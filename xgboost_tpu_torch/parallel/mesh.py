"""Row groups: one process per device over ``torch.distributed``.

The port of the JAX package's ``parallel/mesh.py``. GBDT scales over rows:
each rank holds a row shard, the model is replicated, and the hot loop's
only synchronisation is the per-level histogram all-reduce. The JAX
package is single-controller: one process drives a mesh of devices through
``shard_map`` and several processes join it through ``jax.distributed``.
PyTorch runs one process (rank) per device, so a "mesh" here is a
``RowGroup``: the process group that reduces device tensors (NCCL where
every rank owns a card, else gloo), a gloo group on the CPU for the
host-side gathers (``collective.process_allgather``, the metric pairs,
the sketch summaries, ``broadcast``), this rank, the world size and this
rank's device. ``make_mesh`` returns it; ``mesh_context``,
``current_mesh`` and ``collective_active`` keep their JAX names and
meaning.

Ranks keep ragged row counts and reduce only fixed-shape tensors, so the
JAX package's row padding (``pad_to_multiple``, ``global_pad_rows``,
``shard_rows``, ``replicate``, ``local_rows``) has no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import threading
from typing import Iterator, Optional, Union

import torch
import torch.distributed as dist

from ..resilience import watchdog as _wd

__all__ = ["ROW_AXIS", "RowGroup", "make_mesh", "current_mesh",
           "collective_active", "mesh_context", "init_distributed",
           "form_world", "RENDEZVOUS_DEADLINE", "COLLECTIVE_DEADLINE"]

ROW_AXIS = "data"  # the one parallel axis of GBDT training: rows

#: seconds the rendezvous may take (the JAX package's ``collective_init``
#: watchdog) and seconds one collective may take before the group fails
#: it (the JAX package's ``collective.DEFAULT_DEADLINE``)
RENDEZVOUS_DEADLINE = 900.0
COLLECTIVE_DEADLINE = 600.0

_state = threading.local()
_world: Optional["RowGroup"] = None


@dataclasses.dataclass(frozen=True)
class RowGroup:
    """The ranks that share the rows of one training matrix: every rank of
    the world, in rank order. ``group`` reduces tensors on ``device``
    (``backend``: ``"nccl"`` or ``"gloo"``); ``host_group`` is gloo on the
    CPU."""

    group: object
    host_group: object
    rank: int
    world_size: int
    device: torch.device
    backend: str


def _local_index(default: int) -> int:
    return int(os.environ.get("LOCAL_RANK", default))


def _resolve_device(device, local: int) -> torch.device:
    """``None``: this rank's card, ``cuda:{LOCAL_RANK % device_count}``;
    raises where there is no card, as every entry point of the port does
    unless the caller asks for the CPU."""
    if device is not None:
        dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={dev} requested but "
                               "torch.cuda.is_available() is False")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local % torch.cuda.device_count())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed: no CUDA device for this rank "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "train on the CPU")
    return torch.device("cuda", local % torch.cuda.device_count())


def _check_one_rank_per_card(host_group, device: torch.device) -> None:
    """NCCL refuses a communicator with two ranks on one card ("Duplicate
    GPU detected"): find that before NCCL does and name gloo."""
    here = (socket.gethostname(), device.index)
    everyone = [None] * dist.get_world_size(host_group)
    dist.all_gather_object(everyone, here, group=host_group)
    seen = {}
    for r, key in enumerate(everyone):
        if key in seen:
            raise ValueError(
                f"backend='nccl' needs one card per rank, but ranks "
                f"{seen[key]} and {r} both hold cuda:{key[1]} on {key[0]}; "
                "pass backend='gloo' to run several ranks on one card")
        seen[key] = r


def make_mesh(backend: Optional[str] = None,
              device: Optional[Union[str, torch.device]] = None) -> RowGroup:
    """The row group over every rank of the initialised world (the JAX
    package's 1-D mesh over the row axis), made once per process; every
    rank must call it. ``backend`` (default: ``"nccl"`` on a card, else
    ``"gloo"``) reduces the device tensors. NCCL with two ranks on one card
    raises ValueError; nothing falls back to gloo."""
    global _world
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised; "
                           "call init_distributed first")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = _resolve_device(device, _local_index(rank))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if _world is not None:
        if (_world.backend, _world.device) != (backend, dev):
            raise ValueError(
                f"this process already has a row group ({_world.backend} on "
                f"{_world.device}); one per process")
        return _world
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' reduces CUDA tensors; use "
                         "backend='gloo' on the CPU")
    timeout = datetime.timedelta(seconds=COLLECTIVE_DEADLINE)
    default_gloo = dist.get_backend() == "gloo"
    host = (dist.group.WORLD if default_gloo
            else dist.new_group(backend="gloo", timeout=timeout))
    if backend == "nccl":
        _check_one_rank_per_card(host, dev)
        torch.cuda.set_device(dev)
        group = dist.new_group(backend="nccl", timeout=timeout)
    else:
        group = host
    _world = RowGroup(group=group, host_group=host, rank=rank,
                      world_size=world, device=dev, backend=backend)
    return _world


def current_mesh() -> Optional[RowGroup]:
    return getattr(_state, "mesh", None)


def collective_active() -> bool:
    """True only when collective multi-process semantics apply: several
    ranks AND an active ``mesh_context``. The metrics' reductions and the
    distributed sketch read it (the learner routes a round through any
    active group, one rank included), so a program that initialised
    ``torch.distributed`` but trains per-rank boosters outside a
    ``mesh_context`` sees purely local behaviour everywhere (no hidden
    gather inside a metric)."""
    mesh = current_mesh()
    return mesh is not None and mesh.world_size > 1


@contextlib.contextmanager
def mesh_context(mesh: Optional[RowGroup]) -> Iterator[None]:
    """Activate a row group: training inside the context reduces each
    rank's histograms over it."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     elastic: bool = False) -> RowGroup:
    """Join the world and return its row group (the JAX package's
    ``init_distributed``; the reference's tracker and rabit ring). The JAX
    names map onto ``torch.distributed``: ``coordinator_address`` is the
    ``init_method`` (``"host:port"`` becomes ``tcp://host:port``; a
    ``tcp://`` or ``file://`` URL is taken as it is), ``num_processes`` the
    world size, ``process_id`` the rank; all omitted, ``env://`` as
    ``torchrun`` sets it. The rendezvous may take ``RENDEZVOUS_DEADLINE``
    seconds and each collective ``COLLECTIVE_DEADLINE``. The device is
    resolved first: without ``device="cpu"`` and without a card this raises
    before any rendezvous. ``backend`` as in ``make_mesh``. Call once per
    process, then train inside ``mesh_context(mesh)`` with each rank's own
    rows. ``elastic=True`` forms the world with ``form_world`` (a world
    whose survivors outlive a peer's death; ``parallel.membership`` owns
    liveness)."""
    dev = _resolve_device(device, _local_index(
        process_id if process_id is not None
        else int(os.environ.get("RANK", 0))))
    if elastic:
        return form_world(coordinator_address, num_processes, process_id,
                          backend=backend, device=dev)
    own = not dist.is_initialized()
    if own:
        url = coordinator_address or "env://"
        if "://" not in url:
            url = f"tcp://{url}"
        # the JAX package's deadline around the rendezvous: a clean
        # WatchdogTimeout instead of a hang (XGBTPU_WATCHDOG=
        # "collective_init=S"; it lands when the store's wait returns)
        with _wd.watchdog("collective_init",
                          seconds=_wd.deadline_for("collective_init",
                                                   RENDEZVOUS_DEADLINE)):
            store, rank, world = next(dist.rendezvous(
                url, -1 if process_id is None else process_id,
                -1 if num_processes is None else num_processes,
                timeout=datetime.timedelta(seconds=RENDEZVOUS_DEADLINE)))
            store.set_timeout(
                datetime.timedelta(seconds=RENDEZVOUS_DEADLINE))
            dist.init_process_group(
                "gloo", store=store, rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=COLLECTIVE_DEADLINE))
    try:
        return make_mesh(backend, dev)
    except ValueError:
        if own:
            _shutdown()
        raise


def form_world(coordinator_address: str, num_processes: int,
               process_id: int, *, backend: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None
               ) -> RowGroup:
    """Form one generation of an elastic world (the JAX package's
    ``form_world``) and return its row group. ``coordinator_address`` is
    ``host:port`` (``tcp://`` optional): rank 0 of the generation hosts the
    ``TCPStore`` there in its own process, as the JAX package's
    coordinator hosts its coordination service, and every rank connects to
    it. The store is the rendezvous; after it, a peer's death reaches the
    survivors only as a failed collective (gloo: "Connection reset by
    peer", typed by ``collective.guarded`` as peer loss), never as an abort
    of their process, and ``parallel.membership``'s heartbeats decide who
    is dead. The asymmetry is the JAX package's: the death of the
    generation's rank 0 takes the store with it, so ``elastic_train``
    recovers from it by restarting the survivors' processes and resuming
    from the checkpoint, never by a resize in the same process. One world
    per process: a generation that ends is left with ``_shutdown`` (no
    barrier), and a world of several ranks is formed again only by a new
    process image."""
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise ValueError("form_world needs the coordinator's host:port, "
                         "the world size and this process's rank")
    if dist.is_initialized() or _world is not None:
        raise RuntimeError(
            "form_world: this process already has a torch.distributed "
            "world; an elastic world of several ranks is formed again only "
            "by a process restart")
    dev = _resolve_device(device, _local_index(process_id))
    host, _, port = coordinator_address.split("://")[-1].rpartition(":")
    timeout = datetime.timedelta(seconds=RENDEZVOUS_DEADLINE)
    with _wd.watchdog("collective_init",
                      seconds=_wd.deadline_for("collective_init",
                                               RENDEZVOUS_DEADLINE)):
        store = dist.TCPStore(host or "localhost", int(port), num_processes,
                              is_master=process_id == 0, timeout=timeout)
        dist.init_process_group(
            "gloo", store=store, rank=process_id, world_size=num_processes,
            timeout=datetime.timedelta(seconds=COLLECTIVE_DEADLINE))
    try:
        return make_mesh(backend, dev)
    except ValueError:
        _shutdown()
        raise


def _shutdown() -> None:
    """Leave the world (``collective.finalize``; an elastic generation's
    end). No barrier: after a peer's death none could complete."""
    global _world
    _world = None
    if dist.is_initialized():
        dist.destroy_process_group()
