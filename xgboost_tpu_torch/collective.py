"""Collective communication: the reference's rabit API shim and the
package's collectives over ``torch.distributed``.

The port of the JAX package's ``collective.py``. The shim (``init``,
``finalize``, ``get_rank``, ``get_world_size``, ``is_distributed``,
``allreduce``, ``broadcast``, ``communicator_print`` / ``tracker_print``)
keeps ported user code working; ``init`` joins the world through
``parallel.init_distributed``. Queries read the initialised world (1 and
rank 0 without one).

Host-side collectives go through ``process_allgather`` over the row
group's gloo group (or the default group when no row group is active):
one contribution per process, stacked ``[P, ...]`` in rank order. Device
tensors go through ``all_reduce`` / ``all_gather`` over the row group's
device group, the identity when no group is given; they replace the JAX
package's traced ``psum`` / ``all_gather``. Every collective runs under
``guarded`` (the JAX package's, ``collective.py:64-110``), which applies in
order: the ``collective_timeout`` chaos site; a per-site deadline
(``XGBTPU_WATCHDOG="collective_<site>=S"`` or the ``collective=S``
wildcard, ``DEFAULT_DEADLINE`` otherwise for host collectives, none for
device ones); the retry policy
(``XGBTPU_RETRY="collective_<site>=N"``, default 0: a one-sided retry of a
cross-process operation desyncs the ranks); and on failure a typed
``CollectiveError`` with ``resilience.policy``'s kind and worker-loss
verdict. The ``collective`` chaos site is ``comms.record``, which every
accounted collective passes.

Every collective counts its operations and payload bytes in the metrics
registry under its site and the JAX package's kind of it
(``observability.comms``; ``comms.snapshot(by="site")`` reads them per
site); with ``timing`` on, ``all_reduce`` also synchronises the device
around each call and adds the host-clock seconds. ``all_reduce``,
``allreduce`` and
``broadcast`` record an ``allreduce`` / ``broadcast`` span on the active
trace (host clock only: a span does not synchronise the device).
"""

from __future__ import annotations

import time
from enum import IntEnum
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .observability import comms, trace

__all__ = ["Op", "init", "finalize", "get_rank", "get_world_size",
           "is_distributed", "allreduce", "broadcast", "communicator_print",
           "get_processor_name", "tracker_print", "version_number",
           "CollectiveError", "guarded", "process_allgather", "all_reduce",
           "all_gather", "reduce_histogram"]

#: time each ``all_reduce`` between two device synchronizations
timing = False

#: default deadline (seconds) of one guarded collective: a healthy one
#: takes milliseconds to seconds, so ten minutes means wedged
DEFAULT_DEADLINE = 600.0


class CollectiveError(RuntimeError):
    """A guarded collective failed. ``kind`` is ``resilience.policy``'s
    classification of the failure (``transient``, ``resource`` or
    ``permanent``); ``worker_lost`` is True when it reads as a dead peer
    (a closed or reset connection, a broken pipe, a gloo ring break)."""

    def __init__(self, site: str, kind: str, cause: BaseException,
                 worker_lost: bool = False):
        super().__init__(
            f"collective {site!r} failed ({kind}"
            + (", peer loss" if worker_lost else "")
            + f"): {type(cause).__name__}: {cause}")
        self.site = site
        self.kind = kind
        self.cause = cause
        self.worker_lost = worker_lost


def guarded(site: str, fn: Callable, *args, **kwargs):
    """Run the host collective ``fn(*args, **kwargs)`` under the
    ``collective_timeout`` chaos site, the deadline of
    ``collective_<site>`` (``DEFAULT_DEADLINE`` unless
    ``XGBTPU_WATCHDOG`` names one) and its retry policy; a failure raises
    ``CollectiveError`` naming ``site``."""
    return _guarded(site, DEFAULT_DEADLINE, fn, args, kwargs)


def _guarded(site: str, default: Optional[float], fn: Callable, args,
             kwargs):
    """``guarded`` with the deadline ``default`` when ``XGBTPU_WATCHDOG``
    names none for the site. The device collectives pass None: like the
    JAX package's in-jit ``psum`` they take no deadline of their own (a
    timer thread per level's all-reduce), and the round's
    ``round_dispatch`` deadline covers them."""
    from .resilience import chaos, policy
    from .resilience.chaos import ChaosError
    from .resilience.watchdog import deadline_for, watchdog

    qsite = f"collective_{site}"
    deadline = deadline_for(qsite, deadline_for("collective", default))

    def attempt():
        chaos.hit("collective_timeout")
        with watchdog(qsite, seconds=deadline or 0):
            return fn(*args, **kwargs)

    try:
        return policy.RetryPolicy(qsite, retries=0).run(attempt)
    except ChaosError as e:
        raise CollectiveError(site, e.chaos_kind, e,
                              policy.is_worker_loss(e)) from e
    except Exception as e:
        raise CollectiveError(site, policy.classify(e), e,
                              policy.is_worker_loss(e)) from e


class Op(IntEnum):
    """Reduction ops (reference collective.py Op enum)."""

    MAX = 0
    MIN = 1
    SUM = 2


_TORCH_OPS = {Op.MAX: "MAX", Op.MIN: "MIN", Op.SUM: "SUM"}


def _host_group():
    """The gloo group host payloads travel over: the active row group's,
    else this process's row group's, else the default group."""
    from .parallel import mesh as pm

    m = pm.current_mesh() or pm._world
    return m.host_group if m is not None else None


# ---------------------------------------------------------------------------
# device tensors
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, mesh, op: Op = Op.SUM, *,
               site: str = "all_reduce") -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``mesh``'s device group (the JAX
    package's ``psum``); the identity when ``mesh`` is None. Integer sums
    and maxima are exact, so every rank gets the same bits whatever the
    world size or the backend's reduction order."""
    if mesh is None:
        return t
    t0 = seconds = None
    if timing:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
    nbytes = t.numel() * t.element_size()
    with trace.span("allreduce", site=site, bytes=nbytes, op=int(op)):
        _guarded(site, None, dist.all_reduce, (t,),
                 dict(op=getattr(dist.ReduceOp, _TORCH_OPS[Op(op)]),
                      group=mesh.group))
    if t0 is not None:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        seconds = time.perf_counter() - t0
    comms.record(site, nbytes, seconds=seconds)
    return t


def all_gather(t: torch.Tensor, mesh, *, site: str = "all_gather"
               ) -> torch.Tensor:
    """``[P, ...]``: every rank's ``t`` (equal shapes) stacked in rank
    order, on ``t``'s device; ``t[None]`` when ``mesh`` is None. Gloo does
    not gather CUDA tensors, so they travel through the host group."""
    if mesh is None:
        return t[None]
    if mesh.backend == "gloo" and t.device.type != "cpu":
        host = process_allgather(t.cpu().numpy(), site=site, mesh=mesh)
        return torch.as_tensor(host, device=t.device)
    out = [torch.empty_like(t) for _ in range(mesh.world_size)]
    _guarded(site, None, dist.all_gather, (out, t.contiguous()),
             dict(group=mesh.group))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# host payloads
# ---------------------------------------------------------------------------

def process_allgather(data, *, site: str, mesh=None) -> np.ndarray:
    """One contribution per process, stacked along a leading ``[P, ...]``
    axis in rank order, as numpy (every process passes the same shape and
    dtype); ``data[None]`` in a world of one. Travels over ``mesh``'s gloo
    group (default: the active row group's)."""
    arr = np.ascontiguousarray(data)
    group = mesh.host_group if mesh is not None else _host_group()
    if get_world_size() == 1:
        return arr[None].copy()
    comms.record(site, arr.nbytes, op="process_allgather")
    # as raw bytes: gloo gathers no int16 or bool
    t = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    guarded(site, dist.all_gather, out, t, group=group)
    return torch.stack(out).numpy().view(arr.dtype).reshape(
        (len(out),) + arr.shape)


def _grid_lsb_exp(arr: np.ndarray) -> float:
    """Exponent of the largest power of two dividing EVERY value of
    ``arr`` (+inf when all-zero): the finest grid the values sit on."""
    nz = np.abs(arr[arr != 0].astype(np.float64))
    if nz.size == 0:
        return np.inf
    mant, exp = np.frexp(nz)  # nz = mant * 2^exp, mant in [0.5, 1)
    m_int = np.rint(mant * (1 << 53)).astype(np.int64)
    low_bit = (m_int & -m_int).astype(np.float64)  # 2^trailing_zeros
    return float((exp - 53 + np.log2(low_bit)).min())


def reduce_histogram(data, *, site: str, scale: Optional[float] = None):
    """Cross-process SUM of a histogram-shaped host array with a lossless
    narrow wire (the JAX package's ``reduce_histogram``): a first gather
    of two doubles per rank (largest magnitude, finest value grid), then
    the payload at the narrowest exact type. Integers drop to int16 /
    int32 when the global range fits; float32 values that all sit on a
    common power-of-two grid ship as int16 on that grid when ``max / grid
    < 2^15``; anything else ships unchanged. The wire sum runs in int64,
    so the result is the exact sum either way. ``scale`` marks an integer
    payload already quantised on a shared grid: the int64 sum times
    ``scale``, as float32. Identity in a world of one."""
    arr = np.asarray(data)
    if scale is not None and arr.dtype.kind not in "iu":
        raise TypeError(
            f"reduce_histogram(scale=...) requires an integer payload "
            f"(pre-quantized lanes), got {arr.dtype}")
    world = get_world_size()
    is_int = arr.dtype.kind in "iu"
    m_local = float(np.abs(arr.astype(np.float64)).max()) if arr.size else 0.0
    e_local = _grid_lsb_exp(arr) if not is_int else 0.0
    if world > 1:
        meta = process_allgather(
            np.asarray([m_local, e_local], np.float64), site=f"{site}_meta")
        gmax, glsb_e = float(meta[:, 0].max()), float(meta[:, 1].min())
    else:
        gmax, glsb_e = m_local, e_local
    wire_dt, requant = arr.dtype, None
    if is_int:
        for dt in (np.int16, np.int32):
            if np.dtype(dt).itemsize < arr.dtype.itemsize \
                    and gmax < np.iinfo(dt).max:
                wire_dt = np.dtype(dt)
                break
    elif arr.dtype == np.float32:
        if gmax == 0.0:
            wire_dt, requant = np.dtype(np.int16), 1.0
        elif np.isfinite(glsb_e) and gmax / 2.0 ** glsb_e < 2 ** 15:
            wire_dt, requant = np.dtype(np.int16), float(2.0 ** glsb_e)
    if requant is not None:
        wire = np.rint(arr.astype(np.float64) / requant).astype(wire_dt)
    elif wire_dt != arr.dtype:
        wire = arr.astype(wire_dt)
    else:
        wire = arr
    gathered = process_allgather(wire, site=site)  # [P, ...]
    if np.dtype(wire_dt).kind in "iu":
        total = gathered.astype(np.int64).sum(axis=0)
    else:
        total = gathered.sum(axis=0)
    if requant is not None:
        return (total.astype(np.float64) * requant).astype(arr.dtype)
    if scale is not None:
        return (total.astype(np.float64) * float(scale)).astype(np.float32)
    if is_int:
        # int64, as numpy's sum promotes: narrowing back could wrap
        return total.astype(np.int64)
    return total.astype(arr.dtype)


# ---------------------------------------------------------------------------
# the rabit shim
# ---------------------------------------------------------------------------

def init(**args) -> None:
    """Join the world when it is not yet up (``parallel.init_distributed``
    with ``args``); a no-op afterwards."""
    if not dist.is_initialized():
        from .parallel.mesh import init_distributed

        init_distributed(**args)


def finalize() -> None:
    """Leave the world: the row group and the process groups go."""
    from .parallel.mesh import _shutdown

    _shutdown()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_distributed() -> bool:
    return get_world_size() > 1


def get_processor_name() -> str:
    import socket

    return socket.gethostname()


def allreduce(data: np.ndarray, op: int = Op.SUM) -> np.ndarray:
    """AllReduce with one contribution per process (the reference's rabit
    semantics): gathered, then reduced on the host in rank order; large
    SUM payloads take ``reduce_histogram``'s exact narrow wire. Identity
    in a world of one."""
    arr = np.asarray(data)
    if get_world_size() == 1:
        return arr
    if Op(op) == Op.SUM and arr.dtype.kind in "iuf" and arr.nbytes >= 1024:
        with trace.span("allreduce", bytes=int(arr.nbytes), op=int(op),
                        quantized=True):
            return reduce_histogram(arr, site="allreduce")
    with trace.span("allreduce", bytes=int(arr.nbytes), op=int(op)):
        gathered = process_allgather(arr, site="allreduce")
    red = {Op.SUM: np.sum, Op.MAX: np.max, Op.MIN: np.min}[Op(op)]
    return red(gathered, axis=0)


def broadcast(data, root: int):
    """``root``'s value on every process (reference
    collective.py:broadcast): each process's pickled payload is gathered
    at the largest size and the root's entry kept, so ranks holding
    different values get the root's. Identity in a world of one."""
    if get_world_size() == 1:
        return data
    import pickle

    payload = np.frombuffer(pickle.dumps(data), dtype=np.uint8)
    with trace.span("broadcast", bytes=int(payload.size), root=root):
        sizes = process_allgather(np.asarray([payload.size], np.int64),
                                  site="broadcast")
        buf = np.zeros(int(sizes.max()), np.uint8)
        buf[:payload.size] = payload
        gathered = process_allgather(buf, site="broadcast")
    return pickle.loads(gathered[root, :int(sizes[root, 0])].tobytes())


def communicator_print(msg: str) -> None:
    if get_rank() == 0:
        print(msg, flush=True)


tracker_print = communicator_print


def version_number() -> int:
    return 0
