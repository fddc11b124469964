"""``train()``, ``cv()`` and elastic training (the port of the JAX
package's ``training.py``: ``_AtomicCheckpoint`` :26-66, ``train``
:72-335, ``elastic_train`` and ``elastic_exit`` :338-733, ``cv`` with
``_make_folds`` :736-872; reference ``python-package/xgboost/training.py``
:49 and :189-459)."""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .callback import (CallbackContainer, EarlyStopping, EvaluationMonitor,
                       TrainingCallback, is_maximize)
from .data.dmatrix import DMatrix
from .learner import Booster
from .observability import flight as _flight
from .observability import kernelprof as _kernelprof
from .observability import trace as _trace
from .pipeline import RoundPipeline, completion_probe
from .resilience import checkpoint as _ckpt
from .resilience.watchdog import watchdog as _watchdog

__all__ = ["train", "cv", "elastic_train", "elastic_exit"]


class _AtomicCheckpoint(TrainingCallback):
    """Crash-safe checkpoints for ``train(resume_from=...)`` every
    ``interval`` rounds (``resilience/checkpoint.py``: atomic, checksummed,
    the 2 newest kept); ``after_training`` writes the final round and
    waits until it has landed. A round already on disk (a resumed run's
    first) or in flight is not written again. The commit goes through the
    async writer (``XGBTPU_ASYNC_CKPT=0``: on this thread)."""

    def __init__(self, directory: str, interval: int = 1):
        self.directory = directory
        self.interval = max(1, int(interval))

    def _save(self, model, final: bool = False) -> None:
        rounds = model.num_boosted_rounds()
        if not rounds:
            return
        path = _ckpt.checkpoint_path(self.directory, rounds)
        if _ckpt.async_enabled():
            w = _ckpt.async_writer()
            if not w.covered(self.directory, rounds) \
                    and _ckpt.read_checkpoint(path) is None:
                w.submit(self.directory, model, rounds)
            if final:
                w.wait(self.directory)
        elif _ckpt.read_checkpoint(path) is None:
            _ckpt.save_checkpoint(self.directory, model, rounds)

    def after_iteration(self, model, epoch, evals_log) -> bool:
        if (epoch + 1) % self.interval == 0:
            self._save(model)
        return False

    def after_training(self, model):
        self._save(model, final=True)  # the final round is always durable
        return model


#: verified checkpoints of each rank compared when a row group resumes
_RESUME_CANDIDATES = 8


def _agreed_checkpoint(ckpt_dir: str) -> Optional[Tuple[bytes, int]]:
    """The newest verified checkpoint of ``ckpt_dir``; under an active row
    group of several ranks, the newest round that every rank still holds
    verified (a kill can land while one rank's write is in flight or after
    its file was damaged, and ranks resuming from different rounds would
    desync), or None when they share none. The JAX package resumes each
    rank from its own newest. A write of this process still in flight
    there lands first."""
    from .parallel.mesh import collective_active

    _ckpt.settle(ckpt_dir)
    if not collective_active():
        return _ckpt.load_latest(ckpt_dir)
    from .collective import process_allgather

    verified: Dict[int, Tuple[bytes, int]] = {}
    for path in reversed(_ckpt.list_checkpoints(ckpt_dir)):
        got = _ckpt.read_checkpoint(path)
        if got is not None:
            verified.setdefault(got[1], got)
            if len(verified) == _RESUME_CANDIDATES:
                break
    mine = np.full(_RESUME_CANDIDATES, -1, np.int64)
    mine[:len(verified)] = sorted(verified, reverse=True)
    every = process_allgather(mine, site="resume_rounds")
    common = set.intersection(*(set(r) for r in every.tolist())) - {-1}
    if not common:
        if (every >= 0).any():
            from .utils import console_logger

            console_logger.warning(
                f"resume_from: the ranks hold no verified round in common "
                f"({ckpt_dir}); training from the start")
        return None
    return verified[max(common)]


def _commit_on_abort(bst: Booster, ckpt_dir: Optional[str]) -> None:
    """An abort mid-loop (a watchdog expiry, a failed collective, a fault
    at a kernel's launch site or at a pipeline wait) keeps the finished
    rounds: write the model's whole rounds, on this thread, after the
    async writer's write to ``ckpt_dir`` has landed (a failure parked
    there is dropped: it must not hide this abort). Best effort: the
    abort itself must still surface."""
    if ckpt_dir is None:
        return
    try:
        _ckpt.async_writer().wait(ckpt_dir)
    except Exception:
        pass
    try:
        rounds = bst.num_boosted_rounds()  # 0 for gblinear: nothing to keep
        # never a round cut between its trees
        if rounds and bst._gbm.model.num_trees == rounds * bst._per_round:
            _ckpt.save_checkpoint(ckpt_dir, bst, rounds)
    except Exception:
        pass


def train(params: Dict[str, Any], dtrain: DMatrix, num_boost_round: int = 10,
          evals: Optional[Sequence[Tuple[DMatrix, str]]] = None, obj=None,
          feval=None, maximize: Optional[bool] = None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None, verbose_eval: Any = True,
          xgb_model=None, callbacks: Optional[Sequence[TrainingCallback]] = None,
          custom_metric=None, resume_from: Optional[str] = None,
          checkpoint_interval: int = 1, checkpoint_shared: bool = False,
          resume_mode: str = "total") -> Booster:
    """Train ``num_boost_round`` rounds on ``dtrain``'s device.

    Each round evaluates every ``(DMatrix, name)`` of ``evals`` (with
    ``feval``, or ``custom_metric``, appended: ``(name, value) =
    feval(margin, dmat)``); ``evals_result`` receives the history
    ``{name: {metric: [value per round]}}``, each value rounded to 6
    decimals. ``obj(margin, dtrain) -> (grad, hess)`` replaces the
    objective's gradients. ``early_stopping_rounds`` stops when the last
    metric of the last eval set has not improved for that many rounds
    (``maximize`` overrides the metric's direction) and sets the
    ``best_iteration`` / ``best_score`` attributes. ``verbose_eval`` prints
    every round (True) or every ``verbose_eval`` rounds. ``xgb_model`` (a
    Booster, a model path or its bytes) continues that model: a copy, with
    ``params`` set, fresh prediction caches, from its
    ``num_boosted_rounds()``.

    The loop is traced as the JAX package's: a ``train`` span holding one
    ``round`` span a round, and the flight recorder keeps one record a
    round (its ``grow``, ``sync`` and ``eval`` stages); an exception dumps
    the recorder's black box before it propagates (``abort_dump``), and
    ``XGBTPU_PROFILE`` opens the profiling window at the first round.

    The round loop is pipelined as the JAX package's per-round loop
    (``pipeline.RoundPipeline``): each round's completion event is
    admitted after its ``update``, and the host waits only when more than
    ``XGBTPU_PIPELINE_DEPTH`` rounds (default 2; 0 = every round) are in
    flight, and at the sync points: every round when there are evals,
    ``obj``, ``feval``, early stopping or a callback of the caller's;
    with the interval checkpoint alone, only the rounds it commits; and
    the end of training. A fault surfacing at a wait carries the round it
    belongs to (``.pipeline_round``, a ``pipeline_fault`` flight event).
    The trees stay on the card until a consumer reads them, so a
    consumer-free round needs no host copy of its tree.

    ``resume_from`` is a directory of crash-safe checkpoints
    (``resilience/checkpoint.py``; ``rank<r>`` subdirectories in a world of
    several ranks unless ``checkpoint_shared``). Training resumes from the
    newest verified checkpoint there (when no ``xgb_model`` is given) and
    commits one every ``checkpoint_interval`` rounds (through the async
    writer unless ``XGBTPU_ASYNC_CKPT=0``; the final one has landed when
    ``train`` returns), and on any abort the finished rounds. With
    ``resume_mode="total"`` ``num_boost_round`` is the total: a run
    resumed at round r trains the remaining
    ``num_boost_round - r``, so rerunning a killed command finishes it;
    ``"append"`` trains ``num_boost_round`` more. A resumed booster fills
    its caches round by round (``Booster._fill_caches_by_round``), so the
    resumed model's bytes are an uninterrupted run's. Each round's
    ``update`` runs under the ``round_dispatch`` watchdog
    (``XGBTPU_WATCHDOG``; none by default).

    Sampled rounds (``XGBTPU_KERNEL_PROF=every=N`` or ``rounds=a,b,c``;
    off by default) run the grow with every op bracketed by a completion
    sync (``observability/kernelprof.py``), and the round's flight record
    carries the per-depth x per-op ``grow_detail`` and the port's
    ``round_detail`` (``_level_update``'s sub-ops, the gradient, the
    one-hot build, the eval walk and the metrics; the profile stays armed
    until the callbacks' ``after_iteration`` has run). Before a sampled
    round's ``update`` the pipeline is drained, its wait charged to the
    flight ``sync`` stage, so that the first bracket's sync does not
    charge the rounds still in flight to this one. An unsampled round
    pays one environment read for it and no sync. No counterpart here:
    the JAX package's scan path and its ``train_dispatch`` deadline (TPU
    only; the port keeps the per-round loop on every device) and the
    ``native_dispatch`` retry (the CPU native kernels have no counterpart
    by design)."""
    if resume_mode not in ("total", "append"):
        raise ValueError(
            f"resume_mode must be 'total' or 'append', got {resume_mode!r}")
    callbacks = list(callbacks) if callbacks else []
    evals = list(evals) if evals else []
    feval = custom_metric if custom_metric is not None else feval
    ckpt_dir: Optional[str] = None
    resumed = False
    if resume_from is not None:
        ckpt_dir = _ckpt.process_dir(resume_from, shared=checkpoint_shared)
        loaded = _agreed_checkpoint(ckpt_dir)
        if loaded is not None and xgb_model is None:
            xgb_model, done_rounds = bytes(loaded[0]), loaded[1]
            resumed = True
            if resume_mode == "total":
                num_boost_round = max(0, num_boost_round - done_rounds)
        callbacks.append(_AtomicCheckpoint(ckpt_dir, checkpoint_interval))
    if verbose_eval:
        period = (verbose_eval if isinstance(verbose_eval, int)
                  and not isinstance(verbose_eval, bool) else 1)
        callbacks.append(EvaluationMonitor(period=period))
    if early_stopping_rounds is not None:
        callbacks.append(EarlyStopping(rounds=early_stopping_rounds,
                                       maximize=maximize))

    if xgb_model is not None:
        bst = (xgb_model.copy() if isinstance(xgb_model, Booster)
               else Booster(params, model_file=xgb_model,
                            device=dtrain.device))
        bst.set_param(params)
        for d in [dtrain] + [d for d, _ in evals]:
            bst._add_cache(d)
        if resumed:
            bst._fill_caches_by_round(dtrain, [d for d, _ in evals])
        start_round = bst.num_boosted_rounds()
    else:
        bst = Booster(params, cache=[dtrain] + [d for d, _ in evals],
                      device=dtrain.device)
        start_round = 0

    container = CallbackContainer(callbacks)
    bst = container.before_training(bst)
    pipe = RoundPipeline()
    # the caller's consumers read every round; the interval checkpoint
    # alone reads only the rounds it commits
    other_consumers = (
        bool(evals) or obj is not None or feval is not None
        or early_stopping_rounds is not None
        or any(not isinstance(c, (EvaluationMonitor, _AtomicCheckpoint))
               for c in callbacks))

    def round_consumer(i: int) -> bool:
        return other_consumers or (ckpt_dir is not None and (i + 1)
                                   % max(checkpoint_interval, 1) == 0)

    try:
        with _trace.span("train", rounds=num_boost_round, path="per_round",
                         pipeline_depth=pipe.depth):
            for i in range(start_round, start_round + num_boost_round):
                if container.before_iteration(bst, i, dtrain, evals):
                    break
                _flight.profile_tick(i)
                _flight.RECORDER.begin_round(i)
                sampled = _kernelprof.should_sample(i)
                try:
                    if sampled:
                        # the earlier rounds finish first (charged to
                        # this round's sync stage), then the profile arms
                        pipe.drain()
                        _kernelprof.arm(i)
                    with _trace.span("round", iteration=i):
                        t0 = time.perf_counter()
                        with _watchdog("round_dispatch"):
                            bst.update(dtrain, i, fobj=obj)
                        _flight.note("grow", time.perf_counter() - t0)
                        entry = bst._caches.get(id(dtrain))
                        pipe.admit(i, completion_probe(
                            entry.margin if entry is not None else None))
                        if round_consumer(i):
                            pipe.drain()  # the consumer reads a finished round
                        stop = container.after_iteration(
                            bst, i, dtrain, evals, feval=feval)
                finally:
                    if sampled:
                        rdetail = _kernelprof.round_detail()
                        detail = _kernelprof.disarm()
                        if detail is not None:
                            _flight.RECORDER.annotate("grow_detail", detail)
                        if rdetail is not None:
                            _flight.RECORDER.annotate("round_detail",
                                                      rdetail)
                    _flight.RECORDER.end_round()
                if stop:
                    break
            pipe.drain()  # the end of training
    except BaseException as e:
        _commit_on_abort(bst, ckpt_dir)
        _flight.RECORDER.abort_dump(e)  # the black box: ring + metrics
        raise
    finally:
        _flight.profile_stop()
    bst = container.after_training(bst)

    if evals_result is not None:
        for k, v in container.history.items():
            evals_result[k] = {mk: list(mv) for mk, mv in v.items()}
    return bst


# ---------------------------------------------------------------------------
# elastic training: worker loss shrinks the world and replays from the
# newest verified checkpoint
# ---------------------------------------------------------------------------


class _ElasticGuard(TrainingCallback):
    """The per-round elastic sentinel. At every round boundary it (a) hits
    the ``worker_kill`` chaos site, a scripted hit SIGKILLing this worker
    (the rabit mock's "die at (version, seqno)"); (b) exports the round to
    the membership; (c) scans the membership and raises ``WorkerLost`` on
    a dead peer (the quiesce at a round boundary), or when this worker is
    fenced."""

    def __init__(self, membership):
        self.membership = membership

    def before_iteration(self, model, epoch, evals_log) -> bool:
        from .parallel.membership import WorkerLost
        from .resilience import chaos
        from .resilience.chaos import ChaosError

        try:
            chaos.hit("worker_kill")
        except ChaosError:
            import signal

            from .utils import console_logger

            console_logger.warning(
                f"chaos: worker_kill fired at round {epoch}: SIGKILLing "
                f"rank {self.membership.rank} (pid {os.getpid()})")
            os.kill(os.getpid(), signal.SIGKILL)
        self.membership.round = epoch
        dead = self.membership.scan()
        if self.membership.fenced:
            raise WorkerLost([self.membership.rank], epoch)
        if dead:
            raise WorkerLost(dead, epoch)
        return False


def _atomic_json(path: str, obj: dict) -> None:
    import json

    _ckpt.atomic_write_bytes(path, json.dumps(obj).encode())


def _read_json(path: str) -> Optional[dict]:
    import json

    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _canonical_cuts(run_dir: str, data_fn, max_bin: int, rank: int,
                    members: List[int]):
    """Cuts that do not depend on the sharding, for a bit-exact replay: the
    lowest member sketches the whole dataset once (``data_fn(0, 1)``, the
    world-1 view of the ``load_row_split`` contract) on the plain local
    path and writes ``run_dir/cuts.json`` atomically; every generation at
    every world size bins its shard against it. The manifest is the JAX
    package's (``max_bin``, ``values``, ``min_vals`` and a ``sha256`` over
    the sorted JSON of the rest), so either package reads the other's."""
    import hashlib
    import json

    from .data.quantile import HistogramCuts

    path = os.path.join(run_dir, "cuts.json")
    got = _read_json(path)
    if got is None and rank == min(members):
        bm = data_fn(0, 1).get_binned(max_bin)
        payload = {
            "max_bin": int(max_bin),
            "values": np.asarray(bm.cuts.values).tolist(),
            "min_vals": np.asarray(bm.cuts.min_vals).tolist(),
        }
        del bm  # the whole dataset's bins: not kept on the device
        payload["sha256"] = hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()
        _atomic_json(path, payload)
        got = payload
    if got is None:
        # the other ranks wait for the writer, under a deadline: a writer
        # that died here must abort them, not hang them
        with _watchdog("elastic_cuts", seconds=300.0):
            while got is None:
                time.sleep(0.1)
                got = _read_json(path)
    check = dict(got)
    sha = check.pop("sha256", None)
    if sha != hashlib.sha256(
            json.dumps(check, sort_keys=True).encode()).hexdigest():
        raise RuntimeError(f"elastic cuts manifest {path} failed its "
                           "checksum; delete it to recompute")
    if int(got["max_bin"]) != int(max_bin):
        raise RuntimeError(
            f"elastic cuts manifest was built for max_bin="
            f"{got['max_bin']}, run requests {max_bin}")
    return HistogramCuts(
        values=np.asarray(got["values"], np.float32),
        min_vals=np.asarray(got["min_vals"], np.float32))


def _bin_with_cuts(d: DMatrix, cuts, max_bin: int) -> DMatrix:
    """Seed ``d``'s binned-matrix cache at ``max_bin`` with ``cuts`` (the
    ``QuantileDMatrix(ref=...)`` mechanism, in place), on ``d``'s
    device; CSR input is binned from column blocks and stays sparse."""
    from .data.quantile import BinnedMatrix

    cat = d.categorical_features()
    if d._csr_only():
        bm = BinnedMatrix.from_sparse(d._sparse, max_bin=max_bin, cuts=cuts,
                                      categorical=cat, device=d.device)
    else:
        bm = BinnedMatrix.from_dense(d.data, max_bin=max_bin, cuts=cuts,
                                     categorical=cat)
    d._binned[max_bin] = bm
    return d


def _leave_world(exc: BaseException) -> str:
    """Leave this process's world at once, without a barrier, so that a
    later generation never reduces over it and every peer still waiting in
    a collective with this rank fails now (the survivors then decide who
    died in the same window, while every live agent still beats). gloo
    closes a rank's connections only when its groups are freed, and the
    tracebacks of the failed collective hold them: they are dropped, and
    their text is returned."""
    import gc
    import traceback

    from .parallel import mesh as _mesh

    text = "".join(traceback.format_exception(exc))
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__
    _mesh._shutdown()
    gc.collect()
    return text


_GEN_ENV = "XGBTPU_ELASTIC_GEN"


def elastic_train(params: Dict[str, Any],
                  data_fn: Callable[[int, int], DMatrix],
                  num_boost_round: int, *, run_dir: str, world: int,
                  rank: int, coordinator: Optional[str] = None,
                  checkpoint_interval: int = 1, verbose_eval: Any = False,
                  callbacks: Optional[Sequence[TrainingCallback]] = None,
                  backend: Optional[str] = None) -> Booster:
    """Fault-tolerant training over several processes (the JAX package's
    ``elastic_train``): the loss of a worker shrinks the world and replays
    from the newest verified checkpoint instead of ending the job (the
    reference's rabit ``LoadCheckPoint`` at the scale of the cluster).

    ``data_fn(rank, world) -> DMatrix`` is the re-shardable ingestion hook
    (the ``load_row_split`` contract), called again at every world size
    for that rank's rows. For a bit-exact replay the shards must be
    contiguous blocks of one fixed global row order. Training runs on the
    device of the matrices ``data_fn`` builds: the card unless they were
    built with ``device="cpu"``.

    ``run_dir`` is shared by every worker: the heartbeats (``members/``),
    the cuts manifest (``cuts.json``), the generation state
    (``generation.json``), the shared checkpoints (``checkpoints/``), the
    snapshot each resize replays from (``quiesce/gen<g>_ckpt_*.ckpt``) and
    each worker's telemetry (``obs/rank<base>/``). ``coordinator`` is
    ``host:basePort`` (default ``localhost:29950``); generation g meets at
    ``basePort + g``, its rank 0 hosting the store (``form_world``).
    ``backend`` is ``init_distributed``'s: ``"gloo"`` for several ranks on
    one card, whose all-reduces go through the host; ``"nccl"`` (the
    default on a card) needs one card per rank.

    The state machine of a worker: TRAIN, until a peer's death is found by
    heartbeat silence or by a broken collective (corroborated by the
    heartbeats: a transient fault does not shrink the world, and a failure
    that is not a peer's death re-raises); QUIESCE at a round boundary
    (``train``'s abort handler commits the finished rounds); RESIZE (the
    dead tombstoned, the survivors agreed in ``generation.json``): to one
    survivor in the same process, by a restart of each survivor's process
    image (``os.execv`` with ``XGBTPU_ELASTIC_GEN`` set) when several
    survive or when the generation's rank 0 died; REPLAY (every shard
    binned against the canonical cuts, ``train(resume_from=...)`` from the
    newest verified checkpoint); TRAIN."""
    from .observability.metrics import REGISTRY
    from .parallel import mesh as _mesh
    from .parallel.membership import Membership, WorkerLost, hb_deadline
    from .resilience import policy as _policy
    from .utils import console_logger

    os.makedirs(run_dir, exist_ok=True)
    # each worker's flight records, metrics and trace persist under
    # run_dir/obs/rank<base_rank>/ (obs-report merges them)
    _flight.configure(run_dir, rank=int(rank))
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    member_dir = os.path.join(run_dir, "members")
    gen_path = os.path.join(run_dir, "generation.json")
    max_bin = int(params.get("max_bin", 256))
    base_rank = int(rank)
    host, _, base_port = (coordinator or "localhost:29950").rpartition(":")
    base_port = int(base_port)

    state = _read_json(gen_path) or {
        "generation": 0, "members": list(range(world)),
        "attempted_round": 0,
    }
    env_gen = int(os.environ.get(_GEN_ENV, state["generation"]))
    if env_gen > state["generation"]:
        # restarted ahead of the generation's writer (the lowest survivor
        # commits generation.json just before its own restart): wait for
        # the agreement to land rather than race it
        with _watchdog("elastic_generation", seconds=300.0):
            while state["generation"] < env_gen:
                time.sleep(0.1)
                state = _read_json(gen_path) or state
    gen = max(env_gen, state["generation"])

    cuts = None
    dtrain: Optional[DMatrix] = None
    while True:
        members = list(state["members"])
        if base_rank not in members:
            raise WorkerLost([base_rank])  # fenced before it started
        world_g = len(members)
        rank_g = members.index(base_rank)
        _trace.instant("elastic_generation", generation=gen, world=world_g,
                       rank=rank_g)
        # the fleet table keys (gen, round): replayed rounds land in their
        # own entries
        _flight.RECORDER.set_generation(gen)
        if dtrain is not None:
            # the last generation's matrix (bins, one-hot) goes before
            # this one's is made: the hoist plan reads free memory
            import gc

            cuda = dtrain.device.type == "cuda"
            dtrain = None
            gc.collect()
            if cuda:
                import torch

                torch.cuda.empty_cache()
        shard = data_fn(rank_g, world_g)
        mesh = None
        if world_g > 1:
            mesh = _mesh.init_distributed(
                f"{host}:{base_port + gen}", world_g, rank_g,
                backend=backend, device=shard.device, elastic=True)
        # membership starts right after the rendezvous, the one moment
        # every rank is in step
        membership = Membership(member_dir, base_rank, members,
                                generation=gen).start()
        if cuts is None:
            cuts = _canonical_cuts(run_dir, data_fn, max_bin, rank_g,
                                   list(range(world_g)))
        dtrain = _bin_with_cuts(shard, cuts, max_bin)
        del shard

        # replay accounting: rounds the last generation reached beyond
        # what the checkpoint keeps are trained again now (the header's
        # check only: train() reads the payload anyway)
        resumed = 0
        _ckpt.settle(ckpt_dir)
        for p in reversed(_ckpt.list_checkpoints(ckpt_dir)):
            ok, _, rounds = _ckpt.verify_checkpoint(p)
            if ok:
                resumed = rounds
                break
        replayed = max(0, int(state.get("attempted_round", 0)) - resumed)
        if gen > 0:
            REGISTRY.counter(
                "elastic_resume_rounds_replayed",
                "Rounds re-trained after elastic resizes").inc(replayed)
            _trace.instant("elastic_replay", generation=gen,
                           resumed=resumed, replayed=replayed)
            _flight.RECORDER.event("elastic_replay", generation=gen,
                                   resumed=resumed, replayed=replayed)

        try:
            import contextlib

            ctx = (_mesh.mesh_context(mesh) if mesh is not None
                   else contextlib.nullcontext())
            with ctx:
                bst = train(
                    params, dtrain, num_boost_round,
                    verbose_eval=verbose_eval,
                    callbacks=[_ElasticGuard(membership)]
                    + (list(callbacks) if callbacks else []),
                    resume_from=ckpt_dir,
                    checkpoint_interval=checkpoint_interval,
                    checkpoint_shared=True)
            membership.stop()
            # elastic workers leave through elastic_exit (os._exit, no
            # atexit): flush the black box and the trace now
            _flight.RECORDER.dump("elastic_complete")
            if _trace.enabled():
                _trace.flush()
            return bst
        except BaseException as e:
            if mesh is not None:
                mesh = None
                e.add_note("before the world was left:\n" + _leave_world(e))
            # the heartbeat agent beats on through this block: stopping it
            # before the decision would let simultaneous survivors read
            # each other as silent and fence each other
            dead: List[int] = []
            # rounds attempted so far: the guard's WorkerLost comes before
            # its round runs; a broken collective means the guard's last
            # round was in flight (it is replayed)
            at_round = int(state.get("attempted_round", 0))
            if isinstance(e, WorkerLost):
                dead = e.ranks
                at_round = max(at_round, max(e.round, 0))
            else:
                suspects = [m for m in members if m != base_rank]
                if _policy.is_worker_loss(e):
                    # a broken collective: corroborated by the heartbeats
                    # before the world shrinks
                    dead = membership.wait_dead(
                        suspects, timeout=2 * hb_deadline())
                else:
                    # no peer-loss signature (a collective aborted by the
                    # watchdog, an opaque error): resize only where the
                    # heartbeats already found a death, else re-raise
                    dead = [r for r in membership.scan() if r in suspects]
                if not dead:
                    membership.stop()
                    raise
                at_round = max(at_round, membership.round + 1)
            if base_rank in dead or membership.fenced:
                membership.stop()
                console_logger.warning(
                    f"elastic: rank {base_rank} fenced (tombstoned by a "
                    "peer); exiting rather than splitting the run")
                raise WorkerLost([base_rank]) from e
            _policy.record_failure("elastic_resize", e)
            # QUIESCE committed its rounds in train()'s abort handler
            _trace.instant("elastic_quiesce", generation=gen,
                           at_round=at_round, dead=repr(dead))
            _flight.RECORDER.event("elastic_quiesce", generation=gen,
                                   at_round=at_round, dead=repr(dead))
            _flight.RECORDER.dump("elastic_quiesce")
            for r in dead:
                membership.declare_dead(r)
            survivors = [m for m in members if m not in dead]
            # the audit trail: the snapshot this resize replays from
            # (retention prunes the live directory later)
            try:
                import shutil

                _ckpt.settle(ckpt_dir)
                for p in reversed(_ckpt.list_checkpoints(ckpt_dir)):
                    if _ckpt.verify_checkpoint(p)[0]:
                        qdir = os.path.join(run_dir, "quiesce")
                        os.makedirs(qdir, exist_ok=True)
                        shutil.copy(p, os.path.join(
                            qdir, f"gen{gen}_{os.path.basename(p)}"))
                        break
            except OSError:
                pass  # best effort: the audit copy never blocks a resize
            gen += 1
            state = {"generation": gen, "members": survivors,
                     "attempted_round": at_round}
            if base_rank == min(survivors):
                _atomic_json(gen_path, state)
            REGISTRY.counter(
                "worker_restarts_total",
                "Training restarts caused by elastic resizes").inc()
            _trace.instant("elastic_resize", generation=gen,
                           dead=repr(dead), world=len(survivors))
            _flight.RECORDER.event("elastic_resize", generation=gen,
                                   dead=repr(dead), world=len(survivors))
            console_logger.warning(
                f"elastic: lost rank(s) {dead}; resizing world "
                f"{len(members)} -> {len(survivors)} (generation {gen}), "
                f"replaying from the newest verified checkpoint")
            membership.stop()
            if len(survivors) == 1 and members[0] not in dead:
                continue  # shrink to one in this process
            # several survivors, or the generation's coordinator (the
            # store's host) died: restart this process image in place;
            # every piece of state is in run_dir
            import sys

            os.environ[_GEN_ENV] = str(gen)
            console_logger.warning(
                f"elastic: re-executing worker for generation {gen} "
                f"(world {len(survivors)})")
            if _trace.enabled():  # execv skips atexit: flush the timeline
                _trace.flush()
            sys.stdout.flush()
            sys.stderr.flush()
            os.execv(sys.executable, [sys.executable] + sys.argv)


def elastic_exit(code: int = 0) -> None:
    """Leave an elastic worker's process: flush stdio, then ``os._exit``
    (no atexit hooks, no exit-time teardown of a world whose peers may be
    dead). Call it last, after the model and the metrics are saved."""
    import sys

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _make_folds(dtrain: DMatrix, nfold: int, seed: int, stratified: bool,
                folds, shuffle: bool = True) -> List[Tuple[DMatrix, DMatrix]]:
    """``(train, test)`` DMatrix pairs, each a ``DMatrix.slice`` on
    ``dtrain``'s device: the given ``folds`` (index pairs, or an object with
    ``split``), else the JAX package's assignment, shuffled by
    ``np.random.RandomState(seed)`` (stratified: rows sorted by label after
    the shuffle and dealt round robin; otherwise contiguous blocks of
    ``ceil(n / nfold)``)."""
    n = dtrain.num_row()
    rng = np.random.RandomState(seed)
    if folds is not None:
        splits = folds if not hasattr(folds, "split") else list(
            folds.split(X=np.zeros(n), y=dtrain.get_label()))
    else:
        idx = np.arange(n)
        if shuffle:
            rng.shuffle(idx)
        if stratified and dtrain.label is not None:
            order = np.argsort(dtrain.get_label()[idx], kind="stable")
            idx = idx[order]  # interleave classes across folds
            fold_of = np.arange(n) % nfold
        else:
            fold_of = np.repeat(np.arange(nfold), int(np.ceil(n / nfold)))[:n]
        splits = [(idx[fold_of != k], idx[fold_of == k])
                  for k in range(nfold)]
    return [(dtrain.slice(np.asarray(tr)), dtrain.slice(np.asarray(te)))
            for tr, te in splits]


def cv(params: Dict[str, Any], dtrain: DMatrix, num_boost_round: int = 10,
       nfold: int = 3, stratified: bool = False, folds=None,
       metrics: Sequence[str] = (), obj=None, feval=None,
       maximize: Optional[bool] = None,
       early_stopping_rounds: Optional[int] = None, fpreproc=None,
       as_pandas: bool = True, verbose_eval: Any = None,
       show_stdv: bool = True, seed: int = 0,
       callbacks: Optional[Sequence[TrainingCallback]] = None,
       shuffle: bool = True, custom_metric=None):
    """K-fold cross-validation (the JAX package's ``cv``): one Booster per
    fold on ``dtrain``'s device, trained round by round, each round's
    ``train-`` and ``test-`` values (6 decimals) averaged over the folds
    into ``{"<set>-<metric>-mean": [...], "<set>-<metric>-std": [...]}``.
    With ``early_stopping_rounds`` the last test metric decides the stop
    and the history is cut after the best round. A pandas DataFrame when
    ``as_pandas`` and pandas is present, else the dict. ``callbacks`` are
    accepted and none is run, as in the JAX package."""
    params = dict(params)
    if isinstance(metrics, str):
        metrics = [metrics]
    if metrics:
        params["eval_metric"] = list(metrics)
    cvpacks = []
    for dtr, dte in _make_folds(dtrain, nfold, seed, stratified, folds,
                                shuffle):
        p = params
        if fpreproc is not None:
            dtr, dte, p = fpreproc(dtr, dte, dict(params))
        cvpacks.append((Booster(p, cache=[dtr, dte], device=dtrain.device),
                        dtr, dte))

    feval = custom_metric if custom_metric is not None else feval
    history: Dict[str, List[float]] = {}
    best_iteration = None
    best, stale = None, 0
    for i in range(num_boost_round):
        round_scores: Dict[str, List[float]] = {}
        for bst, dtr, dte in cvpacks:
            bst.update(dtr, i, fobj=obj)
            msg = bst.eval_set([(dtr, "train"), (dte, "test")], i,
                               feval=feval)
            for tok in msg.split("\t")[1:]:
                nm, _, val = tok.rpartition(":")
                round_scores.setdefault(nm, []).append(float(val))
        agg = {k: (float(np.mean(v)), float(np.std(v)))
               for k, v in round_scores.items()}
        for k, (m, s) in agg.items():
            history.setdefault(f"{k}-mean", []).append(m)
            history.setdefault(f"{k}-std", []).append(s)
        if verbose_eval:
            print(f"[{i}]\t" + "\t".join(
                f"{k}:{m:.5f}" + (f"+{s:.5f}" if show_stdv else "")
                for k, (m, s) in agg.items()), flush=True)
        if early_stopping_rounds is not None:
            test_keys = [k for k in agg if k.startswith("test-")]
            if test_keys:
                key = test_keys[-1]
                score = agg[key][0]
                is_max = is_maximize(key[len("test-"):], cvpacks[0][0],
                                     maximize)
                if (best is None or (is_max and score > best)
                        or (not is_max and score < best)):
                    best, stale, best_iteration = score, 0, i
                else:
                    stale += 1
                    if stale >= early_stopping_rounds:
                        break
    if early_stopping_rounds is not None and best_iteration is not None:
        for k in history:
            history[k] = history[k][: best_iteration + 1]
    if as_pandas:
        try:
            import pandas as pd
        except ImportError:
            return history
        return pd.DataFrame(history)
    return history
