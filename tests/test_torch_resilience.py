"""The port's resilience layer (``xgboost_tpu_torch/resilience``) held
against the JAX package's (``xgboost_tpu/resilience``) on the same inputs:

- ``policy``: ``classify`` and ``is_worker_loss`` on a table of
  exceptions (the card's own signatures added), the
  ``XGBTPU_RETRY`` grammar, the backoff sequences and ``RetryPolicy.run``;
- ``chaos``: the hits that fire for the same schedule strings (the seeded
  form included), and the strings both refuse;
- ``watchdog``: the ``XGBTPU_WATCHDOG`` grammar, an expiry's exception and
  its telemetry (the counter, the flight event, the black box);
- ``checkpoint``: round trip, retention, truncation and bit-flip detection,
  previous-good fallback, ``inspect_dir``, checkpoints written by either
  package verified and loaded by the other, and a failed write raising
  with the previous checkpoint kept;
- the chaos sites of the port: ``collective`` (``comms.record``),
  ``fault.inject``'s, ``pager_io`` (absorbed by the retry, and a
  prefetched read's failure attributed to its page), ``pallas`` (raises on
  the CPU path; ``train`` commits the finished rounds), ``checkpoint_write``
  and ``collective_timeout`` (``CollectiveError`` kinds as the JAX
  package's ``guarded``); the default deadline on host collectives only
  (the device ones take one where ``XGBTPU_WATCHDOG`` names it).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu import collective as jcoll
from xgboost_tpu.resilience import chaos as jchaos
from xgboost_tpu.resilience import checkpoint as jckpt
from xgboost_tpu.resilience import policy as jpolicy
from xgboost_tpu.resilience import watchdog as jwatchdog
from xgboost_tpu_torch import collective as tcoll
from xgboost_tpu_torch.observability import REGISTRY, comms, flight
from xgboost_tpu_torch.resilience import chaos as tchaos
from xgboost_tpu_torch.resilience import checkpoint as tckpt
from xgboost_tpu_torch.resilience import policy as tpolicy
from xgboost_tpu_torch.resilience import watchdog as twatchdog
from xgboost_tpu_torch.utils import fault as tfault

torch.set_num_threads(1)

CPU = dict(device="cpu")
PARAMS = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
          "eta": 0.3, "verbosity": 0}


def _count(name, **labels):
    """The port's registry: the sum of ``name``'s series with ``labels``."""
    fam = REGISTRY.get(name)
    if fam is None:
        return 0.0
    return sum(c.value for lab, c in fam.series()
               if all(lab.get(k) == str(v) for k, v in labels.items()))


def _data(n=600, F=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = ((X @ rng.randn(F) + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------- policy

EXCEPTIONS = [
    RuntimeError("RESOURCE_EXHAUSTED: 1GB"), MemoryError(),
    RuntimeError("Mosaic lowering failed"),
    RuntimeError("scoped vmem exhausted"), NotImplementedError("no"),
    ConnectionError("relay reset"), RuntimeError("anything else"),
    RuntimeError("Connection reset by peer"), BrokenPipeError("Broken pipe"),
    RuntimeError("[gloo] Gloo all-reduce failed"), EOFError("eof"),
    TimeoutError("timed out"), RuntimeError("heartbeat timeout of rank 1"),
    OSError("failed to allocate 12 bytes"),
    jchaos.ChaosResource("s", 1), jchaos.ChaosPermanent("s", 1),
    jchaos.ChaosTimeout("worker_kill", 1), jchaos.ChaosCrash("s", 2),
]
# the card's failures: sticky context errors and a failed build are
# permanent; the allocator's "CUDA out of memory" is a resource failure
CARD_EXCEPTIONS = [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "permanent"),
    (RuntimeError("CUDA error: unspecified launch failure"), "permanent"),
    (RuntimeError("CUDA error: no kernel image is available for execution "
                  "on the device"), "permanent"),
    (RuntimeError("CUDA kernel build failed:\nhist_level: nvcc exited 1"),
     "permanent"),
    (RuntimeError("nvcc not found: the CUDA kernels cannot be built"),
     "permanent"),
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), "resource"),
    (RuntimeError("hoisted_level: CUDA error 2 at launch"), "transient"),
]


@pytest.mark.parametrize("i", range(len(EXCEPTIONS)))
def test_classify_matches_jax(i):
    exc = EXCEPTIONS[i]
    assert tpolicy.classify(exc) == jpolicy.classify(exc)
    assert tpolicy.is_worker_loss(exc) == jpolicy.is_worker_loss(exc)


@pytest.mark.parametrize("i", range(len(CARD_EXCEPTIONS)))
def test_classify_card_signatures(i):
    exc, kind = CARD_EXCEPTIONS[i]
    assert tpolicy.classify(exc) == kind
    assert not tpolicy.is_worker_loss(exc)


def test_chaos_errors_classify_by_their_kind():
    for cls in (tchaos.ChaosTransient, tchaos.ChaosResource,
                tchaos.ChaosPermanent, tchaos.ChaosCrash, tchaos.ChaosTimeout,
                tchaos.ChaosCorrupt):
        jcls = getattr(jchaos, cls.__name__)
        assert tpolicy.classify(cls("s", 1)) == jpolicy.classify(
            jcls("s", 1))
        assert str(cls("s", 3)) == str(jcls("s", 3))
    assert tpolicy.is_worker_loss(tchaos.ChaosTransient("worker_kill", 1))


RETRY_ENVS = [None, "", "4", "pager_io=2,*=1", "garbage=zz,pager_io=3",
              "*=0", " pager_io = 5 , ", "x=1,*=7,pager_io=2"]


@pytest.mark.parametrize("env", RETRY_ENVS)
def test_retry_grammar_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("XGBTPU_RETRY", raising=False)
    else:
        monkeypatch.setenv("XGBTPU_RETRY", env)
    for site in ("pager_io", "x", "checkpoint_write", "*"):
        assert tpolicy.retry_budget(site) == jpolicy.retry_budget(site)
        assert tpolicy.RetryPolicy(site, 2).attempts() == \
            jpolicy.RetryPolicy(site, 2).attempts()


@pytest.mark.parametrize("site,seed", [("pager_io", 0), ("checkpoint_write",
                                                        3),
                                       ("collective_level_hist", 17)])
def test_backoff_sequence_matches_jax(site, seed):
    kw = dict(backoff_base=0.05, backoff_cap=0.5, seed=seed)
    t = tpolicy.RetryPolicy(site, 8, **kw)
    j = jpolicy.RetryPolicy(site, 8, **kw)
    assert [t.backoff(a) for a in range(1, 9)] == \
        [j.backoff(a) for a in range(1, 9)]


def test_retry_policy_run_matches_jax(monkeypatch):
    monkeypatch.delenv("XGBTPU_RETRY", raising=False)
    out = []
    for pol in (tpolicy, jpolicy):
        sleeps, calls = [], [0]

        def flaky():
            calls[0] += 1
            if calls[0] < 3:
                raise RuntimeError("transient hiccup")
            return calls[0]

        p = pol.RetryPolicy("flaky_site", retries=3, seed=5,
                            sleep=sleeps.append)
        got = p.run(flaky)
        # a kind that is not retried raises at once; so does a type that
        # is not named in retry_types
        with pytest.raises(NotImplementedError):
            pol.RetryPolicy("flaky_site", retries=5,
                            sleep=sleeps.append).run(not_ported)
        with pytest.raises(RuntimeError):
            pol.RetryPolicy("flaky_site", retries=5, retry_types=(OSError,),
                            sleep=sleeps.append).run(flaky_always)
        out.append((got, sleeps))
    assert out[0] == out[1]
    assert _count("retries_total", site="flaky_site") >= 2
    assert _count("faults_total", site="flaky_site", kind="permanent") >= 1


def flaky_always():
    raise RuntimeError("always")


def not_ported():
    raise NotImplementedError("x")


# ----------------------------------------------------------------- chaos

SCHEDULES = ["site_a:transient:3", "site_a:resource:2,5", "site_a:permanent:4-6",
             "site_a:transient:7+", "site_a:transient:%3",
             "site_a:transient:p0.3@7", "site_a:transient:p0.5@11,1",
             "site_a:crash:2;site_b:timeout:1", "site_a:corrupt:%2",
             "site_b:transient:1;site_a:resource:p0.25"]


@pytest.mark.parametrize("cfg", SCHEDULES)
def test_chaos_schedules_fire_the_same_hits(cfg):
    fired = []
    for ch in (tchaos, jchaos):
        got = []
        with ch.configure(cfg) as plan:
            for n in range(1, 41):
                for site in ("site_a", "site_b", "site_c"):
                    try:
                        ch.hit(site)
                    except ch.ChaosError as e:
                        got.append((site, n, type(e).__name__,
                                    e.hit_index, e.chaos_kind, e.chaos_mode))
            hits = {s: plan.hits(s) for s in ("site_a", "site_b", "site_c")}
        fired.append((got, hits, plan.fired))
    assert fired[0] == fired[1]
    assert fired[0][0], "the schedule fired nothing"


@pytest.mark.parametrize("cfg", ["site_a:bogus:1", "site_a:transient:",
                                 "site_a:transient", "site_a:transient:%0",
                                 "site_a:transient:x"])
def test_bad_chaos_strings_raise(cfg):
    for ch in (tchaos, jchaos):
        with pytest.raises(ValueError):
            ch.ChaosPlan(cfg)


def test_chaos_env_arms_and_rearms(monkeypatch):
    tchaos.reset()
    monkeypatch.setenv("XGBTPU_CHAOS", "env_site:transient:1")
    with pytest.raises(tchaos.ChaosTransient):
        tchaos.hit("env_site")
    tchaos.hit("env_site")  # hit 2: nothing
    monkeypatch.setenv("XGBTPU_CHAOS", "env_site:permanent:1")
    with pytest.raises(tchaos.ChaosPermanent):  # a new string: new counts
        tchaos.hit("env_site")
    monkeypatch.delenv("XGBTPU_CHAOS")
    tchaos.hit("env_site")
    assert tchaos.active_plan() is None
    assert _count("chaos_injections_total", site="env_site") >= 2
    tchaos.reset()


# -------------------------------------------------------------- watchdog

@pytest.mark.parametrize("env", [None, "2.5", "wd2=0.2,*=9", "wd2=x,*=3",
                                 "0", "other=1"])
def test_watchdog_grammar_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("XGBTPU_WATCHDOG", raising=False)
    else:
        monkeypatch.setenv("XGBTPU_WATCHDOG", env)
    for site in ("wd2", "round_dispatch", "other"):
        for default in (None, 600.0):
            assert twatchdog.deadline_for(site, default) == \
                jwatchdog.deadline_for(site, default)


def test_watchdog_times_out_with_its_telemetry(tmp_path):
    flight.configure(str(tmp_path))
    try:
        before = _count("watchdog_timeouts_total", site="wd_port")
        cb = []
        t0 = time.time()
        with pytest.raises(twatchdog.WatchdogTimeout) as ei:
            with twatchdog.watchdog("wd_port", 0.3,
                                    on_timeout=lambda: cb.append(1)):
                for _ in range(200):
                    time.sleep(0.05)
        assert time.time() - t0 < 3
        assert (ei.value.site, ei.value.seconds, cb) == ("wd_port", 0.3, [1])
        assert str(ei.value) == str(jwatchdog.WatchdogTimeout("wd_port", 0.3))
        assert _count("watchdog_timeouts_total", site="wd_port") == before + 1
        box = json.loads((tmp_path / "obs" / f"rank{flight._rank()}"
                          / "blackbox.json").read_text())
        assert box["reason"] == "watchdog:wd_port"
        events = [r for r in box["records"] if r.get("name")
                  == "watchdog_timeout"]
        assert events and events[-1]["args"] == {"site": "wd_port",
                                                 "seconds": 0.3}
    finally:
        flight.RECORDER.reset()
    with twatchdog.watchdog("wd_port", 10.0):
        pass  # under its deadline
    with twatchdog.watchdog("wd_port", 0):
        time.sleep(0.01)  # no deadline


# ------------------------------------------------------------ checkpoint

class _Blob:
    def __init__(self, blob: bytes):
        self._blob = blob

    def save_raw(self):
        return self._blob


def test_checkpoint_roundtrip_retention_matches_jax(tmp_path):
    for mod, sub in ((tckpt, "port"), (jckpt, "jax")):
        d = str(tmp_path / sub)
        os.makedirs(d)
        for r in (1, 2, 3):
            mod.save_checkpoint(d, _Blob(b"model-%d" % r), r)
        assert [os.path.basename(p) for p in mod.list_checkpoints(d)] == [
            "ckpt_00000002.ckpt", "ckpt_00000003.ckpt"]
        assert mod.load_latest(d) == (b"model-3", 3)
        assert not [n for n in os.listdir(d) if ".tmp" in n]
    for r in (2, 3):
        name = f"ckpt_0000000{r}.ckpt"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    assert tckpt.path_rounds("/x/ckpt_00000042.ckpt") == 42
    assert tckpt.path_rounds("/x/other.ckpt") is None


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "header",
                                    "format"])
def test_checkpoint_damage_falls_back_to_previous_good(tmp_path, damage):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, _Blob(b"x" * 64), 4)
    tckpt.save_checkpoint(d, _Blob(b"y" * 64), 5)
    path = tckpt.checkpoint_path(d, 5)
    raw = bytearray(open(path, "rb").read())
    if damage == "truncate":
        raw = raw[:-10]
    elif damage == "bitflip":
        raw[-5] ^= 0x01
    elif damage == "header":
        raw[:1] = b"#"
    else:
        raw = raw.replace(b"xgbtpu-ckpt-v1", b"xgbtpu-ckpt-v9")
    open(path, "wb").write(bytes(raw))
    before = _count("checkpoint_corrupt_total")
    assert tckpt.read_checkpoint(path) is None
    assert _count("checkpoint_corrupt_total") == before + 1
    assert tckpt.verify_checkpoint(path) == jckpt.verify_checkpoint(path)
    assert not tckpt.verify_checkpoint(path)[0]
    assert tckpt.load_latest(d) == (b"x" * 64, 4)
    recs = tckpt.inspect_dir(d)
    assert recs == jckpt.inspect_dir(d)
    assert [(r["rounds"], r["verified"], r["newest_verified"])
            for r in recs][0] == (4, True, True)
    assert tckpt.read_checkpoint(str(tmp_path / "absent.ckpt")) is None


def test_checkpoint_write_chaos_is_retried(tmp_path, monkeypatch):
    monkeypatch.setenv("XGBTPU_RETRY", "checkpoint_write=3")
    before = _count("faults_total", site="checkpoint_write",
                    kind="transient")
    with tchaos.configure("checkpoint_write:transient:1-2") as plan:
        tckpt.save_checkpoint(str(tmp_path), _Blob(b"m"), 1)
    assert len(plan.fired) == 2
    assert _count("faults_total", site="checkpoint_write",
                  kind="transient") == before + 2
    assert "faults_total" in REGISTRY.exposition()
    assert tckpt.load_latest(str(tmp_path)) == (b"m", 1)
    monkeypatch.setenv("XGBTPU_RETRY", "checkpoint_write=0")
    with tchaos.configure("checkpoint_write:transient:1"):
        with pytest.raises(tchaos.ChaosTransient):
            tckpt.save_checkpoint(str(tmp_path), _Blob(b"n"), 2)


def test_process_dir_single_process(tmp_path):
    d = tckpt.process_dir(str(tmp_path / "ck"))
    assert d == str(tmp_path / "ck") and os.path.isdir(d)
    assert tckpt.process_dir(str(tmp_path / "ck"), shared=True) == d


@pytest.fixture(scope="module")
def models():
    """One model trained by each package on the same rows (CPU)."""
    X, y = _data()
    tb = xgbt.train(PARAMS, xgbt.DMatrix(X, y, **CPU), 4, verbose_eval=False)
    jb = xgb.train(PARAMS, xgb.DMatrix(X, label=y), 4, verbose_eval=False)
    return X, tb, jb


def test_port_checkpoint_loads_in_jax(models, tmp_path):
    X, tb, _ = models
    d = str(tmp_path)
    tckpt.save_checkpoint(d, tb, 4)
    ok, detail, rounds = jckpt.verify_checkpoint(tckpt.checkpoint_path(d, 4))
    assert (ok, detail, rounds) == (True, "ok", 4)
    payload, r = jckpt.load_latest(d)
    assert payload == tb.save_raw() and r == 4
    jb = xgb.Booster(model_file=payload)
    np.testing.assert_allclose(
        jb.predict(xgb.DMatrix(X), output_margin=True),
        tb.predict(xgbt.DMatrix(X, **CPU), output_margin=True),
        rtol=1e-6, atol=1e-6)


def test_jax_checkpoint_loads_in_port(models, tmp_path):
    X, _, jb = models
    d = str(tmp_path)
    jckpt.save_checkpoint(d, jb, 4)
    assert tckpt.verify_checkpoint(tckpt.checkpoint_path(d, 4)) == (
        True, "ok", 4)
    payload, r = tckpt.load_latest(d)
    tb = xgbt.Booster(model_file=payload, **CPU)
    assert r == 4 == tb.num_boosted_rounds()
    np.testing.assert_allclose(
        tb.predict(xgbt.DMatrix(X, **CPU), output_margin=True),
        jb.predict(xgb.DMatrix(X), output_margin=True), rtol=1e-6, atol=1e-6)
    # and the port resumes from it: 4 more rounds on the JAX package's trees
    X2, y2 = _data()
    more = xgbt.train(PARAMS, xgbt.DMatrix(X2, y2, **CPU), 6,
                      verbose_eval=False, resume_from=d)
    assert more.num_boosted_rounds() == 6
    assert json.loads(more.save_raw())["learner"]["gradient_booster"][
        "model"]["trees"][:4] == json.loads(payload)["learner"][
        "gradient_booster"]["model"]["trees"]


def test_failed_checkpoint_write_raises_and_keeps_the_previous(
        tmp_path, monkeypatch, models):
    _, tb, _ = models
    monkeypatch.setenv("XGBTPU_RETRY", "checkpoint_write=0")
    d = str(tmp_path)
    tckpt.save_checkpoint(d, tb, 3)
    with tchaos.configure("checkpoint_write:permanent:1"):
        with pytest.raises(tchaos.ChaosPermanent):
            tckpt.save_checkpoint(d, tb, 4)
    assert tckpt.load_latest(d)[1] == 3
    assert [os.path.basename(p) for p in os.listdir(d)] == [
        "ckpt_00000003.ckpt"]
    tckpt.save_checkpoint(d, tb, 4)  # the next write lands
    assert tckpt.load_latest(d) == (tb.save_raw(), 4)


# ------------------------------------------------------- the chaos sites

def test_chaos_at_collective_site():
    from xgboost_tpu.observability import comms as jcomms

    for mod, ch in ((comms, tchaos), (jcomms, jchaos)):
        with ch.configure("collective:transient:2"):
            mod.record("chaos_site", 8)
            with pytest.raises(ch.ChaosTransient):
                mod.record("chaos_site", 8)
            mod.record("chaos_site", 8)


def test_chaos_at_fault_inject():
    from xgboost_tpu.utils import fault as jfault

    for ch, fault in ((tchaos, tfault), (jchaos, jfault)):
        with ch.configure("grow:transient:1"):
            with pytest.raises(ch.ChaosTransient):
                fault.inject("grow")
            fault.inject("grow")  # spent
            fault.inject("gradient")  # another site
    X, y = _data()
    with tchaos.configure("grow:transient:3") as plan:
        with pytest.raises(tchaos.ChaosTransient):
            xgbt.train(PARAMS, xgbt.DMatrix(X, y, **CPU), 5,
                       verbose_eval=False)
    assert plan.fired == [("grow", 3, "transient")]


@pytest.mark.parametrize("fail", ["transient", "persistent"])
def test_chaos_at_collective_timeout_types_as_jax(fail):
    cfg = ("collective_timeout:transient:1" if fail == "transient"
           else "collective_timeout:resource:1+")
    got = []
    for mod, ch in ((tcoll, tchaos), (jcoll, jchaos)):
        with ch.configure(cfg):
            with pytest.raises(mod.CollectiveError) as e:
                mod.guarded("level_hist", lambda: 1)
        got.append((e.value.site, e.value.kind, e.value.worker_lost,
                    type(e.value.cause).__name__))
    assert got[0] == got[1]


class _Mesh:
    group = None


@pytest.mark.parametrize("route,env,times_out", [
    ("host", None, True),
    ("device", None, False),
    ("device", "collective_level_hist=0.2", True),
    ("device", "collective=0.2", True),
])
def test_collective_deadlines(monkeypatch, route, env, times_out):
    """Host collectives take ``DEFAULT_DEADLINE`` (shortened here); the
    device ones (a level's all-reduce) take a deadline only where
    ``XGBTPU_WATCHDOG`` names their site."""
    monkeypatch.setattr(tcoll, "DEFAULT_DEADLINE", 0.2)
    if env is not None:
        monkeypatch.setenv("XGBTPU_WATCHDOG", env)

    def slow(*args, **kwargs):
        for _ in range(20):
            time.sleep(0.05)

    t = torch.zeros(4, dtype=torch.int64)
    if route == "host":
        call = lambda: tcoll.guarded("level_hist", slow)  # noqa: E731
    else:
        monkeypatch.setattr(tcoll.dist, "all_reduce", slow)
        call = lambda: tcoll.all_reduce(  # noqa: E731
            t, _Mesh(), site="level_hist")
    if times_out:
        with pytest.raises(tcoll.CollectiveError) as ei:
            call()
        assert isinstance(ei.value.cause, twatchdog.WatchdogTimeout)
        assert ei.value.site == "level_hist"
    else:
        call()


def _pages(tmp_path, prefix):
    X, y = _data(900, 4)

    class It(xgbt.DataIter):
        def __init__(self):
            super().__init__()
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self, input_data):
            if self.i >= 3:
                return 0
            lo, hi = self.i * 300, (self.i + 1) * 300
            input_data(data=X[lo:hi], label=y[lo:hi])
            self.i += 1
            return 1

    return xgbt.ExternalMemoryQuantileDMatrix(
        It(), cache_prefix=str(tmp_path / prefix), max_bin=16,
        page_rows=256, **CPU)


def test_chaos_pager_io_is_absorbed_by_the_retry(tmp_path, monkeypatch):
    monkeypatch.setenv("XGBTPU_RETRY", "pager_io=3")
    ref = _pages(tmp_path, "ref")
    ref_bst = xgbt.train(PARAMS, ref, 3, verbose_eval=False)
    before = _count("faults_total", site="pager_io", kind="transient")
    with tchaos.configure("pager_io:transient:2,4,%5") as plan:
        d = _pages(tmp_path, "chaos")  # page writes pass the site too
        bst = xgbt.train(PARAMS, d, 3, verbose_eval=False)
    assert plan.fired and plan.hits("pager_io") > len(plan.fired)
    assert _count("faults_total", site="pager_io",
                  kind="transient") == before + len(plan.fired)
    assert bst.save_raw() == ref_bst.save_raw()
    # a prefetched read whose retries run out surfaces at read_page,
    # attributed to its page
    monkeypatch.setenv("XGBTPU_RETRY", "pager_io=1")
    pg = d._paged
    pg.close()  # no read in flight
    with tchaos.configure("pager_io:transient:1-2"):
        pg.start_prefetch(2)
        with pytest.raises(tchaos.ChaosTransient) as ei:
            pg.read_page(2)
    assert ei.value.page == 2
    np.testing.assert_array_equal(pg.read_page(2), ref._paged.read_page(2))
    for m in (ref, d):
        m._paged.cleanup()


def test_chaos_at_pallas_raises_and_train_commits(tmp_path):
    """The kernel-launch site raises on the CPU path too: no retry and no
    plain-version fallback; ``train`` commits the finished rounds on the
    way out and a rerun resumes to the straight run's bytes."""
    X, y = _data()

    def run(**kw):  # fresh matrices: no hoist plan made yet
        d = xgbt.DMatrix(X, y, **CPU)
        dv = xgbt.DMatrix(X[:200], y[:200], **CPU)
        return xgbt.train(PARAMS, d, 6, evals=[(dv, "v")],
                          verbose_eval=False, **kw)

    straight = run()
    ck = str(tmp_path / "ck")
    # hit 1: the hoist plan in round 0; then one eval walk a round
    with tchaos.configure("pallas:permanent:5") as plan:
        with pytest.raises(tchaos.ChaosPermanent):
            run(resume_from=ck)
    assert plan.fired == [("pallas", 5, "permanent")]
    assert tckpt.load_latest(ck)[1] == 4
    assert run(resume_from=ck).save_raw() == straight.save_raw()
    with tchaos.configure("pallas:permanent:1"):
        with pytest.raises(tchaos.ChaosPermanent):
            straight.predict(xgbt.DMatrix(X, **CPU))
