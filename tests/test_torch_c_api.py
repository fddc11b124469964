"""The port's C API (``xgboost_tpu_torch/native/c_api.cpp``,
``libxgbtpu_torch``) held against the JAX package.

Each test is the counterpart of one of ``tests/test_c_api.py``'s, run
through the port's library with ``XGBTPU_DEVICE=cpu`` (in process through
``ctypes``, and from a real C host process), on the same seeded numpy data
as the JAX package's Python API: tree structure and split conditions
equal, leaf values and predictions within rtol 1e-5 / atol 1e-6 (the
parity tolerances of ``tests/test_torch_cli.py``), eval strings within
1e-6 of each value; against the port's own Python API, bit for bit. The
library is built with this machine's ``g++``; a failed build fails.

Beyond the JAX tests: without a card and without ``XGBTPU_DEVICE=cpu``
every handle-creating call returns -1 with ``resolve_device``'s message
(in process and in the C host), an unknown ``XGBTPU_DEVICE`` value fails,
``SetParam("device", ...)`` naming another device fails, and each
``eval_metric`` call adds a metric (the reference learner's rule).
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import xgboost_tpu as xgb
import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch.native import build_capi

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
U64, F32P = ctypes.c_uint64, ctypes.POINTER(ctypes.c_float)
VP = ctypes.c_void_p


def _data(n=600, F=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = ((X @ rng.randn(F)) > 0).astype(np.float32)
    return X, y


class _CApi:
    """The library through ``ctypes``, every entry point typed."""

    SIG = {
        "XGDMatrixCreateFromMat": [F32P, U64, U64, ctypes.c_float,
                                   ctypes.POINTER(VP)],
        "XGDMatrixCreateFromFile": [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(VP)],
        "XGDMatrixCreateFromCSREx": [ctypes.POINTER(U64),
                                     ctypes.POINTER(ctypes.c_uint32), F32P,
                                     ctypes.c_size_t, ctypes.c_size_t,
                                     ctypes.c_size_t, ctypes.POINTER(VP)],
        "XGDMatrixSetFloatInfo": [VP, ctypes.c_char_p, F32P, U64],
        "XGDMatrixSetUIntInfo": [VP, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_uint), U64],
        "XGDMatrixGetFloatInfo": [VP, ctypes.c_char_p, ctypes.POINTER(U64),
                                  ctypes.POINTER(F32P)],
        "XGDMatrixGetUIntInfo": [VP, ctypes.c_char_p, ctypes.POINTER(U64),
                                 ctypes.POINTER(ctypes.POINTER(
                                     ctypes.c_uint))],
        "XGDMatrixNumRow": [VP, ctypes.POINTER(U64)],
        "XGDMatrixNumCol": [VP, ctypes.POINTER(U64)],
        "XGDMatrixSliceDMatrix": [VP, ctypes.POINTER(ctypes.c_int), U64,
                                  ctypes.POINTER(VP)],
        "XGDMatrixFree": [VP],
        "XGBoosterCreate": [ctypes.POINTER(VP), U64, ctypes.POINTER(VP)],
        "XGBoosterFree": [VP],
        "XGBoosterSetParam": [VP, ctypes.c_char_p, ctypes.c_char_p],
        "XGBoosterUpdateOneIter": [VP, ctypes.c_int, VP],
        "XGBoosterBoostOneIter": [VP, VP, F32P, F32P, U64],
        "XGBoosterEvalOneIter": [VP, ctypes.c_int, ctypes.POINTER(VP),
                                 ctypes.POINTER(ctypes.c_char_p), U64,
                                 ctypes.POINTER(ctypes.c_char_p)],
        "XGBoosterPredict": [VP, VP, ctypes.c_int, ctypes.c_uint,
                             ctypes.c_int, ctypes.POINTER(U64),
                             ctypes.POINTER(F32P)],
        "XGBoosterPredictFromDMatrix": [
            VP, VP, ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(U64)),
            ctypes.POINTER(U64), ctypes.POINTER(F32P)],
        "XGBoosterPredictFromDense": [
            VP, ctypes.c_char_p, ctypes.c_char_p, VP,
            ctypes.POINTER(ctypes.POINTER(U64)), ctypes.POINTER(U64),
            ctypes.POINTER(F32P)],
        "XGBoosterPredictFromCSR": [
            VP, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, U64,
            ctypes.c_char_p, VP, ctypes.POINTER(ctypes.POINTER(U64)),
            ctypes.POINTER(U64), ctypes.POINTER(F32P)],
        "XGBoosterSaveModel": [VP, ctypes.c_char_p],
        "XGBoosterLoadModel": [VP, ctypes.c_char_p],
        "XGBoosterSaveModelToBuffer": [VP, ctypes.c_char_p,
                                       ctypes.POINTER(U64),
                                       ctypes.POINTER(ctypes.c_char_p)],
        "XGBoosterLoadModelFromBuffer": [VP, ctypes.c_char_p, U64],
        "XGBoosterSerializeToBuffer": [VP, ctypes.POINTER(U64),
                                       ctypes.POINTER(ctypes.c_char_p)],
        "XGBoosterUnserializeFromBuffer": [VP, ctypes.c_char_p, U64],
        "XGBoosterSaveJsonConfig": [VP, ctypes.POINTER(U64),
                                    ctypes.POINTER(ctypes.c_char_p)],
        "XGBoosterLoadJsonConfig": [VP, ctypes.c_char_p],
        "XGBoosterGetNumFeature": [VP, ctypes.POINTER(U64)],
        "XGBoosterSetAttr": [VP, ctypes.c_char_p, ctypes.c_char_p],
        "XGBoosterGetAttr": [VP, ctypes.c_char_p,
                             ctypes.POINTER(ctypes.c_char_p),
                             ctypes.POINTER(ctypes.c_int)],
        "XGBoosterSetStrFeatureInfo": [VP, ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_char_p), U64],
        "XGBoosterGetStrFeatureInfo": [
            VP, ctypes.c_char_p, ctypes.POINTER(U64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p))],
        "XGBoosterDumpModel": [VP, ctypes.c_char_p, ctypes.c_int,
                               ctypes.POINTER(U64),
                               ctypes.POINTER(ctypes.POINTER(
                                   ctypes.c_char_p))],
    }

    def __init__(self, path):
        self.L = ctypes.CDLL(path)
        self.L.XGBGetLastError.restype = ctypes.c_char_p
        for name, argtypes in self.SIG.items():
            getattr(self.L, name).argtypes = argtypes

    def __getattr__(self, name):
        return getattr(self.L, name)

    def error(self) -> str:
        return self.L.XGBGetLastError().decode()

    def ok(self, rc):
        assert rc == 0, self.error()

    def dmatrix(self, X, y=None, missing=float("nan")):
        X = np.ascontiguousarray(X, np.float32)
        h = VP()
        self.ok(self.XGDMatrixCreateFromMat(
            X.ctypes.data_as(F32P), X.shape[0], X.shape[1], missing,
            ctypes.byref(h)))
        if y is not None:
            self.set_float(h, "label", y)
        return h

    def set_float(self, h, field, v):
        v = np.ascontiguousarray(v, np.float32)
        self.ok(self.XGDMatrixSetFloatInfo(h, field.encode(),
                                           v.ctypes.data_as(F32P), v.size))

    def booster(self, mats, params=()):
        bh = VP()
        arr = (VP * len(mats))(*[m.value for m in mats])
        self.ok(self.XGBoosterCreate(arr if mats else None, len(mats),
                                     ctypes.byref(bh)))
        for k, v in dict(params).items():
            self.ok(self.XGBoosterSetParam(bh, k.encode(), str(v).encode()))
        return bh

    def update(self, bh, h, rounds):
        for it in range(rounds):
            self.ok(self.XGBoosterUpdateOneIter(bh, it, h))

    def eval(self, bh, it, mats, names):
        s = ctypes.c_char_p()
        self.ok(self.XGBoosterEvalOneIter(
            bh, it, (VP * len(mats))(*[m.value for m in mats]),
            (ctypes.c_char_p * len(names))(*[n.encode() for n in names]),
            len(mats), ctypes.byref(s)))
        return s.value.decode()

    def predict(self, bh, h, mask=0, ntree_limit=0):
        n, p = U64(), F32P()
        self.ok(self.XGBoosterPredict(bh, h, mask, ntree_limit, 0,
                                      ctypes.byref(n), ctypes.byref(p)))
        return np.ctypeslib.as_array(p, shape=(n.value,)).copy()

    def shaped(self, fn, *args):
        shp, dim, res = ctypes.POINTER(U64)(), U64(), F32P()
        self.ok(fn(*args, ctypes.byref(shp), ctypes.byref(dim),
                   ctypes.byref(res)))
        shape = tuple(shp[i] for i in range(dim.value))
        return np.ctypeslib.as_array(
            res, shape=(int(np.prod(shape)),)).copy().reshape(shape)

    def raw(self, bh):
        n, p = U64(), ctypes.c_char_p()
        self.ok(self.XGBoosterSaveModelToBuffer(bh, b"{}", ctypes.byref(n),
                                                ctypes.byref(p)))
        return ctypes.string_at(p, n.value)

    def strings(self, fn, *args):
        n, p = U64(), ctypes.POINTER(ctypes.c_char_p)()
        self.ok(fn(*args, ctypes.byref(n), ctypes.byref(p)))
        return [p[i] for i in range(n.value)]


@pytest.fixture(scope="module")
def lib():
    return _CApi(build_capi())


@pytest.fixture(autouse=True)
def _cpu_handles(monkeypatch):
    monkeypatch.setenv("XGBTPU_DEVICE", "cpu")


def _trees(raw):
    return json.loads(raw)["learner"]["gradient_booster"]["model"]["trees"]


def _assert_same_trees(jt, tt):
    """Structure and split conditions equal (depth 6 or less), leaf
    values within the parity tolerance."""
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        for key in ("left_children", "right_children", "split_indices"):
            assert a[key] == b[key], key
        inner = np.asarray(a["left_children"]) >= 0
        np.testing.assert_array_equal(
            np.asarray(a["split_conditions"], np.float32)[inner],
            np.asarray(b["split_conditions"], np.float32)[inner])
        np.testing.assert_allclose(b["base_weights"], a["base_weights"],
                                   rtol=RTOL, atol=ATOL)


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def _same_evals(got: str, want: str):
    """Eval strings: the same names, values within 1e-6."""
    g, w = got.split("\t"), want.split("\t")
    assert g[0] == w[0] and len(g) == len(w), (got, want)
    for a, b in zip(g[1:], w[1:]):
        (na, va), (nb, vb) = a.rsplit(":", 1), b.rsplit(":", 1)
        assert na == nb and abs(float(va) - float(vb)) <= 1e-6, (got, want)


PARAMS = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.4,
          "max_bin": 32, "seed": 7, "verbosity": 0}


def test_c_api_train_predict_matches_python(lib, tmp_path):
    X, y = _data()
    n, F = X.shape
    h = lib.dmatrix(X, y)
    out = U64()
    lib.ok(lib.XGDMatrixNumRow(h, ctypes.byref(out)))
    assert out.value == n
    lib.ok(lib.XGDMatrixNumCol(h, ctypes.byref(out)))
    assert out.value == F
    bh = lib.booster([h], PARAMS)
    evals = []
    for it in range(5):
        lib.ok(lib.XGBoosterUpdateOneIter(bh, it, h))
        evals.append(lib.eval(bh, it, [h], ["train"]))
    assert evals[4].startswith("[4]") and "train-" in evals[4]
    pred_c = lib.predict(bh, h)

    # the port's Python API: the same bytes, predictions and eval strings
    d = xgbt.DMatrix(X, y, device="cpu")
    tb = xgbt.Booster(PARAMS, [d], device="cpu")
    tevals = []
    for it in range(5):
        tb.update(d, it)
        tevals.append(tb.eval_set([(d, "train")], it))
    assert lib.raw(bh) == tb.save_raw() and evals == tevals
    np.testing.assert_array_equal(pred_c, tb.predict(d))
    # the JAX package: the same trees, predictions and evals in tolerance
    jd = xgb.DMatrix(X, label=y)
    jb = xgb.Booster(PARAMS, [jd])
    for it in range(5):
        jb.update(jd, it)
        _same_evals(evals[it], jb.eval_set([(jd, "train")], it))
    _assert_same_trees(_trees(jb.save_raw()), _trees(lib.raw(bh)))
    _close(pred_c, jb.predict(jd))

    # save through C, load into a fresh handle, margins
    mpath = str(tmp_path / "capi_model.json").encode()
    lib.ok(lib.XGBoosterSaveModel(bh, mpath))
    bh2 = lib.booster([])
    lib.ok(lib.XGBoosterLoadModel(bh2, mpath))
    margin_c = lib.predict(bh2, h, mask=1)
    np.testing.assert_array_equal(margin_c, tb.predict(d, output_margin=True))
    _close(margin_c, jb.predict(jd, output_margin=True))
    lib.ok(lib.XGBoosterGetNumFeature(bh2, ctypes.byref(out)))
    assert out.value == F

    lib.ok(lib.XGBoosterSetAttr(bh, b"best_iteration", b"4"))
    sa, ok = ctypes.c_char_p(), ctypes.c_int()
    lib.ok(lib.XGBoosterGetAttr(bh, b"best_iteration", ctypes.byref(sa),
                                ctypes.byref(ok)))
    assert ok.value == 1 and sa.value == b"4"
    lib.ok(lib.XGBoosterGetAttr(bh, b"absent", ctypes.byref(sa),
                                ctypes.byref(ok)))
    assert ok.value == 0 and sa.value is None
    for fn, handle in ((lib.XGBoosterFree, bh), (lib.XGBoosterFree, bh2),
                       (lib.XGDMatrixFree, h)):
        lib.ok(fn(handle))


def test_c_api_exports_the_jax_entry_points(lib):
    """Every ``XGB_DLL`` function of the JAX package's ``c_api.cpp`` is in
    the port's source and exported by its library."""
    import re

    def names(path):
        return set(re.findall(r"XGB_DLL\s+[\w\s\*]+?\b(XG\w+)\s*\(",
                              path.read_text()))

    jax_names = names(ROOT / "xgboost_tpu" / "native" / "c_api.cpp")
    assert len(jax_names) == 37
    assert names(ROOT / "xgboost_tpu_torch" / "native" / "c_api.cpp") \
        == jax_names
    for name in jax_names:
        assert hasattr(lib.L, name), name


def test_c_api_error_contract(lib):
    bh = lib.booster([])
    rc = lib.XGBoosterSetParam(bh, b"tree_method", b"no_such_method")
    if rc == 0:  # parameters may validate lazily
        rc = lib.XGBoosterLoadModel(bh, b"/nonexistent/path.json")
    assert rc == -1 and lib.error()
    # the JAX package's C API fails the same call
    jb = xgb.Booster()
    with pytest.raises(Exception):
        jb.set_param("tree_method", "no_such_method")
        jb.load_model("/nonexistent/path.json")
    lib.ok(lib.XGBoosterFree(bh))


def test_c_api_custom_objective_boost(lib):
    """``XGBoosterBoostOneIter``: caller-given gradients."""
    X, y = _data(300, 4, seed=3)
    n = len(y)
    h = lib.dmatrix(X, y)
    params = {"max_depth": 3, "max_bin": 16, "verbosity": 0}
    bh = lib.booster([h], params)
    g = np.ascontiguousarray((0.5 - y).astype(np.float32))
    hs = np.ascontiguousarray(np.full(n, 0.25, np.float32))
    lib.ok(lib.XGBoosterBoostOneIter(bh, h, g.ctypes.data_as(F32P),
                                     hs.ctypes.data_as(F32P), n))
    m = lib.predict(bh, h, mask=1)
    assert np.isfinite(m).all() and m.std() > 0
    jd = xgb.DMatrix(X, label=y)
    jb = xgb.Booster(params, [jd])
    jb.boost(jd, g, hs)
    _assert_same_trees(_trees(jb.save_raw()), _trees(lib.raw(bh)))
    _close(m, jb.predict(jd, output_margin=True))
    lib.ok(lib.XGBoosterFree(bh))
    lib.ok(lib.XGDMatrixFree(h))


C_HOST = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

typedef unsigned long long bst_ulong;
extern const char *XGBGetLastError(void);
extern int XGDMatrixCreateFromMat(const float*, bst_ulong, bst_ulong,
                                  float, void**);
extern int XGDMatrixSetFloatInfo(void*, const char*, const float*,
                                 bst_ulong);
extern int XGDMatrixFree(void*);
extern int XGBoosterCreate(void**, bst_ulong, void**);
extern int XGBoosterSetParam(void*, const char*, const char*);
extern int XGBoosterUpdateOneIter(void*, int, void*);
extern int XGBoosterPredict(void*, void*, int, unsigned, int,
                            bst_ulong*, const float**);
extern int XGBoosterFree(void*);
extern int XGBoosterSaveJsonConfig(void*, bst_ulong*, const char**);
extern int XGBoosterSerializeToBuffer(void*, bst_ulong*, const char**);
extern int XGBoosterUnserializeFromBuffer(void*, const void*, bst_ulong);
extern int XGDMatrixSliceDMatrix(void*, const int*, bst_ulong, void**);
extern int XGBoosterSetStrFeatureInfo(void*, const char*, const char**,
                                      bst_ulong);
extern int XGBoosterGetStrFeatureInfo(void*, const char*, bst_ulong*,
                                      const char***);

#define CK(x) if ((x) != 0) { \
  fprintf(stderr, "FAIL: %s\n", XGBGetLastError()); return 1; }

int main(int argc, char **argv) {
  enum { N = 256, F = 3 };
  static float data[N * F], label[N];
  unsigned s = 12345;
  for (int i = 0; i < N; ++i) {
    float acc = 0;
    for (int j = 0; j < F; ++j) {
      s = s * 1103515245u + 12345u;
      float v = ((float)(s >> 16) / 32768.0f) - 1.0f;
      data[i * F + j] = v;
      acc += v;
    }
    label[i] = acc > 0 ? 1.0f : 0.0f;
  }
  void *dmat = NULL, *bst = NULL;
  CK(XGDMatrixCreateFromMat(data, N, F, nanf(""), &dmat));
  CK(XGDMatrixSetFloatInfo(dmat, "label", label, N));
  void *mats[1] = {dmat};
  CK(XGBoosterCreate(mats, 1, &bst));
  CK(XGBoosterSetParam(bst, "objective", "binary:logistic"));
  CK(XGBoosterSetParam(bst, "max_depth", "3"));
  CK(XGBoosterSetParam(bst, "verbosity", "0"));
  for (int it = 0; it < 4; ++it) CK(XGBoosterUpdateOneIter(bst, it, dmat));
  bst_ulong len = 0;
  const float *out = NULL;
  CK(XGBoosterPredict(bst, dmat, 0, 0, 0, &len, &out));
  if (len != N) { fprintf(stderr, "bad len\n"); return 1; }
  int correct = 0;
  for (int i = 0; i < N; ++i)
    correct += (out[i] > 0.5f) == (label[i] > 0.5f);
  printf("C_HOST_ACC=%.3f\n", (double)correct / N);
  if (argc > 1) {  /* the data and the predictions, raw float32 */
    FILE *f = fopen(argv[1], "wb");
    if (!f) return 1;
    fwrite(data, sizeof(float), N * F, f);
    fwrite(label, sizeof(float), N, f);
    fwrite(out, sizeof(float), N, f);
    fclose(f);
  }

  bst_ulong cfg_len = 0;
  const char *cfg = NULL;
  CK(XGBoosterSaveJsonConfig(bst, &cfg_len, &cfg));
  if (cfg_len == 0 || strstr(cfg, "learner") == NULL) {
    fprintf(stderr, "bad config json\n"); return 1;
  }
  bst_ulong ser_len = 0;
  const char *ser = NULL;
  CK(XGBoosterSerializeToBuffer(bst, &ser_len, &ser));
  void *bst2 = NULL;
  CK(XGBoosterCreate(NULL, 0, &bst2));
  CK(XGBoosterUnserializeFromBuffer(bst2, ser, ser_len));
  bst_ulong len2 = 0;
  const float *out2 = NULL;
  CK(XGBoosterPredict(bst2, dmat, 0, 0, 0, &len2, &out2));
  if (len2 != len) { fprintf(stderr, "bad unserialized len\n"); return 1; }
  for (bst_ulong i = 0; i < len; ++i) {
    if (out2[i] != out[i]) {
      fprintf(stderr, "unserialized predict mismatch at %llu\n", i);
      return 1;
    }
  }
  printf("C_HOST_SERIALIZE=OK\n");

  int idx[64];
  for (int i = 0; i < 64; ++i) idx[i] = i * 2;
  static float full[N];
  memcpy(full, out, sizeof(float) * N);
  void *dslice = NULL;
  CK(XGDMatrixSliceDMatrix(dmat, idx, 64, &dslice));
  bst_ulong slen = 0;
  const float *sout = NULL;
  CK(XGBoosterPredict(bst, dslice, 0, 0, 0, &slen, &sout));
  if (slen != 64) { fprintf(stderr, "bad slice len\n"); return 1; }
  for (int i = 0; i < 64; ++i) {
    if (sout[i] != full[idx[i]]) {
      fprintf(stderr, "slice predict mismatch at %d\n", i);
      return 1;
    }
  }
  printf("C_HOST_SLICE=OK\n");

  const char *names[F] = {"alpha", "beta", "gamma"};
  CK(XGBoosterSetStrFeatureInfo(bst, "feature_name", names, F));
  bst_ulong nlen = 0;
  const char **got_names = NULL;
  CK(XGBoosterGetStrFeatureInfo(bst, "feature_name", &nlen, &got_names));
  if (nlen != F) { fprintf(stderr, "bad feature_name len\n"); return 1; }
  for (int j = 0; j < F; ++j) {
    if (strcmp(got_names[j], names[j]) != 0) {
      fprintf(stderr, "feature_name mismatch at %d: %s\n", j, got_names[j]);
      return 1;
    }
  }
  printf("C_HOST_FEATINFO=OK\n");

  CK(XGDMatrixFree(dslice));
  CK(XGBoosterFree(bst2));
  CK(XGBoosterFree(bst));
  CK(XGDMatrixFree(dmat));
  return 0;
}
"""


@pytest.fixture(scope="module")
def c_host(tmp_path_factory):
    """``C_HOST`` compiled and linked against the port's library (never
    also against the JAX package's: both export the same symbols)."""
    path = Path(build_capi())
    d = tmp_path_factory.mktemp("c_host")
    (d / "host.c").write_text(C_HOST)
    r = subprocess.run(
        ["gcc", str(d / "host.c"), "-o", str(d / "host"), f"-L{path.parent}",
         f"-l:{path.name}", f"-Wl,-rpath,{path.parent}", "-lm"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    return d / "host"


def _run_host(exe, *args, **env):
    full = {k: v for k, v in os.environ.items() if k != "XGBTPU_DEVICE"}
    full.update(env)
    return subprocess.run([str(exe), *args], capture_output=True, text=True,
                          env=full, timeout=600)


def test_c_api_from_real_c_host(c_host, tmp_path):
    """A C program linked against ``libxgbtpu_torch``: the embedded
    interpreter's path. Its predictions equal the port's Python API's bit
    for bit and the JAX package's within tolerance."""
    dump = tmp_path / "host.bin"
    out = _run_host(c_host, str(dump), XGBTPU_DEVICE="cpu")
    assert out.returncode == 0, (out.stdout, out.stderr[-2000:])
    acc = float(out.stdout.split("C_HOST_ACC=")[1].split()[0])
    assert acc > 0.9, out.stdout
    for tag in ("SERIALIZE", "SLICE", "FEATINFO"):
        assert f"C_HOST_{tag}=OK" in out.stdout, out.stdout
    raw = np.fromfile(dump, np.float32)
    N, F = 256, 3
    X, y, pred = raw[:N * F].reshape(N, F), raw[N * F:N * F + N], raw[-N:]
    params = {"objective": "binary:logistic", "max_depth": 3, "verbosity": 0}
    tb = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 4)
    np.testing.assert_array_equal(pred, tb.predict(
        xgbt.DMatrix(X, device="cpu")))
    jb = xgb.train(params, xgb.DMatrix(X, label=y), 4)
    _close(pred, jb.predict(xgb.DMatrix(X)))


def test_c_host_without_a_card_fails_at_the_first_handle(c_host):
    """No card here and no ``XGBTPU_DEVICE``: the C host's first
    ``XGDMatrixCreateFromMat`` returns -1 with ``resolve_device``'s
    message, and the host exits 1 (nothing ran on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    out = _run_host(c_host)
    assert out.returncode == 1, (out.stdout, out.stderr[-2000:])
    assert "C_HOST_ACC" not in out.stdout
    assert "FAIL: device='cuda' requested" in out.stderr, out.stderr[-2000:]


def test_c_api_csr_dump_and_buffer_roundtrip(lib):
    X = sp.random(500, 6, density=0.4, format="csr", random_state=1,
                  dtype=np.float32)
    y = (np.asarray(X.sum(axis=1)).ravel() > 0.5).astype(np.float32)
    indptr = np.ascontiguousarray(X.indptr, np.uint64)
    indices = np.ascontiguousarray(X.indices, np.uint32)
    vals = np.ascontiguousarray(X.data, np.float32)
    h = VP()
    lib.ok(lib.XGDMatrixCreateFromCSREx(
        indptr.ctypes.data_as(ctypes.POINTER(U64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vals.ctypes.data_as(F32P), len(indptr), len(vals), X.shape[1],
        ctypes.byref(h)))
    out = U64()
    lib.ok(lib.XGDMatrixNumRow(h, ctypes.byref(out)))
    assert out.value == 500
    lib.set_float(h, "label", y)
    params = {"objective": "binary:logistic", "max_depth": 3,
              "verbosity": 0, "seed": 5}
    bh = lib.booster([h], params)
    lib.update(bh, h, 3)
    dump = lib.strings(lib.XGBoosterDumpModel, bh, b"", 0)
    assert len(dump) == 3 and b"leaf" in dump[0]
    raw = lib.raw(bh)
    jb = xgb.train(params, xgb.DMatrix(X, label=y), 3)
    _assert_same_trees(_trees(jb.save_raw()), _trees(raw))
    tb = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 3)
    assert raw == tb.save_raw()
    assert [s.decode() for s in dump] == tb.get_dump()
    bh2 = lib.booster([])
    lib.ok(lib.XGBoosterLoadModelFromBuffer(bh2, raw, len(raw)))
    p1 = lib.predict(bh, h)
    np.testing.assert_array_equal(p1, lib.predict(bh2, h))
    _close(p1, jb.predict(xgb.DMatrix(X)))
    for fn, handle in ((lib.XGBoosterFree, bh), (lib.XGBoosterFree, bh2),
                       (lib.XGDMatrixFree, h)):
        lib.ok(fn(handle))


def test_c_api_predict_from_dmatrix(lib):
    X, y = _data(400, 4, seed=9)
    n, F = X.shape
    h = lib.dmatrix(X, y)
    params = {"objective": "binary:logistic", "max_depth": 3, "seed": 2,
              "verbosity": 0}
    bh = lib.booster([h], params)
    lib.update(bh, h, 4)

    def run(cfg: bytes):
        return lib.shaped(lib.XGBoosterPredictFromDMatrix, bh, h, cfg)

    jd = xgb.DMatrix(X, label=y)
    jb = xgb.train(params, jd, 4)
    td = xgbt.DMatrix(X, device="cpu")
    tb = xgbt.Booster(model_file=lib.raw(bh), device="cpu")
    value = run(b'{"type": 0}')
    np.testing.assert_array_equal(value, tb.predict(td))
    _close(value, jb.predict(jd))
    _close(run(b'{"type": 1}'), jb.predict(jd, output_margin=True))
    leaf = run(b'{"type": 6}')
    assert leaf.shape == (n, 4)
    np.testing.assert_array_equal(leaf, jb.predict(jd, pred_leaf=True))
    contribs = run(b'{"type": 2}')
    assert contribs.shape == (n, F + 1)
    np.testing.assert_allclose(contribs, jb.predict(jd, pred_contribs=True),
                               rtol=RTOL, atol=1e-5)
    _close(run(b'{"type": 0, "iteration_begin": 0, "iteration_end": 2}'),
           jb.predict(jd, iteration_range=(0, 2)))
    rc = lib.XGBoosterPredictFromDMatrix(
        bh, h, b'{"type": 7}', ctypes.byref(ctypes.POINTER(U64)()),
        ctypes.byref(U64()), ctypes.byref(F32P()))
    assert rc == -1 and "unsupported type" in lib.error()
    lib.ok(lib.XGBoosterFree(bh))
    lib.ok(lib.XGDMatrixFree(h))


def test_c_api_set_uint_info_exact_above_2_24(lib):
    """``XGDMatrixSetUIntInfo``: uint32 query ids at and above 2^24 keep
    their values (two groups of 2 rows, as in the JAX package)."""
    X, _ = _data(4, 3, seed=5)
    h = lib.dmatrix(X)
    big = np.uint32(1 << 24)
    qid = np.ascontiguousarray(np.asarray([big, big, big + 1, big + 1],
                                          np.uint32))
    lib.ok(lib.XGDMatrixSetUIntInfo(
        h, b"qid", qid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)), 4))
    n, p = U64(), ctypes.POINTER(ctypes.c_uint)()
    lib.ok(lib.XGDMatrixGetUIntInfo(h, b"group_ptr", ctypes.byref(n),
                                    ctypes.byref(p)))
    gp = np.ctypeslib.as_array(p, shape=(n.value,)).copy()
    np.testing.assert_array_equal(gp, [0, 2, 4])
    jd = xgb.DMatrix(X)
    jd.set_info(qid=qid.astype(np.int64))
    np.testing.assert_array_equal(gp, jd.get_uint_info("group_ptr"))
    lib.ok(lib.XGDMatrixFree(h))


def test_c_api_serialize_and_json_config(lib):
    """The full state (model and configuration) through
    Serialize/Unserialize, and Save/LoadJsonConfig, as in the JAX
    package."""
    X, y = _data(300, 4, seed=13)
    h = lib.dmatrix(X, y)
    params = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.3,
              "max_bin": 16, "seed": 9, "verbosity": 0}
    bh = lib.booster([h], params)
    lib.update(bh, h, 3)
    n, p = U64(), ctypes.c_char_p()
    lib.ok(lib.XGBoosterSaveJsonConfig(bh, ctypes.byref(n), ctypes.byref(p)))
    cfg = json.loads(ctypes.string_at(p, n.value))
    assert cfg["learner"]["objective"]["name"] == "binary:logistic"
    assert cfg["learner"]["gradient_booster"]["params"]["max_depth"] == "4"
    jcfg = json.loads(xgb.train(params, xgb.DMatrix(X, label=y),
                                1).save_config())
    assert cfg["learner"]["objective"] == jcfg["learner"]["objective"]

    lib.ok(lib.XGBoosterSerializeToBuffer(bh, ctypes.byref(n),
                                          ctypes.byref(p)))
    blob = ctypes.string_at(p, n.value)
    assert json.loads(blob)["device"] == "cpu"
    bh2 = lib.booster([])
    lib.ok(lib.XGBoosterUnserializeFromBuffer(bh2, blob, len(blob)))
    p1 = lib.predict(bh, h)
    np.testing.assert_array_equal(p1, lib.predict(bh2, h))
    lib.ok(lib.XGBoosterSaveJsonConfig(bh2, ctypes.byref(n), ctypes.byref(p)))
    cfg_text = ctypes.string_at(p, n.value)
    cfg2 = json.loads(cfg_text)
    assert cfg2["learner"]["gradient_booster"]["params"]["max_depth"] == "4"
    bh3 = lib.booster([h])
    lib.ok(lib.XGBoosterLoadJsonConfig(bh3, cfg_text))
    lib.update(bh3, h, 3)
    np.testing.assert_array_equal(lib.predict(bh3, h), p1)
    jb = xgb.train(params, xgb.DMatrix(X, label=y), 3)
    _close(p1, jb.predict(xgb.DMatrix(X)))
    rc = lib.XGBoosterUnserializeFromBuffer(bh2, b"not json", 8)
    assert rc == -1 and lib.error()
    for b in (bh, bh2, bh3):
        lib.ok(lib.XGBoosterFree(b))
    lib.ok(lib.XGDMatrixFree(h))


def _array_interface(arr: np.ndarray) -> bytes:
    return json.dumps({"data": [arr.ctypes.data, True],
                       "shape": list(arr.shape),
                       "typestr": arr.__array_interface__["typestr"],
                       "version": 3}).encode()


def test_c_api_inplace_predict_dense_and_csr(lib):
    X, y = _data(400, 5, seed=21)
    F = X.shape[1]
    params = {"objective": "binary:logistic", "max_depth": 3, "seed": 7,
              "verbosity": 0}
    tb = xgbt.train(params, xgbt.DMatrix(X, y, device="cpu"), 4)
    blob = tb.save_raw()
    _assert_same_trees(_trees(xgb.train(params, xgb.DMatrix(X, label=y),
                                        4).save_raw()), _trees(blob))
    # the JAX package's predictor on the same model (the training rows
    # have no missing values, so the packages' default directions may
    # differ between their own models)
    jb = xgb.Booster(model_file=bytearray(blob))
    bh = lib.booster([])
    lib.ok(lib.XGBoosterLoadModelFromBuffer(bh, blob, len(blob)))

    def dense(arr, cfg):
        return lib.shaped(lib.XGBoosterPredictFromDense, bh,
                          _array_interface(arr), json.dumps(cfg).encode(),
                          None)

    Xc = np.ascontiguousarray(X)
    for cfg, kw in (({"type": 0}, {}),
                    ({"type": 1}, {"predict_type": "margin"}),
                    ({"type": 0, "iteration_begin": 0, "iteration_end": 2},
                     {"iteration_range": (0, 2)}),
                    ({"type": 0, "iteration_begin": 2, "iteration_end": 0},
                     {"iteration_range": (2, 0)})):
        got = dense(Xc, cfg)
        np.testing.assert_array_equal(got, tb.inplace_predict(X, **kw))
        _close(got, jb.inplace_predict(X, **kw))
    Xm = np.ascontiguousarray(X.copy())
    Xm[::7, 0] = -999.0
    got = dense(Xm, {"type": 0, "missing": -999.0})
    np.testing.assert_array_equal(got, tb.inplace_predict(Xm, missing=-999.0))
    _close(got, jb.inplace_predict(Xm, missing=-999.0))

    Xs = sp.random(200, F, density=0.5, format="csr", random_state=3,
                   dtype=np.float32)
    indptr = np.ascontiguousarray(Xs.indptr.astype(np.uint64))
    indices = np.ascontiguousarray(Xs.indices.astype(np.uint32))
    values = np.ascontiguousarray(Xs.data)
    got = lib.shaped(lib.XGBoosterPredictFromCSR, bh,
                     _array_interface(indptr), _array_interface(indices),
                     _array_interface(values), F, b'{"type": 0}', None)
    np.testing.assert_array_equal(got, tb.inplace_predict(Xs))
    _close(got, jb.inplace_predict(Xs))
    # an unsupported type and a malformed field fail with a message
    for cfg in ({"type": 6}, {"type": 0, "iteration_end": "3"}):
        rc = lib.XGBoosterPredictFromDense(
            bh, _array_interface(Xc), json.dumps(cfg).encode(), None,
            ctypes.byref(ctypes.POINTER(U64)()), ctypes.byref(U64()),
            ctypes.byref(F32P()))
        assert rc == -1 and lib.error()
    lib.ok(lib.XGBoosterFree(bh))


def test_c_api_slice_dmatrix(lib):
    X, y = _data(300, 4, seed=17)
    n, F = X.shape
    h = lib.dmatrix(X, y)
    idx = np.ascontiguousarray(np.arange(1, n, 3, dtype=np.int32))
    h2 = VP()
    lib.ok(lib.XGDMatrixSliceDMatrix(
        h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(idx),
        ctypes.byref(h2)))
    out = U64()
    lib.ok(lib.XGDMatrixNumRow(h2, ctypes.byref(out)))
    assert out.value == len(idx)
    lib.ok(lib.XGDMatrixNumCol(h2, ctypes.byref(out)))
    assert out.value == F
    flen, fptr = U64(), F32P()
    lib.ok(lib.XGDMatrixGetFloatInfo(h2, b"label", ctypes.byref(flen),
                                     ctypes.byref(fptr)))
    got = np.ctypeslib.as_array(fptr, shape=(flen.value,)).copy()
    np.testing.assert_array_equal(got, y[idx])
    np.testing.assert_array_equal(
        got, xgb.DMatrix(X, label=y).slice(idx).get_label())
    params = {"objective": "binary:logistic", "max_depth": 3, "max_bin": 16,
              "seed": 3, "verbosity": 0}
    bh = lib.booster([h], params)
    lib.update(bh, h, 3)
    full = lib.predict(bh, h, mask=1)
    np.testing.assert_array_equal(lib.predict(bh, h2, mask=1), full[idx])
    jb = xgb.train(params, xgb.DMatrix(X, label=y), 3)
    _close(full[idx], jb.predict(xgb.DMatrix(X).slice(idx),
                                 output_margin=True))
    lib.ok(lib.XGBoosterFree(bh))
    lib.ok(lib.XGDMatrixFree(h2))
    lib.ok(lib.XGDMatrixFree(h))


def test_c_api_str_feature_info_roundtrip(lib):
    X, y = _data(200, 3, seed=23)
    tb = xgbt.train({"objective": "binary:logistic", "max_depth": 2,
                     "max_bin": 16, "verbosity": 0},
                    xgbt.DMatrix(X, y, device="cpu"), 2)
    blob = tb.save_raw()
    bh = lib.booster([])
    lib.ok(lib.XGBoosterLoadModelFromBuffer(bh, blob, len(blob)))
    names = [b"age", b"bmi", b"dose"]
    types = [b"float", b"float", b"int"]
    for field, vals in ((b"feature_name", names), (b"feature_type", types)):
        lib.ok(lib.XGBoosterSetStrFeatureInfo(
            bh, field, (ctypes.c_char_p * 3)(*vals), 3))
        assert lib.strings(lib.XGBoosterGetStrFeatureInfo, bh, field) == vals
    raw = lib.raw(bh)
    bh2 = lib.booster([])
    lib.ok(lib.XGBoosterLoadModelFromBuffer(bh2, raw, len(raw)))
    assert lib.strings(lib.XGBoosterGetStrFeatureInfo, bh2,
                       b"feature_name") == names
    # the JAX package reads the names the port wrote
    jb = xgb.Booster(model_file=bytearray(raw))
    assert jb.feature_names == [n.decode() for n in names]
    lib.ok(lib.XGBoosterSetStrFeatureInfo(bh, b"feature_name", None, 0))
    assert lib.strings(lib.XGBoosterGetStrFeatureInfo, bh,
                       b"feature_name") == []
    rc = lib.XGBoosterSetStrFeatureInfo(
        bh, b"no_such_field", (ctypes.c_char_p * 1)(b"x"), 1)
    assert rc == -1 and lib.error()
    lib.ok(lib.XGBoosterFree(bh))
    lib.ok(lib.XGBoosterFree(bh2))


def test_dmatrix_slice_python_semantics():
    """The Python side of ``XGDMatrixSliceDMatrix`` against the JAX
    package's: boolean masks, sparse input stays sparse, grouped matrices
    refuse without ``allow_groups``, out-of-range rows raise."""
    X, y = _data(120, 4, seed=29)
    w = np.arange(120, dtype=np.float32)
    mask = X[:, 0] > 0
    td = xgbt.DMatrix(X, y, weight=w, device="cpu").slice(mask)
    jd = xgb.DMatrix(X, label=y, weight=w).slice(mask)
    assert td.num_row() == jd.num_row() == int(mask.sum())
    np.testing.assert_array_equal(td.get_label(), jd.get_label())
    np.testing.assert_array_equal(td.get_weight(), jd.get_weight())
    Xs = sp.random(80, 5, density=0.4, format="csr", random_state=1,
                   dtype=np.float32)
    ts = xgbt.DMatrix(Xs, device="cpu").slice(np.arange(0, 80, 2))
    assert ts._csr_only()
    np.testing.assert_array_equal(
        np.asarray(ts.get_data().todense()),
        np.asarray(xgb.DMatrix(Xs).slice(np.arange(0, 80, 2))
                   .get_data().todense()))
    for mod, kw in ((xgbt, dict(device="cpu")), (xgb, {})):
        dg = mod.DMatrix(X, label=y, group=[60, 60], **kw)
        with pytest.raises(ValueError, match="group"):
            dg.slice(np.arange(10))
        assert dg.slice(np.arange(10), allow_groups=True).num_row() == 10
        with pytest.raises(IndexError):
            mod.DMatrix(X, **kw).slice(np.asarray([200]))


def test_c_api_predict_ntree_limit_counts_trees(lib):
    """``ntree_limit`` counts trees: 6 trees of a 3-class model are its
    first 2 rounds."""
    rng = np.random.RandomState(11)
    X = rng.randn(300, 4).astype(np.float32)
    y = rng.randint(0, 3, 300).astype(np.float32)
    h = lib.dmatrix(X, y)
    params = {"objective": "multi:softprob", "num_class": 3, "max_depth": 3,
              "seed": 4, "verbosity": 0}
    bh = lib.booster([h], params)
    lib.update(bh, h, 4)
    got = lib.predict(bh, h, ntree_limit=6)
    tb = xgbt.Booster(model_file=lib.raw(bh), device="cpu")
    np.testing.assert_array_equal(got, tb.predict(
        xgbt.DMatrix(X, device="cpu"), iteration_range=(0, 2)).ravel())
    jb = xgb.train(params, xgb.DMatrix(X, label=y), 4)
    _close(got, jb.predict(xgb.DMatrix(X), ntree_limit=6).ravel())
    lib.ok(lib.XGBoosterFree(bh))
    lib.ok(lib.XGDMatrixFree(h))


def test_c_api_without_a_card_every_handle_call_fails(lib, monkeypatch,
                                                      tmp_path):
    """No card and no ``XGBTPU_DEVICE=cpu``: each call that creates a
    handle returns -1 with ``resolve_device``'s message; an unknown
    ``XGBTPU_DEVICE`` value fails as well."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("XGBTPU_DEVICE")
    X, _ = _data(10, 3)
    path = tmp_path / "d.libsvm"
    path.write_text("1 0:1.5\n0 1:2\n")
    indptr = np.asarray([0, 1], np.uint64)
    indices = np.asarray([0], np.uint32)
    vals = np.asarray([1.0], np.float32)
    h = VP()
    calls = {
        "CreateFromMat": lambda: lib.XGDMatrixCreateFromMat(
            np.ascontiguousarray(X).ctypes.data_as(F32P), 10, 3,
            float("nan"), ctypes.byref(h)),
        "CreateFromFile": lambda: lib.XGDMatrixCreateFromFile(
            str(path).encode(), 1, ctypes.byref(h)),
        "CreateFromCSREx": lambda: lib.XGDMatrixCreateFromCSREx(
            indptr.ctypes.data_as(ctypes.POINTER(U64)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            vals.ctypes.data_as(F32P), 2, 1, 3, ctypes.byref(h)),
        "BoosterCreate": lambda: lib.XGBoosterCreate(None, 0,
                                                     ctypes.byref(h)),
    }
    for value in (None, "cuda"):
        if value is not None:
            monkeypatch.setenv("XGBTPU_DEVICE", value)
        for name, fn in calls.items():
            assert fn() == -1, name
            assert lib.error().startswith("device='cuda' requested"), name
    monkeypatch.setenv("XGBTPU_DEVICE", "tpu")
    assert calls["BoosterCreate"]() == -1 and "XGBTPU_DEVICE" in lib.error()


def test_c_api_device_is_fixed_at_creation(lib):
    """``SetParam("device", v)`` on a CPU handle: another device fails and
    names ``XGBTPU_DEVICE``; the handle's own device is accepted; the
    Python API's ``set_param`` ignores the key as before."""
    bh = lib.booster([])
    for v in (b"cuda", b"cuda:0", b"gpu"):
        assert lib.XGBoosterSetParam(bh, b"device", v) == -1
        assert "fixed at creation by XGBTPU_DEVICE" in lib.error()
    lib.ok(lib.XGBoosterSetParam(bh, b"device", b"cpu"))
    tb = xgbt.Booster(device="cpu")
    tb.set_param("device", "cuda")
    assert tb.device.type == "cpu"
    lib.ok(lib.XGBoosterFree(bh))


def test_c_api_eval_metric_calls_add_metrics(lib):
    """Each ``SetParam("eval_metric", m)`` adds ``m`` once (the
    reference learner's rule): the eval string equals the Python API's
    with the list."""
    X, y = _data(300, 4, seed=31)
    h = lib.dmatrix(X, y)
    bh = lib.booster([h], {"objective": "binary:logistic", "max_depth": 2})
    for m in ("auc", "logloss", "auc"):
        lib.ok(lib.XGBoosterSetParam(bh, b"eval_metric", m.encode()))
    lib.update(bh, h, 2)
    got = lib.eval(bh, 1, [h], ["train"])
    d = xgbt.DMatrix(X, y, device="cpu")
    tb = xgbt.train({"objective": "binary:logistic", "max_depth": 2,
                     "eval_metric": ["auc", "logloss"]}, d, 2)
    assert got == tb.eval_set([(d, "train")], 1)
    assert "train-auc:" in got and "train-logloss:" in got
    lib.ok(lib.XGBoosterFree(bh))
    lib.ok(lib.XGDMatrixFree(h))
