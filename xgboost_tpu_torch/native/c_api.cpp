// The C API of xgboost_tpu_torch: the reference's include/xgboost/c_api.h
// surface over the PyTorch/CUDA package, by EMBEDDING CPython. Each
// exported function takes the interpreter lock (initializing an
// interpreter first when the host process is not Python, e.g. a C program
// that dlopens this library) and calls xgboost_tpu_torch.native.capi or a
// method of the handle's object. The reference's layering reversed (its
// Python package wraps libxgboost.so; here the library wraps the Python
// package), with the same ABI for C callers:
//   XGBGetLastError, XGBVersion                        c_api.h:64
//   XGDMatrixCreateFromMat / FromFile / FromCSREx      c_api.h:186,132,114
//   XGDMatrixSetFloatInfo / GetFloatInfo / SetUIntInfo / GetUIntInfo
//   XGDMatrixNumRow / NumCol / SliceDMatrix / Free     c_api.h:240
//   XGBoosterCreate / Free / SetParam                  c_api.h:747,760,795
//   XGBoosterUpdateOneIter / BoostOneIter / EvalOneIter c_api.h:807-835
//   XGBoosterPredict (option_mask 0/1)                 c_api.h:865
//   XGBoosterPredictFromDMatrix / FromDense / FromCSR  c_api.h:928, c_api.cc:833
//   XGBoosterSaveModel / LoadModel / SaveModelToBuffer / LoadModelFromBuffer
//   XGBoosterSerializeToBuffer / UnserializeFromBuffer c_api.h:1030
//   XGBoosterSaveJsonConfig / LoadJsonConfig           c_api.h:990
//   XGBoosterGetNumFeature, DumpModel, SetAttr / GetAttr
//   XGBoosterSetStrFeatureInfo / GetStrFeatureInfo     c_api.h:1146,1182
// Every call returns 0 on success and -1 on failure, the message then
// retrievable with XGBGetLastError(). Handles are created on the device
// that XGBTPU_DEVICE names (capi.py); predictions are host floats copied
// into the handle's buffers, valid until the handle's next call.
//
// Built by xgboost_tpu_torch/native/__init__.py:build_capi (g++ -shared
// -fPIC with this Python's headers and -lpython3.x, XGBTPU_ROOT and
// XGBTPU_SITE baked in).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdarg>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#define XGB_DLL extern "C" __attribute__((visibility("default")))

typedef uint64_t bst_ulong;
typedef void *DMatrixHandle;
typedef void *BoosterHandle;

static thread_local std::string g_last_error;

#ifndef XGBTPU_ROOT
#define XGBTPU_ROOT ""
#endif
#ifndef XGBTPU_SITE
#define XGBTPU_SITE ""
#endif

static void ensure_python() {
  static std::once_flag once;
  std::call_once(once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // the embedded interpreter must see the site-packages (torch, numpy)
      // and the repository root (xgboost_tpu_torch): both baked in at
      // build time, overridable from the environment, put first on
      // sys.path
      const char *dirs[2] = {std::getenv("XGBTPU_SITE"),
                             std::getenv("XGBTPU_ROOT")};
      if (dirs[0] == nullptr) dirs[0] = XGBTPU_SITE;
      if (dirs[1] == nullptr) dirs[1] = XGBTPU_ROOT;
      PyObject *path = PySys_GetObject("path");  // borrowed
      for (const char *dir : dirs) {
        PyObject *p = *dir != '\0' ? PyUnicode_DecodeFSDefault(dir) : nullptr;
        if (path != nullptr && p != nullptr && PySequence_Contains(path, p) == 0)
          PyList_Insert(path, 0, p);
        Py_XDECREF(p);
      }
      PyErr_Clear();
      // release the lock the initializer holds: every entry point takes
      // it again with PyGILState_Ensure (foreign threads included)
      PyEval_SaveThread();
    }
  });
}

namespace {

struct Gil {
  PyGILState_STATE st;
  Gil() {
    ensure_python();
    st = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(st); }
};

int fail() {  // the live Python exception -> g_last_error
  PyObject *t = nullptr, *v = nullptr, *tb = nullptr;
  PyErr_Fetch(&t, &v, &tb);
  PyErr_NormalizeException(&t, &v, &tb);
  g_last_error = "unknown error";
  if (v != nullptr) {
    PyObject *s = PyObject_Str(v);
    const char *c = s != nullptr ? PyUnicode_AsUTF8(s) : nullptr;
    if (c != nullptr) g_last_error = c;
    Py_XDECREF(s);
  }
  PyErr_Clear();
  Py_XDECREF(t);
  Py_XDECREF(v);
  Py_XDECREF(tb);
  return -1;
}

PyObject *imp(const char *name) { return PyImport_ImportModule(name); }

// capi.<fn>(*args), args built by Py_BuildValue from `fmt` (a tuple
// format); a new reference, or nullptr with the exception set
PyObject *call(const char *fn, const char *fmt, ...) {
  PyObject *mod = imp("xgboost_tpu_torch.native.capi");
  if (mod == nullptr) return nullptr;
  PyObject *f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (f == nullptr) return nullptr;
  va_list va;
  va_start(va, fmt);
  PyObject *args = Py_VaBuildValue(fmt, va);
  va_end(va);
  PyObject *r = args != nullptr ? PyObject_CallObject(f, args) : nullptr;
  Py_XDECREF(args);
  Py_DECREF(f);
  return r;
}

// a read-only view of caller memory (copied on the Python side)
PyObject *view(const void *p, size_t nbytes) {
  static char empty = 0;
  return PyMemoryView_FromMemory(
      p != nullptr ? static_cast<char *>(const_cast<void *>(p)) : &empty,
      static_cast<Py_ssize_t>(nbytes), PyBUF_READ);
}

int done(PyObject *r) {  // a call's status; the result is dropped
  if (r == nullptr) return fail();
  Py_DECREF(r);
  return 0;
}

// str or bytes -> *out (the reference is stolen)
int take_str(PyObject *r, std::string *out) {
  if (r == nullptr) return fail();
  char *raw = nullptr;
  Py_ssize_t n = 0;
  bool bad;
  if (PyBytes_Check(r)) {
    bad = PyBytes_AsStringAndSize(r, &raw, &n) != 0;
  } else {
    raw = const_cast<char *>(PyUnicode_AsUTF8AndSize(r, &n));
    bad = raw == nullptr;
  }
  if (!bad) out->assign(raw, static_cast<size_t>(n));
  Py_DECREF(r);
  return bad ? fail() : 0;
}

// a sequence of str -> *out and its C pointers (the reference is stolen)
int take_strs(PyObject *r, std::vector<std::string> *out,
              std::vector<const char *> *ptrs) {
  if (r == nullptr) return fail();
  out->clear();
  ptrs->clear();
  Py_ssize_t n = PySequence_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    const char *c = it != nullptr ? PyUnicode_AsUTF8(it) : nullptr;
    if (c != nullptr) out->emplace_back(c);
    Py_XDECREF(it);
    if (c == nullptr) break;
  }
  Py_DECREF(r);
  if (n < 0 || PyErr_Occurred()) return fail();
  for (auto &s : *out) ptrs->push_back(s.c_str());
  return 0;
}

int take_ulong(PyObject *r, bst_ulong *out) {
  if (r == nullptr) return fail();
  unsigned long long v = PyLong_AsUnsignedLongLong(r);
  Py_DECREF(r);
  if (PyErr_Occurred()) return fail();
  *out = static_cast<bst_ulong>(v);
  return 0;
}

template <typename T>
int take_array(PyObject *r, std::vector<T> *out) {  // bytes -> *out
  std::string raw;
  if (take_str(r, &raw) != 0) return -1;
  out->resize(raw.size() / sizeof(T));
  std::memcpy(out->data(), raw.data(), out->size() * sizeof(T));
  return 0;
}

struct MatWrap {
  explicit MatWrap(PyObject *o) : obj(o) {}
  PyObject *obj;                // xgboost_tpu_torch.DMatrix
  std::vector<float> finfo;     // GetFloatInfo out-buffer
  std::vector<unsigned> uinfo;  // GetUIntInfo out-buffer
};

struct BoosterWrap {
  explicit BoosterWrap(PyObject *o) : obj(o) {}
  PyObject *obj;                      // xgboost_tpu_torch.Booster
  std::vector<float> pred;            // predict out-buffer
  std::vector<bst_ulong> pred_shape;  // its shape
  std::string str_out;                // eval / attr / config out-string
  std::string raw_out;                // SaveModelToBuffer out-bytes
  std::string serialize_out;          // SerializeToBuffer out-bytes
  std::vector<std::string> strs;      // DumpModel / GetStrFeatureInfo
  std::vector<const char *> str_ptrs;
};

PyObject *obj(DMatrixHandle h) { return static_cast<MatWrap *>(h)->obj; }
BoosterWrap *bw(BoosterHandle h) { return static_cast<BoosterWrap *>(h); }

int new_mat(PyObject *d, DMatrixHandle *out) {
  if (d == nullptr) return fail();
  *out = new MatWrap(d);
  return 0;
}

// a predict result (float32 bytes, shape) -> the handle's buffers
int take_pred(BoosterWrap *w, PyObject *r) {
  if (r == nullptr) return fail();
  PyObject *shape = PyTuple_Check(r) && PyTuple_Size(r) == 2
                        ? PyTuple_GetItem(r, 1) : nullptr;
  Py_ssize_t nd = shape != nullptr ? PySequence_Size(shape) : -1;
  w->pred_shape.assign(nd > 0 ? nd : 0, 0);
  for (Py_ssize_t i = 0; i < nd; ++i) {
    PyObject *dim = PySequence_GetItem(shape, i);
    if (dim != nullptr)
      w->pred_shape[i] = PyLong_AsUnsignedLongLong(dim);
    Py_XDECREF(dim);
  }
  PyObject *data = shape != nullptr ? PyTuple_GetItem(r, 0) : nullptr;
  Py_XINCREF(data);
  Py_DECREF(r);
  if (shape == nullptr || nd < 0 || PyErr_Occurred()) {
    Py_XDECREF(data);
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_TypeError, "predict returned no (data, shape)");
    return fail();
  }
  return take_array(data, &w->pred);
}

// C strings (a null one as "") -> a new list, or nullptr with the
// exception set
PyObject *str_list(const char *const *strs, bst_ulong n) {
  PyObject *list = PyList_New(static_cast<Py_ssize_t>(n));
  for (bst_ulong i = 0; list != nullptr && i < n; ++i) {
    PyObject *s = PyUnicode_FromString(strs[i] != nullptr ? strs[i] : "");
    if (s == nullptr) {
      Py_CLEAR(list);
      break;
    }
    PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), s);
  }
  return list;
}

PyObject *opt(DMatrixHandle h) {  // an optional handle's object, or None
  return h != nullptr ? obj(h) : Py_None;
}

}  // namespace

XGB_DLL const char *XGBGetLastError(void) { return g_last_error.c_str(); }

XGB_DLL void XGBVersion(int *major, int *minor, int *patch) {
  if (major) *major = 2;
  if (minor) *minor = 0;
  if (patch) *patch = 0;
}

// ---------------------------------------------------------------- DMatrix

XGB_DLL int XGDMatrixCreateFromMat(const float *data, bst_ulong nrow,
                                   bst_ulong ncol, float missing,
                                   DMatrixHandle *out) {
  Gil gil;
  PyObject *mv = view(data, nrow * ncol * sizeof(float));
  if (mv == nullptr) return fail();
  PyObject *d = call("from_mat", "(OKKd)", mv, (unsigned long long)nrow,
                     (unsigned long long)ncol, static_cast<double>(missing));
  Py_DECREF(mv);
  return new_mat(d, out);
}

XGB_DLL int XGDMatrixCreateFromFile(const char *fname, int /*silent*/,
                                    DMatrixHandle *out) {
  Gil gil;
  return new_mat(call("from_file", "(s)", fname), out);
}

XGB_DLL int XGDMatrixCreateFromCSREx(const size_t *indptr,
                                     const unsigned *indices,
                                     const float *data, size_t nindptr,
                                     size_t nelem, size_t num_col,
                                     DMatrixHandle *out) {
  Gil gil;
  PyObject *pi = view(indptr, nindptr * sizeof(size_t));
  PyObject *px = view(indices, nelem * sizeof(unsigned));
  PyObject *pv = view(data, nelem * sizeof(float));
  PyObject *d = (pi && px && pv)
                    ? call("from_csr", "(OOOK)", pi, px, pv,
                           (unsigned long long)num_col)
                    : nullptr;
  Py_XDECREF(pi);
  Py_XDECREF(px);
  Py_XDECREF(pv);
  return new_mat(d, out);
}

static int set_info(DMatrixHandle handle, const char *field, const void *data,
                    size_t nbytes, const char *dtype) {
  Gil gil;
  PyObject *mv = view(data, nbytes);
  if (mv == nullptr) return fail();
  int rc = done(call("set_info", "(OsOs)", obj(handle), field, mv, dtype));
  Py_DECREF(mv);
  return rc;
}

XGB_DLL int XGDMatrixSetFloatInfo(DMatrixHandle handle, const char *field,
                                  const float *data, bst_ulong len) {
  return set_info(handle, field, data, len * sizeof(float), "float32");
}

XGB_DLL int XGDMatrixSetUIntInfo(DMatrixHandle handle, const char *field,
                                 const unsigned *data, bst_ulong len) {
  return set_info(handle, field, data, len * sizeof(unsigned), "uint32");
}

XGB_DLL int XGDMatrixGetFloatInfo(DMatrixHandle handle, const char *field,
                                  bst_ulong *out_len,
                                  const float **out_dptr) {
  Gil gil;
  auto *w = static_cast<MatWrap *>(handle);
  if (take_array(call("get_info", "(Oss)", w->obj, field, "float32"),
                 &w->finfo) != 0)
    return -1;
  *out_len = w->finfo.size();
  *out_dptr = w->finfo.data();
  return 0;
}

XGB_DLL int XGDMatrixGetUIntInfo(DMatrixHandle handle, const char *field,
                                 bst_ulong *out_len,
                                 const unsigned **out_dptr) {
  Gil gil;
  auto *w = static_cast<MatWrap *>(handle);
  if (take_array(call("get_info", "(Oss)", w->obj, field, "uint32"),
                 &w->uinfo) != 0)
    return -1;
  *out_len = w->uinfo.size();
  *out_dptr = w->uinfo.data();
  return 0;
}

XGB_DLL int XGDMatrixNumRow(DMatrixHandle handle, bst_ulong *out) {
  Gil gil;
  return take_ulong(PyObject_CallMethod(obj(handle), "num_row", nullptr),
                    out);
}

XGB_DLL int XGDMatrixNumCol(DMatrixHandle handle, bst_ulong *out) {
  Gil gil;
  return take_ulong(PyObject_CallMethod(obj(handle), "num_col", nullptr),
                    out);
}

XGB_DLL int XGDMatrixSliceDMatrix(DMatrixHandle handle, const int *idxset,
                                  bst_ulong len, DMatrixHandle *out) {
  // a new DMatrix of the selected rows, their metadata sliced along
  Gil gil;
  PyObject *mv = view(idxset, len * sizeof(int));
  if (mv == nullptr) return fail();
  PyObject *d = call("slice_rows", "(OO)", obj(handle), mv);
  Py_DECREF(mv);
  return new_mat(d, out);
}

XGB_DLL int XGDMatrixFree(DMatrixHandle handle) {
  Gil gil;
  auto *w = static_cast<MatWrap *>(handle);
  Py_XDECREF(w->obj);
  delete w;
  return 0;
}

// ---------------------------------------------------------------- Booster

XGB_DLL int XGBoosterCreate(const DMatrixHandle dmats[], bst_ulong len,
                            BoosterHandle *out) {
  Gil gil;
  PyObject *cache = PyList_New(static_cast<Py_ssize_t>(len));
  if (cache == nullptr) return fail();
  for (bst_ulong i = 0; i < len; ++i) {
    Py_INCREF(obj(dmats[i]));
    PyList_SET_ITEM(cache, static_cast<Py_ssize_t>(i), obj(dmats[i]));
  }
  PyObject *b = call("booster", "(O)", cache);
  Py_DECREF(cache);
  if (b == nullptr) return fail();
  *out = new BoosterWrap(b);
  return 0;
}

XGB_DLL int XGBoosterFree(BoosterHandle handle) {
  Gil gil;
  Py_XDECREF(bw(handle)->obj);
  delete bw(handle);
  return 0;
}

XGB_DLL int XGBoosterSetParam(BoosterHandle handle, const char *name,
                              const char *value) {
  Gil gil;
  return done(call("set_param", "(Oss)", bw(handle)->obj, name, value));
}

XGB_DLL int XGBoosterUpdateOneIter(BoosterHandle handle, int iter,
                                   DMatrixHandle dtrain) {
  Gil gil;
  return done(PyObject_CallMethod(bw(handle)->obj, "update", "Oi",
                                  obj(dtrain), iter));
}

XGB_DLL int XGBoosterBoostOneIter(BoosterHandle handle, DMatrixHandle dtrain,
                                  float *grad, float *hess, bst_ulong len) {
  Gil gil;
  PyObject *g = view(grad, len * sizeof(float));
  PyObject *h = view(hess, len * sizeof(float));
  int rc = (g && h) ? done(call("boost", "(OOOO)", bw(handle)->obj,
                                obj(dtrain), g, h))
                    : fail();
  Py_XDECREF(g);
  Py_XDECREF(h);
  return rc;
}

XGB_DLL int XGBoosterEvalOneIter(BoosterHandle handle, int iter,
                                 DMatrixHandle dmats[],
                                 const char *evnames[], bst_ulong len,
                                 const char **out_result) {
  Gil gil;
  auto *w = bw(handle);
  PyObject *mats = PyList_New(static_cast<Py_ssize_t>(len));
  PyObject *names = str_list(evnames, len);
  for (bst_ulong i = 0; mats != nullptr && i < len; ++i) {
    Py_INCREF(obj(dmats[i]));
    PyList_SET_ITEM(mats, static_cast<Py_ssize_t>(i), obj(dmats[i]));
  }
  PyObject *r = (mats && names) ? call("eval_sets", "(OOOi)", w->obj, mats,
                                       names, iter)
                                : nullptr;
  Py_XDECREF(mats);
  Py_XDECREF(names);
  if (take_str(r, &w->str_out) != 0) return -1;
  *out_result = w->str_out.c_str();
  return 0;
}

XGB_DLL int XGBoosterPredict(BoosterHandle handle, DMatrixHandle dmat,
                             int option_mask, unsigned ntree_limit,
                             int /*training*/, bst_ulong *out_len,
                             const float **out_result) {
  Gil gil;
  auto *w = bw(handle);
  if (take_pred(w, call("predict", "(OOiI)", w->obj, obj(dmat), option_mask,
                        ntree_limit)) != 0)
    return -1;
  *out_len = w->pred.size();
  *out_result = w->pred.data();
  return 0;
}

static int shaped(BoosterWrap *w, PyObject *r, bst_ulong const **out_shape,
                  bst_ulong *out_dim, float const **out_result) {
  if (take_pred(w, r) != 0) return -1;
  *out_shape = w->pred_shape.data();
  *out_dim = w->pred_shape.size();
  *out_result = w->pred.data();
  return 0;
}

XGB_DLL int XGBoosterPredictFromDMatrix(BoosterHandle handle,
                                        DMatrixHandle dmat,
                                        char const *c_json_config,
                                        bst_ulong const **out_shape,
                                        bst_ulong *out_dim,
                                        float const **out_result) {
  Gil gil;
  auto *w = bw(handle);
  return shaped(w, call("predict_dmatrix", "(OOz)", w->obj, obj(dmat),
                        c_json_config),
                out_shape, out_dim, out_result);
}

XGB_DLL int XGBoosterPredictFromDense(BoosterHandle handle,
                                      char const *values,
                                      char const *c_json_config,
                                      DMatrixHandle m,
                                      bst_ulong const **out_shape,
                                      bst_ulong *out_dim,
                                      float const **out_result) {
  // in-place predict (c_api.cc:833): `values` is an __array_interface__
  // document over caller memory; no DMatrix is built
  Gil gil;
  auto *w = bw(handle);
  return shaped(w, call("predict_dense", "(OzzO)", w->obj, values,
                        c_json_config, opt(m)),
                out_shape, out_dim, out_result);
}

XGB_DLL int XGBoosterPredictFromCSR(BoosterHandle handle,
                                    char const *indptr, char const *indices,
                                    char const *values, bst_ulong ncol,
                                    char const *c_json_config,
                                    DMatrixHandle m,
                                    bst_ulong const **out_shape,
                                    bst_ulong *out_dim,
                                    float const **out_result) {
  Gil gil;
  auto *w = bw(handle);
  return shaped(w, call("predict_csr", "(OzzzKzO)", w->obj, indptr, indices,
                        values, (unsigned long long)ncol, c_json_config,
                        opt(m)),
                out_shape, out_dim, out_result);
}

XGB_DLL int XGBoosterSaveModel(BoosterHandle handle, const char *fname) {
  Gil gil;
  return done(PyObject_CallMethod(bw(handle)->obj, "save_model", "s", fname));
}

XGB_DLL int XGBoosterLoadModel(BoosterHandle handle, const char *fname) {
  Gil gil;
  return done(PyObject_CallMethod(bw(handle)->obj, "load_model", "s", fname));
}

XGB_DLL int XGBoosterSaveModelToBuffer(BoosterHandle handle,
                                       const char * /*json_config*/,
                                       bst_ulong *out_len,
                                       const char **out_dptr) {
  Gil gil;
  auto *w = bw(handle);
  if (take_str(PyObject_CallMethod(w->obj, "save_raw", "s", "json"),
               &w->raw_out) != 0)
    return -1;
  *out_len = w->raw_out.size();
  *out_dptr = w->raw_out.data();
  return 0;
}

XGB_DLL int XGBoosterLoadModelFromBuffer(BoosterHandle handle,
                                         const void *buf, bst_ulong len) {
  Gil gil;
  PyObject *b = PyBytes_FromStringAndSize(static_cast<const char *>(buf),
                                          static_cast<Py_ssize_t>(len));
  if (b == nullptr) return fail();
  int rc = done(PyObject_CallMethod(bw(handle)->obj, "load_model", "O", b));
  Py_DECREF(b);
  return rc;
}

XGB_DLL int XGBoosterSerializeToBuffer(BoosterHandle handle,
                                       bst_ulong *out_len,
                                       char const **out_dptr) {
  // the full state: model AND learner configuration (c_api.h:1030)
  Gil gil;
  auto *w = bw(handle);
  if (take_str(call("serialize", "(O)", w->obj), &w->serialize_out) != 0)
    return -1;
  *out_len = w->serialize_out.size();
  *out_dptr = w->serialize_out.data();
  return 0;
}

XGB_DLL int XGBoosterUnserializeFromBuffer(BoosterHandle handle,
                                           const void *buf, bst_ulong len) {
  Gil gil;
  if (buf == nullptr) {
    PyErr_SetString(PyExc_ValueError, "UnserializeFromBuffer: null buffer");
    return fail();
  }
  return done(call("unserialize", "(Oy#)", bw(handle)->obj,
                   static_cast<const char *>(buf),
                   static_cast<Py_ssize_t>(len)));
}

XGB_DLL int XGBoosterSaveJsonConfig(BoosterHandle handle, bst_ulong *out_len,
                                    char const **out_str) {
  Gil gil;
  auto *w = bw(handle);
  if (take_str(PyObject_CallMethod(w->obj, "save_config", nullptr),
               &w->str_out) != 0)
    return -1;
  *out_len = w->str_out.size();
  *out_str = w->str_out.c_str();
  return 0;
}

XGB_DLL int XGBoosterLoadJsonConfig(BoosterHandle handle,
                                    char const *config) {
  Gil gil;
  if (config == nullptr) {
    PyErr_SetString(PyExc_ValueError, "LoadJsonConfig: null config");
    return fail();
  }
  return done(PyObject_CallMethod(bw(handle)->obj, "load_config", "s",
                                  config));
}

XGB_DLL int XGBoosterGetNumFeature(BoosterHandle handle, bst_ulong *out) {
  Gil gil;
  return take_ulong(
      PyObject_CallMethod(bw(handle)->obj, "num_features", nullptr), out);
}

XGB_DLL int XGBoosterSetAttr(BoosterHandle handle, const char *key,
                             const char *value) {
  Gil gil;
  return done(call("set_attr", "(Osz)", bw(handle)->obj, key, value));
}

XGB_DLL int XGBoosterGetAttr(BoosterHandle handle, const char *key,
                             const char **out, int *success) {
  Gil gil;
  auto *w = bw(handle);
  PyObject *r = PyObject_CallMethod(w->obj, "attr", "s", key);
  if (r == nullptr) return fail();
  *success = r != Py_None;
  *out = nullptr;
  if (r == Py_None) {
    Py_DECREF(r);
    return 0;
  }
  if (take_str(r, &w->str_out) != 0) return -1;
  *out = w->str_out.c_str();
  return 0;
}

XGB_DLL int XGBoosterSetStrFeatureInfo(BoosterHandle handle,
                                       const char *field,
                                       const char **features,
                                       bst_ulong size) {
  // feature names / types of the MODEL (c_api.h:1146): they survive
  // save/load and name the features in dumps
  Gil gil;
  PyObject *values = str_list(features, size);
  if (values == nullptr) return fail();
  int rc = done(call("set_feature_info", "(OsO)", bw(handle)->obj, field,
                     values));
  Py_DECREF(values);
  return rc;
}

XGB_DLL int XGBoosterGetStrFeatureInfo(BoosterHandle handle,
                                       const char *field, bst_ulong *len,
                                       const char ***out_features) {
  Gil gil;
  auto *w = bw(handle);
  if (take_strs(call("get_feature_info", "(Os)", w->obj, field), &w->strs,
                &w->str_ptrs) != 0)
    return -1;
  *len = w->strs.size();
  *out_features = w->str_ptrs.data();
  return 0;
}

XGB_DLL int XGBoosterDumpModel(BoosterHandle handle, const char *fmap,
                               int with_stats, bst_ulong *out_len,
                               const char ***out_dump_array) {
  Gil gil;
  auto *w = bw(handle);
  if (take_strs(call("dump", "(Osi)", w->obj, fmap != nullptr ? fmap : "",
                     with_stats),
                &w->strs, &w->str_ptrs) != 0)
    return -1;
  *out_len = w->strs.size();
  *out_dump_array = w->str_ptrs.data();
  return 0;
}
