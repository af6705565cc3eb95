// Flat C ABI over the PyTorch port (mxnet_tpu_torch) — the same header,
// include/mxtpu/c_api.h, as src/c_api.cc, so a C program written against
// it links either library and behaves the same way.  It mirrors the
// reference's src/c_api/c_api.cc (:104-1454): opaque handles, int return
// codes, MXGetLastError.
//
// The core is Python over PyTorch and CUDA, so the ABI EMBEDS the
// interpreter (attaching to an existing one when the host process is
// Python) and drives mxnet_tpu_torch.capi_impl, which imports neither
// jax nor mxnet_tpu.  Handles are PyObject references.  Entry points
// that name no device run on gpu(0) unless MXNET_CAPI_CONTEXT names
// another context (capi_impl.capi_context).
//
// Build: make lib/libmxtpu_torch_capi.so (links libpython).  The C
// consumers under tests/capi/ build against it into lib/torch/.
#include <Python.h>

#include "mxtpu/c_api.h"

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

PyObject* g_impl = nullptr;  // mxnet_tpu_torch.capi_impl module

void SetError(const char* what) { g_last_error = what ? what : "unknown"; }

void SetErrorFromPython() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  PyObject* s = value ? PyObject_Str(value) : nullptr;
  if (s) {
    const char* msg = PyUnicode_AsUTF8(s);
    g_last_error = msg ? msg : "python error";
    Py_DECREF(s);
  } else {
    g_last_error = "python error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// Scoped interpreter attach: initializes Python on first use when the
// host process is plain C; otherwise just takes the GIL.
class Gil {
 public:
  Gil() {
    // first MX* calls may race in from several plain-C threads: only one
    // may initialize the interpreter
    static std::once_flag init_once;
    std::call_once(init_once, [] {
      if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        // Py_InitializeEx leaves the calling thread holding the GIL;
        // park it so Ensure below (and MX* calls from OTHER threads)
        // can take it
        PyEval_SaveThread();
      }
    });
    state_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

int EnsureImpl() {
  if (g_impl) return 0;
  PyObject* mod = PyImport_ImportModule("mxnet_tpu_torch.capi_impl");
  if (!mod) {
    SetErrorFromPython();
    return -1;
  }
  g_impl = mod;  // leaked on purpose: lives for the process
  return 0;
}

// Call impl.<fn>(args...) returning the result object (new ref) or null.
PyObject* Call(const char* fn, PyObject* args) {
  if (EnsureImpl() != 0) {
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(g_impl, fn);
  if (!f) {
    SetErrorFromPython();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (!out) SetErrorFromPython();
  return out;
}

// rc-style call: discard the result, 0 ok / -1 error.
int CallRC(const char* fn, PyObject* args) {
  PyObject* out = Call(fn, args);
  if (!out) return -1;
  Py_DECREF(out);
  return 0;
}

PyObject* WritableView(void* data, size_t nbytes) {
  return PyMemoryView_FromMemory(static_cast<char*>(data),
                                 static_cast<Py_ssize_t>(nbytes),
                                 PyBUF_WRITE);
}

PyObject* ReadView(const void* data, size_t nbytes) {
  return PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(data)),
      static_cast<Py_ssize_t>(nbytes), PyBUF_READ);
}

int FillShape(PyObject* tup, uint32_t* ndim, uint32_t* shape,
              uint32_t cap) {
  Py_ssize_t n = PyTuple_Size(tup);
  if (n < 0 || static_cast<uint32_t>(n) > cap) {
    SetError("shape rank exceeds caller buffer");
    return -1;
  }
  *ndim = static_cast<uint32_t>(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    shape[i] = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(tup, i)));
  }
  return 0;
}

}  // namespace

extern "C" {

const char* MXGetLastError() { return g_last_error.c_str(); }

// ---- NDArray (c_api.cc:116-363 parity subset) ----------------------
int MXNDArrayCreate(const uint32_t* shape, uint32_t ndim,
                    NDArrayHandle* out) {
  Gil gil;
  PyObject* dims = PyTuple_New(ndim);
  for (uint32_t i = 0; i < ndim; ++i)
    PyTuple_SetItem(dims, i, PyLong_FromUnsignedLong(shape[i]));
  PyObject* nd = Call("ndarray_create", PyTuple_Pack(1, dims));
  Py_DECREF(dims);
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXNDArrayFree(NDArrayHandle h) {
  Gil gil;
  Py_XDECREF(static_cast<PyObject*>(h));
  return 0;
}

int MXNDArrayGetShape(NDArrayHandle h, uint32_t* ndim, uint32_t* shape,
                      uint32_t cap) {
  Gil gil;
  PyObject* tup = Call("ndarray_shape",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!tup) return -1;
  int rc = FillShape(tup, ndim, shape, cap);
  Py_DECREF(tup);
  return rc;
}

int MXNDArraySyncCopyFromCPU(NDArrayHandle h, const float* data,
                             size_t size) {
  Gil gil;
  // "N" steals the view reference: no leak
  return CallRC("ndarray_copy_from",
                Py_BuildValue("(ON)", static_cast<PyObject*>(h),
                              ReadView(data, size * sizeof(float))));
}

int MXNDArraySyncCopyToCPU(NDArrayHandle h, float* data, size_t size) {
  Gil gil;
  return CallRC("ndarray_copy_to",
                Py_BuildValue("(ON)", static_cast<PyObject*>(h),
                              WritableView(data, size * sizeof(float))));
}

int MXNDArrayWaitAll() {
  Gil gil;
  return CallRC("ndarray_waitall", PyTuple_New(0));
}

// ---- Symbol (c_api.cc:447-937 parity subset) -----------------------
int MXSymbolCreateFromJSON(const char* json, SymbolHandle* out) {
  Gil gil;
  PyObject* sym = Call("symbol_from_json",
                       Py_BuildValue("(s)", json));
  if (!sym) return -1;
  *out = sym;
  return 0;
}

int MXSymbolFree(SymbolHandle h) { return MXNDArrayFree(h); }

int MXSymbolGetNumArguments(SymbolHandle h, uint32_t* out) {
  Gil gil;
  PyObject* lst = Call("symbol_arguments",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  *out = static_cast<uint32_t>(PyList_Size(lst));
  Py_DECREF(lst);
  return 0;
}

int MXSymbolGetArgument(SymbolHandle h, uint32_t index, char* buf,
                        size_t cap) {
  Gil gil;
  PyObject* lst = Call("symbol_arguments",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  if (index >= static_cast<uint32_t>(PyList_Size(lst))) {
    Py_DECREF(lst);
    SetError("argument index out of range");
    return -1;
  }
  const char* name = PyUnicode_AsUTF8(PyList_GetItem(lst, index));
  snprintf(buf, cap, "%s", name ? name : "");
  Py_DECREF(lst);
  return 0;
}

// ---- Executor (c_api.cc:939-1099 parity subset) --------------------
// shapes_json: {"data": [4, 10], "softmax_label": [4]}
int MXExecutorSimpleBind(SymbolHandle sym, const char* shapes_json,
                         ExecutorHandle* out) {
  Gil gil;
  PyObject* exec_ = Call("executor_bind",
                         Py_BuildValue("(Os)",
                                       static_cast<PyObject*>(sym),
                                       shapes_json));
  if (!exec_) return -1;
  *out = exec_;
  return 0;
}

int MXExecutorFree(ExecutorHandle h) { return MXNDArrayFree(h); }

int MXExecutorSetArg(ExecutorHandle h, const char* name,
                     const float* data, size_t size) {
  Gil gil;
  return CallRC("executor_set_arg",
                Py_BuildValue("(OsN)", static_cast<PyObject*>(h), name,
                              ReadView(data, size * sizeof(float))));
}

int MXExecutorForward(ExecutorHandle h, int is_train,
                      uint32_t* num_outputs) {
  Gil gil;
  PyObject* n = Call("executor_forward",
                     Py_BuildValue("(Oi)", static_cast<PyObject*>(h),
                                   is_train));
  if (!n) return -1;
  if (num_outputs) *num_outputs = static_cast<uint32_t>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

int MXExecutorOutputShape(ExecutorHandle h, uint32_t index,
                          uint32_t* ndim, uint32_t* shape, uint32_t cap) {
  Gil gil;
  PyObject* tup = Call("executor_output_shape",
                       Py_BuildValue("(OI)", static_cast<PyObject*>(h),
                                     index));
  if (!tup) return -1;
  int rc = FillShape(tup, ndim, shape, cap);
  Py_DECREF(tup);
  return rc;
}

int MXExecutorOutputCopy(ExecutorHandle h, uint32_t index, float* data,
                         size_t size) {
  Gil gil;
  return CallRC("executor_output_to",
                Py_BuildValue("(OIN)", static_cast<PyObject*>(h), index,
                              WritableView(data, size * sizeof(float))));
}

// ---- Predict API (c_predict_api.cc parity subset) ------------------
int MXPredCreate(const char* symbol_json, const char* param_path,
                 const char* shapes_json, PredictorHandle* out) {
  Gil gil;
  PyObject* pred = Call("pred_create",
                        Py_BuildValue("(sss)", symbol_json, param_path,
                                      shapes_json));
  if (!pred) return -1;
  *out = pred;
  return 0;
}

int MXPredFree(PredictorHandle h) { return MXNDArrayFree(h); }

int MXPredSetInput(PredictorHandle h, const char* name, const float* data,
                   size_t size) {
  Gil gil;
  return CallRC("pred_set_input",
                Py_BuildValue("(OsN)", static_cast<PyObject*>(h), name,
                              ReadView(data, size * sizeof(float))));
}

int MXPredForward(PredictorHandle h) {
  Gil gil;
  return CallRC("pred_forward",
                PyTuple_Pack(1, static_cast<PyObject*>(h)));
}

int MXPredGetOutputShape(PredictorHandle h, uint32_t index, uint32_t* ndim,
                         uint32_t* shape, uint32_t cap) {
  Gil gil;
  PyObject* tup = Call("pred_output_shape",
                       Py_BuildValue("(OI)", static_cast<PyObject*>(h),
                                     index));
  if (!tup) return -1;
  int rc = FillShape(tup, ndim, shape, cap);
  Py_DECREF(tup);
  return rc;
}

int MXPredGetOutput(PredictorHandle h, uint32_t index, float* data,
                    size_t size) {
  Gil gil;
  return CallRC("pred_output_to",
                Py_BuildValue("(OIN)", static_cast<PyObject*>(h), index,
                              WritableView(data, size * sizeof(float))));
}

// ---- KVStore (c_api.cc:1199-1375 parity subset) --------------------
int MXKVStoreCreate(const char* type, KVStoreHandle* out) {
  Gil gil;
  PyObject* kv = Call("kvstore_create", Py_BuildValue("(s)", type));
  if (!kv) return -1;
  *out = kv;
  return 0;
}

int MXKVStoreFree(KVStoreHandle h) { return MXNDArrayFree(h); }

int MXKVStoreInit(KVStoreHandle h, int key, NDArrayHandle val) {
  Gil gil;
  return CallRC("kvstore_init",
                Py_BuildValue("(OiO)", static_cast<PyObject*>(h), key,
                              static_cast<PyObject*>(val)));
}

int MXKVStorePush(KVStoreHandle h, int key, NDArrayHandle val) {
  Gil gil;
  return CallRC("kvstore_push",
                Py_BuildValue("(OiO)", static_cast<PyObject*>(h), key,
                              static_cast<PyObject*>(val)));
}

int MXKVStorePull(KVStoreHandle h, int key, NDArrayHandle out) {
  Gil gil;
  return CallRC("kvstore_pull",
                Py_BuildValue("(OiO)", static_cast<PyObject*>(h), key,
                              static_cast<PyObject*>(out)));
}

// ---- function registry listing (c_api.cc:366-445 parity) -----------
// Handles are pointers into a process-lifetime cache (the reference's
// registry entries are equally static).
namespace {

struct FuncInfo {
  std::string name;
  std::string description;
  std::string key_var;  // key_var_num_args (atomic-symbol info only)
  std::vector<std::string> arg_names, arg_types, arg_descs;
  std::vector<const char*> pnames, ptypes, pdescs;  // C views
};

std::vector<FuncInfo*>* g_functions = nullptr;  // leaked on purpose

int EnsureFunctions() {
  if (g_functions) return 0;
  PyObject* lst = Call("registry_list_ops", PyTuple_New(0));
  if (!lst) return -1;
  auto* fns = new std::vector<FuncInfo*>();
  for (Py_ssize_t i = 0; i < PyList_Size(lst); ++i) {
    const char* nm = PyUnicode_AsUTF8(PyList_GetItem(lst, i));
    auto* fi = new FuncInfo();
    fi->name = nm ? nm : "";
    fns->push_back(fi);
  }
  Py_DECREF(lst);
  g_functions = fns;
  return 0;
}

int FillInfo(FuncInfo* fi) {
  if (!fi->description.empty() || !fi->arg_names.empty()) return 0;
  PyObject* tup = Call("registry_op_info",
                       Py_BuildValue("(s)", fi->name.c_str()));
  if (!tup) return -1;
  const char* desc = PyUnicode_AsUTF8(PyTuple_GetItem(tup, 1));
  fi->description = desc ? desc : "";
  PyObject* lists[3] = {PyTuple_GetItem(tup, 2), PyTuple_GetItem(tup, 3),
                        PyTuple_GetItem(tup, 4)};
  std::vector<std::string>* dsts[3] = {&fi->arg_names, &fi->arg_types,
                                       &fi->arg_descs};
  for (int k = 0; k < 3; ++k) {
    for (Py_ssize_t i = 0; i < PyList_Size(lists[k]); ++i) {
      const char* s = PyUnicode_AsUTF8(PyList_GetItem(lists[k], i));
      dsts[k]->push_back(s ? s : "");
    }
  }
  Py_DECREF(tup);
  for (auto& s : fi->arg_names) fi->pnames.push_back(s.c_str());
  for (auto& s : fi->arg_types) fi->ptypes.push_back(s.c_str());
  for (auto& s : fi->arg_descs) fi->pdescs.push_back(s.c_str());
  return 0;
}

}  // namespace

int MXListFunctions(uint32_t* out_size, FunctionHandle** out_array) {
  Gil gil;
  if (EnsureFunctions() != 0) return -1;
  *out_size = static_cast<uint32_t>(g_functions->size());
  *out_array = reinterpret_cast<FunctionHandle*>(g_functions->data());
  return 0;
}

int MXFuncGetInfo(FunctionHandle fn, const char** name,
                  const char** description, uint32_t* num_args,
                  const char*** arg_names, const char*** arg_types,
                  const char*** arg_descriptions) {
  Gil gil;
  auto* fi = static_cast<FuncInfo*>(fn);
  if (!fi) { SetError("null function handle"); return -1; }
  if (FillInfo(fi) != 0) return -1;
  if (name) *name = fi->name.c_str();
  if (description) *description = fi->description.c_str();
  if (num_args) *num_args = static_cast<uint32_t>(fi->arg_names.size());
  if (arg_names) *arg_names = fi->pnames.data();
  if (arg_types) *arg_types = fi->ptypes.data();
  if (arg_descriptions) *arg_descriptions = fi->pdescs.data();
  return 0;
}

// Imperative invoke of a registered function on NDArrays (MXFuncInvoke
// parity, c_api.cc:410).  fn must come from MXListFunctions; outputs are
// new handles written to out[0..*num_out-1] (cap = caller array size).
int MXFuncInvoke(FunctionHandle fn, uint32_t num_in, NDArrayHandle* in,
                 const char* kwargs_json, uint32_t* num_out,
                 NDArrayHandle* out, uint32_t cap) {
  Gil gil;
  auto* fi = static_cast<FuncInfo*>(fn);
  if (!fi) { SetError("null function handle"); return -1; }
  PyObject* args = PyList_New(num_in);
  for (uint32_t i = 0; i < num_in; ++i) {
    PyObject* a = static_cast<PyObject*>(in[i]);
    Py_INCREF(a);
    PyList_SetItem(args, i, a);
  }
  PyObject* outs = Call("func_invoke",
                        Py_BuildValue("(ssN)", fi->name.c_str(),
                                      kwargs_json ? kwargs_json : "",
                                      args));
  if (!outs) return -1;
  uint32_t n = static_cast<uint32_t>(PyList_Size(outs));
  if (n > cap) {
    Py_DECREF(outs);
    SetError("output count exceeds caller buffer");
    return -1;
  }
  for (uint32_t i = 0; i < n; ++i) {
    PyObject* o = PyList_GetItem(outs, i);
    Py_INCREF(o);
    out[i] = o;
  }
  if (num_out) *num_out = n;
  Py_DECREF(outs);
  return 0;
}

// ---- symbol compose / attrs (c_api.cc:447-937 parity) --------------
int MXSymbolCreateVariable(const char* name, SymbolHandle* out) {
  Gil gil;
  PyObject* sym = Call("symbol_create_variable", Py_BuildValue("(s)", name));
  if (!sym) return -1;
  *out = sym;
  return 0;
}

// kwargs_json: {"num_hidden": 4, "kernel": [3, 3]} (the reference passes
// key/value string arrays; JSON is this ABI's established convention)
int MXSymbolCreateAtomicSymbol(const char* op_name, const char* kwargs_json,
                               const char* name, SymbolHandle* out) {
  Gil gil;
  PyObject* staged = Call("symbol_create_atomic",
                          Py_BuildValue("(sss)", op_name,
                                        kwargs_json ? kwargs_json : "",
                                        name ? name : ""));
  if (!staged) return -1;
  *out = staged;
  return 0;
}

// Unlike the reference (which mutates sym in place), composition returns
// the composed symbol through *out; the staged atomic handle stays valid
// and must still be freed.
int MXSymbolCompose(SymbolHandle sym, uint32_t num_args, const char** keys,
                    SymbolHandle* args, SymbolHandle* out) {
  Gil gil;
  PyObject* pykeys = PyList_New(0);
  if (keys) {
    for (uint32_t i = 0; i < num_args; ++i) {
      PyObject* s = PyUnicode_FromString(keys[i]);
      PyList_Append(pykeys, s);
      Py_DECREF(s);
    }
  }
  PyObject* pyargs = PyList_New(num_args);
  for (uint32_t i = 0; i < num_args; ++i) {
    PyObject* a = static_cast<PyObject*>(args[i]);
    Py_INCREF(a);
    PyList_SetItem(pyargs, i, a);
  }
  PyObject* composed = Call("symbol_compose",
                            Py_BuildValue("(ONN)",
                                          static_cast<PyObject*>(sym),
                                          pykeys, pyargs));
  if (!composed) return -1;
  *out = composed;
  return 0;
}

int MXSymbolGetAttr(SymbolHandle h, const char* key, char* buf, size_t cap,
                    int* success) {
  Gil gil;
  PyObject* val = Call("symbol_get_attr",
                       Py_BuildValue("(Os)", static_cast<PyObject*>(h),
                                     key));
  if (!val) return -1;
  if (val == Py_None) {
    if (success) *success = 0;
    if (cap) buf[0] = '\0';
  } else {
    const char* s = PyUnicode_AsUTF8(val);
    snprintf(buf, cap, "%s", s ? s : "");
    if (success) *success = 1;
  }
  Py_DECREF(val);
  return 0;
}

int MXSymbolSetAttr(SymbolHandle h, const char* key, const char* value) {
  Gil gil;
  return CallRC("symbol_set_attr",
                Py_BuildValue("(Oss)", static_cast<PyObject*>(h), key,
                              value));
}

int MXSymbolGetNumOutputs(SymbolHandle h, uint32_t* out) {
  Gil gil;
  PyObject* lst = Call("symbol_outputs",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  *out = static_cast<uint32_t>(PyList_Size(lst));
  Py_DECREF(lst);
  return 0;
}

int MXSymbolGetOutput(SymbolHandle h, uint32_t index, char* buf,
                      size_t cap) {
  Gil gil;
  PyObject* lst = Call("symbol_outputs",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  if (index >= static_cast<uint32_t>(PyList_Size(lst))) {
    Py_DECREF(lst);
    SetError("output index out of range");
    return -1;
  }
  const char* name = PyUnicode_AsUTF8(PyList_GetItem(lst, index));
  snprintf(buf, cap, "%s", name ? name : "");
  Py_DECREF(lst);
  return 0;
}

// *out_json points at thread-local storage valid until this thread's
// next MXSymbol*JSON call (the reference's ret_buf convention).
int MXSymbolSaveToJSON(SymbolHandle h, const char** out_json) {
  Gil gil;
  PyObject* s = Call("symbol_tojson",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!s) return -1;
  thread_local std::string ret;
  const char* c = PyUnicode_AsUTF8(s);
  ret = c ? c : "";
  Py_DECREF(s);
  *out_json = ret.c_str();
  return 0;
}

// in_json: {"data": [4, 10]}; out_json: {"arg_shapes": ..., "out_shapes":
// ..., "aux_shapes": ...}
int MXSymbolInferShapeJSON(SymbolHandle h, const char* in_json,
                           const char** out_json) {
  Gil gil;
  PyObject* s = Call("symbol_infer_shape_json",
                     Py_BuildValue("(Os)", static_cast<PyObject*>(h),
                                   in_json));
  if (!s) return -1;
  thread_local std::string ret;
  const char* c = PyUnicode_AsUTF8(s);
  ret = c ? c : "";
  Py_DECREF(s);
  *out_json = ret.c_str();
  return 0;
}

// ---- data iterators (c_api.cc:1101-1197 parity) --------------------
int MXListDataIters(uint32_t* out_size, FunctionHandle** out_array) {
  Gil gil;
  static std::vector<FuncInfo*>* iters = nullptr;  // leaked on purpose
  if (!iters) {
    PyObject* lst = Call("dataiter_list", PyTuple_New(0));
    if (!lst) return -1;
    iters = new std::vector<FuncInfo*>();
    for (Py_ssize_t i = 0; i < PyList_Size(lst); ++i) {
      auto* fi = new FuncInfo();
      const char* nm = PyUnicode_AsUTF8(PyList_GetItem(lst, i));
      fi->name = nm ? nm : "";
      fi->description = "data iterator";  // listing only; no Field walk
      iters->push_back(fi);
    }
    Py_DECREF(lst);
  }
  *out_size = static_cast<uint32_t>(iters->size());
  *out_array = reinterpret_cast<FunctionHandle*>(iters->data());
  return 0;
}

int MXDataIterGetIterInfo(FunctionHandle creator, const char** name,
                          const char** description) {
  Gil gil;
  auto* fi = static_cast<FuncInfo*>(creator);
  if (!fi) { SetError("null iterator handle"); return -1; }
  if (name) *name = fi->name.c_str();
  if (description) *description = fi->description.c_str();
  return 0;
}

int MXDataIterCreateIter(const char* name, const char* kwargs_json,
                         DataIterHandle* out) {
  Gil gil;
  PyObject* it = Call("dataiter_create",
                      Py_BuildValue("(ss)", name,
                                    kwargs_json ? kwargs_json : ""));
  if (!it) return -1;
  *out = it;
  return 0;
}

int MXDataIterFree(DataIterHandle h) { return MXNDArrayFree(h); }

int MXDataIterNext(DataIterHandle h, int* out) {
  Gil gil;
  PyObject* n = Call("dataiter_next",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!n) return -1;
  if (out) *out = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

int MXDataIterBeforeFirst(DataIterHandle h) {
  Gil gil;
  return CallRC("dataiter_before_first",
                PyTuple_Pack(1, static_cast<PyObject*>(h)));
}

int MXDataIterGetData(DataIterHandle h, NDArrayHandle* out) {
  Gil gil;
  PyObject* nd = Call("dataiter_get_data",
                      PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXDataIterGetLabel(DataIterHandle h, NDArrayHandle* out) {
  Gil gil;
  PyObject* nd = Call("dataiter_get_label",
                      PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXDataIterGetPadNum(DataIterHandle h, int* out) {
  Gil gil;
  PyObject* n = Call("dataiter_get_pad",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!n) return -1;
  if (out) *out = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

// ---- RecordIO (c_api.cc:1377-1454 parity) --------------------------
int MXRecordIOWriterCreate(const char* uri, RecordIOHandle* out) {
  Gil gil;
  PyObject* w = Call("recordio_writer_create", Py_BuildValue("(s)", uri));
  if (!w) return -1;
  *out = w;
  return 0;
}

int MXRecordIOWriterFree(RecordIOHandle h) {
  Gil gil;
  int rc = CallRC("recordio_writer_free",
                  PyTuple_Pack(1, static_cast<PyObject*>(h)));
  Py_XDECREF(static_cast<PyObject*>(h));
  return rc;
}

int MXRecordIOWriterWriteRecord(RecordIOHandle h, const char* buf,
                                size_t size) {
  Gil gil;
  return CallRC("recordio_writer_write",
                Py_BuildValue("(ON)", static_cast<PyObject*>(h),
                              ReadView(buf, size)));
}

int MXRecordIOWriterTell(RecordIOHandle h, size_t* pos) {
  Gil gil;
  PyObject* n = Call("recordio_writer_tell",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!n) return -1;
  if (pos) *pos = static_cast<size_t>(PyLong_AsSize_t(n));
  Py_DECREF(n);
  return 0;
}

int MXRecordIOReaderCreate(const char* uri, RecordIOHandle* out) {
  Gil gil;
  PyObject* r = Call("recordio_reader_create", Py_BuildValue("(s)", uri));
  if (!r) return -1;
  *out = r;
  return 0;
}

int MXRecordIOReaderFree(RecordIOHandle h) {
  Gil gil;
  int rc = CallRC("recordio_reader_free",
                  PyTuple_Pack(1, static_cast<PyObject*>(h)));
  Py_XDECREF(static_cast<PyObject*>(h));
  return rc;
}

// *out points at memory owned by the reader, valid until the next
// ReadRecord/Free on this handle.  EOF: rc 0, *out null, *size 0.
int MXRecordIOReaderReadRecord(RecordIOHandle h, const char** out,
                               size_t* size) {
  Gil gil;
  PyObject* data = Call("recordio_reader_read",
                        PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!data) return -1;
  if (data == Py_None) {
    *out = nullptr;
    *size = 0;
  } else {
    char* p = nullptr;
    Py_ssize_t n = 0;
    if (PyBytes_AsStringAndSize(data, &p, &n) != 0) {
      SetErrorFromPython();
      Py_DECREF(data);
      return -1;
    }
    // the impl stashed its own reference on the reader (_capi_last), so
    // the pointer outlives this borrowed object
    *out = p;
    *size = static_cast<size_t>(n);
  }
  Py_DECREF(data);
  return 0;
}

int MXRecordIOReaderSeek(RecordIOHandle h, size_t pos) {
  Gil gil;
  return CallRC("recordio_reader_seek",
                Py_BuildValue("(On)", static_cast<PyObject*>(h),
                              static_cast<Py_ssize_t>(pos)));
}

// ---- NDArray save/load/slice/reshape (c_api.cc:198-363 parity) -----
int MXNDArraySave(const char* fname, uint32_t num, NDArrayHandle* handles,
                  const char** keys) {
  Gil gil;
  PyObject* nds = PyList_New(num);
  for (uint32_t i = 0; i < num; ++i) {
    PyObject* a = static_cast<PyObject*>(handles[i]);
    Py_INCREF(a);
    PyList_SetItem(nds, i, a);
  }
  PyObject* names = PyList_New(0);
  if (keys) {
    for (uint32_t i = 0; i < num; ++i) {
      PyObject* s = PyUnicode_FromString(keys[i]);
      PyList_Append(names, s);
      Py_DECREF(s);
    }
  }
  return CallRC("ndarray_save",
                Py_BuildValue("(sNN)", fname, nds, names));
}

// The handle ARRAY and name strings live until this thread's next
// MXNDArrayLoad; each handle itself is owned by the CALLER (free with
// MXNDArrayFree, like every other NDArrayHandle in this ABI).
int MXNDArrayLoad(const char* fname, uint32_t* out_size,
                  NDArrayHandle** out_arr, uint32_t* out_name_size,
                  const char*** out_names) {
  Gil gil;
  PyObject* tup = Call("ndarray_load", Py_BuildValue("(s)", fname));
  if (!tup) return -1;
  PyObject* names = PyTuple_GetItem(tup, 0);
  PyObject* nds = PyTuple_GetItem(tup, 1);
  thread_local std::vector<PyObject*> arrs;
  thread_local std::vector<std::string> name_store;
  thread_local std::vector<const char*> name_ptrs;
  arrs.clear();          // pointer storage only: caller owns the refs
  name_store.clear();
  name_ptrs.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(nds); ++i) {
    PyObject* a = PyList_GetItem(nds, i);
    Py_INCREF(a);        // transferred to the caller
    arrs.push_back(a);
  }
  for (Py_ssize_t i = 0; i < PyList_Size(names); ++i) {
    const char* s = PyUnicode_AsUTF8(PyList_GetItem(names, i));
    name_store.push_back(s ? s : "");
  }
  for (auto& s : name_store) name_ptrs.push_back(s.c_str());
  Py_DECREF(tup);
  *out_size = static_cast<uint32_t>(arrs.size());
  *out_arr = reinterpret_cast<NDArrayHandle*>(arrs.data());
  *out_name_size = static_cast<uint32_t>(name_ptrs.size());
  *out_names = name_ptrs.data();
  return 0;
}

int MXNDArrayGetDType(NDArrayHandle h, int* out) {
  Gil gil;
  PyObject* n = Call("ndarray_dtype",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!n) return -1;
  *out = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

int MXNDArraySlice(NDArrayHandle h, uint32_t begin, uint32_t end,
                   NDArrayHandle* out) {
  Gil gil;
  PyObject* nd = Call("ndarray_slice",
                      Py_BuildValue("(OII)", static_cast<PyObject*>(h),
                                    begin, end));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXNDArrayReshape(NDArrayHandle h, uint32_t ndim, const uint32_t* shape,
                     NDArrayHandle* out) {
  Gil gil;
  PyObject* dims = PyTuple_New(ndim);
  for (uint32_t i = 0; i < ndim; ++i)
    PyTuple_SetItem(dims, i, PyLong_FromUnsignedLong(shape[i]));
  PyObject* nd = Call("ndarray_reshape",
                      Py_BuildValue("(ON)", static_cast<PyObject*>(h),
                                    dims));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

// ---- executor training surface (c_api.cc:939-1099 parity) ----------
int MXExecutorSimpleBindTrain(SymbolHandle sym, const char* shapes_json,
                              ExecutorHandle* out) {
  Gil gil;
  PyObject* exec_ = Call("executor_bind_train",
                         Py_BuildValue("(Os)",
                                       static_cast<PyObject*>(sym),
                                       shapes_json));
  if (!exec_) return -1;
  *out = exec_;
  return 0;
}

int MXExecutorBackward(ExecutorHandle h) {
  Gil gil;
  return CallRC("executor_backward",
                PyTuple_Pack(1, static_cast<PyObject*>(h)));
}

// Handles to the executor's BOUND arrays (imperative updates through
// them are seen by the next forward — the reference's arg/grad arrays).
int MXExecutorArgHandle(ExecutorHandle h, const char* name,
                        NDArrayHandle* out) {
  Gil gil;
  PyObject* nd = Call("executor_arg_handle",
                      Py_BuildValue("(Os)", static_cast<PyObject*>(h),
                                    name));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXExecutorGradHandle(ExecutorHandle h, const char* name,
                         NDArrayHandle* out) {
  Gil gil;
  PyObject* nd = Call("executor_grad_handle",
                      Py_BuildValue("(Os)", static_cast<PyObject*>(h),
                                    name));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXExecutorNumArgs(ExecutorHandle h, uint32_t* out) {
  Gil gil;
  PyObject* lst = Call("executor_arg_names",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  *out = static_cast<uint32_t>(PyList_Size(lst));
  Py_DECREF(lst);
  return 0;
}

int MXExecutorArgName(ExecutorHandle h, uint32_t index, char* buf,
                      size_t cap) {
  Gil gil;
  PyObject* lst = Call("executor_arg_names",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  if (index >= static_cast<uint32_t>(PyList_Size(lst))) {
    Py_DECREF(lst);
    SetError("arg index out of range");
    return -1;
  }
  const char* name = PyUnicode_AsUTF8(PyList_GetItem(lst, index));
  snprintf(buf, cap, "%s", name ? name : "");
  Py_DECREF(lst);
  return 0;
}

// Execution-plan dump (MXExecutorPrint / GraphExecutor::Print parity,
// graph_executor.cc:955).  *out valid until this thread's next call.
int MXExecutorPrint(ExecutorHandle h, const char** out) {
  Gil gil;
  PyObject* s = Call("executor_print",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!s) return -1;
  thread_local std::string ret;
  const char* c = PyUnicode_AsUTF8(s);
  ret = c ? c : "";
  Py_DECREF(s);
  *out = ret.c_str();
  return 0;
}

// All symbol attributes as JSON (MXSymbolListAttr parity); *out valid
// until this thread's next call.
int MXSymbolListAttrJSON(SymbolHandle h, const char** out) {
  Gil gil;
  PyObject* s = Call("symbol_attr_json",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!s) return -1;
  thread_local std::string ret;
  const char* c = PyUnicode_AsUTF8(s);
  ret = c ? c : "";
  Py_DECREF(s);
  *out = ret.c_str();
  return 0;
}

// ---- kvstore cluster queries (c_api.cc:1199-1375 parity) -----------
int MXKVStoreGetRank(KVStoreHandle h, int* out) {
  Gil gil;
  PyObject* n = Call("kvstore_rank",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!n) return -1;
  *out = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

int MXKVStoreGetGroupSize(KVStoreHandle h, int* out) {
  Gil gil;
  PyObject* n = Call("kvstore_num_workers",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!n) return -1;
  *out = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

int MXKVStoreGetType(KVStoreHandle h, const char** out) {
  Gil gil;
  PyObject* s = Call("kvstore_type",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!s) return -1;
  thread_local std::string ret;
  const char* c = PyUnicode_AsUTF8(s);
  ret = c ? c : "";
  Py_DECREF(s);
  *out = ret.c_str();
  return 0;
}

int MXKVStoreBarrier(KVStoreHandle h) {
  Gil gil;
  return CallRC("kvstore_barrier",
                PyTuple_Pack(1, static_cast<PyObject*>(h)));
}

// Reference MXKVStoreSetUpdater: a C function becomes the kvstore's
// merge-update rule (the "optimizer runs on the server" hook).  The
// handles passed to the callback are borrowed for the call.
int MXKVStoreSetUpdater(KVStoreHandle h, MXKVStoreUpdaterCB* updater,
                        void* user) {
  Gil gil;
  return CallRC("kvstore_set_c_updater",
                Py_BuildValue("(Onn)", static_cast<PyObject*>(h),
                              reinterpret_cast<Py_ssize_t>(updater),
                              reinterpret_cast<Py_ssize_t>(user)));
}

// ---- misc ----------------------------------------------------------
int MXRandomSeed(int seed) {
  Gil gil;
  return CallRC("random_seed", Py_BuildValue("(i)", seed));
}

int MXGetVersion(int* out) {
  Gil gil;
  PyObject* s = Call("get_version", PyTuple_New(0));
  if (!s) return -1;
  // "MAJOR.MINOR.PATCH" -> MAJOR*10000 + MINOR*100 + PATCH
  const char* c = PyUnicode_AsUTF8(s);
  int maj = 0, min = 0, pat = 0;
  if (c) sscanf(c, "%d.%d.%d", &maj, &min, &pat);
  *out = maj * 10000 + min * 100 + pat;
  Py_DECREF(s);
  return 0;
}

int MXSymbolGetNumAuxiliaryStates(SymbolHandle h, uint32_t* out) {
  Gil gil;
  PyObject* lst = Call("symbol_aux_states",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  *out = static_cast<uint32_t>(PyList_Size(lst));
  Py_DECREF(lst);
  return 0;
}

int MXSymbolGetName(SymbolHandle h, char* buf, size_t cap) {
  Gil gil;
  PyObject* s = Call("symbol_name",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!s) return -1;
  const char* c = PyUnicode_AsUTF8(s);
  snprintf(buf, cap, "%s", c ? c : "");
  Py_DECREF(s);
  return 0;
}

// ---- optimizer (c_api.cc:1525-1556 parity) -------------------------
int MXOptimizerCreateOptimizer(const char* name, const char* kwargs_json,
                               OptimizerHandle* out) {
  Gil gil;
  PyObject* opt = Call("optimizer_create",
                       Py_BuildValue("(ss)", name,
                                     kwargs_json ? kwargs_json : ""));
  if (!opt) return -1;
  *out = opt;
  return 0;
}

int MXOptimizerFree(OptimizerHandle h) { return MXNDArrayFree(h); }

// lr/wd < 0 keep the optimizer's own values (reference passes both
// explicitly on every update)
int MXOptimizerUpdate(OptimizerHandle h, int index, NDArrayHandle weight,
                      NDArrayHandle grad, float lr, float wd) {
  Gil gil;
  return CallRC("optimizer_update",
                Py_BuildValue("(OiOOff)", static_cast<PyObject*>(h), index,
                              static_cast<PyObject*>(weight),
                              static_cast<PyObject*>(grad), lr, wd));
}

// ====================================================================
// Reference-surface completion: the remaining MX* names of the
// reference's ~109-function ABI (c_api.h), same JSON/handle conventions
// as above.
// ====================================================================

// ---- NDArray extras (c_api.cc:116-363) -----------------------------
int MXNDArrayCreateNone(NDArrayHandle* out) {
  Gil gil;
  PyObject* nd = Call("ndarray_create_none", PyTuple_New(0));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXNDArrayCreateEx(const uint32_t* shape, uint32_t ndim, int dev_type,
                      int dev_id, int delay_alloc, int dtype,
                      NDArrayHandle* out) {
  Gil gil;
  PyObject* dims = PyTuple_New(ndim);
  for (uint32_t i = 0; i < ndim; ++i)
    PyTuple_SetItem(dims, i, PyLong_FromUnsignedLong(shape[i]));
  PyObject* nd = Call("ndarray_create_ex",
                      Py_BuildValue("(Niiii)", dims, dev_type, dev_id,
                                    delay_alloc, dtype));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXNDArrayAt(NDArrayHandle h, uint32_t idx, NDArrayHandle* out) {
  Gil gil;
  PyObject* nd = Call("ndarray_at",
                      Py_BuildValue("(OI)", static_cast<PyObject*>(h), idx));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXNDArrayGetContext(NDArrayHandle h, int* out_dev_type,
                        int* out_dev_id) {
  Gil gil;
  PyObject* tup = Call("ndarray_context",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!tup) return -1;
  if (out_dev_type)
    *out_dev_type = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(tup, 0)));
  if (out_dev_id)
    *out_dev_id = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(tup, 1)));
  Py_DECREF(tup);
  return 0;
}

// *out_pdata is a synced float32 host snapshot owned by the handle,
// valid until the next MXNDArrayGetData on it, for every device: the
// header promises host memory, never a device pointer (see
// capi_impl.ndarray_data_addr).
int MXNDArrayGetData(NDArrayHandle h, float** out_pdata) {
  Gil gil;
  PyObject* addr = Call("ndarray_data_addr",
                        PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!addr) return -1;
  *out_pdata = reinterpret_cast<float*>(PyLong_AsSize_t(addr));
  Py_DECREF(addr);
  return 0;
}

int MXNDArrayWaitToRead(NDArrayHandle h) {
  Gil gil;
  return CallRC("ndarray_wait_read",
                PyTuple_Pack(1, static_cast<PyObject*>(h)));
}

int MXNDArrayWaitToWrite(NDArrayHandle h) {
  Gil gil;
  return CallRC("ndarray_wait_write",
                PyTuple_Pack(1, static_cast<PyObject*>(h)));
}

// *out_buf thread-local, valid until this thread's next SaveRawBytes.
int MXNDArraySaveRawBytes(NDArrayHandle h, size_t* out_size,
                          const char** out_buf) {
  Gil gil;
  PyObject* b = Call("ndarray_save_raw",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!b) return -1;
  char* p = nullptr;
  Py_ssize_t n = 0;
  if (PyBytes_AsStringAndSize(b, &p, &n) != 0) {
    SetErrorFromPython();
    Py_DECREF(b);
    return -1;
  }
  thread_local std::string ret;
  ret.assign(p, static_cast<size_t>(n));
  Py_DECREF(b);
  *out_size = ret.size();
  *out_buf = ret.data();
  return 0;
}

int MXNDArrayLoadFromRawBytes(const void* buf, size_t size,
                              NDArrayHandle* out) {
  Gil gil;
  PyObject* nd = Call("ndarray_load_raw",
                      Py_BuildValue("(N)", ReadView(buf, size)));
  if (!nd) return -1;
  *out = nd;
  return 0;
}

int MXNotifyShutdown() {
  Gil gil;
  return CallRC("notify_shutdown", PyTuple_New(0));
}

// ---- Symbol completion (c_api.cc:447-937) --------------------------
int MXSymbolCopy(SymbolHandle h, SymbolHandle* out) {
  Gil gil;
  PyObject* sym = Call("symbol_copy",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!sym) return -1;
  *out = sym;
  return 0;
}

int MXSymbolCreateGroup(uint32_t num_symbols, SymbolHandle* symbols,
                        SymbolHandle* out) {
  Gil gil;
  PyObject* lst = PyList_New(num_symbols);
  for (uint32_t i = 0; i < num_symbols; ++i) {
    PyObject* s = static_cast<PyObject*>(symbols[i]);
    Py_INCREF(s);
    PyList_SetItem(lst, i, s);
  }
  PyObject* sym = Call("symbol_group", Py_BuildValue("(N)", lst));
  if (!sym) return -1;
  *out = sym;
  return 0;
}

int MXSymbolCreateFromFile(const char* fname, SymbolHandle* out) {
  Gil gil;
  PyObject* sym = Call("symbol_from_file", Py_BuildValue("(s)", fname));
  if (!sym) return -1;
  *out = sym;
  return 0;
}

int MXSymbolSaveToFile(SymbolHandle h, const char* fname) {
  Gil gil;
  return CallRC("symbol_save_file",
                Py_BuildValue("(Os)", static_cast<PyObject*>(h), fname));
}

int MXSymbolGetInternals(SymbolHandle h, SymbolHandle* out) {
  Gil gil;
  PyObject* sym = Call("symbol_get_internals",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!sym) return -1;
  *out = sym;
  return 0;
}

int MXSymbolGrad(SymbolHandle h, uint32_t num_wrt, const char** wrt,
                 SymbolHandle* out) {
  Gil gil;
  PyObject* names = PyList_New(num_wrt);
  for (uint32_t i = 0; i < num_wrt; ++i)
    PyList_SetItem(names, i, PyUnicode_FromString(wrt[i]));
  PyObject* sym = Call("symbol_grad",
                       Py_BuildValue("(ON)", static_cast<PyObject*>(h),
                                     names));
  if (!sym) return -1;
  *out = sym;
  return 0;
}

namespace {

// string-array return helper (the reference's per-thread ret_vec_charp):
// copies a python list[str] into thread-local storage and exposes it as
// a const char** valid until this thread's next call through here.
int FillStrArray(PyObject* lst, uint32_t* out_size,
                 const char*** out_array) {
  thread_local std::vector<std::string> store;
  thread_local std::vector<const char*> ptrs;
  store.clear();
  ptrs.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(lst); ++i) {
    const char* s = PyUnicode_AsUTF8(PyList_GetItem(lst, i));
    store.push_back(s ? s : "");
  }
  for (auto& s : store) ptrs.push_back(s.c_str());
  *out_size = static_cast<uint32_t>(ptrs.size());
  *out_array = ptrs.data();
  return 0;
}

int ListThrough(const char* impl_fn, PyObject* h, uint32_t* out_size,
                const char*** out_array) {
  PyObject* lst = Call(impl_fn, PyTuple_Pack(1, h));
  if (!lst) return -1;
  int rc = FillStrArray(lst, out_size, out_array);
  Py_DECREF(lst);
  return rc;
}

}  // namespace

int MXSymbolListArguments(SymbolHandle h, uint32_t* out_size,
                          const char*** out_str_array) {
  Gil gil;
  return ListThrough("symbol_arguments", static_cast<PyObject*>(h),
                     out_size, out_str_array);
}

int MXSymbolListOutputs(SymbolHandle h, uint32_t* out_size,
                        const char*** out_str_array) {
  Gil gil;
  return ListThrough("symbol_outputs", static_cast<PyObject*>(h),
                     out_size, out_str_array);
}

int MXSymbolListAuxiliaryStates(SymbolHandle h, uint32_t* out_size,
                                const char*** out_str_array) {
  Gil gil;
  return ListThrough("symbol_aux_states", static_cast<PyObject*>(h),
                     out_size, out_str_array);
}

namespace {

int ListAttrPairs(PyObject* h, int deep, uint32_t* out_size,
                  const char*** out) {
  PyObject* lst = Call("symbol_attr_pairs",
                       Py_BuildValue("(Oi)", h, deep));
  if (!lst) return -1;
  uint32_t n = 0;
  int rc = FillStrArray(lst, &n, out);
  Py_DECREF(lst);
  *out_size = n / 2;  // reference convention: count of (key, value) PAIRS
  return rc;
}

}  // namespace

int MXSymbolListAttr(SymbolHandle h, uint32_t* out_size,
                     const char*** out) {
  Gil gil;
  return ListAttrPairs(static_cast<PyObject*>(h), 1, out_size, out);
}

int MXSymbolListAttrShallow(SymbolHandle h, uint32_t* out_size,
                            const char*** out) {
  Gil gil;
  return ListAttrPairs(static_cast<PyObject*>(h), 0, out_size, out);
}

int MXSymbolPrint(SymbolHandle h, const char** out_str) {
  Gil gil;
  PyObject* s = Call("symbol_print",
                     PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!s) return -1;
  thread_local std::string ret;
  const char* c = PyUnicode_AsUTF8(s);
  ret = c ? c : "";
  Py_DECREF(s);
  *out_str = ret.c_str();
  return 0;
}

// ---- array-convention shape/type inference (reference CSR layout) --
namespace {

struct ShapeTriple {
  // storage for the three shape lists (arg/out/aux) of one infer call
  std::vector<std::vector<uint32_t>> shapes[3];
  std::vector<uint32_t> ndims[3];
  std::vector<const uint32_t*> data[3];
};

thread_local ShapeTriple g_infer_shapes;

int UnpackShapeList(PyObject* lst, int slot, uint32_t* size,
                    const uint32_t** ndim_out, const uint32_t*** data_out) {
  auto& st = g_infer_shapes;
  st.shapes[slot].clear();
  st.ndims[slot].clear();
  st.data[slot].clear();
  for (Py_ssize_t i = 0; i < PyList_Size(lst); ++i) {
    PyObject* tup = PyList_GetItem(lst, i);
    std::vector<uint32_t> dims;
    for (Py_ssize_t d = 0; d < PyTuple_Size(tup); ++d)
      dims.push_back(static_cast<uint32_t>(
          PyLong_AsUnsignedLong(PyTuple_GetItem(tup, d))));
    st.shapes[slot].push_back(std::move(dims));
  }
  for (auto& dims : st.shapes[slot]) {
    st.ndims[slot].push_back(static_cast<uint32_t>(dims.size()));
    st.data[slot].push_back(dims.data());
  }
  *size = static_cast<uint32_t>(st.shapes[slot].size());
  *ndim_out = st.ndims[slot].data();
  *data_out = st.data[slot].data();
  return 0;
}

int InferShapeImpl(SymbolHandle h, uint32_t num_args, const char** keys,
                   const uint32_t* arg_ind_ptr,
                   const uint32_t* arg_shape_data, uint32_t* in_shape_size,
                   const uint32_t** in_shape_ndim,
                   const uint32_t*** in_shape_data,
                   uint32_t* out_shape_size,
                   const uint32_t** out_shape_ndim,
                   const uint32_t*** out_shape_data,
                   uint32_t* aux_shape_size,
                   const uint32_t** aux_shape_ndim,
                   const uint32_t*** aux_shape_data, int* complete,
                   int partial) {
  PyObject* pykeys = PyList_New(0);
  if (keys) {
    for (uint32_t i = 0; i < num_args; ++i) {
      PyObject* s = PyUnicode_FromString(keys[i]);
      PyList_Append(pykeys, s);
      Py_DECREF(s);
    }
  }
  PyObject* pyshapes = PyList_New(num_args);
  for (uint32_t i = 0; i < num_args; ++i) {
    uint32_t lo = arg_ind_ptr[i], hi = arg_ind_ptr[i + 1];
    PyObject* tup = PyTuple_New(hi - lo);
    for (uint32_t d = lo; d < hi; ++d)
      PyTuple_SetItem(tup, d - lo,
                      PyLong_FromUnsignedLong(arg_shape_data[d]));
    PyList_SetItem(pyshapes, i, tup);
  }
  PyObject* res = Call("symbol_infer_shape_arrays",
                       Py_BuildValue("(ONNi)", static_cast<PyObject*>(h),
                                     pykeys, pyshapes, partial));
  if (!res) return -1;
  UnpackShapeList(PyTuple_GetItem(res, 0), 0, in_shape_size, in_shape_ndim,
                  in_shape_data);
  UnpackShapeList(PyTuple_GetItem(res, 1), 1, out_shape_size,
                  out_shape_ndim, out_shape_data);
  UnpackShapeList(PyTuple_GetItem(res, 2), 2, aux_shape_size,
                  aux_shape_ndim, aux_shape_data);
  if (complete)
    *complete = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(res, 3)));
  Py_DECREF(res);
  return 0;
}

}  // namespace

int MXSymbolInferShape(SymbolHandle h, uint32_t num_args, const char** keys,
                       const uint32_t* arg_ind_ptr,
                       const uint32_t* arg_shape_data,
                       uint32_t* in_shape_size,
                       const uint32_t** in_shape_ndim,
                       const uint32_t*** in_shape_data,
                       uint32_t* out_shape_size,
                       const uint32_t** out_shape_ndim,
                       const uint32_t*** out_shape_data,
                       uint32_t* aux_shape_size,
                       const uint32_t** aux_shape_ndim,
                       const uint32_t*** aux_shape_data, int* complete) {
  Gil gil;
  return InferShapeImpl(h, num_args, keys, arg_ind_ptr, arg_shape_data,
                        in_shape_size, in_shape_ndim, in_shape_data,
                        out_shape_size, out_shape_ndim, out_shape_data,
                        aux_shape_size, aux_shape_ndim, aux_shape_data,
                        complete, 0);
}

int MXSymbolInferShapePartial(SymbolHandle h, uint32_t num_args,
                              const char** keys,
                              const uint32_t* arg_ind_ptr,
                              const uint32_t* arg_shape_data,
                              uint32_t* in_shape_size,
                              const uint32_t** in_shape_ndim,
                              const uint32_t*** in_shape_data,
                              uint32_t* out_shape_size,
                              const uint32_t** out_shape_ndim,
                              const uint32_t*** out_shape_data,
                              uint32_t* aux_shape_size,
                              const uint32_t** aux_shape_ndim,
                              const uint32_t*** aux_shape_data,
                              int* complete) {
  Gil gil;
  return InferShapeImpl(h, num_args, keys, arg_ind_ptr, arg_shape_data,
                        in_shape_size, in_shape_ndim, in_shape_data,
                        out_shape_size, out_shape_ndim, out_shape_data,
                        aux_shape_size, aux_shape_ndim, aux_shape_data,
                        complete, 1);
}

int MXSymbolInferType(SymbolHandle h, uint32_t num_args, const char** keys,
                      const int* arg_type_data, uint32_t* in_type_size,
                      const int** in_type_data, uint32_t* out_type_size,
                      const int** out_type_data, uint32_t* aux_type_size,
                      const int** aux_type_data, int* complete) {
  Gil gil;
  PyObject* pykeys = PyList_New(0);
  if (keys) {
    for (uint32_t i = 0; i < num_args; ++i) {
      PyObject* s = PyUnicode_FromString(keys[i]);
      PyList_Append(pykeys, s);
      Py_DECREF(s);
    }
  }
  PyObject* pytypes = PyList_New(num_args);
  for (uint32_t i = 0; i < num_args; ++i)
    PyList_SetItem(pytypes, i, PyLong_FromLong(arg_type_data[i]));
  PyObject* res = Call("symbol_infer_type_arrays",
                       Py_BuildValue("(ONN)", static_cast<PyObject*>(h),
                                     pykeys, pytypes));
  if (!res) return -1;
  thread_local std::vector<int> store[3];
  PyObject* lists[3] = {PyTuple_GetItem(res, 0), PyTuple_GetItem(res, 1),
                        PyTuple_GetItem(res, 2)};
  uint32_t* sizes[3] = {in_type_size, out_type_size, aux_type_size};
  const int** datas[3] = {in_type_data, out_type_data, aux_type_data};
  for (int k = 0; k < 3; ++k) {
    store[k].clear();
    for (Py_ssize_t i = 0; i < PyList_Size(lists[k]); ++i)
      store[k].push_back(
          static_cast<int>(PyLong_AsLong(PyList_GetItem(lists[k], i))));
    if (sizes[k]) *sizes[k] = static_cast<uint32_t>(store[k].size());
    if (datas[k]) *datas[k] = store[k].data();
  }
  if (complete)
    *complete = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(res, 3)));
  Py_DECREF(res);
  return 0;
}

// ---- atomic symbol creators (c_api.cc:447-530) ---------------------
namespace {

std::vector<FuncInfo*>* g_atomic_creators = nullptr;  // leaked on purpose

int EnsureAtomicCreators() {
  if (g_atomic_creators) return 0;
  PyObject* lst = Call("registry_list_ops", PyTuple_New(0));
  if (!lst) return -1;
  auto* fns = new std::vector<FuncInfo*>();
  for (Py_ssize_t i = 0; i < PyList_Size(lst); ++i) {
    const char* nm = PyUnicode_AsUTF8(PyList_GetItem(lst, i));
    auto* fi = new FuncInfo();
    fi->name = nm ? nm : "";
    fns->push_back(fi);
  }
  Py_DECREF(lst);
  g_atomic_creators = fns;
  return 0;
}

}  // namespace

int MXSymbolListAtomicSymbolCreators(uint32_t* out_size,
                                     AtomicSymbolCreator** out_array) {
  Gil gil;
  if (EnsureAtomicCreators() != 0) return -1;
  *out_size = static_cast<uint32_t>(g_atomic_creators->size());
  *out_array =
      reinterpret_cast<AtomicSymbolCreator*>(g_atomic_creators->data());
  return 0;
}

int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                const char** name) {
  Gil gil;
  auto* fi = static_cast<FuncInfo*>(creator);
  if (!fi) { SetError("null creator handle"); return -1; }
  *name = fi->name.c_str();
  return 0;
}

int MXSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator,
                                const char** name, const char** description,
                                uint32_t* num_args, const char*** arg_names,
                                const char*** arg_type_infos,
                                const char*** arg_descriptions,
                                const char** key_var_num_args) {
  Gil gil;
  auto* fi = static_cast<FuncInfo*>(creator);
  if (!fi) { SetError("null creator handle"); return -1; }
  if (fi->description.empty() && fi->arg_names.empty()) {
    PyObject* tup = Call("registry_symbol_op_info",
                         Py_BuildValue("(s)", fi->name.c_str()));
    if (!tup) return -1;
    const char* desc = PyUnicode_AsUTF8(PyTuple_GetItem(tup, 1));
    fi->description = desc ? desc : "";
    PyObject* lists[3] = {PyTuple_GetItem(tup, 2), PyTuple_GetItem(tup, 3),
                          PyTuple_GetItem(tup, 4)};
    std::vector<std::string>* dsts[3] = {&fi->arg_names, &fi->arg_types,
                                         &fi->arg_descs};
    for (int k = 0; k < 3; ++k)
      for (Py_ssize_t i = 0; i < PyList_Size(lists[k]); ++i) {
        const char* s = PyUnicode_AsUTF8(PyList_GetItem(lists[k], i));
        dsts[k]->push_back(s ? s : "");
      }
    const char* kv = PyUnicode_AsUTF8(PyTuple_GetItem(tup, 5));
    fi->key_var = kv ? kv : "";
    Py_DECREF(tup);
    for (auto& s : fi->arg_names) fi->pnames.push_back(s.c_str());
    for (auto& s : fi->arg_types) fi->ptypes.push_back(s.c_str());
    for (auto& s : fi->arg_descs) fi->pdescs.push_back(s.c_str());
  }
  if (name) *name = fi->name.c_str();
  if (description) *description = fi->description.c_str();
  if (num_args) *num_args = static_cast<uint32_t>(fi->arg_names.size());
  if (arg_names) *arg_names = fi->pnames.data();
  if (arg_type_infos) *arg_type_infos = fi->ptypes.data();
  if (arg_descriptions) *arg_descriptions = fi->pdescs.data();
  if (key_var_num_args) *key_var_num_args = fi->key_var.c_str();
  return 0;
}

// ---- function registry completion ----------------------------------
int MXGetFunction(const char* name, FunctionHandle* out) {
  Gil gil;
  if (EnsureFunctions() != 0) return -1;
  for (auto* fi : *g_functions) {
    if (fi->name == name) {
      *out = fi;
      return 0;
    }
  }
  SetError("function not found");
  return -1;
}

int MXFuncDescribe(FunctionHandle fn, uint32_t* num_use_vars,
                   uint32_t* num_scalars, uint32_t* num_mutate_vars,
                   int* type_mask) {
  Gil gil;
  auto* fi = static_cast<FuncInfo*>(fn);
  if (!fi) { SetError("null function handle"); return -1; }
  PyObject* tup = Call("registry_op_describe",
                       Py_BuildValue("(s)", fi->name.c_str()));
  if (!tup) return -1;
  if (num_use_vars)
    *num_use_vars = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(tup, 0)));
  if (num_scalars)
    *num_scalars = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(tup, 1)));
  if (num_mutate_vars)
    *num_mutate_vars = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(tup, 2)));
  if (type_mask)
    *type_mask = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(tup, 3)));
  Py_DECREF(tup);
  return 0;
}

// the reference's key/value-array invoke (vs MXFuncInvoke's JSON):
// results are written INTO mutate_vars
int MXFuncInvokeEx(FunctionHandle fn, NDArrayHandle* use_vars,
                   float* scalar_args, NDArrayHandle* mutate_vars,
                   int num_params, char** param_keys, char** param_vals) {
  Gil gil;
  auto* fi = static_cast<FuncInfo*>(fn);
  if (!fi) { SetError("null function handle"); return -1; }
  uint32_t n_use = 0, n_scalar = 0, n_mut = 0;
  {
    PyObject* tup = Call("registry_op_describe",
                         Py_BuildValue("(s)", fi->name.c_str()));
    if (!tup) return -1;
    n_use = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(tup, 0)));
    n_scalar = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(tup, 1)));
    n_mut = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(tup, 2)));
    Py_DECREF(tup);
  }
  // pass the param arrays straight through as python lists (no JSON
  // round trip: arbitrary key/value strings stay intact)
  PyObject* pkeys = PyList_New(num_params);
  PyObject* pvals = PyList_New(num_params);
  for (int i = 0; i < num_params; ++i) {
    PyList_SetItem(pkeys, i, PyUnicode_FromString(param_keys[i]));
    PyList_SetItem(pvals, i, PyUnicode_FromString(param_vals[i]));
  }
  PyObject* uses = PyList_New(n_use);
  for (uint32_t i = 0; i < n_use; ++i) {
    PyObject* a = static_cast<PyObject*>(use_vars[i]);
    Py_INCREF(a);
    PyList_SetItem(uses, i, a);
  }
  PyObject* scalars = PyList_New(n_scalar);
  for (uint32_t i = 0; i < n_scalar; ++i)
    PyList_SetItem(scalars, i,
                   PyFloat_FromDouble(scalar_args ? scalar_args[i] : 0.0));
  PyObject* muts = PyList_New(n_mut);
  for (uint32_t i = 0; i < n_mut; ++i) {
    PyObject* a = static_cast<PyObject*>(mutate_vars[i]);
    Py_INCREF(a);
    PyList_SetItem(muts, i, a);
  }
  return CallRC("func_invoke_into",
                Py_BuildValue("(sNNNNN)", fi->name.c_str(), pkeys, pvals,
                              uses, scalars, muts));
}

// ---- executor completion (c_api.cc:939-1099) -----------------------
namespace {

int BindImpl(SymbolHandle sym, int dev_type, int dev_id,
             uint32_t num_map_keys, const char** map_keys,
             const int* map_dev_types, const int* map_dev_ids, uint32_t len,
             NDArrayHandle* in_args, NDArrayHandle* arg_grad_store,
             uint32_t* grad_req_type, uint32_t aux_states_len,
             NDArrayHandle* aux_states, ExecutorHandle shared_exec,
             ExecutorHandle* out) {
  PyObject* args = PyList_New(len);
  for (uint32_t i = 0; i < len; ++i) {
    PyObject* a = static_cast<PyObject*>(in_args[i]);
    Py_INCREF(a);
    PyList_SetItem(args, i, a);
  }
  PyObject* grads = PyList_New(len);
  for (uint32_t i = 0; i < len; ++i) {
    PyObject* g = arg_grad_store && arg_grad_store[i]
                      ? static_cast<PyObject*>(arg_grad_store[i])
                      : Py_None;
    Py_INCREF(g);
    PyList_SetItem(grads, i, g);
  }
  PyObject* reqs = PyList_New(len);
  for (uint32_t i = 0; i < len; ++i)
    PyList_SetItem(reqs, i,
                   PyLong_FromUnsignedLong(grad_req_type ? grad_req_type[i]
                                                         : 1));
  PyObject* auxs = PyList_New(aux_states_len);
  for (uint32_t i = 0; i < aux_states_len; ++i) {
    PyObject* a = static_cast<PyObject*>(aux_states[i]);
    Py_INCREF(a);
    PyList_SetItem(auxs, i, a);
  }
  PyObject* mkeys = PyList_New(0);
  PyObject* mtypes = PyList_New(0);
  PyObject* mids = PyList_New(0);
  for (uint32_t i = 0; i < num_map_keys; ++i) {
    PyObject* s = PyUnicode_FromString(map_keys[i]);
    PyList_Append(mkeys, s);
    Py_DECREF(s);
    PyObject* t = PyLong_FromLong(map_dev_types[i]);
    PyList_Append(mtypes, t);
    Py_DECREF(t);
    PyObject* d = PyLong_FromLong(map_dev_ids[i]);
    PyList_Append(mids, d);
    Py_DECREF(d);
  }
  PyObject* shared = shared_exec ? static_cast<PyObject*>(shared_exec)
                                 : Py_None;
  PyObject* exec_ = Call(
      "executor_bind_full",
      Py_BuildValue("(OiiNNNNNNNO)", static_cast<PyObject*>(sym), dev_type,
                    dev_id, args, grads, reqs, auxs, mkeys, mtypes, mids,
                    shared));
  if (!exec_) return -1;
  *out = exec_;
  return 0;
}

}  // namespace

int MXExecutorBind(SymbolHandle sym, int dev_type, int dev_id, uint32_t len,
                   NDArrayHandle* in_args, NDArrayHandle* arg_grad_store,
                   uint32_t* grad_req_type, uint32_t aux_states_len,
                   NDArrayHandle* aux_states, ExecutorHandle* out) {
  Gil gil;
  return BindImpl(sym, dev_type, dev_id, 0, nullptr, nullptr, nullptr, len,
                  in_args, arg_grad_store, grad_req_type, aux_states_len,
                  aux_states, nullptr, out);
}

int MXExecutorBindX(SymbolHandle sym, int dev_type, int dev_id,
                    uint32_t num_map_keys, const char** map_keys,
                    const int* map_dev_types, const int* map_dev_ids,
                    uint32_t len, NDArrayHandle* in_args,
                    NDArrayHandle* arg_grad_store, uint32_t* grad_req_type,
                    uint32_t aux_states_len, NDArrayHandle* aux_states,
                    ExecutorHandle* out) {
  Gil gil;
  return BindImpl(sym, dev_type, dev_id, num_map_keys, map_keys,
                  map_dev_types, map_dev_ids, len, in_args, arg_grad_store,
                  grad_req_type, aux_states_len, aux_states, nullptr, out);
}

int MXExecutorBindEX(SymbolHandle sym, int dev_type, int dev_id,
                     uint32_t num_map_keys, const char** map_keys,
                     const int* map_dev_types, const int* map_dev_ids,
                     uint32_t len, NDArrayHandle* in_args,
                     NDArrayHandle* arg_grad_store, uint32_t* grad_req_type,
                     uint32_t aux_states_len, NDArrayHandle* aux_states,
                     ExecutorHandle shared_exec, ExecutorHandle* out) {
  Gil gil;
  return BindImpl(sym, dev_type, dev_id, num_map_keys, map_keys,
                  map_dev_types, map_dev_ids, len, in_args, arg_grad_store,
                  grad_req_type, aux_states_len, aux_states, shared_exec,
                  out);
}

// handle ARRAY thread-local until the next call; each handle owned by
// the caller (same convention as MXNDArrayLoad)
int MXExecutorOutputs(ExecutorHandle h, uint32_t* out_size,
                      NDArrayHandle** out) {
  Gil gil;
  PyObject* lst = Call("executor_outputs",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  thread_local std::vector<PyObject*> arrs;
  arrs.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(lst); ++i) {
    PyObject* a = PyList_GetItem(lst, i);
    Py_INCREF(a);  // transferred to the caller
    arrs.push_back(a);
  }
  Py_DECREF(lst);
  *out_size = static_cast<uint32_t>(arrs.size());
  *out = reinterpret_cast<NDArrayHandle*>(arrs.data());
  return 0;
}

int MXExecutorSetMonitorCallback(ExecutorHandle h,
                                 ExecutorMonitorCallback callback,
                                 void* callback_handle) {
  Gil gil;
  return CallRC("executor_set_monitor_c",
                Py_BuildValue("(Onn)", static_cast<PyObject*>(h),
                              reinterpret_cast<Py_ssize_t>(callback),
                              reinterpret_cast<Py_ssize_t>(callback_handle)));
}

// ---- kvstore completion (c_api.cc:1199-1375) -----------------------
int MXInitPSEnv(uint32_t num_vars, const char** keys, const char** vals) {
  Gil gil;
  PyObject* ks = PyList_New(num_vars);
  PyObject* vs = PyList_New(num_vars);
  for (uint32_t i = 0; i < num_vars; ++i) {
    PyList_SetItem(ks, i, PyUnicode_FromString(keys[i]));
    PyList_SetItem(vs, i, PyUnicode_FromString(vals[i]));
  }
  return CallRC("init_ps_env", Py_BuildValue("(NN)", ks, vs));
}

namespace {

int RoleQuery(const char* fn, int* ret) {
  PyObject* n = Call(fn, PyTuple_New(0));
  if (!n) return -1;
  *ret = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

}  // namespace

int MXKVStoreIsWorkerNode(int* ret) {
  Gil gil;
  return RoleQuery("kvstore_is_worker", ret);
}

int MXKVStoreIsServerNode(int* ret) {
  Gil gil;
  return RoleQuery("kvstore_is_server", ret);
}

int MXKVStoreIsSchedulerNode(int* ret) {
  Gil gil;
  return RoleQuery("kvstore_is_scheduler", ret);
}

int MXKVStoreGetNumDeadNode(KVStoreHandle h, const int node_id, int* number,
                            const int timeout_sec) {
  Gil gil;
  PyObject* n = Call("kvstore_num_dead",
                     Py_BuildValue("(Oii)", static_cast<PyObject*>(h),
                                   node_id, timeout_sec));
  if (!n) return -1;
  *number = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

int MXKVStoreSetBarrierBeforeExit(KVStoreHandle h,
                                  const int barrier_before_exit) {
  Gil gil;
  return CallRC("kvstore_set_barrier_before_exit",
                Py_BuildValue("(Oi)", static_cast<PyObject*>(h),
                              barrier_before_exit));
}

// (sic) the reference's triple-m typo is part of its ABI
int MXKVStoreSendCommmandToServers(KVStoreHandle h, int cmd_id,
                                   const char* cmd_body) {
  Gil gil;
  return CallRC("kvstore_send_command",
                Py_BuildValue("(Ois)", static_cast<PyObject*>(h), cmd_id,
                              cmd_body ? cmd_body : ""));
}

int MXKVStoreRunServer(KVStoreHandle h, MXKVStoreServerController controller,
                       void* controller_handle) {
  Gil gil;
  return CallRC("kvstore_run_server_c",
                Py_BuildValue("(Onn)", static_cast<PyObject*>(h),
                              reinterpret_cast<Py_ssize_t>(controller),
                              reinterpret_cast<Py_ssize_t>(
                                  controller_handle)));
}

// ---- data iter index ------------------------------------------------
// *out_index thread-local until this thread's next call
int MXDataIterGetIndex(DataIterHandle h, uint64_t** out_index,
                       uint64_t* out_size) {
  Gil gil;
  PyObject* lst = Call("dataiter_get_index",
                       PyTuple_Pack(1, static_cast<PyObject*>(h)));
  if (!lst) return -1;
  thread_local std::vector<uint64_t> idx;
  idx.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(lst); ++i)
    idx.push_back(static_cast<uint64_t>(
        PyLong_AsUnsignedLongLong(PyList_GetItem(lst, i))));
  Py_DECREF(lst);
  *out_size = idx.size();
  *out_index = idx.data();
  return 0;
}

// ---- optimizer creator lookup ---------------------------------------
int MXOptimizerFindCreator(const char* key, OptimizerCreator* out) {
  Gil gil;
  PyObject* name = Call("optimizer_find_creator", Py_BuildValue("(s)", key));
  if (!name) return -1;
  *out = name;  // canonical-name str object; consumed by CreateOptimizer
  return 0;
}

// ---- Rtc: runtime kernels through C (reference MXRtc* over NVRTC;
// the source is a CUDA C kernel body or Python — see
// capi_impl.rtc_create)
int MXRtcCreate(char* name, uint32_t num_input, uint32_t num_output,
                char** input_names, char** output_names,
                NDArrayHandle* inputs, NDArrayHandle* outputs, char* kernel,
                RtcHandle* out) {
  Gil gil;
  PyObject* in_names = PyList_New(num_input);
  for (uint32_t i = 0; i < num_input; ++i)
    PyList_SetItem(in_names, i, PyUnicode_FromString(input_names[i]));
  PyObject* out_names = PyList_New(num_output);
  for (uint32_t i = 0; i < num_output; ++i)
    PyList_SetItem(out_names, i, PyUnicode_FromString(output_names[i]));
  PyObject* ins = PyList_New(num_input);
  for (uint32_t i = 0; i < num_input; ++i) {
    PyObject* a = static_cast<PyObject*>(inputs[i]);
    Py_INCREF(a);
    PyList_SetItem(ins, i, a);
  }
  PyObject* outs = PyList_New(num_output);
  for (uint32_t i = 0; i < num_output; ++i) {
    PyObject* a = static_cast<PyObject*>(outputs[i]);
    Py_INCREF(a);
    PyList_SetItem(outs, i, a);
  }
  PyObject* rtc = Call("rtc_create",
                       Py_BuildValue("(sNNNNs)", name, in_names, out_names,
                                     ins, outs, kernel));
  if (!rtc) return -1;
  *out = rtc;
  return 0;
}

int MXRtcPush(RtcHandle h, uint32_t num_input, uint32_t num_output,
              NDArrayHandle* inputs, NDArrayHandle* outputs,
              uint32_t gridDimX, uint32_t gridDimY, uint32_t gridDimZ,
              uint32_t blockDimX, uint32_t blockDimY, uint32_t blockDimZ) {
  Gil gil;
  PyObject* ins = PyList_New(num_input);
  for (uint32_t i = 0; i < num_input; ++i) {
    PyObject* a = static_cast<PyObject*>(inputs[i]);
    Py_INCREF(a);
    PyList_SetItem(ins, i, a);
  }
  PyObject* outs = PyList_New(num_output);
  for (uint32_t i = 0; i < num_output; ++i) {
    PyObject* a = static_cast<PyObject*>(outputs[i]);
    Py_INCREF(a);
    PyList_SetItem(outs, i, a);
  }
  PyObject* grid = Py_BuildValue("(III)", gridDimX, gridDimY, gridDimZ);
  PyObject* block = Py_BuildValue("(III)", blockDimX, blockDimY, blockDimZ);
  return CallRC("rtc_push",
                Py_BuildValue("(ONNNN)", static_cast<PyObject*>(h), ins,
                              outs, grid, block));
}

int MXRtcFree(RtcHandle h) { return MXNDArrayFree(h); }

// ---- predict ABI completion (c_predict_api parity) -----------------
int MXPredCreatePartialOut(const char* symbol_json, const char* param_path,
                           const char* shapes_json,
                           uint32_t num_output_nodes,
                           const char** output_keys, PredictorHandle* out) {
  Gil gil;
  PyObject* keys = PyList_New(num_output_nodes);
  for (uint32_t i = 0; i < num_output_nodes; ++i)
    PyList_SetItem(keys, i, PyUnicode_FromString(output_keys[i]));
  PyObject* pred = Call("pred_create_partial",
                        Py_BuildValue("(sssN)", symbol_json, param_path,
                                      shapes_json, keys));
  if (!pred) return -1;
  *out = pred;
  return 0;
}

int MXPredPartialForward(PredictorHandle h, int step, int* step_left) {
  Gil gil;
  PyObject* n = Call("pred_partial_forward",
                     Py_BuildValue("(Oi)", static_cast<PyObject*>(h),
                                   step));
  if (!n) return -1;
  if (step_left) *step_left = static_cast<int>(PyLong_AsLong(n));
  Py_DECREF(n);
  return 0;
}

int MXNDListCreate(const char* nd_file_bytes, int nd_file_size,
                   NDListHandle* out, uint32_t* out_length) {
  Gil gil;
  PyObject* items = Call("ndlist_create",
                         Py_BuildValue("(N)",
                                       ReadView(nd_file_bytes,
                                                (size_t)nd_file_size)));
  if (!items) return -1;
  *out = items;
  if (out_length)
    *out_length = static_cast<uint32_t>(PyList_Size(items));
  return 0;
}

// every returned pointer (key, data, shape) aims into caches owned by
// the list handle: all stay valid until MXNDListFree, as documented
int MXNDListGet(NDListHandle h, uint32_t index, const char** out_key,
                const float** out_data, const uint32_t** out_shape,
                uint32_t* out_ndim) {
  Gil gil;
  PyObject* tup = Call("ndlist_get",
                       Py_BuildValue("(OI)", static_cast<PyObject*>(h),
                                     index));
  if (!tup) return -1;
  if (out_key) *out_key = PyUnicode_AsUTF8(PyTuple_GetItem(tup, 0));
  if (out_data)
    *out_data = reinterpret_cast<const float*>(
        PyLong_AsSize_t(PyTuple_GetItem(tup, 1)));
  if (out_shape)
    *out_shape = reinterpret_cast<const uint32_t*>(
        PyLong_AsSize_t(PyTuple_GetItem(tup, 2)));
  if (out_ndim)
    *out_ndim = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(tup, 3)));
  Py_DECREF(tup);
  return 0;
}

int MXNDListFree(NDListHandle h) { return MXNDArrayFree(h); }

// ---- custom op registration (reference CustomOpPropCreator protocol;
// struct layouts declared in include/mxtpu/c_api.h, mirrored by the
// ctypes Structures in capi_impl._custom_ctypes) ---------------------
int MXCustomOpRegister(const char* op_type, CustomOpPropCreator creator) {
  Gil gil;
  return CallRC("custom_op_register_c",
                Py_BuildValue("(sn)", op_type,
                              reinterpret_cast<Py_ssize_t>(creator)));
}

}  // extern "C"
