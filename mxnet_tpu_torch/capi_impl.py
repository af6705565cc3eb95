"""Python side of the port's C ABI (``mxnet_tpu_torch/csrc/c_api.cc``).

The port's counterpart of ``mxnet_tpu/capi_impl.py``, over the same
header, ``include/mxtpu/c_api.h``: the ABI embeds the interpreter and
calls these helpers, which take and return only primitives, buffers and
opaque objects the C side holds as handles.  A handle is a reference to
a Python object of the port (an ``NDArray``, ``Symbol``, ``Executor``,
...), so a C callback (the kvstore updater, the monitor, a custom op's
compute) receives real ``NDArray`` objects, whose ``id()`` is the
handle.

Where the JAX package's helpers run on the JAX default device, these
place what they create by :func:`capi_context`: ``gpu(0)`` unless
``MXNET_CAPI_CONTEXT`` names another context (``cpu``, ``gpu:1``,
``gpu(1)``).  Nothing falls back: with no CUDA device the first call
that creates an array on ``gpu(0)`` fails with the port's error.  Calls
that name a ``dev_type`` take it; ``dev_type`` 4 (the JAX package's
``tpu``) raises.

``MXRtcCreate`` takes Python source defining a function of the inputs
(run eagerly) or the body of a CUDA C kernel (compiled by NVRTC for
``sm_90a``, launched with the caller's grid and block); a Pallas body
raises.

Keep the signatures in step with ``csrc/c_api.cc``.
"""
from __future__ import annotations

import os
import re

import numpy as _np
import torch

#: the environment variable naming the context of calls that name none
CONTEXT_ENV = "MXNET_CAPI_CONTEXT"


def capi_context():
    """The context of the entry points that name no device:
    ``gpu(0)``, or what ``MXNET_CAPI_CONTEXT`` names (a device type,
    optionally with an id: ``cpu``, ``gpu:1``, ``gpu(1)``).  An unknown
    value raises, and so does a GPU context with no such CUDA device."""
    from .base import MXNetError
    from .context import Context, resolve
    spec = os.environ.get(CONTEXT_ENV, "").strip()
    if not spec:
        ctx = Context("gpu", 0)
    else:
        m = re.fullmatch(r"([a-z_]+)\s*(?::\s*(\d+)|\(\s*(\d+)\s*\))?", spec)
        if m is None:
            raise MXNetError("%s=%r is not a context (cpu, gpu, gpu:1, "
                             "gpu(1))" % (CONTEXT_ENV, spec))
        ctx = Context(m.group(1), int(m.group(2) or m.group(3) or 0))
    resolve(ctx)
    return ctx


def _dev_context(dev_type, dev_id):
    """The context of a caller's ``dev_type``/``dev_id`` (1 cpu, 2 gpu,
    3 cpu_pinned; 4, the JAX package's tpu, raises)."""
    from .base import MXNetError
    from .context import Context, resolve
    dev_type = int(dev_type)
    if dev_type == 4:
        raise MXNetError("dev_type 4 is the JAX package's tpu; the PyTorch "
                         "port has no TPU (use 2, gpu)")
    if dev_type not in Context.devtype2str:
        raise MXNetError("unknown dev_type %d (1 cpu, 2 gpu, 3 cpu_pinned)"
                         % dev_type)
    ctx = Context(Context.devtype2str[dev_type], int(dev_id))
    resolve(ctx)
    return ctx


def _json_kwargs(text):
    import json
    return {k: _coerce_json_value(v)
            for k, v in (json.loads(text) if text else {}).items()}


def _shapes(shapes_json):
    import json
    return {k: tuple(v) for k, v in json.loads(shapes_json).items()}


def _host_f32(buf, shape):
    """A writable float32 host copy of a caller's buffer."""
    return _np.array(_np.frombuffer(buf, dtype=_np.float32).reshape(shape))


def ndarray_create(shape):
    from .ndarray import zeros
    return zeros(tuple(int(d) for d in shape), ctx=capi_context())


def ndarray_shape(nd):
    return tuple(int(d) for d in nd.shape)


def ndarray_copy_from(nd, buf):
    nd._set_data(torch.from_numpy(_host_f32(buf, nd.shape)))
    return 0


def ndarray_copy_to(nd, buf):
    out = _np.frombuffer(buf, dtype=_np.float32)
    nd.wait_to_read()
    arr = nd.asnumpy().astype(_np.float32).ravel()
    if out.size != arr.size:
        raise ValueError("buffer size %d != ndarray size %d"
                         % (out.size, arr.size))
    out[:] = arr
    return 0


def ndarray_waitall():
    from .ndarray import waitall
    waitall()
    return 0


def symbol_from_json(text):
    from . import symbol as sym_mod
    return sym_mod.load_json(text)


def symbol_arguments(sym):
    return list(sym.list_arguments())


def executor_bind(sym, shapes_json):
    return sym.simple_bind(capi_context(), grad_req="null",
                           **_shapes(shapes_json))


def executor_set_arg(exec_, name, buf):
    ndarray_copy_from(exec_.arg_dict[name], buf)
    return 0


def executor_forward(exec_, is_train):
    exec_.forward(is_train=bool(is_train))
    # the handles MXExecutorOutputs gave out follow every forward
    for nd, out in zip(getattr(exec_, "_capi_outputs", ()), exec_.outputs):
        nd._data = out.data
    return len(exec_.outputs)


def executor_output_shape(exec_, index):
    return tuple(int(d) for d in exec_.outputs[index].shape)


def executor_output_to(exec_, index, buf):
    return ndarray_copy_to(exec_.outputs[index], buf)


def pred_create(symbol_json, param_path, shapes_json):
    from .predictor import Predictor
    # Predictor takes JSON text or a path ending in .json
    return Predictor(symbol_json, param_path, _shapes(shapes_json),
                     ctx=capi_context())


def pred_set_input(pred, name, buf):
    shape = pred._exec.arg_dict[name].shape
    pred.set_input(name, _host_f32(buf, shape))
    return 0


def pred_forward(pred):
    # the Get* calls copy the outputs
    pred._exec.forward(is_train=False)
    return 0


def pred_output_shape(pred, index):
    return tuple(int(d) for d in pred._exec.outputs[index].shape)


def pred_output_to(pred, index, buf):
    return ndarray_copy_to(pred._exec.outputs[index], buf)


def kvstore_create(kvtype):
    from . import kvstore
    with capi_context():
        return kvstore.create(kvtype)


def kvstore_init(kv, key, nd):
    kv.init(int(key), nd)
    return 0


def kvstore_push(kv, key, nd):
    kv.push(int(key), nd)
    return 0


def kvstore_pull(kv, key, nd):
    kv.pull(int(key), nd)
    return 0


# ----------------------------------------------------------------------
# function-registry listing (c_api.cc:366-445 parity)
# ----------------------------------------------------------------------
def registry_list_ops():
    from .ops.registry import OP_REGISTRY
    seen = set()
    names = []
    for name, cls in OP_REGISTRY._entries.values():
        if cls in seen:
            continue
        seen.add(cls)
        names.append(name)
    return names


def registry_op_info(name):
    """(name, description, [arg names], [arg type descs], [arg docs])."""
    from .ops.registry import OP_REGISTRY
    disp, cls = OP_REGISTRY._entries[name.lower()]
    desc = (cls.__doc__ or "").strip()
    args, types, docs = [], [], []
    pc = getattr(cls, "param_cls", None)
    if pc is not None:
        for fname, field in pc._fields.items():
            args.append(fname)
            t = getattr(field.typ, "__name__", str(field.typ))
            types.append("%s, %s" % (t, "required" if field.required
                                     else "optional"))
            docs.append(field.doc or "")
    return (disp, desc, args, types, docs)


# ----------------------------------------------------------------------
# symbol compose / attrs through C (c_api.cc:447-937 parity)
# ----------------------------------------------------------------------
def symbol_create_variable(name):
    from . import symbol as sym_mod
    return sym_mod.Variable(name)


def _coerce_json_value(v):
    return tuple(v) if isinstance(v, list) else v


def symbol_create_atomic(op_name, kwargs_json, name):
    """An un-composed atomic symbol: a staging record that
    :func:`symbol_compose` turns into a Symbol (CreateAtomicSymbol holds
    op and params until Compose wires the inputs)."""
    return ["atomic", op_name, _json_kwargs(kwargs_json), name or None]


def symbol_compose(staged, keys, args):
    """Wire inputs into a staged atomic symbol; ``keys`` empty is
    positional composition, else keyword."""
    from . import symbol as sym_mod
    kind, op_name, kwargs, name = staged
    if kind != "atomic":
        raise ValueError("compose target is not an atomic symbol")
    creator = getattr(sym_mod, op_name)
    kw = dict(kwargs)
    if name:
        kw["name"] = name
    if keys:
        kw.update(zip(keys, args))
        return creator(**kw)
    return creator(*args, **kw)


def symbol_get_attr(sym, key):
    return sym.attr(key)


def symbol_set_attr(sym, key, value):
    sym._set_attr(**{key: value})
    return 0


def symbol_outputs(sym):
    return list(sym.list_outputs())


def symbol_tojson(sym):
    return sym.tojson()


def symbol_infer_shape_json(sym, in_json):
    import json
    arg, out, aux = sym.infer_shape(**_shapes(in_json))

    def _ser(lst):
        return None if lst is None else [list(s) for s in lst]

    return json.dumps({"arg_shapes": _ser(arg), "out_shapes": _ser(out),
                       "aux_shapes": _ser(aux)})


# ----------------------------------------------------------------------
# data iterators through C (c_api.cc:1101-1197 parity)
# ----------------------------------------------------------------------
_CAPI_ITERS = ("MNISTIter", "ImageRecordIter", "CSVIter")


def dataiter_list():
    return list(_CAPI_ITERS)


def dataiter_create(name, kwargs_json):
    from . import io
    if name not in _CAPI_ITERS:
        raise ValueError("unknown data iterator %r (have %s)"
                         % (name, ", ".join(_CAPI_ITERS)))
    return getattr(io, name)(**_json_kwargs(kwargs_json))


def dataiter_next(it):
    try:
        it._capi_batch = next(it)
    except StopIteration:
        it._capi_batch = None
        it._capi_range = []
        return 0
    # positions of the batch's real records (a final partial batch's
    # pad rows have none), for iterators that keep no index
    n = int(it._capi_batch.data[0].shape[0])
    n -= int(it._capi_batch.pad or 0)
    start = getattr(it, "_capi_pos", 0)
    it._capi_range = list(range(start, start + n))
    it._capi_pos = start + n
    return 1


def dataiter_before_first(it):
    it.reset()
    it._capi_pos = 0
    it._capi_batch = None
    it._capi_range = []
    return 0


def dataiter_get_data(it):
    return it._capi_batch.data[0]


def dataiter_get_label(it):
    return it._capi_batch.label[0]


def dataiter_get_pad(it):
    return int(it._capi_batch.pad or 0)


# ----------------------------------------------------------------------
# RecordIO through C (c_api.cc:1377-1454 parity)
# ----------------------------------------------------------------------
def recordio_writer_create(uri):
    from . import recordio as rio
    return rio.MXRecordIO(uri, "w")


def recordio_writer_write(w, buf):
    w.write(bytes(buf))
    return 0


def recordio_writer_tell(w):
    return int(w.tell())


def recordio_writer_free(w):
    w.close()
    return 0


def recordio_reader_create(uri):
    from . import recordio as rio
    return rio.MXRecordIO(uri, "r")


def recordio_reader_read(r):
    """The record's bytes, kept on the reader until the next read or
    close so the C pointer stays valid; None at the end."""
    data = r.read()
    r._capi_last = data
    return data


def recordio_reader_seek(r, pos):
    r._seek_to(int(pos))
    return 0


def recordio_reader_free(r):
    r._capi_last = None
    r.close()
    return 0


# ----------------------------------------------------------------------
# optimizer create/update through C (c_api.cc:1525-1556 parity)
# ----------------------------------------------------------------------
def optimizer_create(name, kwargs_json):
    from . import optimizer
    opt = optimizer.create(name, **_json_kwargs(kwargs_json))
    opt._capi_states = {}
    return opt


def optimizer_update(opt, index, weight, grad, lr, wd):
    """MXOptimizerUpdate(handle, index, weight, grad, lr, wd): a
    non-negative ``lr``/``wd`` overrides the optimizer's for this call."""
    index = int(index)
    old_lr, old_wd = opt.lr, opt.wd
    try:
        if lr >= 0:
            opt.lr = float(lr)
        if wd >= 0:
            opt.wd = float(wd)
        if index not in opt._capi_states:
            opt._capi_states[index] = opt.create_state(index, weight)
        opt.update(index, weight, grad, opt._capi_states[index])
    finally:
        opt.lr, opt.wd = old_lr, old_wd
    return 0


# ----------------------------------------------------------------------
# NDArray extras (save/load/slice/reshape/dtype through C)
# ----------------------------------------------------------------------
def ndarray_save(fname, nds, names):
    from .ndarray import save
    if names:
        # (name, array) pairs keep the order and any duplicates
        save(fname, list(zip(names, nds)))
    else:
        save(fname, list(nds))
    return 0


def ndarray_load(fname):
    """-> (names (may be empty), arrays) in the file's order, duplicates
    kept; the arrays land on :func:`capi_context`."""
    from .ndarray import load_raw
    with capi_context():
        names, arrays = load_raw(fname)
    return list(names), list(arrays)


def ndarray_dtype(nd):
    from .base import dtype_torch_to_mx
    return int(dtype_torch_to_mx(nd.dtype))


def ndarray_slice(nd, begin, end):
    return nd[int(begin):int(end)]


def ndarray_reshape(nd, shape):
    return nd.reshape(tuple(int(d) for d in shape))


# ----------------------------------------------------------------------
# executor training surface (backward + bound-array handles through C)
# ----------------------------------------------------------------------
def executor_bind_train(sym, shapes_json):
    return sym.simple_bind(capi_context(), grad_req="write",
                           **_shapes(shapes_json))


def executor_backward(exec_):
    exec_.backward()
    return 0


def executor_arg_handle(exec_, name):
    return exec_.arg_dict[name]


def executor_grad_handle(exec_, name):
    g = exec_.grad_dict.get(name)
    if g is None:
        raise KeyError("no gradient bound for %r" % name)
    return g


def executor_arg_names(exec_):
    return list(exec_._arg_names)


# ----------------------------------------------------------------------
# kvstore cluster queries
# ----------------------------------------------------------------------
def kvstore_rank(kv):
    return int(kv.rank)


def kvstore_num_workers(kv):
    return int(kv.num_workers)


def kvstore_type(kv):
    return str(kv.type)


def kvstore_barrier(kv):
    kv.barrier()
    return 0


# ----------------------------------------------------------------------
# misc (random seed, version, symbol aux/name)
# ----------------------------------------------------------------------
def random_seed(seed):
    from . import random
    random.seed(int(seed))
    return 0


def get_version():
    from . import __version__
    return str(__version__)


def symbol_aux_states(sym):
    return list(sym.list_auxiliary_states())


def symbol_name(sym):
    return str(getattr(sym, "name", "") or "")


def func_invoke(name, kwargs_json, nd_args):
    """MXFuncInvoke: run op ``name`` eagerly on NDArray inputs and return
    the output list (on the inputs' device)."""
    from .ndarray import NDArray
    from .ops.registry import create_operator
    op = create_operator(name, **_json_kwargs(kwargs_json))
    if op.list_auxiliary_states():
        raise ValueError("func_invoke: %r needs aux state; bind it in a "
                         "graph instead" % name)
    rng = None
    if getattr(op, "need_rng", False):
        from . import random as _random
        device = nd_args[0].data.device if nd_args else "cpu"
        rng = _random.generator(device)
    with torch.no_grad():
        outs, _aux = op.forward([nd.data for nd in nd_args], [], False, rng)
    return [NDArray(o) for o in outs]


def executor_print(exec_):
    """The execution plan (MXExecutorPrint / GraphExecutor::Print)."""
    return exec_.debug_str()


def symbol_attr_json(sym):
    """Every node's attributes as JSON (MXSymbolListAttr)."""
    import json
    return json.dumps(sym.attr_dict())


# ----------------------------------------------------------------------
# NDArray extras: the rest of the reference's creation, sync and
# raw-bytes surface (c_api.cc:116-363)
# ----------------------------------------------------------------------
def ndarray_create_none():
    """MXNDArrayCreateNone: a placeholder array, a scalar zero until
    written."""
    from .ndarray import zeros
    return zeros((), ctx=capi_context())


def ndarray_create_ex(shape, dev_type, dev_id, delay_alloc, dtype_flag):
    """MXNDArrayCreateEx; ``delay_alloc`` is accepted and ignored (the
    caching allocator owns the memory)."""
    from .base import dtype_mx_to_torch
    from .ndarray import zeros
    return zeros(tuple(int(d) for d in shape),
                 ctx=_dev_context(dev_type, dev_id),
                 dtype=dtype_mx_to_torch(int(dtype_flag)))


def ndarray_at(nd, idx):
    return nd.at(int(idx))


def ndarray_context(nd):
    ctx = nd.context
    return (int(ctx.device_typeid), int(ctx.device_id))


#: id(NDArray) -> its host snapshot; each entry leaves with its array
_CAPI_DATA = {}


def ndarray_data_addr(nd):
    """MXNDArrayGetData: the address of a synced host float32 snapshot
    of the array, on every device (the header promises host memory; a
    device pointer is never returned).  It lives as long as the handle
    and is valid until the next GetData on it."""
    import weakref
    nd.wait_to_read()
    host = _np.ascontiguousarray(nd.asnumpy().astype(_np.float32))
    key = id(nd)
    if key not in _CAPI_DATA:
        weakref.finalize(nd, _CAPI_DATA.pop, key, None)
    _CAPI_DATA[key] = host
    return int(host.ctypes.data)


def ndarray_wait_read(nd):
    nd.wait_to_read()
    return 0


def ndarray_wait_write(nd):
    nd.wait_to_write()
    return 0


def ndarray_save_raw(nd):
    """MXNDArraySaveRawBytes: one array in the reference's per-array
    layout (shape, context, type flag, data; ndarray.cc:637-687)."""
    import io as _io
    from .ndarray import _save_one
    bio = _io.BytesIO()
    _save_one(bio, nd)
    return bio.getvalue()


def ndarray_load_raw(buf):
    import io as _io
    from .context import resolve
    from .ndarray import _load_one
    ctx = capi_context()
    return _load_one(_io.BytesIO(bytes(buf)), ctx, resolve(ctx))


#: where MXNotifyShutdown writes this process's kernel launch counts
COUNTS_ENV = "MXTPU_CAPI_COUNTS"


def launch_counts():
    """This process's launches of the port's hand kernels, by the
    wrappers' own counters (each adds one where it launches)."""
    from . import rtc
    from .kernels import flash_attention, flash_decode, fused_opt, quantize
    return {"flash_decode": flash_decode.flash_decode_attention.launches,
            "quantized_matmul": quantize.quantized_matmul.launches,
            "flash_attention": flash_attention.flash_attention_forward.launches,
            "fused_opt": fused_opt.sweep.launches,
            "rtc": rtc.launches}


def notify_shutdown():
    """MXNotifyShutdown: drain the devices and the native engines, and
    leave a dist kvstore's process group (stopping its heartbeat).  A C
    host never finalizes the interpreter, so Python's ``atexit``
    handlers, which do this at a Python process's exit, do not run
    there.  With ``MXTPU_CAPI_COUNTS`` set, the process's kernel launch
    counts (:func:`launch_counts`) are written there as JSON, so a
    caller can see which kernels a C program ran."""
    import json
    from . import engine, kvstore
    from .ndarray import waitall
    waitall()
    engine._close_live_engines()
    kvstore._leave_group()
    path = os.environ.get(COUNTS_ENV)
    if path:
        with open(path, "w") as f:
            json.dump(launch_counts(), f)
    return 0


# ----------------------------------------------------------------------
# Symbol: copy/group/file/internals/listing/print (c_api.cc:447-937)
# ----------------------------------------------------------------------
def symbol_copy(sym):
    return symbol_from_json(sym.tojson())


def symbol_group(syms):
    from . import symbol as sym_mod
    return sym_mod.Group(list(syms))


def symbol_from_file(fname):
    from . import symbol as sym_mod
    return sym_mod.load(fname)


def symbol_save_file(sym, fname):
    sym.save(fname)
    return 0


def symbol_get_internals(sym):
    return sym.get_internals()


def symbol_attr_pairs(sym, deep):
    """Flat ``[k0, v0, k1, v1, ...]`` attribute listing.  Deep walks
    every node with ``<node>_<key>`` keys (the reference's namespace
    separator is '_', symbol.cc:19,526) and repeats each node's attrs on
    its auxiliary-state names (symbol.cc:532-538); shallow lists the
    head node only (MXSymbolListAttrShallow)."""
    pairs = []
    if deep:
        flat = {}
        for node in sym._topo():
            if not node.attrs:
                continue
            for k, v in node.attrs.items():
                flat["%s_%s" % (node.name, k)] = str(v)
            if node.op is not None:
                for aux in node.op.list_auxiliary_states():
                    for k, v in node.attrs.items():
                        flat["%s_%s_%s" % (node.name, aux, k)] = str(v)
        for k in sorted(flat):
            pairs.extend([k, flat[k]])
    else:
        for k, v in sorted(sym.list_attr().items()):
            pairs.extend([k, str(v)])
    return pairs


def symbol_print(sym):
    return sym.debug_str()


def symbol_grad(sym, wrt):
    return sym.grad(list(wrt))


def symbol_infer_shape_arrays(sym, keys, shapes, partial):
    """MXSymbolInferShape (CSR in, three shape lists out); ``keys`` empty
    is positional by argument order, and a 0-dim entry means unknown.
    -> (arg_shapes, out_shapes, aux_shapes, complete)"""
    args = sym.list_arguments()
    if keys:
        known = {k: tuple(s) for k, s in zip(keys, shapes) if len(s)}
    else:
        known = {a: tuple(s) for a, s in zip(args, shapes) if len(s)}
    fn = sym.infer_shape_partial if partial else sym.infer_shape
    arg, out, aux = fn(**known)
    complete = (arg is not None and out is not None
                and all(s is not None for s in (arg + out + (aux or []))))

    def _ser(lst, n):
        if lst is None:
            return [()] * n
        return [tuple(s) if s is not None else () for s in lst]

    return (_ser(arg, len(args)), _ser(out, len(sym.list_outputs())),
            _ser(aux, len(sym.list_auxiliary_states())), int(complete))


def symbol_infer_type_arrays(sym, keys, type_flags):
    """MXSymbolInferType: int dtype flags in and out (-1 unknown)."""
    from .base import dtype_mx_to_torch, dtype_torch_to_mx
    args = sym.list_arguments()
    names = list(keys) if keys else args[:len(type_flags)]
    known = {n: dtype_mx_to_torch(int(t))
             for n, t in zip(names, type_flags) if int(t) != -1}
    arg, out, aux = sym.infer_type(**known)

    def _flags(lst):
        return [(-1 if t is None else int(dtype_torch_to_mx(t)))
                for t in (lst or [])]

    complete = all(t is not None
                   for t in (arg or []) + (out or []) + (aux or []))
    return (_flags(arg), _flags(out), _flags(aux), int(complete))


# ----------------------------------------------------------------------
# function registry extras (describe + invoke-ex + atomic symbol info)
# ----------------------------------------------------------------------
def registry_op_describe(name):
    """MXFuncDescribe -> (num_use_vars, num_scalars, num_mutate_vars,
    type_mask).  An op with a ``scalar`` param takes one scalar arg (the
    reference's scalar-op convention); outputs are fresh
    (kAcceptEmptyMutateTarget | kNDArrayArgBeforeScalar)."""
    from .ops.registry import OP_REGISTRY
    cls = OP_REGISTRY.get(name)
    pc = getattr(cls, "param_cls", None)
    n_scalar = 1 if (pc is not None and "scalar" in pc._fields) else 0
    try:
        op = cls(**({"scalar": 0.0} if n_scalar else {}))
        n_in = len(op.list_arguments())
        n_out = len(op.list_outputs())
    except Exception:
        n_in, n_out = 1, 1      # required params: signature unknowable
    return (n_in, n_scalar, n_out, 1 | 4)


def func_invoke_into(name, param_keys, param_vals, use_vars, scalars,
                     mutate_vars):
    """MXFuncInvokeEx: run op ``name`` on ``use_vars`` and write the
    results into ``mutate_vars``.  ``param_keys``/``param_vals`` are the
    reference's string arrays; a scalar arg fills the op's ``scalar``
    param when it has one and the params did not set it."""
    import json
    kwargs = dict(zip([str(k) for k in param_keys],
                      [str(v) for v in param_vals]))
    if scalars:
        from .ops.registry import OP_REGISTRY
        pc = getattr(OP_REGISTRY.get(name), "param_cls", None)
        if pc is not None and "scalar" in pc._fields and "scalar" not in kwargs:
            kwargs["scalar"] = float(scalars[0])
    outs = func_invoke(name, json.dumps(kwargs), list(use_vars))
    if len(outs) != len(mutate_vars):
        raise ValueError("op %r produced %d outputs for %d mutate vars"
                         % (name, len(outs), len(mutate_vars)))
    for dst, src in zip(mutate_vars, outs):
        if dst.shape != src.shape:
            # an empty mutate target (MXNDArrayCreateNone's placeholder,
            # kAcceptEmptyMutateTarget) takes the result's storage
            dst._data, dst._ctx = src.data, src.context
        else:
            dst._set_data(src.data)
    return 0


def registry_symbol_op_info(name):
    """MXSymbolGetAtomicSymbolInfo: :func:`registry_op_info` and the
    key_var_num_args marker (ops with a variable input list declare a
    ``num_args`` param: Concat, ElementWiseSum)."""
    from .ops.registry import OP_REGISTRY
    disp, desc, args, types, docs = registry_op_info(name)
    pc = getattr(OP_REGISTRY.get(name), "param_cls", None)
    key_var = "num_args" if (pc is not None and "num_args" in pc._fields) else ""
    return (disp, desc, args, types, docs, key_var)


# ----------------------------------------------------------------------
# executor: Bind with caller arrays + outputs + monitor callback
# (c_api.cc:939-1099)
# ----------------------------------------------------------------------
# code 2 (kWriteInplace) binds as write: in-place sharing is a memory
# optimization of the reference's
_GRAD_REQ = {0: "null", 1: "write", 2: "write", 3: "add"}


def executor_bind_full(sym, dev_type, dev_id, in_args, arg_grads, grad_reqs,
                       aux_states, map_keys, map_dev_types, map_dev_ids,
                       shared_exec):
    """MXExecutorBind/BindX/BindEX: bind with the caller's NDArray
    handles and per-argument grad_req codes.  A group2ctx map raises
    (placement by groups is not ported); ``shared_exec``, the
    reference's memory sharing, changes no result and is ignored."""
    from .base import MXNetError
    if map_keys:
        raise MXNetError("MXExecutorBindX: group2ctx placement is not "
                         "ported (ROADMAP.md queue 1 item 3)")
    reqs = [_GRAD_REQ[int(r)] for r in grad_reqs]
    grads = list(arg_grads) if arg_grads else None
    return sym.bind(_dev_context(dev_type, dev_id), list(in_args),
                    args_grad=grads, grad_req=reqs,
                    aux_states=list(aux_states) if aux_states else None)


def executor_outputs(exec_):
    """MXExecutorOutputs: handles that stay the executor's outputs
    across later forwards (each forward rebinds their tensors)."""
    if getattr(exec_, "_capi_outputs", None) is None:
        from .ndarray import NDArray, zeros
        if exec_.outputs and exec_.outputs[0] is not None:
            exec_._capi_outputs = [NDArray(o.data) for o in exec_.outputs]
        else:
            _, shapes, _ = exec_._symbol.infer_shape(
                **{n: a.shape for n, a in exec_.arg_dict.items()})
            exec_._capi_outputs = [zeros(s, ctx=exec_._ctx) for s in shapes]
    return list(exec_._capi_outputs)


def executor_set_monitor_c(exec_, fn_addr, user_addr):
    """MXExecutorSetMonitorCallback: a C function pointer receives
    (name, NDArrayHandle, user) for each op output; the handle is
    borrowed for the call (graph_executor.cc:937-951)."""
    import ctypes
    cb_type = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_void_p)
    cb = cb_type(fn_addr)
    user = ctypes.c_void_p(user_addr or 0)

    def _monitor(name, nd):
        cb(str(name).encode(), ctypes.c_void_p(id(nd)), user)

    _monitor._capi_refs = (cb, user)
    exec_.set_monitor_callback(_monitor)
    return 0


# ----------------------------------------------------------------------
# kvstore: roles, fault queries, server loop (c_api.cc:1199-1375)
# ----------------------------------------------------------------------
def init_ps_env(keys, vals):
    """MXInitPSEnv: put the launcher's DMLC_*/PS_* variables into the
    environment before a kvstore is created."""
    for k, v in zip(keys, vals):
        os.environ[str(k)] = str(v)
    return 0


def _role():
    return os.environ.get("DMLC_ROLE", "worker").lower()


def kvstore_is_worker():
    return int(_role() == "worker")


def kvstore_is_server():
    return int(_role() == "server")


def kvstore_is_scheduler():
    return int(_role() == "scheduler")


def kvstore_num_dead(kv, node_id, timeout_sec):
    # node_id -1 asks about every worker (the C convention)
    node = None if int(node_id) < 0 else int(node_id)
    return int(kv.num_dead_nodes(node_id=node, timeout=int(timeout_sec)))


def kvstore_set_barrier_before_exit(kv, flag):
    kv._barrier_before_exit = bool(flag)
    return 0


def kvstore_send_command(kv, head, body):
    """MXKVStoreSendCommmandToServers: commands queue on the handle; a
    same-process RunServer drains them (the one-process counterpart of
    the worker-to-server command RPC, kvstore_dist_server.h:28-85)."""
    queue = getattr(kv, "_capi_commands", None)
    if queue is None:
        queue = kv._capi_commands = []
    queue.append((int(head), str(body)))
    kv._send_command_to_servers(int(head), str(body))
    return 0


def kvstore_run_server_c(kv, fn_addr, user_addr):
    """MXKVStoreRunServer: the C controller receives each queued command
    (head, body, user); head 0 (kStopServer) ends the loop, which also
    ends when the queue is empty."""
    import ctypes
    ctrl_type = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_void_p)
    ctrl = ctrl_type(fn_addr)
    user = ctypes.c_void_p(user_addr or 0)
    queue = getattr(kv, "_capi_commands", None) or []
    while queue:
        head, body = queue.pop(0)
        if head == 0:           # kStopServer
            break
        ctrl(int(head), str(body).encode(), user)
    return 0


# ----------------------------------------------------------------------
# data iter index + optimizer creator lookup
# ----------------------------------------------------------------------
def dataiter_get_index(it):
    batch = it._capi_batch
    idx = getattr(batch, "index", None)
    if idx is None:
        # sequential iterators (CSV, MNIST): the record's position
        idx = getattr(it, "_capi_range", [])
    return [int(i) for i in idx]


def optimizer_find_creator(name):
    """MXOptimizerFindCreator: the registered optimizer's canonical name,
    which the create call takes, as the handle."""
    from .optimizer import Optimizer
    key = str(name).lower()
    if key not in Optimizer.opt_registry:
        raise ValueError("optimizer %r is not registered (have %s)"
                         % (name, sorted(Optimizer.opt_registry)))
    return key


# ----------------------------------------------------------------------
# the rest of the predict ABI (c_predict_api.cc: partial-out predictors
# and the NDList reader)
# ----------------------------------------------------------------------
def pred_create_partial(symbol_json, param_path, shapes_json, output_keys):
    """MXPredCreatePartialOut: predict up to the named internal outputs
    (each key a node name or its ``<name>_output`` form)."""
    from . import symbol as sym_mod
    from .predictor import Predictor
    if symbol_json.endswith(".json"):
        base = sym_mod.load(symbol_json)
    else:
        base = sym_mod.load_json(symbol_json)
    internals = base.get_internals()
    names = list(internals.list_outputs())
    picked = []
    for key in output_keys:
        if key in names:
            picked.append(internals[names.index(key)])
        elif key + "_output" in names:
            picked.append(internals[names.index(key + "_output")])
        else:
            raise ValueError("output %r not found among internals (e.g. %s)"
                             % (key, names[:8]))
    sub = sym_mod.Group(picked) if len(picked) > 1 else picked[0]
    return Predictor(sub.tojson(), param_path, _shapes(shapes_json),
                     ctx=capi_context())


def pred_partial_forward(pred, step):
    """MXPredPartialForward: step 0 runs the whole graph and reports no
    steps left, as the JAX package does; the caller's ``while
    (step_left)`` loop ends."""
    if int(step) == 0:
        pred_forward(pred)
    return 0     # steps left


def ndlist_create(buf):
    """MXNDListCreate: parse a named-array file's bytes.  Items keep the
    file's order; an unnamed file's keys are empty strings.  Each item
    keeps (key, float32 host array, uint32 shape) on the handle, so the
    pointers MXNDListGet hands out live until MXNDListFree."""
    from .context import cpu
    from .predictor import load_ndarray_file
    with cpu():
        raw = load_ndarray_file(bytes(buf))
    pairs = raw.items() if isinstance(raw, dict) else \
        (("", v) for v in raw)
    items = []
    for key, val in pairs:
        arr = _np.ascontiguousarray(val.asnumpy().astype(_np.float32))
        shape = _np.asarray(arr.shape, dtype=_np.uint32)
        items.append((str(key), arr, shape))
    return items


def ndlist_get(items, index):
    """-> (key, data address, shape address, ndim) for MXNDListGet,
    pointing into the handle's own arrays."""
    key, arr, shape = items[int(index)]
    return (key, int(arr.ctypes.data), int(shape.ctypes.data),
            int(shape.size))


# ----------------------------------------------------------------------
# MXCustomOpRegister: the reference's C custom-op protocol
# (CustomOpPropCreator / CustomOpPropInfo / CustomOpInfo in c_api.h,
# consumed by src/operator/custom-inl.h:62-210).  A C creator fills a
# struct of callbacks; the op runs as a graph op whose compute calls the
# C callbacks with NDArray handles and tags as custom.cc:47-135 passes
# them (in_data 0, out_data 1, in_grad 2, out_grad 3, aux 4).
# ----------------------------------------------------------------------
def _custom_ctypes():
    import ctypes as ct

    class CustomOpInfo(ct.Structure):
        _compute_t = ct.CFUNCTYPE(ct.c_bool, ct.c_int,
                                  ct.POINTER(ct.c_void_p),
                                  ct.POINTER(ct.c_int),
                                  ct.POINTER(ct.c_int), ct.c_bool,
                                  ct.c_void_p)
        _del_t = ct.CFUNCTYPE(ct.c_bool, ct.c_void_p)
        _fields_ = [
            ("forward", _compute_t),
            ("backward", _compute_t),
            ("del_", _del_t),
            ("p_forward", ct.c_void_p),
            ("p_backward", ct.c_void_p),
            ("p_del", ct.c_void_p),
        ]

    class CustomOpPropInfo(ct.Structure):
        _strlist_t = ct.CFUNCTYPE(ct.c_bool,
                                  ct.POINTER(ct.POINTER(ct.c_char_p)),
                                  ct.c_void_p)
        _ishape_t = ct.CFUNCTYPE(ct.c_bool, ct.c_int, ct.POINTER(ct.c_int),
                                 ct.POINTER(ct.POINTER(ct.c_uint)),
                                 ct.c_void_p)
        _bwddep_t = ct.CFUNCTYPE(ct.c_bool, ct.POINTER(ct.c_int),
                                 ct.POINTER(ct.c_int), ct.POINTER(ct.c_int),
                                 ct.POINTER(ct.c_int),
                                 ct.POINTER(ct.POINTER(ct.c_int)),
                                 ct.c_void_p)
        _createop_t = ct.CFUNCTYPE(ct.c_bool, ct.c_char_p, ct.c_int,
                                   ct.POINTER(ct.POINTER(ct.c_uint)),
                                   ct.POINTER(ct.c_int),
                                   ct.POINTER(ct.c_int),
                                   ct.POINTER(CustomOpInfo), ct.c_void_p)
        _del_t = ct.CFUNCTYPE(ct.c_bool, ct.c_void_p)
        _fields_ = [
            ("list_arguments", _strlist_t),
            ("list_outputs", _strlist_t),
            ("infer_shape", _ishape_t),
            ("declare_backward_dependency", _bwddep_t),
            ("create_operator", _createop_t),
            ("list_auxiliary_states", _strlist_t),
            ("del_", _del_t),
            ("p_list_arguments", ct.c_void_p),
            ("p_list_outputs", ct.c_void_p),
            ("p_infer_shape", ct.c_void_p),
            ("p_declare_backward_dependency", ct.c_void_p),
            ("p_create_operator", ct.c_void_p),
            ("p_list_auxiliary_states", ct.c_void_p),
            ("p_del", ct.c_void_p),
        ]

    creator_t = ct.CFUNCTYPE(ct.c_bool, ct.c_char_p, ct.c_int,
                             ct.POINTER(ct.c_char_p),
                             ct.POINTER(ct.c_char_p),
                             ct.POINTER(CustomOpPropInfo))
    return ct, CustomOpInfo, CustomOpPropInfo, creator_t


_REQ_CODE = {"null": 0, "write": 1, "inplace": 2, "add": 3}


def _type_flag(t):
    from .base import dtype_torch_to_mx
    from .ndarray import _torch_dtype
    return int(dtype_torch_to_mx(_torch_dtype(t)))


def custom_op_register_c(op_type, creator_addr):
    """Register a custom op written in C under ``op_type``, for
    ``mx.sym.Custom(op_type=...)`` and the C symbol ABI."""
    ct, CustomOpInfo, CustomOpPropInfo, creator_t = _custom_ctypes()
    from . import operator as op_mod
    from .base import MXNetError
    from .ndarray import NDArray
    creator = creator_t(creator_addr)
    op_type = str(op_type)

    def _strlist(fn, payload):
        out = ct.POINTER(ct.c_char_p)()
        if not fn(ct.byref(out), payload):
            raise MXNetError("custom op %r: string-list callback failed"
                             % op_type)
        res = []
        i = 0
        while out[i]:
            res.append(out[i].decode())
            i += 1
        return res

    class _CCustomOp(op_mod.CustomOp):
        def __init__(self, info):
            self._info = info

        def _dispatch(self, fn, payload, groups, reqs, train):
            """groups: (host numpy arrays, tag) pairs.  Each array goes
            to the C side as an NDArray handle over a CPU copy, and what
            the callback wrote is copied back (custom.cc's pointer and
            tag protocol)."""
            ptrs, tags, keep = [], [], []
            for arrays, tag in groups:
                for a in arrays:
                    nd = NDArray(torch.from_numpy(_np.array(a)))
                    keep.append((nd, a))
                    ptrs.append(id(nd))
                    tags.append(tag)
            n = len(ptrs)
            c_ptrs = (ct.c_void_p * n)(*ptrs)
            c_tags = (ct.c_int * n)(*tags)
            c_reqs = (ct.c_int * len(reqs))(
                *[_REQ_CODE.get(r, 1) for r in reqs])
            if not fn(n, c_ptrs, c_tags, c_reqs, bool(train), payload):
                raise MXNetError("custom op %r: compute callback failed"
                                 % op_type)
            for nd, a in keep:
                host = nd.asnumpy()
                a_np = _np.asarray(a)
                if host.shape == a_np.shape and a_np.flags.writeable:
                    a_np[...] = host.astype(a_np.dtype)

        def forward(self, is_train, req, in_data, out_data, aux):
            self._dispatch(self._info.forward, self._info.p_forward,
                           [(in_data, 0), (out_data, 1), (aux, 4)],
                           req, is_train)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            # custom.cc:97-135's order: in_data, out_data, in_grad, aux,
            # out_grad (tags 0, 1, 2, 4, 3)
            self._dispatch(self._info.backward, self._info.p_backward,
                           [(in_data, 0), (out_data, 1), (in_grad, 2),
                            (aux, 4), (out_grad, 3)],
                           req, True)

    class _CCustomOpProp(op_mod.CustomOpProp):
        def __init__(self, **kwargs):
            super().__init__(need_top_grad=True)
            keys = sorted(kwargs)
            c_keys = (ct.c_char_p * len(keys))(
                *[k.encode() for k in keys])
            c_vals = (ct.c_char_p * len(keys))(
                *[str(kwargs[k]).encode() for k in keys])
            self._info = CustomOpPropInfo()
            if not creator(op_type.encode(), len(keys), c_keys, c_vals,
                           ct.byref(self._info)):
                raise MXNetError("custom op %r: creator failed" % op_type)

        def list_arguments(self):
            return _strlist(self._info.list_arguments,
                            self._info.p_list_arguments)

        def list_outputs(self):
            return _strlist(self._info.list_outputs,
                            self._info.p_list_outputs)

        def list_auxiliary_states(self):
            return _strlist(self._info.list_auxiliary_states,
                            self._info.p_list_auxiliary_states)

        def infer_shape(self, in_shape):
            n_in = len(self.list_arguments())
            n_out = len(self.list_outputs())
            n_aux = len(self.list_auxiliary_states())
            total = n_in + n_out + n_aux
            ndims = (ct.c_int * total)()
            shapes = (ct.POINTER(ct.c_uint) * total)()
            keep = []
            for i, s in enumerate(in_shape):
                arr = (ct.c_uint * len(s))(*[int(d) for d in s])
                keep.append(arr)
                ndims[i] = len(s)
                shapes[i] = ct.cast(arr, ct.POINTER(ct.c_uint))
            if not self._info.infer_shape(total, ndims, shapes,
                                          self._info.p_infer_shape):
                raise MXNetError("custom op %r: infer_shape failed"
                                 % op_type)

            def _get(i):
                return tuple(int(shapes[i][d]) for d in range(ndims[i]))

            return ([_get(i) for i in range(n_in)],
                    [_get(i) for i in range(n_in, n_in + n_out)],
                    [_get(i) for i in range(n_in + n_out, total)])

        def declare_backward_dependency(self, out_grad, in_data, out_data):
            c_og = (ct.c_int * len(out_grad))(*out_grad)
            c_id = (ct.c_int * len(in_data))(*in_data)
            c_od = (ct.c_int * len(out_data))(*out_data)
            num = ct.c_int(0)
            rdeps = ct.POINTER(ct.c_int)()
            if not self._info.declare_backward_dependency(
                    c_og, c_id, c_od, ct.byref(num), ct.byref(rdeps),
                    self._info.p_declare_backward_dependency):
                raise MXNetError("custom op %r: backward-dependency "
                                 "callback failed" % op_type)
            return [int(rdeps[i]) for i in range(num.value)]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            n = len(in_shapes)
            ndims = (ct.c_int * n)()
            shapes = (ct.POINTER(ct.c_uint) * n)()
            keep = []
            for i, s in enumerate(in_shapes):
                arr = (ct.c_uint * len(s))(*[int(d) for d in s])
                keep.append(arr)
                ndims[i] = len(s)
                shapes[i] = ct.cast(arr, ct.POINTER(ct.c_uint))
            dtypes = (ct.c_int * n)(*[_type_flag(t) for t in in_dtypes])
            op_info = CustomOpInfo()
            if not self._info.create_operator(
                    str(ctx or "cpu").encode(), n, shapes, ndims, dtypes,
                    ct.byref(op_info), self._info.p_create_operator):
                raise MXNetError("custom op %r: create_operator failed"
                                 % op_type)
            op = _CCustomOp(op_info)
            op._keep = keep
            return op

    _CCustomOpProp.__name__ = "CCustomOpProp_%s" % op_type
    _CCustomOpProp._capi_creator = creator   # keep the thunk alive
    op_mod.register(op_type)(_CCustomOpProp)
    return 0


# ----------------------------------------------------------------------
# Rtc through C (MXRtcCreate/Push/Free)
# ----------------------------------------------------------------------
def _python_function(name, source):
    """The function ``name`` of ``source`` when the source is Python that
    defines it at its top level, else None (a CUDA C kernel body)."""
    import ast
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    if not any(isinstance(node, ast.FunctionDef) and node.name == name
               for node in tree.body):
        return None
    ns = {}
    exec(compile(tree, "<mxrtc:%s>" % name, "exec"), ns)
    return ns[name]


def rtc_create(name, input_names, output_names, inputs, outputs, kernel_src):
    """MXRtcCreate.  ``kernel_src`` is one of:

    - Python source defining ``name``, a function of the ``n_in`` input
      tensors returning the outputs: run eagerly, on any device;
    - Python source whose ``name`` takes ``n_in + n_out`` refs, a Pallas
      body, which a CUDA card cannot run: raises;
    - anything else: the body of a CUDA C kernel, as in the reference
      MXNet's MXRtcCreate, whose parameters carry ``input_names`` and
      ``output_names``; NVRTC compiles it for ``sm_90a`` and
      :func:`rtc_push` launches it with the caller's grid and block.

    The example ``outputs`` give the output shapes and dtypes."""
    import inspect
    from .base import MXNetError
    from .rtc import Rtc
    n_in, n_out = len(inputs), len(outputs)
    out_shapes = [tuple(int(d) for d in o.shape) for o in outputs]
    out_dtypes = [o.dtype for o in outputs]
    fn = _python_function(name, kernel_src)
    if fn is None:
        rtc = Rtc(kernel_src, n_outputs=n_out, pallas=True,
                  out_shapes=out_shapes, out_dtypes=out_dtypes,
                  input_names=list(input_names),
                  output_names=list(output_names))
    else:
        arity = len(inspect.signature(fn).parameters)
        if arity == n_in + n_out and n_out:
            raise MXNetError(
                "MXRtcCreate: %r takes %d refs (%d inputs + %d outputs), a "
                "Pallas kernel body, which the port cannot run on a CUDA "
                "card; pass a function of the %d inputs, or the body of a "
                "CUDA C kernel" % (name, arity, n_in, n_out, n_in))
        rtc = Rtc(fn, n_outputs=n_out, pallas=False,
                  out_shapes=out_shapes, out_dtypes=out_dtypes)
    rtc._capi_names = (list(input_names), list(output_names))
    return rtc


def rtc_push(rtc, inputs, outputs, grid_dims, block_dims):
    outs = rtc.push(list(inputs), grid_dims=grid_dims, block_dims=block_dims)
    for dst, src in zip(outputs, outs):
        dst._set_data(src.data)
    return 0


def kvstore_set_c_updater(kv, fn_addr, user_handle_addr):
    """Install a C function pointer as the kvstore updater
    (MXKVStoreSetUpdater): it receives (int key, NDArrayHandle recv,
    NDArrayHandle local, void* user), the handles valid for the call."""
    import ctypes
    cb_type = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p)
    cb = cb_type(fn_addr)
    user = ctypes.c_void_p(user_handle_addr or 0)

    def _updater(key, recv, local):
        # id() of a live object is its address in CPython: the C side
        # gets real NDArrayHandles, borrowed for the call
        cb(int(key), ctypes.c_void_p(id(recv)), ctypes.c_void_p(id(local)),
           user)

    _updater._capi_refs = (cb, user)   # keep the ctypes thunk alive
    kv.set_updater(_updater)
    return 0
