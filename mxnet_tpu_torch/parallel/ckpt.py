"""Host-format checkpoints: one ``.npz`` of a nested dict of arrays.

The port's copy of the host half of ``mxnet_tpu/parallel/ckpt.py``
(``host_save``, ``host_restore``, ``is_host_format``,
``describe_restore_mismatch``) and of the two tree helpers the
hot-state target check uses (``_leaf_specs``, ``_unflatten_like``).
File names and contents are the JAX package's, so a checkpoint written
by either package restores in the other.  Leaves may be numpy arrays or
torch tensors (copied to the host).  The sharded orbax format belongs
to the multi-GPU slice.
"""
from __future__ import annotations

import json as _json
import os as _os

import numpy as _np

__all__ = ["host_save", "host_restore", "is_host_format",
           "describe_restore_mismatch"]

_HOST_MANIFEST = "host_ckpt.json"
_HOST_ARRAYS = "host_ckpt.npz"


def _to_numpy(val):
    """Host numpy view of a leaf (a torch tensor is copied off its
    device)."""
    if hasattr(val, "detach"):
        return val.detach().cpu().numpy()
    return _np.asarray(val)


def _fsync_dir(path):
    try:
        fd = _os.open(path, _os.O_RDONLY)
    except OSError:
        return
    try:
        _os.fsync(fd)
    except OSError:
        pass
    finally:
        _os.close(fd)


def is_coordinator():
    """Rank 0 of the ``torch.distributed`` group when one is initialised,
    else the single process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def _flatten_tree(tree, prefix=""):
    """Nested dict-of-arrays -> {'a/b': numpy array}."""
    flat = {}
    for key, val in tree.items():
        name = "%s%s" % (prefix, key)
        if isinstance(val, dict):
            flat.update(_flatten_tree(val, name + "/"))
        else:
            flat[name] = _to_numpy(val)
    return flat


def _unflatten_like(abstract_tree, flat, prefix=""):
    out = {}
    for key, val in abstract_tree.items():
        name = "%s%s" % (prefix, key)
        if isinstance(val, dict):
            out[key] = _unflatten_like(val, flat, name + "/")
        else:
            out[key] = flat[name]
    return out


def _leaf_specs(tree, prefix=""):
    """{'a/b': (shape, numpy dtype)} for a tree of arrays (anything with
    ``.shape``/``.dtype``; a torch dtype maps through an empty tensor)."""
    out = {}
    for key, val in dict(tree).items():
        name = "%s%s" % (prefix, key)
        if isinstance(val, dict):
            out.update(_leaf_specs(val, name + "/"))
        else:
            dtype = val.dtype
            if not isinstance(dtype, _np.dtype) and hasattr(val, "detach"):
                dtype = _to_numpy(val.detach().new_empty(0)).dtype
            out[name] = (tuple(val.shape), _np.dtype(dtype))
    return out


def is_host_format(path):
    """Was the checkpoint at ``path`` written by :func:`host_save`?"""
    return _os.path.isfile(_os.path.join(str(path), _HOST_MANIFEST))


def host_save(path, tree, step):
    """Write ``tree`` + ``step`` as one host-side ``.npz`` under ``path``
    (the coordinator writes; other ranks return at once)."""
    path = _os.path.abspath(str(path))
    if not is_coordinator():
        return path
    flat = _flatten_tree(dict(tree))
    _os.makedirs(path, exist_ok=True)
    with open(_os.path.join(path, _HOST_ARRAYS), "wb") as fout:
        _np.savez(fout, **flat)
        fout.flush()
        _os.fsync(fout.fileno())
    manifest = {
        "step": int(step),
        "keys": {k: {"shape": list(a.shape), "dtype": a.dtype.str}
                 for k, a in flat.items()},
    }
    with open(_os.path.join(path, _HOST_MANIFEST), "w") as fout:
        _json.dump(manifest, fout, sort_keys=True)
        fout.flush()
        _os.fsync(fout.fileno())
    _fsync_dir(path)
    return path


def host_restore(path, abstract_tree):
    """Restore a :func:`host_save` checkpoint; returns (tree, step)."""
    path = _os.path.abspath(str(path))
    with open(_os.path.join(path, _HOST_MANIFEST)) as fin:
        manifest = _json.load(fin)
    with _np.load(_os.path.join(path, _HOST_ARRAYS)) as npz:
        flat = {k: npz[k] for k in npz.files}
    return (_unflatten_like(dict(abstract_tree), flat),
            int(manifest["step"]))


def _describe(shape, dtype):
    return "shape=%s dtype=%s" % (tuple(shape), _np.dtype(dtype).name)


def describe_restore_mismatch(path, abstract_tree):
    """Leaf-level disagreements between the host checkpoint at ``path``
    and a restore target: ``[(leaf, saved, requested), ...]`` as human
    strings (``shape=... dtype=...`` or ``absent``).  ``[]`` when they
    agree, or when the manifest cannot be read (the restore's own error
    then speaks)."""
    try:
        with open(_os.path.join(str(path), _HOST_MANIFEST)) as fin:
            manifest = _json.load(fin)
        saved = {k: (tuple(v["shape"]), _np.dtype(v["dtype"]))
                 for k, v in manifest["keys"].items()}
    except (OSError, ValueError, KeyError):
        return []
    want = _leaf_specs(abstract_tree)
    saved.pop("step", None)
    want.pop("step", None)
    mismatches = []
    for leaf in sorted(set(saved) | set(want)):
        s, w = saved.get(leaf), want.get(leaf)
        if s is None:
            mismatches.append((leaf, "absent", _describe(*w)))
        elif w is None:
            mismatches.append((leaf, _describe(*s), "absent"))
        elif s != w:
            mismatches.append((leaf, _describe(*s), _describe(*w)))
    return mismatches
