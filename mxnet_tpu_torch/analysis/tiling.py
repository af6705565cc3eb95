"""Hopper launch-budget validation of the port's kernel specs (MXL-K).

The port's counterpart of ``mxnet_tpu/analysis/tiling.py``.  The JAX
package checks every Pallas kernel's ``BlockSpec``s against Mosaic's
tile rules (8/16/32 x 128 tiles, 128 lanes): rules of the TPU that do
not exist on a GPU and are not carried.  What a Hopper kernel can get
wrong before it ever runs is its launch: a block that asks for more
shared memory or registers than an SM has, a TMA box or a 16-byte
vector load off the 16-byte grain, a ``wgmma`` tile the instruction
does not take, a grid over the hardware's extents.  The card refuses
such a launch (or the build, or a TMA descriptor) at run time; this
pass finds it from a *declared* description of each launch, with no
card and no compiler:

- MXL-K001 (error): dynamic plus static shared memory of a block over
  the card's opt-in limit (227 KB on the H100), or over 48 KB for a
  kernel that does not opt in (``"optin": False``), or the blocks a
  ``__launch_bounds__(threads, minBlocks)`` promise puts on one SM over
  its shared memory (228 KB, less 1 KB the CUDA driver keeps for each
  block);
- MXL-K002 (error): a TMA box or a 16-byte vector load whose inner
  extent times the item size is not a multiple of 16 bytes, or a
  ``wgmma`` tile that is not m64, n a multiple of 8 from 8 to 256, and
  k of 32 bytes (k16 in bfloat16, k32 in fp8 or int8);
- MXL-K003 (warning): the grid's tail — a dimension not divisible by
  its tile, so the last blocks compute padding (or a non-positive grid
  extent);
- MXL-K004 (error): more than 1,024 threads a block, a grid's y or z
  over 65,535 (x over 2^31 - 1), registers times threads over the SM's
  65,536 (the budget ``__launch_bounds__`` leaves, or a ``setmaxnreg``
  split), more than 255 registers a thread, or a malformed spec.

The limits come from ``observability.counters.launch_limits``: the
device's own properties on the card, the H100's data-sheet row of
``counters.LIMITS`` off it.  The family is active on the ``"gpu"``
target and silent elsewhere, as the JAX package keeps its Mosaic rules
silent off ``"tpu"``.

Kernels declare their launches through :func:`register_kernel_spec`:
the module that launches a kernel registers a provider returning spec
dicts built from the SAME plan functions its launch uses
(``kernels/flash_decode.py`` ``plan_flash_decode``,
``kernels/quantize.py`` ``plan_quantized_matmul``,
``kernels/flash_attention.py`` ``plan_flash_forward``,
``kernels/fused_opt.py`` ``sweep_route``; ``serving/kvcache.py`` the
paged cache's 16-byte rows).  ``rtc.Rtc.push`` checks its caller's launch
through :func:`block_findings` (knob: ``MXTPU_RTC_LINT``).  A spec dict
describes one launch::

    {"name": "flash_forward_fma<64>",
     "origin": "mxnet_tpu_torch/csrc/flash_attention.cu",
     "entry": r"flash_forward_fmaILi64E",   # regex on ptxas's entry name
     "grid": (64, 1, 1), "block": (128, 1, 1),
     "dynamic_smem": 114688, "static_smem": 0,
     "min_blocks": 2,                  # __launch_bounds__'s, or None
     "optin": True,           # False: no cudaFuncSetAttribute, 48 KB
     "setmaxnreg": [(128, 24), (256, 240)],   # (threads, registers)
     "tiles": [{"name": "q rows", "extent": 1024, "tile": 128}],
     "tma": [{"name": "q", "box": (64, 128, 1), "dtype": "bfloat16"}],
     "vectors": [{"name": "k row", "extent": 64, "dtype": "float32"}],
     "wgmma": [{"name": "s = q k", "m": 64, "n": 128, "k": 16,
                "dtype": "bfloat16"}]}

The register budget of a spec (:func:`register_budget`) is what its
block size and ``min_blocks`` leave each thread: the SM's registers over
the resident threads, in the hardware's grain of 8 a thread, at most
255.  ``chip_smoke.py`` holds each spec's budget and static shared
memory to ``nvcc -Xptxas -v``'s report of the entry function.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as _np

from .core import register_rule

__all__ = ["KERNEL_SPECS", "register_kernel_spec", "unregister_kernel_spec",
           "register_budget", "block_findings", "spec_findings",
           "kernel_spec_issues", "itemsize"]

#: the grain of a TMA box's inner extent and of a vector load, in bytes
GRAIN = 16
#: the k of one ``wgmma`` in bytes of its operand type
WGMMA_K_BYTES = 32

#: element sizes of the types numpy does not name
_ITEMSIZE = {"bfloat16": 2, "fp8": 1, "float8_e4m3fn": 1, "fp8_e4m3": 1}


def itemsize(dtype):
    """Bytes of one element of ``dtype``: a name (``"fp8"``, numpy's, or
    PyTorch's), a numpy dtype or a torch dtype."""
    name = str(dtype or "float32").replace("torch.", "")
    if name in _ITEMSIZE:
        return _ITEMSIZE[name]
    return _np.dtype(dtype).itemsize


# ----------------------------------------------------------------------
# kernel spec registry
# ----------------------------------------------------------------------
KERNEL_SPECS = OrderedDict()    # name -> provider() -> spec dict | [dict]
#: (device, registry version) -> kernel_spec_issues() of the registered
#: specs on that device: they sit at fixed shapes, so every bind on one
#: card reads the same findings
_ISSUES = {}
_VERSION = [0]


def register_kernel_spec(name, provider):
    """Register a kernel's launch description for static validation.

    ``provider`` is a zero-arg callable returning a spec dict (or list
    of them) — lazy so registration at import time stays free — or the
    spec itself.  Re-registering a name overwrites (idempotent module
    re-import)."""
    if not callable(provider):
        spec = provider
        provider = lambda: spec     # noqa: E731
    KERNEL_SPECS[name] = provider
    _VERSION[0] += 1
    return provider


def unregister_kernel_spec(name):
    KERNEL_SPECS.pop(name, None)
    _VERSION[0] += 1


def _ensure_builtin_specs():
    """Import the modules that launch the port's hand kernels so their
    registrations exist even when the caller never touched them."""
    from ..kernels import (flash_attention, flash_decode,  # noqa: F401
                           fused_opt, quantize)
    from ..serving import kvcache  # noqa: F401


def _limits(limits):
    if limits is not None:
        return limits
    from ..observability.counters import launch_limits
    return launch_limits()


def _dims3(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3:
        raise ValueError("%s needs 1 to 3 extents, got %s" % (what, dims))
    return dims + (1,) * (3 - len(dims))


def register_budget(threads, min_blocks=None, limits=None):
    """Registers a thread may hold when ``min_blocks`` blocks of
    ``threads`` threads share one SM: the SM's registers over the
    resident warps' threads, rounded down to the allocation grain of 8,
    at most 255 (a ``__launch_bounds__(threads, min_blocks)`` promise is
    what makes ptxas keep to it)."""
    lim = _limits(limits)
    warps = -(-int(threads) // 32)
    per = lim["regs_per_sm"] // (warps * 32 * max(1, int(min_blocks or 1)))
    return max(0, min(lim["regs_per_thread"], per // 8 * 8))


# ----------------------------------------------------------------------
# launch validation
# ----------------------------------------------------------------------
def block_findings(grid_dims, block_dims, shared_bytes=0, label="launch",
                   min_blocks=None, limits=None):
    """Validate one launch's geometry: ``grid_dims`` blocks of
    ``block_dims`` threads with ``shared_bytes`` of shared memory a
    block.  Returns a list of ``(rule_id, severity, message)``: the
    checks ``Rtc.push`` runs on its caller's launch, and the first of
    :func:`spec_findings`."""
    lim = _limits(limits)
    findings = []
    try:
        grid = _dims3(grid_dims, "grid")
        block = _dims3(block_dims, "block")
    except (TypeError, ValueError) as exc:
        return [("MXL-K004", "error", "%s: malformed launch: %s"
                 % (label, exc))]
    if min(grid) < 1:
        findings.append(("MXL-K003", "warning",
                         "%s: grid %s has a non-positive extent: the launch "
                         "runs no block" % (label, grid)))
    if min(block) < 1:
        findings.append(("MXL-K004", "error",
                         "%s: block %s has a non-positive extent"
                         % (label, block)))
        return findings
    threads = block[0] * block[1] * block[2]
    if threads > lim["threads_per_block"]:
        findings.append(("MXL-K004", "error",
                         "%s: block %s has %d threads, over the card's %d a "
                         "block: the CUDA driver refuses the launch "
                         "(CUDA_ERROR_INVALID_VALUE)"
                         % (label, block, threads, lim["threads_per_block"])))
    if grid[0] > lim["grid_x"] or max(grid[1], grid[2]) > lim["grid_yz"]:
        findings.append(("MXL-K004", "error",
                         "%s: grid %s is over the card's extents (x %d, y and "
                         "z %d)" % (label, grid, lim["grid_x"],
                                    lim["grid_yz"])))
    smem = int(shared_bytes or 0)
    if smem > lim["smem_per_block_optin"]:
        findings.append(("MXL-K001", "error",
                         "%s: %d bytes of shared memory a block, over the "
                         "card's %d (opt-in limit)"
                         % (label, smem, lim["smem_per_block_optin"])))
    elif min_blocks and int(min_blocks) * (
            smem + lim["smem_reserved_per_block"]) > lim["smem_per_sm"]:
        findings.append(("MXL-K001", "error",
                         "%s: __launch_bounds__ promises %d blocks an SM but "
                         "%d of %d bytes of shared memory (each with the "
                         "%d the CUDA driver keeps) do not fit the SM's %d"
                         % (label, int(min_blocks), int(min_blocks), smem,
                            lim["smem_reserved_per_block"],
                            lim["smem_per_sm"])))
    return findings


def _grain_findings(label, what, name, extent, dtype):
    nbytes = int(extent) * itemsize(dtype)
    if nbytes % GRAIN:
        return [("MXL-K002", "error",
                 "%s: %s %r: inner extent %d x %d bytes = %d bytes is not a "
                 "multiple of %d" % (label, what, name, int(extent),
                                     itemsize(dtype), nbytes, GRAIN))]
    return []


def _wgmma_findings(label, t):
    m, n, k = int(t["m"]), int(t["n"]), int(t["k"])
    want_k = WGMMA_K_BYTES // itemsize(t.get("dtype", "bfloat16"))
    problems = []
    if m != 64:
        problems.append("m %d (wgmma takes m64)" % m)
    if n < 8 or n > 256 or n % 8:
        problems.append("n %d (a multiple of 8 from 8 to 256)" % n)
    if k != want_k:
        problems.append("k %d (k%d for %s)" % (k, want_k,
                                               t.get("dtype", "bfloat16")))
    if problems:
        return [("MXL-K002", "error", "%s: wgmma tile %r: %s"
                 % (label, t.get("name", "?"), ", ".join(problems)))]
    return []


def spec_findings(spec, limits=None):
    """Validate one kernel spec dict; ``(rule_id, severity, message)``
    list, each message prefixed with the kernel name."""
    lim = _limits(limits)
    label = "kernel %s" % spec.get("name", "<kernel>")
    if "grid" not in spec and "block" not in spec:
        # a layout the kernels read (the paged cache's rows), no launch
        if not any(spec.get(k) for k in ("tma", "vectors", "wgmma")):
            return [("MXL-K004", "error", "%s: spec declares no launch "
                     "and no layout" % label)]
        return _layout_findings(spec, label)
    if "grid" not in spec or "block" not in spec:
        return [("MXL-K004", "error", "%s: spec has no grid or block"
                 % label)]
    try:
        block = _dims3(spec["block"], "block")
        smem = int(spec.get("dynamic_smem", 0)) + \
            int(spec.get("static_smem", 0))
    except (TypeError, ValueError) as exc:
        return [("MXL-K004", "error", "%s: malformed spec: %s"
                 % (label, exc))]
    findings = block_findings(spec["grid"], block, smem, label,
                              spec.get("min_blocks"), lim)
    if spec.get("optin") is False and smem > lim["smem_per_block"]:
        findings.append(("MXL-K001", "error",
                         "%s: %d bytes of shared memory a block without "
                         "opting in (cudaFuncSetAttribute), over the "
                         "card's %d" % (label, smem, lim["smem_per_block"])))
    threads = block[0] * block[1] * block[2]
    resident = threads * max(1, int(spec.get("min_blocks") or 1))
    regs = spec.get("regs")
    if regs is not None:
        if int(regs) > lim["regs_per_thread"]:
            findings.append(("MXL-K004", "error",
                             "%s: %d registers a thread, over the card's %d"
                             % (label, int(regs), lim["regs_per_thread"])))
        elif int(regs) * resident > lim["regs_per_sm"]:
            findings.append(("MXL-K004", "error",
                             "%s: %d registers x %d resident threads = %d, "
                             "over the SM's %d"
                             % (label, int(regs), resident,
                                int(regs) * resident, lim["regs_per_sm"])))
    split = spec.get("setmaxnreg")
    if split:
        total = sum(int(t) * int(r) for t, r in split)
        if sum(int(t) for t, _r in split) != threads:
            findings.append(("MXL-K004", "error",
                             "%s: setmaxnreg groups %s do not cover the "
                             "block's %d threads" % (label, list(split),
                                                     threads)))
        elif total * max(1, int(spec.get("min_blocks") or 1)) > \
                lim["regs_per_sm"]:
            findings.append(("MXL-K004", "error",
                             "%s: setmaxnreg split %s asks %d registers, "
                             "over the SM's %d"
                             % (label, list(split), total,
                                lim["regs_per_sm"])))
    return findings + _layout_findings(spec, label)


def _layout_findings(spec, label):
    """The tile, TMA, vector and ``wgmma`` checks of one spec."""
    findings = []
    for t in spec.get("tiles", ()):
        extent, tile = int(t["extent"]), int(t["tile"])
        if tile <= 0:
            findings.append(("MXL-K004", "error", "%s: tile %r of %d"
                             % (label, t.get("name", "?"), tile)))
        elif extent % tile:
            findings.append(("MXL-K003", "warning",
                             "%s: %s %d is not divisible by its tile %d: the "
                             "last block computes %d padded entries"
                             % (label, t.get("name", "extent"), extent,
                                tile, -extent % tile)))
    try:
        for box in spec.get("tma", ()):
            findings += _grain_findings(label, "TMA box", box.get("name"),
                                        box["box"][0], box.get("dtype"))
        for vec in spec.get("vectors", ()):
            findings += _grain_findings(label, "16-byte vector load",
                                        vec.get("name"), vec["extent"],
                                        vec.get("dtype"))
        for t in spec.get("wgmma", ()):
            findings += _wgmma_findings(label, t)
    except (KeyError, TypeError, ValueError) as exc:
        findings.append(("MXL-K004", "error", "%s: malformed spec: %s"
                         % (label, exc)))
    return findings


def kernel_spec_issues(limits=None):
    """Validate every registered kernel spec.

    Returns ``[(kernel_name, rule_id, severity, message)]``; a provider
    that raises contributes one MXL-K004 error (a spec that cannot even
    be built is a broken registration, not a pass)."""
    _ensure_builtin_specs()
    lim = _limits(limits)
    out = []
    for name, provider in KERNEL_SPECS.items():
        try:
            specs = provider()
        except Exception as exc:  # noqa: BLE001
            out.append((name, "MXL-K004", "error",
                        "kernel spec provider %r failed: %s" % (name, exc)))
            continue
        if isinstance(specs, dict):
            specs = [specs]
        for spec in specs:
            for rule_id, sev, msg in spec_findings(spec, lim):
                out.append((name, rule_id, sev, msg))
    return out


# ----------------------------------------------------------------------
# the MXL-K rules
# ----------------------------------------------------------------------
def _device_spec_issues():
    """:func:`kernel_spec_issues` on the current device, worked out once
    for each device and state of the registry."""
    _ensure_builtin_specs()
    import torch
    key = (torch.cuda.current_device() if torch.cuda.is_available()
           else None, _VERSION[0])
    if key not in _ISSUES:
        _ISSUES[key] = kernel_spec_issues()
    return _ISSUES[key]


def _findings_by_rule(ctx):
    if "kernel_findings" not in ctx.cache:
        by_rule = {}
        if ctx.target == "gpu":
            for _name, rule_id, sev, msg in _device_spec_issues():
                by_rule.setdefault(rule_id, []).append((sev, msg))
        ctx.cache["kernel_findings"] = by_rule
    return ctx.cache["kernel_findings"]


def _report_rule(ctx, rule_id):
    for sev, msg in _findings_by_rule(ctx).get(rule_id, ()):
        ctx.report(None, msg, severity=sev, rule_id=rule_id)


@register_rule("MXL-K001", "error",
               doc="kernel block over the card's shared memory")
def _rule_k001(ctx):
    _report_rule(ctx, "MXL-K001")


@register_rule("MXL-K002", "error",
               doc="TMA box, vector load or wgmma tile off its grain")
def _rule_k002(ctx):
    _report_rule(ctx, "MXL-K002")


@register_rule("MXL-K003", "warning",
               doc="grid tail: a dimension not divisible by its tile")
def _rule_k003(ctx):
    _report_rule(ctx, "MXL-K003")


@register_rule("MXL-K004", "error",
               doc="threads, grid or registers over the card (or spec "
                   "malformed)")
def _rule_k004(ctx):
    _report_rule(ctx, "MXL-K004")
