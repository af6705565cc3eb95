"""Flash-attention forward: softmax attention and its row logsumexp.

The port of ``mxnet_tpu/parallel/ring_attention.py:_flash_kernel`` and
its launcher ``_flash_forward_kernel_call``: for q, k, v ``(B, H, S, D)``
it returns ``o`` in the input dtype and ``lse = m + log(l)`` as ``(B, H,
Sq)`` float32, the statistic the blockwise backward
(``parallel/ring_attention.py``) recomputes the probabilities from.
Masked scores are -1e30, not -inf, and ``l`` is floored at 1e-30, as in
the JAX kernel.

- :func:`flash_attention_forward_reference` is the plain PyTorch version
  (the whole score matrix, float32).  It runs for tensors on the CPU,
  and it is what the CUDA kernel is compared with on the GPU.
- :func:`flash_attention_forward` is the wrapper of the hand-written
  CUDA kernels ``csrc/flash_attention.cu``: for bfloat16 inputs a
  tensor-core kernel (``wgmma`` fed by TMA, 128 q rows a CTA, p issued
  as a bfloat16 hi and lo part so o keeps float32 accuracy), for float32
  inputs an FMA kernel (128 q rows a CTA, 64 at D=128, 64-key tiles by
  ``cp.async`` into a two-stage ring, 8x8 register micro-tiles, one CTA
  a work item; :func:`plan_flash_forward` states its tiles and work
  order).  Both run an
  online softmax, skip causal tiles above the diagonal and mask only
  the tiles on the diagonal or the ragged edge, so any S works.  For
  CUDA tensors it launches a kernel or raises.
  ``flash_attention_forward.launches`` counts its launches and
  ``.launches_by_dtype`` them by input dtype (so by body).
"""
from __future__ import annotations

import math

import torch

from ..analysis.tiling import register_kernel_spec
from ..base import MXNetError
from ..observability.metrics import register_kernel_counters

__all__ = ["flash_attention_forward_reference", "flash_attention_forward",
           "plan_flash_forward", "work_item", "launch_spec"]

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

#: the float32 body's tiles (``FmaCfg<D>`` in ``csrc/flash_attention.cu``):
#: q rows a CTA by head dim, and keys a tile
F32_BLOCK_Q = {32: 128, 64: 128, 128: 64}
F32_BLOCK_K = 64


def work_item(t, bh_count, n_qtiles, block_q):
    """``(bh, q0)`` of the float32 body's work item ``t``: items walk the
    q tiles from the last (the longest causal walk) down, every
    batch*head at each, as the kernel does."""
    return t % bh_count, (n_qtiles - 1 - t // bh_count) * block_q


def plan_flash_forward(BH, Sq, Sk, D, causal):
    """The float32 body's tiles and work items, from the shapes.

    Each work item is one batch*head and one tile of ``block_q`` q rows,
    which walks ``k_tiles(q0)`` tiles of ``block_k`` keys (causal: up to
    the diagonal).  The kernel runs one CTA an item, CTA ``t`` taking
    :func:`work_item` ``t``, longest walk first: the card hands each next
    item to the first free slot.  The kernel keeps its own copy of these
    numbers and expressions (``FmaCfg<D>``, ``flash_forward_fma``);
    ``tests/test_torch_flash_f32.py`` reads them out of the source and
    holds them to this function.
    Returns a dict: ``block_q``, ``block_k``, ``n_qtiles``, ``items`` and
    ``k_tiles`` (a function of ``q0``)."""
    bq = F32_BLOCK_Q[D]
    n_qtiles = -(-Sq // bq)
    items = BH * n_qtiles
    all_tiles = -(-Sk // F32_BLOCK_K)

    def k_tiles(q0):
        if causal:
            return min(all_tiles, (q0 + bq - 1) // F32_BLOCK_K + 1)
        return all_tiles

    return {"block_q": bq, "block_k": F32_BLOCK_K, "n_qtiles": n_qtiles,
            "items": items, "k_tiles": k_tiles}


def flash_attention_forward_reference(q, k, v, causal=False, scale=None):
    """Plain softmax attention in float32.  ``q (B, H, Sq, D)``, ``k``
    and ``v (B, H, Sk, D)``.  Returns ``(o, lse)``: ``o`` in q's dtype,
    ``lse (B, H, Sq)`` float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(q.shape[-2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.matmul(p, vf) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise MXNetError("flash_attention: want q (B, H, Sq, D) and k, v "
                         "(B, H, Sk, D), got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if q.shape[3] not in _HEAD_DIMS:
        raise MXNetError("flash_attention: the CUDA kernel takes head dims "
                         "%s, got %d" % (_HEAD_DIMS, q.shape[3]))
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError("flash_attention: q, k, v must all be float32 or "
                         "all bfloat16, got %s, %s, %s"
                         % (q.dtype, k.dtype, v.dtype))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise MXNetError("flash_attention: %s is on %s, q on %s"
                             % (name, t.device, q.device))
        if not t.is_contiguous():
            raise MXNetError("flash_attention: %s must be contiguous" % name)
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise MXNetError("flash_attention: empty sequence")


def flash_attention_forward(q, k, v, causal=False, scale=None):
    """Attention forward with :func:`flash_attention_forward_reference`'s
    signature and semantics.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/flash_attention.cu`` (and raise on inputs it
    does not take: other dtypes, head dims outside 32/64/128, strided or
    misaligned tensors)."""
    if not q.is_cuda:
        return flash_attention_forward_reference(q, k, v, causal=causal,
                                                 scale=scale)
    from ._build import check, library
    _check_inputs(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.mxtt_flash_attention_forward(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B * H, Sq, Sk, D, int(bool(causal)),
            float(scale), stream)
    check(lib, code, "flash_attention")
    flash_attention_forward.launches += 1
    flash_attention_forward.launches_by_dtype[
        str(q.dtype).replace("torch.", "")] += 1
    by_dev = flash_attention_forward.launches_by_device
    by_dev[str(q.device)] = by_dev.get(str(q.device), 0) + 1
    by_heads = flash_attention_forward.launches_by_heads
    by_heads[H] = by_heads.get(H, 0) + 1
    return o, lse


#: launches of the CUDA kernels in this process, in all, by input dtype
#: ("bfloat16" is the tensor-core body, "float32" the FMA body), by
#: device and by heads a launch (a tp member's share; callers may reset
#: them)
flash_attention_forward.launches = 0
flash_attention_forward.launches_by_dtype = {"float32": 0, "bfloat16": 0}
flash_attention_forward.launches_by_device = {}
flash_attention_forward.launches_by_heads = {}
register_kernel_counters("flash_attention", lambda: {
    "launches": flash_attention_forward.launches,
    "by_dtype": dict(flash_attention_forward.launches_by_dtype)})


# ----------------------------------------------------------------------
# the launches, declared for the static analyzer (MXL-K)
# ----------------------------------------------------------------------
#: the float32 body's threads (``FmaCfg<D>::THREADS``), its k/v stages
#: and the keys of p it exchanges at a time (``PK``)
F32_THREADS, F32_STAGES, F32_PK = 128, 2, 16
#: the bfloat16 body (``TcCfg<D>``): 2 consumer warpgroups and the
#: producer's, 128 q rows a CTA, 4 k/v stages, ``setmaxnreg`` 24 for the
#: producer's warpgroup and 240 for the consumers'
BF16_THREADS, BF16_BLOCK_Q, BF16_STAGES = 384, 128, 4
BF16_REGS = ((128, 24), (256, 240))
#: the shared memory a card's SM holds, which the float32 body's
#: ``MIN_CTAS`` is worked out against (``FmaCfg<D>::MIN_CTAS``)
_SM_SMEM = 233472
#: the training shape of the LM (``chip_smoke.py`` phases 5 and 7)
MAIN_SHAPES = dict(B=8, H=8, S=1024, D=64)
#: one tp member's share of it at tp=2: half the heads (phase 22)
MEMBER_SHAPES = dict(MAIN_SHAPES, H=4)


def _compiled_smem(dtype, D):
    """(dynamic shared memory, CTAs an SM) of the built library's launch
    of the body for ``dtype`` and head dim ``D`` (its ``FmaCfg<D>`` or
    ``TcCfg<D>``)."""
    import ctypes
    from ._build import launch_smem
    ctas = ctypes.c_int(0)
    smem = launch_smem("flash_attention", _DTYPE_CODES[getattr(torch, dtype)],
                       D, ctypes.byref(ctas))
    return smem, ctas.value


def launch_spec(B, H, Sq, Sk, D, dtype="float32", causal=True, sms=None,
                compiled=False):
    """The kernel's launch for q ``(B, H, Sq, D)`` and k, v ``(B, H, Sk,
    D)``.  float32: the FMA body, one CTA a work item of
    :func:`plan_flash_forward` (its tiles), with the shared memory its
    ``FmaCfg<D>`` lays out (q and the k/v ring at a padded stride, each
    warp's p) and ``__launch_bounds__(128, MIN_CTAS)``.  bfloat16: the
    wgmma body on a persistent grid of at most one CTA an SM, its TMA
    boxes (one swizzled panel of at most 64 columns), the two ``wgmma``
    shapes and the ``setmaxnreg`` split.  ``sms`` None: the card's.
    ``compiled``: the shared memory and CTAs an SM as the built library
    reports them (``mxtt_flash_attention_smem``, needs ``nvcc``) in place
    of this module's copy of the ``.cu`` constants, which
    ``chip_smoke.py`` holds to them."""
    if sms is None:
        from ..observability.counters import launch_limits
        sms = launch_limits()["sms"]
    plan = plan_flash_forward(B * H, Sq, Sk, D, causal)
    origin = "mxnet_tpu_torch/csrc/flash_attention.cu"
    if dtype == "float32":
        bq, bk = plan["block_q"], plan["block_k"]
        qld, rm = D + 4, bq // 16
        smem = (bq * qld + F32_STAGES * bk * (qld + D)
                + F32_THREADS // 32 * 4 * rm * (F32_PK + 8)) * 4
        min_ctas = 2 if 2 * (smem + 1024) <= _SM_SMEM else 1
        if compiled:
            smem, min_ctas = _compiled_smem(dtype, D)
        return {
            "name": "flash_forward_fma<%d>" % D, "origin": origin,
            "entry": "flash_forward_fmaILi%dE" % D,
            "grid": (plan["items"], 1, 1), "block": (F32_THREADS, 1, 1),
            "dynamic_smem": smem, "static_smem": 0, "min_blocks": min_ctas,
            "tiles": [{"name": "q rows", "extent": Sq, "tile": bq},
                      {"name": "keys", "extent": Sk, "tile": bk}],
            "vectors": [{"name": "q/k/v row (cp.async)", "extent": D,
                         "dtype": "float32"}]}
    bk = 64 if D == 128 else 128
    panel = min(D, 64)
    items = B * H * -(-Sq // BF16_BLOCK_Q)
    smem = 1024 + 2 * BF16_BLOCK_Q * D * 2 + BF16_STAGES * 2 * bk * D * 2 \
        + 8 * (4 + 2 * BF16_STAGES)
    min_ctas = 1
    if compiled:
        smem, min_ctas = _compiled_smem(dtype, D)
    return {
        "name": "flash_forward_wgmma<%d>" % D, "origin": origin,
        "entry": "flash_forward_wgmmaILi%dE" % D,
        "grid": (min(items, sms), 1, 1), "block": (BF16_THREADS, 1, 1),
        "dynamic_smem": smem, "static_smem": 0, "min_blocks": min_ctas,
        "setmaxnreg": list(BF16_REGS),
        "tiles": [{"name": "q rows", "extent": Sq, "tile": BF16_BLOCK_Q},
                  {"name": "keys", "extent": Sk, "tile": bk}],
        "tma": [{"name": "q", "box": (panel, BF16_BLOCK_Q, 1),
                 "dtype": "bfloat16"},
                {"name": "k/v", "box": (panel, bk, 1), "dtype": "bfloat16"}],
        "wgmma": [{"name": "s = q k^T", "m": 64, "n": bk, "k": 16,
                   "dtype": "bfloat16"},
                  {"name": "o += p v", "m": 64, "n": D, "k": 16,
                   "dtype": "bfloat16"}]}


register_kernel_spec("kernels.flash_attention", lambda: [
    launch_spec(shapes["B"], shapes["H"], shapes["S"], shapes["S"],
                shapes["D"], dtype)
    for shapes in (MAIN_SHAPES, MEMBER_SHAPES)
    for dtype in ("float32", "bfloat16")])
