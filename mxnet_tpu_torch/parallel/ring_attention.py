"""Attention for training: the flash-attention function, ring attention
over a sequence-parallel mesh axis, and their dispatch.

The port of ``mxnet_tpu/parallel/ring_attention.py``:

- :func:`attention_reference`: plain softmax attention (scores masked
  with -1e30, not -inf).  ``ops/attention.py`` re-exports it.
- :func:`flash_attention`: a ``torch.autograd.Function``.  Its forward
  is the hand-written CUDA kernel for CUDA tensors and its plain version
  for CPU tensors (``kernels/flash_attention.py``); both return the row
  logsumexp that the backward keeps.  Its backward is
  :func:`_flash_backward_blockwise`, the port of the JAX package's
  blockwise recompute (plain jnp there, PyTorch here): per block of
  keys, the probabilities are rebuilt from the logsumexp, so the live
  memory is O(Sq * block_k), never the (Sq, Sk) score matrix.
- :func:`blockwise_combine`: attention over a list of (k, v) blocks by
  the online-softmax recurrence (``_block_step``), the building block of
  the ring.
- :func:`ring_attention`: sequence-parallel attention over the members
  of an sp group.  It takes each member's ``(B, H, S/n, D)`` chunk of q,
  k and v in ring order (sequence order) and returns each member's
  output chunk.  Where the JAX ring steps the recurrence in jnp inside
  ``shard_map`` (it never calls the Pallas kernel), every hop here is
  the flash forward (``kernels.flash_attention.flash_attention_forward``:
  the CUDA kernel on a card) on the member's q chunk and the visiting
  k/v chunk, and the hops' ``(o_i, lse_i)`` combine in float32:
  ``lse = logaddexp(lse, lse_i)``, ``o = sum exp(lse_i - lse) o_i``.
  Hop 0 is the member's own chunk, causal; a chunk of an earlier member
  is not masked, and one of a later member is skipped when causal (the
  JAX recurrence gives it weight ``exp(-1e30 - m) = 0``).  k and v
  rotate one member a hop with ``collectives.send`` (a peer copy between
  cards, none between members of one device).  The backward does the
  hops again with :func:`_flash_backward_blockwise` from the combined o
  and lse: dq stays on its member, each hop's dk and dv go back to the
  chunk's owner.  A member keeps O(S/n) and one hop's
  ``(S/n, block_k)`` scores, never the ``(S/n, S)`` matrix.
  :func:`ring_attention_reference` is the JAX recurrence step by step,
  for the tests.
- :func:`sequence_parallel` / :func:`current_sequence_parallel`: the
  context under which ``MultiHeadAttention`` runs the ring over the
  ``seq_axis`` members of ``mesh`` (``ShardedTrainer(seq_axis=...)``
  enters it around its walk), and :func:`sharded_self_attention`, the
  dispatch for whole ``(B, H, S, D)`` tensors: the ring over the
  context's mesh (the batch split over its ``batch_axis``, the sequence
  over ``seq_axis``) when one is active, :func:`flash_attention`
  otherwise.

Unlike the JAX ``flash_attention``, which takes its reference path when
S is not a multiple of its 128 block, the kernel masks the ragged edge,
so the same function runs for every S.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from ..base import MXNetError
from ..kernels import flash_attention as _fa

__all__ = ["attention_reference", "flash_attention", "blockwise_combine",
           "ring_attention", "ring_attention_reference",
           "sharded_self_attention", "sequence_parallel",
           "current_sequence_parallel", "ring_counts", "reset_ring_counts"]

_NEG_INF = -1e30


def attention_reference(q, k, v, causal=False, scale=None, q_offset=0,
                        kv_offset=0):
    """Plain softmax attention; q (..., Sq, D), k/v (..., Sk, D).

    ``q_offset``/``kv_offset`` are the global positions of element 0
    (causal masking of sequence chunks)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(q.shape[-2], device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[-2], device=q.device)[None, :] + kv_offset
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(p.dtype)).to(q.dtype)


def _flash_backward_blockwise(q, k, v, o, lse, do, causal, scale,
                              block_k=128, as_float=False):
    """Flash-attention backward: blockwise recompute from the saved
    logsumexp (the port of ``_flash_backward_blockwise``).  With
    p = exp(s * scale - lse):

        dv_j = p^T @ do
        ds   = p * (do @ v^T - rowsum(do * o)) * scale
        dq  += ds @ k_j,   dk_j = ds^T @ q

    The last block may be short, so any Sk works.  Computes in float32
    and returns each gradient in its input's dtype (in float32 with
    ``as_float``: the ring sums a chunk's hops before it rounds)."""
    qf = q.float()
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1)                    # (B, H, Sq)
    sq, sk = q.shape[-2], k.shape[-2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for start in range(0, sk, block_k):
        stop = min(start + block_k, sk)
        kb = k[..., start:stop, :].float()
        vb = v[..., start:stop, :].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(start, stop, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
        p = torch.exp(s - lse[..., None])
        dv[..., start:stop, :] = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.matmul(ds, kb)
        dk[..., start:stop, :] = torch.matmul(ds.transpose(-1, -2), qf)
    if as_float:
        return dq, dk, dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _fa.flash_attention_forward(q, k, v, causal=causal,
                                             scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward_blockwise(q, k, v, o, lse, do,
                                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Fused attention; q/k/v (B, H, S, D), differentiable.  The forward
    is the CUDA kernel for CUDA tensors (its plain version on the CPU);
    the backward recomputes blockwise from the saved logsumexp."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))




# ----------------------------------------------------------------------
# blockwise combine and ring attention
# ----------------------------------------------------------------------
def _block_step(q, k, v, scale, causal, q_offset, kv_offset, m, l, o):
    """One online-softmax accumulation step (the JAX ``_block_step``):
    ``m' = max(m, rowmax(s))``, ``l' = l exp(m - m') + rowsum(exp(s -
    m'))``, ``o' = o exp(m - m') + exp(s - m') v``, in float32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qpos = torch.arange(q.shape[-2], device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[-2], device=q.device)[None, :] + kv_offset
        s = torch.where(qpos >= kpos, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    c = torch.exp(m - m_new)
    l_new = l * c + p.sum(dim=-1)
    o_new = o * c[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, o_new


def blockwise_combine(q, kv_blocks, causal=False, scale=None, q_offset=0,
                      kv_offsets=None):
    """Attention of ``q`` over a list of ``(k, v)`` blocks by the
    online-softmax recurrence; ``kv_offsets`` default to the blocks laid
    end to end from 0.  The building block the ring distributes."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    batch_shape = q.shape[:-1]
    m = torch.full(batch_shape, _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(batch_shape, dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if kv_offsets is None:
        kv_offsets, off = [], 0
        for k, _ in kv_blocks:
            kv_offsets.append(off)
            off += k.shape[-2]
    for (k, v), koff in zip(kv_blocks, kv_offsets):
        m, l, o = _block_step(q, k, v, scale, causal, q_offset, koff, m, l, o)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_attention_reference(qs, ks, vs, causal=False, scale=None):
    """The JAX ``ring_attention`` step by step, over the members' chunks
    (ring order = sequence order): at step s member i holds the chunk of
    member ``(i - s) mod n`` and accumulates it with ``_block_step``,
    masked at the chunks' global offsets when causal.  The tests'
    reference for :func:`ring_attention`; nothing else calls it."""
    n = len(qs)
    if scale is None:
        scale = 1.0 / math.sqrt(qs[0].shape[-1])
    chunk = qs[0].shape[-2]
    out = []
    for i, q in enumerate(qs):
        shape = q.shape[:-1]
        m = torch.full(shape, _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(shape, dtype=torch.float32, device=q.device)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for s in range(n):
            j = (i - s) % n
            m, l, o = _block_step(q, ks[j].to(q.device), vs[j].to(q.device),
                                  scale, causal, i * chunk, j * chunk,
                                  m, l, o)
        out.append((o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return out


#: per member (the ``members`` keys :func:`ring_attention` is given):
#: the hops it ran (each one flash forward, the recompute of a mirrored
#: layer's ring included), the hops it skipped (causal), and the bytes it
#: sent (k and v rotated on, dk and dv handed back to their owner; the
#: ``peer`` share crossed between two cards, the rest stayed on one)
_RING = {"hops": {}, "skipped": {}, "bytes_sent": {}, "bytes_peer": {}}


def ring_counts():
    """A copy of the ring's counters: ``{"hops", "skipped",
    "bytes_sent", "bytes_peer"}``, each ``{member: n}``."""
    return {k: dict(v) for k, v in _RING.items()}


def reset_ring_counts():
    for v in _RING.values():
        v.clear()


def _bump(what, member, n=1):
    _RING[what][member] = _RING[what].get(member, 0) + n


def _send(t, device, member):
    """``collectives.send`` of ``t`` by ``member``, counted: a peer copy
    between two cards, none between members of one device."""
    from .collectives import send
    nbytes = t.numel() * t.element_size()
    _bump("bytes_sent", member, nbytes)
    if t.device != torch.device(device):
        _bump("bytes_peer", member, nbytes)
    return send(t, device)


def _rotate(chunks, members):
    """Each member's chunk sent on to the next member of the ring (the
    last member's to the first)."""
    n = len(chunks)
    return [_send(chunks[(j - 1) % n], chunks[j].device, members[(j - 1) % n])
            for j in range(n)]


class _Ring(torch.autograd.Function):
    """Ring attention over ``n`` members' chunks: ``apply(n, causal,
    scale, members, *qs, *ks, *vs)`` gives the ``n`` output chunks."""

    @staticmethod
    def forward(ctx, n, causal, scale, members, *chunks):
        qs = [c.contiguous() for c in chunks[:n]]
        ks = [c.contiguous() for c in chunks[n:2 * n]]
        vs = [c.contiguous() for c in chunks[2 * n:]]
        o = [None] * n
        lse = [None] * n
        cur_k, cur_v = list(ks), list(vs)
        for h in range(n):
            for i in range(n):
                j = (i - h) % n
                if causal and j > i:
                    _bump("skipped", members[i])
                    continue
                o_h, lse_h = _fa.flash_attention_forward(
                    qs[i], cur_k[i], cur_v[i], causal=causal and h == 0,
                    scale=scale)
                _bump("hops", members[i])
                if o[i] is None:
                    o[i], lse[i] = o_h.float(), lse_h
                    continue
                new = torch.logaddexp(lse[i], lse_h)
                o[i] = o[i] * torch.exp(lse[i] - new)[..., None] \
                    + o_h.float() * torch.exp(lse_h - new)[..., None]
                lse[i] = new
            if h + 1 < n:
                cur_k, cur_v = _rotate(cur_k, members), _rotate(cur_v, members)
        out = [oi.to(q.dtype) for oi, q in zip(o, qs)]
        ctx.save_for_backward(*qs, *ks, *vs, *out, *lse)
        ctx.n, ctx.causal, ctx.scale, ctx.members = n, causal, scale, members
        return tuple(out)

    @staticmethod
    def backward(ctx, *dos):
        n, causal, scale = ctx.n, ctx.causal, ctx.scale
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        os_, lses = saved[3 * n:4 * n], saved[4 * n:]
        dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
              for q in qs]
        dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
              for k in ks]
        dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
              for v in vs]
        cur_k, cur_v = list(ks), list(vs)
        for h in range(n):
            for i in range(n):
                j = (i - h) % n
                if causal and j > i:
                    continue
                do = dos[i] if dos[i] is not None \
                    else torch.zeros_like(os_[i])
                g_q, g_k, g_v = _flash_backward_blockwise(
                    qs[i], cur_k[i], cur_v[i], os_[i], lses[i], do,
                    causal and h == 0, scale, as_float=True)
                dq[i] += g_q
                if j == i:
                    dk[j] += g_k
                    dv[j] += g_v
                else:
                    dk[j] += _send(g_k, dk[j].device, ctx.members[i])
                    dv[j] += _send(g_v, dv[j].device, ctx.members[i])
            if h + 1 < n:
                cur_k, cur_v = _rotate(cur_k, ctx.members), \
                    _rotate(cur_v, ctx.members)
        return (None, None, None, None) \
            + tuple(g.to(q.dtype) for g, q in zip(dq, qs)) \
            + tuple(g.to(k.dtype) for g, k in zip(dk, ks)) \
            + tuple(g.to(v.dtype) for g, v in zip(dv, vs))


def ring_attention(qs, ks, vs, causal=False, scale=None, members=None):
    """Sequence-parallel attention over the members of one sp group.

    ``qs``, ``ks``, ``vs``: each member's ``(B, H, S/n, D)`` chunk, in
    ring order (sequence order), each on its member's device.  Returns
    each member's output chunk, differentiable.  Every hop that is not
    skipped is one flash forward (the CUDA kernel for CUDA tensors, its
    plain version on the CPU); ``members`` keys :func:`ring_counts`
    (default: 0 .. n-1)."""
    n = len(qs)
    if not (len(ks) == len(vs) == n) or n == 0:
        raise MXNetError("ring_attention: want one q, k and v chunk a "
                         "member, got %d, %d, %d" % (n, len(ks), len(vs)))
    if len({tuple(q.shape) for q in qs}) != 1:
        raise MXNetError("ring_attention: the members' chunks differ in "
                         "shape: %s" % [tuple(q.shape) for q in qs])
    if scale is None:
        scale = 1.0 / math.sqrt(qs[0].shape[-1])
    members = tuple(range(n)) if members is None else tuple(members)
    return list(_Ring.apply(n, bool(causal), float(scale), members,
                            *qs, *ks, *vs))


# ----------------------------------------------------------------------
# the sequence-parallel context
# ----------------------------------------------------------------------
_SP_STATE = threading.local()


class _SPContext:
    """An active :func:`sequence_parallel`: the mesh, its sequence axis
    and its batch axis (None when the mesh lacks it)."""

    __slots__ = ("mesh", "seq_axis", "batch_axis")

    def __init__(self, mesh, seq_axis, batch_axis):
        self.mesh = mesh
        self.seq_axis = seq_axis
        self.batch_axis = batch_axis

    @property
    def size(self):
        return int(self.mesh.shape.get(self.seq_axis, 1))

    def rings(self):
        """The mesh's sp groups: for each member at index 0 of
        ``seq_axis``, the members that differ from it only there, in
        ring (sequence) order."""
        return [self.mesh.axis_members(i, self.seq_axis)
                for i in self.mesh.members(**{self.seq_axis: 0})]


@contextlib.contextmanager
def sequence_parallel(mesh, seq_axis="sp", batch_axis="dp"):
    """While active, ``MultiHeadAttention`` runs ring attention over
    ``seq_axis`` of ``mesh`` (``ShardedTrainer(seq_axis=...)`` and
    ``ShardedPredictor(seq_axis=...)`` enter it around their walk)."""
    prev = getattr(_SP_STATE, "ctx", None)
    _SP_STATE.ctx = mesh if isinstance(mesh, _SPContext) else _SPContext(
        mesh, seq_axis,
        batch_axis if batch_axis in mesh.axis_names else None)
    try:
        yield _SP_STATE.ctx
    finally:
        _SP_STATE.ctx = prev


def current_sequence_parallel():
    """The active context (``.mesh``, ``.seq_axis``, ``.batch_axis``), or
    None."""
    return getattr(_SP_STATE, "ctx", None)


def sharded_self_attention(q, k, v, causal=False):
    """Attention dispatch for whole ``(B, H, S, D)`` tensors: with a
    sequence-parallel context active, ring attention over its mesh (the
    batch split over the batch axis, the sequence over the sequence
    axis, each part on its member's device; the result assembled on q's
    device), as the JAX function ``shard_map``s the ring; else
    :func:`flash_attention`."""
    ctx = current_sequence_parallel()
    if ctx is None or ctx.seq_axis not in ctx.mesh.axis_names:
        return flash_attention(q, k, v, causal=causal)
    from .collectives import send
    mesh = ctx.mesh
    if mesh.num_processes > 1:
        raise MXNetError("sharded_self_attention: a mesh across processes "
                         "(sp across the processes of a torch.distributed "
                         "group: ROADMAP.md queue 1 item 3 (k))")
    rings = ctx.rings()
    n = ctx.size
    if q.shape[-2] % n or q.shape[0] % len(rings):
        raise MXNetError("sharded_self_attention: (B, S) = %s does not "
                         "divide over %d batch parts and %d sequence parts"
                         % ((q.shape[0], q.shape[-2]), len(rings), n))
    parts = []
    for b, ring in enumerate(rings):
        rows = [t.chunk(len(rings), dim=0)[b] for t in (q, k, v)]
        chunks = [[send(c, mesh.devices[m]) for c, m in
                   zip(t.chunk(n, dim=-2), ring)] for t in rows]
        got = ring_attention(*chunks, causal=causal, members=ring)
        parts.append(torch.cat([send(o, q.device) for o in got], dim=-2))
    return torch.cat(parts, dim=0)
