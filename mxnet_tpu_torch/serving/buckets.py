"""Offline bucket planner: pick serving buckets that minimize padded
matrix-unit work against an offered-load histogram.

A copy of the planner of ``mxnet_tpu/serving/buckets.py``, with the
TPU cost model it prices buckets by (``mxu_padding_waste`` and
``min_tile`` of ``mxnet_tpu/analysis``: k and n pad to 128 lanes, m to
the dtype's sublane granule), so that the port plans THE SAME buckets as
the JAX package for the same model and histogram.  The model's product
rows come from the static analyzer's cost rows
(:func:`model_matmul_dims`), as the JAX planner reads them; only the
granules stay the TPU's here.  A cost model of the H100 is later work
(ROADMAP.md).

A batch of ``n`` samples served in bucket ``B`` pays
``padded_flops(B) = useful_flops(B) / (1 - mxu_padding_waste(dims(B)))``;
:func:`plan_buckets` solves the partition of the observed sizes exactly
by dynamic programming.  ``mats`` are the model's per-sample ``(m, k,
n)`` matmul rows, ``quad_mats`` the rows that scale with the size on
both m and n (the attention S² term of the prompt-length axis).
"""
from __future__ import annotations

import os as _os

import numpy as _np

from ..base import MXNetError

__all__ = ["plan_buckets", "BucketPlan", "plan_cost", "padded_flops",
           "useful_flops", "request_waste", "bucket_for", "pow2_buckets",
           "parse_histogram", "parse_buckets", "mxu_padding_waste",
           "min_tile", "model_matmul_dims", "default_max_buckets"]

#: fallback per-sample matmul dims when the model's are unknown
DEFAULT_MATS = ((1, 128, 128),)
#: planner bucket budget (the JAX package's default)
DEFAULT_MAX_BUCKETS = 4


def default_max_buckets():
    """Planner bucket budget (``MXTPU_SERVE_MAX_BUCKETS``, default 4)."""
    try:
        return max(1, int(_os.environ.get("MXTPU_SERVE_MAX_BUCKETS",
                                          str(DEFAULT_MAX_BUCKETS))))
    except ValueError:
        return DEFAULT_MAX_BUCKETS

#: TPU tile granules of the cost model (mxnet_tpu/analysis/tiling.py)
LANES = 128
_MIN_SUBLANES = {8: 4, 4: 8, 2: 16, 1: 32}
#: numpy has no bfloat16 without ml_dtypes: size it by name
_NAMED_ITEMSIZE = {"bfloat16": 2}


def min_tile(dtype):
    """Minimum tile (sublanes, lanes) of ``dtype`` in the cost model."""
    name = str(dtype or "float32")
    itemsize = _NAMED_ITEMSIZE.get(name) or _np.dtype(name).itemsize
    return (_MIN_SUBLANES.get(itemsize, 8), LANES)


def mxu_padding_waste(dims, compute_dtype="bfloat16"):
    """Fraction of matrix-unit work spent on tile padding for ``(m, k,
    n)`` matmul dims: k and n pad to the 128-lane granule, m to the
    dtype's sublane granule.  0.0 = perfectly tiled."""
    sub, _lanes = min_tile(compute_dtype)
    done = padded = 0
    for m, k, n in dims:
        done += m * k * n
        padded += (-(-m // sub) * sub) * (-(-k // LANES) * LANES) \
            * (-(-n // LANES) * LANES)
    if not padded:
        return 0.0
    return 1.0 - float(done) / float(padded)


def parse_histogram(spec):
    """``{size: weight}`` from a dict, a ``[(size, weight), ...]`` list,
    a plain iterable of sizes (weight 1 each), or a ``"1:100,8:20"``
    string.  Sizes must be positive ints; weights positive numbers."""
    if isinstance(spec, str):
        items = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                size, weight = part.split(":", 1)
                items.append((int(size), float(weight)))
            else:
                items.append((int(part), 1.0))
    elif isinstance(spec, dict):
        items = [(int(k), float(v)) for k, v in spec.items()]
    else:
        items = []
        for entry in spec:
            if isinstance(entry, (tuple, list)):
                items.append((int(entry[0]), float(entry[1])))
            else:
                items.append((int(entry), 1.0))
    hist = {}
    for size, weight in items:
        if size <= 0:
            raise MXNetError("histogram sizes must be positive, got %d"
                             % size)
        if weight <= 0:
            raise MXNetError("histogram weights must be positive, got %r"
                             % weight)
        hist[size] = hist.get(size, 0.0) + weight
    if not hist:
        raise MXNetError("empty request histogram")
    return hist


def parse_buckets(spec):
    """Sorted tuple of bucket sizes from ``"1,8,32"`` / iterable."""
    if isinstance(spec, str):
        sizes = [int(p) for p in spec.split(",") if p.strip()]
    else:
        sizes = [int(b) for b in spec]
    if not sizes or any(b <= 0 for b in sizes):
        raise MXNetError("buckets must be positive ints, got %r" % (spec,))
    return tuple(sorted(set(sizes)))


def bucket_for(n, buckets):
    """Smallest bucket admitting ``n`` samples, or None when ``n``
    exceeds every bucket (the request is inadmissible)."""
    for b in buckets:
        if b >= n:
            return b
    return None


def useful_flops(n, mats=DEFAULT_MATS, quad_mats=()):
    """MAC-units of requested work for ``n`` samples (2-FLOPs-per-MAC
    scaling cancels out of every ratio here, so it is omitted).
    ``quad_mats`` rows pay ``n²`` — the sequence-axis attention term."""
    lin = n * sum(m * k * nn for m, k, nn in mats)
    return lin + n * n * sum(m * k * nn for m, k, nn in quad_mats)


def padded_flops(batch, mats=DEFAULT_MATS, compute_dtype="float32",
                 quad_mats=()):
    """Systolic-array work one batch of ``batch`` samples actually pays
    after MXU tile rounding — the analyzer's ``mxu_padding_waste``
    inverted: padded = useful / (1 - waste).  Linear rows grow the m
    dim with the size; ``quad_mats`` rows grow m AND n."""
    dims = [(batch * m, k, n) for m, k, n in mats]
    dims += [(batch * m, k, batch * n) for m, k, n in quad_mats]
    done = useful_flops(batch, mats, quad_mats)
    waste = mxu_padding_waste(dims, compute_dtype)
    if waste >= 1.0:
        raise MXNetError("degenerate matmul dims %r" % (mats,))
    return done / (1.0 - waste)


def request_waste(n, bucket, mats=DEFAULT_MATS, compute_dtype="float32",
                  quad_mats=()):
    """Fraction of the bucket's padded work that is NOT the ``n``
    requested samples (batch-fill padding + tile padding combined)."""
    padded = padded_flops(bucket, mats, compute_dtype, quad_mats)
    return 1.0 - useful_flops(n, mats, quad_mats) / padded


def plan_cost(buckets, histogram, mats=DEFAULT_MATS,
              compute_dtype="float32", quad_mats=()):
    """Total padded MXU work of serving ``histogram`` (each request of
    size ``s``, weighted, dispatched alone in its smallest admissible
    bucket).  Raises when any size is inadmissible."""
    hist = parse_histogram(histogram)
    buckets = parse_buckets(buckets)
    per_bucket = {b: padded_flops(b, mats, compute_dtype, quad_mats)
                  for b in buckets}
    total = 0.0
    for size, weight in sorted(hist.items()):
        b = bucket_for(size, buckets)
        if b is None:
            raise MXNetError(
                "size %d exceeds the largest bucket %d" % (size, buckets[-1]))
        total += weight * per_bucket[b]
    return total


def pow2_buckets(histogram):
    """The naive baseline: each observed size ceils to a power of two;
    the bucket set is the distinct ceilings actually used."""
    hist = parse_histogram(histogram)
    out = set()
    for size in hist:
        b = 1
        while b < size:
            b <<= 1
        out.add(b)
    return tuple(sorted(out))


class BucketPlan(object):
    """Planner output: the chosen buckets plus the padded-work ledger.

    Attributes: ``buckets`` (sorted tuple), ``cost`` (total padded MXU
    work over the histogram), ``useful`` (requested work), ``waste``
    (1 − useful/cost, the expected padding-waste fraction),
    ``pow2_cost``/``pow2_waste`` (the naive baseline on the same
    histogram), ``mats``, ``quad_mats``, ``compute_dtype``.
    """

    def __init__(self, buckets, histogram, mats, compute_dtype,
                 quad_mats=()):
        self.buckets = parse_buckets(buckets)
        self.histogram = parse_histogram(histogram)
        self.mats = tuple(tuple(int(d) for d in row) for row in mats)
        self.quad_mats = tuple(tuple(int(d) for d in row)
                               for row in quad_mats)
        self.compute_dtype = compute_dtype
        self.cost = plan_cost(self.buckets, self.histogram, self.mats,
                              compute_dtype, self.quad_mats)
        self.useful = sum(w * useful_flops(s, self.mats, self.quad_mats)
                          for s, w in self.histogram.items())
        self.waste = 1.0 - self.useful / self.cost if self.cost else 0.0
        p2 = pow2_buckets(self.histogram)
        self.pow2_buckets = p2
        self.pow2_cost = plan_cost(p2, self.histogram, self.mats,
                                   compute_dtype, self.quad_mats)
        self.pow2_waste = 1.0 - self.useful / self.pow2_cost \
            if self.pow2_cost else 0.0

    def bucket_for(self, n):
        return bucket_for(n, self.buckets)

    def admissible(self, n):
        return bucket_for(n, self.buckets) is not None

    @property
    def max_batch(self):
        return self.buckets[-1]

    def to_dict(self):
        return {"buckets": list(self.buckets),
                "waste": round(self.waste, 6),
                "pow2_buckets": list(self.pow2_buckets),
                "pow2_waste": round(self.pow2_waste, 6),
                "compute_dtype": self.compute_dtype,
                "quadratic": bool(self.quad_mats)}

    def __repr__(self):
        return "BucketPlan(buckets=%s, waste=%.3f, pow2_waste=%.3f)" % (
            list(self.buckets), self.waste, self.pow2_waste)


def plan_buckets(histogram, mats=None, max_buckets=None,
                 compute_dtype="float32", include=(), quad_mats=()):
    """Choose ≤ ``max_buckets`` batch buckets minimizing total padded
    MXU work over ``histogram`` — exact DP over the observed sizes.

    ``include``: sizes forced into the bucket set (e.g. a bucket for
    the configured max batch even if unobserved).  ``quad_mats``: rows
    whose work scales quadratically with the size — pass the attention
    score/value matmuls when planning on the sequence-length axis.
    Deterministic for a fixed histogram regardless of input ordering.
    The DP's optimality argument survives the quadratic rows unchanged:
    a bucket's cost still only depends on the largest size it serves
    (cost_of is still monotone in the size), so restricting candidates
    to observed sizes remains WLOG.
    """
    hist = parse_histogram(histogram)
    mats = tuple(mats) if mats else DEFAULT_MATS
    quad_mats = tuple(quad_mats)
    k_max = max_buckets or default_max_buckets()
    sizes = sorted(set(hist) | {int(s) for s in include})
    weights = [hist.get(s, 0.0) for s in sizes]
    n = len(sizes)
    if n <= k_max:
        return BucketPlan(sizes, hist, mats, compute_dtype,
                          quad_mats=quad_mats)
    cost_of = [padded_flops(s, mats, compute_dtype, quad_mats)
               for s in sizes]
    # prefix weights: W[i] = sum(weights[:i])
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + w)
    INF = float("inf")
    # dp[i][k]: min cost covering sizes[:i] with exactly k buckets, the
    # k-th bucket boundary at sizes[i-1]
    dp = [[INF] * (k_max + 1) for _ in range(n + 1)]
    back = [[None] * (k_max + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for i in range(1, n + 1):
        for k in range(1, min(i, k_max) + 1):
            best, best_j = INF, None
            for j in range(k - 1, i):
                if dp[j][k - 1] == INF:
                    continue
                c = dp[j][k - 1] + cost_of[i - 1] * (prefix[i] - prefix[j])
                # strict < : ties keep the smallest j (widest last
                # bucket), a deterministic choice
                if c < best:
                    best, best_j = c, j
            dp[i][k] = best
            back[i][k] = best_j
    k_best = min(range(1, k_max + 1), key=lambda k: (dp[n][k], k))
    chosen = []
    i, k = n, k_best
    while k > 0:
        chosen.append(sizes[i - 1])
        i = back[i][k]
        k -= 1
    return BucketPlan(sorted(chosen), hist, mats, compute_dtype,
                      quad_mats=quad_mats)


def model_matmul_dims(symbol, input_shapes, batch=1):
    """Per-sample ``(m, k, n)`` product triples of ``symbol`` from the
    static analyzer's MXL-R cost rows (``analysis.roofline._op_costs``)
    at ``input_shapes`` (whose batch dim is ``batch``; ``m`` is divided
    back out to per-sample), as the JAX package's planner reads them.
    Returns ``None`` when the graph has no priceable product (the
    planner then prices occupancy alone)."""
    from ..analysis.core import AnalysisContext
    from ..analysis.roofline import _op_costs
    try:
        ctx = AnalysisContext(symbol, shapes=dict(input_shapes),
                              grad_req="null")
        rows = _op_costs(ctx)["rows"]
    except Exception:
        return None
    mats = []
    for r in rows:
        for m, k, nn in (r["mxu_dims"] or ()):
            per_sample = max(1, int(m) // max(1, int(batch)))
            mats.append((per_sample, int(k), int(nn)))
    return tuple(mats) or None
