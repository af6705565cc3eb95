"""Vision operators: ROIPooling, SpatialTransformer, Correlation.

The port of ``mxnet_tpu/ops/vision.py`` (the reference's
roi_pooling-inl.h, spatial_transformer-inl.h, correlation-inl.h).

``ROIPooling`` is a ``torch.autograd.Function``.  Its forward gathers each
roi's bins as windows of the largest bin's extent (masked past each
bin's own end) one row of bins at a time, and keeps nothing for the
backward but its inputs and its output.  Its backward gives each bin's
gradient to every position of the bin equal to the bin's maximum,
divided by their count: the JAX package's ``jnp.max`` over the masked
window splits a tie evenly, where the reference's argmax gives it all to
the first.  Ties are common (a bin of a feature map after ReLU and max
pooling is often all zeros), and a max taken over W and then over H
splits them differently again, so the backward counts the ties of the
whole bin.  The shares are summed in float64 (float32 for narrower
data) and rounded once.
"""
from __future__ import annotations

import math as _math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..dparam import Field, ParamStruct
from .registry import OperatorProperty, register_op, require_known


# ----------------------------------------------------------------------
# ROIPooling
# ----------------------------------------------------------------------
class _ROIPoolingParam(ParamStruct):
    pooled_size = Field(tuple, required=True, length=2)
    spatial_scale = Field(float, required=True, lower=0.0, upper=1.0)


def _roi_bins(rois, ph, pw, scale, H, W):
    """Per roi: the batch index (R,), and the bins' integer starts and
    (exclusive) ends, rows (R, ph) and columns (R, pw).  The roi corners
    are ``round(coordinate * scale)`` (half to even, as ``jnp.round``),
    the ends inclusive, the edges integer floor and ceil divisions of the
    roi's extent (never a float division: see the JAX package)."""
    batch = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).to(torch.int64)
                      for i in range(1, 5))
    roi_h = torch.clamp(y2 - y1 + 1, min=1)
    roi_w = torch.clamp(x2 - x1 + 1, min=1)

    def edges(n, extent, start, size):
        i = torch.arange(n, device=rois.device)
        lo = torch.div(i[None] * extent[:, None], n, rounding_mode="floor")
        hi = -torch.div(-(i[None] + 1) * extent[:, None], n,
                        rounding_mode="floor")
        return (torch.clamp(lo + start[:, None], 0, size),
                torch.clamp(hi + start[:, None], 0, size))

    hs, he = edges(ph, roi_h, y1, H)
    ws, we = edges(pw, roi_w, x1, W)
    return batch, hs, he, ws, we


def _row_windows(data_nhwc, batch, hs, he, ws, we, i, kh, kw):
    """Row ``i`` of every roi's bins as windows: the values (R, kh, pw,
    kw, C), the mask of the positions inside each bin (R, kh, pw, kw),
    and their flat indices into the (N*H*W) positions (R, kh, pw, kw)."""
    N, H, W, C = data_nhwc.shape
    dev = data_nhwc.device
    hidx = hs[:, i, None] + torch.arange(kh, device=dev)        # (R, kh)
    widx = ws[:, :, None] + torch.arange(kw, device=dev)        # (R, pw, kw)
    hin = hidx < he[:, i, None]
    win = widx < we[:, :, None]
    mask = hin[:, :, None, None] & win[:, None, :, :]
    flat = ((batch[:, None, None, None] * H
             + hidx.clamp(max=H - 1)[:, :, None, None]) * W
            + widx.clamp(max=W - 1)[:, None, :, :])
    vals = data_nhwc.reshape(N * H * W, C)[flat]
    return vals, mask, flat


def _window_extent(hs, he, ws, we):
    kh = int((he - hs).max().clamp(min=1)) if hs.numel() else 1
    kw = int((we - ws).max().clamp(min=1)) if ws.numel() else 1
    return kh, kw


class _ROIPoolingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, rois, ph, pw, scale):
        N, C, H, W = data.shape
        R = rois.shape[0]
        bins = _roi_bins(rois.detach(), ph, pw, scale, H, W)
        kh, kw = _window_extent(*bins[1:])
        x = data.detach().permute(0, 2, 3, 1).contiguous()      # (N,H,W,C)
        out = data.new_zeros((R, C, ph, pw))
        neg = torch.tensor(-float("inf"), dtype=data.dtype,
                           device=data.device)
        for i in range(ph):
            vals, mask, _flat = _row_windows(x, *bins, i, kh, kw)
            m = torch.where(mask[..., None], vals, neg).amax(dim=(1, 3))
            empty = ~mask.any(dim=(1, 3))                       # (R, pw)
            m = torch.where(empty[..., None], torch.zeros_like(m), m)
            out[:, :, i, :] = m.permute(0, 2, 1)
        ctx.save_for_backward(data, rois, out)
        ctx.pooled = (ph, pw, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        data, rois, out = ctx.saved_tensors
        ph, pw, scale = ctx.pooled
        grad_data = None
        if ctx.needs_input_grad[0]:
            N, C, H, W = data.shape
            bins = _roi_bins(rois.detach(), ph, pw, scale, H, W)
            kh, kw = _window_extent(*bins[1:])
            x = data.detach().permute(0, 2, 3, 1).contiguous()
            # the shares summed in float64, rounded once: the card's
            # atomic adds and the CPU's serial ones then agree to the
            # rounding of the result, whatever their order
            acc = torch.float64 if g.dtype in (torch.float32,
                                               torch.float64) \
                else torch.float32
            gx = torch.zeros(N * H * W, C, dtype=acc, device=g.device)
            for i in range(ph):
                vals, mask, flat = _row_windows(x, *bins, i, kh, kw)
                m = out[:, :, i, :].permute(0, 2, 1)            # (R, pw, C)
                tie = mask[..., None] & (vals == m[:, None, :, None, :])
                count = tie.sum(dim=(1, 3))                     # (R, pw, C)
                share = g[:, :, i, :].permute(0, 2, 1) / count.clamp(min=1)
                contrib = tie.to(g.dtype) * share[:, None, :, None, :]
                gx.index_add_(0, flat.reshape(-1),
                              contrib.reshape(-1, C).to(acc))
            grad_data = gx.to(g.dtype).reshape(N, H, W, C) \
                .permute(0, 3, 1, 2)
        # the corners are rounded to integers: no gradient reaches rois
        return grad_data, None, None, None, None


@register_op("ROIPooling")
class ROIPooling(OperatorProperty):
    """roi_pooling-inl.h: max-pool each roi into a fixed (ph, pw) grid.

    rois are (num_rois, 5) rows [batch_index, x1, y1, x2, y2] in image
    coordinates; scaled by spatial_scale and rounded, inclusive ends
    (roi width = x2 - x1 + 1), empty bins produce 0.
    """
    param_cls = _ROIPoolingParam

    def list_arguments(self):
        return ["data", "rois"]

    def infer_shape(self, in_shapes):
        data, rois = require_known("ROIPooling", in_shapes,
                                   self.list_arguments())
        if len(data) != 4 or len(rois) != 2 or rois[1] != 5:
            raise MXNetError("ROIPooling: data (N,C,H,W), rois (R,5)")
        ph, pw = self.param.pooled_size
        out = (rois[0], data[1], ph, pw)
        return [data, rois], [out], []

    def forward(self, inputs, aux, is_train, rng):
        data, rois = inputs
        ph, pw = (int(v) for v in self.param.pooled_size)
        return [_ROIPoolingFn.apply(data, rois, ph, pw,
                                    float(self.param.spatial_scale))], None


# ----------------------------------------------------------------------
# SpatialTransformer
# ----------------------------------------------------------------------
class _SpatialTransformerParam(ParamStruct):
    target_shape = Field(tuple, default=(0, 0), length=2)
    transform_type = Field(str, required=True, enum=("affine",))
    sampler_type = Field(str, required=True, enum=("bilinear",))


@register_op("SpatialTransformer")
class SpatialTransformer(OperatorProperty):
    """spatial_transformer-inl.h: affine grid + bilinear sampling.

    loc is (N, 6) affine params; target grid in [-1, 1] normalized coords
    (spatial_transformer-inl.h:76-79); out-of-bounds samples read 0.
    """
    param_cls = _SpatialTransformerParam

    def list_arguments(self):
        return ["data", "loc"]

    def infer_shape(self, in_shapes):
        data = in_shapes[0]
        if data is None:
            require_known("SpatialTransformer", in_shapes[:1], ["data"])
        if len(data) != 4:
            raise MXNetError("SpatialTransformer: data must be (N,C,H,W)")
        th, tw = self.param.target_shape
        if th == 0:
            th, tw = data[2], data[3]
        out = (data[0], data[1], th, tw)
        return [data, (data[0], 6)], [out], []

    def forward(self, inputs, aux, is_train, rng):
        data, loc = inputs
        N, C, H, W = data.shape
        th, tw = self.param.target_shape
        if th == 0:
            th, tw = H, W
        dt, dev = data.dtype, data.device

        def axis(n):
            if n > 1:
                return -1.0 + torch.arange(n, dtype=dt, device=dev) \
                    * 2.0 / (n - 1)
            return torch.zeros((1,), dtype=dt, device=dev)
        xs, ys = axis(tw), axis(th)
        gx = xs[None, :].expand(th, tw)
        gy = ys[:, None].expand(th, tw)
        grid = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)
        src = torch.einsum("nij,jk->nik", loc.reshape(N, 2, 3), grid)
        # normalized -> source pixel coords
        x_src = (src[:, 0] + 1.0) * (W - 1) / 2.0
        y_src = (src[:, 1] + 1.0) * (H - 1) / 2.0
        x0 = torch.floor(x_src)
        y0 = torch.floor(y_src)
        wx = (x_src - x0)[:, None]
        wy = (y_src - y0)[:, None]
        flat = data.reshape(N, C, H * W)

        def sample(yy, xx):
            """(N, C, P) values at integer coords (N, P); 0 outside."""
            valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            yc = torch.clamp(yy, 0, H - 1).to(torch.int64)
            xc = torch.clamp(xx, 0, W - 1).to(torch.int64)
            idx = (yc * W + xc)[:, None, :].expand(N, C, yc.shape[1])
            v = torch.gather(flat, 2, idx)
            return torch.where(valid[:, None], v, torch.zeros_like(v))

        v00 = sample(y0, x0)
        v01 = sample(y0, x0 + 1)
        v10 = sample(y0 + 1, x0)
        v11 = sample(y0 + 1, x0 + 1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        out = top * (1 - wy) + bot * wy
        return [out.reshape(N, C, th, tw)], None


# ----------------------------------------------------------------------
# Correlation
# ----------------------------------------------------------------------
class _CorrelationParam(ParamStruct):
    kernel_size = Field(int, default=1)
    max_displacement = Field(int, default=1)
    stride1 = Field(int, default=1)
    stride2 = Field(int, default=1)
    pad_size = Field(int, default=0)
    is_multiply = Field(bool, default=True)


@register_op("Correlation")
class Correlation(OperatorProperty):
    """correlation-inl.h:78-97 / correlation.cc CorrelationForward.

    FlowNet cost volume: for each displacement (s2p, s2o) in the
    neighborhood grid, average data1·shift(data2) (or |diff|) over a
    kernel window and channels, as a fixed stack of shifted products.
    """
    param_cls = _CorrelationParam

    def list_arguments(self):
        return ["data1", "data2"]

    def _geom(self, H, W):
        p = self.param
        kr = (p.kernel_size - 1) // 2
        border = p.max_displacement + kr
        ph, pw = H + 2 * p.pad_size, W + 2 * p.pad_size
        top_h = int(_math.ceil(float(ph - border * 2) / p.stride1))
        top_w = int(_math.ceil(float(pw - border * 2) / p.stride1))
        ngr = p.max_displacement // p.stride2
        ngw = 2 * ngr + 1
        return kr, border, top_h, top_w, ngr, ngw

    def infer_shape(self, in_shapes):
        d1, d2 = require_known("Correlation", in_shapes,
                               self.list_arguments())
        if d1 != d2:
            raise MXNetError("Correlation: data1/data2 shapes must match")
        if len(d1) != 4:
            raise MXNetError("Correlation: data must be (N,C,H,W)")
        _, _, top_h, top_w, _, ngw = self._geom(d1[2], d1[3])
        if top_h < 1 or top_w < 1:
            raise MXNetError("Correlation: displacement/kernel too large "
                             "for input size")
        out = (d1[0], ngw * ngw, top_h, top_w)
        return [d1, d2], [out], []

    def forward(self, inputs, aux, is_train, rng):
        p = self.param
        data1, data2 = inputs
        N, C, H, W = data1.shape
        kr, border, top_h, top_w, ngr, ngw = self._geom(H, W)
        pad = (p.pad_size,) * 4
        t1 = F.pad(data1, pad)
        t2 = F.pad(data2, pad)
        sumelems = p.kernel_size * p.kernel_size * C
        sh = (top_h - 1) * p.stride1 + 1
        sw = (top_w - 1) * p.stride1 + 1
        outs = []
        for ti in range(ngw * ngw):
            s2o = (ti % ngw - ngr) * p.stride2
            s2p = (ti // ngw - ngr) * p.stride2
            prod = 0.0
            for h in range(p.kernel_size):
                for w in range(p.kernel_size):
                    y1 = p.max_displacement + h
                    x1 = p.max_displacement + w
                    a = t1[:, :, y1:y1 + sh:p.stride1, x1:x1 + sw:p.stride1]
                    b = t2[:, :, y1 + s2p:y1 + s2p + sh:p.stride1,
                           x1 + s2o:x1 + s2o + sw:p.stride1]
                    if p.is_multiply:
                        prod = prod + a * b
                    else:
                        prod = prod + torch.abs(a - b)
            outs.append(torch.sum(prod, dim=1) / sumelems)      # (N, th, tw)
        return [torch.stack(outs, dim=1)], None
