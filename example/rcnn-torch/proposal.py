"""RPN Proposal layer as a custom python op, on the PyTorch/CUDA port
(``mxnet_tpu_torch``).

The copy of ``example/rcnn/proposal.py`` that differs only in the import
line.  Converts RPN class scores + bbox regression deltas into scored
region proposals: anchor enumeration, delta decoding, clipping,
min-size filtering, NMS, all numpy on the host through the Custom op's
bridge.
"""
import numpy as np

import mxnet_tpu_torch as mx


def generate_anchors(base_size=16, ratios=(0.5, 1, 2),
                     scales=(8, 16, 32)):
    """Standard RPN anchors around one cell."""
    base = np.array([1, 1, base_size, base_size], np.float32) - 1
    w, h = base[2] - base[0] + 1, base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    anchors = []
    size = w * h
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.array(anchors, np.float32)


def bbox_pred(boxes, deltas):
    """Decode regression deltas (dx,dy,dw,dh) onto boxes."""
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * (w - 1.0)
    cy = boxes[:, 1] + 0.5 * (h - 1.0)
    dx, dy, dw, dh = deltas.T
    dw, dh = np.clip(dw, None, 10.0), np.clip(dh, None, 10.0)
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = np.exp(dw) * w, np.exp(dh) * h
    out = np.stack([pcx - 0.5 * (pw - 1), pcy - 0.5 * (ph - 1),
                    pcx + 0.5 * (pw - 1), pcy + 0.5 * (ph - 1)], axis=1)
    return out


def clip_boxes(boxes, im_shape):
    boxes[:, 0::4] = np.clip(boxes[:, 0::4], 0, im_shape[1] - 1)
    boxes[:, 1::4] = np.clip(boxes[:, 1::4], 0, im_shape[0] - 1)
    boxes[:, 2::4] = np.clip(boxes[:, 2::4], 0, im_shape[1] - 1)
    boxes[:, 3::4] = np.clip(boxes[:, 3::4], 0, im_shape[0] - 1)
    return boxes


def nms(dets, thresh):
    """Greedy non-maximum suppression; dets (N,5) [x1,y1,x2,y2,score]."""
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


class ProposalOp(mx.operator.CustomOp):
    def __init__(self, feat_stride, scales, ratios, rpn_pre_nms_top_n,
                 rpn_post_nms_top_n, nms_thresh, min_size):
        super().__init__()
        self._feat_stride = feat_stride
        self._anchors = generate_anchors(base_size=feat_stride,
                                         scales=scales, ratios=ratios)
        self._num_anchors = self._anchors.shape[0]
        self._pre = rpn_pre_nms_top_n
        self._post = rpn_post_nms_top_n
        self._thresh = nms_thresh
        self._min_size = min_size

    def forward(self, is_train, req, in_data, out_data, aux):
        scores = in_data[0][:, self._num_anchors:]  # fg scores
        bbox_deltas = in_data[1]
        im_info = in_data[2][0]

        H, W = scores.shape[-2:]
        sx = np.arange(0, W) * self._feat_stride
        sy = np.arange(0, H) * self._feat_stride
        sx, sy = np.meshgrid(sx, sy)
        shifts = np.stack([sx.ravel(), sy.ravel(),
                           sx.ravel(), sy.ravel()], axis=1)
        A, K = self._num_anchors, shifts.shape[0]
        anchors = (self._anchors.reshape(1, A, 4)
                   + shifts.reshape(K, 1, 4)).reshape(K * A, 4)

        deltas = bbox_deltas[0].transpose(1, 2, 0).reshape(-1, 4)
        scr = scores[0].transpose(1, 2, 0).reshape(-1, 1)

        proposals = bbox_pred(anchors, deltas)
        proposals = clip_boxes(proposals, im_info[:2])
        ws = proposals[:, 2] - proposals[:, 0] + 1
        hs = proposals[:, 3] - proposals[:, 1] + 1
        min_size = self._min_size * im_info[2]
        keep = np.where((ws >= min_size) & (hs >= min_size))[0]
        proposals, scr = proposals[keep], scr[keep]

        order = scr.ravel().argsort()[::-1][:self._pre]
        proposals, scr = proposals[order], scr[order]
        dets = np.hstack([proposals, scr]).astype(np.float32)
        keep = nms(dets, self._thresh)[:self._post]
        pad = self._post - len(keep)
        rois = np.zeros((self._post, 5), np.float32)
        rois[:len(keep), 1:] = proposals[keep]
        if pad > 0 and len(keep) > 0:  # pad by repeating the best roi
            rois[len(keep):, 1:] = proposals[keep[0]]
        self.assign(out_data[0], req[0], rois)
        if len(out_data) > 1:
            s = np.zeros((self._post, 1), np.float32)
            s[:len(keep), 0] = scr.ravel()[keep]
            self.assign(out_data[1], req[1], s)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        for g in in_grad:
            g[...] = 0.0


@mx.operator.register("proposal")
class ProposalProp(mx.operator.CustomOpProp):
    def __init__(self, feat_stride="16", scales="(8, 16, 32)",
                 ratios="(0.5, 1, 2)", rpn_pre_nms_top_n="6000",
                 rpn_post_nms_top_n="300", nms_thresh="0.7",
                 min_size="16", output_score="False"):
        super().__init__(need_top_grad=False)
        import ast
        self._feat_stride = int(feat_stride)
        self._scales = tuple(ast.literal_eval(scales))
        self._ratios = tuple(ast.literal_eval(ratios))
        self._pre = int(rpn_pre_nms_top_n)
        self._post = int(rpn_post_nms_top_n)
        self._thresh = float(nms_thresh)
        self._min_size = int(min_size)
        self._output_score = output_score in ("True", "true", True)

    def list_arguments(self):
        return ["cls_prob", "bbox_pred", "im_info"]

    def list_outputs(self):
        return ["output", "score"] if self._output_score else ["output"]

    def infer_shape(self, in_shape):
        out = [[self._post, 5]]
        if self._output_score:
            out.append([self._post, 1])
        return in_shape, out, []

    def create_operator(self, ctx, shapes, dtypes):
        return ProposalOp(self._feat_stride, self._scales, self._ratios,
                          self._pre, self._post, self._thresh,
                          self._min_size)
