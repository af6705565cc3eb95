"""Faster R-CNN symbol: shared conv backbone + RPN + ROI head, on the
PyTorch/CUDA port (``mxnet_tpu_torch``).

The copy of ``example/rcnn/symbol.py`` that differs only in the import
lines: a compact VGG-style backbone feeding (a) the RPN losses and (b)
ROIPooling + classification/bbox heads from the Proposal custom op.
"""
import mxnet_tpu_torch as mx  # noqa: F401
from mxnet_tpu_torch import symbol as sym

import proposal  # noqa: F401  (registers the 'proposal' custom op)


def conv_backbone(data, small=True):
    """A conv stack with stride 16, VGG-ish."""
    cfg = [(32, 2), (64, 2), (128, 2), (128, 2)] if small else \
        [(64, 2), (128, 2), (256, 2), (512, 2)]
    x = data
    for i, (f, pool) in enumerate(cfg):
        x = sym.Convolution(data=x, num_filter=f, kernel=(3, 3),
                            pad=(1, 1), name="conv%d" % (i + 1))
        x = sym.Activation(data=x, act_type="relu")
        x = sym.Pooling(data=x, kernel=(pool, pool), stride=(pool, pool),
                        pool_type="max")
    return x


def get_rcnn_symbol(num_classes=4, num_anchors=9, rpn_post_nms_top_n=16,
                    feat_stride=16):
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    rpn_label = sym.Variable("rpn_label")
    label = sym.Variable("label")

    conv_feat = conv_backbone(data)

    # RPN
    rpn_conv = sym.Convolution(data=conv_feat, kernel=(3, 3), pad=(1, 1),
                               num_filter=128, name="rpn_conv_3x3")
    rpn_relu = sym.Activation(data=rpn_conv, act_type="relu")
    rpn_cls_score = sym.Convolution(data=rpn_relu, kernel=(1, 1),
                                    num_filter=2 * num_anchors,
                                    name="rpn_cls_score")
    rpn_bbox_pred = sym.Convolution(data=rpn_relu, kernel=(1, 1),
                                    num_filter=4 * num_anchors,
                                    name="rpn_bbox_pred")

    # RPN classification loss (anchor labels come from the data layer);
    # reshape (N,2A,H,W) -> (N,2,A*H,W) as the reference does
    rpn_cls_reshape = sym.Reshape(data=rpn_cls_score,
                                  shape=(0, 2, -1, 0),
                                  name="rpn_cls_reshape")
    rpn_cls_prob = sym.SoftmaxOutput(data=rpn_cls_reshape, label=rpn_label,
                                     multi_output=True, use_ignore=True,
                                     ignore_label=-1, name="rpn_cls_prob")

    # Proposal custom op consumes softmax probabilities reshaped back
    rpn_cls_act = sym.SoftmaxActivation(data=rpn_cls_reshape,
                                        mode="channel",
                                        name="rpn_cls_act")
    rpn_cls_act_reshape = sym.Reshape(data=rpn_cls_act,
                                      shape=(0, 2 * num_anchors, -1, 0),
                                      name="rpn_cls_act_reshape")
    rois = sym.Custom(cls_prob=sym.BlockGrad(rpn_cls_act_reshape),
                      bbox_pred=sym.BlockGrad(rpn_bbox_pred),
                      im_info=im_info,
                      op_type="proposal", feat_stride=str(feat_stride),
                      rpn_post_nms_top_n=str(rpn_post_nms_top_n),
                      rpn_pre_nms_top_n=str(4 * rpn_post_nms_top_n),
                      name="rois")

    # ROI head
    pool5 = sym.ROIPooling(data=conv_feat, rois=rois, pooled_size=(7, 7),
                           spatial_scale=1.0 / feat_stride, name="roi_pool5")
    flat = sym.Flatten(data=pool5)
    fc6 = sym.FullyConnected(data=flat, num_hidden=256, name="fc6")
    relu6 = sym.Activation(data=fc6, act_type="relu")
    cls_score = sym.FullyConnected(data=relu6, num_hidden=num_classes,
                                   name="cls_score")
    cls_prob = sym.SoftmaxOutput(data=cls_score, label=label,
                                 name="cls_prob")
    bbox_pred_s = sym.FullyConnected(data=relu6,
                                     num_hidden=4 * num_classes,
                                     name="bbox_pred")

    return sym.Group([rpn_cls_prob, cls_prob, bbox_pred_s, rois])
