"""ResNet v2 (pre-activation) 18/34/50/101/152/200.

A copy of ``mxnet_tpu/models/resnet.py`` (itself after the reference's
``example/image-classification/symbols/resnet.py``, the BASELINE
``train_imagenet`` configuration): the same graph, names and layouts, so
parameters and checkpoints move between the two packages by name.  A
cifar stem (3x3 convolution) at height <= 32, the imagenet stem (7x7
stride 2, BatchNorm, ReLU, 3x3 max pooling) above.
"""
from .. import symbol as sym
from ..base import MXNetError

bn_mom = 0.9
eps = 2e-5


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True):
    """A pre-activation residual unit (BN-ReLU-Conv x3 bottleneck)."""
    if bottle_neck:
        bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=eps,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(data=act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=eps,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=eps,
                            momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(data=bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(data=act3, num_filter=num_filter,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    else:
        bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=eps,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(data=act1, num_filter=num_filter,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=eps,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=num_filter,
                                kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv2 + shortcut


_UNITS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
    200: ([3, 24, 36, 3], True),
}


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               mirror_blocks=False):
    """The ResNet symbol ending in SoftmaxOutput ``softmax``.
    ``mirror_blocks=True`` tags every op inside each residual unit with
    ``force_mirroring`` and a per-unit ``mirror_stage`` (block-granular
    recompute in the JAX package); the port's executor does not
    recompute yet and refuses such a graph."""
    if num_layers not in _UNITS:
        raise MXNetError("resnet: num_layers must be one of %s" % sorted(_UNITS))
    units, bottle_neck = _UNITS[num_layers]
    filter_list = [64, 256, 512, 1024, 2048] if bottle_neck \
        else [64, 64, 128, 256, 512]
    nchannel, height, _ = image_shape

    from ..attribute import mirror_scope

    def unit_scope(stage_name):
        return mirror_scope(stage_name, enabled=mirror_blocks)

    data = sym.Variable("data")
    data = sym.BatchNorm(data=data, fix_gamma=True, eps=eps,
                         momentum=bn_mom, name="bn_data")
    if height <= 32:  # cifar-style stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:  # imagenet stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=eps,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max")

    for i, n in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        name = "stage%d_unit%d" % (i + 1, 1)
        with unit_scope(name):
            body = residual_unit(body, filter_list[i + 1], stride, False,
                                 name=name, bottle_neck=bottle_neck)
        for j in range(n - 1):
            name = "stage%d_unit%d" % (i + 1, j + 2)
            with unit_scope(name):
                body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                     name=name, bottle_neck=bottle_neck)

    bn1 = sym.BatchNorm(data=body, fix_gamma=False, eps=eps,
                        momentum=bn_mom, name="bn1")
    relu1 = sym.Activation(data=bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")
