"""Vision model zoo beyond ResNet: port of paddle_tpu/models/vision_zoo.py.

Reference: ``python/paddle/vision/models/`` (vgg.py, mobilenetv1.py,
mobilenetv2.py, mobilenetv3.py, alexnet.py, squeezenet.py, densenet.py,
shufflenetv2.py, googlenet.py, inceptionv3.py) — the same layers in the
same order, so a reference ``state_dict()`` loads key for key. NCHW
convolutions run cuDNN's kernels; nothing is fused by hand.

``pretrained=True`` is accepted but raises: this image has zero egress, so
weight downloads are impossible; use paddle.save/load checkpoints instead.
"""
from __future__ import annotations

from .. import nn
from ..ops.manipulation import concat, flatten, reshape, transpose, split


def _no_pretrained(flag):
    if flag:
        raise ValueError(
            "pretrained weights cannot be downloaded in this environment; "
            "load a local checkpoint with paddle.load instead")


# ===========================================================================
# VGG (reference: vision/models/vgg.py)
# ===========================================================================
_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg_features(cfg, batch_norm):
    layers, c_in = [], 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, stride=2))
            continue
        layers.append(nn.Conv2D(c_in, v, 3, padding=1))
        if batch_norm:
            layers.append(nn.BatchNorm2D(v))
        layers.append(nn.ReLU())
        c_in = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, **kw):
    _no_pretrained(pretrained)
    return VGG(_vgg_features(_VGG_CFGS[cfg], batch_norm), **kw)


def vgg11(pretrained=False, batch_norm=False, **kw):
    return _vgg("A", batch_norm, pretrained, **kw)


def vgg13(pretrained=False, batch_norm=False, **kw):
    return _vgg("B", batch_norm, pretrained, **kw)


def vgg16(pretrained=False, batch_norm=False, **kw):
    return _vgg("D", batch_norm, pretrained, **kw)


def vgg19(pretrained=False, batch_norm=False, **kw):
    return _vgg("E", batch_norm, pretrained, **kw)


# ===========================================================================
# AlexNet (reference: vision/models/alexnet.py)
# ===========================================================================
class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def alexnet(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return AlexNet(**kw)


# ===========================================================================
# MobileNet V1 (reference: vision/models/mobilenetv1.py)
# ===========================================================================
def _conv_bn(c_in, c_out, k, stride=1, padding=0, groups=1,
             act=nn.ReLU):
    layers = [nn.Conv2D(c_in, c_out, k, stride=stride, padding=padding,
                        groups=groups, bias_attr=False),
              nn.BatchNorm2D(c_out)]
    if act is not None:
        layers.append(act())
    return nn.Sequential(*layers)


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] \
            + [(512, 512, 1)] * 5 + [(512, 1024, 2), (1024, 1024, 1)]
        blocks = [_conv_bn(3, c(32), 3, stride=2, padding=1)]
        for cin, cout, s in cfg:
            blocks.append(_conv_bn(c(cin), c(cin), 3, stride=s, padding=1,
                                   groups=c(cin)))       # depthwise
            blocks.append(_conv_bn(c(cin), c(cout), 1))  # pointwise
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kw)


# ===========================================================================
# MobileNet V2 (reference: vision/models/mobilenetv2.py)
# ===========================================================================
class InvertedResidual(nn.Layer):
    def __init__(self, c_in, c_out, stride, expand_ratio):
        super().__init__()
        hidden = int(round(c_in * expand_ratio))
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(c_in, hidden, 1, act=nn.ReLU6))
        layers += [
            _conv_bn(hidden, hidden, 3, stride=stride, padding=1,
                     groups=hidden, act=nn.ReLU6),
            _conv_bn(hidden, c_out, 1, act=None),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

        def c(ch):
            return max(8, int(ch * scale + 4) // 8 * 8)

        c_in = c(32)
        features = [_conv_bn(3, c_in, 3, stride=2, padding=1, act=nn.ReLU6)]
        for t, ch, n, s in cfg:
            c_out = c(ch)
            for i in range(n):
                features.append(InvertedResidual(
                    c_in, c_out, s if i == 0 else 1, t))
                c_in = c_out
        self.last_channel = c(1280) if scale > 1.0 else 1280
        features.append(_conv_bn(c_in, self.last_channel, 1, act=nn.ReLU6))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kw)


# ===========================================================================
# MobileNet V3 (reference: vision/models/mobilenetv3.py)
# ===========================================================================
class SqueezeExcite(nn.Layer):
    def __init__(self, ch, squeeze=4):
        super().__init__()
        mid = max(1, ch // squeeze)
        self.pool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc1 = nn.Conv2D(ch, mid, 1)
        self.fc2 = nn.Conv2D(mid, ch, 1)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _MBV3Block(nn.Layer):
    def __init__(self, c_in, mid, c_out, k, stride, se, act):
        super().__init__()
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if mid != c_in:
            layers.append(_conv_bn(c_in, mid, 1, act=act))
        layers.append(_conv_bn(mid, mid, k, stride=stride, padding=k // 2,
                               groups=mid, act=act))
        if se:
            layers.append(SqueezeExcite(mid))
        layers.append(_conv_bn(mid, c_out, 1, act=None))
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


_MBV3_LARGE = [
    # k, mid, out, se, act, stride
    (3, 16, 16, False, nn.ReLU, 1), (3, 64, 24, False, nn.ReLU, 2),
    (3, 72, 24, False, nn.ReLU, 1), (5, 72, 40, True, nn.ReLU, 2),
    (5, 120, 40, True, nn.ReLU, 1), (5, 120, 40, True, nn.ReLU, 1),
    (3, 240, 80, False, nn.Hardswish, 2), (3, 200, 80, False, nn.Hardswish, 1),
    (3, 184, 80, False, nn.Hardswish, 1), (3, 184, 80, False, nn.Hardswish, 1),
    (3, 480, 112, True, nn.Hardswish, 1), (3, 672, 112, True, nn.Hardswish, 1),
    (5, 672, 160, True, nn.Hardswish, 2), (5, 960, 160, True, nn.Hardswish, 1),
    (5, 960, 160, True, nn.Hardswish, 1),
]
_MBV3_SMALL = [
    (3, 16, 16, True, nn.ReLU, 2), (3, 72, 24, False, nn.ReLU, 2),
    (3, 88, 24, False, nn.ReLU, 1), (5, 96, 40, True, nn.Hardswish, 2),
    (5, 240, 40, True, nn.Hardswish, 1), (5, 240, 40, True, nn.Hardswish, 1),
    (5, 120, 48, True, nn.Hardswish, 1), (5, 144, 48, True, nn.Hardswish, 1),
    (5, 288, 96, True, nn.Hardswish, 2), (5, 576, 96, True, nn.Hardswish, 1),
    (5, 576, 96, True, nn.Hardswish, 1),
]


class MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_ch, num_classes=1000, scale=1.0,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(8, int(ch * scale + 4) // 8 * 8)

        c_in = c(16)
        blocks = [_conv_bn(3, c_in, 3, stride=2, padding=1,
                           act=nn.Hardswish)]
        for k, mid, out, se, act, s in cfg:
            blocks.append(_MBV3Block(c_in, c(mid), c(out), k, s, se, act))
            c_in = c(out)
        last_conv = c(cfg[-1][1])
        blocks.append(_conv_bn(c_in, last_conv, 1, act=nn.Hardswish))
        self.features = nn.Sequential(*blocks)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_ch), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Large(MobileNetV3):
    """Reference: vision/models/mobilenetv3.py MobileNetV3Large — the
    ONE place the (large cfg, 1280 head) pairing lives."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MBV3_LARGE, 1280, num_classes=num_classes,
                         scale=scale, with_pool=with_pool)


class MobileNetV3Small(MobileNetV3):
    """Reference: vision/models/mobilenetv3.py MobileNetV3Small."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MBV3_SMALL, 1024, num_classes=num_classes,
                         scale=scale, with_pool=with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV3Large(scale=scale, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    _no_pretrained(pretrained)
    return MobileNetV3Small(scale=scale, **kw)


# ===========================================================================
# SqueezeNet (reference: vision/models/squeezenet.py)
# ===========================================================================
class Fire(nn.Layer):
    def __init__(self, c_in, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Conv2D(c_in, squeeze, 1)
        self.e1 = nn.Conv2D(squeeze, e1, 1)
        self.e3 = nn.Conv2D(squeeze, e3, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return concat([self.relu(self.e1(s)), self.relu(self.e3(s))],
                      axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.1", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128), nn.MaxPool2D(3, stride=2),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2), Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU())
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
            x = flatten(x, 1)
        return x


def squeezenet1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kw)


# ===========================================================================
# DenseNet (reference: vision/models/densenet.py)
# ===========================================================================
class _DenseLayer(nn.Layer):
    def __init__(self, c_in, growth, bn_size):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(c_in)
        self.conv1 = nn.Conv2D(c_in, bn_size * growth, 1, bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False)
        self.relu = nn.ReLU()

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        return concat([x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.norm = nn.BatchNorm2D(c_in)
        self.conv = nn.Conv2D(c_in, c_out, 1, bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


_DENSE_CFG = {121: (64, 32, [6, 12, 24, 16]),
              161: (96, 48, [6, 12, 36, 24]),
              169: (64, 32, [6, 12, 32, 32]),
              201: (64, 32, [6, 12, 48, 32]),
              264: (64, 32, [6, 12, 64, 48])}


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, num_classes=1000,
                 with_pool=True):
        super().__init__()
        init_ch, growth, cfg = _DENSE_CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [nn.Conv2D(3, init_ch, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(init_ch), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        ch = init_ch
        for i, n in enumerate(cfg):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size))
                ch += growth
            if i != len(cfg) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def densenet121(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(121, **kw)


def densenet161(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(161, **kw)


def densenet169(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(169, **kw)


def densenet201(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(201, **kw)


def densenet264(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return DenseNet(264, **kw)


# ===========================================================================
# ShuffleNet V2 (reference: vision/models/shufflenetv2.py)
# ===========================================================================
def _channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = reshape(x, [b, groups, c // groups, h, w])
    x = transpose(x, [0, 2, 1, 3, 4])
    return reshape(x, [b, c, h, w])


class _ShuffleUnit(nn.Layer):
    def __init__(self, c_in, c_out, stride, act=nn.ReLU):
        super().__init__()
        self.stride = stride
        branch = c_out // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                _conv_bn(branch, branch, 1, act=act),
                _conv_bn(branch, branch, 3, stride=1, padding=1,
                         groups=branch, act=None),
                _conv_bn(branch, branch, 1, act=act))
        else:
            self.branch1 = nn.Sequential(
                _conv_bn(c_in, c_in, 3, stride=stride, padding=1,
                         groups=c_in, act=None),
                _conv_bn(c_in, branch, 1, act=act))
            self.branch2 = nn.Sequential(
                _conv_bn(c_in, branch, 1, act=act),
                _conv_bn(branch, branch, 3, stride=stride, padding=1,
                         groups=branch, act=None),
                _conv_bn(branch, branch, 1, act=act))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = split(x, 2, axis=1)
            out = concat([x1, self.branch2(x2)], axis=1)
        else:
            out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


_SHUFFLE_CH = {0.25: [24, 24, 48, 96, 512], 0.33: [24, 32, 64, 128, 512],
               0.5: [24, 48, 96, 192, 1024], 1.0: [24, 116, 232, 464, 1024],
               1.5: [24, 176, 352, 704, 1024], 2.0: [24, 244, 488, 976, 2048]}


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 act=nn.ReLU):
        super().__init__()
        ch = _SHUFFLE_CH[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = _conv_bn(3, ch[0], 3, stride=2, padding=1, act=act)
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        c_in = ch[0]
        for stage_idx, repeat in enumerate([4, 8, 4]):
            c_out = ch[stage_idx + 1]
            stages.append(_ShuffleUnit(c_in, c_out, 2, act=act))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(c_out, c_out, 1, act=act))
            c_in = c_out
        self.stages = nn.Sequential(*stages)
        self.conv_last = _conv_bn(c_in, ch[-1], 1, act=act)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(ch[-1], num_classes)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.stages(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(0.25, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(0.5, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(1.0, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(2.0, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return ShuffleNetV2(0.33, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    """Reference: shufflenet_v2_swish — the x1.0 topology with swish
    activations throughout (every unit + stem + head)."""
    _no_pretrained(pretrained)
    return ShuffleNetV2(1.0, act=nn.Swish, **kw)


# ===========================================================================
# GoogLeNet / Inception v1 (reference: vision/models/googlenet.py —
# Inception modules + two auxiliary classifier heads; forward returns
# (out, aux1, aux2) like the reference)
# ===========================================================================
class _Inception(nn.Layer):
    def __init__(self, c_in, c1, c3r, c3, c5r, c5, pp):
        super().__init__()
        self.b1 = _conv_bn(c_in, c1, 1)
        self.b2 = nn.Sequential(_conv_bn(c_in, c3r, 1),
                                _conv_bn(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_conv_bn(c_in, c5r, 1),
                                _conv_bn(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _conv_bn(c_in, pp, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                      axis=1)


class _GoogLeNetAux(nn.Layer):
    def __init__(self, c_in, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D((4, 4))
        self.conv = _conv_bn(c_in, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = nn.functional.relu(self.fc1(flatten(x, 1)))
        return self.fc2(x)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _conv_bn(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, stride=2, padding=1),
            _conv_bn(64, 64, 1),
            _conv_bn(64, 192, 3, padding=1),
            nn.MaxPool2D(3, stride=2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _GoogLeNetAux(512, num_classes)
            self.aux2 = _GoogLeNetAux(528, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x, aux1, aux2


def googlenet(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return GoogLeNet(**kw)


# ===========================================================================
# Inception v3 (reference: vision/models/inceptionv3.py — A/B/C/D/E
# blocks over a 299x299 stem)
# ===========================================================================
class _IncA(nn.Layer):
    def __init__(self, c_in, pool_ch):
        super().__init__()
        self.b1 = _conv_bn(c_in, 64, 1)
        self.b5 = nn.Sequential(_conv_bn(c_in, 48, 1),
                                _conv_bn(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_conv_bn(c_in, 64, 1),
                                _conv_bn(64, 96, 3, padding=1),
                                _conv_bn(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _conv_bn(c_in, pool_ch, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                      axis=1)


class _IncB(nn.Layer):
    """Grid reduction 35 -> 17."""

    def __init__(self, c_in):
        super().__init__()
        self.b3 = _conv_bn(c_in, 384, 3, stride=2)
        self.b3d = nn.Sequential(_conv_bn(c_in, 64, 1),
                                 _conv_bn(64, 96, 3, padding=1),
                                 _conv_bn(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _IncC(nn.Layer):
    def __init__(self, c_in, c7):
        super().__init__()
        self.b1 = _conv_bn(c_in, 192, 1)
        self.b7 = nn.Sequential(
            _conv_bn(c_in, c7, 1),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _conv_bn(c_in, c7, 1),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, c7, (1, 7), padding=(0, 3)),
            _conv_bn(c7, c7, (7, 1), padding=(3, 0)),
            _conv_bn(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _conv_bn(c_in, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                      axis=1)


class _IncD(nn.Layer):
    """Grid reduction 17 -> 8."""

    def __init__(self, c_in):
        super().__init__()
        self.b3 = nn.Sequential(_conv_bn(c_in, 192, 1),
                                _conv_bn(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _conv_bn(c_in, 192, 1),
            _conv_bn(192, 192, (1, 7), padding=(0, 3)),
            _conv_bn(192, 192, (7, 1), padding=(3, 0)),
            _conv_bn(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _IncE(nn.Layer):
    def __init__(self, c_in):
        super().__init__()
        self.b1 = _conv_bn(c_in, 320, 1)
        self.b3_stem = _conv_bn(c_in, 384, 1)
        self.b3_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_conv_bn(c_in, 448, 1),
                                      _conv_bn(448, 384, 3, padding=1))
        self.b3d_a = _conv_bn(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _conv_bn(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _conv_bn(c_in, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3d_stem(x)
        return concat([self.b1(x),
                       concat([self.b3_a(s), self.b3_b(s)], axis=1),
                       concat([self.b3d_a(d), self.b3d_b(d)], axis=1),
                       self.bp(x)], axis=1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _conv_bn(3, 32, 3, stride=2),
            _conv_bn(32, 32, 3),
            _conv_bn(32, 64, 3, padding=1),
            nn.MaxPool2D(3, stride=2),
            _conv_bn(64, 80, 1),
            _conv_bn(80, 192, 3),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            _IncA(192, 32), _IncA(256, 64), _IncA(288, 64),
            _IncB(288),
            _IncC(768, 128), _IncC(768, 160), _IncC(768, 160),
            _IncC(768, 192),
            _IncD(768),
            _IncE(1280), _IncE(2048))
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kw):
    _no_pretrained(pretrained)
    return InceptionV3(**kw)
