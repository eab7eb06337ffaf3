"""The rest of paddle.vision.models: AlexNet, MobileNet v1 / v2 / v3,
SqueezeNet, DenseNet, GoogLeNet, InceptionV3 and ShuffleNetV2, NCHW:
port of ``paddle_tpu/vision/models_ext.py``, with the reference's
architectures and parameter names. The concatenations are ``torch.cat``
where the reference calls its own ``concat``.
"""
import torch

from .. import nn

__all__ = [
    "AlexNet", "alexnet", "MobileNetV1", "mobilenet_v1", "MobileNetV2",
    "mobilenet_v2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v3_small", "mobilenet_v3_large", "SqueezeNet",
    "squeezenet1_0", "squeezenet1_1", "DenseNet", "densenet121",
    "densenet161", "densenet169", "densenet201", "GoogLeNet", "googlenet",
    "InceptionV3", "inception_v3", "ShuffleNetV2", "shufflenet_v2_x1_0",
    "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_5", "shufflenet_v2_x2_0", "shufflenet_v2_swish",
    "densenet264",
]


def _conv_bn(c_in, c_out, k, stride=1, padding=0, groups=1, act="relu"):
    layers = [nn.Conv2D(c_in, c_out, k, stride=stride, padding=padding,
                        groups=groups, bias_attr=False),
              nn.BatchNorm2D(c_out)]
    if act == "relu":
        layers.append(nn.ReLU())
    elif act == "relu6":
        layers.append(nn.ReLU6())
    elif act == "hardswish":
        layers.append(nn.Hardswish())
    elif act == "swish":
        layers.append(nn.SiLU())
    return nn.Sequential(*layers)


# ------------------------------------------------------------- AlexNet

class AlexNet(nn.Layer):
    """reference vision/models/alexnet.py"""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2))
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(), nn.Linear(256 * 36, 4096), nn.ReLU(),
            nn.Dropout(), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.flatten(1))


def alexnet(pretrained=False, **kw):
    return AlexNet(**kw)


# --------------------------------------------------------- MobileNetV1

class MobileNetV1(nn.Layer):
    """Depthwise-separable stack (reference mobilenetv1.py)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        s = lambda c: max(8, int(c * scale))
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        layers = [_conv_bn(3, s(32), 3, stride=2, padding=1)]
        for c_in, c_out, stride in cfg:
            layers.append(_conv_bn(s(c_in), s(c_in), 3, stride=stride,
                                   padding=1, groups=s(c_in)))  # depthwise
            layers.append(_conv_bn(s(c_in), s(c_out), 1))       # pointwise
        self.features = nn.Sequential(*layers)
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        return self.fc(x.flatten(1))


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)


# --------------------------------------------------------- MobileNetV2

class _InvertedResidual(nn.Layer):
    def __init__(self, c_in, c_out, stride, expand):
        super().__init__()
        hidden = int(round(c_in * expand))
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if expand != 1:
            layers.append(_conv_bn(c_in, hidden, 1, act="relu6"))
        layers += [
            _conv_bn(hidden, hidden, 3, stride=stride, padding=1,
                     groups=hidden, act="relu6"),
            _conv_bn(hidden, c_out, 1, act=None),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    """reference mobilenetv2.py (t,c,n,s table)."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        table = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                 (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                 (6, 320, 1, 1)]
        s = lambda c: max(8, int(c * scale))
        c_in = s(32)
        layers = [_conv_bn(3, c_in, 3, stride=2, padding=1, act="relu6")]
        for t, c, n, stride in table:
            for i in range(n):
                layers.append(_InvertedResidual(
                    c_in, s(c), stride if i == 0 else 1, t))
                c_in = s(c)
        last = max(1280, int(1280 * scale))
        layers.append(_conv_bn(c_in, last, 1, act="relu6"))
        self.features = nn.Sequential(*layers)
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Sequential(nn.Dropout(0.2),
                                        nn.Linear(last, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        return self.classifier(x.flatten(1))


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)


# --------------------------------------------------------- MobileNetV3

class _SE(nn.Layer):
    def __init__(self, c, r=4):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(c, c // r, 1)
        self.fc2 = nn.Conv2D(c // r, c, 1)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _MBV3Block(nn.Layer):
    def __init__(self, c_in, hidden, c_out, k, stride, se, act):
        super().__init__()
        self.use_res = stride == 1 and c_in == c_out
        layers = []
        if hidden != c_in:
            layers.append(_conv_bn(c_in, hidden, 1, act=act))
        layers.append(_conv_bn(hidden, hidden, k, stride=stride,
                               padding=k // 2, groups=hidden, act=act))
        if se:
            layers.append(_SE(hidden))
        layers.append(_conv_bn(hidden, c_out, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_MBV3_LARGE = [
    # k, hidden, out, se, act, stride
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_MBV3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_c, num_classes=1000, scale=1.0,
                 with_pool=True):
        super().__init__()
        s = lambda c: max(8, int(c * scale))
        layers = [_conv_bn(3, s(16), 3, stride=2, padding=1,
                           act="hardswish")]
        c_in = s(16)
        for k, hidden, out, se, act, stride in cfg:
            layers.append(_MBV3Block(c_in, s(hidden), s(out), k, stride,
                                     se, act))
            c_in = s(out)
        last_hidden = s(cfg[-1][1])
        layers.append(_conv_bn(c_in, last_hidden, 1, act="hardswish"))
        self.features = nn.Sequential(*layers)
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Sequential(
            nn.Linear(last_hidden, last_c), nn.Hardswish(),
            nn.Dropout(0.2), nn.Linear(last_c, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        return self.classifier(x.flatten(1))


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MBV3_LARGE, 1280, num_classes, scale, with_pool)


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_MBV3_SMALL, 1024, num_classes, scale, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    return MobileNetV3Large(scale=scale, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    return MobileNetV3Small(scale=scale, **kw)


# ---------------------------------------------------------- SqueezeNet

class _Fire(nn.Layer):
    def __init__(self, c_in, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Sequential(nn.Conv2D(c_in, squeeze, 1), nn.ReLU())
        self.expand1 = nn.Sequential(nn.Conv2D(squeeze, e1, 1), nn.ReLU())
        self.expand3 = nn.Sequential(nn.Conv2D(squeeze, e3, 3, padding=1),
                                     nn.ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return torch.cat([self.expand1(s), self.expand3(s)], 1)


class SqueezeNet(nn.Layer):
    """reference squeezenet.py (versions 1.0/1.1)."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), nn.MaxPool2D(3, 2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, 2), _Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, 2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, 2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, 2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            nn.AdaptiveAvgPool2D(1))

    def forward(self, x):
        return self.classifier(self.features(x)).flatten(1)


def squeezenet1_0(pretrained=False, **kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    return SqueezeNet("1.1", **kw)


# ------------------------------------------------------------ DenseNet

class _DenseLayer(nn.Layer):
    def __init__(self, c_in, growth, bn_size):
        super().__init__()
        self.fn = nn.Sequential(
            nn.BatchNorm2D(c_in), nn.ReLU(),
            nn.Conv2D(c_in, bn_size * growth, 1, bias_attr=False),
            nn.BatchNorm2D(bn_size * growth), nn.ReLU(),
            nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                      bias_attr=False))

    def forward(self, x):
        return torch.cat([x, self.fn(x)], 1)


class DenseNet(nn.Layer):
    """reference densenet.py."""

    _cfgs = {121: (64, 32, (6, 12, 24, 16)),
             161: (96, 48, (6, 12, 36, 24)),
             169: (64, 32, (6, 12, 32, 32)),
             201: (64, 32, (6, 12, 48, 32)),
             264: (64, 32, (6, 12, 64, 48))}

    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        init_c, growth, blocks = self._cfgs[layers]
        feats = [nn.Conv2D(3, init_c, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(init_c), nn.ReLU(),
                 nn.MaxPool2D(3, 2, padding=1)]
        c = init_c
        for bi, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth, bn_size))
                c += growth
            if bi != len(blocks) - 1:  # transition
                feats += [nn.BatchNorm2D(c), nn.ReLU(),
                          nn.Conv2D(c, c // 2, 1, bias_attr=False),
                          nn.AvgPool2D(2, 2)]
                c //= 2
        feats += [nn.BatchNorm2D(c), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        return self.classifier(x.flatten(1))


def densenet121(pretrained=False, **kw):
    return DenseNet(121, **kw)


def densenet161(pretrained=False, **kw):
    return DenseNet(161, **kw)


def densenet169(pretrained=False, **kw):
    return DenseNet(169, **kw)


def densenet264(pretrained=False, **kw):
    return DenseNet(layers=264, **kw)


def densenet201(pretrained=False, **kw):
    return DenseNet(201, **kw)


# ----------------------------------------------------------- GoogLeNet

class _Inception(nn.Layer):
    def __init__(self, c_in, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _conv_bn(c_in, c1, 1)
        self.b2 = nn.Sequential(_conv_bn(c_in, c3r, 1),
                                _conv_bn(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_conv_bn(c_in, c5r, 1),
                                _conv_bn(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, 1, padding=1),
                                _conv_bn(c_in, proj, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], 1)


class GoogLeNet(nn.Layer):
    """reference googlenet.py (main head only at inference; aux heads
    returned in training mode like the reference)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = nn.Sequential(
            _conv_bn(3, 64, 7, stride=2, padding=3), nn.MaxPool2D(3, 2),
            _conv_bn(64, 64, 1), _conv_bn(64, 192, 3, padding=1),
            nn.MaxPool2D(3, 2))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        self.pool5 = nn.AdaptiveAvgPool2D(1)
        self.dropout = nn.Dropout(0.4)
        self.fc = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4e(self.i4d(self.i4c(self.i4b(self.i4a(x)))))
        x = self.pool4(x)
        x = self.i5b(self.i5a(x))
        x = self.dropout(self.pool5(x).flatten(1))
        return self.fc(x)


def googlenet(pretrained=False, **kw):
    return GoogLeNet(**kw)


# ---------------------------------------------------------- InceptionV3

class InceptionV3(nn.Layer):
    """Compact InceptionV3 (reference inceptionv3.py topology: stem +
    InceptionA/B/C/D/E stacks)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        cb = _conv_bn
        self.stem = nn.Sequential(
            cb(3, 32, 3, stride=2), cb(32, 32, 3), cb(32, 64, 3, padding=1),
            nn.MaxPool2D(3, 2), cb(64, 80, 1), cb(80, 192, 3),
            nn.MaxPool2D(3, 2))

        def block_a(c_in, pool_c):
            return _Inception(c_in, 64, 48, 64, 64, 96, pool_c)

        self.a1 = block_a(192, 32)
        self.a2 = block_a(256, 64)
        self.a3 = block_a(288, 64)
        self.red1 = nn.Sequential(cb(288, 384, 3, stride=2))
        self.red1_pool = nn.MaxPool2D(3, 2)
        c = 384 + 288
        self.b1 = _Inception(c, 192, 128, 192, 128, 192, 96)
        cb2 = 192 * 3 + 96
        self.red2 = nn.Sequential(cb(cb2, 320, 3, stride=2))
        self.red2_pool = nn.MaxPool2D(3, 2)
        c3 = 320 + cb2
        self.c1 = _Inception(c3, 320, 384, 384, 448, 384, 192)
        final_c = 320 + 384 + 384 + 192
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.dropout = nn.Dropout(0.5)
        self.fc = nn.Linear(final_c, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.a3(self.a2(self.a1(x)))
        x = torch.cat([self.red1(x), self.red1_pool(x)], 1)
        x = self.b1(x)
        x = torch.cat([self.red2(x), self.red2_pool(x)], 1)
        x = self.c1(x)
        x = self.dropout(self.pool(x).flatten(1))
        return self.fc(x)


def inception_v3(pretrained=False, **kw):
    return InceptionV3(**kw)


# --------------------------------------------------------- ShuffleNetV2

class _ShuffleUnit(nn.Layer):
    def __init__(self, c_in, c_out, stride):
        super().__init__()
        self.stride = stride
        branch_c = c_out // 2
        if stride == 1:
            self.branch2 = nn.Sequential(
                _conv_bn(branch_c, branch_c, 1),
                _conv_bn(branch_c, branch_c, 3, stride=1, padding=1,
                         groups=branch_c, act=None),
                _conv_bn(branch_c, branch_c, 1))
            self.branch1 = None
        else:
            self.branch1 = nn.Sequential(
                _conv_bn(c_in, c_in, 3, stride=stride, padding=1,
                         groups=c_in, act=None),
                _conv_bn(c_in, branch_c, 1))
            self.branch2 = nn.Sequential(
                _conv_bn(c_in, branch_c, 1),
                _conv_bn(branch_c, branch_c, 3, stride=stride, padding=1,
                         groups=branch_c, act=None),
                _conv_bn(branch_c, branch_c, 1))

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            x1 = x[:, :half]
            x2 = x[:, half:]
            out = torch.cat([x1, self.branch2(x2)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        # channel shuffle (2 groups)
        b, c = out.shape[0], out.shape[1]
        h, w = out.shape[2], out.shape[3]
        out = out.reshape(b, 2, c // 2, h, w).transpose(1, 2).reshape(
            b, c, h, w)
        return out


class ShuffleNetV2(nn.Layer):
    """reference shufflenetv2.py (x1.0 config default)."""

    _stage_c = {0.25: (24, 48, 96, 512), 0.33: (32, 64, 128, 512),
                0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
                1.5: (176, 352, 704, 1024), 2.0: (244, 488, 976, 2048)}

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        c1, c2, c3, c_last = self._stage_c[scale]
        self.stem = nn.Sequential(_conv_bn(3, 24, 3, stride=2, padding=1),
                                  nn.MaxPool2D(3, 2, padding=1))
        stages = []
        c_in = 24
        for c_out, repeat in ((c1, 4), (c2, 8), (c3, 4)):
            stages.append(_ShuffleUnit(c_in, c_out, 2))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(c_out, c_out, 1))
            c_in = c_out
        self.stages = nn.Sequential(*stages)
        self.last = _conv_bn(c3, c_last, 1)
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(c_last, num_classes)

    def forward(self, x):
        x = self.last(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        return self.fc(x.flatten(1))


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.33, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return ShuffleNetV2(scale=1.0, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return ShuffleNetV2(scale=2.0, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    kw.setdefault("act", "swish")
    return ShuffleNetV2(scale=1.0, **kw)
