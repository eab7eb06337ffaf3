"""paddle.vision.models: LeNet, VGG and ResNet (with ResNeXt and the wide
ResNets), and the rest of the zoo from ``models_ext``: port of
``paddle_tpu/vision/models.py``.

The models are built from the port's ``nn`` layers, so their parameter
and buffer names, shapes and default initializers are the reference's
(``models.load_jax_params`` carries a reference model's weights and
batch-norm statistics across), and they are placed where ``nn``'s layers
are: on the default place, the card unless ``set_device("cpu")``. The
convolutions are cuDNN's on the card (XLA's in the reference, which has
no Pallas kernel for them). ``pretrained=`` loads nothing, as in the
reference.
"""
from .. import nn

__all__ = ["LeNet", "VGG", "vgg16", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "BasicBlock", "BottleneckBlock"]


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        self.fc = nn.Sequential(
            nn.Linear(400, 120), nn.Linear(120, 84),
            nn.Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        x = x.flatten(1)
        return self.fc(x)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        x = x.flatten(1)
        return self.classifier(x)


def _vgg_layers(cfg, batch_norm=False):
    layers = []
    c_in = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(c_in, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            c_in = v
    return nn.Sequential(*layers)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    return VGG(_vgg_layers(cfg, batch_norm), **kwargs)


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(planes)
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(planes)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = nn.BatchNorm2D(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias_attr=False)
        self.bn2 = nn.BatchNorm2D(width)
        self.conv3 = nn.Conv2D(width, planes * 4, 1, bias_attr=False)
        self.bn3 = nn.BatchNorm2D(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    def __init__(self, block, depth_cfg, num_classes=1000, with_pool=True,
                 groups=1, width_per_group=64):
        super().__init__()
        self.inplanes = 64
        self.groups = groups
        self.base_width = width_per_group
        self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0])
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], stride=2)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], stride=2)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], stride=2)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                nn.BatchNorm2D(planes * block.expansion))
        extra = {}
        if block is BottleneckBlock:
            extra = dict(groups=self.groups, base_width=self.base_width)
        layers = [block(self.inplanes, planes, stride, downsample, **extra)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **extra))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        x = x.flatten(1)
        return self.fc(x)


def resnet18(pretrained=False, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(pretrained=False, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], **kw)


def resnet101(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], **kw)


from .models_ext import *  # noqa: E402,F401,F403
from .models_ext import __all__ as _ext_all
__all__ = list(__all__) + list(_ext_all)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_vgg_layers([64, "M", 128, "M", 256, 256, "M", 512, 512,
                            "M", 512, 512, "M"], batch_norm), **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_vgg_layers([64, 64, "M", 128, 128, "M", 256, 256, "M",
                            512, 512, "M", 512, 512, "M"], batch_norm),
               **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_vgg_layers([64, 64, "M", 128, 128, "M", 256, 256, 256, 256,
                            "M", 512, 512, 512, 512, "M", 512, 512, 512,
                            512, "M"], batch_norm), **kwargs)


def resnet152(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], **kw)


def resnext50_32x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], groups=32,
                  width_per_group=4, **kw)


def resnext101_32x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], groups=32,
                  width_per_group=4, **kw)


def resnext50_64x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], groups=64,
                  width_per_group=4, **kw)


def resnext101_64x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], groups=64,
                  width_per_group=4, **kw)


def resnext152_32x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], groups=32,
                  width_per_group=4, **kw)


def resnext152_64x4d(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], groups=64,
                  width_per_group=4, **kw)


def wide_resnet50_2(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], width_per_group=128, **kw)


def wide_resnet101_2(pretrained=False, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], width_per_group=128, **kw)


__all__ += ["vgg11", "vgg13", "vgg19", "resnet152", "resnext50_32x4d",
            "resnext101_32x4d", "resnext50_64x4d", "resnext101_64x4d",
            "resnext152_32x4d", "resnext152_64x4d", "wide_resnet50_2",
            "wide_resnet101_2"]
