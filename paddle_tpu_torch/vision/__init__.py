"""paddle.vision: ``transforms``, ``datasets``, the model zoo
(``models``) and the detection operators (``ops``): port of
``paddle_tpu/vision``."""
from . import datasets, models, ops, transforms  # noqa: F401
from .models import LeNet, ResNet, resnet18, resnet50, vgg16  # noqa: F401
