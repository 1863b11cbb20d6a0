"""paddle.vision.models: port of paddle_tpu/vision/models.py (reference:
python/paddle/vision/models/__init__.py — the torchvision-like zoo). The
definitions live in ``paddle_tpu_torch.models``; this module re-exports the
reference's public names."""
from ..models.lenet import LeNet  # noqa: F401
from ..models.resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                             resnet18, resnet34, resnet50, resnet101,
                             resnet152, resnext50_32x4d, resnext101_32x4d,
                             resnext101_64x4d, resnext152_32x4d,
                             resnext50_64x4d, resnext152_64x4d,
                             wide_resnet50_2, wide_resnet101_2)
from ..models.vision_zoo import (  # noqa: F401
    VGG, vgg11, vgg13, vgg16, vgg19,
    AlexNet, alexnet,
    MobileNetV1, mobilenet_v1,
    MobileNetV2, mobilenet_v2,
    MobileNetV3, MobileNetV3Large, MobileNetV3Small,
    mobilenet_v3_large, mobilenet_v3_small,
    SqueezeNet, squeezenet1_0, squeezenet1_1,
    DenseNet, densenet121, densenet161, densenet169, densenet201,
    densenet264,
    ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_33,
    shufflenet_v2_x0_5, shufflenet_v2_x1_0, shufflenet_v2_x1_5,
    shufflenet_v2_x2_0, shufflenet_v2_swish,
    GoogLeNet, googlenet,
    InceptionV3, inception_v3)
