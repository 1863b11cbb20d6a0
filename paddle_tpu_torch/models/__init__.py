"""Models of the port: the BASELINE workloads — LeNet, ResNet (``resnet``)
and the rest of the vision zoo (``vision_zoo``), BERT (``bert``) and the
GPT (``gpt``: functional and eager faces)."""
from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152)
from .bert import Bert, BertConfig  # noqa: F401
