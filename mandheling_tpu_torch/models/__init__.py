from .inception import inceptionv3_niti
from .lenet import NITI_LOGIT_CHANNELS, NUM_CLASSES, LeNetFP32, lenet_niti
from .mobilenet import MOBILENET_V2_NITI_LOGITS, mobilenet_v1_niti, mobilenet_v2_niti
from .mobilenet_fp32 import MobileNetV1FP32, MobileNetV2FP32
from .resnet import RESNET18_NITI_LOGITS, resnet18_niti, resnet50v2_niti
from .resnet_fp32 import ResNet18FP32
from .squeezenet import squeezenet_niti

__all__ = [
    "LeNetFP32",
    "MOBILENET_V2_NITI_LOGITS",
    "MobileNetV1FP32",
    "MobileNetV2FP32",
    "NITI_LOGIT_CHANNELS",
    "NUM_CLASSES",
    "RESNET18_NITI_LOGITS",
    "ResNet18FP32",
    "inceptionv3_niti",
    "lenet_niti",
    "mobilenet_v1_niti",
    "mobilenet_v2_niti",
    "resnet18_niti",
    "resnet50v2_niti",
    "squeezenet_niti",
]
