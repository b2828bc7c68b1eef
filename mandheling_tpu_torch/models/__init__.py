from .lenet import NITI_LOGIT_CHANNELS, NUM_CLASSES, LeNetFP32, lenet_niti
from .mobilenet import MOBILENET_V2_NITI_LOGITS, mobilenet_v1_niti, mobilenet_v2_niti

__all__ = [
    "LeNetFP32",
    "MOBILENET_V2_NITI_LOGITS",
    "NITI_LOGIT_CHANNELS",
    "NUM_CLASSES",
    "lenet_niti",
    "mobilenet_v1_niti",
    "mobilenet_v2_niti",
]
