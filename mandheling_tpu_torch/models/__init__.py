from .lenet import NITI_LOGIT_CHANNELS, NUM_CLASSES, lenet_niti

__all__ = ["NITI_LOGIT_CHANNELS", "NUM_CLASSES", "lenet_niti"]
