from . import cifar, loader, mnist
from .cifar import load_cifar10, load_or_synthesize_cifar, synthetic_cifar
from .loader import DataLoader, onehot_padded
from .mnist import load_mnist, load_or_synthesize, read_idx, synthetic_mnist

__all__ = [
    "cifar",
    "loader",
    "mnist",
    "DataLoader",
    "onehot_padded",
    "load_cifar10",
    "load_mnist",
    "load_or_synthesize",
    "load_or_synthesize_cifar",
    "read_idx",
    "synthetic_cifar",
    "synthetic_mnist",
]
