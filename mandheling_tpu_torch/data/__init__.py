from . import loader, mnist
from .loader import DataLoader, onehot_padded
from .mnist import load_mnist, load_or_synthesize, read_idx, synthetic_mnist

__all__ = [
    "loader",
    "mnist",
    "DataLoader",
    "onehot_padded",
    "load_mnist",
    "load_or_synthesize",
    "read_idx",
    "synthetic_mnist",
]
