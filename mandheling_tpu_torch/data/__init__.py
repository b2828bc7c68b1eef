from . import cifar, image, loader, mnist, native
from .cifar import load_cifar10, load_or_synthesize_cifar, synthetic_cifar
from .image import ImageConfig, ImageDataset, ImageNoLabelDataset
from .loader import DataLoader, make_loader, onehot_padded, shard_for_host, to_device
from .mnist import load_mnist, load_or_synthesize, read_idx, synthetic_mnist

__all__ = [
    "cifar",
    "image",
    "loader",
    "mnist",
    "native",
    "DataLoader",
    "ImageConfig",
    "ImageDataset",
    "ImageNoLabelDataset",
    "onehot_padded",
    "load_cifar10",
    "load_mnist",
    "load_or_synthesize",
    "load_or_synthesize_cifar",
    "make_loader",
    "read_idx",
    "shard_for_host",
    "synthetic_cifar",
    "synthetic_mnist",
    "to_device",
]
