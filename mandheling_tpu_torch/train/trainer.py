"""The NITI training loop (port of ``train_niti`` / ``evaluate_niti`` from
``mandheling_tpu/train/trainer.py``; reference `MnistUtils::train`,
demo/MnistUtils.cpp:35-469).

`NITIDSPInt8Train` is `train_niti` with the default model (the NITI LeNet)
and the default backend "cuda": every contraction of the step runs through
the hand-written kernels. `model=mobilenet_v2_niti()` trains MobileNetV2
(`MobilenetV2Train`) through the same loop, and `model=resnet18_niti()`
ResNet-18. `train_fp32` is the float LeNet baseline (`MnistTrain`);
`train_fp32_bn` trains the float twins with batch norm (`ResNet18FP32`,
`MobileNetV2FP32`, `MobileNetV1FP32`), the denominators of the JAX bench's
int8 / fp32 ratios.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.loader import DataLoader, onehot_padded
from ..device import resolve_device
from ..models import NITI_LOGIT_CHANNELS, NUM_CLASSES, LeNetFP32, lenet_niti
from ..nn.module import Sequential
from ..ops.kernels import use_backend
from ..utils.checkpoint import save_checkpoint
from ..utils.jax_params import export_jax_params, load_jax_params
from ..utils.profiler import StepTimer
from .optim import lr_inv, sgd_init, sgd_update
from .train_step import make_eval_step, make_train_step


def evaluate_niti(evals, x: np.ndarray, y: np.ndarray, device: torch.device,
                  batch: int = 64) -> float:
    """Test accuracy over whole batches (the tail of len(x) % batch samples
    is dropped, as in the reference's eval loop)."""
    n = (len(x) // batch) * batch
    correct = 0
    for i in range(0, n, batch):
        xb = torch.from_numpy(x[i : i + batch].astype(np.float32)).to(device)
        yb = torch.from_numpy(y[i : i + batch].astype(np.int64)).to(device)
        correct += int(evals(xb, yb))
    return correct / max(n, 1)


def train_niti(
    train_data,
    test_data,
    epochs: int = 10,
    batch: int = 64,
    seed: int = 0,
    log: Callable[[str], None] = print,
    start_params: Optional[List] = None,
    device=None,
    backend: str = "cuda",
    model: Optional[Sequential] = None,
    checkpoint_path: Optional[str] = None,
    start_epoch: int = 0,
):
    """NITIInt8Train loop -> (model, final_test_accuracy).

    Trains `model` (default: the NITI LeNet; any Sequential NITI model with
    12 logit channels), drawn from `seed` unless `start_params` (JAX-layout
    params, utils/jax_params.py) are given. `device` defaults to the card;
    `backend` selects the kernels ("cuda") or their plain versions
    ("torch"). With `checkpoint_path` the params are saved there after every
    epoch with step = epoch + 1 (utils/checkpoint.py); `start_epoch` resumes
    the epoch count, as the JAX loop does: its loader restarts at its first
    epoch's order."""
    device = resolve_device(device)
    model = model if model is not None else lenet_niti()
    if start_params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        load_jax_params(model, start_params)
    model.to(device)
    step = make_train_step(model)
    evals = make_eval_step(model, NUM_CLASSES)
    sync = torch.cuda.synchronize if device.type == "cuda" else None

    x, y = train_data
    xt, yt = test_data
    dl = DataLoader(x, y, batch, seed=seed)
    it = start_epoch * len(dl)
    acc = 0.0
    with use_backend(backend):
        for epoch in range(start_epoch, epochs):
            timer = StepTimer(sync)
            loss = None
            for bx, by in dl.epoch():
                oh = onehot_padded(by, NUM_CLASSES, NITI_LOGIT_CHANNELS)
                with timer.step(batch):
                    loss = step(torch.from_numpy(bx).to(device),
                                torch.from_numpy(oh).to(device))
                it += 1
            acc = evaluate_niti(evals, xt, yt, device, batch=min(batch, len(xt)))
            log(
                f"epoch {epoch}: loss {float(loss):.6f} "
                f"lr {lr_inv(0.01, it):.5f} test_acc {acc:.4f} "
                f"[{timer.summary()}]"
            )
            if checkpoint_path:
                save_checkpoint(checkpoint_path, export_jax_params(model), step=epoch + 1)
    return model, acc


@contextlib.contextmanager
def full_float32():
    """float32 convolutions and matmuls in full precision: cuDNN takes TF32
    for float32 convolutions by default, which keeps ~3 decimal digits."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _normalize(x: np.ndarray) -> np.ndarray:
    return (x / 255.0 - 0.5) * 2.0


def _train_float(model, train_data, test_data, epochs, batch, seed, num_classes, log, device,
                 **train_kwargs):
    """The float loop of `train_fp32` and `train_fp32_bn` on a model already
    on `device`: autograd, momentum SGD with the inv learning rate, TF32
    off; `train_kwargs` go to the model's training forward. The eval runs on
    whole batches. The inputs take the parameters' dtype (float32; float64
    for a model moved to it)."""
    params = list(model.parameters())
    velocity = sgd_init(params)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    dtype = params[0].dtype

    x, y = train_data
    xt, yt = test_data
    dl = DataLoader(x, y, batch, seed=seed)
    it = 0
    acc = 0.0
    with full_float32():
        for epoch in range(epochs):
            timer = StepTimer(sync)
            loss = None
            for bx, by in dl.epoch():
                oh = torch.from_numpy(onehot_padded(by, NUM_CLASSES, num_classes)).to(device, dtype)
                with timer.step(batch):
                    logits = model(torch.from_numpy(_normalize(bx)).to(device, dtype),
                                   **train_kwargs)
                    loss = -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * oh, dim=-1))
                    grads = torch.autograd.grad(loss, params)
                    sgd_update(params, grads, velocity, lr_inv(0.01, it))
                it += 1
            n = (len(xt) // batch) * batch
            correct = 0
            with torch.no_grad():
                for i in range(0, n, batch):
                    bx = torch.from_numpy(_normalize(xt[i:i + batch].astype(np.float32)))
                    pred = torch.argmax(model(bx.to(device, dtype)), dim=-1).cpu().numpy()
                    correct += int(np.sum(pred == yt[i:i + batch]))
            acc = correct / max(n, 1)
            log(f"epoch {epoch}: loss {float(loss.detach()):.4f} test_acc {acc:.4f} "
                f"[{timer.summary()}]")
    return model, acc


def train_fp32(
    train_data,
    test_data,
    epochs: int = 10,
    batch: int = 64,
    seed: int = 0,
    log: Callable[[str], None] = print,
    start_params: Optional[Dict] = None,
    device=None,
):
    """MnistTrain loop (float32 LeNet, autograd, momentum SGD with the inv
    learning rate) -> (model, final_test_accuracy). Weights are drawn from
    `seed` unless `start_params` (the JAX package's float dict) are given."""
    device = resolve_device(device)
    model = LeNetFP32()
    if start_params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_params(start_params)
    return _train_float(model.to(device), train_data, test_data, epochs, batch, seed,
                        NUM_CLASSES, log, device)


def train_fp32_bn(
    model,
    train_data,
    test_data,
    epochs: int = 10,
    batch: int = 64,
    seed: int = 0,
    num_classes: int = NUM_CLASSES,
    log: Callable[[str], None] = print,
    start_params=None,
    device=None,
):
    """The float loop of the batch-norm twins (models/mobilenet_fp32.py,
    models/resnet_fp32.py) -> (model, final_test_accuracy), as `train_fp32`.
    A training forward normalises by the batch and leaves the running stats
    in the model's buffers, which the update does not touch: the stats come
    from the forward, as the JAX loop takes them. The weights are drawn from
    `seed` unless `start_params` (the JAX package's float tree) are given.
    The eval uses the running stats."""
    device = resolve_device(device)
    if start_params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_params(start_params)
    return _train_float(model.to(device), train_data, test_data, epochs, batch, seed,
                        num_classes, log, device, training=True)
