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

On the card every loop steps through compiled steps, one CUDA graph per
step and input signature (step_graph.py), as the JAX loops run jitted
steps: `train_niti` through `jit_train_step` / `jit_eval_step`, the float
loops through their float step and eval forward. Batches reach the card
from pinned host memory, non-blocking (`data.loader.to_device`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.loader import DataLoader, onehot_padded, to_device
from ..device import resolve_device
from ..models import NITI_LOGIT_CHANNELS, NUM_CLASSES, LeNetFP32, lenet_niti
from ..nn.module import Sequential
from ..ops.kernels import use_backend
from ..utils.checkpoint import save_checkpoint
from ..utils.jax_params import export_jax_params, load_jax_params
from ..utils.profiler import StepTimer
from .optim import lr_inv, sgd_init, sgd_update
from .step_graph import compile_step
from .train_step import jit_eval_step, jit_train_step


def evaluate_niti(evals, x: np.ndarray, y: np.ndarray, device: torch.device,
                  batch: int = 64) -> float:
    """Test accuracy over whole batches (the tail of len(x) % batch samples
    is dropped, as in the reference's eval loop); the counts are summed on
    the device and read once."""
    n = (len(x) // batch) * batch
    correct = torch.zeros((), dtype=torch.int32, device=device)
    for i in range(0, n, batch):
        correct = correct + evals(to_device(x[i : i + batch], device, torch.float32),
                                  to_device(y[i : i + batch], device, torch.int64))
    return int(correct) / max(n, 1)


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
    ("torch"). The steps are `jit_train_step` / `jit_eval_step`, as the JAX
    loop's. With `checkpoint_path` the params are saved there after every
    epoch with step = epoch + 1 (utils/checkpoint.py); `start_epoch`
    resumes the epoch count, as the JAX loop does: its loader restarts at
    its first epoch's order."""
    device = resolve_device(device)
    model = model if model is not None else lenet_niti()
    if start_params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        load_jax_params(model, start_params)
    model.to(device)
    step, evals = jit_train_step(model), jit_eval_step(model, NUM_CLASSES)
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
                    loss = step(to_device(bx, device), to_device(oh, device))
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


def make_float_step(model, params: List[torch.Tensor], velocity: List[torch.Tensor],
                    **train_kwargs):
    """The float train step of `train_fp32` / `train_fp32_bn`:
    step(x, onehot, lr) -> loss (0-d): the model's training forward (with
    `train_kwargs`), the mean cross entropy, torch.autograd.grad over
    `params` and `sgd_update` with `lr`, a 0-d tensor of the params' dtype
    on their device whose value changes every step (the JAX float step's
    traced lr). The params, velocities and running stats are written in
    place, so the step can be captured (step_graph.py)."""

    def step(x: torch.Tensor, onehot: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
        logits = model(x, **train_kwargs)
        loss = -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * onehot, dim=-1))
        grads = torch.autograd.grad(loss, params)
        sgd_update(params, grads, velocity, lr)
        return loss.detach()

    return step


def make_float_eval_step(model):
    """eval_step(x, labels) -> correct count (0-d int32) of the model's eval
    forward's argmax (the JAX loops' jitted `predict`, compared on the
    device)."""

    def eval_step(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return (torch.argmax(model(x), dim=-1) == labels).sum(dtype=torch.int32)

    return eval_step


def _train_float(model, train_data, test_data, epochs, batch, seed, num_classes, log, device,
                 **train_kwargs):
    """The float loop of `train_fp32` and `train_fp32_bn` on a model already
    on `device`: autograd, momentum SGD with the inv learning rate, TF32
    off; `train_kwargs` go to the model's training forward. The train step
    and the eval forward are compiled (step_graph.py). The eval runs on
    whole batches. The inputs and the lr take the parameters' dtype
    (float32; float64 for a model moved to it)."""
    params = list(model.parameters())
    velocity = sgd_init(params)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    dtype = params[0].dtype
    step = compile_step(make_float_step(model, params, velocity, **train_kwargs), device)
    evals = compile_step(make_float_eval_step(model), device)

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
                oh = onehot_padded(by, NUM_CLASSES, num_classes)
                with timer.step(batch):
                    loss = step(to_device(_normalize(bx), device, dtype),
                                to_device(oh, device, dtype),
                                torch.full((), lr_inv(0.01, it), dtype=dtype, device=device))
                it += 1
            n = (len(xt) // batch) * batch
            correct = torch.zeros((), dtype=torch.int32, device=device)
            for i in range(0, n, batch):
                correct = correct + evals(
                    to_device(_normalize(xt[i:i + batch].astype(np.float32)), device, dtype),
                    to_device(yt[i:i + batch], device, torch.int64))
            acc = int(correct) / max(n, 1)
            log(f"epoch {epoch}: loss {float(loss):.4f} test_acc {acc:.4f} "
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
