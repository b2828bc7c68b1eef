"""The NITI training loop (port of ``train_niti`` / ``evaluate_niti`` from
``mandheling_tpu/train/trainer.py``; reference `MnistUtils::train`,
demo/MnistUtils.cpp:35-469).

`NITIDSPInt8Train` is `train_niti` with the default model (the NITI LeNet)
and the default backend "cuda": every contraction of the step runs through
the hand-written kernels. `model=mobilenet_v2_niti()` trains MobileNetV2
(`MobilenetV2Train`) through the same loop.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..data.loader import DataLoader, onehot_padded
from ..device import resolve_device
from ..models import NITI_LOGIT_CHANNELS, NUM_CLASSES, lenet_niti
from ..nn.module import Sequential
from ..ops.kernels import use_backend
from ..utils.jax_params import load_jax_params
from ..utils.profiler import StepTimer
from .optim import lr_inv
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
):
    """NITIInt8Train loop -> (model, final_test_accuracy).

    Trains `model` (default: the NITI LeNet; any Sequential NITI model with
    12 logit channels), drawn from `seed` unless `start_params` (JAX-layout
    params, utils/jax_params.py) are given. `device` defaults to the card;
    `backend` selects the kernels ("cuda") or their plain versions
    ("torch")."""
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
    it = 0
    acc = 0.0
    with use_backend(backend):
        for epoch in range(epochs):
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
    return model, acc
