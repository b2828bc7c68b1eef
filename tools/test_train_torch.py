#!/usr/bin/env python3
"""test_train_torch — run a training config from JSON on the PyTorch/CUDA
port and check that the loss decreases.

The port's counterpart of tools/test_train.py: the same config schema, the
same synthetic data made from `seed`, the same printed JSON record and
`TEST_TRAIN PASS|FAIL` line, and the same exit code (0 iff the mean loss
over the last 10% of steps is below max_final_loss_ratio times the mean
over the first 10%).

    python tools/test_train_torch.py [config.json] [--device cpu] [--params FILE]

Config schema (all fields optional), as tools/test_train.py's:
{
  "model":   "lenet_niti" | "lenet_fp32" | "mobilenet_v2_niti" |
             "mobilenet_v1_niti" | "resnet18_niti",
  "backend": "cuda" | "torch",  # the kernels (default) or their plain
                                # versions; the JAX names "pallas" and
                                # "pallas_interpret" mean "cuda", "xla" "torch"
  "steps": 50, "batch": 64, "seed": 0,
  "data": {"kind": "synthetic" | "mnist" | "cifar10", "root": null},
  "lr": 0.01,                    # lenet_fp32's SGD rate
  "max_final_loss_ratio": 0.9,
  "model_args": {},              # kwargs for the model constructor
  "fgrad_margin": null,          # dense filter-grad requant margin
  "dw_fgrad_margin": null        # depthwise filter-grad requant margin
}

It runs on the GPU, its step compiled (a CUDA graph replayed,
train/step_graph.py) as tools/test_train.py jits it; `--device cpu` runs
it on the CPU with the kernels' plain versions, eagerly (for tests). The
weights are drawn from `seed` by torch's generator, which is not
jax.random's stream; `--params FILE` starts a NITI
model from a checkpoint in the JAX layout instead (either package's
`save_checkpoint`), so that a run can repeat tools/test_train.py's from the
JAX package's initial params. The margins are restored after the run. It
imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULTS = {
    "model": "lenet_niti",
    "backend": "cuda",
    "steps": 50,
    "batch": 64,
    "seed": 0,
    "data": {"kind": "synthetic", "root": None},
    "max_final_loss_ratio": 0.9,
    "lr": 0.01,
    "model_args": {},
    "fgrad_margin": None,
    "dw_fgrad_margin": None,
}
BACKENDS = {"cuda": "cuda", "torch": "torch", "pallas": "cuda", "pallas_interpret": "cuda",
            "xla": "torch"}

# name -> (constructor in mandheling_tpu_torch.models, input shape, logit width)
NITI_MODELS = {
    "lenet_niti": ("lenet_niti", (28, 28, 1), 12),
    "mobilenet_v2_niti": ("mobilenet_v2_niti", (32, 32, 3), 12),
    "mobilenet_v1_niti": ("mobilenet_v1_niti", (32, 32, 3), 12),
    "resnet18_niti": ("resnet18_niti", (32, 32, 3), 12),
}


def load_config(path):
    cfg = dict(DEFAULTS)
    if path:
        with open(path) as f:
            user = json.load(f)
        data = {**DEFAULTS["data"], **user.pop("data", {})}
        cfg.update(user)
        cfg["data"] = data
    return cfg


def make_data(cfg):
    import numpy as np

    kind, root = cfg["data"]["kind"], cfg["data"]["root"]
    n = cfg["steps"] * cfg["batch"]
    if kind == "mnist" and root:
        from mandheling_tpu_torch.data import load_or_synthesize

        x, y, real = load_or_synthesize(root, train=True, synth_n=n)
        if real:
            return x[:n].astype(np.float32), y[:n]
    if kind == "cifar10" and root:
        from mandheling_tpu_torch.data import load_cifar10

        x, y = load_cifar10(root, train=True)
        return x[:n].astype(np.float32), y[:n]
    shape = NITI_MODELS.get(cfg["model"], (None, (28, 28, 1), 12))[1]
    rng = np.random.default_rng(cfg["seed"])
    # separable synthetic task: a class-dependent mean shift, so the loss can drop
    y = rng.integers(0, 10, n).astype(np.int32)
    x = rng.normal(0, 1, (n, *shape)).astype(np.float32)
    x += (y / 10.0 - 0.45)[:, None, None, None]
    return x, y


def train_fp32_lenet(cfg, x, y, device):
    import numpy as np
    import torch

    from mandheling_tpu_torch.data import DataLoader, onehot_padded, to_device
    from mandheling_tpu_torch.models import LeNetFP32
    from mandheling_tpu_torch.train.optim import sgd_init
    from mandheling_tpu_torch.train.step_graph import compile_step
    from mandheling_tpu_torch.train.trainer import make_float_step

    model = LeNetFP32().reset_parameters(torch.Generator().manual_seed(cfg["seed"])).to(device)
    params = list(model.parameters())
    # compiled, as the JAX tool jits its step
    step = compile_step(make_float_step(model, params, sgd_init(params)), device)
    lr = torch.full((), cfg["lr"], dtype=torch.float32, device=device)
    losses = []
    for bx, by in DataLoader(x, y, cfg["batch"], seed=cfg["seed"]).epoch():
        loss = step(to_device(bx, device),
                    to_device(onehot_padded(by, 10, 10).astype(np.float32), device), lr)
        losses.append(float(loss))
    return losses


def train_niti_model(cfg, x, y, device, params_path):
    import importlib

    import torch

    from mandheling_tpu_torch.data import DataLoader, onehot_padded, to_device
    from mandheling_tpu_torch.ops.conv import get_fgrad_margin
    from mandheling_tpu_torch.ops.depthwise import get_dw_fgrad_margin, recipe_margins
    from mandheling_tpu_torch.ops.kernels import use_backend
    from mandheling_tpu_torch.train import jit_train_step
    from mandheling_tpu_torch.utils.checkpoint import load_checkpoint
    from mandheling_tpu_torch.utils.jax_params import export_jax_params, load_jax_params

    fn_name, _, logits_w = NITI_MODELS[cfg["model"]]
    model = getattr(importlib.import_module("mandheling_tpu_torch.models"), fn_name)(
        **(cfg["model_args"] or {}))
    if params_path:
        load_jax_params(model, load_checkpoint(params_path, export_jax_params(model))[0])
    else:
        model.reset_parameters(torch.Generator().manual_seed(cfg["seed"]))
    model.to(device)
    step = jit_train_step(model)  # as tools/test_train.py's
    losses = []
    dense, dw = cfg["fgrad_margin"], cfg["dw_fgrad_margin"]
    with use_backend(BACKENDS[cfg["backend"]]), recipe_margins(
            get_fgrad_margin() if dense is None else int(dense),
            get_dw_fgrad_margin() if dw is None else int(dw)):
        for bx, by in DataLoader(x, y, cfg["batch"], seed=cfg["seed"]).epoch():
            oh = onehot_padded(by, 10, logits_w)
            loss = step(to_device(bx, device), to_device(oh, device))
            losses.append(float(loss))
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (cpu: the plain versions, for tests)")
    ap.add_argument("--params", default=None,
                    help="start a NITI model from this checkpoint (npz, the JAX layout)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    if cfg["backend"] not in BACKENDS:
        ap.error(f"backend must be one of {sorted(BACKENDS)}, got {cfg['backend']!r}")
    if args.params and cfg["model"] not in NITI_MODELS:
        ap.error("--params takes a NITI model's checkpoint")

    import numpy as np

    from mandheling_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    x, y = make_data(cfg)
    if cfg["model"] == "lenet_fp32":
        losses = train_fp32_lenet(cfg, x, y, device)
    else:
        losses = train_niti_model(cfg, x, y, device, args.params)

    k = max(1, len(losses) // 10)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    ratio = last / max(first, 1e-9)
    ok = ratio < cfg["max_final_loss_ratio"]
    print(json.dumps({
        "model": cfg["model"], "backend": cfg["backend"],
        "steps": len(losses), "first_loss": round(first, 4),
        "last_loss": round(last, 4), "ratio": round(ratio, 4),
        "pass": ok,
    }))
    print("TEST_TRAIN " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
