"""`train_fp32_bn` against the JAX package's for MobileNetV2FP32 (width
0.25, one step at batch 2, float64): the case of
tests/test_torch_fp32_cifar_train.py whose float64 runs part after two
steps (its relu6 units meet batch-norm outputs at their kinks), in a file of
its own so that each file stays under a minute alone."""

import importlib.util
from pathlib import Path

import torch


def _checks():
    path = Path(__file__).with_name("test_torch_fp32_cifar_train.py")
    spec = importlib.util.spec_from_file_location("fp32_cifar_train_checks", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_fp32_bn_mnv2_one_step_matches_jax(monkeypatch):
    checks = _checks()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        checks.check_train_fp32_bn(monkeypatch, *checks.MNV2_CASE)
    finally:
        torch.set_num_threads(n)
