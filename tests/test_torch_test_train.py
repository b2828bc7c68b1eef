"""The port's JSON-config training gate (tools/test_train_torch.py) against
the JAX package's (tools/test_train.py), on the CPU: from the JAX package's
initial params (handed over as a checkpoint with `--params`) and the same
synthetic data, both print the same record (steps, losses to their 4
printed decimals, ratio, pass) and the same PASS/FAIL line, with the same
exit code. Every model of the schema runs (lenet_fp32 and the MobileNets at
a small size), the config's margins are restored after the run, and an
unknown backend is refused."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mandheling_tpu import models as jmodels
from mandheling_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops import depthwise as tdw

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(relpath):
    spec = importlib.util.spec_from_file_location(Path(relpath).stem + "_under_test",
                                                  ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tool():
    return load("tools/test_train_torch.py")


def run(main, argv, capsys, monkeypatch=None):
    """-> (record, verdict line, exit code) of a gate's main."""
    if monkeypatch is not None:  # the JAX tool reads sys.argv
        monkeypatch.setattr(sys, "argv", ["test_train.py", *argv])
        try:
            main()
            code = 0
        except SystemExit as e:
            code = e.code
    else:
        code = main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-2]), lines[-1], code


@pytest.mark.parametrize("model,batch,steps", [("lenet_niti", 16, 5), ("resnet18_niti", 4, 3)])
def test_record_matches_the_jax_tool(tool, tmp_path, capsys, monkeypatch, model, batch, steps):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"model": model, "batch": batch, "steps": steps}))
    params = tmp_path / "init.npz"
    # the JAX tool's init: the model's params from PRNGKey(seed)
    j_save_checkpoint(str(params), getattr(jmodels, model)().init(jax.random.PRNGKey(0)))
    want, want_line, want_code = run(load("tools/test_train.py").main, [str(cfg)], capsys,
                                      monkeypatch)
    got, line, code = run(tool.main, [str(cfg), "--device", "cpu", "--params", str(params)],
                          capsys)
    assert want["backend"] == "xla" and got["backend"] == "cuda"
    for key in ("model", "steps", "first_loss", "last_loss", "ratio", "pass"):
        assert got[key] == want[key], key
    assert got["steps"] == steps and np.isfinite(got["last_loss"])
    assert (line, code) == (want_line, want_code)
    assert line == ("TEST_TRAIN PASS" if got["pass"] else "TEST_TRAIN FAIL")


@pytest.mark.parametrize("config", [
    {"model": "lenet_fp32", "batch": 8, "steps": 3},
    {"model": "mobilenet_v2_niti", "batch": 2, "steps": 2, "fgrad_margin": 0,
     "dw_fgrad_margin": 0, "model_args": {"width_mult": 0.25, "dw_per_channel": True}},
    {"model": "mobilenet_v1_niti", "batch": 2, "steps": 2, "backend": "xla",
     "model_args": {"width_mult": 0.25}},
], ids=lambda c: c["model"])
def test_every_model_runs(tool, tmp_path, capsys, config):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(config))
    record, line, code = run(tool.main, [str(cfg), "--device", "cpu"], capsys)
    assert record["steps"] == config["steps"] and record["model"] == config["model"]
    assert np.isfinite(record["first_loss"]) and np.isfinite(record["last_loss"])
    assert code == (0 if record["pass"] else 1) and line.startswith("TEST_TRAIN ")
    assert (tconv.get_fgrad_margin(), tdw.get_dw_fgrad_margin()) == (2, 2)


def test_unknown_backend_and_fp32_params_are_refused(tool, tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"backend": "tpu"}))
    with pytest.raises(SystemExit):
        tool.main([str(cfg), "--device", "cpu"])
    cfg.write_text(json.dumps({"model": "lenet_fp32"}))
    with pytest.raises(SystemExit):
        tool.main([str(cfg), "--device", "cpu", "--params", str(tmp_path / "x.npz")])
    assert tool.BACKENDS["xla"] == "torch" and tool.BACKENDS["pallas"] == "cuda"
