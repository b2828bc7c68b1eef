"""The port's demo CLI (tools/run_train_demo_torch.py) and dot probe
(tools/probes/dot_probe_torch.py) on the CPU: the CLI registers the JAX
CLI's names for every demo whose modules the port has, `MobilenetV2Train`
trains the r5 recipe (per-channel depthwise MobileNetV2, margins 0/0, batch
16 on synthetic data) and restores the margins, the demos print the JAX
CLI's lines (`DataLoaderDemo` the same ones), `MnistTrainSnapshot` resumes
from its own file; the probe's grid is the JAX probe's and its plain
versions give numpy's max|A.B| exactly."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mandheling_tpu.train.trainer as jtrainer
from mandheling_tpu.ops import conv as jconv
from mandheling_tpu.ops import depthwise as jdw
from mandheling_tpu_torch.data import synthetic_mnist
from mandheling_tpu_torch.models import mobilenet_v2_niti
from mandheling_tpu_torch.nn import NITIDepthwiseConv2D, ResidualBlock
from mandheling_tpu_torch.ops import conv as tconv
from mandheling_tpu_torch.ops import depthwise as tdw
import mandheling_tpu_torch.train.trainer as ttrainer

ROOT = Path(__file__).resolve().parents[1]
PORTED = {"MnistTrain", "NITIInt8Train", "NITIDSPInt8Train", "MnistTrainSnapshot",
          "MobilenetV2Train", "MobilenetV1Train", "DataLoaderDemo", "NnGradTest",
          "LinearRegression", "MnistInt8Train", "DistillTrainQuant", "MobilenetV2Transfer",
          "QuanByMSE", "OnnxImportTrain", "TfImportTrain", "CaffeImportTrain",
          "TFLiteImportTrain", "DistributedNITITrain", "PipelineNITITrain", "GPipeLeNetTrain"}


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
def cli():
    return load("tools/run_train_demo_torch.py")


@pytest.fixture(scope="module")
def jax_cli():
    return load("tools/run_train_demo.py")


def test_registry_names(cli, jax_cli):
    assert set(cli.DEMOS) == PORTED
    assert PORTED <= set(jax_cli.DEMOS)


def _dw_layers(model):
    for layer in model.layers:
        if isinstance(layer, ResidualBlock):
            yield from _dw_layers(layer.branch)
        elif isinstance(layer, NITIDepthwiseConv2D):
            yield layer


@pytest.mark.parametrize("fail", [False, True])
def test_mobilenet_v2_train_is_the_recipe(cli, jax_cli, monkeypatch, capsys, fail):
    """Both CLIs, with train_niti replaced by a recorder: the same model
    layout, batch, epochs and margins during the run, the margins back at 2
    after it (also when training raises), and the same printed lines."""
    seen = {}

    def recorder(conv_ops, dw_ops, pkg):
        def fake(train, test, epochs=10, batch=64, model=None, **kwargs):
            seen[pkg] = dict(batch=batch, epochs=epochs, n_train=len(train[0]),
                             n_test=len(test[0]), model=model,
                             margins=(conv_ops.get_fgrad_margin(), dw_ops.get_dw_fgrad_margin()))
            if fail:
                raise RuntimeError("training failed")
            return model, 0.5
        return fake

    monkeypatch.setattr(ttrainer, "train_niti", recorder(tconv, tdw, "torch"))
    monkeypatch.setattr(jtrainer, "train_niti", recorder(jconv, jdw, "jax"))
    printed = {}
    for pkg, module, argv in (("torch", cli, ["MobilenetV2Train", "--epochs", "1", "--device", "cpu"]),
                              ("jax", jax_cli, ["MobilenetV2Train", "--epochs", "1"])):
        monkeypatch.setattr("sys.argv", ["run_train_demo"] + argv)
        if fail:
            with pytest.raises(RuntimeError, match="training failed"):
                module.main(argv) if pkg == "torch" else module.main()
        else:
            module.main(argv) if pkg == "torch" else module.main()
        printed[pkg] = capsys.readouterr().out
    assert (tconv.get_fgrad_margin(), tdw.get_dw_fgrad_margin()) == (2, 2)
    assert (jconv.get_fgrad_margin(), jdw.get_dw_fgrad_margin()) == (2, 2)
    t, j = seen["torch"], seen["jax"]
    assert t["margins"] == j["margins"] == (0, 0)
    assert (t["batch"], t["epochs"], t["n_train"], t["n_test"]) == \
        (j["batch"], j["epochs"], j["n_train"], j["n_test"]) == (16, 1, 512, 64)
    dws = list(_dw_layers(t["model"]))
    assert len(dws) == 17 and all(layer.per_channel for layer in dws)
    want = mobilenet_v2_niti(dw_per_channel=True)
    assert [type(m).__name__ for m in t["model"].modules()] == \
        [type(m).__name__ for m in want.modules()]
    assert printed["torch"] == printed["jax"]
    if not fail:
        assert printed["torch"].splitlines()[-1] == "final test accuracy: 0.5000"


def test_demos_print_the_jax_lines(cli, jax_cli, capsys, monkeypatch):
    cli.main(["DataLoaderDemo"])
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["run_train_demo", "DataLoaderDemo"])
    jax_cli.main()
    assert got == capsys.readouterr().out
    cli.main(["NnGradTest", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["input-grad max |delta| vs float conv: 0.0",
                     "filter-grad max |delta| vs einsum: 0.0", "PASS"]
    cli.main(["LinearRegression", "--device", "cpu"])
    fit = capsys.readouterr().out.strip()  # y = 3x + 1.5 and noise
    a, b = (float(fit.split(f"{v}=")[1].split()[0]) for v in ("a", "b"))
    assert fit.startswith("fit: a=") and abs(a - 3.0) < 0.01 and abs(b - 1.5) < 0.01


def test_snapshot_resumes(cli, capsys, monkeypatch, tmp_path):
    """MnistTrainSnapshot twice: the second run resumes from the first's
    file at its epoch and trains on from there."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "_data", lambda root: (synthetic_mnist(128, seed=1),
                                                    synthetic_mnist(64, seed=2)))
    cli.main(["MnistTrainSnapshot", "--epochs", "1", "--device", "cpu"])
    first = capsys.readouterr().out
    assert "resumed" not in first and (tmp_path / "mnist.snapshot.npz").exists()
    cli.main(["MnistTrainSnapshot", "--epochs", "2", "--device", "cpu"])
    second = capsys.readouterr().out.splitlines()
    assert second[0] == "resumed from mnist.snapshot.npz at epoch 1"
    assert second[1].startswith("epoch 1: loss ")
    assert second[-1].startswith("final test accuracy: ")


def test_cli_needs_the_card_unless_asked(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["NnGradTest"])


def test_probe_grid_and_plain_versions():
    probe = load("tools/probes/dot_probe_torch.py")
    jax_probe = load("tools/probes/dot_probe.py")
    assert (probe.ROWS, probe.KS, probe.N) == (jax_probe.ROWS, (28, 128, 256), 512)
    ops = probe.operands(rows=probe.ROWS)
    rng = np.random.default_rng(0)  # the JAX probe's draws, in its order
    for k in probe.KS:
        a, b = rng.integers(-80, 80, (probe.ROWS, k)), rng.integers(-80, 80, (k, probe.N))
        np.testing.assert_array_equal(ops[k][0], a)
        np.testing.assert_array_equal(ops[k][1], b)
    for k, (a, b) in probe.operands(rows=600).items():
        want = int(np.abs(a.astype(np.int64) @ b.astype(np.int64)).max())
        assert want < 2**24
        for variant in probe.VARIANTS:
            got = probe.plain(torch.from_numpy(a), torch.from_numpy(b), variant)
            assert got.dtype == torch.int32 and int(got) == want
