"""Checkpoints (``utils/checkpoint.py``) and resumed training against the
JAX package: the npz format is the same both ways (a file written by either
package loads in the other, keys and bytes equal), schema v0 files migrate,
newer schemas are refused, inference artifacts cross with their registry
name (ResNet-18's projected blocks included), and a `train_niti` run resumed from its checkpoint gives the JAX
package's resumed params byte for byte.

The JAX trainer takes its native loader when the native library loads; the
port has only the Python loader (the native one is not ported yet), so the
JAX runs here use the JAX package's Python `DataLoader`, whose order the
port's copies."""

import json

import jax
import numpy as np
import pytest
import torch

import mandheling_tpu.train.trainer as jtrainer
from mandheling_tpu.data.loader import DataLoader as JDataLoader
from mandheling_tpu.models import lenet_niti as j_lenet_niti
from mandheling_tpu.models import mobilenet_v2_niti as j_mobilenet_v2_niti
from mandheling_tpu.models import resnet18_niti as j_resnet18_niti
from mandheling_tpu.nn.transform import dw_to_per_channel as j_dw_to_per_channel
from mandheling_tpu.utils import checkpoint as jckpt
from mandheling_tpu_torch.data import synthetic_mnist
from mandheling_tpu_torch.models import lenet_niti, mobilenet_v2_niti, resnet18_niti
from mandheling_tpu_torch.nn import dw_to_per_channel
from mandheling_tpu_torch.train.trainer import train_niti
from mandheling_tpu_torch.utils import checkpoint as tckpt
from mandheling_tpu_torch.utils.jax_params import export_jax_params, flat_weights, load_jax_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runners share the machine's cores among
    several processes, where torch's spinning thread pool slows tiny ops by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(params):
    if isinstance(params, list):
        return [to_numpy(p) for p in params]
    if not params:
        return ()
    if "branch" in params:  # a ProjectedResidualBlock
        return {"branch": to_numpy(params["branch"]), "proj": to_numpy(params["proj"])}
    return {"w": (np.asarray(params["w"].data), np.asarray(params["w"].exp))}


def assert_params_equal(got, want):
    got, want = flat_weights(got), flat_weights(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def npz_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


MODELS = {
    "lenet": (j_lenet_niti, lenet_niti, {}),
    "mnv2_pc": (j_mobilenet_v2_niti, mobilenet_v2_niti, {"width_mult": 0.25,
                                                         "dw_per_channel": True}),
    "resnet18": (j_resnet18_niti, resnet18_niti, {}),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_npz_crosses_both_ways(tmp_path, name):
    jctor, tctor, kwargs = MODELS[name]
    jparams = jctor(**kwargs).init(jax.random.PRNGKey(0))
    want = to_numpy(jparams)
    keys, _ = jckpt._flatten_with_paths(jparams)
    assert list(tckpt.flatten_params(want)) == list(keys)

    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jparams, step=3)
    got, step = tckpt.load_checkpoint(jpath, export_jax_params(tctor(**kwargs)))
    assert step == 3
    assert_params_equal(got, want)

    tpath = str(tmp_path / "torch.npz")
    tckpt.save_checkpoint(tpath, export_jax_params(load_jax_params(tctor(**kwargs), want)), step=5)
    a, b = npz_arrays(jpath), npz_arrays(tpath)
    assert sorted(a) == sorted(b)
    for k in a:
        if k != "__meta__":
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert json.loads(str(b["__meta__"])) == {"step": 5, "schema": 1}
    back, step = jckpt.load_checkpoint(tpath, jctor(**kwargs).init(jax.random.PRNGKey(9)))
    assert step == 5
    assert_params_equal(to_numpy(back), want)


def test_resnet18_params_through_the_carrier_unchanged():
    """JAX-layout ResNet-18 params (identity blocks as the branch's list,
    projected ones as {"branch", "proj"}) go through load_jax_params ->
    export_jax_params unchanged, flatten to the JAX package's 42 checkpoint
    keys, and dw_to_per_channel leaves the model as it is (no depthwise
    layer; the JAX walk returns a projected block's params untouched)."""
    jparams = j_resnet18_niti().init(jax.random.PRNGKey(7))
    want = to_numpy(jparams)
    model = load_jax_params(resnet18_niti(), want)
    got = export_jax_params(model)
    assert [type(p) for p in got] == [type(p) for p in want]
    assert [sorted(p) for p in got if isinstance(p, dict)] == \
        [sorted(p) for p in want if isinstance(p, dict)]
    assert_params_equal(got, want)
    keys, _ = jckpt._flatten_with_paths(jparams)
    assert list(tckpt.flatten_params(got)) == list(keys) and len(keys) == 42
    assert "[6]/['proj']/['w']/.data" in keys and "[6]/['branch']/[0]/['w']/.data" in keys
    assert dw_to_per_channel(model) is model
    assert_params_equal(export_jax_params(model), want)
    _, jback = j_dw_to_per_channel(j_resnet18_niti(), jparams)
    assert_params_equal(to_numpy(jback), want)


def test_schema_migration_and_refusal(tmp_path):
    params = export_jax_params(lenet_niti())
    arrays = tckpt.flatten_params(params)
    old = str(tmp_path / "v0.npz")
    np.savez(old, __meta__=json.dumps({"step": 2}), **arrays)
    got, step = tckpt.load_checkpoint(old, export_jax_params(lenet_niti()))
    assert step == 2
    assert_params_equal(got, params)
    new = str(tmp_path / "v2.npz")
    np.savez(new, __meta__=json.dumps({"step": 2, "schema": 2}), **arrays)
    with pytest.raises(ValueError, match="newer"):
        tckpt.load_checkpoint(new, export_jax_params(lenet_niti()))
    with pytest.raises(ValueError, match="newer"):
        jckpt.load_checkpoint(new, j_lenet_niti().init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_checkpoint(old, export_jax_params(mobilenet_v2_niti(width_mult=0.25)))


def test_inference_artifacts_cross(tmp_path):
    kwargs = {"width_mult": 0.25, "dw_per_channel": True}
    jparams = j_mobilenet_v2_niti(**kwargs).init(jax.random.PRNGKey(4))
    jpath = str(tmp_path / "j.npz")
    jckpt.export_inference(jpath, "mobilenet_v2_niti", jparams, **kwargs)
    model, params = tckpt.load_inference(jpath)
    assert_params_equal(export_jax_params(model), to_numpy(jparams))
    assert_params_equal(params, to_numpy(jparams))

    tpath = str(tmp_path / "t.npz")
    tckpt.export_inference(tpath, "lenet_niti", export_jax_params(
        load_jax_params(lenet_niti(), to_numpy(j_lenet_niti().init(jax.random.PRNGKey(5))))))
    _, back = jckpt.load_inference(tpath)
    assert_params_equal(to_numpy(back), to_numpy(j_lenet_niti().init(jax.random.PRNGKey(5))))

    # resnet18_niti (with its projected blocks) crosses both ways too
    rparams = j_resnet18_niti().init(jax.random.PRNGKey(6))
    rpath = str(tmp_path / "r.npz")
    jckpt.export_inference(rpath, "resnet18_niti", rparams)
    model, params = tckpt.load_inference(rpath)
    assert_params_equal(export_jax_params(model), to_numpy(rparams))
    tckpt.export_inference(tpath, "resnet18_niti", export_jax_params(model))
    _, back = jckpt.load_inference(tpath)
    assert_params_equal(to_numpy(back), to_numpy(rparams))
    assert sorted(tckpt._MODEL_REGISTRY) == sorted(jckpt._MODEL_REGISTRY)
    with pytest.raises(ValueError, match="unknown model"):
        tckpt.export_inference(tpath, "vgg", [])


def test_resumed_train_niti_matches_jax(tmp_path, monkeypatch):
    """One epoch with a checkpoint, then a run resumed from it to epoch 2,
    in each package: the files after each run and the resumed params are
    byte-identical, and the resumed run restarts the loader's order (so it
    differs from an uninterrupted two-epoch run), as the JAX loop does."""
    monkeypatch.setattr(jtrainer, "make_loader",
                        lambda x, y, batch, seed=0: JDataLoader(x, y, batch, seed=seed))
    train, test = synthetic_mnist(128, seed=21), synthetic_mnist(32, seed=22)
    jstart = j_lenet_niti().init(jax.random.PRNGKey(0))
    start = to_numpy(jstart)  # the JAX step donates its params
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jlines, tlines = [], []

    jtrainer.train_niti(train, test, epochs=1, batch=32, log=jlines.append,
                        checkpoint_path=jpath, start_params=jstart)
    train_niti(train, test, epochs=1, batch=32, log=tlines.append, device="cpu",
               checkpoint_path=tpath, start_params=start)
    for f in (jpath, tpath):
        assert json.loads(str(npz_arrays(f)["__meta__"]))["step"] == 1
    assert_params_equal(tckpt.load_checkpoint(tpath, export_jax_params(lenet_niti()))[0],
                        tckpt.load_checkpoint(jpath, export_jax_params(lenet_niti()))[0])

    jparams, jstep = jckpt.load_checkpoint(jpath, j_lenet_niti().init(jax.random.PRNGKey(1)))
    jfinal, _ = jtrainer.train_niti(train, test, epochs=2, batch=32, log=jlines.append,
                                    checkpoint_path=jpath, start_params=jparams,
                                    start_epoch=jstep)
    params, step = tckpt.load_checkpoint(tpath, export_jax_params(lenet_niti()))
    model, _ = train_niti(train, test, epochs=2, batch=32, log=tlines.append, device="cpu",
                          checkpoint_path=tpath, start_params=params, start_epoch=step)
    assert step == jstep == 1
    assert_params_equal(export_jax_params(model), to_numpy(jfinal))
    assert_params_equal(tckpt.load_checkpoint(tpath, export_jax_params(lenet_niti()))[0], to_numpy(jfinal))
    assert [ln.split(" lr ")[1].split()[0] for ln in tlines] == \
        [ln.split(" lr ")[1].split()[0] for ln in jlines]
    assert [ln.split(":")[0] for ln in tlines] == ["epoch 0", "epoch 1"]

    straight, _ = train_niti(train, test, epochs=2, batch=32, log=lambda s: None, device="cpu",
                             start_params=start)
    assert any(not np.array_equal(a, b) for a, b in
               zip(flat_weights(export_jax_params(straight)), flat_weights(to_numpy(jfinal))))
