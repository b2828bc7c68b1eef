"""The port's three parallel demos at world 2 through `torch.distributed.run`
(gloo, `--device cpu`), against the JAX demos in a process with two
virtual CPU devices: the same printed lines, losses at their printed
precision. The port starts from the JAX demos' `jax.random` draw, carried
in a checkpoint (`--params`)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from mandheling_tpu.models import lenet_niti as j_lenet
from mandheling_tpu.parallel.pp import homogeneous_blocks as j_blocks
from mandheling_tpu.utils.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300

# demo -> the JAX model whose PRNGKey(0) init it trains at world 2
DEMOS = {
    "DistributedNITITrain": j_lenet,
    "PipelineNITITrain": lambda: j_blocks(4, 32),
    "GPipeLeNetTrain": j_lenet,
}


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=str(ROOT), **extra)
    return env


def _run(cmd, env):
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert out.returncode == 0, f"{cmd} exited {out.returncode}\n{out.stdout}\n{out.stderr}"
    return out.stdout.splitlines()


@pytest.mark.parametrize("demo", list(DEMOS))
def test_parallel_demo_prints_the_jax_lines(demo, tmp_path):
    params = tmp_path / "start.npz"
    save_checkpoint(str(params), DEMOS[demo]().init(jax.random.PRNGKey(0)))
    port = _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "2", "tools/run_train_demo_torch.py", demo, "--epochs", "1",
                 "--device", "cpu", "--params", str(params)], _clean_env())
    want = _run([sys.executable, "tools/run_train_demo.py", demo, "--epochs", "1"],
                _clean_env(JAX_PLATFORMS="cpu",
                           XLA_FLAGS="--xla_force_host_platform_device_count=2"))
    assert port == want
    assert want[0].startswith("mesh: 2 ") or want[1].startswith("mesh: 2 ")
