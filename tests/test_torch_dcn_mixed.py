"""Mixed fleets: a JAX rank (`runtime.py -c dcn`) and a port rank
(`python -m pipeedge_tpu_torch.runtime -c dcn`) in one fleet, over an
8-bit edge, in both directions.

The JAX rank's stage and the port's differ in the last bits of their
outputs (f32 sum order), and a value on a rounding boundary of the codec
may then land one level apart at the edge. Each mixed fleet's results
are held to the all-JAX fleet's with the allowance
tests/test_torch_pipeline.py uses where a JAX stage meets a port stage at
a quantized edge: a tenth of the logits' own quantization error (the
all-JAX 8-bit fleet against the exact single-shard forward) plus f32
noise. Every fleet runs under its own time limit.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pipeedge_tpu.models import registry as jreg
from pipeedge_tpu_torch import runtime as truntime
from pipeedge_tpu_torch.models import registry
from pipeedge_tpu_torch.models import vit as tvit
from pipeedge_tpu_torch.utils import data as data_utils

from test_torch_dcn_runtime import PORT, REPO, _run_fleet

pytestmark = pytest.mark.fleet

MODEL = "pipeedge/test-tiny-vit"
JAX = [sys.executable, os.path.join(REPO, "runtime.py"), "--platform", "cpu"]
PORT_CPU = PORT + ["--device", "cpu"]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "tiny-vit.npz"
    np.savez(path, **tvit.random_npz_weights(
        registry.get_model_config(MODEL), seed=21))
    return str(path)


def _fleet(tmp_path, name, weights, rank_cmds):
    d = tmp_path / name
    d.mkdir()
    _run_fleet(d, ["-c", "dcn", "-m", MODEL, "-M", weights, "-b", "16",
                   "-u", "4", "-pt", "1,4,5,8", "-q", "8,0", "-r", "0,1",
                   "--sched-timeout", "60", "--save-results", "r.npz"],
               world=2, cmds=dict(enumerate(rank_cmds)), timeout=120)
    with np.load(d / "r.npz") as f:
        return [f[k] for k in f.files]


@pytest.fixture(scope="module")
def jax_fleet(weights, tmp_path_factory):
    return _fleet(tmp_path_factory.mktemp("jj"), "jj", weights, [JAX, JAX])


@pytest.fixture(scope="module")
def exact(weights):
    """The single-shard forward of the JAX package on the fleet's inputs
    (the synthetic batch both packages draw from the same seed)."""
    fn, params, _ = jreg.module_shard_factory(MODEL, weights, 1, 8)
    out = []
    for x, _ in data_utils.batch_dataset(
            truntime.load_dataset(MODEL, 16), 4):
        out.append(np.asarray(jax.jit(fn)(params, jnp.asarray(x))))
    return out


@pytest.mark.parametrize("ranks", ["jax_port", "port_jax"])
def test_mixed_fleet_near_jax_fleet(ranks, weights, jax_fleet, exact,
                                    tmp_path):
    cmds = [JAX, PORT_CPU] if ranks == "jax_port" else [PORT_CPU, JAX]
    got = _fleet(tmp_path, ranks, weights, cmds)
    assert len(got) == len(jax_fleet) == len(exact) == 4
    for g, w, e in zip(got, jax_fleet, exact):
        quant_err = np.max(np.abs(w - e))
        assert quant_err > 0
        assert np.max(np.abs(g - w)) <= 0.1 * quant_err + 1e-5


def test_port_fleet_near_jax_fleet(weights, jax_fleet, exact, tmp_path):
    """The all-port fleet is held to the all-JAX fleet the same way."""
    got = _fleet(tmp_path, "tt", weights, [PORT_CPU, PORT_CPU])
    for g, w, e in zip(got, jax_fleet, exact):
        assert np.max(np.abs(g - w)) <= 0.1 * np.max(np.abs(w - e)) + 1e-5
