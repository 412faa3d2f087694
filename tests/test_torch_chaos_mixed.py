"""Failover in a mixed fleet: a port data rank with a JAX victim and a JAX
spare (here), and a JAX data rank with a port victim and a port spare
(test_torch_chaos_mixed_jax.py), over the 8-bit edge of
tests/test_torch_dcn_mixed.py.

The last stage dies at its 3rd result send (`kill@3`); the data rank
fails over to the spare and replays, the failover frames leading with
their microbatch ids across the two packages. Every result is delivered
once and held to the unfaulted all-JAX fleet with that file's mixed-fleet
bound (a tenth of the 8-bit fleet's own quantization error plus 1e-5).
"""
import os
import subprocess
import uuid

import numpy as np
import pytest

from pipeedge_tpu_torch import chaos_dcn
from test_torch_chaos_dcn import failed_over
# the fixtures too (the unfaulted all-JAX fleet and the exact forward)
from test_torch_dcn_mixed import (  # noqa: F401
    JAX, PORT_CPU, exact, jax_fleet, weights)
from test_torch_dcn_runtime import REPO, _addrs

pytestmark = pytest.mark.fleet

MODEL = "pipeedge/test-tiny-vit"


def failover_fleet(tmp_path, weights, cmds, victim=1, chaos="kill@3",
                   timeout=150):
    """A 3-rank failover fleet, rank r launched with `cmds[r]`, `chaos`
    armed in the victim; every process of the fleet (a restarted
    incarnation included) is reaped at the end. Returns (the data rank's
    output, each rank's output, the saved results)."""
    tag = uuid.uuid4().hex
    argv = ["-c", "dcn", "-m", MODEL, "-M", weights, "-b", "16", "-u", "4",
            "-pt", "1,4,5,8", "-q", "8,0", "-r", "0,1", "--sched-timeout",
            "60", "--on-peer-death", "failover", "--dcn-addrs", _addrs(3)]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               DCN_CONNECT_TIMEOUT="30", OMP_NUM_THREADS="1",
               **{chaos_dcn.ENV_FLEET_TAG: tag})
    procs, logs = [], []
    for r in (1, 2, 0):
        d = tmp_path / f"rank{r}"
        d.mkdir(parents=True)
        logs.append((r, d / "out.log"))
        extra = (["--save-results", str(tmp_path / "r.npz")] if r == 0
                 else [])
        with open(d / "out.log", "w") as log:
            procs.append((r, subprocess.Popen(
                cmds[r] + [str(r), "3"] + argv + extra, cwd=d,
                env=dict(env, DCN_CHAOS=chaos) if r == victim else env,
                stdout=log, stderr=subprocess.STDOUT)))
    try:
        data = dict(procs)[0]
        data.wait(timeout=timeout)
        survivors = chaos_dcn.reap_fleet(tag, 30.0)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        chaos_dcn.reap_fleet(tag, 0.0)
    outs = {r: log.read_text() for r, log in logs}
    assert data.returncode == 0, "\n".join(
        f"--- rank {r}\n{o[-4000:]}" for r, o in outs.items())
    assert survivors == [], survivors
    with np.load(tmp_path / "r.npz") as f:
        results = [f[f"arr_{i}"] for i in range(len(f.files))]
    return outs, results


def assert_near_jax_fleet(got, jax_results, exact_results):
    assert len(got) == len(jax_results) == len(exact_results) == 4
    for g, w, e in zip(got, jax_results, exact_results):
        quant_err = np.max(np.abs(w - e))
        assert quant_err > 0
        assert np.max(np.abs(g - w)) <= 0.1 * quant_err + 1e-5


def test_port_data_rank_fails_over_a_jax_victim(weights, jax_fleet, exact,
                                                tmp_path):
    outs, got = failover_fleet(tmp_path, weights, [PORT_CPU, JAX, JAX])
    assert failed_over(outs[0]) and "moves rank 1 -> 2" in outs[0]
    assert "unacknowledged microbatch" in outs[0]
    assert "chaos: killing this process before send 3" in outs[1]
    assert_near_jax_fleet(got, jax_fleet, exact)
