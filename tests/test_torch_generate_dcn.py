"""`python -m pipeedge_tpu_torch.generate --dcn-addrs --rank --edge-bits`:
decoding across processes, one stage per rank, against the JAX entry's
fleets (`tools/generate.py --dcn-addrs`).

On the tiny GPT-2 over 2 ranks (`-pt 1,4,5,8`, seeded `.npz` weights,
greedy), at edge bits 0 and 8: every row the port's fleet generates
equals the all-JAX fleet's, and so do both mixed fleets' (a JAX rank 0
with a port rank 1, and the other way round: the port's frames, encoded
by `wire_encode_device`, decode in the JAX rank, and the JAX rank's
decode in the port's); the printed `sample continuation ids` (row 0)
agree too. A port rank 0 writes its rows with `--save-ids`; a JAX rank 0
runs `tools/generate.py` through `JAX_RANK0`, which keeps the rows its
`print_summary` is given (the JAX entry prints row 0 only). At bit 0
the rows also equal the one-process run of the port's entry. Every port
rank prints its `rank=R kernel_launches=` line. The fleets of one
bitwidth run at once.
"""
import concurrent.futures
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from pipeedge_tpu_torch import generate
from pipeedge_tpu_torch.models import gpt2 as tgpt2
from pipeedge_tpu_torch.models import registry

from test_torch_dcn_runtime import _addrs

pytestmark = pytest.mark.fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "pipeedge/test-tiny-gpt2"
PORT = [sys.executable, "-m", "pipeedge_tpu_torch.generate", "--device",
        "cpu"]
JAX = [sys.executable, os.path.join(REPO, "tools", "generate.py")]
# the JAX entry as rank 0, keeping every generated row in ids.npz in its
# working directory (the JAX package itself is not changed)
JAX_RANK0 = [sys.executable, "-c", f"""
import importlib.util, sys
import numpy as np
spec = importlib.util.spec_from_file_location("jax_generate", {JAX[1]!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
shown = mod.print_summary
def keep(args, dt, result, label):
    np.savez("ids.npz", ids=result)
    shown(args, dt, result, label)
mod.print_summary = keep
sys.argv[0] = {JAX[1]!r}
mod.main()
"""]
COMBOS = {"port": (PORT, PORT), "jax": (JAX, JAX),
          "jax_port": (JAX, PORT), "port_jax": (PORT, JAX)}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("w") / "tiny-gpt2.npz"
    np.savez(path, **tgpt2.random_npz_weights(
        registry.get_model_config(TINY), seed=3))
    return str(path)


def _argv(weights, bits):
    return ["-m", TINY, "-M", weights, "-pt", "1,4,5,8", "-b", "2",
            "--prompt-len", "6", "--new-tokens", "6",
            "--edge-bits", str(bits)]


def _fleet(tmp_path, cmds, argv):
    """Rank 1 in the background, rank 0 in the foreground; returns both
    ranks' outputs and rank 0's rows."""
    tmp_path.mkdir()
    argv = argv + ["--dcn-addrs", _addrs(2)]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    with open(tmp_path / "rank1.log", "w") as log:
        worker = subprocess.Popen(cmds[1] + argv + ["--rank", "1"],
                                  cwd=tmp_path, env=env, stdout=log,
                                  stderr=subprocess.STDOUT)
    try:
        rank0 = (JAX_RANK0 if cmds[0] is JAX
                 else cmds[0] + ["--save-ids", "ids.npz"])
        data = subprocess.run(rank0 + argv + ["--rank", "0"], cwd=tmp_path,
                              env=env, capture_output=True, text=True,
                              timeout=150)
        worker.wait(timeout=30)
    finally:
        worker.kill()
        worker.wait()
    wout = (tmp_path / "rank1.log").read_text()
    assert data.returncode == 0, data.stdout + data.stderr
    assert worker.returncode == 0, wout
    with np.load(tmp_path / "ids.npz") as f:
        rows = f["ids"]
    return data.stdout, wout, rows


def _ids(out):
    hit = re.search(r"sample continuation ids: (\[[\d, ]*\])", out)
    assert hit is not None, out
    return hit.group(1)


@pytest.mark.parametrize("bits", [0, 8])
def test_dcn_generate_equals_the_jax_fleets(bits, weights, tmp_path):
    argv = _argv(weights, bits)
    with concurrent.futures.ThreadPoolExecutor(len(COMBOS)) as pool:
        futs = {name: pool.submit(_fleet, tmp_path / name, cmds, argv)
                for name, cmds in COMBOS.items()}
        outs = {name: f.result() for name, f in futs.items()}
    ids = {name: _ids(out[0]) for name, out in outs.items()}
    assert len(set(ids.values())) == 1, ids
    rows = {name: out[2] for name, out in outs.items()}
    assert rows["jax"].shape == (2, 12), rows["jax"].shape
    for name, got in rows.items():
        np.testing.assert_array_equal(got, rows["jax"], err_msg=name)
    assert ids["port"] == str(rows["port"][0, 6:].tolist())
    assert "generated 2x6 tokens" in outs["port"][0] \
        and "(2 DCN ranks)" in outs["port"][0]
    for name, (data_out, worker_out, _) in outs.items():
        cmds = COMBOS[name]
        for rank, (cmd, out) in enumerate(zip(cmds, (data_out, worker_out))):
            assert (f"rank={rank} kernel_launches=" in out) == (cmd is PORT)
    if bits == 0:
        # one process: the same ids as the fleet's
        solo = generate.main(["-m", TINY, "-M", weights, "-pt", "1,4,5,8",
                              "-b", "2", "--prompt-len", "6",
                              "--new-tokens", "6", "--device", "cpu"])
        np.testing.assert_array_equal(rows["port"], solo)
