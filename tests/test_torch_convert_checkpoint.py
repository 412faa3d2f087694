"""`python -m pipeedge_tpu_torch.convert_checkpoint`: per-stage checkpoints
that a `runtime -c dcn --stage-ckpt` fleet restores.

The tiny ViT's seeded npz cut at `-pt 1,4,5,8` by the entry (one stage
directory each, the manifest, the JAX tool's `stage I [L, R] -> DIR`
lines), then a 2-rank DCN fleet on the CPU restoring each rank's stage
from those directories: its results equal the same fleet's on the whole
archive.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pipeedge_tpu_torch import convert_checkpoint
from pipeedge_tpu_torch.models import registry
from pipeedge_tpu_torch.models import vit as tvit

pytestmark = pytest.mark.fleet   # spawns the entry and the fleet's ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "pipeedge/test-tiny-vit"
PARTITION = [(1, 4), (5, 8)]


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def _addrs(world):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(world)]
    addrs = ",".join(f"127.0.0.1:{s.getsockname()[1]}" for s in socks)
    for s in socks:
        s.close()
    return addrs


def _fleet(cwd, opts, world=2, timeout=90):
    """A `world`-rank CPU fleet: the workers in the background, the data
    rank in the foreground; every process is gone when it returns."""
    cmd = [sys.executable, "-m", "pipeedge_tpu_torch.runtime", "--device",
           "cpu"]
    argv = opts + ["--dcn-addrs", _addrs(world)]
    workers = []
    for r in range(1, world):
        with open(cwd / f"rank{r}.log", "w") as log:
            workers.append(subprocess.Popen(
                cmd + [str(r), str(world)] + argv, cwd=cwd, env=_env(),
                stdout=log, stderr=subprocess.STDOUT))
    try:
        data = subprocess.run(cmd + ["0", str(world)] + argv, cwd=cwd,
                              env=_env(), capture_output=True, text=True,
                              timeout=timeout)
        for w in workers:
            w.wait(timeout=30)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    assert data.returncode == 0, data.stdout + data.stderr
    assert all(w.returncode == 0 for w in workers), [
        (cwd / f"rank{r}.log").read_text() for r in range(1, world)]


def test_entry_cuts_stages_a_dcn_fleet_restores(tmp_path):
    npz = tmp_path / "w.npz"
    np.savez(npz, **tvit.random_npz_weights(registry.get_model_config(MODEL),
                                            seed=3))
    out = tmp_path / "ckpt"
    run = subprocess.run(
        [sys.executable, "-m", "pipeedge_tpu_torch.convert_checkpoint",
         "-m", MODEL, "-M", str(npz), "-pt", "1,4,5,8", "-o", str(out)],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    dirs = [str(out / f"stage_{i:03d}") for i in range(2)]
    assert run.stdout.splitlines() == [
        f"stage {i} [{l}, {r}] -> {d}"
        for i, ((l, r), d) in enumerate(zip(PARTITION, dirs))]
    assert json.loads((out / "manifest.json").read_text()) == {
        "model_name": MODEL, "partition": [list(p) for p in PARTITION]}
    with np.load(os.path.join(dirs[0], "params.npz")) as s0, \
            np.load(os.path.join(dirs[1], "params.npz")) as s1, \
            np.load(npz) as whole:
        assert not set(s0.files) & set(s1.files)
        assert set(s0.files) | set(s1.files) <= set(whole.files)
    common = ["-c", "dcn", "-m", MODEL, "-b", "8", "-u", "4", "-pt",
              "1,4,5,8", "-q", "0,0"]
    _fleet(tmp_path, common + ["-M", str(npz), "--save-results",
                               "whole.npz"])
    _fleet(tmp_path, common + ["--stage-ckpt", str(out), "--save-results",
                               "staged.npz"])
    with np.load(tmp_path / "whole.npz") as w, \
            np.load(tmp_path / "staged.npz") as s:
        assert len(w.files) == len(s.files) == 2
        for k in w.files:
            np.testing.assert_array_equal(s[k], w[k])


def test_partition_must_be_layer_pairs(tmp_path):
    with pytest.raises(SystemExit) as exc:
        convert_checkpoint.main(["-m", MODEL, "-pt", "1,4,5", "-o",
                                 str(tmp_path)])
    assert exc.value.code == 2
