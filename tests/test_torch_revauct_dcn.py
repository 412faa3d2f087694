"""`python -m pipeedge_tpu_torch.revauct --comm dcn`: the reverse auction
over the DCN command plane, one process per rank, on the inputs of
tests/test_revauct.py's distributed cases.

- Three port ranks, each bidding only from its own device_types file:
  the schedule equals the port's `--comm local` run, the JAX CLI's
  `--comm local` run and an all-JAX `--comm dcn` fleet's, and every
  bidder is released by the auctioneer's CMD_STOP. A port auctioneer
  also collects JAX bidders' bids.
- A bidder that never starts: the auctioneer fails naming it, and the
  live bidder is released (not timed out).
"""
import os
import subprocess
import sys

import pytest
import yaml

from test_torch_dcn_runtime import _addrs

pytestmark = pytest.mark.fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = [sys.executable, "-m", "pipeedge_tpu_torch.revauct"]
JAX = [sys.executable, os.path.join(REPO, "revauct.py")]
DTYPE = "torch.float32"
N = 8
HOSTS = ["c0", "c1", "c2"]
TIMES = {"c0": 0.01, "c1": 0.02, "c2": 0.04}     # a heterogeneous fleet
MODELS = {"pipeedge/test-tiny-vit": {
    "layers": N, "parameters_in": 768, "parameters_out": [1000] * N,
    "mem_MB": [50.0] * N}}
NEIGHBORS = {h: {o: {"bw_Mbps": 10000} for o in HOSTS if o != h}
             for h in HOSTS}
SCHED = ["-m", "pipeedge/test-tiny-vit", "-u", "2", "--seed", "7",
         "-sch", "throughput_ordered", "--no-strict-order"]


def _dev_type(host):
    return {f"type-{host}": {
        "mem_MB": 300, "bw_Mbps": 10000, "model_profiles": {
            "pipeedge/test-tiny-vit": [{
                "dtype": DTYPE, "batch_size": 2,
                "time_s": [TIMES[host]] * N}]}}}


def _write(d, files):
    d.mkdir(exist_ok=True)
    for name, data in files.items():
        with open(d / name, "w") as f:
            yaml.safe_dump(data, f, default_flow_style=None)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The central files (every type, devices.yml) and one directory per
    rank holding only that rank's own device type."""
    root = tmp_path_factory.mktemp("auction")
    types = {}
    for h in HOSTS:
        types.update(_dev_type(h))
    _write(root / "central", {
        "models.yml": MODELS, "device_types.yml": types,
        "devices.yml": {f"type-{h}": [h] for h in HOSTS},
        "device_neighbors_world.yml": NEIGHBORS})
    for r, h in enumerate(HOSTS):
        _write(root / f"rank{r}", {
            "models.yml": MODELS, "device_types.yml": _dev_type(h),
            "device_neighbors_world.yml": NEIGHBORS})
    return root


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def _local(cmd, root):
    proc = subprocess.run(cmd + ["0", "3"] + SCHED, capture_output=True,
                          env=_env(), cwd=root / "central", text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return yaml.safe_load(proc.stdout)


def _dcn(root, cmds):
    """A 3-rank auction, rank r run by cmds[r]; returns the auctioneer's
    schedule and each bidder's output."""
    opts = SCHED + ["-c", "dcn", "--dcn-addrs", _addrs(3)]

    def argv(r):
        return cmds[r] + [str(r), "3"] + opts + [
            "--host", HOSTS[r], "--dev-type", f"type-{HOSTS[r]}"]

    bidders = [subprocess.Popen(argv(r), cwd=root / f"rank{r}", env=_env(),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
               for r in (1, 2)]
    try:
        auctioneer = subprocess.run(argv(0), capture_output=True,
                                    env=_env(), cwd=root / "rank0",
                                    text=True, timeout=200)
        outs = [b.communicate(timeout=60)[0] for b in bidders]
    finally:
        for b in bidders:
            b.kill()
    assert auctioneer.returncode == 0, auctioneer.stdout + auctioneer.stderr
    for b, out in zip(bidders, outs):
        assert b.returncode == 0, out
        assert "released by auctioneer" in out, out
    return yaml.safe_load(auctioneer.stdout)


def test_dcn_auction_equals_the_local_and_the_jax_ones(fixtures):
    port_local = _local(PORT, fixtures)
    assert port_local == _local(JAX, fixtures)
    port_dcn = _dcn(fixtures, [PORT] * 3)
    assert port_dcn == port_local
    assert port_dcn == _dcn(fixtures, [JAX] * 3)
    covered = [layer for stage in port_dcn for lr in stage.values() if lr
               for layer in range(lr[0], lr[1] + 1)]
    assert covered == list(range(1, N + 1))


def test_port_auctioneer_takes_jax_bids(fixtures):
    assert _dcn(fixtures, [PORT, JAX, JAX]) == _local(PORT, fixtures)


def test_missing_bidder_releases_the_fleet(fixtures):
    opts = SCHED + ["-c", "dcn", "--dcn-addrs", _addrs(3),
                    "--auction-timeout", "120"]
    # a short dial deadline: the auctioneer fails fast on the absent rank
    # and still has time to release the live bidder
    env = dict(_env(), DCN_CONNECT_TIMEOUT="5")
    bidder = subprocess.Popen(
        PORT + ["1", "3"] + opts + ["--host", "c1", "--dev-type", "type-c1"],
        cwd=fixtures / "rank1", env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        auctioneer = subprocess.run(
            PORT + ["0", "3"] + opts + ["--host", "c0", "--dev-type",
                                        "type-c0"],
            capture_output=True, env=env, cwd=fixtures / "rank0", text=True,
            timeout=200)
        bout = bidder.communicate(timeout=60)[0]
    finally:
        bidder.kill()
    assert auctioneer.returncode != 0
    out = auctioneer.stdout + auctioneer.stderr
    assert "undeliverable" in out or "no bid from rank 2" in out, out
    assert bidder.returncode == 0, bout
    assert "released by auctioneer" in bout, bout

