"""The routed fleet of the port's serve entry, on the CPU (tiny GPT-2).

- Adopt path: two replicas of the port's server in this process
  (`--role replica`, paged fp KV), behind the port's router entry run as
  a subprocess (`--role router --replica-addrs`): concurrent clients
  with a prefix registered through the router's `/prefix`, every
  request equal to its solo greedy run.
- Drain: the router's `POST /drain` moves the drained replica's cached
  prefix pages to the survivor (`/kv/export` -> `/kv/import`); the next
  request with that prefix hits the survivor's trie (a span, not a
  prefill of the prefix), and both pools are whole after (free + cached
  pages = all pages, no owner left, nothing leaked).
- Spawned path: `--role router --replicas 2` supervises two replica
  processes; one SIGKILLed in the middle of a burst loses no request,
  respawns with the next epoch and is readmitted by the health polls;
  SIGTERM stops the router and its replicas.
- The router flags parse, and their compositions fail as the JAX
  entry's do.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pipeedge_tpu_torch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "pipeedge/test-tiny-gpt2"
BASE = ["-m", MODEL, "-pt", "1,4,5,8", "--max-len", "48", "-t", "float32"]
PAGED = ["--kv-pages", "64", "--kv-page-size", "4"]
PREFIX = [5, 17, 29, 41, 53, 65, 77, 89]          # two whole pages of 4


def _post(port, path, obj, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return json.loads(resp.read())


class _Replica:
    """A port server in this process, as a replica behind a router."""

    def __init__(self):
        args = serve.parse_args(BASE + PAGED + [
            "--device", "cpu", "--role", "replica",
            "--governor-interval", "0.05"])
        self.service = serve.make_service(args, serve.build_pipeline(args))
        self.httpd = serve.Server(("127.0.0.1", 0),
                                  serve.make_handler(self.service, MODEL))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def pool_whole(self) -> bool:
        kv = self.service.kv_backend
        pool, trie = kv.pool.stats(), kv.trie.stats()
        return (pool["pages_free"] + trie["pages_cached"]
                == pool["pages_total"] and pool["owners"] == 0
                and pool["leaked"] == 0)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.stop()
        self.thread.join(timeout=30)


def _spawn_router(argv, timeout=120):
    """The port's router entry as a subprocess; returns (proc, port,
    lines) once it printed its serving line."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pipeedge_tpu_torch.serve", "--role",
         "router", "--port", "0", "--router-poll-interval", "0.1"] + argv,
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    deadline = time.monotonic() + timeout
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("serving router"):
            break
        if time.monotonic() > deadline:
            break
    else:
        raise AssertionError("".join(lines))
    threading.Thread(target=lambda: lines.extend(proc.stdout),
                     daemon=True).start()
    return proc, lines


def _router_port(proc_lines):
    line = next(ln for ln in proc_lines if ln.startswith("serving router"))
    return int(line.rsplit(":", 1)[1])


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope="module")
def oracle():
    """Solo greedy runs on the replicas' weights: `solo(ids, new)` the
    whole prompt's prefill, `solo(suffix, new, prefix=True)` PREFIX's
    cache then a span over the suffix (what a trie-sharing request runs),
    returning suffix + continuation as the server does."""
    args = serve.parse_args(BASE + ["--device", "cpu"])
    pipe = serve.build_pipeline(args)
    handle = pipe.precompute_prefix(np.asarray([PREFIX]))

    def solo(ids, new, prefix=False):
        out = pipe.generate(np.asarray([ids]), new,
                            prefix=handle if prefix else None)
        return out[0].cpu().numpy().tolist()
    return solo


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 90, size=int(rng.integers(3, 9))).tolist(),
             int(rng.integers(3, 8))) for _ in range(n)]


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


@pytest.mark.fleet
def test_adopted_replicas_serve_solo_tokens_and_drain_migrates(oracle):
    reps = [_Replica(), _Replica()]
    proc = None
    try:
        proc, lines = _spawn_router(
            ["--replica-addrs",
             ",".join(f"127.0.0.1:{r.port}" for r in reps)])
        port = _router_port(lines)
        health = _get(port, "/healthz")
        assert health["role"] == "router" and health["ok"]
        assert sorted(health["fleet"]) == ["r0", "r1"]
        pid = _post(port, "/prefix", {"ids": PREFIX})["prefix_id"]
        # the prefix alone first: its pages enter the owner's trie, so
        # every sharer below spans its suffix on them
        published = _post(port, "/generate", {"ids": [PREFIX],
                                              "new_tokens": 2})
        assert published["ids"] == [oracle(PREFIX, 2)]
        reqs = _requests(8)
        out = [None] * len(reqs)

        def client(i):
            ids, new = reqs[i]
            body = {"ids": [ids], "new_tokens": new}
            if i % 2:
                body["prefix_id"] = pid
            out[i] = _post(port, "/generate", body)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, (ids, new) in enumerate(reqs):
            assert out[i]["ids"] == [oracle(ids, new, prefix=i % 2 == 1)], i
        # the prefix requests stuck to one replica (affinity): drain it
        owner = next(n for n, r in zip(("r0", "r1"), reps)
                     if r.service.kv_backend.shared_prompt_tokens(
                         PREFIX + [1]) >= len(PREFIX))
        src = reps[int(owner[1])]
        dst = reps[1 - int(owner[1])]
        assert dst.service.kv_backend.shared_prompt_tokens(
            PREFIX + [1]) == 0
        res = _post(port, "/drain", {"replica": owner})
        assert res["drained"] and res["migrated_prefixes"] >= 1
        assert res["target"] != owner
        assert src.service.draining
        assert dst.service.kv_backend.shared_prompt_tokens(
            PREFIX + [1]) == len(PREFIX)
        # the next prefix request hits the survivor's trie: a span over
        # the suffix, no prefill of the prefix
        steps0 = dict(dst.service.batcher.kind_steps[0])
        ids, new = [3, 4, 5], 4
        got = _post(port, "/generate", {"ids": [ids], "new_tokens": new,
                                        "prefix_id": pid})
        assert got["ids"] == [oracle(ids, new, prefix=True)]
        steps1 = dst.service.batcher.kind_steps[0]
        assert steps1["span"] == steps0["span"] + 1
        assert steps1["prefill"] == steps0["prefill"]
        assert _get(port, "/healthz")["fleet"][owner]["state"] == "drained"
        assert _wait(lambda: all(r.pool_whole() for r in reps))
    finally:
        if proc is not None:
            assert _stop(proc) == 0
        for r in reps:
            r.close()


def _replica_pids(port):
    workers = _get(port, "/healthz")["workers"]
    return {int(k): v for k, v in workers.items()}


@pytest.mark.fleet
def test_spawned_replica_killed_mid_burst_loses_nothing(oracle):
    proc, lines = _spawn_router(["--replicas", "2", "--device", "cpu"]
                                + BASE, timeout=180)
    try:
        port = _router_port(lines)
        assert _wait(lambda: all(
            r["state"] == "healthy"
            for r in _get(port, "/healthz")["fleet"].values()))
        before = _replica_pids(port)
        assert [before[r]["epoch"] for r in (0, 1)] == [0, 0]
        reqs = _requests(12, seed=1)
        out = [None] * len(reqs)
        errors = []

        def client(i):
            ids, new = reqs[i]
            try:
                out[i] = _post(port, "/generate",
                               {"ids": [ids], "new_tokens": new})
            except (urllib.error.URLError, OSError) as exc:
                errors.append((i, exc))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        for t in threads[:6]:
            t.start()
        os.kill(before[0]["pid"], signal.SIGKILL)
        for t in threads[6:]:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        for i, (ids, new) in enumerate(reqs):
            assert out[i]["ids"] == [oracle(ids, new)], i
        # respawned with the next epoch and readmitted by the polls
        assert _wait(lambda: _replica_pids(port)[0]["epoch"] == 1
                     and _replica_pids(port)[0]["alive"], timeout=120)
        assert _wait(lambda: _get(port, "/healthz")["fleet"]["r0"]["state"]
                     == "healthy", timeout=120)
        after = _replica_pids(port)
        assert after[0]["pid"] != before[0]["pid"]
        assert after[1]["pid"] == before[1]["pid"]
        ids, new = [7, 8, 9], 5
        assert _post(port, "/generate", {"ids": [ids], "new_tokens": new}
                     )["ids"] == [oracle(ids, new)]
        pids = [after[0]["pid"], after[1]["pid"]]
    finally:
        rc = _stop(proc)
    assert rc == 0
    for p in pids:          # the router stopped its replicas
        assert _wait(lambda: not os.path.exists(f"/proc/{p}") or open(
            f"/proc/{p}/stat").read().split()[2] == "Z", timeout=30)
    assert any("decode replica rank 0 died" in ln for ln in lines)
    assert any("decode replica rank 0 spawned" in ln and "epoch=1" in ln
               for ln in lines)


def test_router_flags_parse_and_compose_as_the_jax_entry(capsys):
    args = serve.parse_args(BASE + [
        "--role", "router", "--replicas", "3", "--no-replica-respawn",
        "--router-poll-interval", "0.2", "--router-health-timeout", "1",
        "--route-timeout", "30", "--route-retries", "1", "--hedge-ms", "50",
        "--drain-timeout", "9"])
    assert (args.role, args.replicas, args.no_replica_respawn,
            args.hedge_ms, args.drain_timeout) == ("router", 3, True, 50.0,
                                                   9.0)
    cmd = serve.replica_command(serve.parse_args(
        BASE + PAGED + ["--role", "router", "--device", "cpu",
                        "--class-rate", "batch=2"]))
    assert cmd[:2] == ["--role", "replica"]
    assert cmd[cmd.index("-pt") + 1] == "1,4,5,8"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--kv-pages") + 1] == "64"
    assert cmd[cmd.index("--class-rate") + 1] == "batch=2.0"
    # the JAX entry's parse errors (tools/serve.py), word for word
    for argv, msg in (
            (["--role", "router", "--replicas", "0"],
             "--replicas must be >= 1 (or pass --replica-addrs)"),
            (["--role", "router", "--hedge-ms", "-1"],
             "--hedge-ms must be >= 0"),
            (["--role", "router", "--route-retries", "-1"],
             "--route-retries must be >= 0"),
            (["--replica-addrs", "127.0.0.1:1"],
             "--replica-addrs only applies with --role router")):
        capsys.readouterr()
        with pytest.raises(SystemExit) as exc:
            serve.parse_args(BASE + argv)
        assert exc.value.code == 2
        assert capsys.readouterr().err.strip().endswith(f"error: {msg}")


# each flag the router slice took off `serve.REFUSED`, with a value that
# differs from its default
ROUTER_FLAGS = {"--role": ["replica"], "--replicas": ["3"],
                "--replica-addrs": ["127.0.0.1:1", "--role", "router"],
                "--no-replica-respawn": [],
                "--router-poll-interval": ["0.2"],
                "--router-health-timeout": ["1.5"],
                "--route-timeout": ["30"], "--route-retries": ["1"],
                "--hedge-ms": ["50"], "--drain-timeout": ["9"]}


@pytest.mark.parametrize("flag", sorted(ROUTER_FLAGS))
def test_router_flags_accepted(flag):
    assert flag not in serve.REFUSED
    default = serve.parse_args(BASE)
    args = serve.parse_args(BASE + [flag, *ROUTER_FLAGS[flag]])
    name = flag.lstrip("-").replace("-", "_")
    assert getattr(args, name) != getattr(default, name)


def test_replica_refuses_kv_export_without_pages():
    args = serve.parse_args(BASE + ["--device", "cpu", "--role", "replica"])
    service = serve.make_service(args, serve.build_pipeline(args))
    try:
        with pytest.raises(ValueError, match="--kv-pages"):
            service.kv_export([1, 2, 3])
        with pytest.raises(ValueError, match="--kv-pages"):
            service.kv_import([1, 2, 3], "")
        service.begin_drain()
        with pytest.raises(RuntimeError, match="draining"):
            service._check_admittable()
    finally:
        service.stop()
