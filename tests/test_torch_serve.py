"""The port's serve entry (`pipeedge_tpu_torch/serve.py`) against the JAX
package's (`tools/serve.py`).

The port's server runs in process on the CPU (its `make_handler` behind
its `ThreadingHTTPServer`, the plain versions of the kernels), on
`pipeedge/test-tiny-gpt2`, `-pt 1,4,5,8 --max-len 48 -t float32`, with
the seeded random weights both packages draw per shard when no weights
file is given. It is held to:

- the JAX `DecodePipeline`'s solo runs on the same weights (the oracle
  `tests/test_serve.py` uses): `/generate` tokens, plain and streamed,
  fp and int8 caches, both executors, prefix reuse, eos masking and
  concurrent clients, compared exactly;
- the JAX server itself, spawned as `tests/test_serve.py` spawns it: the
  same 400s for malformed requests (streaming too), the same `/healthz`
  key sets, the same `/metrics` families and label sets for what both
  serve, the same degraded -> healing -> healed phases, 503s and
  Retry-After values, and the same answer to `"speculative": true`;
- the paged KV plane and speculative generation against the JAX server
  run with the same flags: the same tokens (plain, streamed, chunked,
  trie-shared, speculative), the same `kv` / `scheduler` key sets in
  /healthz and `pipeedge_kv_*` families in /metrics, and the same parse
  errors for the flags' compositions;
- the tiny Llama (GQA) on the paged, chunked server: each of a few
  concurrent requests equal to its solo run through a dense executor
  that chunks as the server does (fp and int8 caches, both executors),
  and on fp to the JAX `DecodePipeline`'s greedy run;
- disaggregated prefill (`--disaggregate wire`): the JAX server's tokens,
  `kv` key sets in /healthz and `pipeedge_kv_*` families in /metrics, and
  its parse errors for the family's flags;
- its own contracts: deadline 504s under `--inject-stall`, every flag of
  the JAX server parsing (`serve.REFUSED` is empty), `--device cuda`
  raising on a host without a GPU, and the entry serving one request and
  exiting 0 on SIGTERM as a subprocess, writing its `--trace-spans`
  trace.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pipeedge_tpu_torch import serve
from pipeedge_tpu_torch.telemetry.collector import parse_prom_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "pipeedge/test-tiny-gpt2"
PARTITION = [(1, 4), (5, 8)]
BASE = ["-m", MODEL, "-pt", "1,4,5,8", "--max-len", "48", "-t", "float32"]
# cache mode -> server flags (and the JAX oracle's cache_bits, opt-in)
CACHES = {"fp": ([], (0, 0)),
          "int8": (["--kv-bits", "8", "--int8-decode-attend", "1"], (8, 1))}


def _post(port, path, obj, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        body = resp.read().decode()
    return body if path == "/metrics" else json.loads(body)


def _error(port, path, obj):
    """(status, JSON body, Retry-After) of a request that must fail."""
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, path, obj)
    return (err.value.code, json.loads(err.value.read()),
            err.value.headers.get("Retry-After"))


def _stream(port, obj, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(dict(obj, stream=True)).encode())
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return [json.loads(ln) for ln in resp.read().decode().splitlines()
                if ln.strip()]


class _PortServer:
    """The port's server in this process on a free port."""

    def __init__(self, argv):
        args = serve.parse_args(BASE + ["--device", "cpu",
                                        "--governor-interval", "0.05",
                                        *argv])
        pipe = serve.build_pipeline(args)
        fleet, _, _ = serve.build_prefill_fleet(args, pipe)
        self.service = serve.make_service(args, pipe, prefill_fleet=fleet)
        self.httpd = serve.Server(("127.0.0.1", 0),
                                  serve.make_handler(self.service, MODEL))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.stop()
        self.thread.join(timeout=30)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(executor, cache) -> a running port server."""
    pm = str(tmp_path_factory.mktemp("postmortems"))
    out = {(ex, cache): _PortServer(["--executor", ex, "--postmortem-dir",
                                     pm, *flags])
           for ex in ("wave", "stage")
           for cache, (flags, _) in CACHES.items()}
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(scope="module")
def oracles():
    """cache -> the JAX `DecodePipeline` on the weights both servers
    draw (`module_shard_factory` without a weights file, per stage)."""
    from pipeedge_tpu.models import registry
    from pipeedge_tpu.parallel import decode
    params = [registry.module_shard_factory(MODEL, None, l, r, stage=i,
                                            unroll=False)[1]
              for i, (l, r) in enumerate(PARTITION)]
    return {cache: decode.DecodePipeline(
        registry.get_model_entry(MODEL).family.FAMILY,
        registry.get_model_config(MODEL), PARTITION, params, max_len=48,
        cache_bits=bits, int8_decode_attend=optin)
        for cache, (_, (bits, optin)) in CACHES.items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(cmd, env):
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=REPO)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("serving "):
            return proc, line
        if proc.poll() is not None:
            raise RuntimeError(f"server died: {proc.stdout.read()}")
    proc.kill()
    raise RuntimeError("server never came up")


@pytest.fixture(scope="module")
def jax_server():
    """`tools/serve.py` on the same model and flags (wave executor)."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc, _ = _spawn([sys.executable, os.path.join(REPO, "tools",
                                                   "serve.py"),
                      *BASE, "--port", str(port)], env)
    yield port
    proc.terminate()
    proc.wait(timeout=30)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 100, size=shape).tolist()


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_generate_plain_and_streamed_match_jax(servers, oracles, executor,
                                               cache):
    port = servers[(executor, cache)].port
    ids = _ids(3, (2, 8))
    want = np.asarray(oracles[cache].generate(np.asarray(ids), 6))
    got = _post(port, "/generate", {"ids": ids, "new_tokens": 6})
    np.testing.assert_array_equal(np.asarray(got["ids"]), want)
    assert got["rid"].startswith("q")
    lines = _stream(port, {"ids": ids, "new_tokens": 6})
    final = lines[-1]
    np.testing.assert_array_equal(np.asarray(final["ids"]), want)
    assert final["steps"] == 6 and final["first_token_ms"] > 0
    steps = np.asarray([ln["tokens"] for ln in lines[:-1]])   # [T, B]
    np.testing.assert_array_equal(steps.T, want[:, 8:])


@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_prefix_reuse_and_eos_match_jax(servers, oracles, executor):
    port = servers[(executor, "fp")].port
    prefix = _ids(9, (6,))
    reg = _post(port, "/prefix", {"ids": prefix})
    assert reg["len"] == 6
    handle = oracles["fp"].precompute_prefix(np.asarray([prefix]))
    suffix = _ids(10, (2, 3))
    want = np.asarray(oracles["fp"].generate(np.asarray(suffix), 5,
                                             prefix=handle))
    got = _post(port, "/generate", {"ids": suffix, "new_tokens": 5,
                                    "prefix_id": reg["prefix_id"]})
    np.testing.assert_array_equal(np.asarray(got["ids"]), want)
    # eos from row 0's third token: row 0 masked after it
    ids = _ids(11, (2, 5))
    solo = np.asarray(oracles["fp"].generate(np.asarray(ids), 8))
    eos = int(solo[0, 5 + 2])
    final = _stream(port, {"ids": ids, "new_tokens": 8,
                           "eos_token": eos})[-1]
    plain = _post(port, "/generate", {"ids": ids, "new_tokens": 8,
                                      "eos_token": eos})
    assert final["ids"] == plain["ids"]
    got = np.asarray(plain["ids"])
    first = int(np.argmax(got[0, 5:] == eos))
    assert (got[0, 5 + first:] == eos).all()
    np.testing.assert_array_equal(got[:, :5 + first + 1],
                                  solo[:, :5 + first + 1])


@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_concurrent_clients_match_jax(servers, oracles, executor):
    port = servers[(executor, "int8")].port
    reqs = [(_ids(20 + i, (1 + i % 2, 4 + i % 3)), 3 + i % 4)
            for i in range(8)]
    out = {}

    def client(i):
        ids, n = reqs[i]
        out[i] = _post(port, "/generate", {"ids": ids, "new_tokens": n})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, (ids, n) in enumerate(reqs):
        want = np.asarray(oracles["int8"].generate(np.asarray(ids), n))
        np.testing.assert_array_equal(np.asarray(out[i]["ids"]), want)
    stats = _get(port, "/healthz")["stats"]
    assert stats["active"] == 0 and stats["tokens"] > 0
    if executor == "stage":
        assert len(stats["stage_steps"]) == 2 and stats["queued"] == [0, 0]


MALFORMED = [{"ids": [], "new_tokens": 2},
             {"ids": [[]], "new_tokens": 2},
             {"ids": [[1, 2]], "new_tokens": 0},
             {"ids": [[1, 2]], "new_tokens": 2, "prefix_id": "nope"},
             {"ids": [[1, 2]], "new_tokens": 2, "class": "vip"},
             {"ids": [[1, 2]], "new_tokens": 2, "deadline_ms": -5},
             {"ids": [[1, 2]], "new_tokens": 60},
             {"ids": [[1, 2]]},
             {"new_tokens": 2},
             {"ids": [[1, 2]], "new_tokens": 2, "speculative": True,
              "temperature": 0.5}]


@pytest.mark.fleet
@pytest.mark.parametrize("stream", [False, True])
def test_malformed_requests_same_400s(servers, jax_server, stream):
    port = servers[("wave", "fp")].port
    for bad in MALFORMED:
        body = dict(bad, stream=True) if stream else bad
        got, want = _error(port, "/generate", body), \
            _error(jax_server, "/generate", body)
        assert got[0] == want[0] == 400, bad
        assert got[1] == want[1], bad
    # still serving afterwards
    assert len(_post(port, "/generate", {"ids": [[5, 6, 7]],
                                         "new_tokens": 2})["ids"][0]) == 5


@pytest.mark.fleet
def test_speculative_unavailable_like_jax(servers, jax_server):
    body = {"ids": [[1, 2, 3]], "new_tokens": 2, "speculative": True}
    got = _error(servers[("wave", "fp")].port, "/generate", body)
    assert got == _error(jax_server, "/generate", body)
    assert got[0] == 400 and "unavailable" in got[1]["error"]


def _key_sets(health):
    return {"top": sorted(health), "serving": sorted(health["serving"]),
            "admission": sorted(health["serving"]["admission"]),
            "brownout": sorted(health["serving"]["brownout"]),
            "flight": sorted(health["flight"]),
            "stats": sorted(health["stats"])}


@pytest.mark.fleet
def test_healthz_keys_match_jax(servers, jax_server):
    got = _get(servers[("wave", "fp")].port, "/healthz")
    want = _get(jax_server, "/healthz")
    assert _key_sets(got) == _key_sets(want)
    assert got["peer_health"] == want["peer_health"] == {}
    assert got["executor"] == want["executor"] == "wave"
    assert got["stages"] == want["stages"] == 2
    stage = _get(servers[("stage", "fp")].port, "/healthz")
    assert {"stage_steps", "busy", "queued"} <= set(stage["stats"])


def _families(text):
    """{family: set of label-key tuples} of a /metrics body, histogram
    children folded into their family."""
    out = {}
    for name, rows in parse_prom_text(text).items():
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and f"# TYPE {name[:-len(suffix)]} " \
                    "histogram" in text:
                name = name[:-len(suffix)]
        out.setdefault(name, set()).update(
            tuple(sorted(k for k in labels if k != "le"))
            for labels, _ in rows)
    return out


@pytest.mark.fleet
def test_metrics_families_match_jax(jax_server, tmp_path):
    """The port's server entry (wave executor, fp cache: the JAX
    server's flags) in its own process, as the JAX server is: the
    registry of an in-process server also holds the families of
    whatever else this test process imported (the router's, once a
    routed-fleet test ran here)."""
    port = _free_port()
    proc, _ = _spawn([sys.executable, "-m", "pipeedge_tpu_torch.serve",
                      *BASE, "--device", "cpu", "--port", str(port),
                      "--postmortem-dir", str(tmp_path)],
                     dict(os.environ, PYTHONPATH=REPO))
    try:
        for p in (port, jax_server):
            _post(p, "/generate", {"ids": [[1, 2, 3]], "new_tokens": 2})
        got = _families(_get(port, "/metrics"))
        want = _families(_get(jax_server, "/metrics"))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    # every family the port serves is the JAX server's, with its labels
    for name, labels in got.items():
        assert want.get(name) == labels, name
    serving = {n for n in want if n.startswith((
        "pipeedge_serve_", "pipeedge_requests_", "pipeedge_admission_",
        "pipeedge_brownout_", "pipeedge_slo_", "pipeedge_deadline_",
        "pipeedge_decode_steps", "pipeedge_prefill_chunks",
        "pipeedge_postmortems_"))}
    assert serving - {"pipeedge_admission_tokens_free"} <= set(got)


def _lifecycle(port):
    """The degraded -> healing -> healed walk: (status, Retry-After,
    phase) at each step, and the counters' moves."""
    health = lambda: _get(port, "/healthz")   # noqa: E731
    before = health()["stats"]
    out = []
    _post(port, "/degraded", {"degraded": True, "dead_rank": 1,
                              "retry_after": 2})
    h = health()
    out.append(("degraded", h["ok"], h["degraded"]["phase"],
                h["degraded"]["dead_rank"], h["degraded"]["retry_after"]))
    code, body, ra = _error(port, "/generate", {"ids": [[1, 2, 3]],
                                                "new_tokens": 2})
    out.append((code, ra, body["degraded"], body["dead_rank"]))
    out.append(_error(port, "/prefix", {"ids": [1, 2, 3]})[::2])
    _post(port, "/degraded", {"degraded": True, "healing": True})
    h = health()
    out.append(("healing", h["degraded"]["phase"],
                h["degraded"]["dead_rank"]))
    out.append(_error(port, "/generate", {"ids": [[1, 2, 3]],
                                          "new_tokens": 2})[::2])
    out.append(_post(port, "/degraded", {"degraded": False, "healed": True,
                                         "rank": 1}))
    after = health()["stats"]
    out.append((health()["degraded"],
                after["rejoined_ranks_total"] - before["rejoined_ranks_total"],
                after["degraded_entered_total"]
                - before["degraded_entered_total"], after["last_dead_rank"]))
    # a stray healing signal with no window open resurrects nothing; a
    # plain clear is not a rejoin; a window without a hint derives 5 s
    _post(port, "/degraded", {"degraded": True, "healing": True})
    _post(port, "/degraded", {"degraded": True, "dead_rank": 2})
    out.append(_error(port, "/generate", {"ids": [[1, 2, 3]],
                                          "new_tokens": 2})[::2])
    _post(port, "/degraded", {"degraded": False})
    out.append((health()["degraded"],
                health()["stats"]["rejoined_ranks_total"]
                - before["rejoined_ranks_total"]))
    out.append(len(_post(port, "/generate", {"ids": [[1, 2, 3]],
                                             "new_tokens": 2})["ids"][0]))
    return out


@pytest.mark.fleet
def test_degraded_lifecycle_matches_jax(servers, jax_server):
    got = _lifecycle(servers[("stage", "fp")].port)
    assert got == _lifecycle(jax_server)
    assert got[1] == (503, "2", True, 1)


def test_deadline_504_under_inject_stall(tmp_path, capsys):
    srv = _PortServer(["--inject-stall", "1:40", "--postmortem-dir",
                       str(tmp_path)])
    try:
        assert "chaos: injecting 40ms stall" in capsys.readouterr().out
        code, body, ra = _error(srv.port, "/generate", {
            "ids": [[1, 2, 3]], "new_tokens": 30, "deadline_ms": 300})
        assert code == 504 and body["deadline_exceeded"] and ra is None
        assert body["class"] == "interactive" and body["rid"]
        health = _get(srv.port, "/healthz")
        assert health["serving"]["deadline_exceeded_total"] == 1
        assert health["flight"]["postmortems_written_total"] >= 1
        assert any(p.name.endswith("-deadline.json")
                   for p in tmp_path.iterdir())
        # a streamed request past its deadline ends in a terminal line
        lines = _stream(srv.port, {"ids": [[1, 2, 3]], "new_tokens": 30,
                                   "deadline_ms": 300})
        assert "error" in lines[-1] and len(lines) < 31
        dump = _post(srv.port, "/debug/dump", {"rid": body["rid"]})
        assert dump["path"] and dump["written_total"] >= 2
        spans = _get(srv.port, "/debug/spans?drain=0")
        assert {"pid", "rank", "enabled", "spans"} <= set(spans)
    finally:
        srv.close()


# each flag the disaggregation slice took off `serve.REFUSED` (which is
# empty now), with a value other than its default
DISAGG_FLAGS = {"--disaggregate": ["wire", "--kv-pages", "8"],
                "--prefill-ranks": ["2"], "--prefill-lease-timeout": ["1.5"],
                "--prefill-attempts": ["2"], "--no-prefill-respawn": [],
                "--prefill-heartbeat-interval": ["0.25"],
                "--prefill-concurrency": ["3"], "--kv-ship-bits": ["8"]}


@pytest.mark.parametrize("flag", sorted(DISAGG_FLAGS))
def test_disaggregation_flags_parse(flag):
    assert not serve.REFUSED
    args = serve.parse_args(BASE + [flag, *DISAGG_FLAGS[flag]])
    dest = flag.lstrip("-").replace("-", "_")
    assert getattr(args, dest) != serve.build_parser().get_default(dest)


def test_accepted_flags_parse():
    args = serve.parse_args(BASE + [
        "--executor", "stage", "--max-active", "4", "--class-rate",
        "batch=2", "--class-deadline", "interactive=1.5", "--no-brownout",
        "--queue-capacity", "8", "--slo-objective", "0.95"])
    assert args.partition == PARTITION and args.device == "cuda"
    assert args.class_rate == {"batch": 2.0}
    assert args.class_deadline == {"interactive": 1.5}
    with pytest.raises(SystemExit):
        serve.parse_args(BASE + ["--class-rate", "vip=2"])


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(BASE + ["--port", "0"])


@pytest.mark.fleet
def test_entry_serves_and_exits_on_sigterm(oracles, tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc, line = _spawn([sys.executable, "-m", "pipeedge_tpu_torch.serve",
                         *BASE, "--device", "cpu", "--port", str(port),
                         "--executor", "stage", "--postmortem-dir",
                         str(tmp_path), "--trace-spans",
                         str(tmp_path / "trace.json")], env)
    try:
        assert line.strip() == (f"serving {MODEL} (2 stages, stage "
                                f"executor) on 127.0.0.1:{port}")
        ids = _ids(31, (1, 6))
        got = _post(port, "/generate", {"ids": ids, "new_tokens": 4})
        want = np.asarray(oracles["fp"].generate(np.asarray(ids), 4))
        np.testing.assert_array_equal(np.asarray(got["ids"]), want)
        assert _get(port, "/healthz")["executor"] == "stage"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        # the shutdown trace holds the request's per-stage spans
        trace = json.loads((tmp_path / "trace.json").read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert {"exec0", "exec1", "generate"} <= names
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# the paged KV plane and speculative generation at the server
# ---------------------------------------------------------------------------

# the port's paged servers and the JAX one: a 32-page pool of 4 tokens,
# prompts past 4 tokens in chunks, admission re-driven at each step, and
# speculative requests drafted by the tiny GPT-2 itself (one stage)
PAGED = ["--kv-pages", "32", "--kv-page-size", "4", "--chunked-prefill", "4",
         "--step-join", "--draft-model", MODEL, "--gamma", "3"]


@pytest.fixture(scope="module")
def paged_servers(tmp_path_factory):
    """executor -> a running paged port server (fp cache, draft model)."""
    pm = str(tmp_path_factory.mktemp("postmortems_paged"))
    out = {ex: _PortServer(["--executor", ex, "--postmortem-dir", pm,
                            *PAGED]) for ex in ("wave", "stage")}
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(scope="module")
def jax_paged_server():
    """`tools/serve.py` with the same paged and speculative flags."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc, _ = _spawn([sys.executable, os.path.join(REPO, "tools",
                                                   "serve.py"),
                      *BASE, *PAGED, "--port", str(port)], env)
    yield port
    proc.terminate()
    proc.wait(timeout=30)


def _paged_bodies():
    """Request bodies: plain two-row, a single row long enough to chunk,
    and a row on a registered 8-token prefix (sent twice: the second
    reuses the first one's published pages)."""
    return [{"ids": _ids(41, (2, 6)), "new_tokens": 6},
            {"ids": _ids(42, (1, 11)), "new_tokens": 7},
            {"ids": _ids(43, (1, 3)), "new_tokens": 5, "prefix": True},
            {"ids": _ids(43, (1, 3)), "new_tokens": 5, "prefix": True}]


def _paged_traffic(port):
    pid = _post(port, "/prefix", {"ids": _ids(40, (8,))})["prefix_id"]
    out = []
    for body in _paged_bodies():
        body = dict(body)
        if body.pop("prefix", False):
            body["prefix_id"] = pid
        out.append(_post(port, "/generate", body)["ids"])
        out.append(_stream(port, body)[-1]["ids"])
    return out


@pytest.mark.fleet
@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_paged_generate_matches_jax(paged_servers, jax_paged_server,
                                    oracles, executor):
    """/generate on --kv-pages (plain and streamed, chunked, on a
    trie-shared registered prefix) answers the JAX paged server's tokens,
    which are the solo greedy runs."""
    got = _paged_traffic(paged_servers[executor].port)
    assert got == _paged_traffic(jax_paged_server)
    prefix = _ids(40, (8,))
    for i, body in enumerate(_paged_bodies()):
        ids = np.asarray(body["ids"])
        if body.get("prefix"):
            ids = np.concatenate([np.asarray([prefix]), ids], axis=1)
        want = np.asarray(oracles["fp"].generate(ids, body["new_tokens"]))
        if body.get("prefix"):
            want = want[:, 8:]
        for resp in got[2 * i:2 * i + 2]:
            np.testing.assert_array_equal(np.asarray(resp), want)
    kv = _get(paged_servers[executor].port, "/healthz")["serving"]["kv"]
    assert kv["prefix"]["hits"] >= 1 and kv["leaked"] == 0


@pytest.mark.fleet
@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_speculative_with_draft_equals_greedy(paged_servers,
                                              jax_paged_server, oracles,
                                              executor):
    """`"speculative": true` with --draft-model (paged) answers plain
    greedy, as the JAX server does, on a registered prefix too; the
    target's and the draft's pools are whole afterwards."""
    srv = paged_servers[executor]
    ids = _ids(44, (2, 7))
    body = {"ids": ids, "new_tokens": 9, "speculative": True}
    want = np.asarray(oracles["fp"].generate(np.asarray(ids), 9))
    got = _post(srv.port, "/generate", body)
    np.testing.assert_array_equal(np.asarray(got["ids"]), want)
    assert got["ids"] == _post(jax_paged_server, "/generate", body)["ids"]
    pid = _post(srv.port, "/prefix", {"ids": _ids(45, (5,))})["prefix_id"]
    full = np.concatenate([np.asarray([_ids(45, (5,))] * 2), ids], axis=1)
    got = _post(srv.port, "/generate", dict(body, prefix_id=pid))
    np.testing.assert_array_equal(
        np.asarray(got["ids"]),
        np.asarray(oracles["fp"].generate(full, 9))[:, 5:])
    spec = srv.service.spec
    assert spec.kv is srv.service.kv_backend
    assert spec.draft_pool.free_pages == spec.draft_pool.n_pages
    assert srv.service.kv_backend.pool.stats()["owners"] == 0
    assert _get(srv.port, "/healthz")["speculative"] is True


def test_speculative_on_dense_caches_equals_greedy(oracles):
    """Without --kv-pages the draft model runs on dense caches; a
    registered prefix holds both models' handles."""
    srv = _PortServer(["--draft-model", MODEL, "--gamma", "2"])
    try:
        ids = _ids(46, (1, 6))
        got = _post(srv.port, "/generate", {"ids": ids, "new_tokens": 8,
                                            "speculative": True})
        np.testing.assert_array_equal(
            np.asarray(got["ids"]),
            np.asarray(oracles["fp"].generate(np.asarray(ids), 8)))
        prefix = _ids(47, (6,))
        pid = _post(srv.port, "/prefix", {"ids": prefix})["prefix_id"]
        assert set(srv.service.spec_prefixes[pid]) == {"target", "draft"}
        got = _post(srv.port, "/generate", {"ids": ids, "new_tokens": 8,
                                            "speculative": True,
                                            "prefix_id": pid})
        want = np.asarray(oracles["fp"].generate(
            np.concatenate([np.asarray([prefix]), ids], axis=1), 8))
        np.testing.assert_array_equal(np.asarray(got["ids"]), want[:, 6:])
        code, body, _ = _error(srv.port, "/generate", {
            "ids": ids, "new_tokens": 2, "speculative": True,
            "prefix_id": "nope"})
        assert code == 400 and "unknown prefix_id" in body["error"]
    finally:
        srv.close()


def _kv_key_sets(health):
    kv = health["serving"]["kv"]
    return {"serving": sorted(health["serving"]), "kv": sorted(kv),
            "pool": sorted(kv["pool"]), "prefix": sorted(kv["prefix"]),
            "scheduler": sorted(health["serving"]["scheduler"]),
            "admission": sorted(health["serving"]["admission"])}


@pytest.mark.fleet
def test_paged_healthz_and_metrics_match_jax(paged_servers,
                                             jax_paged_server):
    """/healthz's `kv` and `scheduler` blocks have the JAX server's key
    sets, and /metrics the JAX server's `pipeedge_kv_*` families with
    their label sets."""
    port = paged_servers["wave"].port
    for p in (port, jax_paged_server):
        _post(p, "/generate", {"ids": [[1, 2, 3, 4, 5, 6]],
                               "new_tokens": 2})
    got, want = _get(port, "/healthz"), _get(jax_paged_server, "/healthz")
    assert _kv_key_sets(got) == _kv_key_sets(want)
    assert got["serving"]["kv"]["pool"]["pages_total"] == 32
    assert got["speculative"] is want["speculative"] is True
    fams = {name: labels for name, labels in _families(
        _get(port, "/metrics")).items() if name.startswith("pipeedge_kv_")}
    jfams = {name: labels for name, labels in _families(
        _get(jax_paged_server, "/metrics")).items()
        if name.startswith("pipeedge_kv_")}
    # the JAX server's disaggregation family is for ROADMAP A5.3b
    jfams.pop("pipeedge_kv_prefill_colocated_total", None)
    assert fams == jfams and "pipeedge_kv_pages" in fams


# the JAX server's parse-time composition checks (and its --draft-model /
# --kv-bits check, made after it builds its pipeline)
PARSE_ERRORS = [["--chunked-prefill", "-1"],
                ["--chunked-prefill", "4"],
                ["--prefill-budget", "2"],
                ["--kv-pages", "8", "--chunked-prefill", "4",
                 "--prefill-budget", "0"],
                ["--draft-model", MODEL, "--kv-bits", "8"],
                ["--disaggregate", "process"],
                ["--role", "router", "--kv-pages", "8",
                 "--disaggregate", "wire"]]


@pytest.mark.fleet
@pytest.mark.parametrize("bad", PARSE_ERRORS,
                         ids=["chunk-negative", "chunk-without-pages",
                              "budget-without-chunk", "budget-zero",
                              "draft-with-int8", "disagg-without-pages",
                              "router-with-disagg"])
def test_paged_parse_errors_match_jax(bad, capsys):
    with pytest.raises(SystemExit) as err:
        serve.parse_args(BASE + bad)
    assert err.value.code == 2
    got = [ln for ln in capsys.readouterr().err.splitlines()
           if "error:" in ln][-1].split("error: ", 1)[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                        "serve.py"),
                           *BASE, *bad, "--port", str(_free_port())],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 2
    want = [ln for ln in proc.stderr.splitlines()
            if "error:" in ln][-1].split("error: ", 1)[1]
    assert got == want


# each flag the paged-plane and speculative slice took off `serve.REFUSED`
PORTED_FLAGS = {"--kv-pages": ["8"], "--kv-page-size": ["8"],
                "--chunked-prefill": ["4", "--kv-pages", "8"],
                "--prefill-budget": ["2", "--kv-pages", "8",
                                     "--chunked-prefill", "4"],
                "--step-join": [], "--brownout-clamp-chunk": ["2"],
                "--draft-model": [MODEL], "--gamma": ["3"]}


@pytest.mark.parametrize("flag", sorted(PORTED_FLAGS))
def test_paged_and_spec_flags_accepted(flag):
    assert flag not in serve.REFUSED
    args = serve.parse_args(BASE + [flag, *PORTED_FLAGS[flag]])
    assert getattr(args, flag.lstrip("-").replace("-", "_")) not in (
        None, 0, False)


# ---------------------------------------------------------------------------
# the Llama family at the server
# ---------------------------------------------------------------------------

LLAMA = "pipeedge/test-tiny-llama"
LLAMA_FLAGS = ["-m", LLAMA, "-pt", "1,4,5,8", "--max-len", "48", "-t",
               "float32", "--device", "cpu"]
LLAMA_PAGED = ["--kv-pages", "32", "--kv-page-size", "4",
               "--chunked-prefill", "4"]


@pytest.fixture(scope="module")
def llama_jax_oracle():
    """The JAX `DecodePipeline` on the seeded weights both packages draw
    per stage for the tiny Llama (fp cache)."""
    from pipeedge_tpu.models import registry
    from pipeedge_tpu.parallel import decode
    params = [registry.module_shard_factory(LLAMA, None, l, r, stage=i,
                                            unroll=False)[1]
              for i, (l, r) in enumerate(PARTITION)]
    return decode.DecodePipeline(
        registry.get_model_entry(LLAMA).family.FAMILY,
        registry.get_model_config(LLAMA), PARTITION, params, max_len=48)


@pytest.mark.parametrize("cache", ["fp", "int8"])
@pytest.mark.parametrize("executor", ["wave", "stage"])
def test_tiny_llama_served_equals_solo(llama_jax_oracle, tmp_path, executor,
                                       cache):
    """Three concurrent clients (two rows, a prompt of three chunks, a
    streamed one) on the paged server: each result equals its solo run
    through a dense wave executor chunking as the server does, and on an
    fp cache the JAX package's greedy tokens."""
    from pipeedge_tpu_torch.parallel import batcher
    bits = ["--kv-bits", "8"] if cache == "int8" else []
    args = serve.parse_args(LLAMA_FLAGS + LLAMA_PAGED + bits + [
        "--executor", executor, "--postmortem-dir", str(tmp_path)])
    bodies = [{"ids": _ids(61, (2, 6)), "new_tokens": 6},
              {"ids": _ids(62, (1, 11)), "new_tokens": 7},
              {"ids": _ids(63, (1, 5)), "new_tokens": 5, "stream": True}]
    oracle = serve.build_pipeline(serve.parse_args(LLAMA_FLAGS + bits))
    want = []
    for i, body in enumerate(bodies):
        b = batcher.ContinuousBatcher(oracle, max_active=1, chunk_tokens=4)
        b.submit(i, np.asarray(body["ids"]), body["new_tokens"])
        want.append(np.asarray(b.run()[i]))
        if cache == "fp":
            np.testing.assert_array_equal(want[-1], np.asarray(
                llama_jax_oracle.generate(np.asarray(body["ids"]),
                                          body["new_tokens"])))
    service = serve.make_service(args, serve.build_pipeline(args))
    httpd = serve.Server(("127.0.0.1", 0), serve.make_handler(service,
                                                              LLAMA))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        got = [None] * len(bodies)

        def client(i, body):
            if body.get("stream"):
                got[i] = _stream(port, {k: v for k, v in body.items()
                                        if k != "stream"})[-1]["ids"]
            else:
                got[i] = _post(port, "/generate", body)["ids"]

        clients = [threading.Thread(target=client, args=(i, body))
                   for i, body in enumerate(bodies)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w)
        kv = _get(port, "/healthz")["serving"]["kv"]
        assert kv["leaked"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.stop()
        thread.join(timeout=30)


# ---------------------------------------------------------------------------
# disaggregated prefill at the server
# ---------------------------------------------------------------------------

DISAGG = ["--kv-pages", "32", "--kv-page-size", "4", "--disaggregate",
          "wire"]


@pytest.fixture(scope="module")
def jax_disagg_server():
    """`tools/serve.py --disaggregate wire` on the same model and pages."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc, _ = _spawn([sys.executable, os.path.join(REPO, "tools",
                                                   "serve.py"),
                      *BASE, *DISAGG, "--port", str(port)], env)
    yield port
    proc.terminate()
    proc.wait(timeout=30)


@pytest.mark.fleet
def test_disaggregated_server_matches_jax(jax_disagg_server, oracles):
    """A `--disaggregate wire --device cpu` server answers the JAX
    server's tokens (the JAX greedy runs), shipping each prompt it does
    not hold in its trie, and its /healthz `kv` block and
    `pipeedge_kv_*` /metrics families have the JAX server's key sets and
    label sets."""
    srv = _PortServer(DISAGG)
    try:
        bodies = [{"ids": _ids(81, (1, 7)), "new_tokens": 5},
                  {"ids": _ids(82, (1, 9)), "new_tokens": 4}]
        for body in bodies:
            want = np.asarray(oracles["fp"].generate(
                np.asarray(body["ids"]), body["new_tokens"]))
            for port in (srv.port, jax_disagg_server):
                np.testing.assert_array_equal(
                    np.asarray(_post(port, "/generate", body)["ids"]), want)
        fleet = srv.service.prefill_fleet
        assert fleet.m_prefills.value() == 2
        assert fleet.m_ship_bytes.value(path="wire") > 0
        got, want = _get(srv.port, "/healthz"), _get(jax_disagg_server,
                                                      "/healthz")
        kv, jkv = got["serving"]["kv"], want["serving"]["kv"]
        assert kv["disaggregated"] is jkv["disaggregated"] is True
        for key_of in (lambda k: k, lambda k: k["pool"],
                       lambda k: k["prefix"]):
            assert sorted(key_of(kv)) == sorted(key_of(jkv))
        assert kv["leaked"] == 0
        fams, jfams = ({name: labels for name, labels in _families(
            _get(port, "/metrics")).items()
            if name.startswith("pipeedge_kv_")}
            for port in (srv.port, jax_disagg_server))
        assert fams == jfams
        assert {"pipeedge_kv_prefills_total", "pipeedge_kv_ship_bytes_total",
                "pipeedge_kv_prefill_colocated_total"} <= set(fams)
    finally:
        srv.close()
