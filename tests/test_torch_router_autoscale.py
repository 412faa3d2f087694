"""The routed fleet's observatory and capacity loop on the CPU (tiny GPT-2).

- Ramp up, ramp down, observatory: the port's router entry with one
  spawned replica under `--autoscale auto`, requests queued behind
  `--max-active 1` (each step of stage 0 stalled 10 ms so the queue
  holds): exactly one `autoscale_spawn` of r1 at epoch 0, r1 readmitted
  by the health polls and serving, every request equal to its solo greedy
  run; once the load stops, one `autoscale_drain` of r1 with its prefixes
  migrated, r1's process gone and not respawned, the fleet back to 1, the
  decision counter at up/applied 1 and down/applied 1 with no flap.
  `GET /fleet`'s per-class totals equal the live replicas' own
  `/metrics`; `python -m pipeedge_tpu_torch.trace_report --fleet URL
  --request RID` resolves a request across the router's and its
  replica's span rings, and the router's ring holds both applied
  decisions in the report's `autoscale` section.
- `--autoscale advise` counts `advised` decisions and moves nothing.
- `--fleet-scrape-interval 0`: `GET /fleet` is the JAX router's 503.
- Every composition error of the 14 `--fleet-*`/`--autoscale*` flags is
  the JAX entry's (`tools/serve.py` run as a subprocess), word for word.
- SIGTERM stops the router and leaves no replica process.

Every wait has its own deadline; the file takes well under a minute.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from pipeedge_tpu_torch import serve
from pipeedge_tpu_torch.telemetry import collector as fleet_obs
from pipeedge_tpu_torch.telemetry import report
from test_torch_router_fleet import (BASE, PAGED, REPO, _get, _router_port,
                                     _spawn_router, _stop, _wait)

pytestmark = pytest.mark.fleet     # every test here spawns OS processes

LOOP = ["--autoscale-min", "1", "--autoscale-max", "2",
        "--autoscale-confirm", "2", "--autoscale-interval", "0.2",
        "--fleet-scrape-interval", "0.2", "--autoscale-cooldown", "1",
        "--autoscale-dwell-down", "4", "--autoscale-queue-high", "2"]
# one spawned replica that queues: one request at a time, a 10 ms stall
# in every step of stage 0; no brownout ladder (its clamp would cut the
# new tokens of queued requests, and each request is held to its solo run)
FLEET = BASE + PAGED + ["--device", "cpu", "--replicas", "1",
                        "--max-active", "1", "--no-brownout",
                        "--inject-stall", "0:10"]
CLIENTS = 6
LOAD_S = 40.0                      # the most the ramp-up may take


@pytest.fixture(scope="module")
def solo():
    """Solo greedy runs on the replicas' weights."""
    pipe = serve.build_pipeline(serve.parse_args(BASE + ["--device", "cpu"]))
    cache = {}

    def run(ids, new):
        key = (tuple(ids), new)
        if key not in cache:
            cache[key] = pipe.generate([ids], new)[0].cpu().numpy().tolist()
        return cache[key]
    return run


def _requests(n, first=1):
    """n requests whose prompts start with distinct tokens: the router
    learns a fresh prefix affinity for each."""
    return [([first + i] + [(7 * i + 3 * j) % 90 + 1
                            for j in range(3 + i % 3)], 24)
            for i in range(n)]


def _stream(port, ids, new):
    """One streamed request through the router: its final line."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"ids": [ids], "new_tokens": new,
                         "stream": True}).encode())
    last = None
    with urllib.request.urlopen(req, timeout=60) as resp:
        for raw in resp:
            if raw.strip():
                last = json.loads(raw)
    return last


class _Load:
    """One thread per request of `sets[0]`, each sending its request again
    and again until `stop()`; after `switch()`, request i of `sets[1]`
    instead (fresh prompts: the router's affinity pinned the first set to
    the replica that served it first). Keeps (request, final line) per
    answer, errors apart."""

    def __init__(self, port, sets):
        self.answers, self.errors = [], []
        self._halt, self._switch = threading.Event(), threading.Event()

        def client(i):
            while not self._halt.is_set():
                ids, new = sets[int(self._switch.is_set())][i]
                try:
                    self.answers.append(((ids, new),
                                         _stream(port, ids, new)))
                except (urllib.error.URLError, OSError, ValueError) as exc:
                    self.errors.append((i, repr(exc)))
        self.threads = [threading.Thread(target=client, args=(i,))
                        for i in range(len(sets[0]))]
        for t in self.threads:
            t.start()

    def served_by(self, name):
        return sum(1 for _, a in self.answers if a.get("replica") == name)

    def switch(self):
        self._switch.set()

    def stop(self):
        self._halt.set()
        for t in self.threads:
            t.join(timeout=60)


def _metrics(url):
    with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
        return fleet_obs.parse_prom_text(resp.read().decode())


def _metric(fams, family, **labels):
    return sum(v for lab, v in fams.get(family, ())
               if all(lab.get(k) == w for k, w in labels.items()))


def _class_totals(fams):
    counts = fleet_obs.BurnRateEngine.counts_from_families(fams)
    return {cls: {"ok_total": g, "requests_total": t}
            for cls, (g, t) in counts.items()}


def _gone(pid):
    return not os.path.exists(f"/proc/{pid}") or open(
        f"/proc/{pid}/stat").read().split()[2] == "Z"


def test_autoscale_ramp_up_down_and_the_observatory(solo):
    proc, lines = _spawn_router(FLEET + ["--autoscale", "auto"] + LOOP,
                                timeout=120)
    port = _router_port(lines)
    url = f"http://127.0.0.1:{port}"
    try:
        assert any(ln.startswith("autoscale mode=auto min=1 max=2 "
                                 "confirm=2 cooldown=1") for ln in lines)
        assert _wait(lambda: _get(port, "/healthz")["fleet"]["r0"]["state"]
                     == "healthy")
        r0_pid = _get(port, "/healthz")["workers"]["0"]["pid"]
        reqs = _requests(CLIENTS)
        # the first request alone, on r0 (the only replica): its rid is
        # the one the trace report resolves at the end
        first = _stream(port, *reqs[0])
        assert first["replica"] == "r0"
        # (a) ramp up: queued load until the spawned r1 has served
        load = _Load(port, [reqs, _requests(CLIENTS, first=CLIENTS + 1)])
        seen = {"healthy": False, "size": 0}

        def r1_serving():
            h = _get(port, "/healthz")
            rec = h["fleet"].get("r1")
            if rec and rec["state"] == "healthy" and not seen["healthy"]:
                seen["healthy"] = True
                load.switch()
            seen["size"] = max(seen["size"], h["autoscale"]["size"])
            if "1" in h["workers"]:
                seen["r1_pid"] = h["workers"]["1"]["pid"]
            return seen["healthy"] and load.served_by("r1") >= 2
        try:
            assert _wait(r1_serving, timeout=LOAD_S)
        finally:
            load.stop()
        # (c) at quiescence both replicas are live (the calm must last
        # 4 s before the ramp down): /fleet's per-class totals are their
        # own /metrics summed, once a scrape has passed
        time.sleep(0.6)
        fleet = _get(port, "/fleet")
        assert sorted(fleet["targets"]) == ["r0", "r1"]
        live = {name: _metrics(u) for name, u in fleet["targets"].items()}
        assert _metric(_metrics(url), "pipeedge_fleet_actual_size") == 2
        sums = {cls: {k: sum(_class_totals(f)[cls][k] for f in live.values())
                      for k in ("ok_total", "requests_total")}
                for cls in fleet["classes"]}
        for cls, rec in fleet["classes"].items():
            assert {k: rec[k] for k in sums[cls]} == sums[cls], cls
        assert fleet["autoscale"]["decisions"]["applied"] == 1
        assert not load.errors
        served = len(load.answers) + 1
        assert sum(t["ok_total"] for t in sums.values()) == served
        for req, ans in [(reqs[0], first)] + load.answers:
            assert ans["ids"] == [solo(*req)], req
        spawns = [ln for ln in lines if ln.startswith("autoscale_spawn")]
        assert len(spawns) == 1
        assert spawns[0].startswith("autoscale_spawn replica=r1 rank=1 "
                                    "epoch=0 url=http://127.0.0.1:")
        assert seen["size"] == 2
        r1_final = _class_totals(live["r1"])
        # (b) ramp down: the load stopped; r1 drained and retired
        assert _wait(lambda: any(ln.startswith("autoscale_drain")
                                 for ln in lines), timeout=20)
        drain = next(ln for ln in lines if ln.startswith("autoscale_drain"))
        assert drain.startswith("autoscale_drain replica=r1 rank=1 migrated=")
        assert int(drain.rsplit("=", 1)[1]) >= 1
        assert _wait(lambda: _gone(seen["r1_pid"]), timeout=20)
        time.sleep(1.0)                  # a respawn would show by now
        h = _get(port, "/healthz")
        assert sorted(h["fleet"]) == ["r0"] and sorted(h["workers"]) == ["0"]
        assert h["autoscale"]["size"] == 1
        assert sum("decode replica rank 1 spawned" in ln for ln in lines) == 1
        assert any("decode replica rank 1 retired (epoch=0)" in ln
                   for ln in lines)
        fams = _metrics(url)
        decisions = {(d, o): _metric(
            fams, "pipeedge_autoscale_decisions_total", direction=d,
            outcome=o) for d in ("up", "down")
            for o in ("applied", "advised", "held", "flap_damped")}
        assert decisions == {(d, o): float(o == "applied")
                             for d, o in decisions}
        assert _metric(fams, "pipeedge_fleet_actual_size") == 1
        # the collector keeps r1's last scrape: the fleet's totals are
        # r0's now plus r1's final counts
        time.sleep(0.6)
        fleet = _get(port, "/fleet")
        r0_now = _class_totals(_metrics(fleet["targets"]["r0"]))
        for cls, rec in fleet["classes"].items():
            assert {k: rec[k] for k in r0_now[cls]} == {
                k: r0_now[cls][k] + r1_final[cls][k]
                for k in r0_now[cls]}, cls
        # the router's ring holds the decisions: both applied
        with urllib.request.urlopen(f"{url}/debug/spans?drain=0",
                                    timeout=10) as resp:
            ring = json.loads(resp.read())["spans"]
        section = report.analyze_spans(ring, span_cost_ns=1.0)["autoscale"]
        assert section["applies"] == 2 and section["flap_damped"] == 0
        assert section["by_direction"] == {
            "down": {"apply": 1, "plan": 1}, "up": {"apply": 1, "plan": 1}}
        # the first request across the router's and r0's span rings
        out = subprocess.run(
            [sys.executable, "-m", "pipeedge_tpu_torch.trace_report",
             "--fleet", url, "--request", first["rid"]], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        timeline = json.loads(out.stdout)
        assert timeline["found"] and timeline["rid"] == first["rid"]
        procs = timeline["processes"]
        by_target = {p["target"]: int(k) for k, p in procs.items()}
        assert procs[str(by_target["r0"])]["ok"]
        assert set(timeline["ranks"]) == {by_target["router"],
                                          by_target["r0"]}
        assert any(k.startswith("route/r0") for k in timeline["segments"])
    finally:
        rc = _stop(proc)
    assert rc == 0
    assert _wait(lambda: _gone(r0_pid), timeout=30)


def test_autoscale_advise_counts_and_moves_nothing(solo):
    proc, lines = _spawn_router(FLEET + ["--autoscale", "advise"] + LOOP,
                                timeout=120)
    port = _router_port(lines)
    try:
        assert _wait(lambda: _get(port, "/healthz")["fleet"]["r0"]["state"]
                     == "healthy")
        r0_pid = _get(port, "/healthz")["workers"]["0"]["pid"]
        load = _Load(port, [_requests(CLIENTS)])
        try:
            assert _wait(lambda: _get(port, "/fleet")["autoscale"][
                "decisions"]["advised"] >= 1, timeout=LOAD_S)
        finally:
            load.stop()
        assert not load.errors
        for req, ans in load.answers:
            assert ans["ids"] == [solo(*req)] and ans["replica"] == "r0"
        h = _get(port, "/healthz")
        assert sorted(h["fleet"]) == ["r0"] and sorted(h["workers"]) == ["0"]
        snap = h["autoscale"]
        assert snap["mode"] == "advise" and snap["size"] == 1
        assert snap["decisions"]["applied"] == 0
        assert snap["last"]["outcome"] == "advised"
        fams = _metrics(f"http://127.0.0.1:{port}")
        assert _metric(fams, "pipeedge_autoscale_decisions_total",
                       direction="up", outcome="advised") >= 1
        assert _metric(fams, "pipeedge_autoscale_decisions_total",
                       outcome="applied") == 0
        assert not any(ln.startswith(("autoscale_spawn", "autoscale_drain"))
                       for ln in lines)
        assert any(ln.startswith("autoscale_decision direction=up from=1 "
                                 "to=2 outcome=advised") for ln in lines)
    finally:
        rc = _stop(proc)
    assert rc == 0
    assert _wait(lambda: _gone(r0_pid), timeout=30)


def _jax_router(argv):
    """The JAX router entry on the same flags (a model-free process)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    port = serve._free_ports(1)[0]
    p = subprocess.Popen(
        [sys.executable, "tools/serve.py", "--role", "router",
         "--port", str(port)] + argv, cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in p.stdout:
        if line.startswith("serving router"):
            break
    return p, port


def test_fleet_scrape_interval_zero_is_the_jax_routers_503():
    argv = ["--replica-addrs", "127.0.0.1:9", "--fleet-scrape-interval", "0"]
    proc, lines = _spawn_router(argv)
    jax_proc, jax_port = _jax_router(argv)
    try:
        got = []
        for port in (_router_port(lines), jax_port):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(port, "/fleet")
            got.append((err.value.code, json.loads(err.value.read()),
                        err.value.headers.get("Retry-After")))
        assert got[0] == got[1] == (503, {
            "error": "fleet collector disabled (--fleet-scrape-interval 0)"},
            "5")
    finally:
        jax_proc.terminate()
        jax_proc.wait(timeout=30)
        assert _stop(proc) == 0


# each composition the JAX entry refuses, and argparse's own refusals of
# a bad value for each of the 14 flags
COMPOSITIONS = [
    ["--role", "router", "--replica-addrs", "127.0.0.1:1",
     "--autoscale", "auto"],
    ["--role", "router", "--autoscale", "auto",
     "--fleet-scrape-interval", "0"],
    ["--role", "router", "--autoscale", "advise", "--autoscale-min", "3"],
    ["--role", "router", "--autoscale", "auto", "--autoscale-min", "0"],
    ["--role", "router", "--autoscale", "auto", "--autoscale-min", "2",
     "--autoscale-max", "1"],
    ["--role", "router", "--autoscale", "auto", "--autoscale-confirm", "0"],
    ["--role", "router", "--autoscale", "auto",
     "--autoscale-interval", "0"],
    ["--autoscale", "auto"],
    ["--role", "replica", "--autoscale", "advise"],
    ["--autoscale", "sometimes"],
] + [[flag, "x"] for flag in (
    "--autoscale-min", "--autoscale-max", "--autoscale-confirm",
    "--autoscale-cooldown", "--autoscale-interval", "--autoscale-dwell-up",
    "--autoscale-dwell-down", "--autoscale-queue-high",
    "--autoscale-queue-low", "--autoscale-burn-high", "--autoscale-burn-low",
    "--fleet-scrape-interval", "--fleet-history")]


# the JAX entry's last stderr line for each argv above: one process runs
# its `main()` on each (it parses before it imports JAX)
_JAX_ERRORS = """
import contextlib, io, json, runpy, sys
entry = runpy.run_path("tools/serve.py", run_name="not_main")
out = []
for argv in json.loads(sys.argv[1]):
    sys.argv = ["serve.py"] + argv
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            entry["main"]()
            code = 0
        except SystemExit as exc:
            code = exc.code
    out.append([code, err.getvalue().strip().splitlines()[-1]])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_errors():
    run = subprocess.run(
        [sys.executable, "-c", _JAX_ERRORS, json.dumps(COMPOSITIONS)],
        cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    return json.loads(run.stdout)


@pytest.mark.parametrize("case", range(len(COMPOSITIONS)),
                         ids=[" ".join(a) for a in COMPOSITIONS])
def test_composition_errors_are_the_jax_entrys(case, jax_errors, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.parse_args(COMPOSITIONS[case])
    assert exc.value.code == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    code, want = jax_errors[case]
    assert code == 2
    assert got.split(" error: ", 1)[1] == want.split(" error: ", 1)[1]


def test_the_fourteen_flags_parse_off_refused():
    args = serve.parse_args([
        "--role", "router", "--replicas", "1", "--autoscale", "advise",
        "--autoscale-min", "1", "--autoscale-max", "3",
        "--autoscale-confirm", "4", "--autoscale-cooldown", "2.5",
        "--autoscale-interval", "0.5", "--autoscale-dwell-up", "1",
        "--autoscale-dwell-down", "3", "--autoscale-queue-high", "6",
        "--autoscale-queue-low", "1", "--autoscale-burn-high", "2",
        "--autoscale-burn-low", "0.5", "--fleet-scrape-interval", "0.25",
        "--fleet-history", "60"])
    assert (args.autoscale, args.autoscale_min, args.autoscale_max,
            args.autoscale_confirm, args.autoscale_cooldown,
            args.autoscale_interval, args.autoscale_dwell_up,
            args.autoscale_dwell_down, args.autoscale_queue_high,
            args.autoscale_queue_low, args.autoscale_burn_high,
            args.autoscale_burn_low, args.fleet_scrape_interval,
            args.fleet_history) == ("advise", 1, 3, 4, 2.5, 0.5, 1.0, 3.0,
                                    6.0, 1.0, 2.0, 0.5, 0.25, 60)
    # the JAX entry's defaults: the collector on, the autoscaler off
    defaults = serve.parse_args([])
    assert (defaults.fleet_scrape_interval, defaults.fleet_history,
            defaults.autoscale, defaults.autoscale_dwell_down) == (
                1.0, 120, "off", 5.0)
    assert not {f for f in serve.REFUSED
                if f.startswith(("--autoscale", "--fleet"))}
