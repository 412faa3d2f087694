"""Chaos harness for the port's DCN fleet: inject one deterministic fault,
record detection and recovery latency.

Port of `tools/chaos_dcn.py --target runtime`. Launches a loopback fleet
of `python -m pipeedge_tpu_torch.runtime -c dcn` ranks (one OS process
each, `--device` passed through, default cuda), arms `DCN_CHAOS`
(`comm/chaos.py`) in the victim rank's environment only, and timestamps
every rank's output lines to measure the fault-tolerance layer end to end:

- detect_s:  victim fault observed (the chaos log line) -> the data
             rank's death line ("entering failover" / "died")
- recover_s: detection -> run completion (`latency_sec=` from the data
             rank) — failover mode only; in abort mode the fleet stops
- replayed:  microbatches replayed after the failover re-schedule
- rejoin_s / heal_s / time_to_full_capacity_s: the healing timeline of a
             restart fault (detect -> rejoin admission -> partition
             healed at a round boundary); null when no rejoin happened
- quarantine_s / readmit_s: the gray-failure timeline (fault ->
             quarantine at a round boundary -> probation readmission)

It prints one JSON line with the JAX tool's keys, plus `kernel_launches`
(each rank's exit line, `rank=R kernel_launches=`; a restarted rank's is
its last incarnation's) and `survivors` (fleet processes, restarted
incarnations and their relaunchers included, still alive once the case
had ended: each is killed, and any makes the exit code 1). Examples:

  # kill the last stage at its 3rd send; spare rank 2 takes over
  python -m pipeedge_tpu_torch.chaos_dcn --device cpu --world 3 \\
      --victim 1 --chaos kill@3

  # no spare capacity: the fleet must abort naming the dead rank
  python -m pipeedge_tpu_torch.chaos_dcn --device cpu --world 2 \\
      --victim 1 --chaos kill@2 --expect abort

  # kill + restart after 1.5 s: the rank rejoins (epoch 1) and the healed
  # fleet's later rounds run the pre-failure partition again
  python -m pipeedge_tpu_torch.chaos_dcn --device cpu --world 4 \\
      --victim 1 --chaos restart@3:1500 --rounds 3 --on-peer-rejoin heal \\
      --expect heal

  # gray failure: an 80 ms per-send straggler never misses a beat; the
  # peer-health plane must quarantine it at a round boundary
  python -m pipeedge_tpu_torch.chaos_dcn --device cpu --world 4 \\
      --victim 1 --chaos slow@2:80 --rounds 4 --on-peer-degraded \\
      quarantine --expect quarantine

The serving fleet's targets run the port's router (`python -m
pipeedge_tpu_torch.serve --role router`, the tiny GPT-2 by default) under
the port's load generator (`loadgen.py`):

  # SIGKILL the active replica of a 2-replica routed fleet mid
  # shared-prefix burst: nothing lost or errored, the router failed over
  # at least once, the victim respawned and was readmitted, no page leaked
  python -m pipeedge_tpu_torch.chaos_dcn --device cpu \\
      --target router-fleet --expect router

  # a fleet parked at its 1-replica floor under `--autoscale auto` and a
  # seeded load ramp: scaled up while the ramp offered load, drained back
  # to the floor after it (--expect scale, the default), or, under a flat
  # comfortable load, no decision at all (--expect steady)
  python -m pipeedge_tpu_torch.chaos_dcn --device cpu --target autoscale
  python -m pipeedge_tpu_torch.chaos_dcn --device cpu --target autoscale \\
      --expect steady

The disaggregated-serving ship edge (`--target serve-disagg`): a
`--disaggregate process` server (the port's `serve.py`, two prefill
worker processes by default) under a shared-prefix burst, with the chaos
spec armed on prefill worker rank 1's first incarnation
(`PIPEEDGE_PREFILL_CHAOS`). Gates: nothing lost or errored (re-dispatch
or colocated fallback), the fault path engaged, no page leaked, the
victim respawned and readmitted (epoch + 1 JOIN), no process left. The
record also carries each process's `kernel_launches` (the server's and
each worker's last incarnation's exit line); `--kv-ship-bits 8` ships
the 8-bit codec's frames:

  python -m pipeedge_tpu_torch.chaos_dcn --device cpu \\
      --target serve-disagg --chaos kill@2 --expect disagg
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid

# every process of one fleet carries this tag in its environment, and so
# do the incarnations a chaos restart re-execs (they inherit it): the
# harness finds and reaps them by it
ENV_FLEET_TAG = "PIPEEDGE_CHAOS_FLEET"
# seconds the fleet's processes get to end on their own after the data
# rank has (a restarted incarnation takes the empty CMD_SCHED like any
# worker) before they count as survivors
REAP_GRACE_S = 30.0
# router-fleet: seconds the kill may wait for a replica to be serving
KILL_WAIT_S = 5.0
# router-fleet: tokens each burst request decodes. The JAX tool's 4 end a
# tiny-GPT-2 request in milliseconds on a CPU, so its kill lands on an idle
# replica and the failover gate sees 0 failovers; 24 keep the victim
# decoding when the kill lands
BURST_NEW_TOKENS = 24
# the --expect values each target accepts; the first is its default
TARGET_EXPECTS = {"runtime": ("recover", "abort", "heal", "quarantine"),
                  "serve-disagg": ("disagg",),
                  "router-fleet": ("router",),
                  "autoscale": ("scale", "steady")}
# the burst rate each serving target offers by default (req/s): the JAX
# tool's 3 for serve-disagg; 20 for router-fleet (BURST_NEW_TOKENS says
# why it departs from the JAX tool's 3)
DEFAULT_QPS = {"serve-disagg": 3.0, "router-fleet": 20.0}


def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class TimedReader:
    """Drain a process's stdout, stamping each line's arrival time."""

    def __init__(self, proc):
        self.proc = proc
        self.lines = []          # (monotonic, line)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for line in self.proc.stdout:
            self.lines.append((time.monotonic(), line.rstrip("\n")))

    def first(self, needle):
        for t, line in self.lines:
            if needle in line:
                return t, line
        return None

    def last(self, needle):
        hit = None
        for t, line in self.lines:
            if needle in line:
                hit = (t, line)
        return hit

    def join(self):
        self._thread.join(timeout=5)


def tagged_pids(tag: str) -> dict:
    """pid -> (state, command line) of every process whose environment
    carries `ENV_FLEET_TAG=tag` (this user's processes; others are
    unreadable). Zombies (exited, not yet reaped) are left out."""
    needle = f"{ENV_FLEET_TAG}={tag}".encode()
    found = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                if needle not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{entry}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z":
            found[int(entry)] = (state, cmd.strip())
    return found


def reap_fleet(tag: str, grace: float) -> list:
    """Wait up to `grace` seconds for the tagged processes to end, then
    SIGKILL what is left. Returns the command lines of the survivors; a
    stopped process (`hang@K`'s SIGSTOPped victim, which cannot end on its
    own) is killed without counting as one."""
    deadline = time.monotonic() + grace

    def running(procs):
        return {pid: cmd for pid, (state, cmd) in procs.items()
                if state != "T"}

    left = tagged_pids(tag)
    while running(left) and time.monotonic() < deadline:
        time.sleep(0.25)
        left = tagged_pids(tag)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return [f"{pid} {cmd}" for pid, cmd in sorted(running(left).items())]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--target", default="runtime",
                   choices=["runtime", "serve-disagg", "router-fleet",
                            "autoscale"],
                   help="runtime: a DCN fleet of the port's runtime; "
                        "serve-disagg: a --disaggregate process server "
                        "with chaos on a prefill worker's ship edge; "
                        "router-fleet: a --role router replica fleet with "
                        "a mid-burst replica SIGKILL; autoscale: a "
                        "1-replica-floor fleet in --autoscale auto under a "
                        "load ramp (--expect scale) or flat control load "
                        "(--expect steady)")
    p.add_argument("--world", type=int, default=3)
    p.add_argument("--victim", type=int, default=1,
                   help="rank DCN_CHAOS is armed in (must not be the "
                        "data rank)")
    p.add_argument("--chaos", default="kill@3",
                   help="DCN_CHAOS spec: kill@K | hang@K | drop@K | "
                        "delay@K:MS | restart@K:MS | flap@K:MS | "
                        "slow@K[-J]:MS | jitter@K[-J]:MS | corrupt@K")
    p.add_argument("--arm", action="append", default=[],
                   metavar="RANK=SPEC",
                   help="arm DCN_CHAOS=SPEC in another rank too, e.g. a "
                        "substitute slower than the rank it replaces "
                        "(2=delay@1:200); the timeline keys on --victim")
    p.add_argument("--expect", default=None,
                   choices=[e for es in TARGET_EXPECTS.values() for e in es],
                   help="recover (runtime's default): the run must "
                        "complete; abort: the fleet "
                        "must stop naming the victim; heal: the run must "
                        "complete AND the victim must rejoin AND the "
                        "partition must heal (finite "
                        "time_to_full_capacity_s); quarantine: the run "
                        "must complete AND the peer-health plane must "
                        "quarantine the victim; disagg (serve-disagg), "
                        "router (router-fleet), scale (autoscale's "
                        "default), steady: the serving targets' gates")
    p.add_argument("--on-peer-death", default="failover",
                   choices=["abort", "failover"])
    p.add_argument("--on-peer-rejoin", default="spare",
                   choices=["ignore", "spare", "heal"],
                   help="fleet rejoin policy (restart@K:MS faults)")
    p.add_argument("--on-peer-degraded", default="ignore",
                   choices=["ignore", "quarantine"],
                   help="fleet gray-failure policy (slow/jitter faults)")
    p.add_argument("--degraded-confirm", type=int, default=1,
                   help="confirmation windows before quarantine (the "
                        "fastest honest setting: suspect entry + 1 "
                        "confirming window)")
    p.add_argument("--degraded-readmit", type=int, default=1,
                   help="recovered windows before probation readmission")
    p.add_argument("--rounds", type=int, default=1,
                   help="schedule rounds (heal and quarantine act at round "
                        "boundaries, so those experiments need > 1)")
    p.add_argument("--reconnect-grace", type=float, default=0.0,
                   help="DCN_RECONNECT_GRACE for every rank (flap@K:MS "
                        "faults are survivable when this exceeds MS)")
    p.add_argument("-m", "--model-name", default="pipeedge/test-tiny-vit")
    p.add_argument("-M", "--model-file", default=None,
                   help="weights (.npz) every rank loads; without it each "
                        "stage draws seeded random weights")
    p.add_argument("-pt", "--partition", default="1,4,5,8")
    p.add_argument("-q", "--quant", default=None,
                   help="per-stage output bits (default: 0 on every edge)")
    p.add_argument("-r", "--rank-order", default="0,1")
    p.add_argument("-b", "--batch-size", type=int, default=24)
    p.add_argument("-u", "--ubatch-size", type=int, default=4)
    # interval*miss must exceed the worst stall a BUSY rank can take (a
    # stage build starves its beat thread for that long)
    p.add_argument("--heartbeat-interval", type=float, default=1.0)
    p.add_argument("--heartbeat-miss", type=int, default=5)
    p.add_argument("--sched-timeout", type=float, default=120)
    p.add_argument("--timeout", type=float, default=300,
                   help="harness deadline for the whole experiment")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="every rank's --device")
    p.add_argument("--save-results", default=None, metavar="NPZ",
                   help="the data rank's --save-results (every delivered "
                        "result microbatch, in order)")
    p.add_argument("--workdir", default=None,
                   help="each rank runs in <workdir>/rank<r> (its "
                        "monitoring CSVs and postmortems) and its output "
                        "lines land in out.log there; default a "
                        "temporary directory, removed at the end")
    p.add_argument("--verbose", action="store_true",
                   help="replay every rank's output lines to stderr")
    p.add_argument("--kv-pages", type=int, default=96,
                   help="serving targets: each server's page pool")
    p.add_argument("--kv-page-size", type=int, default=8)
    p.add_argument("--qps", type=float, default=None,
                   help="serve-disagg/router-fleet: offered burst rate "
                        "(default 3 and 20 req/s: router-fleet's departs "
                        "from the JAX tool's 3, which leave the victim "
                        "idle at the kill on a CPU, as BURST_NEW_TOKENS "
                        "says)")
    p.add_argument("--duration", type=float, default=8.0,
                   help="serving targets: load seconds")
    p.add_argument("--shared-spec", default="shared:16:24:2",
                   help="serve-disagg/router-fleet: the load's "
                        "shared-prefix prompt distribution")
    p.add_argument("--prefill-ranks", type=int, default=2,
                   help="serve-disagg: prefill worker processes")
    p.add_argument("--kv-ship-bits", type=int, default=0, choices=[0, 8],
                   help="serve-disagg: the server's --kv-ship-bits (8: "
                        "the codec's 8-bit KV frames)")
    p.add_argument("--replicas", type=int, default=2,
                   help="router-fleet: supervised replicas (autoscale: "
                        "the ceiling)")
    p.add_argument("--kill-after", type=float, default=2.5,
                   help="router-fleet: seconds into the burst before the "
                        "SIGKILL lands on the active replica")
    p.add_argument("--ramp", default="ramp:2:30:0.4",
                   help="autoscale: the arrival ramp offered under "
                        "--expect scale (LO->HI->LO req/s over "
                        "--duration; the JAX tool's ramp:1:8:0.4 never "
                        "queues a tiny-GPT-2 replica of the port on a "
                        "CPU, so nothing scales)")
    args = p.parse_args(argv)
    if args.qps is None:
        args.qps = DEFAULT_QPS.get(args.target, 0.0)
    expects = TARGET_EXPECTS[args.target]
    if args.expect is None:
        args.expect = expects[0]
    elif args.expect not in expects:
        p.error(f"--target {args.target} takes --expect "
                f"{'|'.join(expects)}, not {args.expect}")
    if args.target != "runtime":
        if args.model_name == "pipeedge/test-tiny-vit":
            # the runtime's default is a ViT; serving needs a decoder
            args.model_name = "pipeedge/test-tiny-gpt2"
        return args
    if args.victim == 0:
        p.error("--victim 0 is the data rank (the driver; killing it "
                "kills the experiment, not the pipeline)")
    armed = {}
    for item in args.arm:
        rank, _, spec = item.partition("=")
        if not rank.isdigit() or int(rank) in (0, args.victim) or not spec:
            p.error(f"--arm {item}: give RANK=SPEC for a rank other than "
                    "the data rank and the victim")
        armed[int(rank)] = spec
    args.arm = armed
    return args


def _launches(reader, rank: int):
    """The rank's exit line `rank=R kernel_launches={...}` (the last
    incarnation's), or None."""
    hit = reader.last(f"rank={rank} kernel_launches=")
    return json.loads(hit[1].split("=", 2)[2]) if hit else None


def fleet_env(tag: str) -> dict:
    """The environment of a serving target's process: the package's own
    checkout first on PYTHONPATH, and the fleet tag the reaper finds."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=root + (os.pathsep + path
                                               if path else ""),
                **{ENV_FLEET_TAG: tag})


class _RouterFleet:
    """A `python -m pipeedge_tpu_torch.serve --role router` process and
    the replicas it spawns, all tagged for the reaper; its lines are
    stamped by a `TimedReader`."""

    def __init__(self, args, flags):
        import urllib.request
        self._urlopen = urllib.request.urlopen
        self.port = _free_ports(1)[0]
        self.url = f"http://127.0.0.1:{self.port}"
        self.tag = uuid.uuid4().hex
        env = fleet_env(self.tag)
        cmd = [sys.executable, "-m", "pipeedge_tpu_torch.serve",
               "--role", "router", "--device", args.device,
               "-m", args.model_name, "-pt", args.partition,
               "--max-len", "64", "-t", "float32", "--port", str(self.port),
               "--kv-pages", str(args.kv_pages),
               "--kv-page-size", str(args.kv_page_size),
               "--router-poll-interval", "0.2"] + flags
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(cmd, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self.reader = TimedReader(self.proc)

    def get_json(self, path, timeout=10.0, base=None):
        with self._urlopen(f"{base or self.url}{path}",
                           timeout=timeout) as resp:
            return json.loads(resp.read())

    def metric(self, name) -> float:
        with self._urlopen(f"{self.url}/metrics", timeout=10) as resp:
            for line in resp.read().decode().splitlines():
                if line.startswith(name + " "):
                    return float(line.split()[-1])
        return 0.0

    def wait_healthy(self, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError("router died during startup")
            try:
                h = self.get_json("/healthz", timeout=5)
                if h.get("ok") and all(r["state"] == "healthy"
                                       for r in h["fleet"].values()):
                    return h
            except OSError:
                pass
            time.sleep(0.5)
        raise RuntimeError("router fleet never became healthy")

    def generate(self, base, n_ids, new_tokens) -> None:
        import urllib.request
        req = urllib.request.Request(
            f"{base}/generate",
            data=json.dumps({"ids": [7] * n_ids,
                             "new_tokens": new_tokens}).encode(),
            headers={"Content-Type": "application/json"})
        with self._urlopen(req, timeout=180) as resp:
            resp.read()

    def leaked_pages(self, fleet: dict) -> int:
        """Pages leaked over every live replica (each one's own
        /healthz orphan-sweep total); a dead one holds none."""
        leaked = 0
        for rep in fleet.values():
            try:
                body = self.get_json("/healthz", base=rep["url"])
            except OSError:
                continue
            leaked += ((body.get("serving") or {}).get("kv")
                       or {}).get("leaked", 0)
        return leaked

    def stop(self) -> list:
        """SIGTERM the router (it stops its replicas), then reap whatever
        of the fleet is left; returns the survivors' command lines."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        survivors = reap_fleet(self.tag, REAP_GRACE_S)
        self.reader.join()
        return survivors

    def replay(self, verbose: bool) -> None:
        if verbose:
            for t, line in self.reader.lines:
                print(f"[router +{t - self.t0:7.3f}] {line}",
                      file=sys.stderr)


def server_launches(reader) -> dict:
    """The serve-disagg server's `kernel_launches=` exit line and each
    prefill worker's (its last incarnation's; a killed one prints none),
    teed through the server's output as `[prefill rR] ...`."""
    out = {}
    for _, line in reader.lines:
        if line.startswith("kernel_launches="):
            out["server"] = json.loads(line.split("=", 1)[1])
        elif " exiting (" in line and "kernel_launches=" in line:
            rank = line.split("prefill worker rank ", 1)[1].split()[0]
            out[f"prefill r{rank}"] = json.loads(
                line.split("kernel_launches=", 1)[1])
    return out


def run_serve_disagg(args) -> int:
    """The disaggregated-serving chaos experiment (`tools/chaos_dcn.py
    run_serve_disagg`): a `--disaggregate process` server under a
    shared-prefix burst while `--chaos` is armed on prefill worker rank
    1's ship edge. Gates: every request completes (lease re-dispatch or
    colocated fallback: zero lost, zero errors), the fault path engaged,
    page accounting closes with zero leaks, the killed worker is
    respawned and readmitted (DCN_EPOCH + 1 JOIN), and no process of the
    fleet outlives the case. Prints one JSON line with the fault window's
    goodput and recovery_s."""
    import urllib.request

    from . import loadgen

    port = _free_ports(1)[0]
    url = f"http://127.0.0.1:{port}"
    tag = uuid.uuid4().hex
    env = dict(fleet_env(tag), PIPEEDGE_PREFILL_CHAOS=args.chaos,
               PIPEEDGE_PREFILL_CHAOS_RANK="1")
    env.setdefault("DCN_CONNECT_TIMEOUT", "30")
    cmd = [sys.executable, "-m", "pipeedge_tpu_torch.serve",
           "--device", args.device,
           "-m", args.model_name, "-pt", args.partition,
           "--max-len", "64", "-t", "float32", "--port", str(port),
           "--kv-pages", str(args.kv_pages),
           "--kv-page-size", str(args.kv_page_size),
           "--disaggregate", "process",
           "--prefill-ranks", str(args.prefill_ranks),
           "--prefill-lease-timeout", "5",
           "--prefill-heartbeat-interval", "0.5",
           "--kv-ship-bits", str(args.kv_ship_bits)]
    if args.model_file:
        cmd += ["-M", os.path.abspath(args.model_file)]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, env=env, text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    reader = TimedReader(proc)

    def healthz(timeout=10.0):
        with urllib.request.urlopen(f"{url}/healthz",
                                    timeout=timeout) as resp:
            return json.loads(resp.read())

    record = {"target": "serve-disagg", "chaos": args.chaos,
              "prefill_ranks": args.prefill_ranks,
              "expect": args.expect}
    try:
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError("the server died during startup")
            try:
                healthz(timeout=5)
                break
            except OSError:
                time.sleep(0.5)
        else:
            raise RuntimeError("the server never became healthy")
        # warm-up: the burst's exact shapes, one lease on each worker (the
        # fleet's round robin), so the fault window measures the protocol
        # and not a worker's first prompt pass
        shared_max = loadgen.spec_max_len(args.shared_spec)
        for n in {shared_max, 6}:
            req = urllib.request.Request(
                f"{url}/generate",
                data=json.dumps({"ids": [[7] * n],
                                 "new_tokens": 2}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                resp.read()
        # the burst: the armed chaos fires at the victim's Kth ship send.
        # A watcher stamps the readmission as it happens, so a worker that
        # respawns mid-burst does not have its recovery_s aliased to the
        # rest of the burst
        recovered_at = [None]
        watch_stop = threading.Event()

        def watch_readmission():
            seen_down = False
            while not watch_stop.is_set() and recovered_at[0] is None:
                try:
                    live = healthz(timeout=5)["serving"]["kv"][
                        "prefill"]["live"]
                except OSError:
                    watch_stop.wait(0.3)
                    continue
                if len(live) < args.prefill_ranks:
                    seen_down = True
                elif seen_down:
                    recovered_at[0] = time.monotonic()
                    return
                watch_stop.wait(0.2)

        watcher = threading.Thread(target=watch_readmission,
                                   daemon=True, name="readmit-watch")
        watcher.start()
        report = loadgen.run_load(
            f"{url}/generate", args.duration, args.qps,
            mix={"interactive": 1.0}, new_tokens=4,
            prompt_len=args.shared_spec, seed=7, arrival="poisson")
        died = reader.first("died")   # the supervisor's death line
        recover_deadline = time.monotonic() + 60
        while recovered_at[0] is None \
                and time.monotonic() < recover_deadline:
            time.sleep(0.3)
        watch_stop.set()
        watcher.join(timeout=10)
        kv = healthz()["serving"]["kv"]
        prefill = kv["prefill"]
        record.update({
            "requests": report["requests"],
            "lost": report["client_dropped"],
            "errors": report["totals"]["error"],
            "shed": report["totals"]["shed"],
            "fault_window_goodput_rps": round(sum(
                c["goodput_rps"] for c in report["classes"].values()), 3),
            "leases": prefill["leases"],
            "colocated": prefill.get("colocated"),
            "zombies_dropped": prefill["zombies_dropped_total"],
            "ship_corrupt": prefill["ship_corrupt_total"],
            "pages_leaked": kv["leaked"],
            "live_ranks": prefill["live"],
            "worker_epochs": {r: w["epoch"] for r, w in
                              prefill.get("workers", {}).items()},
            "recovery_s": (round(recovered_at[0] - died[0], 3)
                           if recovered_at[0] and died else None),
            "readmitted": recovered_at[0] is not None,
            "total_s": round(time.monotonic() - t0, 3),
        })
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        record["survivors"] = reap_fleet(tag, REAP_GRACE_S)
        reader.join()
        record["kernel_launches"] = server_launches(reader)
    print(json.dumps(record), flush=True)
    if args.verbose:
        for t, line in reader.lines:
            print(f"[serve +{t - t0:7.3f}] {line}", file=sys.stderr)
    # the disagg gate: nothing lost, nothing errored, the fault path
    # engaged (re-dispatch, fallback or colocated), zero leaked pages, and
    # the victim readmitted after its respawn
    engaged = (record["leases"]["redispatched"]
               + record["leases"]["fallback"]
               + sum((record["colocated"] or {}).values())) > 0
    ok = (record["errors"] == 0 and record["lost"] == 0
          and record["pages_leaked"] == 0 and engaged
          and record["readmitted"])
    return 0 if ok and not record["survivors"] else 1


def run_router_fleet(args) -> int:
    """The routed replica fleet under one replica's SIGKILL (`tools/
    chaos_dcn.py run_router_fleet`): a shared-prefix burst through the
    router while the replica serving it is killed. Gates: nothing lost
    or errored (failover and stream replay), the failover counter moved,
    the victim respawned and was readmitted (epoch + 1, healthy), no page
    leaked, no fleet process left. Prints one JSON line."""
    from . import loadgen

    fleet = _RouterFleet(args, ["--replicas", str(args.replicas)])
    record = {"target": "router-fleet", "replicas": args.replicas,
              "expect": args.expect}
    try:
        h = fleet.wait_healthy(args.timeout)
        epochs0 = {n: r["epoch"] for n, r in h["fleet"].items()}
        # warm every replica directly (the router's affinity would leave
        # one cold and fold its first calls into the fault window)
        for rep in h["fleet"].values():
            for n in {loadgen.spec_max_len(args.shared_spec), 6}:
                fleet.generate(rep["url"], n, 2)
        # the kill lands mid-burst on whichever replica is serving; a
        # watcher stamps the respawn's readmission as it happens
        killed = {}
        recovered_at = [None]
        watch_stop = threading.Event()

        def kill_one():
            # the kill lands on a replica that is decoding a request, as
            # the replica's own /healthz says at that moment: the JAX tool
            # reads one snapshot of the router's copy of it, polled every
            # --router-poll-interval, and on a fast host a request is over
            # before that copy shows it; here the reads repeat for up to
            # KILL_WAIT_S before the first replica is taken
            watch_stop.wait(args.kill_after)
            deadline = time.monotonic() + KILL_WAIT_S
            victim = None
            while not watch_stop.is_set():
                try:
                    body = fleet.get_json("/healthz", timeout=5)
                except OSError:
                    return
                for name, rec in sorted(body["fleet"].items()):
                    try:
                        own = fleet.get_json("/healthz", timeout=2,
                                             base=rec["url"])
                    except OSError:
                        continue
                    if (own.get("stats") or {}).get("active"):
                        victim = name
                        break
                if victim is not None or time.monotonic() >= deadline:
                    break
            else:
                return
            victim = victim or sorted(body["fleet"])[0]
            os.kill(body["workers"][victim[1:]]["pid"], signal.SIGKILL)
            killed[victim] = time.monotonic()

        def watch_readmission():
            while not watch_stop.is_set() and recovered_at[0] is None:
                if killed:
                    try:
                        now = fleet.get_json("/healthz", timeout=5)["fleet"]
                    except OSError:
                        watch_stop.wait(0.3)
                        continue
                    victim = next(iter(killed))
                    rec = now[victim]
                    if rec["epoch"] > epochs0[victim] \
                            and rec["state"] == "healthy":
                        recovered_at[0] = time.monotonic()
                        return
                watch_stop.wait(0.2)

        threads = [threading.Thread(target=kill_one, daemon=True),
                   threading.Thread(target=watch_readmission, daemon=True)]
        for t in threads:
            t.start()
        report = loadgen.run_load(
            f"{fleet.url}/generate", args.duration, args.qps,
            mix={"interactive": 1.0}, new_tokens=BURST_NEW_TOKENS,
            prompt_len=args.shared_spec, seed=7, arrival="poisson")
        recover_deadline = time.monotonic() + 120
        while recovered_at[0] is None \
                and time.monotonic() < recover_deadline:
            time.sleep(0.3)
        watch_stop.set()
        for t in threads:
            t.join(timeout=10)
        now = fleet.get_json("/healthz")["fleet"]
        victim = next(iter(killed), None)
        record.update({
            "requests": report["requests"],
            "lost": report["client_dropped"],
            "errors": report["totals"]["error"],
            "shed": report["totals"]["shed"],
            "first_error": report["first_error"],
            "fault_window_goodput_rps": round(sum(
                c["goodput_rps"] for c in report["classes"].values()), 3),
            "victim": victim,
            "failovers": fleet.metric("pipeedge_router_failovers_total"),
            "retries": fleet.metric("pipeedge_router_retries_total"),
            "pages_leaked": fleet.leaked_pages(now),
            "replica_epochs": {n: r["epoch"] for n, r in now.items()},
            "replica_states": {n: r["state"] for n, r in now.items()},
            "recovery_s": (round(recovered_at[0] - killed[victim], 3)
                           if recovered_at[0] and victim else None),
            "readmitted": recovered_at[0] is not None,
            "total_s": round(time.monotonic() - fleet.t0, 3),
        })
    finally:
        record["survivors"] = fleet.stop()
    print(json.dumps(record), flush=True)
    fleet.replay(args.verbose)
    ok = (record.get("errors") == 0 and record.get("lost") == 0
          and record.get("failovers", 0) >= 1
          and record.get("pages_leaked") == 0 and record.get("readmitted"))
    return 0 if ok and not record["survivors"] else 1


def run_autoscale(args) -> int:
    """The serving fleet's capacity loop under load (`tools/chaos_dcn.py
    run_autoscale`): a router parked at its 1-replica floor in
    `--autoscale auto`, `--max-active 1` per replica. `--expect scale`
    offers the `--ramp` arrival: the controller must scale up while the
    ramp still offers load and drain back to the floor after it.
    `--expect steady` offers a flat comfortable 1 req/s: no decision at
    all. Either way nothing is lost or errored, no page leaks and no
    fleet process is left. Prints one JSON line."""
    from . import loadgen

    floor, ceiling = 1, max(2, args.replicas)
    # --max-active 1 keeps one replica's capacity at a few req/s, so the
    # ramp's plateau queues at admission: the signal the controller
    # scales on
    fleet = _RouterFleet(args, [
        "--replicas", str(floor), "--max-active", "1",
        "--fleet-scrape-interval", "0.3", "--autoscale", "auto",
        "--autoscale-min", str(floor), "--autoscale-max", str(ceiling),
        "--autoscale-confirm", "2", "--autoscale-cooldown", "2.0",
        "--autoscale-interval", "0.3", "--autoscale-dwell-down", "1.0",
        "--autoscale-queue-high", "2.0", "--autoscale-queue-low", "0.5"])
    record = {"target": "autoscale", "expect": args.expect,
              "floor": floor, "ceiling": ceiling}
    steady = args.expect == "steady"
    try:
        h = fleet.wait_healthy(args.timeout)
        # warm the floor replica with the load's own shape: a first call
        # stalls, and a stall looks like a capacity shortfall
        n_new = 4 if steady else 24
        for rep in h["fleet"].values():
            fleet.generate(rep["url"], 6, n_new)
        load_t0 = time.monotonic()
        report = loadgen.run_load(
            f"{fleet.url}/generate", args.duration,
            1.0 if steady else None, mix={"interactive": 1.0},
            deadline_from_slo=False, new_tokens=n_new, prompt_len="6",
            seed=7, arrival="uniform" if steady else args.ramp)
        load_s = time.monotonic() - load_t0
        # after the ramp: wait for the drain back to the floor (queue-low
        # confirmation, dwell and cooldown)
        scale_down_s = None
        settle_deadline = time.monotonic() + (5.0 if steady else 90.0)
        while time.monotonic() < settle_deadline:
            a = fleet.get_json("/healthz", timeout=5).get("autoscale") or {}
            if not steady and a.get("size") == floor \
                    and (a.get("decisions") or {}).get("applied", 0) >= 2:
                scale_down_s = time.monotonic() - load_t0 - load_s
                break
            time.sleep(0.5)
        h = fleet.get_json("/healthz", timeout=5)
        asnap = h.get("autoscale") or {}
        spawn = fleet.reader.first("autoscale_spawn")
        spawns = [line for _, line in fleet.reader.lines
                  if line.startswith("autoscale_spawn")]
        record.update({
            "requests": report["requests"],
            "offered_qps": report["offered_qps"],
            "ramp": report.get("ramp"),
            "lost": report["client_dropped"],
            "errors": report["totals"]["error"],
            "shed": report["totals"]["shed"],
            "first_error": report["first_error"],
            "attainment": {c: v["slo_attainment"]
                           for c, v in report["classes"].items()},
            "decisions": asnap.get("decisions"),
            "ticks": asnap.get("ticks"),
            "final_size": asnap.get("size"),
            "spawns": len(spawns),
            "spawn_epochs": [int(part.split("=", 1)[1]) for line in spawns
                             for part in line.split()
                             if part.startswith("epoch=")],
            "time_to_scale_up_s": (round(spawn[0] - load_t0, 3)
                                   if spawn else None),
            "scale_down_s": (round(scale_down_s, 3)
                             if scale_down_s is not None else None),
            "drained": fleet.reader.first("autoscale_drain") is not None,
            "pages_leaked": fleet.leaked_pages(h["fleet"]),
            "total_s": round(time.monotonic() - fleet.t0, 3),
        })
    finally:
        record["survivors"] = fleet.stop()
    print(json.dumps(record), flush=True)
    fleet.replay(args.verbose)
    decisions = record.get("decisions") or {}
    clean = (record.get("errors") == 0 and record.get("lost") == 0
             and record.get("pages_leaked") == 0
             and record.get("final_size") == floor)
    if steady:
        # the governor ticked, decided nothing, never left the floor
        ok = clean and (record.get("ticks") or 0) > 0 \
            and sum(decisions.values()) == 0
    else:
        # scaled up while the ramp still offered load, drained back after
        up = record.get("time_to_scale_up_s")
        ok = clean and up is not None and up < args.duration \
            and record["drained"] and decisions.get("applied", 0) >= 2
    return 0 if ok and not record["survivors"] else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.target == "serve-disagg":
        return run_serve_disagg(args)
    if args.target == "router-fleet":
        return run_router_fleet(args)
    if args.target == "autoscale":
        return run_autoscale(args)
    addrs = ",".join(f"127.0.0.1:{port}"
                     for port in _free_ports(args.world))
    quant = args.quant or ",".join(
        "0" for _ in args.partition.split(",")[::2])
    common = ["-c", "dcn", "--device", args.device, "-m", args.model_name,
              "-b", str(args.batch_size), "-u", str(args.ubatch_size),
              "-pt", args.partition, "-q", quant, "-r", args.rank_order,
              "--dcn-addrs", addrs,
              "--sched-timeout", str(args.sched_timeout),
              "--on-peer-death", args.on_peer_death,
              "--on-peer-rejoin", args.on_peer_rejoin,
              "--on-peer-degraded", args.on_peer_degraded,
              "--degraded-confirm", str(args.degraded_confirm),
              "--degraded-readmit", str(args.degraded_readmit),
              "--rounds", str(args.rounds),
              "--heartbeat-interval", str(args.heartbeat_interval),
              "--heartbeat-miss", str(args.heartbeat_miss)]
    if args.model_file:
        common += ["-M", os.path.abspath(args.model_file)]
    tag = uuid.uuid4().hex
    env = fleet_env(tag)
    env.setdefault("DCN_CONNECT_TIMEOUT", "30")
    if args.reconnect_grace > 0:
        env["DCN_RECONNECT_GRACE"] = str(args.reconnect_grace)
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_dcn_")
    save = os.path.abspath(args.save_results) if args.save_results else None

    def launch(rank, extra_env=None):
        d = os.path.join(workdir, f"rank{rank}")
        os.makedirs(d, exist_ok=True)
        argv = [sys.executable, "-m", "pipeedge_tpu_torch.runtime",
                str(rank), str(args.world)] + common
        if rank == 0 and save:
            argv += ["--save-results", save]
        return subprocess.Popen(
            argv, cwd=d, env=dict(env, **(extra_env or {})), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    procs, readers = {}, {}
    t0 = time.monotonic()
    survivors = []
    try:
        for rank in range(args.world):
            spec = (args.chaos if rank == args.victim
                    else args.arm.get(rank))
            extra = {"DCN_CHAOS": spec} if spec is not None else None
            procs[rank] = launch(rank, extra)
            readers[rank] = TimedReader(procs[rank])
        deadline = t0 + args.timeout
        data = procs[0]
        while time.monotonic() < deadline and data.poll() is None:
            time.sleep(0.25)
        timed_out = data.poll() is None
        if not timed_out:
            # the workers end on the empty CMD_SCHED (or on the abort),
            # a restarted incarnation and its relauncher with them
            survivors = reap_fleet(tag, REAP_GRACE_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    # a SIGSTOPped (hang-chaos) victim still dies to KILL
                    os.kill(proc.pid, signal.SIGKILL)
                except OSError:
                    pass
            proc.wait()
        # whatever is left after a timeout or an error: restarted
        # incarnations are not children of this process
        survivors += reap_fleet(tag, 0.0)
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    for r in readers.values():
        r.join()
    if args.workdir:
        # each rank's lines beside its CSVs, stamped from the launch
        for rank, reader in readers.items():
            with open(os.path.join(workdir, f"rank{rank}", "out.log"),
                      "w") as f:
                f.writelines(f"+{t - t0:8.3f} {line}\n"
                             for t, line in reader.lines)

    # the fault instant: the chaos module logs right before acting — skip
    # the startup "chaos: installed <spec>" line (slow/jitter log an
    # explicit arming line)
    fault = next(((t, line) for t, line in readers[args.victim].lines
                  if "chaos:" in line and "installed" not in line), None)
    # the data rank may detect the death itself ("entering failover") or
    # learn it from a survivor's CMD_DEAD ("announced dead")
    detect = (readers[0].first("entering failover")
              or readers[0].first("announced dead")
              or readers[0].first("died"))
    recover = readers[0].last("latency_sec=")
    replayed_line = readers[0].first("unacknowledged microbatch")
    replayed = None
    if replayed_line:
        for tok in replayed_line[1].split():
            if tok.isdigit():
                replayed = int(tok)
    rejoin = readers[0].first("rejoin_rank=")
    healed = readers[0].first("heal_round=")
    ttfc = None
    if healed:
        for tok in healed[1].split():
            if tok.startswith("time_to_full_capacity_s="):
                ttfc = float(tok.split("=", 1)[1])
    quarantine = readers[0].first("quarantine_rank=")
    readmit = readers[0].first("readmit_rank=")
    completed = (not timed_out and data.returncode == 0
                 and recover is not None)
    aborted = (not timed_out and data.returncode not in (None, 0)
               and readers[0].first("died") is not None)
    record = {
        "chaos": args.chaos,
        "victim": args.victim,
        "world": args.world,
        "mode": args.on_peer_death,
        "rejoin_mode": args.on_peer_rejoin,
        "expect": args.expect,
        "completed": completed,
        "aborted": aborted,
        "timed_out": timed_out,
        "data_rc": data.returncode,
        "detect_s": (round(detect[0] - fault[0], 3)
                     if detect and fault else None),
        "recover_s": (round(recover[0] - detect[0], 3)
                      if recover and detect and completed else None),
        # detect -> JOIN admission at the data rank
        "rejoin_s": (round(rejoin[0] - detect[0], 3)
                     if rejoin and detect else None),
        # admission -> partition healed at a round boundary
        "heal_s": (round(healed[0] - rejoin[0], 3)
                   if healed and rejoin else None),
        # the data rank's own detection -> healed clock
        "time_to_full_capacity_s": ttfc,
        "quarantine_s": (round(quarantine[0] - fault[0], 3)
                         if quarantine and fault else None),
        "readmit_s": (round(readmit[0] - quarantine[0], 3)
                      if readmit and quarantine else None),
        "total_s": round(time.monotonic() - t0, 3),
        "replayed": replayed,
        "device": args.device,
        "kernel_launches": {str(rank): _launches(reader, rank)
                            for rank, reader in readers.items()},
        "survivors": survivors,
    }
    print(json.dumps(record), flush=True)
    if args.verbose:
        for rank, reader in readers.items():
            for t, line in reader.lines:
                print(f"[rank{rank} +{t - t0:7.3f}] {line}",
                      file=sys.stderr)
    if args.expect == "heal":
        ok = completed and rejoin is not None and ttfc is not None
    elif args.expect == "quarantine":
        ok = completed and quarantine is not None
    elif args.expect == "recover":
        ok = completed
    else:
        ok = aborted
    return 0 if ok and not survivors else 1


if __name__ == "__main__":
    sys.exit(main())
