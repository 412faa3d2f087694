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

The other targets of the JAX tool are refused: `serve-disagg` (ROADMAP
A5.3b) and `router-fleet` / `autoscale` (A6b's control half).
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

_REFUSED_TARGETS = {
    "serve-disagg": "A5.3b, the disaggregated prefill fleet",
    "router-fleet": "A6b's control half, the chaos targets of the serving "
                    "fleet",
    "autoscale": "A6b's control half, the chaos targets of the serving "
                 "fleet",
}


def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class _TimedReader:
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
                   help="runtime: a DCN fleet of the port's runtime (the "
                        "other targets are not ported yet)")
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
    p.add_argument("--expect", default="recover",
                   choices=["recover", "abort", "heal", "quarantine"],
                   help="recover: the run must complete; abort: the fleet "
                        "must stop naming the victim; heal: the run must "
                        "complete AND the victim must rejoin AND the "
                        "partition must heal (finite "
                        "time_to_full_capacity_s); quarantine: the run "
                        "must complete AND the peer-health plane must "
                        "quarantine the victim")
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
    args = p.parse_args(argv)
    if args.target in _REFUSED_TARGETS:
        p.error(f"--target {args.target} is not ported to "
                f"pipeedge_tpu_torch yet (ROADMAP "
                f"{_REFUSED_TARGETS[args.target]})")
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


def main(argv=None) -> int:
    args = parse_args(argv)
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
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=root + (os.pathsep + path
                                              if path else ""),
               **{ENV_FLEET_TAG: tag})
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
            readers[rank] = _TimedReader(procs[rank])
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
