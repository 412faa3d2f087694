"""The open-loop load generator the port's chaos targets drive.

The port's copy of the part of `tools/loadgen.py` that `python -m
pipeedge_tpu_torch.chaos_dcn --target router-fleet|autoscale` calls:
`run_load` (open-loop arrivals on the clock, per-class outcome and
latency accounting, one report dict), the prompt specs (`N`,
`uniform:LO:HI`, `shared:PFX:TOTAL[:POOL]`: every prompt opens with one
of POOL seed-derived shared prefixes) and the arrival processes
(`uniform`, `poisson`, and `ramp:LO:HI[:HOLD]`, a piecewise-linear
rise, plateau and fall of the offered rate). The command-line tool,
calibration and the burst spike stay in `tools/loadgen.py`.

Outcomes per request, as the JAX tool counts them: `ok` (HTTP 200
within the class SLO), `ok_late` (200 past it), `shed` (503 from
admission), `degraded` (503 in a failover window), `deadline` (504,
expired mid-flight), `error` (anything else). Requests the client could
not launch (the in-flight cap) count as `client_dropped`.
"""
from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request

from .serving import REQUEST_CLASSES
from .utils.threads import make_lock

DEFAULT_MIX = {"interactive": 0.7, "batch": 0.2, "best_effort": 0.1}
DEFAULT_SLO_MS = {"interactive": 2000.0, "batch": 10000.0,
                  "best_effort": 30000.0}
OUTCOMES = ("ok", "ok_late", "shed", "degraded", "deadline", "error")
WORST_N = 5      # per-class worst-latency request ids kept in the report


def _post(url, obj, timeout):
    """POST JSON; returns (status, body-dict, retry_after | None)."""
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), None
    except urllib.error.HTTPError as exc:
        ra = exc.headers.get("Retry-After")
        try:
            body = json.loads(exc.read())
        except Exception:       # noqa: BLE001 — non-JSON error body
            body = {}
        return exc.code, body, None if ra is None else float(ra)



def parse_prompt_spec(s):
    """`--prompt-len DIST` -> spec dict. Forms:

    - `N`                    fixed length N (the historical behavior)
    - `uniform:LO:HI`        length drawn per request from [LO, HI]
    - `shared:PFX:TOTAL[:POOL]`  every prompt is TOTAL tokens whose
      first PFX tokens are one of POOL (default 1) DETERMINISTIC shared
      prefixes (seed-derived, so reruns share the same prefixes) — the
      workload shape that exercises the server's prefix trie and
      long-context token-budget admission.

    Accepts an int/dict unchanged (the in-process callers)."""
    if isinstance(s, dict):
        return s
    if isinstance(s, int) or (isinstance(s, str) and s.isdigit()):
        n = int(s)
        if n < 1:
            raise ValueError("prompt length must be >= 1")
        return {"dist": "fixed", "len": n}
    parts = str(s).split(":")
    try:
        if parts[0] == "uniform" and len(parts) == 3:
            lo, hi = int(parts[1]), int(parts[2])
            if not 1 <= lo <= hi:
                raise ValueError
            return {"dist": "uniform", "lo": lo, "hi": hi}
        if parts[0] == "shared" and len(parts) in (3, 4):
            pfx, total = int(parts[1]), int(parts[2])
            pool = int(parts[3]) if len(parts) == 4 else 1
            if not (1 <= pfx < total and pool >= 1):
                raise ValueError
            return {"dist": "shared", "prefix": pfx, "total": total,
                    "pool": pool}
    except ValueError:
        pass
    raise ValueError(
        f"bad --prompt-len {s!r}: expected N, uniform:LO:HI, or "
        "shared:PFX:TOTAL[:POOL]")



def spec_max_len(spec) -> int:
    """Longest prompt a spec can emit (capacity/calibration sizing)."""
    spec = parse_prompt_spec(spec)
    return {"fixed": spec.get("len"), "uniform": spec.get("hi"),
            "shared": spec.get("total")}[spec["dist"]]



def prompt_ids(spec, rng, base_seed: int):
    """One request's prompt token list under `spec`. Shared prefixes
    derive from `base_seed` + the drawn pool index ONLY — every request
    (and every rerun with the same seed) that draws pool index k gets
    byte-identical prefix tokens, which is what makes the server-side
    prefix-hit counters deterministic."""
    spec = parse_prompt_spec(spec)
    if spec["dist"] == "fixed":
        return [rng.randrange(100) for _ in range(spec["len"])]
    if spec["dist"] == "uniform":
        n = rng.randint(spec["lo"], spec["hi"])
        return [rng.randrange(100) for _ in range(n)]
    pool_idx = rng.randrange(spec["pool"])
    pfx_rng = random.Random(1_000_003 * base_seed + 7919 * pool_idx + 13)
    prefix = [pfx_rng.randrange(100) for _ in range(spec["prefix"])]
    suffix = [rng.randrange(100)
              for _ in range(spec["total"] - spec["prefix"])]
    return prefix + suffix



class _Stats:
    """Per-class outcome/latency accumulator (one lock, short holds)."""

    def __init__(self, classes):
        self._lock = make_lock("loadgen.stats")
        self.counts = {c: dict.fromkeys(OUTCOMES, 0) for c in classes}
        self.latencies = {c: [] for c in classes}     # ok + ok_late, ms
        # per-class worst-N (latency_ms, rid) of served requests: the
        # cross-reference into trace_report --request and the flight
        # recorder's postmortem bundles
        self.worst = {c: [] for c in classes}
        # request ids the server answered 504 (each one triggered a
        # postmortem bundle server-side)
        self.deadline_rids = []
        self.retry_after = []
        self.client_dropped = 0
        self.first_error = None

    def record(self, cls, outcome, latency_ms=None, retry_after=None,
               error=None, rid=None):
        with self._lock:
            self.counts[cls][outcome] += 1
            if latency_ms is not None:
                self.latencies[cls].append(latency_ms)
                if rid is not None:
                    w = self.worst[cls]
                    w.append((latency_ms, rid))
                    w.sort(reverse=True)
                    del w[WORST_N:]
            if outcome == "deadline" and rid is not None \
                    and len(self.deadline_rids) < WORST_N:
                self.deadline_rids.append(rid)
            if retry_after is not None:
                self.retry_after.append(retry_after)
            if error is not None and self.first_error is None:
                self.first_error = f"{cls}: {error}"

    def drop(self):
        with self._lock:
            self.client_dropped += 1



def _percentile(vals, q):
    if not vals:
        return None
    vals = sorted(vals)
    idx = min(len(vals) - 1, max(0, int(round(q / 100.0 * (len(vals) - 1)))))
    return round(vals[idx], 3)



def parse_ramp_spec(spec):
    """`ramp:LO:HI[:HOLD]` -> {"lo", "hi", "hold"}, or None when `spec`
    is a plain arrival-process name. LO/HI are the offered req/s at the
    ramp floor and plateau; HOLD is the plateau's share of the run in
    [0, 1) (default 1/3). The offered rate rises LO->HI over the first
    (1-HOLD)/2 of the run, holds at HI, then falls symmetrically back
    to LO — the autoscale test workload (scale up on the rise, hold
    through the plateau, scale back down on the fall)."""
    if spec is None or not str(spec).startswith("ramp:"):
        return None
    parts = str(spec).split(":")
    if len(parts) not in (3, 4):
        raise ValueError(f"bad ramp spec {spec!r} "
                         "(expected ramp:LO:HI[:HOLD])")
    try:
        lo, hi = float(parts[1]), float(parts[2])
        hold = float(parts[3]) if len(parts) == 4 else 1.0 / 3.0
    except ValueError:
        raise ValueError(f"bad ramp spec {spec!r}: LO/HI/HOLD must be "
                         "numbers") from None
    if lo <= 0 or hi < lo:
        raise ValueError(f"bad ramp spec {spec!r}: need 0 < LO <= HI")
    if not 0.0 <= hold < 1.0:
        raise ValueError(f"bad ramp spec {spec!r}: HOLD is the plateau "
                         "fraction of the run, in [0, 1)")
    return {"lo": lo, "hi": hi, "hold": hold}



def ramp_rate(t, duration_s, ramp):
    """Instantaneous offered rate (req/s) `t` seconds into a
    `ramp:LO:HI[:HOLD]` run: piecewise-linear rise -> hold -> fall."""
    edge = duration_s * (1.0 - ramp["hold"]) / 2.0
    lo, hi = ramp["lo"], ramp["hi"]
    if t < edge:                      # edge > 0 whenever this is reached
        return lo + (hi - lo) * (t / edge)
    if t <= duration_s - edge:
        return hi
    if t >= duration_s:
        return lo
    return hi - (hi - lo) * ((t - (duration_s - edge)) / edge)



def _ramp_offsets(duration_s, ramp):
    # Step `t += 1/rate(t)` across the run so the instantaneous spacing
    # tracks the piecewise-linear offered rate. Deterministic — the
    # ramp analogue of the uniform grid; `seed` still drives the class
    # draw and prompt sampling, so a run is reproducible end-to-end.
    offsets, t = [], 0.0
    while t < duration_s:
        offsets.append(t)
        t += 1.0 / ramp_rate(t, duration_s, ramp)
    return offsets


def arrival_offsets(n, qps, arrival="uniform", rng=None, duration_s=None):
    """Seconds-from-start launch time of each of `n` arrivals at mean
    rate `qps`. `uniform` is the fixed 1/qps grid (the historical
    behavior); `poisson` draws seeded exponential gaps — an open-loop
    memoryless arrival process whose bursts stress the admission queue
    harder than a metronome at the same mean rate. `ramp:LO:HI[:HOLD]`
    (see `parse_ramp_spec`) ignores `n`/`qps` and shapes the rate over
    `duration_s` instead — the arrival count falls out of the rate
    integral. Pure: same (n, qps, arrival, rng seed) -> same offsets."""
    ramp = parse_ramp_spec(arrival)
    if ramp is not None:
        if duration_s is None or duration_s <= 0:
            raise ValueError("ramp arrival needs duration_s > 0")
        return _ramp_offsets(duration_s, ramp)
    if arrival == "uniform":
        return [i / qps for i in range(n)]
    if arrival != "poisson":
        raise ValueError(f"unknown arrival process {arrival!r} "
                         "(expected 'uniform', 'poisson' or "
                         "'ramp:LO:HI[:HOLD]')")
    if rng is None:
        rng = random.Random(0)
    offsets, t = [], 0.0
    for _ in range(n):
        offsets.append(t)
        t += rng.expovariate(qps)
    return offsets



def _one_request(url, cls, slo_ms, deadline_ms, new_tokens, prompt_spec,
                 timeout, stats, rng_seed, base_seed):
    rng = random.Random(rng_seed)
    ids = [prompt_ids(prompt_spec, rng, base_seed)]
    body = {"ids": ids, "new_tokens": new_tokens, "class": cls}
    if deadline_ms is not None:
        body["deadline_ms"] = deadline_ms
    t0 = time.monotonic()
    try:
        status, resp, retry_after = _post(url, body, timeout)
    except Exception as exc:    # noqa: BLE001 — connection-level failure
        stats.record(cls, "error", error=repr(exc))
        return
    ms = (time.monotonic() - t0) * 1e3
    rid = resp.get("rid") if isinstance(resp, dict) else None
    if status == 200:
        outcome = "ok" if (slo_ms is None or ms <= slo_ms) else "ok_late"
        stats.record(cls, outcome, latency_ms=ms, rid=rid)
    elif status == 503 and resp.get("shed"):
        stats.record(cls, "shed", retry_after=retry_after, rid=rid)
    elif status == 503 and resp.get("degraded"):
        stats.record(cls, "degraded", retry_after=retry_after, rid=rid)
    elif status == 504 and resp.get("deadline_exceeded"):
        stats.record(cls, "deadline", rid=rid)
    else:
        stats.record(cls, "error",
                     error=f"HTTP {status}: {resp.get('error', resp)!r}")



def run_load(url, duration_s, qps, mix=None, slo_ms=None,
             deadline_from_slo=True, new_tokens=8, prompt_len=6,
             timeout=120.0, max_inflight=128, seed=0, arrival="uniform"):
    """Offer `qps` requests/s for `duration_s` with the per-class `mix`
    (a `ramp:` arrival shapes the rate instead); return the report dict
    (see the module docstring for the outcomes). `seed` drives
    everything random: the arrival process, the class draw and the
    prompt tokens."""
    mix = dict(DEFAULT_MIX if mix is None else mix)
    unknown = set(mix) - set(REQUEST_CLASSES)
    if unknown:
        raise ValueError(f"unknown classes in mix: {sorted(unknown)}")
    total_w = sum(mix.values())
    ramp = parse_ramp_spec(arrival)
    if total_w <= 0 or duration_s <= 0 \
            or (ramp is None and (qps is None or qps <= 0)):
        raise ValueError("mix weights, qps and duration must be > 0")
    prompt_spec = parse_prompt_spec(prompt_len)
    slo_ms = dict(DEFAULT_SLO_MS if slo_ms is None else slo_ms)
    classes = sorted(mix)
    weights = [mix[c] / total_w for c in classes]
    stats = _Stats(classes)
    rng = random.Random(seed)
    inflight = threading.Semaphore(max_inflight)
    threads = []
    if ramp is not None:
        offsets = arrival_offsets(0, None, arrival, rng,
                                  duration_s=duration_s)
        n = len(offsets)
        qps = n / duration_s         # mean offered rate, for the report
    else:
        n = max(1, int(round(qps * duration_s)))
        offsets = arrival_offsets(n, qps, arrival, rng)
    t0 = time.monotonic()
    for i in range(n):
        delay = t0 + offsets[i] - time.monotonic()   # arrivals on the clock
        if delay > 0:
            time.sleep(delay)
        cls = rng.choices(classes, weights=weights)[0]
        if not inflight.acquire(blocking=False):
            stats.drop()                 # safety valve, not backpressure
            continue
        cls_slo = slo_ms.get(cls)
        deadline = cls_slo if deadline_from_slo else None

        def work(cls=cls, cls_slo=cls_slo, deadline=deadline, i=i):
            try:
                _one_request(url, cls, cls_slo, deadline, new_tokens,
                             prompt_spec, timeout, stats,
                             seed * 100003 + i, seed)
            finally:
                inflight.release()

        t = threading.Thread(target=work, daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=timeout)
    wall = time.monotonic() - t0
    report = {"url": url, "duration_s": round(wall, 3),
              "offered_qps": round(qps, 3), "requests": n,
              "seed": seed, "arrival": arrival,
              "prompt_len": prompt_spec,
              "client_dropped": stats.client_dropped,
              "classes": {}, "totals": dict.fromkeys(OUTCOMES, 0)}
    if ramp is not None:
        report["ramp"] = dict(ramp)
    all_lat = []
    for c in classes:
        counts = stats.counts[c]
        served = counts["ok"] + counts["ok_late"]
        lat = stats.latencies[c]
        all_lat.extend(lat)
        report["classes"][c] = {
            **counts, "sent": sum(counts.values()),
            "slo_ms": slo_ms.get(c),
            "slo_attainment": (None if not served
                               else round(counts["ok"] / served, 4)),
            "goodput_rps": round(counts["ok"] / wall, 3),
            "latency_ms": {"p50": _percentile(lat, 50),
                           "p95": _percentile(lat, 95),
                           "p99": _percentile(lat, 99)},
            "worst": [{"rid": rid, "ms": round(ms, 3)}
                      for ms, rid in stats.worst[c]],
        }
        for k in OUTCOMES:
            report["totals"][k] += counts[k]
    report["latency_ms"] = {"p50": _percentile(all_lat, 50),
                            "p95": _percentile(all_lat, 95),
                            "p99": _percentile(all_lat, 99),
                            "n": len(all_lat)}
    ra = stats.retry_after
    report["retry_after"] = {
        "n": len(ra), "min": min(ra) if ra else None,
        "max": max(ra) if ra else None,
        "distinct": len({round(v, 3) for v in ra})}
    report["deadline_rids"] = stats.deadline_rids
    report["first_error"] = stats.first_error
    return report
