"""The port's serving and health copies against the JAX package's.

`pipeedge_tpu_torch/serving/{admission,brownout}.py` and
`pipeedge_tpu_torch/health/` are copies; on the same arrivals, grants,
completions and `now=` clock values they must take the JAX package's
decisions:

- `TokenBucket`, `EDFQueue` and `ServiceRateEstimator` step for step;
- `AdmissionController`: the same grants, sheds (with their reasons and
  Retry-After values), grant order and deadline outcomes, and the same
  snapshots and shed counters;
- `BrownoutLadder`: the same levels at the same steps of a watermark
  series, and the same effects (clamps, shed classes);
- the gray-failure scorer walks the same lifecycle on the same samples;
- `default_policies` and `parse_class_map` agree, refusals included.
"""
import importlib
import threading
import time

import numpy as np
import pytest

from pipeedge_tpu import health as jhealth
from pipeedge_tpu.health import guard as jguard
from pipeedge_tpu.serving import admission as jadm
from pipeedge_tpu.serving import brownout as jbrown
from pipeedge_tpu.telemetry import metrics as jprom
from pipeedge_tpu_torch import health as thealth
from pipeedge_tpu_torch.health import guard as tguard
from pipeedge_tpu_torch.serving import admission as tadm
from pipeedge_tpu_torch.serving import brownout as tbrown
from pipeedge_tpu_torch.telemetry import metrics as tprom

PACKAGES = {"jax": (jadm, jbrown, jprom), "torch": (tadm, tbrown, tprom)}
# each health package's `scorer` attribute is its accessor function, so
# the scorer modules are looked up by name
jscorer = importlib.import_module("pipeedge_tpu.health.scorer")
tscorer = importlib.import_module("pipeedge_tpu_torch.health.scorer")


def _bucket_trace(adm):
    rng = np.random.default_rng(1)
    bucket = adm.TokenBucket(rate=2.0, burst=3.0, now=0.0)
    now, out = 0.0, []
    for _ in range(60):
        now += float(rng.exponential(0.3))
        out.append((bucket.try_take(float(rng.choice([0.5, 1.0, 2.0])),
                                    now=now), round(bucket.tokens, 12)))
    return out


def _edf_trace(adm):
    q = adm.EDFQueue(capacity=4)
    out = []
    for i, deadline in enumerate([5.0, None, 2.0, 9.0, 1.0, 3.0, None]):
        shed = q.push(f"r{i}", deadline)
        out.append(("push", shed, len(q)))
    out.append(("peek", q.peek()))
    out.append(("expired", q.pop_expired(2.5)))
    out.append(("remove", q.remove("r3"), q.remove("nope")))
    out.append(("items", q.items()))
    while len(q):
        out.append(("pop", q.pop()))
    out.append(("empty", q.pop(), q.peek()))
    return out


def _rate_trace(adm):
    est = adm.ServiceRateEstimator(halflife_s=2.0)
    out = [(est.rate(), est.retry_after(3))]
    now = 0.0
    for i in range(20):
        now += 0.1 + 0.05 * (i % 4)
        est.observe(now)
        out.append((est.rate(), est.retry_after(i % 5, fallback=7.0)))
    return out


@pytest.mark.parametrize("trace", [_bucket_trace, _edf_trace, _rate_trace])
def test_primitives_identical(trace):
    assert trace(tadm) == trace(jadm)


def _admission_trace(adm, prom):
    """Door decisions, then queued waiters granted by releases in EDF
    order, a waiter displaced by a full queue, a deadline expiry in the
    queue, brownout and shutdown sheds. Waiting threads are driven one
    at a time (each step waits for the queue depth it caused), so the
    trace is deterministic."""
    reg = prom.Registry()
    ctl = adm.AdmissionController(
        concurrency=2, queue_capacity=2, registry=reg,
        policies=adm.default_policies({"batch": 1.0}, {"best_effort": 30}))
    out = []

    def door(cls, deadline=None, now=None):
        try:
            t = ctl.admit(cls, deadline, now=now, rid=f"d{len(out)}")
            out.append(("granted", cls))
            return t
        except adm.AdmissionShed as exc:
            out.append(("shed", exc.request_class, exc.reason,
                        exc.retry_after))
        except KeyError as exc:
            out.append(("keyerror", str(exc)))
        return None

    base = time.monotonic()
    out.append(("deadline_for", ctl.deadline_for("best_effort", now=10.0),
                ctl.deadline_for("interactive", 0.5, now=10.0),
                ctl.deadline_for("interactive", now=10.0)))
    door("nope")
    a = door("batch", now=base)              # takes the bucket's token
    door("batch", now=base + 0.01)           # rate shed
    door("interactive", deadline=base - 1.0)   # already expired
    b = door("interactive")
    results, threads = {}, {}

    def waiter(name, cls, deadline):
        try:
            results[name] = ("granted", ctl.admit(cls, deadline,
                                                  rid=name).rid)
        except adm.AdmissionShed as exc:
            results[name] = ("shed", exc.reason)

    def enqueue(name, cls, deadline, depth):
        threads[name] = threading.Thread(target=waiter,
                                         args=(name, cls, deadline))
        threads[name].start()
        t_end = time.monotonic() + 30
        while ctl.queue_depth != depth and time.monotonic() < t_end:
            time.sleep(0.001)
        out.append(("queued", name, ctl.queue_depth))

    far = time.monotonic() + 600
    enqueue("w_late", "interactive", far + 100, 1)
    enqueue("w_early", "interactive", far, 2)
    # the queue is full: a later-deadline arrival sheds itself, an
    # earlier one displaces the latest waiter
    door("interactive", deadline=far + 500)
    enqueue("w_first", "interactive", far - 100, 2)
    threads["w_late"].join(30)
    out.append(("displaced", results.pop("w_late")))
    snap = ctl.snapshot()
    out.append(("snapshot", {k: v for k, v in snap.items()
                             if k != "service_rate_rps"}))
    for ticket in (a, b):
        ctl.release(ticket, now=base + 1.0)
        t_end = time.monotonic() + 30
        while len(results) < 1 and time.monotonic() < t_end:
            time.sleep(0.001)
        out.append(("release", sorted(results.items())))
        results.clear()
    # a deadline that passes while queued: released slots are all taken
    enqueue("w_expire", "interactive", time.monotonic() + 1.0, 1)
    threads["w_expire"].join(30)
    out.append(("expired_in_queue", results.pop("w_expire")))
    ctl.set_shed_classes(["best_effort"])
    door("best_effort")
    enqueue("w_shutdown", "interactive", None, 1)
    ctl.close()
    threads["w_shutdown"].join(30)
    out.append(("shutdown", results.pop("w_shutdown")))
    door("interactive")
    for name in ("w_early", "w_first"):
        threads[name].join(30)
    out.append(("alive", [n for n, t in threads.items() if t.is_alive()]))
    out.append(("render", "\n".join(
        ln for ln in reg.render().splitlines()
        if "admission_latency" not in ln)))
    return out


def test_admission_controller_same_decisions():
    got = _admission_trace(tadm, tprom)
    want = _admission_trace(jadm, jprom)
    assert got == want
    assert ("shed", "batch", "rate", 5.0) in got
    assert ("displaced", ("shed", "queue_full")) in got
    assert ("alive", []) in got


def test_token_budget_admission_same_decisions():
    out = {}
    for name, (adm, _, prom) in PACKAGES.items():
        ctl = adm.AdmissionController(concurrency=4, token_budget=100,
                                      registry=prom.Registry())
        trace = []
        tickets = []
        for tokens in (60, 30, 500):
            try:
                tickets.append(ctl.admit("interactive", tokens=tokens,
                                         now=1.0))
                trace.append(("granted", tokens))
            except adm.AdmissionShed as exc:
                trace.append(("shed", exc.reason))
        ctl.release(tickets[0], now=2.0)
        trace.append(ctl.snapshot()["tokens_free"])
        ctl.notify_step(now=2.5)
        out[name] = trace
    assert out["torch"] == out["jax"] == [("granted", 60), ("granted", 30),
                                          ("shed", "budget"), 70]


def _ladder_trace(brown, prom, marks_kw, series):
    ladder = brown.BrownoutLadder(brown.Watermarks(**marks_kw),
                                  clamp_new_tokens=8, clamp_chunk_tokens=4,
                                  registry=prom.Registry())
    hooked = []
    ladder.evict_hook = lambda: hooked.append(ladder.level)
    out = []
    for step, (depth, p95, floor) in enumerate(series):
        if floor is not None:
            ladder.set_floor(floor)
        level = ladder.update(depth, p95, now=0.25 * step)
        out.append((level, ladder.level_name, ladder.clamp(100),
                    ladder.clamp_chunk(32), ladder.allow_speculative(),
                    ladder.allow_disaggregate(),
                    sorted(ladder.shed_classes()), ladder.snapshot()))
    return out, hooked


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brownout_ladder_same_levels(seed):
    rng = np.random.default_rng(seed)
    series = []
    for step in range(120):
        hot = (step // 30) % 2 == 0
        depth = int(rng.integers(6, 20) if hot else rng.integers(0, 3))
        p95 = (None if rng.random() < 0.1 else
               float(rng.uniform(1.5, 4.0) if hot else rng.uniform(0, 0.45)))
        floor = (int(rng.integers(0, 3)) if rng.random() < 0.05 else None)
        series.append((depth, p95, floor))
    marks = dict(queue_high=8, queue_low=1, p95_high_s=2.0, p95_low_s=0.5,
                 dwell_up_s=0.5, dwell_down_s=1.0)
    got = _ladder_trace(tbrown, tprom, marks, series)
    assert got == _ladder_trace(jbrown, jprom, marks, series)
    levels = [row[0] for row in got[0]]
    assert max(levels) == tbrown.MAX_LEVEL and levels[-1] < max(levels)
    assert tbrown.LEVEL_NAMES == jbrown.LEVEL_NAMES


def test_watermark_and_policy_refusals_identical():
    for kw in ({"queue_low": 9}, {"p95_low_s": 3.0}):
        with pytest.raises(ValueError) as jerr:
            jbrown.Watermarks(**kw)
        with pytest.raises(ValueError) as terr:
            tbrown.Watermarks(**kw)
        assert str(terr.value) == str(jerr.value)
    pairs = ["interactive=2.5", "batch=0.5"]
    assert tadm.parse_class_map(pairs, "--x") == jadm.parse_class_map(
        pairs, "--x")
    for bad in (["interactive"], ["nope=1"], ["batch=x"]):
        with pytest.raises(ValueError) as jerr:
            jadm.parse_class_map(bad, "--x")
        with pytest.raises(ValueError) as terr:
            tadm.parse_class_map(bad, "--x")
        assert str(terr.value) == str(jerr.value)
    want = jadm.default_policies({"batch": 3.0}, {"interactive": 1.5})
    got = tadm.default_policies({"batch": 3.0}, {"interactive": 1.5})
    assert {k: vars(v) for k, v in got.items()} == \
        {k: vars(v) for k, v in want.items()}
    assert tadm.REQUEST_CLASSES == jadm.REQUEST_CLASSES


def _health_walk(health_mod, scorer_mod):
    policy = scorer_mod.HealthPolicy(confirm=2, readmit=2, probation=2)
    sc = scorer_mod.PeerHealthScorer([0, 1, 2], policy)
    rng = np.random.default_rng(3)
    states = []
    for window in range(40):
        for rank in (0, 1, 2):
            bad = rank == 1 and 5 <= window < 15
            sample = scorer_mod.HealthSample(
                service_ratio=float(rng.uniform(1.6, 2.0) if bad
                                    else rng.uniform(0.95, 1.05)),
                rtt_ratio=None if window % 7 == 0 else float(
                    rng.uniform(0.9, 1.1)),
                send_retries=int(bad and window % 3 == 0))
            sc.observe(rank, sample, can_quarantine=window != 8)
        states.append(sc.snapshot())
    health_mod.set_scorer(sc)
    try:
        installed = health_mod.snapshot()
    finally:
        health_mod.set_scorer(None)
    assert health_mod.scorer() is None
    return states, [vars(t) for t in sc.transitions], installed


def test_health_scorer_same_lifecycle():
    assert thealth.snapshot() == jhealth.snapshot() == {}
    got = _health_walk(thealth, tscorer)
    assert got == _health_walk(jhealth, jscorer)
    kinds = {(t["frm"], t["to"]) for t in got[1]}
    assert ("suspect", "quarantined") in kinds


def test_nan_guard_on_torch_tensors(monkeypatch, tmp_path):
    import torch
    monkeypatch.setenv(tguard.ENV_NAN_GUARD, "1")
    monkeypatch.setenv("PIPEEDGE_POSTMORTEM_DIR", str(tmp_path))
    ok = (torch.ones(3), torch.arange(4))
    assert tguard.check_finite(ok, "stage 0") is ok
    assert jguard.check_finite(np.ones(3), "stage 0") is not None
    for bad in (torch.tensor([1.0, float("nan")]), np.array([np.inf])):
        with pytest.raises(tguard.PoisonedActivationError) as terr:
            tguard.check_finite(bad, "stage 1", mb=3)
        with pytest.raises(jguard.PoisonedActivationError) as jerr:
            jguard.check_finite(np.asarray(bad), "stage 1", mb=3)
        assert str(terr.value) == str(jerr.value)
