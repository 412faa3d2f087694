"""The port's capacity controller held to the JAX package's.

Every case of `tests/test_autoscale.py` runs once through each package's
`serving/autoscale.py` (`CapacityPolicy`, `CapacityController`,
`default_classify`, `signals_from_fleet`, `AutoscaleRunner`), with the
same injected clock, the same signal sequence and the same fake fleet.
Each run records, after every tick, the decision (direction, from, to,
outcome, reason, `line()`, `to_dict()`), the controller's `snapshot()`
and flap factor, the target / actual / cooldown-factor gauges, and at
the end how far each cell of `pipeedge_autoscale_decisions_total`
moved. The two records compare exactly (no tolerance: the controller is
integer and float bookkeeping on the same inputs), as do the exceptions
a bad knob raises.
"""
import pytest

from pipeedge_tpu.serving import autoscale as jax_autoscale
from pipeedge_tpu_torch.serving import autoscale as port_autoscale

MODULES = {"jax": jax_autoscale, "port": port_autoscale}

HOT = {"queue_depth": 100.0, "brownout_level": 0, "burn_rate": 0.0}
COLD = {"queue_depth": 0.0, "brownout_level": 0, "burn_rate": 0.0}
NEUTRAL = {"queue_depth": 2.0, "brownout_level": 0, "burn_rate": 0.5}


class Run:
    """One package's controller over a mutable fake fleet (auto-apply
    moves the size), recording everything observable."""

    def __init__(self, m, size=1, mode="auto", plan_ok=True, plan_fn=None,
                 apply_fn=None, **kw):
        kw.setdefault("min_size", 1)
        kw.setdefault("max_size", 3)
        kw.setdefault("confirm", 2)
        kw.setdefault("cooldown_s", 5.0)
        self.m = m
        # a decision's `at` is the injected clock, except under the
        # runner, which ticks on the real one: its `at` is not compared
        self.real_clock = False
        self.state = {"size": size, "applied": []}
        self.rec = []
        self._counts0 = self._counts()

        def plan(direction, frm, to):
            if not plan_ok:
                return {"ok": False, "reason": "floor"}
            return {"ok": True, "direction": direction, "from": frm,
                    "to": to}

        def apply(p):
            self.state["size"] = p["to"]
            self.state["applied"].append(p)

        self.ctl = m.CapacityController(
            m.CapacityPolicy(**kw), mode=mode,
            size_fn=lambda: self.state["size"],
            plan_fn=plan_fn or plan, apply_fn=apply_fn or apply)
        self.observe(None)

    def _counts(self):
        return {(d, o): self.m._M_DECISIONS.value(direction=d, outcome=o)
                for d in self.m.DIRECTIONS for o in self.m.OUTCOMES}

    def observe(self, d):
        snap = self.ctl.snapshot()
        made = None if d is None else d.to_dict()
        if self.real_clock:
            for rec in (made, snap["last"]):
                if rec is not None:
                    rec.pop("at")
        self.rec.append((
            None if d is None else (d.direction, d.frm, d.to, d.outcome,
                                    d.reason, d.line(), made),
            snap, self.ctl.flap_factor, self.state["size"],
            len(self.state["applied"]), self.m._M_TARGET.value(),
            self.m._M_ACTUAL.value(), self.m._M_FLAP.value()))
        return d

    def tick(self, signals, now):
        return self.observe(self.ctl.tick(signals, now=now))

    def drive(self, signals, n, t0=0.0, dt=1.0):
        out, t = [], t0
        for _ in range(n):
            d = self.tick(signals, t)
            if d is not None:
                out.append(d)
            t += dt
        return out, t

    def record(self):
        now = self._counts()
        return self.rec, {k: now[k] - self._counts0[k] for k in now}


# -- the cases of tests/test_autoscale.py, each written once against a
# -- module `m` and run through both packages -------------------------------

def case_single_hot_window_moves_nothing(m):
    r = Run(m, confirm=3)
    for sig, t in ((HOT, 0.0), (NEUTRAL, 1.0), (HOT, 2.0), (HOT, 3.0)):
        r.tick(sig, t)
    return r


def case_confirmed_pressure_scales_up(m):
    r = Run(m, confirm=2)
    r.drive(HOT, 2)
    return r


def case_streak_resets_on_direction_change(m):
    r = Run(m, confirm=2)
    for sig, t in ((HOT, 0.0), (COLD, 1.0), (HOT, 2.0)):
        r.tick(sig, t)
    return r


def case_dwell_blocks_until_streak_has_lasted(m):
    r = Run(m, confirm=2, dwell_up_s=10.0)
    _, t = r.drive(HOT, 5)
    r.drive(HOT, 7, t0=t)
    return r


def case_dwell_down_independent_of_dwell_up(m):
    r = Run(m, size=2, confirm=1, dwell_up_s=0.0, dwell_down_s=30.0)
    r.drive(COLD, 10)
    r.drive(HOT, 1, t0=100.0)
    return r


def case_zero_decisions_at_floor_on_cold_fleet(m):
    r = Run(m, size=1, confirm=1, cooldown_s=0.0)
    r.drive(COLD, 50)
    return r


def case_zero_decisions_at_ceiling_under_pressure(m):
    r = Run(m, size=3, confirm=1, cooldown_s=0.0, max_size=3)
    r.drive(HOT, 20)
    return r


def case_cooldown_spaces_decisions(m):
    r = Run(m, confirm=1, cooldown_s=10.0)
    r.tick(HOT, 0.0)
    r.drive(HOT, 9, t0=1.0)
    r.tick(HOT, 11.0)
    return r


def case_reversal_doubles_cooldown_and_renders_flap_damped(m):
    r = Run(m, confirm=1, cooldown_s=10.0)
    for sig, t in ((HOT, 0.0), (COLD, 11.0), (HOT, 22.0), (HOT, 23.0),
                   (HOT, 40.0)):
        r.tick(sig, t)
    return r


def case_flap_factor_caps_and_calms(m):
    r = Run(m, confirm=1, cooldown_s=1.0, flap_cap=4.0)
    t = 0.0
    for sig in (HOT, COLD, HOT, COLD, HOT):
        while r.tick(sig, t) is None:
            t += 1.0
        t += 100.0
    r.tick(COLD, t)
    t += 100.0
    r.state["size"] = 3
    r.tick(COLD, t)
    return r


def case_scale_down_ordered_behind_brownout(m):
    r = Run(m, size=2, confirm=1, cooldown_s=0.0)
    r.ctl._classify = lambda pol, sig: -1
    r.drive(dict(COLD, brownout_level=2), 10)
    r.drive(COLD, 1, t0=100.0)
    return r


def case_unrunnable_plan_renders_held(m):
    r = Run(m, size=2, confirm=1, plan_ok=False)
    r.tick(COLD, 0.0)
    r.tick(COLD, 1.0)
    return r


def case_crashing_planner_renders_held_not_raise(m):
    def bad_plan(direction, frm, to):
        raise RuntimeError("boom")
    r = Run(m, confirm=1, plan_fn=bad_plan)
    r.tick(HOT, 0.0)
    return r


def case_failing_apply_renders_held(m):
    def bad_apply(plan):
        raise RuntimeError("spawn refused")
    r = Run(m, confirm=1, apply_fn=bad_apply)
    r.tick(HOT, 0.0)
    return r


def case_advise_logs_without_acting(m):
    r = Run(m, mode="advise", size=2, confirm=2)
    _, t = r.drive(HOT, 2)
    r.tick(HOT, t)
    r.tick(COLD, t + 100.0)
    r.tick(COLD, t + 101.0)
    return r


def case_snapshot_shape(m):
    r = Run(m, confirm=1)
    r.tick(HOT, 0.0)
    return r


def case_runner_emits_decision_lines(m):
    r = Run(m, confirm=1)
    r.real_clock = True
    lines = []
    runner = m.AutoscaleRunner(r.ctl, signals_fn=lambda: HOT,
                               interval_s=0.01, emit=lines.append)
    r.observe(runner.tick_once())
    runner._signals_fn = lambda: (_ for _ in ()).throw(OSError("down"))
    r.observe(runner.tick_once())
    r.rec.append(list(lines))
    with pytest.raises(ValueError) as err:
        m.AutoscaleRunner(r.ctl, signals_fn=dict, interval_s=0.0)
    r.rec.append(str(err.value))
    return r


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_controller_cases_match_jax(name):
    runs = {k: CASES[name](m) for k, m in MODULES.items()}
    jax_rec, jax_counts = runs["jax"].record()
    port_rec, port_counts = runs["port"].record()
    assert port_rec == jax_rec
    assert port_counts == jax_counts
    # the case moved the counters at all where the JAX test says it does
    assert sum(port_counts.values()) == sum(
        1 for obs in port_rec if isinstance(obs, tuple) and obs[0])


@pytest.mark.parametrize("bad", [
    dict(min_size=0), dict(min_size=3, max_size=2), dict(confirm=0),
    dict(cooldown_s=-1), dict(dwell_up_s=-1),
    dict(queue_low=5.0, queue_high=4.0), dict(queue_low=-1.0),
    dict(burn_low=2.0, burn_high=1.0), dict(flap_cap=0.5),
])
def test_policy_rejects_bad_knobs_as_jax(bad):
    msgs = []
    for m in MODULES.values():
        with pytest.raises(ValueError) as err:
            m.CapacityPolicy(**bad)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_modes_and_bad_mode_as_jax():
    msgs = []
    for m in MODULES.values():
        with pytest.raises(ValueError) as err:
            m.CapacityController(mode="yolo")
        msgs.append(str(err.value))
        assert (m.MODES, m.DIRECTIONS, m.OUTCOMES) == (
            jax_autoscale.MODES, jax_autoscale.DIRECTIONS,
            jax_autoscale.OUTCOMES)
    assert msgs[0] == msgs[1]


CLASSIFY = [dict(HOT, size=1), dict(COLD, size=1), dict(NEUTRAL, size=1),
            dict(COLD, brownout_level=1, size=1),
            dict(COLD, burn_rate=2.0, size=1),
            {"queue_depth": 6.0, "brownout_level": 0, "burn_rate": 0.0,
             "size": 4},
            {"queue_depth": 4.0, "size": 0}, {}]


def test_classify_signs_as_jax():
    pols = {k: m.CapacityPolicy(queue_high=4, queue_low=0.5, burn_high=1.0,
                                burn_low=0.25) for k, m in MODULES.items()}
    got = {k: [m.default_classify(pols[k], sig) for sig in CLASSIFY]
           for k, m in MODULES.items()}
    assert got["port"] == got["jax"] == [1, -1, 0, 1, 1, 0, 1, -1]


FLEETS = [
    {"queue_depth": 7.0, "brownout_level": 2,
     "slo": {"burn_rate": {"interactive": {"short": 3.0, "long": 0.1},
                           "batch": {"short": 0.5}}}},
    {},
    {"queue_depth": 12, "brownout_level": 0, "slo": {"burn_rate": {}}},
    {"queue_depth": 0.0, "brownout_level": 1, "slo": None},
]


@pytest.mark.parametrize("fleet", FLEETS, ids=range(len(FLEETS)))
def test_signals_from_fleet_as_jax(fleet):
    got = {k: m.signals_from_fleet(fleet, size=2)
           for k, m in MODULES.items()}
    assert got["port"] == got["jax"]


def test_gauges_and_counter_matrix_as_jax():
    """The decision counter's full direction x outcome matrix exists before
    any decision, under the JAX family names and help texts."""
    for name in ("_M_DECISIONS", "_M_TARGET", "_M_ACTUAL", "_M_FLAP"):
        j, p = (getattr(m, name) for m in MODULES.values())
        assert (p.name, p.help, p.kind) == (j.name, j.help, j.kind)
    keys = {k: set(m._M_DECISIONS.values()) for k, m in MODULES.items()}
    assert keys["port"] == keys["jax"] and len(keys["port"]) == 8
