"""The port's replica router against the JAX package's, on injected I/O.

- Every case of `tests/test_router.py` (registry lifecycle and
  hysteresis, prefix affinity, dispatch retry, shed retry, hedging,
  stream failover, the drain state machine, rid derivation) runs against
  `pipeedge_tpu_torch/serving/router.py`: the cases' source is loaded
  with its imports pointed at the port's module, so each pinned decision
  holds for the port too.
- Scripted scenarios run through both packages' routers side by side
  (same health polls, same scripted replica answers) and their decision
  traces (states, transitions, picks, statuses, bodies, headers, replica
  order) are equal.
"""
import importlib.util
import pathlib
import threading
import time

import pytest

from pipeedge_tpu.serving import router as jrouter
from pipeedge_tpu_torch.serving import router as trouter

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_cases():
    """tests/test_router.py with its imports pointed at the port."""
    src = (ROOT / "tests" / "test_router.py").read_text()
    for a, b in (("from pipeedge_tpu.serving import router as router_mod",
                  "from pipeedge_tpu_torch.serving import router as "
                  "router_mod"),
                 ("from pipeedge_tpu.serving.router import",
                  "from pipeedge_tpu_torch.serving.router import")):
        assert src.count(a) == 1
        src = src.replace(a, b)
    assert "pipeedge_tpu." not in src.replace("pipeedge_tpu_torch.", "")
    spec = importlib.util.spec_from_loader("port_router_cases", loader=None)
    mod = importlib.util.module_from_spec(spec)
    exec(compile(src, "tests/test_router.py (port)", "exec"), mod.__dict__)
    cases = []
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or not callable(fn):
            continue
        marks = [m for m in getattr(fn, "pytestmark", ())
                 if m.name == "parametrize"]
        if not marks:
            cases.append(pytest.param(fn, {}, id=name))
            continue
        (argname, values), = [m.args for m in marks]
        for i, v in enumerate(values):
            cases.append(pytest.param(fn, {argname: v}, id=f"{name}[{i}]"))
    return mod, cases


_CASES_MOD, _CASES = _port_cases()


@pytest.mark.parametrize("case,kwargs", _CASES)
def test_jax_router_case_holds_for_the_port(case, kwargs):
    assert case.__globals__["DecodeRouter"] is trouter.DecodeRouter
    case(**kwargs)


def test_every_jax_router_case_is_run():
    src = (ROOT / "tests" / "test_router.py").read_text()
    names = {line.split("(")[0][4:] for line in src.splitlines()
             if line.startswith("def test_")}
    ran = {p.id.split("[")[0] for p in _CASES}
    assert names == ran and len(names) > 40


# -- side-by-side scenarios --------------------------------------------------

def _policy(m, **kw):
    kw.setdefault("backoff_s", 0.001)
    kw.setdefault("backoff_max_s", 0.002)
    return m.RouterPolicy(**kw)


def _registry_trace(m):
    reg = m.ReplicaRegistry(_policy(m, alpha=0.5, readmit=2, fail_dead=3))
    for i in range(3):
        reg.add(f"r{i}", f"u{i}")
    trace = []
    polls = [("r0", True, 0.9), ("r0", True, 0.9), ("r1", False, None),
             ("r1", False, None), ("r1", False, None), ("r1", True, 0.0),
             ("r1", True, 0.0), ("r1", True, 0.0), ("r1", True, 0.0),
             ("r0", True, 0.3), ("r0", True, 0.0), ("r0", True, 0.0),
             ("r0", True, 0.0), ("r2", True, 0.1)]
    for name, ok, lat in polls:
        trace.append(("observe", name, reg.observe(name, ok, latency_s=lat),
                      reg.state_of(name), round(reg.score_of(name), 9)))
        trace.append(("pick", reg.pick([1, 2, 3, name == "r0"])))
    for tokens in ([5] * 40, [5] * 32 + [6], [7, 8], None, [7, 8, 9]):
        trace.append(("pick", reg.pick(tokens), reg.affinity_owner(
            tokens) if tokens else None))
    reg.note_route("r0")
    reg.note_route("r0")
    trace.append(("least-loaded", reg.pick()))
    trace.append(("drain", reg.drain("r2"), reg.state_of("r2")))
    trace.append(("moved", reg.reassign_affinity("r2", "r1"),
                  reg.reassign_affinity("r0", "r1")))
    trace.append(("keys", sorted(reg.affinity_keys_of("r1"))))
    reg.mark_failed("r1")
    reg.undrain("r2")
    trace.append(("after", reg.pick([7, 8]), reg.state_of("r2")))
    trace.append(("transitions", list(reg.transitions)))
    snap = reg.snapshot()
    trace.append(("snapshot", {n: {k: v for k, v in r.items()
                                   if k != "last_ok_age_s"}
                               for n, r in snap.items()}))
    return trace


def _dispatch_trace(m):
    """Connect failure, shed retry, unanimous shed, no replica."""
    script = {"n": 0}
    seen = []

    def post(url, path, payload, timeout, headers=None):
        script["n"] += 1
        seen.append((url, path, dict(headers or {}), payload.get("ids")))
        n = script["n"]
        if n == 1:
            raise OSError("connection refused")
        if n in (3, 4):
            return 503, {"error": "shed", "shed": True}, [("Retry-After",
                                                            "7")]
        return 200, {"ids": [[n]]}, []

    rt = m.DecodeRouter({f"r{i}": f"http://t:{i}" for i in range(3)},
                        policy=_policy(m, route_retries=2), post_fn=post)
    out = [rt.dispatch({"ids": [1, 2], "new_tokens": 1}),
           rt.dispatch({"ids": [3, 4], "new_tokens": 1, "rid": "cli"}),
           rt.dispatch({"ids": [5], "new_tokens": 1})]
    for name in rt.registry.names():
        rt.registry.mark_failed(name)
    out.append(rt.dispatch({"ids": [6], "new_tokens": 1}))
    return out, seen, rt.registry.snapshot().keys(), \
        [rt.registry.state_of(n) for n in rt.registry.names()]


def _hedge_trace(m):
    release = threading.Event()

    def post(url, path, payload, timeout, headers=None):
        if url.endswith(":0"):
            release.wait(5)
            return 200, {"ids": [[0]]}, []
        return 200, {"ids": [[1]]}, []

    rt = m.DecodeRouter({"r0": "http://t:0", "r1": "http://t:1"},
                        policy=_policy(m, hedge_ms=20), post_fn=post)
    status, body, headers = rt.dispatch({"ids": [9], "new_tokens": 1})
    release.set()
    batch = rt.dispatch({"ids": [9], "new_tokens": 1, "class": "batch"})
    return status, body, sorted(headers), batch


def _stream_trace(m):
    class Scripted(m.DecodeRouter):
        def __init__(self, scripts, **kw):
            super().__init__({"r0": "u0", "r1": "u1"}, **kw)
            self.scripts = list(scripts)
            self.to = []

        def _stream_from(self, name, payload, rid=None, hop=0):
            self.to.append((name, rid, hop))
            yield from self.scripts.pop(0)

    def step(i):
        return ("line", {"step": i, "tokens": [[i]]})

    died = [("ok", None), step(0), step(1)]        # truncated: death
    replay = [("ok", None), step(0), step(1), step(2),
              ("line", {"ids": [[0, 1, 2]], "steps": 3})]
    errored = [("ok", None), step(0), ("line", {"error": "worker died"})]
    shed = [("refusal", (503, [("Retry-After", "3")], {"shed": True}))]
    out = []
    for scripts in ([died, replay], [errored, replay], [shed, replay],
                    [died, died]):
        rt = Scripted([list(s) for s in scripts], policy=_policy(m))
        items = list(rt.stream({"ids": [1], "new_tokens": 3,
                                "stream": True}))
        out.append((items, rt.to,
                    [rt.registry.state_of(n) for n in ("r0", "r1")]))
    return out


def _drain_trace(m):
    calls = []
    polls = {"n": 0}

    def post(url, path, payload, timeout, headers=None):
        calls.append((url, path, payload.get("ids")))
        if path == "/kv/export":
            return 200, {"blob": "QUJD", "pages": 2,
                         "tokens_covered": 32}, []
        if path == "/kv/import":
            return 200, {"installed_pages": 2}, []
        if path == "/prefix":
            return 200, {"prefix_id": "p0", "len": 3}, []
        return 200, {"draining": True, "active": 1}, []

    def get(url, path, timeout):
        polls["n"] += 1
        return 200, {"ok": True, "stats": {"active": max(0, 2 -
                                                          polls["n"])}}

    rt = m.DecodeRouter({"r0": "http://t:0", "r1": "http://t:1"},
                        policy=_policy(m, drain_timeout_s=5), post_fn=post,
                        get_fn=get)
    pid, _ = rt.register_prefix([11, 12, 13])
    rt._prepare("r0", {"prefix_id": pid})        # registered on r0
    rt.registry.pick([21, 22])                  # affinity r0 (least name)
    out = rt.drain_replica("r0")
    again = rt.drain_replica("r0")
    rt.registry.mark_failed("r1")
    dead = rt.drain_replica("r1")
    return (out, again, dead, calls, polls["n"] >= 2,
            rt.registry.affinity_owner([21, 22]),
            [rt.registry.state_of(n) for n in ("r0", "r1")])


@pytest.mark.parametrize("scenario", [_registry_trace, _dispatch_trace,
                                      _hedge_trace, _stream_trace,
                                      _drain_trace],
                         ids=lambda f: f.__name__.strip("_"))
def test_decisions_equal_jax_router(scenario):
    got, want = scenario(trouter), scenario(jrouter)
    if scenario is _dispatch_trace:
        # the port's one departure (fault F7): request 2 is shed by both
        # live replicas while r0 is dead. The JAX router counts the dead
        # r0 as a replica left to try and answers "no routable replica";
        # the port surfaces the second shed. Every post is the same.
        shed = (503, {"error": "shed", "shed": True},
                [("Retry-After", "7"), ("X-PipeEdge-Rid", "cli"),
                 ("X-PipeEdge-Replica", "r2")])
        assert got[0][1] == shed
        assert want[0][1] == (503, {"error": "no routable replica",
                                    "no_replica": True},
                              [("Retry-After", "1"),
                               ("X-PipeEdge-Rid", "cli")])
        got = ([got[0][0], want[0][1], *got[0][2:]], *got[1:])
    assert got == want


def _with_dead(m, answers):
    """A 3-replica router whose r0 is dead; r1 and r2 answer `/generate`
    with the scripted (status, body) in turn."""
    answers = list(answers)
    posts = []

    def post(url, path, payload, timeout, headers=None):
        posts.append(url)
        status, body = answers.pop(0)
        return status, body, ([("Retry-After", "7")] if status == 503
                              else [])

    rt = m.DecodeRouter({f"r{i}": f"http://t:{i}" for i in range(3)},
                        policy=_policy(m, route_retries=2), post_fn=post)
    rt.registry.mark_failed("r0")
    return rt, posts


@pytest.mark.parametrize("second", [(503, {"error": "shed", "shed": True}),
                                    (200, {"ids": [[4]]})],
                         ids=["shed", "ok"])
def test_shed_retry_skips_a_dead_replica(second):
    """A shed is retried once on another routable replica and surfaced
    when none is left: a dead replica is not one (F7)."""
    shed = (503, {"error": "shed", "shed": True})
    rt, posts = _with_dead(trouter, [shed, second])
    status, body, headers = rt.dispatch({"ids": [4], "new_tokens": 1})
    assert (status, body) == second and len(posts) == 2
    assert "http://t:0" not in posts
    if status == 503:
        assert ("Retry-After", "7") in headers
    # with only one live replica the shed is surfaced without a retry
    rt2, posts2 = _with_dead(trouter, [shed])
    rt2.registry.mark_failed("r2")
    assert rt2.dispatch({"ids": [4], "new_tokens": 1})[:2] == shed
    assert posts2 == ["http://t:1"]


def test_stream_shed_retry_skips_a_dead_replica():
    """The streaming path: r1 sheds, r0 is dead, so the shed reaches the
    client with its Retry-After instead of "no routable replica"."""
    class Scripted(trouter.DecodeRouter):
        def __init__(self, **kw):
            super().__init__({"r0": "u0", "r1": "u1"}, **kw)
            self.to = []

        def _stream_from(self, name, payload, rid=None, hop=0):
            self.to.append(name)
            yield ("refusal", (503, [("Retry-After", "3")], {"shed": True}))

    rt = Scripted(policy=_policy(trouter))
    rt.registry.mark_failed("r0")
    items = list(rt.stream({"ids": [1], "new_tokens": 3, "stream": True}))
    assert rt.to == ["r1"]
    assert items[-1] == ("line", {"shed": True})
    assert items[0][:2] == ("status", 503)
    assert ("Retry-After", "3") in items[0][2]


def test_router_module_is_model_free():
    """The router imports the port's telemetry, metrics and lock factory
    only (no model, no kernels, no device)."""
    import ast
    tree = ast.parse((ROOT / "pipeedge_tpu_torch" / "serving" /
                      "router.py").read_text())
    top = {node.module for node in tree.body
           if isinstance(node, ast.ImportFrom) and node.level > 0}
    assert top == {None, "telemetry", "utils.threads"}
    t0 = time.monotonic()
    trouter.DecodeRouter({"r0": "u"}).registry.snapshot()
    assert time.monotonic() - t0 < 5
