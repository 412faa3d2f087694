"""The port's fleet collector held to the JAX package's.

Both packages' `telemetry/collector.py` `FleetCollector`s scrape the
same replica `/metrics` documents through an injected fetch and clock:
two or three replicas whose counters advance between scrapes, a target
whose scrape fails (refused, or a malformed document), a target that
joins and one that leaves mid-run, per-class outcomes in all three
classes, queue depths, brownout levels and latency exemplars. After
every scrape the two `fleet_snapshot()` dicts compare exactly (no
tolerance: the same floats go through the same arithmetic), as do the
per-class (good, total) counts each collector feeds its burn-rate engine,
the engines' burn rates and breach callbacks, the exemplar union and its
`render_exemplar_lines` text, which each package's `parse_exemplars`
reads back to the same rows. The documents themselves are rendered by
each package's own metrics registry, and the two renderings are equal
byte for byte.
"""
import pytest

from pipeedge_tpu.telemetry import collector as jax_fc
from pipeedge_tpu.telemetry import metrics as jax_prom
from pipeedge_tpu_torch.telemetry import collector as port_fc
from pipeedge_tpu_torch.telemetry import metrics as port_prom

PACKAGES = {"jax": (jax_fc, jax_prom), "port": (port_fc, port_prom)}
CLASSES = ("interactive", "batch", "best_effort")


def replica_text(prom, fc, outcomes, queue=0.0, brownout=0,
                 exemplars=()):
    """A replica's /metrics document rendered by one package's registry:
    `outcomes` {(class, outcome): count}, the admission queue depth, the
    brownout level and latency observations with exemplars."""
    reg = prom.Registry()
    c = reg.counter(fc.CLASS_FAMILY, "requests by class and outcome")
    for cls in CLASSES:
        for outcome in ("ok", "shed", "deadline"):
            c.declare(**{"class": cls, "outcome": outcome})
    for (cls, outcome), n in outcomes.items():
        c.inc(n, **{"class": cls, "outcome": outcome})
    reg.gauge(fc.QUEUE_FAMILY, "queue depth").set(queue)
    reg.gauge(fc.BROWNOUT_FAMILY, "brownout level").set(brownout)
    h = reg.histogram(fc.LATENCY_FAMILY, "latency",
                      buckets=(0.05, 0.1, 1.0))
    for value, rid in exemplars:
        h.observe(value, exemplar=rid)
    return reg.render()


class Fleet:
    """One package's collector over a table of documents that the test
    advances between scrapes; a document that is an exception is raised
    by the fetch."""

    def __init__(self, pkg, history=16, objective=0.99):
        self.fc, self.prom = PACKAGES[pkg]
        self.docs, self.urls = {}, {}
        self.fired, self.fed = [], []
        self.burn = self.fc.BurnRateEngine(
            objective=objective, fast_window_s=30.0, slow_window_s=300.0,
            threshold=10.0, registry=self.prom.Registry(),
            on_breach=lambda cls, b: self.fired.append((cls, b)))
        update = self.burn.update

        def feed(counts, now=None):
            self.fed.append((dict(counts), now))
            return update(counts, now=now)
        self.burn.update = feed
        self.col = self.fc.FleetCollector(
            lambda: dict(self.urls), interval_s=0.5, history=history,
            timeout_s=1.0, fetch_fn=self.fetch, burn=self.burn)

    def fetch(self, url, timeout):
        for name, base in self.urls.items():
            if url == f"{base}/metrics":
                doc = self.docs[name]
                if isinstance(doc, Exception):
                    raise doc
                return doc
        raise OSError(f"unknown target {url}")

    def set(self, name, doc):
        self.urls[name] = f"http://{name}.test:80"
        self.docs[name] = doc

    def leave(self, name):
        self.urls.pop(name)


def _doc(pkg, state, **kw):
    fc, prom = PACKAGES[pkg]
    return replica_text(prom, fc, state, **kw)


# each step: (now, {target: document spec or an exception or None = left})
SCENARIO = [
    (0.0, {"r0": dict(outcomes={("interactive", "ok"): 3}, queue=1.0),
           "r1": dict(outcomes={("batch", "ok"): 1}, queue=0.0)}),
    (0.5, {"r0": dict(outcomes={("interactive", "ok"): 9,
                                ("interactive", "shed"): 2}, queue=5.0,
                      brownout=1, exemplars=[(0.04, "R3"), (2.5, "R7")]),
           "r1": dict(outcomes={("batch", "ok"): 4,
                                ("best_effort", "deadline"): 1},
                      queue=2.0, exemplars=[(0.08, "R4.t1")])}),
    (1.0, {"r0": dict(outcomes={("interactive", "ok"): 15,
                                ("interactive", "shed"): 6}, queue=7.0,
                      brownout=2, exemplars=[(0.09, "R11")]),
           "r1": OSError("connection refused"),
           "r2": dict(outcomes={}, queue=0.0)}),
    (1.5, {"r0": dict(outcomes={("interactive", "ok"): 15,
                                ("interactive", "shed"): 40}, queue=3.0),
           "r1": ValueError("malformed document"),
           "r2": dict(outcomes={("interactive", "ok"): 2}, queue=4.0,
                      exemplars=[(0.5, "R20"), (0.03, "R21")])}),
    (2.0, {"r0": dict(outcomes={("interactive", "ok"): 30,
                                ("interactive", "shed"): 40}, queue=0.0),
           "r1": None,
           "r2": dict(outcomes={("interactive", "ok"): 9,
                                ("batch", "ok"): 3}, queue=0.0)}),
    (40.0, {"r0": dict(outcomes={("interactive", "ok"): 90,
                                 ("interactive", "shed"): 40}),
            "r2": dict(outcomes={("interactive", "ok"): 20,
                                 ("batch", "ok"): 3})}),
]


def _run(pkg, history):
    fleet = Fleet(pkg, history=history)
    out = []
    for now, targets in SCENARIO:
        for name, spec in targets.items():
            if spec is None:
                fleet.leave(name)
            elif isinstance(spec, Exception):
                fleet.set(name, spec)
            else:
                fleet.set(name, _doc(pkg, spec["outcomes"], **{
                    k: v for k, v in spec.items() if k != "outcomes"}))
        answered = fleet.col.scrape_once(now=now)
        out.append((answered, fleet.col.fleet_snapshot(now=now + 0.25),
                    fleet.col._fleet_counts()))
    return fleet, out


@pytest.mark.parametrize("history", [16, 2])
def test_fleet_snapshots_match_jax(history):
    jax_fleet, jax_out = _run("jax", history)
    port_fleet, port_out = _run("port", history)
    for step, (got, want) in enumerate(zip(port_out, jax_out)):
        assert got == want, step
    # the burn-rate engines were fed the same fleet counts at the same
    # times and breached alike
    assert port_fleet.fed == jax_fleet.fed
    assert port_fleet.fired == jax_fleet.fired and port_fleet.fired
    last = port_out[-1][1]
    # what the scenario exercises: a failing target and a departed one,
    # each kept with its last good sample while its ring holds one (r1's
    # queue of 2 still counts while its scrapes fail, unless two failed
    # samples filled a ring of 2), the fleet's max brownout, summed queue
    assert last["scrape_errors"] == 2 and not last["replicas"]["r1"]["ok"]
    assert set(last["replicas"]) == {"r0", "r1", "r2"}
    assert port_out[2][1]["brownout_level"] == 2
    assert port_out[3][1]["queue_depth"] == 3.0 + 4.0 + (
        2.0 if history > 2 else 0.0)


def test_replica_documents_render_alike():
    spec = SCENARIO[1][1]["r0"]
    texts = [_doc(pkg, spec["outcomes"], queue=spec["queue"],
                  brownout=spec["brownout"], exemplars=spec["exemplars"])
             for pkg in PACKAGES]
    assert texts[0] == texts[1]


ROWS = [{"le": "0.05", "trace_id": "R3", "value": 0.04},
        {"le": "0.1", "trace_id": "R4.t1", "value": 0.08},
        {"le": "+Inf", "trace_id": "R7.fo1", "value": 2.5},
        {"le": "1", "trace_id": "R20", "value": 0.5}]


def test_exemplar_union_and_render_round_trip_as_jax():
    _, jax_out = _run("jax", 16)
    _, port_out = _run("port", 16)
    for (_, got, _), (_, want, _) in zip(port_out, jax_out):
        assert got["exemplars"] == want["exemplars"]
        assert got["exemplars_text"] == want["exemplars_text"]
        for fc, prom in PACKAGES.values():
            assert prom.parse_exemplars(got["exemplars_text"],
                                        fc.LATENCY_FAMILY) == got["exemplars"]
    texts = ["\n".join(fc.render_exemplar_lines("f_seconds", ROWS))
             for fc, _ in PACKAGES.values()]
    assert texts[0] == texts[1]
    for fc, prom in PACKAGES.values():
        assert prom.parse_exemplars(texts[0], "f_seconds") == ROWS


def test_counts_and_parse_as_jax():
    spec = SCENARIO[3][1]["r0"]
    text = _doc("jax", spec["outcomes"], queue=spec["queue"])
    fams = {pkg: fc.parse_prom_text(text) for pkg, (fc, _) in
            PACKAGES.items()}
    assert fams["port"] == fams["jax"]
    counts = {pkg: fc.BurnRateEngine.counts_from_families(fams[pkg])
              for pkg, (fc, _) in PACKAGES.items()}
    assert counts["port"] == counts["jax"]
    assert counts["port"]["interactive"] == (15.0, 55.0)
    garbage = "# HELP x y\nnot a metric line !!\nfoo_total 3\nbar_total 4\n"
    assert (port_fc.parse_prom_text(garbage, families=("foo_total",))
            == jax_fc.parse_prom_text(garbage, families=("foo_total",)))
