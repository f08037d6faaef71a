"""The port's spans and counters (utils.profiling.span / count / enable /
disable / drain): off they record nothing and open no profiler range; on,
their parent links, ids, per-thread stacks and cap; the trees the trainer
and the Localizer record; and the benchmark's reading of them
(portbench/spans.py)."""
import threading

import numpy as np
import pytest
import torch

from portbench import profile as pprofile
from portbench import spans as pspans
from splatloc_tpu_torch.match import hungarian
from splatloc_tpu_torch.train import mapping as tmapping
from splatloc_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


@pytest.fixture
def tracer():
    """The tracer on, drained before and after; off again at the end."""
    tprof.drain()
    tprof.enable()
    try:
        yield tprof
    finally:
        tprof.disable()
        tprof.drain()


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _block():
    with tprof.span("t.outer", iteration=1):
        with tprof.span("t.inner"):
            torch.ones(4) + 1
        tprof.count("t.n", 3)


def test_tracer_off_records_nothing():
    """Off: the shared no-op context, no span, no counter, and no
    record_function range in a profiler trace of a block crossing spans."""
    tprof.disable()
    tprof.drain()
    assert tprof.span("t.outer", iteration=1) is tprof.span("t.inner")
    names = _profiled(_block)
    assert not names & {"t.outer", "t.inner"}
    assert any("add" in n for n in names)
    assert tprof.drain() == {"spans": [], "counters": {},
                             "spans_dropped": 0}


def test_tracer_on_links_parents_ids_and_threads(tracer):
    """On: each span names its parent on its own thread, inherits its
    parent's ids under its own, and is a record_function range; a second
    thread keeps its own stack."""
    names = _profiled(_block)
    assert {"t.outer", "t.inner"} <= names
    started = threading.Event()
    release = threading.Event()

    def other():
        with tprof.span("t.thread", query="q7"):
            started.set()
            release.wait(10)
            with tprof.span("t.thread.child"):
                pass

    th = threading.Thread(target=other)
    with tprof.span("t.main"):
        th.start()
        assert started.wait(10)
        with tprof.span("t.main.child", query="q1"):
            release.set()
            th.join(10)
    assert not th.is_alive()
    out = tracer.drain()
    by = {s.name: s for s in out["spans"]}
    assert out["counters"] == {"t.n": 3} and out["spans_dropped"] == 0
    assert by["t.outer"].parent is None
    assert by["t.inner"].parent == by["t.outer"].id
    assert by["t.inner"].attrs == {"iteration": 1}
    assert by["t.thread"].parent is None
    assert by["t.thread.child"].parent == by["t.thread"].id
    assert by["t.thread.child"].attrs == {"query": "q7"}
    assert by["t.main.child"].parent == by["t.main"].id
    assert by["t.main.child"].attrs == {"query": "q1"}
    assert by["t.thread"].thread != by["t.main"].thread
    assert by["t.main"].thread == by["t.outer"].thread
    for s in out["spans"]:
        assert s.t0_ns <= s.t1_ns
    assert by["t.outer"].t0_ns <= by["t.inner"].t0_ns
    assert by["t.inner"].t1_ns <= by["t.outer"].t1_ns
    assert len({s.id for s in out["spans"]}) == len(out["spans"])
    assert tracer.drain()["spans"] == []


def test_tracer_cap_counts_what_it_drops(tracer, monkeypatch):
    monkeypatch.setattr(tracer, "SPAN_CAP", 3)
    for i in range(5):
        with tracer.span("t.cap", i=i):
            pass
    tracer.count("t.c")
    tracer.count("t.c", 2)
    out = tracer.drain()
    assert [s.attrs["i"] for s in out["spans"]] == [0, 1, 2]
    assert out["spans_dropped"] == 2 and out["counters"] == {"t.c": 3}
    assert tracer.drain() == {"spans": [], "counters": {},
                              "spans_dropped": 0}


# --------------------------------------------------------------------------
# the trainer and the Localizer
# --------------------------------------------------------------------------

SMALL = dict(width=32, height=24, fx=25.0, fy=25.0, cx=16.0, cy=12.0,
             window_size=2, tile_chunk=2, max_per_tile=128, kp_budget=32,
             nonkp_budget=256, pcd_downsample=2, use_pallas=True,
             gaussian_update_every=2, gaussian_update_offset=1,
             gaussian_reset=2)


def _frames(cfg, n=2):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        rgb = rng.uniform(0.2, 1.0, (cfg.height, cfg.width, 3)).astype(
            np.float32)
        depth = (2.5 + 0.5 * rng.uniform(size=(cfg.height, cfg.width))
                 ).astype(np.float32)
        score = np.zeros((cfg.height, cfg.width), np.float32)
        score[::5, ::5] = 0.5
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.05 * i
        out.append((rgb, depth, score, w2c))
    return out


def test_mapping_records_the_step_tree(tracer):
    """map(2) with a densify at iteration 1 and an opacity reset at 2: each
    step's children under ``map.step``, the densify's under
    ``map.densify``, every span with its iteration, and the drop counters
    of the one checked step."""
    cfg = tmapping.MappingConfig(**SMALL)
    t = tmapping.MappingTrainer(cfg, capacity=2048, frame_capacity=4,
                                seed=2, device="cpu")
    for f in _frames(cfg):
        t.add_keyframe(*f)
    tracer.drain()
    t.map(2)
    out = tracer.drain()
    sp = out["spans"]
    by_id = {s.id: s for s in sp}
    steps = [s for s in sp if s.name == "map.step"]
    assert [s.attrs for s in steps] == [{"iteration": 1}, {"iteration": 2}]
    for st in steps:
        kids = sorted(s.name for s in sp if s.parent == st.id)
        assert kids == ["map.step.backward", "map.step.gather",
                        "map.step.render", "map.step.stats",
                        "map.step.update"]
    (dens,) = [s for s in sp if s.name == "map.densify"]
    assert dens.parent is None and dens.attrs == {"iteration": 1}
    assert sorted(s.name for s in sp if s.parent == dens.id) == [
        "map.densify.check", "map.densify.ladder", "map.densify.prune"]
    (reset,) = [s for s in sp if s.name == "map.reset_opacity"]
    assert reset.attrs == {"iteration": 2}
    (read,) = [s for s in sp if s.name == "map.read_loss"]
    assert read.attrs == {"iteration": 2} and read.parent is None
    for s in sp:
        assert "iteration" in s.attrs, s
        if s.parent is not None:
            assert by_id[s.parent].attrs["iteration"] == s.attrs["iteration"]
    assert out["counters"] == {"map.pairs_dropped": t.n_dropped_total,
                               "map.steps_checked": 1}


def test_localize_records_stages_pnp_and_auction_rounds(tracer,
                                                        monkeypatch):
    """One query of the benchmark's localize cell at a CPU size: the stages
    under ``localize.query``, the matching and PnP spans under their
    stages, every span with the query's name, ``last_stages`` as before,
    and the auction's counter equal to the rounds it ran."""
    from portbench.generators import localize as gen
    from portbench.tests.small import small_cell
    rounds = []
    real = hungarian._auction_round

    def counted(*a):
        rounds.append(1)
        return real(*a)

    pre = gen.prepare(small_cell("localize.replica_room0", 0.25), 5,
                      torch.device("cpu"))
    loc = pre["loc"]
    try:
        monkeypatch.setattr(hungarian, "_auction_round", counted)
        tracer.drain()
        _, match = loc.localize({}, "q3")
        out = tracer.drain()
    finally:
        loc.untap()
    assert match["success"]
    sp = out["spans"]
    by = {s.name: s for s in sp}
    q = by["localize.query"]
    assert q.parent is None and q.attrs == {"query": "q3"}
    stages = ["retrieval", "frustum", "decode", "match", "pnp"]
    assert sorted(s.name for s in sp if s.parent == q.id) == sorted(
        f"localize.{k}" for k in stages)
    assert set(loc.last_stages) == set(stages) | {"total"}
    for k in ("match.similarity", "match.auction"):
        assert by[k].parent == by["localize.match"].id
    pnp = ["pnp.hypotheses", "pnp.refine_hypotheses", "pnp.score",
           "pnp.refine_final", "pnp.readback"]
    assert [s.name for s in sp if s.name.startswith("pnp.")] == pnp
    for k in pnp:
        assert by[k].parent == by["localize.pnp"].id
    assert all(s.attrs == {"query": "q3"} for s in sp)
    n = len(rounds)
    assert n > 0 and out["counters"] == {"match.auction_rounds": n}


# --------------------------------------------------------------------------
# the benchmark's reading
# --------------------------------------------------------------------------

def _ev(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def test_idle_by_span_charges_gaps_to_the_innermost_main_thread_span():
    """Window [0, 1000] us on thread 1; span A [100, 600] holds B [200,
    500], in which the main thread waits while thread 2 (autograd's) works
    in an annotation of its own; device ops at [0, 50], [300, 350] and
    [700, 800]. Gaps are split at span edges and sum to the idle time."""
    events = [
        _ev(pprofile.WINDOW, 0, 1000),
        _ev("A", 100, 500), _ev("B", 200, 300),
        _ev("autograd.thread", 250, 200, tid=2),
        _ev("aten::mul", 260, 10, tid=2, cat="cpu_op"),
        _ev("k0", 0, 50, tid=7, cat="kernel"),
        _ev("k1", 300, 50, tid=7, cat="kernel"),
        _ev("m0", 700, 100, tid=7, cat="gpu_memcpy"),
    ]
    got = pspans.idle_by_span(events)
    want = {pspans.OUTSIDE: 350e-6, "A": 200e-6, "B": 250e-6}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12)
    assert list(got) == [pspans.OUTSIDE, "B", "A"]
    s = pprofile.summarize(events)
    assert sum(got.values()) == pytest.approx(s["window_s"] - s["busy_s"],
                                              abs=1e-12)
    assert pspans.idle_by_span(events[1:]) == {}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idle_by_span_sums_to_the_idle_time_summarize_reads(seed):
    """Device ops that overlap, nest and cross the window's edges, spans
    that cross them too: the charges sum to ``profile.summarize``'s
    ``window_s - busy_s``, so the two gap lists agree."""
    rng = np.random.default_rng(seed)
    events = [_ev(pprofile.WINDOW, 1000, 8000)]
    for _ in range(40):
        ts = float(rng.uniform(0, 10000))
        events.append(_ev("k", ts, float(rng.exponential(150)), tid=7,
                          cat=str(rng.choice(pprofile.DEVICE_CATS))))
    for i in range(12):
        ts = float(rng.uniform(0, 9000))
        events.append(_ev(f"s{i % 4}", ts, float(rng.uniform(10, 900))))
    s = pprofile.summarize(events)
    got = pspans.idle_by_span(events)
    assert s["window_s"] - s["busy_s"] > 0
    assert sum(got.values()) == pytest.approx(s["window_s"] - s["busy_s"],
                                              rel=1e-9)


def test_innermost_tiles_the_window_at_span_edges():
    pieces = pspans.innermost([(10, 40, "a"), (20, 30, "b"), (40, 60, "c"),
                               (-5, 5, "early")], 0, 50)
    assert pieces == [(0, 5, "early"), (5, 10, pspans.OUTSIDE),
                      (10, 20, "a"), (20, 30, "b"), (30, 40, "a"),
                      (40, 50, "c")]


READINGS = ["render_host_ms", "backward_host_ms", "update_host_ms",
            "pairs_dropped_per_step", "auction_rounds", "pnp_refine_ms",
            "pnp_wait_ms"]


def _sp(name, i, parent, ms):
    return tprof.Span(name, i, parent, {}, 0, int(ms * 1e6), 1)


MAP_GOT = {
    "spans": [_sp("map.step", 0, None, 100),
              _sp("map.step.render", 1, 0, 40),
              _sp("map.step.backward", 2, 0, 50),
              _sp("map.step.update", 3, 0, 6),
              _sp("map.step", 4, None, 120),
              _sp("map.step.render", 5, 4, 44),
              _sp("map.step.backward", 6, 4, 54),
              _sp("map.step.update", 7, 4, 8),
              _sp("map.densify", 8, None, 30)],
    "counters": {"map.pairs_dropped": 6, "map.steps_checked": 3}}
LOC_GOT = {
    "spans": [_sp("localize.query", 0, None, 240),
              _sp("pnp.refine_hypotheses", 1, 0, 60),
              _sp("pnp.refine_final", 2, 0, 110),
              _sp("pnp.readback", 3, 0, 4),
              _sp("localize.query", 4, None, 250),
              _sp("pnp.refine_hypotheses", 5, 4, 62),
              _sp("pnp.refine_final", 6, 4, 112),
              _sp("pnp.readback", 7, 4, 6)],
    "counters": {"match.auction_rounds": 40}}
WANT = {"render_host_ms": 42.0, "backward_host_ms": 52.0,
        "update_host_ms": 7.0, "pairs_dropped_per_step": 2.0,
        "auction_rounds": 20.0, "pnp_refine_ms": 172.0, "pnp_wait_ms": 5.0}


@pytest.mark.parametrize("name", READINGS)
def test_reading_is_none_without_what_it_reads(name):
    """A run that recorded nothing, or only the other kind of request,
    reads no value; the request's own spans and counters read it."""
    own = MAP_GOT if READINGS.index(name) < 4 else LOC_GOT
    other = LOC_GOT if own is MAP_GOT else MAP_GOT
    for got in ({}, {"spans": [], "counters": {}}, other):
        assert pspans.readings(got)[name] is None
    assert pspans.readings(own)[name] == pytest.approx(WANT[name])


def test_host_ms_and_children_ms_break_a_request_down():
    assert pspans.host_ms(MAP_GOT["spans"], "map.step") == pytest.approx({
        "map.step": 110.0, "map.step.render": 42.0,
        "map.step.backward": 52.0, "map.step.update": 7.0,
        "map.densify": 15.0})
    assert pspans.children_ms(MAP_GOT["spans"], "map.step") == (
        pytest.approx(101.0))
    assert pspans.children_ms(LOC_GOT["spans"], "map.step") is None
