"""What the port's own spans and counters read.

The port's tracer (``splatloc_tpu_torch.utils.profiling``: ``span``,
``count``, ``enable``, ``disable``, ``drain``) records spans on the host's
clock and, inside a torch.profiler window, as ``user_annotation`` events on
the profiler's clock. Here:

- ``idle_by_span`` charges the device's idle time in a profiled window to
  the innermost program span open on the window's (the main) thread at
  each instant: the backward pass, which autograd runs on another thread,
  is charged to the span the main thread waits in;
- ``readings`` are the per-layer numbers of what ``drain()`` handed over:
  the mean host wall of a layer's spans per step or query, and counters
  per step or query;
- ``host_ms`` and ``children_ms`` break a request's wall down by span.

``tracer_run.py`` takes them on the card.
"""
from __future__ import annotations

import collections

from portbench.profile import DEVICE_CATS, WINDOW

OUTSIDE = "outside spans"
STEP = "map.step"
QUERY = "localize.query"


def device_gaps(events: list, w0: float, w1: float) -> list:
    """The gaps [(start, end)] between the union of device operations
    inside the window [w0, w1], edges included, as ``profile.summarize``
    computes them (a test holds their sum to its ``window_s - busy_s``)."""
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    gaps, cur = [], w0
    for s, t in dev:
        if t < w0 or s > w1:
            continue
        s, t = max(s, w0), min(t, w1)
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def innermost(spans: list, w0: float, w1: float) -> list:
    """[(start, end, name)] tiling [w0, w1]: the innermost of the nested
    ``spans`` [(start, end, name)] open in each piece, ``OUTSIDE`` where
    none is. Pieces are cut at span edges."""
    out, stack, cur = [], [], w0

    def emit(until):
        nonlocal cur
        until = min(until, w1)
        if until > cur:
            out.append((cur, until, stack[-1][1] if stack else OUTSIDE))
            cur = until

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if e <= w0 or s >= w1:
            continue
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(w1)
    return out


def idle_by_span(events: list) -> dict:
    """Seconds of device idle time in the ``portbench.window`` annotation,
    by the innermost program span (every other ``user_annotation`` of the
    window's thread) open at each instant, most first; ``OUTSIDE`` for idle
    time under no span. The values sum to the window's idle time."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    tid = win[0]["tid"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("tid") == tid and e.get("name") != WINDOW]
    pieces = innermost(spans, w0, w1)
    idle = collections.Counter()
    i = 0
    for a, b in device_gaps(events, w0, w1):
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            s, e, name = pieces[j]
            idle[name] += (min(b, e) - max(a, s)) * 1e-6
            j += 1
    return dict(idle.most_common())


def _n(spans: list, request: str) -> int:
    return sum(s.name == request for s in spans)


def _ms(spans: list, names: tuple, request: str):
    """Mean host wall, ms, of the spans ``names`` per ``request`` span;
    None where there is no request or none of the spans."""
    n = _n(spans, request)
    got = [s.t1_ns - s.t0_ns for s in spans if s.name in names]
    if not n or not got:
        return None
    return 1e-6 * sum(got) / n


def _ratio(num, den):
    return None if num is None or not den else num / den


def readings(got: dict) -> dict:
    """The per-layer numbers of what ``drain()`` handed over (``got``);
    each None where the spans or counters it reads were not recorded:

    - ``render_host_ms``, ``backward_host_ms``, ``update_host_ms``: mean
      host ms a step of ``map.step.render``, ``.backward``, ``.update``;
    - ``pairs_dropped_per_step``: ``map.pairs_dropped`` over
      ``map.steps_checked`` (steps checked at the densify cadence);
    - ``auction_rounds``: ``match.auction_rounds`` a query (the rounds
      issued, in whole blocks of 20);
    - ``pnp_refine_ms``: ``pnp.refine_hypotheses`` + ``pnp.refine_final``
      a query; ``pnp_wait_ms``: ``pnp.readback`` a query.
    """
    spans, c = got.get("spans") or [], got.get("counters") or {}
    return {
        "render_host_ms": _ms(spans, ("map.step.render",), STEP),
        "backward_host_ms": _ms(spans, ("map.step.backward",), STEP),
        "update_host_ms": _ms(spans, ("map.step.update",), STEP),
        "pairs_dropped_per_step": _ratio(c.get("map.pairs_dropped"),
                                         c.get("map.steps_checked")),
        "auction_rounds": _ratio(c.get("match.auction_rounds"),
                                 _n(spans, QUERY)),
        "pnp_refine_ms": _ms(spans, ("pnp.refine_hypotheses",
                                     "pnp.refine_final"), QUERY),
        "pnp_wait_ms": _ms(spans, ("pnp.readback",), QUERY),
    }


def host_ms(spans: list, request: str) -> dict:
    """Mean host ms per ``request`` span of every span name recorded."""
    n = _n(spans, request)
    tot = collections.Counter()
    for s in spans:
        tot[s.name] += (s.t1_ns - s.t0_ns) * 1e-6 / max(n, 1)
    return dict(sorted(tot.items()))


def children_ms(spans: list, request: str):
    """Mean host ms per ``request`` span that its direct children cover;
    None without a request span."""
    ids = {s.id for s in spans if s.name == request}
    if not ids:
        return None
    return 1e-6 * sum(s.t1_ns - s.t0_ns for s in spans
                      if s.parent in ids) / len(ids)
