"""The arithmetic of the thread metrics (``idle.py``) on synthetic
records."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from h100bench import idle

LAUNCHER, SOURCE = "queue1-worker", "pipe:src"


def _span(thread, kind, a, b, seq=None, **args):
    return (thread, kind, seq, float(a), float(b), None, args or None)


def _ctx(busy, spans, wall=(0.0, 100.0)):
    """A run's records: the device's ``busy`` intervals cut to the slice
    ``wall``, as the profiled slice's are."""
    t0, t1 = wall
    busy = idle.intersect(idle.merge(busy), [(t0, t1)])
    return SimpleNamespace(
        slice=SimpleNamespace(wall_us=t1 - t0,
                              idle=idle.idle_intervals(busy, t0, t1),
                              busy_us=idle.length(busy)),
        ledger_spans=spans)


def _device_idle_share(ctx):
    return 100.0 * (1.0 - ctx.slice.busy_us / ctx.slice.wall_us)


def test_each_idle_instant_has_one_cause_in_order():
    # busy 10-20 and 60-70: idle 0-10, 20-60, 70-100 (80 µs of 100)
    busy = [(10, 20), (60, 70), (12, 18)]
    spans = [
        _span(LAUNCHER, "device", 9, 10, seq=0),
        _span(LAUNCHER, "device", 59, 60, seq=8),
        _span(SOURCE, "device", 1, 2, seq=1),  # fewer: not the launcher
        _span("gc-thread", "gc", 25, 35, generation=2),
        # back-pressure 30-45: 30-35 already the collection's
        _span(LAUNCHER, "wait_output", 30, 40, element="q_drain"),
        _span(LAUNCHER, "fence_wait", 40, 45),
        # starved 45-55, and a wait of another thread, which is no cause
        _span(LAUNCHER, "wait_input", 45, 55, element="q_stage"),
        _span(SOURCE, "wait_input", 70, 100, element="src"),
        _span(LAUNCHER, "chain", 0, 100, element="q_stage"),
    ]
    ctx = _ctx(busy, spans)
    shares = idle.idle_shares(ctx)
    assert shares == pytest.approx({
        "idle_gc_share": 10.0, "idle_backpressure_share": 10.0,
        "idle_starved_share": 10.0, "idle_dispatch_share": 50.0})
    assert sum(shares.values()) == pytest.approx(_device_idle_share(ctx))


@pytest.mark.parametrize("seed", range(5))
def test_the_shares_tile_the_idle_share(seed):
    import random

    rng = random.Random(seed)
    threads = [LAUNCHER, SOURCE, "queue0-worker"]
    kinds = ["gc", "wait_input", "wait_output", "fence_wait", "chain"]
    busy = [(a, a + rng.uniform(0, 30)) for a in
            (rng.uniform(-10, 1000) for _ in range(40))]
    spans = [_span(LAUNCHER, "device", a, a + 1, seq=i)
             for i, a in enumerate(range(0, 1000, 50))]
    for _ in range(300):
        a = rng.uniform(-20, 1000)
        spans.append(_span(rng.choice(threads), rng.choice(kinds), a,
                           a + rng.uniform(0, 40)))
    ctx = _ctx(busy, spans, wall=(0.0, 1000.0))
    shares = idle.idle_shares(ctx)
    assert set(shares) == set(idle.CAUSES)
    assert all(v >= 0 for v in shares.values())
    assert sum(shares.values()) == pytest.approx(_device_idle_share(ctx),
                                                 abs=1e-9)


def test_nothing_to_read_reads_none():
    assert idle.idle_shares(SimpleNamespace(slice=None,
                                            ledger_spans=None)) is None
    no_launcher = _ctx([(0, 10)], [_span(SOURCE, "chain", 0, 5)])
    assert idle.idle_shares(no_launcher) is None
    # a slice with no device time in it, as device_idle_share reads none
    idle_card = _ctx([], [_span(LAUNCHER, "device", 0, 1, seq=0)])
    assert idle.idle_shares(idle_card) is None
    assert idle.hot_thread_cpu_ms_per_frame(
        SimpleNamespace(thread_cpu_s={}, window_frames=10)) is None
    assert idle.exclusive_chain_ms([_span(SOURCE, "chain", 0, 5,
                                          element="queue0")]) is None


def test_span_algebra():
    x = [(0, 10), (20, 30)]
    y = idle.merge([(5, 25), (28, 40), (26, 27)])
    assert y == [(5, 25), (26, 27), (28, 40)]
    assert idle.intersect(x, y) == [(5, 10), (20, 25), (26, 27), (28, 30)]
    assert idle.subtract(x, y) == [(0, 5), (25, 26), (27, 28)]
    assert idle.idle_intervals([(2, 3), (2.5, 4)], 0, 5) == [(0, 2), (4, 5)]


def test_convert_ms_is_the_converters_own_time():
    spans = [
        # two calls of 10 µs; in the first the ingress queue's chain (4 µs,
        # a blocked put of 3 inside it) runs nested, on the same thread
        _span(SOURCE, "chain", 0, 10, element="tensor_converter0"),
        _span(SOURCE, "chain", 5, 9, element="queue0"),
        _span(SOURCE, "wait_output", 5.5, 8.5, element="queue0"),
        _span(SOURCE, "chain", 20, 30, element="tensor_converter0"),
        # another thread's span inside it is not the converter's
        _span(LAUNCHER, "chain", 21, 29, element="queue1"),
        # neither is another element that merely starts with the name
        _span(SOURCE, "chain", 40, 90, element="tensor_converter_x"),
    ]
    assert idle.exclusive_chain_ms(spans) == pytest.approx((6 + 10) / 2e3)


def test_thread_cover():
    spans = [_span(SOURCE, "chain", 0, 40, element="tensor_converter0"),
             _span(SOURCE, "wait_output", 10, 30, element="queue0"),
             _span(SOURCE, "gc", 50, 60, generation=0),
             _span(SOURCE, "queue_wait", 60, 100, seq=3),
             _span(LAUNCHER, "wait_input", -50, 150, element="queue0")]
    assert idle.thread_cover(spans, 0, 100) == {SOURCE: 0.5, LAUNCHER: 1.0}


def test_the_hot_thread_per_frame():
    ctx = SimpleNamespace(thread_cpu_s={"a": 1.5, "b": 3.0},
                          window_frames=1000)
    assert idle.hot_thread_cpu_ms_per_frame(ctx) == pytest.approx(3.0)
