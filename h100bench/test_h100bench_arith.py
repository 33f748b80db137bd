"""The benchmark's arithmetic on known inputs: FLOPs a frame, kernel B1's
bound, the union of device intervals, the profiled slice's reduction,
the metric readers, and the Poisson arrivals."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from h100bench import cells, peaks, trace, traffic
from h100bench.counts import normalize_chain_kernel as b1


def _config(name):
    return cells.load_config({"name": name,
                              "file": f"h100bench/configs/{name}.json"})


def test_mobilenet_v2_flops_are_the_papers_300_million_multiply_adds():
    c = _config("mobilenet_v2_224")
    # Sandler et al., table 4: 300M multiply-adds at 1.0 / 224
    assert c.program.flops(c.data) == pytest.approx(2 * 300e6, rel=0.01)


def test_ssd_flops_count_backbone_and_heads():
    c = _config("ssd_mobilenet_v2_300")
    head = 0.0
    for cells_, ch in ((19, 96), (10, 320)):
        head += 2.0 * cells_ * cells_ * ch * 9 * 6 * (4 + 91)
    # the heads are most of it; the backbone at 300x300 less than
    # MobileNetV2's 0.6 GFLOP at 224 scaled by the area
    total = c.program.flops(c.data)
    assert head < total < head + 0.6e9 * (300 / 224) ** 2


def test_b1_bound_counts_a_byte_in_and_four_out_an_element():
    n = 224 * 224 * 3
    assert b1.bytes_moved(n) == 5 * n
    assert b1.bound_seconds(n) == pytest.approx(5 * n / 3.35e12)
    # the bytes bound it at every size
    assert b1.bound_seconds(n) > b1.operations(n) / peaks.FLOPS["float32"]


def test_union_of_device_intervals():
    busy, merged = trace.union([(5, 6), (0, 2), (1, 3), (3, 4), (10, 10)])
    assert busy == 5
    assert merged == [(0, 4), (5, 6), (10, 10)]


def test_reduce_a_slice():
    events = [
        ("cudaGraphLaunch", 0, 5, False),
        ("gemm", 10, 30, True),
        ("normalize_chain_kernel<uint8>", 30, 32, True),
        ("cudaMemcpyAsync", 33, 34, False),
        ("cudaStreamSynchronize", 35, 60, False),
        ("cudaGraphLaunch", 61, 62, False),
        ("gemm", 70, 90, True),
    ]
    sl = trace.reduce(events, wall_us=100.0)
    assert sl.busy_us == 42
    assert sl.op_time("normalize_chain_kernel") == (2, 1)
    assert sl.op_time("absent") is None
    assert sl.idle_by_host == {"host: cudaStreamSynchronize": 38}
    bd = sl.breakdown()
    assert bd["device_ops"][0] == ["gemm", 40e-6]
    assert [n for _, n in sl.host_calls] == [
        "cudaGraphLaunch", "cudaMemcpyAsync", "cudaGraphLaunch"]


def _ctx(**kw):
    c = _config("mobilenet_v2_224")
    base = dict(cfg=c.data, program=c.program, traffic={"batch": 8},
                ledger=None, fence=(0.0, 0), slice=None, window_frames=0,
                window_s=10.0, count=cells.load_count, setup_s=None,
                t0=100.0, t1=110.0, arrivals=[], window=[],
                open_loop=False)
    base.update(kw)
    return SimpleNamespace(**base)


def test_metric_readers_on_a_known_slice():
    sl = trace.Slice(wall_us=1000.0, busy_us=250.0, frames=50,
                     device_ops={"normalize_chain_kernel": (3.6, 2)},
                     host_calls=[(0, "cudaMemcpyAsync"),
                                 (1, "cudaGraphLaunch"),
                                 (2, "cudaMemcpyAsync"),
                                 (3, "cudaGraphLaunch"),
                                 (4, "cudaMemcpyAsync")])
    ctx = _ctx(slice=sl, window_frames=20000,
               ledger={"frames": 9, "stages_ms": {"queue_wait": 4.5,
                                                  "d2h": 0.25}},
               fence=(0.5, 1000))

    def read(name):
        return cells.load_metric(name).read(ctx)

    assert read("device_idle_share") == pytest.approx(75.0)
    assert read("device_idle_share.rate") == pytest.approx(75.0)
    assert read("device_busy_ms_per_frame") == pytest.approx(0.005)
    assert read("host_launches_per_replay") == pytest.approx(2.0)
    assert read("queue_wait_ms") == 4.5
    assert read("queue_wait_ms.rate") == 4.5
    assert read("d2h_ms") == 0.25
    assert read("fence_wait_ms") == pytest.approx(0.5)
    flops = ctx.program.flops(ctx.cfg)
    assert read("model_mfu") == pytest.approx(
        100 * flops * 2000 / 989e12)
    bound = b1.bound_seconds(8 * 224 * 224 * 3)
    assert read("b1_roofline") == pytest.approx(100 * bound / 1.8e-6)


def test_a_reader_with_nothing_to_read_returns_nothing():
    ctx = _ctx()
    for m in cells.load_benchmark()["per_layer"]:
        assert cells.load_metric(m["name"]).read(ctx) is None, m["name"]


def test_poisson_arrivals_are_the_same_gaps_in_another_order():
    mix = {"arrivals": "poisson", "rate_fps": 320.0, "preroll_s": 1.0}
    a = traffic.offsets(mix, 7, 10.0)
    b = traffic.offsets(mix, 2 ** 31 + 11, 10.0)
    assert len(a) == len(b) == 3520
    ga, gb = np.diff(np.append(a, 11.0)), np.diff(np.append(b, 11.0))
    assert not np.array_equal(ga, gb)
    assert np.allclose(np.sort(ga), np.sort(gb))
    assert a[0] == 0.0 and a[-1] < 11.0
    # exponential: the mean gap is the rate's, the spread as wide
    assert np.mean(ga) == pytest.approx(1 / 320, rel=1e-6)
    assert np.std(ga) == pytest.approx(1 / 320, rel=0.05)
    assert traffic.offsets({"arrivals": "closed"}, 7, 10.0) is None


def test_launch_string_has_the_mixes_elements():
    c = _config("mobilenet_v2_224")
    b8 = traffic.describe(cells.load_traffic("saturated_b8"), c.program,
                          c.data, "m")
    assert "tensor_aggregator frames-in=1 frames-out=8" in b8
    assert "prefetch-device=true" in b8 and "block=true" in b8
    assert "option2=batched" in b8 and "model=m " in b8
    assert "caps=video/x-raw,format=RGB,width=224,height=224," in b8
    b1_ = traffic.describe(cells.load_traffic("poisson_rate80_b1"),
                           c.program, c.data, "m")
    assert "aggregator" not in b1_ and "prefetch-device" not in b1_
    assert "block=false" in b1_ and "option2" not in b1_
    # the batch-1 flagship differs from the batch-8 string only in the
    # batching layers: the aggregator, the staging queue, the decoder's
    # batched option
    flag = traffic.describe(cells.load_traffic("saturated_b1_flagship"),
                            c.program, c.data, "m")
    strip = {"tensor_aggregator", "queue max-size-buffers=8 prefetch"}
    assert [e for e in b8.replace(" option2=batched", "").split(" ! ")
            if not any(e.startswith(x) for x in strip)] == \
        flag.split(" ! ")


def test_end_to_end_readers_on_a_known_window():
    ctx = _ctx(setup_s=25.5, arrivals=[99.0, 100.0, 105.0, 109.9, 110.0],
               window=[(100.0, 100.004), (101.0, 101.002), (102.0, None),
                       (103.0, 103.010)], open_loop=True)

    def read(name):
        return cells.load_metric(name).read(ctx)

    assert read("setup_s") == 25.5
    assert read("frames_per_s") == pytest.approx(3 / 10.0)
    assert read("latency_p50_ms") == pytest.approx(4.0)
    assert read("latency_p95_ms") == pytest.approx(
        float(np.percentile([2.0, 4.0, 10.0], 95)), rel=1e-6)
    closed = _ctx(window=ctx.window, open_loop=False)
    assert cells.load_metric("latency_p95_ms").read(closed) is None


def test_sources_get_their_own_arrival_orders():
    mix = {"arrivals": "poisson", "rate_fps": 50.0, "preroll_s": 1.0}
    a, b = traffic.offsets(mix, 7, 4.0, 0), traffic.offsets(mix, 7, 4.0, 1)
    assert not np.array_equal(a, b)
    assert np.allclose(np.sort(np.diff(np.append(a, 5.0))),
                       np.sort(np.diff(np.append(b, 5.0))))
