"""The roofline and mfu arithmetic on hand-worked shapes, and the trace
reader's busy time, kernel sums and idle gaps on a made-up trace."""
import types

import pytest
from torch.autograd import DeviceType

from vbench import harness, roofline, trace

CFG = {"M": 96, "K": 256, "dim": 768, "beam_width": 4}
# one search call: 128 queries on one partition, 30 rounds each of 110 new
# candidates, k' = 50 reranked, one schema
W1 = dict(lanes=128, queries=128, calls=1, hops=128 * 30, cmps=128 * 3300, full_reads=128 * 50,
          L=100, k=10, kprime=50, schemas=1)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound(3.35e9, 0.0) == (1.0, "bytes")
    assert roofline.bound(0.0, 67e9) == (1.0, "operations")
    assert roofline.bound(3.35e9, 134e9)[1] == "operations"


def test_adc_work_by_hand():
    nbytes, ops = roofline.adc_work(W1, CFG)
    # 422 400 comparisons x 96 code bytes, plus 128 tables of 96 x 256 floats
    assert nbytes == 422_400 * 96 + 128 * 96 * 256 * 4 == 53_133_312
    assert ops == 422_400 * 96
    assert roofline.bound(nbytes, ops)[0] == pytest.approx(53_133_312 / 3.35e9)


def test_topk_work_by_hand():
    nbytes, _ = roofline.topk_work(W1, CFG)
    merges = (3840 * 100 + 422_400) * 4 + 3840 * 100 * 8
    picks = 3840 * 100 * 4 + 3840 * 4 * 8
    cuts = 128 * (50 * 4 + 10 * 8)
    assert nbytes == merges + picks + cuts
    # four partitions a query add the merge of their 4 x k to k
    w4 = dict(W1, lanes=512)
    extra = roofline.topk_work(w4, CFG)[0] - roofline.topk_work(dict(W1, lanes=512, queries=512),
                                                               CFG)[0]
    assert extra == 128 * (4 * 10 * 4 + 10 * 8)


def test_search_ms_sums_every_part():
    parts = [roofline.adc_work(W1, CFG), roofline.topk_work(W1, CFG),
             roofline.rerank_work(W1, CFG), roofline.lut_work(W1, CFG)]
    total_bytes = sum(b for b, _ in parts)
    total_ops = sum(o for _, o in parts)
    assert roofline.search_ms(W1, CFG) == pytest.approx(
        max(total_bytes / 3.35e9, total_ops / 67e9))
    assert roofline.rerank_work(W1, CFG) == (128 * 50 * 768 * 4 + 128 * 768 * 4,
                                             128 * 50 * 768 * 3)


def _ev(name, start, end, dev=False):
    return types.SimpleNamespace(name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_trace_reader():
    events = [
        _ev(trace.WINDOW_MARK, 0, 1000),
        _ev("vbench.search", 0, 1000),
        _ev("aten::item", 100, 400),  # the host waits here: the device idles 200..400
        _ev("adc_staged_kernel", 50, 200, dev=True),
        _ev("topk_bitonic_kernel", 150, 250 - 50, dev=True),
        _ev("Memcpy HtoD", 400, 500, dev=True),
        _ev("adc_staged_kernel", 480, 600, dev=True),
        _ev("late_kernel", 990, 1100, dev=True),  # clipped to the window
        _ev(trace.WINDOW_MARK, 0, 1000, dev=True),  # the mark's device side
    ]
    prof = types.SimpleNamespace(events=lambda: events)
    tr = trace.read(prof)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((150 + 200 + 10) / 1e6)
    assert tr.kernels == 4
    assert tr.kernel_s("adc_") == pytest.approx(270e-6)
    assert tr.idle_by_host["aten::item"] == pytest.approx(200e-6)
    assert tr.idle_by_host["vbench.search"] == pytest.approx((50 + 390) / 1e6)
    assert trace.short("void at::native::k<4, float>(int, float*)") == "at::native::k"
    assert trace.short("(anonymous namespace)::adc_staged_kernel(float const*)") == \
        "adc_staged_kernel"
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "adc_staged_kernel" and len(bd["idle_gaps"]) == 2


def test_readers_on_a_traced_stretch():
    tr = trace.Trace(window_s=0.1, busy_s=0.01, kernels=640, by_kernel={
        "adc_staged_kernel": 0.002, "topk_bitonic_kernel": 0.001}, idle_by_host={})
    req = types.SimpleNamespace(op="search", ids=[[0]] * 128, status=200, work=W1)
    cell = types.SimpleNamespace(cfg=CFG)
    run = harness.Run(cell, 1.0, [req], 0.1, {}, [], tr, [req], [])
    read = lambda m: harness.load_module(harness.HERE / "metrics" / f"{m}.py").read(run)
    assert read("device.busy_pct") == pytest.approx(10.0)
    assert read("search.launches_per_query") == pytest.approx(5.0)
    assert read("pq_adc_roofline") == pytest.approx(
        100 * roofline.bound(*roofline.adc_work(W1, CFG))[0] / 2.0)
    assert read("mfu_pct") == pytest.approx(100 * roofline.search_ms(W1, CFG) / 100.0)
    assert read("index.cmps_per_query") == pytest.approx(3300)
    # nothing on a device: no share is reported, never a 0
    idle = harness.Run(cell, 1.0, [req], 0.1, {}, [], trace.Trace(0.1, 0.0, 0, {}, {}),
                       [req], [])
    assert harness.load_module(harness.HERE / "metrics" / "device.busy_pct.py").read(idle) is None
    assert harness.load_module(harness.HERE / "metrics" / "pq_adc_roofline.py").read(idle) is None
