"""The program's spans in a traced slice (``harness/spans.py``) against hand
counts on hand-built slices, all exact: the device's idle time inside a
span and inside one span but outside others, launch calls and their host
time inside a span, None for a span the
program did not open; the readers of the span metrics; each span metric's
entry, reader and cell; and a traced run at a tiny size on the CPU, whose
per-layer line carries every span metric of its cell."""

from __future__ import annotations

import math
import os

import pytest

from conftest import BENCH, ROOT, load, tiny_spec

BENCHMARK = load("BENCHMARK.json")
# the span metrics, each with the one cell that reports it
SPAN_METRICS = {
    "stall_pct.serve": "flagship-serve-b4",
    "stall_pct.serve.nlspn": "nlspn-serve-b4",
    "launch_api_pct.serve": "flagship-serve-b4",
    "launch_api_pct.serve.nlspn": "nlspn-serve-b4",
    "stall_ms.G_label": "flagship-serve-b4",
    "stall_ms.G_normal": "flagship-serve-b4",
    "stall_ms.G_A2B": "flagship-serve-b4",
    "launches.G_label": "flagship-serve-b4",
    "launches.G_normal": "flagship-serve-b4",
    "launches.G_A2B": "flagship-serve-b4",
    "stall_ms.nlspn_block": "nlspn-serve-b4",
    "launches.nlspn_block": "nlspn-serve-b4",
    "stall_ms.G": "nlspn-serve-b4",
    "launches.G": "nlspn-serve-b4",
    "stall_ms.outside_nets": "flagship-serve-b4",
    "stall_ms.outside_nets.nlspn": "nlspn-serve-b4",
}


def _slice(device, host, units=1, end=100.0):
    from harness.tracing import Slice

    sl = Slice(units=units, start_us=0.0, end_us=end)
    sl.device = [("k", s, e) for s, e in device]
    sl.host = list(host)
    return sl


def test_stall_where_a_gap_half_overlaps_a_span():
    from harness import spans

    # idle 40-60; the span 50-80 holds its second half
    sl = _slice([(0.0, 40.0), (60.0, 100.0)], [("rdfc.serve", 50.0, 80.0)])
    assert spans.idle_intervals(sl) == [(40.0, 60.0)]
    assert spans.stall_us(sl, "rdfc.serve") == 10.0
    assert spans.host_us(sl, "rdfc.serve") == 30.0


def test_stall_in_nested_spans_and_repeated_ones():
    from harness import spans

    # idle 25-45 and 55-65; serve 10-90 > G 20-70 > block 30-50; a second
    # request's serve 92-98 over the idle tail 95-100
    sl = _slice([(0.0, 25.0), (45.0, 55.0), (65.0, 95.0)],
                [("rdfc.serve", 10.0, 90.0), ("rdfc.G", 20.0, 70.0),
                 ("rdfc.nlspn_block", 30.0, 50.0),
                 ("rdfc.serve", 92.0, 98.0)], units=2)
    assert spans.span_intervals(sl, "rdfc.serve") == [(10.0, 90.0),
                                                       (92.0, 98.0)]
    assert spans.stall_us(sl, "rdfc.serve") == 20.0 + 10.0 + 3.0
    assert spans.stall_us(sl, "rdfc.G") == 20.0 + 10.0
    assert spans.stall_us(sl, "rdfc.nlspn_block") == 15.0


def test_interval_difference():
    from harness import spans

    assert spans._minus([(0.0, 10.0), (20.0, 30.0)], [(5.0, 25.0)]) == [
        (0.0, 5.0), (25.0, 30.0)]
    assert spans._minus([(0.0, 10.0)], []) == [(0.0, 10.0)]
    assert spans._minus([(0.0, 10.0)], [(0.0, 10.0)]) == []
    assert spans._minus([(0.0, 30.0)], [(5.0, 10.0), (12.0, 15.0),
                                        (40.0, 50.0)]) == [
        (0.0, 5.0), (10.0, 12.0), (15.0, 30.0)]


def test_stall_inside_a_span_and_outside_the_nested_ones():
    from harness import spans

    # idle 20-50 and 60-100; serve 10-90 less its nets 25-40, 55-70, 80-85
    # is 10-25, 40-55, 70-80, 85-90, which the idle meets in 20-25, 40-50,
    # 70-80 and 85-90
    sl = _slice([(0.0, 20.0), (50.0, 60.0)],
                [("rdfc.serve", 10.0, 90.0), ("rdfc.G_label", 25.0, 40.0),
                 ("rdfc.G_normal", 55.0, 70.0), ("rdfc.G_A2B", 80.0, 85.0)])
    nets = ("rdfc.G_label", "rdfc.G_normal", "rdfc.G_A2B", "rdfc.G")
    assert spans.stall_outside_us(sl, "rdfc.serve", nets) == 30.0
    assert spans.stall_outside_us(sl, "rdfc.serve", ("rdfc.G_A2B",)) == \
        spans.stall_us(sl, "rdfc.serve") - 5.0
    # no nested span, or no outer one
    assert spans.stall_outside_us(sl, "rdfc.serve", ("rdfc.G",)) is None
    assert spans.stall_outside_us(sl, "rdfc.G", nets) is None


def test_a_span_that_overlaps_itself_counts_once():
    from harness import spans

    sl = _slice([(0.0, 10.0)], [("rdfc.G", 20.0, 60.0),
                                ("rdfc.G", 40.0, 80.0)])
    assert spans.span_intervals(sl, "rdfc.G") == [(20.0, 80.0)]
    assert spans.stall_us(sl, "rdfc.G") == 60.0


def test_no_stall_where_the_device_covers_the_span():
    from harness import spans

    sl = _slice([(0.0, 50.0), (40.0, 100.0)], [("rdfc.serve", 10.0, 90.0)])
    assert spans.stall_us(sl, "rdfc.serve") == 0.0


def test_launch_calls_counted_by_name_inside_the_span():
    from harness import spans

    host = [("rdfc.serve", 10.0, 90.0), ("rdfc.G_A2B", 50.0, 90.0),
            ("cudaLaunchKernel", 12.0, 14.0),
            ("cudaLaunchKernelExC", 20.0, 23.0),
            ("cuLaunchKernel", 30.0, 31.0),
            ("cudaLaunchCooperativeKernel", 55.0, 59.0),
            ("cuLaunchKernelEx", 60.0, 61.0),
            # a launch call that runs past the span's end
            ("cudaLaunchKernel", 88.0, 93.0),
            # no launch calls
            ("cudaMemcpyAsync", 40.0, 45.0), ("aten::conv2d", 50.0, 60.0),
            ("cudaStreamSynchronize", 70.0, 80.0),
            # outside every span
            ("cudaLaunchKernel", 2.0, 4.0), ("cudaLaunchKernel", 95.0, 96.0)]
    sl = _slice([], host)
    assert spans.launch_calls(sl, "rdfc.serve") == 6
    assert spans.launch_calls(sl, "rdfc.G_A2B") == 3
    assert spans.launch_us(sl, "rdfc.serve") == 2 + 3 + 1 + 4 + 1 + 2
    assert spans.launch_us(sl, "rdfc.G_A2B") == 4 + 1 + 2
    assert spans.LAUNCH_CALLS >= {"cudaLaunchKernel", "cudaLaunchKernelExC"}


def test_a_missing_span_reads_none():
    from harness import spans

    sl = _slice([(0.0, 10.0)], [("aten::conv2d", 0.0, 5.0),
                                ("cudaLaunchKernel", 1.0, 2.0)])
    for fn in (spans.span_intervals, spans.stall_us, spans.launch_calls,
               spans.launch_us, spans.host_us):
        assert fn(sl, "rdfc.serve") is None


def _ctx(cell, sl):
    from harness import common

    ctx = common.Ctx(spec=common.load_spec(cell, ROOT), seed=0)
    ctx.trace = sl
    return ctx


def test_readers_over_the_requests_of_a_slice():
    from harness import common

    # two requests in 200 us: idle 40-60 and 140-160
    host = [("rdfc.serve", 10.0, 90.0), ("rdfc.serve", 110.0, 190.0),
            ("rdfc.G_label", 10.0, 50.0), ("rdfc.G_label", 110.0, 150.0),
            ("rdfc.G_normal", 50.0, 90.0), ("rdfc.G_normal", 150.0, 190.0),
            ("rdfc.G", 10.0, 90.0), ("rdfc.nlspn_block", 55.0, 90.0),
            ("cudaLaunchKernel", 20.0, 24.0),
            ("cudaLaunchKernel", 120.0, 124.0),
            ("cudaLaunchKernelExC", 160.0, 168.0)]
    sl = _slice([(0.0, 40.0), (60.0, 140.0), (160.0, 200.0)], host,
                units=2, end=200.0)
    want = {"stall_pct.serve": 100.0 * 40.0 / 200.0,
            "launch_api_pct.serve": 100.0 * 16.0 / 160.0,
            "stall_ms.G_label": 20.0 * 1e-3 / 2,
            "stall_ms.G_normal": 20.0 * 1e-3 / 2,
            "launches.G_label": 1.0, "launches.G_normal": 0.5,
            "stall_ms.nlspn_block": 5.0 * 1e-3 / 2,
            "launches.nlspn_block": 0.0,
            "stall_ms.G": 20.0 * 1e-3 / 2, "launches.G": 0.5,
            # the nets cover the served call
            "stall_ms.outside_nets": 0.0}
    for name, value in want.items():
        got = common.reader(name)(_ctx(SPAN_METRICS[name], sl))
        assert got == pytest.approx(value, rel=1e-12), name
    for name in ("stall_pct.serve", "launch_api_pct.serve",
                 "stall_ms.outside_nets"):
        assert common.reader(name + ".nlspn")(_ctx("nlspn-serve-b4", sl)) \
            == common.reader(name)(_ctx("flagship-serve-b4", sl))
    # spans the program did not open, and no slice
    for name in ("stall_ms.G_A2B", "launches.G_A2B"):
        assert common.reader(name)(_ctx("flagship-serve-b4", sl)) is None
    for name, cell in SPAN_METRICS.items():
        assert common.reader(name)(_ctx(cell, None)) is None
        assert common.reader(name)(_ctx(cell, _slice([], []))) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_has_entry_reader_and_cell(name):
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    entry = [m for m in BENCHMARK["per_layer"] if m["name"] == name]
    assert len(entry) == 1
    m = entry[0]
    assert m["source"] == "device_trace"
    assert m["workloads"] == [SPAN_METRICS[name]]
    assert set(m["workloads"]) <= cells
    assert m["layer"] in ("engines", "models")
    assert os.path.isfile(os.path.join(BENCH, "metrics", name + ".py"))


@pytest.mark.parametrize("config", ["rdfcgan-flagship", "rdfgan-nlspn"])
def test_traced_run_carries_the_span_metrics(config, cpu):
    """On the CPU no device interval exists: the span metrics read the
    whole span as stall and no launch call."""
    import run

    spec = tiny_spec(config, "serve-closed-b4")
    spec.traffic["trace_requests"] = 2
    result, checks = run.run_cell(spec, 2147483900, 0.3, True, cpu)
    assert result["correct"] is True, checks
    cell = spec.cell["name"]
    got = result["metrics"]
    mine = {n for n, c in SPAN_METRICS.items() if c == cell}
    assert mine <= set(got)
    assert all(math.isfinite(got[n]["value"]) for n in mine)
    suffix = ".nlspn" if config == "rdfgan-nlspn" else ""
    assert got["stall_pct.serve" + suffix]["value"] <= \
        got["idle_pct.serve" + suffix]["value"]
    assert got["launch_api_pct.serve" + suffix]["value"] == 0.0
