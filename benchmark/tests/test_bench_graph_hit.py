"""``graph_hit_pct.serve`` on hand-built slices: the program's replay spans
over its served nets' spans, None for a slice with no replay span (a
program that replays no graph) and without a slice; its entry."""

from __future__ import annotations

import pytest

from conftest import ROOT, load

CELL = "flagship-serve-b4"


def _ctx(host):
    from harness import common
    from harness.tracing import Slice

    ctx = common.Ctx(spec=common.load_spec(CELL, ROOT), seed=0)
    if host is not None:
        ctx.trace = Slice(units=2, start_us=0.0, end_us=100.0,
                          host=list(host))
    return ctx


def _request(t, replayed):
    nets = [("rdfc.G_label", t, t + 10.0), ("rdfc.G_normal", t + 10.0,
                                            t + 20.0),
            ("rdfc.G_A2B", t + 20.0, t + 30.0)]
    replays = [("rdfc.graph_replay", s + 1.0, e - 1.0)
               for _, s, e in nets[:replayed]]
    return [("rdfc.serve", t, t + 30.0)] + nets + replays


@pytest.mark.parametrize("replayed, want", [(3, 100.0), (2, 250.0 / 3),
                                            (0, None)])
def test_replays_over_the_nets(replayed, want):
    from harness import common

    # one request replays all three nets, the other ``replayed`` of them
    host = _request(0.0, 3 if replayed else 0) + _request(50.0, replayed)
    got = common.reader("graph_hit_pct.serve")(_ctx(host))
    assert got == (None if want is None else pytest.approx(want,
                                                           rel=1e-12))


def test_no_slice_reads_none():
    from harness import common

    assert common.reader("graph_hit_pct.serve")(_ctx(None)) is None


def test_entry():
    entry = [m for m in load("BENCHMARK.json")["per_layer"]
             if m["name"] == "graph_hit_pct.serve"]
    assert entry == [{"name": "graph_hit_pct.serve", "unit": "%",
                      "better": "higher", "source": "program_span",
                      "layer": "engines", "moves": "serve_img_s",
                      "workloads": [CELL]}]
