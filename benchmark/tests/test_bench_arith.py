"""The yardstick's arithmetic against hand counts at one shape: the FLOP
count over the reference, the rooflines' work, and the traced slice's
reductions (the union of device intervals, idle share, gaps)."""

from __future__ import annotations

import pytest
import torch

from conftest import ROOT, load


def test_flop_count_of_one_conv_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    conv = torch.nn.Conv2d(8, 16, 3, padding=1, device="meta")
    x = torch.zeros(2, 8, 10, 12, device="meta")
    with FlopCounterMode(display=False) as fc:
        conv(x)
    assert fc.get_total_flops() == 2 * 2 * 10 * 12 * 16 * 8 * 9


def test_reference_flops_at_the_served_shapes():
    """The served forwards: convolutions and matrix products of the
    reference at batch 4, 224x304 (1343.1 and 866.2 GFLOP)."""
    from reference import flops

    for name, want in (("rdfgan-nlspn", 866.172403712e9),):
        cfg = load(f"benchmark/configs/{name}.json")
        got = flops.count(cfg, cfg["train"], 4, False)
        assert got == pytest.approx(want, rel=1e-9)


class _Ctx:
    def __init__(self, config, batch, height=224, width=304):
        self.spec = type("S", (), {"config": config})()
        self.batch, self.height, self.width = batch, height, width


def test_conv3x3_work_by_hand():
    from harness import common

    fam = common.roofline_family("conv3x3")
    work = fam.work(_Ctx(load("benchmark/configs/rdfgan-nlspn.json"), 4))
    # 10 identity blocks (5 a torso), 2 forward and 2 backward launches
    assert len(work) == 40
    fwd = sum(f for b, f, p in work if f > 0) / 3  # forward share is 1/3
    planes = [(64, 224, 304), (64, 224, 304), (128, 112, 152),
              (256, 56, 76), (512, 28, 38)] * 2
    assert fwd == pytest.approx(sum(2 * 18.0 * 4 * h * w * c * c
                                    for c, h, w in planes))
    assert all(p == common.PEAK_BF16_FLOPS for _, _, p in work)


def test_in_fwd_work_by_hand():
    from harness import common

    fam = common.roofline_family("in_fwd")
    work = fam.work(_Ctx(load("benchmark/configs/rdfcgan-flagship.json"),
                         4))
    planes = [(512, 14, 19), (768, 28, 38), (384, 56, 76),
              (192, 112, 152)]
    assert [b for b, _, _ in work] == [
        2 * 4 * c * h * w * 4 + 4 * c * 4 for c, h, w in planes]


def test_nlspn_serve_work_by_hand():
    from harness import common

    fam = common.roofline_family("nlspn_serve")
    (sb, sf, _), (cb, cf, _) = fam.work(
        _Ctx(load("benchmark/configs/rdfgan-nlspn.json"), 4))
    px = 4 * 224 * 304
    assert sb == px * (36 * 12 + 64 * 4) and sf == px * 36
    assert cb == px * (64 * 2 + 8) and cf == 2.0 * 18 * 64 * px


def test_slice_union_idle_and_gaps():
    from harness.tracing import Slice

    sl = Slice(units=2, start_us=0.0, end_us=100.0)
    sl.device = [("k1", 10.0, 30.0), ("k2", 20.0, 40.0),
                 ("Memcpy HtoD", 60.0, 70.0), ("k1", 95.0, 120.0)]
    sl.host = [("aten::conv2d", 0.0, 50.0), ("cudaLaunchKernel", 41.0, 45.0),
               ("aten::copy_", 70.0, 99.0)]
    assert sl.busy_intervals() == [(10.0, 40.0), (60.0, 70.0),
                                   (95.0, 100.0)]
    assert sl.busy_s() == pytest.approx(45e-6)
    assert sl.idle_pct() == pytest.approx(55.0)
    assert sl.kernel_seconds(r"\bk1\b") == pytest.approx(45e-6)
    assert len(sl.kernels()) == 3
    gaps = sl.idle_gaps()
    assert gaps[0] == ["aten::copy_", pytest.approx(25e-6)]
    assert gaps[1] == ["aten::conv2d", pytest.approx(20e-6)]
    assert [n for n, _ in sl.top_device_ops()][0] == "k1"


def test_roofline_share_from_a_slice():
    """least time x units over the family's device time, in %."""
    from harness import common
    from harness.tracing import Slice

    spec = common.load_spec("flagship-serve-b4", ROOT)
    ctx = common.Ctx(spec=spec, seed=0)
    fam = common.roofline_family("in_fwd")
    least = sum(max(b / common.PEAK_BYTES_S, f / p)
                for b, f, p in fam.work(ctx))
    sl = Slice(units=3, start_us=0.0, end_us=1e6)
    dev_us = 3 * least * 1e6 * 2  # the kernels at half their bound
    sl.device = [("void instance_norm_fwd_kernel<float, 4>(x)", 0.0, dev_us),
                 ("other", 0.0, 5.0)]
    ctx.trace = sl
    assert ctx.roofline_pct("in_fwd") == pytest.approx(50.0)
    assert ctx.roofline_pct("nlspn_serve") is None
