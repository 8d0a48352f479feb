"""The ESANet-guided RDF-GAN (``rdfgan-guided``, the cell
``guided-serve-b4``) at a tiny size of its own on the CPU: the
configuration's G with narrow core and ESANet decoder widths, NLSPN with 3
steps, at 36x52, where ESANet's planes are 18x26, 9x13, 5x7, 3x4, 2x2 and
the core's 36x52 to 3x4, so that decoder stages of both trim an uneven
skip. It holds the port's served maps to the reference's under the cell's
limits, the type file, the seeding of the NLSPN inside ``core``, the
full-size nets and FLOPs, the two span metrics of the guidance net, and a
planted fault."""

from __future__ import annotations

import math
import os

import conftest
import pytest
import torch
from conftest import BENCH, load
from test_bench_reference_nets import _probe, _shapes

CONFIG, TRAFFIC, CELL = "rdfgan-guided", "serve-closed-b4", "guided-serve-b4"
SEED = 2147483910
BENCHMARK = load("BENCHMARK.json")
GUIDANCE_METRICS = ("stall_ms.G_guidance", "launches.G_guidance")
# at 4x228x304: state-dict entries and the digest of every
# "<net>.<key>:<shape>:<dtype>" in build order, and the FLOPs of a request
FULL_SIZE = (604, "3518fdb1cef739b8", 933779277824)


def tiny_config() -> dict:
    """``conftest.tiny_config``'s narrow core (8 channels, 3 NLSPN steps,
    the served masks in f32 as the port serves them on the CPU), with
    narrow ESANet decoders, at 36x52."""
    cfg = conftest.tiny_config(CONFIG)
    cfg["out_height"], cfg["out_width"] = 36, 52
    cfg["model"]["G"]["guidance_channels_decoder"] = [16, 16, 16]
    return cfg


def tiny_spec():
    """The cell at the tiny size (``conftest.tiny_spec``: batch 4, a pool
    of 4 batches, 2 of them checked), with its own limits and metrics."""
    spec = conftest.tiny_spec(CONFIG, TRAFFIC)
    spec.config = tiny_config()
    return spec


def _run(cpu, trace=False, wrap=None):
    import run

    spec = tiny_spec()
    spec.traffic["trace_requests"] = 2
    return run.run_cell(spec, SEED, 0.3, trace, cpu, wrap=wrap)


def test_sound_run_is_correct(cpu):
    result, checks = _run(cpu)
    assert result["correct"] is True, checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "serve_img_s.nlspn", "serve_p95_ms.nlspn"} <= set(
        result["metrics"])


def test_traced_run_reports_the_guidance_metrics(cpu):
    """On the CPU no device interval exists: the guidance net's span reads
    whole as stall, and no launch call."""
    result, checks = _run(cpu, trace=True)
    assert result["correct"] is True, checks
    got = result["metrics"]
    for name in GUIDANCE_METRICS:
        assert math.isfinite(got[name]["value"]), name
    assert got["stall_ms.G_guidance"]["value"] > 0.0
    assert got["launches.G_guidance"]["value"] == 0.0


def test_guidance_replaced_by_the_rgb_is_not_correct(cpu):
    """ESANet's logits replaced in the program by the RGB, repeated over
    the classes' channels: the core gets the no-guidance input."""
    def wrap(engine):
        def rgb_instead(module, args, out):
            rgb = args[0]
            reps = -(-out.shape[1] // rgb.shape[1])
            return rgb.repeat(1, reps, 1, 1)[:, :out.shape[1]]

        engine.modules["G"].global_guidance_module.register_forward_hook(
            rgb_instead)
        return engine.forward_test

    result, checks = _run(cpu, wrap=wrap)
    assert result["correct"] is False, checks
    assert checks["depth_map_1_err"]["value"] > \
        checks["depth_map_1_err"]["limit"]


def test_control_is_not_correct(cpu):
    """The reference in TF32, the precision below the f32 served path, in
    the program's place, judged by the cell's limits."""
    import control
    from harness import common

    spec = tiny_spec()
    ok, checks = common.judge(
        control.readings(spec, SEED + 1, cpu)["control_tf32"], spec.limits)
    assert ok is False, checks


def test_type_file_and_the_nlspn_inside_core(cpu):
    """``DCVGANGenerator`` finds ``nets/DCVGANGenerator.py``; the seeding
    raises the affinity rows and scales the offset rows of the NLSPN that
    ``core`` holds, to the configuration's largest offset on the probe."""
    from reference import engines, weights

    cfg = tiny_config()
    probe = _probe(cfg, SEED, False)
    nets, scale = weights.make(cfg, False, SEED, cpu, probe=probe)
    g = nets["G"]
    assert type(g).__name__ == "GuidedGenerator"
    assert [n for n, _ in g.named_children()] == [
        "global_guidance_module", "core"]
    assert g.core.rgb_branch_en1[0].in_channels == 40
    assert weights.offset_convs(g) == [
        g.core.nlspn_refine_module.prop_layer.conv_offset_aff]
    assert 0.0 < scale < math.inf
    assert weights.offset_scale(g, *probe, cfg["nlspn_target_offset"]) == \
        pytest.approx(1.0, rel=1e-5)

    raw = engines.build_nets(cfg, False, "meta")
    raw = {k: n.to_empty(device=cpu) for k, n in raw.items()}
    weights.fill(raw, SEED, cpu)
    got, fill = g.state_dict(), raw["G"].state_dict()
    conv = "core.nlspn_refine_module.prop_layer.conv_offset_aff."
    n_off = 2 * (got[conv + "bias"].numel() // 3)
    for leaf in ("weight", "bias"):
        w, f = got[conv + leaf], fill[conv + leaf]
        assert torch.equal(w[:n_off], f[:n_off] * scale)
    assert torch.equal(got[conv + "weight"][n_off:],
                       fill[conv + "weight"][n_off:]
                       * weights.AFF_WEIGHT_SCALE)
    assert torch.equal(got[conv + "bias"][n_off:],
                       fill[conv + "bias"][n_off:] + weights.AFF_BIAS)
    for k, v in got.items():
        if "conv_offset_aff" not in k:
            assert torch.equal(v, fill[k]), k


def test_full_size_nets_and_flops():
    from reference import engines, flops

    cfg = load(f"benchmark/configs/{CONFIG}.json")
    n, digest, want_flops = FULL_SIZE
    assert _shapes(engines.build_nets(cfg, False, "meta")) == (n, digest)
    assert flops.count(cfg, cfg["train"], 4, False) == want_flops


def test_reference_refuses_a_guidance_it_does_not_build():
    from reference import engines

    cfg = tiny_config()
    cfg["model"]["G"]["guidance_upsampling"] = "bilinear"
    with pytest.raises(NotImplementedError, match="guidance_upsampling"):
        engines.build_nets(cfg, False, "meta")


@pytest.mark.parametrize("name", GUIDANCE_METRICS)
def test_guidance_metric_has_entry_reader_and_cell(name):
    entry = [m for m in BENCHMARK["per_layer"] if m["name"] == name]
    assert len(entry) == 1
    m = entry[0]
    assert m["source"] == "device_trace" and m["layer"] == "models"
    assert m["workloads"] == [CELL]
    assert os.path.isfile(os.path.join(BENCH, "metrics", name + ".py"))
