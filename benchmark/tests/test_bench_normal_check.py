"""The flagship's normals are judged by ``pred_normal_cerr``: each pixel's
error weighted by min(1, |xyz| / median |xyz|) of the reference's
pre-normalisation output, so that a pixel whose tiny norm amplifies
rounding is discounted by that amplification and every other pixel reads
its whole error. At a tiny size on the CPU."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_config, tiny_spec

SEED = 2147483910


def _setup(cpu):
    from harness import common, data
    from reference import engines, weights

    spec = tiny_spec("rdfcgan-flagship", "serve-closed-b4")
    ctx = common.Ctx(spec=spec, seed=SEED)
    pool = data.batch_pool(SEED, int(spec.traffic["pool"]), ctx.batch,
                           ctx.height, ctx.width, train=False)
    nets, scale = weights.make(spec.config, False, SEED, cpu)
    ref = engines.Engine(spec.config, nets)
    maps = {j: {k: v.float() for k, v in ref.forward_test(
        b["rgb"], b["raw_depth"]).items()} for j, b in enumerate(pool)}
    weight = {j: ref.conditioning(b["rgb"])["pred_normal"]
              for j, b in enumerate(pool)}
    return ctx, pool, scale, maps, weight


def test_weight_is_the_norm_over_its_median_up_to_one(cpu):
    from reference import engines, weights

    cfg = tiny_config("rdfcgan-flagship")
    nets, _ = weights.make(cfg, False, SEED, cpu)
    ref = engines.Engine(cfg, nets)
    rgb = torch.rand(2, 3, cfg["out_height"], cfg["out_width"])
    ref.forward_test(rgb, torch.rand(2, 1, cfg["out_height"],
                                     cfg["out_width"]))
    w = ref.conditioning(rgb)["pred_normal"]
    norm = nets["G_normal"](rgb)[:, :3].norm(dim=1, keepdim=True)
    assert w.shape == (2, 1, cfg["out_height"], cfg["out_width"])
    assert torch.equal(w, (norm / norm.median()).clamp(max=1.0))
    assert float(w.min()) > 0 and float(w.max()) == 1.0
    # no map of the RDF-GAN is conditioned
    ncfg = tiny_config("rdfgan-nlspn")
    nnets, _ = weights.make(ncfg, False, SEED, cpu, probe=(
        rgb, torch.rand(2, 1, cfg["out_height"], cfg["out_width"])))
    assert engines.Engine(ncfg, nnets).conditioning(rgb) == {}


@pytest.mark.parametrize("where", ["full", "smallest"])
def test_one_pixel_error_reads_its_weight(where, cpu):
    """An error at a pixel of full weight reads whole, as ``_err`` does; at
    the pixel of the smallest norm it reads times that pixel's weight."""
    from harness import serve

    ctx, pool, scale, maps, weight = _setup(cpu)
    j = sorted(maps)[0]
    w = weight[j]
    flat = int(w.flatten().argmin()) if where == "smallest" else \
        int((w == 1.0).flatten().nonzero()[0])
    n, _, y, x = torch.unravel_index(torch.tensor(flat), w.shape)
    got = {k: {m: t.clone() for m, t in v.items()} for k, v in maps.items()}
    got[j]["pred_normal"][n, 1, y, x] += 0.01
    r = serve.compare(ctx, cpu, pool, got, scale)
    assert r["pred_normal_err"] == pytest.approx(0.01, rel=1e-3)
    assert r["pred_normal_cerr"] == pytest.approx(
        0.01 * float(w[n, 0, y, x]), rel=1e-3)
    if where == "full":
        assert r["pred_normal_cerr"] == pytest.approx(r["pred_normal_err"],
                                                      rel=1e-6)


def test_few_pixel_normal_fault_is_not_correct(cpu):
    """Normals altered by 1e-2 at three pixels, where they are produced:
    the run reads not correct, by ``pred_normal_cerr``."""
    import run

    def wrap(engine):
        def serve(rgb, raw):
            out = dict(engine.forward_test(rgb, raw))
            nrm = out["pred_normal"].clone()
            nrm[:, 0, 5, 7:10] += 1e-2
            out["pred_normal"] = nrm
            return out
        return serve

    spec = tiny_spec("rdfcgan-flagship", "serve-closed-b4")
    result, checks = run.run_cell(spec, SEED, 0.5, False, torch.device(
        "cpu"), wrap=wrap)
    assert result["correct"] is False, checks
    assert checks["pred_normal_cerr"]["value"] > \
        checks["pred_normal_cerr"]["limit"]
