"""The plain reference against the port's CPU path at a tiny size: both
configurations served, and one train step's losses and first gradients
(the port's f32 step on the CPU, its kernels' plain versions)."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_config

CONFIGS = ("rdfcgan-flagship", "rdfgan-nlspn")


@pytest.mark.parametrize("name", CONFIGS)
def test_served_maps_match(name, cpu):
    from harness import data, port
    from reference import engines, weights

    cfg = tiny_config(name)
    b = data.batch_pool(2147483800, 1, 2, 32, 48, train=False)[0]
    nets, scale = weights.make(cfg, False, 2147483800, cpu,
                               probe=(b["rgb"], b["raw_depth"]))
    eng = port.build(cfg, 2, "cpu", False,
                     {k: n.state_dict() for k, n in nets.items()})
    got = eng.forward_test(b["rgb"], b["raw_depth"])
    want = engines.Engine(cfg, nets).forward_test(b["rgb"], b["raw_depth"])
    assert set(want) <= set(got)
    for k, w in want.items():
        err = float((got[k] - w).abs().max() / w.abs().max())
        assert err < 2e-5, (k, err)


@pytest.mark.parametrize("name", CONFIGS)
def test_one_train_step_matches(name, cpu):
    from harness import data, port, train
    from reference import engines, weights

    cfg = tiny_config(name)
    B, H, W, seed = 2, 32, 48, 2147483801
    b = data.batch_pool(seed, 1, B, H, W, train=True)[0]
    nets, scale = weights.make(cfg, True, seed, cpu,
                               probe=(b["rgb"], b["raw_depth"]),
                               probe_train=True)
    eng = port.build(cfg, B, "cpu", True,
                     {k: n.state_dict() for k, n in nets.items()})
    shapes = train.keep_shapes(eng.modules, B)
    kw = {} if shapes is None else dict(draws=data.step_draws(
        seed, 0, B, H, W, shapes, cpu))
    got = eng.train_step(b, **kw)
    ref_nets, _ = weights.make(cfg, True, seed, cpu, scale=scale)
    ref = engines.Engine(cfg, ref_nets, cfg["train"])
    ref.make_optimizers()
    want = ref.train_step(b, kw.get("draws"))
    # the Manhattan terms count pixels by the argmax of random logits,
    # which rounding can move across a near tie; every other term
    for k, w in want.items():
        if k.startswith(("floor_", "wall_", "ceiling_")) or k == "loss_G":
            continue
        assert float(got[k]) == pytest.approx(float(w), rel=2e-5), k
    names = {id(p): n for n, p in train.named_params(eng.modules).items()}
    ref_names = {id(p): n for n, p in train.named_params(ref_nets).items()}
    g = train.first_grads(eng.optimizers, names)
    r = train.first_grads(ref.optimizers, ref_names)
    assert set(g) == set(r) and len(r) > 10
    gaps = sorted(gap for gap, _ in train._leaf_gaps(g, r, r))
    # RDF-GAN's leaves to rounding. The flagship's random-weight PSPNet
    # and G_B2A sum some leaves' gradients with heavy cancellation: a 1e-7
    # relative change of G_label's input moves layer1.1.bn2.bias's
    # gradient by 1%, so the port's 1e-6 of rounding moves the worst leaf
    # by up to a tenth and the median by some 5e-4 (not a fault)
    if name == "rdfgan-nlspn":
        assert gaps[-1] < 1e-3, gaps[-3:]
    else:
        assert gaps[len(gaps) // 2] < 5e-3, gaps[-3:]
        assert gaps[-1] < 0.3, gaps[-3:]
