"""Parity of the port's v1 generators and critics with the JAX package, on
the CPU: ``DCVGANGenerator`` guided (ESANetOneModality's 40 class logits
into the core's stem) and unguided, with NLSPN on, narrow core widths and
prop_time 3, in train and eval mode, as a dict and as the v1 5-tuple;
``DCVGANGeneratorVanilla`` with narrow decoders (W-AdaIN and AdaIN fuse
layers); the PixelGAN and PointNet critics; one RDFGAN train step of the
guided DCVGAN against the JAX engine's step (losses, every gradient,
running statistics); a skipped G update (``n_critic``); pretrained torsos
loaded into ``core`` as the JAX package loads them; and the offset probe
seeing a wrapped core. Flax trees are drawn from a numpy seed
(``test_torch_esanet.init_tree``) and cross through ``utils.convert``.

Tolerances. Eval-mode forwards and the critics: rtol 1e-3 / atol 1e-4.
Train-mode forwards with the full-width guidance torso: the f64 rule of
``tests/test_torch_esanet.py``. The train step: losses rtol 1e-4;
gradients, parameters after Adam and running statistics as
``tests/test_torch_train_step.py`` states them (one step).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch import models as tmodels
from rdfc_gan_torch.data import SyntheticDataset
from rdfc_gan_torch.engines import build_engine as t_build
from rdfc_gan_torch.ops.nlspn_guard import probe_max_offset
from rdfc_gan_torch.tools import main_v1 as t_main
from rdfc_gan_torch.utils import convert, pretrained
from rdfc_gan_tpu.engines import build_engine as j_build
from rdfc_gan_tpu.engines.base import GANTrainState
from rdfc_gan_tpu.models import dcv_gan_generator as jdcv
from rdfc_gan_tpu.models import dcv_gan_generator_vanilla as jvan
from rdfc_gan_tpu.models import discriminators as jdisc
from test_torch_esanet import (FWD, STATS, assert_train_close, init_tree,
                               jax_apply, load, nchw, nhwc, rand)
from test_torch_train_step import _np_tree, _recording

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import main_v1 as j_main  # noqa: E402

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

H = W = 64
NARROW = dict(rgb_channels_encoder=(8,) * 6, depth_channels_encoder=(8,) * 6,
              rgb_channels_decoder=(8,) * 4, depth_channels_decoder=(8,) * 4,
              guidance_channels_decoder=(8, 8, 8),
              nlspn_configs=dict(prop_kernel=3, prop_time=3, affinity="TGASS",
                                 affinity_gamma=0.5, conf_prop=True,
                                 preserve_input=False))
# per-sample RGB offsets: the guidance net's pyramid pooling normalises the
# global mean of each channel over the batch, and random images of one
# distribution have nearly equal means, whose difference f32 cannot hold
SHIFTS = np.linspace(-0.6, 0.6, 4).astype(np.float32)
RET = ("depth_map_1", "confidence_map_1", "depth_map_2", "confidence_map_2",
       "pred_depth")


def _inputs(seed, b=2):
    return rand((b, 3, H, W), seed), rand((b, 1, H, W), seed + 1) * 0.5


def _dcv_tree(jm, rgb, dep, seed):
    """A DCVGANGenerator's Flax variables: the guidance net's from
    ``init_tree``, the core's parameters drawn in [-0.15, 0.15], its offset
    conv's kernel in [-0.1, 0.1] and bias in [-0.5, 0.5], as
    tests/test_torch_train_step.py draws an RDFGenerator's (the tanh maps
    stay off +-1 and the NLSPN offsets within the stencil radius), and
    TGASS's scale at its initial gamma * 8."""
    v = init_tree(jm, nhwc(rgb), nhwc(dep), train=True, seed=seed)
    r = np.random.RandomState(seed + 1000)
    core = jax.tree.map(lambda a: r.uniform(-0.15, 0.15, np.shape(a)).astype(
        np.float32), v["params"]["core"])
    core["aff_scale_const"] = np.asarray(4.0, np.float32).reshape(
        np.shape(core["aff_scale_const"]))
    oa = core["conv_offset_aff"]
    oa["kernel"] = r.uniform(-0.1, 0.1, oa["kernel"].shape).astype(np.float32)
    oa["bias"] = r.uniform(-0.5, 0.5, oa["bias"].shape).astype(np.float32)
    v["params"]["core"] = core
    return v


def _dcv_sd(v, fuse):
    return convert.dcv_gan_generator_state_dict_from_jax(
        v["params"], v["batch_stats"], fuse=fuse)


# ----------------------------------------------------- DCVGANGenerator --
def _jax_core(kw):
    """The Flax RDFGenerator that ``DCVGANGenerator.setup`` builds as its
    core, to apply on a given guidance map."""
    from rdfc_gan_tpu.models.rdf_generator import RDFGenerator

    keys = ("encoder_rgb", "encoder_depth", "fuse_depth_in_rgb_decoder",
            "adain_weighting", "use_nlspn_refine", "nlspn_configs",
            "rgb_channels_encoder", "depth_channels_encoder",
            "rgb_channels_decoder", "depth_channels_decoder")
    d = jdcv.DCVGANGenerator(**kw)
    return RDFGenerator(semantic_channels_in=d.guidance_classes
                        if d.use_guidance else 3,
                        **{k: getattr(d, k) for k in keys})


def _core_vars(v):
    return {"params": v["params"]["core"],
            "batch_stats": v["batch_stats"]["core"]}


@pytest.mark.parametrize("guided,train", [(True, False), (False, True),
                                          (True, True)])
def test_dcv_gan_generator_matches_jax(guided, train):
    """Eval mode and the unguided build in train mode: every output against
    the Flax module, and the v1 5-tuple of ``return_tuple`` against the
    dict. The guided build in train mode, whose guidance torso's batch
    statistics on 2x2 planes put f32 noise of 1e-5 into its logits
    (module docstring): the output is the core's on the port's guidance,
    that core against the Flax core on the same guidance map (the 40
    class channels through the unfused stem), and the guidance net against
    the f64 Flax guidance net (``assert_train_close``)."""
    kw = dict(NARROW, use_guidance=guided)
    rgb, dep = _inputs(20)
    jm = jdcv.DCVGANGenerator(**kw)
    v = _dcv_tree(jm, rgb, dep, 21)
    tm = load(tmodels.DCVGANGenerator(**kw), _dcv_sd(v, "WAdaIN"), train)
    xr, xd = torch.from_numpy(rgb), torch.from_numpy(dep)
    with torch.no_grad():
        got = tm(xr, xd)
        tm.return_tuple = True
        tup = tm(xr, xd)
    assert isinstance(tup, tuple) and len(tup) == 5
    for k, t in zip(RET, tup):
        assert torch.equal(t, got[k]), k
    if train and guided:
        with torch.no_grad():
            guide = tm.global_guidance_module(xr)
            assert torch.equal(got["pred_depth"],
                               tm.core(xr, xd, guide)["pred_depth"])
        want, _ = jax_apply(_jax_core(kw), _core_vars(v), nhwc(rgb),
                            nhwc(dep), nhwc(guide.numpy()), train=True)
        g_esa = v["params"]["global_guidance_module"]
        gj = _jax_guidance(kw)
        gv = {"params": g_esa,
              "batch_stats": v["batch_stats"]["global_guidance_module"]}
        g32, _ = jax_apply(gj, gv, nhwc(rgb), train=True)
        g64, _ = jax_apply(gj, gv, nhwc(rgb), train=True, f64=True)
        assert_train_close(guide.numpy(), nchw(g32), nchw(g64), "guidance")
    else:
        want, _ = jax_apply(jm, v, nhwc(rgb), nhwc(dep), train=train)
    for k in RET:
        assert got[k].shape == (2, 1, H, W), k
        np.testing.assert_allclose(got[k].numpy(), nchw(want[k]), **FWD,
                                   err_msg=k)


def _jax_guidance(kw):
    """The Flax ESANetOneModality that ``DCVGANGenerator.setup`` builds."""
    from rdfc_gan_tpu.models.esanet import ESANetOneModality

    d = jdcv.DCVGANGenerator(**kw)
    return ESANetOneModality(
        num_classes=d.guidance_classes, encoder=d.guidance_encoder,
        channels_decoder=tuple(d.guidance_channels_decoder),
        nr_decoder_blocks=tuple(d.guidance_nr_decoder_blocks),
        encoder_decoder_fusion=d.guidance_encoder_decoder_fusion,
        context_module=d.guidance_context_module,
        weighting_in_encoder=d.guidance_weighting_in_encoder,
        upsampling=d.guidance_upsampling, pyramid_supervision=False)


def test_dcv_gan_generator_takes_only_the_jax_keys():
    import dataclasses
    import inspect

    jax_keys = {f.name for f in dataclasses.fields(jdcv.DCVGANGenerator)
                if f.name not in ("parent", "name")}
    port_keys = set(inspect.signature(
        tmodels.DCVGANGenerator.__init__).parameters) - {"self"}
    assert port_keys == jax_keys
    g = tmodels.DCVGANGenerator(**NARROW)
    assert g.core.nlspn_offset_radius == 2 and g.core.nlspn_impl == "auto"


# ----------------------------------------------------------- vanilla --
@pytest.mark.parametrize("fuse,guided,train", [
    ("WAdaIN", False, False), ("AdaIN", True, False)])
def test_vanilla_generator_matches_jax(fuse, guided, train):
    kw = dict(rgb_channels_decoder=(8,) * 5, depth_channels_decoder=(8,) * 5,
              nr_decoder_blocks=(1, 1, 0, 0, 1), guidance_classes=6,
              fuse_depth_in_rgb_decoder=fuse, use_guidance=guided)
    rgb, dep = _inputs(22)
    jm = jvan.DCVGANGeneratorVanilla(**kw)
    v = init_tree(jm, nhwc(rgb), nhwc(dep), train=True, seed=23)
    sd = convert.dcv_gan_generator_vanilla_state_dict_from_jax(
        v["params"], v["batch_stats"])
    tm = load(tmodels.DCVGANGeneratorVanilla(**kw), sd, train)
    with torch.no_grad():
        got = tm(torch.from_numpy(rgb), torch.from_numpy(dep))
    want, stats = jax_apply(jm, v, nhwc(rgb), nhwc(dep), train=train)
    assert isinstance(got, tuple) and len(got) == 5
    want64 = (jax_apply(jm, v, nhwc(rgb), nhwc(dep), train=True, f64=True)[0]
              if train else want)
    for k, g, w, w64 in zip(RET, got, want, want64):
        assert g.shape == (2, 1, H, W)
        if train:  # two full-width torsos on batch statistics
            assert_train_close(g.numpy(), nchw(w), nchw(w64), k)
        else:
            np.testing.assert_allclose(g.numpy(), nchw(w), **FWD, err_msg=k)
    if train:
        back = convert.dcv_gan_generator_vanilla_state_dict_from_jax(
            v["params"], jax.tree.map(np.asarray, stats))
        for k, t in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), back[k].numpy(),
                                           **STATS, err_msg=k)


# ----------------------------------------------------------- critics --
@pytest.mark.parametrize("train", [False, True])
def test_pixelgan_and_pointnet_match_jax(train):
    x = rand((2, 1, 9, 11), 24)
    jm = jdisc.PixelGANDiscriminator(ndf=8)
    v = init_tree(jm, nhwc(x), train=True, seed=25)
    tm = load(tmodels.PixelGANDiscriminator(1, ndf=8),
              convert.pixelgan_state_dict_from_jax(v["params"],
                                                   v["batch_stats"]), train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want, stats = jax_apply(jm, v, nhwc(x), train=train)
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD)

    pts = rand((2, 50, 3), 26)
    jp = jdisc.PointNetDiscriminator()
    v = init_tree(jp, jnp.asarray(pts), train=True, seed=27)
    tp = load(tmodels.PointNetDiscriminator(),
              convert.pointnet_state_dict_from_jax(v["params"],
                                                   v["batch_stats"]), train)
    with torch.no_grad():
        got = tp(torch.from_numpy(pts))
    want, stats = jax_apply(jp, v, jnp.asarray(pts), train=train)
    assert got.shape == (2, 50, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    if train:
        back = convert.pointnet_state_dict_from_jax(
            v["params"], jax.tree.map(np.asarray, stats))
        for k, t in tp.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), back[k].numpy(),
                                           **STATS, err_msg=k)


def test_v1_critics_are_registered():
    from rdfc_gan_torch.registry import DISCRIMINATORS, GENERATORS

    for k in ("PixelGANDiscriminator", "PointNetDiscriminator"):
        DISCRIMINATORS.get(k)
    for k in ("DCVGANGenerator", "DCVGANGeneratorVanilla"):
        GENERATORS.get(k)


# ------------------------------------------------ the RDFGAN v1 step --
FLAGS = ["--dataset", "synthetic", "--height", str(H), "--width", str(W),
         "--use_guidance", "--use_nlspn_to_refine",
         "--fuse_depth_in_rgb_decoder", "WAdaIN",
         "--rgb_channels_encoder", *["8"] * 6,
         "--depth_channels_encoder", *["8"] * 6,
         "--rgb_channels_decoder", *["8"] * 4,
         "--depth_channels_decoder", *["8"] * 4,
         "--guidance_channels_decoder", "8", "8", "8", "--prop_time", "3"]


def _engines(tmp_path, extra=()):
    args = FLAGS + ["--work_dir", str(tmp_path / "w"), *extra]
    jcfg = j_main.make_cfg(j_main.build_parser().parse_args(args))
    tcfg = t_main.parse_cfg(args + ["--device", "cpu"])
    for cfg in (jcfg, tcfg):
        # f32, and the narrow PatchGAN of tests/test_torch_train_step.py
        cfg.compute_dtype = "float32"
        cfg.model.D.merge(dict(out_channels=[8, 16, 16, 16, 1]))
    torch.manual_seed(0)
    te = t_build(tcfg, is_train=True, steps_per_epoch=4)
    je = j_build(jcfg, is_train=True, steps_per_epoch=4)
    je.optimizers = {k: _recording(v) for k, v in je.optimizers.items()}
    rgb, dep = _inputs(30)
    vg = _dcv_tree(je.modules["G"], rgb, dep, 31)
    vd = init_tree(je.modules["D"], nhwc(dep), train=True, seed=32)
    te.modules["G"].load_state_dict(_dcv_sd(vg, "WAdaIN"), strict=False)
    te.modules["D"].load_state_dict(convert.patchgan_state_dict_from_jax(
        vd["params"], vd["batch_stats"]), strict=False)
    params = {"G": jax.tree.map(jnp.asarray, vg["params"]),
              "D": jax.tree.map(jnp.asarray, vd["params"])}
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"G": jax.tree.map(jnp.asarray, vg["batch_stats"]),
                     "D": jax.tree.map(jnp.asarray, vd["batch_stats"])},
        opt_states={k: je.optimizers[k].init(params[k]) for k in params})
    return te, je, state


def _batch(seed=0, b=4):
    """b synthetic samples, the RGB of each shifted by its own offset (see
    the module docstring)."""
    ds = SyntheticDataset(length=b, height=H, width=W, seed=seed)
    nb = {k: np.stack([ds[i][k] for i in range(b)]) for k in ds[0]}
    nb["rgb"] = nb["rgb"] + SHIFTS[:b, None, None, None]
    tb = {k: torch.from_numpy(v.copy()).permute(0, 3, 1, 2).contiguous()
          if v.ndim == 4 else torch.from_numpy(v.copy())
          for k, v in nb.items()}
    return tb, {k: jnp.asarray(v) for k, v in nb.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_guided_rdfgan_step_matches_jax(tmp_path):
    """One lsgan step of the RDFGAN engine with the guided DCVGAN (W-AdaIN,
    NLSPN, 40 classes into the core's stem) from the same weights (the
    core's drawn as in tests/test_torch_train_step.py): the losses (rtol
    1e-4), every gradient of G and D, and the running statistics (rtol
    1e-4 / atol 1e-5).

    This step's gradients are ill-conditioned in f32: BatchNorms of the
    guidance torso and the core on 2x2 to 16x16 planes, instance norms of
    W-AdaIN over 4 to 64 values, and LeakyReLUs whose derivative jumps
    where their input crosses 0. The JAX step's own gradients move by up
    to 1.3e-2 (relative L2) when the RGB moves by 1e-7 relative. So the
    first-step rule of tests/test_torch_train_step.py (2e-4 of each
    tensor's largest entry), which that file's narrow 32x48 step meets,
    does not hold here: each gradient tensor whose largest entry is above
    5e-4 (a conv bias in front of a BatchNorm has a gradient of noise
    alone) is held to a relative L2 error of at most 1e-2 plus four times
    that spread, measured here with a second JAX step on such an RGB
    (1e-3 median, 1.4e-2 largest seen). The parameters after Adam are not
    compared: Adam's first step is lr * sign(g), and an entry whose
    gradient noise straddles 0 takes either sign on either side
    (tests/test_torch_train_step.py compares them at the narrow widths)."""
    te, je, state = _engines(tmp_path)
    tb, jb = _batch()
    got = te.train_step(tb)
    step = jax.jit(je._train_step_impl)
    key = jax.random.PRNGKey(3)
    new, want = step(state, jb, key)
    noise = np.random.RandomState(7).normal(size=jb["rgb"].shape)
    moved, _ = step(state, dict(jb, rgb=jb["rgb"] * (
        1 + 1e-7 * noise).astype(np.float32)), key)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    g_sd = lambda p, s: _dcv_sd(dict(params=p, batch_stats=s),  # noqa: E731
                                "WAdaIN")
    for name, to_sd in (("D", convert.patchgan_state_dict_from_jax),
                        ("G", g_sd)):
        stats = _np_tree(state.batch_stats[name])
        want_g = to_sd(_np_tree(new.opt_states[name][1]), stats)
        spread = to_sd(_np_tree(moved.opt_states[name][1]), stats)
        n = 0
        for k, p in te.modules[name].named_parameters():
            if k not in want_g or not p.requires_grad:
                continue
            w = want_g[k].numpy()
            if np.abs(w).max() <= 5e-4:
                continue
            err, floor = _rel(p.grad.numpy(), w), _rel(spread[k].numpy(), w)
            assert err <= 4 * floor + 1e-2, (k, err, floor)
            n += 1
        assert n > (4 if name == "D" else 100), n
        want_s = to_sd(_np_tree(new.params[name]),
                       _np_tree(new.batch_stats[name]))
        for k, t in te.modules[name].state_dict().items():
            if "running" not in k:
                continue
            # the critic's third pass (the G loss) sees its conv biases
            # after Adam's step, which moves the running means by up to 2 lr
            extra = 2 * te.cfg.lr if name == "D" and "mean" in k else 0.0
            np.testing.assert_allclose(t.numpy(), want_s[k].numpy(),
                                       rtol=STATS["rtol"],
                                       atol=STATS["atol"] + extra,
                                       err_msg=k)


def test_skipped_g_update_leaves_g_unchanged(tmp_path):
    """update_g=False (a step where it % n_critic != 0): D steps, G's
    parameters stay, its BatchNorm statistics move, and G takes no
    gradient."""
    args = FLAGS + ["--work_dir", str(tmp_path), "--device", "cpu",
                    "--n_critic", "2"]
    torch.manual_seed(0)
    te = t_build(t_main.parse_cfg(args), is_train=True)
    G, D = te.modules["G"], te.modules["D"]
    g0 = {k: v.clone() for k, v in G.state_dict().items()}
    d0 = {k: v.clone() for k, v in D.state_dict().items()}
    tb, _ = _batch()
    te.train_step(tb, update_g=False)
    assert all(p.grad is None for p in G.parameters())
    for k, v in G.named_parameters():
        assert torch.equal(v, g0[k]), k
    assert any(not torch.equal(v, g0[k]) for k, v in G.state_dict().items()
               if "running" in k)
    assert any(not torch.equal(v, d0[k]) for k, v in D.named_parameters())


# ------------------------------------------ torsos and the offset probe --
def test_pretrained_torsos_load_into_core_as_jax(tmp_path):
    from rdfc_gan_tpu.utils.torch_convert import apply_pretrained_torsos

    # both branches' en1 give 64 channels, so their layer1 take one file
    kw = dict(NARROW, rgb_channels_encoder=(64,) + (8,) * 5)
    rgb, dep = _inputs(40)
    jm = jdcv.DCVGANGenerator(**kw)
    v = _dcv_tree(jm, rgb, dep, 41)
    # a torchvision-named file at the core's torso widths, drawn apart
    donor = load(tmodels.DCVGANGenerator(**kw),
                 _dcv_sd(_dcv_tree(jm, rgb, dep, 42), "WAdaIN"), False)
    ed = donor.core.depth_branch_encoder_decoder
    sd = {f"layer{i - 1}.{k}": t for i in range(2, 6)
          for k, t in getattr(ed, f"en{i}").state_dict().items()}
    sd["conv1.weight"] = torch.randn(64, 3, 7, 7)
    pth = str(tmp_path / "resnet18.pth")
    torch.save(sd, pth)
    p, s = apply_pretrained_torsos(v["params"], v["batch_stats"], pth)
    want = convert.dcv_gan_generator_state_dict_from_jax(
        jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))
    port = load(tmodels.DCVGANGenerator(**kw), _dcv_sd(v, "WAdaIN"),
                False)
    before = {k: t.clone() for k, t in port.state_dict().items()}
    pretrained.load_resnet_torsos(port, pretrained.load_torch_state_dict(pth))
    got = port.state_dict()
    torso = tuple(f"core.{b}.en{i}." for b in pretrained.TORSO_BRANCHES
                  for i in range(2, 6))
    n = 0
    for k, t in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith(torso):
            assert torch.equal(t, want[k]), k
            assert not torch.equal(t, before[k]) or "running_mean" in k, k
            n += 1
        else:  # the guidance net and the rest of the core keep theirs
            assert torch.equal(t, before[k]), k
    assert n > 40


def test_probe_sees_a_wrapped_core(tmp_path):
    """The RDFGAN engine's G is a DCVGANGenerator, whose NLSPN stage is its
    core's (it has no ``use_nlspn_refine`` of its own): the probe runs a
    forward and reports the max |offset| that forward gives; without NLSPN
    it reports 0 and runs nothing (rdfc_gan_tpu/ops/nlspn_guard.py:38-42)."""
    tb, _ = _batch(1)
    for nlspn, extra in ((True, []), (False, ["--model", "vanilla"])):
        args = [f for f in FLAGS if nlspn or f != "--use_nlspn_to_refine"]
        torch.manual_seed(0)
        te = t_build(t_main.parse_cfg(args + extra + [
            "--work_dir", str(tmp_path), "--device", "cpu"]))
        G = te.modules["G"]
        assert not hasattr(G, "use_nlspn_refine")
        if nlspn:
            with torch.no_grad():
                oa = G.core.nlspn_refine_module.prop_layer.conv_offset_aff
                oa.bias.uniform_(-0.5, 0.5)
            want = float(te.forward_test(tb["rgb"], tb["raw_depth"])[
                "nlspn_max_offset"])
        got = probe_max_offset(te, tb)
        assert te.n_forward == (2 if nlspn else 0)
        assert got == (want if nlspn else 0.0) and (got > 0) == nlspn
