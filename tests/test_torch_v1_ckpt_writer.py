"""The port's writer of the v1 driver's ``.ckpt``, against the JAX package,
on the CPU at the tiny v1 sizes of ``tests/test_torch_v1_driver.py``.

- Every v1 net (the guided ``DCVGANGenerator`` with NLSPN and W-AdaIN, its
  AdaIN, INFuse and weighted builds, ``DCVGANGeneratorVanilla``, ESANet,
  PixelGAN, PointNet): a JAX-initialised tree -> ``utils.convert`` ->
  ``utils.torch_convert`` gives the identical tree.
- The guided engine after one CPU step of the port's ``main_v1`` ->
  ``save_jax_checkpoint``: the JAX ``load_checkpoint`` reads it into the
  JAX ``tools/main_v1.py`` template, whose forward equals the port's; the
  JAX ``resume_from`` restores the step, the epoch and every optax leaf;
  the JAX ``main_v1 --inference --load_from`` reports the port's metrics;
  the port serves and resumes it as it does its own ``.pth``.

Pallas calls run in interpret mode, as ``tests/test_nlspn_stencil.py``
runs them. Tolerances: trees, optimizer states and the port's ``.ckpt``
against its ``.pth``: bit for bit. Forwards and metrics, JAX against the
port: rtol 1e-3 / atol 1e-4, those of the port's v1 parity tests.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.data import SyntheticDataset as TSynth
from rdfc_gan_torch.engines import build_engine as t_build
from rdfc_gan_torch.registry import DATASETS as T_DATASETS
from rdfc_gan_torch.tools import main_v1 as t_main
from rdfc_gan_torch.utils import convert
from rdfc_gan_torch.utils import torch_convert as tc
from rdfc_gan_torch.utils.checkpoint import (load_checkpoint, resume_from,
                                             save_jax_checkpoint)
from rdfc_gan_torch.utils.jax_checkpoint import read_state, sorted_tree
from rdfc_gan_tpu.data import DataLoader as JLoader
from rdfc_gan_tpu.data import SyntheticDataset as JSynth
from rdfc_gan_tpu.engines import build_engine as j_build
from rdfc_gan_tpu.models import dcv_gan_generator as jdcv
from rdfc_gan_tpu.models import dcv_gan_generator_vanilla as jvan
from rdfc_gan_tpu.models import discriminators as jdisc
from rdfc_gan_tpu.models import esanet as jesa
from rdfc_gan_tpu.registry import DATASETS as J_DATASETS
from rdfc_gan_tpu.utils.checkpoint import load_checkpoint as j_load
from rdfc_gan_tpu.utils.checkpoint import resume_from as j_resume
from test_torch_esanet import init_tree, nhwc, rand
from test_torch_jax_ckpt import _bits, _tree_spec
from test_torch_train_step import _np_tree
from test_torch_v1_driver import TINY, _metrics

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import main_v1 as j_main  # noqa: E402

# one intra-op thread a Tier-1 worker (see tests/test_torch_jax_ckpt.py)
torch.set_num_threads(1)

FWD = dict(rtol=1e-3, atol=1e-4)
H = W = 64
NLSPN = dict(prop_kernel=3, prop_time=3, affinity="TGASS",
             affinity_gamma=0.5, conf_prop=True, preserve_input=False)
NARROW = dict(rgb_channels_encoder=(8,) * 6, depth_channels_encoder=(8,) * 6,
              rgb_channels_decoder=(8,) * 4, depth_channels_decoder=(8,) * 4,
              guidance_channels_decoder=(8, 8, 8), nlspn_configs=NLSPN)
VANILLA = dict(rgb_channels_decoder=(8,) * 5, depth_channels_decoder=(8,) * 5,
               nr_decoder_blocks=(1, 1, 0, 0, 1), guidance_classes=6)
FLAGS = TINY + ["--use_guidance", "--use_nlspn_to_refine",
                "--fuse_depth_in_rgb_decoder", "WAdaIN"]


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` in interpret mode on the CPU."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


# ---------------------------------------------------------- converters --
def _dcv(guided, nlspn, fuse, weighting=False):
    kw = dict(NARROW, use_guidance=guided, use_nlspn_refine=nlspn,
              fuse_depth_in_rgb_decoder=fuse, adain_weighting=weighting)
    opts = dict(use_nlspn_refine=nlspn, adain_weighting=weighting, fuse=fuse)
    return (jdcv.DCVGANGenerator(**kw), "rgbd",
            functools.partial(convert.dcv_gan_generator_state_dict_from_jax,
                              **opts),
            functools.partial(tc.convert_dcv_gan_generator, **opts))


def _vanilla(fuse, guided, weighting=False):
    kw = dict(VANILLA, fuse_depth_in_rgb_decoder=fuse, use_guidance=guided,
              adain_weighting=weighting)
    return (jvan.DCVGANGeneratorVanilla(**kw), "rgbd",
            functools.partial(
                convert.dcv_gan_generator_vanilla_state_dict_from_jax,
                adain_weighting=weighting),
            tc.convert_dcv_gan_generator_vanilla)


def _esanet(two_modality, **kw):
    cls = jesa.ESANet if two_modality else jesa.ESANetOneModality
    return (cls(num_classes=5, channels_decoder=(16, 16, 16), **kw),
            "rgbd" if two_modality else "rgb",
            functools.partial(convert.esanet_state_dict_from_jax,
                              two_modality=two_modality),
            functools.partial(tc.convert_esanet, two_modality=two_modality))


NETS = {
    "guided-nlspn-wadain": lambda: _dcv(True, True, "WAdaIN"),
    "guided-adain": lambda: _dcv(True, False, "AdaIN"),
    "unguided-nlspn-in": lambda: _dcv(False, True, "IN"),
    "guided-wadain-weighting": lambda: _dcv(True, True, "WAdaIN", True),
    "vanilla-wadain": lambda: _vanilla("WAdaIN", False),
    "vanilla-guided-adain": lambda: _vanilla("AdaIN", True),
    "vanilla-guided-weighting": lambda: _vanilla("WAdaIN", True, True),
    "esanet-side-outputs": lambda: _esanet(False, pyramid_supervision=True),
    "esanet-nearest-no-se": lambda: _esanet(
        False, upsampling="nearest", weighting_in_encoder="None"),
    "esanet-two-modality": lambda: _esanet(True),
    "pixelgan": lambda: (jdisc.PixelGANDiscriminator(ndf=8), "x",
                         convert.pixelgan_state_dict_from_jax,
                         tc.convert_pixelgan),
    "pointnet": lambda: (jdisc.PointNetDiscriminator(), "points",
                         convert.pointnet_state_dict_from_jax,
                         tc.convert_pointnet),
}


def _init(module, inputs, seed):
    rgb, dep = rand((2, 3, H, W), seed), rand((2, 1, H, W), seed + 1)
    args = {"rgbd": (nhwc(rgb), nhwc(dep)), "rgb": (nhwc(rgb),),
            "x": (nhwc(rand((2, 1, 9, 11), seed)),),
            "points": (jnp.asarray(rand((2, 50, 3), seed)),)}[inputs]
    v = init_tree(module, *args, train=True, seed=seed)
    return {"params": _np_tree(v["params"]),
            "batch_stats": _np_tree(v.get("batch_stats", {}))}


@pytest.mark.parametrize("net", sorted(NETS))
def test_v1_tree_round_trips_through_the_state_dict(net):
    """JAX tree -> state dict -> JAX tree is the identity: keys, shapes,
    dtypes and bits."""
    module, inputs, to_sd, to_tree = NETS[net]()
    v = _init(module, inputs, seed=sorted(NETS).index(net))
    sd = {k: t.numpy() for k, t in to_sd(v["params"],
                                         v["batch_stats"]).items()}
    back = to_tree(sd)
    assert _bits(sorted_tree(back)) == _bits(sorted_tree(v))


# ------------------------------------------------------------ engine --
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's guided v1 model after one CPU step of its ``main_v1``
    (``epoch_1.pth``), its engine written by ``save_jax_checkpoint`` as
    ``epoch_1.ckpt``, and the JAX driver's template."""
    tmp = tmp_path_factory.mktemp("v1w")
    mp = pytest.MonkeyPatch()
    mp.setitem(T_DATASETS._entries, "synthetic",
               functools.partial(TSynth, length=4))
    try:
        res = t_main.run(t_main.parse_cfg(FLAGS + [
            "--device", "cpu", "--work_dir", str(tmp / "tr"), "--n_epochs",
            "1", "--save_interval", "1"]))
    finally:
        mp.undo()
    assert res["steps"] == 1
    engine = res["engine"]
    ckpt = str(tmp / "tr" / "epoch_1.ckpt")
    save_jax_checkpoint(engine, ckpt, meta=dict(epoch=1))
    jcfg = j_main.make_cfg(j_main.build_parser().parse_args(
        FLAGS + ["--work_dir", str(tmp / "j")]))
    je = j_build(jcfg, is_train=True, steps_per_epoch=1)
    ds = JSynth(length=4, height=H, width=W, num_classes=40, seed=jcfg.seed)
    loader = JLoader(ds, 4, shuffle=False, drop_last=False)
    sample = jax.tree.map(jnp.asarray, next(iter(loader)))
    abstract = jax.eval_shape(je.init_state, jax.random.PRNGKey(0), sample)
    return dict(engine=engine, ckpt=ckpt, pth=str(tmp / "tr" / "epoch_1.pth"),
                je=je, abstract=abstract, sample=sample, tmp=tmp)


def test_v1_ckpt_loads_into_the_jax_template(trained, interpret):
    """The JAX ``load_checkpoint`` fills the JAX driver's template (every
    key, shape and dtype; step int32 1), and the JAX forward from it equals
    the port's."""
    te = trained["engine"]
    state, meta = j_load(trained["abstract"], trained["ckpt"])
    assert meta == {"epoch": 1}
    assert _tree_spec(state) == _tree_spec(trained["abstract"])
    assert int(state.step) == te.n_step == 1
    r = np.random.RandomState(5)
    rgb = r.uniform(-1, 1, (2, 3, H, W)).astype(np.float32)
    raw = np.abs(r.normal(size=(2, 1, H, W))).astype(np.float32)
    want = trained["je"].forward_test(state, rgb=jnp.asarray(nhwc(rgb)),
                                      raw_depth=jnp.asarray(nhwc(raw)))
    with torch.no_grad():
        got = te.forward_test(rgb=torch.from_numpy(rgb),
                              raw_depth=torch.from_numpy(raw))
    for k in ("depth_map_1", "depth_map_2", "pred_depth"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]).transpose(0, 3, 1, 2),
            **FWD, err_msg=k)


def test_v1_ckpt_resumes_in_jax(trained, interpret):
    """The JAX ``resume_from`` gives epoch 1 and step 1; each optimizer's
    Adam moments equal the port's ``exp_avg`` / ``exp_avg_sq`` and its
    counts the port's step and schedule, bit for bit."""
    te = trained["engine"]
    state, epoch = j_resume(trained["abstract"], trained["ckpt"])
    assert epoch == 1 and int(state.step) == 1
    cfg = te.cfg
    for k, opt in te.optimizers.items():
        adam, sched = state.opt_states[k]
        assert int(sched.count) == te.schedulers[k].last_epoch == 1
        mod = te.modules[k]
        stats = _np_tree(state.batch_stats[k])
        wmu = convert.net_state_dict_from_jax(cfg, k, mod, _np_tree(adam.mu),
                                              stats)
        wnu = convert.net_state_dict_from_jax(cfg, k, mod, _np_tree(adam.nu),
                                              stats)
        n = 0
        for pn, p in mod.named_parameters():
            s = opt.state.get(p)
            if not s:
                # no JAX counterpart: the unused fuse_layer5 and the
                # frozen NLSPN dummies
                assert pn.startswith("core.fuse_layer5.") or pn.endswith(
                    ("prop_layer.w", "prop_layer.b", "prop_layer.w_conf")), pn
                continue
            assert int(adam.count) == int(s["step"]) == 1
            assert torch.equal(s["exp_avg"], wmu[pn]), (k, pn)
            assert torch.equal(s["exp_avg_sq"], wnu[pn]), (k, pn)
            n += 1
        assert n > 0


def test_jax_main_v1_serves_the_port_ckpt(trained, interpret, monkeypatch):
    """``tools/main_v1.py --inference --load_from epoch_1.ckpt`` (JAX)
    reports the port's 8 metrics; the port's driver reports the same
    metrics from the ``.ckpt`` as from its ``.pth``."""
    tmp = trained["tmp"]
    monkeypatch.setitem(T_DATASETS._entries, "synthetic",
                        functools.partial(TSynth, length=4))
    monkeypatch.setitem(J_DATASETS._entries, "synthetic",
                        functools.partial(JSynth, length=4))
    for src, name in ((trained["ckpt"], "ckpt"), (trained["pth"], "pth")):
        assert t_main.main(FLAGS + [
            "--device", "cpu", "--work_dir", str(tmp / f"t_{name}"),
            "--inference", "--load_from", src]) == 0
    got = _metrics(tmp / "t_ckpt" / "test.log")
    assert len(got) == 8 and got == _metrics(tmp / "t_pth" / "test.log")
    assert j_main.main(FLAGS + ["--work_dir", str(tmp / "j_inf"),
                                "--inference", "--load_from",
                                trained["ckpt"]]) == 0
    want = _metrics(tmp / "j_inf" / "train.log")
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], v, **FWD, err_msg=k)


def test_port_resumes_its_ckpt_as_its_pth(trained):
    """The port's ``resume_from`` of the ``.ckpt`` and of the ``.pth``
    restore the same nets, optimizer states, schedules and step, and
    ``load_checkpoint`` of the ``.ckpt`` the same served nets; the file's
    tree is the one the engine's converters give."""
    te = trained["engine"]
    backs = []
    for src in (trained["ckpt"], trained["pth"]):
        torch.manual_seed(7)
        back = t_build(te.cfg, is_train=True, steps_per_epoch=1)
        assert resume_from(back, src) == 1 and back.n_step == 1
        backs.append(back)
    a, b = backs
    for name, mod in a.modules.items():
        for (k, v), w in zip(mod.state_dict().items(),
                             b.modules[name].state_dict().values()):
            if not k.endswith("num_batches_tracked") and ".fuse_layer5." \
                    not in f".{k}":
                assert torch.equal(v, w), (name, k)
    for k, opt in a.optimizers.items():
        bopt = b.optimizers[k]
        for p, q in zip(opt.param_groups[0]["params"],
                        bopt.param_groups[0]["params"]):
            assert opt.state.get(p, {}).keys() == bopt.state.get(q, {}).keys()
            for sk, sv in opt.state.get(p, {}).items():
                assert torch.equal(sv, bopt.state[q][sk]), (k, sk)
        assert a.schedulers[k].last_epoch == b.schedulers[k].last_epoch
        assert opt.param_groups[0]["lr"] == bopt.param_groups[0]["lr"]
    serve = t_build(te.cfg, is_train=False)
    load_checkpoint(serve.modules, trained["ckpt"], cfg=te.cfg)
    for (k, v), w in zip(serve.modules["G"].state_dict().items(),
                         te.modules["G"].state_dict().values()):
        if not k.endswith("num_batches_tracked") and ".fuse_layer5." \
                not in k:
            assert torch.equal(v, w), k
    tree, _ = read_state(trained["ckpt"])
    for name, mod in te.modules.items():
        t = tc.net_tree_to_jax(te.cfg, name, mod, {
            k: v.numpy() for k, v in mod.state_dict().items()})
        assert _bits(sorted_tree(t["params"])) == _bits(
            tree["params"][name]), name
