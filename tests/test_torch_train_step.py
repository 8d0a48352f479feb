"""Parity of the port's RDFGAN training with the JAX package, on the CPU at
narrow widths: the PatchGAN, the train-mode BatchNorm, the learning-rate
schedules, the shuffled loader, whole train steps of the two engines from
the same weights, and ``python -m rdfc_gan_torch.train`` end to end.

Tolerances. Forwards: rtol 1e-3 / atol 1e-4, those of
``tests/test_ckpt_convert_flagship.py`` (f32 convolutions summed in another
order by XLA and ATen). Losses of a train step: rtol 1e-4. Gradients: each
tensor within 2e-4 of its largest entry plus 5e-6 (found within 3e-5 of
the largest entry; a conv bias in front of a BatchNorm has a gradient that
is zero in exact arithmetic and f32 noise of about 1e-6 on both sides).
The second step starts from parameters that already differ where Adam's
first step took opposite signs on the two sides (below), by 2 * lr, so its
gradients are held by each tensor's relative L2 error (< 1e-2, where the
largest entry is above 5e-4, 100 times the noise) and each entry within
2e-2 of the tensor's largest (seen: 0.7% under six pytest
workers, 0.013% alone).
Parameters after Adam: an Adam step moves a parameter by about
lr * g / (|g| + 1e-8), nearly lr * sign(g), so an entry whose gradient lies
inside the gradient tolerance may take the other sign on the other side and
is compared with atol 2 * lr * steps; every other entry within
2e-5 + 1e-5 |p|, plus a quarter of lr from the second step on, where
Adam's m / sqrt(v) mixes two gradients and turns their differences into a
share of the step (up to 8% of lr seen); a gradient of the wrong sign or
size would move a parameter by about lr. Running statistics: rtol 1e-4, atol 1e-5; the PatchGAN's
running means follow the conv bias in front of each BatchNorm (the G-loss
pass already sees the updated bias), so they get that bias's atol as
well.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rdfc_gan_torch.cli import parse_config as t_parse
from rdfc_gan_torch.config import default_config as t_default
from rdfc_gan_torch.data import DataLoader as TLoader
from rdfc_gan_torch.data import SyntheticDataset
from rdfc_gan_torch.engines import build_engine as t_build
from rdfc_gan_torch.engines.base import make_lr_factor_fn as t_factor
from rdfc_gan_torch.engines.base import make_optimizer as t_make_optimizer
from rdfc_gan_torch.models import PatchGANDiscriminator as TPatchGAN
from rdfc_gan_torch.models.layers import BatchNorm2d
from rdfc_gan_torch.utils.convert import (patchgan_state_dict_from_jax,
                                          rdf_generator_state_dict_from_jax)
from rdfc_gan_tpu.cli import parse_config as j_parse
from rdfc_gan_tpu.config import default_config as j_default
from rdfc_gan_tpu.data import DataLoader as JLoader
from rdfc_gan_tpu.engines import build_engine as j_build
from rdfc_gan_tpu.engines import make_lr_factor_fn as j_factor
from rdfc_gan_tpu.engines import make_optimizer as j_make_optimizer
from rdfc_gan_tpu.engines.base import GANTrainState
from rdfc_gan_tpu.models.discriminators import \
    PatchGANDiscriminator as JPatchGAN
from rdfc_gan_tpu.models.layers import BatchNorm as JBatchNorm
from rdfc_gan_tpu.utils.torch_convert import convert_rdf_generator

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_ckpt import convert_patchgan  # noqa: E402

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

FWD = dict(rtol=1e-3, atol=1e-4)
STATS = dict(rtol=1e-4, atol=1e-5)
D_CH = (8, 16, 16, 16, 1)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _nhwc(t):
    return jnp.asarray(t.detach().numpy().transpose(0, 2, 3, 1))


# ------------------------------------------------------------- PatchGAN --
def _random_patchgan_tree(seed):
    jd = JPatchGAN(out_channels=D_CH)
    v = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 32, 48, 1)),
                                       train=False))
    r = np.random.RandomState(seed)

    def fill(path, a):
        leaf = jax.tree_util.keystr(path)
        lo, hi = ((0.5, 1.5) if leaf.endswith("['scale']") or
                  leaf.endswith("['var']") else (-0.2, 0.2))
        return r.uniform(lo, hi, a.shape).astype(np.float32)

    return jd, jax.tree_util.tree_map_with_path(fill, dict(v))


@pytest.mark.parametrize("train", [False, True])
def test_patchgan_matches_jax_through_converter(train):
    jd, tree = _random_patchgan_tree(0)
    sd = patchgan_state_dict_from_jax(tree["params"], tree["batch_stats"])
    td = TPatchGAN(in_channels=1, out_channels=D_CH)
    td.load_state_dict(sd, strict=True)
    td.train(train)
    x = np.random.RandomState(1).normal(size=(2, 1, 32, 48)).astype(
        np.float32)
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    v = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    if train:
        want, mut = jd.apply(v, _nhwc(torch.from_numpy(x)), train=True,
                             mutable=["batch_stats"])
        back = patchgan_state_dict_from_jax(tree["params"],
                                            _np_tree(mut["batch_stats"]))
        for k, t in td.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), back[k].numpy(),
                                           **STATS, err_msg=k)
    else:
        want = jd.apply(v, _nhwc(torch.from_numpy(x)), train=False)
    assert got.shape == (2, 1, 2, 4)
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want)[..., 0],
                               **FWD)


def test_patchgan_converters_are_inverse_and_reference_named():
    from torch_ref_models import TorchPatchGAN

    ref = TorchPatchGAN(out_channels=D_CH)
    port = TPatchGAN(out_channels=D_CH)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    port.load_state_dict(ref.state_dict(), strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    tree = convert_patchgan(sd)
    back = patchgan_state_dict_from_jax(tree["params"], tree["batch_stats"])
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


# -------------------------------------------- BatchNorm, fault 2 repaired --
def test_batchnorm_running_update_is_biased_as_jax():
    """Two values per channel: torch's own BatchNorm2d would put the
    unbiased variance, twice the biased one, into running_var."""
    x = np.random.RandomState(2).normal(size=(2, 3, 1, 1)).astype(
        np.float32) * 3.0
    bn = BatchNorm2d(3, eps=1e-5).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    y = bn(torch.from_numpy(x))
    jb = JBatchNorm(momentum=0.9, epsilon=1e-5)
    params = {"scale": jnp.asarray(bn.weight.detach().numpy()),
              "bias": jnp.asarray(bn.bias.detach().numpy())}
    stats = {"mean": jnp.zeros(3), "var": jnp.ones(3)}
    want, mut = jb.apply({"params": params, "batch_stats": stats},
                         _nhwc(torch.from_numpy(x)), mutable=["batch_stats"])
    np.testing.assert_allclose(y.detach().numpy()[..., 0, 0],
                               np.asarray(want)[:, 0, 0], **FWD)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               **STATS)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), **STATS)
    biased = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * biased,
                               rtol=1e-5)
    plain = torch.nn.BatchNorm2d(3, eps=1e-5).train()
    plain(torch.from_numpy(x))
    np.testing.assert_allclose(plain.running_var.numpy(), 0.9 + 0.2 * biased,
                               rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1


# ------------------------------------------------------------ schedules --
SCHEDULES = {
    "linear": dict(epoch=1, decay_epoch=4, n_epochs=10),
    "step": dict(lr_decay_epochs=[3, 6], lr_decay_rate=0.1),
    "cosine": dict(n_epochs=10),
    "onecycle": dict(n_epochs=10, div_factor=25.0, pct_start=0.3,
                     final_div_factor=1e4),
    "lambda": dict(lambda_lr_decay=[2, 5], lambda_lr_gamma=[1.0, 0.5, 0.1]),
}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_lr_factor_matches_jax(sched):
    tcfg, jcfg = t_default(), j_default()
    for cfg in (tcfg, jcfg):
        cfg.merge(dict(scheduler=sched, **SCHEDULES[sched]))
    tf, jf = t_factor(tcfg), j_factor(jcfg)
    for e in range(12):
        np.testing.assert_allclose(tf(float(e)),
                                   float(jf(jnp.asarray(float(e)))),
                                   rtol=1e-6, atol=1e-7, err_msg=f"{e}")


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd", "rmsprop"])
def test_optimizer_steps_match_optax_with_warm_up(kind):
    """Five updates of one parameter vector under a per-step schedule with
    warm-up: the port's optimizer and LambdaLR against the JAX package's
    optax chain, step for step (2 steps an epoch; adamw with decay 0.01)."""
    over = dict(optimizer=kind, lr=1e-2, warm_up=True, warm_up_lr=1e-4,
                warm_up_steps=1, scheduler="linear", epoch=0,
                decay_epoch=1, n_epochs=4)
    tcfg, jcfg = t_default(), j_default()
    for cfg in (tcfg, jcfg):
        cfg.merge(over)
    r = np.random.RandomState(3)
    p0 = r.normal(size=(6,)).astype(np.float32)
    grads = r.normal(size=(5, 6)).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = t_make_optimizer(tcfg, [p], steps_per_epoch=2,
                                  weight_decay=0.01)
    tx = j_make_optimizer(jcfg, 2, weight_decay=0.01)
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-6)


def test_clip_grad_matches_optax_global_norm():
    """clip_grad: the global-norm clip ahead of the optimizer (torch adds
    1e-6 to the norm, so rtol 1e-5 for gradients of norm ~10)."""
    from rdfc_gan_torch.engines.base import clip_gradients

    cfg = t_default()
    cfg.merge(dict(clip_grad=True, max_norm=1.0))
    r = np.random.RandomState(4)
    gs = [r.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(ps, gs):
        p.grad = torch.from_numpy(g.copy())
    clip_gradients(cfg, ps)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    for p, w in zip(ps, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-5)


# --------------------------------------------------------------- loader --
def test_train_loader_order_matches_jax():
    ds = SyntheticDataset(length=23, height=4, width=6)
    t = TLoader(ds, 4, shuffle=True, drop_last=True, seed=5)
    j = JLoader(ds, 4, shuffle=True, drop_last=True, seed=5)
    assert len(t) == len(j) == 5
    for epoch in range(3):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        np.testing.assert_array_equal(t.indices(), j._indices())
    rows = [b["sample_idx"].numpy() for b in t]
    np.testing.assert_array_equal(np.concatenate(rows), j._indices()[:20])


# ---------------------------------------------------- the RDFGAN step --
TINY = """\
model:
  type: RDFGAN
  G:
    type: RDFGenerator
    rgb_channels_encoder: [8, 8, 8, 8, 8, 8]
    depth_channels_encoder: [8, 8, 8, 8, 8, 8]
    rgb_channels_decoder: [8, 8, 8, 8]
    depth_channels_decoder: [8, 8, 8, 8]
    use_nlspn_refine: true
    nlspn_configs: {prop_kernel: 3, prop_time: 3, affinity: TGASS,
                    affinity_gamma: 0.5, conf_prop: true,
                    preserve_input: false}
  D:
    type: PatchGANDiscriminator
    in_channels: 1
    out_channels: [8, 16, 16, 16, 1]
compute_dtype: float32
"""


def _recording(tx):
    """An optax transformation that also keeps the last gradient in its
    state, so a jitted JAX step hands its gradients back."""
    def init(p):
        return tx.init(p), jax.tree.map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, inner = tx.update(g, s[0], p)
        return u, (inner, g)

    return optax.GradientTransformation(init, update)


def _engines(tmp_path, gan_loss):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY)
    args = ["--dataset", "synthetic", "--model_cfg_path", str(cfg_path),
            "--work_dir", str(tmp_path / "w"), "--gan_loss_type", gan_loss]
    # D keeps torch's default init, drawn from the global generator: seed
    # it, or the two-step comparison depends on which tests ran before in
    # the process (some draws put a BN gradient past its bound)
    torch.manual_seed(0)
    te = t_build(t_parse(args + ["--device", "cpu"]), is_train=True,
                 steps_per_epoch=4)
    G, D = te.modules["G"], te.modules["D"]
    torch.manual_seed(0)
    with torch.no_grad():
        for n, p in G.named_parameters():
            if not n.endswith(("aff_scale_const", ".w", ".b", ".w_conf")):
                p.uniform_(-0.15, 0.15)
        oa = G.nlspn_refine_module.prop_layer.conv_offset_aff
        oa.weight.uniform_(-0.1, 0.1)
        oa.bias.uniform_(-0.5, 0.5)
    # copies: JAX may alias a numpy buffer, which the port's optimizer
    # then updates in place
    gt = convert_rdf_generator({k: v.numpy().copy() for k, v in
                                G.state_dict().items()},
                               use_nlspn_refine=True)
    dt = convert_patchgan({k: v.numpy().copy()
                           for k, v in D.state_dict().items()})
    je = j_build(j_parse(args), is_train=True, steps_per_epoch=4)
    je.optimizers = {k: _recording(v) for k, v in je.optimizers.items()}
    params = {"G": jax.tree.map(jnp.asarray, gt["params"]),
              "D": jax.tree.map(jnp.asarray, dt["params"])}
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats={"G": jax.tree.map(jnp.asarray, gt["batch_stats"]),
                     "D": jax.tree.map(jnp.asarray, dt["batch_stats"])},
        opt_states={k: je.optimizers[k].init(params[k]) for k in params})
    return te, je, state


def _batches(n):
    ds = SyntheticDataset(length=8, height=32, width=48)
    for i in range(n):
        smp = [ds[2 * i], ds[2 * i + 1]]
        nb = {k: np.stack([s[k] for s in smp]) for k in smp[0]}
        tb = {k: torch.from_numpy(v.copy()).permute(0, 3, 1, 2).contiguous()
              if v.ndim == 4 else torch.from_numpy(v.copy())
              for k, v in nb.items()}
        yield tb, {k: jnp.asarray(v) for k, v in nb.items()}


def _grad_atol(want, step):
    return (2e-4 if step == 0 else 2e-2) * np.abs(want).max() + 5e-6


def _assert_grads(module, jgrads, to_sd, stats, step):
    want_sd = to_sd(_np_tree(jgrads), _np_tree(stats))
    n = 0
    for name, p in module.named_parameters():
        if name not in want_sd or not p.requires_grad:
            continue
        want = want_sd[name].numpy()
        got = (np.zeros_like(want) if p.grad is None else p.grad.numpy())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_grad_atol(want, step),
                                   err_msg=f"grad {name}")
        if step and np.abs(want).max() > 5e-4:  # not the noise-only biases
            rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel_l2 < 1e-2, (name, rel_l2)
        n += 1
    assert n > 10


def _assert_state(module, jparams, jstats, jgrads, to_sd, lr, steps):
    want_sd = to_sd(_np_tree(jparams), _np_tree(jstats))
    grad_sd = to_sd(_np_tree(jgrads), _np_tree(jstats))
    for name, t in module.state_dict().items():
        if name not in want_sd or name.endswith("num_batches_tracked"):
            continue
        got, want = t.numpy(), want_sd[name].numpy()
        if "running" in name:
            extra = 0.0
            if name.startswith("model.") and name.endswith("running_mean"):
                extra = 2 * lr * steps
            np.testing.assert_allclose(got, want, rtol=STATS["rtol"],
                                       atol=STATS["atol"] + extra,
                                       err_msg=name)
            continue
        g = grad_sd[name].numpy()
        loose = np.abs(g) <= _grad_atol(g, steps - 1)
        atol = np.where(loose, 2 * lr * steps,
                        2e-5 + 0.25 * lr * (steps - 1) + 1e-5 * np.abs(want))
        assert (np.abs(got - want) <= atol).all(), (
            name, float(np.abs(got - want).max()))


@pytest.mark.parametrize("gan_loss,update_g,steps",
                         [("lsgan", True, 2), ("wgangp", False, 1)])
def test_rdfgan_steps_match_jax(tmp_path, gan_loss, update_g, steps):
    te, je, state = _engines(tmp_path, gan_loss)
    step = jax.jit(je._train_step_impl, static_argnames=("update_g",))
    G, D = te.modules["G"], te.modules["D"]
    lr = te.cfg.lr
    for i, (tb, jb) in enumerate(_batches(steps)):
        key = jax.random.PRNGKey(10 + i)
        # the gradient penalty's draw, as jax's gradient_penalty makes it
        eps = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))
        state_before = state
        got = te.train_step(tb, update_g=update_g,
                            gp_eps=torch.from_numpy(eps.copy()))
        state, want = step(state, jb, key, update_g=update_g)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        jgrad_d = state.opt_states["D"][1]
        _assert_grads(D, jgrad_d, patchgan_state_dict_from_jax,
                      state_before.batch_stats["D"], i)
        _assert_state(D, state.params["D"], state.batch_stats["D"], jgrad_d,
                      patchgan_state_dict_from_jax, lr, i + 1)
        jgrad_g = state.opt_states["G"][1]
        if update_g:
            _assert_grads(G, jgrad_g, rdf_generator_state_dict_from_jax,
                          state_before.batch_stats["G"], i)
        else:  # G keeps its parameters but its BN statistics move
            assert all(p.grad is None for p in G.parameters())
        _assert_state(G, state.params["G"], state.batch_stats["G"], jgrad_g,
                      rdf_generator_state_dict_from_jax, lr, i + 1)
    assert te.n_step == steps


# -------------------------------------------------- the CLI entry point --
def _logged(path, key):
    vals = re.findall(rf"INFO {re.escape(key)}: ([-+0-9.eE]+)",
                      path.read_text())
    assert vals, f"{key} not in {path}"
    return float(vals[-1])


def test_train_cli_one_epoch_then_serve(tmp_path):
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_tpu.metrics import METRIC_NAMES

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY.replace("compute_dtype: float32\n", ""))
    common = ["--dataset", "synthetic", "--model_cfg_path", str(cfg_path),
              "--out_height", "32", "--out_width", "48", "--batch_size",
              "8", "--num_workers", "2", "--device", "cpu"]
    assert port_train.main(common + [
        "--work_dir", str(tmp_path / "tr"), "--n_epochs", "1",
        "--log_interval", "3", "--save_interval", "1",
        "--start_eval_epoch", "0"]) == 0
    log = tmp_path / "tr" / "train.log"
    text = log.read_text()
    # 8 steps, logged at 3 and 6 and the trailing window at the epoch end
    assert len(re.findall(r"epoch 0 iter \d+ ", text)) == 3
    assert (tmp_path / "tr" / "epoch_1.pth").exists()
    ckpt = torch.load(tmp_path / "tr" / "best.pth", weights_only=True)
    # the reference schema: each net, each optimizer's and scheduler's
    # state (what --resume_from reads), meta
    assert set(ckpt) == {f"{k}_{e}state_dict" for k in ("G", "D")
                         for e in ("", "optimizer_", "lr_scheduler_")} \
        | {"meta"}
    assert ckpt["meta"]["epoch"] == 1
    assert port_test.main(common + ["--work_dir", str(tmp_path / "te"),
                                    "--load_from",
                                    str(tmp_path / "tr" / "best.pth")]) == 0
    for k in METRIC_NAMES:
        assert _logged(tmp_path / "te" / "test.log", k) == \
            _logged(log, k), k
