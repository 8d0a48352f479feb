"""The flagship's train step against the JAX package, on the CPU: one
``RDFCGAN.train_step`` under ``configs/rdfc_gan_tiny.yaml`` at 32x48,
batch 2, f32, from the same weights (all six nets) and with JAX's draws
handed in (the
pepper noise's uniforms, recomputed from the split of the step key, and
G_label's dropout keep masks, read from its Dropout layers); the Nor
optimizer's decay against optax's adamw; and ``python -m
rdfc_gan_torch.train`` on the tiny flagship, then ``rdfc_gan_torch.test``
serving its ``best.pth``.

The port's engine initialises the six nets from a torch seed; the JAX
package's converters (reference schema -> Flax) give the JAX step the same
weights, and the port's converters must take them back bit for bit. The
JAX step is built and run once, jitted without remat and W-packing.

Tolerances. The 23 losses: rtol 1e-4 (tests/test_torch_train_step.py).
The running statistics: the forward tolerance of the port tests, rtol 1e-3
/ atol 1e-4 (the PatchGANs' means also 2 lr: they follow the conv bias in
front of each BatchNorm). Gradients:
this step is ill-conditioned at batch 2 and 32x48, where BatchNorms
normalise over 2 values (the PSP module's 1x1 bin), 4 (the 1x2 maps at
the bottom of NNET and of G_A2B's encoders) or 12 (2x3): they turn the
last-bit differences of their inputs into percent-level differences of
the gradients below them (G_label alone, with the same dropout masks,
differs from JAX by 0.8% in its 1x1 bin conv; the port against itself
with the BatchNorm variance summed another way by 1e-4). So each gradient
tensor is held by its relative L2 error (< 0.2; seen up to 5.6e-2, in
G_A2B's encoder) and each net's whole gradient (< 0.06; seen 1.8e-2 for
G_A2B, 1.3e-2 for G_label, 3e-3 or less for the others); a tensor whose
JAX gradient lies below 1e-4 of the net's largest entry is zero in exact
arithmetic (a bias or BN scale in front of a norm) and both sides must be
noise within 1e-5 of that entry (seen 2e-6). A wrong term, weight or
input moves a gradient by tens of percent. The parameters after the
update: where the two gradients agree to 10%, Adam's update agrees, so
within 2e-5 + 1e-5 |p|; elsewhere within 2 lr (and rounding).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rdfc_gan_torch.cli import parse_config as t_parse
from rdfc_gan_torch.engines import build_engine as t_build
from rdfc_gan_torch.engines.base import make_optimizer as t_make_optimizer
from rdfc_gan_torch.utils import convert
from rdfc_gan_tpu.cli import parse_config as j_parse
from rdfc_gan_tpu.engines import build_engine as j_build
from rdfc_gan_tpu.engines import make_optimizer as j_make_optimizer
from test_torch_train_step import _np_tree, _recording

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 32, 48, 2
NETS = ("G_A2B", "G_B2A", "disc_A", "disc_B", "G_normal", "G_label")
G_KEYS = ("loss_G", "loss_G_A2B", "loss_G_B2A", "loss_A2B_L1", "loss_B2A_L1",
          "loss_cycle_A", "loss_cycle_B", "loss_label_A2B", "loss_label_B2A",
          "loss_normal_A2B", "loss_normal_B2A", "floor_loss_A2B",
          "wall_loss_A2B", "ceiling_loss_A2B", "floor_loss_B2A",
          "wall_loss_B2A", "ceiling_loss_B2A")
D_KEYS = ("loss_D_A", "loss_D_A_real", "loss_D_A_fake", "loss_D_B",
          "loss_D_B_real", "loss_D_B_fake")


def _args(tmp_path):
    return ["--dataset", "synthetic", "--model_cfg_path",
            os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml"),
            "--work_dir", str(tmp_path / "w"), "--out_height", str(H),
            "--out_width", str(W), "--batch_size", str(B)]


def _batch():
    from rdfc_gan_torch.data import SyntheticDataset

    ds = SyntheticDataset(length=4, height=H, width=W, seed=3)
    smp = [ds[0], ds[1]]
    nb = {k: np.stack([s[k] for s in smp]) for k in smp[0]}
    tb = {k: torch.from_numpy(v.copy()).permute(0, 3, 1, 2).contiguous()
          if v.ndim == 4 else torch.from_numpy(v.copy())
          for k, v in nb.items()}
    return tb, {k: jnp.asarray(v) for k, v in nb.items()}


def _dropout_keeps(je, params, stats, x, rng_drop):
    """The keep masks of G_label's two Dropout layers under ``rng_drop``,
    as the JAX step draws them (one apply of the same module with the same
    dropout key): a channel is kept where its output plane is not all
    zero (a plane that is zero before the dropout is zero either way)."""
    import flax.linen as nn

    outs = []

    def grab(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if isinstance(ctx.module, nn.Dropout) and ctx.method_name == \
                "__call__":
            outs.append(np.asarray(out))
        return out

    with nn.intercept_methods(grab):
        je.modules["G_label"].apply(
            {"params": params, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"], rngs={"dropout": rng_drop})
    assert len(outs) == 2
    return tuple(torch.from_numpy((o != 0).any(axis=(1, 2)))[:, :, None,
                                                             None]
                 for o in outs)


def _to_sd(net, cfg):
    """(params or grads, batch_stats) numpy trees of ``net`` -> the port's
    state dict."""
    depth = cfg.model.Normal_G.depth
    return {
        "G_A2B": lambda p, s: convert.rdf_generator_state_dict_from_jax(
            p, s, use_nlspn_refine=False),
        "G_B2A": lambda p, s: convert.resnet_generator_state_dict_from_jax(
            p),
        "disc_A": convert.patchgan_state_dict_from_jax,
        "disc_B": convert.patchgan_state_dict_from_jax,
        "G_normal": lambda p, s: convert.nnet_state_dict_from_jax(p, s,
                                                                  depth),
        "G_label": convert.pspnet_state_dict_from_jax,
    }[net]


# tensors whose JAX gradient is below this share of the net's largest
# gradient entry are zero in exact arithmetic (a conv bias or a BN scale in
# front of a norm that removes it): rounding noise on both sides
NOISE = 1e-4


def _assert_grads(module, want_sd, name, skip=()):
    """The port's gradients of ``module`` against JAX's (a state dict).
    Returns the names of the tensors checked."""
    tens = {}
    for k, p in module.named_parameters():
        if k in want_sd and not k.startswith(skip):
            want = want_sd[k].numpy()
            tens[k] = (np.zeros_like(want) if p.grad is None
                       else p.grad.numpy(), want)
    top = max(np.abs(w).max() for _, w in tens.values())
    num = den = 0.0
    for k, (got, want) in tens.items():
        if np.abs(want).max() < NOISE * top:
            assert max(np.abs(got).max(), np.abs(want).max()) \
                <= 1e-5 * top, f"{name} {k}: not noise-level"
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 0.2, f"{name} grad {k}: relative L2 {rel:.3e}"
        num += float(np.sum((got - want) ** 2))
        den += float(np.sum(want ** 2))
    assert (num / den) ** 0.5 < 0.06, f"{name}: whole-gradient relative L2"
    return tens


def _assert_params(module, want_sd, grads, lr):
    """The parameters after the update: Adam moves an entry by about lr
    times the sign of its gradient, so where the two gradients agree to 10%
    the new values agree to rounding; elsewhere they may differ by 2 lr."""
    for k, p in module.named_parameters():
        if k not in want_sd:
            continue
        got, want = p.detach().numpy(), want_sd[k].numpy()
        g = grads.get(k)
        loose = (np.ones(got.shape, bool) if g is None
                 else np.abs(g[0] - g[1]) >= 0.1 * np.abs(g[1]))
        atol = np.where(loose, 2.01 * lr, 2e-5 + 1e-5 * np.abs(want))
        assert (np.abs(got - want) <= atol).all(), (
            k, float(np.abs(got - want).max()))


def _jax_trees(te):
    """The port's six nets -> the JAX package's (params, batch_stats)
    trees, through its own converters from the reference schema."""
    import sys

    from rdfc_gan_tpu.utils.torch_convert import (convert_nnet,
                                                  convert_pspnet,
                                                  convert_rdf_generator)

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from convert_torch_ckpt import convert_patchgan, convert_resnet_generator

    sd = {k: {n: v.numpy().copy() for n, v in m.state_dict().items()}
          for k, m in te.modules.items()}
    ncfg = te.cfg.model.Normal_G
    trees = {
        "G_A2B": convert_rdf_generator(sd["G_A2B"], use_nlspn_refine=False),
        "G_B2A": convert_resnet_generator(
            sd["G_B2A"], n_blocks=te.cfg.model.G_B2A.n_blocks),
        "disc_A": convert_patchgan(sd["disc_A"]),
        "disc_B": convert_patchgan(sd["disc_B"]),
        "G_normal": convert_nnet(sd["G_normal"], width=ncfg.width,
                                 depth=ncfg.depth),
        "G_label": convert_pspnet(sd["G_label"])}
    return ({k: v["params"] for k, v in trees.items()},
            {k: v.get("batch_stats", {}) for k, v in trees.items()})


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """One JAX step and one port step from the same weights, batch and
    draws. Returns (port engine, JAX state before and after, JAX losses,
    port losses, config, draws)."""
    from rdfc_gan_tpu.engines.base import GANTrainState

    tmp_path = tmp_path_factory.mktemp("rdfc_step")
    args = _args(tmp_path)
    cfg = t_parse(args + ["--device", "cpu"])
    torch.manual_seed(0)
    te = t_build(cfg, is_train=True, steps_per_epoch=4)
    params, stats = _jax_trees(te)
    # the port's converters take the JAX trees back to the same weights
    sds = convert.rdfcgan_state_dicts_from_jax(
        params, stats, normal_depth=cfg.model.Normal_G.depth)
    assert set(sds) == set(NETS)
    for k in NETS:
        mine = te.modules[k].state_dict()
        for n, v in sds[k].items():
            np.testing.assert_array_equal(v.numpy(), mine[n].numpy(),
                                          err_msg=f"{k}.{n}")
        assert all(n.startswith("fuse_layer5.") for n in set(mine) - set(
            sds[k])), k

    # f32, no remat and no W-packing (a TPU layout, exact): the jitted step
    # then compiles in about 90 s on the CPU instead of about 180 s
    jcfg = j_parse(args)
    jcfg.merge(dict(compute_dtype="float32", donate=False, remat=False))
    for k in ("G_A2B", "G_B2A", "D_A", "D_B"):
        jcfg.model[k]["packed_width"] = False
    je = j_build(jcfg, is_train=True, steps_per_epoch=4)
    je.optimizers = {k: _recording(v) for k, v in je.optimizers.items()}
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    groups = {"G": {k: params[k] for k in ("G_A2B", "G_B2A")},
              "D": {k: params[k] for k in ("disc_A", "disc_B")},
              "Nor": params["G_normal"], "label": params["G_label"]}
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_states={k: je.optimizers[k].init(v) for k, v in groups.items()})
    tb, jb = _batch()
    key = jax.random.PRNGKey(10)
    # JAX's draws: the pepper noise (image_ops.py:20-25) and the dropout
    # key from the step key's split (rdfc_gan.py:212)
    rng_pepper, rng_drop = jax.random.split(key)
    k_active, k_mask = jax.random.split(rng_pepper)
    active = float(jax.random.uniform(k_active))
    u = np.asarray(jax.random.uniform(k_mask, (B, H, W, 1)))
    keep = _dropout_keeps(je, params["G_label"], stats["G_label"],
                          jb["rgb"], rng_drop)
    draws = dict(pepper=(torch.tensor(active),
                         torch.from_numpy(u.transpose(0, 3, 1, 2).copy())),
                 keep=keep)
    got = te.train_step(tb, draws=draws)
    new_state, want = jax.jit(je._train_step_impl)(state, jb, key)
    want = {k: float(v) for k, v in want.items()}
    return te, state, new_state, want, got, cfg, draws


def test_flagship_step_losses_match_jax(stepped):
    te, _, _, want, got, _, draws = stepped
    assert sorted(got) == sorted(G_KEYS + D_KEYS) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # the draws did something: the noise was on and a channel was dropped
    assert float(draws["pepper"][0]) < 0.9
    assert not all(bool(k.all()) for k in draws["keep"])
    assert te.n_step == 1


@pytest.mark.parametrize("net", NETS)
def test_flagship_step_grads_and_state_match_jax(stepped, net):
    """The gradient each optimizer received for ``net``, then its
    parameters after the update and its running statistics (G_A2B's
    advanced twice, the discs' three times in the step)."""
    te, state, new_state, _, _, cfg, _ = stepped
    opt = {"G_A2B": "G", "G_B2A": "G", "G_normal": "Nor",
           "G_label": "label", "disc_A": "D", "disc_B": "D"}[net]
    jg = new_state.opt_states[opt][1]
    if opt in ("G", "D"):
        jg = jg[net]
    to_sd = _to_sd(net, cfg)
    mod = te.modules[net]
    # the JAX NNET has no bn2 (its decoder never reads it): the converter
    # gives it identity values, and neither side moves it
    grads = _assert_grads(mod, to_sd(_np_tree(jg), _np_tree(
        state.batch_stats[net])), net, skip=("encoder.original_model.bn2.",))
    assert len(grads) >= 8
    lr = cfg.lr * (0.5 if opt == "Nor" else 1.0)
    _assert_params(mod, to_sd(_np_tree(new_state.params[net]),
                              _np_tree(new_state.batch_stats[net])),
                   grads, lr)
    # the running statistics, forward quantities: the forward tolerance
    stats_only = {k: v for k, v in mod.state_dict().items()
                  if "running" in k}
    want_sd = to_sd(_np_tree(new_state.params[net]),
                    _np_tree(new_state.batch_stats[net]))
    for k, v in stats_only.items():
        extra = 2 * lr if net.startswith("disc") and k.endswith(
            "running_mean") else 0.0
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=1e-3,
                                   atol=1e-4 + extra, err_msg=f"{net} {k}")
    if net in ("G_A2B", "G_normal", "G_label", "disc_A"):
        assert stats_only, net
        tracked = {k: int(v) for k, v in mod.state_dict().items()
                   if k.endswith("num_batches_tracked")}
        n = {"G_A2B": 2, "G_normal": 2, "G_label": 2, "disc_A": 3}[net]
        assert set(tracked.values()) <= {0, n} and n in tracked.values()


def test_nor_optimizer_decay_matches_optax():
    """The Nor optimizer, torch's AdamW at 0.5 lr with the config's decay,
    against the JAX package's optax.adamw: the decoupled decay is scaled
    by the same halved rate (three updates of one parameter vector; the
    tolerance of tests/test_torch_train_step.py's optimizer test)."""
    from rdfc_gan_torch.config import default_config as t_default
    from rdfc_gan_tpu.config import default_config as j_default

    tcfg, jcfg = t_default(), j_default()
    for c in (tcfg, jcfg):
        c.merge(dict(lr=0.05, weight_decay=0.3))
    r = np.random.RandomState(5)
    p0 = r.normal(size=(7,)).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = t_make_optimizer(tcfg, [p], 4, lr_mult=0.5, kind="adamw",
                                  weight_decay=tcfg.weight_decay)
    tx = j_make_optimizer(jcfg, 4, lr_mult=0.5, kind="adamw",
                          weight_decay=jcfg.weight_decay)
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    for g in r.normal(size=(3, 7)).astype(np.float32):
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-6)
    assert opt.param_groups[0]["weight_decay"] == 0.3
    assert opt.param_groups[0]["lr"] == pytest.approx(0.025)


def _logged(path, key):
    vals = re.findall(rf"INFO {re.escape(key)}: ([-+0-9.eE]+)",
                      path.read_text())
    assert vals, f"{key} not in {path}"
    return float(vals[-1])


def test_train_cli_flagship_then_serve(tmp_path):
    """``python -m rdfc_gan_torch.train --device cpu`` on the tiny flagship
    for 2 steps and an evaluation, writing all six nets; then
    ``rdfc_gan_torch.test`` serves its ``best.pth`` to the same metrics."""
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_tpu.metrics import METRIC_NAMES

    common = ["--dataset", "synthetic", "--model_cfg_path",
              os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml"),
              "--out_height", str(H), "--out_width", str(W),
              "--batch_size", "32", "--num_workers", "2", "--device", "cpu"]
    assert port_train.main(common + [
        "--work_dir", str(tmp_path / "tr"), "--n_epochs", "1",
        "--log_interval", "1", "--start_eval_epoch", "0"]) == 0
    log = tmp_path / "tr" / "train.log"
    text = log.read_text()
    # the synthetic train split has 64 images: 2 steps of 32
    assert len(re.findall(r"epoch 0 iter \d+ ", text)) == 2
    for k in G_KEYS + D_KEYS:
        assert f" {k}=" in text, k
    ckpt = torch.load(tmp_path / "tr" / "best.pth", weights_only=True)
    # the reference schema: the six nets, the four optimizers' and
    # schedulers' state (what --resume_from reads), meta
    assert set(ckpt) == {f"{k}_state_dict" for k in NETS} | {
        f"{k}_{e}_state_dict" for k in ("G", "D", "Nor", "label")
        for e in ("optimizer", "lr_scheduler")} | {"meta"}
    assert port_test.main(common + ["--work_dir", str(tmp_path / "te"),
                                    "--load_from",
                                    str(tmp_path / "tr" / "best.pth")]) == 0
    served = tmp_path / "te" / "test.log"
    if not served.exists():
        served = next((tmp_path / "te").glob("*.log"))
    for k in METRIC_NAMES:
        assert _logged(served, k) == _logged(log, k), k
