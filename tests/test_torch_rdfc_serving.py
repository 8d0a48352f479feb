"""The flagship's serving slice against the JAX package, on the CPU:
``RDFCGAN.forward_test`` (G_label -> G_normal -> norm_normalize -> G_A2B)
under ``configs/rdfc_gan_tiny.yaml`` at 32x48, with and without
``depth_only``, then ``python -m rdfc_gan_torch.test`` on a six-net
reference-schema checkpoint against the JAX evaluator's 8 metrics.

The JAX side initialises only the three nets that serving reads (in eval
mode, so G_label has no aux head) and their trees go through
``rdfcgan_state_dicts_from_jax`` into the port. Tolerance rtol 1e-3 /
atol 1e-4, as the other port parity tests.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.cli import parse_config
from rdfc_gan_torch.engines import build_engine
from rdfc_gan_torch.test import main
from rdfc_gan_torch.utils.checkpoint import save_checkpoint
from rdfc_gan_torch.utils.convert import rdfcgan_state_dicts_from_jax
from rdfc_gan_tpu.metrics import METRIC_NAMES
from test_torch_normal_net import randomize_norms

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 32, 48, 3
SERVED = ("G_A2B", "G_normal", "G_label")


def _args(tmp_path):
    return ["--dataset", "synthetic", "--model_cfg_path",
            os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml"),
            "--work_dir", str(tmp_path / "work"), "--out_height", str(H),
            "--out_width", str(W), "--batch_size", str(B),
            "--num_workers", "2"]


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX engine, its three served nets' (params, batch_stats) with
    drawn norm leaves, the port's engine holding the same weights, and the
    CLI args."""
    from rdfc_gan_tpu.cli import parse_config as jax_parse_config
    from rdfc_gan_tpu.engines import build_engine as jax_build_engine

    tmp_path = tmp_path_factory.mktemp("rdfc")
    args = _args(tmp_path)
    jeng = jax_build_engine(jax_parse_config(args), is_train=False)
    x = jnp.zeros((B, H, W, 3))
    d = jnp.zeros((B, H, W, 1))
    inputs = {"G_A2B": (x, d, x), "G_normal": (x,), "G_label": (x,)}
    params, stats = {}, {}
    for i, k in enumerate(SERVED):
        p, s = jeng._init_net(jax.random.PRNGKey(i), k, *inputs[k],
                              train=False)
        scale = (0.3, 0.6) if k == "G_label" else (0.8, 1.2)
        params[k] = randomize_norms(p, 10 + i, scale=scale)
        stats[k] = randomize_norms(s, 20 + i)

    cfg = parse_config(args + ["--device", "cpu"])
    teng = build_engine(cfg, is_train=False)
    sds = rdfcgan_state_dicts_from_jax(params, stats,
                                       normal_depth=cfg.model.Normal_G.depth)
    left = {k: teng.modules[k].load_state_dict(sds[k], strict=False)
            for k in SERVED}
    # the JAX trees hold neither the never-used fuse_layer5 nor, in eval
    # mode, G_label's aux head
    assert {k for k in left["G_A2B"].missing_keys} == {
        "fuse_layer5.style.linear.weight_orig",
        "fuse_layer5.style.linear.bias"}
    assert not left["G_normal"].missing_keys
    assert all(k.startswith("auxiliary_branch.")
               for k in left["G_label"].missing_keys)
    assert not any(v.unexpected_keys for v in left.values())
    return jeng, params, stats, teng, args, tmp_path


def _batch(seed):
    r = np.random.RandomState(seed)
    rgb = r.uniform(-1, 1, (B, 3, H, W)).astype(np.float32)
    raw = (r.normal(size=(B, 1, H, W)) * (r.uniform(size=(B, 1, H, W))
                                          > 0.6)).astype(np.float32)
    return rgb, raw


def _served(tree, depth_only):
    """The subtrees that serving reads: without G_label for depth_only."""
    return {k: tree[k] for k in SERVED if not (depth_only and k == "G_label")}


@pytest.mark.parametrize("depth_only", [False, True])
def test_forward_test_matches_jax(flagship, depth_only):
    jeng, params, stats, teng, _, _ = flagship
    rgb, raw = _batch(0)
    want = jeng._forward_test(_served(params, depth_only),
                              _served(stats, depth_only),
                              jnp.asarray(rgb.transpose(0, 2, 3, 1)),
                              jnp.asarray(raw.transpose(0, 2, 3, 1)),
                              depth_only=depth_only)
    got = teng.forward_test(rgb=torch.from_numpy(rgb),
                            raw_depth=torch.from_numpy(raw),
                            depth_only=depth_only)
    assert set(got) == set(want)
    assert ("pred_label" in got) != depth_only
    for k, v in got.items():
        np.testing.assert_allclose(
            v.numpy(), np.asarray(want[k]).transpose(0, 3, 1, 2),
            rtol=1e-3, atol=1e-4, err_msg=k)
    assert tuple(got["pred_depth"].shape) == (B, 1, H, W)
    assert tuple(got["pred_normal"].shape) == (B, 3, H, W)


def _logged(log_path, key):
    vals = re.findall(rf"INFO {re.escape(key)}: ([-+0-9.eE]+)",
                      log_path.read_text())
    assert vals, f"{key} not in {log_path}"
    return float(vals[-1])


@pytest.mark.parametrize("depth_only", [False, True])
def test_test_driver_serves_six_net_checkpoint(flagship, depth_only):
    """``rdfc_gan_torch.test`` loads its three nets from a six-net
    ``.pth``, names the three it leaves unread, and prints the JAX
    evaluator's 8 metrics."""
    from rdfc_gan_tpu.cli import parse_config as jax_parse_config
    from rdfc_gan_tpu.data import DataLoader, SyntheticDataset
    from rdfc_gan_tpu.engines.base import GANTrainState
    from rdfc_gan_tpu.evaluator import Eval

    jeng, params, stats, teng, args, tmp_path = flagship
    pth = str(tmp_path / "rdfc.pth")
    unread = {k: {"weight": torch.zeros(1)}
              for k in ("G_B2A", "disc_A", "disc_B")}
    save_checkpoint({**teng.modules, **unread}, pth, meta={"epoch": 3})
    flag = ["--depth_only"] if depth_only else []
    assert main(args + flag + ["--device", "cpu", "--load_from", pth]) == 0
    log = tmp_path / "work" / "test.log"
    assert re.search(r"left unread G_B2A_state_dict, disc_A_state_dict, "
                     r"disc_B_state_dict", log.read_text())
    got = {k: _logged(log, k) for k in METRIC_NAMES}

    cfg = jax_parse_config(args + flag)
    ds = SyntheticDataset(height=H, width=W, num_classes=cfg.num_classes,
                          seed=cfg.seed)
    loader = DataLoader(ds, B, shuffle=False, drop_last=False,
                        with_indices=True)
    # the trees of the forward test above, so that its compiled forward
    # serves here too
    state = GANTrainState(step=jnp.zeros((), jnp.int32),
                          params=_served(params, depth_only),
                          batch_stats=_served(stats, depth_only),
                          opt_states={})
    want = Eval(loader, depth_only=depth_only).evaluate(jeng, state)
    for k in METRIC_NAMES:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_training_waits_for_its_slice(tmp_path):
    """The flagship's train slice is in: a train engine holds the six nets
    of the reference schema and the four optimizers over them (Nor at half
    the rate, with the decay); a serving engine holds the three nets that
    serving reads."""
    cfg = parse_config(_args(tmp_path) + ["--device", "cpu"])
    te = build_engine(cfg, is_train=True)
    assert list(te.modules) == ["G_A2B", "G_B2A", "disc_A", "disc_B",
                                "G_normal", "G_label"]
    owners = {"G": ("G_A2B", "G_B2A"), "D": ("disc_A", "disc_B"),
              "Nor": ("G_normal",), "label": ("G_label",)}
    assert sorted(te.optimizers) == sorted(owners)
    for name, nets in owners.items():
        held = {id(p) for g in te.optimizers[name].param_groups
                for p in g["params"]}
        assert held == {id(p) for n in nets
                        for p in te.modules[n].parameters()}, name
    nor = te.optimizers["Nor"].param_groups[0]
    assert nor["lr"] == pytest.approx(cfg.lr * 0.5)
    assert nor["weight_decay"] == cfg.weight_decay
    assert list(build_engine(cfg, is_train=False).modules) == [
        "G_A2B", "G_normal", "G_label"]
