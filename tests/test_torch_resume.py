"""Resume, sample grids and single-image inference of the port, on the CPU.

* Resume equivalence (the port's analog of
  ``tests/test_resume_equivalence.py``): through ``python -m
  rdfc_gan_torch.train``, 2N epochs straight against N epochs, then
  ``--resume_from epoch_N.pth`` and N more, on synthetic data, for the
  flagship (``configs/rdfc_gan_tiny.yaml``) and a narrow NLSPN RDFGAN
  (wgangp, so the gradient penalty draws from the per-step generator).
  Every entry of the two final ``.pth`` files, nets, optimizers,
  schedulers and meta, must be bit-identical. A file without the
  optimizer or scheduler entries must raise, naming the entry.
* ``RDFCGAN.save_samples``: the four grids, decoded, against the JAX
  engine's ``save_samples`` (its ``save_vis.merge_images`` of the same
  arrays, captured before its JPEG write) from the same weights.
* ``python -m rdfc_gan_torch.inference`` against ``tools/inference.py`` from
  the same weights: the uint16 depth PNGs within 1 mm at every pixel.
"""

import os
import sys
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.cli import parse_config
from rdfc_gan_torch.data import image_io
from rdfc_gan_torch.engines import build_engine
from rdfc_gan_torch.utils.checkpoint import resume_from, save_checkpoint
from rdfc_gan_torch.utils.convert import rdfcgan_state_dicts_from_jax
from test_torch_normal_net import randomize_norms

# Tier-1 runs several pytest workers on the machine's cores: one intra-op
# thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
TINY_NLSPN = """\
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
N = 1  # 2N epochs straight against N + resume + N


def _config(tmp_path, which):
    if which == "flagship":
        return TINY, []
    path = tmp_path / "nlspn.yaml"
    path.write_text(TINY_NLSPN)
    return str(path), ["--gan_loss_type", "wgangp"]


def _train(tmp_path, which, name, n_epochs, resume=None):
    from rdfc_gan_torch import train

    cfg_path, extra = _config(tmp_path, which)
    work = tmp_path / name
    argv = ["--dataset", "synthetic", "--model_cfg_path", cfg_path,
            "--work_dir", str(work), "--batch_size", "32",
            "--n_epochs", str(n_epochs), "--num_classes", "5",
            "--out_height", "32", "--out_width", "32", "--seed", "11",
            "--log_interval", "1000", "--sample_interval", "1000000",
            "--val_interval", "1000", "--save_interval", "1",
            "--num_workers", "2", "--device", "cpu", *extra]
    if resume:
        argv += ["--resume_from", str(resume)]
    res = train.run(parse_config(argv))
    return work / f"epoch_{n_epochs}.pth", res


def _diffs(a, b, path=""):
    """Paths at which two loaded checkpoints differ (tensors bit for bit,
    dtype included; other leaves by ==)."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in _diffs(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _diffs(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


@pytest.mark.parametrize("which", ["flagship", "nlspn"])
def test_resume_equivalence_bitwise(tmp_path, which):
    straight, _ = _train(tmp_path, which, "straight", 2 * N)
    half, _ = _train(tmp_path, which, "half", N)
    resumed, res = _train(tmp_path, which, "resumed", 2 * N,
                          resume=half.parent / f"epoch_{N}.pth")
    assert res["start_epoch"] == N and res["steps"] == N * 2
    a = torch.load(straight, weights_only=True)
    b = torch.load(resumed, weights_only=True)
    opts = ("G", "D", "Nor", "label") if which == "flagship" else ("G", "D")
    for k in opts:
        assert f"{k}_optimizer_state_dict" in a
        assert f"{k}_lr_scheduler_state_dict" in a
        # the schedule is per step: each scheduler stepped once a step
        assert a[f"{k}_lr_scheduler_state_dict"]["last_epoch"] == 2 * N * 2
    assert a["meta"] == {"epoch": 2 * N, "batch_size": 32}
    diffs = _diffs(a, b)
    assert not diffs, f"{len(diffs)} entries differ: {diffs[:8]}"


def test_resume_needs_optimizer_and_scheduler_entries(tmp_path):
    cfg_path, extra = _config(tmp_path, "nlspn")
    cfg = parse_config(["--dataset", "synthetic", "--model_cfg_path",
                        cfg_path, "--work_dir", str(tmp_path / "w"),
                        "--device", "cpu", *extra])
    engine = build_engine(cfg, is_train=True, steps_per_epoch=2)
    nets_only = str(tmp_path / "nets.pth")
    save_checkpoint(engine.modules, nets_only, meta={"epoch": 1})
    with pytest.raises(KeyError, match="G_optimizer_state_dict"):
        resume_from(engine, nets_only)
    full = str(tmp_path / "full.pth")
    state = engine.train_state()
    del state["D_lr_scheduler_state_dict"]
    save_checkpoint(engine.modules, full, meta={"epoch": 1},
                    train_state=state)
    with pytest.raises(KeyError, match="D_lr_scheduler_state_dict"):
        resume_from(engine, full)
    save_checkpoint(engine.modules, full, train_state=engine.train_state())
    with pytest.raises(KeyError, match="meta epoch"):
        resume_from(engine, full)


# ------------------------------------------- JAX weights into the port --
H, W, B = 32, 48, 2


@pytest.fixture(scope="module")
def jax_state():
    """The JAX serving engine's ``init_state(PRNGKey(0))`` at the inference
    tool's shapes (batch 1), with drawn norm leaves in the three served
    nets, and the same weights in the port's training engine."""
    from rdfc_gan_tpu.cli import parse_config as jax_parse_config
    from rdfc_gan_tpu.engines import build_engine as jax_build_engine

    args = ["--dataset", "synthetic", "--model_cfg_path", TINY,
            "--work_dir", "unused", "--out_height", str(H),
            "--out_width", str(W)]
    jeng = jax_build_engine(jax_parse_config(args), is_train=False)
    zeros = dict(rgb=jnp.zeros((1, H, W, 3)),
                 raw_depth=jnp.zeros((1, H, W, 1)),
                 gt_depth=jnp.zeros((1, H, W, 1)))
    state = jeng.init_state(jax.random.PRNGKey(0), zeros)
    params = jax.tree.map(np.asarray, dict(state.params))
    stats = jax.tree.map(np.asarray, dict(state.batch_stats))
    for i, k in enumerate(("G_A2B", "G_normal", "G_label")):
        scale = (0.3, 0.6) if k == "G_label" else (0.8, 1.2)
        params[k] = randomize_norms(params[k], 10 + i, scale=scale)
        stats[k] = randomize_norms(stats[k], 20 + i)
    state = state.replace(params=params, batch_stats=stats)

    cfg = parse_config(args + ["--device", "cpu"])
    teng = build_engine(cfg, is_train=True, steps_per_epoch=1)
    sds = rdfcgan_state_dicts_from_jax(params, stats,
                                       normal_depth=cfg.model.Normal_G.depth)
    for k in ("G_A2B", "G_B2A", "G_normal", "G_label"):
        left = teng.modules[k].load_state_dict(sds[k], strict=False)
        assert not left.unexpected_keys
    return jeng, state, teng


def _fixed_batch():
    r = np.random.RandomState(3)
    rgb = r.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    gt = r.uniform(-0.8, 0.8, (B, H, W, 1)).astype(np.float32)
    raw = (gt * (r.uniform(size=gt.shape) > 0.5)).astype(np.float32)
    normal = r.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    labels = r.randint(0, 5, (B, H, W)).astype(np.int32)
    return dict(rgb=rgb, gt_depth=gt, raw_depth=raw, gt_normal=normal,
                labels=labels)


def test_save_samples_matches_jax_grids(jax_state, tmp_path):
    """The four grids, decoded from the port's PNGs, against the JAX
    engine's merged grids. The nets agree to about 1e-5, and a grid is
    the float image truncated to uint8, so a value within that of an
    integer may fall on the other side: each grid may differ by one level
    at 0.5% of its values; the label grids (an argmax of the logits) may
    differ at 0.5% of their pixels."""
    from rdfc_gan_tpu.utils import save_vis as jax_vis

    jeng, state, teng = jax_state
    batch = _fixed_batch()
    want = {}

    def capture(path, image_lists, num_imgs_per_scene, batch_size=8):
        merged = jax_vis.merge_images(
            [jax_vis.to_data(x) for x in image_lists], num_imgs_per_scene,
            batch_size)
        # "{dir}/sample-test-000008-A-B.jpg" -> "A-B"
        want[os.path.basename(path)[len("sample-test-000008-"):-4]] = \
            merged.astype(np.uint8)

    with mock.patch.object(jax_vis, "save_image_grid", capture):
        jeng.save_samples(SimpleNamespace(params=state.params,
                                          batch_stats=state.batch_stats),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          str(tmp_path / "jax"), 8, prefix="sample-test")
    nchw = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy())
            if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}
    prefix = teng.save_samples(nchw, str(tmp_path / "port"), 8,
                               prefix="sample-test")
    assert os.path.basename(prefix) == "sample-test-000008"
    assert sorted(want) == ["A-B", "B-A", "label", "normal"]
    for name, ref in want.items():
        got = image_io.bgr2rgb(image_io.imread(f"{prefix}-{name}.png"))
        assert got.shape == ref.shape == (
            B * H, (3 if "-" in name else 2) * W, 3), name
        diff = np.abs(got.astype(int) - ref)
        if name == "label":
            assert (diff.max(-1) > 0).mean() <= 0.005, name
        else:
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, name


def test_inference_matches_jax_tool(jax_state, tmp_path):
    """``python -m rdfc_gan_torch.inference`` (its entry point, on the CPU)
    against ``tools/inference.py``, from the same weights: the uint16 mm
    PNGs within 1 mm (the nets agree to about 1e-5 m; the mm are
    truncated), and the VIRIDIS map within one colour-table step."""
    import cv2

    from rdfc_gan_torch import inference
    from rdfc_gan_tpu.engines.rdfc_gan import RDFCGAN as JaxRDFCGAN

    jeng, state, teng = jax_state
    r = np.random.default_rng(0)
    rgb_p, dep_p = str(tmp_path / "rgb.png"), str(tmp_path / "depth.png")
    image_io.imwrite(rgb_p, r.uniform(0, 255, (40, 56, 3)).astype(np.uint8))
    image_io.imwrite(dep_p, r.uniform(500, 8000, (40, 56)).astype(np.uint16))
    pth = str(tmp_path / "served.pth")
    save_checkpoint({k: teng.modules[k] for k in
                     ("G_A2B", "G_normal", "G_label")}, pth)

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import inference as jax_tool
    finally:
        sys.path.pop(0)
    jax_out = str(tmp_path / "jax.png")
    # the tool draws its weights from init_state(PRNGKey(0)) at these
    # shapes: hand it the fixture's (the same draw, norms redrawn)
    with mock.patch.object(JaxRDFCGAN, "init_state",
                           lambda self, rng, batch: state):
        jax_tool.main(["--model_cfg_path", TINY, "--rgb", rgb_p, "--depth",
                       dep_p, "--out", jax_out, "--out_height", str(H),
                       "--out_width", str(W)])
    port_out = str(tmp_path / "port.png")
    res = inference.run(["--model_cfg_path", TINY, "--load_from", pth,
                         "--rgb", rgb_p, "--depth", dep_p, "--out", port_out,
                         "--out_height", str(H), "--out_width", str(W),
                         "--device", "cpu"])
    got, want = image_io.imread(port_out), cv2.imread(jax_out,
                                                      cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype == np.uint16 and got.shape == (H, W)
    assert np.abs(got.astype(int) - want).max() <= 1
    vis = image_io.imread(res["vis"])
    assert vis.shape == (H, W, 3) and vis.dtype == np.uint8
    assert res["vis"].endswith("port_vis.png")
