"""The port's v1 datasets against the JAX package's, on the CPU: the HDF5
corpora ``nyuv2_s2d`` (with ``stat_depth`` and ``gt_depth_origin``) and
``nyuv2_r2r``, ``ddrnet_human`` (several seeds, so several rescales) and the
folder datasets ``cleargrasp`` / ``thuman``, train and test samples over two
epochs, every array bit for bit, on the fixtures of
``tests/test_real_datasets.py:145-283`` (copied here) and on the port's
own s2d fixture (seeded scenes with edges and holes). The port reads the
HDF5 frames with its own reader and the PNGs with its own decoder, and
resamples through ``cv_ops``; the JAX package uses ``h5py`` and OpenCV.

Also: ``ellipse_dropout`` and its fill equal ``cv2.ellipse`` over
thousands of draws; EXR depth raises; ``create_ddrnet_csv`` writes the JAX
tool's CSV; and ``python -m rdfc_gan_torch.train --dataset nyuv2_s2d``
trains on s2d files and ``rdfc_gan_torch.test`` serves the checkpoint.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch


cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

# Tier-1 runs several pytest workers on the machine's cores: one intra-op
# thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(path, arr)


def _same_samples(port_ds, jax_ds, epochs=(0, 1), indices=None):
    assert len(port_ds) == len(jax_ds)
    for ep in epochs:
        port_ds.set_epoch(ep)
        jax_ds.set_epoch(ep)
        for idx in indices or range(len(jax_ds)):
            want, got = jax_ds[idx], port_ds[idx]
            assert want is not None and got is not None
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, (k, ep, idx)
                np.testing.assert_array_equal(
                    got[k], want[k], err_msg=f"{k} epoch {ep} index {idx}")


# ----------------------------------------------------------- HDF5 corpora
@pytest.fixture(scope="module")
def s2d_root(tmp_path_factory):
    """tests/test_real_datasets.py:145-163: h5py-written frames."""
    root = str(tmp_path_factory.mktemp("s2d"))
    rng = np.random.RandomState(2)
    split = {"train": [], "val": []}
    for mode in ("train", "val"):
        for i in range(2):
            fn = f"{mode}_{i}.h5"
            with h5py.File(os.path.join(root, fn), "w") as f:
                f["rgb"] = rng.randint(0, 255, (3, 480, 640), dtype=np.uint8)
                f["depth"] = rng.uniform(0.5, 9, (480, 640)).astype(
                    np.float32)
            split[mode].append({"filename": fn})
    with open(os.path.join(root, "nyu.json"), "w") as f:
        json.dump(split, f)
    return root


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    """The port's own fixture tool: seeded scenes, depth with holes,
    written without h5py."""
    from rdfc_gan_torch.tools.make_s2d_fixture import write_fixture

    root = str(tmp_path_factory.mktemp("s2d_scenes"))
    write_fixture(root, n_train=2, n_val=2, seed=4)
    return root


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("fixture", ["s2d_root", "scene_root"])
def test_nyuv2_s2d_matches_jax(fixture, mode, request):
    from rdfc_gan_torch.data.nyuv2_s2d import NYUV2S2DDataset as Port
    from rdfc_gan_tpu.data.nyuv2_s2d import NYUV2S2DDataset as Ref

    root = request.getfixturevalue(fixture)
    port = Port(root, mode=mode, seed=3)
    _same_samples(port, Ref(root, mode=mode, seed=3))
    s = port[0]
    assert s["rgb"].shape == (228, 304, 3)
    if mode == "val":
        assert s["gt_depth_origin"].shape == (228, 304)


@pytest.mark.parametrize("fixture", ["s2d_root", "scene_root"])
def test_nyuv2_s2d_stat_depth_matches_jax(fixture, request):
    from rdfc_gan_torch.data.nyuv2_s2d import NYUV2S2DDataset as Port
    from rdfc_gan_tpu.data.nyuv2_s2d import NYUV2S2DDataset as Ref

    root = request.getfixturevalue(fixture)
    ours, theirs = [], []
    got = Port(root, mode="train").stat_depth(log=ours.append)
    want = Ref(root, mode="train").stat_depth(log=theirs.append)
    assert got == want and ours == theirs


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("fixture", ["s2d_root", "scene_root"])
def test_nyuv2_r2r_matches_jax(fixture, mode, request):
    from rdfc_gan_torch.data.nyuv2_r2r import NYUV2R2RDataset as Port
    from rdfc_gan_tpu.data.nyuv2_r2r import NYUV2R2RDataset as Ref

    root = request.getfixturevalue(fixture)
    for seed in (0, 5):
        _same_samples(Port(root, mode=mode, seed=seed),
                      Ref(root, mode=mode, seed=seed))


# ------------------------------------------------------------ DDRNet human
@pytest.fixture(scope="module")
def ddrnet_root(tmp_path_factory):
    """tests/test_real_datasets.py:223-246."""
    root = str(tmp_path_factory.mktemp("ddr"))
    rng = np.random.RandomState(3)
    rows = []
    for i in range(2):
        h, w = 480, 640
        paths = {}
        for kind, arr in (
            ("rgb", rng.randint(0, 255, (h, w, 3), dtype=np.uint8)),
            ("raw", rng.randint(500, 2900, (h, w)).astype(np.uint16)),
            ("gt", rng.randint(500, 2900, (h, w)).astype(np.uint16)),
            ("mask", (rng.uniform(size=(h, w)) > 0.3).astype(np.uint8) * 255),
        ):
            p = os.path.join(root, f"{i}_{kind}.png")
            _write_png(p, arr)
            paths[kind] = p
        rows.append(f"{paths['rgb']},{paths['raw']},{paths['gt']},"
                    f"{paths['mask']}")
    for mode in ("train", "val"):
        with open(os.path.join(root, f"{mode}.csv"), "w") as f:
            f.write("\n".join(rows))
    return root


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ddrnet_human_train_matches_jax(ddrnet_root, seed):
    """``times=2``: indices 0, 1 and 3 (both frames, and a repeat) in each
    of two epochs, each seed and epoch its own rescale factors (widths
    round(640 s), most not a multiple of 16)."""
    from rdfc_gan_torch.data.ddrnet_human import DDRNetHumanDataset as Port
    from rdfc_gan_tpu.data.ddrnet_human import DDRNetHumanDataset as Ref

    port = Port(ddrnet_root, mode="train", times=2, seed=seed)
    assert len(port) == 4
    _same_samples(port, Ref(ddrnet_root, mode="train", times=2, seed=seed),
                  indices=(0, 1, 3))
    assert port[0]["human_mask"].shape == (480, 640, 1)


def test_ddrnet_human_test_matches_jax(ddrnet_root):
    from rdfc_gan_torch.data.ddrnet_human import DDRNetHumanDataset as Port
    from rdfc_gan_tpu.data.ddrnet_human import DDRNetHumanDataset as Ref

    port = Port(ddrnet_root, mode="val", times=5)
    assert len(port) == 2  # the multiplier is the train split's
    _same_samples(port, Ref(ddrnet_root, mode="val"), epochs=(0,))
    assert port[0]["evaluate_mask"].dtype == bool


def test_create_ddrnet_csv_matches_jax_tool(tmp_path):
    from rdfc_gan_torch.tools.create_ddrnet_csv import main, write_index

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import create_ddrnet_csv as jax_tool
    finally:
        sys.path.pop(0)
    src = tmp_path / "ddr"
    for sub in ("color_map", "depth_map", "high_quality_depth", "mask"):
        (src / sub).mkdir(parents=True)
        for name in ("b.png", "a.png", "c.png"):
            (src / sub / name).write_bytes(b"")
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    assert write_index(str(src), str(ours)) == 3
    assert main([str(src), str(ours)]) == 0  # appends, as the tool does
    jax_tool.write_index(str(src), str(theirs))
    jax_tool.write_index(str(src), str(theirs))
    assert ours.read_text() == theirs.read_text()
    assert ours.read_text().splitlines()[0].split(",")[0].endswith(
        "color_map/a.png")


# ------------------------------------------------------- folder datasets
@pytest.fixture(scope="module")
def folder_root(tmp_path_factory):
    """tests/test_real_datasets.py:261-270, plus a split with depth_raw."""
    root = str(tmp_path_factory.mktemp("cg"))
    rng = np.random.RandomState(4)
    for split in ("train", "val", "test"):
        for i in range(3):
            _write_png(f"{root}/{split}/rgb/{i}.png",
                       rng.randint(0, 255, (100, 120, 3), dtype=np.uint8))
            _write_png(f"{root}/{split}/depth/{i}.png",
                       rng.randint(500, 9000, (100, 120)).astype(np.uint16))
            if split == "test":
                raw = rng.randint(500, 9000, (100, 120)).astype(np.uint16)
                raw[rng.uniform(size=raw.shape) < 0.3] = 0
                _write_png(f"{root}/{split}/depth_raw/{i}.png", raw)
    return root


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("key", ["cleargrasp", "thuman"])
def test_folder_datasets_match_jax(folder_root, key, mode):
    """train: raw depth from the ellipse dropout (no depth_raw), the flip;
    val: gt as raw; test: the depth_raw files."""
    from rdfc_gan_torch import data  # noqa: F401
    from rdfc_gan_torch.registry import DATASETS as PORT
    from rdfc_gan_tpu import data as jdata  # noqa: F401
    from rdfc_gan_tpu.registry import DATASETS as REF

    port = PORT.get(key)(folder_root, mode=mode, seed=6)
    _same_samples(port, REF.get(key)(folder_root, mode=mode, seed=6))
    s = port[0]
    assert s["rgb"].shape == (256, 256, 3)
    if mode == "train":
        assert (s["raw_depth"] == 0).any()


def test_ellipse_dropout_matches_opencv():
    """The JAX ``ellipse_dropout`` (``cv2.ellipse``) and the port's from the
    same generator: 400 images of 1-10 ellipses each."""
    from rdfc_gan_torch.utils.data_augmentation import ellipse_dropout
    from rdfc_gan_tpu.utils import data_augmentation as ref

    for i in range(400):
        r = np.random.RandomState(i)
        h, w = int(r.randint(20, 140)), int(r.randint(20, 140))
        depth = r.uniform(0.5, 9.0, (h, w)).astype(np.float32)
        a = ref.ellipse_dropout(depth, np.random.default_rng(i))
        b = ellipse_dropout(depth, np.random.default_rng(i))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=f"draw {i}")


def test_ellipse_fill_matches_opencv():
    """``fill_ellipse`` against ``cv2.ellipse(..., 0, 360, color, -1)`` over
    5000 random draws: centres on and off the image, axes 0-60 (so every
    polygon step, 90, 30, 18 and 5 degrees), any angle (rounded to whole
    degrees, negative and past 360)."""
    from rdfc_gan_torch.utils.data_augmentation import fill_ellipse

    rng = np.random.default_rng(0)
    for i in range(5000):
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        center = (int(rng.integers(-8, w + 8)), int(rng.integers(-8, h + 8)))
        axes = tuple(int(v) for v in rng.integers(0, 60, 2))
        angle = float(rng.uniform(-400, 400))
        a = np.full((h, w), 7, np.uint8)
        b = a.copy()
        cv2.ellipse(a, center, axes, angle, 0, 360, 0, -1)
        fill_ellipse(b, center, axes, angle, 0)
        np.testing.assert_array_equal(
            b, a, err_msg=f"draw {i}: {h}x{w} {center} {axes} {angle}")


def test_exr_depth_raises(tmp_path):
    """OpenCV here is built without OpenEXR, so there is no reference to
    match: the port refuses EXR depth, naming the file."""
    from rdfc_gan_torch.data.folder_dataset import FolderDepthDataset
    from rdfc_gan_torch.utils.data_augmentation import exr_loader

    root = tmp_path / "cg"
    _write_png(str(root / "train/rgb/0.png"), np.zeros((8, 8, 3), np.uint8))
    (root / "train/depth").mkdir(parents=True)
    exr = root / "train/depth/0.exr"
    exr.write_bytes(b"v/1\x01")
    with pytest.raises(ValueError, match="0.exr"):
        exr_loader(str(exr))
    with pytest.raises(ValueError, match="0.exr"):
        FolderDepthDataset(str(root), mode="train")


def test_registry_has_the_v1_datasets():
    from rdfc_gan_torch import data  # noqa: F401
    from rdfc_gan_torch.cli import build_parser
    from rdfc_gan_torch.registry import DATASETS

    for key in ("nyuv2_s2d", "nyuv2_r2r", "ddrnet_human", "cleargrasp",
                "thuman"):
        DATASETS.get(key)
    choices = next(a.choices for a in build_parser()._actions
                   if a.dest == "dataset")
    # the CLI offers what the JAX train.py offers
    assert {"nyuv2_s2d", "cleargrasp", "thuman"} <= set(choices)
    assert not {"nyuv2_r2r", "ddrnet_human"} & set(choices)


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


def test_train_and_test_drivers_on_s2d_files(scene_root, tmp_path):
    """``python -m rdfc_gan_torch.train --dataset nyuv2_s2d`` on HDF5 files
    written without h5py: one epoch at 228x304, an evaluation,
    ``best.pth``; ``rdfc_gan_torch.test`` serves it to the same metrics."""
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_torch.cli import parse_config

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_NLSPN)
    common = ["--dataset", "nyuv2_s2d", "--data_root", scene_root,
              "--model_cfg_path", str(cfg_path), "--batch_size", "2",
              "--num_workers", "2", "--device", "cpu"]
    res = port_train.run(parse_config(common + [
        "--work_dir", str(tmp_path / "tr"), "--n_epochs", "1",
        "--start_eval_epoch", "0"]))
    assert res["steps"] == 1 and np.isfinite(res["metrics"]["RMSE"])
    served = port_test.run(parse_config(common + [
        "--work_dir", str(tmp_path / "te"),
        "--load_from", str(tmp_path / "tr" / "best.pth")]))["metrics"]
    for k, v in res["metrics"].items():
        assert np.isclose(served[k], v, rtol=1e-5, atol=1e-6), k
