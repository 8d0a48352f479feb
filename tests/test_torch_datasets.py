"""The port's file datasets against the JAX package's, on the CPU, on
fixtures in the corpora's real on-disk layouts (as
``tests/test_real_datasets.py`` writes them): ``nyuv2``, ``nyuv2_sparse``,
``nyuv2_pseudo``, ``nyuv2_raw`` and ``sunrgbd``, train and test samples at
two epochs, every array bit for bit (the port decodes through its own PNG
reader and resamples through ``cv_ops``, which match OpenCV at these
shapes). Also: the port's fixture generator writes the JAX tool's files
pixel for pixel, the decode cache's hit equals its miss, the thread and
process loaders give the same batches, and ``python -m
rdfc_gan_torch.train`` trains on a NYUv2-layout fixture with the default
``--dataset nyuv2``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from rdfc_gan_torch.data import image_io
from rdfc_gan_torch.tools.make_nyuv2_fixture import write_fixture

# Tier-1 runs several pytest workers on the machine's cores: one intra-op
# thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NYU = ["NYUV21400Dataset", "NYUV21400SparseDataset",
       "NYUV21400PseudoDataset", "NYUV21400RawDataset"]


@pytest.fixture(scope="module")
def nyuv2_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nyuv2") / "nyu")
    write_fixture(root, n_train=3, n_test=2, seed=5)
    return root


def test_fixture_generator_matches_jax_tool(tmp_path):
    """The port's copy of the scene generator (its own Gaussian blur,
    dilation and PNG writer) writes what ``tools/make_nyuv2_fixture.py``
    writes with OpenCV, pixel for pixel."""
    import sys

    import cv2

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import make_nyuv2_fixture as jax_tool
    finally:
        sys.path.pop(0)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    for d in (ours, theirs):
        os.makedirs(d)
    write_fixture(ours, n_train=2, n_test=0, seed=3)
    jax_tool.write_split(theirs, "train", 2, 3)
    for sub in ("rgb", "depth", "depth_raw", "norm_v2", "labels_13"):
        for i in ("0000", "0001"):
            a = image_io.imread(f"{ours}/train/{sub}/{i}.png")
            b = cv2.imread(f"{theirs}/train/{sub}/{i}.png",
                           cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype, sub
            np.testing.assert_array_equal(a, b, err_msg=f"{sub}/{i}")


def _same_samples(port_ds, jax_ds, epochs=(0, 1)):
    assert len(port_ds) == len(jax_ds)
    for ep in epochs:
        port_ds.set_epoch(ep)
        jax_ds.set_epoch(ep)
        for idx in range(len(jax_ds)):
            want, got = jax_ds[idx], port_ds[idx]
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, (k, ep, idx)
                np.testing.assert_array_equal(
                    got[k], want[k], err_msg=f"{k} epoch {ep} index {idx}")


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("cls", NYU)
def test_nyuv2_family_matches_jax(nyuv2_root, cls, mode):
    from rdfc_gan_torch.data import nyuv2 as port
    from rdfc_gan_tpu.data import nyuv2 as ref

    kw = dict(mode=mode, seed=7)
    _same_samples(getattr(port, cls)(nyuv2_root, **kw),
                  getattr(ref, cls)(nyuv2_root, **kw))


def test_nyuv2_registry_keys():
    from rdfc_gan_torch import data  # noqa: F401
    from rdfc_gan_torch.registry import DATASETS

    for key in ("nyuv2", "nyuv2_sparse", "nyuv2_pseudo", "nyuv2_raw",
                "sunrgbd", "synthetic"):
        DATASETS.get(key)  # KeyError when missing


@pytest.fixture(scope="module")
def sunrgbd_root(tmp_path_factory):
    """tests/test_real_datasets.py:98-130's layout: bit-shifted depth PNGs,
    pickled labels, {train,test}_*.txt lists."""
    root = str(tmp_path_factory.mktemp("sunrgbd"))
    rng = np.random.RandomState(1)
    names = {k: [] for k in ("rgb", "depth", "depth_bfx", "seg_label",
                             "normal")}
    for i, (h, w) in enumerate(((120, 160), (97, 131))):
        os.makedirs(os.path.join(root, "img"), exist_ok=True)
        paths = {k: f"img/{i}_{k}.png" for k in ("rgb", "depth",
                                                  "depth_bfx", "normal")}
        image_io.imwrite(os.path.join(root, paths["rgb"]),
                         rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        for k in ("depth", "depth_bfx"):
            mm = rng.randint(500, 8000, (h, w)).astype(np.uint32)
            mm[rng.uniform(size=(h, w)) < 0.2] = 0
            enc = ((mm << 3) & 0xFFFF | (mm >> 13)).astype(np.uint16)
            image_io.imwrite(os.path.join(root, paths[k]), enc)
        image_io.imwrite(os.path.join(root, paths["normal"]),
                         rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        paths["seg_label"] = f"img/{i}_label.pkl"
        with open(os.path.join(root, paths["seg_label"]), "wb") as f:
            pickle.dump(rng.randint(0, 37, (h, w)).astype(np.uint8), f)
        for k, p in paths.items():
            names[k].append(p)
    for prefix in ("train_", "test_"):
        for k, files in names.items():
            with open(os.path.join(root, f"{prefix}{k}.txt"), "w") as f:
                f.write("\n".join(files))
    return root


@pytest.mark.parametrize("mode", ["train", "test"])
def test_sunrgbd_matches_jax(sunrgbd_root, mode, monkeypatch):
    """Train and test, the test samples with origin_h, origin_w and
    real_idx. The depth decode is ``fastops.sunrgbd_depth_decode``'s numpy
    path (``v / 1000``), which the JAX package takes without its native
    library; its native path (``v * 1e-3f``) can differ by one f32 ulp,
    so the JAX side is held to its numpy path here, and the two decodes
    are compared in ``test_sunrgbd_depth_decode``."""
    from rdfc_gan_torch.data.sunrgbd import SUNRGBDPseudoDataset as Port
    from rdfc_gan_tpu.data import fastops
    from rdfc_gan_tpu.data.sunrgbd import SUNRGBDPseudoDataset as Ref

    monkeypatch.setattr(fastops, "available", lambda: False)
    port = Port(sunrgbd_root, mode=mode, seed=2)
    _same_samples(port, Ref(sunrgbd_root, mode=mode, seed=2))
    if mode == "test":
        s = port[1]
        assert (int(s["origin_h"]), int(s["origin_w"]),
                int(s["real_idx"])) == (97, 131, 1)


def test_sunrgbd_depth_decode():
    """(d >> 3) | (d << 13) in metres: equal to the JAX numpy path, within
    one f32 ulp of its native path, for every uint16."""
    from rdfc_gan_torch.data.sunrgbd import SUNRGBDPseudoDataset
    from rdfc_gan_tpu.data import fastops

    d = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    ours = SUNRGBDPseudoDataset.get_depth_inpaint(d)
    v = np.bitwise_or(np.right_shift(d, 3), np.left_shift(d, 13))
    np.testing.assert_array_equal(ours, v.astype(np.float32) / 1000.0)
    native = fastops.sunrgbd_depth_decode(d)
    np.testing.assert_array_max_ulp(ours, native, maxulp=1)


def test_decode_cache_hit_equals_miss(nyuv2_root, tmp_path):
    from rdfc_gan_torch.data.nyuv2 import NYUV21400Dataset

    plain = NYUV21400Dataset(nyuv2_root, mode="train")
    cache = str(tmp_path / "cache")
    cached = NYUV21400Dataset(nyuv2_root, mode="train", decode_cache=cache)
    a = plain[0]
    b = cached[0]  # miss: decode and store
    files = os.listdir(cache)
    assert len(files) == 1 and files[0].endswith("__train__rgb__0000.png.npz")
    c = cached[0]  # hit
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        np.testing.assert_array_equal(c[k], a[k], err_msg=k)
    # the salt keys the file by class and root: another class misses
    from rdfc_gan_torch.data.nyuv2 import NYUV21400RawDataset

    NYUV21400RawDataset(nyuv2_root, mode="train", decode_cache=cache)[0]
    assert len(os.listdir(cache)) == 2


def test_thread_and_process_loaders_agree(nyuv2_root):
    """Two epochs of the pseudo-hole variant (the most draws a sample):
    both backends give the same batches, bit for bit."""
    from rdfc_gan_torch.data import DataLoader
    from rdfc_gan_torch.data.nyuv2 import NYUV21400PseudoDataset

    out = {}
    for backend in ("thread", "process"):
        ds = NYUV21400PseudoDataset(nyuv2_root, mode="train", seed=4)
        dl = DataLoader(ds, 2, num_workers=2, shuffle=True, drop_last=False,
                        seed=4, worker_backend=backend)
        batches = []
        try:
            for epoch in (0, 1):
                dl.set_epoch(epoch)
                ds.set_epoch(epoch)
                batches += list(dl)
        finally:
            dl.close()
        out[backend] = batches
    assert len(out["thread"]) == len(out["process"]) == 4
    for a, b in zip(out["thread"], out["process"]):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert tuple(out["thread"][0]["rgb"].shape) == (2, 3, 224, 304)


def test_bad_loader_backend_raises():
    from rdfc_gan_torch.data import DataLoader, SyntheticDataset

    with pytest.raises(ValueError, match="worker_backend 'fork'"):
        DataLoader(SyntheticDataset(length=2), 1, worker_backend="fork")


def test_show_dumps_pngs(nyuv2_root, tmp_path):
    """BaseDataset.show (lib/datasets/base.py:103-163): the JAX package's
    dumps, pixel for pixel (the plasma map from OpenCV's table)."""
    import cv2

    from rdfc_gan_torch.data.nyuv2 import NYUV21400Dataset
    from rdfc_gan_tpu.data.nyuv2 import NYUV21400Dataset as Ref

    ds = NYUV21400Dataset(nyuv2_root, mode="val")
    s = ds[0]
    samples = {k: np.stack([s[k]]) for k in ("rgb", "raw_depth", "gt_depth")}
    samples["pred_depth"] = samples["gt_depth"] + 0.01
    ours = ds.show(samples, iters=42, save_dir=str(tmp_path / "ours"))
    theirs = Ref(nyuv2_root, mode="val").show(
        samples, iters=42, save_dir=str(tmp_path / "theirs"))
    assert ours.endswith("0000000042")
    for name in ("rgb", "raw_depth", "pred_depth", "gt_depth", "pred_gray"):
        a = image_io.imread(os.path.join(ours, f"0_{name}.png"))
        b = cv2.imread(os.path.join(theirs, f"0_{name}.png"),
                       cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(a, b, err_msg=name)


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


def test_train_and_test_drivers_on_nyuv2_files(nyuv2_root, tmp_path):
    """``python -m rdfc_gan_torch.train`` with the default ``--dataset``
    (nyuv2) on the fixture: one epoch, an evaluation, ``best.pth``; then
    ``rdfc_gan_torch.test`` serves it to the same metrics. Without
    ``--data_root`` a file dataset raises."""
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_torch.cli import parse_config

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_NLSPN)
    common = ["--model_cfg_path", str(cfg_path), "--batch_size", "2",
              "--num_workers", "2", "--device", "cpu"]
    res = port_train.run(parse_config(common + [
        "--data_root", nyuv2_root, "--work_dir", str(tmp_path / "tr"),
        "--n_epochs", "1", "--start_eval_epoch", "0"]))
    assert res["steps"] == 1 and np.isfinite(res["metrics"]["RMSE"])
    served = port_test.run(parse_config(common + [
        "--data_root", nyuv2_root, "--work_dir", str(tmp_path / "te"),
        "--load_from", str(tmp_path / "tr" / "best.pth")]))["metrics"]
    for k, v in res["metrics"].items():
        assert np.isclose(served[k], v, rtol=1e-5, atol=1e-6), k
    with pytest.raises(ValueError, match="needs a data_root"):
        port_test.run(parse_config(common + [
            "--work_dir", str(tmp_path / "none")]))
