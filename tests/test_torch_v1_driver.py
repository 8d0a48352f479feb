"""The port's v1 evaluation and driver against the JAX package, on the CPU:
``RDFGANMetric`` (whole-batch f64 metrics and the per-sample mean) and the
segmentation helpers; ``cv_ops.resize`` against ``cv2`` at EvalV1's
228x304 -> 480x640; ``EvalV1`` against the JAX ``EvalV1`` on an
``nyuv2_s2d`` fixture with the same predictions handed to both;
``PointCloudsHandler``'s points and ``.pcd`` bytes; the v1 driver's flags
and model dict against ``tools/main_v1.py``'s, and its guided model
against ``configs/rdf_gan_guided_config.yaml`` and the benchmark's
``rdfgan-guided``; and tiny runs of
``python -m rdfc_gan_torch.tools.main_v1`` (train an epoch, then
``--inference`` and ``--cal_fps`` from its ``epoch_1.pth``),
``main_vanilla`` and ``dataset_checker``. ``--device cuda`` without a card
raises.

Tolerances: the metrics rtol 1e-6 (the same f32 or f64 sums in another
order), the resize and the ``.pcd`` bytes exact.
"""

import functools
import json
import os
import re
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from rdfc_gan_torch.data import DataLoader as TLoader
from rdfc_gan_torch.data import SyntheticDataset, cv_ops
from rdfc_gan_torch.data.nyuv2_s2d import NYUV2S2DDataset as TS2D
from rdfc_gan_torch.evaluator import EvalV1 as TEval
from rdfc_gan_torch.metrics import RDFGANMetric as TMetric
from rdfc_gan_torch.metrics import seg_metrics as tseg
from rdfc_gan_torch.registry import DATASETS
from rdfc_gan_torch.tools import dataset_checker
from rdfc_gan_torch.tools import main_v1 as t_main
from rdfc_gan_torch.tools import main_vanilla
from rdfc_gan_torch.tools.make_s2d_fixture import write_fixture
from rdfc_gan_torch.utils.point_cloud import PointCloudsHandler as TPCH

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import main_v1 as j_main  # noqa: E402

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

METRIC = dict(rtol=1e-6, atol=1e-9)
TINY = ["--dataset", "synthetic", "--height", "64", "--width", "64",
        "--batch_size", "4", "--num_workers", "1",
        "--rgb_channels_encoder", *["8"] * 6,
        "--depth_channels_encoder", *["8"] * 6,
        "--rgb_channels_decoder", *["8"] * 4,
        "--depth_channels_decoder", *["8"] * 4,
        "--guidance_channels_decoder", "8", "8", "8", "--prop_time", "3"]


# ------------------------------------------------------------ metrics --
def _results(seed, n=3, shape=(20, 30), masks=False):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        gt = r.uniform(0.0, 8.0, shape).astype(np.float32)
        gt[r.uniform(size=shape) < 0.2] = 0.0
        res = dict(gt=gt, pd=(gt + r.normal(0, 0.5, shape)).astype(
            np.float32))
        if masks:
            res["evaluate_mask"] = r.uniform(size=shape) > 0.3
        out.append(res)
    return out


@pytest.mark.parametrize("masks", [False, True])
def test_rdfgan_metric_matches_jax(masks, capsys):
    from rdfc_gan_tpu.metrics import RDFGANMetric as JMetric

    res = _results(0, masks=masks)
    got, want = TMetric().evaluate_all(res), JMetric().evaluate_all(res)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **METRIC, err_msg=k)
    printed = capsys.readouterr().out
    assert all(f"{k}: " in printed for k in want)
    gt = np.stack([r["gt"] for r in res])
    pd_ = np.stack([r["pd"] for r in res])
    np.testing.assert_allclose(TMetric().evaluate_batch(gt, pd_),
                               JMetric().evaluate_batch(gt, pd_), **METRIC)


def test_seg_metrics_match_jax():
    from rdfc_gan_tpu.metrics import seg_metrics as jseg

    r = np.random.RandomState(1)
    gt = r.randint(-1, 7, (3, 17, 19))
    pred = r.randint(0, 6, (3, 17, 19))
    assert tseg.eval_semantic(pred, gt, 6) == jseg.eval_semantic(pred, gt, 6)
    for it in (0, 5, 99):
        assert tseg.poly_lr(0.01, it, 100) == jseg.poly_lr(0.01, it, 100)


def test_resize_matches_cv2_at_the_v1_origin_size():
    """EvalV1's resize of an f32 (228, 304) prediction back to the s2d
    origin (480, 640), INTER_LINEAR, bit for bit."""
    x = np.random.RandomState(2).uniform(-1, 1, (228, 304)).astype(
        np.float32)
    got = cv_ops.resize(x, (640, 480), cv_ops.INTER_LINEAR)
    want = cv2.resize(x, (640, 480), interpolation=cv2.INTER_LINEAR)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- EvalV1 --
def _origin(cls):
    """``cls`` whose test samples carry the frame's uncropped 480x640
    depth as ``gt_depth_origin``, so the predictions are resized back."""
    class Origin(cls):
        def get_test_data(self, idx):
            sample = super().get_test_data(idx)
            sample["gt_depth_origin"] = self._load(idx)[1]
            return sample

    return Origin


class _TModel:
    def __init__(self, preds):
        self.preds, self.i = preds, 0

    def forward_test(self, rgb, raw_depth, **kw):
        p = self.preds[self.i]
        self.i += 1
        return {"pred_depth": torch.from_numpy(p.copy())}


class _JModel(_TModel):
    def forward_test(self, state, rgb, raw_depth):
        p = self.preds[self.i]
        self.i += 1
        return {"pred_depth": p.transpose(0, 2, 3, 1)}


@pytest.fixture(scope="module")
def s2d_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("s2d"))
    write_fixture(root, n_train=2, n_val=4, seed=3)
    return root


@pytest.mark.parametrize("origin", [False, True])
def test_eval_v1_matches_jax(s2d_root, origin):
    """The same predictions (2 batches of 2 at 228x304) through both
    evaluators: with the dataset's ``gt_depth_origin`` (the crop, 228x304)
    and with the uncropped 480x640 depth, which the predictions are
    resized to."""
    from rdfc_gan_tpu.data import DataLoader as JLoader
    from rdfc_gan_tpu.data.nyuv2_s2d import NYUV2S2DDataset as JS2D
    from rdfc_gan_tpu.evaluator.v1_evaluator import EvalV1 as JEval

    tcls, jcls = (_origin(TS2D), _origin(JS2D)) if origin else (TS2D, JS2D)
    r = np.random.RandomState(4)
    preds = [r.uniform(-1, 1, (2, 1, 228, 304)).astype(np.float32)
             for _ in range(2)]
    tl = TLoader(tcls(s2d_root, mode="val"), 2, num_workers=1)
    jl = JLoader(jcls(s2d_root, mode="val"), 2, shuffle=False,
                 drop_last=False)
    tres = TEval(tl).inference(_TModel(preds))
    jres = JEval(jl).inference(_JModel(preds), None)
    assert len(tres) == len(jres) == 4
    for a, b in zip(tres, jres):
        assert a["gt"].shape == b["gt"].shape == ((480, 640) if origin
                                                  else (228, 304))
        np.testing.assert_array_equal(a["gt"], np.asarray(b["gt"]))
        np.testing.assert_array_equal(a["pd"], b["pd"])
    got = TEval(tl).evaluate(_TModel(preds))
    want = JEval(jl).evaluate(_JModel(preds), None)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **METRIC, err_msg=k)


def test_eval_v1_drops_pad_rows():
    """A short last batch is padded by the loader; EvalV1 scores each
    sample once."""
    ds = SyntheticDataset(length=3, height=8, width=8)
    loader = TLoader(ds, 2, num_workers=1)
    preds = [np.zeros((2, 1, 8, 8), np.float32) for _ in range(2)]
    res = TEval(loader).inference(_TModel(preds))
    assert len(res) == 3


# --------------------------------------------------------- point cloud --
def test_point_clouds_match_jax(tmp_path):
    from rdfc_gan_tpu.utils.point_cloud import PointCloudsHandler as JPCH

    intr = (6, 8, 5.2, 5.1, 3.7, 2.9)
    r = np.random.RandomState(5)
    depth = r.uniform(0.5, 4.0, (6, 8)).astype(np.float32)
    depth[r.uniform(size=(6, 8)) < 0.3] = 0.0
    rgb = r.randint(0, 256, (6, 8, 3)).astype(np.uint8)
    got, want = TPCH(intr).img2points(depth, rgb), JPCH(intr).img2points(
        depth, rgb)
    np.testing.assert_array_equal(got, want)
    TPCH(intr).points2pcd(got, str(tmp_path / "t.pcd"))
    JPCH(intr).points2pcd(want, str(tmp_path / "j.pcd"))
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd"
                                                 ).read_bytes()
    from rdfc_gan_torch.utils.point_cloud import get_dist_info

    assert get_dist_info() == (0, 1)


# -------------------------------------------------------------- driver --
def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """Every flag of tools/main_v1.py with its option strings, default,
    type, nargs and choices; the port adds --device alone."""
    t, j = _actions(t_main.build_parser()), _actions(j_main.build_parser())
    assert set(t) - set(j) == {"device"} and set(j) <= set(t)
    for k, a in j.items():
        b = t[k]
        for attr in ("option_strings", "default", "type", "nargs", "choices",
                     "const", "required"):
            assert getattr(a, attr) == getattr(b, attr), (k, attr)
    assert t["device"].default == "cuda"
    for k in ("guidance_pretrained_dir", "gpus", "sample_interval",
              "rgb_branch_l2_loss_coef", "use_pretrained_encoder_decoder"):
        assert "never reads" in t[k].help, k


@pytest.mark.parametrize("extra", [
    [], ["--use_guidance", "--use_nlspn_to_refine"],
    ["--model", "vanilla", "--use_guidance", "--adain_weighting"],
    ["--max_epoch", "7", "--learning_rate", "0.1", "--no_conf",
     "--final_l1_loss_coef", "3", "--fuse_depth_in_rgb_decoder", "WAdaIN"]])
def test_make_cfg_matches_jax(extra):
    args = ["--work_dir", "w"] + extra
    t = t_main.make_cfg(t_main.build_parser().parse_args(args))
    j = j_main.make_cfg(j_main.build_parser().parse_args(args))
    assert t.model.to_dict() == j.model.to_dict()
    for k in ("n_epochs", "lr", "lambda_l1_fusion", "conf_prop",
              "n_critic", "dataset", "batch_size"):
        assert t[k] == j[k], k


# the published RDF-GAN: its guidance, NLSPN and the paper's W-AdaIN
GUIDED = ["--use_guidance", "--use_nlspn_to_refine",
          "--fuse_depth_in_rgb_decoder", "WAdaIN"]


def test_guided_model_is_the_yaml_and_the_benchmark_configuration():
    """The model ``main_v1`` builds under GUIDED is, key for key, the model
    of ``configs/rdf_gan_guided_config.yaml`` and of the benchmark's
    ``rdfgan-guided`` configuration, which names that YAML."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = t_main.make_cfg(t_main.build_parser().parse_args(
        ["--work_dir", "w"] + GUIDED)).model.to_dict()
    with open(os.path.join(root, "configs",
                           "rdf_gan_guided_config.yaml")) as f:
        assert yaml.safe_load(f)["model"] == want
    with open(os.path.join(root, "benchmark", "configs",
                           "rdfgan-guided.json")) as f:
        bench = json.load(f)
    assert bench["model"] == want
    assert bench["port_yaml"] == "configs/rdf_gan_guided_config.yaml"


def _metrics(path):
    text = open(path).read()
    return {k: float(v) for k, v in re.findall(
        r"INFO ([A-Za-z^0-9]+): ([-+0-9.eE]+|nan)\n", text)}


@pytest.fixture
def short_synthetic(monkeypatch):
    """``synthetic`` of 4 samples: one step an epoch at batch 4."""
    monkeypatch.setitem(DATASETS._entries, "synthetic",
                        functools.partial(SyntheticDataset, length=4))


def test_main_v1_trains_then_serves_on_the_cpu(tmp_path, short_synthetic,
                                                monkeypatch):
    """The guided NLSPN model trains an epoch (one step), writes
    epoch_1.pth and evaluates; --inference from it logs the same 8
    metrics; --cal_fps runs (8 images here)."""
    from rdfc_gan_torch import test as port_test

    flags = TINY + ["--use_guidance", "--use_nlspn_to_refine", "--device",
                    "cpu"]
    res = t_main.run(t_main.parse_cfg(flags + [
        "--work_dir", str(tmp_path / "tr"), "--n_epochs", "1",
        "--save_interval", "1", "--log_interval", "1"]))
    assert res["steps"] == 1 and res["g_updates"] == 1
    assert np.isfinite(list(res["losses"].values())).all()
    pth = tmp_path / "tr" / "epoch_1.pth"
    ckpt = torch.load(pth, weights_only=True)
    assert {"G_state_dict", "D_state_dict", "meta"} <= set(ckpt)
    assert ckpt["meta"]["epoch"] == 1
    trained = _metrics(tmp_path / "tr" / "test.log")
    assert len(trained) == 8
    assert t_main.main(flags + ["--work_dir", str(tmp_path / "inf"),
                                "--inference", "--load_from",
                                str(pth)]) == 0
    assert _metrics(tmp_path / "inf" / "test.log") == trained
    monkeypatch.setattr(port_test, "cal_fps", functools.partial(
        port_test.cal_fps, n_images=8, warmup=1))
    res = t_main.run(t_main.parse_cfg(flags + [
        "--work_dir", str(tmp_path / "fps"), "--cal_fps", "--load_from",
        str(pth)]))
    assert res["fps"] > 0 and res["engine"].n_forward == 3


def test_n_critic_updates_g_every_other_step(tmp_path, monkeypatch):
    """--n_critic 2 over two steps: D steps twice, G once (it 0)."""
    monkeypatch.setitem(DATASETS._entries, "synthetic",
                        functools.partial(SyntheticDataset, length=8))
    res = t_main.run(t_main.parse_cfg(TINY + [
        "--device", "cpu", "--work_dir", str(tmp_path), "--n_epochs", "1",
        "--n_critic", "2", "--val_interval", "9", "--save_interval", "9"]))
    assert res["steps"] == 2 and res["g_updates"] == 1
    assert res["engine"].n_step == 2


def test_main_vanilla_takes_a_step(tmp_path, short_synthetic):
    argv = TINY[:TINY.index("--rgb_channels_encoder")] + [
        "--device", "cpu", "--work_dir", str(tmp_path), "--n_epochs", "1",
        "--val_interval", "9", "--save_interval", "1"]
    assert main_vanilla.main(argv) == 0
    ckpt = torch.load(tmp_path / "epoch_1.pth", weights_only=True)
    assert any(k.startswith("rgb_decoder5.") for k in ckpt["G_state_dict"])


def test_dataset_checker_on_synthetic(capsys):
    dataset_checker.main(["--dataset", "synthetic"])
    out = capsys.readouterr().out
    assert "[synthetic] len=64" in out and "rgb: shape=(224, 304, 3)" in out


def test_main_v1_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_main.main(TINY + ["--work_dir", str(tmp_path)])
