"""End-to-end serving parity: ``python -m rdfc_gan_torch.test`` on the CPU
against the JAX package's ``Eval`` with the same weights, on a tiny NLSPN
RDF-GAN config. ``--batch_size 3`` does not divide the 64-image synthetic
split, so the padded final batch and the dropping of its pad rows are
exercised on both sides.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from rdfc_gan_torch.cli import parse_config
from rdfc_gan_torch.registry import build_generator
from rdfc_gan_torch.test import main
from rdfc_gan_tpu.metrics import METRIC_NAMES

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

TINY = """\
model:
  type: RDFGAN
  G:
    type: RDFGenerator
    rgb_channels_encoder: [16, 16, 16, 16, 16, 16]
    depth_channels_encoder: [16, 16, 16, 16, 16, 16]
    rgb_channels_decoder: [16, 16, 16, 16]
    depth_channels_decoder: [16, 16, 16, 16]
    use_nlspn_refine: true
    nlspn_configs: {prop_kernel: 3, prop_time: 4, affinity: TGASS,
                    affinity_gamma: 0.5, conf_prop: true,
                    preserve_input: false}
    packed_width: true
  D:
    type: PatchGANDiscriminator
    in_channels: 1
"""


@pytest.fixture
def served(tmp_path):
    """A tiny config, a seeded reference-schema .pth, and the CLI args."""
    cfg_path = tmp_path / "tiny_nlspn.yaml"
    cfg_path.write_text(TINY)
    args = ["--dataset", "synthetic", "--model_cfg_path", str(cfg_path),
            "--work_dir", str(tmp_path / "work"), "--out_height", "32",
            "--out_width", "48", "--batch_size", "3", "--num_workers", "2"]
    cfg = parse_config(args + ["--device", "cpu"])
    from rdfc_gan_torch import models  # noqa: F401

    torch.manual_seed(0)
    g = build_generator(cfg.model.G.to_dict())
    with torch.no_grad():
        for n, p in g.named_parameters():
            if not n.endswith(("aff_scale_const", ".w", ".b", ".w_conf")):
                p.uniform_(-0.15, 0.15)
        oa = g.nlspn_refine_module.prop_layer.conv_offset_aff
        oa.weight.uniform_(-0.05, 0.05)
        oa.bias.uniform_(-0.3, 0.3)
    pth = tmp_path / "G.pth"
    torch.save({"G_state_dict": g.state_dict()}, str(pth))
    return args + ["--load_from", str(pth)], tmp_path / "work" / "test.log"


def _logged(log_path, key):
    vals = re.findall(rf"INFO {re.escape(key)}: ([-+0-9.eE]+)",
                      log_path.read_text())
    assert vals, f"{key} not in {log_path}"
    return float(vals[-1])


def _jax_metrics(args, pth):
    from rdfc_gan_tpu.cli import parse_config as jax_parse_config
    from rdfc_gan_tpu.data import DataLoader, SyntheticDataset
    from rdfc_gan_tpu.engines import build_engine
    from rdfc_gan_tpu.evaluator import Eval
    from rdfc_gan_tpu.utils.torch_convert import (convert_rdf_generator,
                                                  load_torch_state_dict)

    cfg = jax_parse_config(args)
    ds = SyntheticDataset(height=cfg.out_height, width=cfg.out_width,
                          num_classes=cfg.num_classes, seed=cfg.seed)
    loader = DataLoader(ds, cfg.batch_size, shuffle=False, drop_last=False,
                        with_indices=True)
    engine = build_engine(cfg, is_train=False)
    state = engine.init_state(jax.random.PRNGKey(0), next(iter(loader)))
    sd = {k[len("G."):]: v for k, v in load_torch_state_dict(pth).items()}
    tree = convert_rdf_generator(sd, use_nlspn_refine=True)
    state = state.replace(
        params={**state.params, "G": tree["params"]},
        batch_stats={**state.batch_stats, "G": tree["batch_stats"]})
    return Eval(loader).evaluate(engine, state)


def test_serving_metrics_match_jax_eval(served):
    args, log_path = served
    assert main(args + ["--device", "cpu"]) == 0
    got = {k: _logged(log_path, k) for k in METRIC_NAMES}
    want = _jax_metrics(args[:-2], args[-1])
    assert all(np.isfinite(v) for v in got.values())
    for k in METRIC_NAMES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_cal_fps_runs(served):
    args, log_path = served
    assert main(args + ["--device", "cpu", "--cal_fps"]) == 0
    assert _logged(log_path, "FPS") > 0
    assert os.path.exists(log_path)
