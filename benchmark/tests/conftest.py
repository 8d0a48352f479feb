"""Shared helpers of the benchmark's CPU tests: the benchmark folder on
``sys.path`` and cells of both configurations at a tiny size (narrow
widths, 32x48, NLSPN with 3 steps), which the port runs on the CPU with
its kernels' plain versions."""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_FLAGSHIP_MODEL = {
    "type": "RDFCGAN",
    "G_A2B": {"type": "RDFGenerator", "encoder_rgb": "resnet18",
              "encoder_depth": "resnet18", "semantic_channels_in": 3,
              "fuse_depth_in_rgb_decoder": "WAdaIN",
              "rgb_channels_encoder": [16] * 6,
              "depth_channels_encoder": [16] * 6,
              "rgb_channels_decoder": [16] * 4,
              "depth_channels_decoder": [16] * 4},
    "G_B2A": {"type": "ResnetGenerator", "input_channels": 1,
              "output_channels": 3, "ngf": 8, "n_blocks": 2,
              "norm_layer": "IN2d"},
    "Normal_G": {"width": 0.35, "depth": 0.3},
    "Label_G": {"backbone_depth": 50, "planes": [8, 8, 16, 16],
                "stem_features": 8},
    "D_A": {"type": "PatchGANDiscriminator", "in_channels": 1,
            "out_channels": [8, 8, 1], "kernel_size": [4, 4, 4],
            "stride": [2, 2, 1], "padding": [1, 1, 1]},
    "D_B": {"type": "PatchGANDiscriminator", "in_channels": 3,
            "out_channels": [8, 8, 1], "kernel_size": [4, 4, 4],
            "stride": [2, 2, 1], "padding": [1, 1, 1]},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without a card")


def load(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    """The configuration file ``name`` at a tiny size. The served NLSPN
    masks stay f32, as the port serves them on the CPU."""
    cfg = copy.deepcopy(load(f"benchmark/configs/{name}.json"))
    cfg["out_height"], cfg["out_width"] = 32, 48
    cfg.pop("nlspn_serve_masks", None)
    if cfg["model"]["type"] == "RDFGAN":
        g = cfg["model"]["G"]
        for k in ("rgb_channels_encoder", "depth_channels_encoder"):
            g[k] = [8] * 6
        for k in ("rgb_channels_decoder", "depth_channels_decoder"):
            g[k] = [8] * 4
        g["nlspn_configs"]["prop_time"] = 3
        cfg["model"]["D"]["out_channels"] = [8, 16, 16, 16, 1]
    else:
        cfg["model"] = copy.deepcopy(TINY_FLAGSHIP_MODEL)
    return cfg


def tiny_spec(config: str, traffic: str, limits: dict = None):
    """Configuration ``config`` under traffic ``traffic`` at a tiny size
    (batch 4, a pool of 4 batches, 2 of them checked), with the limits of
    the cell of ``BENCHMARK.json`` that pairs them, or ``limits``."""
    from harness import common

    bench = load("BENCHMARK.json")
    cells = [w for w in bench["workloads"]
             if w["config"] == config and w["traffic"] == traffic]
    name = cells[0]["name"] if cells else f"{config}.{traffic}"
    if limits is None:
        limits = load(f"benchmark/workloads/{name}.json")["limits"]

    def reports(m):
        return "workloads" not in m or name in m["workloads"]

    tr = dict(load(f"benchmark/traffic/{traffic}.json"), batch=4, pool=4,
              check_batches=2, warmup_requests=1)
    return common.Spec(cell=dict(name=name, config=config, traffic=traffic,
                                 chips=1),
                       config=tiny_config(config), traffic=tr, limits=limits,
                       end_to_end=[m for m in bench["end_to_end"]
                                   if reports(m)],
                       per_layer=[m for m in bench["per_layer"]
                                  if reports(m)], chips=1)


@pytest.fixture
def cpu():
    import torch

    torch.set_num_threads(2)
    return torch.device("cpu")
