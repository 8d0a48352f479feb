"""Model FLOPs of one served request or one train step, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the reference nets on
the ``meta`` device at the cell's shapes: convolutions and matrix
products, two per multiply-add, forward (and for a step backward) alike,
whatever implements them."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import engines


def _meta_batch(cfg: dict, batch: int, train: bool) -> dict:
    h, w = cfg["out_height"], cfg["out_width"]
    m = "meta"
    out = dict(rgb=torch.zeros(batch, 3, h, w, device=m),
               raw_depth=torch.zeros(batch, 1, h, w, device=m))
    if train:
        out.update(gt_depth=torch.zeros(batch, 1, h, w, device=m),
                   depth_masks=torch.ones(batch, 1, h, w, device=m),
                   gt_normal=torch.zeros(batch, 3, h, w, device=m),
                   normal_masks=torch.ones(batch, h, w, device=m),
                   labels=torch.zeros(batch, h, w, dtype=torch.long,
                                      device=m))
    return out


def count(cfg: dict, train_cfg: dict, batch: int, train: bool) -> int:
    """FLOPs of one request (``train`` False) or one step."""
    # the propagation's form moves no convolution or matrix product; the
    # shift masks' bounds would need values, which meta tensors lack
    cfg = {k: v for k, v in cfg.items() if k != "nlspn_serve_masks"}
    nets = engines.build_nets(cfg, train, "meta")
    eng = engines.Engine(cfg, nets, train_cfg)
    b = _meta_batch(cfg, batch, train)
    draws = None
    if train and eng.kind == "RDFCGAN":
        h, w = cfg["out_height"], cfg["out_width"]
        psp = nets["G_label"]
        shapes = ((batch, psp.master_branch[0].bottleneck[0].out_channels,
                   1, 1), (batch, psp.auxiliary_branch[0].out_channels, 1,
                           1))
        draws = dict(pepper=(torch.ones((), device="meta"),
                             torch.zeros(batch, 1, h, w, device="meta")),
                     keep=tuple(torch.ones(s, dtype=torch.bool,
                                           device="meta") for s in shapes))
    with FlopCounterMode(display=False) as fc:
        if train:
            eng.train_step(b, draws, update=False)
        else:
            eng.forward_test(b["rgb"], b["raw_depth"])
    return int(fc.get_total_flops())
