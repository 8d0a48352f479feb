"""Seeded weights of the reference nets, made on the device in one draw.

Every floating entry of every net's state dict, in the order of
``state_dict()``, takes its slice of one uniform draw u in [0, 1) from a
``torch.Generator`` on the device seeded by the run's seed:

  * a conv or linear weight: U(-b, b) with b = sqrt(3 / fan_in), which
    keeps the second moment of the activations from layer to layer;
    EqualLinear's ``weight_orig`` (scaled by sqrt(2 / fan_in) at its call)
    U(-sqrt 3, sqrt 3), unit variance;
  * a bias: U(-0.1, 0.1); W-AdaIN's style bias 1 + U(-0.1, 0.1) on its
    gamma half;
  * a BatchNorm: weight 1 + U(-0.1, 0.1), bias and running mean
    U(-0.1, 0.1), running variance 1 + U(0, 0.2);
  * a PReLU slope 0.25 + U(-0.05, 0.05);
  * NLSPN's frozen dummies and affinity scale as the reference
    initialises them (w = 1, b = 0, w_conf = 1, aff_scale_const =
    gamma x neighbours, gamma the one its module was built with), and its
    offset/affinity conv a random weight whose offset rows are scaled to a
    stated largest offset on a probe batch (``offset_scale``) and whose
    affinity rows are scaled by ``AFF_WEIGHT_SCALE`` and raised by
    ``AFF_BIAS``. Every NLSPN inside the generator ``G`` is so treated,
    however deep its net holds it.
"""

from __future__ import annotations

import math

import torch

from . import models

# NLSPN's affinity rows: weights scaled down and the bias raised, so that
# tanh of the raw affinity is positive nearly everywhere, as a trained
# NLSPN's affinities are; each step is then a convex combination of its
# neighbours, which does not amplify rounding (mixed-sign random
# affinities grew a served map 2e3-fold over 18 steps)
AFF_WEIGHT_SCALE = 0.1
AFF_BIAS = 1.5


def _kind(sd: dict, name: str, t: torch.Tensor) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if "prop_layer" in name and leaf in ("w", "w_conf"):
        return "one"
    if "prop_layer" in name and leaf in ("b", "aff_scale_const"):
        return leaf
    if leaf == "running_var":
        return "var"
    if leaf == "weight_orig":
        return "unit"
    if leaf == "weight" and t.dim() == 1:
        if name[:-len("weight")] + "running_var" in sd:
            return "gamma"
        return "prelu" if t.numel() == 1 else "small"
    if leaf == "weight":
        return "fan_in"
    return "small"


def fill(nets: dict, seed: int, device) -> None:
    """Fill every net's state in place from one draw of the seed's
    generator on ``device``."""
    entries = []
    for key in sorted(nets):
        sd = nets[key].state_dict(keep_vars=True)
        for name, t in sd.items():
            if t.dtype.is_floating_point:
                entries.append((t, _kind(sd, name, t)))
            else:
                with torch.no_grad():
                    t.zero_()
    total = sum(t.numel() for t, _ in entries)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for t, kind in entries:
            n = t.numel()
            v = u[off:off + n].view(t.shape)
            off += n
            if kind == "fan_in":
                t.copy_((2 * v - 1) * math.sqrt(3.0 / max(1, t[0].numel())))
            elif kind == "unit":
                t.copy_((2 * v - 1) * math.sqrt(3.0))
            elif kind == "gamma":
                t.copy_(1 + (2 * v - 1) * 0.1)
            elif kind == "var":
                t.copy_(1 + v * 0.2)
            elif kind == "prelu":
                t.copy_(0.25 + (2 * v - 1) * 0.05)
            elif kind == "one":
                t.fill_(1.0)
            elif kind == "b":
                t.zero_()
            elif kind == "aff_scale_const":
                pass  # set per module below
            else:
                t.copy_((2 * v - 1) * 0.1)
        for net in nets.values():
            for mod in net.modules():
                if isinstance(mod, models.TorchWAdaIN):
                    bias = mod.style.linear.bias
                    bias[:bias.numel() // 2] += 1.0
                if isinstance(mod, models.TorchNLSPN):
                    mod.aff_scale_const.fill_(
                        mod.affinity_gamma * mod.num
                        if mod.affinity == "TGASS"
                        else float(mod.num) if mod.affinity == "TC" else 1.0)


def offset_convs(generator) -> list:
    """The offset/affinity conv of every NLSPN refinement inside
    ``generator``, however deep."""
    return [m.prop_layer.conv_offset_aff for m in generator.modules()
            if isinstance(m, models.TorchNLSPNRefineModule)]


def _n_off(conv) -> int:
    return 2 * (conv.out_channels // 3)


@torch.no_grad()
def offset_scale(generator, rgb, raw_depth, target: float,
                 train: bool = False) -> float:
    """The scale of the offset rows of ``generator``'s NLSPN
    offset/affinity convs under which the largest |offset| over them on the
    probe batch is ``target``, with BatchNorm in eval mode (as served) or,
    with ``train``, on the batch's statistics (as trained; the running
    statistics are put back)."""
    convs = offset_convs(generator)
    seen = []
    hooks = [c.register_forward_hook(lambda m, i, o: seen.append(
        o[:, :_n_off(m)].abs().max())) for c in convs]
    buffers = {k: v.clone() for k, v in generator.named_buffers()}
    generator.train(train)(rgb, raw_depth)
    for k, v in generator.named_buffers():
        v.copy_(buffers[k])
    for h in hooks:
        h.remove()
    return target / float(max(seen))


def make(cfg: dict, train: bool, seed: int, device, probe=None,
         scale: float = None, probe_train: bool = False):
    """The configuration's reference nets on ``device`` with the seed's
    weights. With NLSPN, the offset rows are scaled by ``scale``, or to
    the configuration's ``nlspn_target_offset`` on ``probe`` (rgb,
    raw_depth). Returns (nets, scale)."""
    from . import engines

    nets = engines.build_nets(cfg, train, "meta")
    for k in nets:
        nets[k] = nets[k].to_empty(device=device)
    fill(nets, seed, device)
    convs = offset_convs(nets["G"]) if "G" in nets else []
    if convs:
        with torch.no_grad():
            for conv in convs:
                conv.weight[_n_off(conv):] *= AFF_WEIGHT_SCALE
                conv.bias[_n_off(conv):] += AFF_BIAS
        if scale is None:
            scale = offset_scale(nets["G"], *probe,
                                 cfg["nlspn_target_offset"], probe_train)
        with torch.no_grad():
            for conv in convs:
                conv.weight[:_n_off(conv)] *= scale
                conv.bias[:_n_off(conv)] *= scale
    return nets, scale
