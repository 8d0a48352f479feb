"""Convert a reference PyTorch checkpoint into the JAX package's ``.ckpt``
(port of tools/convert_torch_ckpt.py, with its flags).

    python -m rdfc_gan_torch.tools.convert_torch_ckpt --torch_ckpt ref.pth \\
        --model_cfg_path configs/rdf_cycle_patchgan_config.yaml \\
        --out conv.ckpt [--num_classes 14]

The reference schema (``{net}_state_dict`` per net, lib/utils/
checkpoint.py:27-30) is the port's, so the nets go through the port's
copies of the JAX converters (``utils.torch_convert``): disc_A / disc_B
(PatchGAN), G_B2A (ResnetGenerator), G_A2B (RDFGenerator, with NLSPN where
the file has it), G_normal (NNET) and G_label (PSPNet); any other net is
reported ``UNRECOGNIZED`` and left at init. The file written is the JAX
tool's: an eval-mode GANTrainState (``step`` 0, no optimizer states) of
the config's engine, the converted nets, and ``meta={converted_from}``,
which the JAX drivers' ``--load_from`` and the port's read. A net of the
engine that the ``.pth`` lacks stays at the port's own seeded init (as
the JAX tool's stays at its own; the two packages draw different numbers,
so only the leaves that come from the ``.pth`` are the JAX tool's), in
the JAX eval-mode tree (G_label without its aux head).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def convert_reference_state(sd, cfg, params, stats):
    """Map a flat reference state dict ({net}.{param}, numpy) onto the
    ``params`` / ``batch_stats`` trees (keyed by net) in place. Returns
    {net: 'converted (N tensors)' or an 'UNRECOGNIZED' note}."""
    from ..utils.convert import model_options
    from ..utils.torch_convert import (convert_nnet, convert_patchgan,
                                       convert_pspnet, convert_rdf_generator,
                                       convert_resnet_generator)

    report = {}
    for net in sorted({k.split(".")[0] for k in sd}):
        net_sd = {k.split(".", 1)[1]: v for k, v in sd.items()
                  if k.startswith(net + ".")}
        if net in ("disc_A", "disc_B"):
            tree = convert_patchgan(net_sd)
        elif net == "G_B2A":
            tree = convert_resnet_generator(net_sd)
        elif net == "G_A2B":
            g = model_options(cfg, net)
            tree = convert_rdf_generator(
                net_sd,
                use_nlspn_refine=any(
                    k.startswith("nlspn_refine_module.") for k in net_sd),
                adain_weighting=bool(g.get("adain_weighting", False)),
                fuse=g.get("fuse_depth_in_rgb_decoder", "WAdaIN"))
        elif net == "G_normal":
            tree = convert_nnet(net_sd, depth=model_options(cfg, net).get(
                "depth", 2.2))
        elif net == "G_label":
            tree = convert_pspnet(net_sd)
        else:
            report[net] = "UNRECOGNIZED: left at init"
            continue
        params[net] = tree["params"]
        if tree.get("batch_stats"):
            stats[net] = tree["batch_stats"]
        report[net] = f"converted ({len(net_sd)} tensors)"
    return report


def init_trees(cfg):
    """The eval-mode JAX trees of the config's engine from the port's
    seeded init: every net of the training engine (the JAX eval template
    initialises all of them), G_label without its aux head."""
    from ..engines import build_engine
    from ..models import PSPNet
    from ..utils.torch_convert import net_tree_to_jax

    torch.manual_seed(0)
    engine = build_engine(cfg, is_train=True)
    params, stats = {}, {}
    for name, mod in engine.modules.items():
        sd = {k: v.detach().cpu().numpy() for k, v in
              mod.state_dict().items()
              if not (isinstance(mod, PSPNet)
                      and k.startswith("auxiliary_branch."))}
        t = net_tree_to_jax(cfg, name, mod, sd)
        params[name], stats[name] = t["params"], t["batch_stats"]
    return params, stats


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--model_cfg_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num_classes", type=int, default=14)
    args = p.parse_args(argv)

    from ..config import default_config, load_config
    from ..utils.jax_checkpoint import sorted_tree, write_state
    from ..utils.pretrained import load_torch_state_dict

    cfg = default_config()
    load_config(cfg, args.model_cfg_path)
    cfg.merge(dict(num_classes=args.num_classes, device="cpu"))

    sd = {k: v.numpy() for k, v in
          load_torch_state_dict(args.torch_ckpt).items()}
    print(f"nets in torch ckpt: {sorted({k.split('.')[0] for k in sd})}")
    params, stats = init_trees(cfg)
    report = convert_reference_state(sd, cfg, params, stats)
    for net, msg in report.items():
        print(f"{net}: {msg}")
    write_state(args.out, {"step": np.asarray(0, np.int32),
                           "params": sorted_tree(params),
                           "batch_stats": sorted_tree(stats),
                           "opt_states": {}},
                meta=dict(converted_from=args.torch_ckpt))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
