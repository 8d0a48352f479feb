"""RDFCGAN engine, the flagship cycle GAN with normal and label guidance
(port of rdfc_gan_tpu/engines/rdfc_gan.py; reference lib/models/
rdfc_gan.py:21-413).

Six nets, keyed like the reference checkpoint: G_A2B (RDFGenerator), G_B2A
(ResnetGenerator), disc_A and disc_B (PatchGAN), G_normal (NNET,
``model.Normal_G.width/depth``, B5 by default) and G_label (PSPNet,
``model.Label_G.backbone_depth/planes/stem_features``, the dilated R50 by
default) with ``num_classes`` classes; NNET resizes to (``out_height``,
``out_width``). A serving engine (``is_train`` False) builds the three nets
that ``forward_test`` reads.

    forward_test: G_label(rgb) -> pred_label (skipped with ``depth_only``:
                  pred_depth never reads it), G_normal(rgb) -> pred_normal =
                  the unit xyz of its first 3 channels, then
                  G_A2B(rgb, raw_depth, pred_normal) -> pred_depth.

    train_step (rdfc_gan.py:198-393): four optimizers, G = Adam over G_A2B
    and G_B2A, D = Adam over both discs, Nor = AdamW at 0.5 lr with
    ``weight_decay`` over G_normal, label = Adam over G_label. The G loss,
    with the discs frozen (their running statistics advance):
      G_label, G_normal (norm_normalize) and G_A2B on real_A; pepper noise
      on its depth -> fake_B; G_B2A once on cat(fake_B, real_B) (exact: it
      is instance-norm only) -> rec_A, fake_A; G_label, G_normal and G_A2B
      on fake_A -> rec_B; disc_A(fake_B), disc_B(fake_A); the 16 terms
        GAN x 2 + L1(fake_B, real_B, w) 5 lam_L1 + L1(fake_A, real_A, w)
        3 lam_L1 + L1(rec_A, real_A) lam_A + L1(rec_B, real_B, w) lam_B
        + (CE + 0.4 CE_aux) lam_L1 x 2 + nor_loss 2 lam_L1 x 2
        + Manhattan floor / wall / ceiling lam_L1 x 2,
      logged under the JAX names (17 keys, ``loss_A2B_L1`` with its own
      value). G, Nor and label step first; then the D loss on the detached
      fakes, real before fake for each disc (6 keys), and D steps.

Bug for bug with the JAX engine (rdfc_gan.py:18-24): fake_B is
pepper-noised before the discriminator, the cycle and the A2B L1 term; the
lam_L1 x 5 / x 3 boosts stay; G_normal(fake_A), G_A2B(fake_A) and
G_B2A(fake_B) run once, so G_A2B's BatchNorm statistics advance twice a
step. The step's draws (the pepper noise's batch uniform and field, and
the two keep masks of G_label's dropouts, shared by its two applications
as JAX's one dropout key gives) come from ``step_generator``, or are
handed in (``draws``), as the tests hand in JAX's.

At a world size above 1 (``parallel``) each rank runs the step on its
shard of the global batch: the losses are its shares of the global ones
(``losses``: global denominators; the image weight's mask sum is summed
over the ranks), the draws are made at the global batch's shape and each
rank takes its rows (the pepper's batch uniform is one scalar on every
rank), and each optimizer's gradients are summed over the ranks before
its clip and step.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..losses import (GANLoss, l1_loss, manhattan_loss, nor_loss,
                      norm_normalize, softmax_cross_entropy_loss)
from ..losses.gan_loss import global_count
from ..models.label_net import PSPNet
from ..models.normal_net import NNET
from ..parallel import all_reduce_grads, rank_rows, spatial, world_size
from ..registry import MODELS, build_discriminator, build_generator
from ..utils import pretrained
from ..utils.image_ops import add_pepper_noise, pepper_draw
from .base import BaseEngine, clip_gradients, make_optimizer

NET_KEYS = ("G_A2B", "G_B2A", "disc_A", "disc_B", "G_normal", "G_label")
# which nets each optimizer steps
OPT_NETS = {"G": ("G_A2B", "G_B2A"), "Nor": ("G_normal",),
            "label": ("G_label",), "D": ("disc_A", "disc_B")}


@contextlib.contextmanager
def _frozen(*modules: torch.nn.Module):
    """No parameter gradients of ``modules`` inside the block."""
    flags = [(p, p.requires_grad) for m in modules for p in m.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in flags:
            p.requires_grad_(f)


class RDFCGAN(BaseEngine):
    OPT_NETS = OPT_NETS

    def __init__(self, cfg, is_train: bool = False, steps_per_epoch: int = 1):
        super().__init__(cfg, is_train, steps_per_epoch)
        ncfg = cfg.model.get("Normal_G") or {}
        lcfg = cfg.model.get("Label_G") or {}
        nets = {
            "G_A2B": build_generator(cfg.model.G_A2B.to_dict()),
            "G_normal": NNET(cfg.out_height, cfg.out_width,
                             width=ncfg.get("width", 1.6),
                             depth=ncfg.get("depth", 2.2)),
            "G_label": PSPNet(
                cfg.num_classes,
                backbone_depth=lcfg.get("backbone_depth", 50),
                planes=tuple(lcfg.get("planes", (64, 128, 256, 512))),
                stem_features=lcfg.get("stem_features", 64)),
        }
        if is_train:
            nets["G_B2A"] = build_generator(cfg.model.G_B2A.to_dict())
            nets["disc_A"] = build_discriminator(cfg.model.D_A.to_dict())
            nets["disc_B"] = build_discriminator(cfg.model.D_B.to_dict())
        self.modules = {k: nets[k].to(self.device).eval()
                        for k in NET_KEYS if k in nets}
        self._load_pretrained()
        # forward_test calls served, so a caller can relate kernel launch
        # counts to requests
        self.n_forward = 0
        if not is_train:
            return
        self.criterion_gan = GANLoss(cfg.gan_loss_type)
        for name, keys in OPT_NETS.items():
            params = [p for k in keys for p in self.modules[k].parameters()]
            extra = (dict(lr_mult=0.5, kind="adamw",
                          weight_decay=cfg.weight_decay)
                     if name == "Nor" else {})
            self.optimizers[name], self.schedulers[name] = make_optimizer(
                cfg, params, self.steps_per_epoch, **extra)
        self.n_step = 0

    def _load_pretrained(self):
        """The configured torsos, as the JAX ``init_state`` loads them
        (rdfc_gan.py:155-190): imagenet resnet into G_A2B's two branches,
        the timm B5 into G_normal's encoder, the dilated R50 into G_label's
        backbone. Each path is checked before any file is read."""
        paths = [pretrained.configured(self.cfg.get(k)) for k in (
            "pretrained_resnet_path", "pretrained_normal_path",
            "pretrained_label_path")]
        for path, net, load in zip(paths,
                                   ("G_A2B", "G_normal", "G_label"),
                                   (pretrained.load_resnet_torsos,
                                    pretrained.load_efficientnet_torso,
                                    pretrained.load_pspnet_backbone)):
            if path:
                load(self.modules[net], pretrained.load_torch_state_dict(path))

    @torch.inference_mode()
    def forward_test(self, rgb: torch.Tensor, raw_depth: torch.Tensor,
                     depth_only: bool = False, grid=None,
                     assemble: bool = False) -> dict:
        """rgb: (B,3,H,W); raw_depth: (B,1,H,W), on the engine's device.
        Returns pred_depth (B,1,H,W), pred_normal (B,3,H,W) and, unless
        ``depth_only``, pred_label (B,num_classes,H,W) logits.

        ``grid`` (``parallel.grid``, a ``model`` axis over M ranks): rgb
        and raw_depth are this data row's rows at the whole width W, which
        M must divide; the rank serves its W / M columns and returns its
        shards of the outputs, or with ``assemble`` the whole width
        (``parallel.spatial.serve``)."""
        self.n_forward += 1
        if grid is not None:
            return spatial.serve(self._forward_test, grid, rgb, raw_depth,
                                 depth_only, assemble=assemble)
        return self._forward_test(rgb, raw_depth, depth_only)

    def _forward_test(self, rgb: torch.Tensor, raw_depth: torch.Tensor,
                      depth_only: bool) -> dict:
        mods = {k: m.eval() for k, m in self.modules.items()}
        if not depth_only:
            label = mods["G_label"](rgb)
        pred_normal = norm_normalize(mods["G_normal"](rgb))
        ret = mods["G_A2B"](rgb, raw_depth, pred_normal)
        out = dict(pred_depth=ret["pred_depth"], pred_normal=pred_normal)
        if not depth_only:
            out["pred_label"] = label
        if "nlspn_max_offset" in ret:
            out["nlspn_max_offset"] = ret["nlspn_max_offset"]
        return out

    __call__ = forward_test

    def step_generator(self, step: int) -> torch.Generator:
        """The generator of step ``step``'s draws, seeded from (seed, global
        step); JAX splits a per-step key the same way, but the bits
        differ, so tests hand the draws in."""
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(int(self.cfg.seed) * 1000003 + int(step))

    def draws(self, step: int, batch: Dict[str, torch.Tensor]) -> dict:
        """Step ``step``'s random draws: ``pepper`` (the batch uniform and
        the (B,1,H,W) field of ``add_pepper_noise``) and ``keep`` (the
        keep masks of G_label's two dropouts, kept with probability 0.9),
        drawn at the global batch's shape; this rank's rows are returned."""
        gen = self.step_generator(step)
        b, c, h, w = batch["gt_depth"].shape
        b *= world_size()
        active, field = pepper_draw((b, c, h, w), gen, self.device)
        keep = tuple(rank_rows(torch.rand(s, generator=gen,
                                          device=self.device) < 0.9)
                     for s in self.modules["G_label"].dropout_shapes(b))
        return dict(pepper=(active, rank_rows(field)), keep=keep)

    @torch.inference_mode()
    def save_samples(self, fixed_samples: Dict[str, torch.Tensor],
                     save_dir: str, iters: int, prefix: str = "sample",
                     batch_size: int = 8):
        """Image-grid dumps of the cycle (JAX rdfc_gan.py:436-490; reference
        rdfc_gan.py:342-410), in eval mode: ``{prefix}-{iters:06d}-A-B.png``
        (raw depth, gt depth, fake_B), ``-B-A.png`` (rgb, fake_A = G_B2A(gt),
        rec_A = G_B2A(fake_B)), ``-normal.png`` (gt, predicted) and
        ``-label.png`` (gt, predicted, in the palette). PNG, not the JAX
        package's JPEG (``utils.save_vis``)."""
        import os

        from ..utils import save_vis

        def nhwc(t):
            t = t.detach().float().cpu()
            return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()

        os.makedirs(save_dir, exist_ok=True)
        rgb, gt_depth = fixed_samples["rgb"], fixed_samples["gt_depth"]
        aux = fixed_samples["raw_depth"]
        ret = self.forward_test(rgb=rgb, raw_depth=aux)
        lbl = ret["pred_label"]
        lbl = lbl[0] if isinstance(lbl, (list, tuple)) else lbl
        G_B2A = self.modules["G_B2A"].eval()
        fake_A = G_B2A(gt_depth)
        rec_A = G_B2A(ret["pred_depth"])
        p = os.path.join(save_dir, f"{prefix}-{iters:06d}")
        n = int(self.cfg.num_classes)
        save_vis.save_image_grid(
            f"{p}-A-B.png", [nhwc(aux), nhwc(gt_depth),
                             nhwc(ret["pred_depth"])],
            num_imgs_per_scene=3, batch_size=batch_size)
        save_vis.save_image_grid(
            f"{p}-B-A.png", [nhwc(rgb), nhwc(fake_A), nhwc(rec_A)],
            num_imgs_per_scene=3, batch_size=batch_size)
        save_vis.save_image_grid(
            f"{p}-normal.png", [nhwc(fixed_samples["gt_normal"]),
                                nhwc(ret["pred_normal"])],
            num_imgs_per_scene=2, batch_size=batch_size)
        pred_lbl = save_vis.color_label(
            lbl.argmax(1).cpu().numpy(), save_vis.PALETTE, n)
        gt_lbl = save_vis.color_label(
            fixed_samples["labels"].cpu().numpy(), save_vis.PALETTE, n)
        save_vis.save_image_grid(
            f"{p}-label.png", [gt_lbl / 255.0, pred_lbl / 255.0],
            num_imgs_per_scene=2, batch_size=batch_size)
        return p

    def _optimize(self, names, loss: torch.Tensor):
        """One backward of ``loss``, then each named optimizer's clip, step
        and schedule, in order."""
        for name in names:
            self.optimizers[name].zero_grad(set_to_none=True)
        loss.backward()
        for name in names:
            all_reduce_grads(p for k in OPT_NETS[name]
                             for p in self.modules[k].parameters())
            clip_gradients(self.cfg, [p for k in OPT_NETS[name]
                                      for p in self.modules[k].parameters()])
            self.optimizers[name].step()
            self.schedulers[name].step()

    def _g_loss(self, batch, draws):
        cfg, m = self.cfg, self.modules
        real_A, real_B = batch["rgb"], batch["gt_depth"]
        aux_A = batch["raw_depth"]
        gt_normal, gt_label = batch["gt_normal"], batch["labels"]
        norm_mask = batch["normal_masks"]
        mask = batch.get("depth_masks")
        if mask is None:
            mask = torch.ones_like(real_B)
        w_img = mask / (global_count(mask.sum()) + 1e-6)
        lam_A, lam_B, lam_l1 = cfg.lambda_A, cfg.lambda_B, cfg.lambda_L1
        keep = draws["keep"]

        # --- A -> B
        lbl_realA = m["G_label"](real_A, keep=keep)
        nrm_realA = norm_normalize(m["G_normal"](real_A))
        retAB = m["G_A2B"](real_A, aux_A, nrm_realA)
        fake_B = add_pepper_noise(retAB["pred_depth"], *draws["pepper"])
        # G_B2A is instance-norm only: one batch of both inputs is exact
        rec_A, fake_A = m["G_B2A"](torch.cat([fake_B, real_B])).chunk(2)

        # --- B -> A
        lbl_fakeA = m["G_label"](fake_A, keep=keep)
        nrm_fakeA = norm_normalize(m["G_normal"](fake_A))
        rec_B = m["G_A2B"](fake_A, aux_A, nrm_fakeA)["pred_depth"]

        # --- adversarial terms (the discs frozen; statistics advance)
        loss_G_A2B = self.criterion_gan(m["disc_A"](fake_B), True)
        loss_G_B2A = self.criterion_gan(m["disc_B"](fake_A), True)
        loss_A2B_L1 = l1_loss(fake_B, real_B, weight=w_img) * lam_l1 * 5
        loss_B2A_L1 = l1_loss(fake_A, real_A, weight=w_img) * lam_l1 * 3
        loss_cycle_A = l1_loss(rec_A, real_A) * lam_A
        loss_cycle_B = l1_loss(rec_B, real_B, weight=w_img) * lam_B

        def label_loss(lbl):
            return (softmax_cross_entropy_loss(lbl[0], gt_label)
                    + softmax_cross_entropy_loss(lbl[1], gt_label) * 0.4
                    ) * lam_l1

        def manhattan(nrm, lbl):
            return manhattan_loss(nrm, lbl[0], norm_mask, cfg.label_wall,
                                  cfg.label_floor, cfg.label_ceiling, lam_l1)

        loss_normal_A2B = nor_loss(nrm_realA, gt_normal, norm_mask) \
            * lam_l1 * 2
        loss_normal_B2A = nor_loss(nrm_fakeA, gt_normal, norm_mask) \
            * lam_l1 * 2
        fl_A, wl_A, cl_A = manhattan(nrm_realA, lbl_realA)
        fl_B, wl_B, cl_B = manhattan(nrm_fakeA, lbl_fakeA)
        log = dict(
            loss_G_A2B=loss_G_A2B, loss_G_B2A=loss_G_B2A,
            loss_A2B_L1=loss_A2B_L1, loss_B2A_L1=loss_B2A_L1,
            loss_cycle_A=loss_cycle_A, loss_cycle_B=loss_cycle_B,
            loss_label_A2B=label_loss(lbl_realA),
            loss_label_B2A=label_loss(lbl_fakeA),
            loss_normal_A2B=loss_normal_A2B, loss_normal_B2A=loss_normal_B2A,
            floor_loss_A2B=fl_A, wall_loss_A2B=wl_A, ceiling_loss_A2B=cl_A,
            floor_loss_B2A=fl_B, wall_loss_B2A=wl_B, ceiling_loss_B2A=cl_B)
        log["loss_G"] = sum(log.values())
        return log, fake_B, fake_A

    def train_step(self, batch: Dict[str, torch.Tensor],
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One step: the G loss and the G, Nor and label updates, then the D
        loss and the D update. ``draws`` (``pepper``: (batch uniform,
        (B,1,H,W) field); ``keep``: G_label's two keep masks) default to
        ``draws(self.n_step, batch)``. Returns the 23 losses as detached
        device scalars: reading them is the caller's one device sync."""
        m = self.modules
        for net in m.values():
            net.train()
        if draws is None:
            draws = self.draws(self.n_step, batch)
        with _frozen(m["disc_A"], m["disc_B"]), self.autocast():
            log, fake_B, fake_A = self._g_loss(batch, draws)
        self._optimize(("G", "Nor", "label"), log["loss_G"])

        real_A, real_B = batch["rgb"], batch["gt_depth"]
        gan = self.criterion_gan
        with self.autocast():
            d_log = {}
            for d, real, fake in (("A", real_B, fake_B),
                                  ("B", real_A, fake_A)):
                disc = m[f"disc_{d}"]
                r = gan(disc(real), True)
                f = gan(disc(fake.detach()), False)
                d_log.update({f"loss_D_{d}": (r + f) * 0.5,
                              f"loss_D_{d}_real": r, f"loss_D_{d}_fake": f})
        self._optimize(("D",), d_log["loss_D_A"] + d_log["loss_D_B"])
        log.update(d_log)
        self.n_step += 1
        return {k: v.detach().float() for k, v in log.items()}


MODELS.register("RDFCGAN")(RDFCGAN)
