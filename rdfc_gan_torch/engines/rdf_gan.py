"""RDFGAN engine: generator G and PatchGAN discriminator D (port of
rdfc_gan_tpu/engines/rdf_gan.py; reference lib/models/rdf_gan.py:18-251).

  * forward_test: G(rgb, raw_depth) in eval mode, no gradient. A
    generator's v1 5-tuple becomes the dict (``_as_ret_dict``), in the step
    too, so the v1 generators drive the engine.
  * train_step: one G forward in train mode, then the D update FIRST
    (rdf_gan.py:192-196), then (``update_g``) the G update against the
    updated D:
      D loss = (GAN(D(fake.detach()), F) + GAN(D(real_B), T)) / 2, plus the
      wgangp gradient penalty (D in eval mode on the stats of the two
      passes); wgan clips D's parameters after its update.
      G loss = GAN(D(depth_map_1), T) + 100 * three mask-weighted L1 terms
      (rgb branch, depth branch, fusion).

The JAX step runs G twice on the same parameters and batch (once for the
fake, once under the G gradient) and keeps the batch statistics of one;
here G runs once and the G loss reuses its graph, as the reference does,
which gives the same numbers. D runs in train mode in the G loss and
updates its running statistics a third time, as JAX's ``ds2``. Only D's
optimizer sees the D loss and only G's the G loss: D's parameters take no
gradient while the G loss is differentiated.

At a world size above 1 (``parallel``) each rank runs the step on its
shard of the global batch: the losses are its shares of the global ones
(``losses``: global denominators; the image weight's mask sum is summed
over the ranks), the wgangp draw is the global batch's, and each
optimizer's gradients are summed over the ranks before the clip and the
step, so every rank takes the global step.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from ..losses import GANLoss, gradient_penalty, l1_loss
from ..losses.gan_loss import global_count
from ..models.rdf_generator import RDFGenerator
from ..parallel import all_reduce_grads, spatial
from ..registry import MODELS, build_discriminator, build_generator
from ..utils import pretrained
from ..utils.profiling import span
from .base import BaseEngine, clip_gradients, make_optimizer


def _as_ret_dict(ret):
    """A generator's output as the engine's dict (rdf_gan.py:30-38): the
    v1 5-tuple (depth_map_1, confidence_map_1, depth_map_2,
    confidence_map_2, pred_depth) of ``DCVGANGeneratorVanilla`` or a
    ``return_tuple`` DCVGANGenerator gets the dict keys; a dict stays."""
    if isinstance(ret, (tuple, list)):
        d1, c1, d2, c2, f = ret
        return dict(depth_map_1=d1, confidence_map_1=c1, depth_map_2=d2,
                    confidence_map_2=c2, pred_depth=f)
    return ret


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """Take no parameter gradients of ``module`` inside the block (the
    reference's set_requires_grad(D, False) around the G loss)."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in flags:
            p.requires_grad_(f)


class RDFGAN(BaseEngine):
    def __init__(self, cfg, is_train: bool = False, steps_per_epoch: int = 1):
        super().__init__(cfg, is_train, steps_per_epoch)
        G = build_generator(cfg.model.G.to_dict()).to(self.device)
        self.modules = {"G": G.eval()}
        # imagenet torsos for G's two branches, as the JAX init_state
        # (rdf_gan.py:77-88); G_normal / G_label paths are not read here
        pth = pretrained.configured(cfg.get("pretrained_resnet_path"))
        if pth:
            pretrained.load_resnet_torsos(
                G, pretrained.load_torch_state_dict(pth))
        # generator forwards served, so a caller can relate kernel launch
        # counts to requests
        self.n_forward = 0
        if not is_train:
            return
        D = build_discriminator(cfg.model.D.to_dict()).to(self.device)
        self.modules["D"] = D.train()
        self.criterion_gan = GANLoss(cfg.gan_loss_type)
        for name in ("G", "D"):
            self.optimizers[name], self.schedulers[name] = make_optimizer(
                cfg, self.modules[name].parameters(), self.steps_per_epoch)
        self.n_step = 0

    @torch.inference_mode()
    def forward_test(self, rgb: torch.Tensor, raw_depth: torch.Tensor,
                     depth_only: bool = False, grid=None,
                     assemble: bool = False) -> dict:
        """rgb: (B,3,H,W); raw_depth: (B,1,H,W), on the engine's device.
        ``depth_only`` is accepted for the driver's interface: this engine
        has no auxiliary heads to skip. ``grid`` and ``assemble``: width
        sharding as ``RDFCGAN.forward_test`` (an ``RDFGenerator`` G; its
        NLSPN block runs on the row's gathered width).

        Spans (``utils.profiling.span``): ``rdfc.serve`` around the call,
        ``rdfc.G`` around the net inside it."""
        del depth_only
        with span("rdfc.serve"):
            self.n_forward += 1
            G = self.modules["G"].eval()

            def serve(r, d):
                with span("rdfc.G"):
                    return _as_ret_dict(G(r, d))

            if grid is None:
                return serve(rgb, raw_depth)
            if grid.M > 1 and not isinstance(G, RDFGenerator):
                raise NotImplementedError(
                    f"width sharding covers the RDFGenerator, not "
                    f"{type(G).__name__}")
            return spatial.serve(serve, grid, rgb, raw_depth,
                                 assemble=assemble)

    __call__ = forward_test

    def step_generator(self, step: int) -> torch.Generator:
        """The per-step generator of the gradient penalty's interpolation,
        seeded from (seed, global step); JAX folds the step into its key
        the same way, but the bits differ, so tests hand the draw in."""
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(int(self.cfg.seed) * 1000003 + int(step))

    def _optimize(self, name: str, loss: torch.Tensor):
        """Backward, all-reduce, clip, step and schedule of net ``name``,
        in the span ``rdfc.train.update.<name>``."""
        with span("rdfc.train.update." + name):
            opt = self.optimizers[name]
            opt.zero_grad(set_to_none=True)
            loss.backward()
            all_reduce_grads(self.modules[name].parameters())
            clip_gradients(self.cfg, self.modules[name].parameters())
            opt.step()
            self.schedulers[name].step()

    def train_step(self, batch: Dict[str, torch.Tensor],
                   update_g: bool = True,
                   gp_eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One D update, then (``update_g``) one G update. ``gp_eps``
        (B,1,1,1) is the wgangp interpolation draw; by default it comes from
        ``step_generator(self.n_step)``. Returns the losses (and
        ``nlspn_max_offset``) as detached device scalars: reading them is
        the caller's one device sync. The span ``rdfc.train.G_loss`` opens
        twice, around G's forward (which the D loss reads too) and around
        the G loss's terms; ``rdfc.train.D_loss`` around the D loss; the
        updates are in ``_optimize``'s spans."""
        cfg = self.cfg
        G, D = self.modules["G"].train(), self.modules["D"].train()
        real_A, real_B = batch["rgb"], batch["gt_depth"]
        corrupted_B = batch["raw_depth"]
        mask = batch.get("depth_masks")
        if mask is None:
            mask = torch.ones_like(real_B)
        image_loss_weight = mask / (global_count(mask.sum()) + 1e-6)
        stats = {}
        grad = torch.enable_grad() if update_g else torch.no_grad()
        with grad, self.autocast(), span("rdfc.train.G_loss"):
            ret = _as_ret_dict(G(real_A, corrupted_B))
        fake = ret["depth_map_1"]
        if "nlspn_max_offset" in ret:
            stats["nlspn_max_offset"] = ret["nlspn_max_offset"]

        # --- D update first
        with self.autocast(), span("rdfc.train.D_loss"):
            loss_fake = self.criterion_gan(D(fake.detach()), False)
            loss_real = self.criterion_gan(D(real_B), True)
            loss_d = (loss_real + loss_fake) * 0.5
            if cfg.gan_loss_type == "wgangp":
                D.eval()
                gp = gradient_penalty(
                    D, real_B, fake.detach(), eps=gp_eps,
                    generator=self.step_generator(self.n_step))
                D.train()
                loss_d = loss_d + gp
                stats["grad_penalty"] = gp
        self._optimize("D", loss_d)
        if cfg.gan_loss_type == "wgan":
            clip = cfg.get("wgan_clip_value", 0.01)
            with torch.no_grad():
                for p in D.parameters():
                    p.clamp_(-clip, clip)
        stats.update(loss_D=loss_d, loss_D_real=loss_real,
                     loss_D_fake=loss_fake)

        # --- G update with the updated D
        if update_g:
            with _frozen(D):
                with self.autocast(), span("rdfc.train.G_loss"):
                    loss_gan = self.criterion_gan(D(fake), True)
                    l1 = {}
                    for name, key, lam in (
                            ("rgb_branch", "depth_map_1",
                             cfg.lambda_l1_rgb_branch),
                            ("depth_branch", "depth_map_2",
                             cfg.lambda_l1_depth_branch),
                            ("fusion", "pred_depth", cfg.lambda_l1_fusion)):
                        l1[f"loss_L1_{name}"] = l1_loss(
                            ret[key], real_B, weight=image_loss_weight) * lam
                    loss_g = loss_gan + sum(l1.values())
                self._optimize("G", loss_g)
            stats.update(loss_G_GAN=loss_gan, **l1)
        self.n_step += 1
        return {k: v.detach().float() for k, v in stats.items()}


MODELS.register("RDFGAN")(RDFGAN)
