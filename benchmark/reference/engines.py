"""Plain f32 engines of the two configurations: the reference's
``forward_test`` and ``train_step`` of RDF-GAN (G and a PatchGAN D) and of
RDFC-GAN (six nets, four optimizers, the 16-term generator loss), written
from the published engines' equations over ``models.py``, each net built
by the file of its type in ``nets/``. Imports ``torch``, this folder and
the standard library's ``os`` and ``importlib`` only.

Every loss is the weighted sum of its elementwise terms in f32: the
default weight 1 / (numel + 1e-6), the image weight mask / (sum(mask) +
1e-6) broadcast over the channels; the normal losses average over the
pixels whose term is non-zero, 1e-6 added to the count. The step's random
draws (the pepper noise, G_label's keep masks) are handed in by the
caller, who hands the same to the measured program.
"""

from __future__ import annotations

import importlib.util
import os

import torch

from . import models
from .precision import precision

EPS6 = 1e-6


# ------------------------------------------------------------- losses --
def weighted_sum(loss, weight=None):
    if weight is None:
        return (loss * (1.0 / (loss.numel() + EPS6))).sum()
    if weight.dim() != loss.dim():
        weight = weight.unsqueeze(1)
    return (loss * weight.to(loss.dtype)).sum()


def l1(pred, target, weight=None):
    return weighted_sum(torch.abs(pred.float() - target.float()), weight)


def lsgan(pred, real: bool):
    """Least-squares GAN loss: the weighted-sum MSE against 1 or 0."""
    target = 1.0 if real else 0.0
    return weighted_sum((pred.float() - target) ** 2)


def cross_entropy(logits, labels):
    logz = torch.log_softmax(logits.float(), dim=1)
    return -torch.gather(logz, 1, labels.long()[:, None]).mean()


def _norm(x, dim=1):
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-12)


def norm_normalize(out):
    xyz = out[:, :3]
    return xyz / torch.sqrt(torch.sum(xyz ** 2, dim=1, keepdim=True) + 1e-12)


def nor_loss(pred, target, masks):
    pred, target = pred.float(), target.float()
    dot = torch.sum(pred * target, dim=1) / (
        torch.clamp_min(_norm(pred), 1e-8) * torch.clamp_min(_norm(target),
                                                             1e-8))
    m = masks[:, 0] if masks.dim() == 4 else masks
    d = dot.detach()
    valid = (m.float() * (d < 0.999) * (d > -0.999)) > 0.0
    contrib = (1.0 - dot) * valid
    return contrib.sum() / (torch.sum(contrib != 0.0).detach() + EPS6)


def manhattan(normal, logits, wall, floor, ceiling, weight):
    """(floor, wall, ceiling) priors on the normals where the logits'
    argmax names each class, each times ``weight``."""
    sem = torch.argmax(logits, dim=1)
    normal = normal.float()
    ny = normal[:, 1]

    def directional(mask, sign):
        mf = mask.float()
        cos = sign * (ny * mf) / torch.clamp_min(
            _norm(normal * mf[:, None]), 1e-8)
        contrib = (1.0 - cos) * mf
        return contrib.sum() / (torch.sum(contrib != 0.0).detach() + EPS6)

    fl = directional(sem == floor, 1.0)
    ce = directional(sem == ceiling, -1.0)
    wm = (sem == wall).float()
    wc = (ny * wm) / torch.clamp_min(_norm(normal * wm[:, None]), 1e-8) \
        * wm * 2.0
    wl = torch.abs(wc).sum() / (torch.sum(wc != 0.0).detach() + EPS6)
    return fl * weight, wl * weight, ce * weight


def pepper(img, active, u, snr=0.98, p=0.9):
    """Salt (+1) and pepper (-1) where the batch draw is on, from the
    per-pixel uniform ``u``."""
    on = active < p
    half = snr + (1.0 - snr) / 2.0
    img = torch.where((u >= snr) & (u < half) & on, torch.ones_like(img),
                      img)
    return torch.where((u >= half) & on, -torch.ones_like(img), img)


# ---------------------------------------------------------- networks --
# each net's reference is found by the ``type`` of its entry in the
# configuration's ``model``: ``nets/<type>.py``, whose
# ``build(net, cfg) -> nn.Module`` gets that entry and the whole file
NETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nets")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class SpecError(LookupError):
    """A net whose ``type`` has no file in ``nets/``."""


# checkpoint key -> configuration key, each engine's nets in the reference
# checkpoint's order
NET_KEYS = {
    "RDFGAN": {"G": "G", "D": "D"},
    "RDFCGAN": {"G_A2B": "G_A2B", "G_normal": "Normal_G",
                "G_label": "Label_G", "G_B2A": "G_B2A", "disc_A": "D_A",
                "disc_B": "D_B"},
}
SERVED = ("G", "G_A2B", "G_normal", "G_label")


def _normal_net(net: dict, cfg: dict):
    return models.TorchNNET(cfg["out_height"], cfg["out_width"],
                            net.get("width", 1.6), net.get("depth", 2.2))


def _label_net(net: dict, cfg: dict):
    return models.TorchPSPNet(
        cfg["num_classes"], tuple(net.get("planes", (64, 128, 256, 512))),
        net.get("stem_features", 64))


# the flagship engine fixes these two nets' kinds: their entries hold no
# ``type``
FIXED = {"G_normal": _normal_net, "G_label": _label_net}


def net_builder(type_name):
    """The ``build`` of ``nets/<type_name>.py``."""
    if not isinstance(type_name, str) or not type_name.isidentifier():
        raise SpecError(f"net type {type_name!r} is not a name")
    path = os.path.join(NETS, type_name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.nets.{type_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


def build_nets(cfg: dict, train: bool, device="cpu"):
    """The configuration's nets (``cfg``: the configuration file), keyed as
    the reference checkpoint, on ``device`` (``meta`` for shapes alone).
    Every net's type is found before any net is built."""
    m = cfg["model"]
    keys = {k: c for k, c in NET_KEYS[m["type"]].items()
            if train or k in SERVED}
    builders = {k: FIXED[k] if k in FIXED else net_builder(m[c].get("type"))
                for k, c in keys.items()}
    with torch.device(device):
        return {k: builders[k](m.get(c, {}), cfg) for k, c in keys.items()}


def _set_keep(psp, keep):
    drops = (psp.master_branch[0].bottleneck[3], psp.auxiliary_branch[3])
    for d, k in zip(drops, keep):
        d.keep = k


# ----------------------------------------------------------- engines --
class Engine:
    """The reference engine of one configuration over ``nets``, each net
    run in ``precision_name`` (``precision.PRECISIONS``)."""

    def __init__(self, cfg: dict, nets: dict, train_cfg: dict = None,
                 precision_name: str = "f32"):
        self.cfg = cfg
        self.kind = cfg["model"]["type"]
        self.nets = nets
        self.t = dict(train_cfg or {})
        self.optimizers = {}
        self.precision = precision_name

    def call(self, key, *args):
        """Net ``key`` on ``args`` in the engine's precision."""
        with precision(self.precision):
            return self.nets[key](*args)

    # -- serving
    @torch.no_grad()
    def forward_test(self, rgb, raw_depth):
        """The served maps; NLSPN's shift masks in the configuration's
        ``nlspn_serve_masks`` type (f32 where it states none)."""
        masks = self.cfg.get("nlspn_serve_masks")
        for n in self.nets.values():
            n.eval()
            for m in n.modules():
                if isinstance(m, models.TorchNLSPN):
                    m.mask_dtype = getattr(torch, masks) if masks else None
        if self.kind == "RDFGAN":
            return self.call("G", rgb, raw_depth)
        label = self.call("G_label", rgb)
        normal = norm_normalize(self.call("G_normal", rgb))
        ret = self.call("G_A2B", rgb, raw_depth, normal)
        return dict(pred_depth=ret["pred_depth"], pred_normal=normal,
                    pred_label=label)

    @torch.no_grad()
    def conditioning(self, rgb) -> dict:
        """Per served map whose rounding error the map's own formula
        amplifies, a per-pixel weight in (0, 1] that takes the
        amplification back out (after ``forward_test``, in eval mode). The
        flagship's normal is G_normal's output divided by its own norm, so a
        rounding error e of that output moves the normal by about e / |xyz|;
        the weight min(1, |xyz| / median |xyz|) makes weight x error about
        e / median |xyz| at every pixel, and leaves pixels of the median
        norm or more unweighted."""
        if self.kind == "RDFGAN":
            return {}
        norm = self.call("G_normal", rgb)[:, :3].float().norm(
            dim=1, keepdim=True)
        return {"pred_normal": (norm / norm.median()).clamp(max=1.0)}

    # -- training
    def make_optimizers(self):
        """Adam (betas beta1, beta2; eps 1e-8) over each optimizer's nets;
        RDFC-GAN's ``Nor`` is AdamW at half the rate with weight decay."""
        t = self.t
        betas = (t["beta1"], t["beta2"])

        def params(keys):
            return [p for k in keys for p in self.nets[k].parameters()
                    if p.requires_grad]

        if self.kind == "RDFGAN":
            groups = {"G": ("G",), "D": ("D",)}
        else:
            groups = {"G": ("G_A2B", "G_B2A"), "Nor": ("G_normal",),
                      "label": ("G_label",), "D": ("disc_A", "disc_B")}
        for name, keys in groups.items():
            if name == "Nor":
                opt = torch.optim.AdamW(params(keys), lr=t["lr"] * 0.5,
                                        betas=betas, eps=1e-8,
                                        weight_decay=t["weight_decay"],
                                        foreach=False)
            else:
                opt = torch.optim.Adam(params(keys), lr=t["lr"], betas=betas,
                                       eps=1e-8, foreach=False)
            self.optimizers[name] = opt

    def _step(self, names, loss):
        for n in names:
            self.optimizers[n].zero_grad(set_to_none=True)
        loss.backward()
        for n in names:
            self.optimizers[n].step()

    def train_step(self, batch: dict, draws: dict = None, update=True):
        """One step; returns its losses as f32 scalars. ``update`` False
        runs the forward and backward alone (the FLOP count)."""
        for n in self.nets.values():
            n.train()
        if self.kind == "RDFGAN":
            return self._rdfgan_step(batch, update)
        return self._rdfcgan_step(batch, draws, update)

    def _rdfgan_step(self, batch, update):
        t, D = self.t, self.nets["D"]
        real_A, real_B = batch["rgb"], batch["gt_depth"]
        mask = batch["depth_masks"]
        w = mask / (mask.sum() + EPS6)
        ret = self.call("G", real_A, batch["raw_depth"])
        fake = ret["depth_map_1"]
        loss_fake = lsgan(self.call("D", fake.detach()), False)
        loss_real = lsgan(self.call("D", real_B), True)
        loss_d = (loss_real + loss_fake) * 0.5
        if update:
            self._step(("D",), loss_d)
        else:
            loss_d.backward()
        trainable = [p for p in D.parameters() if p.requires_grad]
        for p in trainable:
            p.requires_grad_(False)
        loss_gan = lsgan(self.call("D", fake), True)
        l1s = {f"loss_L1_{name}": l1(ret[key], real_B, w) * t[lam]
               for name, key, lam in (
                   ("rgb_branch", "depth_map_1", "lambda_l1_rgb_branch"),
                   ("depth_branch", "depth_map_2", "lambda_l1_depth_branch"),
                   ("fusion", "pred_depth", "lambda_l1_fusion"))}
        loss_g = loss_gan + sum(l1s.values())
        if update:
            self._step(("G",), loss_g)
        else:
            loss_g.backward()
        for p in trainable:
            p.requires_grad_(True)
        out = dict(loss_D=loss_d, loss_D_real=loss_real,
                   loss_D_fake=loss_fake, loss_G_GAN=loss_gan, **l1s)
        return {k: v.detach().float() for k, v in out.items()}

    def _rdfcgan_step(self, batch, draws, update):
        t, m = self.t, self.nets
        real_A, real_B = batch["rgb"], batch["gt_depth"]
        aux_A = batch["raw_depth"]
        gt_normal, gt_label = batch["gt_normal"], batch["labels"]
        nmask = batch["normal_masks"]
        mask = batch["depth_masks"]
        w = mask / (mask.sum() + EPS6)
        lam_A, lam_B, lam = t["lambda_A"], t["lambda_B"], t["lambda_L1"]
        _set_keep(m["G_label"], draws["keep"])
        discs = [p for k in ("disc_A", "disc_B") for p in m[k].parameters()]
        for p in discs:
            p.requires_grad_(False)

        c = self.call
        lbl_a = c("G_label", real_A)
        nrm_a = norm_normalize(c("G_normal", real_A))
        fake_B = pepper(c("G_A2B", real_A, aux_A, nrm_a)["pred_depth"],
                        *draws["pepper"])
        rec_A = c("G_B2A", fake_B)
        fake_A = c("G_B2A", real_B)
        lbl_b = c("G_label", fake_A)
        nrm_b = norm_normalize(c("G_normal", fake_A))
        rec_B = c("G_A2B", fake_A, aux_A, nrm_b)["pred_depth"]

        def label_loss(lbl):
            return (cross_entropy(lbl[0], gt_label)
                    + cross_entropy(lbl[1], gt_label) * 0.4) * lam

        def mh(nrm, lbl):
            return manhattan(nrm, lbl[0], t["label_wall"], t["label_floor"],
                             t["label_ceiling"], lam)

        fl_a, wl_a, cl_a = mh(nrm_a, lbl_a)
        fl_b, wl_b, cl_b = mh(nrm_b, lbl_b)
        log = dict(
            loss_G_A2B=lsgan(c("disc_A", fake_B), True),
            loss_G_B2A=lsgan(c("disc_B", fake_A), True),
            loss_A2B_L1=l1(fake_B, real_B, w) * lam * 5,
            loss_B2A_L1=l1(fake_A, real_A, w) * lam * 3,
            loss_cycle_A=l1(rec_A, real_A) * lam_A,
            loss_cycle_B=l1(rec_B, real_B, w) * lam_B,
            loss_label_A2B=label_loss(lbl_a),
            loss_label_B2A=label_loss(lbl_b),
            loss_normal_A2B=nor_loss(nrm_a, gt_normal, nmask) * lam * 2,
            loss_normal_B2A=nor_loss(nrm_b, gt_normal, nmask) * lam * 2,
            floor_loss_A2B=fl_a, wall_loss_A2B=wl_a, ceiling_loss_A2B=cl_a,
            floor_loss_B2A=fl_b, wall_loss_B2A=wl_b, ceiling_loss_B2A=cl_b)
        log["loss_G"] = sum(log.values())
        if update:
            self._step(("G", "Nor", "label"), log["loss_G"])
        else:
            log["loss_G"].backward()
        for p in discs:
            p.requires_grad_(True)
        _set_keep(m["G_label"], (None, None))

        d_log = {}
        for d, real, fake in (("A", real_B, fake_B), ("B", real_A, fake_A)):
            r = lsgan(self.call(f"disc_{d}", real), True)
            f = lsgan(self.call(f"disc_{d}", fake.detach()), False)
            d_log.update({f"loss_D_{d}": (r + f) * 0.5,
                          f"loss_D_{d}_real": r, f"loss_D_{d}_fake": f})
        loss_d = d_log["loss_D_A"] + d_log["loss_D_B"]
        if update:
            self._step(("D",), loss_d)
        else:
            loss_d.backward()
        log.update(d_log)
        return {k: v.detach().float() for k, v in log.items()}
