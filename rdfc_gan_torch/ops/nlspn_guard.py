"""Runtime guard for the NLSPN stencil's offset clamp (port of
rdfc_gan_tpu/ops/nlspn_guard.py).

The stencil is exact only while every learned offset satisfies
|o| <= R (``nlspn_offset_radius``). The generator reports the batch max
|offset| as ``nlspn_max_offset``; after loading a checkpoint the eval driver
probes one batch (:func:`probe_max_offset`) and picks a safe configuration
(:func:`escalate_nlspn_cfg`): a larger R while the shift window stays small,
else the reference-exact gather.
"""

from __future__ import annotations

import logging
import math
from typing import Tuple

from ..parallel import all_reduce_max

logger = logging.getLogger(__name__)

# above this radius the (2R+4)^2 shift-mask stack (S=12 -> 144 planes) is no
# longer worth it; the CUDA scatter also takes S <= 12
MAX_STENCIL_RADIUS = 4


def probe_max_offset(engine, batch) -> float:
    """One generator forward; the max |offset| it reports (the max over the
    ranks, so every rank escalates alike), or 0.0 when the generator has no
    NLSPN stage: neither G nor its ``core`` (a DCVGANGenerator's
    RDFGenerator) has ``use_nlspn_refine`` set (nlspn_guard.py:38-42)."""
    mod = engine.modules.get("G")
    if mod is None or not getattr(mod, "use_nlspn_refine", getattr(
            getattr(mod, "core", None), "use_nlspn_refine", False)):
        return 0.0
    ret = engine.forward_test(rgb=batch["rgb"], raw_depth=batch["raw_depth"])
    return float(all_reduce_max(ret["nlspn_max_offset"].float().clone()))


def escalate_nlspn_cfg(g_cfg: dict, max_offset: float,
                       margin: float = 1.25) -> Tuple[dict, bool]:
    """Given a generator config dict and an observed max |offset|, return
    (updated config, changed). The radius must cover margin * max_offset;
    escalate R while R <= MAX_STENCIL_RADIUS, else switch to 'gather'."""
    g_cfg = dict(g_cfg)
    if not g_cfg.get("use_nlspn_refine", False):
        return g_cfg, False
    R = int(g_cfg.get("nlspn_offset_radius", 2))
    if g_cfg.get("nlspn_impl", "auto") == "gather":
        return g_cfg, False
    need = math.ceil(max_offset * margin)
    if need <= R:
        return g_cfg, False
    if need <= MAX_STENCIL_RADIUS:
        logger.warning(
            "NLSPN offsets reach %.2f > stencil radius %d; escalating "
            "nlspn_offset_radius to %d", max_offset, R, need)
        g_cfg["nlspn_offset_radius"] = need
    else:
        logger.warning(
            "NLSPN offsets reach %.2f, beyond the stencil-friendly radius "
            "%d; falling back to the reference-exact gather path",
            max_offset, MAX_STENCIL_RADIUS)
        g_cfg["nlspn_impl"] = "gather"
    return g_cfg, True


def guard_loaded_engine(cfg, engine, batch, rebuild):
    """After a checkpoint load: probe ``batch`` and, where the offsets pass
    the stencil radius, merge the escalated generator config into
    ``cfg.model.G`` and return ``rebuild()``, an engine built (and loaded)
    anew from ``cfg``. Returns (engine, max |offset| or None, changed); a
    config without a ``G`` node is returned unprobed."""
    g_node = cfg.model.get("G")
    if g_node is None:
        return engine, None, False
    max_offset = probe_max_offset(engine, batch)
    g_cfg, changed = escalate_nlspn_cfg(g_node.to_dict(), max_offset)
    if changed:
        g_node.merge(g_cfg)
        engine = rebuild()
    return engine, max_offset, changed
