"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, ``nvcc``
and PyTorch built for CUDA. It

1. builds every CUDA kernel of ``rdfc_gan_torch/csrc`` with ``nvcc``;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the NLSPN serving and training paths (B=4, 224x304, T=18;
   S=8 and 10; preserve off and on; f32 and bf16 stacks), and times both;
   the three chain kernels (each one cooperative launch a chain) also by
   their device time a chain and a step; all three chains also at a plane
   they take in bands of rows (16x352x1216), and their launch plan's
   Python mirror against each kernel's own; the shift correlation with dM
   in f32 and in bf16, each timed beside its own bound, and its cut's
   Python mirror against the kernel's; then exports ``forward_test``
   through ``python -m rdfc_gan_torch.tools.export_model``'s code path
   with ``--check`` at 4x224x304 (the flagship in full and
   ``--depth_only``, the NLSPN config), loads each ``.pt2`` in a fresh
   process that imports only torch and ``rdfc_gan_torch.ops.kernels``,
   holds its outputs against the live forward and counts its launches
   (``export_phase``); and holds the general deformable ops, the DCNv2
   backward's repeat and ``nlspn_refine_stencil`` (``deform_phase``);
3. serves ``configs/rdf_gan_nlspn_config.yaml`` at full width through
   ``python -m rdfc_gan_torch.test``'s code path, with random weights from a
   seed and non-zero NLSPN offsets, and checks that its kernels carried it;
4. profiles a few served batches (device time by kernel);
5. trains the same config one epoch (16 steps at batch 4, its bfloat16
   compute type) through ``python -m rdfc_gan_torch.train``'s code path
   from seeded G and D, checks the losses, the launch counts of every
   kernel, that the correlation writes dM in the masks' bf16 (no cast
   pass), that G and D moved, and that ``rdfc_gan_torch.test`` serves the
   written ``best.pth``; prints step times and peak memory; profiles two
   steps;
6. runs one f32 train step through the kernels and one with their plain
   versions patched in (deterministic cuDNN) and compares the losses and
   every parameter gradient (the step's identity BasicBlocks run the fused
   conv3x3 kernels); then one bf16 step the same ways and as a control
   with the identity blocks on torch's convolution and BatchNorm2d, each
   gradient held within twice the control's difference;
7. holds the instance-norm kernels against their plain versions at the four
   W-AdaIN shapes (f32 and bf16), then serves the flagship RDFC-GAN
   (``configs/rdf_cycle_patchgan_config.yaml``: G_label -> G_normal ->
   G_A2B) at full width through ``python -m rdfc_gan_torch.test``'s code
   path, with and without ``--depth_only``, from seeded weights: latency,
   img/s, ``--cal_fps``, peak memory, 4 IN launches per forward, pred_depth
   against the plain IN path, the time of each net and of its convolution
   kinds, and a profile;
8. holds the fused conv3x3 + moments kernels (forward and backward)
   against their plain versions at the four identity-block shapes (f32 bit
   for bit; bf16, on the tensor cores, within the tolerance
   ``conv_block_kernel`` states) and times them beside cuDNN; the IN
   kernels also at G_B2A's planes and at odd planes, with the forward's
   time per shape and per G_B2A application beside ``F.instance_norm``'s,
   the backward's beside its bound, each with the plan it took (the
   Python mirrors of the plans checked against the kernel's own);
9. trains the flagship one epoch (16 bf16 steps at batch 4) through
   ``python -m rdfc_gan_torch.train``'s code path from seeded nets: the 23
   losses, the launch counts, all six nets moved, ``best.pth`` served;
   step times, peak memory and a two-step profile; then one f32 flagship
   step through the kernels against the plain step, run-to-run and a
   control with the identity blocks on torch's convolution;
10. writes a NYUv2-1400 fixture (16 train, 8 test scenes at 480x640) with
   the port's generator and reads every PNG back (the native C++ unfilter
   equal to what was written and to the plain unfilter); trains the
   flagship on it (bf16, batch 4) 2 epochs straight, and 1 epoch, then
   ``--resume_from epoch_1.pth`` and a second with the process loader,
   and compares the two ``epoch_2.pth`` entry by entry, bit for bit (the
   package as shipped, deterministic cuDNN: G_B2A's reflect pads add
   their border gradients in a fixed order); checks the sample grids;
   serves the test split from ``epoch_2.pth`` and with the NLSPN config
   (launch counts); runs ``rdfc_gan_torch.inference`` on one image;
   prints step times, the loader's wait, decode time, peak memory; before
   the fixture, times a bf16 G_B2A forward + backward with the package's
   fixed-order reflect pad beside ``F.pad`` and checks that two backward
   passes with it are bit-equal;
11. writes an ``nyuv2_s2d`` fixture (16 train, 8 val HDF5 frames at
   480x640, the port's writer) and reads it back with the port's reader;
   holds the scatter, the three chains and the IN kernels against their
   plain versions at 228x304; trains the NLSPN config one epoch (4 bf16
   steps at batch 4) with its evaluation through ``python -m
   rdfc_gan_torch.train --dataset nyuv2_s2d`` and serves best.pth, the
   launches counted from 0 before each; then loads ``ddrnet_human``,
   ``nyuv2_r2r`` and ``cleargrasp`` batches through the loader, serves a
   ``ddrnet_human`` batch at 4x480x640 (the scatter, the served chain and
   the IN forward held there too), trains ``cleargrasp`` 4 steps at
   256x256 and serves it, and serves G_A2B built with the ``IN`` and
   ``AdaIN`` fuse layers and with ``add`` skips (IN launches counted; the
   IN build also one train step); then the v1 family
   (``v1_family_phase``): the fused conv3x3 kernels held against their
   plain versions at ESANet's planes (228x304 and 480x640, down to
   4x512x8x10) and timed beside cuDNN; the guided v1 model (ESANet
   guidance, NLSPN, W-AdaIN) trained one epoch (4 bf16 steps) through
   ``python -m rdfc_gan_torch.tools.main_v1``'s code path with every
   kernel's launches checked, evaluated by ``EvalV1`` at the 480x640
   origin, served by ``--inference`` and ``--cal_fps``; one f32 guided
   step through the kernels against the plain step; the driver-default
   AdaIN build and a vanilla build served, and one vanilla train step;
12. trains the NLSPN config 4 bf16 steps twice under
   ``set_random_seed(seed, deterministic=True)`` and holds the two
   checkpoints bit-equal (``nlspn_repeat_check``); then data parallelism
   (``data_parallel_phase``): world 1 through ``torch.distributed.run``
   bit-equal to the plain run, and two ranks on the one card in a gloo
   group (f32 flagship and RDF-GAN steps against world 1, 4 bf16 flagship
   steps bit-equal across the ranks with their launch counts, an NLSPN
   evaluation with pad rows against world 1's);
13. serves width-sharded (``spatial_phase``, the JAX ``spatial_sharding``):
   after the IN forward's split for a sharded plane is held against its
   plain versions and its M = 1 composition against the forward kernel
   (``in_split_phase``, with the kernel phases; also at the uneven shards
   of the published 224x304), gloo ranks on the one card serve the
   flagship at 2x480x640 on three ``data`` x ``model`` grids in full and
   ``--depth_only``, and the NLSPN config on two ranks, then the published
   4x224x304, whose deeper levels split unevenly, with the flagship on
   {model: 2} and {model: 4} and the NLSPN config on {model: 2}, each held
   against the unsharded forward with its launches counted, and
   ``rdfc_gan_torch.test`` serves with a ``model`` axis, its metrics held to
   world 1's; peak memory a rank, bytes exchanged and times printed;
14. prints the card's name and power limit, one ``{"kernels": [...]}``
   line, and ``{"ok": true, "device": {...}}`` as the last line.

It exits non-zero, printing no result, when there is no card or no
``rdfc_gan_torch`` package beside it, or when any phase fails.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f64 FLOP/s outside the tensor cores (the same data sheet)
PEAK_F64_FLOPS = 34e12
# bf16 FLOP/s of the tensor cores, dense (the same data sheet)
PEAK_BF16_FLOPS = 989e12

B, H, W, T = 4, 224, 304, 18
SCATTER_RTOL, SCATTER_ATOL = 1e-6, 1e-6
# the chain kernels and the shift correlation vs plain: the same sums in
# the same order, a separately rounded multiply and add, so bit for bit
CHAIN_RTOL, CHAIN_ATOL = 0.0, 0.0
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-5
# instance norm kernels vs plain: the plain versions sum in the kernels'
# order and take a correctly rounded rsqrt, so the two agree bit for bit
IN_RTOL, IN_ATOL = 0.0, 0.0
# W-AdaIN shapes of the generator at 224x304, batch 4 (fuse_layer1..4)
IN_SHAPES = ((B, 512, 14, 19), (B, 768, 28, 38), (B, 384, 56, 76),
             (B, 192, 112, 152))
# G_B2A's instance norms in the flagship train step (fake_B and real_B in
# one batch of 8): the stem and last up, the first down and up, the second
# down and the residual blocks. The forward splits the 64-channel planes
# (136 KB in bf16) over a cluster of four blocks and stages the others in
# one block (the 256-channel planes four to a block)
G_B2A_IN_SHAPES = ((2 * B, 64, H, W), (2 * B, 128, H // 2, W // 2),
                   (2 * B, 256, H // 4, W // 4))
# IN launches a G_B2A application at each of those shapes (6 residual
# blocks: 2 + 2 + 1 + 2 * 6)
G_B2A_IN_LAUNCHES = (2, 2, 13)
# odd planes (no vector width divides them), checked bit for bit only
ODD_IN_SHAPES = ((4, 3, 17, 23), (2, 5, 14, 19))
# the f32 fused conv3x3 + moments kernels vs plain: f64 sums in one order
# on both sides, so bit for bit (the bf16 kernels: conv_block_kernel's
# stated tolerance)
CONV_RTOL, CONV_ATOL = 0.0, 0.0
# (C, H, W) of the identity BasicBlocks of a resnet18 torso behind G_A2B's
# stride-1 en1, at 224x304 (layer1 and the second block of layers 2-4)
CONV_SHAPES = ((64, H, W), (128, H // 2, W // 2), (256, H // 4, W // 4),
               (512, H // 8, W // 8))


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = None):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_flops / (peak_flops or PEAK_F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want, rtol, atol, quiet=False):
    """Max |got - want|; fails past atol + rtol |want|. ``quiet`` prints
    only a failure."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    if quiet and ok:
        return max_abs
    print(f"  {name}: max|ref|={float(want.abs().max()):.3e} "
          f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(tolerance atol={atol:g} rtol={rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def mask_inputs(gen, R: int, shape=(B, H, W)):
    """(offsets, aff, feat, fix) as the serving path makes them at a
    (batch, height, width) plane: offsets within +-R/1.25, TGASS affinities
    over a confidence map, a sparse depth map kept where > 0."""
    import torch

    from rdfc_gan_torch.ops.nlspn import NLSPNParamsSpec, nlspn_offset_affinity

    spec = NLSPNParamsSpec(prop_time=T)
    num = spec.num_neighbors
    dev = "cuda"
    b, h, w = shape
    raw = torch.empty((b, 3 * num, h, w), device=dev)
    raw[:, :2 * num].uniform_(-R / 1.25, R / 1.25, generator=gen)
    raw[:, 2 * num:].normal_(generator=gen)
    conf = torch.empty((b, 1, h, w), device=dev).uniform_(0.2, 1.0,
                                                          generator=gen)
    offsets, aff = nlspn_offset_affinity(
        raw, conf, torch.tensor(spec.affinity_gamma * num, device=dev), spec,
        conf_sample_radius=R)
    feat = torch.empty((b, 1, h, w), device=dev).uniform_(-1, 1,
                                                          generator=gen)
    keep = torch.empty((b, 1, h, w), device=dev).uniform_(
        generator=gen) > 0.6
    fix = torch.where(keep, feat.abs(), torch.zeros_like(feat))
    return offsets, aff, feat, fix


def scatter_args(offsets, aff, R: int):
    """The (w, sy, sx, S) that build_shift_masks hands to the scatter."""
    from rdfc_gan_torch.ops.kernels import mask_kernel

    captured = {}

    def spy(w, sy, sx, S):
        captured.update(w=w, sy=sy, sx=sx, S=S)
        return mask_kernel.scatter_shift_masks_plain(w, sy, sx, S)

    from rdfc_gan_torch.ops import nlspn_stencil

    with mock.patch.object(mask_kernel, "scatter_shift_masks", spy):
        M = nlspn_stencil.build_shift_masks(offsets, aff, 3, R)
    return captured, M


def kernel_phase():
    """Each kernel against its plain version at the serving shapes. Returns
    the per-kernel numbers of the main shape (S=8 / R=2)."""
    import torch

    from rdfc_gan_torch.ops.kernels import mask_kernel, nlspn_kernel
    from rdfc_gan_torch.ops.nlspn_stencil import stencil_propagate

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    print("kernel checks (B=4, 224x304):")
    for R in (2, 3):
        offsets, aff, feat, fix = mask_inputs(gen, R)
        a, M_plain = scatter_args(offsets, aff, R)
        w, sy, sx, S = a["w"], a["sy"], a["sx"], a["S"]
        K = w.shape[1]
        got = mask_kernel.scatter_shift_masks(w, sy, sx, S)
        torch.cuda.synchronize()
        err = compare(f"shift_mask_scatter S={S} K={K}", got,
                      M_plain.reshape(got.shape), SCATTER_RTOL, SCATTER_ATOL)
        if R == 2:
            HW = H * W
            idx = (sy * S + sx).long().reshape(B, K, HW)
            wf = w.reshape(B, K, HW)
            zeros = torch.zeros((B, S * S, HW), device="cuda")

            def library_call():  # out of place: one call, zeros as base
                return zeros.scatter_add(1, idx, wf)

            n_bytes = B * HW * (K * (4 + 4 + 4) + S * S * 4)
            bnd, by = bound_ms(n_bytes, B * HW * K)
            rows["shift_mask_scatter"] = dict(
                name="shift_mask_scatter", route="cuda",
                source="rdfc_gan_torch/csrc/shift_mask_scatter.cu",
                replaces="rdfc_gan_tpu/ops/pallas/mask_kernel.py:37",
                max_abs_err=err,
                ms=time_ms(lambda: mask_kernel.scatter_shift_masks(
                    w, sy, sx, S)),
                plain_ms=time_ms(lambda: mask_kernel.scatter_shift_masks_plain(
                    w, sy, sx, S)),
                bound_ms=bnd, bound_by=by,
                library_ms=time_ms(library_call))
        M = M_plain.reshape(B, S, S, H, W)
        for preserve in ((False, True) if R == 2 else (False,)):
            def kernel(p=preserve):
                return nlspn_kernel.nlspn_stencil_propagate(
                    feat, M, fix, T, R, p)

            def plain(p=preserve):
                return stencil_propagate(feat, M.to(torch.bfloat16), T, R,
                                         fix, p)

            got = kernel()
            torch.cuda.synchronize()
            err = compare(f"nlspn_propagate R={R} T={T} preserve={preserve}",
                          got, plain(), CHAIN_RTOL, CHAIN_ATOL)
            if R == 2 and not preserve:
                served = (feat, M.to(torch.bfloat16))
                plane = B * H * W * 4
                n_bytes = B * S * S * H * W * 2 + 2 * plane
                bnd, by = bound_ms(n_bytes, 2.0 * T * S * S * B * H * W)
                rows["nlspn_propagate"] = dict(
                    name="nlspn_propagate", route="cuda",
                    source="rdfc_gan_torch/csrc/nlspn_propagate.cu",
                    replaces="rdfc_gan_tpu/ops/pallas/nlspn_kernel.py:35",
                    max_abs_err=err, ms=time_ms(kernel),
                    plain_ms=time_ms(plain, reps=5),
                    bound_ms=bnd, bound_by=by, library_ms=None)
    for r in rows.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    feat, M16 = served  # M already bf16: the device time is the chain's
    _chain_device_times(
        "nlspn_propagate",
        lambda t: nlspn_kernel.nlspn_stencil_propagate(feat, M16, None, t, 2,
                                                       False), T,
        rows["nlspn_propagate"]["bound_ms"])
    _banded_chain_check(gen)
    _check_chain_plan_mirror()
    return rows


def _banded_chain_check(gen):
    """Both forward chains at 16x352x1216, S=8, preserve on, T=2, bit for
    bit against their plain versions: on an H100 a block's rows and halo
    pass its shared memory there, so it takes its runs in two bands of
    rows a step (as the reverse chain does:
    ``_banded_reverse_chain_check``)."""
    import torch

    from rdfc_gan_torch.ops import nlspn_stencil as st
    from rdfc_gan_torch.ops.kernels import nlspn_kernel

    shape, R, T_ = (16, 352, 1216), 2, 2
    feat = torch.randn(shape, device="cuda", generator=gen)
    M16 = (torch.randn((shape[0], 8, 8) + shape[1:], device="cuda",
                       generator=gen) * 0.2).to(torch.bfloat16)
    keep = torch.rand(shape, device="cuda", generator=gen) > 0.6
    fix = torch.where(keep, feat.abs(), torch.zeros_like(feat))
    tag = f"{'x'.join(map(str, shape))} S=8 T={T_} preserve=True"
    got = nlspn_kernel.nlspn_stencil_propagate(feat[:, None], M16,
                                               fix[:, None], T_, R, True)
    torch.cuda.synchronize()
    compare(f"nlspn_propagate {tag}", got, st.stencil_propagate(
        feat[:, None], M16, T_, R, fix[:, None], True), CHAIN_RTOL,
        CHAIN_ATOL)
    for dt in (torch.float32, torch.bfloat16):
        out, X = nlspn_kernel.propagate_x(feat, M16, fix, T_, R, dt)
        torch.cuda.synchronize()
        pout, pX = st.propagate_x_plain(feat, M16, fix, T_, R, dt)
        compare(f"nlspn_propagate_x out {tag} {dt}", out, pout, CHAIN_RTOL,
                CHAIN_ATOL)
        compare(f"nlspn_propagate_x X {tag} {dt}", X, pX, CHAIN_RTOL,
                CHAIN_ATOL)


def backward_kernel_phase():
    """The four kernels of the NLSPN backward against their plain versions
    at the training shapes: S=8 (R=2) and S=10 (R=3), preserve off and on,
    f32 and bf16 stacks. Returns the numbers of the train step's own case
    (R=2, no preserve, bf16 stacks: the config's bfloat16 compute type)."""
    import torch

    from rdfc_gan_torch.ops import nlspn_stencil as st
    from rdfc_gan_torch.ops.kernels import mask_kernel, nlspn_kernel

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    HW = H * W
    print("backward kernel checks (B=4, 224x304, T=18):")
    # the gather with out-of-range indices (they give 0), on its vector path
    # and, at odd HW, its scalar one; a generator of its own, so the timed
    # inputs below stay those of earlier runs
    odd = torch.Generator(device="cuda").manual_seed(11)
    for S, shape in ((8, (4, 36, 56, 76)), (8, (2, 36, 17, 23)),
                     (10, (4, 36, 14, 19))):
        sy, sx = (torch.randint(-1, S + 1, shape, device="cuda",
                                generator=odd, dtype=torch.int32)
                  for _ in range(2))
        for dt in (torch.float32, torch.bfloat16):
            dM = torch.randn((shape[0], S * S) + shape[2:], device="cuda",
                             generator=odd).to(dt)
            got = mask_kernel.shift_mask_gather(dM, sy, sx, S, dt)
            torch.cuda.synchronize()
            compare(f"shift_mask_gather S={S} {shape} {dt}, indices in "
                    f"[-1, S]", got, mask_kernel.shift_mask_gather_plain(
                        dM, sy, sx, S, dt), 0.0, 0.0)
    for R in (2, 3):
        offsets, aff, feat, fix = mask_inputs(gen, R)
        a, M = scatter_args(offsets, aff, R)
        sy, sx, S = a["sy"], a["sx"], a["S"]
        K = sy.shape[1]
        lo = st.shift_window(R)[0]
        M16 = M.reshape(B, S, S, H, W).to(torch.bfloat16)
        feat0 = feat[:, 0].contiguous()
        fix0 = fix[:, 0].contiguous()
        g0 = torch.randn((B, H, W), device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            dM = torch.randn((B, S * S, H, W), device="cuda",
                             generator=gen).to(dt)
            got = mask_kernel.shift_mask_gather(dM, sy, sx, S, dt)
            torch.cuda.synchronize()
            err_g = compare(f"shift_mask_gather S={S} {dt}", got,
                            mask_kernel.shift_mask_gather_plain(
                                dM, sy, sx, S, dt), 0.0, 0.0)
            for preserve in (False, True):
                fx = fix0 if preserve else None
                tag = f"R={R} preserve={preserve} {dt}"
                out, X = nlspn_kernel.propagate_x(feat0, M16, fx, T, R, dt)
                G, dfeat, dfix = nlspn_kernel.reverse_chain(g0, M16, fx, T,
                                                            R, dt)
                dMk = {odt: mask_kernel.shift_correlation(G, X, S, lo, odt)
                       for odt in (torch.float32, torch.bfloat16)}
                torch.cuda.synchronize()
                pout, pX = st.propagate_x_plain(feat0, M16, fx, T, R, dt)
                pG, pdfeat, pdfix = st.reverse_chain_plain(g0, M16, fx, T, R,
                                                           dt)
                err_x = max(compare(f"nlspn_propagate_x out {tag}", out,
                                    pout, CHAIN_RTOL, CHAIN_ATOL),
                            compare(f"nlspn_propagate_x X {tag}", X, pX,
                                    CHAIN_RTOL, CHAIN_ATOL))
                err_c = max(compare(f"nlspn_reverse_chain G {tag}", G, pG,
                                    CHAIN_RTOL, CHAIN_ATOL),
                            compare(f"nlspn_reverse_chain dfeat {tag}",
                                    dfeat, pdfeat, CHAIN_RTOL, CHAIN_ATOL),
                            compare(f"nlspn_reverse_chain dfix {tag}",
                                    dfix, pdfix, CHAIN_RTOL, CHAIN_ATOL))
                err_s = max(compare(
                    f"shift_correlation {tag}, dM {odt}", got,
                    mask_kernel.shift_correlation_plain(G, X, S, lo, odt),
                    CHAIN_RTOL, CHAIN_ATOL) for odt, got in dMk.items())
                if R != 2 or preserve or dt != torch.bfloat16:
                    continue
                plane = B * HW * 4
                stack = T * B * HW * 2
                mbytes = B * S * S * HW * 2
                chain_ops = 2.0 * T * S * S * B * HW
                idx = (sy * S + sx).long().reshape(B, K, HW)
                dMf = dM.reshape(B, S * S, HW)

                def row(name, src, replaces, err, kernel, plain, n_bytes,
                        n_ops, library=None, plain_reps=20):
                    bnd, by = bound_ms(n_bytes, n_ops)
                    rows[name] = dict(
                        name=name, route="cuda",
                        source=f"rdfc_gan_torch/csrc/{src}.cu",
                        replaces=replaces, max_abs_err=err,
                        ms=time_ms(kernel),
                        plain_ms=time_ms(plain, reps=plain_reps),
                        bound_ms=bnd, bound_by=by,
                        library_ms=None if library is None
                        else time_ms(library))

                chain_case = (feat0, g0, M16, T, R, dt)
                corr_case = (G, X, S, lo, stack, chain_ops)

                def gather(dM=dM, sy=sy, sx=sx, S=S, dt=dt):
                    return mask_kernel.shift_mask_gather(dM, sy, sx, S, dt)

                def library_gather(dMf=dMf, idx=idx):
                    return torch.gather(dMf, 1, idx)

                row("shift_mask_gather", "shift_mask_gather",
                    "rdfc_gan_tpu/ops/pallas/mask_kernel.py:54", err_g,
                    gather,
                    lambda: mask_kernel.shift_mask_gather_plain(
                        dM, sy, sx, S, dt),
                    B * HW * (S * S * 2 + K * (4 + 4 + 2)), B * K * HW,
                    library=library_gather)
                row("nlspn_propagate_x", "nlspn_propagate",
                    "rdfc_gan_tpu/ops/pallas/nlspn_kernel.py:35", err_x,
                    lambda: nlspn_kernel.propagate_x(feat0, M16, None, T, R,
                                                     dt),
                    lambda: st.propagate_x_plain(feat0, M16, None, T, R, dt),
                    mbytes + 2 * plane + stack, chain_ops, plain_reps=3)
                row("nlspn_reverse_chain", "nlspn_reverse_chain",
                    "rdfc_gan_tpu/ops/pallas/nlspn_kernel.py:89", err_c,
                    lambda: nlspn_kernel.reverse_chain(g0, M16, None, T, R,
                                                       dt),
                    lambda: st.reverse_chain_plain(g0, M16, None, T, R, dt),
                    mbytes + 2 * plane + stack, chain_ops, plain_reps=3)
                # dM in bf16, the masks' type in the bf16 train step
                bf16 = torch.bfloat16
                row("shift_correlation", "shift_correlation",
                    "rdfc_gan_tpu/ops/pallas/mask_kernel.py:167", err_s,
                    lambda: mask_kernel.shift_correlation(G, X, S, lo, bf16),
                    lambda: mask_kernel.shift_correlation_plain(G, X, S, lo,
                                                                bf16),
                    2 * stack + B * S * S * HW * 2, chain_ops, plain_reps=3)
    for r in rows.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    print(f"  shift_mask_gather device time: kernel "
          f"{_device_ms(gather, n=10):.4f} ms, torch.gather "
          f"{_device_ms(library_gather, n=10):.4f} ms")
    feat0, g0, M16, T_, R, dt = chain_case
    _chain_device_times(
        "nlspn_propagate_x",
        lambda t: nlspn_kernel.propagate_x(feat0, M16, None, t, R, dt), T_,
        rows["nlspn_propagate_x"]["bound_ms"])
    _chain_device_times(
        "nlspn_reverse_chain",
        lambda t: nlspn_kernel.reverse_chain(g0, M16, None, t, R, dt), T_,
        rows["nlspn_reverse_chain"]["bound_ms"])
    G, X, S, lo, stack, chain_ops = corr_case
    for odt in (torch.float32, torch.bfloat16):
        bnd, by = bound_ms(2 * stack + B * S * S * HW * odt.itemsize,
                           chain_ops)

        def corr(odt=odt):
            return mask_kernel.shift_correlation(G, X, S, lo, odt)

        dev = _device_ms(corr, n=10)
        print(f"  shift_correlation, dM {odt}: events {time_ms(corr):.4f} "
              f"ms, device {dev:.4f} ms; bound {bnd * 1e3:.2f} us ({by}), "
              f"the device time at {_pct(bnd, dev)} of it")
    _banded_reverse_chain_check(gen)
    _check_corr_plan_mirror()
    return rows


def _banded_reverse_chain_check(gen):
    """The reverse chain at 16x352x1216, S=8, preserve on, T=2, f32 and bf16
    G, bit for bit against its plain version: on an H100 a block's rows and
    halo pass its shared memory there, so it takes its runs in two bands of
    rows a step. Then its device time for T=18 and T=1 (bf16 G)."""
    import torch

    from rdfc_gan_torch.ops import nlspn_stencil as st
    from rdfc_gan_torch.ops.kernels import nlspn_kernel

    shape, R, T_ = (16, 352, 1216), 2, 2
    g0 = torch.randn(shape, device="cuda", generator=gen)
    M16 = (torch.randn((shape[0], 8, 8) + shape[1:], device="cuda",
                       generator=gen) * 0.2).to(torch.bfloat16)
    keep = torch.rand(shape, device="cuda", generator=gen) > 0.6
    fix = torch.where(keep, g0.abs(), torch.zeros_like(g0))
    tag = f"{'x'.join(map(str, shape))} S=8 T={T_} preserve=True"
    for dt in (torch.float32, torch.bfloat16):
        got = nlspn_kernel.reverse_chain(g0, M16, fix, T_, R, dt)
        torch.cuda.synchronize()
        want = st.reverse_chain_plain(g0, M16, fix, T_, R, dt)
        for what, a, b in zip(("G", "dfeat", "dfix"), got, want):
            compare(f"nlspn_reverse_chain {what} {tag} {dt}", a, b,
                    CHAIN_RTOL, CHAIN_ATOL)

    def chain(t):  # the train step's G type
        return nlspn_kernel.reverse_chain(g0, M16, fix, t, R, torch.bfloat16)

    d = _device_ms(lambda: chain(T), n=5)
    d1 = _device_ms(lambda: chain(1), n=5)
    print(f"  nlspn_reverse_chain {'x'.join(map(str, shape))} S=8 "
          f"preserve=True, G bf16: device {d:.4f} ms a chain of {T} steps "
          f"(the wrapper's zeroed dfix included), {d1:.4f} a one-step "
          f"chain, {(d - d1) / (T - 1) * 1e3:.2f} us each further step; "
          f"events {time_ms(lambda: chain(T), reps=5):.4f} ms")


# (B, H, W, S) at which the correlation's cut is held against the kernel's
# export: planes it takes and planes and windows it refuses
CORR_PLAN_SHAPES = [(b, h, w, S) for b in (1, 4, 16, 70000)
                    for h in (1, 7, 8, 224, 352, 600000)
                    for w in (1, 23, 32, 304, 1216) for S in range(2, 15)]


def _check_corr_plan_mirror():
    """``mask_kernel.corr_plan`` against the cut the built correlation
    kernel exports (``shift_correlation_plan``) at CORR_PLAN_SHAPES."""
    import ctypes

    from rdfc_gan_torch.ops.kernels import build, mask_kernel

    lib = build.library(mask_kernel.CORR)
    out = (ctypes.c_int * 8)()
    for shape in CORR_PLAN_SHAPES:
        rc = lib.shift_correlation_plan(*shape, out)
        try:
            mirror = tuple(mask_kernel.corr_plan(*shape))
        except ValueError:
            mirror = None
        if (mirror is None) != (rc != 0) or (rc == 0 and
                                             tuple(out) != mirror):
            fail(f"mask_kernel.corr_plan{shape} = {mirror}, the kernel's "
                 f"{tuple(out)} (rc {rc})")
    print(f"  corr_plan matches the kernel's exported cut at "
          f"{len(CORR_PLAN_SHAPES)} (plane, window) cases")


def _chain_device_times(name, chain, T_, bnd):
    """A chain kernel's device time per chain and per step, and of a
    one-step chain (its set-up, the reverse chain's layout pass or the
    forward's mask copy, and a step), so the time of each further step
    reads apart from the set-up. ``chain(t)`` runs a t-step chain."""
    d = _device_ms(lambda: chain(T_), n=10)
    print(f"  {name} device time: {d:.4f} ms a chain of {T_} steps, "
          f"{d / T_ * 1e3:.2f} us a step; bound {bnd * 1e3:.2f} us (the "
          f"device time at {_pct(bnd, d)} of it)")
    ms_1 = _device_ms(lambda: chain(1), n=10)
    print(f"  {name}, as launched: one step chain {ms_1:.4f} ms (the set-up "
          f"and a step); each further step "
          f"{(d - ms_1) / (T_ - 1) * 1e3:.2f} us")


# (B, H, W, S) at which the forward chain's plan mirror is held against the
# kernel's export: the card tests' planes and a sweep (as
# tests/test_torch_nlspn_ops.py)
CHAIN_PLAN_SHAPES = [(2, 8, 9, 8), (2, 17, 23, 8), (1, 17, 23, 10),
                     (1, 17, 23, 12), (2, 30, 44, 4), (3, 9, 16, 6),
                     (4, 224, 304, 8), (4, 224, 304, 10), (1, 4000, 61, 8),
                     (16, 352, 1216, 8)] + [
    (b, h, w, S) for b in (1, 4, 16) for h in (1, 7, 224, 352, 1000)
    for w in (1, 9, 61, 304, 1216, 4000, 9000) for S in (4, 8, 12)]


def _check_chain_plan_mirror():
    """``nlspn_kernel.chain_plan`` against the plan each built chain kernel
    exports (``nlspn_chain_plan``, ``nlspn_reverse_chain_plan``), for this
    card's SM count and an H100's and for three shared-memory sizes, at
    CHAIN_PLAN_SHAPES."""
    import ctypes

    import torch

    from rdfc_gan_torch.ops.kernels import build, nlspn_kernel as nk

    out = (ctypes.c_int * 7)()
    sms = sorted({132, torch.cuda.get_device_properties(0)
                  .multi_processor_count, 16})
    for name, export in ((nk.NAME, "nlspn_chain_plan"),
                         (nk.CHAIN, "nlspn_reverse_chain_plan")):
        plan = getattr(build.library(name), export)
        n = 0
        for shape in CHAIN_PLAN_SHAPES:
            for sm in sms:
                for smem in (232448, 48 * 1024, 4096):
                    rc = plan(*shape, sm, smem, out)
                    try:
                        mirror = tuple(nk.chain_plan(*shape, sm, smem))
                    except ValueError:
                        mirror = None
                    if (mirror is None) != (rc != 0) or (
                            rc == 0 and tuple(out) != mirror):
                        fail(f"nlspn_kernel.chain_plan"
                             f"{shape + (sm, smem)} = {mirror}, {export}'s "
                             f"{tuple(out)} (rc {rc})")
                    n += 1
        print(f"  chain_plan matches {export} at {n} (plane, window, SMs, "
              f"shared memory) cases")


# offsets of the served model: the scale of conv_offset_aff is set so that
# the probe batch's max |offset| is this, inside the R=2 stencil window
# with the guard's 1.25 margin
TARGET_MAX_OFFSET = 1.5


def _seeded_generator(cfg, device, batch, train: bool = False):
    """The config's generator with torch's default init from a seed, and
    conv_offset_aff (zero-initialised, as in the reference, which would make
    the propagation the identity) set from a seeded generator, its offset
    channels scaled to TARGET_MAX_OFFSET on ``batch`` with BatchNorm in
    eval mode (``train`` False: as served) or train mode (batch
    statistics: as trained; the running statistics are put back after)."""
    import torch

    from rdfc_gan_torch import models  # noqa: F401
    from rdfc_gan_torch.registry import build_generator

    torch.manual_seed(0)
    g = build_generator(cfg.model.G.to_dict()).to(device).train(train)
    oa = g.nlspn_refine_module.prop_layer.conv_offset_aff
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        oa.weight.uniform_(-1.0, 1.0, generator=gen)
        oa.bias.uniform_(-1.0, 1.0, generator=gen)
        buffers = {k: v.clone() for k, v in g.named_buffers()}
        seen = {}
        hook = oa.register_forward_hook(
            lambda m, i, o: seen.setdefault("raw", o))
        g(batch["rgb"], batch["raw_depth"])
        hook.remove()
        for k, v in g.named_buffers():
            v.copy_(buffers[k])
        n_off = 2 * (oa.out_channels // 3)
        scale = TARGET_MAX_OFFSET / float(seen["raw"][:, :n_off].abs().max())
        oa.weight[:n_off] *= scale
        oa.bias[:n_off] *= scale
    return g.eval()


def serve_phase(workdir):
    """Serve the config through rdfc_gan_torch.test.run, counting kernel
    launches; check the counts, the metrics and pred_depth against the
    plain path on the card. Returns (launch counts, engine, a batch)."""
    import numpy as np
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.ops.kernels import build, mask_kernel, nlspn_kernel
    from rdfc_gan_torch.ops.nlspn_stencil import stencil_propagate

    args = ["--dataset", "synthetic", "--model_cfg_path",
            os.path.join(ROOT, "configs", "rdf_gan_nlspn_config.yaml"),
            "--work_dir", os.path.join(workdir, "work"),
            "--batch_size", str(B), "--out_height", str(H),
            "--out_width", str(W), "--device", "cuda"]
    cfg = parse_config(args)
    first = next(iter(port_test.build_val_loader(cfg, torch.device("cuda"))))
    g = _seeded_generator(cfg, "cuda", first)
    pth = os.path.join(workdir, "G.pth")
    torch.save({"G_state_dict": g.state_dict()}, pth)
    del g

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = port_test.run(parse_config(args + ["--load_from", pth]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    engine, metrics = res["engine"], res["metrics"]
    G = engine.modules["G"]
    per_forward = {"shift_mask_scatter": 1, "nlspn_propagate": 1,
                   "instance_norm_fwd": 4}
    print(f"serve: {os.path.basename(cfg.model_cfg_path)} at {H}x{W}, batch "
          f"{B}, {len(res['batch_seconds'])} batches; nlspn_max_offset of "
          f"the probe batch {res['max_offset']:.4f}, stencil radius "
          f"{G.nlspn_offset_radius}, impl {G.nlspn_impl}")
    print(f"  metrics: " + ", ".join(f"{k}={v:.6g}"
                                     for k, v in metrics.items()))
    bs = np.asarray(res["batch_seconds"]) * 1e3
    n_img = len(res["loader"].dataset)
    print(f"  per-request (batch of {B}) latency ms: median "
          f"{np.median(bs):.3f}, p90 {np.percentile(bs, 90):.3f}, max "
          f"{bs.max():.3f}; {n_img / (bs.sum() / 1e3):.2f} img/s served "
          f"(forward + metrics), run wall {wall:.2f} s incl. load and probe")
    print(f"  peak device memory {peak / 2**20:.1f} MiB; forwards "
          f"{res['forwards']}; kernel launches {counts}")
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"non-finite metrics {metrics}")
    for name, per in per_forward.items():
        want = res["forwards"] * per
        if counts.get(name, 0) == 0 or counts[name] != want:
            fail(f"{name}: {counts.get(name, 0)} launches, expected "
                 f"{res['forwards']} forwards x {per} = {want}")
    if not 0.5 <= res["max_offset"] <= 2.0:
        fail(f"nlspn_max_offset {res['max_offset']} outside [0.5, 2]")
    fps = port_test.run(parse_config(args + ["--load_from", pth,
                                             "--cal_fps"]))["fps"]
    print(f"  --cal_fps: {fps:.2f} img/s (300 images, batch {B}, loader "
          f"included, synchronized per batch)")

    batch = next(iter(res["loader"]))

    def forward():
        return engine.forward_test(rgb=batch["rgb"],
                                   raw_depth=batch["raw_depth"])["pred_depth"]

    def plain_prop(feat, M, fix, T_, R, preserve):
        return stencil_propagate(feat, M.to(torch.bfloat16), T_, R, fix,
                                 preserve)

    # cuDNN's default transposed-conv algorithms may sum with atomics, so
    # two forwards of the same model differ in the last bits and the
    # propagation can amplify that; the kernels-vs-plain comparison runs
    # with deterministic cuDNN algorithms so that only the kernels differ
    spread = float((forward() - forward()).abs().max())
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        got = forward()
        with mock.patch.object(mask_kernel, "scatter_shift_masks",
                               mask_kernel.scatter_shift_masks_plain), \
                mock.patch.object(nlspn_kernel, "nlspn_stencil_propagate",
                                  plain_prop):
            want = forward()
    torch.cuda.synchronize()
    print(f"  pred_depth of two kernel forwards with cuDNN's default "
          f"algorithms: max_abs_diff={spread:.3e}")
    if tuple(got.shape) != (B, 1, H, W) or float(got.abs().max()) > 1.0:
        fail(f"pred_depth shape {tuple(got.shape)} / range")
    compare("serve pred_depth, kernels vs plain path (deterministic cuDNN)",
            got, want, SERVE_RTOL, SERVE_ATOL)
    return counts, engine, batch


def _no_f32_conv(counts, title):
    """A bf16 run goes through the bf16 conv kernels alone: fail on any
    launch of the f32 ones."""
    from rdfc_gan_torch.ops.kernels import conv_block_kernel as ck

    f32 = {k: counts.get(k, 0) for k in (ck.FWD_F32, ck.BWD_F32)}
    print(f"  {title}: f32 conv kernel launches {f32} (must be 0)")
    if any(f32.values()):
        fail(f"{title} launched the f32 conv kernels")


def fused_blocks(module) -> int:
    """BasicBlocks of ``module`` that a train-mode forward runs through the
    fused conv3x3 kernels: two conv3x3_fwd and, in the backward, two
    conv3x3_bwd launches each."""
    from rdfc_gan_torch.models.resnet import BasicBlock

    return sum(1 for m in module.modules() if isinstance(m, BasicBlock)
               and m.downsample is None and m.conv1.stride == (1, 1)
               and m.conv1.dilation == (1, 1))


def _train_args(workdir, pth):
    return ["--dataset", "synthetic", "--model_cfg_path",
            os.path.join(ROOT, "configs", "rdf_gan_nlspn_config.yaml"),
            "--work_dir", os.path.join(workdir, "train"),
            "--batch_size", str(B), "--out_height", str(H),
            "--out_width", str(W), "--device", "cuda", "--n_epochs", "1",
            "--log_interval", "1", "--save_interval", "1",
            "--val_interval", "1", "--start_eval_epoch", "0",
            "--load_from", pth]


def _seeded_nets(cfg, workdir, device="cuda"):
    """The seeded generator of the serve phase and a PatchGAN from a seed,
    saved as one reference-schema checkpoint."""
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.registry import build_discriminator

    first = next(iter(port_test.build_val_loader(cfg, torch.device(device))))
    g = _seeded_generator(cfg, device, first, train=True)
    torch.manual_seed(2)
    d = build_discriminator(cfg.model.D.to_dict())
    pth = os.path.join(workdir, "GD.pth")
    torch.save({"G_state_dict": g.state_dict(),
                "D_state_dict": d.state_dict()}, pth)
    return pth


def train_phase(workdir):
    """Train the config one epoch at full width through
    rdfc_gan_torch.train.run at the config's compute type, counting kernel
    launches; check the losses, that G and D moved, the counts, and that
    rdfc_gan_torch.test serves best.pth to the in-train metrics. Returns
    (launch counts, engine, a batch, the checkpoint of the seeded nets)."""
    import numpy as np
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.ops.kernels import build, mask_kernel, norm_kernel
    from rdfc_gan_torch.ops.nlspn_guard import escalate_nlspn_cfg

    pth = _seeded_nets(parse_config(_train_args(workdir, "")[:-2]), workdir)
    args = _train_args(workdir, pth)
    cfg = parse_config(args)
    in_dtypes = collections.Counter()
    real_in_fwd = norm_kernel.instance_norm_fwd
    dM_dtypes = collections.Counter()
    real_corr = mask_kernel.shift_correlation

    def in_fwd(x, eps):  # the type autocast hands to the IN Function
        in_dtypes[str(x.dtype)] += 1
        return real_in_fwd(x, eps)

    def corr(*args):  # the type the correlation itself writes dM in
        dM = real_corr(*args)
        dM_dtypes[str(dM.dtype)] += 1
        return dM

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(norm_kernel, "instance_norm_fwd", in_fwd), \
            mock.patch.object(mask_kernel, "shift_correlation", corr):
        res = port_train.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    engine, steps = res["engine"], res["steps"]
    evals = engine.n_forward
    want = {"shift_mask_scatter": steps + evals, "shift_mask_gather": steps,
            "nlspn_propagate_x": steps, "nlspn_reverse_chain": steps,
            "shift_correlation": steps, "nlspn_propagate": evals,
            "instance_norm_fwd": 4 * (steps + evals),
            "instance_norm_bwd": 4 * steps,
            "conv3x3_fwd": 2 * fused_blocks(engine.modules["G"]) * steps,
            "conv3x3_bwd": 2 * fused_blocks(engine.modules["G"]) * steps}
    sec = np.asarray(res["step_seconds"][1:]) * 1e3  # the first warms up
    print(f"train: {os.path.basename(cfg.model_cfg_path)} at {H}x{W}, batch "
          f"{B}, {steps} steps + {evals} eval forwards, compute dtype "
          f"{engine.compute_dtype}, {cfg.gan_loss_type}, wall {wall:.2f} s")
    print("  last losses: " + ", ".join(
        f"{k}={v:.6g}" for k, v in sorted(res["losses"].items())))
    print(f"  step ms (host clock, each ending in its loss readback; first "
          f"step left out): median {np.median(sec):.3f}, p90 "
          f"{np.percentile(sec, 90):.3f}, max {sec.max():.3f}; "
          f"{B / (np.median(sec) / 1e3):.2f} img/s trained; peak device "
          f"memory {peak / 2**20:.1f} MiB")
    print(f"  kernel launches {counts}; expected {want}")
    print(f"  instance norm inputs by type (W-AdaIN under the step's "
          f"autocast, and the evaluation): {dict(in_dtypes)}")
    print(f"  dM by the type the correlation kernel wrote it in (the "
          f"masks' type: no cast pass): {dict(dM_dtypes)}")
    if engine.compute_dtype == torch.bfloat16 and set(dM_dtypes) != {
            str(torch.bfloat16)}:
        fail(f"the bf16 step's correlation wrote dM as {dict(dM_dtypes)}, "
             f"not in the masks' bf16")
    print("  metrics after the epoch: " + ", ".join(
        f"{k}={v:.6g}" for k, v in res["metrics"].items()))
    if not all(np.isfinite(v) for v in res["losses"].values()):
        fail(f"non-finite losses {res['losses']}")
    _no_f32_conv(counts, "the RDFGAN bf16 epoch")
    if counts != want:
        fail(f"launch counts {counts} are not {want}")
    before = torch.load(pth, map_location="cpu", weights_only=True)
    for net in ("G", "D"):
        sd = engine.modules[net].state_dict()
        moved = sum(int(not torch.equal(sd[k].cpu(), v))
                    for k, v in before[f"{net}_state_dict"].items()
                    if "running" not in k and "num_batches" not in k)
        print(f"  {net}: {moved} parameter tensors changed")
        if moved == 0:
            fail(f"{net}'s parameters did not change")
    best = os.path.join(cfg.work_dir, "best.pth")
    res_best = port_test.run(parse_config(
        ["--dataset", "synthetic", "--model_cfg_path", cfg.model_cfg_path,
         "--work_dir", os.path.join(workdir, "serve_best"),
         "--batch_size", str(B), "--out_height", str(H), "--out_width",
         str(W), "--device", "cuda", "--load_from", best]))
    served = res_best["metrics"]
    if not all(np.isfinite(v) for v in served.values()):
        fail(f"rdfc_gan_torch.test on best.pth: non-finite {served}")
    _, escalated = escalate_nlspn_cfg(cfg.model.G.to_dict(),
                                      res_best["max_offset"])
    if escalated:
        # the offset guard rebuilt the generator (larger radius or the
        # gather), so the served metrics differ from the in-train ones by
        # design
        print(f"  rdfc_gan_torch.test serves best.pth (max|offset| "
              f"{res_best['max_offset']:.3f}: the guard rebuilt G, so its "
              f"metrics are not compared): " + ", ".join(
                  f"{k}={v:.6g}" for k, v in served.items()))
    else:
        for k, v in served.items():
            if not np.isclose(v, res["metrics"][k], rtol=SERVE_RTOL,
                              atol=SERVE_ATOL):
                fail(f"rdfc_gan_torch.test on best.pth: {k}={v}, the "
                     f"epoch's evaluation {res['metrics'][k]}")
        print(f"  rdfc_gan_torch.test serves best.pth to the same metrics "
              f"(rtol {SERVE_RTOL:g}, max|offset| "
              f"{res_best['max_offset']:.3f})")
    batch = next(iter(port_train.build_train_loader(cfg, engine.device)))
    return counts, engine, batch, pth


# kernels vs plain on one f32 train step: relative to each gradient
# tensor's largest entry (the kernels agree bit for bit with their plain
# versions; deterministic cuDNN leaves only atomics elsewhere)
STEP_RTOL = 1e-4


def _f32_stats_instance_norm_fwd(x, eps):
    """The IN forward with its statistics summed in f32 by ATen's ``mean``
    (the JAX package's f32 sums, in another order): the same function,
    its last bits moved as another summation order moves them."""
    import torch

    xf = x.float()
    m = xf.mean(dim=(2, 3))
    a = torch.rsqrt(torch.clamp_min((xf * xf).mean(dim=(2, 3)) - m * m,
                                    0.0) + eps)
    b = -m * a
    return (x * a[:, :, None, None].to(x.dtype)
            + b[:, :, None, None].to(x.dtype)), a


def _step_diff(title, a, b):
    """Losses and gradients of steps ``a`` and ``b`` (losses, grads):
    returns (the losses' largest relative difference, each gradient's
    max|a - b| / max|b| sorted from the largest); prints them and each
    net's whole-gradient relative L2 difference."""
    import torch

    (la, ga), (lb, gb) = a, b
    worst = max((float((la[k] - lb[k]).abs()) / max(float(lb[k].abs()),
                                                     1e-30), k) for k in lb)
    errs = sorted(((float((ga[k] - gb[k]).abs().max())
                    / max(float(gb[k].abs().max()), 1e-30), k) for k in gb),
                  reverse=True)
    l2 = {}
    for net in sorted({k.split(".")[0] for k in gb}):
        keys = [k for k in gb if k.startswith(f"{net}.")]
        va = torch.cat([ga[k].flatten() for k in keys])
        vb = torch.cat([gb[k].flatten() for k in keys])
        l2[net] = float((va - vb).norm() / vb.norm())
    print(f"  {title}: losses max relative difference {worst[0]:.3e} "
          f"({worst[1]}); {len(errs)} gradients, max|a - b| / max|b|: "
          + "; ".join(f"{e:.3e} ({k})" for e, k in errs[:3])
          + "; whole-gradient relative L2: "
          + ", ".join(f"{k} {v:.3e}" for k, v in l2.items()))
    return worst[0], errs


def plain_in_and_conv():
    """The plain versions of the IN and fused-conv kernels, keyed by the
    (module, name) through which the port calls them."""
    from rdfc_gan_torch.ops import fused_block
    from rdfc_gan_torch.ops.kernels import conv_block_kernel as ck
    from rdfc_gan_torch.ops.kernels import norm_kernel as nk

    return {(nk, "instance_norm_fwd"): nk.instance_norm_fwd_plain,
            (nk, "instance_norm_bwd"): nk.instance_norm_bwd_plain,
            (fused_block, "conv3x3_fwd"): ck.conv3x3_fwd_plain,
            (fused_block, "conv3x3_bwd"): ck.conv3x3_bwd_plain}


def step_compare_phase(workdir, pth):
    """One f32 train step with deterministic cuDNN from the seeded nets,
    once through the kernels and once with the plain versions patched in;
    the losses and every parameter gradient of G and D must agree. A third
    step, the plain one with the IN statistics summed in f32 by ATen, shows
    how far a last-bit change of the IN statistics moves the same
    gradients."""
    import torch

    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.ops import nlspn_stencil as st
    from rdfc_gan_torch.ops.kernels import (build, mask_kernel, nlspn_kernel,
                                            norm_kernel)
    from rdfc_gan_torch.train import build_train_loader
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    cfg = parse_config(_train_args(workdir, pth))
    cfg["compute_dtype"] = "float32"
    batch = next(iter(build_train_loader(cfg, torch.device("cuda"))))
    mk, nk = mask_kernel, norm_kernel
    plain = {(mk, "_scatter"): mk.scatter_shift_masks_plain,
             (mk, "shift_mask_gather"): mk.shift_mask_gather_plain,
             (mk, "shift_correlation"): mk.shift_correlation_plain,
             (nlspn_kernel, "propagate_x"): st.propagate_x_plain,
             (nlspn_kernel, "reverse_chain"): st.reverse_chain_plain,
             **plain_in_and_conv()}
    paths = {"kernels": {}, "plain": plain,
             "f32": {**plain, (nk, "instance_norm_fwd"):
                     _f32_stats_instance_norm_fwd}}
    out, launches = {}, {}
    for path, patches in paths.items():
        engine = build_engine(cfg, is_train=True, steps_per_epoch=16)
        load_checkpoint(engine.modules, pth)
        build.reset_launches()
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False))
            for (mod, name), fn in patches.items():
                stack.enter_context(mock.patch.object(mod, name, fn))
            losses = engine.train_step(batch)
            torch.cuda.synchronize()
        grads = {f"{net}.{n}": p.grad.detach().clone()
                 for net in ("G", "D")
                 for n, p in engine.modules[net].named_parameters()
                 if p.grad is not None}
        out[path] = (losses, grads)
        launches[path] = dict(build.LAUNCHES)
        del engine
    print(f"kernels vs plain, one f32 train step (deterministic cuDNN): "
          f"launches {launches['kernels']} vs {launches['plain']}")
    if launches["plain"] or launches["f32"] or not launches["kernels"]:
        fail("the plain step launched a kernel, or the kernel step none")
    worst, errs = _step_diff("kernels vs plain", out["kernels"],
                             out["plain"])
    _step_diff("plain with the IN statistics summed in f32 vs plain (for "
               "the record, not checked)", out["f32"], out["plain"])
    if set(out["kernels"][1]) != set(out["plain"][1]) or worst > STEP_RTOL:
        fail("losses or the set of gradients differ")
    if errs[0][0] > STEP_RTOL:
        fail("a gradient of the kernel step disagrees with the plain step")


def bf16_step_compare_phase(workdir, pth):
    """One RDFGAN train step at the config's bf16 compute type with
    deterministic cuDNN from the seeded nets: through the kernels, through
    their plain versions, the plain way again (run to run), and as a
    control with the identity blocks on torch's convolution and
    BatchNorm2d. The bf16 conv kernels sum in f32, the plain versions in
    f64, so the kernel step is held to the control: each loss and gradient
    within FLAGSHIP_STEP_FACTOR times the larger of the control's and the
    run-to-run difference from the plain step, and of one bf16 ulp of the
    plain value (``_hold_to_control``)."""
    import torch

    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.models.resnet import BasicBlock
    from rdfc_gan_torch.ops import nlspn_stencil as st
    from rdfc_gan_torch.ops.kernels import (build, mask_kernel, nlspn_kernel)
    from rdfc_gan_torch.ops.kernels import conv_block_kernel as ck
    from rdfc_gan_torch.train import build_train_loader
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    cfg = parse_config(_train_args(workdir, pth))
    batch = next(iter(build_train_loader(cfg, torch.device("cuda"))))
    mk = mask_kernel
    plain = {(mk, "_scatter"): mk.scatter_shift_masks_plain,
             (mk, "shift_mask_gather"): mk.shift_mask_gather_plain,
             (mk, "shift_correlation"): mk.shift_correlation_plain,
             (nlspn_kernel, "propagate_x"): st.propagate_x_plain,
             (nlspn_kernel, "reverse_chain"): st.reverse_chain_plain,
             **plain_in_and_conv()}
    paths = {"kernels": {}, "plain": plain, "plain again": plain,
             "control": {**plain, (BasicBlock, "fused"):
                         lambda self: False}}
    out, launches = {}, {}
    for path, patches in paths.items():
        engine = build_engine(cfg, is_train=True, steps_per_epoch=16)
        load_checkpoint(engine.modules, pth)
        build.reset_launches()
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False))
            for (mod, name), fn in patches.items():
                stack.enter_context(mock.patch.object(mod, name, fn))
            losses = engine.train_step(batch)
            torch.cuda.synchronize()
        dtype = engine.compute_dtype
        grads = {f"{net}.{n}": p.grad.detach().clone()
                 for net in ("G", "D")
                 for n, p in engine.modules[net].named_parameters()
                 if p.grad is not None}
        out[path] = (losses, grads)
        launches[path] = dict(build.LAUNCHES)
        del engine
    print(f"kernels vs plain, one {dtype} RDFGAN train step (deterministic "
          f"cuDNN): launches {launches['kernels']}")
    if launches["plain"] or launches["control"] or \
            launches["plain again"]:
        fail("a plain bf16 step launched a kernel")
    k = launches["kernels"]
    _no_f32_conv(k, "the bf16 RDFGAN step")
    if not k.get(ck.FWD) or not k.get(ck.BWD):
        fail(f"the bf16 step did not run the bf16 conv kernels: {k}")
    if set(out["kernels"][1]) != set(out["plain"][1]):
        fail("the bf16 steps differ in their gradients")
    _step_diff("bf16 kernels vs plain", out["kernels"], out["plain"])
    _step_diff("bf16 plain again vs plain (run to run)",
               out["plain again"], out["plain"])
    _step_diff("bf16 control vs plain", out["control"], out["plain"])
    _hold_to_control("bf16 RDFGAN step", out, bf16_floor=True)


def train_profile_phase(engine, batch, n: int = 2,
                        title: str = "train profile"):
    """Device time by kernel over ``n`` train steps, and the device's busy
    share of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    _print_profile(prof, f"{title} ({n} steps of batch {B})", "step",
                   wall_ms, n, top=20, host_top=12)


def _print_profile(prof, title, unit, wall_ms, n, top=15, host_top=0):
    import torch

    # device-side events only: the aten ops that launch them report the
    # same time again
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in evts) / 1e3 / n
    print(f"{title}: wall {wall_ms:.3f} ms per {unit}, device busy "
          f"{total:.3f} ms "
          + (f"({100 * total / wall_ms:.1f}%)" if total else
             "(not measured: the profiler saw no device time)"))
    evts.sort(key=lambda e: -e.self_device_time_total)
    for e in evts[:top]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms "
              f"x{e.count // n:<4d} {e.key[:90]}")
    if host_top:
        # where the host's time goes when the device waits for it
        ops = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CPU
                      and e.self_cpu_time_total > 0),
                     key=lambda e: -e.self_cpu_time_total)
        print(f"  host, by self CPU time per {unit} (profiled, so inflated):")
        for e in ops[:host_top]:
            print(f"  {e.self_cpu_time_total / 1e3 / n:9.3f} ms "
                  f"x{e.count // n:<5d} {e.key[:90]}")


def profile_phase(engine, batch, n: int = 3, title: str = "profile"):
    """Device time by kernel over ``n`` served batches, and the device's
    busy share of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        engine.forward_test(rgb=batch["rgb"], raw_depth=batch["raw_depth"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            engine.forward_test(rgb=batch["rgb"],
                                raw_depth=batch["raw_depth"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    _print_profile(prof, f"{title} ({n} forwards of batch {B})", "forward",
                   wall_ms, n)


def instance_norm_phase():
    """The IN forward and backward kernels against their plain versions at
    the four W-AdaIN shapes, G_B2A's three and two odd planes, f32 and bf16.
    Prints each shape's times (CUDA events and device) with the plan each
    kernel took, the forward's beside ``F.instance_norm``, and G_B2A's
    forward and backward times per application. Returns
    the two kernel rows: the forward at the served f32 and the backward at
    the train step's bf16, each time the sum over the four shapes of one
    forward or step."""
    import torch
    import torch.nn.functional as F

    from rdfc_gan_torch.ops.kernels import norm_kernel as nk

    gen = torch.Generator(device="cuda").manual_seed(3)
    print("instance norm kernel checks (the W-AdaIN, G_B2A and odd shapes):")
    _check_plan_mirrors(nk, IN_SHAPES + G_B2A_IN_SHAPES + ODD_IN_SHAPES)
    acc = {(k, dt, grp): collections.defaultdict(float)
           for k in ("fwd", "bwd")
           for dt in (torch.float32, torch.bfloat16)
           for grp in ("W-AdaIN", "G_B2A")}
    per_app = collections.defaultdict(float)
    for shape in IN_SHAPES + G_B2A_IN_SHAPES + ODD_IN_SHAPES:
        grp = ("W-AdaIN" if shape in IN_SHAPES else
               "G_B2A" if shape in G_B2A_IN_SHAPES else "odd")
        n_el = 1
        for d in shape:
            n_el *= d
        planes = shape[0] * shape[1]
        xf = torch.randn(shape, device="cuda", generator=gen) * 3 + 1.5
        gf = torch.randn(shape, device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x, dy = xf.to(dt), gf.to(dt)
            tag = f"{tuple(shape)} {dt}"
            y, a = nk.instance_norm_fwd(x, 1e-5)
            dx = nk.instance_norm_bwd(dy, y, a)
            torch.cuda.synchronize()
            py, pa = nk.instance_norm_fwd_plain(x, 1e-5)
            err_f = max(compare(f"instance_norm_fwd y {tag}", y, py, IN_RTOL,
                                IN_ATOL),
                        compare(f"instance_norm_fwd a {tag}", a, pa, IN_RTOL,
                                IN_ATOL))
            err_b = compare(f"instance_norm_bwd dx {tag}", dx,
                            nk.instance_norm_bwd_plain(dy, y, a), IN_RTOL,
                            IN_ATOL)
            if grp == "odd":
                continue
            isz = x.element_size()
            # f64: a convert, an add, a multiply and an add an element;
            # f32: a multiply and an add for y; counted at the f32 rate
            fwd_bytes = 2 * n_el * isz + planes * 4
            fwd_ops = n_el * (2.0 + 4.0 * PEAK_F32_FLOPS / PEAK_F64_FLOPS)
            t_k = time_ms(lambda: nk.instance_norm_fwd(x, 1e-5))
            t_lib = time_ms(lambda: F.instance_norm(x, eps=1e-5))
            # device time alone: at the small planes the events time the
            # host's launches
            d_k = _device_ms(lambda: nk.instance_norm_fwd(x, 1e-5), n=10)
            d_lib = _device_ms(lambda: F.instance_norm(x, eps=1e-5), n=10)
            bnd, by = bound_ms(fwd_bytes, fwd_ops)
            how = _plan_words(nk.fwd_plan(shape[2] * shape[3], isz), isz,
                              "x")
            print(f"  instance_norm_fwd {tag}: {how}: kernel "
                  f"{t_k:.4f} ms (device {d_k:.4f}), F.instance_norm "
                  f"{t_lib:.4f} ms (device {d_lib:.4f}), bound {bnd:.4f} ms "
                  f"({by}; the kernel's device time at "
                  f"{_pct(bnd, d_k)} of it)")
            if grp == "G_B2A":
                w = G_B2A_IN_LAUNCHES[G_B2A_IN_SHAPES.index(shape)]
                for key, t in (("kernel", t_k), ("library", t_lib),
                               ("kernel device", d_k),
                               ("library device", d_lib), ("bound", bnd)):
                    per_app[(key, dt)] += w * t
            bwd_bytes = 3 * n_el * isz + planes * 4
            bwd_ops = n_el * (4.0 + 5.0 * PEAK_F32_FLOPS / PEAK_F64_FLOPS)
            t_kb = time_ms(lambda: nk.instance_norm_bwd(dy, y, a))
            d_kb = _device_ms(lambda: nk.instance_norm_bwd(dy, y, a), n=10)
            bnd_b, by_b = bound_ms(bwd_bytes, bwd_ops)
            how = _plan_words(nk.bwd_plan(shape[2] * shape[3], isz), isz,
                              "dy and y")
            print(f"  instance_norm_bwd {tag}: {how}: kernel "
                  f"{t_kb:.4f} ms (device {d_kb:.4f}), bound {bnd_b:.4f} ms "
                  f"({by_b}; the kernel's device time at "
                  f"{_pct(bnd_b, d_kb)} of it)")
            if grp == "G_B2A":
                w = G_B2A_IN_LAUNCHES[G_B2A_IN_SHAPES.index(shape)]
                for key, t in (("bwd kernel", t_kb), ("bwd kernel device",
                                                      d_kb),
                               ("bwd bound", bnd_b)):
                    per_app[(key, dt)] += w * t
            f = acc[("fwd", dt, grp)]
            f["err"] = max(f["err"], err_f)
            f["ms"] += t_k
            f["plain_ms"] += time_ms(
                lambda: nk.instance_norm_fwd_plain(x, 1e-5))
            f["library_ms"] += t_lib
            f["bytes"] += fwd_bytes
            f["ops"] += fwd_ops
            b = acc[("bwd", dt, grp)]
            b["err"] = max(b["err"], err_b)
            b["ms"] += t_kb
            b["device_ms"] += d_kb
            b["plain_ms"] += time_ms(
                lambda: nk.instance_norm_bwd_plain(dy, y, a))
            b["bytes"] += bwd_bytes
            b["ops"] += bwd_ops
            if dt == torch.bfloat16 and shape == IN_SHAPES[0]:
                # what F.instance_norm, the port's IN before these kernels,
                # gives under the train step's autocast
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    lib = F.instance_norm(x, eps=1e-5)
                print(f"  F.instance_norm of a bf16 input under bf16 "
                      f"autocast: dtype {lib.dtype}, "
                      f"{float((lib != py).float().mean()) * 100:.2f}% of "
                      f"elements differ from the JAX rounding, max "
                      f"{float((lib.float() - py.float()).abs().max()):.3e}")
    mix = " + ".join(f"{w} x {s[1]}-ch" for w, s in zip(G_B2A_IN_LAUNCHES,
                                                        G_B2A_IN_SHAPES))
    for dt in (torch.float32, torch.bfloat16):
        t = {k: v for (k, d), v in per_app.items() if d == dt}
        print(f"  instance_norm_fwd {dt}, one G_B2A application ({mix}): "
              f"kernel {t['kernel']:.4f} ms (device "
              f"{t['kernel device']:.4f}), F.instance_norm "
              f"{t['library']:.4f} ms (device {t['library device']:.4f}), "
              f"bound {t['bound']:.4f} ms")
        print(f"  instance_norm_bwd {dt}, one G_B2A application ({mix}): "
              f"kernel {t['bwd kernel']:.4f} ms (device "
              f"{t['bwd kernel device']:.4f}), bound {t['bwd bound']:.4f} ms "
              f"(the device time at {_pct(t['bwd bound'], t['bwd kernel device'])}"
              f" of it)")
    for (kind, dt, grp), r in acc.items():
        bnd, by = bound_ms(r["bytes"], r["ops"])
        dev = (f" (device {r['device_ms']:.4f})" if kind == "bwd" else "")
        print(f"  instance_norm_{kind} {dt}, the {grp} shapes: kernel "
              f"{r['ms']:.4f} ms{dev}, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms'] if kind == 'fwd' else None} ms, bound "
              f"{bnd * 1e3:.2f} us ({by})")
    rows = {}
    for kind, dt, replaces in (
            ("fwd", torch.float32, "attic/norm_kernel.py:211"),
            ("bwd", torch.bfloat16, "attic/norm_kernel.py:230")):
        r = acc[(kind, dt, "W-AdaIN")]
        bnd, by = bound_ms(r["bytes"], r["ops"])
        rows[f"instance_norm_{kind}"] = dict(
            name=f"instance_norm_{kind}", route="cuda",
            source="rdfc_gan_torch/csrc/instance_norm.cu",
            replaces=replaces, max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=bnd, bound_by=by,
            library_ms=r["library_ms"] if kind == "fwd" else None)
    return rows


def _plan_words(p, isz: int, staged: str) -> str:
    """How an IN kernel's plan cuts a plane, in words."""
    return (f"a cluster of {p.cluster} blocks a plane" if p.cluster > 1 else
            f"{p.teams} planes a block" if p.teams > 1 else
            "one block a plane") + (
        f", {p.team} threads a plane, {p.vec * isz}-byte vectors, {staged} "
        f"staged once")


def _check_plan_mirrors(nk, shapes):
    """The Python plans (``norm_kernel.fwd_plan`` and ``bwd_plan``) and the
    split's TMA rule (``bulk_copy``) against the ones the built kernel
    exports, at the phase's plane sizes and a sweep, f32 and bf16."""
    import ctypes

    from rdfc_gan_torch.ops.kernels import build

    lib = build.library(nk.SOURCE)
    out = (ctypes.c_int * 5)()
    sizes = sorted({s[2] * s[3] for s in shapes} | set(range(1, 5000, 7)) |
                   set(range(5000, 420000, 4999)))
    for kind in ("fwd", "bwd"):
        export = getattr(lib, f"instance_norm_{kind}_plan")
        mirror = getattr(nk, f"{kind}_plan")
        for n in sizes:
            for size in (2, 4):
                export(n, size, out)
                if tuple(out) != tuple(mirror(n, size)):
                    fail(f"norm_kernel.{kind}_plan({n}, {size}) = "
                         f"{tuple(mirror(n, size))}, the kernel's "
                         f"{tuple(out)}")
    for n in sizes:
        for size in (2, 4):
            if bool(lib.instance_norm_bulk_copy(n, size)) != \
                    nk.bulk_copy(n, size):
                fail(f"norm_kernel.bulk_copy({n}, {size}) is "
                     f"{nk.bulk_copy(n, size)}, the kernel's not")
    print(f"  fwd_plan, bwd_plan and bulk_copy match the kernel's exports "
          f"at {len(sizes)} plane sizes, f32 and bf16")


def conv_block_phase():
    """The fused conv3x3 kernels against their plain versions at the four
    identity-block shapes: the forward with no prologue
    (conv1) and with the affine + ReLU prologue (conv2); the backward of
    conv2 (finalize, ReLU', BN sums), of conv1 (finalize, carry) and bare.
    f32 (conv_block.cu) bit for bit; bf16 (conv3x3_bf16.cu, the train
    steps' kernels) within the tolerance conv_block_kernel states, printed
    with the observed error and the share of elements that differ. Times
    the conv2 forward and backward, the plain versions, and cuDNN's
    F.conv2d / convolution_backward on the same inputs (f32 without TF32).
    Returns the two kernel rows at the train step's bf16, each time the
    sum over the four shapes of one call."""
    import torch
    import torch.nn.functional as F

    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.ops.kernels import conv_block_kernel as ck

    log = build.BUILD_LOGS.get(ck.SOURCE_BF16, "")
    print("conv3x3_bf16.cu, ptxas: " + " | ".join(
        ln.strip() for ln in log.splitlines()
        if "Compiling" in ln or "Used" in ln or "spill" in ln))
    if "bytes spill" in log and not all(
            " 0 bytes spill stores, 0 bytes spill loads" in ln
            for ln in log.splitlines() if "spill" in ln):
        print("  (spills in the report above)")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*s, scale=1.0, shift=0.0):
        return torch.randn(s, device="cuda", generator=gen) * scale + shift

    print(f"conv3x3 block kernel checks (batch {B}, the identity "
          f"BasicBlocks; f32 bit for bit, bf16 within y/gout "
          f"{ck.Y_ULPS:g} ulp, mom {ck.MOM_RTOL:.3g}, dW/sums "
          f"{ck.SUM_RTOL:.3g} of the absolute sums):")
    acc = {(k, dt): collections.defaultdict(float)
           for k in ("fwd", "bwd") for dt in (torch.float32, torch.bfloat16)}

    def bf16_rows(title, rows, got, want_first):
        """Print and hold the tolerance rows; returns max |got - plain|
        of y or gout."""
        for name, err, bnd, note in rows:
            ok = err <= bnd
            print(f"  {title} {name}: error {err:.4g} (bound {bnd:.4g})"
                  + (f"; {note}" if note else "") + (" ok" if ok else
                                                     " FAIL"))
            if not ok:
                fail(f"{title} {name} outside its tolerance")
        return float((got.float() - want_first.float()).abs().max())

    for C, h, w in CONV_SHAPES:
        uf = rnd(B, C, h, w, scale=1.5, shift=0.2)
        wf = rnd(C, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
        a, b = rnd(C, scale=0.3, shift=1.0), rnd(C, scale=0.3)
        gf, yf, cf = (rnd(B, C, h, w), rnd(B, C, h, w, scale=2.0, shift=0.5),
                      rnd(B, C, h, w))
        fin = torch.stack([rnd(C, scale=0.3, shift=1.0), rnd(C, scale=0.1),
                           rnd(C, scale=0.1), rnd(C, scale=0.3),
                           rnd(C, scale=0.1, shift=0.8)])
        xh = (rnd(C, scale=0.3), rnd(C, scale=0.1, shift=0.8))
        n_el = B * C * h * w
        flops = 2.0 * B * h * w * C * C * 9
        for dt in (torch.float32, torch.bfloat16):
            u, g, y, cy = (t.to(dt) for t in (uf, gf, yf, cf))
            tag = f"({B}, {C}, {h}, {w}) {dt}"
            f, bk = acc[("fwd", dt)], acc[("bwd", dt)]
            for args, kind in (((None, None, "none"), "conv1"),
                               ((a, b, "relu"), "conv2")):
                got = ck.conv3x3_fwd(u, wf, *args)
                torch.cuda.synchronize()
                want = ck.conv3x3_fwd_plain(u, wf, *args)
                if dt == torch.bfloat16:
                    f["err"] = max(f["err"], bf16_rows(
                        f"conv3x3_fwd {kind} {tag}",
                        ck.check_fwd_bf16(got, u, wf, *args, want=want),
                        got[0], want[0]))
                    continue
                for name, x_, y_ in zip(("y", "moments"), got, want):
                    f["err"] = max(f["err"], compare(
                        f"conv3x3_fwd {kind} {name} {tag}", x_, y_,
                        CONV_RTOL, CONV_ATOL))
            conv2_bwd = dict(a=a, b=b, act="relu", y=y, fin=fin, xh=xh)
            for kw, kind in ((conv2_bwd, "conv2"),
                             (dict(y=y, fin=fin, carry=cy), "conv1"),
                             ({}, "bare")):
                got = ck.conv3x3_bwd(g, u, wf, **kw)
                torch.cuda.synchronize()
                if (got[2] is None) != ("xh" not in kw):
                    fail(f"conv3x3_bwd {kind}: sums returned or missing")
                if dt == torch.bfloat16:
                    parts = ck._bwd_parts(g, u, wf, **kw)
                    rows = ck.check_bwd_bf16(got, g, u, wf, **kw,
                                             parts=parts)
                    bk["err"] = max(bk["err"], bf16_rows(
                        f"conv3x3_bwd {kind} {tag}", rows, got[0],
                        parts["gout"]))
                    continue
                want = ck.conv3x3_bwd_plain(g, u, wf, **kw)
                for name, x_, y_ in zip(("gout", "dW", "sums"), got, want):
                    if y_ is None:
                        continue
                    bk["err"] = max(bk["err"], compare(
                        f"conv3x3_bwd {kind} {name} {tag}", x_, y_,
                        CONV_RTOL, CONV_ATOL))
            isz = u.element_size()
            wd = wf.to(dt)
            # the f64 f32 kernels take 11-20 ms a call: fewer repetitions
            reps, warm = (5, 1) if dt == torch.float32 else (20, 3)
            f["ms"] += time_ms(lambda: ck.conv3x3_fwd(u, wf, a, b, "relu"),
                               reps=reps, warmup=warm)
            f["plain_ms"] += time_ms(
                lambda: ck.conv3x3_fwd_plain(u, wf, a, b, "relu"), reps=1,
                warmup=0)
            bk["ms"] += time_ms(lambda: ck.conv3x3_bwd(g, u, wf, **conv2_bwd),
                                reps=reps, warmup=warm)
            bk["plain_ms"] += time_ms(
                lambda: ck.conv3x3_bwd_plain(g, u, wf, **conv2_bwd), reps=1,
                warmup=0)
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=False,
                                            allow_tf32=False):
                f["library_ms"] += time_ms(
                    lambda: F.conv2d(u, wd, padding=1))
                bk["library_ms"] += time_ms(
                    lambda: torch.ops.aten.convolution_backward(
                        g, u, wd, None, [1, 1], [1, 1], [1, 1], False,
                        [0, 0], 1, [True, True, False]))
            # each input read once, each output written once
            f["bytes"] += 2 * n_el * isz + C * C * 9 * isz + 2 * C * 4 \
                + B * 2 * C * 8
            f["ops"] += flops
            bk["bytes"] += 4 * n_el * isz + C * C * 9 * (isz + 4) \
                + 7 * C * 4 + B * 2 * C * 8
            bk["ops"] += 2 * flops
    rows = {}
    for (kind, dt), r in acc.items():
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
        bnd, by = bound_ms(r["bytes"], r["ops"], peak)
        print(f"  conv3x3_{kind} {dt}, 4 shapes: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, cuDNN {r['library_ms']:.4f} "
              f"ms ({r['ms'] / r['library_ms']:.2f}x), bound {bnd:.4f} ms "
              f"({by}; {r['ops'] / 1e12:.3f} TFLOP, "
              f"{r['ops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
              f"{100 * bnd / r['ms']:.1f}% of the bound)")
        if dt == torch.bfloat16:
            rows[f"conv3x3_{kind}"] = dict(
                name=f"conv3x3_{kind}", route="cuda",
                source="rdfc_gan_torch/csrc/conv3x3_bf16.cu",
                replaces=("attic/conv_block_kernel.py:67" if kind == "fwd"
                          else "attic/conv_block_kernel.py:221"),
                max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=bnd, bound_by=by, library_ms=r["library_ms"])
    return rows


def batchnorm_rounding_check():
    """What torch's own train-mode batch norm gives for a bf16 input (what
    every train-mode BatchNorm gets under the steps' autocast) against the
    JAX rounding that ``models.layers.BatchNorm2d`` follows: printed for
    the record."""
    import torch
    import torch.nn.functional as F

    from rdfc_gan_torch.models.layers import BatchNorm2d

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn((B, 128, 28, 38), device="cuda", generator=gen) * 3
         + 1.5).to(torch.bfloat16)
    bn = BatchNorm2d(128).cuda().train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(128, device="cuda", generator=gen) + 0.5)
        bn.bias.copy_(torch.rand(128, device="cuda", generator=gen) - 0.5)
        ours = bn(x)
        lib = F.batch_norm(x, None, None, bn.weight, bn.bias, training=True,
                           eps=bn.eps)
    print(f"train-mode batch norm of a bf16 {tuple(x.shape)} input: "
          f"F.batch_norm gives {lib.dtype}, "
          f"{float((lib != ours).float().mean()) * 100:.2f}% of elements "
          f"differ from the JAX rounding, max "
          f"{float((lib.float() - ours.float()).abs().max()):.3e}")


def _flagship_args(workdir, extra=()):
    return ["--dataset", "synthetic", "--model_cfg_path",
            os.path.join(ROOT, "configs", "rdf_cycle_patchgan_config.yaml"),
            "--work_dir", os.path.join(workdir, "flagship"),
            "--batch_size", str(B), "--out_height", str(H),
            "--out_width", str(W), "--device", "cuda", *extra]


def flagship_serve_phase(workdir):
    """Serve the flagship RDFC-GAN through rdfc_gan_torch.test.run with and
    without --depth_only (seeded weights: rdfc_gan_torch.test seeds torch
    before it builds the nets), counting kernel launches; check the
    metrics, the outputs and 4 IN launches per forward, and hold pred_depth
    against the plain IN path. Returns (launch counts of the full run,
    engine, batch)."""
    import numpy as np
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.ops.kernels import build, norm_kernel

    # --depth_only first, so that its engine is gone before the full run,
    # whose engine the checks below keep
    for depth_only in (True, False):
        engine = None
        extra = ("--depth_only",) if depth_only else ()
        args = _flagship_args(workdir, extra)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        res = port_test.run(parse_config(args))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        metrics, fwd = res["metrics"], res["forwards"]
        bs = np.asarray(res["batch_seconds"]) * 1e3
        n_img = len(res["loader"].dataset)
        mode = "--depth_only" if depth_only else "full"
        print(f"flagship serve ({mode}): rdf_cycle_patchgan_config.yaml at "
              f"{H}x{W}, batch {B}, {len(bs)} batches, f32")
        print("  metrics: " + ", ".join(f"{k}={v:.6g}"
                                        for k, v in metrics.items()))
        print(f"  per-request (batch of {B}) latency ms: median "
              f"{np.median(bs):.3f}, p90 {np.percentile(bs, 90):.3f}, max "
              f"{bs.max():.3f}; {n_img / (bs.sum() / 1e3):.2f} img/s served "
              f"(forward + metrics), run wall {wall:.2f} s incl. build")
        print(f"  peak device memory {peak / 2**20:.1f} MiB; forwards {fwd}; "
              f"kernel launches {counts}")
        if not all(np.isfinite(v) for v in metrics.values()):
            fail(f"flagship {mode}: non-finite metrics {metrics}")
        if counts != {"instance_norm_fwd": 4 * fwd}:
            fail(f"flagship {mode}: launches {counts}, expected "
                 f"{{'instance_norm_fwd': {4 * fwd}}}")
        fps = port_test.run(parse_config(args + ["--cal_fps"]))["fps"]
        print(f"  --cal_fps: {fps:.2f} img/s (300 images, batch {B}, loader "
              f"included, synchronized per batch)")
        engine = res["engine"]
        del res
    batch = next(iter(port_test.build_val_loader(
        parse_config(_flagship_args(workdir)), engine.device)))

    def forward(depth_only=False):
        return engine.forward_test(rgb=batch["rgb"],
                                   raw_depth=batch["raw_depth"],
                                   depth_only=depth_only)

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        got = forward()
        short = forward(depth_only=True)
        with mock.patch.object(norm_kernel, "instance_norm_fwd",
                               norm_kernel.instance_norm_fwd_plain):
            want = forward()
    torch.cuda.synchronize()
    shapes = {k: tuple(v.shape) for k, v in got.items()}
    print(f"  outputs {shapes}; depth_only gives {sorted(short)}")
    if shapes != {"pred_depth": (B, 1, H, W), "pred_normal": (B, 3, H, W),
                  "pred_label": (B, 14, H, W)} or "pred_label" in short:
        fail(f"flagship outputs {shapes}, depth_only {sorted(short)}")
    norm = got["pred_normal"].norm(dim=1)
    if not (torch.isfinite(got["pred_label"]).all()
            and float((norm - 1).abs().max()) < 1e-3
            and float(got["pred_depth"].abs().max()) <= 1.0):
        fail("flagship outputs: non-finite labels, normals off the unit "
             "sphere or pred_depth outside [-1, 1]")
    compare("flagship pred_depth, depth_only vs full", short["pred_depth"],
            got["pred_depth"], 0.0, 0.0)
    for k in ("pred_depth", "pred_normal"):
        compare(f"flagship {k}, IN kernels vs plain IN (deterministic "
                f"cuDNN)", got[k], want[k], SERVE_RTOL, SERVE_ATOL)
    return counts, engine, batch


def flagship_train_phase(workdir):
    """Train the flagship one epoch at full width through
    rdfc_gan_torch.train.run at the config's bf16 compute type, from six
    nets seeded as the train entry point seeds them, counting launches; check
    the losses, the counts, that all six nets moved and that
    rdfc_gan_torch.test serves best.pth to the epoch's metrics. Returns
    (launch counts, engine, a batch, the seeded checkpoint)."""
    import numpy as np
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.utils import set_random_seed
    from rdfc_gan_torch.utils.checkpoint import save_checkpoint

    common = ["--work_dir", os.path.join(workdir, "flagship_train"),
              "--n_epochs", "1", "--log_interval", "4", "--save_interval",
              "1", "--val_interval", "1", "--start_eval_epoch", "0"]
    cfg = parse_config(_flagship_args(workdir, common))
    set_random_seed(cfg.seed)
    seeded = build_engine(cfg, is_train=True, steps_per_epoch=16)
    pth = os.path.join(workdir, "flagship_seeded.pth")
    save_checkpoint(seeded.modules, pth)
    del seeded
    cfg = parse_config(_flagship_args(workdir, common + ["--load_from",
                                                         pth]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = port_train.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    engine, steps = res["engine"], res["steps"]
    evals = engine.n_forward
    blocks = fused_blocks(engine.modules["G_A2B"])
    n_in = sum(1 for m in engine.modules["G_B2A"].modules()
               if type(m).__name__ == "InstanceNorm")
    # G_A2B runs twice a step (real_A and fake_A): 4 W-AdaIN each; G_B2A
    # once on the batch of 8; the evaluation's forwards 4 W-AdaIN each
    want = {"conv3x3_fwd": 2 * 2 * blocks * steps,
            "conv3x3_bwd": 2 * 2 * blocks * steps,
            "instance_norm_fwd": (2 * 4 + n_in) * steps + 4 * evals,
            "instance_norm_bwd": (2 * 4 + n_in) * steps}
    sec = np.asarray(res["step_seconds"][1:]) * 1e3
    print(f"flagship train: rdf_cycle_patchgan_config.yaml at {H}x{W}, "
          f"batch {B}, {steps} steps + {evals} eval forwards, compute "
          f"dtype {engine.compute_dtype}, {blocks} fused blocks in G_A2B, "
          f"{n_in} IN in G_B2A, wall {wall:.2f} s")
    print("  last losses: " + ", ".join(
        f"{k}={v:.6g}" for k, v in sorted(res["losses"].items())))
    print(f"  step ms (host clock, each ending in its loss readback at the "
          f"log boundaries; first step left out): median "
          f"{np.median(sec):.3f}, p90 {np.percentile(sec, 90):.3f}, max "
          f"{sec.max():.3f}; {B / (np.median(sec) / 1e3):.2f} img/s "
          f"trained; peak device memory {peak / 2**20:.1f} MiB")
    print(f"  kernel launches {counts}; expected {want}")
    print("  metrics after the epoch: " + ", ".join(
        f"{k}={v:.6g}" for k, v in res["metrics"].items()))
    if len(res["losses"]) != 23 or not all(
            np.isfinite(v) for v in res["losses"].values()):
        fail(f"flagship losses {res['losses']}")
    _no_f32_conv(counts, "the flagship bf16 epoch")
    if counts != want:
        fail(f"flagship launch counts {counts} are not {want}")
    before = torch.load(pth, map_location="cpu", weights_only=True)
    for net, mod in engine.modules.items():
        sd = mod.state_dict()
        moved = sum(int(not torch.equal(sd[k].cpu(), v))
                    for k, v in before[f"{net}_state_dict"].items()
                    if "running" not in k and "num_batches" not in k)
        print(f"  {net}: {moved} parameter tensors changed")
        if moved == 0:
            fail(f"{net}'s parameters did not change")
    best = os.path.join(cfg.work_dir, "best.pth")
    served = port_test.run(parse_config(_flagship_args(
        workdir, ["--load_from", best])))["metrics"]
    for k, v in served.items():
        if not np.isclose(v, res["metrics"][k], rtol=SERVE_RTOL,
                          atol=SERVE_ATOL):
            fail(f"rdfc_gan_torch.test on the flagship's best.pth: {k}={v}, "
                 f"the epoch's evaluation {res['metrics'][k]}")
    print(f"  rdfc_gan_torch.test serves best.pth to the same metrics (rtol "
          f"{SERVE_RTOL:g})")
    batch = next(iter(port_train.build_train_loader(cfg, engine.device)))
    return counts, engine, batch, pth


# the flagship's kernel step against its plain step: each gradient tensor
# within twice what summing the fused blocks' convolutions another way
# (torch's convolution and BatchNorm), or running the plain step again,
# moves it
FLAGSHIP_STEP_FACTOR = 2.0


def flagship_step_compare_phase(workdir, pth):
    """One f32 flagship step with deterministic cuDNN from the seeded six
    nets (the same draws), through the kernels, through their plain
    versions, twice more the plain way (run to run), and as a control with
    the identity blocks on torch's convolution and BatchNorm (the fused
    convolutions summed in another order). Each gradient of the kernel
    step must equal the plain step's or lie within FLAGSHIP_STEP_FACTOR
    times the larger of the control's and the run-to-run difference; so
    must each loss."""
    import torch

    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.models.resnet import BasicBlock
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.train import build_train_loader
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    cfg = parse_config(_flagship_args(workdir, ["--load_from", pth]))
    cfg["compute_dtype"] = "float32"
    batch = next(iter(build_train_loader(cfg, torch.device(cfg.device))))
    plain = plain_in_and_conv()
    paths = {"kernels": {}, "plain": plain, "plain again": plain,
             "control": {**plain, (BasicBlock, "fused"):
                         lambda self: False}}
    out, launches, draws = {}, {}, None
    for path, patches in paths.items():
        engine = build_engine(cfg, is_train=True, steps_per_epoch=16)
        load_checkpoint(engine.modules, pth)
        if draws is None:
            draws = engine.draws(0, batch)
        build.reset_launches()
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False))
            for (mod, name), fn in patches.items():
                stack.enter_context(mock.patch.object(mod, name, fn))
            t0 = time.perf_counter()
            losses = engine.train_step(batch, draws=draws)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        grads = {f"{net}.{n}": p.grad.detach().clone()
                 for net, m in engine.modules.items()
                 for n, p in m.named_parameters() if p.grad is not None}
        out[path] = (losses, grads)
        launches[path] = dict(build.LAUNCHES)
        print(f"  flagship f32 step, {path}: {sec:.2f} s, launches "
              f"{launches[path]}")
        del engine
    if launches["plain"] or launches["control"] or not launches["kernels"]:
        fail("a plain flagship step launched a kernel, or the kernel step "
             "none")
    (lk, gk), (lp, gp), (lc, gc), (la, ga) = (
        out[k] for k in ("kernels", "plain", "control", "plain again"))
    if set(gk) != set(gp) or set(lk) != set(lp):
        fail("the flagship steps differ in their losses or gradients")
    exact = sum(int(torch.equal(gk[k], gp[k])) for k in gp)
    print(f"flagship kernels vs plain, one f32 step (deterministic cuDNN): "
          f"{exact} of {len(gp)} gradients and "
          f"{sum(int(torch.equal(lk[k], lp[k])) for k in lp)} of {len(lp)} "
          f"losses bit-equal")
    _step_diff("flagship kernels vs plain", out["kernels"], out["plain"])
    _step_diff("flagship plain again vs plain (run to run)",
               out["plain again"], out["plain"])
    _step_diff("flagship control vs plain", out["control"], out["plain"])
    _hold_to_control("flagship step", out)


def _resumed_step(cfg, path, batch, steps_per_epoch: int = 2):
    """A train engine seeded as the train entry point seeds it, resumed
    from ``path`` (either format; epoch 1 of ``steps_per_epoch`` steps),
    then one step on ``batch`` with deterministic cuDNN. Returns (losses,
    the nets' state dicts, launch counts, the engine)."""
    import torch

    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.utils import set_random_seed
    from rdfc_gan_torch.utils.checkpoint import resume_from

    set_random_seed(cfg.seed)
    engine = build_engine(cfg, is_train=True,
                          steps_per_epoch=steps_per_epoch)
    epoch = resume_from(engine, path)
    if epoch != 1 or engine.n_step != steps_per_epoch:
        fail(f"resume from {os.path.basename(path)}: epoch {epoch}, step "
             f"{engine.n_step}, expected 1 and {steps_per_epoch}")
    build.reset_launches()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        losses = engine.train_step(batch)
        _sync(cfg.device)
    counts = dict(build.LAUNCHES)
    state = {f"{net}.{k}": v.detach().clone()
             for net, m in engine.modules.items()
             for k, v in m.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    return losses, state, counts, engine


def jax_ckpt_phase(workdir, device="cuda", flagship=None, nlspn=None,
                   size=(H, W)):
    """The JAX drivers' .ckpt on the card, written by the port (the smoke
    imports no JAX). The seeded flagship takes 2 bf16 steps; the same
    state goes to x.ckpt (save_jax_checkpoint) and x.pth;
    rdfc_gan_torch.test serves each (4 IN launches a forward) to the same
    metrics and bit-equal outputs; a resume from each takes one step under
    deterministic cuDNN to bit-equal losses and nets (the launch counts of
    one flagship step); the NLSPN config is served from a .ckpt (#1 and #3
    once a forward) to the outputs of the generator that wrote it. Prints
    the file's size and its write and read seconds. ``flagship``,
    ``nlspn`` and ``size`` default to the two published configs at
    224x304; off the card the launch counts are not checked."""
    import shutil

    import numpy as np
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.ops.nlspn_guard import escalate_nlspn_cfg
    from rdfc_gan_torch.train import build_train_loader
    from rdfc_gan_torch.utils import jax_checkpoint, set_random_seed
    from rdfc_gan_torch.utils.checkpoint import (save_checkpoint,
                                                 save_jax_checkpoint)

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    flagship = flagship or os.path.join(ROOT, "configs",
                                        "rdf_cycle_patchgan_config.yaml")
    nlspn = nlspn or os.path.join(ROOT, "configs",
                                  "rdf_gan_nlspn_config.yaml")
    tmp = tempfile.mkdtemp(prefix="jax_ckpt-", dir=workdir)

    def args(config, work, extra=()):
        return ["--dataset", "synthetic", "--model_cfg_path", config,
                "--work_dir", os.path.join(tmp, work), "--batch_size",
                str(B), "--out_height", str(size[0]), "--out_width",
                str(size[1]), "--device", device, *extra]

    def counted(want, got, title):
        if on_card and got != want:
            fail(f"{title}: launches {got}, expected {want}")

    cfg = parse_config(args(flagship, "flagship"))
    set_random_seed(cfg.seed)
    engine = build_engine(cfg, is_train=True, steps_per_epoch=2)
    loader = build_train_loader(cfg, engine.device)
    batches = []
    for batch in loader:
        batches.append(batch)
        if len(batches) == 3:
            break
    loader.close()
    for batch in batches[:2]:
        engine.train_step(batch)
    _sync(device)
    dtype = str(engine.compute_dtype or torch.float32).replace("torch.", "")
    ckpt, pth = os.path.join(tmp, "x.ckpt"), os.path.join(tmp, "x.pth")
    t0 = time.perf_counter()
    save_jax_checkpoint(engine, ckpt, meta=dict(epoch=1))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_checkpoint(engine.modules, pth, meta=dict(epoch=1),
                    train_state=engine.train_state())
    t_pth = time.perf_counter() - t0
    del engine
    t0 = time.perf_counter()
    tree, meta = jax_checkpoint.read_state(ckpt)
    t_read = time.perf_counter() - t0
    n_leaves = len(_flat_leaves(tree))
    del tree
    n_bytes = os.path.getsize(ckpt)
    print(f"jax .ckpt: {os.path.basename(flagship)} after 2 {dtype} steps at "
          f"{size[0]}x{size[1]}, batch {B}: {n_bytes} bytes "
          f"({n_bytes / 2**30:.3f} GiB, {n_leaves} leaves); "
          f"save_jax_checkpoint {t_write:.2f} s, read_state {t_read:.2f} s; "
          f"the .pth of the same state {os.path.getsize(pth)} bytes, "
          f"torch.save {t_pth:.2f} s"
          + (f"; {gpu_line()}" if on_card else ""))
    if meta != {"epoch": 1}:
        fail(f"the .ckpt's meta {meta}")

    served = {}
    for path in (ckpt, pth):
        _sync(device)
        build.reset_launches()
        res = port_test.run(parse_config(args(
            flagship, "serve", ["--load_from", path])))
        _sync(device)
        counts, fwd = dict(build.LAUNCHES), res["forwards"]
        counted({"instance_norm_fwd": 4 * fwd}, counts,
                f"flagship served from {os.path.basename(path)}")
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            out = res["engine"].forward_test(
                rgb=batches[2]["rgb"], raw_depth=batches[2]["raw_depth"])
        served[path] = (res["metrics"], out, counts)
        del res
    (m_c, o_c, n_c), (m_p, o_p, _) = served[ckpt], served[pth]
    if m_c != m_p or not all(np.isfinite(v) for v in m_c.values()):
        fail(f"flagship metrics from the .ckpt {m_c}, from the .pth {m_p}")
    for k in o_p:
        if not torch.equal(o_c[k], o_p[k]):
            fail(f"flagship {k} served from the .ckpt differs from the .pth")
    print("  served from x.ckpt and x.pth: the same metrics ("
          + ", ".join(f"{k}={v:.6g}" for k, v in m_c.items())
          + f") and bit-equal {sorted(o_p)} (deterministic cuDNN); "
          f"launches {n_c}")
    del served, o_c, o_p

    t0 = time.perf_counter()
    l_c, s_c, n_c, engine = _resumed_step(cfg, ckpt, batches[2])
    t_resume = time.perf_counter() - t0
    blocks = fused_blocks(engine.modules["G_A2B"])
    n_in = sum(1 for m in engine.modules["G_B2A"].modules()
               if type(m).__name__ == "InstanceNorm")
    del engine
    l_p, s_p, n_p, engine = _resumed_step(cfg, pth, batches[2])
    del engine
    want = {"conv3x3_fwd": 2 * 2 * blocks, "conv3x3_bwd": 2 * 2 * blocks,
            "instance_norm_fwd": 2 * 4 + n_in,
            "instance_norm_bwd": 2 * 4 + n_in}
    for path, counts in ((ckpt, n_c), (pth, n_p)):
        counted(want, counts,
                f"the step resumed from {os.path.basename(path)}")
    bad = [k for k in l_p if not torch.equal(l_c[k], l_p[k])]
    bad += [k for k in s_p if not torch.equal(s_c[k], s_p[k])]
    if set(l_c) != set(l_p) or set(s_c) != set(s_p) or bad:
        fail(f"the steps resumed from the .ckpt and the .pth differ: "
             f"{len(bad)} tensors, first {bad[:8]}")
    print(f"  resumed from x.ckpt (resume and step {t_resume:.2f} s) and "
          f"from x.pth, one {dtype} step each (deterministic cuDNN): "
          f"{len(l_p)} losses and {len(s_p)} net tensors bit-equal; "
          f"launches {n_c}")
    del s_c, s_p, batches

    n_args = args(nlspn, "nlspn")
    ncfg = parse_config(n_args)
    first = next(iter(port_test.build_val_loader(ncfg,
                                                 torch.device(device))))
    set_random_seed(ncfg.seed)
    nengine = build_engine(ncfg, is_train=True, steps_per_epoch=2)
    g = _seeded_generator(ncfg, device, first, train=True)
    nengine.modules["G"].load_state_dict(g.state_dict())
    nckpt = os.path.join(tmp, "nlspn.ckpt")
    save_jax_checkpoint(nengine, nckpt, meta=dict(epoch=0))
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        want_out = g.eval()(first["rgb"], first["raw_depth"])
    del nengine, g
    build.reset_launches()
    res = port_test.run(parse_config(n_args + ["--load_from", nckpt]))
    counts, fwd = dict(build.LAUNCHES), res["forwards"]
    want, impl = _served_nlspn_counts(ncfg.model.G.to_dict(),
                                      res["max_offset"], fwd)
    print(f"  NLSPN served from a .ckpt ({os.path.getsize(nckpt)} bytes): "
          + ", ".join(f"{k}={v:.6g}" for k, v in res["metrics"].items())
          + f"; max offset {res['max_offset']:.4f}, forwards {fwd}, impl "
          f"{impl!r}, launches {counts}")
    counted(want, counts, "NLSPN served from a .ckpt")
    if not all(np.isfinite(v) for v in res["metrics"].values()):
        fail(f"NLSPN served from a .ckpt: metrics {res['metrics']}")
    _, escalated = escalate_nlspn_cfg(ncfg.model.G.to_dict(),
                                      res["max_offset"])
    if not escalated:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            got = res["engine"].forward_test(rgb=first["rgb"],
                                             raw_depth=first["raw_depth"])
        for k in ("depth_map_1", "depth_map_2", "pred_depth"):
            if not torch.equal(got[k], want_out[k]):
                fail(f"NLSPN {k} from the .ckpt differs from the generator "
                     f"that wrote it")
        print("  its outputs bit-equal to the generator that wrote it")
    del res
    shutil.rmtree(tmp)
    print(f"  jax_ckpt_phase {time.perf_counter() - t_phase:.1f} s")


def _bf16_ulp(v) -> float:
    """One bf16 ulp at the largest magnitude in v."""
    import math

    m = float(v.abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _hold_to_control(title, out, bf16_floor=False):
    """Each loss and gradient of the kernel step must equal the plain
    step's or lie within FLAGSHIP_STEP_FACTOR times the larger of the
    control's and the run-to-run difference from it. With bf16_floor (a
    bf16 step, whose values are rounded to bf16 on the way) that
    difference is taken as at least one bf16 ulp of the plain value's
    largest entry: a control that lands on the same bf16 rounding by
    chance shows 0, which no other summation order could be held to."""
    (lk, gk), (lp, gp), (lc, gc), (la, ga) = (
        out[k] for k in ("kernels", "plain", "control", "plain again"))
    worst = []
    for tag, a, c, r, d in (("loss", lk, lc, la, lp),
                            ("grad", gk, gc, ga, gp)):
        for k in d:
            dk = float((a[k] - d[k]).abs().max())
            dc = max(float((c[k] - d[k]).abs().max()),
                     float((r[k] - d[k]).abs().max()),
                     _bf16_ulp(d[k]) if bf16_floor else 0.0)
            worst.append((dk / dc if dc else (0.0 if dk == 0 else
                                              float("inf")), tag, k, dk, dc))
    worst.sort(reverse=True)
    print(f"  {title}: largest kernel/control ratios: " + "; ".join(
        f"{t} {k}: {dk:.3e} / {dc:.3e}" for _, t, k, dk, dc in worst[:4]))
    if worst[0][0] > FLAGSHIP_STEP_FACTOR:
        fail(f"{title}: {worst[0][1]} {worst[0][2]} moved {worst[0][3]:.3e} "
             f"from the plain step, more than {FLAGSHIP_STEP_FACTOR} times "
             f"the control's {worst[0][4]:.3e}")


def _device_ms(fn, n: int = 2) -> float:
    """Device time (ms) of the kernels ``fn`` launches, per call, from the
    profiler over ``n`` calls after one warm-up: idle gaps left out.

    A profiler session can come back with no device events at all; it is
    then tried again, and after three empty sessions the time is taken
    with CUDA events over ``n`` calls instead (launch gaps included, so
    at least the device time), with a line that says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    print(f"  (the profiler saw no device time in three sessions: "
          f"{ms:.4f} ms from CUDA events, launch gaps included)")
    return ms


def _pct(part: float, whole: float) -> str:
    """``part`` as a share of ``whole``, or "not measured" where ``whole``
    is not a positive time."""
    return f"{100 * part / whole:.1f}%" if whole > 0 else "not measured"


def flagship_breakdown_phase(engine, batch):
    """Device time of one served forward, of each net, and of each kind of
    layer in it: every Conv2d / ConvTranspose2d / SqueezeExcite is replayed
    on the inputs it saw in one forward, under the profiler."""
    import torch
    import torch.nn as nn

    from rdfc_gan_torch.losses import norm_normalize
    from rdfc_gan_torch.models.normal_net import SqueezeExcite

    rgb, raw = batch["rgb"], batch["raw_depth"]
    nets = engine.modules
    with torch.inference_mode():
        normal = norm_normalize(nets["G_normal"](rgb))
        total = _device_ms(lambda: engine.forward_test(rgb=rgb,
                                                       raw_depth=raw))
        per_net = {"G_label": _device_ms(lambda: nets["G_label"](rgb)),
                   "G_normal": _device_ms(lambda: nets["G_normal"](rgb)),
                   "G_A2B": _device_ms(lambda: nets["G_A2B"](rgb, raw,
                                                              normal))}
        kinds = collections.defaultdict(list)
        in_se = {id(c) for m in nets.values()
                 for s in m.modules() if isinstance(s, SqueezeExcite)
                 for c in s.modules() if c is not s}
        hooks = []
        for net_name, net in nets.items():
            for m in net.modules():
                if isinstance(m, SqueezeExcite):
                    kind = "NNET squeeze-excite"
                elif id(m) in in_se:
                    continue
                elif isinstance(m, nn.ConvTranspose2d):
                    kind = "transposed conv"
                elif isinstance(m, nn.Conv2d):
                    kind = ("NNET depthwise conv" if m.groups > 1 else
                            f"{net_name} conv")
                else:
                    continue
                hooks.append(m.register_forward_hook(
                    lambda mod, a, o, k=kind: kinds[k].append((mod, a))))
        engine.forward_test(rgb=rgb, raw_depth=raw)
        for h in hooks:
            h.remove()
        kind_ms = {k: _device_ms(lambda c=c: [m(*a) for m, a in c])
                   for k, c in kinds.items()}
    print(f"flagship forward, device time (profiler, idle gaps left out, "
          f"f32): {total:.3f} ms; by net: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in per_net.items()))
    for k, v in sorted(kind_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {k}: {v:.3f} ms over {len(kinds[k])} calls "
              f"({_pct(v, total)} of the forward's device time)")



# the NYUv2-1400 fixture of the file-dataset phase: scenes a split, at the
# corpus's 480x640
FILE_TRAIN, FILE_TEST = 16, 8


def _plain_png_check(path):
    """(path, the plain unfilter's decode equals the native one's); run in
    a worker process."""
    import numpy as np

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from rdfc_gan_torch.data import image_io

    a = image_io.imread(path)
    b = image_io.imread(path, plain=True)
    return path, bool(a.dtype == b.dtype and np.array_equal(a, b))


def _flat_leaves(obj, path=""):
    """{path: leaf} of a loaded checkpoint (dicts, lists, tuples walked)."""
    if isinstance(obj, (dict, list, tuple)):
        items = obj.items() if isinstance(obj, dict) else enumerate(obj)
        out = {}
        for k, v in items:
            out.update(_flat_leaves(v, f"{path}/{k}"))
        return out
    return {path: obj}


def _file_fixture(workdir):
    """Write the fixture with the port's generator, read every PNG back
    (native unfilter) against what was written and (in worker processes)
    against the plain unfilter; time a sample's decode. Returns the root."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from rdfc_gan_torch.data import image_io
    from rdfc_gan_torch.data.nyuv2 import NYUV21400Dataset
    from rdfc_gan_torch.tools.make_nyuv2_fixture import write_fixture

    root = os.path.join(workdir, "nyuv2")
    t0 = time.perf_counter()
    written = write_fixture(root, n_train=FILE_TRAIN, n_test=FILE_TEST,
                            seed=0)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rel, arr in written.items():
        got = image_io.imread(os.path.join(root, rel))
        if got.dtype != arr.dtype or not np.array_equal(got, arr):
            fail(f"{rel} does not read back as written")
    t_read = time.perf_counter() - t0
    paths = [os.path.join(root, rel) for rel in written]
    with ProcessPoolExecutor(max_workers=os.cpu_count() or 4,
                             mp_context=mp.get_context("spawn")) as pool:
        bad = [p for p, ok in pool.map(_plain_png_check, paths) if not ok]
    if bad:
        fail(f"plain and native unfilter disagree on {bad[:4]}")
    ds = NYUV21400Dataset(root, mode="train")
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds._load_raw(i)
    decode_ms = (time.perf_counter() - t0) / len(ds) * 1e3
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    sample_ms = (time.perf_counter() - t0) / len(ds) * 1e3
    print(f"file datasets: NYUv2-1400 fixture, {FILE_TRAIN} train + "
          f"{FILE_TEST} test scenes at 480x640, {len(written)} PNGs written "
          f"in {t_write:.2f} s; every PNG read back equal to what was "
          f"written ({t_read / len(written) * 1e3:.2f} ms a PNG), the plain "
          f"unfilter equal to the native one on every file")
    print(f"  host decode per sample (5 PNGs + border cut, one thread): "
          f"{decode_ms:.3f} ms; whole train sample (decode, rotate, resize, "
          f"crop, normalize): {sample_ms:.3f} ms")
    return root


def _check_grids(samples, steps):
    """The sample grids of a run of ``steps`` steps dumped every 4."""
    from rdfc_gan_torch.data import image_io

    shapes = {"A-B": (B * H, 3 * W, 3), "B-A": (B * H, 3 * W, 3),
              "normal": (B * H, 2 * W, 3), "label": (B * H, 2 * W, 3)}
    grids = sorted(os.listdir(samples))
    want = sorted(f"sample-{s}-{it:06d}-{k}.png" for s in ("train", "test")
                  for it in range(4, steps + 1, 4) for k in shapes)
    if grids != want:
        fail(f"sample grids {grids}, expected {want}")
    for name in grids:
        img = image_io.imread(os.path.join(samples, name))
        kind = name.split("-", 3)[3][:-4]
        if img.shape != shapes[kind] or str(img.dtype) != "uint8":
            fail(f"{name}: {img.shape} {img.dtype}")
    print(f"  sample grids: {len(grids)} PNGs (every 4 steps, the fixed "
          f"train and test batches), shapes {shapes}")


def file_dataset_phase(workdir):
    """The flagship's data-to-checkpoint loop on NYUv2-layout files: the
    fixture (``_file_fixture``); the flagship trained (bf16, batch 4,
    deterministic cuDNN algorithms, so that the step is deterministic) 2
    epochs straight, and 1 epoch, then
    --resume_from epoch_1.pth and the second epoch with the process loader,
    the two epoch_2.pth bit-equal entry by entry; the sample grids; the
    test split served from epoch_2.pth (the flagship) and with a seeded
    NLSPN generator, counting launches; single-image inference; the step
    times, the loader's wait and peak memory."""
    import numpy as np
    import torch

    from rdfc_gan_torch import inference
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.data import image_io
    from rdfc_gan_torch.ops.kernels import build

    t_phase = time.perf_counter()
    print(gpu_line())
    reflect_pad_cost(workdir)
    root = _file_fixture(workdir)
    flagship = os.path.join(ROOT, "configs", "rdf_cycle_patchgan_config.yaml")

    def args(work, config=flagship, extra=()):
        return ["--dataset", "nyuv2", "--data_root", root, "--model_cfg_path",
                config, "--work_dir", os.path.join(workdir, work),
                "--batch_size", str(B), "--num_workers", "4",
                "--device", "cuda", *extra]

    def train(work, n_epochs, extra=()):
        common = ["--n_epochs", str(n_epochs), "--save_interval", "1",
                  "--sample_interval", "4", "--log_interval", "4",
                  "--val_interval", "1000"]
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            return port_train.run(parse_config(args(work, extra=common
                                                    + list(extra))))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = train("file_straight", 2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    engine, steps = res["engine"], res["steps"]
    blocks = fused_blocks(engine.modules["G_A2B"])
    n_in = sum(1 for m in engine.modules["G_B2A"].modules()
               if type(m).__name__ == "InstanceNorm")
    dumps = len(res["samples"])
    # a step as in the flagship train phase; a sample dump is one
    # forward_test (4 W-AdaIN) and two G_B2A applications
    want = {"conv3x3_fwd": 2 * 2 * blocks * steps,
            "conv3x3_bwd": 2 * 2 * blocks * steps,
            "instance_norm_fwd": (2 * 4 + n_in) * steps
            + (4 + 2 * n_in) * dumps,
            "instance_norm_bwd": (2 * 4 + n_in) * steps}
    sec = np.asarray(res["step_seconds"][1:]) * 1e3
    wait = np.asarray(res["wait_seconds"]) * 1e3
    print(f"  flagship train on the files: {steps} steps (2 epochs) at "
          f"{H}x{W}, batch {B}, bf16, deterministic cuDNN, thread loader, "
          f"{dumps} sample dumps, wall {wall:.2f} s incl. build")
    print(f"  step ms (host clock, first step left out, dumps included): "
          f"median {np.median(sec):.3f}, p90 {np.percentile(sec, 90):.3f}, "
          f"max {sec.max():.3f}; loader wait ms a step: mean "
          f"{wait.mean():.3f}, median {np.median(wait):.3f}, max "
          f"{wait.max():.3f}; peak device memory {peak / 2**20:.1f} MiB")
    print(f"  kernel launches {counts}; expected {want}")
    _no_f32_conv(counts, "the flagship epochs on files")
    if counts != want:
        fail(f"file-dataset launch counts {counts} are not {want}")
    if not all(np.isfinite(v) for v in res["losses"].values()):
        fail(f"file-dataset losses {res['losses']}")
    _check_grids(os.path.join(workdir, "file_straight", "samples"), steps)
    del engine, res

    train("file_half", 1)
    resumed = train("file_resumed", 2, [
        "--resume_from", os.path.join(workdir, "file_half", "epoch_1.pth"),
        "--loader_backend", "process"])
    if resumed["start_epoch"] != 1 or resumed["steps"] != steps // 2:
        fail(f"resumed at epoch {resumed['start_epoch']} for "
             f"{resumed['steps']} steps")
    del resumed
    ep2 = os.path.join(workdir, "file_straight", "epoch_2.pth")
    a, b = (_flat_leaves(torch.load(p, map_location="cpu", weights_only=True))
            for p in (ep2, os.path.join(workdir, "file_resumed",
                                        "epoch_2.pth")))
    if set(a) != set(b):
        fail(f"epoch_2.pth entries differ: {sorted(set(a) ^ set(b))[:6]}")
    differ = [k for k, x in a.items() if not (
        torch.equal(x, b[k]) and x.dtype == b[k].dtype
        if isinstance(x, torch.Tensor) else x == b[k])]
    n_tensors = sum(isinstance(x, torch.Tensor) for x in a.values())
    if differ:
        fail(f"resumed epoch_2.pth differs from the straight run's at "
             f"{len(differ)} of {len(a)} entries, e.g. {differ[:4]}")
    print(f"  resume: epoch_2.pth of 1 epoch + --resume_from + 1 epoch "
          f"(process loader) is bit-equal to the straight run's: all "
          f"{n_tensors} tensors (nets, optimizers, schedulers) and "
          f"{len(a) - n_tensors} other entries")

    build.reset_launches()
    served = port_test.run(parse_config(args("file_serve",
                                             extra=["--load_from", ep2])))
    counts = dict(build.LAUNCHES)
    fwd, metrics = served["forwards"], served["metrics"]
    print(f"  flagship served from epoch_2.pth on the {FILE_TEST} test "
          f"scenes: " + ", ".join(f"{k}={v:.6g}" for k, v in metrics.items())
          + f"; forwards {fwd}, launches {counts}")
    if len(metrics) != 8 or not all(np.isfinite(v)
                                    for v in metrics.values()):
        fail(f"served metrics {metrics}")
    if counts != {"instance_norm_fwd": 4 * fwd}:
        fail(f"flagship serve on files: launches {counts}, expected "
             f"{{'instance_norm_fwd': {4 * fwd}}}")
    del served

    nlspn = os.path.join(ROOT, "configs", "rdf_gan_nlspn_config.yaml")
    cfg = parse_config(args("file_nlspn", nlspn))
    first = next(iter(port_test.build_val_loader(cfg, torch.device("cuda"))))
    g = _seeded_generator(cfg, "cuda", first)
    gpth = os.path.join(workdir, "file_G.pth")
    torch.save({"G_state_dict": g.state_dict()}, gpth)
    del g
    build.reset_launches()
    served = port_test.run(parse_config(args("file_nlspn", nlspn,
                                             ["--load_from", gpth])))
    counts = dict(build.LAUNCHES)
    fwd = served["forwards"]
    print(f"  NLSPN served on the test scenes: " + ", ".join(
        f"{k}={v:.6g}" for k, v in served["metrics"].items())
        + f"; max offset {served['max_offset']:.4f}, forwards {fwd}, "
        f"launches {counts}")
    want, impl = _served_nlspn_counts(cfg.model.G.to_dict(),
                                      served["max_offset"], fwd)
    if impl == "gather":
        print(f"    the offset guard fell back to the gather path after the "
              f"probe: {fwd - 1} forwards served without the scatter and "
              f"the chain")
    if counts != want or not all(np.isfinite(v) for v in
                                 served["metrics"].values()):
        fail(f"NLSPN serve on files: launches {counts}, expected {want}")
    del served

    out = os.path.join(workdir, "file_pred.png")
    inf = inference.run(["--model_cfg_path", flagship, "--load_from", ep2,
                         "--rgb", os.path.join(root, "test/rgb/0000.png"),
                         "--depth", os.path.join(root,
                                                 "test/depth_raw/0000.png"),
                         "--out", out])
    pred = image_io.imread(out)
    vis = image_io.imread(inf["vis"])
    if pred.dtype != np.uint16 or pred.shape != (H, W) \
            or vis.shape != (H, W, 3):
        fail(f"inference wrote {pred.dtype}{pred.shape}, vis {vis.shape}")
    print(f"  inference: {os.path.basename(out)} uint16 {pred.shape}, "
          f"range [{int(pred.min())}, {int(pred.max())}] mm; "
          f"{os.path.basename(inf['vis'])} {vis.shape}")
    print(f"  file-dataset phase wall {time.perf_counter() - t_phase:.2f} s")


def reflect_pad_cost(workdir):
    """The cost of the package's reflect pad, whose backward folds the
    border gradients in a fixed order: a bf16 G_B2A (the flagship's)
    forward + backward at the flagship step's shape (2B x 1 x H x W),
    timed with CUDA events beside a copy of the net whose pads call
    ``F.pad(mode="reflect")`` (its CUDA backward adds with atomics); and
    whether two passes of each give bit-equal gradients under
    deterministic cuDNN."""
    import copy

    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    from rdfc_gan_torch import models  # noqa: F401
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.models.resnet_generator import ReflectionPad
    from rdfc_gan_torch.registry import build_generator

    class FPad(nn.Module):
        def __init__(self, pad):
            super().__init__()
            self.pad = pad

        def forward(self, x):
            return F.pad(x, (self.pad,) * 4, mode="reflect")

    cfg = parse_config(_flagship_args(workdir))
    torch.manual_seed(0)
    net = build_generator(cfg.model.G_B2A.to_dict()).cuda().train()
    fpad = copy.deepcopy(net)
    n_pads = 0
    for mod in list(fpad.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, ReflectionPad):
                setattr(mod, name, FPad(child.pad))
                n_pads += 1
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((2 * B, 1, H, W), device="cuda", generator=gen)
    w = torch.randn((2 * B, 3, H, W), device="cuda", generator=gen)

    def step(g):
        g.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = g(x)
        (out.float() * w).sum().backward()

    def grads(g):
        step(g)
        return [p.grad.clone() for p in g.parameters()]

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        same = {}
        for name, g in (("package pad", net), ("F.pad", fpad)):
            a, b = grads(g), grads(g)
            same[name] = sum(int(not torch.equal(u, v))
                             for u, v in zip(a, b))
        # in turns, so that drift of the card's clock falls on both
        t = collections.defaultdict(list)
        for name, g in (("package pad", net), ("F.pad", fpad)) * 2:
            t[name].append(time_ms(lambda g=g: step(g), reps=20))
    n = len(list(net.parameters()))
    print(f"reflect pad: a bf16 G_B2A forward + backward at {2 * B}x1x{H}x"
          f"{W} ({n_pads} pads), CUDA events, 20 passes each, in turns: "
          f"the package's fixed-order pad " + ", ".join(
              f"{v:.3f}" for v in t["package pad"]) + " ms, F.pad "
          + ", ".join(f"{v:.3f}" for v in t["F.pad"]) + " ms; gradients "
          f"differing between two passes (deterministic cuDNN): package pad "
          f"{same['package pad']} of {n}, F.pad {same['F.pad']} of {n}")
    if same["package pad"]:
        fail("two G_B2A backward passes with the package's reflect pad "
             "differ")
    del net, fpad


# the v1 pipelines' planes: nyuv2_s2d's crop and ddrnet_human's frames
S2D_H, S2D_W = 228, 304
DDR_H, DDR_W = 480, 640
S2D_TRAIN, S2D_VAL = 16, 8
# the channels entering G_A2B's four fuse layers (concat skips): W-AdaIN
# normalises the content's, INFuse the content's and the style's
WADAIN_CHANNELS = (512, 768, 384, 192)
INFUSE_CHANNELS = tuple(2 * c for c in WADAIN_CHANNELS)


def _halve(n: int, k: int) -> int:
    """n after k stride-2 convolutions with padding 1 and kernel 3."""
    for _ in range(k):
        n = (n + 1) // 2
    return n


def fuse_in_shapes(h: int, w: int, channels=WADAIN_CHANNELS):
    """The IN planes of G_A2B's four fuse layers at an h x w input, batch
    B: the 1/16 plane, then each decoder's output trimmed to its skip."""
    return tuple((B, c, _halve(h, 4 - i), _halve(w, 4 - i))
                 for i, c in enumerate(channels))


def hold_in_kernels(shapes, title: str):
    """The IN forward and backward kernels against their plain versions
    at ``shapes``, f32 and bf16, bit for bit."""
    import torch

    from rdfc_gan_torch.ops.kernels import norm_kernel as nk

    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = []
    for shape in shapes:
        xf = torch.randn(shape, device="cuda", generator=gen) * 3 + 1.5
        gf = torch.randn(shape, device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            x, dy = xf.to(dt), gf.to(dt)
            tag = f"{title} {tuple(shape)} {dt}"
            y, a = nk.instance_norm_fwd(x, 1e-5)
            dx = nk.instance_norm_bwd(dy, y, a)
            torch.cuda.synchronize()
            py, pa = nk.instance_norm_fwd_plain(x, 1e-5)
            errs += [
                compare(f"instance_norm_fwd y {tag}", y, py, IN_RTOL,
                        IN_ATOL, quiet=True),
                compare(f"instance_norm_fwd a {tag}", a, pa, IN_RTOL,
                        IN_ATOL, quiet=True),
                compare(f"instance_norm_bwd dx {tag}", dx,
                        nk.instance_norm_bwd_plain(dy, y, a), IN_RTOL,
                        IN_ATOL, quiet=True)]
    print(f"  instance norm kernels vs plain, {title}, "
          f"{', '.join('x'.join(map(str, sh)) for sh in shapes)}, f32 and "
          f"bf16: y, a and dx bit for bit ({len(errs)} comparisons, "
          f"max_abs_err {max(errs):.3e})")


def hold_chain_kernels(shape, title: str, train: bool):
    """At a (batch, height, width) plane, R=2 (S=8), T=18: the scatter (#1)
    and the served chain (#3) against their plain versions; with
    ``train`` also the X-storing chain (#4) and the reverse chain (#5),
    f32 and bf16; bit for bit (the scatter to SCATTER_RTOL)."""
    import torch

    from rdfc_gan_torch.ops import nlspn_stencil as st
    from rdfc_gan_torch.ops.kernels import mask_kernel, nlspn_kernel

    gen = torch.Generator(device="cuda").manual_seed(7)
    R = 2
    b, h, w = shape
    offsets, aff, feat, fix = mask_inputs(gen, R, shape)
    a, M = scatter_args(offsets, aff, R)
    S = a["S"]
    got = mask_kernel.scatter_shift_masks(a["w"], a["sy"], a["sx"], S)
    torch.cuda.synchronize()
    tag = f"{title} {b}x{h}x{w}"
    compare(f"shift_mask_scatter {tag} S={S}", got, M.reshape(got.shape),
            SCATTER_RTOL, SCATTER_ATOL)
    M16 = M.reshape(b, S, S, h, w).to(torch.bfloat16)
    got = nlspn_kernel.nlspn_stencil_propagate(feat, M16, fix, T, R, False)
    torch.cuda.synchronize()
    compare(f"nlspn_propagate {tag} T={T}", got, st.stencil_propagate(
        feat, M16, T, R, fix, False), CHAIN_RTOL, CHAIN_ATOL)
    if not train:
        return
    feat0 = feat[:, 0].contiguous()
    g0 = torch.randn((b, h, w), device="cuda", generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        out, X = nlspn_kernel.propagate_x(feat0, M16, None, T, R, dt)
        G, dfeat, dfix = nlspn_kernel.reverse_chain(g0, M16, None, T, R, dt)
        torch.cuda.synchronize()
        pout, pX = st.propagate_x_plain(feat0, M16, None, T, R, dt)
        pG, pdfeat, pdfix = st.reverse_chain_plain(g0, M16, None, T, R, dt)
        errs = [compare(f"nlspn_{what} {tag} {dt}", u, v, CHAIN_RTOL,
                        CHAIN_ATOL, quiet=True)
                for what, u, v in (("propagate_x out", out, pout),
                                   ("propagate_x X", X, pX),
                                   ("reverse_chain G", G, pG),
                                   ("reverse_chain dfeat", dfeat, pdfeat))]
        print(f"  nlspn_propagate_x (out, X) and nlspn_reverse_chain (G, "
              f"dfeat) {tag} T={T} {dt}: bit for bit, max_abs_err "
              f"{max(errs):.3e}")


def _rdfgan_counts(engine, steps: int) -> dict:
    """The kernel launches of ``steps`` RDFGAN train steps and
    ``engine.n_forward`` evaluation forwards (as in ``train_phase``)."""
    evals = engine.n_forward
    blocks = fused_blocks(engine.modules["G"])
    return {"shift_mask_scatter": steps + evals, "shift_mask_gather": steps,
            "nlspn_propagate_x": steps, "nlspn_reverse_chain": steps,
            "shift_correlation": steps, "nlspn_propagate": evals,
            "instance_norm_fwd": 4 * (steps + evals),
            "instance_norm_bwd": 4 * steps,
            "conv3x3_fwd": 2 * blocks * steps,
            "conv3x3_bwd": 2 * blocks * steps}


def _served_nlspn_counts(g_cfg: dict, max_offset: float, forwards: int):
    """The launches ``rdfc_gan_torch.test`` must make serving the NLSPN
    RDF-GAN from a checkpoint: it probes one batch on the loaded G and hands
    the probe's max|offset| to the offset guard. While the guard keeps the
    stencil (its radius raised or not) every forward builds the masks and
    runs the served chain; where the guard falls back to the gather, only
    the probe did. Returns (the counts, the impl the guard chose)."""
    from rdfc_gan_torch.ops.nlspn_guard import escalate_nlspn_cfg

    chosen, _ = escalate_nlspn_cfg(g_cfg, max_offset)
    impl = chosen.get("nlspn_impl", "auto")
    if g_cfg.get("nlspn_impl", "auto") == "gather":
        stencil = 0
    elif impl == "gather":
        stencil = 1
    else:
        stencil = forwards
    want = {"instance_norm_fwd": 4 * forwards}
    if stencil:
        want.update(shift_mask_scatter=stencil, nlspn_propagate=stencil)
    return want, impl


def _train_and_serve(workdir, name, data_args, steps_expected):
    """Train the NLSPN RDF-GAN one epoch with its evaluation through
    ``rdfc_gan_torch.train`` on a file dataset, counting launches from 0,
    then serve its best.pth through ``rdfc_gan_torch.test``, counting
    again. Returns the train result."""
    import numpy as np
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.ops.nlspn_guard import escalate_nlspn_cfg

    nlspn = os.path.join(ROOT, "configs", "rdf_gan_nlspn_config.yaml")

    def args(work, extra):
        return [*data_args, "--model_cfg_path", nlspn, "--work_dir",
                os.path.join(workdir, work), "--batch_size", str(B),
                "--num_workers", "4", "--device", "cuda", *extra]

    cfg = parse_config(args(f"{name}_train", [
        "--n_epochs", "1", "--log_interval", "1", "--save_interval", "1",
        "--val_interval", "1", "--start_eval_epoch", "0"]))
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    res = port_train.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    engine, steps = res["engine"], res["steps"]
    want = _rdfgan_counts(engine, steps)
    sec = np.asarray(res["step_seconds"]) * 1e3
    wait = np.asarray(res["wait_seconds"]) * 1e3
    print(f"  {name} train: {steps} steps + {engine.n_forward} eval "
          f"forwards, batch {B}, {engine.compute_dtype}, wall {wall:.2f} s; "
          f"step ms (host clock) {', '.join(f'{v:.1f}' for v in sec)}, "
          f"median after the first {np.median(sec[1:]):.3f}; "
          f"loader wait ms a step: mean {wait.mean():.3f}, max "
          f"{wait.max():.3f}")
    print("    last losses: " + ", ".join(
        f"{k}={v:.6g}" for k, v in sorted(res["losses"].items())))
    print("    metrics: " + ", ".join(
        f"{k}={v:.6g}" for k, v in res["metrics"].items()))
    print(f"    kernel launches {counts}; expected {want}")
    if steps != steps_expected:
        fail(f"{name}: {steps} steps, expected {steps_expected}")
    if not all(np.isfinite(v) for v in list(res["losses"].values())
               + list(res["metrics"].values())):
        fail(f"{name}: non-finite losses or metrics")
    _no_f32_conv(counts, f"the {name} bf16 epoch")
    if counts != want:
        fail(f"{name} train launch counts {counts} are not {want}")
    del engine

    build.reset_launches()
    served = port_test.run(parse_config(args(f"{name}_serve", [
        "--load_from", os.path.join(workdir, f"{name}_train", "best.pth")])))
    counts = dict(build.LAUNCHES)
    fwd = served["forwards"]
    want, impl = _served_nlspn_counts(cfg.model.G.to_dict(),
                                      served["max_offset"], fwd)
    print(f"  {name} served from best.pth: " + ", ".join(
        f"{k}={v:.6g}" for k, v in served["metrics"].items())
        + f"; max offset {served['max_offset']:.4f}, forwards {fwd}, "
        f"impl after the guard {impl!r}, launches {counts}")
    _, escalated = escalate_nlspn_cfg(cfg.model.G.to_dict(),
                                      served["max_offset"])
    if impl == "gather":
        print(f"    the offset guard fell back to the gather path after the "
              f"probe (max|offset| {served['max_offset']:.3f} needs a "
              f"radius beyond the stencil's): {fwd - 1} forwards served "
              f"without the scatter and the chain")
    if counts != want:
        fail(f"{name} serve: launches {counts}, expected {want}")
    if escalated:
        # the guard rebuilt G (a larger stencil radius or the gather), so
        # the metrics differ from the epoch's by design
        print(f"    the offset guard rebuilt G (max|offset| "
              f"{served['max_offset']:.3f}): metrics not compared")
        return res
    for k, v in served["metrics"].items():
        if not np.isclose(v, res["metrics"][k], rtol=SERVE_RTOL,
                          atol=SERVE_ATOL):
            fail(f"{name} serve: {k}={v}, the epoch's evaluation "
                 f"{res['metrics'][k]}")
    print(f"    the same metrics as the epoch's evaluation (rtol "
          f"{SERVE_RTOL:g})")
    return res


def s2d_phase(workdir):
    """nyuv2_s2d, v1's default corpus, end to end: the fixture (16 train
    and 8 val HDF5 frames written by the port's writer: seeded scenes,
    480x640) read back through the port's reader; the chain kernels, the
    scatter and the IN kernels held against their plain versions at
    228x304 (planes 114, 57, 29 and 15 rows in the nets); the NLSPN RDF-GAN
    trained one epoch (4 bf16 steps at batch 4) with its evaluation
    through ``python -m rdfc_gan_torch.train --dataset nyuv2_s2d``, and its
    best.pth served through ``rdfc_gan_torch.test``, launches counted from
    0 before each. Returns the data root."""
    import numpy as np

    from rdfc_gan_torch.data import hdf5
    from rdfc_gan_torch.data.nyuv2_s2d import NYUV2S2DDataset
    from rdfc_gan_torch.tools.make_s2d_fixture import write_fixture

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "s2d")
    t0 = time.perf_counter()
    written = write_fixture(root, n_train=S2D_TRAIN, n_val=S2D_VAL, seed=0)
    t_write = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(os.path.join(root, fn)) for fn in written)
    for fn, arrays in written.items():
        with hdf5.File(os.path.join(root, fn)) as f:
            for k, a in arrays.items():
                got = f[k][:]
                if got.dtype != a.dtype or not np.array_equal(got, a):
                    fail(f"{fn}/{k} does not read back as written")
    ds = NYUV2S2DDataset(root, mode="train")
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds._load(i)
    decode_ms = (time.perf_counter() - t0) / len(ds) * 1e3
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    sample_ms = (time.perf_counter() - t0) / len(ds) * 1e3
    print(f"nyuv2_s2d: {S2D_TRAIN} train + {S2D_VAL} val HDF5 frames "
          f"(3x480x640 uint8 rgb, 480x640 f32 depth), "
          f"{n_bytes / 1e6:.1f} MB, written in {t_write:.2f} s, every "
          f"dataset read back equal")
    print(f"  host decode per frame (the port's HDF5 reader, one thread): "
          f"{decode_ms:.3f} ms; whole train sample (decode, flip, rotate, "
          f"rescale, jitter, crop, 500-point sampler): {sample_ms:.3f} ms")
    hold_chain_kernels((B, S2D_H, S2D_W), "s2d", train=True)
    hold_in_kernels(fuse_in_shapes(S2D_H, S2D_W), "W-AdaIN s2d")
    _train_and_serve(workdir, "s2d", ["--dataset", "nyuv2_s2d",
                                      "--data_root", root],
                     S2D_TRAIN // B)
    print(f"  nyuv2_s2d phase wall {time.perf_counter() - t_phase:.2f} s")
    return root


def _ddrnet_fixture(root: str, n: int):
    """n DDRNet-layout frames (480x640 seeded scenes: rgb, raw and gt
    depth in mm, a human mask) under root/frames, indexed by the port's
    create_ddrnet_csv into train.csv and val.csv."""
    import numpy as np

    from rdfc_gan_torch.data import image_io
    from rdfc_gan_torch.tools.create_ddrnet_csv import write_index
    from rdfc_gan_torch.tools.make_nyuv2_fixture import _scene

    rng = np.random.RandomState(5)
    frames = os.path.join(root, "frames")
    for i in range(n):
        rgb, depth_mm, raw_mm, _, labels = _scene(rng)
        mask = np.where(labels % 3 == 0, 255, 0).astype(np.uint8)
        for sub, arr in (("color_map", rgb[..., ::-1]),
                         ("depth_map", raw_mm), ("high_quality_depth",
                                                 depth_mm),
                         ("mask", mask)):
            os.makedirs(os.path.join(frames, sub), exist_ok=True)
            image_io.imwrite(os.path.join(frames, sub, f"{i:04d}.png"), arr)
    for split in ("train", "val"):
        write_index(frames, os.path.join(root, f"{split}.csv"))
    return root


def _folder_fixture(root: str, n_train: int, n_val: int):
    """cleargrasp-layout PNGs (tests/test_real_datasets.py:261-270's
    shapes: 100x120 8-bit rgb, mm depth), no depth_raw: the train split's
    raw depth is the ellipse dropout's."""
    import numpy as np

    from rdfc_gan_torch.data import image_io

    rng = np.random.RandomState(4)
    for split, n in (("train", n_train), ("val", n_val)):
        for sub in ("rgb", "depth"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for i in range(n):
            image_io.imwrite(os.path.join(root, split, "rgb", f"{i}.png"),
                             rng.randint(0, 255, (100, 120, 3)).astype(
                                 np.uint8))
            image_io.imwrite(os.path.join(root, split, "depth", f"{i}.png"),
                             rng.randint(500, 9000, (100, 120)).astype(
                                 np.uint16))
    return root


def v1_variants_phase(workdir, s2d_root):
    """The other v1 datasets and the G_A2B variants: ddrnet_human,
    nyuv2_r2r (on the s2d frames) and cleargrasp fixtures written with the
    port's PNG and HDF5 writers, a batch of each through the port's
    loader; the NLSPN RDF-GAN serving one ddrnet_human batch at 4x480x640
    (launches counted), with the scatter, the served chain and the IN
    forward held against their plain versions at that plane; cleargrasp
    trained 4 steps at 256x256 and served; then the flagship's G_A2B built
    with ``fuse_depth_in_rgb_decoder: IN``, ``AdaIN`` and with ``add``
    skips, each serving one bf16 batch at 224x304 with its IN launches
    counted from 0 and held to what the build should launch, INFuse's IN
    planes (2C channels) held against the plain versions, and the IN build
    taking one train step."""
    import numpy as np
    import torch

    from rdfc_gan_torch import models  # noqa: F401
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.data import DataLoader
    from rdfc_gan_torch.data.ddrnet_human import DDRNetHumanDataset
    from rdfc_gan_torch.data.folder_dataset import FolderDepthDataset
    from rdfc_gan_torch.data.nyuv2_r2r import NYUV2R2RDataset
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.metrics import compute_depth_metrics
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.registry import build_generator

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    ddr = _ddrnet_fixture(os.path.join(workdir, "ddrnet"), B)
    cg = _folder_fixture(os.path.join(workdir, "cleargrasp"), 4 * B, B)
    batches = {}
    for name, ds, shape in (
            ("ddrnet_human train", DDRNetHumanDataset(ddr, mode="train",
                                                      times=2),
             (DDR_H, DDR_W)),
            ("ddrnet_human val", DDRNetHumanDataset(ddr, mode="val"),
             (DDR_H, DDR_W)),
            ("nyuv2_r2r train", NYUV2R2RDataset(s2d_root, mode="train"),
             (256, 320)),
            ("cleargrasp train", FolderDepthDataset(cg, mode="train"),
             (256, 256))):
        loader = DataLoader(ds, B, device=dev, num_workers=4, shuffle=True)
        t0 = time.perf_counter()
        batch = next(iter(loader))
        ms = (time.perf_counter() - t0) * 1e3
        keys = {k: tuple(v.shape) for k, v in batch.items()}
        print(f"{name}: a batch of {B} through the loader in {ms:.1f} ms: "
              f"{keys}")
        if keys["rgb"] != (B, 3) + shape or not all(
                torch.isfinite(v.float()).all() for v in batch.values()):
            fail(f"{name}: batch {keys}")
        batches[name] = batch

    hold_chain_kernels((B, DDR_H, DDR_W), "ddrnet", train=False)
    hold_in_kernels(fuse_in_shapes(DDR_H, DDR_W), "W-AdaIN ddrnet")
    nlspn = os.path.join(ROOT, "configs", "rdf_gan_nlspn_config.yaml")
    cfg = parse_config(["--dataset", "synthetic", "--model_cfg_path", nlspn,
                        "--work_dir", os.path.join(workdir, "ddr_serve"),
                        "--out_height", str(DDR_H), "--out_width",
                        str(DDR_W), "--device", "cuda"])
    batch = batches["ddrnet_human val"]
    engine = build_engine(cfg, is_train=False)
    engine.modules["G"].load_state_dict(
        _seeded_generator(cfg, "cuda", batch).state_dict())
    torch.cuda.synchronize()
    build.reset_launches()
    with torch.no_grad():
        pred = engine.forward_test(rgb=batch["rgb"],
                                   raw_depth=batch["raw_depth"])["pred_depth"]
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    m = compute_depth_metrics(batch["gt_depth"][:, 0] * 1.5 + 1.5,
                              pred[:, 0].float() * 1.5 + 1.5,
                              batch["evaluate_mask"]).mean(0)
    want = {"shift_mask_scatter": 1, "nlspn_propagate": 1,
            "instance_norm_fwd": 4}
    print(f"ddrnet_human served by the NLSPN RDF-GAN at {B}x{DDR_H}x{DDR_W}:"
          f" RMSE {float(m[0]):.4f} m over the human mask, launches "
          f"{counts}; expected {want}")
    if counts != want or tuple(pred.shape) != (B, 1, DDR_H, DDR_W) \
            or not torch.isfinite(m).all():
        fail(f"ddrnet serve: launches {counts}, pred {tuple(pred.shape)}")
    del engine

    _train_and_serve(workdir, "cleargrasp", ["--dataset", "cleargrasp",
                                             "--data_root", cg], 4)

    hold_in_kernels(fuse_in_shapes(H, W, INFUSE_CHANNELS), "INFuse")
    node = parse_config(_flagship_args(workdir)).model.G_A2B.to_dict()
    gen = torch.Generator(device="cuda").manual_seed(8)
    rgb, normal = (torch.randn((B, 3, H, W), device="cuda", generator=gen)
                   for _ in range(2))
    depth = torch.rand((B, 1, H, W), device="cuda", generator=gen)
    variants = (("IN", {"fuse_depth_in_rgb_decoder": "IN"}, 4),
                ("AdaIN", {"fuse_depth_in_rgb_decoder": "AdaIN"}, 0),
                ("add skips", {"rgb_skip_connection_type": "add",
                               "depth_skip_connection_type": "add",
                               "rgb_channels_decoder": [512, 256, 128, 64],
                               "depth_channels_decoder": [512, 256, 128,
                                                          64]}, 4))
    for name, change, n_in in variants:
        torch.manual_seed(0)
        g = build_generator({**node, **change}).cuda().eval()
        build.reset_launches()
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = g(rgb, depth, normal)["pred_depth"]
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        want = {"instance_norm_fwd": n_in} if n_in else {}
        print(f"G_A2B with {name} served at {B}x{H}x{W} (bf16): pred_depth "
              f"{tuple(out.shape)} in [{float(out.min()):.4f}, "
              f"{float(out.max()):.4f}], launches {counts}; expected {want}")
        if counts != want or tuple(out.shape) != (B, 1, H, W) \
                or not torch.isfinite(out).all():
            fail(f"G_A2B {name}: launches {counts}, expected {want}")
        if name != "IN":
            continue
        g.train()
        opt = torch.optim.Adam(g.parameters(), lr=1e-4)
        before = {k: v.detach().clone() for k, v in g.named_parameters()}
        build.reset_launches()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            ret = g(rgb, depth, normal)
        loss = sum(ret[k].float().abs().mean() for k in (
            "depth_map_1", "depth_map_2", "pred_depth"))
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        blocks = fused_blocks(g)
        want = {"instance_norm_fwd": 4, "instance_norm_bwd": 4,
                "conv3x3_fwd": 2 * blocks, "conv3x3_bwd": 2 * blocks}
        moved = sum(int(not torch.equal(before[k], v))
                    for k, v in g.named_parameters())
        print(f"  one train step of the IN build: loss "
              f"{float(loss.detach()):.6g}, "
              f"{moved} of {len(before)} parameter tensors moved, launches "
              f"{counts}; expected {want}")
        _no_f32_conv(counts, "the IN build's bf16 step")
        if counts != want or not np.isfinite(float(loss.detach())) \
                or moved == 0:
            fail(f"the IN build's train step: launches {counts}")
        del g, opt
    print(f"  v1 datasets and variants phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")


def esanet_planes(h: int, w: int):
    """(C, H, W) of the identity BasicBlocks of ESANet's resnet18 torso at
    an h x w input: behind the 7x7/2 stem and the 3x3/2 max-pool, layer1
    (both blocks) and the second block of layers 2-4."""
    return tuple((c, _halve(h, 2 + i), _halve(w, 2 + i))
                 for i, c in enumerate((64, 128, 256, 512)))


def hold_conv_kernels(planes, title: str):
    """The fused conv3x3 kernels (#9, #10) against their plain versions at
    ``planes`` (batch B), as ``conv_block_phase`` holds them: the forward
    without and with the affine + ReLU prologue, the backward of conv2,
    of conv1 (carry) and bare; f32 bit for bit, bf16 within
    ``conv_block_kernel``'s stated tolerance. Times the bf16 conv2
    forward and backward beside cuDNN's bf16 convolution and its backward
    on the same inputs, and the f32 kernels. Returns {plane: times}."""
    import torch

    from rdfc_gan_torch.ops.kernels import conv_block_kernel as ck

    gen = torch.Generator(device="cuda").manual_seed(9)

    def rnd(*s, scale=1.0, shift=0.0):
        return torch.randn(s, device="cuda", generator=gen) * scale + shift

    errs, times = [], {}
    for C, h, w in planes:
        uf = rnd(B, C, h, w, scale=1.5, shift=0.2)
        wf = rnd(C, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
        a, b = rnd(C, scale=0.3, shift=1.0), rnd(C, scale=0.3)
        gf, yf, cf = (rnd(B, C, h, w), rnd(B, C, h, w, scale=2.0, shift=0.5),
                      rnd(B, C, h, w))
        fin = torch.stack([rnd(C, scale=0.3, shift=1.0), rnd(C, scale=0.1),
                           rnd(C, scale=0.1), rnd(C, scale=0.3),
                           rnd(C, scale=0.1, shift=0.8)])
        xh = (rnd(C, scale=0.3), rnd(C, scale=0.1, shift=0.8))
        conv2_bwd = dict(a=a, b=b, act="relu", y=None, fin=fin, xh=xh)
        for dt in (torch.float32, torch.bfloat16):
            u, g, y, cy = (t.to(dt) for t in (uf, gf, yf, cf))
            conv2_bwd["y"] = y
            tag = f"{title} ({B}, {C}, {h}, {w}) {dt}"
            for args, kind in (((None, None, "none"), "conv1"),
                               ((a, b, "relu"), "conv2")):
                got = ck.conv3x3_fwd(u, wf, *args)
                torch.cuda.synchronize()
                want = ck.conv3x3_fwd_plain(u, wf, *args)
                if dt == torch.bfloat16:
                    for name, err, bnd, _ in ck.check_fwd_bf16(
                            got, u, wf, *args, want=want):
                        if err > bnd:
                            fail(f"conv3x3_fwd {kind} {tag} {name}: error "
                                 f"{err:.4g} past {bnd:.4g}")
                    errs.append(float((got[0].float() - want[0].float())
                                      .abs().max()))
                    continue
                for name, x_, y_ in zip(("y", "moments"), got, want):
                    errs.append(compare(f"conv3x3_fwd {kind} {name} {tag}",
                                        x_, y_, CONV_RTOL, CONV_ATOL,
                                        quiet=True))
            for kw, kind in ((conv2_bwd, "conv2"),
                             (dict(y=y, fin=fin, carry=cy), "conv1"),
                             ({}, "bare")):
                got = ck.conv3x3_bwd(g, u, wf, **kw)
                torch.cuda.synchronize()
                if dt == torch.bfloat16:
                    parts = ck._bwd_parts(g, u, wf, **kw)
                    for name, err, bnd, _ in ck.check_bwd_bf16(
                            got, g, u, wf, **kw, parts=parts):
                        if err > bnd:
                            fail(f"conv3x3_bwd {kind} {tag} {name}: error "
                                 f"{err:.4g} past {bnd:.4g}")
                    errs.append(float((got[0].float() - parts["gout"]
                                       .float()).abs().max()))
                    continue
                want = ck.conv3x3_bwd_plain(g, u, wf, **kw)
                for name, x_, y_ in zip(("gout", "dW", "sums"), got, want):
                    if y_ is not None:
                        errs.append(compare(
                            f"conv3x3_bwd {kind} {name} {tag}", x_, y_,
                            CONV_RTOL, CONV_ATOL, quiet=True))
        u, g, y = (t.to(torch.bfloat16) for t in (uf, gf, yf))
        wd = wf.to(torch.bfloat16)
        bwd = dict(conv2_bwd, y=y)
        t = dict(
            fwd=time_ms(lambda: ck.conv3x3_fwd(u, wf, a, b, "relu")),
            bwd=time_ms(lambda: ck.conv3x3_bwd(g, u, wf, **bwd)),
            fwd_f32=time_ms(lambda: ck.conv3x3_fwd(uf, wf, a, b, "relu"),
                            reps=3, warmup=1),
            bwd_f32=time_ms(lambda: ck.conv3x3_bwd(gf, uf, wf, **dict(
                conv2_bwd, y=yf)), reps=3, warmup=1))
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            t["cudnn_fwd"] = time_ms(lambda: torch.nn.functional.conv2d(
                u, wd, padding=1))
            t["cudnn_bwd"] = time_ms(
                lambda: torch.ops.aten.convolution_backward(
                    g, u, wd, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                    [True, True, False]))
        times[(C, h, w)] = t
        print(f"  {title} {B}x{C}x{h}x{w} ({gpu_line()}): bf16 fwd "
              f"{t['fwd']:.4f} ms (cuDNN {t['cudnn_fwd']:.4f}), bwd "
              f"{t['bwd']:.4f} ms (cuDNN {t['cudnn_bwd']:.4f}); f32 fwd "
              f"{t['fwd_f32']:.4f} ms, bwd {t['bwd_f32']:.4f} ms")
    print(f"  conv3x3 kernels vs plain at the {title} planes "
          f"{', '.join('x'.join(map(str, p)) for p in planes)}, f32 bit for "
          f"bit and bf16 within tolerance ({len(errs)} comparisons, max "
          f"|kernel - plain| of y/gout {max(errs):.3e})")
    return times


def _s2d_origin_dataset():
    """``nyuv2_s2d`` whose val samples carry the frame's uncropped 480x640
    depth as ``gt_depth_origin``: EvalV1 resizes each 228x304 prediction
    back to it."""
    from rdfc_gan_torch.data.nyuv2_s2d import NYUV2S2DDataset

    class Origin(NYUV2S2DDataset):
        def get_test_data(self, idx):
            sample = super().get_test_data(idx)
            sample["gt_depth_origin"] = self._load(idx)[1]
            return sample

    return Origin


V1_FLAGS = ["--use_guidance", "--use_nlspn_to_refine",
            "--fuse_depth_in_rgb_decoder", "WAdaIN"]


def _v1_cfg(workdir, s2d_root, work, extra=()):
    from rdfc_gan_torch.tools import main_v1

    return main_v1.parse_cfg([
        "--dataset", "nyuv2_s2d", "--data_root", s2d_root, "--batch_size",
        str(B), "--num_workers", "4", "--work_dir",
        os.path.join(workdir, work), "--device", "cuda", *extra])


def _served_counts(forwards: int, nlspn: bool = True, n_in: int = 4):
    want = {"instance_norm_fwd": n_in * forwards} if n_in else {}
    if nlspn:
        want.update(shift_mask_scatter=forwards, nlspn_propagate=forwards)
    return want


def _nets_moved(engine, cfg) -> dict:
    """{net: (tensors moved, tensors)} against the same seeded init."""
    import torch

    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.utils import set_random_seed

    set_random_seed(cfg.seed)
    init = build_engine(cfg, is_train=True)
    out = {}
    for k in ("G", "D"):
        a = dict(engine.modules[k].named_parameters())
        b = dict(init.modules[k].named_parameters())
        out[k] = (sum(int(not torch.equal(a[n], b[n])) for n in a), len(a))
    return out


def v1_family_phase(workdir, s2d_root):
    """The v1 RDF-GAN family through ``python -m
    rdfc_gan_torch.tools.main_v1``'s code path on the s2d fixture: #9 /
    #10 held against their plain versions at ESANet's planes (228x304 and
    480x640, down to 8x10) and timed beside cuDNN; the guided model
    (ESANet guidance, NLSPN, W-AdaIN) trained one epoch (4 bf16 steps at
    batch 4, 228x304, deterministic cuDNN) with every kernel's launches a
    step checked, G and D moved, step times and peak memory; EvalV1 with
    the predictions resized back to 480x640; ``--inference`` from
    epoch_1.pth and ``--cal_fps``, launches counted a forward; the same
    engine state written as the JAX driver's epoch_1.ckpt
    (``save_jax_checkpoint``: its size, write and read seconds), served by
    ``--inference --load_from`` to the .pth's metrics and bit-equal
    outputs, and resumed for one bf16 step bit-equal to the .pth's resume
    (every kernel launched: #9 / #10 30 times); one f32 guided step
    through the kernels against the step with their plain versions; the
    driver-default AdaIN build and a vanilla build served, and one vanilla
    train step with its #9 / #10 launches."""
    import numpy as np
    import torch

    from rdfc_gan_torch.data import DataLoader
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.evaluator import EvalV1
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.tools import main_v1
    from rdfc_gan_torch.utils import jax_checkpoint
    from rdfc_gan_torch.utils.checkpoint import (load_checkpoint,
                                                 save_jax_checkpoint)

    t_phase = time.perf_counter()
    print(f"v1 family ({gpu_line()}):")
    for size in ((S2D_H, S2D_W), (DDR_H, DDR_W)):
        hold_conv_kernels(esanet_planes(*size),
                          f"ESANet {size[0]}x{size[1]}")

    # the guided model, trained one epoch through the driver
    cfg = _v1_cfg(workdir, s2d_root, "v1_train", V1_FLAGS + [
        "--n_epochs", "1", "--save_interval", "1", "--log_interval", "1"])
    cfg.deterministic = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    res = main_v1.run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, engine, steps = dict(build.LAUNCHES), res["engine"], res["steps"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = _rdfgan_counts(engine, steps)
    blocks = fused_blocks(engine.modules["G"])
    sec = np.asarray(res["step_seconds"]) * 1e3
    print(f"  guided v1 train (ESANet + NLSPN + W-AdaIN, "
          f"{engine.compute_dtype}, batch {B}, {S2D_H}x{S2D_W}): {steps} "
          f"steps + "
          f"{engine.n_forward} EvalV1 forwards in {wall:.2f} s; step ms "
          f"(host clock, each ends in the loss readback) "
          f"{', '.join(f'{v:.1f}' for v in sec)}, median after the first "
          f"{np.median(sec[1:]):.3f}; peak memory {peak:.3f} GiB "
          f"({gpu_line()})")
    print("    last losses: " + ", ".join(
        f"{k}={v:.6g}" for k, v in sorted(res["losses"].items())))
    print("    metrics: " + ", ".join(
        f"{k}={v:.6g}" for k, v in res["metrics"].items()))
    print(f"    fused BasicBlocks {blocks} (core 10 + ESANet 5); kernel "
          f"launches {counts}; expected {want}")
    if steps != S2D_TRAIN // B or res["g_updates"] != steps:
        fail(f"v1 train: {steps} steps, {res['g_updates']} G updates")
    if not all(np.isfinite(v) for v in list(res["losses"].values())
               + list(res["metrics"].values())):
        fail("v1 train: non-finite losses or metrics")
    _no_f32_conv(counts, "the guided v1 bf16 epoch")
    if blocks != 15 or counts != want:
        fail(f"v1 train launch counts {counts} are not {want}")
    moved = _nets_moved(engine, cfg)
    print(f"    parameter tensors moved from the seeded init: {moved}")
    if any(m == 0 for m, _ in moved.values()):
        fail(f"v1 train: a net did not move {moved}")
    trained = res["metrics"]

    # EvalV1 at the 480x640 origin
    loader = DataLoader(_s2d_origin_dataset()(s2d_root, mode="val"), B,
                        device=torch.device("cuda"), num_workers=4)
    build.reset_launches()
    forwards = engine.n_forward
    t0 = time.perf_counter()
    m = EvalV1(loader).evaluate(engine)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    fwd = engine.n_forward - forwards
    counts, want = dict(build.LAUNCHES), _served_counts(fwd)
    print(f"  EvalV1 at the 480x640 origin ({S2D_VAL} frames, {fwd} "
          f"forwards, {ms:.1f} ms host clock, {gpu_line()}): " + ", ".join(
              f"{k}={v:.6g}" for k, v in m.items())
          + f"; launches {counts}; expected {want}")
    if counts != want or not all(np.isfinite(list(m.values()))):
        fail(f"EvalV1 at 480x640: launches {counts}, metrics {m}")
    val_batch = next(iter(loader))
    pth = os.path.join(workdir, "v1_train", "epoch_1.pth")

    # the same state as the JAX driver's epoch_1.ckpt, by the port's writer
    t_v1ckpt = time.perf_counter()
    ckpt = os.path.join(workdir, "v1_train", "epoch_1.ckpt")
    t0 = time.perf_counter()
    save_jax_checkpoint(engine, ckpt, meta=dict(epoch=1))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree, meta = jax_checkpoint.read_state(ckpt)
    t_read = time.perf_counter() - t0
    n_leaves = len(_flat_leaves(tree))
    del tree, engine, res
    print(f"  v1 .ckpt (the guided model after {steps} {B}x{S2D_H}x{S2D_W} "
          f"bf16 steps, nets and Adam states): {os.path.getsize(ckpt)} bytes "
          f"({os.path.getsize(ckpt) / 2**30:.3f} GiB, {n_leaves} leaves); "
          f"save_jax_checkpoint {t_write:.2f} s, read_state {t_read:.2f} s; "
          f"epoch_1.pth {os.path.getsize(pth)} bytes ({gpu_line()})")
    if meta != {"epoch": 1}:
        fail(f"the v1 .ckpt's meta {meta}")

    # --inference from epoch_1.pth and from epoch_1.ckpt, --cal_fps
    served = {}
    for path in (pth, ckpt):
        icfg = _v1_cfg(workdir, s2d_root, "v1_inf", V1_FLAGS + [
            "--inference", "--load_from", path])
        icfg.deterministic = True
        build.reset_launches()
        inf = main_v1.run(icfg)
        counts = dict(build.LAUNCHES)
        fwd = inf["engine"].n_forward
        want = _served_counts(fwd)
        print(f"  --inference from {os.path.basename(path)}: " + ", ".join(
            f"{k}={v:.6g}" for k, v in inf["metrics"].items())
            + f"; {fwd} forwards, launches {counts}; expected {want}")
        if counts != want:
            fail(f"--inference launches {counts} are not {want}")
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            out = inf["engine"].forward_test(
                rgb=val_batch["rgb"], raw_depth=val_batch["raw_depth"])
        served[path] = (inf["metrics"], out)
        del inf
    (m_p, o_p), (m_c, o_c) = served[pth], served[ckpt]
    for k, v in m_p.items():
        if not np.isclose(v, trained[k], rtol=SERVE_RTOL, atol=SERVE_ATOL):
            fail(f"--inference {k}={v}, the epoch's evaluation {trained[k]}")
    if m_c != m_p:
        fail(f"v1 metrics from the .ckpt {m_c}, from the .pth {m_p}")
    bad = [k for k in o_p if not torch.equal(o_c[k], o_p[k])]
    if set(o_c) != set(o_p) or bad:
        fail(f"v1 outputs served from the .ckpt differ from the .pth: {bad}")
    print(f"  served from epoch_1.ckpt and epoch_1.pth: the same metrics and "
          f"bit-equal {sorted(o_p)} (deterministic cuDNN)")
    del served, o_p, o_c
    t_v1ckpt = time.perf_counter() - t_v1ckpt
    build.reset_launches()
    fps = main_v1.run(_v1_cfg(workdir, s2d_root, "v1_fps", V1_FLAGS + [
        "--cal_fps", "--load_from", pth]))
    counts, fwd = dict(build.LAUNCHES), fps["engine"].n_forward
    want = _served_counts(fwd)
    print(f"  --cal_fps: {fps['fps']:.2f} img/s at batch {B}, "
          f"{S2D_H}x{S2D_W}, f32 ({gpu_line()}); {fwd} forwards, launches "
          f"{counts}; expected {want}")
    if counts != want or not fps["fps"] > 0:
        fail(f"--cal_fps launches {counts} are not {want}")
    del fps

    # one f32 guided step through the kernels against the plain step
    from rdfc_gan_torch.ops import nlspn_stencil as st
    from rdfc_gan_torch.ops.kernels import mask_kernel as mk
    from rdfc_gan_torch.ops.kernels import nlspn_kernel

    cfg = _v1_cfg(workdir, s2d_root, "v1_step", V1_FLAGS)
    cfg.compute_dtype = "float32"
    batch = next(iter(DataLoader(_s2d_origin_dataset()(s2d_root,
                                                        mode="train"), B,
                                 device=torch.device("cuda"), num_workers=4,
                                 shuffle=True, drop_last=True)))
    plain = {(mk, "_scatter"): mk.scatter_shift_masks_plain,
             (mk, "shift_mask_gather"): mk.shift_mask_gather_plain,
             (mk, "shift_correlation"): mk.shift_correlation_plain,
             (nlspn_kernel, "propagate_x"): st.propagate_x_plain,
             (nlspn_kernel, "reverse_chain"): st.reverse_chain_plain,
             **plain_in_and_conv()}
    out, launches = {}, {}
    for path, patches in (("kernels", {}), ("plain", plain)):
        engine = build_engine(cfg, is_train=True)
        load_checkpoint(engine.modules, pth)
        build.reset_launches()
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False))
            for (mod, name), fn in patches.items():
                stack.enter_context(mock.patch.object(mod, name, fn))
            losses = engine.train_step(batch)
            torch.cuda.synchronize()
        out[path] = (losses, {f"{net}.{n}": p.grad.detach().clone()
                              for net in ("G", "D")
                              for n, p in engine.modules[net]
                              .named_parameters() if p.grad is not None})
        launches[path] = dict(build.LAUNCHES)
        del engine
    want = _rdfgan_counts_f32(blocks)
    print(f"  one f32 guided step, kernels vs plain (deterministic cuDNN): "
          f"launches {launches['kernels']} (expected {want}) vs "
          f"{launches['plain']}")
    if launches["plain"] or launches["kernels"] != want:
        fail("the f32 guided step's launches")
    worst, errs = _step_diff("guided v1 kernels vs plain", out["kernels"],
                             out["plain"])
    if set(out["kernels"][1]) != set(out["plain"][1]) \
            or worst > STEP_RTOL or errs[0][0] > STEP_RTOL:
        fail("the f32 guided step through the kernels disagrees with the "
             "plain step")
    del out

    # one bf16 step resumed from epoch_1.ckpt and from epoch_1.pth
    t0 = time.perf_counter()
    rcfg = _v1_cfg(workdir, s2d_root, "v1_resume", V1_FLAGS)
    spe = S2D_TRAIN // B
    l_c, s_c, n_c, engine = _resumed_step(rcfg, ckpt, batch, spe)
    want = {k: v for k, v in _rdfgan_counts(engine, 1).items() if v}
    dtype = engine.compute_dtype
    del engine
    l_p, s_p, n_p, engine = _resumed_step(rcfg, pth, batch, spe)
    del engine
    # fuse_layer5 is built and never used: the JAX tree has no entry for
    # it, so a .ckpt resume keeps the engine's own
    for st in (s_c, s_p):
        for k in [k for k in st if ".fuse_layer5." in k]:
            del st[k]
    print(f"  one {dtype} guided step resumed from epoch_1.ckpt and from "
          f"epoch_1.pth (deterministic cuDNN): launches {n_c} and {n_p}; "
          f"expected {want}")
    if n_c != want or n_p != want:
        fail(f"the v1 resumed step's launches {n_c}, {n_p}, not {want}")
    bad = [k for k in l_p if not torch.equal(l_c[k], l_p[k])]
    bad += [k for k in s_p if not torch.equal(s_c[k], s_p[k])]
    if set(l_c) != set(l_p) or set(s_c) != set(s_p) or bad:
        fail(f"the v1 steps resumed from the .ckpt and the .pth differ: "
             f"{len(bad)} tensors, first {bad[:8]}")
    t_v1ckpt += time.perf_counter() - t0
    print(f"    {len(l_p)} losses and {len(s_p)} net tensors bit-equal; the "
          f"v1 .ckpt's write, read, serve and resume took {t_v1ckpt:.2f} s")
    del s_c, s_p

    # the driver-default AdaIN build and a vanilla build served; one
    # vanilla train step
    gen = torch.Generator(device="cuda").manual_seed(11)
    rgb = torch.randn((B, 3, S2D_H, S2D_W), device="cuda", generator=gen)
    raw = torch.rand((B, 1, S2D_H, S2D_W), device="cuda", generator=gen)
    for name, extra, want in (
            ("driver default (AdaIN)", ["--use_guidance",
                                        "--use_nlspn_to_refine"],
             _served_counts(1, n_in=0)),
            ("vanilla (AdaIN)", ["--model", "vanilla", "--use_guidance"],
             {})):
        vcfg = _v1_cfg(workdir, s2d_root, "v1_variant", extra)
        torch.manual_seed(0)
        engine = build_engine(vcfg, is_train=True)
        build.reset_launches()
        pred = engine.forward_test(rgb, raw)["pred_depth"]
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        print(f"  {name} served at {B}x{S2D_H}x{S2D_W}: pred_depth "
              f"{tuple(pred.shape)} in [{float(pred.min()):.4f}, "
              f"{float(pred.max()):.4f}], launches {counts}; expected {want}")
        if counts != want or not torch.isfinite(pred).all():
            fail(f"{name} served: launches {counts}")
        if not name.startswith("vanilla"):
            del engine
            continue
        blocks = fused_blocks(engine.modules["G"])
        vbatch = dict(batch, rgb=rgb, raw_depth=raw)
        build.reset_launches()
        t0 = time.perf_counter()
        losses = engine.train_step(vbatch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(build.LAUNCHES)
        want = {"conv3x3_fwd": 2 * blocks, "conv3x3_bwd": 2 * blocks}
        print(f"  one vanilla train step (guided, {engine.compute_dtype}, "
              f"{blocks} fused BasicBlocks: two torsos and ESANet's): "
              f"{ms:.1f} ms host clock (the first; {gpu_line()}), losses "
              + ", ".join(
                  f"{k}={float(v):.6g}" for k, v in sorted(losses.items()))
              + f"; launches {counts}; expected {want}")
        if blocks != 15 or counts != want or not all(
                torch.isfinite(v) for v in losses.values()):
            fail(f"the vanilla train step: launches {counts}")
        del engine
    print(f"  v1 family phase wall {time.perf_counter() - t_phase:.2f} s "
          f"({gpu_line()})")


def _palette_png(path: str, index: "np.ndarray", palette: bytes):
    """An 8-bit palette PNG (colour type 3) of ``index``, rows unfiltered:
    PIL writes the test suite's; the card's machine has no PIL."""
    import struct
    import zlib

    import numpy as np

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    h, w = index.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = index
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
                + chunk(b"PLTE", palette)
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def augmentation_phase(workdir):
    """The sensor-corruption library (``utils/data_augmentation.py``) on
    the card's host with OpenCV and PIL made unimportable for the phase
    (None in ``sys.modules``; the port imports neither): each of its 18
    functions once at 228x304, twice from the same seed to the same array,
    with its motion blur (filter2d), HLS jitter, cubic resize, colour map,
    PNG writer and palette reader in numpy; a save_uint16_png ->
    image_io.imread round trip exact; a palette PNG read back as its
    indices; EXR refused."""
    import importlib.util

    t0 = time.perf_counter()
    present = [m for m in ("cv2", "PIL") if importlib.util.find_spec(m)]
    hidden = {m: sys.modules.pop(m, None) for m in ("cv2", "PIL")}
    sys.modules.update(cv2=None, PIL=None)  # an import of either raises
    try:
        _augmentation_checks(workdir)
    finally:
        for m, mod in hidden.items():
            del sys.modules[m]
            if mod is not None:
                sys.modules[m] = mod
    print(f"  OpenCV / PIL installed here: {present or 'neither'}, "
          f"unimportable during the phase; phase "
          f"{time.perf_counter() - t0:.2f} s")


def _augmentation_checks(workdir):
    import numpy as np

    from rdfc_gan_torch.data import image_io
    from rdfc_gan_torch.utils import data_augmentation as da

    h, w = S2D_H, S2D_W
    tmp = tempfile.mkdtemp(prefix="augment-", dir=workdir)
    gen = np.random.default_rng(0)
    depth = np.abs(gen.normal(2.0, 0.7, (h, w))).astype(np.float32)
    depth[gen.random((h, w)) < 0.1] = 0
    rgb = gen.integers(0, 256, (h, w, 3)).astype(np.uint8)
    cam = dict(fx=518.8, fy=519.5, cx=w / 2, cy=h / 2, xres=w, yres=h)
    noise = dict(ellipse_dropout_mean=10, ellipse_gamma_shape=5.0,
                 ellipse_gamma_scale=1.0, gamma_shape=1000.0,
                 gamma_scale=0.001, gaussian_scale=0.005,
                 gp_rescale_factor=4)
    xyz = da.compute_xyz(depth, cam)
    pal = os.path.join(tmp, "labels.png")
    labels = gen.integers(0, 40, (h, w)).astype(np.uint8)
    _palette_png(pal, labels,
                 bytes(gen.integers(0, 256, 3 * 40).astype(np.uint8)))

    def ply(seed):
        path = os.path.join(tmp, f"pc{seed}.ply")
        pts, cols = da.depth_to_point_cloud(depth, 518.8, 519.5, w / 2,
                                            h / 2, rgb)
        da.write_point_cloud(path, pts, cols)
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), np.uint8)

    def png(seed):
        path = os.path.join(tmp, f"d{seed}.png")
        da.save_uint16_png(path, da.scale_depth(depth))
        return image_io.imread(path)

    calls = {
        "depth2rgb": lambda r: da.depth2rgb(depth),
        "scale_depth": lambda r: da.scale_depth(depth),
        "unscale_depth": lambda r: da.unscale_depth(da.scale_depth(depth)),
        "normalize_depth_img": lambda r: da.normalize_depth_img(
            depth, np.uint16, 0.0, 10.0),
        "depth_to_point_cloud": lambda r: da.depth_to_point_cloud(
            depth, 518.8, 519.5, w / 2, h / 2)[0],
        "write_point_cloud": ply,
        "build_matrix_of_indices": lambda r: da.build_matrix_of_indices(h, w),
        "compute_xyz": lambda r: da.compute_xyz(depth, cam),
        "add_gaussian_noise": lambda r: da.add_gaussian_noise(depth, r),
        "chromatic_transform": lambda r: da.chromatic_transform(
            rgb, r, label=(depth > 2.5).astype(np.uint8)),
        "dropout_random_ellipses_4corruptmask": lambda r:
            da.dropout_random_ellipses_4corruptmask(
                (depth > 2.5).astype(np.uint8), r, noise),
        "dropout_random_ellipses_4mask": lambda r:
            da.dropout_random_ellipses_4mask((depth > 0).astype(np.uint8),
                                             r, noise),
        "add_noise_to_depth": lambda r: da.add_noise_to_depth(depth, r,
                                                              noise),
        "add_noise_to_xyz": lambda r: da.add_noise_to_xyz(xyz, depth, r,
                                                          noise),
        "save_uint16_png": png,
        "imread_indexed": lambda r: da.imread_indexed(pal),
    }
    # add_noise's two branches: seeds whose first draw is under 0.9
    # (gaussian noise) and past it (motion blur)
    for branch, pick in (("gaussian", lambda u: u < 0.9),
                         ("motion blur", lambda u: u >= 0.9)):
        seed = next(s for s in range(1000)
                    if pick(np.random.default_rng(s).random()))
        calls[f"add_noise ({branch})"] = lambda r, seed=seed: da.add_noise(
            rgb, np.random.default_rng(seed))
    seconds = {}
    for name, fn in calls.items():
        t1 = time.perf_counter()
        a = fn(np.random.default_rng(7))
        seconds[name] = time.perf_counter() - t1
        b = fn(np.random.default_rng(7))
        if not (isinstance(a, np.ndarray) and a.size and np.array_equal(a, b)):
            fail(f"augmentation: {name} does not repeat from its seed")
    if not np.array_equal(png(0), da.scale_depth(depth)):
        fail("augmentation: save_uint16_png -> imread is not exact")
    if not np.array_equal(da.imread_indexed(pal), labels):
        fail("augmentation: imread_indexed does not give the palette indices")
    try:
        da.exr_saver(os.path.join(tmp, "d.exr"), depth)
        fail("augmentation: exr_saver wrote an EXR")
    except ValueError as e:
        if "d.exr" not in str(e):
            fail(f"augmentation: exr_saver's error names no file: {e}")
    named = {n.split(" ")[0] for n in calls} | {"exr_saver"}
    print(f"augmentation library at {h}x{w} ({len(named)} functions): "
          f"each repeats from its seed, the uint16 PNG round trip and the "
          f"palette indices are exact; seconds a call: " + ", ".join(
              f"{k} {v:.3f}" for k, v in seconds.items()))
    if len(named) != 18:
        fail(f"augmentation: {len(named)} functions called, not 18")


def _rdfgan_counts_f32(blocks: int) -> dict:
    """The launches of one f32 RDFGAN step with W-AdaIN and NLSPN: the f32
    conv kernels carry the identity blocks."""
    return {"shift_mask_scatter": 1, "shift_mask_gather": 1,
            "nlspn_propagate_x": 1, "nlspn_reverse_chain": 1,
            "shift_correlation": 1, "instance_norm_fwd": 4,
            "instance_norm_bwd": 4, "conv3x3_fwd_f32": 2 * blocks,
            "conv3x3_bwd_f32": 2 * blocks}


REPEAT_STEPS = 4


def nlspn_repeat_check(workdir):
    """Does one rank repeat itself? The RDF-GAN NLSPN config (bf16, batch 4,
    224x304) from the seeded G and D, REPEAT_STEPS train steps, twice,
    each under ``set_random_seed(seed, deterministic=True)`` in a fresh
    engine; the two checkpoints (nets, optimizers, schedulers) must be
    bit-equal entry by entry. Each step's losses and gradients are compared
    too, so a difference is placed: the first step that differs and, in
    forward order, the last parameters whose gradients differ (the
    nondeterministic op sits behind them)."""
    import torch

    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.train import build_train_loader
    from rdfc_gan_torch.utils import set_random_seed
    from rdfc_gan_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    cfg = parse_config(_train_args(workdir, "")[:-2] + ["--deterministic"])
    pth = _seeded_nets(cfg, workdir)
    runs = []
    for run in range(2):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            set_random_seed(cfg.seed, deterministic=True)
            engine = build_engine(cfg, is_train=True, steps_per_epoch=16)
            load_checkpoint(engine.modules, pth)
            steps = []
            for _, batch in zip(range(REPEAT_STEPS),
                                build_train_loader(cfg, engine.device)):
                losses = engine.train_step(batch)
                grads = {f"{net}.{n}": p.grad.detach().clone()
                         for net, m in engine.modules.items()
                         for n, p in m.named_parameters()
                         if p.grad is not None}
                steps.append((losses, grads))
            out = os.path.join(workdir, f"repeat_{run}.pth")
            save_checkpoint(engine.modules, out, meta=dict(steps=len(steps)),
                            train_state=engine.train_state())
        runs.append((out, steps))
        del engine
    first = None
    for i, ((la, ga), (lb, gb)) in enumerate(zip(runs[0][1], runs[1][1])):
        diff_l = [k for k in la if not torch.equal(la[k], lb[k])]
        diff_g = [k for k in ga if not torch.equal(ga[k], gb[k])]
        print(f"  repeat step {i}: {len(la) - len(diff_l)} of {len(la)} "
              f"losses and {len(ga) - len(diff_g)} of {len(ga)} gradients "
              f"bit-equal")
        if (diff_l or diff_g) and first is None:
            first = i
            print(f"    first differing step {i}: losses {diff_l}; the last "
                  f"differing gradients in forward order {diff_g[-8:]}")
    a, b = (_flat_leaves(torch.load(p, map_location="cpu", weights_only=True))
            for p, _ in runs)
    differ = [k for k, x in a.items() if not (
        torch.equal(x, b[k]) if isinstance(x, torch.Tensor) else x == b[k])]
    n_tensors = sum(isinstance(x, torch.Tensor) for x in a.values())
    print(f"NLSPN RDF-GAN, {REPEAT_STEPS} bf16 steps at batch {B}, {H}x{W}, "
          f"twice under set_random_seed(seed, deterministic=True): "
          f"{len(a) - len(differ)} of {len(a)} checkpoint entries "
          f"({n_tensors} tensors) bit-equal")
    if differ or first is not None:
        fail(f"the NLSPN RDF-GAN steps do not repeat: {len(differ)} "
             f"checkpoint entries differ, e.g. {differ[:6]}")


# the data-parallel phase: a NYUv2 fixture of 8 train scenes (2 flagship
# steps at batch 4) and a val split of 6 (batch 2 a rank, so pad rows)
DP_TRAIN, DP_TEST = 8, 6
DP_BF16_STEPS = 4
# world 2 against world 1, f32, world 1's BatchNorms in the world-2 form
# (``_SyncBN``, whose collectives are no-ops at world 1): torch's kernel
# rounds y otherwise, which on the card flipped 45 of 272384 of G_label's
# classes of real_A. The losses rtol 1e-5. The gradients as the port's CPU
# flagship test holds them against JAX (the same rule for the RDF-GAN
# step): a tensor's relative L2 error below 0.2, a net's below 0.06; a
# tensor below 1e-4 of its net's largest entry on both sides is noise; a
# one-entry tensor (a PReLU slope: a sum of x dy over a layer's negative
# inputs, which cancels; one read 0.22 on the card) is held by its net's
# bound. The convolutions of batch 2 and batch 4 round otherwise, and the
# BatchNorms and (Leaky)ReLUs turn that into percent-level gradient
# differences where a value sits at a kink; a rank's own statistics or
# denominators move them by tens of percent. The parameters after Adam
# within 2e-5 + 1e-5 |p| where the two gradients agree to 10% and lie
# above 10 times Adam's eps, else (and in a noise tensor) within 2 lr. The
# running statistics rtol 1e-4 / atol 1e-5 (f64 sums at world 2, f32 at
# world 1: rounding apart), the running means 2 lr x momentum more (a conv
# bias ahead of a BatchNorm takes a gradient that is noise, so Adam moves
# it by lr either way, and the batch means of the passes after the update
# follow it).
DP_LOSS_RTOL = 1e-5
DP_STATS = dict(rtol=1e-4, atol=1e-5)
# the f32 flagship comparison names no class as floor, wall or ceiling, so
# the Manhattan terms' masks are empty: they take an argmax of G_label's
# logits, and pixels whose top two classes lie within rounding swap
# classes between the batch-4 and batch-2 convolutions (on the card they
# moved a B->A term by 4e-4 and G_B2A's gradients by up to 29%); the CPU
# tests hold those terms at world 2
NO_MANHATTAN = ["--label_wall", "99", "--label_floor", "99",
                "--label_ceiling", "99"]


def _dp_net_check(title, net, got_grads, want_grads, got_state, want_state,
                  lr):
    """One net of a world-2 f32 step against world 1 (the rule above).
    Returns the worst relative L2 error of a tensor."""
    import torch

    tens = {k: (got_grads[k].double(), w.double())
            for k, w in want_grads.items()}
    if set(got_grads) != set(want_grads):
        fail(f"{title} {net}: the ranks' gradients name other tensors")
    top = max(float(w.abs().max()) for _, w in tens.values())
    num = den = worst = 0.0
    noise = set()
    for k, (g, w) in tens.items():
        if max(float(g.abs().max()), float(w.abs().max())) < 1e-4 * top:
            noise.add(k)
            continue
        rel = float((g - w).norm() / w.norm())
        # a one-entry tensor (a PReLU slope: a sum of x dy over a layer's
        # negative inputs, which cancels) is held by its net's bound
        if w.numel() > 1:
            worst = max(worst, rel)
            if rel >= 0.2:
                fail(f"{title} {net}.{k}: gradient relative L2 {rel:.3e}")
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    if den and (num / den) ** 0.5 >= 0.06:
        fail(f"{title} {net}: whole-gradient relative L2 "
             f"{(num / den) ** 0.5:.3e}")
    for k, w in want_state.items():
        g = got_state[k]
        if k.endswith("num_batches_tracked"):
            ok = torch.equal(g, w)
        elif "running" in k:
            extra = 2 * lr * 0.1 if k.endswith("running_mean") else 0.0
            ok = bool(((g - w).abs() <= DP_STATS["atol"] + extra
                       + DP_STATS["rtol"] * w.abs()).all())
        elif k in tens:
            gg, gw = tens[k]
            # Adam's step follows the sign of a gradient far above its
            # eps (1e-8); one within 10 eps, or noise, moves it anywhere
            # within lr
            loose = (((gg - gw).abs() >= 0.1 * gw.abs()) | (gw.abs() < 1e-7)
                     | (k in noise))
            atol = torch.where(loose, torch.full_like(gw, 2.01 * lr),
                               2e-5 + 1e-5 * w.double().abs())
            ok = bool(((g.double() - w.double()).abs() <= atol).all())
        else:
            ok = True
        if not ok:
            fail(f"{title} {net}.{k}: updated value past its tolerance")
    return worst


@contextlib.contextmanager
def _sync_bn_form():
    """Train-mode BatchNorm2d in its world-2 form (``_SyncBN``, whose
    collectives are no-ops at world 1) at any world size."""
    from rdfc_gan_torch.models import layers

    def forward(self, x):
        if not self.training:
            return layers.nn.BatchNorm2d.forward(self, x)
        y, mean, var = layers._SyncBN.apply(x, self.weight, self.bias,
                                            self.eps)
        self.update_running(mean, var)
        return y

    with mock.patch.object(layers.BatchNorm2d, "forward", forward):
        yield


def _dp_step(cfg_args, pth, batch, bn_form=False):
    """One f32 train step of a fresh engine of ``cfg_args`` loaded from
    ``pth`` on ``batch`` (this rank's rows at world 2), deterministic
    cuDNN; ``bn_form``: the BatchNorms in their world-2 form. Returns
    (losses, gradients, state dicts, seconds, G_label's classes of real_A
    or None)."""
    import torch

    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    cfg = parse_config(cfg_args)
    cfg["compute_dtype"] = "float32"
    engine = build_engine(cfg, is_train=True, steps_per_epoch=16)
    load_checkpoint(engine.modules, pth)
    seen = []
    label = engine.modules.get("G_label")
    hook = label and label.register_forward_hook(
        lambda m, i, o: seen.append(o[0].detach().argmax(1).cpu()))
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False))
        if bn_form:
            stack.enter_context(_sync_bn_form())
        t0 = time.perf_counter()
        losses = engine.train_step(batch)
        _sync(engine.device)
        sec = time.perf_counter() - t0
    if hook:
        hook.remove()
    out = ({k: float(v) for k, v in losses.items()},
           {net: {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                  if p.grad is not None}
            for net, m in engine.modules.items()},
           {net: {n: v.detach().cpu() for n, v in m.state_dict().items()}
            for net, m in engine.modules.items()}, sec,
           seen[0] if seen else None)
    del engine
    return out


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _net_digests(engine):
    """{net: sha1 of all its tensors' bytes} of an engine's nets."""
    import hashlib

    import torch

    out = {}
    for net, m in engine.modules.items():
        h = hashlib.sha1()
        for _, v in sorted(m.state_dict().items()):
            h.update(v.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        out[net] = h.hexdigest()
    return out


def dp_rank_main(rank: int, world: int, port: int, spec_path: str):
    """One rank of ``data_parallel_phase``: a gloo group over
    tcp://localhost:port on the spec's device (``cuda:0``: both ranks share
    the card). Runs the spec's f32 flagship step, bf16 flagship steps
    (digests of the six nets gathered after each), f32 RDF-GAN step and the
    NLSPN evaluation, and writes its results beside the spec."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.parallel import all_gather_object, rank_rows
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    out = {}
    try:
        rows = {k: rank_rows(v).to(dev) for k, v in spec["batch"].items()}
        build.reset_launches()
        out["flagship_f32"] = _dp_step(spec["flagship_f32"], spec["fpth"],
                                       rows)
        out["flagship_f32_launches"] = dict(build.LAUNCHES)
        engine = build_engine(parse_config(spec["flagship_bf16"]),
                              is_train=True, steps_per_epoch=16)
        load_checkpoint(engine.modules, spec["fpth"])
        out["bf16_seeded"] = _net_digests(engine)
        out["blocks"] = fused_blocks(engine.modules["G_A2B"])
        out["n_in"] = sum(1 for m in engine.modules["G_B2A"].modules()
                          if type(m).__name__ == "InstanceNorm")
        steps, digests = [], []
        build.reset_launches()
        for i in range(DP_BF16_STEPS):
            b = {k: rank_rows(v).to(dev)
                 for k, v in spec["bf16_batches"][i].items()}
            t0 = time.perf_counter()
            losses = engine.train_step(b)
            _sync(dev)
            steps.append(time.perf_counter() - t0)
            if not all(bool(torch.isfinite(v)) for v in losses.values()):
                raise RuntimeError(f"bf16 step {i}: non-finite losses")
            digests.append(all_gather_object(_net_digests(engine)))
        out["bf16_launches"] = dict(build.LAUNCHES)
        out["bf16_digests"], out["bf16_seconds"] = digests, steps
        out["bf16_moved"] = _net_digests(engine)
        del engine
        build.reset_launches()
        out["rdfgan_f32"] = _dp_step(spec["rdfgan_f32"], spec["gpth"], rows)
        out["rdfgan_f32_launches"] = dict(build.LAUNCHES)
        build.reset_launches()
        served = port_test.run(parse_config(spec["serve"]))
        out["serve"] = dict(metrics=served["metrics"],
                            max_offset=served["max_offset"],
                            forwards=served["forwards"],
                            launches=dict(build.LAUNCHES))
        torch.save(out, os.path.join(os.path.dirname(spec_path),
                                     f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_rank_counts(title, res, want):
    for r, got in enumerate(res):
        if got != want:
            fail(f"{title}: rank {r} launched {got}, expected {want}")


def data_parallel_phase(workdir, device="cuda:0", flagship=None, nlspn=None,
                        size=(H, W)):
    """Data parallelism on the one card. World 1 through the real launcher:
    ``torch.distributed.run --nproc_per_node 1`` trains the flagship 2 bf16
    steps on a NYUv2 fixture (deterministic), and its epoch_1.pth must be
    bit-equal to the same run without the launcher. World 2: two ranks on
    ``device`` in a gloo group (NCCL refuses two ranks on one card): one
    f32 flagship step (``NO_MANHATTAN``) and one f32 RDF-GAN NLSPN step on
    the ranks' halves of a 4-row batch against world 1 on the whole, its
    BatchNorms in the world-2 form (``_dp_net_check``); 4 bf16 flagship
    steps with the six nets bit-equal across the ranks after
    each and the launch counts of world 1 at batch 2; the NLSPN config's
    evaluation of a val split of 6 at batch 2 a rank against world 1's,
    every rank taking the same radius from the probe. ``flagship``,
    ``nlspn`` and ``size`` (the configs and the synthetic batch's plane)
    default to the two published configs at 224x304."""
    import socket

    import numpy as np
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch import train as port_train
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.ops.nlspn_guard import escalate_nlspn_cfg
    from rdfc_gan_torch.tools.make_nyuv2_fixture import write_fixture
    from rdfc_gan_torch.utils import set_random_seed
    from rdfc_gan_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        print(gpu_line())
    flagship = flagship or os.path.join(ROOT, "configs",
                                        "rdf_cycle_patchgan_config.yaml")
    nlspn = nlspn or os.path.join(ROOT, "configs",
                                  "rdf_gan_nlspn_config.yaml")
    dp = os.path.join(workdir, "dp")
    root = os.path.join(dp, "nyu")
    write_fixture(root, n_train=DP_TRAIN, n_test=DP_TEST, seed=0)

    def files(config, work, extra=(), dev=device):
        return ["--dataset", "nyuv2", "--data_root", root, "--model_cfg_path",
                config, "--work_dir", os.path.join(dp, work), "--num_workers",
                "2", "--device", dev, *extra]

    # seeded nets and the batches, written for the ranks
    synth = ["--dataset", "synthetic", "--out_height", str(size[0]),
             "--out_width", str(size[1]), "--batch_size", str(B),
             "--device", device]
    fl_cfg = ["--model_cfg_path", flagship, "--work_dir",
              os.path.join(dp, "f")] + synth
    cfg = parse_config(fl_cfg)
    set_random_seed(cfg.seed)
    fpth = os.path.join(dp, "flagship_seeded.pth")
    seeded = build_engine(cfg, is_train=True, steps_per_epoch=16)
    save_checkpoint(seeded.modules, fpth)
    del seeded
    rd_cfg = ["--model_cfg_path", nlspn, "--work_dir",
              os.path.join(dp, "r")] + synth
    gpth = _seeded_nets(parse_config(rd_cfg), dp, device)
    loader = port_train.build_train_loader(parse_config(fl_cfg),
                                           torch.device("cpu"))
    it = iter(loader)
    batches = [next(it) for _ in range(DP_BF16_STEPS)]
    loader.close()
    serve_args = files(nlspn, "serve2", ["--batch_size", str(B),
                                         "--load_from", gpth])
    spec = dict(device=device, batch=batches[0], bf16_batches=batches,
                fpth=fpth, gpth=gpth, flagship_f32=fl_cfg + NO_MANHATTAN,
                flagship_bf16=fl_cfg, rdfgan_f32=rd_cfg, serve=serve_args)
    spec_path = os.path.join(dp, "spec.pt")
    torch.save(spec, spec_path)
    if on_card:
        torch.cuda.empty_cache()

    # world 1 through the launcher, and the two ranks, at once
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    train_w1 = ["--n_epochs", "1", "--batch_size", str(B),
                "--save_interval", "1", "--val_interval", "1000",
                "--log_interval", "1", "--deterministic"]
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "rdfc_gan_torch.train",
         *files(flagship, "launcher", train_w1,
                "cuda" if on_card else "cpu")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ranks = [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
         f"chip_smoke.dp_rank_main({r}, 2, {port}, {spec_path!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    procs = [launcher] + ranks
    try:
        # meanwhile, world 1 without the launcher, then its NLSPN
        # evaluation and RDF-GAN step (the flagship's f32 step, the
        # largest, after the ranks)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            port_train.run(parse_config(files(flagship, "plain", train_w1)))
        w1 = port_test.run(parse_config(files(nlspn, "serve1", [
            "--batch_size", "2", "--load_from", gpth])))
        whole = {k: v.to(device) for k, v in batches[0].items()}
        refs = {"rdfgan_f32": _dp_step(spec["rdfgan_f32"], gpth, whole,
                                       bn_form=True)}
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=420))
            except subprocess.TimeoutExpired:
                fail("a data-parallel process did not end within 420 s")
        for name, p, (_, err) in zip(("launcher", "rank 0", "rank 1"), procs,
                                     outs):
            if p.returncode != 0:
                fail(f"data-parallel {name} exited {p.returncode}:\n"
                     f"{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    a, b = (_flat_leaves(torch.load(os.path.join(dp, w, "epoch_1.pth"),
                                    map_location="cpu", weights_only=True))
            for w in ("launcher", "plain"))
    differ = [k for k, x in a.items() if k not in b or not (
        torch.equal(x, b[k]) if isinstance(x, torch.Tensor) else x == b[k])]
    if differ or set(a) != set(b):
        fail(f"world 1 through torch.distributed.run differs from the plain "
             f"run at {len(differ)} of {len(a)} entries, e.g. {differ[:4]}")
    print(f"  world 1 through torch.distributed.run (1 rank, "
          f"{'NCCL' if on_card else 'gloo'}): the flagship's epoch_1.pth "
          f"after {DP_TRAIN // B} bf16 steps is bit-equal to the plain "
          f"run's, all {len(a)} entries")

    res = [torch.load(os.path.join(dp, f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
    blocks, n_in = res[0]["blocks"], res[0]["n_in"]
    # world 1 references on the whole 4-row batch
    refs["flagship_f32"] = _dp_step(spec["flagship_f32"], fpth, whole,
                                    bn_form=True)
    g_blocks = fused_blocks(build_engine(parse_config(rd_cfg)).modules["G"])
    checks = (("flagship", "flagship_f32", fpth,
               {"conv3x3_fwd_f32": 4 * blocks, "conv3x3_bwd_f32": 4 * blocks,
                "instance_norm_fwd": 8 + n_in,
                "instance_norm_bwd": 8 + n_in}),
              ("RDF-GAN NLSPN", "rdfgan_f32", gpth,
               {"shift_mask_scatter": 1, "shift_mask_gather": 1,
                "nlspn_propagate_x": 1, "nlspn_reverse_chain": 1,
                "shift_correlation": 1, "instance_norm_fwd": 4,
                "instance_norm_bwd": 4, "conv3x3_fwd_f32": 2 * g_blocks,
                "conv3x3_bwd_f32": 2 * g_blocks}))
    problems = []
    for title, key, pth, want in checks:
        losses, grads, state, sec, cls = refs[key]
        (l0, g0, s0, t0, c0), (l1, g1, s1, t1, c1) = res[0][key], \
            res[1][key]
        if cls is not None:
            print(f"    {title}: G_label classes of real_A differing from "
                  f"world 1 at {int((torch.cat([c0, c1]) != cls).sum())} of "
                  f"{cls.numel()} pixels")
        for net in g0:
            for k in g0[net]:
                if not torch.equal(g0[net][k], g1[net][k]):
                    fail(f"{title}: the ranks' gradients of {net}.{k} differ")
            for k in s0[net]:
                if not torch.equal(s0[net][k], s1[net][k]):
                    fail(f"{title}: the ranks' {net}.{k} differ after the "
                         f"step")
        worst_loss = 0.0
        for k, v in losses.items():
            got = (max(l0[k], l1[k]) if k == "nlspn_max_offset"
                   else l0[k] + l1[k])
            worst_loss = max(worst_loss, abs(got - v) / max(abs(v), 1e-30))
            if abs(got - v) > DP_LOSS_RTOL * abs(v) + 1e-7:
                problems.append(f"{title} f32 world 2: {k}={got}, world 1 "
                                f"{v}")
        per_net = {}
        for net in grads:
            # each net's failure is recorded and the phase fails at its end,
            # so one run reports every net
            try:
                per_net[net] = _dp_net_check(
                    f"{title} f32 world 2", net, g0[net], grads[net],
                    s0[net], state[net], 2e-3)
            except SystemExit:
                problems.append(f"{title} {net} (above)")
                per_net[net] = float("nan")
        print(f"  {title} f32 step, world 2 (2 rows a rank) against world 1 "
              f"(4 rows): losses within {worst_loss:.3e} (rtol "
              f"{DP_LOSS_RTOL:g}); worst gradient relative L2 by net "
              + ", ".join(f"{n} {v:.3e}" for n, v in per_net.items())
              + f"; step s: world 1 {sec:.3f}, ranks {t0:.3f} / {t1:.3f}")
        got = [r[key + "_launches"] for r in res]
        print(f"    {title} launches a rank: {got[0]} / {got[1]}")
        if on_card:
            _dp_rank_counts(f"{title} f32 world 2", got, want)
    want = {"conv3x3_fwd": 4 * blocks * DP_BF16_STEPS,
            "conv3x3_bwd": 4 * blocks * DP_BF16_STEPS,
            "instance_norm_fwd": (8 + n_in) * DP_BF16_STEPS,
            "instance_norm_bwd": (8 + n_in) * DP_BF16_STEPS}
    if on_card:
        _dp_rank_counts("flagship bf16 world 2",
                        [r["bf16_launches"] for r in res], want)
    for i, gathered in enumerate(res[0]["bf16_digests"]):
        if gathered[0] != gathered[1] or gathered != \
                res[1]["bf16_digests"][i]:
            fail(f"bf16 step {i}: the ranks' nets differ: "
                 + str([n for n in gathered[0]
                        if gathered[0][n] != gathered[1][n]]))
    still = [n for n, d in res[0]["bf16_moved"].items()
             if res[0]["bf16_seeded"][n] == d]
    if still:
        fail(f"bf16 world 2: {still} did not move")
    print(f"  flagship bf16, world 2: {DP_BF16_STEPS} steps, the six nets "
          f"bit-equal across the ranks after each (sha1 of every tensor), "
          f"all six moved; launches a rank {res[0]['bf16_launches']} / "
          f"{res[1]['bf16_launches']} (world 1 at batch 2: {want}); step s "
          f"rank 0 " + ", ".join(f"{v:.3f}" for v in res[0]["bf16_seconds"])
          + "; rank 1 " + ", ".join(f"{v:.3f}" for v in
                                    res[1]["bf16_seconds"])
          + " (two processes time-sliced on one card: not a scaling number)")
    s0, s1 = res[0]["serve"], res[1]["serve"]
    if s0["max_offset"] != s1["max_offset"] or s0["metrics"] != s1["metrics"]:
        fail(f"world-2 evaluation: the ranks differ: {s0} / {s1}")
    g_cfg = parse_config(serve_args).model.G.to_dict()
    chosen = [escalate_nlspn_cfg(g_cfg, m)[0] for m in
              (w1["max_offset"], s0["max_offset"])]
    if chosen[0] != chosen[1]:
        fail(f"world-2 probe chose {chosen[1]}, world 1 {chosen[0]}")
    for k, v in w1["metrics"].items():
        if not np.isclose(s0["metrics"][k], v, rtol=SERVE_RTOL,
                          atol=SERVE_ATOL):
            fail(f"world-2 evaluation {k}={s0['metrics'][k]}, world 1 {v}")
    for r, sv in enumerate((s0, s1)):
        want_sv, _ = _served_nlspn_counts(g_cfg, sv["max_offset"],
                                          sv["forwards"])
        if on_card and sv["launches"] != want_sv:
            fail(f"world-2 evaluation, rank {r}: launches {sv['launches']}, "
                 f"expected {want_sv}")
    print(f"  NLSPN evaluation of the {DP_TEST} test scenes, world 2 (batch "
          f"2 a rank, pad rows gathered and dropped) against world 1: "
          + ", ".join(f"{k}={v:.6g}" for k, v in s0["metrics"].items())
          + f" (rtol {SERVE_RTOL:g}); probe max|offset| "
          f"{s0['max_offset']:.4f} on both ranks (world 1 "
          f"{w1['max_offset']:.4f}), the same radius; forwards a rank "
          f"{s0['forwards']}, launches {s0['launches']} / {s1['launches']}")
    print(f"  data-parallel phase wall {time.perf_counter() - t_phase:.2f} s")
    if problems:
        fail("data-parallel f32 steps against world 1: "
             + "; ".join(problems))


# width-sharded serving (spatial_phase): the served batch and plane; the
# published NYUv2 crop at the served batch, whose deeper levels (152, 76,
# 38, 19, 10 columns) do not split evenly over 2 or 4 ranks; the forwards
# each pool of ranks runs (by world size): (grid, net, --depth_only
# settings), a net's "_crop" serving the crop; the timed forwards
SPATIAL_B, SPATIAL_SIZE = 2, (480, 640)
CROP_B, CROP_SIZE = 4, (224, 304)
SPATIAL_JOBS = {2: (({"model": 2}, "flagship", (False, True)),
                    ({"model": 2}, "nlspn", (False,)),
                    ({"model": 2}, "flagship_crop", (False, True)),
                    ({"model": 2}, "nlspn_crop", (False,))),
                4: (({"model": 4}, "flagship", (False, True)),
                    ({"data": 2, "model": 2}, "flagship", (False, True)),
                    ({"model": 4}, "flagship_crop", (False,)))}
SPATIAL_REPS = 5
SPLIT = ("instance_norm_moments", "instance_norm_apply")


def _mesh_label(mesh) -> str:
    return "x".join(f"{k}{v}" for k, v in mesh.items())


def _ulps(a, b) -> int:
    """The largest distance in f32 units in the last place between two f32
    tensors of one sign."""
    import torch

    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    return int((ia - ib).abs().max())


def _host_ms(fn, reps: int = 100) -> float:
    """The host's time (ms) to issue one call of ``fn``, over ``reps``
    calls issued back to back (the device runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return host


def _device_kernels(fn):
    """The names of the device kernels one call of ``fn`` runs, in order,
    from the profiler (tried three times; None where every session came
    back with no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            prof.events(), key=lambda e: e.time_range.start)
            if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return None


def in_split_phase():
    """The IN forward's split for width-sharded planes: the moments and
    apply kernels (y and the scale a) bit for bit against their plain
    versions at the four W-AdaIN planes of a 2x480x640 forward, whole and
    as M = 2 and M = 4 shards, f32 and bf16; their M = 1 composition bit
    for bit against the forward kernel (#7); the M-shard scale beside #7's;
    the M = 1 composition on a shard two launches and no other device
    kernel (launch counts and the profiler). Times at the M = 2 shard (a
    rank's launch), f32, per plane: CUDA events over a burst of one tensor
    (the three smaller planes fit the 50 MB L2, so a device time under a
    plane's HBM bound is marked L2), the profiler's device time and the
    host's time to issue a call, beside #7 on that shard, the M = 1
    composition and ``torch.var_mean`` / ``torch.addcmul``. Returns the
    two kernel rows, each time summed over the four planes."""
    import torch

    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.ops.kernels import norm_kernel as nk

    shapes = tuple((SPATIAL_B,) + s[1:] for s in fuse_in_shapes(
        *SPATIAL_SIZE))
    print(f"instance norm split (moments + apply) at the W-AdaIN planes of "
          f"{SPATIAL_B}x{SPATIAL_SIZE[0]}x{SPATIAL_SIZE[1]}: {shapes}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    acc = {k: collections.defaultdict(float) for k in SPLIT}
    whole = collections.defaultdict(float)
    for shape in shapes:
        x32 = torch.randn(shape, device="cuda", generator=gen) * 3 + 1.5
        B_, C_, h, w = shape
        worst = {}
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            y7, a7 = nk.instance_norm_fwd(x, 1e-5)
            y1, a1 = nk.instance_norm_fwd_sharded(x, 1e-5)
            compare(f"M=1 composition y {shape} {dt} vs #7", y1, y7, 0.0,
                    0.0, quiet=True)
            compare(f"M=1 composition a {shape} {dt} vs #7", a1, a7, 0.0,
                    0.0, quiet=True)
            for M in (1, 2, 4):
                cols = w // M
                parts = [x[..., m * cols:(m + 1) * cols].contiguous()
                         for m in range(M)]
                sums = [nk.instance_norm_moments(p) for p in parts]
                for m, (p, s) in enumerate(zip(parts, sums)):
                    acc[SPLIT[0]]["err"] = max(acc[SPLIT[0]]["err"], compare(
                        f"instance_norm_moments {shape} {dt} M={M} m={m}", s,
                        nk.instance_norm_moments_plain(p), 0.0, 0.0,
                        quiet=True))
                total = sums[0]
                for s in sums[1:]:
                    total = total + s
                for m, p in enumerate(parts):
                    y, a = nk.instance_norm_apply(p, total, h * w, 1e-5)
                    py, pa = nk.instance_norm_apply_plain(p, total, h * w,
                                                          1e-5)
                    for what, got, want in (("y", y, py), ("a", a, pa)):
                        acc[SPLIT[1]]["err"] = max(
                            acc[SPLIT[1]]["err"], compare(
                                f"instance_norm_apply {what} {shape} {dt} "
                                f"M={M} m={m}", got, want, 0.0, 0.0,
                                quiet=True))
                    worst[M] = max(worst.get(M, 0), _ulps(a, a7))
                if worst[M] > 1:
                    fail(f"instance norm split {shape} {dt} M={M}: the "
                         f"scale is {worst[M]} ulps from #7's")
        # a rank's launches at the M = 2 shard, f32 (as served)
        xs = x32[..., :w // 2].contiguous()
        n_el, planes, ns = xs.numel(), B_ * C_, h * w // 2
        s = nk.instance_norm_moments(xs)
        a, b = nk.instance_norm_finalize(s, ns, 1e-5)
        a4, b4 = a[:, :, None, None], b[:, :, None, None]
        build.reset_launches()
        nk.instance_norm_fwd_sharded(xs, 1e-5)
        counts = dict(build.LAUNCHES)
        if counts != {SPLIT[0]: 1, SPLIT[1]: 1}:
            fail(f"the M=1 split at {tuple(xs.shape)} launched {counts}")
        names = _device_kernels(lambda: nk.instance_norm_fwd_sharded(xs,
                                                                     1e-5))
        if names is not None and (
                len(names) != 2 or "instance_norm_moments_kernel" not in
                names[0] or "instance_norm_apply_kernel" not in names[1]):
            fail(f"the M=1 split at {tuple(xs.shape)} ran device kernels "
                 f"{names}, not moments then apply")
        fns = dict(moments=lambda: nk.instance_norm_moments(xs),
                   apply=lambda: nk.instance_norm_apply(xs, s, ns, 1e-5),
                   split=lambda: nk.instance_norm_fwd_sharded(xs, 1e-5),
                   fwd=lambda: nk.instance_norm_fwd(xs, 1e-5),
                   var_mean=lambda: torch.var_mean(xs, dim=(2, 3)),
                   addcmul=lambda: torch.addcmul(b4, xs, a4))
        t = {k: time_ms(f) for k, f in fns.items()}
        d = {k: _device_ms(f, n=10) for k, f in fns.items()}
        host = {k: _host_ms(fns[k]) for k in ("moments", "apply",
                                              "var_mean", "addcmul")}
        t["moments_plain"] = time_ms(
            lambda: nk.instance_norm_moments_plain(xs), reps=3, warmup=1)
        t["apply_plain"] = time_ms(
            lambda: nk.instance_norm_apply_plain(xs, s, ns, 1e-5))
        # f64: a convert, an add, a multiply and an add an element (at the
        # f32 rate, as the forward's row counts them); apply: a multiply
        # and an add, reading each plane's two f64 sums and writing its a
        cost = {SPLIT[0]: (n_el * 4 + planes * 16,
                           n_el * 4.0 * PEAK_F32_FLOPS / PEAK_F64_FLOPS),
                SPLIT[1]: (2 * n_el * 4 + planes * (16 + 4), 2.0 * n_el)}
        marks = {}
        for name, key, lib in ((SPLIT[0], "moments", "var_mean"),
                               (SPLIT[1], "apply", "addcmul")):
            r = acc[name]
            r["ms"] += t[key]
            r["device_ms"] += d[key]
            r["host_ms"] += host[key]
            r["plain_ms"] += t[key + "_plain"]
            r["library_ms"] += t[lib]
            r["library_device_ms"] += d[lib]
            r["library_host_ms"] += host[lib]
            r["bytes"] += cost[name][0]
            r["ops"] += cost[name][1]
            hbm = cost[name][0] / PEAK_BYTES_S * 1e3
            marks[key] = " (L2: under its HBM bound)" if d[key] < hbm else ""
        for k in ("split", "fwd"):
            whole[k] += t[k]
            whole[k + "_device"] += d[k]
        print(f"  {shape}: M=1 composition = #7 bit for bit; moments and "
              f"apply (y, a) = plain bit for bit at M=1, 2, 4, f32 and "
              f"bf16; scale a vs #7's: "
              + ", ".join(f"M={M} {u} ulp" for M, u in worst.items()))
        print(f"    M=2 shard {tuple(xs.shape)}, ms events / device / host "
              f"a call: moments {t['moments']:.4f} / {d['moments']:.4f} / "
              f"{host['moments']:.4f}{marks['moments']}, var_mean "
              f"{t['var_mean']:.4f} / {d['var_mean']:.4f} / "
              f"{host['var_mean']:.4f}; apply {t['apply']:.4f} / "
              f"{d['apply']:.4f} / {host['apply']:.4f}{marks['apply']}, "
              f"addcmul {t['addcmul']:.4f} / {d['addcmul']:.4f} / "
              f"{host['addcmul']:.4f}; the M=1 split (launches {counts}, "
              f"device kernels {names or 'not seen by the profiler'}) "
              f"{t['split']:.4f} / {d['split']:.4f}, #7 {t['fwd']:.4f} / "
              f"{d['fwd']:.4f}")
    rows = {}
    for name in SPLIT:
        r = acc[name]
        bnd, by = bound_ms(r["bytes"], r["ops"])
        rows[name] = dict(
            name=name, route="cuda",
            source="rdfc_gan_torch/csrc/instance_norm.cu",
            replaces="attic/norm_kernel.py:211", max_abs_err=r["err"],
            ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound_ms=bnd, bound_by=by, library_ms=r["library_ms"])
        lib = "torch.var_mean" if name == SPLIT[0] else "torch.addcmul"
        print(f"  {name}, the four planes at the M=2 shard: kernel events "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} "
              f"({_pct(bnd, r['device_ms'])} of the bound), host "
              f"{r['host_ms']:.4f}; plain {r['plain_ms']:.4f} ms; library "
              f"({lib}) events {r['library_ms']:.4f}, device "
              f"{r['library_device_ms']:.4f}, host "
              f"{r['library_host_ms']:.4f}; bound {bnd:.4f} ms ({by})")
    print(f"  the M=1 split on the four shards (moments + apply, no "
          f"collective): events {whole['split']:.4f} ms, device "
          f"{whole['split_device']:.4f}; #7 on the same shards: events "
          f"{whole['fwd']:.4f}, device {whole['fwd_device']:.4f}")
    _in_split_uneven(gen, acc)
    for name in SPLIT:
        rows[name]["max_abs_err"] = acc[name]["err"]
    return rows


def _in_split_uneven(gen, acc):
    """Moments and apply at the shards the published crop's W-AdaIN planes
    (``CROP_B`` x ``CROP_SIZE``) give over M = 2 and 4, in the layout of
    uneven shards (ceil(w / M) columns a rank; 19 columns over 4 are 5, 5,
    5 and 4): bit for bit against their plain versions, f32 and bf16, the
    edge rank's padded columns zeroed before its moments as
    ``instance_norm_fwd_sharded`` zeroes them, and the scale within one
    ulp of #7's on the whole plane. The worst differences go into
    ``acc``."""
    import torch
    import torch.nn.functional as F

    from rdfc_gan_torch.ops.kernels import norm_kernel as nk

    shapes = tuple((CROP_B,) + s[1:] for s in fuse_in_shapes(*CROP_SIZE))
    worst = {}
    for shape in shapes:
        x32 = torch.randn(shape, device="cuda", generator=gen) * 3 + 1.5
        h, w = shape[2:]
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            a7 = nk.instance_norm_fwd(x, 1e-5)[1]
            for M in (2, 4):
                c = -(-w // M)
                parts = []
                for m in range(M):
                    own = x[..., m * c:(m + 1) * c]
                    parts.append(F.pad(own, (0, c - own.shape[3])))
                sums = [nk.instance_norm_moments(p) for p in parts]
                total = sums[0]
                for p, s in zip(parts, sums):
                    acc[SPLIT[0]]["err"] = max(acc[SPLIT[0]]["err"], compare(
                        f"instance_norm_moments {shape} {dt} M={M} shard "
                        f"{tuple(p.shape)}", s,
                        nk.instance_norm_moments_plain(p), 0.0, 0.0,
                        quiet=True))
                for s in sums[1:]:
                    total = total + s
                for m, p in enumerate(parts):
                    y, a = nk.instance_norm_apply(p, total, h * w, 1e-5)
                    py, pa = nk.instance_norm_apply_plain(p, total, h * w,
                                                          1e-5)
                    for what, got, want in (("y", y, py), ("a", a, pa)):
                        acc[SPLIT[1]]["err"] = max(
                            acc[SPLIT[1]]["err"], compare(
                                f"instance_norm_apply {what} {shape} {dt} "
                                f"M={M} m={m}", got, want, 0.0, 0.0,
                                quiet=True))
                    u = _ulps(a, a7)
                    if u > 1:
                        fail(f"instance norm split {shape} {dt} M={M}: the "
                             f"scale is {u} ulps from #7's")
                    worst[M] = max(worst.get(M, 0), u)
    print(f"  uneven shards of the W-AdaIN planes of {CROP_B}x"
          f"{CROP_SIZE[0]}x{CROP_SIZE[1]} {shapes} (ceil(w / M) columns a "
          f"rank, the edge rank's padding zeroed): moments and apply (y, a) "
          f"= plain bit for bit at M=2, 4, f32 and bf16; scale a vs #7's: "
          + ", ".join(f"M={M} {u} ulp" for M, u in worst.items()))


def _spatial_forward(engine, batch, grid, depth_only, device):
    """One forward of ``engine`` on ``batch`` (this data row's rows, or the
    whole batch without a grid); synchronized."""
    out = engine.forward_test(rgb=batch["rgb"], raw_depth=batch["raw_depth"],
                              depth_only=depth_only, grid=grid)
    _sync(device)
    return out


def _spatial_measure(engine, batch, grid, depth_only, device):
    """A warm-up forward, one counted (launches, bytes exchanged, peak
    memory; its outputs on the host) and SPATIAL_REPS timed (host clock,
    each synchronized)."""
    import torch

    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.parallel import halo

    on_card = torch.device(device).type == "cuda"
    _spatial_forward(engine, batch, grid, depth_only, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    build.reset_launches()
    halo.reset_stats()
    out = _spatial_forward(engine, batch, grid, depth_only, device)
    res = dict(out={k: v.float().cpu() for k, v in out.items()},
               launches=dict(build.LAUNCHES), exchanged=dict(halo.STATS),
               base=base,
               peak=torch.cuda.max_memory_allocated() if on_card else 0)
    ms = []
    for _ in range(SPATIAL_REPS):
        t0 = time.perf_counter()
        _spatial_forward(engine, batch, grid, depth_only, device)
        ms.append((time.perf_counter() - t0) * 1e3)
    res["ms"] = ms
    return res


@contextlib.contextmanager
def _block_inputs(G, seen: dict, use=None):
    """Record the inputs of G's NLSPN block in ``seen`` (under a grid: the
    row's gathered width), on the host; with ``use``, run the block on
    those tensors instead of its own."""
    block = G._nlspn_block

    def recorded(*inputs):
        if use is not None:
            inputs = [t.to(inputs[0].device) for t in use]
        seen["inputs"] = [t.float().cpu() for t in inputs]
        return block(*inputs)

    G._nlspn_block = recorded
    try:
        yield
    finally:
        del G._nlspn_block


def _wait_for(path: str, timeout: float = 600):
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError(f"{path} did not appear within {timeout} s")
        time.sleep(0.2)


def _spatial_engine(spec, net):
    """The serving engine of ``spec``'s ``net`` (its size in its args),
    loaded from the seeded checkpoint of its config."""
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    engine = build_engine(parse_config(spec["args"][net]))
    load_checkpoint(engine.modules, spec["pth"][net.split("_")[0]])
    return engine


def spatial_rank_main(rank: int, world: int, port: int, spec_path: str):
    """One rank of ``spatial_phase``: a gloo group of ``world`` ranks on the
    spec's device. Waits for its turn (a file), then runs its pool's
    forwards (``SPATIAL_JOBS``), each ``_spatial_measure``d; the two-rank
    pool then serves ``rdfc_gan_torch.test`` with the spec's sharded
    config. Writes its results beside the spec."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.parallel import rank_rows
    from rdfc_gan_torch.parallel.grid import make_grid

    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    here = os.path.dirname(spec_path)
    out = {}
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            grids = {}
            engine, engine_net = None, None
            _wait_for(os.path.join(here, spec["after"][world]))
            t0 = time.perf_counter()
            for mesh, net, depth_onlys in SPATIAL_JOBS[world]:
                label = _mesh_label(mesh)
                if label not in grids:
                    grids[label] = make_grid(mesh)
                grid = grids[label]
                if net != engine_net:
                    engine = None
                    engine, engine_net = _spatial_engine(spec, net), net
                rb = {k: rank_rows(v, grid.d, grid.D).to(dev)
                      for k, v in spec["batch"][net].items()}
                for depth_only in depth_onlys:
                    res = out[(label, net, depth_only)] = _spatial_measure(
                        engine, rb, grid, depth_only, dev)
                if net.startswith("nlspn"):
                    seen = {}
                    with _block_inputs(engine.modules["G"], seen):
                        _spatial_forward(engine, rb, grid, False, dev)
                    res["block_inputs"] = seen["inputs"]
            del engine
            if world == 2:
                build.reset_launches()
                res = port_test.run(parse_config(spec["cli"]))
                out["cli"] = dict(metrics=res["metrics"],
                                     forwards=res["forwards"],
                                     launches=dict(build.LAUNCHES))
            out["seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(here, f"w{world}_rank{rank}.pt"))
    finally:
        dist.barrier()
        if rank == 0:
            open(os.path.join(here, f"w{world}.done"), "w").close()
        dist.destroy_process_group()


def _nlspn_block_check(title, engine, net, inputs, ref, got, spec, device):
    """The NLSPN block of a sharded forward: its inputs (the row's gathered
    guide, confidence, initial depth and raw depth) against the unsharded
    forward's at SERVE_RTOL / SERVE_ATOL; then the unsharded forward run
    with its block fed those same inputs, which the sharded outputs must
    match at that tolerance (returned as the reference). The seeded
    affinities make the T-step chain amplify its input's rounding (its
    output grows thousands-fold), so the plain unsharded forward's
    depth_map_2 is printed beside it, not held."""
    import torch

    for name, a, b in zip(("guide", "confidence", "pred_init",
                           "origin_depth"), inputs, ref["block_inputs"]):
        compare(f"{title} NLSPN block input {name}", a, b, SERVE_RTOL,
                SERVE_ATOL)
    b = {k: v.to(device) for k, v in spec["batch"][net].items()}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False), \
            _block_inputs(engine.modules["G"], {}, use=inputs):
        out = _spatial_forward(engine, b, None, False, device)
    fed = dict(ref, out={k: v.float().cpu() for k, v in out.items()})
    d_in = max(float((a - b_).abs().max()) for a, b_ in
               zip(inputs, ref["block_inputs"]))
    d_out = float((got["depth_map_2"] - ref["out"]["depth_map_2"]).abs()
                  .max())
    print(f"  {title}: the block's inputs within {d_in:.3e} of the "
          f"unsharded forward's; depth_map_2 against the unsharded forward "
          f"{d_out:.3e} (the chain's amplification, not held); held below "
          f"against the unsharded forward with the same block inputs")
    return fed


def spatial_phase(workdir, device="cuda:0", flagship=None, nlspn=None,
                  size=SPATIAL_SIZE, crop=CROP_SIZE):
    """Width-sharded serving on the one card (the JAX spatial_sharding).
    Ranks run on ``device`` in gloo groups the phase makes (NCCL refuses two
    ranks on one card): a pool of 2 ranks and one of 4, started at once,
    each a ``python -c "...spatial_rank_main(...)"`` process, taking turns
    through files (this process's references first, then the 2-rank pool,
    then the 4-rank one) so that their timed forwards do not overlap. The
    flagship (seeded, f32, no TF32, deterministic cuDNN) at
    ``SPATIAL_B`` x ``size`` on {model: 2}, {model: 4} and {data: 2, model:
    2}, in full and ``--depth_only``, and the NLSPN config on {model: 2};
    at ``CROP_B`` x ``crop`` (the published 224x304, whose deeper levels
    split unevenly: the last rank's columns past a level's width are
    padding) the flagship on {model: 2} in full and ``--depth_only`` and
    on {model: 4}, and the NLSPN config on {model: 2} (``SPATIAL_JOBS``):
    each rank's shards assembled and held against the unsharded forward at
    SERVE_RTOL / SERVE_ATOL; a sharded flagship forward launches the IN
    split's moments and apply 4 times each and #7 never on every rank
    (NLSPN: also #1 and #3 once), the unsharded one #7 4 times;
    ``rdfc_gan_torch.test`` with mesh_shape {data: 1, model: 2} gives the
    world-1 metrics. Prints the per-rank peak memory at M = 1, 2 and 4, the
    bytes exchanged a forward, the median ms of SPATIAL_REPS forwards after
    a warm-up (time-sliced ranks on one card: not a scaling result) and
    the phase's seconds (a rank holds the flagship's and the NLSPN config's
    weights). Returns rank 0's launch counts of one {model: 2} flagship
    forward. ``flagship``, ``nlspn``, ``size`` and ``crop`` default to the
    two published configs at 480x640 and 224x304."""
    import socket

    import numpy as np
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.utils import set_random_seed
    from rdfc_gan_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        print(gpu_line())
    flagship = flagship or os.path.join(ROOT, "configs",
                                        "rdf_cycle_patchgan_config.yaml")
    nlspn = nlspn or os.path.join(ROOT, "configs",
                                  "rdf_gan_nlspn_config.yaml")
    sp = os.path.join(workdir, "spatial")
    os.makedirs(sp, exist_ok=True)

    def args(config, work, bs=SPATIAL_B, hw=size):
        return ["--dataset", "synthetic", "--model_cfg_path", config,
                "--work_dir", os.path.join(sp, work), "--out_height",
                str(hw[0]), "--out_width", str(hw[1]), "--batch_size",
                str(bs), "--num_workers", "2", "--device", device]

    spec = dict(device=device, args=dict(
        flagship=args(flagship, "f"), nlspn=args(nlspn, "n"),
        flagship_crop=args(flagship, "fc", CROP_B, crop),
        nlspn_crop=args(nlspn, "nc", CROP_B, crop)),
        pth={}, batch={}, after={2: "main.done", 4: "w2.done"})
    cfg = parse_config(spec["args"]["flagship"])
    set_random_seed(cfg.seed)
    engine = build_engine(cfg)
    spec["pth"]["flagship"] = os.path.join(sp, "flagship.pth")
    save_checkpoint(engine.modules, spec["pth"]["flagship"])
    del engine
    cfgn = parse_config(spec["args"]["nlspn"])
    spec["pth"]["nlspn"] = _seeded_nets(cfgn, sp, device)
    for net in spec["args"]:
        loader = port_test.build_val_loader(
            parse_config(spec["args"][net]), torch.device("cpu"))
        spec["batch"][net] = next(iter(loader))
    # rdfc_gan_torch.test's config: the flagship's with a model axis of 2
    sharded_yaml = os.path.join(sp, "sharded.yaml")
    with open(flagship) as f, open(sharded_yaml, "w") as g:
        g.write(f.read() + "\nmesh_shape: {data: 1, model: 2}\n")
    cli_w1 = args(flagship, "cli1", 4) + ["--depth_only"]
    spec["cli"] = args(sharded_yaml, "cli2", 4) + ["--depth_only"]
    spec_path = os.path.join(sp, "spec.pt")
    torch.save(spec, spec_path)
    if on_card:
        torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for world in SPATIAL_JOBS:
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        procs += [(world, r, subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
             f"chip_smoke.spatial_rank_main({r}, {world}, {port}, "
             f"{spec_path!r})"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)) for r in range(world)]
    try:
        # meanwhile: the world-1 rdfc_gan_torch.test run and the unsharded
        # references
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            w1 = port_test.run(parse_config(cli_w1))
            refs, nlspn_engines = {}, {}
            for net in spec["args"]:
                engine = _spatial_engine(spec, net)
                b = {k: v.to(device) for k, v in spec["batch"][net].items()}
                for depth_only in sorted({d for jobs in SPATIAL_JOBS.values()
                                          for _, n, ds in jobs if n == net
                                          for d in ds}):
                    refs[(net, depth_only)] = _spatial_measure(
                        engine, b, None, depth_only, device)
                if net.startswith("nlspn"):
                    seen = {}
                    with _block_inputs(engine.modules["G"], seen):
                        _spatial_forward(engine, b, None, False, device)
                    refs[(net, False)]["block_inputs"] = seen["inputs"]
                    nlspn_engines[net] = engine
                del engine
        if on_card:
            torch.cuda.empty_cache()
        open(os.path.join(sp, "main.done"), "w").close()
        outs = []
        for world, r, p in procs:
            try:
                outs.append(p.communicate(timeout=600))
            except subprocess.TimeoutExpired:
                fail("a width-sharding rank did not end within 600 s")
        for (world, r, p), (_, err) in zip(procs, outs):
            if p.returncode != 0:
                fail(f"width-sharding world {world} rank {r} exited "
                     f"{p.returncode}:\n{err[-4000:]}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = {world: [torch.load(os.path.join(sp, f"w{world}_rank{r}.pt"),
                              weights_only=False) for r in range(world)]
           for world in SPATIAL_JOBS}

    def mib(n):
        return f"{n / 2**20:.1f}"

    print(f"width-sharded serving (gloo ranks time-sliced on one card: "
          f"times are not a scaling result), batch {SPATIAL_B} at "
          f"{size[0]}x{size[1]} and (the nets named _crop) batch {CROP_B} "
          f"at {crop[0]}x{crop[1]}, f32, deterministic cuDNN, no TF32:")
    want_unsharded = {"instance_norm_fwd": 4}
    for (net, depth_only), r in refs.items():
        want = dict(want_unsharded)
        if net.startswith("nlspn"):
            want.update(shift_mask_scatter=1, nlspn_propagate=1)
        if on_card and r["launches"] != want:
            fail(f"unsharded {net}: launches {r['launches']}, expected "
                 f"{want}")
        print(f"  M=1 {net}{' --depth_only' if depth_only else ''}: peak "
              f"{mib(r['peak'])} MiB ({mib(r['base'])} resident before the "
              f"forward), median {np.median(r['ms']):.3f} ms "
              f"({', '.join(f'{v:.1f}' for v in r['ms'])}), launches "
              f"{r['launches']}")
    split_counts = None
    for world, ranks in res.items():
        for mesh, net, depth_onlys in SPATIAL_JOBS[world]:
            label = _mesh_label(mesh)
            D, M = mesh.get("data", 1), mesh["model"]
            for key in [(label, net, d) for d in depth_onlys]:
                depth_only = key[2]
                ref = refs[(net, depth_only)]
                title = (f"{label} {net}"
                         f"{' --depth_only' if depth_only else ''}")
                got = {k: torch.cat([torch.cat(
                    [ranks[d * M + m][key]["out"][k] for m in range(M)], 3)
                    if ranks[0][key]["out"][k].dim() == 4 else
                    ranks[d * M][key]["out"][k] for d in range(D)])
                    if ranks[0][key]["out"][k].dim() == 4 else
                    ranks[0][key]["out"][k] for k in ranks[0][key]["out"]}
                if set(got) != set(ref["out"]):
                    fail(f"{title}: outputs {sorted(got)}, unsharded "
                         f"{sorted(ref['out'])}")
                if net.startswith("nlspn"):
                    ref = _nlspn_block_check(
                        title, nlspn_engines[net], net,
                        ranks[0][key]["block_inputs"], ref, got, spec,
                        device)
                errs = []
                for k, v in ref["out"].items():
                    if v.dim() == 4:
                        errs.append(f"{k} {compare(f'{title} {k}', got[k], v, SERVE_RTOL, SERVE_ATOL, quiet=True):.2e}")
                want = {n: 4 for n in SPLIT}
                if net.startswith("nlspn"):
                    want.update(shift_mask_scatter=1, nlspn_propagate=1)
                for r_, rk in enumerate(ranks):
                    if on_card and rk[key]["launches"] != want:
                        fail(f"{title}: rank {r_} launched "
                             f"{rk[key]['launches']}, expected {want}")
                if key == ("model2", "flagship", False):
                    split_counts = ranks[0][key]["launches"]
                x = ranks[0][key]["exchanged"]
                med = [np.median(rk[key]["ms"]) for rk in ranks]
                print(f"  {title}: max_abs_err vs unsharded {', '.join(errs)}"
                      f" (rtol {SERVE_RTOL:g}, atol {SERVE_ATOL:g}); peak a "
                      f"rank {', '.join(mib(rk[key]['peak']) for rk in ranks)}"
                      f" MiB ({mib(ranks[0][key]['base'])} resident before "
                      f"the forward); exchanged by rank 0 a forward: halo "
                      f"{x.get('halo_bytes', 0) / 2**20:.3f} MiB in "
                      f"{x.get('halo_calls', 0)} calls, gathered "
                      f"{x.get('gather_bytes', 0) / 2**20:.3f} MiB in "
                      f"{x.get('gather_calls', 0)}, reduced "
                      f"{x.get('reduce_bytes', 0) / 2**10:.3f} KiB in "
                      f"{x.get('reduce_calls', 0)}; median ms a rank "
                      f"{', '.join(f'{v:.1f}' for v in med)}; launches a rank "
                      f"{ranks[0][key]['launches']}")
        print(f"  the {world}-rank pool's grids took "
              f"{max(rk['seconds'] for rk in ranks):.2f} s")
    d0, d1 = (r["cli"] for r in res[2])
    if d0["metrics"] != d1["metrics"]:
        fail(f"sharded rdfc_gan_torch.test: the ranks' metrics differ: "
             f"{d0} / {d1}")
    for k, v in w1["metrics"].items():
        if not np.isclose(d0["metrics"][k], v, rtol=SERVE_RTOL,
                          atol=SERVE_ATOL):
            fail(f"sharded rdfc_gan_torch.test {k}={d0['metrics'][k]}, "
                 f"world 1 {v}")
    if on_card and d0["launches"] != {n: 4 * d0["forwards"] for n in SPLIT}:
        fail(f"sharded rdfc_gan_torch.test: launches {d0['launches']} for "
             f"{d0['forwards']} forwards")
    print(f"  rdfc_gan_torch.test --depth_only, mesh_shape {{data: 1, model: "
          f"2}}, {len(w1['batch_seconds'])} batches of 4 at {size[0]}x"
          f"{size[1]}: " + ", ".join(f"{k}={v:.6g}" for k, v in
                                    d0["metrics"].items())
          + f" = world 1 within rtol {SERVE_RTOL:g}; launches a rank "
          f"{d0['launches']} for {d0['forwards']} forwards")
    print(f"  width-sharding phase wall {time.perf_counter() - t_phase:.2f} s")
    return split_counts


# the loading host of an exported program: torch and the kernels' ops,
# nothing else of the port. argv: the .pt2, the inputs file, the outputs
# file. One forward counted, then 20 timed (each synchronized), after 3
# warm-up forwards, under deterministic cuDNN and no TF32, as the engine
# serves.
EXPORT_LOADER = """
import json, sys, time
import torch
import rdfc_gan_torch.ops.kernels
from rdfc_gan_torch.ops.kernels import build
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
ep = torch.export.load(sys.argv[1])
serve = ep.module()
load_s = time.perf_counter() - t0
rgb, raw = (t.cuda() for t in torch.load(sys.argv[2]))
with torch.no_grad():
    build.reset_launches()
    out = serve(rgb, raw)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    for _ in range(3):
        serve(rgb, raw)
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        serve(rgb, raw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[3])
print(json.dumps(dict(
    counts=counts, ms=ms, load_s=load_s, state=sorted(ep.state_dict),
    modules=sorted(m for m in sys.modules if m.startswith("rdfc_gan_torch")),
    device=torch.cuda.get_device_name(0))))
"""
EXPORT_RTOL = EXPORT_ATOL = 2e-5


def _ms_stats(ms):
    import numpy as np

    return float(np.median(ms)), float(np.percentile(ms, 90))


def export_phase(workdir):
    """``python -m rdfc_gan_torch.tools.export_model``'s code path (``run``,
    the body of its ``main``) with ``--check`` at 4x224x304, three times:
    the flagship in full and with ``--depth_only`` (seeded random weights)
    and the NLSPN config (the serve phase's seeded G, its offsets scaled
    to TARGET_MAX_OFFSET on the sample batch, through ``--load_from``).
    Each ``.pt2`` is loaded in a fresh process that imports only torch and
    ``rdfc_gan_torch.ops.kernels`` and run on the card; its outputs are
    held against the live ``forward_test`` (rtol = atol = 2e-5), its
    launches a forward counted (#7 four times, #1 and #3 once for NLSPN),
    the depth-only file checked for G_label weights; export seconds,
    artifact MB and the median and p90 ms of 20 forwards, exported against
    live, printed. Deterministic cuDNN throughout."""
    import torch

    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.ops.kernels import build
    from rdfc_gan_torch.tools import export_model

    t_phase = time.perf_counter()
    nlspn_cfg = os.path.join(ROOT, "configs", "rdf_gan_nlspn_config.yaml")
    flagship_cfg = os.path.join(ROOT, "configs",
                                "rdf_cycle_patchgan_config.yaml")
    rgb, raw = export_model.sample_inputs(B, H, W, 0, "cuda")
    cfg = parse_config(["--model_cfg_path", nlspn_cfg, "--work_dir",
                        workdir, "--out_height", str(H), "--out_width",
                        str(W), "--device", "cuda"])
    g = _seeded_generator(cfg, "cuda", dict(rgb=rgb, raw_depth=raw))
    g_pth = os.path.join(workdir, "export_G.pth")
    torch.save({"G_state_dict": g.state_dict()}, g_pth)
    del g
    in_per_forward = {"instance_norm_fwd": 4}
    cases = (("flagship", flagship_cfg, (), in_per_forward),
             ("flagship --depth_only", flagship_cfg, ("--depth_only",),
              in_per_forward),
             ("nlspn", nlspn_cfg, ("--load_from", g_pth),
              {**in_per_forward, "shift_mask_scatter": 1,
               "nlspn_propagate": 1}))
    print(f"export: {gpu_line()}")
    for title, cfg_path, extra, want_counts in cases:
        out = os.path.join(workdir, title.replace(" --", "_") + ".pt2")
        argv = ["--model_cfg_path", cfg_path, "--out", out, "--batch_size",
                str(B), "--out_height", str(H), "--out_width", str(W),
                "--device", "cuda", "--check", *extra]
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            res = export_model.run(argv)
            engine = res["engine"]
            depth_only = "--depth_only" in extra
            nodes = collections.Counter(
                str(n.target) for n in res["program"].graph.nodes
                if str(n.target).startswith(build.OP_NAMESPACE))
            live = engine.forward_test(rgb=rgb, raw_depth=raw,
                                       depth_only=depth_only)
            live_ms = []
            for _ in range(3):
                engine.forward_test(rgb=rgb, raw_depth=raw,
                                    depth_only=depth_only)
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.forward_test(rgb=rgb, raw_depth=raw,
                                    depth_only=depth_only)
                torch.cuda.synchronize()
                live_ms.append((time.perf_counter() - t0) * 1e3)
        export_s, export_mb = res["seconds"], res["bytes"] / 1e6
        inputs = os.path.join(workdir, "export_inputs.pt")
        outputs = os.path.join(workdir, "export_outputs.pt")
        torch.save((rgb.cpu(), raw.cpu()), inputs)
        del res, engine
        torch.cuda.empty_cache()
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_LOADER, out, inputs, outputs],
            cwd=workdir, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"export {title}: the loading process failed:\n"
                 f"{proc.stderr[-3000:]}")
        info = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.load(outputs)
        if set(got) != set(live):
            fail(f"export {title}: outputs {sorted(got)}, live "
                 f"{sorted(live)}")
        errs = {k: compare(f"export {title} {k}, loaded program vs live",
                           got[k].cuda(), live[k], EXPORT_RTOL, EXPORT_ATOL,
                           quiet=True) for k in sorted(live)}
        med, p90 = _ms_stats(info["ms"])
        lmed, lp90 = _ms_stats(live_ms)
        print(f"  {title}: {export_mb:.2f} MB, traced and saved in "
              f"{export_s:.2f} s; op nodes {dict(nodes)}")
        print(f"    loaded in a fresh process ({info['device']}) in "
              f"{info['load_s']:.2f} s; max |exported - live| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tolerance {EXPORT_ATOL:g}); launches a forward "
              f"{info['counts']}")
        print(f"    ms a forward (batch {B}, 20 forwards): exported median "
              f"{med:.3f}, p90 {p90:.3f}; live median {lmed:.3f}, p90 "
              f"{lp90:.3f}")
        if info["counts"] != want_counts:
            fail(f"export {title}: launches a forward {info['counts']}, "
                 f"expected {want_counts}")
        if dict(nodes) != {f"{build.OP_NAMESPACE}.{k}.default": v
                           for k, v in want_counts.items()}:
            fail(f"export {title}: op nodes {dict(nodes)}")
        if any(m.startswith(("rdfc_gan_torch.engines",
                             "rdfc_gan_torch.models"))
               for m in info["modules"]):
            fail(f"export {title}: the loading process imported "
                 f"{info['modules']}")
        has_label = any("G_label" in k for k in info["state"])
        if has_label != (title == "flagship"):
            fail(f"export {title}: G_label weights in the file: {has_label}")
    print(f"  export_phase: {time.perf_counter() - t_phase:.1f} s")


# a DCNv2 layer of a resnet18 layer 1 at 224x304 / 4
DCN_SHAPE = (B, 64, H // 4, W // 4)
DEFORM_RTOL = DEFORM_ATOL = 1e-5
# F.conv2d (cuDNN, TF32 off) against the deformable conv at zero offsets:
# the same products summed in another order
DCN_CONV_RTOL, DCN_CONV_ATOL = 1e-4, 1e-5


def _plain_gather(src, idx):
    """``torch.gather``, whose CUDA backward adds with atomics: what
    ``ops.deform._FixedOrderGather`` replaces, patched in for the record."""
    import torch

    return torch.gather(src, 2, idx.expand(src.shape[0], src.shape[1],
                                           idx.shape[-1]))


def deform_phase(workdir):
    """The general deformable ops and the stencil refine on the card:
    ``modulated_deform_conv`` at NLSPN's own use (C = 1, K = 9, weight of
    ones, mask = the affinity, 4x1x224x304) against one gather step of
    ``nlspn_propagate``, its backward run twice and held bit-equal; a
    DCNv2 layer 4x64x56x76 -> 64, groups 1 and 64,
    at zero offsets against ``F.conv2d`` (TF32 off) and at offsets up to 4
    pixels against the CPU, its backward run twice and held bit-equal (and
    the same with ``torch.gather``'s own backward patched in, reported),
    forward and forward + backward timed, peak memory;
    ``deform_psroi_pooling`` (1x490x38x50, 64 ROIs, P = 7, 4 samples a
    part, output_dim 10) against the CPU; ``nlspn_refine_stencil`` at
    4x224x304 (S = 8, T = 18), on the inputs of the seeded NLSPN
    generator's refine block (as ``export_phase`` seeds it), bit for bit
    against its own composition, with
    its launches (#1 and #3 once), its offsets and affinities against the
    CPU's, its masks and chain against the CPU's from the same offsets
    (the masks rounded to bf16, as the card's chain rounds them) at the
    served tolerance, and its distance to the unrounded CPU run
    printed."""
    import torch
    import torch.nn.functional as F

    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.ops import (NLSPNParamsSpec, deform,
                                    deform_psroi_pooling,
                                    modulated_deform_conv, nlspn_propagate,
                                    nlspn_refine_stencil)
    from rdfc_gan_torch.ops.kernels import build, nlspn_kernel
    from rdfc_gan_torch.ops.nlspn import nlspn_offset_affinity
    from rdfc_gan_torch.ops.nlspn_stencil import build_shift_masks
    from rdfc_gan_torch.tools import export_model

    t_phase = time.perf_counter()
    print(f"deform: {gpu_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(11)
    R = 2
    with torch.no_grad():
        offsets, aff, feat, _ = mask_inputs(gen, R)
        got = modulated_deform_conv(feat, offsets, aff,
                                    torch.ones((1, 1, 3, 3), device="cuda"))
        want = nlspn_propagate(feat, offsets, aff,
                               NLSPNParamsSpec(prop_time=1))
    compare(f"modulated_deform_conv {B}x1x{H}x{W} (weight of ones, mask = "
            f"affinity) vs one nlspn_propagate gather step", got, want,
            DEFORM_RTOL, DEFORM_ATOL)
    ins = [t.clone().requires_grad_() for t in (feat, offsets, aff)]

    def nlspn_use_grads():
        for t in ins:
            t.grad = None
        modulated_deform_conv(*ins, torch.ones(
            (1, 1, 3, 3), device="cuda")).square().sum().backward()
        return [t.grad.clone() for t in ins]

    repeats = all(torch.equal(u, v) for u, v in zip(nlspn_use_grads(),
                                                    nlspn_use_grads()))
    print(f"  modulated_deform_conv {B}x1x{H}x{W}: backward twice bit-equal "
          f"{repeats} (feat, offsets, mask)")
    if not repeats:
        fail(f"modulated_deform_conv {B}x1x{H}x{W}: two backward passes "
             f"differ")
    del ins

    b, c, h, w = DCN_SHAPE
    x = torch.randn(DCN_SHAPE, device="cuda", generator=gen)
    off = torch.empty((b, 9, 2, h, w), device="cuda").uniform_(
        -4, 4, generator=gen)
    mask = torch.rand((b, 9, h, w), device="cuda", generator=gen)
    bias = torch.randn((c,), device="cuda", generator=gen)
    gout = torch.randn(DCN_SHAPE, device="cuda", generator=gen)
    tag = f"DCNv2 {b}x{c}x{h}x{w} -> {c}"
    for groups in (1, c):
        wt = torch.randn((c, c // groups, 3, 3), device="cuda",
                         generator=gen) / (9 * c // groups) ** 0.5
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=False):
            zero = modulated_deform_conv(x, torch.zeros_like(off), None, wt,
                                         bias, groups=groups)
            ref = F.conv2d(x, wt, bias, padding=1, groups=groups)
            got = modulated_deform_conv(x, off, mask, wt, bias,
                                        groups=groups)
            conv_ms = time_ms(lambda: F.conv2d(x, wt, bias, padding=1,
                                               groups=groups))
            fwd_ms = time_ms(lambda: modulated_deform_conv(
                x, off, mask, wt, bias, groups=groups))
        compare(f"{tag} groups {groups}, zero offsets vs F.conv2d", zero,
                ref, DCN_CONV_RTOL, DCN_CONV_ATOL)
        cpu = modulated_deform_conv(x.cpu(), off.cpu(), mask.cpu(),
                                    wt.cpu(), bias.cpu(), groups=groups)
        compare(f"{tag} groups {groups}, offsets up to 4 px, card vs CPU",
                got, cpu.cuda(), DEFORM_RTOL, DEFORM_ATOL)
        ins = [t.clone().requires_grad_() for t in (x, off, mask, wt)]

        def fwd_bwd():
            for t in ins:
                t.grad = None
            modulated_deform_conv(*ins, bias, groups=groups).backward(gout)
            return [t.grad.clone() for t in ins]

        first, second = fwd_bwd(), fwd_bwd()
        repeats = all(torch.equal(u, v) for u, v in zip(first, second))
        with mock.patch.object(deform._FixedOrderGather, "apply",
                               _plain_gather):
            p1, p2 = fwd_bwd(), fwd_bwd()
        plain_diff = float((p1[0] - p2[0]).abs().max())
        fb_ms = time_ms(fwd_bwd, reps=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"  {tag} groups {groups}: backward twice bit-equal "
              f"{repeats} (feat, offsets, mask, weight); with torch.gather's "
              f"own backward bit-equal {torch.equal(p1[0], p2[0])}, max "
              f"|dfeat diff| {plain_diff:.3e}")
        print(f"    ms: forward {fwd_ms:.3f} (F.conv2d at zero offsets "
              f"{conv_ms:.3f}), forward + backward {fb_ms:.3f}; peak memory "
              f"of a forward + backward {peak / 2**20:.1f} MiB")
        if not repeats:
            fail(f"{tag} groups {groups}: two backward passes differ")

    P, n = 7, 64
    pfeat = torch.randn((1, P * P * 10, 38, 50), device="cuda",
                        generator=gen)
    # ROIs in the image of a 1/16 feature map (800x608)
    corners = torch.rand((n, 4), device="cuda", generator=gen) * \
        torch.tensor([800.0, 608.0, 800.0, 608.0], device="cuda")
    rois = torch.stack([torch.zeros(n, device="cuda"),
                        torch.minimum(corners[:, 0], corners[:, 2]),
                        torch.minimum(corners[:, 1], corners[:, 3]),
                        torch.maximum(corners[:, 0], corners[:, 2]),
                        torch.maximum(corners[:, 1], corners[:, 3])], 1)
    poff = (torch.rand((n, 2, P, P), device="cuda", generator=gen) - 0.5)
    kw = dict(pooled_size=P, output_dim=10, spatial_scale=1 / 16,
              sample_per_part=4, gamma=0.1)
    with torch.no_grad():
        got = deform_psroi_pooling(pfeat, rois, poff, **kw)
        roi_ms = time_ms(lambda: deform_psroi_pooling(pfeat, rois, poff,
                                                      **kw))
    cpu = deform_psroi_pooling(pfeat.cpu(), rois.cpu(), poff.cpu(), **kw)
    if tuple(got.shape) != (n, 10, P, P):
        fail(f"deform_psroi_pooling shape {tuple(got.shape)}")
    compare(f"deform_psroi_pooling 1x490x38x50, {n} ROIs, card vs CPU "
            f"({roi_ms:.3f} ms on the card)", got, cpu.cuda(), DEFORM_RTOL,
            DEFORM_ATOL)

    # the refine's inputs as the served NLSPN generator makes them: the
    # serve phase's seeded G on the export tool's sample batch, its NLSPN
    # block's guide, confidence, initial depth and sparse depth captured
    cfg = parse_config(["--model_cfg_path", os.path.join(
        ROOT, "configs", "rdf_gan_nlspn_config.yaml"), "--work_dir",
        workdir, "--out_height", str(H), "--out_width", str(W), "--device",
        "cuda"])
    rgb, raw_depth = export_model.sample_inputs(B, H, W, 0, "cuda")
    g = _seeded_generator(cfg, "cuda", dict(rgb=rgb, raw_depth=raw_depth))
    seen = {}
    block = g._nlspn_block

    def spy(guide, confidence, pred_init, origin_depth):
        seen.update(guide=guide, conf=confidence, pred=pred_init,
                    fix=origin_depth)
        return block(guide, confidence, pred_init, origin_depth)

    g._nlspn_block = spy
    with torch.no_grad():
        g(rgb, raw_depth)
        prop = g.nlspn_refine_module.prop_layer
        raw = prop.conv_offset_aff(seen["guide"])
    gamma, spec, R = prop.aff_scale_const.detach(), g.nlspn_spec, \
        g.nlspn_offset_radius
    pred, conf, fix = seen["pred"], seen["conf"], seen["fix"]
    del g, seen
    if (spec.prop_time, R) != (T, 2):
        fail(f"the NLSPN config's prop_time {spec.prop_time} and radius {R}"
             f", expected {T} and 2")
    with torch.no_grad():
        build.reset_launches()
        got = nlspn_refine_stencil(pred, raw, conf, gamma, spec, fix, R=R)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        refine_ms = time_ms(lambda: nlspn_refine_stencil(
            pred, raw, conf, gamma, spec, fix, R=R))
        offs, affs = nlspn_offset_affinity(raw, conf, gamma, spec)
        own = nlspn_kernel.propagate_auto(
            pred, build_shift_masks(offs, affs, 3, R), T, R, fix,
            spec.preserve_input)
        coffs, caffs = nlspn_offset_affinity(raw.cpu(), conf.cpu(),
                                             gamma.cpu(), spec)
        served_cpu = nlspn_kernel.nlspn_stencil_propagate(
            pred.cpu(), build_shift_masks(offs.cpu(), affs.cpu(), 3, R),
            fix.cpu(), T, R, spec.preserve_input)
        plain_cpu = nlspn_refine_stencil(pred.cpu(), raw.cpu(), conf.cpu(),
                                         gamma.cpu(), spec, fix.cpu(), R=R)
    tag = f"nlspn_refine_stencil {B}x{H}x{W} S={2 * R + 4} T={T}"
    print(f"  {tag}: {refine_ms:.3f} ms on the card, launches {counts}")
    if counts != {"shift_mask_scatter": 1, "nlspn_propagate": 1}:
        fail(f"{tag}: launches {counts}, expected the scatter and the "
             f"served chain once each")
    compare(f"{tag} vs its own composition", got, own, 0.0, 0.0)
    compare(f"{tag} offsets, card vs CPU", offs, coffs.cuda(), DEFORM_RTOL,
            DEFORM_ATOL)
    compare(f"{tag} affinities, card vs CPU", affs, caffs.cuda(),
            DEFORM_RTOL, DEFORM_ATOL)
    compare(f"{tag} vs the CPU's masks and served chain from the same "
            f"offsets (M in bf16)", got, served_cpu.cuda(), SERVE_RTOL,
            SERVE_ATOL)
    diff = (got - plain_cpu.cuda()).abs()
    print(f"  {tag} vs its CPU run, whose masks stay f32 (the card's chain "
          f"rounds them to bf16): max_abs_diff {float(diff.max()):.3e}, "
          f"max|ref| {float(plain_cpu.abs().max()):.3e}, median abs diff "
          f"{float(diff.median()):.3e}, max_abs_diff / max|ref| "
          f"{float(diff.max() / plain_cpu.abs().max()):.3e}; max|initial "
          f"depth| "
          f"{float(pred.abs().max()):.3e}, max|offset| "
          f"{float(offs.abs().max()):.3f}, preserve_input "
          f"{spec.preserve_input}")
    print(f"  deform_phase: {time.perf_counter() - t_phase:.1f} s")


def main():
    if not os.path.isdir(os.path.join(ROOT, "rdfc_gan_torch", "csrc")):
        fail(f"no rdfc_gan_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    from rdfc_gan_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"built {len(build.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in build.BUILD_LOGS.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"  {name}: " + " | ".join(lines))

    rows = kernel_phase()
    train_rows = backward_kernel_phase()
    in_rows = instance_norm_phase()
    split_rows = in_split_phase()
    conv_rows = conv_block_phase()
    batchnorm_rounding_check()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as workdir:
        export_phase(workdir)
        deform_phase(workdir)
        counts, engine, batch = serve_phase(workdir)
        profile_phase(engine, batch)
        del engine
        train_counts, engine, batch, pth = train_phase(workdir)
        train_profile_phase(engine, batch)
        del engine
        step_compare_phase(workdir, pth)
        bf16_step_compare_phase(workdir, pth)
        flagship_counts, engine, batch = flagship_serve_phase(workdir)
        flagship_breakdown_phase(engine, batch)
        profile_phase(engine, batch, title="flagship profile")
        del engine
        flagship_train_counts, engine, batch, fpth = flagship_train_phase(
            workdir)
        train_profile_phase(engine, batch, title="flagship train profile")
        del engine
        flagship_step_compare_phase(workdir, fpth)
        jax_ckpt_phase(workdir)
        file_dataset_phase(workdir)
        s2d_root = s2d_phase(workdir)
        v1_variants_phase(workdir, s2d_root)
        v1_family_phase(workdir, s2d_root)
        augmentation_phase(workdir)
        nlspn_repeat_check(workdir)
        data_parallel_phase(workdir)
        split_counts = spatial_phase(workdir)
    # launches: the scatter and the served chain from the serve run, the
    # NLSPN backward kernels from the RDFGAN train run, the IN and conv
    # kernels from the flagship train run
    for name, row in rows.items():
        row["launches"] = counts[name]
    for name, row in train_rows.items():
        row["launches"] = train_counts[name]
    for name, row in {**in_rows, **conv_rows}.items():
        row["launches"] = flagship_train_counts[name]
    # the IN split's: from one width-sharded flagship forward on a rank
    for name, row in split_rows.items():
        row["launches"] = split_counts[name]
    rows.update(train_rows)
    rows.update(in_rows)
    rows.update(split_rows)
    rows.update(conv_rows)
    print(gpu_line())
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
