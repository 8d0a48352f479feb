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
   Python mirror against the kernel's;
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
10. prints the card's name and power limit, one ``{"kernels": [...]}``
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


def compare(name, got, want, rtol, atol):
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"non-finite output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= atol + rtol * want.abs()).all())
    print(f"  {name}: max|ref|={float(want.abs().max()):.3e} "
          f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(tolerance atol={atol:g} rtol={rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def mask_inputs(gen, R: int):
    """(offsets, aff, feat, fix) as the serving path makes them: offsets
    within +-R/1.25, TGASS affinities over a confidence map, a sparse depth
    map kept where > 0."""
    import torch

    from rdfc_gan_torch.ops.nlspn import NLSPNParamsSpec, nlspn_offset_affinity

    spec = NLSPNParamsSpec(prop_time=T)
    num = spec.num_neighbors
    dev = "cuda"
    raw = torch.empty((B, 3 * num, H, W), device=dev)
    raw[:, :2 * num].uniform_(-R / 1.25, R / 1.25, generator=gen)
    raw[:, 2 * num:].normal_(generator=gen)
    conf = torch.empty((B, 1, H, W), device=dev).uniform_(0.2, 1.0,
                                                          generator=gen)
    offsets, aff = nlspn_offset_affinity(
        raw, conf, torch.tensor(spec.affinity_gamma * num, device=dev), spec,
        conf_sample_radius=R)
    feat = torch.empty((B, 1, H, W), device=dev).uniform_(-1, 1,
                                                          generator=gen)
    keep = torch.empty((B, 1, H, W), device=dev).uniform_(
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


def _seeded_nets(cfg, workdir):
    """The seeded generator of the serve phase and a PatchGAN from a seed,
    saved as one reference-schema checkpoint."""
    import torch

    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.registry import build_discriminator

    first = next(iter(port_test.build_val_loader(cfg, torch.device("cuda"))))
    g = _seeded_generator(cfg, "cuda", first, train=True)
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
    """The Python plans (``norm_kernel.fwd_plan`` and ``bwd_plan``) against
    the ones the built kernel exports, at the phase's plane sizes and a
    sweep, f32 and bf16."""
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
    print(f"  fwd_plan and bwd_plan match the kernel's exported plans at "
          f"{len(sizes)} plane sizes, f32 and bf16")


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
    conv_rows = conv_block_phase()
    batchnorm_rounding_check()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=ROOT) as workdir:
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
    # launches: the scatter and the served chain from the serve run, the
    # NLSPN backward kernels from the RDFGAN train run, the IN and conv
    # kernels from the flagship train run
    for name, row in rows.items():
        row["launches"] = counts[name]
    for name, row in train_rows.items():
        row["launches"] = train_counts[name]
    for name, row in {**in_rows, **conv_rows}.items():
        row["launches"] = flagship_train_counts[name]
    rows.update(train_rows)
    rows.update(in_rows)
    rows.update(conv_rows)
    print(gpu_line())
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
