"""Parent against change on one card, each tree running its own phases.

    python3 ab_chip.py [--wrappers | --split | --spatial] PARENT_TREE
        [OTHER_TREE ...] CHANGE_TREE LOG_DIR

Each tree is a checkout of the repository (a ``git archive`` of the parent
commit unpacked in a git-ignored directory, and this checkout). In turns,
parent, change, change, parent, a fresh process runs from the tree's own
``chip_smoke.py``: the kernel and backward-kernel phases (each kernel held
against its plain version and timed), the device time of the served and
the X-storing NLSPN forward chains and of the reverse chain (a T=18 chain
and a one-step chain at 4x224x304, S=8, bf16 masks, through the tree's own
wrappers), the shift correlation's device and events times at the train
step's shapes (bf16 stacks, dM in f32 and in bf16: a tree whose kernel
writes only f32 casts after it, as its train step did), the RDF-GAN
serve and train phases (latency, step times, launch counts), and the
flagship train phase (16 bf16 steps at batch 4: step times, with each
tree's own G_B2A reflect pad), and the instance norm's split for a
width-sharded plane: the tree's own ``in_split_phase`` and, through its
own wrappers, the events and device times of moments, apply, their M = 1
composition and #7 at the four W-AdaIN planes of 2x480x640 as M = 2
shards, f32 (a tree whose apply takes a and b finalizes between the two,
as its sharded forward did). With ``--split`` a run only builds the
instance norm's source and runs that last part. With ``--wrappers`` a
run only builds the kernels and times the served kernels' wrappers as
the main path calls them, through the tree's own modules: the shift-mask
scatter (#1) and the served chain (#3, T=18) at 4x224x304, S=8, and the
instance norm's forward (#7) at the four W-AdaIN shapes, f32, beside
``F.instance_norm``; each as the CUDA events time a call over a burst of
back-to-back calls, and the host's time to issue a call. With
``--spatial`` a run builds the kernels and runs the tree's own
``spatial_phase`` (width-sharded serving: gloo ranks on the one card, the
bytes each forward exchanges and its median ms a rank on each grid).
More than two trees run in the order given,
then in reverse (parent, other, change, change, other, parent). Each
run's whole output goes to LOG_DIR/ab_<label>.log; the lines that compare
the trees are printed. Needs one CUDA card, as ``chip_smoke.py``.
"""

from __future__ import annotations

import inspect
import os
import subprocess
import sys
import tempfile
import time

# the printed lines of a run's log
KEEP = ("[", "  nlspn_", "  per-request", "  step ms", "NVIDIA",
        "  instance_norm_", "  the M=1 split", "  model", "  data",
        "  M=1 ", "  the 2-rank", "  the 4-rank", "  width-sharding")


def split_times(label: str):
    """The instance norm split, from the current directory's tree: its own
    ``in_split_phase``, then the events and device times a call of
    moments, apply, the M = 1 composition (``instance_norm_fwd_sharded``
    with no collective) and #7 at the M = 2 shards of the four W-AdaIN
    planes of 2x480x640, f32, each summed over the four."""
    import collections

    import torch

    import chip_smoke as c
    from rdfc_gan_torch.ops.kernels import norm_kernel as nm

    c.in_split_phase()
    takes_sums = "sums" in inspect.signature(
        nm.instance_norm_apply).parameters
    g = torch.Generator(device="cuda").manual_seed(5)
    total = collections.defaultdict(float)
    for shape in c.fuse_in_shapes(*c.SPATIAL_SIZE):
        shape = (c.SPATIAL_B,) + shape[1:]
        x = torch.randn(shape, device="cuda", generator=g) * 3 + 1.5
        xs = x[..., :shape[3] // 2].contiguous()
        ns = shape[2] * shape[3] // 2
        s = nm.instance_norm_moments(xs)
        if takes_sums:
            apply = (lambda xs=xs, s=s, ns=ns:
                     nm.instance_norm_apply(xs, s, ns, 1e-5))
        else:
            a, b = nm.instance_norm_finalize(s, ns, 1e-5)
            apply = lambda xs=xs, a=a, b=b: nm.instance_norm_apply(xs, a, b)
        fns = (("moments", lambda xs=xs: nm.instance_norm_moments(xs)),
               ("apply", apply),
               ("split", lambda xs=xs: nm.instance_norm_fwd_sharded(xs,
                                                                    1e-5)),
               ("#7", lambda xs=xs: nm.instance_norm_fwd(xs, 1e-5)))
        for name, fn in fns:
            events, device = c.time_ms(fn), c._device_ms(fn, n=10)
            total[name, "events"] += events
            total[name, "device"] += device
            print(f"[{label}] split {name} {tuple(xs.shape)}: events "
                  f"{events:.4f} ms, device {device:.4f} ms")
    for name in ("moments", "apply", "split", "#7"):
        print(f"[{label}] split {name}, the four M=2 shards: events "
              f"{total[name, 'events']:.4f} ms, device "
              f"{total[name, 'device']:.4f} ms"
              + ("" if takes_sums or name != "apply" else
                 " (apply from a and b: the finalize's ops not in it)"))


def run_tree(label: str):
    """One run, from the current directory's tree."""
    tree = os.getcwd()
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as c
    from rdfc_gan_torch.ops.kernels import build, mask_kernel as mk
    from rdfc_gan_torch.ops.kernels import nlspn_kernel as nk

    t0 = time.time()
    build.build_all()
    print(f"[{label}] built in {time.time() - t0:.1f} s")
    rows = c.kernel_phase()
    rows.update(c.backward_kernel_phase())
    g = torch.Generator(device="cuda").manual_seed(5)
    feat = torch.randn((4, 224, 304), device="cuda", generator=g)
    M16 = (torch.randn((4, 8, 8, 224, 304), device="cuda", generator=g)
           * 0.2).to(torch.bfloat16)
    chains = (("served", lambda t: nk.nlspn_stencil_propagate(
        feat[:, None], M16, None, t, 2, False)),
              ("X bf16", lambda t: nk.propagate_x(feat, M16, None, t, 2,
                                                  torch.bfloat16)),
              ("reverse, G bf16", lambda t: nk.reverse_chain(
                  feat, M16, None, t, 2, torch.bfloat16)))
    for name, fn in chains:
        d18 = c._device_ms(lambda: fn(18), n=10)
        d1 = c._device_ms(lambda: fn(1), n=10)
        print(f"[{label}] {name} chain: device {d18:.4f} ms a T=18 chain, "
              f"{d1:.4f} a one-step chain, {(d18 - d1) / 17 * 1e3:.2f} us "
              f"each further step; events {c.time_ms(lambda: fn(18)):.4f} ms")
    G, X = (torch.randn((18, 4, 224, 304), device="cuda", generator=g).to(
        torch.bfloat16) for _ in range(2))
    bf16 = torch.bfloat16
    if "out_dtype" in inspect.signature(mk.shift_correlation).parameters:
        corr_bf16 = ("bf16 dM", lambda: mk.shift_correlation(G, X, 8, -3,
                                                             bf16))
    else:
        corr_bf16 = ("bf16 dM (f32 kernel + cast)",
                     lambda: mk.shift_correlation(G, X, 8, -3).to(bf16))
    for name, fn in (("f32 dM", lambda: mk.shift_correlation(G, X, 8, -3)),
                     corr_bf16):
        print(f"[{label}] shift_correlation {name}: device "
              f"{c._device_ms(fn, n=10):.4f} ms, events "
              f"{c.time_ms(fn):.4f} ms")
    for name in ("nlspn_propagate", "nlspn_propagate_x",
                 "nlspn_reverse_chain", "shift_correlation"):
        r = rows[name]
        print(f"[{label}] row {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
              f"max_abs_err {r['max_abs_err']}")
    with tempfile.TemporaryDirectory(prefix=".ab-", dir=tree) as wd:
        counts, engine, _ = c.serve_phase(wd)
        del engine
        train_counts = c.train_phase(wd)[0]
        flagship_counts = c.flagship_train_phase(wd)[0]
    print(f"[{label}] launches: serve {counts}; train {train_counts}; "
          f"flagship train {flagship_counts}")
    split_times(label)
    print(c.gpu_line())


def split_run(label: str):
    """Only the instance norm's split, from the current directory's tree."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from rdfc_gan_torch.ops.kernels import build

    t0 = time.time()
    build.build_all(["instance_norm"])
    print(f"[{label}] built in {time.time() - t0:.1f} s")
    split_times(label)
    print(c.gpu_line())


def spatial_run(label: str):
    """Only width-sharded serving, from the current directory's tree."""
    tree = os.getcwd()
    sys.path.insert(0, tree)
    import chip_smoke as c
    from rdfc_gan_torch.ops.kernels import build

    t0 = time.time()
    build.build_all()
    print(f"[{label}] built in {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke-", dir=tree) as wd:
        c.spatial_phase(wd)
    print(c.gpu_line())


def wrapper_times(label: str):
    """The served kernels' wrappers, from the current directory's tree."""
    tree = os.getcwd()
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from rdfc_gan_torch.ops.kernels import build, mask_kernel as mk
    from rdfc_gan_torch.ops.kernels import nlspn_kernel as nk
    from rdfc_gan_torch.ops.kernels import norm_kernel as nm

    t0 = time.time()
    build.build_all()
    print(f"[{label}] built in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    offsets, aff, feat, _ = c.mask_inputs(gen, 2)
    a, _ = c.scatter_args(offsets, aff, 2)
    M16 = mk.scatter_shift_masks(a["w"], a["sy"], a["sx"], a["S"]).reshape(
        c.B, a["S"], a["S"], c.H, c.W).to(torch.bfloat16)
    cases = [("shift_mask_scatter", f"{tuple(a['w'].shape)} S={a['S']}",
              lambda: mk.scatter_shift_masks(a["w"], a["sy"], a["sx"],
                                             a["S"])),
             ("nlspn_propagate", f"{tuple(M16.shape)} T={c.T}",
              lambda: nk.nlspn_stencil_propagate(feat, M16, None, c.T, 2,
                                                 False))]
    for shape in c.IN_SHAPES:
        x = torch.randn(shape, device="cuda", generator=gen) * 3 + 1.5
        cases.append(("instance_norm_fwd", f"{shape}",
                      lambda x=x: nm.instance_norm_fwd(x, 1e-5)))
        cases.append(("F.instance_norm", f"{shape}",
                      lambda x=x: F.instance_norm(x, eps=1e-5)))
    with torch.no_grad():
        for name, shape, fn in cases:
            events = c.time_ms(fn, reps=200, warmup=10)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(100):
                fn()
            host = (time.perf_counter() - t) / 100 * 1e3
            torch.cuda.synchronize()
            print(f"[{label}] wrapper {name} {shape}: events {events:.4f} ms "
                  f"a call over 200 calls, host {host:.4f} ms to issue a "
                  f"call")
    print(c.gpu_line())


def main():
    args = sys.argv[1:]
    mode = [a for a in args if a in ("--wrappers", "--split", "--spatial")]
    args = [a for a in args if a not in mode]
    if len(args) == 2 and args[0] == "--run":
        {"--wrappers": wrapper_times, "--split": split_run,
         "--spatial": spatial_run}.get(
            mode[0] if mode else None, run_tree)(args[1])
        return
    if len(args) < 3:
        sys.exit(__doc__)
    trees = [os.path.abspath(t) for t in args[:-1]]
    names = ["parent"] + [os.path.basename(t) for t in trees[1:-1]] + \
        ["change"]
    log_dir = os.path.abspath(args[-1])
    os.makedirs(log_dir, exist_ok=True)
    order = list(range(len(trees)))
    for n, i in enumerate(order + order[::-1]):
        label = f"{names[i]}{1 + n // len(trees)}"
        log = os.path.join(log_dir, f"ab_{label}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--run", label] + mode[:1],
                                cwd=trees[i], stdout=f,
                                stderr=subprocess.STDOUT).returncode
        with open(log) as f:
            lines = f.read().splitlines()
        print("\n".join(ln for ln in lines if ln.startswith(KEEP)))
        if rc != 0:
            print("\n".join(lines[-30:]))
            sys.exit(f"ab_chip: the {label} run failed (exit {rc})")


if __name__ == "__main__":
    main()
