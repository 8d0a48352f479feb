"""Parent against change on one card, each tree running its own phases.

    python3 ab_chip.py PARENT_TREE CHANGE_TREE LOG_DIR

Each tree is a checkout of the repository (a ``git archive`` of the parent
commit unpacked in a git-ignored directory, and this checkout). In turns,
parent, change, change, parent, a fresh process runs from the tree's own
``chip_smoke.py``: the kernel and backward-kernel phases (each kernel held
against its plain version and timed), the device time of the served and
the X-storing NLSPN forward chains and of the reverse chain (a T=18 chain
and a one-step chain at 4x224x304, S=8, bf16 masks, through the tree's own
wrappers), the shift correlation's device and events times at the train
step's shapes (bf16 stacks, dM in f32 and in bf16: a tree whose kernel
writes only f32 casts after it, as its train step did), and the RDF-GAN
serve and train phases (latency, step times, launch counts). Each
run's whole output goes to LOG_DIR/ab_<label>.log; the lines that compare
the two trees are printed. Needs one CUDA card, as ``chip_smoke.py``.
"""

from __future__ import annotations

import inspect
import os
import subprocess
import sys
import tempfile
import time

RUNS = (("parent", "parent1"), ("change", "change1"), ("change", "change2"),
        ("parent", "parent2"))
# the printed lines of a run's log
KEEP = ("[", "  nlspn_", "  per-request", "  step ms", "NVIDIA")


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
    print(f"[{label}] launches: serve {counts}; train {train_counts}")
    print(c.gpu_line())


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run_tree(sys.argv[2])
        return
    if len(sys.argv) != 4:
        sys.exit(__doc__)
    trees = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.abspath(sys.argv[2])}
    log_dir = os.path.abspath(sys.argv[3])
    os.makedirs(log_dir, exist_ok=True)
    for which, label in RUNS:
        log = os.path.join(log_dir, f"ab_{label}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--run", label], cwd=trees[which],
                                stdout=f, stderr=subprocess.STDOUT).returncode
        with open(log) as f:
            lines = f.read().splitlines()
        print("\n".join(ln for ln in lines if ln.startswith(KEEP)))
        if rc != 0:
            print("\n".join(lines[-30:]))
            sys.exit(f"ab_chip: the {label} run failed (exit {rc})")


if __name__ == "__main__":
    main()
