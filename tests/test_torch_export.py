"""The serving export (``python -m rdfc_gan_torch.tools.export_model``) on
the CPU: the tiny flagship (``configs/rdfc_gan_tiny.yaml``, batch 2,
32x48) exported in full and with ``--depth_only`` from a port ``.pth``
holding JAX weights, each with ``--check``; both files loaded in a fresh
process that imports only torch and ``rdfc_gan_torch.ops.kernels``; their
outputs held against the live ``forward_test`` (rtol = atol = 2e-5, the
JAX tool's) and pred_depth against the JAX engine's ``_forward_test_impl``
(rtol 1e-3, atol 1e-4, the port's parity tolerance). Then
``torch.library.opcheck`` of the three dispatcher ops of the served
kernels. The gpu-marked test exports on the card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rdfc_gan_torch.ops.kernels import build, mask_kernel, nlspn_kernel, \
    norm_kernel
from rdfc_gan_torch.tools import export_model

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
B, H, W = 2, 32, 48
SERVED = ("G_A2B", "G_normal", "G_label")
OP_NAMES = ("shift_mask_scatter", "nlspn_propagate", "instance_norm_fwd")

# the loading host: torch and the kernels' ops, nothing else of the port
LOADER = """
import sys
import torch
import rdfc_gan_torch.ops.kernels
torch.set_num_threads(1)
inputs = torch.load(sys.argv[1])
res = {}
for name, path in zip(("full", "depth_only"), sys.argv[2:4]):
    ep = torch.export.load(path)
    with torch.no_grad():
        res[name] = dict(ep.module()(*inputs))
    res[name + "_state"] = sorted(ep.state_dict)
res["modules"] = sorted(m for m in sys.modules
                        if m.startswith("rdfc_gan_torch"))
torch.save(res, sys.argv[4])
"""


def _argv(out, pth, device="cpu", extra=()):
    return ["--model_cfg_path", TINY, "--out", str(out), "--batch_size",
            str(B), "--out_height", str(H), "--out_width", str(W),
            "--load_from", str(pth), "--device", device, *extra]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A port .pth with the JAX engine's three served nets (norm leaves
    drawn), the two artifacts written by the tool's ``main`` with
    ``--check``, the live engine, the loader process's results and the
    JAX engine with its trees."""
    import jax

    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.utils.checkpoint import save_checkpoint
    from rdfc_gan_torch.utils.convert import rdfcgan_state_dicts_from_jax
    from rdfc_gan_tpu.cli import parse_config as jax_parse_config
    from rdfc_gan_tpu.engines import build_engine as jax_build_engine
    from test_torch_normal_net import randomize_norms

    tmp = tmp_path_factory.mktemp("export")
    cfg_args = ["--dataset", "synthetic", "--model_cfg_path", TINY,
                "--work_dir", str(tmp / "w"), "--out_height", str(H),
                "--out_width", str(W), "--batch_size", str(B)]
    jeng = jax_build_engine(jax_parse_config(cfg_args), is_train=False)
    x = jax.numpy.zeros((B, H, W, 3))
    d = jax.numpy.zeros((B, H, W, 1))
    inputs = {"G_A2B": (x, d, x), "G_normal": (x,), "G_label": (x,)}
    params, stats = {}, {}
    for i, k in enumerate(SERVED):
        p, s = jeng._init_net(jax.random.PRNGKey(i), k, *inputs[k],
                              train=False)
        params[k] = randomize_norms(
            p, 10 + i, scale=(0.3, 0.6) if k == "G_label" else (0.8, 1.2))
        stats[k] = randomize_norms(s, 20 + i)
    cfg = parse_config(cfg_args + ["--device", "cpu"])
    teng = build_engine(cfg, is_train=False)
    sds = rdfcgan_state_dicts_from_jax(params, stats,
                                       normal_depth=cfg.model.Normal_G.depth)
    for k in SERVED:
        teng.modules[k].load_state_dict(sds[k], strict=False)
    pth = tmp / "rdfc.pth"
    save_checkpoint(teng.modules, str(pth))

    full, depth = tmp / "full.pt2", tmp / "depth.pt2"
    assert export_model.main(_argv(full, pth, extra=["--check"])) == 0
    assert export_model.main(_argv(depth, pth, extra=["--check",
                                                      "--depth_only"])) == 0
    engine, rgb, raw = export_model.build(export_model.parse_args(
        _argv(full, pth)))
    torch.save((rgb, raw), tmp / "inputs.pt")
    res = subprocess.run(
        [sys.executable, "-c", LOADER, str(tmp / "inputs.pt"), str(full),
         str(depth), str(tmp / "res.pt")], cwd=str(tmp),
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded = torch.load(tmp / "res.pt")
    return dict(engine=engine, rgb=rgb, raw=raw, loaded=loaded, jeng=jeng,
                params=params, stats=stats)


@pytest.mark.parametrize("depth_only", [False, True])
def test_round_trip_in_a_fresh_process(exported, depth_only):
    """Each loaded program gives the live forward_test's outputs, on a host
    that imported no engine or model of the port."""
    got = exported["loaded"]["depth_only" if depth_only else "full"]
    want = exported["engine"].forward_test(
        rgb=exported["rgb"], raw_depth=exported["raw"],
        depth_only=depth_only)
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=2e-5, atol=2e-5)
    mods = exported["loaded"]["modules"]
    assert "rdfc_gan_torch.ops.kernels.norm_kernel" in mods
    assert not any(m.startswith(("rdfc_gan_torch.engines",
                                 "rdfc_gan_torch.models")) for m in mods)


def test_depth_only_artifact_has_no_g_label(exported):
    full = exported["loaded"]["full_state"]
    depth = exported["loaded"]["depth_only_state"]
    assert any(".G_label." in k for k in full)
    assert not any("G_label" in k for k in depth)
    assert set(depth) == {k for k in full if ".G_label." not in k}
    torch.testing.assert_close(
        exported["loaded"]["depth_only"]["pred_depth"],
        exported["loaded"]["full"]["pred_depth"], rtol=0, atol=0)


def test_exported_pred_depth_matches_jax(exported):
    import jax.numpy as jnp

    jeng = exported["jeng"]
    want = jeng._forward_test(
        exported["params"], exported["stats"],
        jnp.asarray(exported["rgb"].numpy().transpose(0, 2, 3, 1)),
        jnp.asarray(exported["raw"].numpy().transpose(0, 2, 3, 1)),
        depth_only=False)
    for k in ("pred_depth", "pred_normal", "pred_label"):
        np.testing.assert_allclose(
            exported["loaded"]["full"][k].numpy(),
            np.asarray(want[k]).transpose(0, 3, 1, 2), rtol=1e-3,
            atol=1e-4, err_msg=k)


def test_export_without_card_raises(monkeypatch, tmp_path):
    """``--device`` defaults to cuda, which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--model_cfg_path", TINY, "--out",
                           str(tmp_path / "m.pt2")])


def _op_cases():
    r = np.random.RandomState(0)
    b, k, s, h, w = 2, 36, 8, 5, 6
    wt = torch.from_numpy(r.uniform(-1, 1, (b, k, h, w)).astype(np.float32))
    sy = torch.from_numpy(r.randint(0, s, (b, k, h, w)).astype(np.int32))
    sx = torch.from_numpy(r.randint(0, s, (b, k, h, w)).astype(np.int32))
    feat = torch.from_numpy(r.normal(size=(b, h, w)).astype(np.float32))
    M16 = torch.from_numpy(r.uniform(-0.2, 0.2, (b, s, s, h, w)).astype(
        np.float32)).to(torch.bfloat16)
    fix = torch.from_numpy(np.abs(r.normal(size=(b, h, w))).astype(
        np.float32))
    x = torch.from_numpy(r.normal(size=(b, 3, h, w)).astype(np.float32))
    return {
        "shift_mask_scatter": (mask_kernel.scatter_op,
                               [(wt, sy, sx, s)]),
        "nlspn_propagate": (nlspn_kernel.chain_op,
                            [(feat, M16, None, 3, 2),
                             (feat, M16, fix, 3, 2)]),
        "instance_norm_fwd": (norm_kernel.fwd_op,
                              [(x, 1e-5), (x.to(torch.bfloat16), 1e-5)]),
    }


@pytest.mark.parametrize("name", OP_NAMES)
def test_served_kernel_ops_pass_opcheck(name):
    """Schema, fake implementation and dispatch of each op, on the CPU
    (where it runs its kernel's plain version)."""
    op, cases = _op_cases()[name]
    assert str(op) == f"{build.OP_NAMESPACE}.{name}.default"
    for args in cases:
        torch.library.opcheck(op, args)


@pytest.mark.gpu
def test_export_on_card_keeps_the_ops(tmp_path):
    """On the card the exported flagship holds the IN forward as four op
    nodes and an exported ``nlspn_refine_stencil`` the scatter and the
    served chain; a run of each loaded program launches them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rdfc_gan_torch.ops import NLSPNParamsSpec, nlspn_refine_stencil

    out = tmp_path / "f.pt2"
    res = export_model.run(["--model_cfg_path", TINY, "--out", str(out),
                            "--batch_size", str(B), "--out_height", str(H),
                            "--out_width", str(W), "--check"])

    def op_nodes(ep):
        return sorted(str(n.target) for n in ep.graph.nodes
                      if str(n.target).startswith(build.OP_NAMESPACE))

    assert op_nodes(res["program"]) == [
        "rdfc_gan_torch.instance_norm_fwd.default"] * 4

    class Refine(torch.nn.Module):
        def forward(self, pred, raw, conf, gamma):
            return nlspn_refine_stencil(pred, raw, conf, gamma,
                                        NLSPNParamsSpec(prop_time=6))

    gen = torch.Generator(device="cuda").manual_seed(0)
    args = (torch.randn((B, 1, H, W), device="cuda", generator=gen),
            torch.rand((B, 24, H, W), device="cuda", generator=gen) - 0.5,
            torch.rand((B, 1, H, W), device="cuda", generator=gen),
            torch.tensor(4.0, device="cuda"))
    with torch.no_grad():
        ep = torch.export.export(Refine(), args)
        want = Refine()(*args)
    assert op_nodes(ep) == ["rdfc_gan_torch.nlspn_propagate.default",
                            "rdfc_gan_torch.shift_mask_scatter.default"]
    torch.export.save(ep, tmp_path / "r.pt2")
    build.reset_launches()
    with torch.no_grad():
        got = torch.export.load(tmp_path / "r.pt2").module()(*args)
    assert dict(build.LAUNCHES) == {"shift_mask_scatter": 1,
                                    "nlspn_propagate": 1}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("probed,radius,impl", [
    (1.0, 2, "auto"), (2.8, 4, "auto"), (9.0, 2, "gather")])
def test_guard_rebuilds_for_the_probed_offsets(monkeypatch, probed, radius,
                                               impl):
    """The probe-and-rebuild step that ``rdfc_gan_torch.test`` and the
    export tool share: R escalated to cover 1.25x the probed offset, the
    gather past R = 4, the engine rebuilt only when the config changed;
    no probe without a generator node."""
    from rdfc_gan_torch.config import default_config, load_config
    from rdfc_gan_torch.ops import nlspn_guard

    cfg = default_config()
    load_config(cfg, os.path.join(ROOT, "configs",
                                  "rdf_gan_nlspn_config.yaml"))
    monkeypatch.setattr(nlspn_guard, "probe_max_offset",
                        lambda engine, batch: probed)
    old, new = object(), object()
    got = nlspn_guard.guard_loaded_engine(cfg, old, None, lambda: new)
    assert got == ((new, probed, True) if probed > 1.6
                   else (old, probed, False))
    assert cfg.model.G.get("nlspn_offset_radius", 2) == radius
    assert cfg.model.G.get("nlspn_impl", "auto") == impl
    flagship = default_config()
    load_config(flagship, TINY)
    assert nlspn_guard.guard_loaded_engine(flagship, old, None,
                                           lambda: new) == (old, None, False)
