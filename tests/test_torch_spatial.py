"""Width-sharded serving of the port (``parallel.grid``, ``parallel.halo``,
``parallel.spatial``: the JAX ``spatial_sharding``), on the CPU: gloo ranks
of ``tests/torch_dp_worker.py``, a pool of 2 and one of 4 started once for
the module, each running its batch of jobs while the references (the
unsharded ops and forwards, the JAX sharded forward, the world-1 CLI run)
are computed here.

* Every rule against its unsharded op, at M = 2 and 4: every distinct
  convolution of the flagship's three served nets (kernel, stride,
  dilation, padding, depthwise or not; ``test_conv_cases_cover_the_served_
  nets`` holds the list against the modules) and ``Conv2dSame`` (k3 / k5,
  stride 1 / 2, depthwise, and the stem), the transposed convolution, the
  max pool, ``bilinear_resize`` (2x and 8x align-corners, to a skip's
  size, half-pixel up and antialiased down, and a PSP bin's whole map), the
  PSP module (its pooling and resize back), the squeeze-excite mean,
  ``AdaIN`` and the instance norm. Tolerance rtol 1e-4 / atol 1e-5 (the
  smoke's SERVE tolerance): a shard's convolution rounds as the library
  picks for its shape. The instance norm's scale: within one f32 ulp of
  ``instance_norm_fwd_plain``'s (the f64 sums added in another order), and
  at M = 1 the split's composition equals it bit for bit.
* The tiny flagship (``configs/rdfc_gan_tiny.yaml``, 2x3x64x128, the JAX
  package's weights) on {model: 2}, {model: 4} and {data: 2, model: 2}
  (and ``depth_only`` on the first) against the port's unsharded forward at
  1e-4 / 1e-5, and against JAX's ``jit(engine._forward_test_impl)`` with its
  inputs placed by ``spatial_sharding(make_mesh({"data": 2, "model": 4}))``
  at 1e-3 / 1e-4, the tolerance of ``tests/test_torch_rdfc_serving.py``
  (XLA's own sharded and unsharded forwards differ by up to 9.2e-5 in the
  labels); the returned shards are the assembled output's columns. The
  tiny NLSPN RDF-GAN on {model: 2} against its unsharded forward.
* ``rdfc_gan_torch.test`` with ``mesh_shape`` {data: 1, model: 2} gives the
  world-1 metrics; a train step at {data: 1, model: 2} equals one at
  {data: 2} bit for bit (a ``model`` axis trains as data parallelism).
* The refusals: a width that 32 M does not divide, a sharded forward that
  would record a gradient, and mesh shapes that are not the world.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from rdfc_gan_torch.cli import parse_config
from rdfc_gan_torch.engines import build_engine
from rdfc_gan_torch.ops.kernels import norm_kernel as nk
from rdfc_gan_torch.parallel import spatial
from rdfc_gan_torch.parallel.grid import Grid
from rdfc_gan_torch.utils.checkpoint import save_checkpoint
from rdfc_gan_torch.utils.convert import rdfcgan_state_dicts_from_jax
from test_torch_normal_net import randomize_norms
from test_torch_train_step import TINY

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
JAX_RTOL, JAX_ATOL = 1e-3, 1e-4
B, H, W = 2, 64, 128
SERVED = ("G_A2B", "G_normal", "G_label")
GRIDS = {2: [{"model": 2}], 4: [{"model": 4}, {"data": 2, "model": 2}]}

# (kernel, stride, dilation, padding, depthwise) of every nn.Conv2d of the
# flagship's G_A2B, G_normal and G_label, and (kernel, stride, depthwise)
# of every Conv2dSame
CONV_CASES = [(1, 1, 1, 0, False), (1, 2, 1, 0, False), (3, 1, 1, 1, False),
              (3, 2, 1, 1, False), (3, 1, 2, 2, False), (3, 1, 4, 4, False),
              (3, 1, 8, 8, False), (3, 1, 16, 16, False)]
SAME_CASES = [(3, 2, False), (3, 1, True), (3, 2, True), (5, 1, True),
              (5, 2, True)]


def _x(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).normal(
        size=shape).astype(np.float32))


def _cases():
    """Every op case: kind, its parameters, its inputs (global)."""
    cases = [dict(kind="conv", conv=c, inputs=[_x(i, (B, 4, 6, 32))])
             for i, c in enumerate(CONV_CASES)]
    cases += [dict(kind="same", conv=c, inputs=[_x(20 + i, (B, 4, 6, 32))])
              for i, c in enumerate(SAME_CASES)]
    cases += [
        dict(kind="convT", inputs=[_x(30, (B, 4, 5, 16))]),
        dict(kind="maxpool", inputs=[_x(31, (B, 4, 6, 32))]),
        # 2x and 8x align-corners, to a skip's (odd) size, half-pixel up
        # and antialiased down, a PSP bin's whole map
        dict(kind="resize", size=(10, 32), align=True,
             inputs=[_x(32, (B, 3, 5, 16))]),
        dict(kind="resize", size=(32, 64), align=True,
             inputs=[_x(33, (B, 3, 4, 8))]),
        dict(kind="resize", size=(9, 32), align=True,
             inputs=[_x(34, (B, 3, 5, 16))]),
        dict(kind="resize", size=(8, 32), align=False,
             inputs=[_x(35, (B, 3, 4, 16))]),
        dict(kind="resize", size=(4, 16), align=False,
             inputs=[_x(36, (B, 3, 8, 64))]),
        dict(kind="resize", size=(12, 32), align=True, whole=True,
             inputs=[_x(37, (B, 3, 6, 6))]),
        dict(kind="psp", c=8, inputs=[_x(38, (B, 8, 6, 32))]),
        dict(kind="se", c=8, inputs=[_x(39, (B, 8, 5, 32))]),
        dict(kind="adain", inputs=[_x(40, (B, 4, 5, 32)),
                                   _x(41, (B, 4, 5, 32)) * 2 + 1]),
        dict(kind="in", c=3, inputs=[_x(42, (B, 3, 5, 32)) * 3 + 1.5])]
    return cases


CASES = _cases()
CASE_IDS = [f"{c['kind']}{i}" for i, c in enumerate(CASES)]


def _args(tmp, config, work, extra=()):
    return ["--dataset", "synthetic", "--model_cfg_path", str(config),
            "--work_dir", str(tmp / work), "--out_height", str(H),
            "--out_width", str(W), "--num_workers", "1", "--device", "cpu",
            *extra]


def _flagship_weights(tmp):
    """The JAX engine with its three served nets' trees (norm leaves drawn)
    and the port's serving engine args and checkpoint holding them."""
    from rdfc_gan_tpu.cli import parse_config as jax_parse_config
    from rdfc_gan_tpu.engines import build_engine as jax_build_engine

    config = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
    args = _args(tmp, config, "f")
    jeng = jax_build_engine(jax_parse_config(args[:-2]), is_train=False)
    x, d = jnp.zeros((B, H, W, 3)), jnp.zeros((B, H, W, 1))
    inputs = {"G_A2B": (x, d, x), "G_normal": (x,), "G_label": (x,)}
    params, stats = {}, {}
    for i, k in enumerate(SERVED):
        p, s = jeng._init_net(jax.random.PRNGKey(i), k, *inputs[k],
                              train=False)
        scale = (0.3, 0.6) if k == "G_label" else (0.8, 1.2)
        params[k] = randomize_norms(p, 10 + i, scale=scale)
        stats[k] = randomize_norms(s, 20 + i)
    teng = build_engine(parse_config(args))
    sds = rdfcgan_state_dicts_from_jax(
        params, stats, normal_depth=teng.cfg.model.Normal_G.depth)
    for k in SERVED:
        teng.modules[k].load_state_dict(sds[k], strict=False)
    pth = str(tmp / "flagship.pth")
    save_checkpoint(teng.modules, pth)
    return jeng, params, stats, teng, args, pth


def _nlspn_weights(tmp):
    """The tiny NLSPN RDF-GAN with seeded weights (offsets away from 0)."""
    (tmp / "tiny.yaml").write_text(TINY)
    args = _args(tmp, tmp / "tiny.yaml", "n")
    torch.manual_seed(0)
    eng = build_engine(parse_config(args))
    with torch.no_grad():
        for n, p in eng.modules["G"].named_parameters():
            if not n.endswith(("aff_scale_const", ".w", ".b", ".w_conf")):
                p.uniform_(-0.15, 0.15)
        oa = eng.modules["G"].nlspn_refine_module.prop_layer.conv_offset_aff
        oa.weight.uniform_(-0.1, 0.1)
        oa.bias.uniform_(-0.5, 0.5)
    pth = str(tmp / "nlspn.pth")
    save_checkpoint(eng.modules, pth)
    return eng, args, pth


def _batch(seed):
    r = np.random.RandomState(seed)
    rgb = r.uniform(-1, 1, (B, 3, H, W)).astype(np.float32)
    raw = (r.normal(size=(B, 1, H, W)) * (r.uniform(size=(B, 1, H, W))
                                          > 0.6)).astype(np.float32)
    return rgb, raw


@pytest.fixture(scope="module")
def spatial_run(tmp_path_factory):
    """Start both pools on every job, compute the references here
    meanwhile, then collect."""
    from rdfc_gan_tpu.parallel.mesh import make_mesh, spatial_sharding
    from jax.sharding import NamedSharding, PartitionSpec as P

    tmp = tmp_path_factory.mktemp("spatial")
    jeng, params, stats, teng, fargs, fpth = _flagship_weights(tmp)
    neng, nargs, npth = _nlspn_weights(tmp)
    rgb, raw = _batch(0)
    batch = dict(rgb=torch.from_numpy(rgb), raw=torch.from_numpy(raw))
    sharded_yaml = tmp / "sharded.yaml"
    sharded_yaml.write_text(TINY + "mesh_shape: {data: 1, model: 2}\n")
    drv = ["--batch_size", "4", "--out_height", "32", "--out_width", "64"]
    # the train step of a model axis: the flagship step of
    # test_torch_data_parallel at tiny widths, from its seeded nets
    torch.manual_seed(0)
    targs = _args(tmp, os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml"),
                  "t", ["--out_height", "32", "--out_width", "48"])
    tpth = str(tmp / "train.pth")
    save_checkpoint(build_engine(parse_config(targs), is_train=True,
                                 steps_per_epoch=4).modules, tpth)
    from rdfc_gan_torch.data import SyntheticDataset

    ds = SyntheticDataset(length=4, height=32, width=48)
    tbatch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(4)]))
              for k in ds[0]}
    tbatch = {k: v.permute(0, 3, 1, 2).contiguous() if v.dim() == 4 else v
              for k, v in tbatch.items()}
    jobs = {
        2: [("ops", "spatial_ops", dict(mesh={"model": 2}, cases=CASES)),
            ("flagship", "spatial_forward", dict(
                args=fargs, pth=fpth, batch=batch, meshes=GRIDS[2],
                depth_only=True)),
            ("nlspn", "spatial_forward", dict(
                args=nargs, pth=npth, batch=batch, meshes=GRIDS[2])),
            ("cli", "serve_cli", dict(args=_args(
                tmp, sharded_yaml, "d2", drv))),
            ("steps", "mesh_steps", dict(
                args=targs, pth=tpth, batch=tbatch,
                meshes=[{"data": 2}, {"data": 1, "model": 2}]))],
        4: [("ops", "spatial_ops", dict(mesh={"model": 4}, cases=CASES)),
            ("flagship", "spatial_forward", dict(
                args=fargs, pth=fpth, batch=batch, meshes=GRIDS[4]))]}
    collect = {}
    for world, js in jobs.items():
        (tmp / f"w{world}").mkdir()
        collect[world] = torch_dp_worker.start_ranks(js, str(tmp / f"w{world}"),
                                                     world=world)

    refs = {}
    with torch.inference_mode():
        refs["ops"] = [torch_dp_worker.build_op(c)(*c["inputs"])
                       for c in CASES]
        refs["flagship"] = {d: teng.forward_test(
            batch["rgb"], batch["raw"], depth_only=d) for d in (False, True)}
        refs["nlspn"] = neng.forward_test(batch["rgb"], batch["raw"])
    from rdfc_gan_torch import test as port_test

    (tmp / "tiny1.yaml").write_text(TINY)
    refs["cli"] = port_test.run(parse_config(_args(
        tmp, tmp / "tiny1.yaml", "d1", drv)))["metrics"]
    mesh = make_mesh({"data": 2, "model": 4}, devices=jax.devices()[:8])
    sp = spatial_sharding(mesh)
    repl = NamedSharding(mesh, P())
    jax_out = jax.jit(jeng._forward_test_impl)(
        jax.device_put(params, repl), jax.device_put(stats, repl),
        jax.device_put(jnp.asarray(rgb.transpose(0, 2, 3, 1)), sp),
        jax.device_put(jnp.asarray(raw.transpose(0, 2, 3, 1)), sp))
    refs["jax"] = {k: np.asarray(v).transpose(0, 3, 1, 2)
                   for k, v in jax_out.items()}
    ranks = {world: c() for world, c in collect.items()}
    return dict(refs=refs, ranks=ranks, targs=targs, tpth=tpth,
                tbatch=tbatch)


def _assemble(ranks, label, key, D, M):
    """The global tensor of each output from the ranks' shards: the M
    shards of a data row side by side, the rows stacked."""
    outs = [r[label][key][0] for r in ranks]
    return {k: torch.cat([torch.cat([outs[d * M + m][k] for m in range(M)],
                                    3) for d in range(D)])
            for k, v in outs[0].items() if v.dim() == 4}


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_rule_matches_unsharded_op(spatial_run, world, case):
    c = CASES[case]
    ranks = spatial_run["ranks"][world]
    want = spatial_run["refs"]["ops"][case]
    got = [r["ops"][case] for r in ranks]
    if c["kind"] == "in":
        y = torch.cat([g[0] for g in got], 3)
        _close(y, want, RTOL, ATOL, "instance norm y")
        _, a = nk.instance_norm_fwd_plain(c["inputs"][0], 1e-5)
        for g in got:
            ulps = (g[1].view(torch.int32).long()
                    - a.view(torch.int32).long()).abs().max()
            assert int(ulps) <= 1
        return
    _close(torch.cat(got, 3), want, RTOL, ATOL, c["kind"])


def test_instance_norm_split_at_one_rank_is_the_forward():
    """M = 1: moments, the finalize and apply compose to
    ``instance_norm_fwd_plain`` bit for bit, f32 and bf16."""
    for dt in (torch.float32, torch.bfloat16):
        x = (_x(50, (2, 5, 14, 19)) * 3 + 1.5).to(dt)
        y, a = nk.instance_norm_fwd_sharded(x, 1e-5)
        py, pa = nk.instance_norm_fwd_plain(x, 1e-5)
        assert torch.equal(a, pa) and torch.equal(y, py)
        s = nk.instance_norm_moments(x)
        assert s.dtype == torch.float64 and tuple(s.shape) == (2, 5, 2)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,M", [((2, 5, 14, 19), 1), ((4, 3, 17, 23), 1),
                                     ((2, 6, 12, 32), 2)])
def test_instance_norm_apply_plain_is_finalize_then_elementwise(shape, M, dt):
    """``instance_norm_apply_plain(x, sums, n, eps)`` equals
    ``instance_norm_finalize`` followed by the elementwise y = x T(a) +
    T(b), bit for bit, at a served, an odd and an M = 2 sharded plane (each
    shard's apply from the two shards' moments added)."""
    x = (_x(51, shape) * 3 + 1.5).to(dt)
    w = shape[3] // M
    parts = [x[..., m * w:(m + 1) * w].contiguous() for m in range(M)]
    sums = nk.instance_norm_moments_plain(parts[0])
    for p in parts[1:]:
        sums = sums + nk.instance_norm_moments_plain(p)
    n = shape[2] * shape[3]
    a, b = nk.instance_norm_finalize(sums, n, 1e-5)
    for p in parts:
        y, got_a = nk.instance_norm_apply_plain(p, sums, n, 1e-5)
        want = p * a[:, :, None, None].to(dt) + b[:, :, None, None].to(dt)
        assert y.dtype == dt and got_a.dtype == torch.float32
        assert torch.equal(y, want) and torch.equal(got_a, a)


def test_conv_cases_cover_the_served_nets():
    """Every convolution and pool of the flagship's three served nets (full
    widths) has its configuration among the cases above."""
    import torch.nn as nn

    from rdfc_gan_torch.models.normal_net import Conv2dSame

    from rdfc_gan_torch.models.label_net import PSPNet
    from rdfc_gan_torch.models.normal_net import NNET
    from rdfc_gan_torch.registry import build_generator

    cfg = parse_config(["--model_cfg_path", os.path.join(
        ROOT, "configs", "rdf_cycle_patchgan_config.yaml"), "--work_dir",
        "unused", "--device", "cpu"])
    with torch.device("meta"):
        nets = (build_generator(cfg.model.G_A2B.to_dict()),
                NNET(cfg.out_height, cfg.out_width), PSPNet(cfg.num_classes))
    seen = set()
    for net in nets:
        for m in net.modules():
            dw = m.groups > 1 if isinstance(m, nn.Conv2d) else False
            if isinstance(m, Conv2dSame):
                seen.add(("same", m.kernel_size[1], m.stride[1], dw))
            elif isinstance(m, nn.Conv2d):
                seen.add(("conv", m.kernel_size[1], m.stride[1],
                          m.dilation[1], m.padding[1], dw))
            elif isinstance(m, nn.ConvTranspose2d):
                seen.add(("convT", m.kernel_size, m.stride, m.padding,
                          m.output_padding))
            elif isinstance(m, nn.MaxPool2d):
                seen.add(("maxpool", m.kernel_size, m.stride, m.padding))
    covered = ({("conv",) + c for c in CONV_CASES}
               | {("same",) + c for c in SAME_CASES}
               | {("convT", (3, 3), (2, 2), (1, 1), (1, 1)),
                  ("maxpool", 3, 2, 1)})
    assert seen <= covered, sorted(seen - covered)
    assert {c for c in seen if c[0] == "conv"} == {("conv",) + c
                                                   for c in CONV_CASES}


@pytest.mark.parametrize("mesh", [str(m) for w in (2, 4) for m in GRIDS[w]])
def test_flagship_forward_matches_unsharded_and_jax(spatial_run, mesh):
    world = 2 if mesh == str(GRIDS[2][0]) else 4
    grid = eval(mesh)
    D, M = grid.get("data", 1), grid["model"]
    ranks = spatial_run["ranks"][world]
    refs = spatial_run["refs"]
    for depth_only in (False, True):
        if (mesh, depth_only) not in ranks[0]["flagship"]:
            continue
        key = (mesh, depth_only)
        got = _assemble(ranks, "flagship", key, D, M)
        want = refs["flagship"][depth_only]
        assert set(got) == set(want)
        assert ("pred_label" in got) != depth_only
        for k, v in want.items():
            _close(got[k], v, RTOL, ATOL, f"{mesh} {k} vs unsharded")
            _close(got[k], refs["jax"][k], JAX_RTOL, JAX_ATOL,
                   f"{mesh} {k} vs JAX spatial_sharding")
            assert tuple(ranks[0]["flagship"][key][0][k].shape) == (
                B // D, v.shape[1], H, W // M)
        # the assembled forward is the shards side by side, on every rank
        for r, rk in enumerate(ranks):
            d = r // M
            for k in want:
                assert torch.equal(rk["flagship"][key][1][k],
                                   got[k][d * (B // D):(d + 1) * (B // D)])


def test_nlspn_forward_matches_unsharded(spatial_run):
    ranks = spatial_run["ranks"][2]
    key = (str({"model": 2}), False)
    got = _assemble(ranks, "nlspn", key, 1, 2)
    want = spatial_run["refs"]["nlspn"]
    for k, v in want.items():
        if v.dim() == 4:
            _close(got[k], v, RTOL, ATOL, k)
    offs = [float(r["nlspn"][key][0]["nlspn_max_offset"]) for r in ranks]
    assert offs[0] == offs[1]
    np.testing.assert_allclose(offs[0], float(want["nlspn_max_offset"]),
                               rtol=RTOL)


def test_test_cli_with_a_model_axis_gives_world1_metrics(spatial_run):
    a, b = (r["cli"] for r in spatial_run["ranks"][2])
    assert a["metrics"] == b["metrics"]
    want = spatial_run["refs"]["cli"]
    for k, v in want.items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_model_axis_trains_as_data_parallelism(spatial_run):
    """One flagship step at {data: 1, model: 2} equals one at {data: 2},
    bit for bit, on both ranks."""
    for r in spatial_run["ranks"][2]:
        dp, mp = r["steps"]
        assert dp["losses"] == mp["losses"]
        for part in ("grads", "state"):
            for net, tensors in dp[part].items():
                for k, v in tensors.items():
                    assert torch.equal(v, mp[part][net][k]), (part, net, k)


def test_width_that_does_not_split_raises(tmp_path):
    """W = 96 over M = 2 (64 divides it not): refused before any rank
    computes or exchanges."""
    eng = build_engine(parse_config(_args(tmp_path, os.path.join(
        ROOT, "configs", "rdfc_gan_tiny.yaml"), "w")))
    grid = Grid(1, 2, 0, 0, None, None)
    x = torch.zeros(1, 3, 32, 96)
    with pytest.raises(ValueError, match=r"W divisible by 32 x M = 64"):
        eng.forward_test(x, x[:, :1], grid=grid)


def test_sharded_forward_that_needs_a_gradient_raises():
    grid = Grid(1, 2, 0, 0, None, None)
    with pytest.raises(RuntimeError, match="serves only"):
        with spatial.sharded(grid):
            pass
    x = torch.zeros(1, 2, 4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        nk.instance_norm_fwd_sharded(x, 1e-5)


def test_refused_op_fails_under_a_grid():
    """An op that reads across the width and has no rule fails rather
    than running on a shard as if it were the image."""
    import torch.nn.functional as F

    with torch.no_grad(), spatial.sharded(Grid(1, 2, 0, 0, None, None)):
        with pytest.raises(NotImplementedError, match="no width-sharded"):
            F.pad(torch.zeros(1, 1, 2, 2), (1, 1))


@pytest.mark.parametrize("mesh,world", [({"data": 2, "model": 2}, 4),
                                        ({"model": 4}, 4),
                                        ({"data": 1, "model": 1}, 1),
                                        ({"model": 2}, 2)])
def test_mesh_shape_of_the_world_is_accepted(mesh, world):
    from rdfc_gan_torch.parallel import check_mesh_shape
    from rdfc_gan_torch.parallel.dist import mesh_axes

    check_mesh_shape(mesh, world)
    D, M = mesh_axes(mesh, world)
    assert D * M == world and M == mesh.get("model", 1)


@pytest.mark.parametrize("mesh,world", [({"data": 2, "model": 2}, 2),
                                        ({"model": 3}, 4),
                                        ({"data": 1, "model": 2}, 1)])
def test_mesh_shape_of_another_world_raises(mesh, world):
    from rdfc_gan_torch.parallel import check_mesh_shape

    with pytest.raises(ValueError, match="must equal the world size"):
        check_mesh_shape(mesh, world)


def test_split_wrappers_never_take_plain_on_cuda(monkeypatch):
    """The IN split's wrappers launch their kernel, or raise, for a tensor
    that is not on the CPU."""
    from test_torch_no_jax import _never, _OnCard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("instance_norm_moments_plain", "instance_norm_apply_plain"):
        monkeypatch.setattr(nk, name, _never)
    x = _OnCard()
    for call in (lambda: nk.instance_norm_moments(x),
                 lambda: nk.instance_norm_apply(x, x, 4, 1e-5),
                 lambda: nk.instance_norm_fwd_sharded(x, 1e-5)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"), \
                torch.no_grad():
            call()


def test_no_grid_changes_nothing(monkeypatch):
    """Without a grid the helpers take their unsharded forms: no collective
    is called and the IN forward is the kernel's op (one launch a call on
    the card), not the split."""
    import torch.distributed as dist

    def refuse(*a, **k):
        raise AssertionError("a collective ran without a grid")

    for name in ("all_reduce", "all_gather", "broadcast"):
        monkeypatch.setattr(dist, name, refuse)
    monkeypatch.setattr(nk, "instance_norm_fwd_sharded", refuse)
    assert spatial.active() is None
    with torch.inference_mode():
        for c in CASES:
            torch_dp_worker.build_op(c)(*c["inputs"])
