"""Width-sharded serving at widths whose deeper layers do not split evenly
(``parallel.spatial``'s layout for uneven shards: ceil(W_l / M) columns a
rank, the columns past W_l padding on the last ranks), on the CPU: gloo
ranks of ``tests/torch_dp_worker.py``, pools of 2, 3 and 4 started once for
the module, each running its batch of jobs while the references are
computed here.

* Every rule against its unsharded op at M = 2, 3 and 4, at widths where
  a rank's input columns are not its output columns times the stride
  (25 columns: 13, 9 and 7 a rank, 7, 5 and 4 after a stride of 2), and
  at tiny widths where a rank holds no image column: every case of
  ``CONV_CASES`` and ``SAME_CASES``, the transposed conv, the transposed
  conv plus the skip's trim (whose shards differ from the skip's at M =
  3), the max pool on negative inputs, every ``bilinear_resize`` kind, the
  PSP module, the squeeze-excite mean, ``AdaIN`` and the instance norm's
  split. The padded input columns hold NaN, so a rule that read one would
  fail. Tolerance rtol 1e-4 / atol 1e-5; the instance norm's scale within
  one f32 ulp of ``instance_norm_fwd_plain``'s.
* The tiny flagship (``configs/rdfc_gan_tiny.yaml``, the JAX package's
  weights) at 2x3x64x96 on {model: 2} and {model: 3}, 2x3x64x104 on
  {model: 4}, and 2x3x64x40 on {model: 4}, where the 1/16 and 1/32 levels
  leave the last rank no image column: against the port's unsharded
  forward at 1e-4 / 1e-5 and against JAX's ``jit(engine._forward_test_
  impl)`` with its inputs placed by ``spatial_sharding(make_mesh({"data":
  2, "model": 4}))`` on the 8 host devices at 1e-3 / 1e-4 (the tolerances
  of ``tests/test_torch_spatial.py``). The tiny NLSPN RDF-GAN at 2x3x64x96
  on {model: 2} against its unsharded forward.
* ``rdfc_gan_torch.test`` with ``mesh_shape`` {data: 1, model: 2} at
  32x48 (48 is no multiple of 64) gives the world-1 metrics.
* ``check_width`` refuses exactly the widths ``device_put`` refuses with
  ``spatial_sharding``; the layout's helpers at W = 40 over M = 4.
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
from rdfc_gan_torch.parallel.grid import owned, shard_cols, valid_cols
from rdfc_gan_torch.utils.checkpoint import save_checkpoint
from rdfc_gan_torch.utils.convert import rdfcgan_state_dicts_from_jax
from test_torch_normal_net import randomize_norms
from test_torch_spatial import CONV_CASES, SAME_CASES, _nlspn_weights
from test_torch_train_step import TINY

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
JAX_RTOL, JAX_ATOL = 1e-3, 1e-4
B, H = 2, 64
SERVED = ("G_A2B", "G_normal", "G_label")
WORLDS = (2, 3, 4)
# (label, width, world, mesh) of each flagship forward
FORWARDS = [("w96_model2", 96, 2, {"model": 2}),
            ("w96_model3", 96, 3, {"model": 3}),
            ("w104_model4", 104, 4, {"model": 4}),
            ("w40_model4", 40, 4, {"model": 4})]


def _x(seed, shape):
    return torch.from_numpy(np.random.RandomState(seed).normal(
        size=shape).astype(np.float32))


def _neg(seed, shape):
    return -_x(seed, shape).abs() - 1.0


def _cases():
    """Every op case: kind, its parameters, its inputs (global)."""
    cases = [dict(kind="conv", conv=c, inputs=[_x(i, (B, 4, 6, 25))])
             for i, c in enumerate(CONV_CASES)]
    cases += [dict(kind="same", conv=c, inputs=[_x(20 + i, (B, 4, 6, 25))])
              for i, c in enumerate(SAME_CASES)]
    cases += [
        # a deep level: 5 columns over 4 ranks leave the last none, 3
        # over 4 the last none after the stride
        dict(kind="conv", conv=(3, 2, 1, 1, False),
             inputs=[_x(60, (B, 4, 6, 5))]),
        dict(kind="same", conv=(5, 2, True), inputs=[_x(61, (B, 4, 6, 3))]),
        dict(kind="convT", inputs=[_x(30, (B, 4, 5, 13))]),
        dict(kind="convT", inputs=[_x(62, (B, 4, 5, 3))]),
        # the decoder's overhang: 5 -> 10 trimmed to a skip of 9 (at M = 3
        # 4 columns a rank against the skip's 3), 13 -> 26 to 25
        dict(kind="convT_trim", inputs=[_x(63, (B, 4, 5, 5)),
                                        _x(64, (B, 2, 9, 9))]),
        dict(kind="convT_trim", inputs=[_x(65, (B, 4, 5, 13)),
                                        _x(66, (B, 2, 10, 25))]),
        dict(kind="maxpool", inputs=[_neg(31, (B, 4, 6, 25))]),
        dict(kind="maxpool", inputs=[_neg(67, (B, 4, 6, 3))]),
        # 2x align-corners to an odd skip, 7 -> 50 (a 1/8 map back to
        # the image), to NNET's skip size (10 -> 19), half-pixel up and
        # antialiased down, a PSP bin's whole map to an odd width
        dict(kind="resize", size=(10, 25), align=True,
             inputs=[_x(32, (B, 3, 5, 13))]),
        dict(kind="resize", size=(32, 50), align=True,
             inputs=[_x(33, (B, 3, 4, 7))]),
        dict(kind="resize", size=(9, 19), align=True,
             inputs=[_x(34, (B, 3, 5, 10))]),
        dict(kind="resize", size=(8, 26), align=False,
             inputs=[_x(35, (B, 3, 4, 13))]),
        dict(kind="resize", size=(4, 13), align=False,
             inputs=[_x(36, (B, 3, 8, 50))]),
        dict(kind="resize", size=(12, 25), align=True, whole=True,
             inputs=[_x(37, (B, 3, 6, 6))]),
        dict(kind="psp", c=8, inputs=[_x(38, (B, 8, 6, 25))]),
        dict(kind="se", c=8, inputs=[_x(39, (B, 8, 5, 25))]),
        dict(kind="adain", inputs=[_x(40, (B, 4, 5, 25)),
                                   _x(41, (B, 4, 5, 25)) * 2 + 1]),
        dict(kind="in", c=3, inputs=[_x(42, (B, 3, 5, 25)) * 3 + 1.5]),
        dict(kind="in", c=3, inputs=[_x(68, (B, 3, 5, 5)) * 3 + 1.5])]
    return cases


CASES = _cases()
CASE_IDS = [f"{c['kind']}{i}" for i, c in enumerate(CASES)]


def _args(tmp, config, work, width, extra=()):
    return ["--dataset", "synthetic", "--model_cfg_path", str(config),
            "--work_dir", str(tmp / work), "--out_height", str(H),
            "--out_width", str(width), "--num_workers", "1", "--device",
            "cpu", *extra]


def _batch(seed, width):
    r = np.random.RandomState(seed)
    rgb = r.uniform(-1, 1, (B, 3, H, width)).astype(np.float32)
    raw = (r.normal(size=(B, 1, H, width))
           * (r.uniform(size=(B, 1, H, width)) > 0.6)).astype(np.float32)
    return rgb, raw


def _jax_engine(tmp, width):
    from rdfc_gan_tpu.cli import parse_config as jax_parse_config
    from rdfc_gan_tpu.engines import build_engine as jax_build_engine

    config = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
    return jax_build_engine(jax_parse_config(
        _args(tmp, config, f"j{width}", width)[:-2]), is_train=False)


def _flagship_weights(tmp):
    """The JAX flagship's three served nets' trees (norm leaves drawn) and
    a port checkpoint holding them."""
    jeng = _jax_engine(tmp, 96)
    x, d = jnp.zeros((B, H, 96, 3)), jnp.zeros((B, H, 96, 1))
    inputs = {"G_A2B": (x, d, x), "G_normal": (x,), "G_label": (x,)}
    params, stats = {}, {}
    for i, k in enumerate(SERVED):
        p, s = jeng._init_net(jax.random.PRNGKey(i), k, *inputs[k],
                              train=False)
        scale = (0.3, 0.6) if k == "G_label" else (0.8, 1.2)
        params[k] = randomize_norms(p, 10 + i, scale=scale)
        stats[k] = randomize_norms(s, 20 + i)
    config = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
    teng = build_engine(parse_config(_args(tmp, config, "f", 96)))
    sds = rdfcgan_state_dicts_from_jax(
        params, stats, normal_depth=teng.cfg.model.Normal_G.depth)
    for k in SERVED:
        teng.modules[k].load_state_dict(sds[k], strict=False)
    pth = str(tmp / "flagship.pth")
    save_checkpoint(teng.modules, pth)
    return params, stats, pth


@pytest.fixture(scope="module")
def uneven_run(tmp_path_factory):
    """Start the three pools on every job, compute the references here
    meanwhile, then collect."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rdfc_gan_tpu.parallel.mesh import make_mesh, spatial_sharding

    tmp = tmp_path_factory.mktemp("uneven")
    params, stats, fpth = _flagship_weights(tmp)
    neng, _, npth = _nlspn_weights(tmp)
    config = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
    batches = {w: _batch(w, w) for w in {f[1] for f in FORWARDS}}
    nargs = _args(tmp, tmp / "tiny.yaml", "n96", 96)
    sharded_yaml = tmp / "sharded.yaml"
    sharded_yaml.write_text(TINY + "mesh_shape: {data: 1, model: 2}\n")
    drv = ["--batch_size", "4", "--out_height", "32", "--out_width", "48"]
    jobs = {w: [("ops", "spatial_ops", dict(mesh={"model": w},
                                            cases=CASES))] for w in WORLDS}
    for label, width, world, mesh in FORWARDS:
        rgb, raw = batches[width]
        jobs[world].append((label, "spatial_forward", dict(
            args=_args(tmp, config, label, width), pth=fpth,
            batch=dict(rgb=torch.from_numpy(rgb), raw=torch.from_numpy(raw)),
            meshes=[mesh])))
    rgb, raw = batches[96]
    jobs[2] += [("nlspn", "spatial_forward", dict(
        args=nargs, pth=npth, meshes=[{"model": 2}],
        batch=dict(rgb=torch.from_numpy(rgb), raw=torch.from_numpy(raw)))),
        ("cli", "serve_cli", dict(args=_args(tmp, sharded_yaml, "d2", 48,
                                             drv)))]
    collect = {}
    for world, js in jobs.items():
        (tmp / f"w{world}").mkdir()
        collect[world] = torch_dp_worker.start_ranks(
            js, str(tmp / f"w{world}"), world=world)

    refs = {"flagship": {}, "jax": {}}
    with torch.inference_mode():
        refs["ops"] = [torch_dp_worker.build_op(c)(*c["inputs"])
                       for c in CASES]
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    mesh = make_mesh({"data": 2, "model": 4}, devices=jax.devices()[:8])
    sp, repl = spatial_sharding(mesh), NamedSharding(mesh, P())
    jparams, jstats = (jax.device_put(t, repl) for t in (params, stats))
    for width, (rgb, raw) in batches.items():
        teng = build_engine(parse_config(_args(tmp, config, f"u{width}",
                                               width)))
        load_checkpoint(teng.modules, fpth)
        refs["flagship"][width] = teng.forward_test(
            torch.from_numpy(rgb), torch.from_numpy(raw))
        out = jax.jit(_jax_engine(tmp, width)._forward_test_impl)(
            jparams, jstats,
            jax.device_put(jnp.asarray(rgb.transpose(0, 2, 3, 1)), sp),
            jax.device_put(jnp.asarray(raw.transpose(0, 2, 3, 1)), sp))
        refs["jax"][width] = {k: np.asarray(v).transpose(0, 3, 1, 2)
                              for k, v in out.items()}
    rgb, raw = batches[96]
    refs["nlspn"] = neng.forward_test(torch.from_numpy(rgb),
                                      torch.from_numpy(raw))
    (tmp / "tiny1.yaml").write_text(TINY)
    refs["cli"] = port_test.run(parse_config(_args(
        tmp, tmp / "tiny1.yaml", "d1", 48, drv)))["metrics"]
    ranks = {world: c() for world, c in collect.items()}
    return dict(refs=refs, ranks=ranks)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _assemble(ranks, label, key):
    """The global width of each 4-D output: the ranks' shards side by
    side (one data row)."""
    outs = [r[label][key][0] for r in ranks]
    return {k: torch.cat([o[k] for o in outs], 3)
            for k, v in outs[0].items() if v.dim() == 4}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_rule_matches_unsharded_op_at_uneven_shards(uneven_run, world, case):
    """The ranks' output shards side by side: ceil(W_out / M) columns a
    rank, the first W_out of them the unsharded op's output."""
    c = CASES[case]
    want = uneven_run["refs"]["ops"][case]
    got = [r["ops"][case] for r in uneven_run["ranks"][world]]
    y = [g[0] for g in got] if c["kind"] == "in" else got
    W_out = want.shape[3]
    assert {t.shape[3] for t in y} == {shard_cols(W_out, world)}
    _close(torch.cat(y, 3)[..., :W_out], want, RTOL, ATOL, c["kind"])
    if c["kind"] == "in":
        _, a = nk.instance_norm_fwd_plain(c["inputs"][0], 1e-5)
        for g in got:
            ulps = (g[1].view(torch.int32).long()
                    - a.view(torch.int32).long()).abs().max()
            assert int(ulps) <= 1


@pytest.mark.parametrize("label,width,world,mesh", FORWARDS,
                         ids=[f[0] for f in FORWARDS])
def test_flagship_forward_at_uneven_levels(uneven_run, label, width, world,
                                           mesh):
    """Each rank returns its W / M columns; side by side they are the
    unsharded forward and JAX's spatial_sharding forward, and the
    assembled forward on every rank."""
    ranks = uneven_run["ranks"][world]
    key = (str(mesh), False)
    got = _assemble(ranks, label, key)
    want = uneven_run["refs"]["flagship"][width]
    jax_out = uneven_run["refs"]["jax"][width]
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(ranks[0][label][key][0][k].shape) == (
            B, v.shape[1], H, width // world)
        _close(got[k], v, RTOL, ATOL, f"{label} {k} vs unsharded")
        _close(got[k], jax_out[k], JAX_RTOL, JAX_ATOL,
               f"{label} {k} vs JAX spatial_sharding")
        for rk in ranks:
            assert torch.equal(rk[label][key][1][k], got[k])


def test_nlspn_forward_at_uneven_levels(uneven_run):
    ranks = uneven_run["ranks"][2]
    key = (str({"model": 2}), False)
    got = _assemble(ranks, "nlspn", key)
    want = uneven_run["refs"]["nlspn"]
    for k, v in want.items():
        if v.dim() == 4:
            _close(got[k], v, RTOL, ATOL, k)
    offs = [float(r["nlspn"][key][0]["nlspn_max_offset"]) for r in ranks]
    assert offs[0] == offs[1]
    np.testing.assert_allclose(offs[0], float(want["nlspn_max_offset"]),
                               rtol=RTOL)


def test_test_cli_at_a_width_of_no_multiple_of_64(uneven_run):
    a, b = (r["cli"] for r in uneven_run["ranks"][2])
    assert a["metrics"] == b["metrics"]
    want = uneven_run["refs"]["cli"]
    assert set(a["metrics"]) == set(want) and len(want) == 8
    for k, v in want.items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("W,M", [(304, 2), (304, 4), (304, 8), (640, 8),
                                 (96, 2), (98, 4), (97, 2), (97, 4),
                                 (100, 8)])
def test_check_width_refuses_what_device_put_refuses(W, M):
    from rdfc_gan_tpu.parallel.mesh import make_mesh, spatial_sharding

    mesh = make_mesh({"data": 8 // M, "model": M}, devices=jax.devices()[:8])
    try:
        jax.device_put(jnp.zeros((1, 2, W, 1)), spatial_sharding(mesh))
        jax_refuses = False
    except ValueError:
        jax_refuses = True
    try:
        spatial.check_width(W, M)
        refused = False
    except ValueError as e:
        assert "should be divisible by" in str(e)
        refused = True
    assert refused == jax_refuses == bool(W % M)


def test_layout_at_40_over_4():
    """The levels of a 40-wide input over 4 ranks: ceil(W_l / 4) columns a
    rank, the image columns on the first ranks; at 1/16 and 1/32 the last
    rank holds none."""
    want = {40: [10, 10, 10, 10], 20: [5, 5, 5, 5], 10: [3, 3, 3, 1],
            5: [2, 2, 1, 0], 3: [1, 1, 1, 0], 2: [1, 1, 0, 0]}
    for W, cols in want.items():
        assert [valid_cols(W, 4, m) for m in range(4)] == cols
        c = shard_cols(W, 4)
        assert [owned(W, 4, m) for m in range(4)] == [
            (m * c, (m + 1) * c) for m in range(4)]
