"""Data parallelism of the port on the CPU: two gloo ranks
(``tests/torch_dp_worker.py``, started once for the module while the
references are computed here), each with its half of a global batch.

* One RDFGAN train step at world 2 against the JAX step on the global batch
  through the JAX package's own data-parallel path (``make_mesh({"data":
  2})``, ``shard_batch``, ``replicate_state`` over the conftest's CPU
  devices), on the small NLSPN config of ``tests/test_torch_train_step.py``
  with its tolerances and its first batch (rows 0 and 1, one a rank): once
  as it is, once with depth masks that differ between the two halves (a
  rank's own mask sum as the image weight's denominator would fail it).
  Those tolerances were set on 2-row batches; on 4 rows the port at world
  1 already differs from JAX past them in a few tensors (3e-3 of the
  largest entry of ``id_dec1.0.weight``), as more pixels put the L1
  terms' sign and the activations' kinks within f32 noise of their switch,
  while world 2 and world 1 of the port agree there within 5e-5.
* World 2 against world 1 in the port: the wgangp RDFGAN step (the
  penalty's draw is the global batch's) and a flagship step at
  ``configs/rdfc_gan_tiny.yaml`` widths (the pepper and dropout draws are
  the global batch's).
* The rank-sharded loader against the JAX ``_indices(per_process=True)``;
  the evaluator's gather and dedupe against the JAX evaluator on a split
  that neither the batch nor the world divides.
* ``python -m torch.distributed.run --nproc_per_node 2 -m
  rdfc_gan_torch.train --device cpu``: rank 0 alone writes, and a
  ``--resume_from`` at world 2 continues; ``mesh_shape`` whose data x
  model is not the world size, or that names another axis, raises
  ``ValueError``.
* World 1 keeps the one-process forms: no collective, BatchNorm through
  torch's fused kernel.

Tolerances of world 2 against world 1 in the port (f32): those the port
is held to against JAX. Losses rtol 1e-5 (the same sums split over two
ranks: f32 rounding apart). The wgangp RDFGAN step: as the first step of
``tests/test_torch_train_step.py`` (each gradient within 2e-4 of its
tensor's largest entry plus 5e-6; parameters after Adam within 2e-5 + 1e-5
|p|, or 2 lr where the gradient lies inside its tolerance and Adam's step
may take the other sign; running statistics rtol 1e-4 / atol 1e-5). The
flagship step: as ``tests/test_torch_rdfc_train_step.py`` holds it
(``_assert_grads``, ``_assert_params``: relative L2 errors per tensor and
per net, noise-level tensors, Adam's 2 lr). At 32x48 and batch 4 its
BatchNorms normalise over a few values and its (Leaky)ReLUs sit within
rounding of their kinks, so the world-2 form's other rounding moves its
gradients by up to 5% of a tensor's largest entry, which that test's
tolerances were set for; a rank's own statistics or denominators move
them by tens of percent.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from rdfc_gan_torch.cli import parse_config
from rdfc_gan_torch.data import DataLoader as TLoader
from rdfc_gan_torch.data import SyntheticDataset
from rdfc_gan_torch.engines import build_engine
from rdfc_gan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from rdfc_gan_torch.utils.convert import (patchgan_state_dict_from_jax,
                                          rdf_generator_state_dict_from_jax)
from test_torch_train_step import (TINY, _assert_grads, _assert_state,
                                   _engines)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB = 4  # the global batch: 2 rows a rank


def _global_batch(unequal: bool, rows: int = GB):
    """``rows`` synthetic rows at 32x48 as (torch NCHW, numpy NHWC);
    ``unequal`` keeps a third of rank 0's depth pixels and all of rank
    1's."""
    ds = SyntheticDataset(length=8, height=32, width=48)
    nb = {k: np.stack([ds[i][k] for i in range(rows)]) for k in ds[0]}
    if unequal:
        half = rows // 2
        keep = np.random.RandomState(7).uniform(
            size=nb["depth_masks"][:half].shape) < 0.33
        nb["depth_masks"][:half] = keep.astype(np.float32)
    tb = {k: torch.from_numpy(v.copy()).permute(0, 3, 1, 2).contiguous()
          if v.ndim == 4 else torch.from_numpy(v.copy())
          for k, v in nb.items()}
    return tb, nb


def _rdfgan_args(tmp_path, gan_loss):
    return ["--dataset", "synthetic", "--model_cfg_path",
            str(tmp_path / "tiny.yaml"), "--work_dir", str(tmp_path / "w"),
            "--gan_loss_type", gan_loss, "--device", "cpu"]


def _flagship_args(tmp_path):
    return ["--dataset", "synthetic", "--model_cfg_path",
            os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml"), "--work_dir",
            str(tmp_path / "f"), "--out_height", "32", "--out_width", "48",
            "--device", "cpu"]


def _world1(args, pth, batch, **kw):
    """One port step at world 1 from ``pth``: (losses, grads, state)."""
    engine = build_engine(parse_config(args), is_train=True,
                          steps_per_epoch=4)
    load_checkpoint(engine.modules, pth)
    losses = engine.train_step(batch, **kw)
    return (
        {k: float(v) for k, v in losses.items()},
        {k: {n: p.grad.clone() for n, p in m.named_parameters()
             if p.grad is not None} for k, m in engine.modules.items()},
        {k: {n: v.clone() for n, v in m.state_dict().items()}
         for k, m in engine.modules.items()})


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Start the two ranks on every job, compute the references here
    meanwhile, then collect."""
    tmp = tmp_path_factory.mktemp("dp")
    te, je, state = _engines(tmp, "lsgan")
    gd = str(tmp / "GD.pth")
    save_checkpoint(te.modules, gd)
    (tmp / "tiny_wgangp").mkdir()
    (tmp / "tiny_wgangp" / "tiny.yaml").write_text(TINY)
    wg_args = _rdfgan_args(tmp / "tiny_wgangp", "wgangp")
    fl_args = _flagship_args(tmp)
    torch.manual_seed(0)
    fl = build_engine(parse_config(fl_args), is_train=True, steps_per_epoch=4)
    fpth = str(tmp / "flagship.pth")
    save_checkpoint(fl.modules, fpth)
    del fl
    pairs = _global_batch(False, 2), _global_batch(True, 2)
    unequal = _global_batch(True)
    jobs = [
        ("rdfgan", "train_steps", dict(
            args=_rdfgan_args(tmp, "lsgan"), pth=gd,
            cases=[dict(batch=p[0]) for p in pairs])),
        ("wgangp", "train_steps", dict(
            args=wg_args, pth=gd,
            cases=[dict(batch=unequal[0], kwargs=dict(update_g=False))])),
        ("flagship", "train_steps", dict(
            args=fl_args, pth=fpth, cases=[dict(batch=unequal[0])])),
        ("evaluate", "evaluate", dict(n=7, batch=3)),
    ]
    collect = torch_dp_worker.start_ranks(jobs, str(tmp))

    from rdfc_gan_tpu.parallel import (make_mesh, replicate_state,
                                       shard_batch)

    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    step = jax.jit(je._train_step_impl, static_argnames=("update_g",))
    rstate = replicate_state(state, mesh)
    jax_out = []
    for _, nb in pairs:
        jb = shard_batch({k: jnp.asarray(v) for k, v in nb.items()}, mesh)
        new, losses = step(rstate, jb, jax.random.PRNGKey(10), update_g=True)
        jax_out.append((jax.device_get(new), jax.device_get(losses)))
    ref = dict(wgangp=_world1(wg_args, gd, unequal[0], update_g=False),
               flagship=_world1(fl_args, fpth, unequal[0]))
    return dict(te=te, state=state, jax=jax_out, ref=ref, ranks=collect())


def _ranks_agree(ranks, label, case=0):
    """The ranks' gradients and nets after the step are bit-equal."""
    a, b = (r[label][case] for r in ranks)
    for part in ("grads", "state"):
        for net in a[part]:
            for k, v in a[part][net].items():
                assert torch.equal(v, b[part][net][k]), (part, net, k)
    return a, b


@pytest.mark.parametrize("case", ["equal_masks", "unequal_masks"])
def test_rdfgan_world2_matches_jax_global_step(dp, case):
    i = ["equal_masks", "unequal_masks"].index(case)
    a, b = _ranks_agree(dp["ranks"], "rdfgan", i)
    new_state, want = dp["jax"][i]
    got = {k: a["losses"][k] + b["losses"][k] for k in a["losses"]}
    got["nlspn_max_offset"] = max(a["losses"]["nlspn_max_offset"],
                                  b["losses"]["nlspn_max_offset"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    te, state = dp["te"], dp["state"]
    for net, to_sd in (("D", patchgan_state_dict_from_jax),
                       ("G", rdf_generator_state_dict_from_jax)):
        mod = te.modules[net]
        mod.load_state_dict(a["state"][net])
        for n, p in mod.named_parameters():
            p.grad = a["grads"][net].get(n)
        jgrad = new_state.opt_states[net][1]
        _assert_grads(mod, jgrad, to_sd, state.batch_stats[net], 0)
        _assert_state(mod, new_state.params[net], new_state.batch_stats[net],
                      jgrad, to_sd, te.cfg.lr, 1)


class _Param:
    """A parameter's value and gradient, as the flagship test's checks
    read a module's."""

    def __init__(self, value, grad):
        self.value, self.grad = value, grad

    def detach(self):
        return self.value


class _Net:
    def __init__(self, values, grads):
        self.params = [(k, _Param(v, grads.get(k))) for k, v in values.items()
                       if k in grads or "running" not in k]

    def named_parameters(self):
        return self.params


@pytest.mark.parametrize("label", ["wgangp", "flagship"])
def test_world2_step_matches_world1(dp, label):
    a, b = _ranks_agree(dp["ranks"], label)
    losses, grads, state = dp["ref"][label]
    for k, v in losses.items():
        if k == "nlspn_max_offset":
            got = max(a["losses"][k], b["losses"][k])
        else:
            got = a["losses"][k] + b["losses"][k]
        np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-7, err_msg=k)
    for net, g in grads.items():
        assert set(a["grads"][net]) == set(g), net
        for name, want in state[net].items():
            if "running" in name:
                np.testing.assert_allclose(a["state"][net][name].numpy(),
                                           want.numpy(), rtol=1e-4,
                                           atol=1e-5, err_msg=f"{net}.{name}")
            elif name.endswith("num_batches_tracked"):
                assert torch.equal(a["state"][net][name], want), name
        if label == "flagship":
            from test_torch_rdfc_train_step import (_assert_grads,
                                                    _assert_params)

            got = _Net(a["state"][net], a["grads"][net])
            checked = _assert_grads(got, g, net)
            _assert_params(got, state[net], checked, 2e-3)
            continue
        for name, want in g.items():
            w, got = want.numpy(), a["grads"][net][name].numpy()
            gtol = 2e-4 * np.abs(w).max() + 5e-6
            np.testing.assert_allclose(got, w, rtol=0, atol=gtol,
                                       err_msg=f"{net}.{name}")
            p = state[net][name].numpy()
            atol = np.where(np.abs(w) <= gtol, 2 * 2e-3,
                            2e-5 + 1e-5 * np.abs(p))
            assert (np.abs(a["state"][net][name].numpy() - p)
                    <= atol).all(), (net, name)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_rank_loader_matches_jax_per_process(monkeypatch, world, shuffle):
    from rdfc_gan_tpu.data import DataLoader as JLoader

    ds = SyntheticDataset(length=10, height=4, width=6)
    shards = []
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        j = JLoader(ds, 2, shuffle=shuffle, drop_last=False, seed=3,
                    per_process=True)
        t = TLoader(ds, 2, shuffle=shuffle, drop_last=False, seed=3,
                    rank=r, world=world)
        for epoch in (0, 1):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            np.testing.assert_array_equal(t.indices(), j._indices())
        assert len(t) == len(j)
        shards.append(t.indices())
    # equal lengths; together the padded global order, dealt round-robin
    assert len({len(s) for s in shards}) == 1
    order = TLoader(ds, 2, shuffle=shuffle, seed=3)
    order.set_epoch(1)
    full = order.indices()
    pad = -len(full) % world
    dealt = np.stack(shards, axis=1).reshape(-1)
    np.testing.assert_array_equal(dealt, np.concatenate([full,
                                                         full[:pad]]))


def test_evaluator_gathers_and_dedupes_as_jax(dp):
    """7 images, batch 3 a rank, 2 ranks: 4 images a rank, rank 1's last a
    shard-padding duplicate, and each rank's second batch padded with two
    pad rows; the gathered metrics equal the JAX evaluator's over the
    whole split, on every rank."""
    from rdfc_gan_tpu.data import DataLoader as JLoader
    from rdfc_gan_tpu.evaluator import Eval as JEval

    a, b = (r["evaluate"] for r in dp["ranks"])
    assert a["metrics"] == b["metrics"]
    assert a["n_batches"] == b["n_batches"] == 2
    assert sorted(set(a["local"]) | set(b["local"])) == list(range(7))
    assert sorted(a["idx"]) == sorted(b["idx"]) and len(a["idx"]) == 8
    assert sorted(set(a["idx"])) == list(range(7))

    class Model:
        def forward_test(self, state, rgb, raw_depth, depth_only=False):
            return {"pred_depth": jnp.tanh(raw_depth + 0.3 * rgb[..., :1])}

    ds = SyntheticDataset(length=7, height=8, width=12)
    want = JEval(JLoader(ds, 2, shuffle=False, drop_last=False,
                         with_indices=True)).evaluate(Model(), None,
                                                      logger=_Quiet())
    for k, v in want.items():
        np.testing.assert_allclose(a["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)


class _Quiet:
    def log(self, msg):
        pass


def _torchrun(tmp_path, work, extra=()):
    """The port's train entry point on 2 gloo ranks through torchrun."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY.replace("compute_dtype: float32\n", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "rdfc_gan_torch.train",
           "--dataset", "synthetic", "--model_cfg_path", str(cfg),
           "--work_dir", str(tmp_path / work), "--out_height", "32",
           "--out_width", "48", "--batch_size", "16", "--num_workers", "1",
           "--log_interval", "1", "--save_interval", "1",
           "--start_eval_epoch", "0", "--device", "cpu", *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def test_torchrun_two_ranks_train_and_resume(tmp_path):
    _torchrun(tmp_path, "w1", ["--n_epochs", "1"])
    w1 = tmp_path / "w1"
    # rank 0 alone writes: one log with rank 0's lines, whole checkpoints
    assert sorted(p.name for p in w1.iterdir()) == [
        "best.pth", "config.yaml", "epoch_1.pth", "train.log"]
    log = (w1 / "train.log").read_text()
    assert "rank 0 of 2" in log and "rank 1 of 2" not in log
    # 64 samples over 2 ranks at 16 a rank: 2 steps an epoch
    assert "train batches/epoch 2" in log
    ck = torch.load(w1 / "epoch_1.pth", weights_only=True)
    assert ck["meta"] == {"epoch": 1, "batch_size": 16}
    assert ck["G_optimizer_state_dict"]["state"]
    _torchrun(tmp_path, "w2", ["--n_epochs", "2", "--resume_from",
                               str(w1 / "epoch_1.pth")])
    log2 = (tmp_path / "w2" / "train.log").read_text()
    assert "resumed from" in log2 and "at epoch 1" in log2
    assert len(re.findall(r"epoch 1 iter \d+ ", log2)) == 2
    assert (tmp_path / "w2" / "epoch_2.pth").exists()
    assert not (tmp_path / "w2" / "epoch_1.pth").exists()


@pytest.mark.parametrize("mesh_shape,match", [
    ({"data": 3}, "world size 1"),
    ({"data": 1, "model": 2}, "must equal the world size 1"),
    ({"data": 1, "seq": 1}, "unknown axes"),
])
def test_mesh_shape_other_than_the_ranks_raises(mesh_shape, match):
    from rdfc_gan_torch.parallel import init_distributed

    cfg = parse_config(["--model_cfg_path", os.path.join(
        ROOT, "configs", "rdfc_gan_tiny.yaml"), "--work_dir", "unused",
        "--device", "cpu"])
    cfg["mesh_shape"] = mesh_shape
    with pytest.raises(ValueError, match=match):
        init_distributed(cfg)
    cfg["mesh_shape"] = {"data": 1, "model": 1}
    assert init_distributed(cfg) == (torch.device("cpu"), False)


def test_world1_runs_no_collective(monkeypatch):
    """Without a process group the BatchNorm takes torch's fused kernel (bit
    for bit) and no collective is called on a train step's path."""
    import torch.distributed as dist

    from rdfc_gan_torch.models.layers import BatchNorm2d
    from rdfc_gan_torch.parallel import (all_reduce_grads, all_reduce_sum,
                                         rank_rows, world_size)

    def refuse(*a, **k):
        raise AssertionError("a collective ran at world 1")

    for name in ("all_reduce", "broadcast", "all_gather_object", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    assert world_size() == 1
    x = torch.from_numpy(np.random.RandomState(0).normal(
        size=(3, 4, 5, 6)).astype(np.float32))
    bn = BatchNorm2d(4).train()
    ref = torch.nn.BatchNorm2d(4).train()
    assert torch.equal(bn(x), ref(x))
    t = torch.arange(4.0)
    assert all_reduce_sum(t) is t and rank_rows(t) is t
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.ones(2)
    all_reduce_grads([p])
    assert torch.equal(p.grad, torch.ones(2))
