"""One rank of the port's multi-rank CPU tests: a gloo process group over
``tcp://localhost:PORT``, one intra-op thread, torch and the port only.

    python tests/torch_dp_worker.py RANK WORLD PORT JOBS OUT_DIR

``JOBS`` is a ``torch.save``d list of (label, job, inputs) that the test
wrote; each job (a function below) runs in turn (every rank runs the same
collectives in the same order) and writes ``OUT_DIR/{label}_{rank}.pt``.
Global batches come in whole; each rank takes its rows with
``parallel.rank_rows``. ``start_ranks`` starts the ranks and returns the
function that waits for them and reads their results, so a test computes
its reference while they run.
"""

import datetime
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rdfc_gan_torch.parallel import rank_rows  # noqa: E402


def _rows(obj):
    """This rank's rows of every tensor in ``obj`` (dicts, tuples walked);
    a 0-d tensor (a draw for the whole batch) is every rank's."""
    if isinstance(obj, dict):
        return {k: _rows(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_rows(v) for v in obj)
    if isinstance(obj, torch.Tensor) and obj.dim():
        return rank_rows(obj)
    return obj


def _grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def sync_bn(inp):
    """The port's BatchNorm2d in train mode on this rank's rows, f32 and
    bf16: y, the gradients of x, gamma and beta, the running statistics."""
    from rdfc_gan_torch.models.layers import BatchNorm2d

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        bn = BatchNorm2d(inp["x"].shape[1]).train()
        bn.load_state_dict(inp["sd"])
        x = rank_rows(inp["x"]).to(dt).requires_grad_(True)
        y = bn(x)
        y.backward(rank_rows(inp["dy"]).to(dt))
        out[str(dt)] = dict(y=y.detach().float(), dx=x.grad.float(),
                            dgamma=bn.weight.grad.clone(),
                            dbeta=bn.bias.grad.clone(), **_state(bn))
    return out


def fused_block(inp):
    """The fused train-mode BasicBlock (the conv kernels' plain versions)
    on this rank's rows, the loss sum(out * wr) of the rows; the gradients
    summed over the ranks as the engines sum them."""
    from rdfc_gan_torch.models.resnet import BasicBlock
    from rdfc_gan_torch.parallel import all_reduce_grads

    C = inp["x"].shape[1]
    blk = BasicBlock(C, C).train()
    blk.load_state_dict(inp["sd"])
    assert blk.fused()
    x = rank_rows(inp["x"]).requires_grad_(True)
    y = blk(x)
    (y * rank_rows(inp["wr"])).sum().backward()
    all_reduce_grads(blk.parameters())
    return dict(y=y.detach(), dx=x.grad, grads=_grads(blk), state=_state(blk))


def _engine(inp):
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    cfg = parse_config(inp["args"])
    engine = build_engine(cfg, is_train=True, steps_per_epoch=4)
    load_checkpoint(engine.modules, inp["pth"])
    return engine


def train_steps(inp):
    """For each case, a fresh engine of ``args`` loaded from ``pth``, one
    train step on this rank's rows (``kwargs`` handed to ``train_step``,
    their tensors the global batch's, of which the rank takes its rows):
    the losses, every net's gradients and state after the step."""
    out = []
    for case in inp["cases"]:
        engine = _engine(inp)
        losses = engine.train_step(_rows(case["batch"]),
                                   **_rows(case.get("kwargs", {})))
        out.append(dict(
            losses={k: float(v) for k, v in losses.items()},
            grads={k: _grads(m) for k, m in engine.modules.items()},
            state={k: _state(m) for k, m in engine.modules.items()}))
    return out


def evaluate(inp):
    """The evaluator over this rank's shard of a synthetic split with a
    fixed function of the inputs for a model: the metrics and the gathered
    sample indices."""
    from rdfc_gan_torch.data import DataLoader, SyntheticDataset
    from rdfc_gan_torch.evaluator import Eval
    from rdfc_gan_torch.parallel import rank, world_size

    class Model:
        def forward_test(self, rgb, raw_depth, depth_only=False):
            return {"pred_depth": torch.tanh(raw_depth + 0.3 * rgb[:, :1])}

    ds = SyntheticDataset(length=inp["n"], height=8, width=12)
    loader = DataLoader(ds, inp["batch"], num_workers=1, rank=rank(),
                        world=world_size())
    ev = Eval(loader)
    _, idx = ev.inference(Model())
    return dict(metrics=ev.evaluate(Model(), logger=_Quiet()),
                idx=idx.tolist(), n_batches=len(loader),
                local=loader.indices().tolist())


class _Quiet:
    def log(self, msg):
        pass


def build_op(case):
    """The op of a width-sharding case (``tests/test_torch_spatial.py``) as
    a function of the case's inputs, its module's weights drawn from the
    case's seed, so that the test and every rank build the same op."""
    import torch.nn as nn

    from rdfc_gan_torch.models.label_net import PSPModule
    from rdfc_gan_torch.models.layers import AdaIN, bilinear_resize
    from rdfc_gan_torch.models.normal_net import Conv2dSame, SqueezeExcite
    from rdfc_gan_torch.ops.kernels.norm_kernel import instance_norm

    torch.manual_seed(case.get("seed", 0))
    kind, c = case["kind"], case.get("c", 4)
    if kind == "conv":
        k, s, d, p, dw = case["conv"]
        return nn.Conv2d(c, c if dw else 5, k, s, p, d, c if dw else 1)
    if kind == "same":
        k, s, dw = case["conv"]
        return Conv2dSame(c, c if dw else 5, k, s, c if dw else 1)
    if kind == "convT":
        return nn.ConvTranspose2d(c, 3, 3, 2, 1, 1)
    if kind == "convT_trim":
        from rdfc_gan_torch.models.encoder_decoder import concat_skip

        convt = nn.ConvTranspose2d(c, 3, 3, 2, 1, 1)
        return lambda x, skip: concat_skip(convt(x), skip)
    if kind == "maxpool":
        return nn.MaxPool2d(3, 2, 1)
    if kind == "resize":
        return lambda x: bilinear_resize(x, case["size"], case["align"],
                                         replicated=case.get("whole", False))
    if kind == "psp":
        m = PSPModule(c).eval()
        for bn in (mod for mod in m.modules()
                   if isinstance(mod, nn.BatchNorm2d)):
            bn.running_mean.uniform_(-0.2, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
        return m
    if kind == "se":
        return SqueezeExcite(c, 2)
    if kind == "adain":
        return AdaIN()
    if kind == "in":
        return instance_norm
    raise ValueError(kind)


def shard_image(x, grid):
    """This rank's shard of a (..., W) activation in the uneven layout of
    ``parallel.spatial`` (ceil(W / M) columns a rank; the columns past W
    NaN, which no rule may read), marked with its image width."""
    from rdfc_gan_torch.parallel import spatial
    from rdfc_gan_torch.parallel.grid import owned

    W = x.shape[-1]
    lo, hi = owned(W, grid.M, grid.m)
    own = x[..., lo:min(hi, W)]
    pad = torch.full((*x.shape[:-1], hi - lo - own.shape[-1]), float("nan"))
    return spatial.with_width(torch.cat([own, pad], -1).contiguous(), W)


def spatial_ops(inp):
    """Each case's op on this rank's columns of its inputs under the grid of
    ``mesh`` (``shard_image``; an input marked whole goes to every rank as
    it is); for the instance norm also the scale a of
    ``instance_norm_fwd_sharded``. Returns the output shards, in case
    order."""
    from rdfc_gan_torch.ops.kernels.norm_kernel import \
        instance_norm_fwd_sharded
    from rdfc_gan_torch.parallel import spatial
    from rdfc_gan_torch.parallel.grid import make_grid

    grid = make_grid(inp["mesh"])
    outs = []
    for case in inp["cases"]:
        op = build_op(case)
        args = [x if case.get("whole") else shard_image(x, grid)
                for x in case["inputs"]]
        with torch.inference_mode(), spatial.sharded(grid):
            out = op(*args)
        if case["kind"] == "in":
            out = (out, instance_norm_fwd_sharded(
                args[0], 1e-5, grid.model_group, grid.M,
                spatial.valid_width(args[0]), grid.m)[1])
        outs.append(out)
    return outs


def spatial_forward(inp):
    """An engine of ``args`` loaded from ``pth``, serving the global batch
    under each grid of ``meshes`` (this rank's rows; with ``depth_only``
    both ways for the first grid): its output shards and the same forward
    assembled (``assemble``), keyed (mesh label, depth_only)."""
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.engines import build_engine
    from rdfc_gan_torch.parallel.grid import make_grid
    from rdfc_gan_torch.utils.checkpoint import load_checkpoint

    engine = build_engine(parse_config(inp["args"]))
    load_checkpoint(engine.modules, inp["pth"])
    out = {}
    for i, mesh in enumerate(inp["meshes"]):
        grid = make_grid(mesh)
        rgb, raw = (rank_rows(inp["batch"][k], grid.d, grid.D)
                    for k in ("rgb", "raw"))
        for depth_only in ((False, True) if i == 0 and inp.get("depth_only")
                           else (False,)):
            kw = dict(depth_only=depth_only, grid=grid)
            out[(str(mesh), depth_only)] = (
                engine.forward_test(rgb, raw, **kw),
                engine.forward_test(rgb, raw, assemble=True, **kw))
    return out


def serve_cli(inp):
    """``rdfc_gan_torch.test.run`` of ``args`` (its model config names the
    mesh): the metrics and the forwards."""
    from rdfc_gan_torch import test as port_test
    from rdfc_gan_torch.cli import parse_config

    res = port_test.run(parse_config(inp["args"]))
    return dict(metrics=res["metrics"], forwards=res["forwards"])


def mesh_steps(inp):
    """For each mesh of ``meshes``: ``init_distributed`` checks it against
    the ranks, then an engine of ``args`` loaded from ``pth`` takes one
    train step on this rank's rows of ``batch``: the losses and every net's
    gradients and state."""
    from rdfc_gan_torch.cli import parse_config
    from rdfc_gan_torch.parallel import init_distributed

    out = []
    for mesh in inp["meshes"]:
        cfg = parse_config(inp["args"])
        cfg["mesh_shape"] = mesh
        init_distributed(cfg)
        engine = _engine(inp)
        losses = engine.train_step(_rows(inp["batch"]))
        out.append(dict(
            losses={k: float(v) for k, v in losses.items()},
            grads={k: _grads(m) for k, m in engine.modules.items()},
            state={k: _state(m) for k, m in engine.modules.items()}))
    return out


JOBS = {f.__name__: f for f in (sync_bn, fused_block, train_steps,
                                 evaluate, spatial_ops, spatial_forward,
                                 serve_cli, mesh_steps)}


def start_ranks(jobs, work_dir, world: int = 2, timeout: float = 300):
    """Start ``world`` rank processes of this file on ``jobs`` (a list of
    (label, job, inputs)). Returns ``collect()``, which waits for each to
    end within ``timeout`` seconds (killing them after), fails naming a
    rank that exited non-zero, and returns, for each rank, {label:
    result}."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    jobs_file = os.path.join(work_dir, "jobs.pt")
    torch.save(jobs, jobs_file)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), jobs_file, str(work_dir)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(world)]

    def collect():
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
        return [{label: torch.load(os.path.join(work_dir, f"{label}_{r}.pt"),
                                   weights_only=False)
                 for label, _, _ in jobs} for r in range(world)]

    return collect


def run_ranks(jobs, work_dir, world: int = 2, timeout: float = 300):
    """``start_ranks`` and wait for the results."""
    return start_ranks(jobs, work_dir, world, timeout)()


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    jobs_file, out_dir = sys.argv[4:6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for label, job, inp in torch.load(jobs_file, weights_only=False):
            torch.save(JOBS[job](inp),
                       os.path.join(out_dir, f"{label}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
