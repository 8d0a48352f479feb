"""The flagship's served call replayed as CUDA graphs
(``rdfc_gan_torch/engines/graphs.py``) and the matrices it needs on the
device (``models.layers.device_matrix``).

On the CPU: the kept matrices are the numpy builders' values, one tensor a
key; ``bilinear_resize`` and the PSP pooling give the same bits, forward
and backward, as the formulas that built their matrices on every call, a
matrix first made in inference mode included; an export trace keeps no
matrix; the autocast state is part of a key, and the capture's cast
cache is off; ``RDFCGAN.forward_test`` takes no graph on the CPU and
returns the maps of its nets run in order, a served net left in train
mode put back in eval mode.

On the card (``gpu``; no JAX here, so they run on the card's machine),
under deterministic cuDNN, every map bit-equal: the replayed maps are an
eager call's at 4x224x304 and at batch 1, with and without
``depth_only``, and the IN kernel's wrapper counts its launches in the
warm-up and the capture and not in a replay; a held result is not
overwritten by the next call; after an in-place ``load_state_dict`` the
replay serves the new weights' maps; after ``train_step`` the nets are
back in eval mode and the maps equal an eager call's; a call under bf16
autocast replays its own graphs, the eager autocast call's maps and not
the f32 ones, in a later autocast block too; the width-sharded call and
``tools/export_model`` take no graph; a G_A2B that refines with NLSPN
(its grids built on the host) stays eager. Under the default,
non-deterministic cuDNN (the benchmark's), G_A2B's eager forward itself
differs between two calls (its transposed convs), so the replay is held
there to the benchmark's ``pred_depth`` limit and the other maps
bit-equal.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rdfc_gan_torch.cli import parse_config
from rdfc_gan_torch.data import SyntheticDataset
from rdfc_gan_torch.engines import build_engine
from rdfc_gan_torch.engines import graphs
from rdfc_gan_torch.engines.graphs import REPLAY, ServedGraphs
from rdfc_gan_torch.engines.rdfc_gan import SERVED
from rdfc_gan_torch.losses import norm_normalize
from rdfc_gan_torch.models import label_net, layers
from rdfc_gan_torch.ops.kernels import build

# one intra-op thread a Tier-1 worker (see tests/test_torch_serving.py)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
FLAGSHIP = os.path.join(ROOT, "configs", "rdf_cycle_patchgan_config.yaml")
# pred_depth's limit in flagship-serve-b4: largest |error| over largest
# |map|
PRED_DEPTH_ERR = 3e-4
BUILDERS = {"half_pixel": layers._half_pixel_matrix,
            "align_corners": layers._interp_matrix,
            "pool": label_net._pool_matrix}


def _engine(cfg_path, tmp, h, w, b, device, is_train=False, seed=0):
    cfg = parse_config(["--dataset", "synthetic", "--model_cfg_path",
                        cfg_path, "--work_dir", str(tmp), "--out_height",
                        str(h), "--out_width", str(w), "--batch_size",
                        str(b), "--device", device])
    torch.manual_seed(seed)
    return build_engine(cfg, is_train=is_train, steps_per_epoch=4)


def _batch(b, h, w, device="cpu"):
    ds = SyntheticDataset(length=b, height=h, width=w, seed=3)
    smp = [ds[i] for i in range(b)]
    out = {}
    for k in smp[0]:
        v = np.stack([s[k] for s in smp])
        t = torch.from_numpy(v.copy())
        t = t.permute(0, 3, 1, 2).contiguous() if v.ndim == 4 else t
        out[k] = t.to(device)
    return out


def _nets_in_order(eng, rgb, raw_depth, depth_only=False):
    """The served call as the nets compute it, each run in turn."""
    m = eng.modules
    out = {}
    with torch.inference_mode():
        if not depth_only:
            label = m["G_label"](rgb)
        normal = norm_normalize(m["G_normal"](rgb))
        out["pred_depth"] = m["G_A2B"](rgb, raw_depth, normal)["pred_depth"]
        out["pred_normal"] = normal
        if not depth_only:
            out["pred_label"] = label
    return out


def _assert_equal(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _assert_within_limit(got, want):
    """Under non-deterministic cuDNN on the card: G_label's and
    G_normal's maps bit-equal; pred_depth within ``flagship-serve-b4``'s
    limit (``benchmark/workloads``), since G_A2B's eager forward itself
    differs between two calls there (by up to about 4e-7 in its maps)."""
    assert list(got) == list(want)
    for k, v in want.items():
        if k in ("pred_depth", "nlspn_max_offset"):
            err = (got[k] - v).abs().max() / v.abs().max().clamp_min(1e-30)
            assert float(err) <= PRED_DEPTH_ERR, (k, float(err))
        else:
            assert torch.equal(got[k], v), k


# ---------------------------------------------------------------- the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes", [(56, 224), (224, 56), (7, 3), (5, 5),
                                   (1, 6)])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_device_matrix_is_the_builders(builder, sizes, dtype):
    build_fn = BUILDERS[builder]
    got = layers.device_matrix(build_fn, *sizes, torch.device("cpu"), dtype)
    want = torch.from_numpy(build_fn(*sizes)).to(dtype).float()
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_device_matrix_is_kept_by_key():
    cpu = torch.device("cpu")
    fn = layers._half_pixel_matrix
    a = layers.device_matrix(fn, 9, 4, cpu)
    assert layers.device_matrix(fn, 9, 4, cpu) is a
    assert layers.device_matrix(fn, 9, 4, cpu, torch.float32) is a
    others = [layers.device_matrix(fn, 9, 4, cpu, torch.bfloat16),
              layers.device_matrix(fn, 9, 5, cpu),
              layers.device_matrix(fn, 8, 4, cpu),
              layers.device_matrix(layers._interp_matrix, 9, 4, cpu)]
    assert all(o is not a for o in others)
    assert len({id(o) for o in others}) == len(others)


def _resize_formula(x, size, align_corners):
    """``bilinear_resize`` (unsharded) as it built its matrices on every
    call."""
    B, C, H, W = x.shape
    h, w = size
    mat = layers._interp_matrix if align_corners else \
        layers._half_pixel_matrix
    out = x.reshape(B * C, H, W)
    if h != H:
        wy = torch.from_numpy(mat(H, h)).to(x.device, x.dtype).float()
        out = torch.matmul(wy, out.float()).to(x.dtype)
    if w != W:
        wx = torch.from_numpy(mat(W, w)).to(x.device, x.dtype).float()
        out = torch.matmul(out.float(), wx.t()).to(x.dtype)
    return out.reshape(B, C, h, w)


def _pool_formula(x, b):
    """``AdaptiveAvgPool`` (unsharded) as it built its matrices on every
    call."""
    H, W = x.shape[-2:]
    ph, pw = (torch.from_numpy(label_net._pool_matrix(n, b)).to(x.device)
              for n in (H, W))
    return torch.einsum("ih,bchw,jw->bcij", ph, x.float(), pw).to(x.dtype)


OPS = {
    "half_pixel": (lambda x: layers.bilinear_resize(x, (5, 17)),
                   lambda x: _resize_formula(x, (5, 17), False)),
    "align_corners": (
        lambda x: layers.bilinear_resize(x, (12, 7), align_corners=True),
        lambda x: _resize_formula(x, (12, 7), True)),
    "pool": (lambda x: label_net.AdaptiveAvgPool(3)(x),
             lambda x: _pool_formula(x, 3)),
}


@pytest.mark.parametrize("first_in_inference", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", sorted(OPS))
def test_resize_and_pool_bit_equal_to_their_formulas(op, dtype,
                                                     first_in_inference):
    """Outputs and input gradients bit-equal to the per-call formulas; with
    ``first_in_inference`` the kept matrices are first made inside
    ``torch.inference_mode`` (a served call) and then saved for a
    backward (a train step)."""
    new, old = OPS[op]
    r = np.random.RandomState(5)
    x = torch.from_numpy(r.normal(size=(2, 3, 9, 13)).astype(
        np.float32)).to(dtype)
    if first_in_inference:
        layers._resident_matrix.cache_clear()
        with torch.inference_mode():
            new(x)
    outs = []
    for fn in (new, old):
        xt = x.clone().requires_grad_(True)
        y = fn(xt)
        g = torch.from_numpy(np.random.RandomState(6).normal(
            size=y.shape).astype(np.float32)).to(dtype)
        y.backward(g)
        outs.append((y.detach(), xt.grad))
    for a, b in zip(*outs):
        assert a.dtype == dtype
        assert torch.equal(a, b)


def test_export_trace_keeps_no_matrix():
    """A ``torch.export`` trace builds its own matrices (fake tensors) and
    keeps none; the exported program computes the module's bits."""

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pool = label_net.AdaptiveAvgPool(2)

        def forward(self, x):
            return layers.bilinear_resize(self.pool(x), (11, 6))

    x = torch.randn(1, 2, 15, 19)
    kept = layers._resident_matrix.cache_info().currsize
    with torch.no_grad():
        ep = torch.export.export(M(), (x,))
    assert layers._resident_matrix.cache_info().currsize == kept
    assert torch.equal(ep.module()(x), M()(x))


def test_graphs_do_not_engage_on_the_cpu():
    x = torch.zeros(1, 3, 4, 4)
    with torch.inference_mode():
        assert not ServedGraphs.engages(x, x)
    assert not ServedGraphs.engages(x, x)


@pytest.mark.parametrize("change", ["enabled", "dtype"])
def test_autocast_state_is_in_the_key(change):
    """A call under CUDA autocast, or under another autocast dtype, keys
    graphs of its own; the capture's cast cache is off and restored."""
    enabled = torch.is_autocast_enabled("cuda")
    dtype = torch.get_autocast_dtype("cuda")
    before = graphs._kernel_flags()
    try:
        if change == "enabled":
            torch.set_autocast_enabled("cuda", not enabled)
        else:
            torch.set_autocast_dtype("cuda", torch.bfloat16
                                     if dtype != torch.bfloat16
                                     else torch.float16)
        assert graphs._kernel_flags() != before
    finally:
        torch.set_autocast_enabled("cuda", enabled)
        torch.set_autocast_dtype("cuda", dtype)
    assert graphs._kernel_flags() == before
    with graphs._no_cast_cache():
        assert not torch.is_autocast_cache_enabled()
    assert torch.is_autocast_cache_enabled()


@pytest.fixture(scope="module")
def tiny_cpu(tmp_path_factory):
    eng = _engine(TINY, tmp_path_factory.mktemp("graphs"), 32, 48, 2, "cpu")
    return eng, _batch(2, 32, 48)


@pytest.mark.parametrize("depth_only", [False, True])
def test_cpu_forward_test_takes_no_graph(tiny_cpu, depth_only):
    eng, b = tiny_cpu
    for _ in range(3):
        got = eng.forward_test(b["rgb"], b["raw_depth"],
                               depth_only=depth_only)
        _assert_equal(got, _nets_in_order(eng, b["rgb"], b["raw_depth"],
                                          depth_only))
    assert len(eng.graphs) == 0


def test_served_net_in_train_mode_is_put_back_in_eval(tiny_cpu):
    eng, b = tiny_cpu
    want = eng.forward_test(b["rgb"], b["raw_depth"])
    eng.modules["G_normal"].train()
    got = eng.forward_test(b["rgb"], b["raw_depth"])
    for k in SERVED:
        assert not any(m.training for m in eng.modules[k].modules()), k
    _assert_equal(got, want)


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(b, h, w, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rgb = torch.rand((b, 3, h, w), device="cuda", generator=gen) * 2 - 1
    raw = torch.rand((b, 1, h, w), device="cuda", generator=gen) * 2 - 1
    raw = raw * (torch.rand((b, 1, h, w), device="cuda",
                            generator=gen) > 0.6)
    return rgb, raw


def _eager(eng, rgb, raw, depth_only=False):
    with torch.inference_mode():
        return eng._forward_test(rgb, raw, depth_only)


def _deterministic():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


@pytest.fixture
def det():
    """Deterministic cuDNN around a card test."""
    with _deterministic():
        yield


def _replays(fn):
    """(fn(), the ``rdfc.graph_replay`` spans it opened)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name == REPLAY for e in prof.events())


@pytest.fixture(scope="module")
def flagship_card(tmp_path_factory):
    _card()
    return _engine(FLAGSHIP, tmp_path_factory.mktemp("card"), 224, 304, 4,
                   "cuda")


def _in_fwd():
    return build.LAUNCHES["instance_norm_fwd"]


@pytest.mark.gpu
@pytest.mark.parametrize("depth_only", [False, True])
@pytest.mark.parametrize("batch", [4, 1])
def test_replayed_maps_bit_equal_to_eager(flagship_card, det, batch,
                                          depth_only):
    """Warm-up, capture and replay all return the eager call's maps; a
    replay opens one ``rdfc.graph_replay`` a net; the IN kernel's wrapper
    counts its launches in the warm-up and the capture, and in no
    replay."""
    eng = flagship_card
    x1, x2 = _inputs(batch, 224, 304, 1), _inputs(batch, 224, 304, 2)
    n = _in_fwd()
    want1 = _eager(eng, *x1, depth_only)
    per_call = _in_fwd() - n
    want2 = _eager(eng, *x2, depth_only)
    n, replayed = _in_fwd(), eng.graphs.replayed
    for _ in range(3):
        _assert_equal(eng.forward_test(*x1, depth_only=depth_only), want1)
    got, replays = _replays(lambda: eng.forward_test(
        *x2, depth_only=depth_only))
    torch.cuda.synchronize()
    assert per_call == 4
    assert _in_fwd() - n == 2 * per_call
    assert eng.graphs.replayed - replayed == 2
    assert replays == (2 if depth_only else 3)
    _assert_equal(got, want2)


@pytest.mark.gpu
def test_replayed_maps_under_default_cudnn(flagship_card):
    """The benchmark's cuDNN settings: the replay's maps within the
    cell's limit of the eager call's."""
    eng = flagship_card
    x = _inputs(4, 224, 304, 8)
    want = _eager(eng, *x)
    for _ in range(3):
        got, replays = _replays(lambda: eng.forward_test(*x))
        _assert_within_limit(got, want)
    assert replays == 3


@pytest.mark.gpu
def test_autocast_is_keyed_apart(flagship_card, det):
    """f32 and bf16-autocast calls of one shape replay graphs of their
    own, each the maps of its eager call; an autocast block after the
    one that captured replays the same maps."""
    eng = flagship_card
    x = _inputs(4, 224, 304, 9)
    want = _eager(eng, *x)
    for _ in range(3):
        got = eng.forward_test(*x)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        want_bf16 = _eager(eng, *x)
        for _ in range(3):
            got_bf16, replays = _replays(lambda: eng.forward_test(*x))
    assert replays == 3
    with torch.autocast("cuda", dtype=torch.bfloat16):
        again, replays = _replays(lambda: eng.forward_test(*x))
    assert replays == 3
    got_f32, replays = _replays(lambda: eng.forward_test(*x))
    assert replays == 3
    for served in (got, got_f32):
        _assert_equal(served, want)
    for served in (got_bf16, again):
        _assert_equal(served, want_bf16)
    assert not torch.equal(want_bf16["pred_depth"], want["pred_depth"])


@pytest.mark.gpu
def test_held_result_is_not_overwritten(flagship_card, det):
    eng = flagship_card
    x1, x2 = _inputs(4, 224, 304, 3), _inputs(4, 224, 304, 4)
    want = _eager(eng, *x1)
    for _ in range(3):
        held = eng.forward_test(*x1)
    later = eng.forward_test(*x2)
    torch.cuda.synchronize()
    _assert_equal(held, want)
    assert not torch.equal(held["pred_depth"], later["pred_depth"])


@pytest.mark.gpu
def test_replay_serves_weights_loaded_in_place(flagship_card, det,
                                               tmp_path):
    eng = flagship_card
    other = _engine(FLAGSHIP, tmp_path, 224, 304, 4, "cuda", seed=1)
    x = _inputs(4, 224, 304, 5)
    for _ in range(3):
        before = eng.forward_test(*x)
    for k in SERVED:
        eng.modules[k].load_state_dict(other.modules[k].state_dict())
    got, replays = _replays(lambda: eng.forward_test(*x))
    assert replays == 3
    _assert_equal(got, _eager(eng, *x))
    _assert_equal(got, _eager(other, *x))
    assert not torch.equal(got["pred_depth"], before["pred_depth"])


@pytest.mark.gpu
def test_train_step_then_serve(det, tmp_path):
    """A train engine's validation call after a step: the served nets are
    back in eval mode and the replay reads the stepped weights and
    running statistics."""
    _card()
    eng = _engine(FLAGSHIP, tmp_path, 224, 304, 2, "cuda", is_train=True)
    x = _inputs(2, 224, 304, 6)
    for _ in range(3):
        eng.forward_test(*x)
    eng.train_step(_batch(2, 224, 304, "cuda"))
    got, replays = _replays(lambda: eng.forward_test(*x))
    assert replays == 3
    for k in SERVED:
        assert not any(m.training for m in eng.modules[k].modules()), k
    _assert_equal(got, _eager(eng, *x))


@pytest.mark.gpu
def test_export_and_sharded_call_take_no_graph(det, tmp_path, monkeypatch):
    _card()
    from rdfc_gan_torch.parallel import spatial
    from rdfc_gan_torch.tools import export_model

    res = export_model.run(["--model_cfg_path", TINY, "--out",
                            str(tmp_path / "m.pt2"), "--batch_size", "2",
                            "--out_height", "32", "--out_width", "48",
                            "--device", "cuda"])
    eng, (rgb, raw) = res["engine"], res["inputs"]
    assert len(eng.graphs) == 0
    grids = []

    def serve(fn, grid, rgb, raw_depth, depth_only, assemble=False):
        grids.append(grid)
        return fn(rgb, raw_depth, depth_only)

    monkeypatch.setattr(spatial, "serve", serve)
    want = _eager(eng, rgb, raw)
    for _ in range(3):
        _assert_equal(eng.forward_test(rgb, raw, grid="grid"), want)
    assert grids == ["grid"] * 3
    assert len(eng.graphs) == 0


@pytest.mark.gpu
def test_host_sync_keeps_the_key_eager(det, tmp_path):
    """A G_A2B that refines with NLSPN builds its grids on the host each
    call: its key's warm-up finds the host's wait and the key stays
    eager."""
    _card()
    with open(TINY) as f:
        text = f.read()
    anchor = "    depth_channels_decoder: [16, 16, 16, 16]\n"
    assert anchor in text
    path = tmp_path / "nlspn_a2b.yaml"
    path.write_text(text.replace(anchor, anchor + (
        "    use_nlspn_refine: true\n"
        "    nlspn_configs: {prop_kernel: 3, prop_time: 3, affinity: TGASS,"
        " affinity_gamma: 0.5, conf_prop: true, preserve_input: false}\n"),
        1))
    eng = _engine(str(path), tmp_path, 32, 48, 2, "cuda")
    x = _inputs(2, 32, 48, 7)
    want = _eager(eng, *x)
    assert "nlspn_max_offset" in want
    for _ in range(2):
        _assert_equal(eng.forward_test(*x), want)
    got, replays = _replays(lambda: eng.forward_test(*x))
    _assert_equal(got, want)
    assert replays == 0
    assert len(eng.graphs) == 1
