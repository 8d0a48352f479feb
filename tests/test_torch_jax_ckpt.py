"""The JAX drivers' ``.ckpt`` in the port, against the JAX package, on the
CPU: the msgpack codec against flax's, the RDFCTPU2 / RDFCTPU1 header,
the optax <-> torch optimizer state for every optimizer case, the tiny
flagship served, resumed and stepped from a JAX-written file, the NLSPN
RDF-GAN resumed after two JAX steps, the v1 driver served, and the
writers (``save_jax_checkpoint``, ``tools/convert_torch_ckpt.py``) read
back by the JAX ``load_checkpoint``.

The flagship's state: the JAX ``init_state(is_train=True)`` is traced once
(``jax.eval_shape``: its tree without the 40 s compile of six inits); its
params are the port's seeded init through the port's writer converters
(checked against that template leaf for leaf), its norms drawn as
``tests/test_torch_rdfc_serving.py`` draws them, its optimizer leaves
seeded (mu normal, nu positive, counts 7).

Tolerances. Codec, header, converters and the state a resume restores:
bit for bit. Forwards and metrics: rtol 1e-3 / atol 1e-4, those of the
port's serving tests. A learning rate: rtol 1e-6 (the schedule in f64
here, in f32 in JAX). An optimizer update from the same state and
gradient: within 4e-7 (3 f32 ulp at 1) plus 1e-6 relative of the
parameter: Adam's bias corrections and square root are rounded in
another order (seen 1.2e-7). The NLSPN RDF-GAN's third step: the rules of
``tests/test_torch_train_step.py``.
"""

import contextlib
import logging
import os
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as fs
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from rdfc_gan_torch.cli import parse_config as t_parse
from rdfc_gan_torch.engines import build_engine as t_build
from rdfc_gan_torch.engines.base import clip_gradients
from rdfc_gan_torch.engines.base import make_optimizer as t_make_optimizer
from rdfc_gan_torch.engines.optax_state import load_optimizer_state
from rdfc_gan_torch.models import PatchGANDiscriminator as TPatchGAN
from rdfc_gan_torch.utils import jax_checkpoint, msgpack_codec
from rdfc_gan_torch.utils.jax_checkpoint import sorted_tree
from rdfc_gan_torch.utils.checkpoint import (load_checkpoint, resume_from,
                                             save_checkpoint,
                                             save_jax_checkpoint)
from rdfc_gan_torch.utils.convert import (net_state_dict_from_jax,
                                          patchgan_state_dict_from_jax)
from rdfc_gan_torch.utils.torch_convert import net_tree_to_jax
from rdfc_gan_tpu.cli import parse_config as j_parse
from rdfc_gan_tpu.config import default_config as j_default
from rdfc_gan_tpu.engines import build_engine as j_build
from rdfc_gan_tpu.engines import make_optimizer as j_make_optimizer
from rdfc_gan_tpu.engines.base import GANTrainState
from rdfc_gan_tpu.utils.checkpoint import load_checkpoint as j_load
from rdfc_gan_tpu.utils.checkpoint import save_checkpoint as j_save
from test_torch_normal_net import randomize_norms
from test_torch_train_step import (D_CH, _assert_grads, _assert_state,
                                   _batches, _engines, _np_tree,
                                   _random_patchgan_tree)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import make_synth_ref_ckpt  # noqa: E402
from convert_torch_ckpt import convert_reference_state  # noqa: E402

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
H, W, B = 32, 48, 3
SPE = 4
FWD = dict(rtol=1e-3, atol=1e-4)


def _update_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=4e-7)


# ---------------------------------------------------------------- codec --
def _bits(x):
    """A leaf (or tree) as comparable bits: dtype, shape and bytes."""
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_bits(v) for v in x]
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return ("bfloat16", tuple(x.shape),
                x.contiguous().view(torch.int16).numpy().tobytes())
    if isinstance(x, (np.ndarray, np.generic)):
        kind = "array" if isinstance(x, np.ndarray) else "scalar"
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return ("bfloat16", a.shape, a.view(np.uint16).tobytes())
        return (kind, a.dtype.name, a.shape, a.tobytes())
    if isinstance(x, float):
        return ("float", np.float64(x).tobytes())
    if isinstance(x, complex):
        return ("complex", np.complex128(x).tobytes())
    return (type(x).__name__, x)


def _leaf_zoo():
    r = np.random.RandomState(0)
    return {
        "f32": r.normal(size=(3, 4)).astype(np.float32),
        "f16": r.normal(size=(5,)).astype(np.float16),
        "bf16": r.normal(size=(2, 3)).astype(jnp.bfloat16),
        "i32": r.randint(-9, 9, (4,)).astype(np.int32),
        "u8": r.randint(0, 255, (2, 2)).astype(np.uint8),
        "bool": r.uniform(size=(3,)) > 0.5,
        "zero_d": np.asarray(7, np.int32),
        "empty": np.zeros((0, 3), np.float32),
        "complex": 1.5 - 2j,
        "c64": (r.normal(size=3) + 1j).astype(np.complex64),
        "scalars": {"f": np.float32(0.25), "i": np.int64(-3),
                    "b": np.bool_(True),
                    "bf": np.dtype(jnp.bfloat16).type(1.5)},
        "nested": {"a": {"b": {"c": np.arange(6.0).reshape(2, 3)}}},
        "plain": [1, -1, 200, -200, 70000, 2 ** 40, -2 ** 40, 2 ** 64 - 1,
                  1.25, None, True, False, "x" * 40, b"raw"],
        "f64_big": r.normal(size=(300,)),
    }


def test_codec_reads_what_flax_writes():
    raw = fs.to_bytes(_leaf_zoo())
    assert _bits(msgpack_codec.unpackb(raw)) == _bits(fs.msgpack_restore(raw))


def test_codec_writes_flax_bytes():
    """The same tree (keys sorted, as flax's tree_map leaves them) gives
    flax's bytes, and flax reads them back to the same leaves; a bf16
    tensor writes as flax's bf16 array."""
    tree = sorted_tree(_leaf_zoo())
    raw = fs.msgpack_serialize(tree)
    assert msgpack_codec.packb(tree) == raw
    tree["bf16"] = torch.from_numpy(tree["bf16"].view(np.int16)).view(
        torch.bfloat16)
    assert msgpack_codec.packb(tree) == raw
    assert _bits(fs.msgpack_restore(msgpack_codec.packb(tree))) == \
        _bits(fs.msgpack_restore(raw))


def test_codec_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    r = np.random.RandomState(1)
    tree = sorted_tree({
        "big": r.normal(size=(5, 7)).astype(np.float32),
        "bf": {"x": r.normal(size=(40,)).astype(jnp.bfloat16)},
        "small": np.arange(3, dtype=np.int32)})
    raw = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in raw
    assert _bits(msgpack_codec.unpackb(raw)) == _bits(fs.msgpack_restore(raw))
    assert msgpack_codec.packb(tree) == raw


_DTYPES = st.sampled_from([np.float32, np.float16, np.float64, np.int8,
                           np.int32, np.int64, np.uint8, np.uint16,
                           np.bool_, np.complex64])
_ARRAYS = _DTYPES.flatmap(lambda dt: hnp.arrays(
    dt, hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=4)))
_LEAVES = st.one_of(
    _ARRAYS, st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(width=64),
    st.booleans(), st.none(), st.text(max_size=40), st.binary(max_size=40),
    st.floats(width=32).map(np.float32),
    st.complex_numbers(allow_nan=False))
_TREES = st.recursive(
    _LEAVES, lambda kids: st.dictionaries(st.text(max_size=8), kids,
                                          max_size=5), max_leaves=12)


@settings(max_examples=60, deadline=None)
@given(tree=st.dictionaries(st.text(max_size=8), _TREES, max_size=6))
def test_codec_round_trip_property(tree):
    tree = sorted_tree(tree)
    raw = fs.msgpack_serialize(tree)
    assert msgpack_codec.packb(tree) == raw
    assert _bits(msgpack_codec.unpackb(raw)) == _bits(fs.msgpack_restore(raw))


# --------------------------------------------------------------- header --
@contextlib.contextmanager
def _captured(caplog, name):
    """``caplog`` on logger ``name`` itself: the port's drivers stop their
    ``rdfc_gan_torch`` logger from propagating to the root."""
    log = logging.getLogger(name)
    log.addHandler(caplog.handler)
    try:
        yield
    finally:
        log.removeHandler(caplog.handler)



def _explode():
    raise AssertionError("a V1 header was unpickled")


class _Boom:
    def __reduce__(self):
        return (_explode, ())


def test_header_formats(tmp_path, caplog):
    """RDFCTPU2 with its JSON meta; RDFCTPU1 read with meta {} and a
    warning, its pickled header (which raises if unpickled) never
    unpickled; a foreign file refused by name; a .pth read as before."""
    tree = {"step": np.asarray(3, np.int32), "x": np.arange(4.0)}
    p2 = str(tmp_path / "v2.ckpt")
    j_save(tree, p2, meta={"epoch": 4, "note": "n"})
    got, meta = jax_checkpoint.read_state(p2)
    assert meta == {"epoch": 4, "note": "n"}
    assert _bits(got) == _bits(tree)

    header = pickle.dumps(_Boom())
    p1 = tmp_path / "v1.ckpt"
    p1.write_bytes(jax_checkpoint.MAGIC_V1 + len(header).to_bytes(8, "little")
                   + header + fs.to_bytes(tree))
    with pytest.raises(AssertionError, match="unpickled"):
        pickle.loads(header)
    with _captured(caplog, jax_checkpoint.__name__):
        got, meta = jax_checkpoint.read_state(str(p1))
    assert meta == {} and _bits(got) == _bits(tree)
    assert "legacy" in caplog.text
    assert j_load(tree, str(p1))[1] == {}

    foreign = tmp_path / "x.ckpt"
    foreign.write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="x.ckpt"):
        jax_checkpoint.read_state(str(foreign))
    with pytest.raises(ValueError, match="x.ckpt"):
        load_checkpoint({"D": TPatchGAN(out_channels=D_CH)}, str(foreign))

    d = TPatchGAN(out_channels=D_CH)
    pth = str(tmp_path / "d.ckpt")  # the suffix does not decide
    save_checkpoint({"D": d}, pth, meta={"epoch": 1})
    e = TPatchGAN(out_channels=D_CH)
    assert load_checkpoint({"D": e}, pth) == {"epoch": 1}
    for k, v in d.state_dict().items():
        assert torch.equal(v, e.state_dict()[k])
    with pytest.raises(ValueError, match="config"):
        load_checkpoint({"D": e}, p2)


# ------------------------------------------------ optimizer, each case --
OPT_CASES = {"adam": {}, "adamw": {}, "sgd": {}, "rmsprop": {},
             "clip_grad": dict(clip_grad=True, max_norm=1.0),
             "fused_optimizer": dict(fused_optimizer=True)}
SCHED = dict(lr=1e-2, warm_up=True, warm_up_lr=1e-4, warm_up_steps=1,
             scheduler="linear", epoch=0, decay_epoch=0, n_epochs=4)


def _j_lr(cfg, count, spe, lr_mult=1.0):
    """JAX's schedule(count) as its make_optimizer computes it: an sgd
    update of a unit gradient at that count."""
    sgd = j_make_optimizer(cfg, spe, lr_mult=lr_mult, kind="sgd")
    s = sgd.init(jnp.zeros(()))
    leaves, tdef = jax.tree.flatten(s)
    s = jax.tree.unflatten(tdef, [jnp.asarray(count, l.dtype)
                                  for l in leaves])
    u, _ = sgd.update(jnp.ones(()), s, jnp.zeros(()))
    return -float(u)


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_state_maps_to_optax(tmp_path, case):
    """Three optax updates of a PatchGAN with seeded gradients, written by
    JAX's save_checkpoint; the port restores its optimizer over the
    converted parameters: the state leaf for leaf, the schedule's next
    rate, and one more update with the same gradient."""
    kind = case if case in ("adam", "adamw", "sgd", "rmsprop") else "adam"
    over = dict(SCHED, optimizer=kind, **OPT_CASES[case])
    jcfg, tcfg = j_default(), j_default()
    jcfg.merge(over)
    from rdfc_gan_torch.config import default_config as t_default

    tcfg = t_default()
    tcfg.merge(over)
    _, tree = _random_patchgan_tree(5)
    params, stats = tree["params"], tree["batch_stats"]
    tx = j_make_optimizer(jcfg, 2, weight_decay=0.01)
    state = tx.init(params)
    r = np.random.RandomState(7)

    def grad():
        return jax.tree.map(lambda a: r.normal(size=np.shape(a)).astype(
            np.float32) * 3, params)

    for _ in range(3):
        u, state = tx.update(grad(), state, params)
        params = optax.apply_updates(params, u)
    path = str(tmp_path / "d.ckpt")
    j_save(GANTrainState(step=jnp.asarray(3, jnp.int32),
                         params={"D": params}, batch_stats={"D": stats},
                         opt_states={"D": state}), path)

    got, _ = jax_checkpoint.read_state(path)
    td = TPatchGAN(out_channels=D_CH)

    def from_tree(t):
        return patchgan_state_dict_from_jax(t, got["batch_stats"]["D"])

    td.load_state_dict(from_tree(got["params"]["D"]))
    opt, sched = t_make_optimizer(tcfg, td.parameters(), 2,
                                  weight_decay=0.01)
    count = load_optimizer_state(
        opt, sched, got["opt_states"]["D"], [("D", td, from_tree)],
        got["params"]["D"], clip=case == "clip_grad",
        fused=case == "fused_optimizer")
    assert count == 3 and sched.last_epoch == 3
    np.testing.assert_allclose(opt.param_groups[0]["lr"],
                               _j_lr(jcfg, 3, 2), rtol=1e-6)

    # the restored state, bit for bit
    inner = state
    if case == "clip_grad":
        inner = inner[1]
    moments = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"),
               "rmsprop": ("nu",), "sgd": ()}[kind]
    for m in moments:
        tree_m = getattr(inner[0], m)
        if case == "fused_optimizer":
            flat = np.asarray(tree_m)
            leaves, tdef = jax.tree.flatten(params)
            sizes = np.cumsum([np.size(x) for x in leaves])[:-1]
            tree_m = jax.tree.unflatten(tdef, [
                p.reshape(np.shape(x)) for p, x in
                zip(np.split(flat, sizes), leaves)])
        want = from_tree(_np_tree(tree_m))
        tkey = {"mu": "exp_avg", "nu": "exp_avg_sq" if kind != "rmsprop"
                else "nu"}[m]
        for name, p in td.named_parameters():
            assert torch.equal(opt.state[p][tkey], want[name]), (m, name)
            if kind != "rmsprop":
                assert float(opt.state[p]["step"]) == 3
    if kind == "sgd":
        assert not opt.state

    g = grad()
    u, _ = tx.update(g, state, params)
    want = from_tree(_np_tree(optax.apply_updates(params, u)))
    gsd = from_tree(_np_tree(g))
    for name, p in td.named_parameters():
        p.grad = gsd[name].clone()
    clip_gradients(tcfg, td.parameters())
    opt.step()
    sched.step()
    for name, p in td.named_parameters():
        _update_close(p.detach().numpy(), want[name].numpy())


# ------------------------------------------------------------- flagship --
def _flagship_args(tmp_path):
    return ["--dataset", "synthetic", "--model_cfg_path", TINY_CFG,
            "--work_dir", str(tmp_path / "work"), "--out_height", str(H),
            "--out_width", str(W), "--batch_size", str(B),
            "--num_workers", "2"]


def _tree_spec(tree):
    return jax.tree.map(lambda x: (tuple(np.shape(x)), str(x.dtype)), tree)


def _jax_sample(b=1):
    return {"rgb": jnp.zeros((b, H, W, 3)), "raw_depth": jnp.zeros(
        (b, H, W, 1)), "gt_depth": jnp.zeros((b, H, W, 1))}


def _seeded_opt_states(abstract, seed):
    r = np.random.RandomState(seed)

    def fill(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith(".count") or key.endswith("['count']"):
            return np.asarray(7, a.dtype)
        if ".nu" in key or "['nu']" in key:
            return r.uniform(1e-6, 1e-3, a.shape).astype(a.dtype)
        return (r.normal(size=a.shape) * 1e-2).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(fill, abstract)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The tiny flagship's JAX train state (see the module docstring),
    written by the JAX save_checkpoint, with the JAX train engine and the
    abstract template."""
    tmp = tmp_path_factory.mktemp("flagship")
    args = _flagship_args(tmp)
    je = j_build(j_parse(args), is_train=True, steps_per_epoch=SPE)
    abstract = jax.eval_shape(je.init_state, jax.random.PRNGKey(0),
                              _jax_sample())
    tcfg = t_parse(args + ["--device", "cpu"])
    torch.manual_seed(0)
    te = t_build(tcfg, is_train=True, steps_per_epoch=SPE)
    params, stats = {}, {}
    for i, (name, mod) in enumerate(te.modules.items()):
        t = net_tree_to_jax(tcfg, name, mod, {
            k: v.numpy() for k, v in mod.state_dict().items()})
        scale = (0.3, 0.6) if name == "G_label" else (0.8, 1.2)
        params[name] = randomize_norms(t["params"], 10 + i, scale=scale)
        stats[name] = randomize_norms(t["batch_stats"], 20 + i)
    # the port's writer converters give the JAX template's tree
    assert _tree_spec(sorted_tree(params)) == _tree_spec(abstract.params)
    assert _tree_spec(sorted_tree(stats)) == _tree_spec(
        abstract.batch_stats)
    state = GANTrainState(step=jnp.asarray(5, jnp.int32), params=params,
                          batch_stats=stats,
                          opt_states=_seeded_opt_states(abstract.opt_states,
                                                        3))
    ckpt = str(tmp / "jax.ckpt")
    j_save(state, ckpt, meta={"epoch": 2, "batch_size": B})
    return dict(args=args, je=je, abstract=abstract, state=state,
                ckpt=ckpt, tcfg=tcfg, tmp=tmp)


def _unmapped(net, key):
    """The port's entries that the JAX trees lack (a resume leaves them
    as they were)."""
    return (key.endswith("num_batches_tracked")
            or key.startswith("fuse_layer5.")
            or (net == "G_normal" and ".bn2." in key))


def _logged(log_path, key):
    vals = re.findall(rf"INFO {re.escape(key)}: ([-+0-9.eE]+|nan)",
                      log_path.read_text())
    assert vals, f"{key} not in {log_path}"
    return float(vals[-1])


def test_flagship_serves_jax_ckpt(flagship):
    """``rdfc_gan_torch.test --load_from x.ckpt`` gives the JAX evaluator's
    8 metrics on the same synthetic split."""
    from rdfc_gan_torch.test import main
    from rdfc_gan_tpu.data import DataLoader, SyntheticDataset
    from rdfc_gan_tpu.evaluator import Eval
    from rdfc_gan_tpu.metrics import METRIC_NAMES

    args = flagship["args"]
    assert main(args + ["--device", "cpu", "--load_from",
                        flagship["ckpt"]]) == 0
    log = flagship["tmp"] / "work" / "test.log"
    assert "left unread G_B2A, disc_A, disc_B" in log.read_text()
    got = {k: _logged(log, k) for k in METRIC_NAMES}
    cfg = j_parse(args)
    ds = SyntheticDataset(height=H, width=W, num_classes=cfg.num_classes,
                          seed=cfg.seed)
    loader = DataLoader(ds, B, shuffle=False, drop_last=False,
                        with_indices=True)
    want = Eval(loader).evaluate(flagship["je"], flagship["state"])
    for k in METRIC_NAMES:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], **FWD, err_msg=k)


def _j_opt_trees(state, k):
    """The JAX optimizer ``k``'s params tree as optax sees it."""
    nets = {"G": ("G_A2B", "G_B2A"), "D": ("disc_A", "disc_B"),
            "Nor": ("G_normal",), "label": ("G_label",)}[k]
    if len(nets) > 1:
        return {n: state.params[n] for n in nets}, nets
    return state.params[nets[0]], nets


def _resumed(flagship):
    torch.manual_seed(1)
    te = t_build(flagship["tcfg"], is_train=True, steps_per_epoch=SPE)
    assert resume_from(te, flagship["ckpt"]) == 2
    return te


def test_flagship_resume_restores_every_leaf(flagship):
    """Every net, every mapped optimizer leaf, each schedule's count and
    next rate, and the global step, as the file holds them."""
    te, state, cfg = _resumed(flagship), flagship["state"], flagship["tcfg"]
    assert te.n_step == 5
    jcfg = j_parse(flagship["args"])
    for name, mod in te.modules.items():
        want = net_state_dict_from_jax(cfg, name, mod, state.params[name],
                                       state.batch_stats[name])
        for k, v in mod.state_dict().items():
            if k in want and not k.endswith("num_batches_tracked"):
                assert torch.equal(v, want[k]), (name, k)
    empty = []
    for k, opt in te.optimizers.items():
        tree, nets = _j_opt_trees(state, k)
        adam = state.opt_states[k][0]
        assert te.schedulers[k].last_epoch == 7
        np.testing.assert_allclose(
            opt.param_groups[0]["lr"],
            _j_lr(jcfg, 7, SPE, 0.5 if k == "Nor" else 1.0), rtol=1e-6)
        for n in nets:
            mod = te.modules[n]
            mu = adam.mu[n] if len(nets) > 1 else adam.mu
            nu = adam.nu[n] if len(nets) > 1 else adam.nu
            wmu = net_state_dict_from_jax(cfg, n, mod, _np_tree(mu),
                                          state.batch_stats[n])
            wnu = net_state_dict_from_jax(cfg, n, mod, _np_tree(nu),
                                          state.batch_stats[n])
            for pn, p in mod.named_parameters():
                s = opt.state.get(p)
                if not s:
                    empty.append(f"{n}.{pn}")
                    continue
                assert torch.equal(s["exp_avg"], wmu[pn]), (n, pn)
                assert torch.equal(s["exp_avg_sq"], wnu[pn]), (n, pn)
                assert float(s["step"]) == 7
    # no JAX counterpart: the unused fuse_layer5 and NNET's identity bn2
    assert sorted(empty) == [
        "G_A2B.fuse_layer5.style.linear.bias",
        "G_A2B.fuse_layer5.style.linear.weight_orig",
        "G_normal.encoder.original_model.bn2.bias",
        "G_normal.encoder.original_model.bn2.weight"]


def test_flagship_resumed_update_matches_optax(flagship):
    """One update of each optimizer group with a seeded gradient, against
    optax's tx.update on the same tree and state."""
    te, state, cfg = _resumed(flagship), flagship["state"], flagship["tcfg"]
    je = flagship["je"]
    r = np.random.RandomState(11)
    for k, opt in te.optimizers.items():
        tree, nets = _j_opt_trees(state, k)
        g = jax.tree.map(lambda a: r.normal(size=np.shape(a)).astype(
            np.float32), tree)
        u, _ = jax.jit(je.optimizers[k].update)(g, state.opt_states[k],
                                                tree)
        new = optax.apply_updates(tree, u)
        for n in nets:
            mod = te.modules[n]
            pick = (lambda t: t[n]) if len(nets) > 1 else (lambda t: t)
            gsd = net_state_dict_from_jax(cfg, n, mod, _np_tree(pick(g)),
                                          state.batch_stats[n])
            for pn, p in mod.named_parameters():
                p.grad = gsd[pn].clone() if pn in gsd and \
                    opt.state.get(p) else None
        opt.step()
        for n in nets:
            mod = te.modules[n]
            pick = (lambda t: t[n]) if len(nets) > 1 else (lambda t: t)
            want = net_state_dict_from_jax(cfg, n, mod, _np_tree(pick(new)),
                                           state.batch_stats[n])
            for pn, p in mod.named_parameters():
                if opt.state.get(p):
                    _update_close(p.detach().numpy(), want[pn].numpy())


def test_flagship_writer_round_trip(flagship, tmp_path):
    """Two port steps, then ``save_jax_checkpoint``: the JAX
    load_checkpoint reads it into its template (same keys, shapes, dtypes,
    step int32), JAX's forward from it equals the port's, and the port
    resumes it to the same state."""
    from rdfc_gan_torch.data import SyntheticDataset as TSynth

    te = _resumed(flagship)
    ds = TSynth(length=4, height=H, width=W, seed=3)
    for i in range(2):
        smp = [ds[2 * i], ds[2 * i + 1]]
        batch = {k: torch.from_numpy(np.stack([s[k] for s in smp]))
                 for k in smp[0]}
        batch = {k: v.permute(0, 3, 1, 2).contiguous() if v.ndim == 4
                 else v for k, v in batch.items()}
        te.train_step(batch)
    path = str(tmp_path / "port.ckpt")
    save_jax_checkpoint(te, path, meta={"epoch": 3})
    jstate, meta = j_load(flagship["abstract"], path)
    assert meta == {"epoch": 3}
    assert _tree_spec(jstate) == _tree_spec(flagship["abstract"])
    assert int(jstate.step) == te.n_step == 7

    r = np.random.RandomState(4)
    rgb = r.uniform(-1, 1, (B, 3, H, W)).astype(np.float32)
    raw = r.normal(size=(B, 1, H, W)).astype(np.float32)
    want = flagship["je"]._forward_test(
        jstate.params, jstate.batch_stats, jnp.asarray(rgb.transpose(
            0, 2, 3, 1)), jnp.asarray(raw.transpose(0, 2, 3, 1)))
    got = te.forward_test(rgb=torch.from_numpy(rgb),
                          raw_depth=torch.from_numpy(raw))
    for k, v in got.items():
        np.testing.assert_allclose(
            v.numpy(), np.asarray(want[k]).transpose(0, 3, 1, 2), **FWD,
            err_msg=k)

    torch.manual_seed(2)
    back = t_build(flagship["tcfg"], is_train=True, steps_per_epoch=SPE)
    assert resume_from(back, path) == 3 and back.n_step == 7
    for name, mod in te.modules.items():
        for (k, v), w in zip(mod.state_dict().items(),
                             back.modules[name].state_dict().values()):
            if not _unmapped(name, k):
                assert torch.equal(v, w), (name, k)
    for k, opt in te.optimizers.items():
        bopt = back.optimizers[k]
        for p, q in zip(opt.param_groups[0]["params"],
                        bopt.param_groups[0]["params"]):
            for sk, sv in opt.state.get(p, {}).items():
                assert torch.equal(sv, bopt.state[q][sk]), (k, sk)
        assert back.schedulers[k].last_epoch == te.schedulers[k].last_epoch


def test_converters_round_trip_every_net(flagship):
    """from_jax(to_jax(sd)) == sd on every entry the JAX tree holds, and
    to_jax(from_jax(tree)) == tree, exactly, for the six nets and an NLSPN
    RDFGenerator."""
    from rdfc_gan_torch.models import RDFGenerator
    from test_torch_train_step import TINY

    import yaml

    cfg, state = t_parse(flagship["args"] + ["--device", "cpu"]), \
        flagship["state"]
    torch.manual_seed(3)
    te = t_build(cfg, is_train=True, steps_per_epoch=SPE)
    nets = dict(te.modules)
    g = dict(yaml.safe_load(TINY)["model"]["G"])
    g.pop("type")
    nets["G"] = RDFGenerator(**g)
    cfg.model["G"] = dict(type="RDFGenerator", **g)
    for name, mod in nets.items():
        sd = {k: v.numpy() for k, v in mod.state_dict().items()}
        t = net_tree_to_jax(cfg, name, mod, sd)
        back = net_state_dict_from_jax(cfg, name, mod, t["params"],
                                       t["batch_stats"])
        dropped = set(sd) - set(back)
        assert all(k.startswith("fuse_layer5.") for k in dropped), name
        for k, v in back.items():
            if k.endswith("num_batches_tracked") or k.endswith(
                    ("prop_layer.w", "prop_layer.b", "prop_layer.w_conf")):
                continue
            if name == "G_normal" and ".bn2." in k:
                continue  # the identity bn2 the JAX tree has not
            assert np.array_equal(v.numpy(), sd[k]), (name, k)
        if name in state.params:
            jt = {"params": _np_tree(state.params[name]),
                  "batch_stats": _np_tree(state.batch_stats[name])}
            sd2 = {k: v.numpy() for k, v in net_state_dict_from_jax(
                cfg, name, mod, jt["params"], jt["batch_stats"]).items()}
            t2 = net_tree_to_jax(cfg, name, mod, sd2)
            assert _bits(sorted_tree(t2)) == _bits(sorted_tree(jt)), name
    assert any(k.startswith("conv_offset_aff") for k in t["params"])


# ---------------------------------------------------------------- tools --
def _tool_round(tmp_path, cfg_path, nlspn):
    """The JAX tool's conversion (its ``convert_reference_state`` and
    ``save_checkpoint``; every net of the template comes from the
    ``.pth``) and the port's ``tools/convert_torch_ckpt.py`` on one
    ``make_synth_ref_ckpt`` file."""
    from rdfc_gan_torch.tools import convert_torch_ckpt as port_tool
    from rdfc_gan_tpu.config import load_config
    from rdfc_gan_tpu.utils.torch_convert import load_torch_state_dict

    jcfg = j_default()
    load_config(jcfg, cfg_path)
    jcfg.merge(dict(num_classes=14))
    pth = str(tmp_path / f"ref{int(nlspn)}.pth")
    make_synth_ref_ckpt.make_ckpt(jcfg, pth, 14, seed=1)
    je = j_build(jcfg, is_train=False)
    abstract = jax.eval_shape(je.init_state, jax.random.PRNGKey(0),
                              _jax_sample())
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), abstract)
    sd = load_torch_state_dict(pth)
    converted, report = convert_reference_state(sd, jcfg, template)
    jpath, ppath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    j_save(converted, jpath, meta=dict(converted_from=pth))
    assert port_tool.main(["--torch_ckpt", pth, "--model_cfg_path",
                           cfg_path, "--out", ppath]) == 0
    assert set(report.values()) == {f"converted ({n} tensors)" for n in
                                    {len([k for k in sd if k.startswith(
                                        net + ".")]) for net in report}}
    return abstract, jpath, ppath


@pytest.mark.parametrize("nlspn", [False, True])
def test_convert_tool_matches_jax_tool(tmp_path, capsys, nlspn):
    """Both files load into the JAX template (extended by the ``.pth``'s
    aux head); every leaf the ``.pth`` sets is bit-equal, and so are the
    files' bytes (maps in JAX's sorted order). The template's leaves that
    the ``.pth`` does not set: ``step`` alone."""
    cfg_path = TINY_CFG
    if nlspn:
        import yaml

        cfg = yaml.safe_load(open(TINY_CFG))
        cfg["model"]["G_A2B"].update(
            use_nlspn_refine=True, nlspn_configs=dict(
                prop_kernel=3, prop_time=3, affinity="TGASS",
                affinity_gamma=0.5, conf_prop=True, preserve_input=False))
        cfg_path = str(tmp_path / "nlspn.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
    abstract, jpath, ppath = _tool_round(tmp_path, cfg_path, nlspn)
    out = capsys.readouterr().out
    assert "nets in torch ckpt: ['G_A2B', 'G_B2A', 'G_label', 'G_normal', " \
        "'disc_A', 'disc_B']" in out
    assert "G_label: converted (" in out and f"wrote {ppath}" in out
    jt, _ = jax_checkpoint.read_state(jpath)
    pt, _ = jax_checkpoint.read_state(ppath)
    assert _bits(pt) == _bits(jt)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    assert ("conv_offset_aff" in pt["params"]["G_A2B"]) == nlspn
    # the JAX eval template plus the .pth's aux head reads both
    template = abstract.replace(
        params={**abstract.params, "G_label": jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
            pt["params"]["G_label"])})
    for p in (jpath, ppath):
        state, meta = j_load(template, p)
        assert _tree_spec(state) == _tree_spec(template)
        assert meta["converted_from"].endswith(".pth")
    unset = [k for k in pt if k not in ("params", "batch_stats")
             and not (isinstance(pt[k], dict) and not pt[k])]
    assert unset == ["step"]


# ------------------------------------------------------ NLSPN RDF-GAN --
def test_nlspn_rdfgan_resumes_after_two_jax_steps(tmp_path, caplog):
    """Two JAX train steps written by the JAX save_checkpoint (no epoch in
    its meta); the port resumes (epoch 0 with a warning, the step kept)
    and takes step 3, held against JAX's step 3 as
    tests/test_torch_train_step.py holds its steps; then serves the
    file."""
    te, je, state = _engines(tmp_path, "lsgan")
    step = jax.jit(je._train_step_impl, static_argnames=("update_g",))
    batches = list(_batches(3))
    for i in range(2):
        state, _ = step(state, batches[i][1], jax.random.PRNGKey(10 + i))
    path = str(tmp_path / "nlspn.ckpt")
    j_save(state.replace(opt_states={k: v[0] for k, v in
                                     state.opt_states.items()}), path)
    with _captured(caplog, "rdfc_gan_torch.utils.checkpoint"):
        assert resume_from(te, path) == 0
    assert "no epoch metadata" in caplog.text and te.n_step == 2
    G, D = te.modules["G"], te.modules["D"]
    state_before = state
    got = te.train_step(batches[2][0])
    state, want = step(state, batches[2][1], jax.random.PRNGKey(12))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    from rdfc_gan_torch.utils.convert import \
        rdf_generator_state_dict_from_jax as g_sd

    lr = te.cfg.lr
    _assert_grads(D, state.opt_states["D"][1], patchgan_state_dict_from_jax,
                  state_before.batch_stats["D"], 2)
    _assert_state(D, state.params["D"], state.batch_stats["D"],
                  state.opt_states["D"][1], patchgan_state_dict_from_jax,
                  lr, 3)
    _assert_grads(G, state.opt_states["G"][1], g_sd,
                  state_before.batch_stats["G"], 2)
    _assert_state(G, state.params["G"], state.batch_stats["G"],
                  state.opt_states["G"][1], g_sd, lr, 3)
    assert te.n_step == 3

    serve = t_build(te.cfg, is_train=False)
    load_checkpoint(serve.modules, path, cfg=te.cfg)
    rgb, raw = batches[0][0]["rgb"], batches[0][0]["raw_depth"]
    got = serve.forward_test(rgb=rgb, raw_depth=raw)
    want = je._forward_test(state_before.params, state_before.batch_stats,
                            batches[0][1]["rgb"], batches[0][1]["raw_depth"])
    for k in ("depth_map_1", "depth_map_2", "pred_depth"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]).transpose(0, 3, 1, 2),
            **FWD, err_msg=k)


# ------------------------------------------------------------ v1 driver --
def test_main_v1_from_jax_ckpt(tmp_path, monkeypatch):
    """``main_v1 --inference --load_from x.ckpt`` on a JAX v1 train state
    (the guided NLSPN model's JAX template, leaves seeded): the JAX
    EvalV1's 8 metrics; ``--resume_from x.ckpt`` trains on from its epoch
    and step."""
    import functools

    import main_v1 as j_main
    from rdfc_gan_torch.data import SyntheticDataset as TSynth
    from rdfc_gan_torch.registry import DATASETS as T_DATASETS
    from rdfc_gan_torch.tools import main_v1 as t_main
    from rdfc_gan_tpu.data import DataLoader as JLoader
    from rdfc_gan_tpu.data import SyntheticDataset as JSynth
    from rdfc_gan_tpu.evaluator.v1_evaluator import EvalV1 as JEvalV1
    from test_torch_v1_driver import TINY as V1_TINY
    from test_torch_v1_driver import _metrics

    monkeypatch.setitem(T_DATASETS._entries, "synthetic",
                        functools.partial(TSynth, length=4))
    flags = V1_TINY + ["--use_guidance", "--use_nlspn_to_refine"]
    jcfg = j_main.make_cfg(j_main.build_parser().parse_args(
        flags + ["--work_dir", str(tmp_path / "j")]))
    je = j_build(jcfg, is_train=True)
    ds = JSynth(length=4, height=64, width=64, num_classes=40,
                seed=jcfg.seed)
    loader = JLoader(ds, 4, shuffle=False, drop_last=False)
    sample = jax.tree.map(jnp.asarray, next(iter(loader)))
    abstract = jax.eval_shape(je.init_state, jax.random.PRNGKey(0), sample)
    r = np.random.RandomState(8)

    def fill(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['kernel']"):
            fan_in = int(np.prod(a.shape[:-1]))
            return (r.normal(size=a.shape) * np.sqrt(1.0 / fan_in)).astype(
                a.dtype)
        if key.endswith("['var']") or key.endswith("['scale']"):
            return r.uniform(0.8, 1.2, a.shape).astype(a.dtype)
        return (r.uniform(-0.1, 0.1, a.shape)).astype(a.dtype)

    state = abstract.replace(
        step=jnp.asarray(5, jnp.int32),
        params=jax.tree_util.tree_map_with_path(fill, abstract.params),
        batch_stats=jax.tree_util.tree_map_with_path(fill,
                                                     abstract.batch_stats),
        opt_states=_seeded_opt_states(abstract.opt_states, 9))
    path = str(tmp_path / "v1.ckpt")
    j_save(state, path, meta={"epoch": 1})
    assert t_main.main(flags + ["--device", "cpu", "--work_dir",
                                str(tmp_path / "inf"), "--inference",
                                "--load_from", path]) == 0
    got = _metrics(tmp_path / "inf" / "test.log")
    want = JEvalV1(loader).evaluate(je, state)
    assert len(got) == 8
    for k, v in want.items():
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], v, **FWD, err_msg=k)

    res = t_main.run(t_main.parse_cfg(flags + [
        "--device", "cpu", "--work_dir", str(tmp_path / "res"),
        "--resume_from", path, "--n_epochs", "2", "--save_interval", "1"]))
    assert res["steps"] == 1 and res["engine"].n_step == 6
    assert np.isfinite(list(res["losses"].values())).all()
    assert torch.load(tmp_path / "res" / "epoch_2.pth",
                      weights_only=True)["meta"]["epoch"] == 2
