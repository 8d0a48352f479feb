"""The port's global-batch BatchNorm at world size 2 against the JAX
package's, on the CPU: two gloo ranks (``tests/torch_dp_worker.py``), each
with its half of a global batch, started once for the module.

* ``BatchNorm2d`` in train mode against the JAX ``_bn_train`` under
  ``jax.pmap(axis_name="d")`` over two CPU devices (the pattern of
  ``tests/test_layer_rewrites.py:93-121``): y, dx, each rank's gamma and
  beta gradients and their sum, the running mean and variance; f32, and
  bf16 with the port's rounding (gamma and beta rounded to bf16 as the
  JAX step casts its parameters).
* The fused BasicBlock (``ops/fused_block``, the conv kernels' plain
  versions) at world 2 against the JAX ``BasicBlock`` on the global batch:
  output, running statistics, the gradients of x, of both kernels, both
  gammas and both betas (summed over the ranks).

Tolerances. f32: values rtol 1e-5 / atol 2e-6 (the same formula; the sums
run in another order, and ``E[x^2] - mean^2`` cancels the last bits); the
running statistics rtol 1e-5 / atol 1e-7; gradients within 1e-5 of each
tensor's largest entry. bf16: the coefficients are rounded to bf16 from
f32 sums made in another order, so each bf16 term of y = x a + b and of
dx = A dy + cy y + c0 may take the neighbouring value, and XLA keeps f32
between the bf16 operations of a fusion where the port rounds each one:
y within 2^-7 of the summed magnitudes of its terms (an ulp of each term
and of the result), dx, with three terms and two rounded additions,
within 2^-6 of its terms' (2 ulps of the result seen), each plus 2^-12;
the gamma and beta gradients (rounded to bf16 from f32 sums) within 2^-7
of the largest entry on each rank, and their sum over the two ranks within
2^-6 (an ulp from each rank).
The block: the tolerances of ``tests/test_torch_fused_block.py`` (rtol
1e-3 / atol 1e-4 for values, 1e-4 / 1e-5 for statistics, 2e-4 of the
largest entry plus 5e-6 for gradients), and the two ranks' parameters
and gradients after the all-reduce bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from rdfc_gan_torch.models.resnet import BasicBlock

torch.set_num_threads(1)

B, C, H, W = 4, 6, 5, 7
F32 = dict(rtol=1e-5, atol=2e-6)
STATS = dict(rtol=1e-5, atol=1e-7)


def _r(shape, seed, scale=1.0, shift=0.0):
    r = np.random.RandomState(seed)
    return (r.normal(size=shape) * scale + shift).astype(np.float32)


def _bn_inputs():
    g = np.random.RandomState(3).uniform(0.3, 2.0, (C,)).astype(np.float32)
    b = np.random.RandomState(4).uniform(-1, 1, (C,)).astype(np.float32)
    sd = {"weight": torch.from_numpy(g), "bias": torch.from_numpy(b),
          "running_mean": torch.zeros(C), "running_var": torch.ones(C),
          "num_batches_tracked": torch.tensor(0)}
    x = _r((B, C, H, W), 1, 2.0, 0.7)
    # rank 1's rows sit elsewhere, so local statistics would not do
    x[B // 2:] = x[B // 2:] * 0.5 - 1.0
    return dict(x=torch.from_numpy(x), dy=torch.from_numpy(
        _r((B, C, H, W), 2)), sd=sd)


def _block_inputs():
    torch.manual_seed(0)
    blk = BasicBlock(C, C).train()
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
            bn.running_mean.uniform_(-0.2, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
    x = _r((B, C, 8, 9), 5, 2.0, 0.3)
    x[B // 2:] += 1.5
    return dict(x=torch.from_numpy(x), wr=torch.from_numpy(
        _r((B, C, 8, 9), 6)), sd={k: v.clone() for k, v in
                                  blk.state_dict().items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    bn, blk = _bn_inputs(), _block_inputs()
    out = torch_dp_worker.run_ranks(
        [("sync_bn", "sync_bn", bn), ("fused_block", "fused_block", blk)],
        str(tmp_path_factory.mktemp("sync_bn")))
    return bn, blk, out


def _nhwc(a):
    return np.asarray(a, np.float32).transpose(0, 2, 3, 1)


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def _jax_sync_bn(inp, dtype):
    """The JAX _bn_train over 2 pmap devices with axis_name 'd': y, mean,
    var, dx and the per-device dscale / dbias of the cotangent dy."""
    from rdfc_gan_tpu.models.layers import _bn_train

    x = _nhwc(inp["x"]).reshape(2, B // 2, H, W, C)
    dy = _nhwc(inp["dy"]).reshape(2, B // 2, H, W, C)
    g = np.broadcast_to(inp["sd"]["weight"].numpy(), (2, C))
    b = np.broadcast_to(inp["sd"]["bias"].numpy(), (2, C))

    def step(x_, g_, b_, dy_):
        def f(xx, gg, bb):
            return _bn_train(xx, gg, bb, 1e-5, 1, "d")

        (y, mean, var), vjp = jax.vjp(f, x_, g_, b_)
        dx, dg, db = vjp((dy_, jnp.zeros_like(mean), jnp.zeros_like(var)))
        return y, mean, var, dx, dg, db

    args = [jnp.asarray(a).astype(dtype) for a in (x, g, b, dy)]
    return [np.asarray(jnp.asarray(v).astype(jnp.float32))
            for v in jax.pmap(step, axis_name="d")(*args)]


def _ranks_cat(out, key, dt):
    return np.concatenate([o["sync_bn"][dt][key].numpy() for o in out])


def _bf16_bounds(inp, mean, var):
    """Per element, 2^-7 of the summed magnitudes of the bf16 terms of y
    and 2^-6 of those of dx (f64, from the global statistics), plus
    2^-12."""
    x, dy = (inp[k].numpy().astype(np.float64) for k in ("x", "dy"))
    g, b = (inp["sd"][k].numpy().astype(np.float64)[None, :, None, None]
            for k in ("weight", "bias"))
    mean, var = (np.asarray(v, np.float64)[None, :, None, None]
                 for v in (mean, var))
    A = g / np.sqrt(var + 1e-5)
    y = x * A + (b - mean * A)
    n = x.size // x.shape[1]
    xhat = (x - mean) * A / g
    m1 = dy.sum((0, 2, 3), keepdims=True) / n
    m2 = (dy * xhat).sum((0, 2, 3), keepdims=True) / n
    cy, c0 = -A / g * m2, A * (m2 * b / g - m1)
    return (2.0 ** -7 * (np.abs(x * A) + np.abs(b - mean * A)) + 2.0 ** -12,
            2.0 ** -6 * (np.abs(A * dy) + np.abs(cy * y) + np.abs(c0))
            + 2.0 ** -12)


@pytest.mark.parametrize("dt", ["torch.float32", "torch.bfloat16"])
def test_sync_bn_matches_jax_pmap(ranks, dt):
    inp, _, out = ranks
    jdt = jnp.float32 if dt == "torch.float32" else jnp.bfloat16
    y, mean, var, dx, dg, db = _jax_sync_bn(inp, jdt)
    got_y, got_dx = _ranks_cat(out, "y", dt), _ranks_cat(out, "dx", dt)
    want_y, want_dx = (_nchw(v.reshape(B, H, W, C)) for v in (y, dx))
    if jdt == jnp.float32:
        gtol = 1e-5
        np.testing.assert_allclose(got_y, want_y, **F32)
        np.testing.assert_allclose(got_dx, want_dx, **F32)
    else:
        gtol = 2.0 ** -7
        by, bdx = _bf16_bounds(inp, mean[0], var[0])
        assert (np.abs(got_y - want_y) <= by).all(), \
            float(np.abs(got_y - want_y).max())
        assert (np.abs(got_dx - want_dx) <= bdx).all(), \
            float(np.abs(got_dx - want_dx).max())
    for r, o in enumerate(out):
        s = o["sync_bn"][dt]
        for key, want in (("dgamma", dg[r]), ("dbeta", db[r])):
            np.testing.assert_allclose(s[key].numpy(), want, rtol=0,
                                       atol=gtol * np.abs(want).max(),
                                       err_msg=f"rank {r} {key}")
        # the global statistics: every rank's running update is the same
        np.testing.assert_allclose(s["running_mean"].numpy(),
                                   0.1 * mean[r], **STATS)
        np.testing.assert_allclose(s["running_var"].numpy(),
                                   0.9 + 0.1 * var[r], **STATS)
        assert int(s["num_batches_tracked"]) == 1
    for key, want in (("dgamma", dg.sum(0)), ("dbeta", db.sum(0))):
        got = sum(o["sync_bn"][dt][key].numpy() for o in out)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * gtol * np.abs(want).max())
    # the global variance differs from either half's: a rank's own
    # statistics would fail the checks above
    xs = inp["x"].numpy()
    assert not np.allclose(var[0], xs[:B // 2].var(axis=(0, 2, 3)),
                           rtol=1e-2)


def _grad_close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max() + 5e-6,
                               err_msg=err_msg)


def test_fused_block_world2_matches_jax_global_batch(ranks):
    from rdfc_gan_tpu.models.resnet import BasicBlock as JBlock

    _, inp, out = ranks
    sd = inp["sd"]
    params = {"Conv_0": {"kernel": jnp.asarray(
        sd["conv1.weight"].numpy().transpose(2, 3, 1, 0))},
        "Conv_1": {"kernel": jnp.asarray(
            sd["conv2.weight"].numpy().transpose(2, 3, 1, 0))}}
    stats = {}
    for i in range(2):
        params[f"BatchNorm_{i}"] = {
            "scale": jnp.asarray(sd[f"bn{i + 1}.weight"].numpy()),
            "bias": jnp.asarray(sd[f"bn{i + 1}.bias"].numpy())}
        stats[f"BatchNorm_{i}"] = {
            "mean": jnp.asarray(sd[f"bn{i + 1}.running_mean"].numpy()),
            "var": jnp.asarray(sd[f"bn{i + 1}.running_var"].numpy())}
    jb = JBlock(planes=C)
    wr = _nhwc(inp["wr"])

    def loss(p, xj):
        o, mut = jb.apply({"params": p, "batch_stats": stats}, xj,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(o * wr), (o, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, _nhwc(inp["x"]))
    r0, r1 = (o["fused_block"] for o in out)
    np.testing.assert_allclose(
        np.concatenate([r0["y"].numpy(), r1["y"].numpy()]), _nchw(want),
        rtol=1e-3, atol=1e-4)
    _grad_close(np.concatenate([r0["dx"].numpy(), r1["dx"].numpy()]),
                _nchw(gx), "dx")
    for k in r0["grads"]:
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    for i in range(2):
        ms = mut["batch_stats"][f"BatchNorm_{i}"]
        for key, jk in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(r0["state"][f"bn{i + 1}.{key}"],
                                       np.asarray(ms[jk]), rtol=1e-4,
                                       atol=1e-5)
        g = gp[f"BatchNorm_{i}"]
        _grad_close(r0["grads"][f"bn{i + 1}.weight"].numpy(),
                    np.asarray(g["scale"]), f"bn{i + 1} gamma")
        _grad_close(r0["grads"][f"bn{i + 1}.bias"].numpy(),
                    np.asarray(g["bias"]), f"bn{i + 1} beta")
        _grad_close(r0["grads"][f"conv{i + 1}.weight"].numpy(),
                    np.asarray(gp[f"Conv_{i}"]["kernel"]).transpose(
                        3, 2, 0, 1), f"conv{i + 1}")
