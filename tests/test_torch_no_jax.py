"""The port stands alone and never hides the device: no module of it
imports JAX or anything of the JAX package, ``--device cuda`` without a
card raises, a wrapper given a non-CPU tensor never falls back to its plain
version, and the results of the kernel path stay in the autograd graph."""

import os
import subprocess
import sys

import pytest
import torch

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Every module of the package, walked, and chip_smoke."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import chip_smoke, rdfc_gan_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    rdfc_gan_torch.__path__, 'rdfc_gan_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert {'rdfc_gan_torch.train', 'rdfc_gan_torch.losses.gan_loss',\n"
        "        'rdfc_gan_torch.ops.kernels.mask_kernel',\n"
        "        'rdfc_gan_torch.ops.kernels.norm_kernel',\n"
        "        'rdfc_gan_torch.models.normal_net',\n"
        "        'rdfc_gan_torch.models.label_net',\n"
        "        'rdfc_gan_torch.models.resnet_generator',\n"
        "        'rdfc_gan_torch.ops.fused_block',\n"
        "        'rdfc_gan_torch.ops.kernels.conv_block_kernel',\n"
        "        'rdfc_gan_torch.utils.image_ops',\n"
        "        'rdfc_gan_torch.engines.rdfc_gan'} <= set(names)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'rdfc_gan_tpu',\n"
        "              'tools', 'attic'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _cuda_without_card_raises(main, monkeypatch, tmp_path,
                              config="rdf_gan_nlspn_config.yaml", extra=()):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--model_cfg_path",
              os.path.join(ROOT, "configs", config),
              "--work_dir", str(tmp_path), "--device", "cuda", *extra])


def test_device_cuda_without_card_raises(monkeypatch, tmp_path):
    from rdfc_gan_torch.test import main

    _cuda_without_card_raises(main, monkeypatch, tmp_path)


@pytest.mark.parametrize("extra", [(), ("--depth_only",)])
def test_flagship_serving_without_card_raises(monkeypatch, tmp_path, extra):
    """The RDFCGAN entry point, by default and with --depth_only."""
    from rdfc_gan_torch.test import main

    _cuda_without_card_raises(main, monkeypatch, tmp_path,
                              "rdf_cycle_patchgan_config.yaml", extra)


def test_train_device_cuda_without_card_raises(monkeypatch, tmp_path):
    from rdfc_gan_torch.train import main

    _cuda_without_card_raises(main, monkeypatch, tmp_path)


def test_flagship_train_without_card_raises(monkeypatch, tmp_path):
    """The flagship's train entry point defaults to the card too."""
    from rdfc_gan_torch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--model_cfg_path",
              os.path.join(ROOT, "configs", "rdf_cycle_patchgan_config.yaml"),
              "--work_dir", str(tmp_path)])


class _OnCard:
    """Stands in for a CUDA tensor: only its device is ever read before the
    wrapper reaches for its kernel."""

    device = torch.device("cuda", 0)


def _never(*args, **kwargs):
    raise AssertionError("plain version reached for a CUDA tensor")


def test_scatter_wrapper_never_takes_plain_on_cuda(monkeypatch):
    from rdfc_gan_torch.ops.kernels import mask_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mask_kernel, "scatter_shift_masks_plain", _never)
    x = _OnCard()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mask_kernel.scatter_shift_masks(x, x, x, 8)


def test_propagation_wrappers_never_take_plain_on_cuda(monkeypatch):
    from rdfc_gan_torch.ops.kernels import nlspn_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(nlspn_kernel, "stencil_propagate", _never)
    x = _OnCard()
    for call in (lambda: nlspn_kernel.nlspn_stencil_propagate(x, x, x, 18),
                 lambda: nlspn_kernel.propagate_auto(x, x, 18)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


def test_instance_norm_wrappers_never_take_plain_on_cuda(monkeypatch):
    from rdfc_gan_torch.ops.kernels import norm_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("instance_norm_fwd_plain", "instance_norm_bwd_plain"):
        monkeypatch.setattr(norm_kernel, name, _never)
    x = _OnCard()
    for call in (lambda: norm_kernel.instance_norm_fwd(x, 1e-5),
                 lambda: norm_kernel.instance_norm_bwd(x, x, x),
                 lambda: norm_kernel.instance_norm(x)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


def test_conv_block_wrappers_never_take_plain_on_cuda(monkeypatch):
    from rdfc_gan_torch.ops.kernels import conv_block_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("conv3x3_fwd_plain", "conv3x3_bwd_plain"):
        monkeypatch.setattr(conv_block_kernel, name, _never)
    x = _OnCard()
    for call in (lambda: conv_block_kernel.conv3x3_fwd(x, x),
                 lambda: conv_block_kernel.conv3x3_bwd(x, x, x)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


def test_backward_wrappers_never_take_plain_on_cuda(monkeypatch):
    from rdfc_gan_torch.ops import nlspn_stencil
    from rdfc_gan_torch.ops.kernels import mask_kernel, nlspn_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, name in ((mask_kernel, "shift_mask_gather_plain"),
                      (mask_kernel, "shift_correlation_plain"),
                      (nlspn_kernel, "propagate_x_plain"),
                      (nlspn_kernel, "reverse_chain_plain"),
                      (nlspn_stencil, "propagate_x_plain"),
                      (nlspn_stencil, "reverse_chain_plain")):
        monkeypatch.setattr(mod, name, _never)
    x = _OnCard()
    for call in (
            lambda: mask_kernel.shift_mask_gather(x, x, x, 8, torch.float32),
            lambda: mask_kernel.shift_correlation(x, x, 8, -3),
            lambda: nlspn_kernel.propagate_x(x, x, None, 18, 2,
                                             torch.float32),
            lambda: nlspn_kernel.reverse_chain(x, x, None, 18, 2,
                                               torch.float32)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


class _FakeLib:
    """Stands in for a built kernel library: every launch succeeds and
    writes nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_kernel_results_carry_grad_fn(monkeypatch):
    """Fault 1 of slice 1: a ctypes launch returns a tensor outside the
    autograd graph. The kernel path (here on meta tensors, which are not
    CPU tensors, with the launch faked) must hand back results with a
    grad_fn whenever an input requires grad, and route their backward
    through the backward kernels."""
    from rdfc_gan_torch.ops.kernels import build, mask_kernel, nlspn_kernel

    monkeypatch.setattr(build, "library", lambda name: _FakeLib())
    monkeypatch.setattr(build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(build, "stream_handle", lambda: None)
    build.reset_launches()
    meta = dict(device="meta")
    B, K, S, H, W, T = 2, 36, 8, 5, 6, 3
    w = torch.empty((B, K, H, W), **meta).requires_grad_(True)
    idx = torch.empty((B, K, H, W), dtype=torch.int32, **meta)
    M = mask_kernel.scatter_shift_masks(w, idx, idx, S)
    assert M.grad_fn is not None
    feat = torch.empty((B, 1, H, W), **meta).requires_grad_(True)
    out = nlspn_kernel.nlspn_stencil_propagate(
        feat, M.reshape(B, S, S, H, W), None, T, 2, False)
    assert out.grad_fn is not None
    out.sum().backward()
    assert w.grad is not None and feat.grad is not None
    assert dict(build.LAUNCHES) == {
        "shift_mask_scatter": 1, "nlspn_propagate_x": 1,
        "nlspn_reverse_chain": 1, "shift_correlation": 1,
        "shift_mask_gather": 1}
    with torch.no_grad():  # no gradient wanted: the served chain
        nlspn_kernel.nlspn_stencil_propagate(feat, M.reshape(B, S, S, H, W),
                                             None, T, 2, False)
    assert build.LAUNCHES["nlspn_propagate"] == 1  # one launch a chain
    build.reset_launches()


def test_instance_norm_result_carries_grad_fn(monkeypatch):
    """The IN kernel path (meta tensors, launches faked) stays in the
    autograd graph and runs its backward through the backward kernel."""
    from rdfc_gan_torch.ops.kernels import build, norm_kernel

    monkeypatch.setattr(build, "library", lambda name: _FakeLib())
    monkeypatch.setattr(build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(build, "stream_handle", lambda: None)
    build.reset_launches()
    for dt in (torch.float32, torch.bfloat16):
        x = torch.empty((2, 3, 14, 19), dtype=dt,
                        device="meta").requires_grad_(True)
        y = norm_kernel.instance_norm(x)
        assert y.grad_fn is not None and y.dtype == dt
        y.sum().backward()
        assert x.grad is not None and x.grad.dtype == dt
    assert dict(build.LAUNCHES) == {"instance_norm_fwd": 2,
                                    "instance_norm_bwd": 2}
    build.reset_launches()


def test_fused_block_result_carries_grad_fn(monkeypatch):
    """The fused BasicBlock on the conv kernels (meta tensors, launches
    faked): its output stays in the autograd graph, its backward runs the
    backward kernel twice, and each wrapper call counts one launch."""
    from rdfc_gan_torch.ops.fused_block import basic_block
    from rdfc_gan_torch.ops.kernels import build

    monkeypatch.setattr(build, "library", lambda name: _FakeLib())
    monkeypatch.setattr(build, "require_card", lambda name: None)
    monkeypatch.setattr(build, "require_cuda", lambda name, *t: None)
    monkeypatch.setattr(build, "stream_handle", lambda: None)
    build.reset_launches()
    C = 4
    for dt in (torch.float32, torch.bfloat16):
        x = torch.empty((2, C, 6, 7), dtype=dt,
                        device="meta").requires_grad_(True)
        ps = [torch.empty(s, device="meta").requires_grad_(True)
              for s in ((C, C, 3, 3), (C,), (C,), (C, C, 3, 3), (C,), (C,))]
        out, stats = basic_block(x, *ps)
        assert out.grad_fn is not None and out.dtype == dt
        assert all(s.shape == (C,) and s.dtype == torch.float32
                   for s in stats)
        out.sum().backward()
        assert x.grad is not None and x.grad.dtype == dt
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in ps)
    # bf16 on the tensor-core kernels, f32 on the exact f64 ones
    assert dict(build.LAUNCHES) == {"conv3x3_fwd": 2, "conv3x3_bwd": 2,
                                    "conv3x3_fwd_f32": 2,
                                    "conv3x3_bwd_f32": 2}
    build.reset_launches()
