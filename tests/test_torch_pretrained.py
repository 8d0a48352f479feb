"""The pretrained-torso flags of the port against the JAX engines, on the
CPU at tiny widths.

``--pretrained_resnet_path`` (both engines), ``--pretrained_normal_path``
and ``--pretrained_label_path`` (RDFCGAN only, as the JAX engines read
them): a configured path that does not exist raises
``FileNotFoundError``; a torso state dict synthesised from
``tools/torch_ref_models.py`` (torchvision resnet ``layer1-4``, a raw timm
EfficientNet, the dilated-R50 backbone layout; random weights and
BatchNorm statistics), written to a ``.pth``, lands in the port's nets
bit for bit as the JAX ``init_state`` puts it in the JAX tree, that tree
converted with the port's ``utils/convert.py``; what the file does not
cover keeps its init.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.cli import parse_config as t_parse
from rdfc_gan_torch.engines import build_engine as t_build
from rdfc_gan_torch.utils import pretrained
from rdfc_gan_torch.utils.convert import (nnet_state_dict_from_jax,
                                          pspnet_state_dict_from_jax,
                                          rdf_generator_state_dict_from_jax)
from rdfc_gan_tpu.cli import parse_config as j_parse
from rdfc_gan_tpu.engines import build_engine as j_build
from rdfc_gan_tpu.utils.torch_convert import load_torch_state_dict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from torch_ref_models import (TorchEncoderDecoder, TorchNNET,  # noqa: E402
                              TorchPSPNet)

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 32, 48, 2
NORMAL_WIDTH, NORMAL_DEPTH = 0.35, 0.3
LABEL_PLANES, LABEL_STEM = (8, 8, 16, 16), 8
FLAGS = ("pretrained_resnet_path", "pretrained_normal_path",
         "pretrained_label_path")

# the tiny flagship with G_A2B's rgb en1 at 64 channels, as the published
# config: both branches' en2 then take 64 channels in, so one resnet torso
# fits both (its layer1 has a downsample at these widths)
RDFC_TINY = open(os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")).read(
).replace("rgb_channels_encoder: [16, 16, 16, 16, 16, 16]",
          "rgb_channels_encoder: [64, 16, 16, 16, 16, 16]")
RDF_TINY = """
model:
  type: RDFGAN
  G:
    type: RDFGenerator
    encoder_rgb: resnet18
    encoder_depth: resnet18
    semantic_channels_in: 3
    fuse_depth_in_rgb_decoder: WAdaIN
    rgb_skip_connection_type: concat
    depth_skip_connection_type: concat
    rgb_channels_encoder: [64, 16, 16, 16, 16, 16]
    depth_channels_encoder: [64, 16, 16, 16, 16, 16]
    rgb_channels_decoder: [16, 16, 16, 16]
    depth_channels_decoder: [16, 16, 16, 16]
  D:
    type: PatchGANDiscriminator
    in_channels: 1
    out_channels: [8, 16, 16, 16, 1]
    activation: LeakyReLU
"""


def _randomize_bn(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo, hi in ((m.running_mean, -0.5, 0.5),
                                  (m.running_var, 0.5, 2.0),
                                  (m.weight, 0.5, 1.5),
                                  (m.bias, -0.2, 0.2)):
                    t.copy_(torch.rand(t.shape, generator=g) * (hi - lo)
                            + lo)
    return model


@pytest.fixture(scope="module")
def torsos(tmp_path_factory):
    """{flag: path of a synthesised torso .pth}, and the config files."""
    d = tmp_path_factory.mktemp("torsos")
    torch.manual_seed(0)
    ed = _randomize_bn(TorchEncoderDecoder(
        encoder_channels=(16,) * 5, decoder_channels=(16,) * 4,
        in_channels=64), 1)
    resnet = {f"layer{i - 1}.{k}": v
              for i in range(2, 6)
              for k, v in getattr(ed, f"en{i}").state_dict().items()}
    # the rest of a torchvision file, which no loader reads
    resnet["conv1.weight"] = torch.randn(64, 3, 7, 7)
    resnet["fc.weight"] = torch.randn(10, 16)
    nnet = _randomize_bn(TorchNNET(H, W, width=NORMAL_WIDTH,
                                   depth=NORMAL_DEPTH), 2)
    pre = "encoder.original_model."
    timm = {k[len(pre):]: v for k, v in nnet.state_dict().items()
            if k.startswith(pre)}  # the raw timm layout
    timm["classifier.weight"] = torch.randn(10, 16)
    psp = _randomize_bn(TorchPSPNet(14, planes=LABEL_PLANES,
                                    stem=LABEL_STEM), 3)
    backbone = {}
    for k, v in psp.state_dict().items():
        if k.startswith("initial.0."):
            backbone["conv1." + k[len("initial.0."):]] = v
        elif k.startswith("initial.1."):
            backbone["bn1." + k[len("initial.1."):]] = v
        elif k.startswith("layer"):
            backbone[k] = v
    paths = {}
    for flag, sd in zip(FLAGS, (resnet, timm, backbone)):
        paths[flag] = str(d / f"{flag}.pth")
        torch.save(sd, paths[flag])
    for name, text in (("rdfc.yaml", RDFC_TINY), ("rdf.yaml", RDF_TINY)):
        (d / name).write_text(text)
    return d, paths


def _args(d, cfg, flags):
    out = ["--dataset", "synthetic", "--model_cfg_path", str(d / cfg),
           "--work_dir", str(d / "w"), "--out_height", str(H),
           "--out_width", str(W), "--batch_size", str(B)]
    for k, v in flags.items():
        out += [f"--{k}", v]
    return out


def _port(d, cfg, flags, is_train=False):
    torch.manual_seed(0)
    return t_build(t_parse(_args(d, cfg, flags) + ["--device", "cpu"]),
                   is_train=is_train)


def _jax_state(d, cfg, flags):
    eng = j_build(j_parse(_args(d, cfg, flags)), is_train=False)
    batch = {"rgb": jnp.zeros((B, H, W, 3)),
             "raw_depth": jnp.zeros((B, H, W, 1)),
             "gt_depth": jnp.zeros((B, H, W, 1))}
    state = eng.init_state(jax.random.PRNGKey(0), batch)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return np_tree(state.params), np_tree(state.batch_stats)


def _assert_loaded(module, want, prefixes):
    """Every key of ``module`` under ``prefixes`` (but the BN batch counts)
    equals ``want``'s, bit for bit; returns how many were compared."""
    got = module.state_dict()
    keys = [k for k in got if k.startswith(prefixes)
            and not k.endswith("num_batches_tracked")]
    assert keys
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    return len(keys)


def _torso_prefixes():
    return tuple(f"{b}.en{i}." for b in pretrained.TORSO_BRANCHES
                 for i in range(2, 6))


@pytest.mark.parametrize("flag", FLAGS)
def test_rdfcgan_missing_path_raises(torsos, flag):
    d, paths = torsos
    flags = dict(paths, **{flag: str(d / "missing.pth")})
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        _port(d, "rdfc.yaml", flags)


def test_rdfgan_missing_path_raises(torsos):
    d, _ = torsos
    with pytest.raises(FileNotFoundError, match="missing.pth"):
        _port(d, "rdf.yaml",
              {"pretrained_resnet_path": str(d / "missing.pth")})


def test_rdfgan_reads_only_the_resnet_path(torsos):
    """The JAX RDFGAN reads neither the normal nor the label path, so a
    missing one is not an error there, nor here."""
    d, _ = torsos
    _port(d, "rdf.yaml", {"pretrained_normal_path": str(d / "missing.pth"),
                          "pretrained_label_path": str(d / "missing.pth")})


@pytest.fixture(scope="module")
def rdfc_jax(torsos):
    d, paths = torsos
    return _jax_state(d, "rdfc.yaml", paths)


@pytest.mark.parametrize("is_train", [False, True])
def test_rdfcgan_loads_the_torsos_as_jax(torsos, rdfc_jax, is_train):
    d, paths = torsos
    params, stats = rdfc_jax
    teng = _port(d, "rdfc.yaml", paths, is_train)
    init = _port(d, "rdfc.yaml", {}, is_train)
    want_a2b = rdf_generator_state_dict_from_jax(
        params["G_A2B"], stats["G_A2B"], use_nlspn_refine=False)
    n = _assert_loaded(teng.modules["G_A2B"], want_a2b, _torso_prefixes())
    assert n == 2 * (8 * 10 + 4 * 5)  # a branch: 8 blocks, 4 downsamples
    enc = "encoder.original_model."
    _assert_loaded(teng.modules["G_normal"], nnet_state_dict_from_jax(
        params["G_normal"], stats["G_normal"], depth=NORMAL_DEPTH),
        tuple(f"{enc}{m}." for m in ("conv_stem", "bn1", "blocks",
                                     "conv_head")))
    _assert_loaded(teng.modules["G_label"], pspnet_state_dict_from_jax(
        params["G_label"], stats["G_label"]),
        ("initial.", "layer1.", "layer2.", "layer3.", "layer4."))
    # what the files do not cover keeps the seeded init: G_A2B's decoder,
    # NNET's bn2 and decoder, the PSP head
    for net, prefixes in (("G_A2B", ("rgb_branch_encoder_decoder.de2.",
                                     "fuse_layer1.")),
                          ("G_normal", (f"{enc}bn2.", "decoder.")),
                          ("G_label", ("master_branch.",))):
        _assert_loaded(teng.modules[net], init.modules[net].state_dict(),
                       prefixes)


def test_rdfgan_loads_the_torsos_as_jax(torsos):
    d, paths = torsos
    flags = {"pretrained_resnet_path": paths["pretrained_resnet_path"]}
    params, stats = _jax_state(d, "rdf.yaml", flags)
    teng = _port(d, "rdf.yaml", flags, is_train=True)
    _assert_loaded(teng.modules["G"], rdf_generator_state_dict_from_jax(
        params["G"], stats["G"], use_nlspn_refine=False), _torso_prefixes())


def test_state_dict_reader_matches_jax(torsos):
    """A raw state dict and the reference's multi-net schema read as the
    JAX reader reads them (optimizer states left out)."""
    d, paths = torsos
    raw = paths["pretrained_label_path"]
    sd = torch.load(raw, weights_only=True)
    multi = str(d / "multi.pth")
    torch.save({"G_label_state_dict": sd, "G_state_dict": {"x": torch.ones(2)},
                "G_optimizer_state_dict": {"y": torch.ones(1)}}, multi)
    for path in (raw, multi):
        got = pretrained.load_torch_state_dict(path)
        want = load_torch_state_dict(path)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert "G.x" in pretrained.load_torch_state_dict(multi)


def test_loader_names_a_missing_key(torsos):
    d, paths = torsos
    sd = pretrained.load_torch_state_dict(paths["pretrained_label_path"])
    del sd["layer2.0.conv2.weight"]
    teng = _port(d, "rdfc.yaml", {})
    with pytest.raises(KeyError, match="layer2.0.conv2.weight"):
        pretrained.load_pspnet_backbone(teng.modules["G_label"], sd)
