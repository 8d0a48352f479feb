"""Each net's reference is found by its configuration's ``type``
(``benchmark/reference/nets/<type>.py``), and NLSPN wherever a generator
holds it. The constants were recorded from the harness of commit 3689b20,
whose ``engines.build_nets`` built every net by hand: the same nets, in
the same ``state_dict()`` order, the same seeded weights, offset scale and
FLOP counts."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import pytest
import torch

from conftest import load, tiny_config

CONFIGS = ("rdfcgan-flagship", "rdfgan-nlspn")

# (config, train): state-dict entries, digest of every "<net>.<key>:<shape>:
# <dtype>" in build order, and the FLOPs of one request (batch 4) or one
# train step (batch 16), at the configuration's full size
FULL_SIZE = {
    ("rdfcgan-flagship", False): (1619, "80c29bd93ea66488", 1343110399488),
    ("rdfcgan-flagship", True): (1709, "e980204e8f28ffa2", 51167496450048),
    ("rdfgan-nlspn", False): (350, "fbebf772dd509d46", 866172403712),
    ("rdfgan-nlspn", True): (375, "84cfa41533e582c1", 11214424899584),
}
# (config, train): the offset scale on a probe batch of the seed
# 2147483900 + train at the tiny size (None: no NLSPN), and the digest of
# the weights that scale gives
TINY = {
    ("rdfcgan-flagship", False): (None, "efaa0f08563624b3"),
    ("rdfcgan-flagship", True): (None, "5e3eb2dd7abc0ba4"),
    ("rdfgan-nlspn", False): (0.76096617193541, "fda6d3828bd89955"),
    ("rdfgan-nlspn", True): (0.3217506631503213, "43a0039211494fdb"),
}
CASES = sorted(FULL_SIZE)


def _shapes(nets) -> tuple:
    h, n = hashlib.sha256(), 0
    for k, net in nets.items():
        for name, t in net.state_dict().items():
            h.update(f"{k}.{name}:{tuple(t.shape)}:{t.dtype}\n".encode())
            n += 1
    return n, h.hexdigest()[:16]


def _digest(nets) -> str:
    h = hashlib.sha256()
    for k in sorted(nets):
        for name, t in nets[k].state_dict().items():
            h.update(f"{k}.{name}".encode())
            h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _probe(cfg, seed, train):
    from harness import data

    b = data.batch_pool(seed, 1, 2, cfg["out_height"], cfg["out_width"],
                        train=train, classes=cfg["num_classes"])[0]
    return b["rgb"], b["raw_depth"]


@pytest.mark.parametrize("name,train", CASES)
def test_full_size_nets_and_flops_as_the_parent(name, train):
    from reference import engines, flops

    cfg = load(f"benchmark/configs/{name}.json")
    n, digest, want_flops = FULL_SIZE[name, train]
    assert _shapes(engines.build_nets(cfg, train, "meta")) == (n, digest)
    assert flops.count(cfg, cfg["train"], 16 if train else 4,
                       train) == want_flops


@pytest.mark.parametrize("name,train", CASES)
def test_tiny_weights_and_offset_scale_as_the_parent(name, train, cpu):
    """The seeded fill is exact on any CPU; the scale comes from a probe
    forward, whose convolutions may round apart on another CPU."""
    from reference import weights

    cfg = tiny_config(name)
    seed = 2147483900 + train
    want_scale, want_digest = TINY[name, train]
    nets, scale = weights.make(cfg, train, seed, cpu,
                               probe=_probe(cfg, seed, train),
                               probe_train=train)
    given, _ = weights.make(cfg, train, seed, cpu, scale=scale)
    assert _digest(nets) == _digest(given)
    if want_scale is None:
        assert scale is None
    else:
        assert scale == pytest.approx(want_scale, rel=1e-6)
    parent, _ = weights.make(cfg, train, seed, cpu, scale=want_scale)
    assert _digest(parent) == want_digest


@pytest.mark.parametrize("name,key,train", [
    ("rdfgan-nlspn", "G", False), ("rdfgan-nlspn", "D", True),
    ("rdfcgan-flagship", "G_A2B", False), ("rdfcgan-flagship", "D_B", True)])
def test_unknown_type_raises_before_any_weight(name, key, train, cpu,
                                               monkeypatch):
    from reference import engines, flops, weights

    cfg = tiny_config(name)
    cfg["model"][key]["type"] = "NoSuchNet"

    def no_fill(*args):
        raise AssertionError("weights made for an unknown type")

    monkeypatch.setattr(weights, "fill", no_fill)
    where = "benchmark/reference/nets/NoSuchNet.py"
    with pytest.raises(engines.SpecError, match=where):
        weights.make(cfg, train, 2147483902, cpu,
                     probe=_probe(cfg, 2147483902, train))
    with pytest.raises(engines.SpecError, match=where):
        flops.count(cfg, cfg["train"], 2, train)


@pytest.mark.parametrize("type_name", ["../nets/RDFGenerator", None])
def test_type_that_is_no_name_raises(type_name):
    from reference import engines

    cfg = tiny_config("rdfgan-nlspn")
    cfg["model"]["G"]["type"] = type_name
    with pytest.raises(engines.SpecError, match="is not a name"):
        engines.build_nets(cfg, False, "meta")


WRAPPED = '''
from torch import nn

from harness import common

RDF = common.load_module({path!r}, "reference.nets.RDFGenerator")


class Wrapped(nn.Module):
    """A generator that holds the RDFGenerator, NLSPN and all, as
    ``core``."""

    def __init__(self, core):
        super().__init__()
        self.core = core

    def forward(self, rgb, depth):
        return self.core(rgb, depth)


def build(net, cfg):
    return Wrapped(RDF.build(net, cfg))
'''


def _wrapped(cfg, monkeypatch, tmp_path) -> dict:
    """``cfg`` with its G of a type that only ``tmp_path`` holds: the
    RDFGenerator one level down, as ``core``."""
    from reference import engines

    (tmp_path / "WrappedRDFGenerator.py").write_text(WRAPPED.format(
        path=os.path.join(engines.NETS, "RDFGenerator.py")))
    monkeypatch.setattr(engines, "NETS", str(tmp_path))
    cfg = dict(cfg, model=dict(cfg["model"]))
    cfg["model"]["G"] = dict(cfg["model"]["G"], type="WrappedRDFGenerator")
    return cfg


def test_nlspn_one_level_down_is_seeded_as_the_unwrapped(cpu, monkeypatch,
                                                         tmp_path):
    from reference import engines, weights

    cfg, seed = tiny_config("rdfgan-nlspn"), 2147483903
    probe = _probe(cfg, seed, False)
    plain, plain_scale = weights.make(cfg, False, seed, cpu, probe=probe)
    raw = engines.build_nets(cfg, False, "meta")
    raw = {k: n.to_empty(device=cpu) for k, n in raw.items()}
    weights.fill(raw, seed, cpu)

    nets, scale = weights.make(_wrapped(cfg, monkeypatch, tmp_path), False,
                               seed, cpu, probe=probe)
    assert scale == plain_scale
    got = nets["G"].state_dict()
    want = plain["G"].state_dict()
    assert list(got) == ["core." + k for k in want]
    for k, w in want.items():
        assert torch.equal(got["core." + k], w), k
    # both raised the affinity rows and scaled the offset rows of the fill
    conv = "nlspn_refine_module.prop_layer.conv_offset_aff."
    n_off = 2 * (want[conv + "bias"].numel() // 3)
    fill = raw["G"].state_dict()
    for leaf in ("weight", "bias"):
        w, f = got["core." + conv + leaf], fill[conv + leaf]
        assert torch.equal(w[:n_off], f[:n_off] * scale)
    w, b = fill[conv + "weight"], fill[conv + "bias"]
    assert torch.equal(got["core." + conv + "weight"][n_off:],
                       w[n_off:] * weights.AFF_WEIGHT_SCALE)
    assert torch.equal(got["core." + conv + "bias"][n_off:],
                       b[n_off:] + weights.AFF_BIAS)


def test_new_type_is_found_without_an_edit(cpu, monkeypatch, tmp_path):
    """A type file outside the tree, found through the lookup's folder:
    weights, FLOPs and the served maps as the type it wraps."""
    from reference import engines, flops, weights

    cfg, seed = tiny_config("rdfgan-nlspn"), 2147483904
    rgb, raw = _probe(cfg, seed, False)
    plain, scale = weights.make(cfg, False, seed, cpu, probe=(rgb, raw))
    want = engines.Engine(cfg, plain).forward_test(rgb, raw)
    want_flops = flops.count(cfg, cfg["train"], 2, False)

    wcfg = _wrapped(cfg, monkeypatch, tmp_path)
    nets, wscale = weights.make(wcfg, False, seed, cpu, probe=(rgb, raw))
    assert type(nets["G"]).__name__ == "Wrapped" and wscale == scale
    got = engines.Engine(wcfg, nets).forward_test(rgb, raw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert flops.count(wcfg, wcfg["train"], 2, False) == want_flops


def test_generator_without_nlspn_is_left_alone(cpu):
    from reference import engines, weights

    cfg, seed = tiny_config("rdfgan-nlspn"), 2147483905
    cfg["model"]["G"]["use_nlspn_refine"] = False
    nets, scale = weights.make(cfg, False, seed, cpu)
    assert scale is None
    raw = engines.build_nets(cfg, False, "meta")
    raw = {k: n.to_empty(device=cpu) for k, n in raw.items()}
    weights.fill(raw, seed, cpu)
    assert _digest(nets) == _digest(raw)


def test_flop_cache_key_follows_the_type_files(monkeypatch, tmp_path):
    """An edit to a file under ``reference/nets`` counts the FLOPs anew."""
    import run
    from conftest import BENCH, tiny_spec

    shutil.copytree(f"{BENCH}/reference", tmp_path / "reference",
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(run, "HERE", str(tmp_path))
    spec = tiny_spec("rdfgan-nlspn", "serve-closed-b4")
    first = run.flop_count(spec)
    with open(tmp_path / "reference" / "nets" / "RDFGenerator.py", "a") as f:
        f.write("# edited\n")
    assert run.flop_count(spec) == first
    with open(tmp_path / ".cache" / "flops.json") as f:
        assert len(json.load(f)) == 2
