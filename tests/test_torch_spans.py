"""The program's spans (``rdfc_gan_torch.utils.profiling.span``) on the CPU,
at the tiny sizes of the serving and train-step tests (32x48, batch 2;
``configs/rdfc_gan_tiny.yaml``, a narrow NLSPN RDF-GAN and a narrow
ESANet-guided one):

- ``forward_test`` of both engines under ``torch.profiler`` opens
  ``rdfc.serve`` once a call, with the served nets' spans inside it in
  call order (``rdfc.G_label``, ``rdfc.G_normal``, ``rdfc.G_A2B``; the
  RDF-GAN's ``rdfc.G`` with ``rdfc.nlspn_block`` inside it, and with a
  guided G ``rdfc.G_guidance`` before that block);
- one train step of each engine opens the loss and update spans, each
  optimizer's step inside an update span;
- with no profiler on, ``span`` never calls ``record_function``;
- the outputs are bit-equal with and without a profiler.

``tests/test_torch_export.py`` holds that no span enters an exported
graph.
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rdfc_gan_torch.cli import parse_config
from rdfc_gan_torch.data import SyntheticDataset
from rdfc_gan_torch.engines import build_engine
from rdfc_gan_torch.utils import profiling

# one intra-op thread a Tier-1 worker (see tests/test_torch_serving.py)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 32, 48, 2
NLSPN_TINY = """\
model:
  type: RDFGAN
  G:
    type: RDFGenerator
    rgb_channels_encoder: [8, 8, 8, 8, 8, 8]
    depth_channels_encoder: [8, 8, 8, 8, 8, 8]
    rgb_channels_decoder: [8, 8, 8, 8]
    depth_channels_decoder: [8, 8, 8, 8]
    use_nlspn_refine: true
    nlspn_configs: {prop_kernel: 3, prop_time: 3, affinity: TGASS,
                    affinity_gamma: 0.5, conf_prop: true,
                    preserve_input: false}
  D:
    type: PatchGANDiscriminator
    in_channels: 1
    out_channels: [8, 16, 16, 16, 1]
compute_dtype: float32
"""
# the v1 generator with its ESANet guidance, narrow decoders
GUIDED_TINY = """\
model:
  type: RDFGAN
  G:
    type: DCVGANGenerator
    guidance_channels_decoder: [8, 8, 8]
    rgb_channels_encoder: [8, 8, 8, 8, 8, 8]
    depth_channels_encoder: [8, 8, 8, 8, 8, 8]
    rgb_channels_decoder: [8, 8, 8, 8]
    depth_channels_decoder: [8, 8, 8, 8]
    fuse_depth_in_rgb_decoder: WAdaIN
    use_nlspn_refine: true
    nlspn_configs: {prop_kernel: 3, prop_time: 3, affinity: TGASS,
                    affinity_gamma: 0.5, conf_prop: true,
                    preserve_input: false}
  D:
    type: PatchGANDiscriminator
    in_channels: 1
    out_channels: [8, 16, 16, 16, 1]
compute_dtype: float32
"""
TINY_YAML = {"nlspn": NLSPN_TINY, "guided": GUIDED_TINY}
# the spans a served call opens inside rdfc.serve, in call order
SERVED = {"flagship": ["rdfc.G_label", "rdfc.G_normal", "rdfc.G_A2B"],
          "nlspn": ["rdfc.G", "rdfc.nlspn_block"],
          "guided": ["rdfc.G", "rdfc.G_guidance", "rdfc.nlspn_block"]}
# the spans a train step opens at its top level, in order
STEP = {"flagship": ["rdfc.train.G_loss", "rdfc.train.update.G+Nor+label",
                     "rdfc.train.D_loss", "rdfc.train.update.D"],
        "nlspn": ["rdfc.train.G_loss", "rdfc.train.D_loss",
                  "rdfc.train.update.D", "rdfc.train.G_loss",
                  "rdfc.train.update.G"]}


def _engine(kind, tmp_path, is_train):
    if kind == "flagship":
        cfg_path = os.path.join(ROOT, "configs", "rdfc_gan_tiny.yaml")
    else:
        cfg_path = str(tmp_path / f"{kind}_tiny.yaml")
        with open(cfg_path, "w") as f:
            f.write(TINY_YAML[kind])
    cfg = parse_config(["--dataset", "synthetic", "--model_cfg_path",
                        cfg_path, "--work_dir", str(tmp_path / "w"),
                        "--out_height", str(H), "--out_width", str(W),
                        "--batch_size", str(B), "--device", "cpu"])
    torch.manual_seed(0)
    return build_engine(cfg, is_train=is_train, steps_per_epoch=4)


def _batch():
    ds = SyntheticDataset(length=B, height=H, width=W, seed=3)
    smp = [ds[i] for i in range(B)]
    out = {}
    for k in smp[0]:
        v = np.stack([s[k] for s in smp])
        t = torch.from_numpy(v.copy())
        out[k] = t.permute(0, 3, 1, 2).contiguous() if v.ndim == 4 else t
    return out


def _events(prof, prefix="rdfc."):
    """(name, start, end) of the profile's events named ``prefix...``, in
    start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda t: (t[1], -t[2]))


def _inside(outer, ev):
    return outer[1] <= ev[1] and ev[2] <= outer[2]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    b = _batch()
    return {k: _engine(k, tmp, False) for k in SERVED}, b


@pytest.mark.parametrize("kind", sorted(SERVED))
def test_served_call_opens_serve_with_its_nets_inside(served, kind):
    engines, b = served
    eng = engines[kind]

    def two_calls():
        for _ in range(2):
            eng.forward_test(b["rgb"], b["raw_depth"])

    _, prof = _profiled(two_calls)
    evs = _events(prof)
    calls = [e for e in evs if e[0] == "rdfc.serve"]
    assert len(calls) == 2
    for call in calls:
        inner = [e for e in evs if e is not call and _inside(call, e)]
        assert [e[0] for e in inner] == SERVED[kind]
    if kind != "flagship":
        g, block = [e for e in evs if e[0] in ("rdfc.G",
                                               "rdfc.nlspn_block")][:2]
        assert _inside(g, block)
    if kind == "guided":
        guide = [e for e in evs if e[0] == "rdfc.G_guidance"][0]
        assert _inside(g, guide) and guide[2] <= block[1]
    assert len(evs) == 2 * (1 + len(SERVED[kind]))


def test_depth_only_skips_the_label_span(served):
    engines, b = served
    _, prof = _profiled(lambda: engines["flagship"].forward_test(
        b["rgb"], b["raw_depth"], depth_only=True))
    assert [e[0] for e in _events(prof)] == [
        "rdfc.serve", "rdfc.G_normal", "rdfc.G_A2B"]


@pytest.mark.parametrize("kind", sorted(SERVED))
def test_outputs_bit_equal_with_and_without_a_profiler(served, kind):
    engines, b = served
    eng = engines[kind]
    want = eng.forward_test(b["rgb"], b["raw_depth"])
    got, _ = _profiled(lambda: eng.forward_test(b["rgb"], b["raw_depth"]))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("kind", sorted(STEP))
def test_train_step_opens_loss_and_update_spans(kind, tmp_path):
    eng = _engine(kind, tmp_path, True)
    b = _batch()
    _, prof = _profiled(lambda: eng.train_step(b))
    evs = _events(prof)
    top = [e for e in evs
           if not any(o is not e and _inside(o, e) for o in evs)]
    assert [e[0] for e in top] == STEP[kind]
    updates = [e for e in top if e[0].startswith("rdfc.train.update.")]
    steps = _events(prof, "Optimizer.step#")
    assert len(steps) == len(eng.optimizers)
    assert all(any(_inside(u, s) for u in updates) for s in steps)
    if kind == "nlspn":
        block = [e for e in evs if e[0] == "rdfc.nlspn_block"]
        assert len(block) == 1 and _inside(top[0], block[0])


def test_span_calls_no_record_function_without_a_profiler(served,
                                                          monkeypatch):
    engines, b = served
    calls = []
    real = profiling.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    for eng in engines.values():
        eng.forward_test(b["rgb"], b["raw_depth"])
    assert calls == []
    with profiling.span("rdfc.test"):
        pass
    assert calls == []
    _profiled(lambda: engines["nlspn"].forward_test(b["rgb"],
                                                    b["raw_depth"]))
    assert calls == ["rdfc.serve", "rdfc.G", "rdfc.nlspn_block"]
    del calls[:]
    _profiled(lambda: engines["guided"].forward_test(b["rgb"],
                                                     b["raw_depth"]))
    assert calls == ["rdfc.serve", "rdfc.G", "rdfc.G_guidance",
                     "rdfc.nlspn_block"]
