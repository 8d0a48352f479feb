"""BENCHMARK.json against the harness's files: every cell finds its
configuration, traffic mix, limits and metric readers by name, every name
and unit keeps to its characters, and a new cell, configuration or metric
needs only new files and an entry."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = load("BENCHMARK.json")


def test_top_level_keys_and_command():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCHMARK["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_finds_its_files(cell):
    from harness import common

    spec = common.load_spec(cell, ROOT)
    assert spec.chips == 1
    assert spec.limits
    assert spec.traffic["driver"] in ("serve", "train")
    for m in spec.end_to_end + spec.per_layer:
        assert callable(common.reader(m["name"]))
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer


def test_names_units_and_keys():
    seen = set()
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
        assert c["source"].startswith("https://")
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCHMARK["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


@pytest.mark.parametrize("family", sorted(
    f[:-3] for f in os.listdir(os.path.join(BENCH, "roofline"))
    if f.endswith(".py")))
def test_roofline_families_load(family):
    from harness import common

    fam = common.roofline_family(family)
    re.compile(fam.KERNELS)
    assert callable(fam.work)


def test_new_cell_config_and_metric_are_files_and_entries(tmp_path):
    """A copy of the layout with one more configuration, traffic mix, cell
    and per-layer metric, each a new file and an entry, loads and reads."""
    from harness import common

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCHMARK))
    cfg = load("benchmark/configs/rdfgan-nlspn.json")
    cfg["name"] = "dummy-config"
    (root / "benchmark/configs/dummy-config.json").write_text(
        json.dumps(cfg))
    (root / "benchmark/traffic/dummy-traffic.json").write_text(json.dumps(
        dict(load("benchmark/traffic/serve-closed-b4.json"), batch=2)))
    (root / "benchmark/workloads/dummy-cell.json").write_text(
        json.dumps({"limits": {"pred_depth_err": 1.0}}))
    (root / "benchmark/metrics/dummy_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.batch\n")
    bench["configs"].append(dict(name="dummy-config", source="https://x",
                                 file="benchmark/configs/dummy-config.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="dummy-cell", config="dummy-config",
                                   traffic="dummy-traffic", chips=1,
                                   why="a test"))
    bench["per_layer"].append(dict(name="dummy_metric", unit="x",
                                   better="higher", source="host_clock",
                                   layer="engines", moves="serve_img_s",
                                   workloads=["dummy-cell"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = common.load_spec("dummy-cell", str(root))
    assert spec.config["name"] == "dummy-config"
    assert spec.traffic["batch"] == 2
    assert [m["name"] for m in spec.per_layer][-1] == "dummy_metric"
    mod = common.load_module(str(root / "benchmark/metrics/dummy_metric.py"),
                             "dummy_metric")
    ctx = common.Ctx(spec=spec, seed=0)
    assert mod.read(ctx) == 4.0
    with pytest.raises(common.SpecError):
        common.load_spec("no-such-cell", str(root))


def test_a_pair_that_no_cell_holds_loads_without_limits():
    """``control.py --pair``: a configuration under a traffic mix that no
    cell pairs, here the train mix, found by name with no limits."""
    from harness import common

    cells = {(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]}
    assert ("rdfgan-nlspn", "train-b16") not in cells
    spec = common.pair_spec("rdfgan-nlspn", "train-b16")
    assert spec.traffic["driver"] == "train" and spec.limits == {}
    assert spec.config["name"] == "rdfgan-nlspn" and spec.chips == 1
