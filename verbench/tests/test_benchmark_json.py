"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name
in it finds its files."""

import json
import re

import pytest

from verbench.bench import HERE, Cell, arch_of, reader_path
from verbench.flops import PEAK_FLOP_PER_S

from . import tiny

SPEC = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["verbench"]


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_units_and_readers(m):
    assert NAME.match(m["name"])
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert reader_path(m["name"]).is_file()


def test_names_unique_and_allowed():
    for rows in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [r["name"] for r in rows]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_bounds():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("w", SPEC["workloads"],
                         ids=[w["name"] for w in SPEC["workloads"]])
def test_cell_files_and_metrics(w):
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
    assert all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
    assert per and all(m["moves"] in e2e for m in per)
    config = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert (tiny.ROOT / config["file"]).is_file()


@pytest.mark.parametrize("c", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_architecture_resolves(c):
    config = json.loads((tiny.ROOT / c["file"]).read_text())
    assert arch_of(config).dtype in PEAK_FLOP_PER_S


@pytest.mark.parametrize("w", SPEC["workloads"],
                         ids=[w["name"] for w in SPEC["workloads"]])
def test_voxelformer_rooflines_only_in_its_cells(w):
    """The shared ``deform_*_roofline`` readers take the VoxelFormer's
    shapes: building a cell refuses them where its configuration is not
    ``reference/arch.py``'s."""
    assert Cell(tiny.ROOT, w["name"]).arch
