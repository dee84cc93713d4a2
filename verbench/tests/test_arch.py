"""A configuration names its architecture module (``"arch"``), and a cell
is built on that module's ``Arch`` with no edit to the harness."""

import json
import sys
import types

import pytest

from verbench import bench, readers
from verbench.compare import control_precision
from verbench.driver import Driver
from verbench.flops import PEAK_FLOP_PER_S
from verbench.reference.arch import Arch

from . import tiny

SPEC = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())


def _config(workload, spec=SPEC):
    w = next(w for w in spec["workloads"] if w["name"] == workload)
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    return entry, json.loads((tiny.ROOT / entry["file"]).read_text())


def _voxelformer_cells(spec):
    """The cells whose configuration ``reference/arch.py`` reads: no
    ``"arch"`` key, or ``"arch": "arch"``."""
    return [w["name"] for w in spec["workloads"]
            if _config(w["name"], spec)[1].get("arch", "arch") == "arch"]


CELLS = _voxelformer_cells(SPEC)


def _root(tmp_path, workload, config, voxelformer_readers=False):
    """A checkout's root whose ``BENCHMARK.json`` points the cell's
    configuration at ``config``, written under ``tmp_path``."""
    entry, _ = _config(workload)
    spec = json.loads(json.dumps(SPEC))
    for c in spec["configs"]:
        if c["name"] == entry["name"]:
            c["file"] = "config.json"
    if not voxelformer_readers:
        spec["per_layer"] = [
            m for m in spec["per_layer"] if bench.reader_path(
                m["name"]).stem not in bench.VOXELFORMER_READERS]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "config.json").write_text(json.dumps(config))
    return tmp_path


@pytest.fixture
def other_arch(monkeypatch):
    """An architecture module ``verbench.reference.<name>`` that exists
    only in ``sys.modules``, with four feature levels, which
    ``reference/arch.py`` refuses."""
    name = "four_level_test_arch"
    mod = types.ModuleType(f"verbench.reference.{name}")

    class FourLevel:
        def __init__(self, spec):
            self.dtype = spec["model"]["dtype"]
            self.num_levels = int(spec["model"]["num_levels"])
    mod.Arch = FourLevel
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    _, config = _config("ver36-full-b8")
    config["arch"] = name
    config["model"]["num_levels"] = 4
    return FourLevel, config


@pytest.mark.parametrize("workload", CELLS)
def test_cells_read_by_reference_arch(workload):
    _, config = _config(workload)
    arch = bench.Cell(tiny.ROOT, workload).arch
    assert type(arch) is Arch
    assert vars(arch) == vars(Arch(config))


@pytest.mark.parametrize("workload", CELLS)
def test_arch_key_naming_arch_is_no_key(workload, tmp_path):
    _, config = _config(workload)
    arch = bench.Cell(_root(tmp_path, workload, dict(config, arch="arch"),
                            voxelformer_readers=True), workload).arch
    assert type(arch) is Arch and arch.spec.pop("arch") == "arch"
    assert vars(arch) == vars(bench.Cell(tiny.ROOT, workload).arch)


def test_a_cell_of_another_arch_leaves_the_voxelformer_cells(other_arch,
                                                            tmp_path):
    """A spec that holds a cell of another architecture beside these
    selects the same cells for the two tests above."""
    _, config = other_arch
    (tmp_path / "other.json").write_text(json.dumps(config))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="other",
                                file=str(tmp_path / "other.json")))
    spec["workloads"].append(dict(spec["workloads"][0], name="other-b1",
                                  config="other"))
    assert CELLS and _voxelformer_cells(spec) == CELLS


def test_cell_of_another_arch(other_arch, tmp_path):
    cls, config = other_arch
    with pytest.raises(ValueError, match="one feature level"):
        Arch(config)
    cell = bench.Cell(_root(tmp_path, "ver36-full-b8", config),
                      "ver36-full-b8")
    assert type(cell.arch) is cls and cell.arch.num_levels == 4
    assert Driver(cell, 3, "cpu").arch is cell.arch
    assert control_precision(cell.arch.dtype)
    run = types.SimpleNamespace(units=12, window_s=3.0, arch=cell.arch)
    assert readers.mfu(run, 2e12) == pytest.approx(
        100.0 * 2e12 * 12 / 3.0 / PEAK_FLOP_PER_S[config["model"]["dtype"]])


def test_another_arch_may_not_list_voxelformer_rooflines(other_arch,
                                                         tmp_path):
    _, config = other_arch
    root = _root(tmp_path, "ver36-full-b8", config, voxelformer_readers=True)
    with pytest.raises(ValueError, match="deform_fwd_roofline.full"):
        bench.Cell(root, "ver36-full-b8")


@pytest.mark.parametrize("name, error, says", [
    ("no_such_arch", FileNotFoundError, "reference/no_such_arch.py"),
    ("../bench", ValueError, "not the name of a module")])
def test_unknown_arch_fails_when_the_cell_is_built(name, error, says,
                                                   tmp_path):
    _, config = _config("ver36-full-b8")
    root = _root(tmp_path, "ver36-full-b8", dict(config, arch=name))
    with pytest.raises(error, match=says):
        bench.Cell(root, "ver36-full-b8")


def test_arch_of_holds_to_the_contract(monkeypatch):
    mod = types.ModuleType("verbench.reference.contract_test_arch")

    class NoPeak:
        def __init__(self, spec):
            self.dtype = "int3"
    mod.Arch = NoPeak
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    with pytest.raises(ValueError, match="dtype 'int3'"):
        bench.arch_of({"arch": "contract_test_arch", "model": {}})
