"""Cells, configurations, traffic mixes and per-layer metrics are found by
name: a new one is added by adding files, and no file changes."""

import json
import shutil
from pathlib import Path

import pytest

from portbench import spec, trace

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def test_every_cell_of_the_benchmark_loads():
    """Each cell's per-layer metrics move an end-to-end metric the cell
    reports, its frames/s among them."""
    bench = json.loads(BENCHMARK.read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.link["rx"]["algorithm"] == cell.traffic["receiver"]
        assert cell.n_iters == 8
        e2e = [m["name"] for m in cell.end_to_end]
        assert e2e in (["frames_per_s", "setup_s"], ["frames_per_s.host_paced", "setup_s"])
        assert cell.per_layer and {m.name for m in cell.per_layer} <= set(cell.readers)
        moves = {m["name"]: m["moves"] for m in bench["per_layer"]}
        moved = {moves[m.name] for m in cell.per_layer}
        assert moved <= set(e2e) and e2e[0] in moved, w["name"]
        assert cell.limits, w["name"]


def test_a_configuration_without_a_frame_family_runs_the_single_user_frame():
    """The benchmark's configurations name no ``frame``: ``frames/miso.py``,
    with no arguments."""
    bench = json.loads(BENCHMARK.read_text())
    for w in bench["workloads"]:
        cfg = json.loads((ROOT.parent / next(
            c["file"] for c in bench["configs"] if c["name"] == w["config"])).read_text())
        assert "frame" not in cfg and "frame_args" not in cfg
        cell = spec.load_cell(w["name"])
        assert cell.frame.__file__ == str(ROOT / "frames" / "miso.py")
        assert cell.frame_args == {}


def test_each_per_layer_metric_has_its_twin_for_the_host_paced_cells():
    """Every ``X.host_paced`` reading has its ``X``, of the same layer and
    unit, the one moving ``frames_per_s.host_paced`` and the other
    ``frames_per_s``."""
    per_layer = {m["name"]: m for m in json.loads(BENCHMARK.read_text())["per_layer"]}
    twins = [n for n in per_layer if n.endswith(".host_paced")]
    assert twins
    for n in twins:
        base = per_layer[n[:-len(".host_paced")]]
        twin = per_layer[n]
        assert base["moves"] == "frames_per_s"
        assert twin["moves"] == "frames_per_s.host_paced"
        assert twin["layer"] == base["layer"] and twin["unit"] == base["unit"]
    view = trace.TraceView(window=(0.0, 10.0), rounds=2,
                           device_ops=[(1.0, 4.0, "k", "kernel"), (3.0, 5.0, "k", "kernel")])
    cell = spec.load_cell("miso_los.cnc.b32")
    view.readers = cell.readers
    for m in cell.per_layer:
        if m.name in twins:
            assert m.read(view) == cell.readers[m.name[:-len(".host_paced")]](view)


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    """A folder of its own with one new configuration, traffic mix, cell,
    limits file and metric; the harness's files are untouched."""
    for d in ("metrics", "reference", "frames"):
        shutil.copytree(ROOT / d, tmp_path / d)
    for d in ("configs", "traffic", "limits"):
        (tmp_path / d).mkdir()
    cfg = json.loads((ROOT / "configs" / "miso_los.json").read_text())
    cfg["link"]["array"]["n_elements"] = 32
    (tmp_path / "configs" / "miso_los32.json").write_text(json.dumps(cfg))
    tr = json.loads((ROOT / "traffic" / "cnc.b32.json").read_text())
    tr.update(receiver="mcnc", frames_per_round=8)
    (tmp_path / "traffic" / "mcnc.b8.json").write_text(json.dumps(tr))
    shutil.copy(ROOT / "traffic" / "cnc.b32.json", tmp_path / "traffic" / "cnc.b32.json")
    shutil.copy(ROOT / "limits" / "miso_los.cnc.b32.json",
                tmp_path / "limits" / "miso_los32.cnc.b32.json")
    (tmp_path / "limits" / "miso_los32.mcnc.b8.json").write_text(
        json.dumps({"gap_sq_mean": {"limit": 1.0}}))
    (tmp_path / "metrics" / "round.kernels_seen.py").write_text(
        "def read(view):\n    return float(len(view.kernels)) if view.kernels else None\n")
    bench = json.loads(BENCHMARK.read_text())
    frames = next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")
    frames["workloads"] += ["miso_los32.mcnc.b8", "miso_los32.cnc.b32"]
    bench["configs"].append({"name": "miso_los32", "source": "x", "why": "x", "reduced": [],
                             "file": "configs/miso_los32.json"})
    bench["workloads"] += [{"name": "miso_los32.mcnc.b8", "config": "miso_los32",
                            "traffic": "mcnc.b8", "chips": 1, "why": "x"},
                           {"name": "miso_los32.cnc.b32", "config": "miso_los32",
                            "traffic": "cnc.b32", "chips": 1, "why": "x"}]
    bench["per_layer"].append({"name": "round.kernels_seen", "unit": "launches",
                               "better": "lower", "source": "device_trace", "layer": "Round",
                               "moves": "frames_per_s", "workloads": ["miso_los32.mcnc.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("miso_los32.mcnc.b8", tmp_path / "BENCHMARK.json", tmp_path)
    assert cell.link["array"]["n_elements"] == 32
    assert cell.link["rx"]["algorithm"] == "mcnc"
    assert cell.traffic["frames_per_round"] == 8
    assert cell.limits == {"gap_sq_mean": {"limit": 1.0}}
    assert cell.reference.__file__ == str(tmp_path / "reference" / "miso.py")
    assert cell.frame.__file__ == str(tmp_path / "frames" / "miso.py")
    names = [m.name for m in cell.per_layer]
    assert "round.kernels_seen" in names and "device.idle_share" in names
    assert "kernel.fused_pa_roofline" not in names      # listed for the benchmark's cells
    assert "device.idle_share.host_paced" not in names  # moves a metric the cell lacks
    view = trace.TraceView(window=(0.0, 10.0), rounds=1,
                           device_ops=[(1.0, 2.0, "k", "kernel"), (3.0, 4.0, "k", "kernel")])
    reader = next(m for m in cell.per_layer if m.name == "round.kernels_seen")
    assert reader.read(view) == 2.0
    # a metric restricted to other cells is not reported here
    other = spec.load_cell("miso_los32.cnc.b32", tmp_path / "BENCHMARK.json", tmp_path)
    assert "round.kernels_seen" not in [m.name for m in other.per_layer]


def test_an_unknown_cell_names_the_cells_there_are():
    with pytest.raises(KeyError, match="miso_rayleigh.mcnc.b512"):
        spec.load_cell("no.such.cell")
