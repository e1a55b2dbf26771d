"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and the
metrics; everything else is a file of its own, found by that name:

* ``configs/<config>.json`` (the ``file`` the configuration's entry names):
  ``link``, the port's configuration as ``dataclasses.asdict`` of its
  ``LinkConfig``; ``reference``, the module under ``reference/`` that
  holds its plain reference; and, optionally, ``frame``, the frame family
  under ``frames/`` (``miso`` without the key), with its fixed arguments in
  ``frame_args``;
* ``frames/<family>.py``: the port's frame function, the round's draws and
  the counters, for the harness (``frames/__init__.py`` lists them);
* ``traffic/<traffic>.json``: the receiver, the frames a round, the rounds
  in flight and the SNR;
* ``limits/<cell>.json``: each number the check compares, with its limit;
* ``metrics/<metric>.py``: the per-layer metric's reader, ``read(view)``.

An end-to-end metric with a ``workloads`` list is reported in those cells
alone; a per-layer metric in the cells it lists, or, without a list, in
every cell that reports the end-to-end metric it ``moves``.

A later cell, configuration or metric is added by adding such files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: object                      # read(view) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    link: dict                        # the port's LinkConfig as a dict, receiver set
    traffic: dict
    limits: dict                      # number -> {"limit": ..., ...}
    reference: object                 # the reference module
    frame: object                     # the frame family's module
    frame_args: dict                  # the family's fixed arguments
    end_to_end: list[dict]
    per_layer: list[Metric]
    readers: dict                     # every per-layer metric's reader, by name

    @property
    def n_iters(self) -> int:
        return self.link["rx"]["max_cnc_iters"]


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = BENCHMARK, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``benchmark``, its files read from under ``root``
    (configuration files from where the benchmark's entry puts them,
    relative to the benchmark's folder)."""
    bench = _read_json(Path(benchmark))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {benchmark} (cells: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = _read_json(Path(benchmark).parent / configs[w["config"]]["file"])
    traffic = _read_json(root / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(root / "limits" / f"{name}.json")
    link = json.loads(json.dumps(cfg_file["link"]))
    link["rx"]["algorithm"] = traffic["receiver"]
    reference = load_module(root / "reference" / f"{cfg_file['reference']}.py",
                            f"portbench_reference_{cfg_file['reference']}")
    family = cfg_file.get("frame", "miso")
    frame = load_module(root / "frames" / f"{family}.py", f"portbench_frame_{family}")
    readers = {m["name"]: load_module(root / "metrics" / f"{m['name']}.py",
                                      "portbench_metric_" + m["name"].replace(".", "_")).read
               for m in bench["per_layer"]}
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [Metric(m["name"], m["unit"], readers[m["name"]])
                 for m in bench["per_layer"] if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=w["chips"], link=link, traffic=traffic, limits=limits,
                reference=reference, frame=frame, frame_args=cfg_file.get("frame_args", {}),
                end_to_end=end_to_end, per_layer=per_layer, readers=readers)
