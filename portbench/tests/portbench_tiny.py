"""A small cell of its own for the CPU tests: the benchmark's files with the
``miso_rayleigh`` configuration cut to n_fft 256, 128 subcarriers and 4
antennas, a few frames a round, and the harness's sizes cut to match
(:func:`shrink`)."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "tiny.t"


def shrink(set_attr=setattr, check_frames=16):
    """One warm-up round, a pool of the fewest rounds, ``check_frames``
    frames compared (``set_attr``: ``monkeypatch.setattr`` in a test)."""
    from portbench import run, traffic
    set_attr(run, "WARMUP_ROUNDS", 1)
    set_attr(run, "CHECK_FRAMES", check_frames)
    set_attr(traffic, "POOL_MIN_BYTES", 0)


def make(tmp, *, storage="float32", receiver="cnc", channel="rayleigh", frames=4,
         n_ant=4, n_fft=256, limits_of="miso_rayleigh.mcnc.b512", snr_db=15.0):
    """Write the cell ``tiny.t`` under ``tmp``, with the limits and the
    metrics of the cell ``limits_of``; returns ``(BENCHMARK.json, root)``."""
    tmp = Path(tmp)
    for d in ("metrics", "reference"):
        if not (tmp / d).exists():
            shutil.copytree(ROOT / d, tmp / d)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir(exist_ok=True, parents=True)
    cfg = json.loads((ROOT / "configs" / "miso_rayleigh.json").read_text())
    link = cfg["link"]
    link["modem"].update(n_fft=n_fft, n_sub_carr=n_fft // 2)
    link["array"]["n_elements"] = n_ant
    link["channel"]["model"] = channel
    link["mxu_fft_storage"] = link["channel_storage"] = storage
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / "t.json").write_text(json.dumps({
        "receiver": receiver, "frames_per_round": frames, "rounds_in_flight": 3,
        "snr_db": snr_db}))
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "x", "file": "configs/tiny.json",
                         "reduced": [], "why": "x"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "t", "chips": 1,
                           "why": "x"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if limits_of in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(ROOT / "limits" / f"{limits_of}.json", tmp / "limits" / f"{CELL}.json")
    return tmp / "BENCHMARK.json", tmp
