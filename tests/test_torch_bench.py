"""The port's bench, ``mimo_ofdm_tpu_torch/bench.py``, against the root
``bench.py``: the workload of both arms, the pipelined and interleaved
windows, the output line, the env knobs and the CPU baseline's cache, on
the CPU at a small shape (n_fft 256, 8 antennas, batch 2). The root
``bench.py`` imports JAX inside ``main``, so it is read with ``ast`` and
never imported; the JAX side of the workload comes from
``mimo_ofdm_tpu.utils.config`` alone, and no JAX frame is compiled."""

import ast
import dataclasses
import io
import statistics
import time
from pathlib import Path

import pytest
import torch

from mimo_ofdm_tpu.utils import config as jax_config
from mimo_ofdm_tpu_torch import bench
from mimo_ofdm_tpu_torch.utils import config

ROOT = Path(__file__).resolve().parents[1]
BENCH_PY = ast.parse((ROOT / "bench.py").read_text())
ROOT_BASELINE = ROOT / "BASELINE_CPU.json"


def _bench_py_keys() -> tuple[set, set]:
    """The keys of bench.py's output dict literal, and those it adds after
    it (``out[...] = ...``, the MCNC arm's)."""
    base, added = set(), set()
    for node in ast.walk(BENCH_PY):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            base |= {k.value for k in node.keys}
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "out"):
            added.add(node.targets[0].slice.value)
    return base, added


def _bench_py_constants() -> dict:
    """bench.py's ``n_iters``, SNR, env knobs with their defaults, and each
    arm's round-index offset, read from its source."""
    out = {"knobs": {}, "offsets": {}}
    for node in ast.walk(BENCH_PY):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name, v = node.targets[0].id, node.value
            if name == "n_iters":
                out["n_iters"] = v.value
            if name == "snr":
                out["snr"] = v.args[0].value
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and ast.unparse(node.func.value) == "os.environ"):
            out["knobs"][node.args[0].value] = (node.args[1].value if len(node.args) > 1
                                                else None)
        if (isinstance(node, ast.Tuple) and isinstance(node.elts[0], ast.Constant)
                and node.elts[0].value in ("cnc", "mcnc")):
            out["offsets"][node.elts[0].value] = node.elts[-1].value
    return out


def _small_cfg():
    return bench.workload().replace(modem=config.ModemConfig(n_fft=256, n_sub_carr=128),
                                    array=config.ArrayConfig(n_elements=8))


@pytest.fixture
def stub_baseline(monkeypatch):
    """The CPU baseline's measurement replaced by a counting stub."""
    calls = []

    def measure(cfg, n_iters):
        calls.append((cfg, n_iters))
        return 4.0
    monkeypatch.setattr(bench.baseline_cpu, "measure_baseline_frames_per_s", measure)
    return calls


@pytest.mark.parametrize("arm", ["cnc", "mcnc"])
def test_workload_is_bench_py_s(arm):
    """Each arm's configuration equals bench.py's (``bench.py:77-78,
    106-114``), field by field."""
    want, _ = jax_config.canonical_miso_cnc()
    want = want.replace(channel=jax_config.ChannelConfig(model="rayleigh"))
    if arm == "mcnc":
        want = want.replace(rx=jax_config.RxConfig(algorithm="mcnc"))
    want = dataclasses.asdict(want)
    got = dataclasses.asdict(bench.arm_config(bench.workload(), arm))
    assert got.keys() == want.keys()
    for field in want:
        assert got[field] == want[field], field
    consts = _bench_py_constants()
    assert (bench.N_ITERS, bench.SNR_DB) == (consts["n_iters"], consts["snr"])
    assert bench.ARM_OFFSETS == consts["offsets"]


def test_knobs_are_bench_py_s():
    """The same env knobs by the same names; every default but the batches
    (measured on the card) is bench.py's."""
    knobs = _bench_py_constants()["knobs"]
    assert set(knobs) == {"BENCH_BATCH", "BENCH_MCNC_BATCH", "BENCH_PIPELINE_DEPTH",
                          "BENCH_WINDOWS", "BENCH_WINDOW_S", "BENCH_SKIP_MCNC"}
    got = bench.settings({})
    assert got == {"batch": bench.DEFAULT_BATCH["cnc"],
                   "mcnc_batch": bench.DEFAULT_BATCH["mcnc"],
                   "depth": int(knobs["BENCH_PIPELINE_DEPTH"]),
                   "n_windows": int(knobs["BENCH_WINDOWS"]),
                   "window_s": float(knobs["BENCH_WINDOW_S"])}
    env = {"BENCH_BATCH": "3", "BENCH_MCNC_BATCH": "5", "BENCH_PIPELINE_DEPTH": "2",
           "BENCH_WINDOWS": "4", "BENCH_WINDOW_S": "0.5"}
    assert bench.settings(env) == {"batch": 3, "mcnc_batch": 5, "depth": 2,
                                   "n_windows": 4, "window_s": 0.5}
    assert bench.settings({**env, "BENCH_SKIP_MCNC": "1"})["mcnc_batch"] is None


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_measure_window_pipelines_in_order(depth):
    """At most ``depth`` rounds in flight, consumed in the order issued,
    indices from the offset on, frames = rounds x batch."""
    issued, consumed = [], []

    def round_fn(key, idx, snr):
        assert (key, snr) == (0, 15.0)
        assert len(issued) - len(consumed) < depth
        time.sleep(0.001)
        issued.append(idx)
        return idx

    t0 = time.perf_counter()
    fps, n = bench._measure_window(round_fn, consumed.append, 0, 15.0, 4, 0.02, depth,
                                   fold_offset=500)
    elapsed = time.perf_counter() - t0
    assert issued == consumed == list(range(500, 500 + n))
    assert n >= depth
    assert n * 4 / elapsed <= fps <= n * 4 / 0.02


def _fake_arm(calls: list, name: str):
    def round_fn(key, idx, snr):
        calls.append((name, idx))
        return torch.arange(bench.N_ITERS + 2, dtype=torch.int32)
    return round_fn


def test_interleaved_windows_never_repeat_an_index():
    """Arms take turns window by window; window w of an arm starts at
    ``offset + 100 w`` or right after the arm's previous window, whichever
    is later, so no round index repeats across windows or arms; the
    tallies count every round with its counters."""
    calls, tallies = [], {}
    arms = [(name, _fake_arm(calls, name), 2, off, 3)
            for name, off in bench.ARM_OFFSETS.items()]
    windows = bench.interleaved(arms, 3, 0.02, tallies)
    assert [len(w) for w in windows.values()] == [3, 3]
    assert all(f > 0 for w in windows.values() for f in w)
    warm = 5 * len(arms)
    assert calls[:warm] == [(name, i) for name, off in bench.ARM_OFFSETS.items()
                            for i in (0, off + 1000, off + 1001, off + 1002, off + 1003)]
    timed = calls[warm:]
    assert len(set(idx for _, idx in timed)) == len(timed)
    runs = []                                  # (arm, [indices]) per window
    for name, idx in timed:
        if not runs or runs[-1][0] != name:
            runs.append((name, []))
        runs[-1][1].append(idx)
    assert [name for name, _ in runs] == ["cnc", "mcnc"] * 3
    end = dict(bench.ARM_OFFSETS)
    for w, (name, idx) in enumerate(runs):
        start = max(bench.ARM_OFFSETS[name] + 100 * (w // 2), end[name])
        assert idx == list(range(start, start + len(idx)))
        end[name] = start + len(idx)
    counts = list(range(bench.N_ITERS + 2))
    for name in bench.ARM_OFFSETS:
        n = sum(1 for c in calls if c[0] == name)
        assert tallies[name] == {"rounds": n, "counters": [n * c for c in counts]}


def test_interleaved_raises_when_an_arm_runs_into_the_next():
    calls = []
    arms = [("a", _fake_arm(calls, "a"), 2, 10_000, 2),
            ("b", _fake_arm(calls, "b"), 2, 10_005, 2)]
    with pytest.raises(RuntimeError, match="past the next arm's offset"):
        bench.interleaved(arms, 1, 0.01)


@pytest.mark.parametrize("skip_mcnc", [False, True])
def test_run_on_the_cpu(stub_baseline, tmp_path, skip_mcnc):
    """The bench at a small shape on the CPU: bench.py's keys plus
    ``device``, positive windows, medians as the values;
    ``BENCH_SKIP_MCNC`` drops the MCNC arm's two keys."""
    env = {"BENCH_BATCH": "2", "BENCH_MCNC_BATCH": "2", "BENCH_WINDOWS": "2",
           "BENCH_WINDOW_S": "0.05"}
    if skip_mcnc:
        env["BENCH_SKIP_MCNC"] = "1"
    tallies = {}
    out = bench.run(_small_cfg(), **bench.settings(env), device="cpu",
                    baseline_path=tmp_path / "baseline.json", tallies=tallies)
    base, mcnc_keys = _bench_py_keys()
    assert mcnc_keys == {"mcnc_frames_per_s", "mcnc_windows"}
    assert set(out) == base | ({"device"} if skip_mcnc else mcnc_keys | {"device"})
    assert out["metric"] == "canonical_miso_cnc_frames_per_s"
    assert out["unit"] == "frames/s"
    assert out["device"].startswith("cpu: ")
    assert len(out["windows"]) == 2 and all(w > 0 for w in out["windows"])
    assert out["value"] == round(statistics.median(out["windows"]), 2)
    assert out["vs_baseline"] == pytest.approx(out["value"] / 4.0, abs=0.01)
    assert set(tallies) == ({"cnc"} if skip_mcnc else {"cnc", "mcnc"})
    if not skip_mcnc:
        assert len(out["mcnc_windows"]) == 2 and all(w > 0 for w in out["mcnc_windows"])
    for t in tallies.values():
        clean, *iters = t["counters"]
        n_bits = t["rounds"] * 2 * _small_cfg().modem.n_bits_per_ofdm_sym
        assert t["rounds"] >= 5 + 2 * 2 and 0 <= clean < iters[0] < 0.5 * n_bits
    assert len(stub_baseline) == 1


def test_baseline_is_cached_by_config_and_cpu(stub_baseline, tmp_path, monkeypatch):
    """The second call reads the cache back; another CPU model or another
    configuration measures again; the root BASELINE_CPU.json (a TPU host's
    number) is never read or written."""
    root_before = (ROOT_BASELINE.read_bytes(), ROOT_BASELINE.stat().st_mtime_ns)
    path = tmp_path / "_build" / "baseline_cpu.json"
    cfg = bench.workload()
    assert bench.baseline_frames_per_s(cfg, 8, path) == 4.0
    assert bench.baseline_frames_per_s(cfg, 8, path) == 4.0
    assert len(stub_baseline) == 1 and path.exists()
    bench.baseline_frames_per_s(_small_cfg(), 8, path)
    assert len(stub_baseline) == 2
    monkeypatch.setattr(bench, "cpu_model", lambda: "another CPU")
    bench.baseline_frames_per_s(cfg, 8, path)
    assert len(stub_baseline) == 3
    assert (ROOT_BASELINE.read_bytes(), ROOT_BASELINE.stat().st_mtime_ns) == root_before
    assert bench.BASELINE_CACHE == Path(bench.__file__).resolve().parent / "_build" / \
        "baseline_cpu.json"


def test_default_device_raises_without_a_card(monkeypatch, stub_baseline):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(_small_cfg(), 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.batch_table()
    assert not stub_baseline


@pytest.mark.parametrize("model_name,want", [
    ("Intel(R) Xeon(R) Platinum 8480C", "Intel(R) Xeon(R) Platinum 8480C"),
    ("unknown", "GenuineIntel family 6 model 143 stepping 8")])
def test_cpu_model_names_the_cpu(monkeypatch, model_name, want):
    """The baseline's cache key: /proc/cpuinfo's model name, or the first
    processor's vendor, family, model and stepping where it says
    ``unknown`` (as some virtual machines report)."""
    text = (f"processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\nmodel\t\t: 143\n"
            f"model name\t: {model_name}\nstepping\t: 8\n\nprocessor\t: 1\n"
            f"model name\t: another\n")
    monkeypatch.setattr(bench, "open", lambda *a, **k: io.StringIO(text), raising=False)
    assert bench.cpu_model() == want
