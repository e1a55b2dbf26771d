"""The readers of the program's spans (``stages.py``) on a synthetic Chrome
trace plus spans, and once through a traced run of the harness on the CPU."""

import json
from pathlib import Path

import pytest

import portbench_tiny
from portbench import run, spec, stages, trace

ROOT = Path(__file__).resolve().parents[1]
FUSED = "void fused_ifft_pa_fft_tc_kernel<IoPlanes<__nv_bfloat16>, 12, 1>(...)"
NEW = ("frame.tx_eager_ms_per_round", "frame.precoder_ms_per_round",
       "frame.receiver_ms_per_round", "device.idle_in_frame_share")


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0,
            "args": args}


def synthetic_trace():
    """A 100 us window of two rounds. Launch (host us) -> device work (us):
    round 0: 2 -> 10-20, 7 -> 20-24, 9 -> the fused kernel 24-34, 11 -> 34-37,
    15 -> 37-39, 31 -> 39-40; the harness's cat: 47 -> 47-48; round 1:
    52 -> 60-70, 56 -> 70-75; the counters' copy: 96 -> 96-100. Busy 50 us;
    idle 0-10, 40-47, 48-60, 75-96."""
    ev = [_x("cudaGetDevice", "cuda_runtime", 0, 1)]
    for corr, (launch, start, dur, name) in enumerate([
            (2, 10, 10, "k"), (7, 20, 4, "k"), (9, 24, 10, FUSED), (11, 34, 3, "k"),
            (15, 37, 2, "k"), (31, 39, 1, "k"), (47, 47, 1, "cat"), (52, 60, 10, "k"),
            (56, 70, 5, "k")], start=1):
        ev += [_x("cudaLaunchKernel", "cuda_runtime", launch, 0.5, correlation=corr),
               _x(name, "kernel", start, dur, correlation=corr)]
    ev += [_x("cudaMemcpyAsync", "cuda_runtime", 96, 0.5, correlation=10),
           _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 96, 4, correlation=10),
           _x("cudaEventSynchronize", "cuda_runtime", 75, 20)]
    return {"traceEvents": ev, "baseTimeNanoseconds": 1_000_000}


def synthetic_spans():
    """``(start, end, name, parent, round, counts)`` in the order they
    began: set-up and a warm-up frame before the window, then two rounds."""
    return [(-5000, -4000, "setup.frame_fn", -1, -1, {}),
            (-3000, -1000, "frame", -1, 0, {"frames": 4}),
            (1, 45, "frame", -1, 1, {"frames": 4}),
            (1, 4, "frame.precoder", 2, 1, {}),
            (6, 8, "tx.precode", 2, 1, {}),
            (8, 10, "chain", 2, 1, {"rows": 32}),
            (10, 12, "tx.combine", 2, 1, {}),
            (13, 40, "rx.pass", 2, 1, {"index": 0}),
            (14, 16, "rx.detect", 7, 1, {}),
            (16, 30, "rx.replica", 7, 1, {}),
            (30, 32, "rx.update", 7, 1, {}),
            (50, 80, "frame", -1, 2, {"frames": 4}),
            (51, 53, "frame.precoder", 11, 2, {}),
            (55, 57, "tx.combine", 11, 2, {})]


def _readers():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    return {m["name"]: spec.load_module(ROOT / "metrics" / f"{m['name']}.py",
                                        "s_" + m["name"].replace(".", "_")).read
            for m in bench["per_layer"]}


def _view(readers):
    link = json.loads((ROOT / "configs" / "miso_rayleigh.json").read_text())["link"]
    tr = json.loads((ROOT / "traffic" / "mcnc.b512.json").read_text())
    return trace.TraceView.from_trace(synthetic_trace(), rounds=2, host_frame_s=0.004,
                                      link=link, traffic=tr, readers=readers)


@pytest.fixture
def views():
    """The same trace twice: without spans, and with them."""
    readers = _readers()
    plain, spanned = _view(readers), _view(readers)
    stages.attach(spanned, synthetic_trace(), synthetic_spans())
    return plain, spanned


def test_each_new_reader(views):
    _, view = views
    assert view.read("frame.tx_eager_ms_per_round") == pytest.approx((4 + 3 + 5) / 1e3 / 2)
    assert view.read("frame.precoder_ms_per_round") == pytest.approx((10 + 10) / 1e3 / 2)
    assert view.read("frame.receiver_ms_per_round") == pytest.approx((2 + 1) / 1e3 / 2)
    # idle 0-10, 40-47, 48-60, 75-96 within the frames 1-45 and 50-80
    assert view.read("device.idle_in_frame_share") == pytest.approx((9 + 5 + 10 + 5) / 100)
    assert view.read("setup.program_s") == pytest.approx((1000 + 2000) / 1e6)
    for name in NEW:
        assert view.read(name + ".host_paced") == view.read(name)


def test_stages_and_the_unspanned_rest_sum_to_all_device_time(views):
    _, view = views
    st = stages.of(view)
    assert st.rounds == view.rounds == 2
    assert dict(st.device_us) == pytest.approx({
        "frame.precoder": 20, "tx.precode": 4, "chain": 10, "tx.combine": 8,
        "rx.detect": 2, "rx.update": 1, stages.UNSPANNED: 5})
    assert sum(st.device_us.values()) == pytest.approx(sum(e - s for s, e, *_ in view.device_ops))
    assert st.idle_by_span() == pytest.approx({"frame": 29e-6, stages.OUTSIDE_FRAME: 21e-6})


def test_spans_change_neither_the_window_nor_the_existing_readings(views):
    plain, view = views
    assert view.window == plain.window == (0.0, 100.0)      # set-up spans begin at -5000
    old = [n for n in view.readers if not n.startswith(NEW) and n != "setup.program_s"]
    assert len(old) == 12
    for name in old:
        assert view.read(name) == plain.read(name), name
    assert view.breakdown() == plain.breakdown()
    for name in (*NEW, "setup.program_s"):
        assert plain.read(name) is None, name


def test_a_stage_that_never_began_in_the_window_reads_nothing(views):
    _, view = views
    st = stages.of(view)
    assert st.device_ms_per_round(("decode",)) is None
    assert st.device_ms_per_round(("rx.detect",)) == pytest.approx(1e-3)


def test_innermost_takes_the_deepest_span_and_nothing_outside():
    sp = [(0, 10, "a"), (2, 8, "b"), (3, 4, "c"), (12, 20, "d")]
    assert stages.innermost(sp, [5, 3.5, 1, 11, 20, 25, 2, -1]) == [1, 2, 0, -1, 3, -1, 1, -1]


def test_only_a_traced_run_of_the_harness_turns_the_recorder_on():
    harness = str(ROOT / "run.py")
    assert stages.traced_cell([harness, "--workload", "a.b", "--seed", "1", "--seconds",
                               "10", "--trace", "1"]) == "a.b"
    assert stages.traced_cell([harness, "--workload", "a.b", "--trace", "0"]) is None
    assert stages.traced_cell([harness, "--workload", "a.b"]) is None
    assert stages.traced_cell(["pytest", "--workload", "a.b", "--trace", "1"]) is None
    assert stages.traced_cell([]) is None


def test_a_traced_run_on_the_cpu_reads_its_spans(tmp_path, monkeypatch):
    """Through the harness: the set-up spans end before the window, and the
    program's frame spans in it are the rounds the harness launched (the
    CPU trace has no device work, so the device readers read nothing)."""
    seen = []
    real_of = stages.of

    def spy(view):
        st = real_of(view)
        seen.append((view, st))
        return st

    monkeypatch.setattr(stages, "of", spy)
    portbench_tiny.shrink(monkeypatch.setattr)
    bench, root = portbench_tiny.make(tmp_path, receiver="mcnc", frames=2)
    assert stages.enable(portbench_tiny.CELL)
    try:
        res = run.run(portbench_tiny.CELL, 20261018, 0.5, True, device="cpu",
                      benchmark=bench, root=root)
    finally:
        stages.disable()
    assert res["attempted"] > 0
    view, st = seen[0]
    assert st is not None and st.rounds == view.rounds > 0
    assert 0 < res["metrics"]["setup.program_s"]["value"] < 60
    assert "frame.tx_eager_ms_per_round" not in res["metrics"]
    names = {sp[2] for sp in st.spans}
    assert {"setup.frame_fn", "frame", "tx.precode", "chain", "rx.pass"} <= names
