"""The per-layer readers on a small synthetic Chrome trace."""

import json
from pathlib import Path

import pytest

from portbench import spec, trace

ROOT = Path(__file__).resolve().parents[1]
FUSED = "void fused_ifft_pa_fft_tc_kernel<IoPlanes<__nv_bfloat16>, 12, 1>(...)"


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0,
            "args": args}


def synthetic_trace():
    """A 100 us window with two rounds: a fused kernel 10-30 overlapping an
    elementwise kernel 20-40 (union 30 us, sum 40 us), a copy 60-70, a
    fused kernel 80-90; the host launches at 0-2 and 6-8 and waits 50-100."""
    return {"traceEvents": [
        _x("cudaLaunchKernel", "cuda_runtime", 0, 2, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 6, 2),
        _x("cudaEventSynchronize", "cuda_runtime", 50, 50),
        _x(FUSED, "kernel", 10, 20, correlation=1),
        _x("void at::native::elementwise_kernel<128, 2>(...)", "kernel", 20, 20),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 60, 10),
        _x(FUSED, "kernel", 80, 10),
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
    ]}


@pytest.fixture(scope="module")
def view():
    link = json.loads((ROOT / "configs" / "miso_rayleigh.json").read_text())["link"]
    tr = json.loads((ROOT / "traffic" / "mcnc.b512.json").read_text())
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    readers = {m["name"]: spec.load_module(ROOT / "metrics" / f"{m['name']}.py",
                                           "t_" + m["name"].replace(".", "_")).read
               for m in bench["per_layer"]}
    return trace.TraceView.from_trace(synthetic_trace(), rounds=2, host_frame_s=0.004,
                                      link=link, traffic=tr, readers=readers)


def test_union_not_sum_decides_busy_and_idle(view):
    assert view.window == (0.0, 100.0)
    assert view.busy_us() == pytest.approx(30 + 10 + 10)       # union, not 20 + 20 + 10 + 10
    assert view.read("device.idle_share") == pytest.approx(0.5)


def test_launches_and_device_ms(view):
    assert view.read("round.launches_per_round") == pytest.approx(3 / 2)
    assert view.read("kernel.fused_pa_ms_per_round") == pytest.approx(30e-3 / 2)
    assert view.read("frame.other_device_ms_per_round") == pytest.approx(20e-3 / 2)
    assert view.read("round.host_ms_per_round") == pytest.approx(2.0)


def test_roofline_is_the_least_time_over_the_kernel_time(view):
    # 512 x 640 rows of [2048] bf16 points: 1.6034 ms least, against 0.015 ms
    assert view.read("kernel.fused_pa_roofline") == pytest.approx(100 * 1.60338 / 0.015,
                                                                  rel=1e-4)


def test_readers_without_their_work_return_nothing(view):
    empty = trace.TraceView(window=(0.0, 10.0), rounds=3, device_ops=[], readers=view.readers,
                            link=view.link, traffic=view.traffic)
    for name in view.readers:
        assert empty.read(name) is None, name


def test_breakdown_names_device_ops_and_idle_time_by_host_activity(view):
    b = view.breakdown()
    assert b["device_ops"][0] == [FUSED[:160], pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # idle 0-10 (host between launches), 40-60, 70-80 and 90-100 (waiting)
    assert gaps[trace.BETWEEN_CALLS] == pytest.approx(10e-6)
    assert gaps["cudaEventSynchronize"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)


def test_trace_files_load_plain_and_gzipped(tmp_path):
    import gzip
    plain, packed = tmp_path / "t.json", tmp_path / "t.json.gz"
    plain.write_text(json.dumps(synthetic_trace()))
    with gzip.open(packed, "wt") as f:
        json.dump(synthetic_trace(), f)
    assert trace.load(plain) == trace.load(packed) == synthetic_trace()
