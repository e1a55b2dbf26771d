"""The two-user cell ``mu_two_user.mcnc_mu.b128`` as the benchmark finds it:
its configuration, family and reference by name, the per-layer metrics each
cell resolves (the three earlier cells' unchanged), and the reader of the
MCNC-MU replica's spans, ``frame.mu_replica_ms_per_round``, on a synthetic
trace."""

import json
from pathlib import Path

import pytest

from portbench import roofline, spec, stages, trace

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = ROOT.parent / "BENCHMARK.json"
CELL = "mu_two_user.mcnc_mu.b128"
STAGE_METRICS = ["device.idle_in_frame_share", "device.idle_share",
                 "frame.other_device_ms_per_round", "frame.precoder_ms_per_round",
                 "frame.receiver_ms_per_round", "frame.tx_eager_ms_per_round",
                 "kernel.fused_pa_ms_per_round", "kernel.fused_pa_roofline",
                 "round.host_ms_per_round", "round.launches_per_round"]
HOST_PACED = sorted([m + ".host_paced" for m in STAGE_METRICS] + ["setup.program_s"])
# the per-layer metrics each cell resolved before the two-user cell was added
RESOLVED_BEFORE = {
    "miso_rayleigh.mcnc.b512": sorted(STAGE_METRICS + ["setup.program_s"]),
    "miso_los.cnc.b32": HOST_PACED,
    "miso_rayleigh.cnc.b512": HOST_PACED,
}


def _resolved(cell: str) -> list[str]:
    return sorted(m.name for m in spec.load_cell(cell).per_layer)


@pytest.mark.parametrize("cell", sorted(RESOLVED_BEFORE))
def test_the_earlier_cells_resolve_the_same_metrics(cell):
    assert _resolved(cell) == RESOLVED_BEFORE[cell]


def test_the_two_user_cell_resolves_its_twelve_metrics():
    """The seven metrics whose lists gain it, the four that list no cells and
    follow ``frames_per_s``, and its own."""
    cell = spec.load_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    assert _resolved(CELL) == sorted(STAGE_METRICS + ["setup.program_s",
                                                      "frame.mu_replica_ms_per_round"])


def test_the_two_user_cell_runs_the_mu_family_at_the_published_geometry():
    cell = spec.load_cell(CELL)
    assert cell.frame.__file__ == str(ROOT / "frames" / "mu.py")
    assert cell.reference.__file__ == str(ROOT / "reference" / "mu.py")
    assert cell.frame_args == {"angles_deg": [-30.0, 30.0], "distances_m": [100.0, 316.3],
                               "cord_z": 1.5}
    assert cell.link["modem"]["n_users"] == 2 and cell.link["rx"]["algorithm"] == "mcnc_mu"
    assert cell.n_iters == 8 and cell.traffic["frames_per_round"] == 128
    assert set(cell.limits) == {"gap_sq_first", "gap_sq_passes", "ber_gap"}
    # one [8192] TX and nine [16384] replica launches a round
    assert 128 * roofline.rows_per_frame("mcnc_mu", 64, 8, 2) == 8192 + 9 * 16384 == 155_648


def test_the_configuration_is_miso_los_with_two_users():
    """Every key of the canonical LOS link but ``modem.n_users``; nothing
    reduced."""
    mu = json.loads((ROOT / "configs" / "mu_two_user.json").read_text())
    los = json.loads((ROOT / "configs" / "miso_los.json").read_text())
    los["link"]["modem"]["n_users"] = 2
    assert mu["link"] == los["link"] and mu["reduced"] == []
    bench = json.loads(BENCHMARK.read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "mu_two_user")
    assert entry["file"] == "portbench/configs/mu_two_user.json" and entry["reduced"] == []
    assert entry["source"] == mu["source"]


def test_the_configurations_without_a_frame_family_run_the_single_user_frame():
    """The earlier cells' configurations name no ``frame``: ``frames/miso.py``,
    with no arguments."""
    for name in RESOLVED_BEFORE:
        cell = spec.load_cell(name)
        assert cell.frame.__file__ == str(ROOT / "frames" / "miso.py")
        assert cell.frame_args == {}


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0,
            "args": args}


def synthetic():
    """A 100 us window of two rounds. Launch (host us) -> device work (us):
    round 0: 2 -> 10-20 (frame.precoder), 12 -> 20-24 (mu.precode),
    14 -> the fused kernel 24-34 (chain), 16 -> 34-37 (mu.combine);
    round 1: 62 -> 70-72 (mu.precode), 66 -> 72-80 (mu.combine); the
    harness's cat: 95 -> 95-100."""
    ev = []
    for corr, (launch, start, dur, name) in enumerate([
            (2, 10, 10, "k"), (12, 20, 4, "k"), (14, 24, 10, "fused_ifft_pa_fft_tc_kernel"),
            (16, 34, 3, "k"), (62, 70, 2, "k"), (66, 72, 8, "k"), (95, 95, 5, "cat")], start=1):
        ev += [_x("cudaLaunchKernel", "cuda_runtime", launch, 0.5, correlation=corr),
               _x(name, "kernel", start, dur, correlation=corr)]
    ev.append(_x("cudaGetDevice", "cuda_runtime", 0, 1))
    spans = [(1, 50, "frame", -1, 0, {"frames": 128, "users": 2}),
             (1, 4, "frame.precoder", 0, 0, {}),
             (9, 30, "rx.pass", 0, 0, {"index": 0}),
             (10, 20, "rx.replica", 2, 0, {}),
             (11, 13, "mu.precode", 3, 0, {}),
             (13, 15, "chain", 3, 0, {"rows": 4096}),
             (15, 17, "mu.combine", 3, 0, {}),
             (60, 90, "frame", -1, 1, {"frames": 128, "users": 2}),
             (61, 63, "mu.precode", 7, 1, {}),
             (65, 67, "mu.combine", 7, 1, {})]
    return {"traceEvents": ev, "baseTimeNanoseconds": 0}, spans


def _view(with_spans: bool):
    cell = spec.load_cell(CELL)
    tr, spans = synthetic()
    view = trace.TraceView.from_trace(tr, rounds=2, link=cell.link, traffic=cell.traffic,
                                      readers=cell.readers)
    if with_spans:
        stages.attach(view, tr, spans)
    return view


def test_the_replica_reader_sums_its_two_spans_per_round():
    view = _view(True)
    assert view.read("frame.mu_replica_ms_per_round") == pytest.approx((4 + 3 + 2 + 8) / 1e3 / 2)
    assert view.read("frame.precoder_ms_per_round") == pytest.approx(10 / 1e3 / 2)
    assert view.read("frame.tx_eager_ms_per_round") is None     # no tx.* span began


def test_the_replica_reader_reads_nothing_without_the_spans():
    """A program without the spans (the parent's, for instance): the
    reader gives None and raises nothing."""
    assert _view(False).read("frame.mu_replica_ms_per_round") is None
    view = _view(True)
    view.__dict__["_stages"] = stages.Stages(view, [(1, 50, "frame", -1, 0, {})], [])
    assert view.read("frame.mu_replica_ms_per_round") is None
