"""The coded cell ``ldpc_ref.cnc.b16`` as the benchmark finds it: its
configuration, family and reference by name, the per-layer metrics it
resolves (the earlier cells' unchanged), its round's draws, the decoder's
roofline counts, the readers of the decoder's and demapper's spans on a
synthetic trace, and a reference that imports nothing of the program."""

import json
import sys
from pathlib import Path

import pytest
import torch

from portbench import roofline_ldpc, spec, stages, trace
from portbench.reference import ldpc as reference

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = ROOT.parent / "BENCHMARK.json"
CELL = "ldpc_ref.cnc.b16"
NEW_METRICS = ["frame.decoder_ms_per_round", "frame.decoder_roofline",
               "frame.demap_ms_per_round"]
UNLISTED = ["device.idle_share", "frame.other_device_ms_per_round", "round.host_ms_per_round",
            "round.launches_per_round"]
STAGE_METRICS = ["device.idle_in_frame_share", "device.idle_share",
                 "frame.other_device_ms_per_round", "frame.precoder_ms_per_round",
                 "frame.receiver_ms_per_round", "frame.tx_eager_ms_per_round",
                 "kernel.fused_pa_ms_per_round", "kernel.fused_pa_roofline",
                 "round.host_ms_per_round", "round.launches_per_round"]
HOST_PACED = sorted([m + ".host_paced" for m in STAGE_METRICS] + ["setup.program_s"])
# the per-layer metrics each cell resolved before the coded cell was added
RESOLVED_BEFORE = {
    "miso_rayleigh.mcnc.b512": sorted(STAGE_METRICS + ["setup.program_s"]),
    "miso_los.cnc.b32": HOST_PACED,
    "miso_rayleigh.cnc.b512": HOST_PACED,
    "mu_two_user.mcnc_mu.b128": sorted(STAGE_METRICS + ["setup.program_s",
                                                        "frame.mu_replica_ms_per_round"]),
}


def _resolved(cell: str) -> list[str]:
    return sorted(m.name for m in spec.load_cell(cell).per_layer)


@pytest.mark.parametrize("cell", sorted(RESOLVED_BEFORE))
def test_the_earlier_cells_resolve_the_same_metrics(cell):
    assert _resolved(cell) == RESOLVED_BEFORE[cell]


def test_the_coded_cell_resolves_its_nine_metrics():
    """The two whose lists gain it, the four that list no cells and follow
    ``frames_per_s``, and its three own."""
    cell = spec.load_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    assert _resolved(CELL) == sorted(UNLISTED + NEW_METRICS + ["device.idle_in_frame_share",
                                                               "setup.program_s"])


def test_the_coded_cell_runs_the_ldpc_family_at_ldpc_ref_bers_settings():
    cell = spec.load_cell(CELL)
    assert cell.frame.__file__ == str(ROOT / "frames" / "ldpc.py")
    assert cell.reference.__file__ == str(ROOT / "reference" / "ldpc.py")
    assert cell.frame_args == {"code_rate": 0.5, "ldpc_iters": 12, "ldpc_algorithm": "sumprod"}
    assert cell.link["rx"]["algorithm"] == "cnc" and cell.n_iters == 8
    assert cell.traffic["frames_per_round"] == 16 and cell.traffic["rounds_in_flight"] == 3
    assert cell.traffic["snr_db"] == pytest.approx(8.0 + 7.781512503836436)
    assert set(cell.limits) <= {"gap_sq_first", "gap_sq_passes", "ber_gap"} and cell.limits


def test_the_configuration_is_ldpc_ref_bers_link_uncut():
    """``coded_link_config("los", "cnc", 64, 0.0)`` with 8 CNC iterations,
    which is the canonical LOS link; nothing reduced."""
    cfg = json.loads((ROOT / "configs" / "ldpc_ref.json").read_text())
    los = json.loads((ROOT / "configs" / "miso_los.json").read_text())
    assert cfg["link"] == los["link"] and cfg["reduced"] == []
    bench = json.loads(BENCHMARK.read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "ldpc_ref")
    assert entry["file"] == "portbench/configs/ldpc_ref.json" and entry["reduced"] == []
    assert entry["source"] == cfg["source"]


def test_the_code_is_one_bg1_block_of_zc_288():
    cell = spec.load_cell(CELL)
    code = reference.code_of(cell.link, cell.frame_args["code_rate"])
    assert (code.bg, code.a, code.k_prime, code.z, code.e) == (1, 6144, 6168, 288, 12288)
    assert code.n - 2 * code.z == 19_008


def test_the_decoder_roofline_counts_the_configurations_work():
    """84,960 edges a codeword, 160 codewords a round (16 frames, the clean
    run and 9 passes, one block each), operations the bound: about 15 us."""
    cell = spec.load_cell(CELL)
    code = reference.code_of(cell.link, 0.5)
    assert code.edges == 84_960
    words = roofline_ldpc.codewords_per_round(16, cell.n_iters)
    assert words == 160
    least, bound = roofline_ldpc.least_seconds(words, code.edges, 12, code.e, code.k)
    assert bound == "operations"
    assert least == pytest.approx(160 * 6 * 84_960 * 12 / 67e12)
    assert roofline_ldpc.round_least_seconds(cell.link, cell.traffic, 0.5, 12) == least
    assert roofline_ldpc.codeword_bytes(code.e, code.k) == 4 * 12_288 + 6_336


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 10**15 + 3])
def test_draw_round_has_the_same_shapes_for_every_seed(seed):
    link = json.loads((ROOT / "configs" / "ldpc_ref.json").read_text())["link"]
    link["modem"].update(n_fft=256, n_sub_carr=128)
    link["array"]["n_elements"] = 4
    cell = spec.load_cell(CELL)
    d = cell.frame.draw_round(link, 3, seed, 1, "cpu", **cell.frame_args)
    assert d["fade"] is None
    assert d["bits_c"].shape == d["bits_d"].shape == (3, 384)
    assert d["bits_d"].dtype == torch.int8
    assert d["noise_c"].shape == d["noise_d"].shape == (3, 2, 128)
    assert d["loc"].shape == (3, 2) and d["loc"].abs().max() <= 5.0
    again = cell.frame.draw_round(link, 3, seed, 1, "cpu", **cell.frame_args)
    assert all(torch.equal(d[k], again[k]) for k in ("bits_c", "bits_d", "noise_c", "loc"))


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0,
            "args": args}


def synthetic():
    """A 100 us window of two rounds. Launch (host us) -> device work (us):
    round 0: 2 -> 10-14 (frame.channel), 12 -> 14-16 (soft_demap),
    14 -> 16-20 (outer decode: de-rate-matching), 16 -> 20-40 (inner
    decode); round 1: 62 -> 62-64 (soft_demap), 66 -> 64-84 (inner
    decode); the harness's cat: 95 -> 95-100."""
    ev = []
    for corr, (launch, start, dur, name) in enumerate([
            (2, 10, 4, "k"), (12, 14, 2, "k"), (14, 16, 4, "k"), (16, 20, 20, "k"),
            (62, 62, 2, "k"), (66, 64, 20, "k"), (95, 95, 5, "cat")], start=1):
        ev += [_x("cudaLaunchKernel", "cuda_runtime", launch, 0.5, correlation=corr),
               _x(name, "kernel", start, dur, correlation=corr)]
    ev.append(_x("cudaGetDevice", "cuda_runtime", 0, 1))
    spans = [(1, 50, "frame", -1, 0, {"frames": 16}),
             (1, 4, "frame.channel", 0, 0, {}),
             (11, 13, "soft_demap", 0, 0, {}),
             (13, 30, "decode", 0, 0, {}),
             (15, 29, "decode", 3, 0, {"codewords": 160, "iters": 12}),
             (60, 90, "frame", -1, 1, {"frames": 16}),
             (61, 63, "soft_demap", 5, 1, {}),
             (64, 80, "decode", 5, 1, {}),
             (65, 79, "decode", 7, 1, {"codewords": 160, "iters": 12})]
    return {"traceEvents": ev, "baseTimeNanoseconds": 0}, spans


def _view(with_spans: bool):
    cell = spec.load_cell(CELL)
    tr, spans = synthetic()
    view = trace.TraceView.from_trace(tr, rounds=2, link=cell.link, traffic=cell.traffic,
                                      readers=cell.readers)
    if with_spans:
        stages.attach(view, tr, spans)
    return view


def test_the_decoder_and_demapper_readers_sum_their_spans_per_round(monkeypatch):
    monkeypatch.setattr(sys, "argv", [str(ROOT / "run.py"), "--workload", CELL, "--trace", "1"])
    view = _view(True)
    decoder_ms = (4 + 20 + 20) / 1e3 / 2
    assert view.read("frame.decoder_ms_per_round") == pytest.approx(decoder_ms)
    assert view.read("frame.demap_ms_per_round") == pytest.approx((2 + 2) / 1e3 / 2)
    least_ms = 160 * 6 * 84_960 * 12 / 67e12 * 1e3
    assert view.read("frame.decoder_roofline") == pytest.approx(100 * least_ms / decoder_ms)
    assert view.read("frame.precoder_ms_per_round") is None     # no such span began


def test_the_roofline_reads_nothing_outside_a_traced_run_of_the_cell(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pytest"])
    assert _view(True).read("frame.decoder_roofline") is None


def test_the_readers_read_nothing_without_the_spans(monkeypatch):
    """A program without the spans: each reader gives None and raises
    nothing."""
    monkeypatch.setattr(sys, "argv", [str(ROOT / "run.py"), "--workload", CELL, "--trace", "1"])
    for name in NEW_METRICS:
        assert _view(False).read(name) is None
    view = _view(True)
    view.__dict__["_stages"] = stages.Stages(view, [(1, 50, "frame", -1, 0, {})], [])
    for name in NEW_METRICS:
        assert view.read(name) is None


def test_the_coded_reference_and_roofline_load_nothing_of_the_program():
    """``reference/ldpc.py`` (and ``roofline_ldpc.py``, which counts from it)
    imports neither JAX nor either package of the simulator."""
    from portbench import run
    from test_portbench_imports import _top_level_modules_after

    mods = _top_level_modules_after("""
        import json, sys
        from portbench import roofline_ldpc
        from portbench.frames import ldpc as family
        from portbench.reference import ldpc
        link = json.load(open("portbench/configs/ldpc_ref.json"))["link"]
        link["modem"].update(n_fft=256, n_sub_carr=128)
        link["array"]["n_elements"] = 4
        args = {"code_rate": 0.5, "ldpc_iters": 2, "ldpc_algorithm": "sumprod"}
        d = family.draw_round(link, 2, 5, 0, "cpu", **args)
        assert ldpc.frame_counters(link, "cnc", 1, 15.0, d, **args).shape == (2, 3)
        assert roofline_ldpc.codewords_per_round(16, 8) == 160
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert "torch" in mods
    assert not mods & {*run.FORBIDDEN, "mimo_ofdm_tpu_torch"}
