"""The comparison that decides ``correct`` refuses what it must.

* The control: the plain reference put in the program's place and computed
  one precision below the configuration's (fp8 e4m3 where the cells
  compute in bf16: every stored plane and each transform pass's operand),
  at a size a test run holds, fails each cell's limits.
* The faults: a whole run on the CPU (the harness's look for a card
  skipped) with the timed path broken underneath, and ``correct`` false:
  a CNC loop that returns its state unchanged, half of each round's frames
  left out and the mean of the rest put in their place, and each frame's
  last answer altered where it is produced (the first pass's in its
  place). The cells run on one chip, so no exchange between chips can be
  left out.
"""

import json
from pathlib import Path

import pytest
import torch

import portbench_tiny
from portbench import check, run

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT.parent / "BENCHMARK.json").read_text())["workloads"]]


def _counters(c):
    from mimo_ofdm_tpu_torch.models.link import FrameCounters
    return FrameCounters(clean_err=c[:, 0].to(torch.int32),
                         dist_err=c[:, 1:].to(torch.int32).contiguous())


def _control_in_place(monkeypatch, planes=None):
    """Replace the port's frame by the reference with ``planes`` storage,
    by default the control's (``check.control_planes``)."""
    import mimo_ofdm_tpu_torch.models.link as link_mod
    from portbench.reference import miso

    def make(cfg, n_iters, device=None, **kw):
        import dataclasses
        link = json.loads(json.dumps(dataclasses.asdict(cfg)))
        prec = planes or check.control_planes(link)

        def frame(snr_db, draws):
            d = {k: getattr(draws, k) for k in
                 ("fade", "loc", "bits_c", "bits_d", "noise_c", "noise_d")}
            return _counters(miso.frame_counters(link, link["rx"]["algorithm"], n_iters,
                                                 snr_db, d, planes=prec))
        return frame
    monkeypatch.setattr(link_mod, "make_frame_fn", make)


def _run(tmp_path, monkeypatch, seconds=1.0, check_frames=16, **kw):
    portbench_tiny.shrink(monkeypatch.setattr, check_frames)
    bench, root = portbench_tiny.make(tmp_path, **kw)
    return run.run(portbench_tiny.CELL, 20260101, seconds, False, device="cpu",
                   benchmark=bench, root=root)


def _cell_kw(cell):
    """The cell's receiver, channel, SNR and limits, for the tiny f32 runs."""
    cfg = json.loads((ROOT / "configs" / f"{cell.split('.')[0]}.json").read_text())["link"]
    tr = json.loads((ROOT / "traffic" / f"{cell.split('.', 1)[1]}.json").read_text())
    return dict(receiver=tr["receiver"], channel=cfg["channel"]["model"],
                snr_db=tr["snr_db"], limits_of=cell)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits(cell, tmp_path, monkeypatch):
    """The cell's configuration (bf16) at 64 antennas and n_fft 256, the
    cell's receiver, channel and SNR, the cell's limits."""
    _control_in_place(monkeypatch)
    res = _run(tmp_path, monkeypatch, 3.0, storage="bfloat16", n_ant=64, frames=8, check_frames=64,
               **_cell_kw(cell))
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]


def test_the_control_is_one_precision_below_the_configurations():
    assert check.control_planes({"mxu_fft_storage": "bfloat16"}) == "float8_e4m3fn"
    assert check.control_planes({"mxu_fft_storage": "float32"}) == "bfloat16"
    for cell in CELLS:
        cfg = json.loads((ROOT / "configs" / f"{cell.split('.')[0]}.json").read_text())
        assert check.control_planes(cfg["link"]) == "float8_e4m3fn", cell


def test_the_reference_in_the_programs_place_passes(tmp_path, monkeypatch):
    """The same harness with the reference itself in the program's place."""
    _control_in_place(monkeypatch, "float32")
    res = _run(tmp_path, monkeypatch, 3.0, storage="bfloat16", receiver="mcnc", n_ant=64, frames=8,
               check_frames=64)
    assert res["correct"] is True, res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


FAULT_SIZE = {"n_fft": 1024, "n_ant": 16}


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_passes(cell, tmp_path, monkeypatch):
    res = _run(tmp_path, monkeypatch, frames=8, **FAULT_SIZE, **_cell_kw(cell))
    assert res["correct"] is True, res["checks"]


def _state_unchanged(monkeypatch):
    import mimo_ofdm_tpu_torch.models.receivers as rx
    real = rx.cnc_iterate

    def frozen(rx_sc, n_iters, constel_size, replica_fn, detect_alpha=1.0):
        return real(rx_sc, n_iters, constel_size, lambda det: det, detect_alpha)
    monkeypatch.setattr(rx, "cnc_iterate", frozen)


def _wrap_frame(monkeypatch, alter):
    import mimo_ofdm_tpu_torch.models.link as link_mod
    real = link_mod.make_frame_fn

    def make(*a, **kw):
        fn = real(*a, **kw)
        return lambda snr_db, draws: alter(fn, snr_db, draws)
    monkeypatch.setattr(link_mod, "make_frame_fn", make)


def _half_batch(monkeypatch):
    def alter(fn, snr_db, draws):
        half = draws.batch // 2
        c = fn(snr_db, type(draws)(*(x[:half] if isinstance(x, torch.Tensor) else x
                                     for x in draws)))
        per = torch.cat([c.clean_err[:, None], c.dist_err], 1)
        mean = per.float().mean(0, keepdim=True).round().to(per.dtype)
        return _counters(torch.cat([per, mean.expand(draws.batch - half, -1)]))
    _wrap_frame(monkeypatch, alter)


def _answer_altered(monkeypatch):
    def alter(fn, snr_db, draws):
        c = fn(snr_db, draws)
        dist = c.dist_err.clone()
        dist[:, -1] = dist[:, 0]                 # the last pass answers with the first's
        return c._replace(dist_err=dist)
    _wrap_frame(monkeypatch, alter)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(fault, cell, tmp_path, monkeypatch):
    """At n_fft 1024 and 16 antennas, where the receivers' passes move the
    errors as at full size (LOS CNC converges, Rayleigh CNC rises)."""
    fault(monkeypatch)
    res = _run(tmp_path, monkeypatch, frames=8, **FAULT_SIZE, **_cell_kw(cell))
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]
