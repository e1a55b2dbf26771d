"""The comparison that decides ``correct`` in the coded cell refuses what it
must, through the harness on the CPU with the plain coded reference
(``reference/ldpc.py``), on a small LDPC cell of the ``ldpc`` family: the
cell's configuration cut to n_fft 1024, 512 subcarriers and 16 antennas
(A = 1,536 payload bits, where §7.2.2 picks BG2), its receiver at Eb/N0
7 dB, where this link's passes sit in their waterfall as the full cell's do
at 8 dB, with limits of its own (:data:`LIMITS`):

* the control, the reference put in the program's place and computed one
  precision below the configuration's (fp8 e4m3 where the cell computes
  in bf16: the chain's input, passes and output), fails the limits;
* the reference in the program's place, and the sound program, pass;
* a whole run with the timed path broken underneath is not correct: a CNC
  loop that returns its state unchanged, half of each round's frames left
  out and the mean of the rest put in their place, and each frame's last
  answer altered where it is produced (the first pass's in its place).
"""

import json
import math
import shutil
from pathlib import Path

import pytest
import torch

import portbench_tiny
from portbench import check, run
from portbench.reference import ldpc as reference

ROOT = Path(__file__).resolve().parents[1]
CELL = "ldpc_ref.cnc.b16"
CONFIG = json.loads((ROOT / "configs" / "ldpc_ref.json").read_text())
TRAFFIC = json.loads((ROOT / "traffic" / "cnc.b16.json").read_text())
EBN0_DB = 7.0
# A failed block's payload errors, and with them gap_sq, grow with the bits a
# block carries, so the small cell's 1,536-bit blocks take limits of their
# own, set as the cell's were: between the program's largest reading and the
# faults' and fp8 control's smallest at this size (on the CPU, 16-32 frames
# of 4 draws). gap_sq_first: program 0.031-0.064, control 0.45-1.18.
# gap_sq_passes: program 3.0-4.7, control 13.2-19.5, the state left
# unchanged 44-53, the last answer altered 9.4-13.3, half the frames left
# out 14.4. ber_gap: program 0.08-0.13, control 0.64-1.29, the last answer
# altered 0.36-0.51, half the frames left out 0.34.
LIMITS = {"gap_sq_first": {"limit": 0.3}, "gap_sq_passes": {"limit": 7.5},
          "ber_gap": {"limit": 0.25}}


def make_ldpc(tmp, *, n_ant=16, n_fft=1024, frames=8, ebn0_db=EBN0_DB, limits=LIMITS):
    """Write the coded cell ``tiny.t`` under ``tmp``: the cell's configuration
    (``"frame": "ldpc"``, its reference and ``frame_args``) at ``n_fft`` and
    ``n_ant``, its receiver at ``ebn0_db``, one round in flight, ``limits``
    and the cell's metrics; returns ``(BENCHMARK.json, root)``."""
    snr_db = ebn0_db + 10 * math.log10(6)
    bench, tmp = portbench_tiny.make(tmp, storage="bfloat16", receiver=TRAFFIC["receiver"],
                                     channel="los", frames=frames, n_ant=n_ant, n_fft=n_fft,
                                     limits_of=CELL, snr_db=snr_db)
    cfg = json.loads(json.dumps(CONFIG))
    cfg["link"]["modem"].update(n_fft=n_fft, n_sub_carr=n_fft // 2)
    cfg["link"]["array"]["n_elements"] = n_ant
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for d in ("frames", "reference"):
        shutil.copytree(ROOT / d, tmp / d, dirs_exist_ok=True)
    tr = json.loads((tmp / "traffic" / "t.json").read_text())
    tr["rounds_in_flight"] = 1              # a CPU round takes a few seconds
    (tmp / "traffic" / "t.json").write_text(json.dumps(tr))
    (tmp / "limits" / f"{portbench_tiny.CELL}.json").write_text(json.dumps(limits))
    return bench, tmp


def _run(tmp_path, monkeypatch, seconds=8.0, check_frames=32, **kw):
    portbench_tiny.shrink(monkeypatch.setattr, check_frames)
    bench, root = make_ldpc(tmp_path, **kw)
    return run.run(portbench_tiny.CELL, 2**33 + 24, seconds, False, device="cpu",
                   benchmark=bench, root=root)


def _counters(per, like):
    """``like`` with the per-frame errors ``per [B, n_iters + 2]`` (the
    block counts, which the check does not read, left as they are)."""
    return like._replace(clean_err=per[:, 0].to(like.clean_err.dtype),
                         dist_err=per[:, 1:].to(like.dist_err.dtype).contiguous())


def _reference_in_place(monkeypatch, planes=None):
    """Replace the port's coded frame by the reference with ``planes``
    storage, by default the control's (``check.control_planes``)."""
    import dataclasses

    from mimo_ofdm_tpu_torch.models import link_ldpc

    def make(cfg, n_iters, chain, ldpc_iters=25, *, ldpc_algorithm="minsum", device=None,
             **kw):
        link = json.loads(json.dumps(dataclasses.asdict(cfg)))
        prec = planes or check.control_planes(link)
        rate = CONFIG["frame_args"]["code_rate"]
        assert chain.a == reference.payload_bits(link, rate)

        def frame(snr_db, draws):
            d = {k: getattr(draws, k) for k in
                 ("fade", "loc", "bits_c", "bits_d", "noise_c", "noise_d")}
            c = reference.frame_counters(link, link["rx"]["algorithm"], n_iters, snr_db, d,
                                         planes=prec, code_rate=rate, ldpc_iters=ldpc_iters,
                                         ldpc_algorithm=ldpc_algorithm).to(torch.int32)
            zeros = torch.zeros_like(c)
            return link_ldpc.TransportFrameCounters(
                clean_err=c[:, 0], clean_blk=zeros[:, 0], dist_err=c[:, 1:].contiguous(),
                dist_blk=zeros[:, 1:].contiguous())
        return frame
    monkeypatch.setattr(link_ldpc, "make_transport_frame_fn", make)


def test_the_control_fails_the_limits(tmp_path, monkeypatch):
    _reference_in_place(monkeypatch)
    res = _run(tmp_path, monkeypatch)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]


def test_the_reference_in_the_programs_place_passes(tmp_path, monkeypatch):
    _reference_in_place(monkeypatch, "float32")
    res = _run(tmp_path, monkeypatch)
    assert res["correct"] is True, res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_the_sound_program_passes(tmp_path, monkeypatch):
    res = _run(tmp_path, monkeypatch)
    assert res["correct"] is True, res["checks"]


def _state_unchanged(monkeypatch):
    from mimo_ofdm_tpu_torch.models import receivers
    real = receivers.cnc_iterate_soft

    def frozen(rx_sc, n_iters, constel_size, replica_fn, detect_alpha=1.0):
        return real(rx_sc, n_iters, constel_size, lambda det: det, detect_alpha)
    monkeypatch.setattr(receivers, "cnc_iterate_soft", frozen)


def _wrap_frame(monkeypatch, alter):
    from mimo_ofdm_tpu_torch.models import link_ldpc
    real = link_ldpc.make_transport_frame_fn

    def make(*a, **kw):
        fn = real(*a, **kw)
        return lambda snr_db, draws: alter(fn, snr_db, draws)
    monkeypatch.setattr(link_ldpc, "make_transport_frame_fn", make)


def _half_batch(monkeypatch):
    def alter(fn, snr_db, draws):
        half = draws.batch // 2
        c = fn(snr_db, type(draws)(*(x[:half] if isinstance(x, torch.Tensor) else x
                                     for x in draws)))
        per = torch.cat([c.clean_err[:, None], c.dist_err], 1)
        mean = per.float().mean(0, keepdim=True).round().to(per.dtype)
        return _counters(torch.cat([per, mean.expand(draws.batch - half, -1)]), c)
    _wrap_frame(monkeypatch, alter)


def _answer_altered(monkeypatch):
    def alter(fn, snr_db, draws):
        c = fn(snr_db, draws)
        dist = c.dist_err.clone()
        dist[:, -1] = dist[:, 0]                 # the last pass answers with the first's
        return c._replace(dist_err=dist)
    _wrap_frame(monkeypatch, alter)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_a_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    res = _run(tmp_path, monkeypatch)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]
