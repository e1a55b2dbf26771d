"""The comparison that decides ``correct`` in the two-user cell refuses what
it must, through the harness on the CPU with the cell's own limits and the
plain two-user reference (``reference/mu.py``):

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
import shutil
from pathlib import Path

import pytest
import torch

import portbench_tiny
from portbench import check, run
from portbench.reference import mu
from test_portbench_control import FAULT_SIZE, _state_unchanged

ROOT = Path(__file__).resolve().parents[1]
CELL = "mu_two_user.mcnc_mu.b128"
TRAFFIC = json.loads((ROOT / "traffic" / "mcnc_mu.b128.json").read_text())


def _run(tmp_path, monkeypatch, seconds=2.0, check_frames=16, storage="float32", **kw):
    """The two-user tiny cell with this cell's receiver, SNR, reference and
    limits, at ``storage``; one run on the CPU, its window long enough for a
    loaded host to complete a round in it (the reference in the program's
    place takes about half a second a round at 32 antennas)."""
    portbench_tiny.shrink(monkeypatch.setattr, check_frames)
    limits = json.loads((ROOT / "limits" / f"{CELL}.json").read_text())
    bench, root = portbench_tiny.make_mu(tmp_path, receiver=TRAFFIC["receiver"],
                                         snr_db=TRAFFIC["snr_db"], limits=limits, **kw)
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    cfg["reference"] = "mu"
    cfg["link"]["mxu_fft_storage"] = cfg["link"]["channel_storage"] = storage
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "reference" / "mu.py", root / "reference" / "mu.py")
    return run.run(portbench_tiny.CELL, 20261018, seconds, False, device="cpu",
                   benchmark=bench, root=root)


def _draws_dict(draws):
    """The family's dict of a ``MuFrameDraws`` (``frames/mu.py::to_draws``
    read back)."""
    def users(field):
        got = [getattr(u, field) for u in draws.users]
        return None if got[0] is None else torch.stack(got, 1)
    return {"fade": users("fade"), "loc": users("loc"), "bits_c": draws.bits_c,
            "bits_d": draws.bits_d, "noise_c": draws.noise_c, "noise_d": draws.noise_d}


def _reference_in_place(monkeypatch, planes=None):
    """Replace the port's two-user frame by the reference with ``planes``
    storage, by default the control's (``check.control_planes``)."""
    import dataclasses

    from mimo_ofdm_tpu_torch.models import link_mu

    def make(cfg, n_iters, positions, device=None, **kw):
        link = json.loads(json.dumps(dataclasses.asdict(cfg)))
        prec = planes or check.control_planes(link)
        args = {"angles_deg": [-30.0, 30.0], "distances_m": [100.0, 316.3], "cord_z": 1.5}
        assert (link_mu.default_user_positions(tuple(args["angles_deg"]),
                                               tuple(args["distances_m"])) == positions).all()

        def frame(snr_db, draws):
            c = mu.frame_counters(link, link["rx"]["algorithm"], n_iters, snr_db,
                                  _draws_dict(draws), planes=prec, **args).to(torch.int32)
            return link_mu.MuFrameCounters(clean_err=c[..., 0], dist_err=c[..., 1:].contiguous())
        return frame
    monkeypatch.setattr(link_mu, "make_mu_frame_fn", make)


def test_the_control_fails_the_cells_limits(tmp_path, monkeypatch):
    """The cell's configuration (bf16) at 32 antennas and n_fft 256, the
    cell's receiver, channel and SNR, the cell's limits: it reads each of
    the three numbers over its limit (0.095, 3.0 and 0.62 against 0.045,
    1.0 and 0.15)."""
    _reference_in_place(monkeypatch)
    res = _run(tmp_path, monkeypatch, 4.0, 64, storage="bfloat16", n_ant=32, frames=8)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]


def test_the_reference_in_the_programs_place_passes(tmp_path, monkeypatch):
    _reference_in_place(monkeypatch, "float32")
    res = _run(tmp_path, monkeypatch, 4.0, 64, storage="bfloat16", n_ant=32, frames=8)
    assert res["correct"] is True, res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_the_sound_program_passes(tmp_path, monkeypatch):
    res = _run(tmp_path, monkeypatch, frames=8, **FAULT_SIZE)
    assert res["correct"] is True, res["checks"]


def _wrap_frame(monkeypatch, alter):
    from mimo_ofdm_tpu_torch.models import link_mu
    real = link_mu.make_mu_frame_fn

    def make(*a, **kw):
        fn = real(*a, **kw)
        return lambda snr_db, draws: alter(fn, snr_db, draws)
    monkeypatch.setattr(link_mu, "make_mu_frame_fn", make)


def _half_batch(monkeypatch):
    def alter(fn, snr_db, draws):
        half = draws.batch // 2
        cut = draws._replace(
            users=tuple(type(u)(*(x[:half] if isinstance(x, torch.Tensor) else x for x in u))
                        for u in draws.users),
            **{k: getattr(draws, k)[:half] for k in ("bits_c", "bits_d", "noise_c", "noise_d")})
        c = fn(snr_db, cut)
        per = torch.cat([c.clean_err[..., None], c.dist_err], -1)          # [half, U, P]
        mean = per.float().mean(0, keepdim=True).round().to(per.dtype)
        per = torch.cat([per, mean.expand(draws.batch - half, -1, -1)])
        return c._replace(clean_err=per[..., 0], dist_err=per[..., 1:].contiguous())
    _wrap_frame(monkeypatch, alter)


def _answer_altered(monkeypatch):
    def alter(fn, snr_db, draws):
        c = fn(snr_db, draws)
        dist = c.dist_err.clone()
        dist[..., -1] = dist[..., 0]             # the last pass answers with the first's
        return c._replace(dist_err=dist)
    _wrap_frame(monkeypatch, alter)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_a_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    """At n_fft 1024 and 16 antennas, where MCNC-MU's passes take most of
    the first pass's errors away, as at full size."""
    fault(monkeypatch)
    res = _run(tmp_path, monkeypatch, frames=8, **FAULT_SIZE)
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]
