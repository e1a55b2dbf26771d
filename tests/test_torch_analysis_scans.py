"""The port's correlation and SDR scans held against the JAX package's on
the CPU, on JAX's own draws (tests/torch_parity_draws.py), at n_fft 256,
n_sc 128, 8 antennas, at most 12 points and 5 snapshots; with the physics
checks of tests/test_analysis.py on the port. The multi-user scans are in
tests/test_torch_analysis_mu.py.

Tolerances (see tests/test_torch_analysis.py), each about 3x the gap
measured on these inputs. On Rayleigh the two packages agree to float32
rounding: correlations within 1.2e-7 (asserted 5e-7), SDRs within 3.8e-6
dB (asserted 2e-5 dB). On LOS the compiled JAX scan rounds the ~2e4 rad
phase otherwise (XLA folds its constant factors): correlations within
2.5e-4 (asserted 8e-4), SDRs within 1.6e-4 dB (asserted 5e-4 dB).
"""

import dataclasses

import numpy as np
import jax
import pytest

import torch_parity_draws as pdr
from mimo_ofdm_tpu.models import analysis as jan
from mimo_ofdm_tpu.utils import config as jcfg_mod

from mimo_ofdm_tpu_torch.models import analysis
from mimo_ofdm_tpu_torch.utils import config as pcfg_mod

N_BITS = 6 * 128
KEY = 3
TOL = {"los": dict(corr=8e-4, db=5e-4), "rayleigh": dict(corr=5e-7, db=2e-5)}


def _cfgs(chan, n_ant=8, ibo=0.0):
    j = jcfg_mod.LinkConfig(
        modem=jcfg_mod.ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128, cp_len=16),
        array=jcfg_mod.ArrayConfig(n_elements=n_ant),
        channel=jcfg_mod.ChannelConfig(model=chan),
        pa=jcfg_mod.PaConfig(model="softlim", ibo_db=ibo))
    return j, pcfg_mod.config_from_dict(dataclasses.asdict(j))


def _rayleigh_only(draws, chan, *fields):
    """Drop the fade fields the geometric channels do not read."""
    return draws if chan == "rayleigh" else draws._replace(**{f: None for f in fields})


@pytest.mark.parametrize("chan", ["los", "rayleigh"])
def test_channel_mat_correlation_matches_jax(chan):
    """Also: the correlation is 1 at the main angle and is the maximum; on
    Rayleigh every other point is an independent fade, below 0.6."""
    j, p = _cfgs(chan)
    key = jax.random.key(KEY)
    with jax.enable_x64(False):
        ja, jc = jan.channel_mat_correlation_scan(j, key, n_points=12, point_chunk=8)
        draws = pdr.as_torch(pdr.scan_channel_corr(key, 12, (8, 256)))
    pa_, pc = analysis.channel_mat_correlation_scan(p, draws, n_points=12, point_chunk=8,
                                                    device="cpu")
    np.testing.assert_array_equal(pa_, ja)
    np.testing.assert_allclose(pc, np.asarray(jc), atol=TOL[chan]["corr"])
    main = int(round(12 / 180 * 45.0))
    assert pc[main] == pytest.approx(1.0, abs=1e-5) and pc.argmax() == main
    assert np.all(pc <= 1.0 + 1e-5) and np.all(pc >= 0.0)
    if chan == "rayleigh":
        assert np.all(np.delete(pc, main) < 0.6)


def test_channel_correlation_narrows_with_antennas():
    """LOS: larger arrays decorrelate faster away from the main angle."""
    corr = {n: analysis.channel_mat_correlation_scan(_cfgs("los", n)[1], n_points=36,
                                                     device="cpu")[1] for n in (2, 16)}
    off = int(round(36 / 180 * 90.0))
    assert corr[16][off] < corr[2][off]


@pytest.mark.parametrize("chan", ["los", "rayleigh"])
def test_spatial_correlation_matches_jax(chan):
    """Also: 1 at the main angle, the maximum, all in (0, 1]."""
    j, p = _cfgs(chan)
    key = jax.random.key(KEY)
    n_points = 10 if chan == "los" else 6
    with jax.enable_x64(False):
        _, jc = jan.spatial_correlation_scan(j, key, n_points=n_points)
        draws = pdr.as_torch(pdr.scan_spatial(key, n_points, N_BITS,
                                              (8, 128) if chan == "rayleigh" else None))
    _, pc = analysis.spatial_correlation_scan(p, draws, n_points=n_points, point_chunk=4,
                                              device="cpu")
    np.testing.assert_allclose(pc, np.asarray(jc), atol=TOL[chan]["corr"])
    main = int(round(n_points / 180 * 45.0))
    assert pc[main] == pytest.approx(1.0, abs=1e-5) and pc.argmax() == main
    assert np.all(pc > 0.0) and np.all(pc <= 1.0 + 1e-5)


@pytest.mark.parametrize("chan", ["los", "rayleigh"])
def test_sdr_vs_ibo_matches_jax(chan):
    """Two IBO values, 5 snapshots in chunks of 2 (the last one ragged), the
    RX rerolled per snapshot on LOS: dB and linear means; SDR rises with
    IBO."""
    j, p = _cfgs(chan)
    key = jax.random.key(KEY)
    kw = dict(n_snapshots=5, snap_chunk=2)
    rx = (150.0, 150.0, 1.5)
    with jax.enable_x64(False):
        jdb, jlin = jan.sdr_vs_ibo_curve(j, key, [0.0, 3.0], rx, **kw)
        draws = pdr.as_torch(_rayleigh_only(
            pdr.scan_sdr(key, 2, 5, N_BITS, (8, 128), 10.0), chan, "fade"))
    if chan == "rayleigh":
        draws = draws._replace(loc=None)
    pdb, plin = analysis.sdr_vs_ibo_curve(p, [0.0, 3.0], rx, draws, device="cpu", **kw)
    np.testing.assert_allclose(pdb, jdb, atol=TOL[chan]["db"])
    np.testing.assert_allclose(10 * np.log10(plin), 10 * np.log10(jlin), atol=TOL[chan]["db"])
    assert pdb[0] < pdb[1]


def test_sdr_at_point_rises_with_ibo():
    """More backoff, less clipping, higher SDR (main_sdr_vs_ibo_vs_channel.py)."""
    sdrs = [float(analysis.sdr_at_point(_cfgs("los", 16, ibo)[1], (150.0, 150.0, 1.5),
                                        seed=2, n_snapshots=4, device="cpu")[0])
            for ibo in (0.0, 3.0, 6.0)]
    assert sdrs[0] < sdrs[1] < sdrs[2]
