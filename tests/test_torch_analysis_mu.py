"""The port's multi-user analysis scans held against the JAX package's on
the CPU, on JAX's own draws (tests/torch_parity_draws.py), at n_fft 256,
n_sc 128, 8 antennas, at most 12 points and 4 snapshots: the per-user
SDR/SINR and the two-user SDR vs angle. The SDR vs IBO vs user count is in
tests/test_torch_analysis_nusers.py.

Tolerances (see tests/test_torch_analysis.py and
tests/test_torch_analysis_scans.py), each about 3x the gap measured on
these inputs. Rayleigh: float32 rounding, SDRs within 5.7e-6 dB (asserted
2e-5 dB), correlations within 9e-8 (asserted 3e-7). LOS: the per-user
SDR/SINR scan is one batched computation in both, within 3.8e-6 dB
(asserted 2e-5 dB).
"""

import dataclasses

import numpy as np
import jax
import pytest

import torch_parity_draws as pdr
from mimo_ofdm_tpu.models import analysis as jan
from mimo_ofdm_tpu.utils import config as jcfg_mod

from mimo_ofdm_tpu_torch.models import analysis
from mimo_ofdm_tpu_torch.models.link_mu import spread_user_positions
from mimo_ofdm_tpu_torch.utils import config as pcfg_mod

N_BITS = 6 * 128
KEY = 3
TOL = {"rayleigh": dict(corr=3e-7, db=2e-5)}


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


@pytest.mark.parametrize("kind", ["mrt", "zf"])
def test_mu_sinr_sdr_matches_jax(kind):
    """Three users on LOS: SDR and SINR [dB] within 2e-5 dB (measured
    3.8e-6); ZF takes the pseudo-inverse path of more than two users."""
    j, p = _cfgs("los")
    key = jax.random.key(KEY)
    pos = spread_user_positions(3)
    with jax.enable_x64(False):
        js, jn = jan.mu_sinr_sdr(j, key, pos, n_snapshots=4, precoding_kind=kind)
        draws = pdr.as_torch(analysis.ScanDraws(pdr.scan_snapshot_bits(key, 4, (3, N_BITS))))
    ps, pn = analysis.mu_sinr_sdr(p, pos, draws, n_snapshots=4, precoding_kind=kind,
                                  device="cpu")
    np.testing.assert_allclose(ps, np.asarray(js), atol=2e-5)
    np.testing.assert_allclose(pn, np.asarray(jn), atol=2e-5)


def test_mu_sinr_zf_beats_mrt():
    """ZF nulls the inter-user interference, so its SINR is about its SDR;
    MRT leaves cross-talk, so its SINR is below its SDR."""
    _, p = _cfgs("los", 32)
    pos = spread_user_positions(4)
    sdr_zf, sinr_zf = analysis.mu_sinr_sdr(p, pos, seed=1, n_snapshots=4,
                                           precoding_kind="zf", device="cpu")
    sdr_mrt, sinr_mrt = analysis.mu_sinr_sdr(p, pos, seed=1, n_snapshots=4,
                                             precoding_kind="mrt", device="cpu")
    assert np.all(np.abs(sdr_zf - sinr_zf) < 0.5)
    assert np.mean(sdr_mrt - sinr_mrt) > 0.1
    assert np.all(sdr_zf > 5.0) and np.all(sinr_zf > sinr_mrt)


@pytest.mark.parametrize("chan", ["rayleigh"])
def test_mu_angle_overlap_matches_jax(chan):
    """Two users, the secondary swept over 13 points in chunks of 8: the
    correlation and both users' SDRs."""
    j, p = _cfgs(chan)
    key = jax.random.key(KEY)
    with jax.enable_x64(False):
        _, jc, js = jan.mu_angle_overlap_scan(j, key, n_points=12, n_snapshots=2,
                                              point_chunk=8)
        draws = pdr.as_torch(_rayleigh_only(pdr.scan_overlap(key, 12, 2, N_BITS, (8, 128)),
                                            chan, "fade", "main"))
    _, pc, ps = analysis.mu_angle_overlap_scan(p, draws, n_points=12, n_snapshots=2,
                                               point_chunk=8, device="cpu")
    assert ps.shape == (2, 13)
    np.testing.assert_allclose(pc, jc, atol=TOL[chan]["corr"])
    np.testing.assert_allclose(ps, js, atol=TOL[chan]["db"])
