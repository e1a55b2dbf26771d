"""The port's analysis module held against the JAX package's on the CPU:
the Welch PSD (also against scipy), the Bussgang split, the complexity
closed forms and geometry helpers (exact), the multi-user and time-domain
transmit, and the beampattern and radiation-pattern scans on JAX's own
draws (tests/torch_parity_draws.py), at n_fft 256, n_sc 128, 4-8 antennas,
at most 12 points and 4 snapshots. The correlation and SDR scans are in
tests/test_torch_analysis_scans.py, the multi-user scans in
tests/test_torch_analysis_mu.py.

Tolerances, each about 3x the gap measured on these inputs. Scan powers
and PSDs are compared relative to their peak. On Rayleigh both packages
run the same float32 operations and agree to float32 rounding (powers
3.4e-7 of the peak, asserted 1e-6; PSDs 9.1e-7, asserted 3e-6). On LOS
the compiled JAX scan folds the constant factors of the ~2e4 rad phase
(one ulp of it is ~2e-3 rad), so the port, which forms the phase in the
source order, agrees with JAX run op by op to 3e-7 but with the compiled
scan only to 5.8e-5 of the peak (asserted 2e-4). The PSDs at the first
user's angle agree to 2e-4 (asserted 6e-4); off the beams, at 78 deg, the
PSDs are sums of nearly cancelling terms and agree to 2.6e-3 (asserted
1e-2).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity_draws as pdr
from mimo_ofdm_tpu.models import analysis as jan
from mimo_ofdm_tpu.models import complexity as jcx
from mimo_ofdm_tpu.models import geometry as jgeo
from mimo_ofdm_tpu.models import transmit as jtx
from mimo_ofdm_tpu.utils import config as jcfg_mod

from mimo_ofdm_tpu_torch.models import analysis, complexity, geometry, transmit
from mimo_ofdm_tpu_torch.utils import config as pcfg_mod

N_BITS = 6 * 128
KEY = 3


def _cfgs(n_ant=8, ibo=0.0, chan="los", n_users=1):
    j = jcfg_mod.LinkConfig(
        modem=jcfg_mod.ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128, cp_len=16,
                                   n_users=n_users),
        array=jcfg_mod.ArrayConfig(n_elements=n_ant),
        channel=jcfg_mod.ChannelConfig(model=chan),
        pa=jcfg_mod.PaConfig(model="softlim", ibo_db=ibo))
    return j, pcfg_mod.config_from_dict(dataclasses.asdict(j))


def _peak_rel(a, b):
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_complexity_exact():
    for kw in (dict(), dict(m=16, n_u=600, n=1024)):
        assert complexity.std_rx_ops(**kw) == jcx.std_rx_ops(**kw)
        for it in (range(9), [0, 3]):
            for f, jf in ((complexity.cnc_ops, jcx.cnc_ops), (complexity.mcnc_ops, jcx.mcnc_ops)):
                for a, b in zip(f(it, **kw), jf(it, **kw)):
                    np.testing.assert_array_equal(a, b)
    for a, b in zip(complexity.mcnc_ops([2], k=16), jcx.mcnc_ops([2], k=16)):
        np.testing.assert_array_equal(a, b)


def test_geometry_helpers_exact():
    for r, n in ((300.0, 180), (12.5, 7)):
        np.testing.assert_array_equal(geometry.pts_on_circum(r, n), jgeo.pts_on_circum(r, n))
        np.testing.assert_array_equal(geometry.pts_on_semicircum(r, n),
                                      jgeo.pts_on_semicircum(r, n))
        for c in ((0.0, 0.0, 0.0), (1.0, -2.0, 15.0)):
            np.testing.assert_array_equal(geometry.pts_on_semisphere(r, n, c),
                                          jgeo.pts_on_semisphere(r, n, c))


def test_welch_matches_scipy_and_jax():
    """float64 input: scipy.signal.welch to 1e-10 (both float64); float32
    input: JAX's welch_psd in float32 to 1e-5 relative of the peak."""
    from scipy.signal import welch as sp_welch
    rng = np.random.default_rng(0)
    x = rng.normal(size=2048) + 1j * rng.normal(size=2048)
    f, p = analysis.welch_psd(torch.from_numpy(x), nfft=128, nperseg=64)
    f2, p2 = sp_welch(x, fs=128, nfft=128, nperseg=64, return_onesided=False)
    np.testing.assert_allclose(f.numpy(), f2)
    np.testing.assert_allclose(p.numpy(), p2, rtol=1e-10)
    x32 = x.astype(np.complex64)
    with jax.enable_x64(False):
        jf, jp = jan.welch_psd(jnp.asarray(x32), nfft=256, nperseg=64)
    pf, pp = analysis.welch_psd(torch.from_numpy(x32), nfft=256, nperseg=64)
    assert pp.dtype == torch.float32
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert _peak_rel(pp.numpy(), jp) < 1e-5


def test_bussgang_split_matches_jax_and_linear_part_vanishes():
    """The split equals JAX's; and for a clipped Gaussian the distortion is
    uncorrelated with the input (Bussgang's theorem)."""
    from mimo_ofdm_tpu_torch.ops import pa
    g = torch.Generator().manual_seed(1)
    x = torch.complex(torch.randn(4, 1 << 15, generator=g, dtype=torch.float64),
                      torch.randn(4, 1 << 15, generator=g, dtype=torch.float64)) * np.sqrt(0.5)
    y = pa.soft_limiter(x, pa.ibo_to_sat_power(0.0, 1.0))
    ak = torch.full((4,), float(pa.bussgang_alpha(0.0)), dtype=torch.float64)
    desired, dist = analysis.bussgang_split(y, x, ak)
    corr = (dist * torch.conj(x)).mean(-1)
    assert float(corr.abs().max()) < 5e-3
    jd, je = jan.bussgang_split(jnp.asarray(y.numpy()), jnp.asarray(x.numpy()),
                                jnp.asarray(ak.numpy()))
    np.testing.assert_allclose(desired.numpy(), np.asarray(jd), rtol=1e-12)
    np.testing.assert_allclose(dist.numpy(), np.asarray(je), rtol=1e-12, atol=1e-15)


def test_transmit_multi_user_and_time_domain_match_jax():
    """array_transmit_fd with a multi-user precoder (users summed or kept)
    and array_transmit_td with the cyclic prefix, float32, within 1e-5."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (3, 2, N_BITS)).astype(np.int8)
    v = (rng.normal(size=(4, 2, 128)) + 1j * rng.normal(size=(4, 2, 128))).astype(np.complex64)
    v1 = v[:, 0]
    kw = dict(constel_size=64, n_fft=256, pa_model="softlim", sat_power=0.05)
    with jax.enable_x64(False):
        j_sum = jtx.array_transmit_fd(jnp.asarray(bits), v=jnp.asarray(v), **kw)
        j_usr = jtx.array_transmit_fd(jnp.asarray(bits), v=jnp.asarray(v), sum_users=False,
                                      skip_dist=True, **kw)
        j_td = jtx.array_transmit_td(jnp.asarray(bits[:, 0]), cp_len=16, v=jnp.asarray(v1),
                                     **kw)
    tb = torch.from_numpy(bits)
    p_sum = transmit.array_transmit_fd(tb, v=torch.from_numpy(v), sum_users=True, **kw)
    p_usr = transmit.array_transmit_fd(tb, v=torch.from_numpy(v), sum_users=False,
                                       skip_dist=True, **kw)
    p_td = transmit.array_transmit_td(tb[:, 0], cp_len=16, v=torch.from_numpy(v1), **kw)
    assert p_sum.shape == (3, 4, 256) and p_usr.shape == (3, 2, 4, 256)
    assert p_td.shape == (3, 4, 256 + 16)
    for p, j in ((p_sum, j_sum), (p_usr, j_usr), (p_td, j_td)):
        assert _peak_rel(p.numpy(), np.asarray(j)) < 1e-5


@pytest.fixture(scope="module")
def beampattern_pair():
    j, p = _cfgs()
    key = jax.random.key(KEY)
    with jax.enable_x64(False):
        jr = jan.beampattern_scan(j, key, n_points=12, n_snapshots=4, point_chunk=8)
        draws = pdr.as_torch(analysis.ScanDraws(pdr.scan_snapshot_bits(key, 4, (N_BITS,))))
    pr = analysis.beampattern_scan(p, draws, n_points=12, n_snapshots=4, point_chunk=8,
                                   device="cpu")
    return jr, pr


def test_beampattern_scan_matches_jax(beampattern_pair):
    jr, pr = beampattern_pair
    np.testing.assert_array_equal(pr.angles_rad, jr.angles_rad)
    assert _peak_rel(pr.desired_pow, jr.desired_pow) < 2e-4
    assert _peak_rel(pr.distortion_pow, jr.distortion_pow) < 2e-4


def test_beampattern_physics(beampattern_pair):
    """The desired power peaks at the precoded angle (truncated index
    ``int(12/180*45) = 3``, i.e. -45 deg on the -90..90 grid), and under
    single-user MRT on LOS the distortion beamforms with the signal, so the
    SDR is nearly flat across angles."""
    _, pr = beampattern_pair
    assert int(np.argmax(pr.desired_pow)) == 3
    assert np.degrees(pr.angles_rad[3]) == pytest.approx(-45.0)
    assert pr.sdr_db.max() - pr.sdr_db.min() < 1.0


@pytest.fixture(scope="module")
def radiation_pairs():
    key = jax.random.key(KEY)
    out = {}
    for name, chan, angles in (("rayleigh", "rayleigh", None),
                               ("los_mu", "los", (45.0, 120.0))):
        j, p = _cfgs(chan=chan, ibo=3.0, n_users=1 if angles is None else 2)
        kw = dict(n_points=12, n_snapshots=4, snap_chunk=2, n_samp_per_seg=64,
                  precoding_angles_deg=angles)
        usr = () if angles is None else (2,)
        with jax.enable_x64(False):
            jr = jan.radiation_pattern(j, key, **kw)
            draws = pdr.as_torch(pdr.scan_radiation(
                key, 13, 4, (*usr, N_BITS), (8, 256) if chan == "rayleigh" else None))
        out[name] = (jr, analysis.radiation_pattern(p, draws, device="cpu", **kw))
    return out


# case -> (powers, {PSD angle: PSDs}), relative to the peak
RADIATION_TOL = {"rayleigh": (1e-6, {45.0: 3e-6, 78.0: 3e-6}),
                 "los_mu": (2e-4, {45.0: 6e-4, 78.0: 1e-2})}


@pytest.mark.parametrize("name", sorted(RADIATION_TOL))
def test_radiation_pattern_matches_jax(radiation_pairs, name):
    tol_pow, tol_psd = RADIATION_TOL[name]
    jr, pr = radiation_pairs[name]
    np.testing.assert_array_equal(pr.angles_deg, jr.angles_deg)
    assert _peak_rel(pr.desired_pow, jr.desired_pow) < tol_pow
    assert _peak_rel(pr.distortion_pow, jr.distortion_pow) < tol_pow
    assert set(pr.psd) == set(jr.psd) == {45.0, 78.0}
    for ang in jr.psd:
        (jf, jd, je), (pf, pd, pe) = jr.psd[ang], pr.psd[ang]
        np.testing.assert_array_equal(pf, jf)
        assert _peak_rel(pd, jd) < tol_psd[ang] and _peak_rel(pe, je) < tol_psd[ang]


def test_radiation_pattern_physics(radiation_pairs):
    """LOS (two users): the desired power peaks at a precoded angle, the
    distortion is positive everywhere, and at the first user's angle the
    desired PSD dominates the distortion's. Rayleigh: no spatial beam for
    IID fades, the peak within 10 dB of the median."""
    _, pr = radiation_pairs["los_mu"]
    assert int(np.argmax(pr.desired_pow)) in (3, 8)
    assert np.all(pr.distortion_pow > 0)
    for ang in (45.0, 78.0):
        f, p_des, p_dist = pr.psd[ang]
        assert f.shape == p_des.shape == p_dist.shape == (256,)
    f, p_des, p_dist = pr.psd[45.0]
    assert p_des.mean() > 10 * p_dist.mean()
    d = radiation_pairs["rayleigh"][1].desired_pow
    assert 10 * np.log10(d.max() / np.median(d)) < 10.0


def test_scans_draw_from_a_seed_and_need_a_device():
    """Without draws a scan takes its randoms from a generator seeded with
    ``seed``: the same seed gives the same result, another seed another.
    Without ``device`` it runs on the card, and raises where there is none."""
    _, p = _cfgs(chan="rayleigh")
    kw = dict(n_points=6, n_snapshots=2, snap_chunk=2, n_samp_per_seg=64, device="cpu")
    a = analysis.radiation_pattern(p, seed=1, **kw)
    b = analysis.radiation_pattern(p, seed=1, **kw)
    c = analysis.radiation_pattern(p, seed=2, **kw)
    np.testing.assert_array_equal(a.desired_pow, b.desired_pow)
    assert not np.array_equal(a.desired_pow, c.desired_pow)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            analysis.beampattern_scan(p, n_points=6, n_snapshots=2)
    with pytest.raises(ValueError, match="unsupported channel"):
        analysis.radiation_pattern(_cfgs(chan="rician")[1], **kw)
