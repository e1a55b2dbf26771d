"""The port's component API held against the JAX package on the same numpy
inputs: Gray coding, hard symbol detection and the O(M) argmin detector
(exact), AWGN at a fixed dBm power on JAX's normals (1e-6), the OFDM
modem with a cyclic prefix (relative L2 1e-6, round trip against JAX's own
round trip) and the full-band AGC, single-user and multi-user (relative
L2 1e-6 a field, the unused bins exactly 1). JAX runs with x64 off on
complex64/float32 inputs, as the frames do."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import agc as jagc
from mimo_ofdm_tpu.models import precoding as jprec
from mimo_ofdm_tpu.ops import bits as jbits, noise as jnoise, ofdm as jofdm
from mimo_ofdm_tpu.ops import qam as jqam

from mimo_ofdm_tpu_torch.models import agc
from mimo_ofdm_tpu_torch.ops import bits, noise, ofdm, qam

REL = 1e-6


def _c64(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_gray_encode_matches_jax():
    x = np.arange(4096, dtype=np.int32)
    got = bits.gray_encode(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbits.gray_encode(jnp.asarray(x))))
    # neighbours differ in one bit
    assert set(np.unique(np.bitwise_count(got.numpy()[1:] ^ got.numpy()[:-1]))) == {1}


@pytest.mark.parametrize("m", [16, 64])
@pytest.mark.parametrize("alpha", [1.0, 0.8])
def test_hard_detect_symbols_matches_jax(m, alpha):
    rng = np.random.default_rng(m)
    y = _c64(rng, (3, 500), scale=np.sqrt(m) / 2)
    with jax.enable_x64(False):
        ref = np.asarray(jqam.hard_detect_symbols(jnp.asarray(y), m, alpha))
    got = qam.hard_detect_symbols(torch.from_numpy(y), m, alpha)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), ref)
    # the points are alpha times the constellation's
    pts = qam.qam_constellation(m).numpy() * np.float32(alpha)
    assert np.isin(got.numpy(), pts).all()


@pytest.mark.parametrize("m", [4, 16, 64])
def test_hard_detect_index_argmin_matches_jax_off_ties(m):
    """Random points away from the decision boundaries (the two nearest
    points at least 1e-3 apart in squared distance): the argmin detector
    equals JAX's and the O(1) quantizer."""
    rng = np.random.default_rng(m + 1)
    const = qam.qam_constellation(m)
    y = _c64(rng, (2000,), scale=np.sqrt(m) / 2)
    d2 = np.sort(np.abs(y[:, None].astype(np.complex128) - const.numpy()) ** 2, axis=-1)
    y = y[d2[:, 1] - d2[:, 0] > 1e-3]
    with jax.enable_x64(False):
        ref = np.asarray(jqam.hard_detect_index_argmin(jnp.asarray(y),
                                                       jqam.qam_constellation(m)))
    got = qam.hard_detect_index_argmin(torch.from_numpy(y), const)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(),
                                  qam.hard_detect_index(torch.from_numpy(y), m).numpy())
    # any constellation: an 8-PSK
    psk = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
    z = _c64(rng, (300,))
    with jax.enable_x64(False):
        ref = np.asarray(jqam.hard_detect_index_argmin(jnp.asarray(z), jnp.asarray(psk)))
    np.testing.assert_array_equal(
        qam.hard_detect_index_argmin(torch.from_numpy(z), torch.from_numpy(psk)).numpy(), ref)


def test_awgn_fixed_power_on_jax_normals():
    rng = np.random.default_rng(3)
    sig = _c64(rng, (4, 256))
    key = jax.random.key(3)
    with jax.enable_x64(False):
        normals = np.array(jax.random.normal(key, (2, 4, 256), jnp.float32))
        for dbm in (-30.0, 10.0):
            ref = np.asarray(jnoise.awgn_fixed_power(key, jnp.asarray(sig), np.float32(dbm)))
            unit = noise.complex_normal(torch.from_numpy(normals).movedim(0, -2))
            got = noise.awgn_fixed_power(torch.from_numpy(sig), dbm, unit)
            assert got.dtype == torch.complex64
            assert _rel(got.numpy() - sig, ref - sig) < REL
    # per-frame powers broadcast over the samples
    dbm_b = torch.tensor([-10.0, 0.0, 3.0, 20.0])
    unit = torch.complex(torch.ones(4, 256), torch.zeros(4, 256))
    got = noise.awgn_fixed_power(torch.zeros(4, 256, dtype=torch.complex64), dbm_b, unit)
    np.testing.assert_allclose(got.real.numpy()[:, 0],
                               np.sqrt(1e-3 * 10 ** (dbm_b.numpy() / 10)), rtol=REL)


@pytest.mark.parametrize("n_fft,n_sc,cp_len", [(256, 128, 16), (1024, 512, 0),
                                               (1024, 512, 128)])
def test_ofdm_modem_matches_jax(n_fft, n_sc, cp_len):
    rng = np.random.default_rng(n_fft + cp_len)
    sym = _c64(rng, (2, 3, n_sc))
    with jax.enable_x64(False):
        j_td = jofdm.ofdm_modulate(jnp.asarray(sym), n_fft, cp_len)
        j_back = np.asarray(jofdm.ofdm_demodulate(j_td, n_sc, cp_len))
        j_fd = np.asarray(jofdm.td_to_fd(jnp.asarray(sym)))
        j_ifd = np.asarray(jofdm.fd_to_td(jnp.asarray(sym)))
    td = ofdm.ofdm_modulate(torch.from_numpy(sym), n_fft, cp_len)
    assert td.shape == (2, 3, n_fft + cp_len) and td.dtype == torch.complex64
    assert _rel(td.numpy(), np.asarray(j_td)) < REL
    back = ofdm.ofdm_demodulate(td, n_sc, cp_len)
    assert _rel(back.numpy(), j_back) < REL
    assert _rel(back.numpy(), sym) < REL
    # the prefix is the frame's tail, and stripping it is exact
    np.testing.assert_array_equal(td.numpy()[..., :cp_len], td.numpy()[..., n_fft:])
    body = ofdm.remove_cyclic_prefix(td, cp_len)
    np.testing.assert_array_equal(ofdm.add_cyclic_prefix(body, cp_len).numpy(), td.numpy())
    np.testing.assert_array_equal(np.asarray(jofdm.remove_cyclic_prefix(td.numpy(), cp_len)),
                                  body.numpy())
    assert _rel(ofdm.td_to_fd(torch.from_numpy(sym)).numpy(), j_fd) < REL
    assert _rel(ofdm.fd_to_td(torch.from_numpy(sym)).numpy(), j_ifd) < REL
    assert (ofdm.ofdm_avg_sample_power(42.0, n_fft, n_sc)
            == jofdm.ofdm_avg_sample_power(42.0, n_fft, n_sc))


FIELDS_SC = ("hk_vk_agc_nfft", "ak_hk_vk_agc_nfft")
SCALARS = ("hk_vk_noise_scaler", "ak_hk_vk_noise_scaler", "ak_vect")


def _check_agc(got, ref, n_fft, n_sc):
    for name in FIELDS_SC + SCALARS:
        assert _rel(getattr(got, name).numpy(), getattr(ref, name)) < REL, name
    h = n_sc // 2
    for name in FIELDS_SC:
        vec = getattr(got, name).numpy()
        assert vec.shape[-1] == n_fft
        unused = np.r_[0, h + 1:n_fft - h]
        np.testing.assert_array_equal(vec[..., unused], np.ones_like(vec[..., unused]))


@pytest.mark.parametrize("n_fft,n_sc", [(256, 128), (1024, 512)])
def test_compute_agc_single_user_matches_jax(n_fft, n_sc):
    rng = np.random.default_rng(n_sc)
    h = _c64(rng, (2, 8, n_sc))                      # two frames
    with jax.enable_x64(False):
        v = np.array(jprec.mrt_precoder(jnp.asarray(h)))
        refs = [jagc.compute_agc(jnp.asarray(h[b]), jnp.asarray(v[b]), 1.5, 8, n_fft)
                for b in range(2)]
    got = agc.compute_agc(torch.from_numpy(h), torch.from_numpy(v), 1.5, 8, n_fft)
    assert isinstance(got, agc.AgcState)
    for b in range(2):
        _check_agc(type(got)(*(f[b] for f in got)), refs[b], n_fft, n_sc)


@pytest.mark.parametrize("usr_idx", [0, 1])
def test_compute_agc_multi_user_matches_jax(usr_idx):
    n_fft, n_sc = 256, 128
    rng = np.random.default_rng(7 + usr_idx)
    h = _c64(rng, (2, 8, n_sc))                      # [n_usr, n_ant, n_sc]
    with jax.enable_x64(False):
        v = np.array(jprec.mu_mrt_precoder(jnp.asarray(h)))     # [n_ant, n_usr, n_sc]
        ref = jagc.compute_agc(jnp.asarray(h[usr_idx]), jnp.asarray(v), 0.0, 8, n_fft,
                               usr_idx=usr_idx)
    got = agc.compute_agc(torch.from_numpy(h[usr_idx]), torch.from_numpy(v), 0.0, 8, n_fft,
                          usr_idx=usr_idx)
    _check_agc(got, ref, n_fft, n_sc)
    # the data bins are the subcarrier-domain state's
    sc = agc.compute_agc_sc(torch.from_numpy(h[usr_idx]), torch.from_numpy(v), 0.0, 8,
                            usr_idx=usr_idx)
    np.testing.assert_array_equal(
        ofdm.extract_subcarriers(got.ak_hk_vk_agc_nfft, n_sc).numpy(),
        sc.ak_hk_vk_agc_sc.numpy())
