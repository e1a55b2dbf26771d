"""The port's ops (mimo_ofdm_tpu_torch/ops) held against the JAX package's
on the same numpy inputs: bit-exact for bits and detection, rtol 1e-6 for
the float32 functions. Inputs go to JAX as explicit float32/complex64/int
arrays, since the suite runs JAX with x64 on."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.ops import bits as jbits, noise as jnoise, ofdm as jofdm
from mimo_ofdm_tpu.ops import pa as jpa, qam as jqam
from mimo_ofdm_tpu.models import channels as jchannels, geometry as jgeometry
from mimo_ofdm_tpu.models import precoding as jprecoding

from mimo_ofdm_tpu_torch.ops import bits, noise, ofdm, pa, qam
from mimo_ofdm_tpu_torch.models import channels, geometry, precoding

RTOL = 1e-6


def _c64(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


@pytest.mark.parametrize("bps", [2, 4, 6])
def test_bits_pack_unpack_count(bps):
    rng = np.random.default_rng(bps)
    b = rng.integers(0, 2, (3, 5, 12 * bps)).astype(np.int8)
    ints = bits.bits_to_ints(torch.from_numpy(b), bps)
    np.testing.assert_array_equal(ints.numpy(), np.asarray(jbits.bits_to_ints(b, bps)))
    back = bits.ints_to_bits(ints, bps)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbits.ints_to_bits(jnp.asarray(ints.numpy()), bps)))
    np.testing.assert_array_equal(back.numpy(), b)
    flip = b ^ (rng.random(b.shape) < 0.1).astype(np.int8)
    for axis in (None, -1):
        got = bits.count_bit_errors(torch.from_numpy(b), torch.from_numpy(flip), axis=axis)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jbits.count_bit_errors(b, flip, axis=axis)))


def test_random_payload_bits_fair_and_seeded():
    g = torch.Generator().manual_seed(1)
    b = bits.random_payload_bits(g, (4, 3000))
    assert b.dtype == torch.int8 and b.shape == (4, 3000)
    assert set(np.unique(b.numpy())) == {0, 1}
    assert abs(float(b.float().mean()) - 0.5) < 0.02
    b2 = bits.random_payload_bits(torch.Generator().manual_seed(1), (4, 3000))
    assert torch.equal(b, b2)


@pytest.mark.parametrize("m", [4, 16, 64, 256])
def test_qam_modulate_detect_demod(m):
    rng = np.random.default_rng(m)
    bps = int(np.log2(m))
    b = rng.integers(0, 2, (2, 64 * bps)).astype(np.int8)
    np.testing.assert_array_equal(qam.qam_constellation(m).numpy(),
                                  np.asarray(jqam.qam_constellation(m)))
    assert qam.avg_symbol_power(m) == jqam.avg_symbol_power(m)
    sym = qam.modulate_bits(torch.from_numpy(b), m)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jqam.modulate_bits(b, m)))
    # noisy symbols, including points beyond the grid edges
    y = sym.numpy() + _c64(rng, sym.shape, 0.6 * np.sqrt(m) / 4)
    for alpha in (1.0, 0.83):
        idx = qam.hard_detect_index(torch.from_numpy(y), m, alpha)
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jqam.hard_detect_index(y, m, np.float32(alpha))))
        np.testing.assert_array_equal(
            qam.demodulate_bits(torch.from_numpy(y), m, alpha).numpy(),
            np.asarray(jqam.demodulate_bits(y, m, np.float32(alpha))))
        ds, db = qam.detect_symbols_and_bits(torch.from_numpy(y), m, alpha)
        js, jb = jqam.detect_symbols_and_bits(y, m, np.float32(alpha))
        np.testing.assert_array_equal(db.numpy(), np.asarray(jb))
        np.testing.assert_allclose(ds.numpy(), np.asarray(js), rtol=RTOL)
    # noiseless symbols detect to the transmitted bits
    np.testing.assert_array_equal(qam.demodulate_bits(sym, m).numpy(), b)


@pytest.mark.parametrize("model", ["softlim", "rapp", "toi", "none"])
def test_apply_pa_planar(model):
    rng = np.random.default_rng(3)
    x = _c64(rng, (3, 256), 0.8)
    xr, xi = x.real.copy(), x.imag.copy()
    sat = np.array([[0.3], [0.9], [2.0]], np.float32)
    coeff = np.float32(0.07)
    got = pa.apply_pa_planar(torch.from_numpy(xr), torch.from_numpy(xi), model,
                             torch.from_numpy(sat), 1.1, coeff)
    ref = jpa.apply_pa_planar(xr, xi, model, sat, 1.1, coeff)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=1e-7)


def test_pa_scalars():
    ibo = np.array([-3.0, 0.0, 1.5, 4.0, 7.0], np.float32)
    np.testing.assert_allclose(pa.bussgang_alpha(torch.from_numpy(ibo)).numpy(),
                               np.asarray(jpa.bussgang_alpha(ibo)), rtol=RTOL)
    assert pa.bussgang_alpha(0.0).dtype == torch.float32
    for v in (0.0, 3.0):
        assert pa.ibo_to_sat_power(v, 10.5) == pytest.approx(
            float(jpa.ibo_to_sat_power(v, 10.5)), rel=1e-12)
        assert pa.toi_to_cubic_coeff(v, 10.5) == pytest.approx(
            float(jpa.toi_to_cubic_coeff(v, 10.5)), rel=1e-12)
    with pytest.raises(ValueError):
        pa.apply_pa_planar(torch.zeros(2), torch.zeros(2), "bogus")


@pytest.mark.parametrize("n_fft,n_sc", [(64, 32), (1024, 512), (4096, 2048)])
def test_map_extract_subcarriers(n_fft, n_sc):
    rng = np.random.default_rng(n_fft)
    d = _c64(rng, (2, n_sc))
    fd = ofdm.map_subcarriers(torch.from_numpy(d), n_fft)
    np.testing.assert_array_equal(fd.numpy(), np.asarray(jofdm.map_subcarriers(d, n_fft)))
    np.testing.assert_array_equal(ofdm.extract_subcarriers(fd, n_sc).numpy(), d)
    full = _c64(rng, (2, n_fft))
    np.testing.assert_array_equal(
        ofdm.extract_subcarriers(torch.from_numpy(full), n_sc).numpy(),
        np.asarray(jofdm.extract_subcarriers(full, n_sc)))
    np.testing.assert_array_equal(
        ofdm.fft_bin_frequencies(n_fft, 15e3, 3.5e9),
        np.asarray(jofdm.fft_bin_frequencies(n_fft, 15e3, 3.5e9)))


def test_awgn_with_injected_normals():
    """JAX's awgn draws its normals from a key; the port takes the same
    normals injected and must add the same noise."""
    rng = np.random.default_rng(4)
    sig = _c64(rng, (128,))
    key = jax.random.key(4)
    normals = np.array(jax.random.normal(key, (2, 128), jnp.float32))
    snr = np.float32(12.0)
    for pow_ in (1.0, 42.0):
        ref = jnoise.awgn(key, sig, snr, np.float32(pow_))
        got = noise.awgn(torch.from_numpy(sig), snr, np.float32(pow_),
                         noise.complex_normal(torch.from_numpy(normals)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)
    # batched: per-frame power [B] against normals [B, 2, n]
    sig_b = _c64(rng, (3, 128))
    normals_b = rng.standard_normal((3, 2, 128)).astype(np.float32)
    pow_b = np.array([1.0, 42.0, 3.5], np.float32)
    got = noise.awgn(torch.from_numpy(sig_b), snr, torch.from_numpy(pow_b),
                     noise.complex_normal(torch.from_numpy(normals_b)))
    for i in range(3):
        ref = sig_b[i] + (normals_b[i, 0] + 1j * normals_b[i, 1]).astype(np.complex64) \
            * np.float32(np.sqrt(0.5)) * np.sqrt(pow_b[i] / np.float32(10.0) ** (snr / 10))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=RTOL, atol=1e-6)
    z = noise.complex_normal(torch.randn(2, 20000, generator=torch.Generator().manual_seed(0)))
    assert z.dtype == torch.complex64 and z.shape == (20000,)
    assert abs(float((z.abs() ** 2).mean()) - 1.0) < 0.03


def test_geometry_channels_precoding():
    pos = geometry.ula_positions(16, 3.5e9, 0.5, cord_z=15.0)
    np.testing.assert_array_equal(pos, jgeometry.ula_positions(16, 3.5e9, 0.5, cord_z=15.0))
    np.testing.assert_array_equal(geometry.array_positions("linear", 8, 3.5e9, cord_z=15.0),
                                  jgeometry.array_positions("linear", 8, 3.5e9, cord_z=15.0))
    assert geometry.C_LIGHT == jgeometry.C_LIGHT
    tx = pos.astype(np.float32)
    rx = np.array([212.0, 212.0, 1.5], np.float32)
    freqs = (3.5e9 + 15e3 * np.arange(-8, 8)).astype(np.float32)
    d = channels._distances(torch.from_numpy(tx), torch.from_numpy(rx))
    np.testing.assert_allclose(d.numpy(), np.asarray(jchannels._distances(tx, rx)), rtol=RTOL)
    att = channels._fs_attenuation(d, torch.from_numpy(freqs))
    np.testing.assert_allclose(
        att.numpy(), np.asarray(jchannels._fs_attenuation(d.numpy(), freqs)), rtol=RTOL)
    rng = np.random.default_rng(6)
    h, x = _c64(rng, (16, 32)), _c64(rng, (2, 16, 32))
    np.testing.assert_allclose(
        channels.propagate(torch.from_numpy(h), torch.from_numpy(x)).numpy(),
        np.asarray(jchannels.propagate(h, x)), rtol=1e-5, atol=1e-6)
    vk = (rng.random(16) + 0.5).astype(np.float32)
    np.testing.assert_allclose(
        precoding.per_antenna_ibo_db(0.0, torch.from_numpy(vk), 32, 16).numpy(),
        np.asarray(jprecoding.per_antenna_ibo_db(0.0, vk, 32, 16)), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        precoding.per_antenna_alpha(0.0, torch.from_numpy(vk), 32, 16).numpy(),
        np.asarray(jprecoding.per_antenna_alpha(0.0, vk, 32, 16)), rtol=RTOL)
