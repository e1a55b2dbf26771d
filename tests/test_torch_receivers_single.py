"""The single-call receivers on full-band frames and ``fused_ifft_clip_fft``
held against the JAX package on the CPU.

* ``standard_receive``, ``cnc_receive`` and ``mcnc_receive`` on the same
  equalized complex64 frames: every pass's hard bits equal JAX's;
  ``cnc_iterate`` / ``cnc_iterate_soft`` with ``detect_alpha=0.8``: bits
  equal, corrected signals within relative L2 1e-6; the CNC replica with
  ``toi_db``: 1e-6.
* The slice as a whole: each package builds the frames with its own
  component API (``array_transmit_fd`` -> ``propagate`` -> AWGN on JAX's
  normals -> ``compute_agc`` -> ``equalize``) and receives them; the
  frames agree within 1e-5 and the bits are equal.
* ``fused_ifft_clip_fft``: the port's entry point (its plain version on
  the CPU) against the Pallas kernel in interpret mode, 1e-5; other
  lengths raise.

JAX runs jitted, with x64 off, on complex64 inputs.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import agc as jagc, channels as jchannels
from mimo_ofdm_tpu.models import precoding as jprec, receivers as jrec
from mimo_ofdm_tpu.models import transmit as jtransmit
from mimo_ofdm_tpu.ops import ofdm as jofdm, qam as jqam

from mimo_ofdm_tpu_torch.kernels import fused_pa
from mimo_ofdm_tpu_torch.models import agc, channels, precoding, receivers, transmit
from mimo_ofdm_tpu_torch.ops import noise, ofdm, qam

M = 64
N_ANT = 8
SNR_DB = 25.0
IBO_DB = 0.0
SHAPES = [(256, 128, 3), (1024, 512, 8)]       # n_fft, n_sc, n_iters


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _draws(n_fft, n_sc, batch, seed):
    """Bits ``[B, n_bits]``, a Rayleigh-like full-band channel ``[B, n_ant,
    n_fft]`` and JAX's unit normals of the noise ``[B, 2, n_fft]``."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, n_sc * 6)).astype(np.int8)
    h = ((rng.standard_normal((batch, N_ANT, n_fft))
          + 1j * rng.standard_normal((batch, N_ANT, n_fft))) / np.sqrt(2)).astype(np.complex64)
    with jax.enable_x64(False):
        normals = np.array(jax.random.normal(jax.random.key(seed), (batch, 2, n_fft),
                                             jnp.float32))
    return bits, h, normals


def _jax_frame(bits, h_fd, normals, n_fft, n_sc):
    """One distorted frame through JAX's component API: the equalized
    full-band frame, the precoder, the saturation power and the AGC."""
    avg_sym_pow = jqam.avg_symbol_power(M)
    h_sc = jofdm.extract_subcarriers(h_fd, n_sc)
    v = jprec.mrt_precoder(h_sc)
    sat = jprec.pa_sat_power(IBO_DB, avg_sym_pow * n_sc / n_fft, v)
    st = jagc.compute_agc(h_sc, v, IBO_DB, N_ANT, n_fft)
    fd = jtransmit.array_transmit_fd(bits, constel_size=M, n_fft=n_fft, v=v, sat_power=sat)
    rx = jchannels.propagate(h_fd, fd)
    noise_pow = avg_sym_pow * st.ak_hk_vk_noise_scaler / 10.0 ** (SNR_DB / 10.0)
    unit = (normals[0] + 1j * normals[1]).astype(jnp.complex64) * jnp.sqrt(
        jnp.asarray(0.5, jnp.float32))
    rx = rx + unit * jnp.sqrt(noise_pow).astype(jnp.complex64)
    return jrec.equalize(rx, st.ak_hk_vk_agc_nfft), v, sat, st.ak_hk_vk_agc_nfft


@functools.lru_cache(maxsize=None)
def _frames(n_fft, n_sc, seed=0, batch=3):
    bits, h, normals = _draws(n_fft, n_sc, batch, seed)
    with jax.enable_x64(False):
        fn = jax.jit(jax.vmap(functools.partial(_jax_frame, n_fft=n_fft, n_sc=n_sc)))
        rx, v, sat, agc_n = (np.array(a) for a in fn(bits, h, normals))
    return dict(bits=bits, h=h, normals=normals, rx=rx, v=v, sat=sat, agc=agc_n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_fft,n_sc,_", SHAPES)
def test_standard_receive_matches_jax(n_fft, n_sc, _):
    f = _frames(n_fft, n_sc)
    for alpha in (1.0, 0.8):
        with jax.enable_x64(False):
            ref = np.asarray(jax.jit(jrec.standard_receive, static_argnums=(1, 2))(
                f["rx"], n_sc, M, alpha))
            ref_sc = np.asarray(jrec.standard_receive_sc(
                jofdm.extract_subcarriers(f["rx"], n_sc), M, alpha))
        got = receivers.standard_receive(_t(f["rx"]), n_sc, M, alpha)
        assert got.dtype == torch.int8 and got.shape == f["bits"].shape
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(receivers.standard_receive_sc(
            ofdm.extract_subcarriers(_t(f["rx"]), n_sc), M, alpha).numpy(), ref_sc)
    ber = float(np.mean(got.numpy() != f["bits"]))
    assert 0.0 < ber < 0.5


@pytest.mark.parametrize("n_fft,n_sc,n_iters", SHAPES)
def test_cnc_receive_matches_jax(n_fft, n_sc, n_iters):
    f = _frames(n_fft, n_sc)
    with jax.enable_x64(False):
        ref = np.asarray(jax.jit(functools.partial(
            jrec.cnc_receive, n_iters=n_iters, constel_size=M, n_sc=n_sc,
            ibo_db=IBO_DB))(f["rx"]))
    got = receivers.cnc_receive(_t(f["rx"]), n_iters, constel_size=M, n_sc=n_sc,
                                ibo_db=IBO_DB)
    assert got.shape == (n_iters + 1, *f["bits"].shape)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_fft,n_sc,n_iters", SHAPES)
def test_mcnc_receive_matches_jax(n_fft, n_sc, n_iters):
    f = _frames(n_fft, n_sc)

    def one(rx, h, v, agc_n, sat):
        return jrec.mcnc_receive(rx, n_iters, h, v, agc_n, constel_size=M, n_sc=n_sc,
                                 sat_power=sat)
    with jax.enable_x64(False):
        ref = np.asarray(jax.jit(jax.vmap(one, out_axes=1))(
            f["rx"], f["h"], f["v"], f["agc"], f["sat"]))
    got = receivers.mcnc_receive(_t(f["rx"]), n_iters, _t(f["h"]), _t(f["v"]), _t(f["agc"]),
                                 constel_size=M, n_sc=n_sc, sat_power=_t(f["sat"])[:, None])
    np.testing.assert_array_equal(got.numpy(), ref)
    err = (got.numpy() != f["bits"]).sum(-1).sum(-1)
    assert err[-1] <= err[0]            # MCNC cancels the clipping noise


def test_cnc_iterate_detect_alpha_matches_jax():
    n_fft, n_sc, n_iters = 256, 128, 3
    f = _frames(n_fft, n_sc)
    rx_sc = jofdm.extract_subcarriers(f["rx"], n_sc)
    with jax.enable_x64(False):
        replica = jrec.make_cnc_replica(M, n_fft, n_sc, IBO_DB)
        bits_ref, sym_ref = jax.jit(lambda x: jrec.cnc_iterate(
            x, n_iters, M, replica, detect_alpha=0.8))(rx_sc)
        corr_ref = jax.jit(lambda x: jrec.cnc_iterate_soft(
            x, n_iters, M, replica, detect_alpha=0.8))(rx_sc)
    port_replica = receivers.make_cnc_replica(M, n_fft, n_sc, IBO_DB)
    bits, sym = receivers.cnc_iterate(_t(rx_sc), n_iters, M, port_replica, detect_alpha=0.8)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_ref))
    np.testing.assert_array_equal(sym.numpy(), np.asarray(sym_ref))
    corr = receivers.cnc_iterate_soft(_t(rx_sc), n_iters, M, port_replica, detect_alpha=0.8)
    assert _rel(corr.numpy(), np.asarray(corr_ref)) < 1e-6
    # the default detects against the unit grid, as before
    plain, _ = receivers.cnc_iterate(_t(rx_sc), n_iters, M, port_replica)
    assert not torch.equal(plain, bits)


@pytest.mark.parametrize("toi_db", [None, 18.0])
def test_cnc_replica_toi_db_matches_jax(toi_db):
    n_fft, n_sc = 256, 128
    rng = np.random.default_rng(5)
    det = np.array(jqam.qam_constellation(M))[rng.integers(0, M, (2, n_sc))]
    with jax.enable_x64(False):
        ref = np.asarray(jrec.make_cnc_replica(M, n_fft, n_sc, 12.0, "toi", toi_db=toi_db)(
            jnp.asarray(det)))
    got = receivers.make_cnc_replica(M, n_fft, n_sc, 12.0, "toi", toi_db=toi_db)(_t(det))
    assert _rel(got.numpy(), ref) < 1e-6
    if toi_db is not None:               # another intercept point, another replica
        same_ibo = receivers.make_cnc_replica(M, n_fft, n_sc, 12.0, "toi")(_t(det))
        assert _rel(same_ibo.numpy(), ref) > 1e-3


def _port_frame(f, n_fft, n_sc):
    """The port's component API on the same bits, channel and normals."""
    avg_sym_pow = qam.avg_symbol_power(M)
    h_fd = _t(f["h"])
    h_sc = ofdm.extract_subcarriers(h_fd, n_sc)
    v = precoding.mrt_precoder(h_sc)
    sat = precoding.pa_sat_power(IBO_DB, avg_sym_pow * n_sc / n_fft, v)[:, None]
    st = agc.compute_agc(h_sc, v, IBO_DB, N_ANT, n_fft)
    fd = transmit.array_transmit_fd(_t(f["bits"]), constel_size=M, n_fft=n_fft, v=v,
                                    sat_power=sat)
    rx = noise.awgn(channels.propagate(h_fd, fd), SNR_DB,
                    avg_sym_pow * st.ak_hk_vk_noise_scaler,
                    noise.complex_normal(_t(f["normals"])))
    return receivers.equalize(rx, st.ak_hk_vk_agc_nfft), h_fd, v, sat, st


@pytest.mark.parametrize("n_fft,n_sc,n_iters", SHAPES)
def test_component_frame_matches_jax(n_fft, n_sc, n_iters):
    """The slice as a whole: frames built and received by each package."""
    f = _frames(n_fft, n_sc)
    rx, h_fd, v, sat, st = _port_frame(f, n_fft, n_sc)
    assert _rel(rx.numpy(), f["rx"]) < 1e-5
    assert _rel(st.ak_hk_vk_agc_nfft.numpy(), f["agc"]) < 1e-6
    np.testing.assert_array_equal(receivers.standard_receive(rx, n_sc, M).numpy(),
                                  receivers.standard_receive(_t(f["rx"]), n_sc, M).numpy())
    kw = dict(constel_size=M, n_sc=n_sc)
    for got, ref in (
            (receivers.cnc_receive(rx, n_iters, ibo_db=IBO_DB, **kw),
             receivers.cnc_receive(_t(f["rx"]), n_iters, ibo_db=IBO_DB, **kw)),
            (receivers.mcnc_receive(rx, n_iters, h_fd, v, st.ak_hk_vk_agc_nfft,
                                    sat_power=sat, **kw),
             receivers.mcnc_receive(_t(f["rx"]), n_iters, _t(f["h"]), _t(f["v"]),
                                    _t(f["agc"]), sat_power=_t(f["sat"])[:, None], **kw))):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.fixture
def interpret_pallas(monkeypatch):
    import jax.experimental.pallas as pl
    import mimo_ofdm_tpu.kernels.fused_pa as fp
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(fp.pl, "pallas_call", patched)
    return fp


@pytest.mark.parametrize("sat", [1.5, torch.tensor(0.7)])
def test_fused_ifft_clip_fft_matches_pallas_kernel(interpret_pallas, sat):
    rng = np.random.default_rng(1)
    x = ((rng.standard_normal((2, 4, 4096)) + 1j * rng.standard_normal((2, 4, 4096)))
         .astype(np.complex64))
    ref = np.asarray(interpret_pallas.fused_ifft_clip_fft(jnp.asarray(x), float(sat), tile=4))
    before = fused_pa.fused_ifft_pa_fft.launches
    got = fused_pa.fused_ifft_clip_fft(torch.from_numpy(x), sat)
    assert fused_pa.fused_ifft_pa_fft.launches == before       # CPU: the plain version
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert _rel(got.numpy(), ref) < 1e-5
    assert _rel(got.numpy(), x) > 1e-2                           # it clips


def test_fused_ifft_clip_fft_rejects_other_inputs():
    for n in (1024, 2048, 8192):
        with pytest.raises(ValueError, match="4096"):
            fused_pa.fused_ifft_clip_fft(torch.zeros(2, n, dtype=torch.complex64), 1.0)
    with pytest.raises(ValueError, match="complex64"):
        fused_pa.fused_ifft_clip_fft(torch.zeros(2, 4096, dtype=torch.complex128), 1.0)
    with pytest.raises(ValueError, match="scalar"):
        fused_pa.fused_ifft_clip_fft(torch.zeros(2, 4096, dtype=torch.complex64),
                                     torch.ones(2))
