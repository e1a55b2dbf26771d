"""The fused IFFT -> PA -> FFT entry points of the port
(mimo_ofdm_tpu_torch/kernels/fused_pa.py, ops/fused_chain.py) held against
the JAX package on the CPU, where the wrapper runs its plain version:

* ``sc`` mode against ``ops/mxu_fft.py::fused_sc_ifft_pa_fft_planar_io`` at
  float32 storage, relative error below 1e-5 (the JAX package's own
  threshold, tests/test_mxu_fft.py:140-156);
* ``full`` mode against the Pallas kernel
  ``kernels/fused_pa.py::fused_ifft_clip_fft`` run in interpret mode, as
  tests/test_kernels.py runs it, below 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.ops import mxu_fft
from mimo_ofdm_tpu.ops import pa as jpa

from mimo_ofdm_tpu_torch.kernels import fused_pa
from mimo_ofdm_tpu_torch.ops import fused_chain


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _planes(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) * scale).astype(np.float32),
            (rng.standard_normal(shape) * scale).astype(np.float32))


def _jax_sc(dr, di, n_fft, model, sat, coeff=0.0):
    """JAX's planar-I/O chain with per-row PA parameters broadcast over the
    digit-swapped [.., n2, n1] sample planes."""
    sat_b = jnp.asarray(sat, jnp.float32)[..., None, None]
    coeff_b = jnp.asarray(coeff, jnp.float32)
    if coeff_b.ndim:
        coeff_b = coeff_b[..., None, None]

    def pa_fn(pr, pi):
        return jpa.apply_pa_planar(pr, pi, model, sat_b, 1.1, coeff_b)

    out = jax.jit(lambda a, b: mxu_fft.fused_sc_ifft_pa_fft_planar_io(
        a, b, pa_fn, n_fft, storage="float32"))(dr, di)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("n_fft,n_sc", [(4096, 2048), (1024, 512), (1024, 256)])
def test_sc_mode_matches_jax_planar_io(n_fft, n_sc):
    rng = np.random.default_rng(n_fft + n_sc)
    dr, di = _planes(rng, (2, 3, n_sc))
    sat = np.array([[0.2, 0.5, 1.3], [0.9, 0.31, 4.0]], np.float32)
    jr, ji = _jax_sc(dr, di, n_fft, "softlim", sat)
    before = fused_pa.fused_ifft_pa_fft.launches
    pr, pi = fused_chain.fused_sc_ifft_pa_fft_planar_io(
        torch.from_numpy(dr), torch.from_numpy(di), n_fft, pa_model="softlim",
        sat=torch.from_numpy(sat), storage="float32")
    assert fused_pa.fused_ifft_pa_fft.launches == before    # CPU: plain version
    assert pr.dtype == torch.float32 and pr.shape == (2, 3, n_sc)
    got = pr.numpy() + 1j * pi.numpy()
    assert _rel(got, jr + 1j * ji) < 1e-5


@pytest.mark.parametrize("model", ["rapp", "toi", "none"])
def test_sc_mode_other_pa_models(model):
    n_fft, n_sc = 1024, 512
    rng = np.random.default_rng(21)
    dr, di = _planes(rng, (4, n_sc))
    sat = np.array([0.3, 0.6, 1.0, 2.0], np.float32)
    coeff = np.array([0.01, 0.05, 0.1, 0.2], np.float32)
    jr, ji = _jax_sc(dr, di, n_fft, model, sat, coeff)
    pr, pi = fused_chain.fused_sc_ifft_pa_fft_planar_io(
        torch.from_numpy(dr), torch.from_numpy(di), n_fft, pa_model=model,
        sat=torch.from_numpy(sat), cubic_coeff=torch.from_numpy(coeff))
    assert _rel(pr.numpy() + 1j * pi.numpy(), jr + 1j * ji) < 1e-5


def test_sc_mode_straggler_only():
    """Energy only in the straggler bin n_sc/2 (the last data subcarrier)
    round-trips through the identity PA (tests/test_mxu_fft.py:159-170)."""
    n_fft, n_sc = 1024, 512
    d = np.zeros(n_sc, np.complex64)
    d[-1] = 2.0 - 1.0j
    got = fused_chain.fused_sc_ifft_pa_fft_planar(
        torch.from_numpy(d), n_fft, pa_model="none", sat=1.0)
    jr, ji = _jax_sc(d.real.copy(), d.imag.copy(), n_fft, "none", 1.0)
    np.testing.assert_allclose(got.numpy(), jr + 1j * ji, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), d, atol=1e-5)


def test_bf16_storage_keeps_dtype_and_accuracy():
    n_fft, n_sc = 1024, 512
    rng = np.random.default_rng(8)
    dr, di = _planes(rng, (3, n_sc))
    sat = np.float32(0.4)
    jr, ji = _jax_sc(dr, di, n_fft, "softlim", np.full(3, sat))
    pr, pi = fused_chain.fused_sc_ifft_pa_fft_planar_io(
        torch.from_numpy(dr), torch.from_numpy(di), n_fft, pa_model="softlim",
        sat=float(sat), storage="bfloat16")
    assert pr.dtype == pi.dtype == torch.bfloat16
    # bf16 planes at both ends: ~2^-8 relative per value
    assert _rel(pr.float().numpy() + 1j * pi.float().numpy(), jr + 1j * ji) < 1e-2


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


@pytest.mark.parametrize("sat", [1.5, 1e6])
def test_full_mode_matches_pallas_kernel(interpret_pallas, sat):
    fp = interpret_pallas
    rng = np.random.default_rng(0)
    scale = 1.0 if sat < 1e3 else 0.01
    xr, xi = _planes(rng, (8, 4096), scale)
    ref = np.asarray(fp.fused_ifft_clip_fft(jnp.asarray(xr + 1j * xi), sat, tile=4))
    pr, pi = fused_pa.fused_ifft_pa_fft(
        torch.from_numpy(xr), torch.from_numpy(xi), sat, pa_model="softlim",
        n_fft=4096, mode="full")
    got = pr.numpy() + 1j * pi.numpy()
    assert _rel(got, ref) < 1e-5
    if sat > 1e3:   # nothing clips: identity
        np.testing.assert_allclose(got, xr + 1j * xi, atol=1e-5)
    cplx = fused_chain.fused_ifft_pa_fft_planar(
        torch.from_numpy(xr + 1j * xi), pa_model="softlim", sat=sat)
    assert _rel(cplx.numpy(), ref) < 1e-5


def test_full_mode_matches_jax_planar_full_band():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 1024)) + 1j * rng.standard_normal((2, 1024))
         ).astype(np.complex64)
    sat = np.array([0.4, 1.1], np.float32)
    ref = jax.jit(lambda v: mxu_fft.fused_ifft_pa_fft_planar(
        v, lambda a, b: jpa.apply_pa_planar(a, b, "softlim", sat[:, None, None]),
        storage="float32"))(x)
    got = fused_chain.fused_ifft_pa_fft_planar(torch.from_numpy(x), pa_model="softlim",
                                               sat=torch.from_numpy(sat))
    assert _rel(got.numpy(), np.asarray(ref)) < 1e-5


@pytest.mark.parametrize("n_fft,n_io,mode", [(128, 64, "sc"), (8192, 4096, "sc"),
                                             (1000, 500, "sc"), (1024, 1024, "sc"),
                                             (1024, 511, "sc"), (1024, 512, "full"),
                                             (1024, 512, "bogus")])
def test_wrapper_rejects_unsupported_shapes(n_fft, n_io, mode):
    x = torch.zeros(2, n_io)
    with pytest.raises(ValueError):
        fused_pa.fused_ifft_pa_fft(x, x, 1.0, pa_model="softlim", n_fft=n_fft, mode=mode)


def test_wrapper_rejects_bad_planes():
    x = torch.zeros(2, 512)
    with pytest.raises(ValueError):
        fused_pa.fused_ifft_pa_fft(x, x.double(), 1.0, n_fft=1024)
    with pytest.raises(ValueError):
        fused_pa.fused_ifft_pa_fft(x.double(), x.double(), 1.0, n_fft=1024)
    with pytest.raises(ValueError):
        fused_pa.fused_ifft_pa_fft(x, x, 1.0, pa_model="bogus", n_fft=1024)
