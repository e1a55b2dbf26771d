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

import math

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


# --- the kernel's schedule, modelled on the CPU (fused_ifft_pa_fft_staged) ---

N_FFTS = [256, 512, 1024, 2048, 4096]


def _staged(xr, xi, sat, coeff=0.0, **kw):
    pr, pi = fused_pa.fused_ifft_pa_fft_staged(
        torch.from_numpy(xr), torch.from_numpy(xi), torch.as_tensor(sat),
        torch.as_tensor(coeff), **kw)
    return pr.numpy() + 1j * pi.numpy()


@pytest.mark.parametrize("n_fft,n_sc", [(4096, 2048), (1024, 512), (1024, 256)])
def test_staged_sc_matches_jax_planar_io(n_fft, n_sc):
    rng = np.random.default_rng(n_fft - n_sc)
    dr, di = _planes(rng, (2, 3, n_sc))
    sat = np.array([[0.2, 0.5, 1.3], [0.9, 0.31, 4.0]], np.float32)
    jr, ji = _jax_sc(dr, di, n_fft, "softlim", sat)
    got = _staged(dr, di, sat, pa_model="softlim", n_fft=n_fft, mode="sc")
    assert got.shape == (2, 3, n_sc)
    assert _rel(got, jr + 1j * ji) < 1e-5


@pytest.mark.parametrize("sat", [1.5, 1e6])
def test_staged_full_matches_pallas_kernel(interpret_pallas, sat):
    fp = interpret_pallas
    rng = np.random.default_rng(5)
    scale = 1.0 if sat < 1e3 else 0.01
    xr, xi = _planes(rng, (8, 4096), scale)
    ref = np.asarray(fp.fused_ifft_clip_fft(jnp.asarray(xr + 1j * xi), sat, tile=4))
    got = _staged(xr, xi, np.float32(sat), pa_model="softlim", n_fft=4096, mode="full")
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("n_fft", N_FFTS)
@pytest.mark.parametrize("mode,io_div", [("sc", 2), ("sc", 4), ("full", 1)])
def test_staged_matches_plain_every_size(n_fft, mode, io_div):
    """Every radix-r tail (r = 1, 2, 4, 8, 16) and both I/O maps, on a
    ragged [3, 5] batch of rows with per-row saturation powers."""
    rng = np.random.default_rng(n_fft + io_div)
    xr, xi = _planes(rng, (3, 5, n_fft // io_div))
    sat = rng.uniform(0.2, 2.0, (3, 5)).astype(np.float32)
    got = _staged(xr, xi, sat, pa_model="softlim", n_fft=n_fft, mode=mode)
    pr, pi = fused_pa.fused_ifft_pa_fft_plain(
        torch.from_numpy(xr), torch.from_numpy(xi), torch.from_numpy(sat),
        torch.zeros(3, 5), pa_model="softlim", n_fft=n_fft, mode=mode)
    assert _rel(got, pr.numpy() + 1j * pi.numpy()) < 1e-5


@pytest.mark.parametrize("model", ["rapp", "toi", "none"])
def test_staged_other_pa_models_match_jax(model):
    n_fft, n_sc = 2048, 1024
    rng = np.random.default_rng(22)
    dr, di = _planes(rng, (4, n_sc))
    sat = np.array([0.3, 0.6, 1.0, 2.0], np.float32)
    coeff = np.array([0.01, 0.05, 0.1, 0.2], np.float32)
    jr, ji = _jax_sc(dr, di, n_fft, model, sat, coeff)
    got = _staged(dr, di, sat, coeff, pa_model=model, n_fft=n_fft, mode="sc")
    assert _rel(got, jr + 1j * ji) < 1e-5


def _wavefronts(addrs):
    """Shared-memory wavefronts of one half-warp's 16 float2 accesses:
    the most distinct addresses on one 8-byte bank pair."""
    pairs = {}
    for a in addrs:
        pairs.setdefault(int(a) % 16, set()).add(int(a))
    return max(len(v) for v in pairs.values())


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_exchange_layout_is_bank_conflict_free(n_fft):
    """Each exchange writes every address of the row once, and for every
    register each half-warp (16 consecutive threads of one row) reads or
    writes 16 distinct bank pairs: one wavefront per access."""
    s = fused_pa.schedule(n_fft)
    tables = [s.e1_w, s.e1_r] + ([s.e2_w, s.e2_r] if s.radix > 1 else [])
    assert (s.e2_w is None) == (n_fft == 256)
    for e in tables:
        assert e.shape == (s.threads, fused_pa.POINTS)
        np.testing.assert_array_equal(np.sort(e.ravel()), np.arange(n_fft))
        for hw in range(0, s.threads, 16):
            for i in range(fused_pa.POINTS):
                assert _wavefronts(e[hw:hw + 16, i]) == 1, (n_fft, hw, i)
    if s.radix > 1:
        # exchange 2 needs only __syncwarp(): whoever wrote the addresses a
        # thread reads is in the same warp (rows start on 16-thread bounds)
        writer = np.empty(n_fft, int)
        writer[s.e2_w.ravel()] = np.repeat(np.arange(s.threads), fused_pa.POINTS)
        for t in range(s.threads):
            assert set(writer[s.e2_r[t]] // 32) == {t // 32}, (n_fft, t)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_twiddle_table_layout(n_fft):
    s = fused_pa.schedule(n_fft)
    tw = fused_pa.twiddle_table(n_fft)
    assert tw.dtype == np.float32 and tw.shape == (16 * s.threads + 16 * s.radix, 2)
    w = tw[:, 0] + 1j * tw[:, 1].astype(np.float64)
    t, k = 7 % s.threads, 13
    np.testing.assert_allclose(w[k * s.threads + t],
                               np.exp(-2j * np.pi * t * k / n_fft), atol=1e-7)
    a, c = s.radix - 1, 11
    np.testing.assert_allclose(w[16 * s.threads + c * s.radix + a],
                               np.exp(-2j * np.pi * 16 * a * c / n_fft), atol=1e-7)


def _split_radix_flops(n):
    """Split-radix operation count by its recurrence: a DIT stage of
    ``N / 4`` butterflies costs ``6 N - 16``. Each butterfly has 12
    additions and two twiddle products of 6 operations, except at k = 0
    (no products) and k = N / 8 (4 operations each)."""
    if n <= 4:
        return {1: 0, 2: 4, 4: 16}[n]
    return _split_radix_flops(n // 2) + 2 * _split_radix_flops(n // 4) + 6 * n - 16


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_flops_per_row(n_fft):
    pair = 2 * _split_radix_flops(n_fft)
    assert fused_pa.flops_per_row(n_fft, "full") == pair
    assert fused_pa.flops_per_row(n_fft, "sc") == pair - 3 * n_fft
    # below the nominal radix-2 count 5 N log2 N a transform
    assert pair < 2 * 5 * n_fft * math.log2(n_fft)


def test_wrapper_zero_rows():
    x = torch.zeros(0, 2048, dtype=torch.bfloat16)
    before = fused_pa.fused_ifft_pa_fft.launches
    pr, pi = fused_pa.fused_ifft_pa_fft(x, x, 1.0, n_fft=4096)
    assert pr.shape == pi.shape == (0, 2048) and pr.dtype == torch.bfloat16
    assert fused_pa.fused_ifft_pa_fft.launches == before


# --- the precoded layouts: the MRT precode as the chain's load ---------------

def _eager_precode_and_chain(sym, vr, vi, sat, coeff, **kw):
    """The transmitter's chain as it ran before the precoded layouts: the
    precode as plane operations of the storage dtype, then the planes'
    entry point."""
    st = vr.dtype
    sr = sym.real.to(st)[:, None, :]
    si = sym.imag.to(st)[:, None, :]
    pr = sr * vr - si * vi
    pi_ = sr * vi + si * vr
    return fused_pa.fused_ifft_pa_fft(pr, pi_, sat, coeff, n_fft=1024, mode="sc", **kw)


@pytest.mark.parametrize("model", ["softlim", "toi"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_precoded_entry_equals_eager_precode_and_plain_chain(storage, model):
    """At n_fft 1024 / 8 antennas the precoded entry point (its plain version
    here), with per-frame or per-row ``sat``/``cubic_coeff``, gives exactly
    the eager precode followed by the plain chain, and launches nothing on
    the CPU."""
    st = fused_pa.storage_dtype(storage)
    g = torch.Generator().manual_seed(17 + len(storage))
    sym = torch.complex(torch.randn(3, 512, generator=g), torch.randn(3, 512, generator=g))
    h = torch.randn(2, 3, 8, 512, generator=g)
    vr, vi = (h[0] * 0.3).to(st), (h[1] * 0.3).to(st)
    sat = (torch.rand(3, generator=g) + 0.2)[:, None]
    coeff = (torch.rand(3, generator=g) * 0.05)[:, None]
    want = _eager_precode_and_chain(sym, vr, vi, sat, coeff, pa_model=model)
    before = fused_pa.fused_ifft_pa_fft.launches
    got = fused_pa.fused_precoded_ifft_pa_fft(sym, vr, vi, sat, coeff, pa_model=model,
                                              n_fft=1024)
    per_row = fused_pa.fused_precoded_ifft_pa_fft(
        sym, vr, vi, sat.expand(3, 8).contiguous(), coeff.expand(3, 8).contiguous(),
        pa_model=model, n_fft=1024)
    assert fused_pa.fused_ifft_pa_fft.launches == before
    for out in (got, per_row):
        assert out[0].dtype == out[1].dtype == st and out[0].shape == (3, 8, 512)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_precoded_entry_rejects_what_the_kernel_does_not_take():
    sym = torch.zeros(2, 512, dtype=torch.complex64)
    v = torch.zeros(2, 8, 512)
    ok = dict(pa_model="softlim", n_fft=1024)
    bad = [((sym.to(torch.complex128), v, v), ok),                  # symbols not complex64
           ((sym, v.double(), v.double()), ok),                     # planes not f32 / bf16
           ((sym, v, v.bfloat16()), ok),                            # planes of two dtypes
           ((sym[:, :256], v, v), ok),                              # symbols' width
           ((sym[:1], v, v), ok),                                   # frames
           ((sym, v[0], v[0]), ok),                                 # no antenna axis
           ((sym, v, v), dict(ok, n_fft=512)),                      # n_sc not below n_fft
           ((sym, v, v), dict(ok, pa_model="bogus"))]
    for args, kw in bad:
        with pytest.raises(ValueError):
            fused_pa.fused_precoded_ifft_pa_fft(*args, 1.0, **kw)
    pr, pi = fused_pa.fused_precoded_ifft_pa_fft(sym[:0], v[:0], v[:0], 1.0, **ok)
    assert pr.shape == pi.shape == (0, 8, 512)
