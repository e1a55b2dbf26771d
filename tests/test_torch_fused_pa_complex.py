"""The kernel's interleaved complex64 entry point
(mimo_ofdm_tpu_torch/kernels/fused_pa.py::fused_ifft_pa_fft_complex) and
the complex-ended chain calls routed through it (ops/fused_chain.py), on
the CPU, where the wrappers run their plain versions:

* the complex entry gives the plane route's bits (``.real``/``.imag`` cast
  to the storage dtype, the plane entry, the result cast back to
  complex64), compared as integers, at both storages, in both modes, for
  every PA model; so do ``fused_ifft_clip_fft`` and the two complex-ended
  chain calls, for complex64 and for lazily conjugated and strided views;
* ``fused_ifft_clip_fft`` against the Pallas kernel
  ``mimo_ofdm_tpu/kernels/fused_pa.py::fused_ifft_clip_fft`` in interpret
  mode, within 1e-5 relative L2 (tests/test_torch_fused_pa.py's bound);
* the complex ``sc`` chain at bf16 storage against JAX's
  ``mxu_fft.fused_sc_ifft_pa_fft_planar`` at bf16 storage within 1e-2
  relative L2 (the -40 dB of bf16 storage, tests/test_mxu_fft.py:107-130;
  0.0085 measured: both round each pass's operand to bf16, at different
  places), and against JAX at float32 storage within 5e-3 (0.0048
  measured; 0.0024 when the port's bf16 layouts ran float32 passes);
* zero rows launch nothing, and complex128 keeps the plane route.

The same bits on the card, where the kernel's interleaved layout must
equal its plane layout, are held in tests/test_torch_cuda.py and in
chip_smoke.py's phase 3.
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

KERNEL = fused_pa.fused_ifft_pa_fft
STORAGES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bits(z: torch.Tensor) -> torch.Tensor:
    """complex64 as its int32 halves: equal only if every bit is."""
    return torch.view_as_real(z.resolve_conj().contiguous()).view(torch.int32)


def _complex(rng, shape, scale=1.0) -> torch.Tensor:
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale
    return torch.from_numpy(x.astype(np.complex64))


def _plane_route(x, sat, coeff=0.0, *, storage="float32", **kw):
    """What the complex-ended calls ran before they had the complex entry:
    planes in the storage dtype, the plane entry, complex64 out."""
    st = STORAGES[storage]
    outr, outi = KERNEL(x.real.to(st).contiguous(), x.imag.to(st).contiguous(), sat,
                        coeff, **kw)
    return torch.complex(outr.to(torch.float32), outi.to(torch.float32))


@pytest.mark.parametrize("model", ["softlim", "rapp", "toi", "none"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sc", "full"])
@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_complex_entry_equals_plane_entry(n_fft, mode, storage, model):
    rng = np.random.default_rng(n_fft + len(mode) + len(storage) + len(model))
    n_io = n_fft // 2 if mode == "sc" else n_fft
    x = _complex(rng, (2, 2, n_io))
    sat = torch.from_numpy(rng.uniform(0.2, 2.0, (2, 2)).astype(np.float32))
    coeff = torch.from_numpy(rng.uniform(0.0, 0.1, (2, 2)).astype(np.float32))
    kw = dict(pa_model=model, n_fft=n_fft, mode=mode)
    before = KERNEL.launches
    got = fused_pa.fused_ifft_pa_fft_complex(x, sat, coeff, storage=storage, **kw)
    assert KERNEL.launches == before                # the CPU runs the plain version
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(_plane_route(x, sat, coeff, storage=storage, **kw)))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_chain_calls_take_the_complex_entry(monkeypatch, storage):
    """Both complex-ended chain calls hand complex64 to the complex entry
    and return the plane route's bits."""
    rng = np.random.default_rng(3)
    seen = []
    entry = fused_chain.fused_ifft_pa_fft_complex

    def spy(x, *a, **k):
        seen.append((x.dtype, k["mode"], k["storage"]))
        return entry(x, *a, **k)

    monkeypatch.setattr(fused_chain, "fused_ifft_pa_fft_complex", spy)
    sat = torch.tensor([0.3, 0.9, 1.4])
    d = _complex(rng, (3, 512))
    got = fused_chain.fused_sc_ifft_pa_fft_planar(d, 1024, pa_model="softlim", sat=sat,
                                                  storage=storage)
    want = _plane_route(d, sat, storage=storage, pa_model="softlim", n_fft=1024, mode="sc")
    assert torch.equal(_bits(got), _bits(want))
    f = _complex(rng, (3, 1024))
    got = fused_chain.fused_ifft_pa_fft_planar(f, pa_model="rapp", sat=sat, storage=storage)
    want = _plane_route(f, sat, storage=storage, pa_model="rapp", n_fft=1024, mode="full")
    assert torch.equal(_bits(got), _bits(want))
    assert seen == [(torch.complex64, "sc", storage), (torch.complex64, "full", storage)]


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
def test_fused_ifft_clip_fft_matches_pallas_kernel(interpret_pallas, sat):
    rng = np.random.default_rng(11)
    x = _complex(rng, (8, 4096), 1.0 if sat < 1e3 else 0.01)
    ref = np.asarray(interpret_pallas.fused_ifft_clip_fft(
        jnp.asarray(x.numpy(), jnp.complex64), sat, tile=4))
    got = fused_pa.fused_ifft_clip_fft(x, sat)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) < 1e-5
    want = _plane_route(x, sat, pa_model="softlim", n_fft=4096, mode="full")
    assert torch.equal(_bits(got), _bits(want))


def _jax_sc(d, n_fft, model, sat, coeff, storage):
    sat_b = jnp.asarray(sat, jnp.float32)[..., None, None]
    coeff_b = jnp.asarray(coeff, jnp.float32)[..., None, None]

    def pa_fn(pr, pi):
        return jpa.apply_pa_planar(pr, pi, model, sat_b, 1.1, coeff_b)

    return np.asarray(jax.jit(lambda v: mxu_fft.fused_sc_ifft_pa_fft_planar(
        v, pa_fn, n_fft, storage=storage))(jnp.asarray(d, jnp.complex64)))


@pytest.mark.parametrize("model", ["softlim", "toi"])
@pytest.mark.parametrize("n_fft,n_sc", [(4096, 2048), (1024, 512), (1024, 256)])
def test_sc_chain_bf16_matches_jax(n_fft, n_sc, model):
    rng = np.random.default_rng(n_fft + n_sc)
    d = _complex(rng, (2, 3, n_sc))
    sat = np.array([[0.2, 0.5, 1.3], [0.9, 0.31, 4.0]], np.float32)
    coeff = np.full((2, 3), 0.05, np.float32)
    got = fused_chain.fused_sc_ifft_pa_fft_planar(
        d, n_fft, pa_model=model, sat=torch.from_numpy(sat),
        cubic_coeff=torch.from_numpy(coeff), storage="bfloat16").numpy()
    assert _rel(got, _jax_sc(d.numpy(), n_fft, model, sat, coeff, "bfloat16")) < 1e-2
    assert _rel(got, _jax_sc(d.numpy(), n_fft, model, sat, coeff, "float32")) < 5e-3


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_conjugated_and_strided_views(storage):
    """A lazily conjugated view and a strided view give the bits of their
    contiguous copies."""
    rng = np.random.default_rng(5)
    kw = dict(pa_model="softlim", n_fft=1024, mode="sc", storage=storage)
    x = _complex(rng, (4, 512))
    conj = x.conj()
    assert conj.is_conj()
    got = fused_pa.fused_ifft_pa_fft_complex(conj, 0.6, **kw)
    want = fused_pa.fused_ifft_pa_fft_complex(conj.resolve_conj(), 0.6, **kw)
    assert torch.equal(_bits(got), _bits(want))
    wide = _complex(rng, (512, 8))
    strided = wide.T[::2]                            # [4, 512], strides (2, 8)
    assert not strided.is_contiguous()
    got = fused_pa.fused_ifft_pa_fft_complex(strided, 0.6, **kw)
    want = fused_pa.fused_ifft_pa_fft_complex(strided.contiguous(), 0.6, **kw)
    assert torch.equal(_bits(got), _bits(want))


def test_zero_rows_launch_nothing():
    x = torch.zeros(0, 2048, dtype=torch.complex64)
    before = KERNEL.launches
    out = fused_pa.fused_ifft_pa_fft_complex(x, 1.0, pa_model="softlim", n_fft=4096,
                                             mode="sc", storage="bfloat16")
    assert out.shape == (0, 2048) and out.dtype == torch.complex64
    out = fused_chain.fused_ifft_pa_fft_planar(torch.zeros(3, 0, 1024, dtype=torch.complex64),
                                               pa_model="softlim", sat=1.0)
    assert out.shape == (3, 0, 1024)
    assert KERNEL.launches == before


def test_complex128_keeps_the_plane_route(monkeypatch):
    """complex128 raises at the complex entry, and the chain calls take it
    through float32 or bf16 planes, rounding float64 once."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 512)) + 1j * rng.standard_normal((2, 512)))
    with pytest.raises(ValueError, match="complex64"):
        fused_pa.fused_ifft_pa_fft_complex(x, 1.0, pa_model="softlim", n_fft=1024, mode="sc")

    def refuse(*a, **k):
        raise AssertionError("complex128 reached the complex entry")

    monkeypatch.setattr(fused_chain, "fused_ifft_pa_fft_complex", refuse)
    for storage, st in STORAGES.items():
        got = fused_chain.fused_sc_ifft_pa_fft_planar(x, 1024, pa_model="softlim", sat=0.5,
                                                      storage=storage)
        outr, outi = KERNEL(x.real.to(st), x.imag.to(st), 0.5, pa_model="softlim",
                            n_fft=1024, mode="sc")
        assert got.dtype == torch.complex64
        assert torch.equal(_bits(got), _bits(torch.complex(outr.float(), outi.float())))


def test_complex_entry_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 512, dtype=torch.complex64)
    kw = dict(pa_model="softlim", n_fft=1024, mode="sc")
    with pytest.raises(ValueError, match="storage"):
        fused_pa.fused_ifft_pa_fft_complex(x, 1.0, storage="float16", **kw)
    with pytest.raises(ValueError, match="PA model"):
        fused_pa.fused_ifft_pa_fft_complex(x, 1.0, **{**kw, "pa_model": "bogus"})
    with pytest.raises(ValueError, match="full mode"):
        fused_pa.fused_ifft_pa_fft_complex(x, 1.0, **{**kw, "mode": "full"})
    with pytest.raises(ValueError, match="complex64"):
        fused_pa.fused_ifft_pa_fft_complex(x.real.contiguous(), 1.0, **kw)
