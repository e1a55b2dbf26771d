"""The fused_pa CUDA kernel against its plain PyTorch version, on the card,
alone and inside the single-user, multi-user and coded frames; the LDPC
decoder and the transport encoder on the card against the CPU.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips when
there is no card (decided at run time, never at import, so that every test
worker collects the same tests). On a machine with an H100 (``--noconftest``
skips ``tests/conftest.py``, which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py -q
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from mimo_ofdm_tpu_torch import kernels
from mimo_ofdm_tpu_torch.kernels import antenna_combine, fused_pa
from mimo_ofdm_tpu_torch.models import link
from mimo_ofdm_tpu_torch.utils import config

pytestmark = pytest.mark.gpu

KERNEL = fused_pa.fused_ifft_pa_fft


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _routed(plain):
    """Inside the ``with`` block: every kernel's plain version where
    ``plain``, else the kernels."""
    return kernels.plain_versions() if plain else contextlib.nullcontext()


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).to(torch.complex128))
                 / torch.linalg.vector_norm(b.to(torch.complex128)))


def _both(xr, xi, sat, coeff=0.0, **kw):
    """Kernel output, then the plain version on the same CUDA inputs."""
    before = KERNEL.launches
    kr, ki = KERNEL(xr, xi, sat, coeff, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    rows = xr.shape[:-1]
    sat_t = torch.broadcast_to(torch.as_tensor(sat, dtype=torch.float32, device=xr.device), rows)
    coeff_t = torch.broadcast_to(torch.as_tensor(coeff, dtype=torch.float32, device=xr.device), rows)
    pr, pi = fused_pa.fused_ifft_pa_fft_plain(xr, xi, sat_t, coeff_t, **kw)
    return torch.complex(kr.float(), ki.float()), torch.complex(pr.float(), pi.float())


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_sc_mode_f32_all_sizes(cuda, n_fft):
    g = torch.Generator(device=cuda).manual_seed(n_fft)
    n_sc = n_fft // 2
    xr = torch.randn(24, n_sc, generator=g, device=cuda)
    xi = torch.randn(24, n_sc, generator=g, device=cuda)
    sat = torch.rand(24, generator=g, device=cuda) + 0.1
    k, p = _both(xr, xi, sat, pa_model="softlim", n_fft=n_fft, mode="sc")
    assert _rel(k, p) < 1e-5


def test_full_mode_f32(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    xr = torch.randn(256, 4096, generator=g, device=cuda)
    xi = torch.randn(256, 4096, generator=g, device=cuda)
    k, p = _both(xr, xi, 1.5, pa_model="softlim", n_fft=4096, mode="full")
    assert _rel(k, p) < 1e-5
    k, _ = _both(xr * 0.01, xi * 0.01, 1e6, pa_model="softlim", n_fft=4096, mode="full")
    assert _rel(k, torch.complex(xr, xi) * 0.01) < 1e-5


def test_sc_mode_bf16(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    xr = torch.randn(64 * 8, 2048, generator=g, device=cuda).bfloat16()
    xi = torch.randn(64 * 8, 2048, generator=g, device=cuda).bfloat16()
    k, p = _both(xr, xi, 0.5, pa_model="softlim", n_fft=4096, mode="sc")
    assert _rel(k, p) < 1e-2


@pytest.mark.parametrize("model", ["none", "rapp", "toi"])
def test_other_pa_models(cuda, model):
    g = torch.Generator(device=cuda).manual_seed(3)
    xr = torch.randn(32, 512, generator=g, device=cuda)
    xi = torch.randn(32, 512, generator=g, device=cuda)
    coeff = torch.rand(32, generator=g, device=cuda) * 0.1
    k, p = _both(xr, xi, 0.7, coeff, pa_model=model, n_fft=1024, mode="sc")
    assert _rel(k, p) < 1e-5


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048])
@pytest.mark.parametrize("mode", ["sc", "full"])
def test_ragged_last_block(cuda, n_fft, mode):
    """37 rows: not a multiple of the 256 / (n_fft / 16) rows of a block."""
    g = torch.Generator(device=cuda).manual_seed(n_fft + len(mode))
    n_io = n_fft // 2 if mode == "sc" else n_fft
    assert 37 % (256 // (n_fft // 16))
    xr = torch.randn(37, n_io, generator=g, device=cuda)
    xi = torch.randn(37, n_io, generator=g, device=cuda)
    sat = torch.rand(37, generator=g, device=cuda) + 0.1
    k, p = _both(xr, xi, sat, pa_model="softlim", n_fft=n_fft, mode=mode)
    assert _rel(k, p) < 1e-5


@pytest.mark.parametrize("n_fft", [256, 4096])
def test_one_row(cuda, n_fft):
    g = torch.Generator(device=cuda).manual_seed(5)
    xr = torch.randn(1, n_fft // 2, generator=g, device=cuda)
    xi = torch.randn(1, n_fft // 2, generator=g, device=cuda)
    k, p = _both(xr, xi, 0.4, pa_model="softlim", n_fft=n_fft, mode="sc")
    assert _rel(k, p) < 1e-5


def test_zero_rows_launch_nothing(cuda):
    x = torch.zeros(0, 2048, device=cuda)
    before = KERNEL.launches
    kr, ki = KERNEL(x, x, 1.0, n_fft=4096)
    assert kr.shape == ki.shape == (0, 2048) and kr.is_cuda
    assert KERNEL.launches == before


def test_sc_mode_narrow_band(cuda):
    """n_sc = 256 of n_fft = 1024: most bins are guard band."""
    g = torch.Generator(device=cuda).manual_seed(6)
    xr = torch.randn(40, 256, generator=g, device=cuda)
    xi = torch.randn(40, 256, generator=g, device=cuda)
    k, p = _both(xr, xi, 0.3, pa_model="softlim", n_fft=1024, mode="sc")
    assert _rel(k, p) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_tx_shape(cuda, dtype, tol):
    """The main path's TX launch: 128 frames x 64 antennas, n_sc 2048."""
    g = torch.Generator(device=cuda).manual_seed(7)
    xr = torch.randn(8192, 2048, generator=g, device=cuda).to(dtype)
    xi = torch.randn(8192, 2048, generator=g, device=cuda).to(dtype)
    sat = torch.rand(8192, generator=g, device=cuda) + 0.2
    k, p = _both(xr, xi, sat, pa_model="softlim", n_fft=4096, mode="sc")
    assert _rel(k, p) < tol


# --- the bf16 layouts on the tensor cores --------------------------------------

# relative L2 of the kernel against the bf16 plain version: the same passes
# and roundings read under 1e-3 on an H100, and the earlier float32-pass
# arithmetic with bf16 loads and stores reads 4.6e-3 against it
BF16_PLAIN_TOL = 2e-3

def _bf16_plain(xr, xi, sat, coeff=0.0, **kw):
    """The bf16 layouts' plain version (the tensor-core arithmetic) on the
    same CUDA inputs."""
    rows = xr.shape[:-1]
    sat_t = torch.broadcast_to(torch.as_tensor(sat, dtype=torch.float32, device=xr.device), rows)
    coeff_t = torch.broadcast_to(torch.as_tensor(coeff, dtype=torch.float32, device=xr.device),
                                 rows)
    pr, pi = fused_pa.fused_ifft_pa_fft_bf16(xr, xi, sat_t, coeff_t, **kw)
    return torch.complex(pr.float(), pi.float())


@pytest.mark.parametrize("rows", [96, 37, 1])
@pytest.mark.parametrize("mode", ["sc", "full"])
@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_bf16_planes_against_both_plain_versions(cuda, n_fft, mode, rows):
    """The tensor-core kernel on bf16 planes within 2e-3 relative L2 of the
    bf16 plain version (the same passes and roundings) and within 1e-2 of
    the exact plain version, every size, both modes, a ragged last block
    and one row."""
    g = torch.Generator(device=cuda).manual_seed(n_fft * 7 + len(mode) + rows)
    n_io = n_fft // 2 if mode == "sc" else n_fft
    xr = torch.randn(rows, n_io, generator=g, device=cuda).bfloat16()
    xi = torch.randn(rows, n_io, generator=g, device=cuda).bfloat16()
    sat = torch.rand(rows, generator=g, device=cuda) * 2 + 0.2
    kw = dict(pa_model="softlim", n_fft=n_fft, mode=mode)
    k, exact = _both(xr, xi, sat, **kw)
    assert KERNEL.launches_by_layout["planes_bf16"] > 0
    assert _rel(k, _bf16_plain(xr, xi, sat, **kw)) < BF16_PLAIN_TOL
    assert _rel(k, exact) < 1e-2


@pytest.mark.parametrize("model", ["none", "rapp", "toi"])
def test_bf16_other_pa_models(cuda, model):
    g = torch.Generator(device=cuda).manual_seed(31)
    xr = torch.randn(64, 2048, generator=g, device=cuda).bfloat16()
    xi = torch.randn(64, 2048, generator=g, device=cuda).bfloat16()
    sat = torch.rand(64, generator=g, device=cuda) + 0.2
    coeff = torch.rand(64, generator=g, device=cuda) * 0.05
    kw = dict(pa_model=model, n_fft=4096, mode="sc")
    k, exact = _both(xr, xi, sat, coeff, **kw)
    assert _rel(k, _bf16_plain(xr, xi, sat, coeff, **kw)) < BF16_PLAIN_TOL
    assert _rel(k, exact) < 1e-2


def test_bf16_under_plain_versions_runs_the_bf16_plain_version(cuda):
    g = torch.Generator(device=cuda).manual_seed(32)
    xr = torch.randn(16, 512, generator=g, device=cuda).bfloat16()
    xi = torch.randn(16, 512, generator=g, device=cuda).bfloat16()
    kw = dict(pa_model="softlim", n_fft=1024, mode="sc")
    with kernels.plain_versions():
        before = KERNEL.launches
        pr, pi = KERNEL(xr, xi, 0.5, **kw)
        assert KERNEL.launches == before
    assert torch.equal(torch.complex(pr.float(), pi.float()), _bf16_plain(xr, xi, 0.5, **kw))


def test_bf16_instantiations_run_on_the_tensor_cores(cuda):
    """Every bf16 instantiation is the tensor-core kernel, its SASS holds
    HMMA, it does not spill and 2 of its blocks fit an SM; no f32 one
    uses the tensor cores."""
    for r in fused_pa.kernel_resources():
        if r["layout"].endswith("bf16"):
            assert r["tensor_cores"] and r["sass_mma"] > 0, r
            assert r["local_bytes"] == 0 and r["blocks_per_sm"] >= 2, r
        else:
            assert not r["tensor_cores"] and r["sass_mma"] == 0, r


# Registers a thread of each instantiation of the layouts that the precoded
# ones came beside, at n_fft 256, 512, 1024, 2048, 4096, as the runtime read
# them before those came (NVIDIA H100 80GB HBM3, the card machine's nvcc).
# Every one has no static shared memory and the dynamic shared memory of
# its kernel: 32 KB on the tensor cores (bf16), 64 KB on the CUDA cores.
EXISTING_REGISTERS = {
    ("interleaved_bf16", "full"): (80, 118, 123, 123, 120),
    ("interleaved_bf16", "sc"): (117, 126, 126, 128, 124),
    ("interleaved_f32", "full"): (96, 115, 115, 96, 113),
    ("interleaved_f32", "sc"): (112, 127, 128, 123, 125),
    ("planes_bf16", "full"): (81, 118, 122, 122, 120),
    ("planes_bf16", "sc"): (118, 126, 124, 124, 126),
    ("planes_f32", "full"): (96, 116, 124, 96, 112),
    ("planes_f32", "sc"): (112, 127, 128, 123, 125),
}


def test_existing_layouts_keep_their_resources(cuda):
    """The precoded layouts leave what the other layouts' callers run as it
    was: the same registers and shared memory in every instantiation of
    the planes and interleaved layouts."""
    got = {}
    for r in fused_pa.kernel_resources():
        if r["layout"].startswith("precoded"):
            assert r["mode"] == "sc", r
            continue
        smem = 32768 if r["layout"].endswith("bf16") else 65536
        assert (r["static_smem_bytes"], r["dynamic_smem_bytes"]) == (0, smem), r
        got.setdefault((r["layout"], r["mode"]), []).append((r["n_fft"], r["registers"]))
    assert {k: tuple(n for _, n in sorted(v)) for k, v in got.items()} == EXISTING_REGISTERS


def test_rejects_non_contiguous(cuda):
    x = torch.zeros(4, 1024, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        KERNEL(x, x, 1.0, n_fft=1024)


# --- the interleaved complex64 layout (fused_ifft_pa_fft_complex) -------------

STORAGES = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 1e-2)}


def _bits(z):
    """complex64 as its int32 halves: equal only if every bit is."""
    return torch.view_as_real(z.resolve_conj().contiguous()).view(torch.int32)


def _layouts(x, sat, coeff=0.0, storage="float32", **kw):
    """The interleaved layout's result, the plane layout's on the same
    complex64 input (the planes cast to the storage dtype and the result
    cast back, as the complex-ended chain calls did before they had the
    interleaved layout) and the plain version's; one launch of each
    layout."""
    st, _ = STORAGES[storage]
    interleaved = f"interleaved_{'bf16' if st == torch.bfloat16 else 'f32'}"
    before, by_layout = KERNEL.launches, KERNEL.launches_by_layout[interleaved]
    got = fused_pa.fused_ifft_pa_fft_complex(x, sat, coeff, storage=storage, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert KERNEL.launches_by_layout[interleaved] == by_layout + 1
    xr, xi = x.real.to(st).contiguous(), x.imag.to(st).contiguous()
    kr, ki = KERNEL(xr, xi, sat, coeff, **kw)
    rows = x.shape[:-1]
    sat_t = torch.broadcast_to(torch.as_tensor(sat, dtype=torch.float32, device=x.device), rows)
    coeff_t = torch.broadcast_to(torch.as_tensor(coeff, dtype=torch.float32, device=x.device),
                                 rows)
    pr, pi = fused_pa.fused_ifft_pa_fft_plain(xr, xi, sat_t, coeff_t, **kw)
    return (got, torch.complex(kr.float(), ki.float()),
            torch.complex(pr.float(), pi.float()))


def _cplx(g, rows, n, device):
    return torch.complex(torch.randn(rows, n, generator=g, device=device),
                         torch.randn(rows, n, generator=g, device=device))


@pytest.mark.parametrize("model", ["softlim", "rapp", "toi", "none"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sc", "full"])
@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_interleaved_layout_equals_planes(cuda, n_fft, mode, storage, model):
    g = torch.Generator(device=cuda).manual_seed(n_fft + len(mode) + len(storage))
    n_io = n_fft // 2 if mode == "sc" else n_fft
    x = _cplx(g, 24, n_io, cuda)
    sat = torch.rand(24, generator=g, device=cuda) + 0.1
    coeff = torch.rand(24, generator=g, device=cuda) * 0.1
    got, planes, plain = _layouts(x, sat, coeff, storage, pa_model=model, n_fft=n_fft,
                                  mode=mode)
    assert torch.equal(_bits(got), _bits(planes))
    assert _rel(got, plain) < STORAGES[storage][1]
    if storage == "bfloat16":
        xr, xi = x.real.bfloat16(), x.imag.bfloat16()
        assert _rel(got, _bf16_plain(xr, xi, sat, coeff, pa_model=model, n_fft=n_fft,
                                     mode=mode)) < BF16_PLAIN_TOL


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sc", "full"])
@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048])
def test_interleaved_ragged_last_block(cuda, n_fft, mode, storage):
    """37 rows: not a multiple of the 256 / (n_fft / 16) rows of a block."""
    g = torch.Generator(device=cuda).manual_seed(n_fft * 3 + len(mode))
    n_io = n_fft // 2 if mode == "sc" else n_fft
    x = _cplx(g, 37, n_io, cuda)
    sat = torch.rand(37, generator=g, device=cuda) + 0.1
    got, planes, plain = _layouts(x, sat, 0.0, storage, pa_model="softlim", n_fft=n_fft,
                                  mode=mode)
    assert torch.equal(_bits(got), _bits(planes))
    assert _rel(got, plain) < STORAGES[storage][1]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_interleaved_one_row_and_zero_rows(cuda, storage):
    g = torch.Generator(device=cuda).manual_seed(17)
    for mode, n_io in (("sc", 2048), ("full", 4096)):
        got, planes, _ = _layouts(_cplx(g, 1, n_io, cuda), 0.4, 0.0, storage,
                                  pa_model="softlim", n_fft=4096, mode=mode)
        assert torch.equal(_bits(got), _bits(planes))
    before = KERNEL.launches
    out = fused_pa.fused_ifft_pa_fft_complex(torch.zeros(0, 2048, dtype=torch.complex64,
                                                         device=cuda), 1.0,
                                             pa_model="softlim", n_fft=4096, mode="sc",
                                             storage=storage)
    assert out.shape == (0, 2048) and out.is_cuda and out.dtype == torch.complex64
    assert KERNEL.launches == before


def test_interleaved_views(cuda):
    """A lazily conjugated view and a strided view give the bits of their
    contiguous copies, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(18)
    kw = dict(pa_model="softlim", n_fft=1024, mode="sc", storage="bfloat16")
    x = _cplx(g, 64, 512, cuda)
    strided = _cplx(g, 512, 128, cuda).T[::2]
    for view in (x.conj(), strided):
        before = KERNEL.launches
        got = fused_pa.fused_ifft_pa_fft_complex(view, 0.6, **kw)
        assert KERNEL.launches == before + 1
        want = fused_pa.fused_ifft_pa_fft_complex(view.resolve_conj().contiguous(), 0.6, **kw)
        assert torch.equal(_bits(got), _bits(want))


# --- the precoded layouts (fused_precoded_ifft_pa_fft) ------------------------

PRECODED_STORAGES = {"float32": (torch.float32, torch.int32),
                     "bfloat16": (torch.bfloat16, torch.int16)}


def _precoded_and_eager(sym, vr, vi, sat, coeff, **kw):
    """The precoded layout's output planes, then the transmitter's chain as
    it ran before them on the same inputs: the precode as eager plane
    operations of the storage dtype, then the planes' layout; one launch of
    each. Both as their raw bits."""
    st, bits = PRECODED_STORAGES["bfloat16" if vr.dtype == torch.bfloat16 else "float32"]
    layout = f"precoded_{'bf16' if st == torch.bfloat16 else 'f32'}"
    before, by_layout = KERNEL.launches, KERNEL.launches_by_layout[layout]
    got = fused_pa.fused_precoded_ifft_pa_fft(sym, vr, vi, sat, coeff, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert KERNEL.launches_by_layout[layout] == by_layout + 1
    s = sym.resolve_conj().contiguous()
    sr, si = s.real.to(st)[..., None, :], s.imag.to(st)[..., None, :]
    want = KERNEL(sr * vr - si * vi, sr * vi + si * vr, sat, coeff, mode="sc", **kw)
    return [t.view(bits) for t in got], [t.view(bits) for t in want]


def _precoder(g, frames, n_ant, n_sc, st, device):
    v = torch.randn(2, frames, n_ant, n_sc, generator=g, device=device) / math.sqrt(n_ant)
    return v[0].to(st), v[1].to(st)


@pytest.mark.parametrize("frames,n_ant", [(6, 64), (37, 8), (5, 3), (9, 1)])
@pytest.mark.parametrize("n_fft,n_sc", [(4096, 2048), (1024, 512)])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_precoded_layout_equals_eager_precode_and_kernel(cuda, storage, n_fft, n_sc,
                                                         frames, n_ant):
    """Bit for bit the eager precode followed by the planes' layout, in both
    storages: 64 and 8 antennas, 15 rows (a ragged last block wherever a
    block holds more than one row) and one row a frame."""
    st, _ = PRECODED_STORAGES[storage]
    g = torch.Generator(device=cuda).manual_seed(n_fft + frames * n_ant + len(storage))
    sym = _cplx(g, frames, n_sc, cuda)
    vr, vi = _precoder(g, frames, n_ant, n_sc, st, cuda)
    sat = (torch.rand(frames, 1, generator=g, device=cuda) + 0.2) * 0.5
    got, want = _precoded_and_eager(sym, vr, vi, sat, 0.0, pa_model="softlim", n_fft=n_fft)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("model", ["none", "rapp", "toi"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_precoded_layout_other_pa_models(cuda, storage, model):
    st, _ = PRECODED_STORAGES[storage]
    g = torch.Generator(device=cuda).manual_seed(41 + len(model))
    sym = _cplx(g, 4, 1024, cuda)
    vr, vi = _precoder(g, 4, 16, 1024, st, cuda)
    sat = torch.rand(4, 16, generator=g, device=cuda) * 0.2 + 0.05
    coeff = torch.rand(4, 16, generator=g, device=cuda) * 0.5
    got, want = _precoded_and_eager(sym, vr, vi, sat, coeff, pa_model=model, n_fft=2048)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_precoded_layout_takes_symbol_views(cuda, storage):
    """A strided and a lazily conjugated view of the symbols give the bits
    of their contiguous copies; zero frames launch nothing."""
    st, _ = PRECODED_STORAGES[storage]
    g = torch.Generator(device=cuda).manual_seed(43)
    vr, vi = _precoder(g, 8, 8, 512, st, cuda)
    strided = _cplx(g, 512, 16, cuda).T[::2]
    assert not strided.is_contiguous()
    for view in (strided, _cplx(g, 8, 512, cuda).conj()):
        got, want = _precoded_and_eager(view, vr, vi, 0.3, 0.0, pa_model="softlim",
                                        n_fft=1024)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    before = KERNEL.launches
    out = fused_pa.fused_precoded_ifft_pa_fft(strided[:0], vr[:0], vi[:0], 0.3, n_fft=1024)
    assert out[0].shape == (0, 8, 512) and KERNEL.launches == before


# --- the precoded_mu layouts (fused_precoded_mu_ifft_pa_fft) ------------------

def _mu_inputs(g, frames, n_ant, n_usr, n_sc, device, order="users_first"):
    """Every user's symbols ``[frames, n_usr, n_sc]``, the detections
    ``[n_usr, frames, n_sc]`` and a precoder ``[frames, n_ant, n_usr, n_sc]``
    laid out in memory users first (as the joint MRT returns it),
    contiguously, or with its points strided (as the ZF precoder returns
    it)."""
    def cplx(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=device),
                             torch.randn(*shape, generator=g, device=device))

    v = cplx(n_usr, frames, n_ant, n_sc) / math.sqrt(n_ant)
    v = {"users_first": v.permute(1, 2, 0, 3), "contiguous": v.permute(1, 2, 0, 3).contiguous(),
         "points_strided": v.permute(1, 3, 2, 0).contiguous().permute(0, 2, 3, 1)}[order]
    return cplx(frames, n_usr, n_sc), cplx(n_usr, frames, n_sc), v


def _precoded_mu_and_eager(usr, v, det, sat, coeff=0.0, storage="bfloat16", **kw):
    """The precoded_mu layout's output, then the route it replaces on the
    same inputs (the eager swap and precode, then the interleaved layout),
    one launch of each, both as their raw bits."""
    layout = f"precoded_mu_{'bf16' if storage == 'bfloat16' else 'f32'}"
    before, by_layout = KERNEL.launches, KERNEL.launches_by_layout[layout]
    got = fused_pa.fused_precoded_mu_ifft_pa_fft(usr, v, sat, coeff, det_sym=det,
                                                 storage=storage, **kw)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert KERNEL.launches_by_layout[layout] == by_layout + 1
    sym = usr if det is None else fused_pa.swap_detections(det, usr)
    want = fused_pa.fused_ifft_pa_fft_complex(fused_pa.precode_users(sym, v), sat, coeff,
                                              mode="sc", storage=storage, **kw)
    return _bits(got), _bits(want)


@pytest.mark.parametrize("n_usr", [2, 3])
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("frames,n_ant", [(6, 64), (5, 3)])
@pytest.mark.parametrize("n_fft,n_sc", [(4096, 2048), (2048, 1024), (1024, 512), (256, 128)])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_precoded_mu_layout_equals_eager_precode_and_kernel(cuda, storage, n_fft, n_sc,
                                                            frames, n_ant, swap, n_usr):
    """Bit for bit the eager joint precode (with the replica pass's swap, or
    without it as the transmitter runs it) followed by the interleaved
    layout, in both storages, at four sizes, with a saturation power a
    frame: 64 antennas, and 15 or 45 rows (a ragged last block wherever a
    block holds more than one row)."""
    g = torch.Generator(device=cuda).manual_seed(n_fft + frames * n_ant + 7 * swap + n_usr)
    usr, det, v = _mu_inputs(g, frames, n_ant, n_usr, n_sc, cuda)
    sat = (torch.rand(frames, 1, generator=g, device=cuda) + 0.2) * 0.5
    got, want = _precoded_mu_and_eager(usr, v, det if swap else None, sat, storage=storage,
                                       pa_model="softlim", n_fft=n_fft)
    assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["none", "rapp", "toi"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_precoded_mu_layout_other_pa_models(cuda, storage, model):
    g = torch.Generator(device=cuda).manual_seed(47 + len(model))
    usr, det, v = _mu_inputs(g, 4, 16, 2, 1024, cuda)
    sat = torch.rand(2, 4, 16, generator=g, device=cuda) * 0.2 + 0.05
    coeff = torch.rand(2, 4, 16, generator=g, device=cuda) * 0.5
    got, want = _precoded_mu_and_eager(usr, v, det, sat, coeff, storage=storage,
                                       pa_model=model, n_fft=2048)
    assert torch.equal(got, want)


@pytest.mark.parametrize("order", ["contiguous", "points_strided"])
def test_precoded_mu_layout_takes_any_precoder_layout(cuda, order):
    """A contiguous precoder and one whose points are strided (copied
    first) give the bits of the users-first one; the symbols may be views;
    zero frames launch nothing."""
    g = torch.Generator(device=cuda).manual_seed(53)
    usr, det, v = _mu_inputs(g, 4, 8, 2, 512, cuda, order)
    strided = det.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    got, want = _precoded_mu_and_eager(usr.conj(), v, strided, 0.3, pa_model="softlim",
                                       n_fft=1024)
    assert torch.equal(got, want)
    before = KERNEL.launches
    out = fused_pa.fused_precoded_mu_ifft_pa_fft(usr[:0], v[:0], 0.3, det_sym=det[:, :0],
                                                 n_fft=1024)
    assert out.shape == (2, 0, 8, 512) and KERNEL.launches == before


def test_precoded_mu_layouts_exist_in_sc_mode_alone_without_spills(cuda):
    """Each precoded_mu layout is built at every n_fft in sc mode alone,
    no instantiation of it spills to local memory, and the bf16 one runs
    on the tensor cores, whose instructions its SASS is read to hold."""
    got = {}
    for r in fused_pa.kernel_resources():
        if r["layout"].startswith("precoded_mu"):
            assert r["mode"] == "sc" and r["local_bytes"] == 0, r
            bf16 = r["layout"] == "precoded_mu_bf16"
            assert r["tensor_cores"] == bf16 and (r["sass_mma"] > 0) == bf16, r
            got.setdefault(r["layout"], []).append(r["n_fft"])
    assert {k: sorted(v) for k, v in got.items()} == {
        layout: [256, 512, 1024, 2048, 4096]
        for layout in ("precoded_mu_bf16", "precoded_mu_f32")}


def test_mcnc_mu_bf16_frame_runs_the_precoded_mu_layout(cuda, monkeypatch):
    """The two-user MCNC-MU frame at bf16 storage: the TX and every replica
    pass launch the precoded_mu bf16 layout, ``1 + (n_iters + 1)`` times,
    and the interleaved bf16 layout never; its counters equal those of the
    route it replaced (the eager swap and precode, then the interleaved
    layout). Under the plain versions it launches no kernel, and its totals
    lie within 1% of the kernel's: the bf16 plain version sums in another
    order than the tensor cores, so its bits differ (BF16_PLAIN_TOL of
    chip_smoke.py)."""
    from mimo_ofdm_tpu_torch.models import link_mu
    from mimo_ofdm_tpu_torch.ops import fused_chain
    n_iters = 2
    cfg = _mu_cfg("mrt", "mcnc_mu", "bfloat16")
    frame = link_mu.make_mu_frame_fn(cfg, n_iters, link_mu.default_user_positions(),
                                     device=cuda)
    draws = link_mu.MuFrameDraws.draw(cfg, 2, 8, torch.Generator(device=cuda).manual_seed(8))

    def counters():
        r = frame(25.0, draws)
        return np.concatenate([r.clean_err.cpu().numpy()[..., None], r.dist_err.cpu().numpy()],
                              axis=-1)

    def eager(usr, v, sat, coeff=0.0, *, det_sym=None, **kw):
        sym = usr if det_sym is None else fused_pa.swap_detections(det_sym, usr)
        return fused_chain.fused_ifft_pa_fft_complex(fused_pa.precode_users(sym, v), sat, coeff,
                                                     mode="sc", **kw)

    by_layout = dict(KERNEL.launches_by_layout)
    kernel = counters()
    moved = {k: n - by_layout[k] for k, n in KERNEL.launches_by_layout.items()
             if n != by_layout[k]}
    assert moved == {"precoded_mu_bf16": 1 + (n_iters + 1)}
    launches = KERNEL.launches
    with kernels.plain_versions():
        plain = counters()
    assert KERNEL.launches == launches
    monkeypatch.setattr(fused_chain, "fused_precoded_mu_ifft_pa_fft", eager)
    np.testing.assert_array_equal(kernel, counters())
    assert kernel[..., 1:].sum() > 0
    assert abs(int(plain[..., 1:].sum()) - int(kernel[..., 1:].sum())) <= 0.01 * kernel[..., 1:].sum()


def test_chain_calls_launch_only_the_kernel(cuda):
    """The complex-ended chain calls and fused_ifft_clip_fft run the fused
    kernel once on complex64, in its interleaved layout, and the precoded
    chain call runs it once on the symbols and the precoder's planes, and
    nothing else but the fill of a scalar saturation power: no plane copies,
    no precode."""
    from mimo_ofdm_tpu_torch.ops import fused_chain
    g = torch.Generator(device=cuda).manual_seed(19)
    sat = torch.rand(64, generator=g, device=cuda) + 0.2
    coeff = torch.zeros(64, device=cuda)
    d, f = _cplx(g, 64, 2048, cuda), _cplx(g, 64, 4096, cuda)
    sym, v = _cplx(g, 8, 2048, cuda), torch.randn(2, 8, 8, 2048, generator=g, device=cuda)
    vb = v.bfloat16()

    def precoded(vr, vi):
        return fused_pa.fused_precoded_ifft_pa_fft(
            sym, vr, vi, sat.reshape(8, 8), coeff.reshape(8, 8), pa_model="softlim",
            n_fft=4096)

    calls = {
        "sc_bf16": lambda: fused_chain.fused_sc_ifft_pa_fft_planar(
            d, 4096, pa_model="softlim", sat=sat, cubic_coeff=coeff, storage="bfloat16"),
        "full_f32": lambda: fused_chain.fused_ifft_pa_fft_planar(
            f, pa_model="softlim", sat=sat, cubic_coeff=coeff, storage="float32"),
        "clip": lambda: fused_pa.fused_ifft_clip_fft(f, 1.5),
        "precoded_bf16": lambda: precoded(vb[0], vb[1]),
        "precoded_f32": lambda: precoded(v[0], v[1]),
    }
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
        fused = [n for k, n in kernels.items() if "fused_ifft_pa_fft" in k]
        others = [k for k in kernels if "fused_ifft_pa_fft" not in k]
        assert fused == [1] and all("Fill" in k for k in others), (name, kernels)


def test_frame_kernel_equals_plain(cuda):
    """A small f32 frame through the kernel and through the plain version
    (forced on CUDA tensors) gives the same counters."""
    cfg = config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
        array=config.ArrayConfig(n_elements=8),
        channel=config.ChannelConfig(model="rayleigh"),
        channel_storage="float32", mxu_fft_storage="float32")
    out = {}
    for alg in ("cnc", "mcnc"):
        c = cfg.replace(rx=dataclasses.replace(cfg.rx, algorithm=alg))
        frame = link.make_frame_fn(c, 2, device=cuda)
        draws = link.FrameDraws.draw(c, 8, torch.Generator(device=cuda).manual_seed(4))
        for plain in (False, True):
            with _routed(plain):
                r = frame(15.0, draws)
            out[alg, plain] = np.concatenate([r.clean_err.cpu().numpy()[:, None],
                                              r.dist_err.cpu().numpy()], axis=1)
        np.testing.assert_array_equal(out[alg, False], out[alg, True])


@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_bf16_rayleigh_frames_precoded_equal_eager_precode(cuda, alg, monkeypatch):
    """The bf16 Rayleigh frame: its transmitter chain, precoded in the
    kernel's load, gives exactly the counters of the eager precode followed
    by the planes' layout (the chain as it ran before), one precoded launch
    for the TX and one for each MCNC pass. The plain versions (forced) launch
    neither the chain's kernel nor the combine's and give totals within 1%:
    the bf16 plain version sums in another order than the tensor cores, so
    its bits differ (BF16_PLAIN_TOL)."""
    from mimo_ofdm_tpu_torch.models import link_planar
    cfg = config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
        array=config.ArrayConfig(n_elements=8),
        channel=config.ChannelConfig(model="rayleigh"),
        rx=config.RxConfig(algorithm=alg),
        channel_storage="bfloat16", mxu_fft_storage="bfloat16")
    frame = link.make_frame_fn(cfg, 2, device=cuda)
    draws = link.FrameDraws.draw(cfg, 8, torch.Generator(device=cuda).manual_seed(6))

    def counters():
        r = frame(15.0, draws)
        return np.concatenate([r.clean_err.cpu().numpy()[:, None], r.dist_err.cpu().numpy()],
                              axis=1)

    def eager(sym, vr, vi, sat, cubic_coeff, **kw):
        return fused_pa.fused_ifft_pa_fft(*fused_pa.precode_planes(sym, vr, vi), sat,
                                          cubic_coeff, **kw)

    before = KERNEL.launches_by_layout["precoded_bf16"]
    precoded = counters()
    assert KERNEL.launches_by_layout["precoded_bf16"] - before == (1 + 3 if alg == "mcnc" else 1)
    launches = KERNEL.launches, antenna_combine.antenna_combine.launches
    with kernels.plain_versions():
        plain = counters()
    assert (KERNEL.launches, antenna_combine.antenna_combine.launches) == launches
    monkeypatch.setattr(link_planar, "fused_precoded_ifft_pa_fft", eager)
    np.testing.assert_array_equal(precoded, counters())
    assert precoded[:, 1].sum() > 0
    assert abs(int(plain[:, 1:].sum()) - int(precoded[:, 1:].sum())) <= 0.01 * precoded[:, 1:].sum()


@pytest.mark.parametrize("storage", ["float32", "complex64"])
@pytest.mark.parametrize("model", ["los", "two_path"])
def test_geometric_frames_kernel_equal_plain(cuda, model, storage):
    """The LOS / two-path planar frame and the complex64 branch, f32 chain
    storage: the kernel and the plain version give the same counters, and
    a frame launches the kernel once for the TX and once per replica pass."""
    cfg = config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
        array=config.ArrayConfig(n_elements=8),
        channel=config.ChannelConfig(model=model),
        channel_storage=storage, mxu_fft_storage="float32")
    for alg in ("cnc", "mcnc"):
        c = cfg.replace(rx=dataclasses.replace(cfg.rx, algorithm=alg))
        frame = link.make_frame_fn(c, 2, device=cuda)
        draws = link.FrameDraws.draw(c, 8, torch.Generator(device=cuda).manual_seed(5))
        out = {}
        for plain in (False, True):
            before = KERNEL.launches
            with _routed(plain):
                r = frame(25.0, draws)
            assert KERNEL.launches - before == (0 if plain else 1 + 3)
            out[plain] = np.concatenate([r.clean_err.cpu().numpy()[:, None],
                                         r.dist_err.cpu().numpy()], axis=1)
        np.testing.assert_array_equal(out[False], out[True])
        assert out[False][:, 1].sum() > 0


@pytest.mark.parametrize("model", ["rician", "random_paths", "tdl_3gpp", "gscm"])
def test_stochastic_frames_kernel_equal_plain(cuda, model):
    """The complex64 frame on each stochastic channel, f32 chain storage:
    the kernel and the plain version give the same counters, with one TX
    launch and one launch per replica pass."""
    cfg = config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
        array=config.ArrayConfig(n_elements=8),
        channel=config.ChannelConfig(model=model), mxu_fft_storage="float32")
    for alg in ("cnc", "mcnc"):
        c = cfg.replace(rx=dataclasses.replace(cfg.rx, algorithm=alg))
        frame = link.make_frame_fn(c, 2, device=cuda)
        draws = link.FrameDraws.draw(c, 8, torch.Generator(device=cuda).manual_seed(6))
        out = {}
        for plain in (False, True):
            before = KERNEL.launches
            with _routed(plain):
                r = frame(25.0, draws)
            assert KERNEL.launches - before == (0 if plain else 1 + 3)
            out[plain] = np.concatenate([r.clean_err.cpu().numpy()[:, None],
                                         r.dist_err.cpu().numpy()], axis=1)
        np.testing.assert_array_equal(out[False], out[True])


def _mu_cfg(prec, alg, storage="float32"):
    return config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512, n_users=2),
        array=config.ArrayConfig(n_elements=8), precoding=prec,
        rx=config.RxConfig(algorithm=alg), mxu_fft_storage=storage)


@pytest.mark.parametrize("prec,alg,sep", [("mrt", "cnc", False), ("zf", "cnc", False),
                                          ("mrt", "cnc_mu", False), ("mrt", "mcnc_mu", False),
                                          ("mrt", "cnc", True)])
def test_mu_frame_kernel_equal_plain(cuda, prec, alg, sep):
    """The multi-user frame, f32 chain storage: the kernel and the plain
    version give the same per-user counters, with the users folded into
    one launch for the TX and one per replica pass."""
    from mimo_ofdm_tpu_torch.models import link_mu
    cfg = _mu_cfg(prec, alg)
    pos = link_mu.default_user_positions()
    builder = link_mu.make_mu_sep_frame_fn if sep else link_mu.make_mu_frame_fn
    frame = builder(cfg, 2, pos, device=cuda)
    draws = link_mu.MuFrameDraws.draw(cfg, 2, 8, torch.Generator(device=cuda).manual_seed(7),
                                      sep_carriers=sep)
    out = {}
    for plain in (False, True):
        before = KERNEL.launches
        with _routed(plain):
            r = frame(25.0, draws)
        assert KERNEL.launches - before == (0 if plain else 1 + 3)
        out[plain] = (r.clean_err.cpu().numpy(), r.dist_err.cpu().numpy())
    np.testing.assert_array_equal(out[False][0], out[True][0])
    np.testing.assert_array_equal(out[False][1], out[True][1])


@pytest.mark.parametrize("kind", ["mu_zf_mcnc_mu", "mu_mrt_cnc", "tdl_3gpp", "gscm",
                                  "rayleigh_cnc", "rayleigh_mcnc"])
def test_rounds_never_wait_for_the_device(cuda, kind):
    """After a warm-up round (kernel build, constant tables), a round of the
    multi-user link, of the TDL/GSCM complex64 frame or of the bench's
    Rayleigh frame on bf16 planes (full width, both arms) makes no call
    that synchronizes with the device."""
    from mimo_ofdm_tpu_torch import bench
    from mimo_ofdm_tpu_torch.models import link_mu
    if kind.startswith("mu_"):
        _, prec, alg = kind.split("_", 2)
        round_fn = link_mu.make_mu_round_fn(_mu_cfg(prec, alg, "bfloat16"), 2, 4,
                                            device=cuda)
    elif kind.startswith("rayleigh_"):
        cfg = bench.arm_config(bench.workload(), kind.split("_")[1])
        assert cfg.channel_storage == cfg.mxu_fft_storage == "bfloat16"
        round_fn = link.make_round_fn(cfg, bench.N_ITERS, 4, device=cuda)
    else:
        cfg = config.LinkConfig(modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
                                array=config.ArrayConfig(n_elements=8),
                                channel=config.ChannelConfig(model=kind))
        round_fn = link.make_round_fn(cfg, 2, 4, device=cuda)
    round_fn(0, 0, 20.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = round_fn(0, 1, 20.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.dtype == torch.int32


def _planar_cfg(kind: str) -> config.LinkConfig:
    """The bench's bf16 Rayleigh frame (``rayleigh_cnc``/``rayleigh_mcnc``) or
    the canonical LOS configuration (``los_cnc``), on bf16 planes."""
    from mimo_ofdm_tpu_torch import bench
    channel, alg = kind.split("_")
    if channel == "rayleigh":
        return bench.arm_config(bench.workload(), alg)
    cfg, _ = config.canonical_miso_cnc()
    assert cfg.channel.model == "los" and cfg.rx.algorithm == alg
    return cfg


@pytest.mark.parametrize("kind", ["rayleigh_cnc", "rayleigh_mcnc", "los_cnc"])
def test_planar_rounds_never_wait_for_the_device_with_spans_on(cuda, kind):
    """The stage spans read no tensor: a planar round at full width with the
    recorder on makes no call that synchronizes with the device, and records
    one ``frame`` span."""
    from mimo_ofdm_tpu_torch.utils import spans
    cfg = _planar_cfg(kind)
    assert cfg.channel_storage == cfg.mxu_fft_storage == "bfloat16"
    round_fn = link.make_round_fn(cfg, 8, 4, device=cuda)
    round_fn(0, 0, 20.0)
    torch.cuda.synchronize()
    spans.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = round_fn(0, 1, 20.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        spans.disable()
    rec = spans.collect()
    assert out.dtype == torch.int32
    assert [s.name for s in rec if s.parent == -1] == ["frame"]


@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_every_fused_launch_lies_in_a_chain_span_on_the_trace_clock(cuda, alg, tmp_path):
    """Under a card-only profiler with the recorder on, the runtime or
    driver call that launched each fused kernel (matched by correlation id)
    lies inside a ``chain`` span put on the trace's clock, and that span is
    the innermost one open there."""
    import json

    from mimo_ofdm_tpu_torch.utils import spans
    cfg = _planar_cfg(f"rayleigh_{alg}")
    frame_fn = link.make_frame_fn(cfg, 8, device=cuda)
    draws = link.FrameDraws.draw(cfg, 8, torch.Generator(device=cuda).manual_seed(5))
    frame_fn(15.0, draws)
    torch.cuda.synchronize()
    spans.enable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                frame_fn(15.0, draws)
            torch.cuda.synchronize()
    finally:
        spans.disable()
    rec = spans.collect()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    on_trace = spans.on_trace_clock(rec, trace["baseTimeNanoseconds"])
    launched_at = {e["args"]["correlation"]: e["ts"] for e in trace["traceEvents"]
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    fused = [e for e in trace["traceEvents"]
             if e.get("cat") == "kernel" and "fused_ifft_pa_fft" in e.get("name", "")]
    assert len(fused) == 3 * (8 + 2)
    assert sum(sp.name == "frame" for sp in on_trace) == 3
    for k in fused:
        t = launched_at[k["args"]["correlation"]]
        holding = [sp for sp in on_trace if sp.start <= t <= sp.end]
        assert holding, (t, k["name"])
        assert min(holding, key=lambda sp: sp.end - sp.start).name == "chain"


def test_bench_on_the_card(cuda, tmp_path, monkeypatch):
    """The bench function on the card at a small shape, three rounds in
    flight: bench.py's keys plus the card's name, positive windows, 10
    kernel launches a round on each arm and sane counters."""
    from mimo_ofdm_tpu_torch import bench
    monkeypatch.setattr(bench.baseline_cpu, "measure_baseline_frames_per_s",
                        lambda cfg, n_iters: 1.0)
    cfg = bench.workload().replace(modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
                                   array=config.ArrayConfig(n_elements=8))
    tallies = {}
    before = KERNEL.launches
    out = bench.run(cfg, 4, 4, n_windows=2, window_s=0.2, depth=3, device=cuda,
                    baseline_path=tmp_path / "baseline.json", tallies=tallies)
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "windows",
                        "mcnc_frames_per_s", "mcnc_windows", "device"}
    assert torch.cuda.get_device_name(cuda) in out["device"]
    assert all(w > 0 for w in out["windows"] + out["mcnc_windows"])
    rounds = sum(t["rounds"] for t in tallies.values())
    assert KERNEL.launches - before == rounds * (bench.N_ITERS + 2)
    for t in tallies.values():
        clean, *iters = t["counters"]
        assert 0 <= clean < iters[0] < 0.5 * t["rounds"] * 4 * cfg.modem.n_bits_per_ofdm_sym


# --- the coded link ----------------------------------------------------------

def _coded_cfg(alg="cnc", storage="bfloat16"):
    return config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
        array=config.ArrayConfig(n_elements=8), rx=config.RxConfig(algorithm=alg),
        mxu_fft_storage=storage)


@pytest.mark.parametrize("alg", ["minsum", "sumprod"])
def test_ldpc_decode_cuda_matches_cpu(cuda, alg):
    """The decoder on the card against the same call on the CPU, on one LLR
    batch of the reference's BG1 Zc 288 code at a waterfall SNR: min-sum
    gives equal bits; sum-product equal bits or error totals within 5%
    (tanh and log differ by an ulp between the two devices)."""
    from mimo_ofdm_tpu_torch.ops import ldpc, nr_ldpc
    code = nr_ldpc.make_nr_code(1, 288)
    info = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (8, code.k)).astype(np.int8))
    cw = nr_ldpc.encode(code, info).numpy()
    sigma = 1.15
    y = (1.0 - 2.0 * cw) + sigma * np.random.default_rng(2).normal(size=cw.shape)
    llr = torch.from_numpy((2.0 * y / sigma ** 2).astype(np.float32))
    cpu = ldpc.decode(code, llr, n_iters=12, algorithm=alg)
    gpu = ldpc.decode(code, llr.to(cuda), n_iters=12, algorithm=alg).cpu()
    diff = int((gpu != cpu).sum())
    if alg == "minsum" or diff == 0:
        assert diff == 0
    else:
        e_cpu, e_gpu = int((cpu != info).sum()), int((gpu != info).sum())
        assert abs(e_gpu - e_cpu) <= 0.05 * max(e_cpu, 100), (diff, e_cpu, e_gpu)


def test_transport_encode_cuda_equals_cpu(cuda):
    """The full-width reference chain (A 6144, BG1 Zc 288) and a segmented,
    repeating IRA chain encode to the same bits on both devices."""
    from mimo_ofdm_tpu_torch.models import link_ldpc
    from mimo_ofdm_tpu_torch.ops import ldpc, transport
    full = config.LinkConfig(modem=config.ModemConfig())
    chains = [link_ldpc.reference_chain(full, 0.5),
              transport.make_transport_chain(ldpc.make_default_code(12, 12, 16),
                                             e_total=768, target_rate=0.25)]
    for chain in chains:
        pay = torch.from_numpy(np.random.default_rng(chain.a).integers(
            0, 2, (4, chain.a)).astype(np.int8))
        cpu = transport.transport_encode(chain, pay)
        assert torch.equal(transport.transport_encode(chain, pay.to(cuda)).cpu(), cpu)
        llr = (1.0 - 2.0 * cpu.float()) * 3.0
        rx, ok = transport.transport_decode(chain, llr.to(cuda), n_iters=4)
        assert torch.equal(rx.cpu(), pay) and bool(ok.all())


@pytest.mark.parametrize("kind", ["transport", "inloop", "ira"])
def test_coded_round_never_waits_for_the_device(cuda, kind):
    """After a warm-up round (kernel build, tables on the device), a coded
    round makes no call that synchronizes with the device, and launches the
    kernel once for the TX and once per replica pass."""
    from mimo_ofdm_tpu_torch.models import link_ldpc
    cfg = _coded_cfg("mcnc")
    if kind == "ira":
        round_fn = link_ldpc.make_coded_round_fn(cfg, 2, 4, ldpc_iters=4, device=cuda)
    else:
        chain = link_ldpc.reference_chain(cfg, 0.5)
        make = (link_ldpc.make_transport_round_fn if kind == "transport"
                else link_ldpc.make_transport_inloop_round_fn)
        round_fn = make(cfg, 2, 4, chain, ldpc_iters=4, device=cuda)
    round_fn(0, 0, 14.0)
    torch.cuda.synchronize()
    before = KERNEL.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = round_fn(0, 1, 14.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.dtype == torch.int32 and KERNEL.launches - before == 1 + 3


def test_coded_frame_kernel_equals_plain(cuda):
    """A small f32 transport frame through the kernel and through the plain
    version forced on CUDA tensors gives the same counters."""
    from mimo_ofdm_tpu_torch.models import link_ldpc
    for alg in ("cnc", "mcnc"):
        cfg = _coded_cfg(alg, "float32")
        chain = link_ldpc.reference_chain(cfg, 0.5)
        frame = link_ldpc.make_transport_frame_fn(cfg, 2, chain, 6, ldpc_algorithm="sumprod",
                                                  device=cuda)
        draws = link.FrameDraws.draw(cfg, 8, torch.Generator(device=cuda).manual_seed(8),
                                     n_bits=chain.a)
        out = {}
        for plain in (False, True):
            with _routed(plain):
                out[plain] = [x.cpu() for x in frame(14.0, draws)]
        for a, b in zip(out[False], out[True]):
            assert torch.equal(a, b)


# --- the analysis family -----------------------------------------------------

def test_radiation_pattern_cuda_matches_cpu(cuda):
    """A Rayleigh radiation-pattern scan (8 antennas, n_fft 1024, 7 points,
    4 snapshots) on the card against the same scan on the CPU, on draws
    made on the CPU: powers within 1e-4 of the peak, PSDs within 1e-4 of
    theirs; the kernel launched once per (point chunk, snapshot chunk) in
    ``sc`` mode and once per PSD point in ``full`` mode."""
    from mimo_ofdm_tpu_torch.models import analysis
    cfg = config.LinkConfig(modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
                            array=config.ArrayConfig(n_elements=8),
                            channel=config.ChannelConfig(model="rayleigh"),
                            pa=config.PaConfig(ibo_db=3.0))
    g = torch.Generator().manual_seed(12)
    draws = analysis.ScanDraws(
        torch.randint(0, 2, (7, 4, cfg.modem.n_bits_per_ofdm_sym), generator=g,
                      dtype=torch.int8),
        torch.randn(7, 2, 8, 1024, generator=g))
    kw = dict(n_points=6, n_snapshots=4, snap_chunk=2, n_samp_per_seg=256)
    ref = analysis.radiation_pattern(cfg, draws, device="cpu", **kw)
    before = KERNEL.launches
    got = analysis.radiation_pattern(cfg, draws, device=cuda, **kw)
    assert KERNEL.launches - before == 2 * 2 + 2
    for a, b in ((got.desired_pow, ref.desired_pow), (got.distortion_pow, ref.distortion_pow)):
        assert np.max(np.abs(a - b)) < 1e-4 * np.max(b)
    for ang in ref.psd:
        for a, b in zip(got.psd[ang][1:], ref.psd[ang][1:]):
            assert np.max(np.abs(a - b)) < 1e-4 * np.max(b)


def test_siso_round_cuda_matches_cpu(cuda):
    """A SISO CNC frame batch (AWGN and Rayleigh, n_fft 1024, 3 iterations)
    on the card: counters equal through the kernel and through the plain
    version forced on CUDA tensors, totals within 2% of the CPU's, and one
    launch for the clipped run plus one per CNC pass."""
    from mimo_ofdm_tpu_torch.experiments import siso_checks
    for rayleigh in (False, True):
        draws = siso_checks.SisoDraws.draw(16, 512, 6 * 512, rayleigh,
                                           torch.Generator().manual_seed(13))
        cpu = siso_checks._make_siso_frame_fn(64, 1024, 512, 0.0, 3, 0.62, rayleigh,
                                              device="cpu")(22.0, draws)
        frame = siso_checks._make_siso_frame_fn(64, 1024, 512, 0.0, 3, 0.62, rayleigh,
                                                device=cuda)
        out = {}
        for plain in (False, True):
            before = KERNEL.launches
            with _routed(plain):
                out[plain] = [x.cpu() for x in frame(22.0, draws)]
            assert KERNEL.launches - before == (0 if plain else 1 + 4)
        for a, b in zip(out[False], out[True]):
            assert torch.equal(a, b)
        for a, b in zip(out[False], cpu):
            ta, tb = a.sum(0).double(), b.sum(0).double()
            assert torch.all((ta - tb).abs() <= 0.02 * torch.clamp(tb, min=100))


# --- scale-out -----------------------------------------------------------------

def test_world_size_one_nccl_sharded_rounds(cuda):
    """A world-size-1 NCCL job on the card: the sharded round on its (1, 1)
    mesh equals ``make_round_fn`` for the same ``(key, idx)``, with the
    kernel's 1 + n_iters + 1 launches a round; the sharded multi-user
    round (ZF + MCNC-MU) equals ``make_mu_round_fn`` and, after a warm-up
    round, makes no call that synchronizes with the device."""
    import socket
    from datetime import timedelta

    import torch.distributed as dist

    from mimo_ofdm_tpu_torch.models import link_mu
    from mimo_ofdm_tpu_torch.parallel import multihost, sharded
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                         timeout=timedelta(seconds=60))
    try:
        mesh = sharded.make_mesh(1, 1)
        assert mesh.shape == {"dp": 1, "tp": 1} and mesh.dp_group is None
        cfg = config.LinkConfig(modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
                                array=config.ArrayConfig(n_elements=8),
                                channel=config.ChannelConfig(model="rayleigh"),
                                rx=config.RxConfig(algorithm="mcnc"))
        before = KERNEL.launches
        got = sharded.make_sharded_round_fn(cfg, 2, 4, mesh, device=cuda)(0, 3, 20.0)
        torch.cuda.synchronize()
        assert KERNEL.launches - before == 1 + 2 + 1
        want = link.make_round_fn(cfg, 2, 4, device=cuda)(0, 3, 20.0)
        assert torch.equal(got.cpu(), want.cpu())
        mcfg = _mu_cfg("zf", "mcnc_mu", "bfloat16")
        round_fn = sharded.make_sharded_mu_round_fn(mcfg, 2, 4, mesh, device=cuda)
        round_fn(0, 0, 20.0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = round_fn(0, 1, 20.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = link_mu.make_mu_round_fn(mcfg, 2, 4, device=cuda)(0, 1, 20.0)
        assert torch.equal(got.cpu(), want.cpu())
    finally:
        dist.destroy_process_group()


def test_component_receivers_on_the_kernel(cuda):
    """Phase 15 (b) and (c) of chip_smoke.py at a small width: equalized
    full-band LOS frames built with the component API go through
    ``cnc_receive``/``mcnc_receive`` (torch.fft replicas) and through
    ``cnc_iterate`` with the kernel-backed replicas, 9 launches a receive,
    at most 1e-4 of the bits differing at any pass; ``fused_ifft_clip_fft``
    launches the kernel once and agrees with its plain version within
    1e-5."""
    from mimo_ofdm_tpu_torch.models import agc, channels, precoding, receivers, transmit
    from mimo_ofdm_tpu_torch.ops import noise, ofdm

    cfg = config.LinkConfig(
        modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
        array=config.ArrayConfig(n_elements=8),
        channel=config.ChannelConfig(model="los"), channel_storage="complex64",
        mxu_fft_storage="float32")
    m, n_fft, n_sc, n_iters, snr = 64, 1024, 512, 8, 25.0
    draws = link.FrameDraws.draw(cfg, 16, torch.Generator(device=cuda).manual_seed(15))
    tx_pos, freqs, rx_base = link.link_static(cfg, cuda)
    h_fd = link.make_channel_fn(cfg, freqs, rx_base, True)(tx_pos, draws)
    h_sc = ofdm.extract_subcarriers(h_fd, n_sc)
    v = precoding.mrt_precoder(h_sc)
    sat = precoding.pa_sat_power(0.0, cfg.modem.avg_sample_power, v)[:, None]
    st = agc.compute_agc(h_sc, v, 0.0, 8, n_fft)
    fd = transmit.array_transmit_fd(draws.bits_d, constel_size=m, n_fft=n_fft, v=v,
                                    sat_power=sat)
    rx = noise.awgn(channels.propagate(h_fd, fd), snr,
                    cfg.modem.avg_symbol_power * st.ak_hk_vk_noise_scaler,
                    noise.complex_normal(ofdm.map_subcarriers(draws.noise_d, n_fft)))
    rx = receivers.equalize(rx, st.ak_hk_vk_agc_nfft)
    agc_sc = ofdm.extract_subcarriers(st.ak_hk_vk_agc_nfft, n_sc)
    mxu = dict(use_mxu_fft=True, mxu_storage="float32")
    kw = dict(constel_size=m, n_sc=n_sc)
    cases = {
        "cnc": (receivers.cnc_receive(rx, n_iters, ibo_db=0.0, **kw),
                receivers.make_cnc_replica(m, n_fft, n_sc, 0.0, **mxu)),
        "mcnc": (receivers.mcnc_receive(rx, n_iters, h_fd, v, st.ak_hk_vk_agc_nfft,
                                        sat_power=sat, **kw),
                 receivers.make_mcnc_replica(h_sc, v, agc_sc, constel_size=m, n_fft=n_fft,
                                             n_sc=n_sc, sat_power=sat, **mxu))}
    n_bits = draws.bits_d.numel()
    for alg, (plain_bits, replica) in cases.items():
        before = KERNEL.launches
        bits, _ = receivers.cnc_iterate(ofdm.extract_subcarriers(rx, n_sc), n_iters, m,
                                        replica)
        assert KERNEL.launches - before == n_iters + 1
        diff = (bits != plain_bits).flatten(1).sum(-1)
        assert int(diff.max()) <= 1e-4 * n_bits, (alg, diff.tolist())
        errs = (bits != draws.bits_d).flatten(1).sum(-1)
        assert 0 < int(errs[0]) < 0.5 * n_bits

    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.complex(torch.randn(64, 4096, generator=g, device=cuda),
                      torch.randn(64, 4096, generator=g, device=cuda))
    before = KERNEL.launches
    y = fused_pa.fused_ifft_clip_fft(x, 1.5)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ones = torch.ones(64, device=cuda)
    pr, pi = fused_pa.fused_ifft_pa_fft_plain(x.real, x.imag, ones * 1.5, ones * 0.0,
                                              pa_model="softlim", n_fft=4096, mode="full")
    assert y.dtype == torch.complex64 and _rel(y, torch.complex(pr, pi)) < 1e-5
