"""The precoded_mu layouts of the fused chain on the CPU, where their wrapper
(``kernels/fused_pa.py::fused_precoded_mu_ifft_pa_fft``) runs its plain
route: the multi-user joint precode, with an MCNC-MU replica pass's swap,
followed by the chain. That route must be bit for bit what the two-user
transmitter and replica ran before the precode moved into the kernel's
load: ``torch.where`` swap, ``transmit.precode_symbols(..., sum_users=True)``,
``transmit.ifft_pa_fft_sc``. The kernel itself is held to the same bits on
the card (``tests/test_torch_cuda.py``)."""

import ctypes

import pytest
import torch

from mimo_ofdm_tpu_torch.kernels import fused_pa
from mimo_ofdm_tpu_torch.models import transmit

KERNEL = fused_pa.fused_ifft_pa_fft
N_FFT, N_SC, N_ANT, FRAMES = 256, 128, 6, 3


def _bits(z: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(z.resolve_conj().contiguous()).view(torch.int32)


def _inputs(seed: int, n_usr: int):
    """Every user's symbols ``[FRAMES, n_usr, N_SC]``, the detections
    ``[n_usr, FRAMES, N_SC]`` and a precoder ``[FRAMES, N_ANT, n_usr, N_SC]``
    laid out users first in memory, as the joint MRT returns it."""
    g = torch.Generator().manual_seed(seed)

    def cplx(*shape):
        return torch.complex(torch.randn(*shape, generator=g), torch.randn(*shape, generator=g))

    v = (cplx(n_usr, FRAMES, N_ANT, N_SC) * 0.3).permute(1, 2, 0, 3)
    return cplx(FRAMES, n_usr, N_SC), cplx(n_usr, FRAMES, N_SC), v


def _before(usr, v, det, sat, storage, use_mxu_fft=True, **kw):
    """The two-user chain as the transmitter and the MCNC-MU replica ran it
    before the precoded_mu layouts."""
    sym = usr
    if det is not None:
        n_usr = usr.shape[-2]
        own = torch.eye(n_usr, dtype=torch.bool).view(n_usr, *([1] * (usr.ndim - 2)), n_usr, 1)
        sym = torch.where(own, det[..., None, :], usr)
    per_ant_sc = transmit.precode_symbols(sym, v, sum_users=True)
    return transmit.ifft_pa_fft_sc(per_ant_sc, N_FFT, kw.get("pa_model", "softlim"), sat,
                                   use_mxu_fft=use_mxu_fft, mxu_storage=storage)


@pytest.mark.parametrize("n_usr", [2, 3])
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_plain_route_is_the_eager_precode_and_chain(storage, swap, n_usr):
    """The wrapper on CPU tensors: bit for bit the eager swap, precode and
    chain, in both storages, with and without the swap; no launch."""
    usr, det, v = _inputs(11 + n_usr + 2 * swap + len(storage), n_usr)
    det = det if swap else None
    sat = (torch.rand(FRAMES, generator=torch.Generator().manual_seed(5)) + 0.2)[:, None]
    before = KERNEL.launches
    got = fused_pa.fused_precoded_mu_ifft_pa_fft(usr, v, sat, det_sym=det, n_fft=N_FFT,
                                                 storage=storage)
    assert KERNEL.launches == before
    want = _before(usr, v, det, sat, storage)
    rows = (n_usr, FRAMES, N_ANT) if swap else (FRAMES, N_ANT)
    assert got.shape == (*rows, N_SC) and got.dtype == torch.complex64
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("use_mxu_fft", [True, False])
@pytest.mark.parametrize("swap", [False, True])
def test_transmit_chain_is_the_eager_route(swap, use_mxu_fft):
    """``transmit.precode_ifft_pa_fft_sc``, which the two-user frame calls
    for its TX and every MCNC-MU replica pass, gives the bits of the route
    it replaced on the fused chain (the bf16 storage) and on torch.fft."""
    usr, det, v = _inputs(23 + 2 * swap + use_mxu_fft, 2)
    det = det if swap else None
    sat = torch.full((FRAMES, 1), 0.7)
    got = transmit.precode_ifft_pa_fft_sc(usr, v, N_FFT, "softlim", sat, det_sym=det,
                                          use_mxu_fft=use_mxu_fft, mxu_storage="bfloat16")
    want = _before(usr, v, det, sat, "bfloat16", use_mxu_fft=use_mxu_fft)
    assert torch.equal(_bits(got), _bits(want))


def test_precode_users_is_the_eager_sum():
    usr, _, v = _inputs(3, 2)
    want = (usr[..., :, None, :] * v.transpose(-3, -2)).sum(-3)
    assert torch.equal(_bits(fused_pa.precode_users(usr, v)), _bits(want))
    assert torch.equal(_bits(transmit.precode_symbols(usr, v, sum_users=True)), _bits(want))


def test_swap_detections_takes_each_users_own_row():
    usr, det, _ = _inputs(4, 3)
    sym = fused_pa.swap_detections(det, usr)                 # [U, FRAMES, U, N_SC]
    for r in range(3):
        for u in range(3):
            assert torch.equal(sym[r, :, u], det[r] if u == r else usr[:, u])


_OK = dict(n_fft=N_FFT)
_USR, _DET, _V = _inputs(7, 2)
_BAD = {
    "symbols_complex128": ((_USR.to(torch.complex128), _V), {}, _OK),
    "precoder_complex128": ((_USR, _V.to(torch.complex128)), {}, _OK),
    "detections_complex128": ((_USR, _V), {"det_sym": _DET.to(torch.complex128)}, _OK),
    "precoder_users": ((_USR, _V[..., :1, :]), {}, _OK),
    "precoder_width": ((_USR, _V[..., :64]), {}, _OK),
    "precoder_frames": ((_USR, _V[:2]), {}, _OK),
    "no_user_axis": ((_USR[:, 0], _V), {}, _OK),
    "no_antenna_axis": ((_USR[0], _V[0, 0]), {}, _OK),
    "detections_shape": ((_USR, _V), {"det_sym": _DET[:, :2]}, _OK),
    "detections_device": ((_USR, _V), {"det_sym": torch.empty(_DET.shape, dtype=_DET.dtype,
                                                              device="meta")}, _OK),
    "n_sc_not_below_n_fft": ((_USR, _V), {}, dict(n_fft=128)),
    "pa_model": ((_USR, _V), {}, dict(_OK, pa_model="bogus")),
    "storage": ((_USR, _V), {}, dict(_OK, storage="float16")),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_rejects_what_the_kernel_does_not_take(case):
    args, det, kw = _BAD[case]
    with pytest.raises(ValueError):
        fused_pa.fused_precoded_mu_ifft_pa_fft(*args, 0.5, **det, **kw)


def test_zero_frames_launch_nothing():
    before = KERNEL.launches
    out = fused_pa.fused_precoded_mu_ifft_pa_fft(_USR[:0], _V[:0], 0.5, det_sym=_DET[:, :0],
                                                 n_fft=N_FFT, storage="bfloat16")
    assert out.shape == (2, 0, N_ANT, N_SC) and KERNEL.launches == before


def test_layouts_list_the_precoded_mu_layouts():
    assert fused_pa.LAYOUTS["precoded_mu_f32"] == ("precoded_mu", False)
    assert fused_pa.LAYOUTS["precoded_mu_bf16"] == ("precoded_mu", True)
    assert fused_pa.IO_KINDS.index("precoded_mu") == 3          # csrc/fused_pa.cu, enum Io
    assert {"precoded_mu_f32", "precoded_mu_bf16"} <= set(KERNEL.launches_by_layout)


def test_kernel_resources_skip_the_precoded_kinds_outside_sc(monkeypatch):
    """``kernel_resources`` asks the library for every layout in ``sc``
    mode and for all but the precoded kinds in ``full`` mode: 5 sizes x (8
    + 4) instantiations."""
    asked = []

    def attributes(log2n, sc, bf16, io, out):
        asked.append((log2n, sc, bf16, io))
        return 0

    lib = type("Lib", (), {"fused_ifft_pa_fft_attributes": staticmethod(attributes)})
    monkeypatch.setattr(fused_pa, "build_library", lambda: (lib, ""))
    monkeypatch.setattr(fused_pa, "sass_mma_counts", dict)
    rows = fused_pa.kernel_resources()
    assert len(rows) == len(asked) == 5 * (8 + 4)
    mu = fused_pa.IO_KINDS.index("precoded_mu")
    assert sorted(a for a in asked if a[3] == mu) == [(n, 1, b, mu) for n in range(8, 13)
                                                      for b in (0, 1)]
    assert {r["layout"] for r in rows if r["mode"] == "full"} == {
        "planes_f32", "planes_bf16", "interleaved_f32", "interleaved_bf16"}


# instantiations' names as ``cuobjdump -sass`` prints them: the kernel in the
# anonymous namespace, <LOG2N, SC, IO>
_NS = "_ZN12_GLOBAL__N_1"
_ARGS = "EEvPKNT1_4ElemES6_PS4_S7_PKfS9_PK6float2iiiffffiNS3_4ArgsE"
_NAMES = {
    f"{_NS}27fused_ifft_pa_fft_tc_kernelILi12ELb1ENS_10PrecodedMuILb1EEE{_ARGS}":
        (4096, "sc", "precoded_mu_bf16"),
    f"{_NS}24fused_ifft_pa_fft_kernelILi10ELb1ENS_10PrecodedMuILb0EEE{_ARGS}":
        (1024, "sc", "precoded_mu_f32"),
    f"{_NS}27fused_ifft_pa_fft_tc_kernelILi12ELb1ENS_11InterleavedILb1EEE{_ARGS}":
        (4096, "sc", "interleaved_bf16"),
    f"{_NS}24fused_ifft_pa_fft_kernelILi8ELb0ENS_11InterleavedILb0EEE{_ARGS}":
        (256, "full", "interleaved_f32"),
    f"{_NS}27fused_ifft_pa_fft_tc_kernelILi11ELb1ENS_8PrecodedI13__nv_bfloat16EE{_ARGS}":
        (2048, "sc", "precoded_bf16"),
    f"{_NS}24fused_ifft_pa_fft_kernelILi9ELb0ENS_6PlanesIfEE{_ARGS}":
        (512, "full", "planes_f32"),
    f"{_NS}21antenna_combine_kernelILi8EEvPK13__nv_bfloat16": None,
}


@pytest.mark.parametrize("name", list(_NAMES))
def test_mangled_names_give_their_instantiation(name):
    """``sass_mma_counts`` finds each instantiation by its mangled name,
    the precoded_mu layouts among them (without them it would read 0
    tensor-core instructions there)."""
    assert fused_pa.instantiation(name) == _NAMES[name]


def test_launch_entry_declares_every_argument():
    """The ctypes declaration of the launch entry has one type for each of
    its parameters (csrc/fused_pa.cu, ``fused_ifft_pa_fft_launch``): the
    four arrays, sat, coeff, the table, the symbols and detections, n_ant,
    n_usr, V's three strides, rows, log2n, n_io, sc, bf16, io, the PA
    model, its three floats and the stream."""
    lib = type("Lib", (), {})()
    lib.fused_ifft_pa_fft_launch = type("Fn", (), {})()
    lib.fused_ifft_pa_fft_attributes = type("Fn", (), {})()
    fused_pa._declare(lib)
    types = lib.fused_ifft_pa_fft_launch.argtypes
    assert len(types) == 25 and types[11:14] == [ctypes.c_longlong] * 3
