"""The fused IFFT -> PA -> FFT chain of the distorted transmitter
(counterpart of ``mimo_ofdm_tpu/ops/mxu_fft.py``).

The JAX package runs this chain as 64 x 64 matmuls on the TPU's matrix
unit; here every entry point hands its planes to the CUDA kernel of
:mod:`mimo_ofdm_tpu_torch.kernels.fused_pa` (or, for CPU tensors, to its
plain PyTorch version). The PA is named by model and per-row parameters
instead of a closure, since it runs inside the kernel.

``storage`` is the dtype of the planes on either side of the kernel
(``"bfloat16"`` or ``"float32"``); the transforms run in float32 either
way.
"""

from __future__ import annotations

import torch

from mimo_ofdm_tpu_torch.kernels.fused_pa import fused_ifft_pa_fft

STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def storage_dtype(storage: str) -> torch.dtype:
    if storage not in STORAGE_DTYPES:
        raise ValueError(f"unknown storage {storage!r} "
                         f"(expected one of {tuple(STORAGE_DTYPES)})")
    return STORAGE_DTYPES[storage]


def fused_sc_ifft_pa_fft_planar_io(dr: torch.Tensor, di: torch.Tensor,
                                   n_fft: int, *, pa_model: str, sat,
                                   cubic_coeff=0.0, rapp_p: float = 1.1,
                                   storage: str = "float32"
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``extract_sc(FFT(PA(IFFT(map_sc(d)))))`` on real/imag data planes
    ``[..., n_sc]`` in ``[neg | pos]`` order (bin ``n_sc/2`` last); the
    full-band frame never leaves the kernel. ``sat``/``cubic_coeff``
    broadcast to the leading dims. Output planes are in the storage dtype."""
    st = storage_dtype(storage)
    return fused_ifft_pa_fft(dr.to(st).contiguous(), di.to(st).contiguous(),
                             sat, cubic_coeff, pa_model=pa_model, n_fft=n_fft,
                             mode="sc", rapp_p=rapp_p)


def fused_sc_ifft_pa_fft_planar(data_sc: torch.Tensor, n_fft: int, *,
                                pa_model: str, sat, cubic_coeff=0.0,
                                rapp_p: float = 1.1,
                                storage: str = "float32") -> torch.Tensor:
    """Complex ``[..., n_sc]`` in, complex64 out: the planar-I/O chain of
    :func:`fused_sc_ifft_pa_fft_planar_io` with complex ends."""
    outr, outi = fused_sc_ifft_pa_fft_planar_io(
        data_sc.real, data_sc.imag, n_fft, pa_model=pa_model, sat=sat,
        cubic_coeff=cubic_coeff, rapp_p=rapp_p, storage=storage)
    return torch.complex(outr.to(torch.float32), outi.to(torch.float32))


def fused_ifft_pa_fft_planar(x_fd: torch.Tensor, *, pa_model: str, sat,
                             cubic_coeff=0.0, rapp_p: float = 1.1,
                             storage: str = "float32") -> torch.Tensor:
    """Full-band ``FFT(PA(IFFT(x)))`` of complex ``[..., n_fft]`` frames,
    complex64 out."""
    st = storage_dtype(storage)
    outr, outi = fused_ifft_pa_fft(
        x_fd.real.to(st).contiguous(), x_fd.imag.to(st).contiguous(), sat,
        cubic_coeff, pa_model=pa_model, n_fft=x_fd.shape[-1], mode="full",
        rapp_p=rapp_p)
    return torch.complex(outr.to(torch.float32), outi.to(torch.float32))
