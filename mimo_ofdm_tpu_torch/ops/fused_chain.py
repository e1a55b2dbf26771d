"""The fused IFFT -> PA -> FFT chain of the distorted transmitter
(counterpart of ``mimo_ofdm_tpu/ops/mxu_fft.py``).

The JAX package runs this chain as 64 x 64 matmuls on the TPU's matrix
unit; here every entry point hands its planes to the wrappers of
:mod:`mimo_ofdm_tpu_torch.kernels.fused_pa`, which launch the CUDA kernel
(or, for CPU tensors, run its plain PyTorch version). The PA is named by
model and per-row parameters instead of a closure, since it runs inside
the kernel.

``storage`` is the dtype of the planes on either side of the kernel
(``"bfloat16"`` or ``"float32"``). At float32 the transforms run in
float32; at bf16 they run the JAX chain's bf16 contract on the tensor
cores (each pass a bf16 product with float32 sums, its operand rounded to
bf16 once). The complex-ended entry points hand complex64 to the kernel's
interleaved layout as it is, which gives the same bits without the planes
(complex128 still goes through planes). The multi-user transmitter's chain
takes its symbols and precoder to the kernel's precoded_mu layouts, whose
load computes the joint precode (:func:`fused_precoded_mu_ifft_pa_fft`).
"""

from __future__ import annotations

import torch

from mimo_ofdm_tpu_torch.kernels.fused_pa import (check_shapes, fused_ifft_pa_fft,
                                                  fused_ifft_pa_fft_complex,
                                                  fused_precoded_mu_ifft_pa_fft, precode_users,
                                                  storage_dtype, swap_detections)


def kernel_eligible(n_fft: int, n_io: int, mode: str) -> bool:
    """True when the kernel takes this transform (the counterpart of
    ``mxu_fft.square_radix`` / ``sc_prune_eligible``)."""
    try:
        check_shapes(n_fft, n_io, mode)
    except ValueError:
        return False
    return True


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
    :func:`fused_sc_ifft_pa_fft_planar_io` with complex ends (complex64
    goes to the kernel as it is)."""
    if data_sc.dtype == torch.complex64:
        return fused_ifft_pa_fft_complex(data_sc, sat, cubic_coeff, pa_model=pa_model,
                                         n_fft=n_fft, mode="sc", rapp_p=rapp_p,
                                         storage=storage)
    outr, outi = fused_sc_ifft_pa_fft_planar_io(
        data_sc.real, data_sc.imag, n_fft, pa_model=pa_model, sat=sat,
        cubic_coeff=cubic_coeff, rapp_p=rapp_p, storage=storage)
    return torch.complex(outr.to(torch.float32), outi.to(torch.float32))


def fused_ifft_pa_fft_planar(x_fd: torch.Tensor, *, pa_model: str, sat,
                             cubic_coeff=0.0, rapp_p: float = 1.1,
                             storage: str = "float32") -> torch.Tensor:
    """Full-band ``FFT(PA(IFFT(x)))`` of complex ``[..., n_fft]`` frames,
    complex64 out (complex64 goes to the kernel as it is)."""
    if x_fd.dtype == torch.complex64:
        return fused_ifft_pa_fft_complex(x_fd, sat, cubic_coeff, pa_model=pa_model,
                                         n_fft=x_fd.shape[-1], mode="full",
                                         rapp_p=rapp_p, storage=storage)
    st = storage_dtype(storage)
    outr, outi = fused_ifft_pa_fft(
        x_fd.real.to(st).contiguous(), x_fd.imag.to(st).contiguous(), sat,
        cubic_coeff, pa_model=pa_model, n_fft=x_fd.shape[-1], mode="full",
        rapp_p=rapp_p)
    return torch.complex(outr.to(torch.float32), outi.to(torch.float32))
