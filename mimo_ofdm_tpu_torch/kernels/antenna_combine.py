"""The planar transmitter's antenna combine ``sum_ant H o X`` over bf16 planes:
the CUDA kernel of ``csrc/antenna_combine.cu`` and its plain PyTorch
version.

:func:`antenna_combine` takes the channel's planes ``hr``/``hi`` and the
fused chain's output planes ``fr``/``fi``, ``[B, n_ant, n_sc]`` bfloat16
each, and returns the complex64 ``[B, n_sc]`` sum over the antennas
(``reference/channel.py:74-89``). Each term is rounded as the eager
expression :func:`antenna_combine_plain` rounds it (each bf16 product, then
their bf16 difference or sum), and the terms are summed in float32; only
the order of that sum may differ (the kernel's: each subcarrier in one
thread, antenna 0 first, ``csrc/antenna_combine.cu``), so the kernel gives
the same bits on every run and for every batch the frames come in.

Rows must be contiguous (antenna stride ``n_sc``, subcarrier stride 1);
the frames of a pair of planes may be ``n_ant * n_sc`` apart or share one
plane (batch stride 0, an ``expand``ed channel), which the kernel reads as
it is, without a copy.

For a CUDA tensor the wrapper launches the kernel (built with ``nvcc`` at
first use and loaded with ``ctypes``, ``kernels/build.py``) or raises; for
a CPU tensor it runs :func:`antenna_combine_plain`. Launches count in
``antenna_combine.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from mimo_ofdm_tpu_torch.kernels import build

SOURCE = build.PACKAGE_DIR / "csrc" / "antenna_combine.cu"
VEC = 8              # subcarriers a thread, when rows are 16-byte aligned


def antenna_combine_plain(hr: torch.Tensor, hi: torch.Tensor, fr: torch.Tensor,
                          fi: torch.Tensor) -> torch.Tensor:
    """``sum_ant H o X`` as the eager expression: products, difference and
    sum in the planes' dtype, the antenna sums in float32, complex64 out
    (any device, any dtype of planes)."""
    return torch.complex((hr * fr - hi * fi).sum(-2, dtype=torch.float32),
                         (hr * fi + hi * fr).sum(-2, dtype=torch.float32))


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.antenna_combine_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cl, cl, ci, vp]
    lib.antenna_combine_launch.restype = ci
    lib.antenna_combine_attributes.argtypes = [ci, ctypes.POINTER(ci)]
    lib.antenna_combine_attributes.restype = ci


def build_library() -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/antenna_combine.cu`` for sm_90a (once per source
    version) and load it (once a process, ``kernels/build.py``). Returns
    the library and ptxas's report."""
    return build.load_library(SOURCE, _declare)


def kernel_resources() -> list[dict]:
    """Each instantiation's registers, local memory (non-zero when ptxas
    spills) and resident blocks per SM, as the runtime reads them on the
    current card."""
    lib, _ = build_library()
    rows = []
    for vec in (VEC, 1):
        buf = (ctypes.c_int * 3)()
        err = lib.antenna_combine_attributes(vec, buf)
        if err:
            raise RuntimeError(f"antenna_combine_attributes: CUDA error {err}")
        rows.append({"vec": vec, "registers": buf[0], "local_bytes": buf[1],
                     "blocks_per_sm": buf[2]})
    return rows


def _batch_stride(re: torch.Tensor, im: torch.Tensor, names: str) -> int:
    """The frame stride of a pair of ``[B, n_ant, n_sc]`` planes whose rows
    are contiguous: 0 or ``n_ant * n_sc`` (any, read as 0, for one frame),
    the same for both."""
    b, n_ant, n_sc = re.shape
    stride = re.stride()
    if im.stride() != stride:
        raise ValueError(f"{names} must share their strides: {stride}, {im.stride()}")
    if (n_sc > 1 and stride[2] != 1) or (n_ant > 1 and stride[1] != n_sc):
        raise ValueError(f"{names} need contiguous rows [B, n_ant, n_sc], got strides {stride}")
    if b == 1:
        return 0
    if stride[0] not in (0, n_ant * n_sc):
        raise ValueError(f"{names} have batch stride {stride[0]}: expected 0 or "
                         f"n_ant * n_sc = {n_ant * n_sc}")
    return stride[0]


def antenna_combine(hr: torch.Tensor, hi: torch.Tensor, fr: torch.Tensor,
                    fi: torch.Tensor) -> torch.Tensor:
    """``sum_ant H o X`` for bf16 planes ``[B, n_ant, n_sc]`` (see the module
    docstring): complex64 ``[B, n_sc]``. One launch for CUDA tensors (counted
    in ``antenna_combine.launches``), :func:`antenna_combine_plain` for CPU
    tensors. Raises for other dtypes, shapes or devices that differ, rows
    that are not contiguous, or a batch stride other than 0 or
    ``n_ant * n_sc``."""
    bf16 = torch.bfloat16
    if not hr.dtype == hi.dtype == fr.dtype == fi.dtype == bf16:
        raise ValueError(f"the planes must be bfloat16, got {hr.dtype}, {hi.dtype}, "
                         f"{fr.dtype}, {fi.dtype}")
    shape, device = hr.shape, hr.device
    if len(shape) != 3 or not hi.shape == fr.shape == fi.shape == shape:
        raise ValueError("the four planes must share one shape [B, n_ant, n_sc], got "
                         f"{[tuple(t.shape) for t in (hr, hi, fr, fi)]}")
    if not hi.device == fr.device == fi.device == device:
        raise ValueError("the four planes must share a device")
    h_stride = _batch_stride(hr, hi, "hr and hi")
    x_stride = _batch_stride(fr, fi, "fr and fi")
    if device.type == "cpu":
        return antenna_combine_plain(hr, hi, fr, fi)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    frames, n_ant, n_sc = shape
    out = torch.empty(frames, n_sc, dtype=torch.complex64, device=device)
    if out.numel() == 0:
        return out
    ptrs = (hr.data_ptr(), hi.data_ptr(), fr.data_ptr(), fi.data_ptr())
    vec = VEC if n_sc % VEC == 0 and not any(p % 16 for p in ptrs) else 1
    lib, _ = build_library()
    err = lib.antenna_combine_launch(*ptrs, out.data_ptr(), frames, n_ant, n_sc, h_stride,
                                     x_stride, vec, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"antenna_combine launch failed: CUDA error {err}")
    antenna_combine.launches += 1
    return out


antenna_combine.launches = 0
