"""Fused IFFT -> PA -> FFT over rows of planes: the CUDA kernel of
``csrc/fused_pa.cu`` and its plain PyTorch version.

:func:`fused_ifft_pa_fft` is the wrapper. It takes real/imag planes
``[..., n_io]`` (float32 or bfloat16), one saturation power and one cubic
coefficient per row, and returns planes of the same shape and dtype:

* ``mode="full"``: ``FFT(PA(IFFT(x)))`` over all ``n_fft`` bins, the
  contract of the TPU kernel ``mimo_ofdm_tpu/kernels/fused_pa.py::fused_ifft_clip_fft``;
* ``mode="sc"``: ``extract_sc(FFT(PA(IFFT(map_sc(x)))))`` over ``n_sc`` data
  bins in ``[neg | pos]`` order, the contract of
  ``mimo_ofdm_tpu/ops/mxu_fft.py::fused_sc_ifft_pa_fft_planar_io``.

Both transforms are ortho-normalized and run in float32; bf16 planes are
converted at load and store only.

For a CUDA tensor the wrapper launches the kernel (built with ``nvcc`` at
first use into ``mimo_ofdm_tpu_torch/_build/`` and loaded with ``ctypes``)
or raises. For a CPU tensor it runs :func:`fused_ifft_pa_fft_plain`. The
wrapper counts kernel launches in ``fused_ifft_pa_fft.launches``; setting
``fused_ifft_pa_fft.force_plain = True`` runs the plain version on CUDA
tensors too, for comparing the two inside a whole frame (tests and
``chip_smoke.py`` only).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from mimo_ofdm_tpu_torch.ops import ofdm
from mimo_ofdm_tpu_torch.ops.pa import PA_MODELS, apply_pa_planar

MODES = ("full", "sc")
N_FFT_RANGE = (256, 4096)
_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "fused_pa.cu"
BUILD_DIR = _PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def check_shapes(n_fft: int, n_io: int, mode: str) -> None:
    """Raise ``ValueError`` for a transform the kernel does not take:
    ``n_fft`` a power of two in ``[256, 4096]``; ``full`` mode reads all
    ``n_fft`` bins, ``sc`` mode an even ``n_sc < n_fft``."""
    lo, hi = N_FFT_RANGE
    if n_fft & (n_fft - 1) or not lo <= n_fft <= hi:
        raise ValueError(f"n_fft={n_fft} is not a power of two in [{lo}, {hi}]")
    if mode == "full":
        if n_io != n_fft:
            raise ValueError(f"full mode needs n_fft={n_fft} bins, got {n_io}")
    elif mode == "sc":
        if n_io % 2 or not 0 < n_io < n_fft:
            raise ValueError(f"sc mode needs an even n_sc < n_fft={n_fft}, got {n_io}")
    else:
        raise ValueError(f"unknown mode {mode!r} (expected one of {MODES})")


def fused_ifft_pa_fft_plain(xr, xi, sat, cubic_coeff, *, pa_model: str,
                            n_fft: int, mode: str = "sc",
                            rapp_p: float = 1.1):
    """Plain PyTorch version in complex64: ``map_sc -> ifft -> PA -> fft ->
    extract_sc`` (``sc``) or ``ifft -> PA -> fft`` (``full``). ``sat`` and
    ``cubic_coeff`` are per-row ``[...]`` float32 tensors."""
    x = torch.complex(xr.to(torch.float32), xi.to(torch.float32))
    n_io = x.shape[-1]
    if mode == "sc":
        x = ofdm.map_subcarriers(x, n_fft)
    td = torch.fft.ifft(x, dim=-1, norm="ortho")
    pr, pi = apply_pa_planar(td.real, td.imag, pa_model, sat[..., None],
                             rapp_p, cubic_coeff[..., None])
    fd = torch.fft.fft(torch.complex(pr, pi), dim=-1, norm="ortho")
    if mode == "sc":
        fd = ofdm.extract_subcarriers(fd, n_io)
    return fd.real.to(xr.dtype), fd.imag.to(xi.dtype)


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the fused_pa kernel "
                       "is built from csrc/fused_pa.cu at first use")


@functools.lru_cache(maxsize=None)
def build_library() -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/fused_pa.cu`` for sm_90a (once per source version)
    and load it. Returns the library and ptxas's register/shared-memory
    report."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"libfused_pa_{digest}.so"
    report_path = so.with_suffix(".ptxas.txt")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"libfused_pa_{digest}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        report_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.fused_ifft_pa_fft_launch
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, cf,
                   cf, vp]
    fn.restype = ci
    report = report_path.read_text() if report_path.exists() else ""
    return lib, report


@functools.lru_cache(maxsize=None)
def _twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """``exp(-2 pi i t / n_fft)`` for ``t < n_fft``, computed in float64 and
    stored as interleaved float32 (re, im) pairs on ``device``."""
    w = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    pairs = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(pairs).to(device)


def _row_param(v, lead, device) -> torch.Tensor:
    """One float32 value per row. A Python scalar is filled on the device:
    copying it from the host would sync the stream."""
    if not isinstance(v, torch.Tensor):
        return torch.full(lead, float(v), dtype=torch.float32, device=device)
    return torch.broadcast_to(v.to(device=device, dtype=torch.float32),
                              lead).contiguous()


def _launch(xr, xi, sat, coeff, pa_model, n_fft, mode, rapp_p):
    for name, t in (("xr", xr), ("xi", xi), ("sat", sat), ("cubic_coeff", coeff)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib, _ = build_library()
    outr = torch.empty_like(xr)
    outi = torch.empty_like(xi)
    rows = xr.numel() // xr.shape[-1] if xr.numel() else 0
    tw = _twiddles(n_fft, xr.device)
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    err = lib.fused_ifft_pa_fft_launch(
        xr.data_ptr(), xi.data_ptr(), outr.data_ptr(), outi.data_ptr(),
        sat.data_ptr(), coeff.data_ptr(), tw.data_ptr(), rows,
        n_fft.bit_length() - 1, xr.shape[-1], int(mode == "sc"),
        int(xr.dtype == torch.bfloat16), PA_MODELS.index(pa_model),
        float(rapp_p), -1.0 / (2.0 * rapp_p), 1.0 / math.sqrt(n_fft), stream)
    if err:
        raise RuntimeError(f"fused_ifft_pa_fft launch failed: CUDA error {err}")
    return outr, outi


def fused_ifft_pa_fft(xr: torch.Tensor, xi: torch.Tensor, sat,
                      cubic_coeff=0.0, *, pa_model: str = "softlim",
                      n_fft: int, mode: str = "sc", rapp_p: float = 1.1
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``FFT(PA(IFFT(.)))`` over the last axis of the planes ``xr``/``xi``
    (see the module docstring for the two modes). ``sat`` and
    ``cubic_coeff`` broadcast to the planes' leading dims (one value per
    row). Returns planes of the input's shape and dtype."""
    if xr.shape != xi.shape or xr.dtype != xi.dtype or xr.device != xi.device:
        raise ValueError("xr and xi must share shape, dtype and device")
    if xr.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"planes must be float32 or bfloat16, got {xr.dtype}")
    if pa_model not in PA_MODELS:
        raise ValueError(f"unknown PA model {pa_model!r}")
    check_shapes(n_fft, xr.shape[-1], mode)
    lead = xr.shape[:-1]
    sat = _row_param(sat, lead, xr.device)
    coeff = _row_param(cubic_coeff, lead, xr.device)
    if xr.device.type == "cpu" or (xr.is_cuda and fused_ifft_pa_fft.force_plain):
        return fused_ifft_pa_fft_plain(xr, xi, sat, coeff, pa_model=pa_model,
                                       n_fft=n_fft, mode=mode, rapp_p=rapp_p)
    if not xr.is_cuda:
        raise ValueError(f"no kernel for device {xr.device}")
    out = _launch(xr, xi, sat, coeff, pa_model, n_fft, mode, rapp_p)
    fused_ifft_pa_fft.launches += 1
    return out


fused_ifft_pa_fft.launches = 0
fused_ifft_pa_fft.force_plain = False
