"""Fused IFFT -> PA -> FFT over rows of planes: the CUDA kernel of
``csrc/fused_pa.cu`` and its plain PyTorch version.

:func:`fused_ifft_pa_fft` is the wrapper. It takes real/imag planes
``[..., n_io]`` (float32 or bfloat16), one saturation power and one cubic
coefficient per row, and returns planes of the same shape and dtype:

* ``mode="full"``: ``FFT(PA(IFFT(x)))`` over all ``n_fft`` bins, the
  contract of the TPU kernel ``mimo_ofdm_tpu/kernels/fused_pa.py::fused_ifft_clip_fft``,
  which :func:`fused_ifft_clip_fft` keeps by name (complex frames of
  ``N = 4096`` bins, soft limiter);
* ``mode="sc"``: ``extract_sc(FFT(PA(IFFT(map_sc(x)))))`` over ``n_sc`` data
  bins in ``[neg | pos]`` order, the contract of
  ``mimo_ofdm_tpu/ops/mxu_fft.py::fused_sc_ifft_pa_fft_planar_io``.

Both transforms are ortho-normalized and run in float32; bf16 planes are
converted at load and store only.

:func:`fused_ifft_pa_fft_complex` is the same function on interleaved
complex64 ``[..., n_io]``, in and out, which the kernel reads and writes as
it is (no planes): ``storage="bfloat16"`` rounds each half to bf16 on the
way in and out, and so gives the bits of bf16 planes cast from and back to
complex64. :func:`fused_ifft_clip_fft` is its ``full`` mode at float32.

For a CUDA tensor the wrappers launch the kernel (built with ``nvcc`` at
first use into ``mimo_ofdm_tpu_torch/_build/`` and loaded with ``ctypes``)
or raise. For a CPU tensor they run :func:`fused_ifft_pa_fft_plain`. Both
count kernel launches in ``fused_ifft_pa_fft.launches``, and by I/O layout
(:data:`LAYOUTS`) in ``fused_ifft_pa_fft.launches_by_layout``; setting
``fused_ifft_pa_fft.force_plain = True`` runs the plain version on CUDA
tensors too, for comparing the two inside a whole frame (tests and
``chip_smoke.py`` only).

:func:`fused_ifft_pa_fft_staged` is a PyTorch model of the kernel's own
schedule (the radix-16 passes, the twiddle table, the shared-memory
exchanges with their swizzled addresses, the PA on the digit-reversed
samples). It is for the CPU tests only, which debug the kernel's index
and twiddle arithmetic with it; no entry point calls it.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the kernel's I/O layouts: name -> (interleaved complex64, bf16 rounding)
LAYOUTS = {"planes_f32": (False, False), "planes_bf16": (False, True),
           "interleaved_f32": (True, False), "interleaved_bf16": (True, True)}
N = 4096             # the one length fused_ifft_clip_fft takes, as the TPU kernel
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


def storage_dtype(storage: str) -> torch.dtype:
    """The dtype named by a chain's ``storage``; raises for other names."""
    if storage not in STORAGE_DTYPES:
        raise ValueError(f"unknown storage {storage!r} "
                         f"(expected one of {tuple(STORAGE_DTYPES)})")
    return STORAGE_DTYPES[storage]


def flops_per_row(n_fft: int, mode: str) -> int:
    """Real floating-point operations that one row of the function needs:
    two split-radix transforms of ``4 N log2 N - 6 N + 8`` each. In ``sc``
    mode (at ``n_sc = n_fft / 2``) half of the IFFT's input bins are zero,
    which saves about ``2 N`` additions of its first stage, and half of the
    FFT's output bins are dropped, which saves ``N`` of its last stage. The
    PA's few operations a sample are not counted, so a time bound built on
    this count stays a lower bound."""
    check_shapes(n_fft, n_fft if mode == "full" else n_fft // 2, mode)
    one = 4 * n_fft * (n_fft.bit_length() - 1) - 6 * n_fft + 8
    return 2 * one - (3 * n_fft if mode == "sc" else 0)


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
    td = ofdm.fd_to_td(x)
    pr, pi = apply_pa_planar(td.real, td.imag, pa_model, sat[..., None],
                             rapp_p, cubic_coeff[..., None])
    fd = ofdm.td_to_fd(torch.complex(pr, pi))
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
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, cf, cf,
                   cf, vp]
    fn.restype = ci
    attrs = lib.fused_ifft_pa_fft_attributes
    attrs.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
    attrs.restype = ci
    report = report_path.read_text() if report_path.exists() else ""
    return lib, report


def kernel_resources() -> list[dict]:
    """Every instantiation's resources (each size, mode and I/O layout), as
    the runtime reads them from the loaded kernel on the current card:
    registers, local memory (non-zero when ptxas spills), shared memory,
    resident blocks per SM."""
    lib, _ = build_library()
    rows = []
    for log2n in range(N_FFT_RANGE[0].bit_length() - 1, N_FFT_RANGE[1].bit_length()):
        for mode in MODES:
            for layout, (interleaved, bf16) in LAYOUTS.items():
                buf = (ctypes.c_int * 5)()
                err = lib.fused_ifft_pa_fft_attributes(
                    log2n, int(mode == "sc"), int(bf16), int(interleaved), buf)
                if err:
                    raise RuntimeError(f"fused_ifft_pa_fft_attributes: CUDA error {err}")
                rows.append({"n_fft": 1 << log2n, "mode": mode, "layout": layout,
                             "registers": buf[0],
                             "local_bytes": buf[1], "static_smem_bytes": buf[2],
                             "dynamic_smem_bytes": buf[3], "blocks_per_sm": buf[4]})
    return rows


POINTS = 16          # complex points a thread holds in registers


@dataclasses.dataclass(frozen=True)
class Schedule:
    """How the kernel splits one ``n_fft``-point row: ``threads`` threads of
    16 points each, three passes of radix 16, 16 and ``radix``
    (``radix == 1``: two passes), and the shared-memory float2 address of
    each thread's 16 registers in the exchanges, ``[threads, 16]`` each and
    already swizzled: ``e1_w``/``e1_r`` after pass 1 (written in pass-1
    layout, read in pass-2 layout), ``e2_w``/``e2_r`` after pass 2 (None
    when ``radix == 1``). The FFT runs the same exchanges with reads and
    writes swapped."""
    n_fft: int
    threads: int
    radix: int
    e1_w: np.ndarray
    e1_r: np.ndarray
    e2_w: np.ndarray | None
    e2_r: np.ndarray | None


def swizzle(addr):
    """The exchange buffers' bank swizzle (float2 units): bits 4-7 of the
    address flip its low 4 bits, so every half-warp's 16 accesses fall on
    16 distinct 8-byte bank pairs."""
    return addr ^ ((addr >> 4) & 15)


@functools.lru_cache(maxsize=None)
def schedule(n_fft: int) -> Schedule:
    """The kernel's split of an ``n_fft``-point row (``csrc/fused_pa.cu``
    computes the same addresses)."""
    check_shapes(n_fft, n_fft, "full")
    threads, radix = n_fft // POINTS, n_fft // 256
    t = np.arange(threads)[:, None]
    i = np.arange(POINTS)[None, :]
    k, a = t // radix, t % radix                 # pass-2/3 coordinates
    e1_w = i * threads + t                       # thread t, register k = i
    e1_r = k * threads + a + radix * i           # thread (k, a), register b = i
    e2_w = e2_r = None
    if radix > 1:
        e2_w = k * threads + i * radix + a       # thread (k, a), register c = i
        cl, aa = i // radix, i % radix           # thread (k, g = a), register cl*r + aa
        e2_r = k * threads + (a * (POINTS // radix) + cl) * radix + aa
        e2_w, e2_r = swizzle(e2_w), swizzle(e2_r)
    return Schedule(n_fft, threads, radix, swizzle(e1_w), swizzle(e1_r), e2_w, e2_r)


@functools.lru_cache(maxsize=None)
def twiddle_table(n_fft: int) -> np.ndarray:
    """The kernel's twiddles, computed in float64 and rounded to float32
    (re, im) pairs, in the order the kernel reads them: ``16 * threads``
    entries ``W^(t k)`` at ``k * threads + t`` for pass 1, then ``16 *
    radix`` entries ``W^(16 a c)`` at ``c * radix + a`` for pass 2, with
    ``W = exp(-2 pi i / n_fft)``. The IFFT takes the conjugates."""
    s = schedule(n_fft)
    k = np.arange(POINTS)[:, None]
    e1 = k * np.arange(s.threads)[None, :]
    e2 = 16 * k * np.arange(s.radix)[None, :]
    w = np.exp(-2j * np.pi * np.concatenate([e1.ravel(), e2.ravel()]) / n_fft)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    """:func:`twiddle_table` on ``device``."""
    return torch.from_numpy(twiddle_table(n_fft)).to(device)


def _sc_bins(n_fft: int, n_io: int, mode: str) -> np.ndarray:
    """For each FFT bin, its index in the ``[..., n_io]`` planes, or -1 for
    DC and the guard band: the kernel's load map, and its store map read
    the other way."""
    p = np.arange(n_fft)
    if mode == "full":
        return p
    h = n_io // 2
    return np.where((p >= 1) & (p <= h), p + h - 1,
                    np.where(p >= n_fft - h, p - (n_fft - h), -1))


def _dft_matrix(m: int, inverse: bool) -> torch.Tensor:
    """``[j, k] -> exp(-+2 pi i j k / m)`` in complex64, from float64."""
    j = np.arange(m)
    sign = 1.0 if inverse else -1.0
    return torch.from_numpy(np.exp(sign * 2j * np.pi * np.outer(j, j) / m)
                            .astype(np.complex64))


def fused_ifft_pa_fft_staged(xr, xi, sat, cubic_coeff, *, pa_model: str,
                             n_fft: int, mode: str = "sc",
                             rapp_p: float = 1.1):
    """The kernel's schedule in PyTorch, complex64 on the CPU (tests only).

    ``regs[row, t, i]`` is register ``i`` of thread ``t``. Each pass is a
    DFT over a thread's registers (``@`` a DFT matrix), each exchange a
    scatter to the swizzled shared-memory addresses of :func:`schedule` and
    a gather back. Arguments as :func:`fused_ifft_pa_fft_plain`."""
    check_shapes(n_fft, xr.shape[-1], mode)
    s = schedule(n_fft)
    T, r = s.threads, s.radix
    lead, n_io = xr.shape[:-1], xr.shape[-1]
    x = torch.complex(xr.to(torch.float32), xi.to(torch.float32)).reshape(-1, n_io)
    rows = x.shape[0]
    tw = torch.from_numpy(twiddle_table(n_fft))
    tw = torch.complex(tw[:, 0], tw[:, 1])
    tw1 = tw[:POINTS * T].reshape(POINTS, T).T                 # [t, k]
    tw2 = tw[POINTS * T:].reshape(POINTS, r).T[np.arange(T) % r]  # [t (k, a), c]
    norm = 1.0 / math.sqrt(n_fft)
    # register j of thread t holds bin t + T j
    bins = np.arange(n_fft).reshape(POINTS, T).T
    io = torch.from_numpy(_sc_bins(n_fft, n_io, mode)[bins])
    regs = torch.where(io >= 0, x[:, io.clamp(min=0)], 0) * norm

    def exchange(v, w_addr, r_addr):
        buf = torch.zeros(rows, n_fft, dtype=v.dtype)
        buf[:, torch.from_numpy(w_addr.ravel())] = v.reshape(rows, -1)
        return buf[:, torch.from_numpy(r_addr.ravel())].reshape(rows, T, POINTS)

    def dft_r(v, inverse):
        return (v.reshape(rows, T, POINTS // r, r) @ _dft_matrix(r, inverse)
                ).reshape(rows, T, POINTS)

    f16i, f16f = _dft_matrix(POINTS, True), _dft_matrix(POINTS, False)
    # IFFT, decimation in frequency
    regs = (regs @ f16i) * tw1.conj()
    regs = exchange(regs, s.e1_w, s.e1_r) @ f16i
    if r > 1:
        regs = dft_r(exchange(regs * tw2.conj(), s.e2_w, s.e2_r), True)
    # PA on the digit-reversed time samples, in registers
    sat = _row_param(sat, lead, "cpu").reshape(-1, 1, 1)
    coeff = _row_param(cubic_coeff, lead, "cpu").reshape(-1, 1, 1)
    pr, pi = apply_pa_planar(regs.real, regs.imag, pa_model, sat, rapp_p, coeff)
    regs = torch.complex(pr, pi)
    # FFT: the IFFT's passes transposed, in reverse order
    if r > 1:
        regs = exchange(dft_r(regs, False), s.e2_r, s.e2_w) * tw2
    regs = exchange(regs @ f16f, s.e1_r, s.e1_w) * tw1
    regs = (regs @ f16f) * norm
    out = torch.zeros(rows, n_io, dtype=regs.dtype)
    keep = io >= 0
    out[:, io[keep]] = regs[:, keep]
    out = out.reshape(*lead, n_io)
    return out.real.to(xr.dtype), out.imag.to(xi.dtype)


def _row_param(v, lead, device) -> torch.Tensor:
    """One float32 value per row. A Python scalar is filled on the device:
    copying it from the host would sync the stream."""
    if not isinstance(v, torch.Tensor):
        return torch.full(lead, float(v), dtype=torch.float32, device=device)
    return torch.broadcast_to(v.to(device=device, dtype=torch.float32),
                              lead).contiguous()


def _check_call(pa_model: str, n_fft: int, n_io: int, mode: str, device) -> None:
    if pa_model not in PA_MODELS:
        raise ValueError(f"unknown PA model {pa_model!r}")
    check_shapes(n_fft, n_io, mode)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {device}")


def _launch(ins, outs, n_io, sat, coeff, pa_model, n_fft, mode, rapp_p, layout):
    """One launch on contiguous CUDA tensors: ``ins``/``outs`` are the real
    and imag planes, or one ``view_as_real`` of complex64 each in the
    interleaved layouts; counted under ``layout``."""
    interleaved, bf16 = LAYOUTS[layout]
    for name, t in (*zip(("xr", "xi"), ins), ("sat", sat), ("cubic_coeff", coeff)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib, _ = build_library()
    ptrs = [t.data_ptr() for t in (*ins, *outs)]
    if interleaved:      # one array a side: no imag plane
        ptrs = [ptrs[0], None, ptrs[1], None]
    device = ins[0].device
    tw = _twiddles(n_fft, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.fused_ifft_pa_fft_launch(
        *ptrs, sat.data_ptr(), coeff.data_ptr(), tw.data_ptr(), sat.numel(),
        n_fft.bit_length() - 1, n_io, int(mode == "sc"), int(bf16), int(interleaved),
        PA_MODELS.index(pa_model), float(rapp_p), -1.0 / (2.0 * rapp_p),
        1.0 / math.sqrt(n_fft), stream)
    if err:
        raise RuntimeError(f"fused_ifft_pa_fft launch failed: CUDA error {err}")
    fused_ifft_pa_fft.launches += 1
    fused_ifft_pa_fft.launches_by_layout[layout] += 1


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
    _check_call(pa_model, n_fft, xr.shape[-1], mode, xr.device)
    lead = xr.shape[:-1]
    sat = _row_param(sat, lead, xr.device)
    coeff = _row_param(cubic_coeff, lead, xr.device)
    if xr.numel() == 0:                 # no rows: nothing to compute or launch
        return torch.empty_like(xr), torch.empty_like(xi)
    if xr.device.type == "cpu" or fused_ifft_pa_fft.force_plain:
        return fused_ifft_pa_fft_plain(xr, xi, sat, coeff, pa_model=pa_model,
                                       n_fft=n_fft, mode=mode, rapp_p=rapp_p)
    outr, outi = torch.empty_like(xr), torch.empty_like(xi)
    _launch((xr, xi), (outr, outi), xr.shape[-1], sat, coeff, pa_model, n_fft, mode,
            rapp_p, "planes_bf16" if xr.dtype == torch.bfloat16 else "planes_f32")
    return outr, outi


fused_ifft_pa_fft.launches = 0
fused_ifft_pa_fft.launches_by_layout = dict.fromkeys(LAYOUTS, 0)
fused_ifft_pa_fft.force_plain = False


def fused_ifft_pa_fft_complex(x: torch.Tensor, sat, cubic_coeff=0.0, *,
                              pa_model: str, n_fft: int, mode: str,
                              rapp_p: float = 1.1, storage: str = "float32"
                              ) -> torch.Tensor:
    """:func:`fused_ifft_pa_fft` on complex64 ``[..., n_io]``, returning
    complex64 of that shape, in one launch of the kernel's interleaved
    layout (counted in ``fused_ifft_pa_fft.launches``). ``storage`` names
    the dtype of the planes whose bits it gives: ``"bfloat16"`` rounds the
    input's halves to bf16 and the output's too, as ``.real``/``.imag``
    cast to bf16 planes and the result cast back would.

    Complex128 raises: cast to bf16 from float64 it rounds once, from
    complex64 twice, so its callers keep the plane route. A CPU tensor (or
    ``force_plain``) runs the plain version on such planes, bit for bit the
    plane route's result."""
    if x.dtype != torch.complex64:
        raise ValueError(f"x must be complex64, got {x.dtype}")
    st = storage_dtype(storage)
    _check_call(pa_model, n_fft, x.shape[-1], mode, x.device)
    lead = x.shape[:-1]
    sat = _row_param(sat, lead, x.device)
    coeff = _row_param(cubic_coeff, lead, x.device)
    if x.numel() == 0:
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.device.type == "cpu" or fused_ifft_pa_fft.force_plain:
        pr, pi = fused_ifft_pa_fft_plain(x.real.to(st), x.imag.to(st), sat, coeff,
                                         pa_model=pa_model, n_fft=n_fft, mode=mode,
                                         rapp_p=rapp_p)
        return torch.complex(pr.float(), pi.float())
    # one float2 array: no lazy conjugate or negative, no strides
    x = x.resolve_conj().resolve_neg().contiguous()
    out = torch.empty_like(x)
    _launch((torch.view_as_real(x),), (torch.view_as_real(out),), x.shape[-1], sat, coeff,
            pa_model, n_fft, mode, rapp_p,
            "interleaved_bf16" if st == torch.bfloat16 else "interleaved_f32")
    return out


def fused_ifft_clip_fft(x_fd: torch.Tensor, sat_power) -> torch.Tensor:
    """``FFT(softlimit(IFFT(x_fd)))`` with ortho norms: the kernel's
    ``full`` mode on complex64 ``[..., 4096]`` frames, read and written
    interleaved, with one scalar saturation power (a Python float or a 0-d
    tensor), returning complex64 of the same shape
    (``mimo_ofdm_tpu/kernels/fused_pa.py:113-152``). Like the TPU kernel
    it takes ``N = 4096`` bins and nothing else. A CUDA tensor launches the
    kernel (counted in ``fused_ifft_pa_fft.launches``), a CPU tensor runs
    the plain version."""
    if x_fd.dtype != torch.complex64:
        raise ValueError(f"x_fd must be complex64, got {x_fd.dtype}")
    if x_fd.shape[-1] != N:
        raise ValueError(f"fused_ifft_clip_fft takes {N} bins, got {x_fd.shape[-1]}")
    if isinstance(sat_power, torch.Tensor) and sat_power.ndim:
        raise ValueError("sat_power must be a scalar")
    return fused_ifft_pa_fft_complex(x_fd, sat_power, pa_model="softlim", n_fft=N,
                                     mode="full")
