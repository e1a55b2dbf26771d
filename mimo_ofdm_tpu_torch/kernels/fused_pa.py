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

Both transforms are ortho-normalized. The float32 layouts run them in
float32 (CUDA cores). The bf16 layouts run JAX's bf16 contract
(``mxu_fft.py:375-384``) on the tensor cores: every DFT pass is a bf16
matrix product with float32 accumulation, and its operand is rounded to bf16
once, after the twiddle (or the PA) in float32.

:func:`fused_ifft_pa_fft_complex` is the same function on interleaved
complex64 ``[..., n_io]``, in and out, which the kernel reads and writes as
it is (no planes): ``storage="bfloat16"`` rounds each half to bf16 on the
way in and out, and so gives the bits of bf16 planes cast from and back to
complex64. :func:`fused_ifft_clip_fft` is its ``full`` mode at float32.

:func:`fused_precoded_ifft_pa_fft` is the ``sc`` chain of the single-user
transmitter with its MRT precode as the kernel's load: it takes the frames'
complex64 symbols ``s [..., n_sc]`` and the precoder's planes ``V [...,
n_ant, n_sc]`` and gives the chain's output planes for ``s o V`` (the
precoded layouts), bit for bit what :func:`precode_planes` followed by
:func:`fused_ifft_pa_fft` gives, without writing the precoded planes.
:func:`fused_precoded_mu_ifft_pa_fft` is the multi-user transmitter's
``sc`` chain with its joint precode ``sum_u s_u o V_u`` as the load: every
user's complex64 symbols (in an MCNC-MU replica pass one user's swapped for
its detection) and the complex64 precoder ``V [..., n_ant, n_usr, n_sc]`` in,
complex64 out (the precoded_mu layouts), bit for bit
:func:`precode_users` followed by :func:`fused_ifft_pa_fft_complex`, without
writing the users' products or their sum.

For a CUDA tensor the wrappers launch the kernel (built with ``nvcc`` at
first use into ``mimo_ofdm_tpu_torch/_build/`` and loaded with ``ctypes``)
or raise. For a CPU tensor, or inside ``kernels.plain_versions()``, they
run the layout's plain version (:func:`mimo_ofdm_tpu_torch.kernels.runs_kernel`
decides): :func:`fused_ifft_pa_fft_plain` (exact float32 transforms) for
the float32 layouts, :func:`fused_ifft_pa_fft_bf16` (the tensor-core
passes, their bf16 rounding points and float32 sums) for the bf16 ones.
Kernel launches count in ``fused_ifft_pa_fft.launches``, and by I/O layout
(:data:`LAYOUTS`) in ``fused_ifft_pa_fft.launches_by_layout``.

:func:`fused_ifft_pa_fft_staged` is a PyTorch model of the kernel's own
schedule (the radix-16 passes, the twiddle table, the shared-memory
exchanges with their swizzled addresses, the PA on the digit-reversed
samples). It is for the CPU tests only, which debug the kernel's index
and twiddle arithmetic with it; no entry point calls it.
:func:`tensor_schedule` gives the tensor-core kernel's exchange chunks for
the same tests; :func:`fused_ifft_pa_fft_bf16` runs that kernel's passes
and roundings with its exchanges as plain transposes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os
import re
import subprocess

import numpy as np
import torch

from mimo_ofdm_tpu_torch.kernels import build, runs_kernel
from mimo_ofdm_tpu_torch.ops import ofdm
from mimo_ofdm_tpu_torch.ops.pa import PA_MODELS, apply_pa_planar

MODES = ("full", "sc")
STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the kernel's I/O layouts: name -> (how a point is read and written, bf16
# rounding); the kinds in the kernel's order (csrc/fused_pa.cu, enum Io)
IO_KINDS = ("planes", "interleaved", "precoded", "precoded_mu")
LAYOUTS = {"planes_f32": ("planes", False), "planes_bf16": ("planes", True),
           "interleaved_f32": ("interleaved", False), "interleaved_bf16": ("interleaved", True),
           "precoded_f32": ("precoded", False), "precoded_bf16": ("precoded", True),
           "precoded_mu_f32": ("precoded_mu", False), "precoded_mu_bf16": ("precoded_mu", True)}
SC_ONLY = ("precoded", "precoded_mu")     # the kinds built in sc mode alone
N = 4096             # the one length fused_ifft_clip_fft takes, as the TPU kernel
N_FFT_RANGE = (256, 4096)
SOURCE = build.PACKAGE_DIR / "csrc" / "fused_pa.cu"


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


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.fused_ifft_pa_fft_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, cl, cl,
                                             cl, ci, ci, ci, ci, ci, ci, ci, cf, cf, cf, vp]
    lib.fused_ifft_pa_fft_launch.restype = ci
    lib.fused_ifft_pa_fft_attributes.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
    lib.fused_ifft_pa_fft_attributes.restype = ci


def build_library() -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/fused_pa.cu`` for sm_90a (once per source version)
    and load it (once a process, ``kernels/build.py``). Returns the library
    and ptxas's register/shared-memory report."""
    return build.load_library(SOURCE, _declare)


def kernel_resources() -> list[dict]:
    """Every instantiation's resources (each size, mode and I/O layout; the
    precoded kinds, :data:`SC_ONLY`, in ``sc`` mode only), as the runtime reads them from
    the loaded kernel on the current card:
    registers, local memory (non-zero when ptxas spills), shared memory,
    resident blocks per SM, whether it is the tensor-core kernel, and the
    tensor-core instructions (``HMMA``, ``HGMMA``) in its SASS."""
    lib, _ = build_library()
    mma = sass_mma_counts()
    rows = []
    for log2n in range(N_FFT_RANGE[0].bit_length() - 1, N_FFT_RANGE[1].bit_length()):
        for mode in MODES:
            for layout, (io, bf16) in LAYOUTS.items():
                if io in SC_ONLY and mode != "sc":
                    continue
                buf = (ctypes.c_int * 6)()
                err = lib.fused_ifft_pa_fft_attributes(
                    log2n, int(mode == "sc"), int(bf16), IO_KINDS.index(io), buf)
                if err:
                    raise RuntimeError(f"fused_ifft_pa_fft_attributes: CUDA error {err}")
                rows.append({"n_fft": 1 << log2n, "mode": mode, "layout": layout,
                             "registers": buf[0],
                             "local_bytes": buf[1], "static_smem_bytes": buf[2],
                             "dynamic_smem_bytes": buf[3], "blocks_per_sm": buf[4],
                             "tensor_cores": bool(buf[5]),
                             "sass_mma": mma.get((1 << log2n, mode, layout), 0)})
    return rows


# a kernel's mangled name: the kernel, <LOG2N, SC, IO>
_MANGLED = re.compile(r"(fused_ifft_pa_fft(?:_tc)?_kernel)ILi(\d+)ELb([01])E"
                      r"NS_(?:(6Planes|8Precoded)I(f|13__nv_bfloat16)E|11InterleavedILb([01])EE"
                      r"|10PrecodedMuILb([01])EE)")


def instantiation(mangled: str) -> tuple[int, str, str] | None:
    """``(n_fft, mode, layout)`` of an instantiation of the kernel from its
    mangled name, or None for any other function."""
    m = _MANGLED.search(mangled)
    if m is None:
        return None
    _, log2n, sc, kind, plane, inter, mu = m.groups()
    if plane:
        layout = f"{kind[1:].lower()}_{'f32' if plane == 'f' else 'bf16'}"
    else:
        layout = (f"interleaved_{'bf16' if inter == '1' else 'f32'}" if inter is not None
                  else f"precoded_mu_{'bf16' if mu == '1' else 'f32'}")
    return 1 << int(log2n), "sc" if sc == "1" else "full", layout


def sass_mma_counts() -> dict:
    """``(n_fft, mode, layout) -> `` the number of tensor-core instructions
    (``HMMA``, ``HGMMA``) in each instantiation's SASS, from ``cuobjdump
    -sass`` of the built library (the CUDA toolkit's, beside ``nvcc``)."""
    _, so = build.library_path(SOURCE)
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        key = instantiation(part.split("\n", 1)[0])
        if key is not None:
            out[key] = len(re.findall(r"\bH(?:G)?MMA\b", part))
    return out


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


def _twiddles64(n_fft: int, ortho_pass1: bool) -> np.ndarray:
    """The twiddles in complex128: ``16 * threads`` entries ``W^(t k)`` at
    ``k * threads + t`` (times ``1 / sqrt(n_fft)`` with ``ortho_pass1``),
    then ``16 * radix`` entries ``W^(16 a c)`` at ``c * radix + a``, with
    ``W = exp(-2 pi i / n_fft)``."""
    s = schedule(n_fft)
    k = np.arange(POINTS)[:, None]
    e1 = k * np.arange(s.threads)[None, :]
    e2 = 16 * k * np.arange(s.radix)[None, :]
    w1 = np.exp(-2j * np.pi * e1.ravel() / n_fft)
    if ortho_pass1:
        w1 = w1 / math.sqrt(n_fft)
    return np.concatenate([w1, np.exp(-2j * np.pi * e2.ravel() / n_fft)])


def _pairs(w: np.ndarray) -> np.ndarray:
    """Complex values as float32 (re, im) pairs, each rounded once."""
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def twiddle_table(n_fft: int) -> np.ndarray:
    """The kernel's twiddles, computed in float64 and rounded to float32
    (re, im) pairs, in the order the kernel reads them: ``16 * threads``
    entries ``W^(t k)`` at ``k * threads + t`` for pass 1, then ``16 *
    radix`` entries ``W^(16 a c)`` at ``c * radix + a`` for pass 2, with
    ``W = exp(-2 pi i / n_fft)``. The IFFT takes the conjugates."""
    return _pairs(_twiddles64(n_fft, False))


@functools.lru_cache(maxsize=None)
def tensor_twiddle_table(n_fft: int) -> np.ndarray:
    """The bf16 layouts' twiddles: :func:`twiddle_table`'s layout, with the
    ortho ``1 / sqrt(n_fft)`` folded into the ``W^(t k)`` section (in
    float64, then rounded), since the tensor-core kernel applies it with
    that twiddle, in both transforms."""
    return _pairs(_twiddles64(n_fft, True))


@functools.lru_cache(maxsize=None)
def tensor_kernel_table(n_fft: int) -> np.ndarray:
    """What the tensor-core kernel reads, ``[640 R + 512, 2]`` float32 (``R
    = n_fft / 256``): the values of :func:`tensor_twiddle_table` gathered
    in the order a warp's lanes read them, so that each load is 256
    contiguous bytes, then the DFT matrices' B fragments. For lane ``l``
    (``g = l // 4``, ``q = l % 4``) and accumulator element ``(h, e)`` of
    a tile (row ``g + 8 (e // 2)``, point ``8 h + 2 q + e % 2``), at entry
    ``[section][reg][lane]``:

    * ``W^(t k) / sqrt(n)`` after IFFT pass 1, ``[tile][4 h + e][l]``:
      ``t = 16 tile + row``, ``k = point``;
    * ``W^(16 a c)`` after IFFT pass 2, ``[tile][2 h + e % 2][l]``: ``a =
      tile``, ``c = point``;
    * ``W^(16 a c)`` after FFT pass 3, ``[4 h + e][l]``: ``c = row``, ``a =
      point % R``;
    * ``W^(t k) / sqrt(n)`` after FFT pass 2, ``[tile][4 h + e][l]``: ``k
      = row``, ``t = tile + R point``;
    * the DFT-16's and the block-diagonal DFT-R's B fragments, 128 entries
      each: 32-bit words ``[c[h][r] | s[h][r]][l]`` (word ``2 h + r``, then
      ``4 + 2 h + r``), each two bf16 (the low half the even row) of the
      cos and sin parts of :func:`_tensor_dft`, rows ``2 q + 8 r`` and one
      on, column ``8 h + g``."""
    r = n_fft // 256
    T = n_fft // TILE
    nat = tensor_twiddle_table(n_fft)
    tw1, tw2 = nat[:TILE * T], nat[TILE * T:]
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    reg = np.arange(8)[:, None]
    h, e = reg // 4, reg % 4
    row, point = g + 8 * (e // 2), 8 * h + 2 * q + e % 2          # [8, 32]
    tau = np.arange(r)[:, None, None]
    s1 = tw1[point * T + TILE * tau + row]                         # [R, 8, 32, 2]
    reg2 = np.arange(4)[:, None]
    s2 = tw2[(8 * (reg2 // 2) + 2 * q + reg2 % 2) * r + tau]       # [R, 4, 32, 2]
    s3 = tw2[row * r + point % r]                                  # [8, 32, 2]
    s4 = tw1[row * T + tau + r * point]                            # [R, 8, 32, 2]
    mats = [_b_fragments(16), _b_fragments(max(r, 2))]
    return np.concatenate([s1.reshape(-1, 2), s2.reshape(-1, 2), s3.reshape(-1, 2),
                           s4.reshape(-1, 2), *mats]).astype(np.float32)


def _b_fragments(radix: int) -> np.ndarray:
    """The B fragments of :func:`_tensor_dft` ``(radix)`` as the kernel's
    ``load_matrix`` reads them: ``[8 words, 32 lanes]`` uint32 viewed as
    ``[128, 2]`` float32."""
    big = _tensor_dft(radix, True)
    bits = {"c": big[:TILE, :TILE], "s": big[:TILE, TILE:]}       # inverse: C + i S
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    words = []
    for part in ("c", "s"):
        b = bits[part].to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
        for h in range(2):
            for rr in range(2):
                k, n = 2 * q + 8 * rr, 8 * h + g
                words.append(b[k, n] | (b[k + 1, n] << 16))
    return np.ascontiguousarray(np.stack(words).astype(np.uint32)).view(np.float32).reshape(-1, 2)


@functools.lru_cache(maxsize=None)
def _twiddles(n_fft: int, device: torch.device, tensor: bool = False) -> torch.Tensor:
    """:func:`twiddle_table` (or, ``tensor``, :func:`tensor_kernel_table`)
    on ``device``."""
    table = tensor_kernel_table(n_fft) if tensor else twiddle_table(n_fft)
    return torch.from_numpy(table).to(device)


# --- the bf16 layouts: the tensor-core kernel's schedule and plain version ---

TILE = 16            # a tensor-core tile: 16 columns of 16 points


def chunk_swizzle(u):
    """The tensor-core kernel's exchange swizzle, in 16-byte chunks of 8
    bf16: the low 3 bits of ``u`` (its bank group) xor every higher 3-bit
    digit of ``u``. Three consecutive bits of ``u`` then always land on
    three distinct bits of the bank group."""
    v = u >> 3
    return u ^ ((v ^ (v >> 3) ^ (v >> 6)) & 7)


@dataclasses.dataclass(frozen=True)
class TensorSchedule:
    """How the tensor-core kernel (the bf16 layouts) splits one
    ``n_fft``-point row: ``tiles`` tiles of 16 x 16 points (``tiles`` is
    also the radix of the third pass; 1: two passes), and for each side of
    its two exchanges the swizzled 16-byte chunk that each lane of a warp
    addresses with ``stmatrix``/``ldmatrix``, ``[tiles, 32]``: lane ``l``
    gives row ``l % 8`` of the 8 x 8 matrix ``l // 8``. The row side moves
    8 consecutive points of one tile row (``e1_rows``: pass 1 writes it in
    the IFFT, pass 1 reads it in the FFT; ``e2_rows``: pass 2), the column
    side 8 consecutive rows of one point (``.trans``; ``e1_cols``: pass 2,
    ``e2_cols``: pass 3). ``e2_*`` is None when ``tiles == 1``."""
    n_fft: int
    tiles: int
    e1_rows: np.ndarray
    e1_cols: np.ndarray
    e2_rows: np.ndarray | None
    e2_cols: np.ndarray | None


def _tensor_chunks(n_fft: int):
    """The kernel's chunk index (before the swizzle) of each exchange side
    as a function of (tile, index, half): ``rows`` takes a tile row ``m``
    and the half of its 16 points, ``cols`` a point ``kk`` and the half of
    the tile's 16 rows."""
    r = n_fft // 256
    return {"e1": (lambda tau, m, h: 2 * (16 * tau + m) + h,      # t = 16 tau + m, k
                   lambda a, kk, mh: 2 * (a + r * kk) + mh),       # t = a + R b, b = kk
            "e2": (lambda a, m, h: 2 * (m * r + a) + h,            # (k = m, a), c
                   lambda tau, kk, mh: 2 * (16 * tau + kk) + mh)}  # (k, a) = 16 tau + kk, c


@functools.lru_cache(maxsize=None)
def tensor_schedule(n_fft: int) -> TensorSchedule:
    """The tensor-core kernel's split of an ``n_fft``-point row
    (``csrc/fused_pa.cu``, ``fused_ifft_pa_fft_tc_kernel``, computes the
    same chunks)."""
    check_shapes(n_fft, n_fft, "full")
    r = n_fft // 256
    tau = np.arange(r)[:, None]
    lane = np.arange(32)[None, :]
    i, row = lane >> 3, lane & 7
    chunks = _tensor_chunks(n_fft)
    tables = {}
    for name, (rows_fn, cols_fn) in chunks.items():
        tables[f"{name}_rows"] = chunk_swizzle(rows_fn(tau, row + 8 * (i & 1), i >> 1))
        tables[f"{name}_cols"] = chunk_swizzle(cols_fn(tau, row + 8 * (i >> 1), i & 1))
    if r == 1:
        tables["e2_rows"] = tables["e2_cols"] = None
    return TensorSchedule(n_fft, r, **tables)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and widened back to float32."""
    return t.to(torch.bfloat16).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _tensor_dft(radix: int, inverse: bool) -> torch.Tensor:
    """One tensor-core pass as a real ``[32, 32]`` matrix of bf16 values (in
    float32), the kernel's B operand: rows ``[Re | Im]`` of 16 input
    points, columns ``[Re | Im]`` of 16 outputs, the DFT-``radix`` matrix
    ``exp(+-2 pi i a d / radix)`` on each diagonal block (``radix`` 16:
    the DFT-16), rounded to bf16 from float64."""
    k = np.arange(TILE)
    on = (k[:, None] // radix) == (k[None, :] // radix)
    ang = 2 * np.pi * ((k[:, None] % radix) * (k[None, :] % radix) % radix) / radix
    c = np.where(on, np.cos(ang), 0.0)
    s = np.where(on, np.sin(ang), 0.0)
    c[np.abs(c) < 1e-12] = 0.0              # exact zeros, as the kernel's constants
    s[np.abs(s) < 1e-12] = 0.0
    mi = s if inverse else -s
    big = np.block([[c, mi], [-mi, c]])     # x [Re | Im] -> [Re | Im] of x (C + i mi)
    return torch.from_numpy(big).to(torch.bfloat16).to(torch.float32)


def fused_ifft_pa_fft_bf16(xr, xi, sat, cubic_coeff, *, pa_model: str,
                           n_fft: int, mode: str = "sc", rapp_p: float = 1.1):
    """The plain version of the bf16 layouts (the tensor-core kernel's
    arithmetic) in PyTorch, on any device: the input rounded to bf16; each
    pass a product of bf16 values with float32 sums (a float32 matmul of
    bf16-exact operands, :func:`_tensor_dft`); the twiddles
    (:func:`tensor_twiddle_table`, the ortho scale in them) and the PA in
    float32 on the sums; each pass's operand rounded to bf16 once, at the
    exchange before it. Arguments as :func:`fused_ifft_pa_fft_plain`;
    returns planes of the input's dtype (bf16 planes: the store rounds).

    The passes, for ``n_fft = 256 R`` (``T = 16 R``), each on ``R`` tiles
    ``[16 rows, 16 points]`` of a row: 1. rows ``t = 16 tau + m``, points
    ``j`` (bin ``t + T j``), twiddle ``conj W^(t k) / sqrt(n)``; 2. rows
    ``(k, a)``, points ``b`` (``t = a + R b``), twiddle ``conj W^(16 a
    c)``; 3. rows ``c``, points ``(s, a)`` of ``16 / R`` columns ``k``, a
    block-diagonal DFT-``R``; the PA; the FFT the same passes transposed,
    in reverse. The kernel moves the points between passes through shared
    memory (:func:`tensor_schedule`); here each exchange is the transpose
    it amounts to."""
    check_shapes(n_fft, xr.shape[-1], mode)
    r, T = n_fft // 256, n_fft // TILE
    lead, n_io, dtype, device = xr.shape[:-1], xr.shape[-1], xr.dtype, xr.device
    xr = _bf16(xr.reshape(-1, n_io))
    xi = _bf16(xi.reshape(-1, n_io))
    rows = xr.shape[0]
    tw = torch.from_numpy(tensor_twiddle_table(n_fft)).to(device)
    tau = torch.arange(r, device=device)[:, None, None]
    m = torch.arange(TILE, device=device)[None, :, None]
    n = torch.arange(TILE, device=device)[None, None, :]
    bins = (TILE * tau + m + T * n).cpu().numpy()            # pass 1's points j = n
    io = torch.from_numpy(_sc_bins(n_fft, n_io, mode)[bins]).to(device)
    keep = io >= 0
    idx = io.clamp(min=0)
    re = torch.where(keep, xr[:, idx], 0.0)
    im = torch.where(keep, xi[:, idx], 0.0)

    def product(re, im, radix, inverse):
        y = torch.cat([re, im], -1) @ _tensor_dft(radix, inverse).to(device)
        return y[..., :TILE], y[..., TILE:]

    def twiddle(re, im, at, conj):
        w = tw[torch.broadcast_to(at, (r, TILE, TILE))]
        wr, wi = w[..., 0], (-w[..., 1] if conj else w[..., 1])
        return re * wr - im * wi, re * wi + im * wr

    # each exchange rounds to bf16 and moves [rows, tiles, 16, 16] from one
    # pass's (row, point) to the next's
    def e1(v):          # (t = 16 tau + m, k) -> (a, k, b), t = a + R b
        return _bf16(v).reshape(rows, TILE, r, TILE).permute(0, 2, 3, 1)

    def e1_back(v):     # (a, k, b) -> (t, k)
        return _bf16(v).permute(0, 3, 1, 2).reshape(rows, r, TILE, TILE)

    def e2(v):          # (a, k, c) -> (tau, c, n), 16 tau + n = k R + a
        v = _bf16(v).transpose(1, 2).reshape(rows, TILE * r, TILE).transpose(1, 2)
        return v.reshape(rows, TILE, r, TILE).transpose(1, 2)

    def e2_back(v):     # (tau, c, n) -> (a, k, c)
        v = _bf16(v).transpose(1, 2).reshape(rows, TILE, TILE * r).transpose(1, 2)
        return v.reshape(rows, TILE, r, TILE).transpose(1, 2)

    at1 = T * n + TILE * tau + m                  # W^(t k) / sqrt(n): k = n, t = 16 tau + m
    at2 = 16 * T + n * r + tau                    # W^(16 a c): a = tau, c = n
    at3 = 16 * T + m * r + n % r                  # W^(16 a c): c = m, a = n % R
    at2f = T * m + tau + r * n                    # W^(t k): k = m, t = tau + R b, b = n
    # IFFT
    re, im = twiddle(*product(re, im, TILE, True), at1, True)
    re, im = product(e1(re), e1(im), TILE, True)
    if r > 1:
        re, im = twiddle(re, im, at2, True)
        re, im = product(e2(re), e2(im), r, True)
    # PA on the time samples
    sat = _row_param(sat, lead, device).reshape(-1, 1, 1, 1)
    coeff = _row_param(cubic_coeff, lead, device).reshape(-1, 1, 1, 1)
    re, im = apply_pa_planar(re, im, pa_model, sat, rapp_p, coeff)
    re, im = _bf16(re), _bf16(im)
    # FFT: the passes transposed, in reverse order
    if r > 1:
        re, im = twiddle(*product(re, im, r, False), at3, False)
        re, im = e2_back(re), e2_back(im)
    re, im = twiddle(*product(re, im, TILE, False), at2f, False)
    re, im = product(e1_back(re), e1_back(im), TILE, False)
    outr = torch.zeros(rows, n_io, dtype=re.dtype, device=device)
    outi = torch.zeros_like(outr)
    outr[:, io[keep]] = re[:, keep]
    outi[:, io[keep]] = im[:, keep]
    return outr.reshape(*lead, n_io).to(dtype), outi.reshape(*lead, n_io).to(dtype)


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


def _plain_version(dtype: torch.dtype):
    """The plain version of the layouts of ``dtype``: the bf16 layouts'
    tensor-core arithmetic, or the exact float32 transforms."""
    return fused_ifft_pa_fft_bf16 if dtype == torch.bfloat16 else fused_ifft_pa_fft_plain


def _float2(z: torch.Tensor) -> torch.Tensor:
    """complex64 as the kernel reads it: one float2 array, no lazy conjugate
    or negative, no strides."""
    return torch.view_as_real(z.resolve_conj().resolve_neg().contiguous())


def _launch(ins, sat, coeff, io, dtype, *, pa_model, n_fft, mode, rapp_p, outs=None,
            sym=None, det=None, n_ant=0, n_usr=0, v_strides=(0, 0, 0)):
    """One launch of the layout ``io`` at ``dtype`` (bf16: the tensor-core
    kernel, with :func:`tensor_kernel_table`) into ``outs`` (default: new
    tensors like ``ins``), which it returns; counted under that layout.
    ``ins`` and ``outs`` are CUDA tensors, contiguous: the real and imag
    planes, or one :func:`_float2` in the interleaved layouts; the precoded
    layouts read the precoder's planes as ``ins`` and the symbols ``sym``
    (a :func:`_float2`, one row of it for each ``n_ant`` rows); the
    precoded_mu layouts read the complex64 precoder ``[frames, n_ant,
    n_usr, n_sc]`` as ``ins`` (a float view, its frame, antenna and user
    strides ``v_strides`` in complex points), every user's symbols ``sym``
    and the replica pass's detections ``det`` (or None), and write one
    :func:`_float2`. No rows: the outputs, and no launch."""
    outs = tuple(map(torch.empty_like, ins)) if outs is None else outs
    if not sat.numel():                 # no rows: nothing to compute or launch
        return outs
    bf16 = dtype == torch.bfloat16
    layout = f"{io}_{'bf16' if bf16 else 'f32'}"
    one = io in ("interleaved", "precoded_mu")       # one complex64 array a side
    named = (*zip(("xr", "xi"), ins if io != "precoded_mu" else ()), ("sat", sat),
             ("cubic_coeff", coeff), ("sym", sym), ("det", det))
    for name, t in named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib, _ = build_library()
    ptrs = [t.data_ptr() for t in (*ins, *outs)]
    if one:                      # no imag plane
        ptrs = [ptrs[0], None, ptrs[1], None]
    device = ins[0].device
    tw = _twiddles(n_fft, device, bf16)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.fused_ifft_pa_fft_launch(
        *ptrs, sat.data_ptr(), coeff.data_ptr(), tw.data_ptr(),
        None if sym is None else sym.data_ptr(), None if det is None else det.data_ptr(),
        n_ant, n_usr, *v_strides,
        sat.numel(), n_fft.bit_length() - 1, outs[0].shape[-2 if one else -1],
        int(mode == "sc"), int(bf16), IO_KINDS.index(io),
        PA_MODELS.index(pa_model), float(rapp_p), -1.0 / (2.0 * rapp_p),
        1.0 / math.sqrt(n_fft), stream)
    if err:
        raise RuntimeError(f"fused_ifft_pa_fft launch failed: CUDA error {err}")
    fused_ifft_pa_fft.launches += 1
    fused_ifft_pa_fft.launches_by_layout[layout] += 1
    return outs


def _chain(shape, device, sat, cubic_coeff, plain, launch, *, pa_model, n_fft, mode,
           rapp_p):
    """What the layout wrappers share, for outputs of ``shape [..., n_io]``
    (a row for each leading index) on ``device``: the PA model's, the
    shapes' and the device's checks, one float32 ``sat`` and
    ``cubic_coeff`` a row, and the route: ``plain(sat, coeff, **kw)`` runs
    the layout's plain version where :func:`runs_kernel` says so,
    ``launch(sat, coeff, **kw)`` runs :func:`_launch` otherwise and for no
    rows."""
    if pa_model not in PA_MODELS:
        raise ValueError(f"unknown PA model {pa_model!r}")
    check_shapes(n_fft, shape[-1], mode)
    kernel = runs_kernel(device)
    lead = shape[:-1]
    sat = _row_param(sat, lead, device)
    coeff = _row_param(cubic_coeff, lead, device)
    kw = dict(pa_model=pa_model, n_fft=n_fft, mode=mode, rapp_p=rapp_p)
    if kernel or not math.prod(shape):
        return launch(sat, coeff, **kw)
    return plain(sat, coeff, **kw)


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
    return _chain(xr.shape, xr.device, sat, cubic_coeff,
                  functools.partial(_plain_version(xr.dtype), xr, xi),
                  lambda s, c, **kw: _launch((xr, xi), s, c, "planes", xr.dtype, **kw),
                  pa_model=pa_model, n_fft=n_fft, mode=mode, rapp_p=rapp_p)


fused_ifft_pa_fft.launches = 0
fused_ifft_pa_fft.launches_by_layout = dict.fromkeys(LAYOUTS, 0)


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
    complex64 twice, so its callers keep the plane route. The plain route
    runs the storage's plain version on such planes, bit for bit the plane
    route's result."""
    if x.dtype != torch.complex64:
        raise ValueError(f"x must be complex64, got {x.dtype}")
    st = storage_dtype(storage)

    def launch(s, c, **kw):
        out, = _launch((_float2(x),), s, c, "interleaved", st, **kw)
        return torch.view_as_complex(out)

    return _chain(x.shape, x.device, sat, cubic_coeff,
                  functools.partial(_complex_plain, x, st), launch, pa_model=pa_model,
                  n_fft=n_fft, mode=mode, rapp_p=rapp_p)


def _complex_plain(x, st, sat, coeff, **kw) -> torch.Tensor:
    """The plain route of a complex64 layout: the halves of ``x`` cast to
    planes of ``st``, the storage's plain version, the result cast back."""
    pr, pi = _plain_version(st)(x.real.to(st), x.imag.to(st), sat, coeff, **kw)
    return torch.complex(pr.float(), pi.float())


def precode_planes(sym: torch.Tensor, vr: torch.Tensor, vi: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The single-user MRT precode ``s o V`` in the planes' dtype: symbols
    ``sym [..., n_sc]`` (complex), precoder planes ``vr``/``vi [..., n_ant,
    n_sc]``; ``s``'s halves cast to the planes' dtype, and each product,
    difference and sum a plane operation of that dtype, as the eager
    transmitter computes it (``reference/modulation.py:373``)."""
    sr = sym.real.to(vr.dtype)[..., None, :]
    si = sym.imag.to(vr.dtype)[..., None, :]
    return sr * vr - si * vi, sr * vi + si * vr


def fused_precoded_ifft_pa_fft(sym: torch.Tensor, vr: torch.Tensor, vi: torch.Tensor,
                               sat, cubic_coeff=0.0, *, pa_model: str = "softlim",
                               n_fft: int, rapp_p: float = 1.1
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``extract_sc(FFT(PA(IFFT(map_sc(s o V)))))`` for each frame's antenna
    rows: complex64 symbols ``sym [..., n_sc]`` (any strides), the
    precoder's contiguous planes ``vr``/``vi [..., n_ant, n_sc]`` (float32 or
    bfloat16), ``sat``/``cubic_coeff`` broadcast to ``[..., n_ant]``. Returns
    output planes of ``vr``'s shape and dtype: bit for bit
    :func:`fused_ifft_pa_fft` of :func:`precode_planes`, in one launch of a
    precoded layout (counted in ``fused_ifft_pa_fft.launches``) that reads
    ``s`` and ``V`` and never writes the precoded planes. The plain route
    runs the precode and then the planes' plain version."""
    if vr.shape != vi.shape or vr.dtype != vi.dtype or vr.device != vi.device:
        raise ValueError("vr and vi must share shape, dtype and device")
    if vr.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"planes must be float32 or bfloat16, got {vr.dtype}")
    if sym.dtype != torch.complex64:
        raise ValueError(f"sym must be complex64, got {sym.dtype}")
    if vr.ndim < 2 or sym.shape != vr.shape[:-2] + vr.shape[-1:]:
        raise ValueError(f"sym {tuple(sym.shape)} does not match planes "
                         f"{tuple(vr.shape)} [..., n_ant, n_sc]")
    if sym.device != vr.device:
        raise ValueError("sym and the planes must share a device")

    def plain(s, c, **kw):
        return _plain_version(vr.dtype)(*precode_planes(sym, vr, vi), s, c, **kw)

    return _chain(vr.shape, vr.device, sat, cubic_coeff, plain,
                  lambda s, c, **kw: _launch((vr, vi), s, c, "precoded", vr.dtype,
                                             sym=_float2(sym), n_ant=vr.shape[-2], **kw),
                  pa_model=pa_model, n_fft=n_fft, mode="sc", rapp_p=rapp_p)


def precode_users(sym: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The multi-user joint precode ``sum_u s_u o V_u`` as the eager
    transmitter computes it (``reference/modulation.py:373-382``): symbols
    ``sym [..., n_usr, n_sc]`` times the precoder ``v [..., n_ant, n_usr,
    n_sc]`` in ATen's complex product, summed over the users ->
    ``[..., n_ant, n_sc]``."""
    return (sym[..., :, None, :] * v.transpose(-3, -2)).sum(-3)


def swap_detections(det_sym: torch.Tensor, usr_symbols: torch.Tensor) -> torch.Tensor:
    """Every user's symbols once for each user's detection, users first:
    ``[r]`` is ``usr_symbols [..., n_usr, n_sc]`` with user ``r``'s row
    replaced by ``det_sym[r]`` (``det_sym [n_usr, ..., n_sc]``), the
    symbols of the MCNC-MU replica of user ``r``
    (``reference/corrector.py:405-451``)."""
    n_usr = usr_symbols.shape[-2]
    own = torch.eye(n_usr, dtype=torch.bool, device=usr_symbols.device).view(
        n_usr, *([1] * (usr_symbols.ndim - 2)), n_usr, 1)
    return torch.where(own, det_sym[..., None, :], usr_symbols)


def fused_precoded_mu_ifft_pa_fft(usr_symbols: torch.Tensor, v: torch.Tensor, sat,
                                  cubic_coeff=0.0, *, det_sym: torch.Tensor | None = None,
                                  pa_model: str = "softlim", n_fft: int, rapp_p: float = 1.1,
                                  storage: str = "float32") -> torch.Tensor:
    """``extract_sc(FFT(PA(IFFT(map_sc(sum_u s_u o V_u)))))``, the
    multi-user transmitter's chain on each frame's antenna rows, complex64
    out: every user's complex64 symbols ``usr_symbols [..., n_usr, n_sc]``
    and the complex64 precoder ``v [..., n_ant, n_usr, n_sc]`` give rows
    ``[..., n_ant]``; with the detections ``det_sym [n_usr, ..., n_sc]`` of
    an MCNC-MU replica pass the rows are ``[n_usr, ..., n_ant]``, row ``r``
    precoding :func:`swap_detections`'s ``[r]``. ``sat``/``cubic_coeff``
    broadcast to the rows; ``storage`` as in
    :func:`fused_ifft_pa_fft_complex`. Bit for bit :func:`precode_users`
    followed by :func:`fused_ifft_pa_fft_complex`, in one launch of a
    precoded_mu layout (counted in ``fused_ifft_pa_fft.launches``) that
    reads the symbols and ``V`` (any strides but the last) and writes
    neither the users' products nor their sum. The plain route runs those
    two."""
    named = (("usr_symbols", usr_symbols), ("v", v),
             *((("det_sym", det_sym),) if det_sym is not None else ()))
    for name, t in named:
        if t.dtype != torch.complex64:
            raise ValueError(f"{name} must be complex64, got {t.dtype}")
        if t.device != v.device:
            raise ValueError("usr_symbols, v and det_sym must share a device")
    if usr_symbols.ndim < 2 or v.ndim < 3 or v.shape[:-3] + v.shape[-2:] != usr_symbols.shape:
        raise ValueError(f"v {tuple(v.shape)} does not match usr_symbols "
                         f"{tuple(usr_symbols.shape)} ([..., n_ant, n_usr, n_sc] against "
                         "[..., n_usr, n_sc])")
    lead, (n_usr, n_sc), n_ant = usr_symbols.shape[:-2], usr_symbols.shape[-2:], v.shape[-3]
    if det_sym is not None and det_sym.shape != (n_usr, *lead, n_sc):
        raise ValueError(f"det_sym {tuple(det_sym.shape)} is not [n_usr, ..., n_sc] = "
                         f"{(n_usr, *lead, n_sc)}")
    shape = (*((n_usr,) if det_sym is not None else ()), *lead, n_ant, n_sc)
    st = storage_dtype(storage)

    def plain(s, c, **kw):
        sym = usr_symbols if det_sym is None else swap_detections(det_sym, usr_symbols)
        return _complex_plain(precode_users(sym, v), st, s, c, **kw)

    def launch(s, c, **kw):
        vv = v.resolve_conj().resolve_neg()
        vv = (vv if vv.stride(-1) == 1 else vv.contiguous()).reshape(-1, n_ant, n_usr, n_sc)
        out = torch.empty(*shape, 2, dtype=torch.float32, device=v.device)
        _launch((torch.view_as_real(vv),), s, c, "precoded_mu", st, outs=(out,),
                sym=_float2(usr_symbols), det=None if det_sym is None else _float2(det_sym),
                n_ant=n_ant, n_usr=n_usr, v_strides=vv.stride()[:3], **kw)
        return torch.view_as_complex(out)

    return _chain(shape, v.device, sat, cubic_coeff, plain, launch, pa_model=pa_model,
                  n_fft=n_fft, mode="sc", rapp_p=rapp_p)


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
