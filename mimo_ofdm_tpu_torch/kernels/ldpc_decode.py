"""The flooding LDPC decode of :func:`mimo_ofdm_tpu_torch.ops.ldpc.decode`:
the CUDA kernels of ``csrc/ldpc_decode.cu`` over the code's quasi-cyclic
block layout, and the block tables they read.

:func:`ldpc_decode` takes float32 LLRs ``[..., N]`` (positive = bit 0) and
returns the hard information bits ``[..., K]`` int8 after ``n_iters``
flooding iterations of sum-product or normalised min-sum, in full. On CUDA
tensors it launches the kernels, two an iteration (built with ``nvcc`` at
first use and loaded with ``ctypes``, ``kernels/build.py``); on CPU tensors,
or inside ``kernels.plain_versions()``, it runs the plain version
``ops/ldpc.py::_decode`` (:func:`mimo_ofdm_tpu_torch.kernels.runs_kernel`
decides). The kernel computes what the plain version computes, operation
for operation in float32; only the order of its sums differs from torch's
reductions (each sum in one thread, in the plain version's slot order), so
a marginal decode may end otherwise, and a codeword's bits depend neither
on the run nor on the batch. Decodes that ran the kernel count in
``ldpc_decode.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from mimo_ofdm_tpu_torch.kernels import build, runs_kernel
from mimo_ofdm_tpu_torch.ops import ldpc

SOURCE = build.PACKAGE_DIR / "csrc" / "ldpc_decode.cu"
ALGORITHMS = {"sumprod": 0, "minsum": 1}
MAX_ROW_DEGREE = 32         # the check kernel keeps a row's messages in registers
# the kernels in the order of csrc/ldpc_decode.cu's kKernels
INSTANTIATIONS = tuple(
    [{"kernel": "ldpc_check_kernel", "algorithm": alg, "max_degree": d, "first": first}
     for alg in ALGORITHMS for d in (8, 16, 24, 32) for first in (True, False)]
    + [{"kernel": "ldpc_variable_kernel", "first": first} for first in (True, False)])


@functools.lru_cache(maxsize=None)
def block_tables(code: ldpc.QcLdpcCode) -> dict:
    """The kernels' host tables of ``code``. Nonzero block ``b`` of the base
    matrix, in row-major order, owns message plane ``b``:

    * ``row_blocks [n_blocks, 2]``: ``(j Z, shift)`` of each block, row by
      row in increasing ``j``; ``row_start [m_b + 1]`` where each row's
      blocks begin;
    * ``col_blocks [n_blocks, 2]``: ``(b Z, shift)``, column by column in
      increasing ``i``; ``col_start [n_b + 1]``.

    Shifts are reduced mod ``Z``: check ``i Z + r`` of block ``(i, j)`` meets
    variable ``j Z + (r + shift) mod Z``."""
    z = code.z
    base = np.asarray(code.base, np.int64)
    rows, cols = np.nonzero(base >= 0)              # row-major order
    shifts = base[rows, cols] % z
    by_col = np.lexsort((rows, cols))
    return {
        "row_blocks": np.stack([cols * z, shifts], 1).astype(np.int32),
        "row_start": np.searchsorted(rows, np.arange(code.m_b + 1)).astype(np.int32),
        "col_blocks": np.stack([by_col * z, shifts[by_col]], 1).astype(np.int32),
        "col_start": np.searchsorted(cols[by_col], np.arange(code.n_b + 1)).astype(np.int32),
    }


def max_row_degree(code: ldpc.QcLdpcCode) -> int:
    return int(np.diff(block_tables(code)["row_start"]).max())


@functools.lru_cache(maxsize=None)
def device_tables(code: ldpc.QcLdpcCode, device: torch.device) -> torch.Tensor:
    """:func:`block_tables` packed into one int32 tensor on ``device``, in the
    order ``ldpc_decode_launch`` reads: row_blocks, col_blocks, row_start,
    col_start."""
    t = block_tables(code)
    flat = np.concatenate([t["row_blocks"].ravel(), t["col_blocks"].ravel(), t["row_start"],
                           t["col_start"]])
    return torch.as_tensor(flat, device=device)


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldpc_decode_launch.argtypes = [vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp, ci, ci,
                                       ci, cf, vp]
    lib.ldpc_decode_launch.restype = ci
    lib.ldpc_decode_attributes.argtypes = [ci, ctypes.POINTER(ci)]
    lib.ldpc_decode_attributes.restype = ci


def build_library() -> tuple[ctypes.CDLL, str]:
    """Compile ``csrc/ldpc_decode.cu`` for sm_90a (once per source version)
    and load it (once a process, ``kernels/build.py``). Returns the library
    and ptxas's report."""
    return build.load_library(SOURCE, _declare)


def kernel_resources() -> list[dict]:
    """Each instantiation's registers, local memory (non-zero when ptxas
    spills) and resident blocks per SM, as the runtime reads them on the
    current card."""
    lib, _ = build_library()
    rows = []
    for index, inst in enumerate(INSTANTIATIONS):
        buf = (ctypes.c_int * 3)()
        err = lib.ldpc_decode_attributes(index, buf)
        if err:
            raise RuntimeError(f"ldpc_decode_attributes: CUDA error {err}")
        rows.append({**inst, "registers": buf[0], "local_bytes": buf[1],
                     "blocks_per_sm": buf[2]})
    return rows


def _check(code: ldpc.QcLdpcCode, llr: torch.Tensor, algorithm: str) -> None:
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown LDPC decoder {algorithm!r}")
    if llr.dtype != torch.float32:
        raise ValueError(f"the LLRs must be float32, got {llr.dtype}")
    if llr.dim() < 1 or llr.shape[-1] != code.n:
        raise ValueError(f"the LLRs must be [..., {code.n}], got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("the LLRs must be contiguous")


def _launch(code: ldpc.QcLdpcCode, llr: torch.Tensor, n_iters: int, normalization: float,
            algorithm: str, beliefs: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One decode on the kernels: the hard bits ``[..., K]`` and, where
    ``beliefs``, the float32 beliefs ``[..., N]`` after the last iteration."""
    degree = max_row_degree(code)
    if degree > MAX_ROW_DEGREE:
        raise ValueError(f"the kernel takes check rows of at most {MAX_ROW_DEGREE} blocks, "
                         f"the code has {degree}")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    lead, device = llr.shape[:-1], llr.device
    words = math.prod(lead)
    if words * code.n >= 2 ** 31:
        raise ValueError(f"{words} codewords of {code.n} bits exceed the kernels' 2^31 "
                         "variables")
    n_blocks = len(block_tables(code)["row_blocks"])
    hard = torch.empty(*lead, code.k, dtype=torch.int8, device=device)
    out = torch.empty_like(llr) if beliefs else None
    if words == 0:
        return hard, out
    c2v = torch.empty(words, n_blocks, code.z, dtype=torch.float32, device=device)
    total = torch.empty_like(llr) if n_iters >= 2 else None
    lib, _ = build_library()
    err = lib.ldpc_decode_launch(
        device_tables(code, device).data_ptr(), code.z, code.m_b, code.n_b, code.k_b,
        n_blocks, degree, llr.data_ptr(), c2v.data_ptr(),
        None if total is None else total.data_ptr(), hard.data_ptr(),
        None if out is None else out.data_ptr(), words, n_iters, ALGORITHMS[algorithm],
        normalization, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"ldpc_decode launch failed: CUDA error {err}")
    return hard, out


def ldpc_decode(code: ldpc.QcLdpcCode, llr: torch.Tensor, n_iters: int,
                normalization: float = 0.75, algorithm: str = "minsum") -> torch.Tensor:
    """Flooding decode of ``llr [..., N]`` (float32, contiguous; positive =
    bit 0): the hard information bits ``[..., K]`` int8 (see the module
    docstring). The kernels where :func:`runs_kernel` says so (counted in
    ``ldpc_decode.launches``, one a call that decodes a codeword), ``ops/ldpc.py::_decode``
    otherwise. Raises for an unknown ``algorithm``, LLRs of another dtype,
    shape or layout, and on the kernels' route for a code whose check rows
    span more than :data:`MAX_ROW_DEGREE` blocks."""
    _check(code, llr, algorithm)
    if not runs_kernel(llr.device):
        return ldpc._decode(code, llr, n_iters, normalization, algorithm)
    hard, _ = _launch(code, llr, n_iters, normalization, algorithm, beliefs=False)
    if llr.numel():
        ldpc_decode.launches += 1
    return hard


ldpc_decode.launches = 0


def kernel_beliefs(code: ldpc.QcLdpcCode, llr: torch.Tensor, n_iters: int,
                   normalization: float = 0.75, algorithm: str = "minsum") -> torch.Tensor:
    """The kernels' float32 beliefs ``llr + sum c2v`` ``[..., N]`` after
    ``n_iters`` iterations, for CUDA LLRs (the decode's state, for tests and
    ``chip_smoke.py``; not counted in ``ldpc_decode.launches``)."""
    _check(code, llr, algorithm)
    if llr.device.type != "cuda":
        raise ValueError(f"the kernels need CUDA LLRs, got {llr.device}")
    return _launch(code, llr, n_iters, normalization, algorithm, beliefs=True)[1]
