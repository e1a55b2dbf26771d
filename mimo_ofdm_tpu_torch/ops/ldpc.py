"""Quasi-cyclic LDPC codec (port of ``mimo_ofdm_tpu/ops/ldpc.py``), the
native replacement for the reference's out-of-process MATLAB 5G-NR LDPC
calls (``reference/main_cnc_mcnc_w_ldpc/mp_ldpc_model.py:91-179``).

A code is an ``[m_b, n_b]`` base matrix of circulant shifts (``-1`` = zero
block) lifted by ``Z``; :func:`make_default_code` builds the deterministic
IRA (accumulator-parity) code of the JAX package from the same numpy draws.

Every per-frame operation is a gather over padded index tables built once
per code on the host and kept on each device:

* encoding: the syndrome of each check row is one gather of the
  systematic bits it touches and a sum mod 2 (JAX rolls ``m_b x k_b``
  blocks one by one);
* decoding: flooding belief propagation, normalized min-sum or
  sum-product, the same arithmetic as JAX's. On CUDA tensors
  :func:`decode` runs the hand-written kernels of
  ``kernels/ldpc_decode.py`` (two launches an iteration, the messages in
  the code's block layout); the plain version, :func:`_decode`, keeps the
  check-to-variable messages in the padded check-row layout ``[..., n_chk,
  d_c]``, which saves JAX's two gathers between its flat edge vector and
  that layout; each message meets the same operations in the same order.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from mimo_ofdm_tpu_torch.kernels import ldpc_decode
from mimo_ofdm_tpu_torch.utils.spans import OFF, enabled, span


@dataclass(frozen=True)
class QcLdpcCode:
    """Quasi-cyclic LDPC code: ``H`` built from ``base[i][j]``-shifted
    ``Z x Z`` identity circulants (``-1`` = zero block). Columns
    ``0..k_b-1`` are systematic; ``kind`` is ``"ira"`` (accumulator parity)
    or ``"nr_bg1"`` / ``"nr_bg2"`` (the 38.212 parity core,
    :mod:`mimo_ofdm_tpu_torch.ops.nr_ldpc`)."""
    base: tuple            # [m_b][n_b] ints, hashable nested tuple
    z: int
    kind: str = "ira"

    @property
    def m_b(self) -> int:
        return len(self.base)

    @property
    def n_b(self) -> int:
        return len(self.base[0])

    @property
    def k_b(self) -> int:
        return self.n_b - self.m_b

    @property
    def n(self) -> int:
        return self.n_b * self.z

    @property
    def k(self) -> int:
        return self.k_b * self.z

    @property
    def rate(self) -> float:
        return self.k / self.n


def make_default_code(k_b: int = 12, m_b: int = 12, z: int = 32,
                      col_weight: int = 3, seed: int = 7) -> QcLdpcCode:
    """Deterministic QC-LDPC construction, the JAX package's draws
    (``mimo_ofdm_tpu/ops/ldpc.py:69-91``): random circulant shifts with
    ``col_weight`` checks per systematic column, plus the IRA accumulator
    parity part (dual diagonal, zero shifts)."""
    rng = np.random.default_rng(seed)
    base = -np.ones((m_b, k_b + m_b), np.int64)
    for j in range(k_b):
        rows = rng.choice(m_b, size=min(col_weight, m_b), replace=False)
        for i in rows:
            base[i, j] = rng.integers(0, z)
    for i in range(m_b):
        base[i, k_b + i] = 0
        if i > 0:
            base[i, k_b + i - 1] = 0
    for i in range(m_b):
        if np.all(base[i, :k_b] < 0):
            base[i, rng.integers(0, k_b)] = rng.integers(0, z)
    return QcLdpcCode(base=tuple(tuple(int(x) for x in row) for row in base), z=z)


def check_vars(code: QcLdpcCode, rows, cols) -> np.ndarray:
    """Variable indices of the checks of block rows ``rows``, restricted to
    block columns ``cols``: ``[len(rows) * Z, d]``, in increasing column
    order, ``-1`` past a row's degree. Check ``i Z + r`` of block ``(i, j)``
    with shift ``s`` reads variable ``j Z + (r + s) mod Z``."""
    z = code.z
    r = np.arange(z)
    per_row = []
    for i in rows:
        blocks = [j * z + (r + code.base[i][j]) % z for j in cols if code.base[i][j] >= 0]
        per_row.append(np.stack(blocks, axis=1) if blocks else np.zeros((z, 0), np.int64))
    d = max(1, max(b.shape[1] for b in per_row))
    out = np.full((len(per_row) * z, d), -1, np.int64)
    for n, b in enumerate(per_row):
        out[n * z:(n + 1) * z, :b.shape[1]] = b
    return out


def padded_index(idx: np.ndarray, pad: int) -> np.ndarray:
    """``idx`` with its ``-1`` entries replaced by ``pad``."""
    return np.where(idx >= 0, idx, pad)


@functools.lru_cache(maxsize=None)
def _decode_tables(code: QcLdpcCode):
    """Host tables of the decoder: ``chk_var_idx [n_chk, d_c]`` (0 past a
    row's degree), ``chk_mask``, ``var_slot_idx [n_var, d_v]``, the flat
    check-row slots ``c d_c + s`` of each variable's edges in increasing
    check order (JAX's edge order), and ``var_mask``."""
    idx = check_vars(code, range(code.m_b), range(code.n_b))
    chk_mask = idx >= 0
    flat = idx.reshape(-1)
    pos = np.flatnonzero(flat >= 0)
    var = flat[pos]
    order = np.argsort(var, kind="stable")
    pos, var = pos[order], var[order]
    deg = np.bincount(var, minlength=code.n)
    slot = np.arange(len(var)) - (np.cumsum(deg) - deg)[var]
    d_v = max(int(deg.max()), 1)
    var_slot_idx = np.zeros((code.n, d_v), np.int64)
    var_mask = np.zeros((code.n, d_v), bool)
    var_slot_idx[var, slot] = pos
    var_mask[var, slot] = True
    return padded_index(idx, 0), chk_mask, var_slot_idx, var_mask


@functools.lru_cache(maxsize=None)
def decode_tables(code: QcLdpcCode, device: torch.device):
    """:func:`_decode_tables` as tensors on ``device``, made once."""
    return tuple(torch.as_tensor(t, device=device) for t in _decode_tables(code))


@functools.lru_cache(maxsize=None)
def _ira_encode_table(code: QcLdpcCode, device: torch.device) -> torch.Tensor:
    """``[n_chk, d]`` systematic variables of each check; ``k`` (a zero
    bit appended to the message) past a row's degree."""
    idx = check_vars(code, range(code.m_b), range(code.k_b))
    return torch.as_tensor(padded_index(idx, code.k), device=device)


def gather_xor(bits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """XOR over each row of ``table`` of the bits it indexes: ``bits [...,
    n]`` (a trailing zero bit for the pad index) -> int32 ``[..., rows]``."""
    g = torch.index_select(bits, -1, table.reshape(-1))
    g = g.view(*bits.shape[:-1], *table.shape).to(torch.int32)
    return g.sum(-1) & 1


def with_zero_bit(bits: torch.Tensor) -> torch.Tensor:
    """``bits [..., n]`` with a zero appended, the target of pad indices."""
    return torch.cat([bits, bits.new_zeros((*bits.shape[:-1], 1))], dim=-1)


def encode(code: QcLdpcCode, info_bits: torch.Tensor) -> torch.Tensor:
    """Systematic IRA encode ``[..., K] -> [..., N]`` int8
    (``mimo_ofdm_tpu/ops/ldpc.py:94-123``): the parity block ``p_i`` is the
    prefix XOR over block rows of the check syndromes ``s_i``, so that
    ``H c^T = 0``."""
    c = info_bits.to(torch.int8)
    s = gather_xor(with_zero_bit(c), _ira_encode_table(code, c.device))
    p = s.view(*c.shape[:-1], code.m_b, code.z).cumsum(-2) & 1
    return torch.cat([c, p.flatten(-2).to(torch.int8)], dim=-1)


def decode(code: QcLdpcCode, llr: torch.Tensor, n_iters: int = 25,
           normalization: float = 0.75, algorithm: str = "minsum") -> torch.Tensor:
    """Flooding BP decode (``mimo_ofdm_tpu/ops/ldpc.py:190-267``):
    normalized min-sum, or sum-product (``algorithm="sumprod"``, the
    phi-function form with JAX's clamps to [1e-6, 30]; MATLAB
    ``nrLDPCDecode``'s default, ``reference/main_cnc_mcnc_w_ldpc/
    mp_ldpc_model.py:174-175``). ``llr [..., N]``, positive = bit 0.
    Returns the hard info bits ``[..., K]`` int8. Runs inside a ``decode``
    span that counts the ``codewords`` decoded and their ``iters``; the
    LLRs are taken as contiguous float32, and
    :func:`mimo_ofdm_tpu_torch.kernels.ldpc_decode.ldpc_decode` decodes them
    (the kernels on CUDA, :func:`_decode` on the CPU)."""
    with (span("decode", codewords=math.prod(llr.shape[:-1]), iters=n_iters) if enabled()
          else OFF):
        return ldpc_decode.ldpc_decode(code, llr.to(torch.float32).contiguous(), n_iters,
                                       normalization, algorithm)


def _decode(code: QcLdpcCode, llr: torch.Tensor, n_iters: int, normalization: float,
            algorithm: str) -> torch.Tensor:
    chk_var_idx, chk_mask, var_slot_idx, var_mask = decode_tables(code, llr.device)
    llr = llr.to(torch.float32)
    lead = llr.shape[:-1]
    n_chk, d_c = chk_var_idx.shape
    slots = torch.arange(d_c, device=llr.device)

    def beliefs(c2v):
        """llr + the sum of each variable's incoming check messages."""
        per_var = torch.index_select(c2v.flatten(-2), -1, var_slot_idx.reshape(-1))
        per_var = torch.where(var_mask, per_var.view(*lead, *var_slot_idx.shape), 0.0)
        return llr + per_var.sum(-1)

    c2v = llr.new_zeros((*lead, n_chk, d_c))
    for _ in range(n_iters):
        var_total = beliefs(c2v)
        row = torch.index_select(var_total, -1, chk_var_idx.reshape(-1))
        row = row.view(*lead, n_chk, d_c) - c2v                  # variable -> check
        row = torch.where(chk_mask, row, torch.inf)
        sign_row = torch.where(chk_mask, torch.sign(row), 1.0)
        sign_row = torch.where(sign_row == 0, 1.0, sign_row)
        prod_sign = torch.prod(sign_row, -1, keepdim=True)
        mag = torch.abs(row)
        if algorithm == "sumprod":
            # phi(x) = -log(tanh(x/2)) is self-inverse; the extrinsic
            # magnitude is phi(sum of the others' phi(|v2c|))
            phi = -torch.log(torch.tanh(torch.clamp(mag, 1e-6, 30.0) / 2.0))
            phi = torch.where(chk_mask, phi, 0.0)
            excl = torch.clamp(phi.sum(-1, keepdim=True) - phi, 1e-6, 30.0)
            new_row = prod_sign * sign_row * -torch.log(torch.tanh(excl / 2.0))
        else:
            min1, arg1 = torch.min(mag, -1, keepdim=True)
            first = slots == arg1
            min2 = torch.where(first, torch.inf, mag).amin(-1, keepdim=True)
            new_row = normalization * prod_sign * sign_row * torch.where(first, min2, min1)
        c2v = torch.where(chk_mask, new_row, 0.0)
    hard = (beliefs(c2v) < 0).to(torch.int8)                   # llr > 0 -> bit 0
    return hard[..., :code.k]


def syndrome_ok(code: QcLdpcCode, codeword: torch.Tensor) -> torch.Tensor:
    """True where ``H c^T = 0`` (every check satisfied)."""
    chk_var_idx, chk_mask, _, _ = decode_tables(code, codeword.device)
    table = torch.where(chk_mask, chk_var_idx, code.n)
    return (gather_xor(with_zero_bit(codeword.to(torch.int8)), table) == 0).all(-1)
