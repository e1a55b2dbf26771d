"""5G-NR (TS 38.212 §5.2.2/§5.3.2) LDPC: base graphs, lifting-size
selection, the NR parity-core encoder and the rv rate-matching offsets
(port of ``mimo_ofdm_tpu/ops/nr_ldpc.py``, the replacement for MATLAB's
``nrDLSCHInfo`` / ``nrLDPCEncode`` / ``nrLDPCDecode``,
``reference/main_cnc_mcnc_w_ldpc/mp_ldpc_model.py:104,149-154,170-179``).

Everything structural is the standard's: BG1 46 x 68 and BG2 42 x 52 block
matrices, the 8 lifting-size sets and the ``Zc`` selection, the
double-diagonal parity core solved by a GF(2) core inverse, the ``2 Zc``
punctured systematic bits and the Table 5.4.2.1-2 ``k0`` offsets. The
shift values are the JAX package's deterministic surrogate (the same numpy
draws, so the same base matrices for every ``(bg, i_ls, draw)``),
replaceable by the standard tables through :func:`set_base_graph_tables`.
The host-side numpy parts are this package's own copy; the surrogate draw
and the installed tables are this module's state.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mimo_ofdm_tpu_torch.ops import ldpc

# TS 38.212 Table 5.3.2-1: the 8 lifting-size sets
LIFTING_SETS: tuple[tuple[int, ...], ...] = (
    (2, 4, 8, 16, 32, 64, 128, 256),
    (3, 6, 12, 24, 48, 96, 192, 384),
    (5, 10, 20, 40, 80, 160, 320),
    (7, 14, 28, 56, 112, 224),
    (9, 18, 36, 72, 144, 288),
    (11, 22, 44, 88, 176, 352),
    (13, 26, 52, 104, 208),
    (15, 30, 60, 120, 240),
)

# (m_b, n_b, k_b) block dimensions per base graph
BG_DIMS = {1: (46, 68, 22), 2: (42, 52, 10)}
# §5.2.2 maximum code-block size per base graph
KCB = {1: 8448, 2: 3840}
# Table 5.4.2.1-2 numerators for k0 = floor(num * Ncb / (den * Zc)) * Zc
RV_K0 = {1: ((0, 17, 33, 56), 66), 2: ((0, 13, 25, 43), 50)}

_user_tables: dict[tuple[int, int], np.ndarray] = {}
_surrogate_draw = 0


def set_surrogate_draw(draw: int) -> None:
    """Select surrogate-table realization ``draw`` (>= 0; 0 = default) and
    clear the cached base graphs; installed tables are unaffected."""
    global _surrogate_draw
    _surrogate_draw = int(draw)
    _protograph_support.cache_clear()
    _base_graph_cached.cache_clear()


def set_base_graph_tables(bg: int, i_ls: int, table: np.ndarray) -> None:
    """Install the TS 38.212 Table 5.3.2-2/-3 shift matrix ``[m_b, n_b]``
    (-1 = null block) for ``(bg, i_ls)`` in place of the surrogate."""
    m_b, n_b, _ = BG_DIMS[bg]
    t = np.asarray(table, np.int64)
    if t.shape != (m_b, n_b):
        raise ValueError(f"BG{bg} table must be [{m_b}, {n_b}], got {t.shape}")
    _user_tables[(bg, i_ls)] = t
    _base_graph_cached.cache_clear()


@functools.lru_cache(maxsize=None)
def _protograph_support(bg: int) -> np.ndarray:
    """``[m_b, n_b]`` bool support of the protograph
    (``mimo_ofdm_tpu/ops/nr_ldpc.py:100-134``): core rows 0-3 with the
    punctured columns and a random systematic fill, the weight-3 column and
    double diagonal of the parity core, extension rows with one punctured
    column, a few taps and their identity parity column."""
    m_b, n_b, k_b = BG_DIMS[bg]
    rng = np.random.default_rng(38212 + bg + 7919 * _surrogate_draw)
    sup = np.zeros((m_b, n_b), bool)
    core_deg = 19 if bg == 1 else 10
    for r in range(4):
        sup[r, [0, 1]] = True
        extra = rng.choice(np.arange(2, k_b), size=min(core_deg - 2, k_b - 2),
                           replace=False)
        sup[r, extra] = True
    sup[0, k_b] = sup[1, k_b] = sup[3, k_b] = True
    sup[0, k_b + 1] = sup[1, k_b + 1] = True
    sup[1, k_b + 2] = sup[2, k_b + 2] = True
    sup[2, k_b + 3] = sup[3, k_b + 3] = True
    ext_deg = 4 if bg == 1 else 3
    for r in range(4, m_b):
        sup[r, r % 2] = True
        pool = np.arange(2, k_b + 4)
        extra = rng.choice(pool, size=ext_deg - 1, replace=False)
        sup[r, extra] = True
        sup[r, k_b + 4 + (r - 4)] = True
    return sup


@functools.lru_cache(maxsize=None)
def _base_graph_cached(bg: int, i_ls: int) -> tuple:
    """The base matrix of ``(bg, i_ls)`` at ``z_max`` of the set
    (``mimo_ofdm_tpu/ops/nr_ldpc.py:137-187``): surrogate shifts, the exact
    NR parity-core shifts, and 4-cycle avoidance by resampling."""
    if (bg, i_ls) in _user_tables:
        return tuple(tuple(int(x) for x in row) for row in _user_tables[(bg, i_ls)])
    m_b, n_b, k_b = BG_DIMS[bg]
    z_max = max(LIFTING_SETS[i_ls])
    sup = _protograph_support(bg)
    rng = np.random.default_rng(1000 * bg + i_ls + 7919 * _surrogate_draw)
    base = -np.ones((m_b, n_b), np.int64)
    base[sup] = rng.integers(0, z_max, size=int(sup.sum()))
    base[0, k_b] = 1
    base[1, k_b] = 0
    base[3, k_b] = 1
    base[0, k_b + 1] = base[1, k_b + 1] = 0
    base[1, k_b + 2] = base[2, k_b + 2] = 0
    base[2, k_b + 3] = base[3, k_b + 3] = 0
    base[4:, k_b + 4:] = np.where(sup[4:, k_b + 4:], 0, -1)
    # a 4-cycle between rows (a, b) over columns (c, d) exists iff
    # s_ac - s_ad == s_bc - s_bd mod Z: resample one member of every
    # duplicate shift difference per column pair
    fixed = np.zeros_like(sup)
    fixed[:4, k_b: k_b + 4] = True
    fixed[4:, k_b + 4:] = True
    for _ in range(8):
        changed = False
        for c_idx in range(n_b):
            rows_c = np.flatnonzero(sup[:, c_idx])
            if rows_c.size < 2:
                continue
            for d_idx in range(c_idx + 1, n_b):
                rows = rows_c[sup[rows_c, d_idx]]
                if rows.size < 2:
                    continue
                diffs = (base[rows, c_idx] - base[rows, d_idx]) % z_max
                seen = set()
                for r, dv in zip(rows, diffs):
                    if dv not in seen:
                        seen.add(int(dv))
                    elif not fixed[r, c_idx]:
                        base[r, c_idx] = rng.integers(0, z_max)
                        changed = True
                    elif not fixed[r, d_idx]:
                        base[r, d_idx] = rng.integers(0, z_max)
                        changed = True
        if not changed:
            break
    return tuple(tuple(int(x) for x in row) for row in base)


def make_nr_code(bg: int, zc: int, i_ls: int | None = None) -> ldpc.QcLdpcCode:
    """The lifted NR code of base graph ``bg`` at lifting size ``zc``
    (shifts mod ``zc``, §5.3.2)."""
    if i_ls is None:
        i_ls = next(i for i, s in enumerate(LIFTING_SETS) if zc in s)
    base = np.asarray(_base_graph_cached(bg, i_ls))
    lifted = np.where(base >= 0, base % zc, -1)
    return ldpc.QcLdpcCode(base=tuple(tuple(int(x) for x in row) for row in lifted),
                           z=zc, kind=f"nr_bg{bg}")


def select_lifting(bg: int, k_prime: int, b: int | None = None) -> tuple[int, int, int]:
    """§5.2.2: ``(kb, i_ls, zc)`` with ``zc = min{Z in any set : Kb Z >=
    K'}`` (ties to the smallest Z, as ``nrDLSCHInfo``); ``b`` (default
    ``k_prime``) sets BG2's payload-dependent ``Kb``."""
    if bg == 1:
        kb = 22
    else:
        if b is None:
            b = k_prime
        kb = 10 if b > 640 else 9 if b > 560 else 8 if b > 192 else 6
    best = None
    for i_ls, zs in enumerate(LIFTING_SETS):
        for z in zs:
            if kb * z >= k_prime and (best is None or z < best[1]):
                best = (i_ls, z)
    if best is None:
        raise ValueError(f"K'={k_prime} too large for BG{bg}")
    return kb, best[0], best[1]


def rv_k0(bg: int, rv: int, n_cb: int, zc: int) -> int:
    """Table 5.4.2.1-2 circular-buffer start of redundancy version ``rv``."""
    nums, den = RV_K0[bg]
    return (nums[rv] * n_cb // (den * zc)) * zc


@functools.lru_cache(maxsize=None)
def _core_inverse(code: ldpc.QcLdpcCode) -> np.ndarray:
    """GF(2) inverse of the ``[4Z, 4Z]`` parity core (columns
    ``kb..kb+3`` of rows 0..3), by Gauss-Jordan on the host."""
    z, k_b = code.z, code.k_b
    base = np.asarray(code.base)
    b_mat = np.zeros((4 * z, 4 * z), np.int8)
    eye = np.eye(z, dtype=np.int8)
    for r in range(4):
        for c in range(4):
            sh = base[r, k_b + c]
            if sh >= 0:
                b_mat[r * z:(r + 1) * z, c * z:(c + 1) * z] = np.roll(eye, sh, axis=1)
    n = 4 * z
    aug = np.concatenate([b_mat, np.eye(n, dtype=np.int8)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col]))
        if aug[piv, col] == 0:
            raise ValueError("singular NR parity core")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        mask = aug[:, col].copy()
        mask[col] = 0
        aug ^= np.outer(mask, aug[col])
    return aug[:, n:]


def encode_np(code: ldpc.QcLdpcCode, info_bits: np.ndarray) -> np.ndarray:
    """Host numpy encode of one block ``[K] -> [N]`` int8, by rolls, the
    JAX package's ``encode_np`` (``mimo_ofdm_tpu/ops/nr_ldpc.py:279-300``)."""
    z, m_b, k_b = code.z, code.m_b, code.k_b
    base = np.asarray(code.base)
    c = np.asarray(info_bits).reshape(k_b, z).astype(np.int64)

    def syndrome(blocks, cols, rows):
        out = np.zeros((len(rows), z), np.int64)
        for oi, r in enumerate(rows):
            for j in cols:
                if base[r, j] >= 0:
                    out[oi] ^= np.roll(blocks[j], -base[r, j])
        return out

    lam_core = syndrome(c, range(k_b), range(4)).reshape(4 * z)
    p_core = (_core_inverse(code).astype(np.int64) @ lam_core) % 2
    sys_core = np.concatenate([c, p_core.reshape(4, z)], axis=0)
    lam_ext = syndrome(sys_core, range(k_b + 4), range(4, m_b))
    return np.concatenate([sys_core.reshape(-1), lam_ext.reshape(-1)]).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _encode_tables(code: ldpc.QcLdpcCode, device: torch.device):
    """Device tables of :func:`encode`: the core rows' systematic
    variables ``[4Z, d]`` (pad ``K``), the extension rows' variables among
    the systematic and core-parity columns ``[(m_b - 4) Z, d']`` (pad ``(k_b
    + 4) Z``), and the core inverse as float32 0/1 (a float32 product of 0/1
    values is exact: every sum stays below 2^24)."""
    k_b = code.k_b
    core = ldpc.check_vars(code, range(4), range(k_b))
    ext = ldpc.check_vars(code, range(4, code.m_b), range(k_b + 4))
    return (torch.as_tensor(ldpc.padded_index(core, code.k), device=device),
            torch.as_tensor(ldpc.padded_index(ext, (k_b + 4) * code.z), device=device),
            torch.as_tensor(_core_inverse(code), dtype=torch.float32, device=device))


def encode(code: ldpc.QcLdpcCode, info_bits: torch.Tensor) -> torch.Tensor:
    """NR systematic encode ``[..., K] -> [..., N]`` int8 (§5.3.2,
    ``mimo_ofdm_tpu/ops/nr_ldpc.py:303-322``): the core parity solves the
    core rows' syndromes through the core inverse; each extension parity
    is its row's syndrome over the systematic and core-parity bits (its
    identity column has shift 0). ``H c^T = 0`` exactly."""
    core_tab, ext_tab, binv = _encode_tables(code, info_bits.device)
    c = info_bits.to(torch.int8)
    lam_core = ldpc.gather_xor(ldpc.with_zero_bit(c), core_tab)          # [..., 4Z]
    p_core = torch.remainder(lam_core.to(torch.float32) @ binv.T, 2.0).to(torch.int8)
    sys_core = torch.cat([c, p_core], dim=-1)                            # [..., (k_b+4) Z]
    p_ext = ldpc.gather_xor(ldpc.with_zero_bit(sys_core), ext_tab).to(torch.int8)
    return torch.cat([sys_core, p_ext], dim=-1)
