"""Plain reference of the 5G-NR LDPC-coded single-user MISO link: the same
draws in, each frame's payload bit errors ``[clean, pass 0 .. pass n_iters]``
out.

Written from the simulator's published semantics
(``main_cnc_mcnc_w_ldpc/mp_ldpc_model.py``, ``LinkLdpc``, lines 99-179:
``nrDLSCHInfo``, the DL-SCH encode, the soft demapper, ``nrLDPCDecode``),
with plain ``torch`` and numpy operations only, and the single-user
reference's plain helpers (``miso.py``: the constellation, the LOS and
Rayleigh channels, the chain, the Bussgang gain, the AWGN and
:class:`~portbench.reference.miso.Precision`). It imports nothing of the
program under test and takes nothing the program made: the base graph, the
code, the generator, the rate-matching positions, the channel, the precoder,
the AGC vectors and the PA's saturation power are worked out again here.
Complex64 arithmetic with float32 sums, TF32 off; the geometry and LOS
phases in float64, the transforms through ``torch.fft``.

A frame, as ``mp_ldpc_model.py`` runs it:

* the transport block: ``A = rate * n_bits_per_frame`` payload bits, CRC24A
  on top (TS 38.212 §5.1), the base graph by §7.2.2, one code block of
  ``K' = A + 24`` bits and ``K - K'`` zero filler bits, ``Zc`` the least
  lifting size with ``Kb Zc >= K'`` (§5.2.2);
* the encoder: the systematic codeword ``[u | p]`` with ``H [u | p] = 0``,
  ``p = u P`` mod 2, ``P`` from GF(2) elimination on the whole parity-check
  matrix ``H`` (no use of its structure);
* rate matching: the circular buffer from bit ``2 Zc`` on (the first
  ``2 Zc`` systematic bits are never sent), filler bits skipped, redundancy
  version 0, ``E = n_bits_per_frame`` bits, repeated around the buffer
  where ``E`` exceeds it;
* the front end of ``miso.py`` in the coded link's order: the clean run
  propagates the precoded symbols ``sum_ant H o (s V)``, the distorted run
  sends ``s V`` through the chain, and the CNC replica is the nominal PA's
  chain divided by the Bussgang gain; each pass's corrected signal (before
  detection) is what the decoder gets;
* the exact soft demapper, ``llr[k] = log sum_{b: bit k = 1} exp(-|y -
  s_b|^2 / nv) - log sum_{b: bit k = 0} exp(-|y - s_b|^2 / nv)``
  (``reference/modulation.py:30-59``'s form), with ``nv = 2 avg_sym_pow /
  10^(snr/10)`` formed in float32 (``mp_ldpc_model.py:121``), negated to the
  decoder's sign (positive = bit 0, ``mp_ldpc_model.py:168-169``);
* de-rate-matching: repeated positions summed, the filler bits pinned to the
  known-zero LLR 64, punctured and unsent positions 0;
* flooding sum-product, ``ldpc_iters`` iterations run in full, with
  ``phi(x) = -log(tanh(x / 2))`` and its argument clamped to ``[1e-6, 30]``
  both ways, a zero message counted as positive;
* the payload bits of the hard decision against those sent. The TB CRC is
  not checked: a failed block shows as payload errors.

Departures from the published description:

* the base graphs' shift values are the simulator port's seeded surrogate
  (:func:`base_graph`), not TS 38.212 Table 5.3.2-2/-3, which the
  repository does not hold; the structure (BG1 46 x 68, BG2 42 x 52, the
  double-diagonal parity core, the punctured columns) is the standard's;
* no bit interleaving after rate matching (§5.4.2.2), and one code block
  (no CRC24B segmentation) and redundancy version 0 alone: what the
  benchmark's configurations need;
* float32 in place of MATLAB's double, one OFDM symbol a frame, and the
  clean run's (I)FFT round trip left out, since it is the identity on the
  data bins; the RX offsets and every random taken from the draws.

``planes`` names the precision of the planes, as in ``miso.py``:
``"float32"``, the reference, or a lower one. The coded link keeps its
channel, precoder, AGC vectors and combines in complex64 at every storage;
only the chain stores planes at the configuration's precision (its input,
each transform pass's operand and its output). So at a lower precision
these, and these alone, are rounded to it; sums and the PA in float32.

The host tables (base graph, generator, decoder and rate-matching indices)
are built once a process for each code and kept, as a fixed part of the
reference; nothing computed from the draws is kept.

Configurations taken: those of ``miso.py`` with the receiver ``cnc`` or
``mcnc``, a code rate whose transport block is one code block, and the
decoder ``sumprod``. Anything else raises ``ValueError``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from portbench.reference.miso import (Precision, Qam, _awgn, bussgang_alpha, chain, channel,
                                      check_supported)

# TS 38.212 Table 5.3.2-1: the lifting sizes, set by set
LIFTING_SETS = ((2, 4, 8, 16, 32, 64, 128, 256), (3, 6, 12, 24, 48, 96, 192, 384),
                (5, 10, 20, 40, 80, 160, 320), (7, 14, 28, 56, 112, 224),
                (9, 18, 36, 72, 144, 288), (11, 22, 44, 88, 176, 352),
                (13, 26, 52, 104, 208), (15, 30, 60, 120, 240))
# base graph -> (block rows, block columns, systematic block columns)
BASE_DIMS = {1: (46, 68, 22), 2: (42, 52, 10)}
MAX_CB = {1: 8448, 2: 3840}                     # §5.2.2, the largest code block
CRC24A_POLY = 0x864CFB                          # §5.1, x^24 implicit
FILLER_LLR = 64.0
PHI_CLAMP = (1e-6, 30.0)


# --- transport sizes ------------------------------------------------------

def payload_bits(link: dict, code_rate: float) -> int:
    """``A = rate * n_bits_per_frame`` (``mp_ldpc_model.py:99-104``)."""
    m = link["modem"]
    return int(round(code_rate * int(round(math.log2(m["constel_size"]))) * m["n_sub_carr"]))


def base_graph_number(a: int, rate: float) -> int:
    """§7.2.2: BG2 for small or low-rate blocks, else BG1."""
    return 2 if a <= 292 or rate <= 0.25 or (a <= 3824 and rate <= 0.67) else 1


def lifting(bg: int, k_prime: int) -> tuple[int, int]:
    """``(set index, Zc)``: the least lifting size of any set with ``Kb Zc >=
    K'`` (§5.2.2; BG2's ``Kb`` from the block's size)."""
    if bg == 1:
        kb = 22
    else:
        kb = 10 if k_prime > 640 else 9 if k_prime > 560 else 8 if k_prime > 192 else 6
    zc = min(z for s in LIFTING_SETS for z in s if kb * z >= k_prime)
    return next(i for i, s in enumerate(LIFTING_SETS) if zc in s), zc


class Code:
    """One transport block's code: base graph ``bg`` lifted by ``z``, ``a``
    payload bits, ``e`` rate-matched bits."""

    def __init__(self, e: int, a: int, rate: float):
        self.e, self.a = e, a
        self.bg = base_graph_number(a, rate)
        self.k_prime = a + 24
        if self.k_prime > MAX_CB[self.bg]:
            raise ValueError(f"A={a} needs {math.ceil(self.k_prime / MAX_CB[self.bg])} code "
                             "blocks; the LDPC reference models one")
        self.i_ls, self.z = lifting(self.bg, self.k_prime)
        m_b, n_b, k_b = BASE_DIMS[self.bg]
        self.n_chk, self.n, self.k = m_b * self.z, n_b * self.z, k_b * self.z
        base = base_graph(self.bg, self.i_ls)
        self.shifts = np.where(base >= 0, base % self.z, -1)

    @property
    def key(self) -> tuple:
        return (self.e, self.a, self.bg, self.z, self.i_ls)

    def __eq__(self, other) -> bool:
        return isinstance(other, Code) and self.key == other.key

    def __hash__(self) -> int:
        return hash(self.key)

    @property
    def edges(self) -> int:
        """Ones of ``H``: the decoder's messages a codeword each way."""
        return int((self.shifts >= 0).sum()) * self.z


def code_of(link: dict, code_rate: float) -> Code:
    m = link["modem"]
    e = int(round(math.log2(m["constel_size"]))) * m["n_sub_carr"]
    return Code(e, payload_bits(link, code_rate), code_rate)


# --- the surrogate base graphs -------------------------------------------

def _support(bg: int) -> np.ndarray:
    """Which blocks of the base graph are circulants: rows 0-3 (the core)
    hold the two punctured columns, a seeded systematic fill and the
    double-diagonal parity core; each later row one punctured column, a few
    seeded taps and its own identity parity column."""
    m_b, n_b, k_b = BASE_DIMS[bg]
    rng = np.random.default_rng(38212 + bg)
    sup = np.zeros((m_b, n_b), bool)
    fill = 19 if bg == 1 else 10
    for r in range(4):
        sup[r, :2] = True
        sup[r, rng.choice(np.arange(2, k_b), size=min(fill - 2, k_b - 2), replace=False)] = True
    for r, c in ((0, 0), (1, 0), (3, 0), (0, 1), (1, 1), (1, 2), (2, 2), (2, 3), (3, 3)):
        sup[r, k_b + c] = True
    taps = 4 if bg == 1 else 3
    for r in range(4, m_b):
        sup[r, r % 2] = True
        sup[r, rng.choice(np.arange(2, k_b + 4), size=taps - 1, replace=False)] = True
        sup[r, k_b + r] = True
    return sup


@functools.lru_cache(maxsize=None)
def _base_graph(bg: int, i_ls: int) -> tuple:
    m_b, n_b, k_b = BASE_DIMS[bg]
    z_max = LIFTING_SETS[i_ls][-1]
    sup = _support(bg)
    rng = np.random.default_rng(1000 * bg + i_ls)
    base = np.full((m_b, n_b), -1, np.int64)
    base[sup] = rng.integers(0, z_max, size=int(sup.sum()))
    core = base[:4, k_b:k_b + 4]
    core[0, 0], core[1, 0], core[3, 0] = 1, 0, 1
    core[0, 1] = core[1, 1] = core[1, 2] = core[2, 2] = core[2, 3] = core[3, 3] = 0
    base[4:, k_b + 4:] = np.where(sup[4:, k_b + 4:], 0, -1)
    pinned = np.zeros_like(sup)
    pinned[:4, k_b:k_b + 4] = pinned[4:, k_b + 4:] = True
    # two rows that share two columns close a 4-cycle when their shift
    # differences over the pair agree: redraw a free shift of each repeat
    for _ in range(8):
        redrawn = False
        for c in range(n_b):
            for d in range(c + 1, n_b):
                rows = np.flatnonzero(sup[:, c] & sup[:, d])
                if rows.size < 2:
                    continue
                seen = set()
                for r, diff in zip(rows, (base[rows, c] - base[rows, d]) % z_max):
                    if int(diff) not in seen:
                        seen.add(int(diff))
                    elif not pinned[r, c]:
                        base[r, c] = rng.integers(0, z_max)
                        redrawn = True
                    elif not pinned[r, d]:
                        base[r, d] = rng.integers(0, z_max)
                        redrawn = True
        if not redrawn:
            break
    return tuple(map(tuple, base.tolist()))


def base_graph(bg: int, i_ls: int) -> np.ndarray:
    """The surrogate base graph of ``(bg, i_ls)`` at the set's largest
    lifting size, ``-1`` for a zero block; a code takes its shifts mod
    ``Zc``."""
    return np.array(_base_graph(bg, i_ls), np.int64)


# --- the parity-check matrix and the generator ---------------------------

def edge_list(code: Code) -> tuple[np.ndarray, np.ndarray]:
    """``(check, variable)`` of every one of ``H``, check by check, each
    check's variables in increasing order: check ``i Z + r`` of block ``(i,
    j)`` with shift ``s`` reads variable ``j Z + (r + s) mod Z``."""
    z = code.z
    i, j = np.nonzero(code.shifts >= 0)
    r = np.arange(z)
    chk = (i[:, None] * z + r).ravel()
    var = (j[:, None] * z + (r + code.shifts[i, j][:, None]) % z).ravel()
    order = np.lexsort((var, chk))
    return chk[order], var[order]


def _packed_h(code: Code) -> np.ndarray:
    """``H`` as ``[n_chk, words]`` uint64, bit ``v % 64`` of word ``v // 64``."""
    chk, var = edge_list(code)
    words = -(-code.n // 64)
    h = np.zeros((code.n_chk, words), np.uint64)
    np.bitwise_or.at(h, (chk, var // 64), np.left_shift(np.uint64(1), (var % 64).astype(np.uint64)))
    return h


@functools.lru_cache(maxsize=None)
def generator(code: Code) -> np.ndarray:
    """``P [K, n - K]`` uint8: the parity ``p = u P`` mod 2 of the
    systematic codeword of ``u``. Gauss-Jordan elimination of ``H`` over
    GF(2) on its parity columns, the last first, leaves row ``r`` with one
    parity column ``c`` and the information columns ``A_r``: ``p_c = A_r
    . u``."""
    h = _packed_h(code)
    n_rows = h.shape[0]
    row_of = {}
    free = np.ones(n_rows, bool)
    for c in range(code.n - 1, code.k - 1, -1):
        w, b = divmod(c, 64)
        has = ((h[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
        cand = np.flatnonzero(has & free)
        if cand.size == 0:
            raise ValueError("H is singular on its parity columns")
        piv = cand[0]
        free[piv] = False
        others = np.flatnonzero(has)
        others = others[others != piv]
        if others.size:
            h[others] ^= h[piv]
        row_of[c] = piv
    bits = np.unpackbits(h.view(np.uint8), axis=1, bitorder="little")[:, :code.k]
    p = np.empty((code.k, code.n - code.k), np.uint8)
    for c, r in row_of.items():
        p[:, c - code.k] = bits[r]
    return p


@functools.lru_cache(maxsize=None)
def _generator_on(code: Code, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(generator(code), device=device)


# --- CRC, encoding, rate matching ----------------------------------------

def crc24a(bits: np.ndarray) -> np.ndarray:
    """``[b, 24]`` CRC24A of the MSB-first ``[b, n]`` bits: the remainder of
    ``m(x) x^24`` by ``g(x)``, a shift register of 24 bits."""
    state = np.zeros(bits.shape[0], np.int64)
    for col in bits.T.astype(np.int64):
        fb = ((state >> 23) & 1) ^ col
        state = ((state << 1) & 0xFFFFFF) ^ (fb * CRC24A_POLY)
    return (state[:, None] >> np.arange(23, -1, -1)) & 1


def rate_match_positions(code: Code) -> np.ndarray:
    """The codeword position of each of the ``E`` sent bits: the circular
    buffer from ``2 Zc`` on (rv 0), filler bits ``K'..K-1`` skipped, round
    the buffer again where ``E`` exceeds it."""
    pos = np.arange(2 * code.z, code.n)
    pos = pos[(pos < code.k_prime) | (pos >= code.k)]
    return np.resize(pos, code.e)


def encode(code: Code, payload: torch.Tensor) -> torch.Tensor:
    """``[b, A]`` payload bits -> the ``[b, E]`` sent bits (int64): CRC24A,
    the filler, ``[u | u P]`` mod 2, rate matching."""
    dev = payload.device
    pay = payload.cpu().numpy().astype(np.int64)
    u = np.concatenate([pay, crc24a(pay), np.zeros((len(pay), code.k - code.k_prime), np.int64)],
                       axis=1)
    u_dev = torch.as_tensor(u, dtype=torch.float32, device=dev)
    gen = _generator_on(code, dev)
    parity = [torch.remainder(u_dev @ gen[:, c0:c0 + 2048].to(torch.float32), 2.0)
              for c0 in range(0, gen.shape[1], 2048)]       # exact: sums below 2^24
    word = torch.cat([u_dev, *parity], dim=1).to(torch.int64)
    return word[:, torch.as_tensor(rate_match_positions(code), device=dev)]


def derate_match(code: Code, llr: torch.Tensor) -> torch.Tensor:
    """``[..., E]`` LLRs -> ``[..., n]``: each position's LLRs summed in the
    order they were sent, filler bits at :data:`FILLER_LLR`, the rest 0."""
    pos = rate_match_positions(code)
    per = min(code.e, code.n - 2 * code.z - (code.k - code.k_prime))
    out = llr.new_zeros((*llr.shape[:-1], code.n))
    idx = torch.as_tensor(pos[:per], device=llr.device)
    for start in range(0, code.e, per):
        take = min(per, code.e - start)
        out[..., idx[:take]] += llr[..., start:start + take]
    out[..., code.k_prime:code.k] = FILLER_LLR
    return out


# --- demapper and decoder --------------------------------------------------

def noise_var(avg_sym_pow: float, snr_db: float) -> float:
    """``2 avg_sym_pow / 10^(snr/10)`` in float32 arithmetic."""
    f = np.float32
    return float(f(2.0 * avg_sym_pow) / f(10.0) ** (f(snr_db) / f(10.0)))


def soft_demap(y: torch.Tensor, qam: Qam, nv: float) -> torch.Tensor:
    """Exact LLRs ``[..., n_sym * bps]``, MSB first, positive = bit 1."""
    d = y[..., None] - qam.points
    metric = -(d.real ** 2 + d.imag ** 2) / nv                       # [..., n_sym, M]
    idx = torch.arange(qam.points.numel(), device=y.device)
    out = []
    for k in range(qam.bps):
        one = ((idx >> (qam.bps - 1 - k)) & 1).bool()
        out.append(torch.logsumexp(metric[..., one], -1) - torch.logsumexp(metric[..., ~one], -1))
    return torch.stack(out, -1).flatten(-2)


@functools.lru_cache(maxsize=None)
def _decoder_tables(code: Code):
    """Padded index tables of the edges: ``by_chk [n_chk, d_c]`` (each
    check's edges) and ``by_var [n, d_v]`` (each variable's edges, in
    increasing check order), ``-1`` past a degree; and each edge's
    variable."""
    chk, var = edge_list(code)

    def padded(owner, n):
        order = np.argsort(owner, kind="stable")
        deg = np.bincount(owner, minlength=n)
        width = max(int(deg.max()), 1)
        out = np.full((n, width), -1, np.int64)
        slot = np.arange(len(order)) - np.repeat(np.cumsum(deg) - deg, deg)
        out[owner[order], slot] = order
        return out

    return padded(chk, code.n_chk), padded(var, code.n), var


def _phi(x: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.tanh(torch.clamp(x, *PHI_CLAMP) / 2.0))


def decode(code: Code, llr: torch.Tensor, iters: int) -> torch.Tensor:
    """Flooding sum-product on ``[..., n]`` LLRs (positive = bit 0),
    ``iters`` iterations in full: ``[..., n]`` hard bits (int64)."""
    by_chk, by_var, var = (torch.as_tensor(t, device=llr.device)
                           for t in _decoder_tables(code))
    chk_pad, var_pad = by_chk < 0, by_var < 0
    chk_idx, var_idx = by_chk.clamp_min(0), by_var.clamp_min(0)
    c2v = llr.new_zeros((*llr.shape[:-1], var.numel()))

    def total(c2v):
        incoming = c2v[..., var_idx].masked_fill(var_pad, 0.0)
        return llr + incoming.sum(-1)

    for _ in range(iters):
        v2c = total(c2v)[..., var] - c2v                              # [..., edges]
        row = v2c[..., chk_idx]                                       # [..., n_chk, d_c]
        sign = torch.where(row < 0, -1.0, 1.0).masked_fill(chk_pad, 1.0)
        phi = _phi(row.abs()).masked_fill(chk_pad, 0.0)
        others = torch.clamp(phi.sum(-1, keepdim=True) - phi, *PHI_CLAMP)
        msg = sign.prod(-1, keepdim=True) * sign * _phi(others)
        c2v = torch.zeros_like(c2v)
        c2v[..., by_chk[~chk_pad]] = msg[..., ~chk_pad]
    return (total(c2v) < 0).to(torch.int64)


# --- the frame -------------------------------------------------------------

def frame_counters(link: dict, receiver: str, n_iters: int, snr_db: float, draws: dict,
                   planes: str = "float32", *, code_rate: float, ldpc_iters: int,
                   ldpc_algorithm: str = "sumprod") -> torch.Tensor:
    """Payload bit errors of each frame of ``draws`` (a dict of the frames'
    ``fade``/``loc``, ``bits_c``, ``bits_d`` ``[b, A]``, ``noise_c``,
    ``noise_d``), int64 ``[b, n_iters + 2]``: the clean run, then each
    CNC/MCNC pass."""
    check_supported(link, receiver)
    if ldpc_algorithm != "sumprod":
        raise ValueError(f"the LDPC reference models sum-product, not {ldpc_algorithm!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    code = code_of(link, code_rate)
    if draws["bits_d"].shape[-1] != code.a:
        raise ValueError(f"draws of {draws['bits_d'].shape[-1]} payload bits, the code "
                         f"carries {code.a}")
    prec = Precision(planes)
    store = prec.store
    dev = draws["bits_d"].device
    m, n_fft = link["modem"]["constel_size"], link["modem"]["n_fft"]
    n_sc, n_ant = link["modem"]["n_sub_carr"], link["array"]["n_elements"]
    ibo = link["pa"]["ibo_db"]
    qam = Qam(m, dev)
    avg_samp = qam.avg_power * n_sc / n_fft
    nv = noise_var(qam.avg_power, snr_db)

    h = channel(link, draws)                                          # [b, A, S]
    v = h.conj() / torch.sqrt((h.abs() ** 2).sum(-2, keepdim=True))
    vk_pow = (v.abs() ** 2).sum(-1)                                   # [b, A]
    ibo_k = 10 * torch.log10(10 ** (ibo / 10) * n_sc / (vk_pow.double() * n_ant))
    ak = bussgang_alpha(ibo_k).to(torch.float32)
    hv_terms = h * v
    hv = hv_terms.sum(-2)                                             # [b, S]
    akhv = (ak[..., None] * hv_terms).sum(-2)
    sat = 10 ** (ibo / 10) * avg_samp * vk_pow.sum(-1) / (n_ant * n_sc)   # [b]

    def tx_propagate(sym):
        y = store(chain(store(sym[:, None, :] * v), n_fft, sat[:, None, None], prec))
        return (h * y).sum(-2)

    sym_c = qam.modulate(encode(code, draws["bits_c"]))
    rx_c = _awgn((h * (sym_c[:, None, :] * v)).sum(-2), draws["noise_c"], snr_db,
                 qam.avg_power * (hv.abs() ** 2).mean(-1))
    corrected = [rx_c / hv]

    sym_d = qam.modulate(encode(code, draws["bits_d"]))
    rx_d = _awgn(tx_propagate(sym_d), draws["noise_d"], snr_db,
                 qam.avg_power * (akhv.abs() ** 2).mean(-1))
    rx_sc = rx_d / akhv
    if receiver == "cnc":
        alpha = float(bussgang_alpha(torch.tensor(float(ibo))))
        sat_c = torch.tensor(10 ** (ibo / 10) * avg_samp, device=dev)

        def replica(sym):
            return store(chain(store(sym), n_fft, sat_c, prec)) / alpha
    else:
        def replica(sym):
            return tx_propagate(sym) / akhv
    d_est = torch.zeros_like(rx_sc)
    for _ in range(n_iters + 1):
        corr = rx_sc - d_est
        corrected.append(corr)
        det, _ = qam.detect(corr)
        d_est = replica(det) - det

    llr = -soft_demap(torch.stack(corrected, 1), qam, nv)            # [b, passes, E]
    hard = decode(code, derate_match(code, llr), ldpc_iters)[..., :code.a]
    sent = torch.stack([draws["bits_c"], *[draws["bits_d"]] * (n_iters + 1)], 1)
    return (hard != sent.to(torch.int64)).sum(-1)
