"""Transport-block chain of the coded link: CRC attachment, code-block
segmentation, LDPC encoding and circular-buffer rate matching (port of
``mimo_ofdm_tpu/ops/transport.py``, the replacement for the reference's
MATLAB DL-SCH chain, ``reference/main_cnc_mcnc_w_ldpc/mp_ldpc_model.py:149-154``
and, to decode, ``:170-179``).

* **CRC** as a GF(2) matrix product: the remainder of each input bit
  position is precomputed on the host, and attaching or checking is one
  float32 product of 0/1 values mod 2 (exact: the sums stay below 2^24;
  CUDA has no integer matmul).
* **Segmentation** into ``C`` code blocks with a CRC24B each when ``C >
  1``, and zero filler bits up to the code's info length.
* **Rate matching** through a circular buffer with redundancy-version
  offsets and filler skipping (NR codes: the ``2 Zc`` punctured bits and
  the Table 5.4.2.1-2 ``k0``). De-rate-matching sums repeated positions
  in a fixed order and pins filler LLRs to a large known-zero value.

Sizes are resolved when the chain is made; the tables are built once per
chain on the host and kept on each device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from mimo_ofdm_tpu_torch.ops import ldpc, nr_ldpc
from mimo_ofdm_tpu_torch.utils.spans import spanned

# 3GPP TS 38.212 §5.1 generator polynomials (MSB first, degree bit implicit)
CRC24A = (24, 0x864CFB)
CRC24B = (24, 0x800063)
CRC16 = (16, 0x1021)

_FILLER_LLR = 64.0   # "known zero" LLR magnitude of the filler bits


@functools.lru_cache(maxsize=None)
def _crc_matrix(n_in: int, length: int, poly: int) -> np.ndarray:
    """``[n_in, length]`` GF(2) matrix: row ``i`` is the CRC remainder of a
    message with a single one at position ``i`` (MSB first, remainder of
    ``m(x) x^length mod g(x)``)."""
    g = (1 << length) | poly
    out = np.zeros((n_in, length), np.int8)
    rem = 1
    rems = {}
    for power in range(n_in + length):
        rems[power] = rem
        rem <<= 1
        if rem >> length:
            rem ^= g
    for i in range(n_in):
        r = rems[n_in - 1 - i + length]
        out[i] = [(r >> (length - 1 - b)) & 1 for b in range(length)]
    return out


@functools.lru_cache(maxsize=None)
def _crc_matrix_on(n_in: int, length: int, poly: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_crc_matrix(n_in, length, poly), dtype=torch.float32,
                           device=device)


def crc_remainder(bits: torch.Tensor, length: int, poly: int) -> torch.Tensor:
    """CRC remainder ``[..., length]`` int32 of MSB-first ``bits [..., K]``."""
    mat = _crc_matrix_on(bits.shape[-1], length, poly, bits.device)
    return torch.remainder(bits.to(torch.float32) @ mat, 2.0).to(torch.int32)


def crc_attach(bits: torch.Tensor, kind=CRC24A) -> torch.Tensor:
    length, poly = kind
    return torch.cat([bits, crc_remainder(bits, length, poly).to(bits.dtype)], dim=-1)


def crc_ok(bits_with_crc: torch.Tensor, kind=CRC24A) -> torch.Tensor:
    """True where the trailing CRC matches (the whole word's remainder is 0)."""
    length, poly = kind
    return (crc_remainder(bits_with_crc, length, poly) == 0).all(-1)


def _rv_start(rv: int, buf_len: int, z: int) -> int:
    """IRA codes' redundancy-version start, aligned to ``z`` (rv0..rv3 at
    0, 1/4, 1/2, 3/4 of the buffer); NR codes use :func:`nr_ldpc.rv_k0`."""
    frac = {0: 0.0, 1: 0.25, 2: 0.5, 3: 0.75}[rv]
    return (int(frac * buf_len) // z) * z


@dataclass(frozen=True)
class TransportChain:
    """Static plan: one transport block of ``a`` info bits into ``e_total``
    rate-matched bits through ``c`` code blocks of the given code."""
    code: ldpc.QcLdpcCode
    a: int                 # transport block payload bits
    e_total: int           # total rate-matched bits (fills the OFDM frame)
    c: int                 # number of code blocks
    k_prime: int           # info bits per code block incl. CB-CRC, pre-filler
    n_filler: int          # filler zero-bits per code block
    rv: int = 0

    @property
    def cb_crc(self) -> bool:
        return self.c > 1

    @property
    def e_cb(self) -> int:
        return self.e_total // self.c

    @property
    def coded_rate(self) -> float:
        return self.a / self.e_total


def make_transport_chain(code: ldpc.QcLdpcCode, e_total: int,
                         target_rate: float | None = None,
                         a: int | None = None, rv: int = 0) -> TransportChain:
    """Segmentation sizes of a transport block of ``a`` bits, or of the
    largest feasible payload at most ``target_rate * e_total - 24``
    (``mimo_ofdm_tpu/ops/transport.py:121-168``; the reference's
    ``trgt_tb_size = ceil(n_bits_per_frame * code_rate)``,
    ``mp_ldpc_model.py:99-104``)."""
    auto = a is None
    if auto:
        if target_rate is None:
            raise ValueError("give a or target_rate")
        a = int(np.floor(target_rate * e_total)) - 24

    def plan(a):
        b = a + 24
        k_max = code.k
        if b <= k_max:
            c, l_cb = 1, 0
        else:
            l_cb = 24
            c = int(np.ceil(b / (k_max - l_cb)))
        b_prime = b + c * l_cb
        if b_prime % c or e_total % c:
            return None
        k_prime = b_prime // c
        if k_prime > k_max:
            return None
        return TransportChain(code=code, a=a, e_total=e_total, c=c,
                              k_prime=k_prime, n_filler=k_max - k_prime, rv=rv)

    if not auto:
        chain = plan(a)
        if chain is None:
            raise ValueError(
                f"a={a} infeasible for e_total={e_total}, K={code.k}: need "
                f"(a + 24 + 24*C) % C == 0 and e_total % C == 0")
        return chain
    for cand in range(a, max(a - 4096, 0), -1):
        chain = plan(cand)
        if chain is not None:
            return chain
    raise ValueError(f"no feasible transport size near a={a} for "
                     f"e_total={e_total}, K={code.k}")


def make_nr_transport_chain(e_total: int, *, bg: int = 1,
                            target_rate: float | None = None,
                            a: int | None = None, rv: int = 0) -> TransportChain:
    """NR DL-SCH sizing (TS 38.212 §5.2.2, ``nrDLSCHInfo``,
    ``mimo_ofdm_tpu/ops/transport.py:280-328``): segment against ``Kcb``,
    pick ``Zc`` from the lifting sets, fill ``K - K'`` filler bits. Equal
    code blocks are assumed (``C | B'`` and ``C | E``); without ``a`` the
    payload is searched downward from the target."""
    auto = a is None
    if auto:
        if target_rate is None:
            raise ValueError("give a or target_rate")
        a = int(np.floor(target_rate * e_total)) - 24

    def plan(a):
        b = a + 24
        kcb = KCB_NR[bg]
        if b <= kcb:
            c, l_cb = 1, 0
        else:
            l_cb = 24
            c = int(np.ceil(b / (kcb - l_cb)))
        b_prime = b + c * l_cb
        if b_prime % c or e_total % c:
            return None
        k_prime = b_prime // c
        _, i_ls, zc = nr_ldpc.select_lifting(bg, k_prime, b)
        code = nr_ldpc.make_nr_code(bg, zc, i_ls)
        if k_prime > code.k:
            return None
        return TransportChain(code=code, a=a, e_total=e_total, c=c,
                              k_prime=k_prime, n_filler=code.k - k_prime, rv=rv)

    if not auto:
        chain = plan(a)
        if chain is None:
            raise ValueError(f"a={a} infeasible for e_total={e_total} (BG{bg})")
        return chain
    for cand in range(a, max(a - 4096, 0), -1):
        chain = plan(cand)
        if chain is not None:
            return chain
    raise ValueError(f"no feasible NR transport size near a={a} for "
                     f"e_total={e_total} (BG{bg})")


@functools.lru_cache(maxsize=None)
def _rm_order(chain: TransportChain) -> tuple[np.ndarray, np.ndarray]:
    """``(order, filler)``: the circular buffer's transmitted positions in
    transmission order from the rv start, and the filler mask ``[N]``
    (``mimo_ofdm_tpu/ops/transport.py:171-204``). The rate-matched bits
    are ``order`` tiled to ``e_cb``."""
    code, z = chain.code, chain.code.z
    filler = np.zeros(code.n, bool)
    if chain.n_filler:
        filler[chain.k_prime: code.k] = True
    usable = np.flatnonzero(~filler)
    if code.kind.startswith("nr"):
        # the first 2 Zc systematic bits are never sent (38.212 §5.4.2.1)
        bg = int(code.kind[-1])
        n_punct = 2 * z
        usable = usable[usable >= n_punct]
        start = n_punct + nr_ldpc.rv_k0(bg, chain.rv, code.n - n_punct, z)
    else:
        start = _rv_start(chain.rv, code.n, z)
    first = int(np.searchsorted(usable, start))
    return np.concatenate([usable[first:], usable[:first]]), filler


def _rm_tables(chain: TransportChain) -> tuple[np.ndarray, np.ndarray]:
    """``(sel [e_cb], filler [N])``: the buffer position of each
    rate-matched bit (JAX's ``_rm_tables``)."""
    order, filler = _rm_order(chain)
    reps = -(-chain.e_cb // len(order))
    return np.tile(order, reps)[: chain.e_cb], filler


@functools.lru_cache(maxsize=None)
def _rm_device(chain: TransportChain, device: torch.device):
    order, filler = _rm_order(chain)
    sel, _ = _rm_tables(chain)
    return (torch.as_tensor(sel, device=device), torch.as_tensor(order, device=device),
            torch.as_tensor(filler, device=device))


def transport_encode(chain: TransportChain, payload: torch.Tensor) -> torch.Tensor:
    """``[..., A]`` payload bits -> ``[..., E_total]`` rate-matched coded
    bits: CRC24A, segmentation (+ CRC24B), QC-LDPC encode, circular-buffer
    selection."""
    code = chain.code
    lead = payload.shape[:-1]
    tb = crc_attach(payload.to(torch.int8), CRC24A)             # [..., B]
    if chain.cb_crc:
        cbs = crc_attach(tb.reshape(*lead, chain.c, chain.k_prime - 24), CRC24B)
    else:
        cbs = tb.reshape(*lead, 1, chain.k_prime)
    if chain.n_filler:
        cbs = torch.cat([cbs, cbs.new_zeros((*lead, chain.c, chain.n_filler))], dim=-1)
    if code.kind.startswith("nr"):
        coded = nr_ldpc.encode(code, cbs)                        # [..., C, N]
    else:
        coded = ldpc.encode(code, cbs)
    sel, _, _ = _rm_device(chain, payload.device)
    return torch.index_select(coded, -1, sel).reshape(*lead, chain.e_total)


def _derate_match(chain: TransportChain, llr: torch.Tensor) -> torch.Tensor:
    """``[..., E_total]`` LLRs -> the decoder's ``[..., C, N]`` buffers.
    A position sent ``r`` times gets its LLRs summed in transmission
    order, as JAX's scatter-add does, and never through an atomic add
    (whose order on CUDA is not fixed); filler positions get the
    known-zero LLR and punctured ones 0."""
    code = chain.code
    lead = llr.shape[:-1]
    _, order, filler = _rm_device(chain, llr.device)
    per_cb = llr.reshape(*lead, chain.c, chain.e_cb).to(torch.float32)
    n_ord = order.shape[0]
    reps = -(-chain.e_cb // n_ord)
    per_cb = torch.nn.functional.pad(per_cb, (0, reps * n_ord - chain.e_cb))
    acc = per_cb[..., :n_ord]
    for r in range(1, reps):
        acc = acc + per_cb[..., r * n_ord:(r + 1) * n_ord]
    buf = per_cb.new_zeros((*lead, chain.c, code.n))
    buf[..., order] = acc
    return torch.where(filler, _FILLER_LLR, buf)


@spanned("decode")
def transport_decode(chain: TransportChain, llr: torch.Tensor, n_iters: int = 25,
                     algorithm: str = "minsum",
                     serial_blocks: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., E_total]`` LLRs (positive = bit 0) -> ``(payload [..., A]
    int8, tb_crc_ok [...])``. ``serial_blocks=g`` decodes the flattened
    (leading, code block) items ``g`` at a time, with the same bits as one
    batched decode: it bounds the decoder's memory."""
    code = chain.code
    lead = llr.shape[:-1]
    buf = _derate_match(chain, llr)
    if serial_blocks:
        flat = buf.reshape(-1, code.n)
        info = torch.cat([ldpc.decode(code, flat[i:i + serial_blocks], n_iters=n_iters,
                                      algorithm=algorithm)
                          for i in range(0, flat.shape[0], serial_blocks)])
        info = info.reshape(*lead, chain.c, code.k)
    else:
        info = ldpc.decode(code, buf, n_iters=n_iters, algorithm=algorithm)
    info = info[..., : chain.k_prime]
    if chain.cb_crc:
        info = info[..., : chain.k_prime - 24]                  # strip CRC24B
    tb = info.reshape(*lead, -1)                                 # [..., B]
    return tb[..., : chain.a], crc_ok(tb, CRC24A)


KCB_NR = nr_ldpc.KCB      # the maximum code-block size of each base graph
