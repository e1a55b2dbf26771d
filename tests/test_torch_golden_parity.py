"""Golden parity of the port's receivers: its CNC, MCNC, CNC-MU and MCNC-MU
loops against an independent NumPy version of the reference algorithms
(``reference/corrector.py:52-207,288-451``), on the inputs, sizes and
seeds of the JAX package's golden layer (``tests/test_golden_parity.py``).

The port's receivers take complex128 unchanged (the plain ``torch.fft``
chain, no kernel), so they run at complex128 here and every pass's hard
bits must equal the NumPy loop's exactly, as JAX's do. The MCNC-MU loop
runs the port's all-users replica; user 0's slice is compared.

The NumPy helpers are copied from the JAX test module; the Bussgang gain
and the saturation power come from the JAX package's closed forms, as
there."""

import numpy as np
import pytest
import torch

from mimo_ofdm_tpu.ops import pa

from mimo_ofdm_tpu_torch.models import receivers

M, N_FFT, N_SC = 64, 256, 128
BPS = 6


def np_constellation():
    n = int(np.sqrt(M))
    pam = np.arange(-n + 1, n, 2)
    snake = np.tile(np.hstack((pam, pam[::-1])), n // 2) * 1j + pam.repeat(n)
    gray = np.arange(M) ^ (np.arange(M) >> 1)
    return snake[gray.argsort()]


def np_embed(sym, n_fft=N_FFT):
    out = np.zeros(n_fft, np.complex128)
    out[-(N_SC // 2):] = sym[: N_SC // 2]
    out[1: N_SC // 2 + 1] = sym[N_SC // 2:]
    return out


def np_extract(fd, n_sc=N_SC):
    return np.concatenate((fd[-(n_sc // 2):], fd[1: n_sc // 2 + 1]))


def np_clip(x, sat):
    p = np.abs(x) ** 2
    return np.where(p <= sat, x, x * np.sqrt(sat / np.where(p > 0, p, 1.0)))


def np_detect(sym, constellation):
    idx = np.abs(sym - constellation[:, None]).argmin(0)
    return constellation[idx], idx


def np_bits(idx):
    return ((idx[:, None] >> np.arange(BPS - 1, -1, -1)) & 1).ravel()


def np_cnc_receive(rx_sc, n_iters, ibo_db):
    """Reference CNC loop (``reference/corrector.py:52-112``) in NumPy."""
    constellation = np_constellation()
    avg_sym_pow = np.mean(np.abs(constellation) ** 2)
    sat = 10 ** (ibo_db / 10) * avg_sym_pow / (N_FFT / N_SC)
    alpha = float(pa.bussgang_alpha(ibo_db))
    d_est = np.zeros(N_SC, np.complex128)
    bits_per_iter, sym_per_iter = [], []
    for _ in range(n_iters + 1):
        det, idx = np_detect(rx_sc - d_est, constellation)
        bits_per_iter.append(np_bits(idx))
        sym_per_iter.append(det)
        td = np.fft.ifft(np_embed(det), norm="ortho")
        rep = np_extract(np.fft.fft(np_clip(td, sat), norm="ortho"))
        d_est = rep / alpha - det
    return np.stack(bits_per_iter), np.stack(sym_per_iter)


def np_mcnc_receive(rx_sc, n_iters, h_sc, v, agc_sc, sat):
    """Reference MCNC loop (``reference/corrector.py:165-207``) in NumPy."""
    constellation = np_constellation()
    d_est = np.zeros(N_SC, np.complex128)
    bits_per_iter = []
    for _ in range(n_iters + 1):
        det, idx = np_detect(rx_sc - d_est, constellation)
        bits_per_iter.append(np_bits(idx))
        per_ant = v * det
        rep_sc = np.zeros(N_SC, np.complex128)
        for a in range(v.shape[0]):
            td = np.fft.ifft(np_embed(per_ant[a]), norm="ortho")
            rep_sc += h_sc[a] * np_extract(np.fft.fft(np_clip(td, sat), norm="ortho"))
        d_est = rep_sc / agc_sc - det
    return np.stack(bits_per_iter)


@pytest.fixture
def rx_input():
    rng = np.random.default_rng(0)
    constellation = np_constellation()
    tx_sym = constellation[rng.integers(0, M, N_SC)]
    td = np.fft.ifft(np_embed(tx_sym), norm="ortho")
    avg_sym_pow = np.mean(np.abs(constellation) ** 2)
    sat = 10 ** (0 / 10) * avg_sym_pow / (N_FFT / N_SC)
    rx_fd = np.fft.fft(np_clip(td, sat), norm="ortho")
    rx_sc = np_extract(rx_fd) / float(pa.bussgang_alpha(0.0))
    rx_sc += (rng.normal(size=N_SC) + 1j * rng.normal(size=N_SC)) * 0.05
    return rx_sc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.complex128))


def _iterate(rx_sc, n_iters, replica):
    bits, sym = receivers.cnc_iterate(_t(rx_sc), n_iters, M, replica)
    assert bits.shape == (n_iters + 1, *rx_sc.shape[:-1], N_SC * BPS)
    assert sym.dtype == torch.complex128
    return bits.numpy(), sym.numpy()


def test_cnc_bit_exact_vs_numpy_reference(rx_input):
    n_iters = 4
    gold_bits, gold_sym = np_cnc_receive(rx_input, n_iters, ibo_db=0.0)
    bits, sym = _iterate(rx_input, n_iters,
                         receivers.make_cnc_replica(M, N_FFT, N_SC, ibo_db=0.0))
    np.testing.assert_array_equal(bits, gold_bits)
    np.testing.assert_array_equal(sym, gold_sym)
    # iterations change the decisions: the loop is exercised
    assert (bits[0] != bits[-1]).any()


def test_mcnc_bit_exact_vs_numpy_reference(rx_input):
    rng = np.random.default_rng(1)
    n_ant, n_iters = 4, 3
    h_sc = (rng.normal(size=(n_ant, N_SC)) + 1j * rng.normal(size=(n_ant, N_SC))) / np.sqrt(2)
    v = np.conj(h_sc) / np.sqrt(np.sum(np.abs(h_sc) ** 2, axis=0))
    avg_samp_pow = float(np.mean(np.abs(np_constellation()) ** 2)) * N_SC / N_FFT
    sat = 10 ** (0 / 10) * avg_samp_pow * np.mean(np.abs(v) ** 2)
    vk_pow = np.sum(np.abs(v) ** 2, axis=1)
    ak = np.asarray(pa.bussgang_alpha(10 * np.log10(10 ** 0 * N_SC / (vk_pow * n_ant))))
    agc_sc = np.sum(ak[:, None] * h_sc * v, axis=0)

    gold = np_mcnc_receive(rx_input, n_iters, h_sc, v, agc_sc, sat)
    replica = receivers.make_mcnc_replica(_t(h_sc), _t(v), _t(agc_sc), constel_size=M,
                                          n_fft=N_FFT, n_sc=N_SC, sat_power=sat)
    bits, _ = _iterate(rx_input, n_iters, replica)
    np.testing.assert_array_equal(bits, gold)


def test_cnc_mu_matches_numpy(rx_input):
    """CNCWI: equal-power combined replica (``reference/corrector.py:288-345``)."""
    rng = np.random.default_rng(2)
    constellation = np_constellation()
    other = constellation[rng.integers(0, M, N_SC)]
    n_iters = 2
    sat = np.mean(np.abs(constellation) ** 2) / (N_FFT / N_SC)
    alpha = float(pa.bussgang_alpha(0.0))
    d_est = np.zeros(N_SC, np.complex128)
    gold = []
    w = np.sqrt(2) / 2
    for _ in range(n_iters + 1):
        det, idx = np_detect(rx_input - d_est, constellation)
        gold.append(np_bits(idx))
        td = np.fft.ifft(np_embed(w * det + w * other), norm="ortho")
        d_est = np_extract(np.fft.fft(np_clip(td, sat), norm="ortho")) / alpha - det

    replica = receivers.make_cnc_mu_replica(_t(other), constel_size=M, n_fft=N_FFT,
                                            n_sc=N_SC, ibo_db=0.0)
    bits, _ = _iterate(rx_input, n_iters, replica)
    np.testing.assert_array_equal(bits, np.stack(gold))


def test_mcnc_mu_bit_exact_vs_numpy_reference(rx_input):
    """MCNCWI: the replica transmit stacks the detected own-user symbols
    with the known other-user symbols in user order and runs the full
    MU-precoded TX + channel + own-user AGC
    (``reference/corrector.py:405-451``). The port's replica serves both
    users at once; user 0 gets ``rx_input``, user 1 a second frame, and
    user 0's bits are compared."""
    rng = np.random.default_rng(3)
    constellation = np_constellation()
    n_ant, n_usr, n_iters, usr_idx = 4, 2, 3, 0
    other = constellation[rng.integers(0, M, N_SC)]

    h_mu = (rng.normal(size=(n_usr, n_ant, N_SC))
            + 1j * rng.normal(size=(n_usr, n_ant, N_SC))) / np.sqrt(2)
    norm = np.sqrt(np.sum(np.abs(h_mu) ** 2, axis=(0, 1)))
    v_mu = np.transpose(np.conj(h_mu) / norm, (1, 0, 2))   # [n_ant, n_usr, n_sc]

    avg_samp_pow = float(np.mean(np.abs(constellation) ** 2)) * N_SC / N_FFT
    sat = avg_samp_pow * np.mean(np.sum(np.abs(v_mu) ** 2, axis=1))
    vk_pow = np.sum(np.abs(v_mu) ** 2, axis=(1, 2))
    ak = np.asarray(pa.bussgang_alpha(10 * np.log10(10 ** 0 * N_SC / (vk_pow * n_ant))))
    agc_mu = np.stack([np.sum(ak[:, None] * h_mu[u] * v_mu[:, u, :], axis=0)
                       for u in range(n_usr)])               # [n_usr, n_sc]
    h_u, agc_sc = h_mu[usr_idx], agc_mu[usr_idx]

    d_est = np.zeros(N_SC, np.complex128)
    gold = []
    for _ in range(n_iters + 1):
        det, idx = np_detect(rx_input - d_est, constellation)
        gold.append(np_bits(idx))
        sym_mu = np.stack([det, other]) if usr_idx == 0 else np.stack([other, det])
        per_ant = np.einsum("aus,us->as", v_mu, sym_mu)
        rep_sc = np.zeros(N_SC, np.complex128)
        for a in range(n_ant):
            td = np.fft.ifft(np_embed(per_ant[a]), norm="ortho")
            rep_sc += h_u[a] * np_extract(np.fft.fft(np_clip(td, sat), norm="ortho"))
        d_est = rep_sc / agc_sc - det

    # user 1's frame: its own symbols plus noise
    own1 = constellation[rng.integers(0, M, N_SC)]
    rx_mu = np.stack([rx_input, own1 + 0.05 * rng.normal(size=N_SC)])
    usr_symbols = np.stack([np.zeros(N_SC), other])           # user 0's row is detected
    replica = receivers.make_mcnc_mu_replica(
        _t(usr_symbols), _t(h_mu), _t(v_mu), _t(agc_mu), constel_size=M, n_fft=N_FFT,
        n_sc=N_SC, sat_power=sat)
    bits, _ = _iterate(rx_mu, n_iters, replica)
    np.testing.assert_array_equal(bits[:, usr_idx], np.stack(gold))
