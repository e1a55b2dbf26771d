"""The port's LDPC ops (mimo_ofdm_tpu_torch/ops/{qam,ldpc,nr_ldpc,transport}.py)
held against the JAX package's on the CPU, at small sizes.

Bit-exact: the NR base matrices (the surrogate's numpy draws), lifting and
rv offsets, the chain sizing, CRC remainders, the IRA and NR encoders and
the transport encoder. The soft demapper agrees to relative L2 1e-5. The
decoders run on one LLR batch at a waterfall SNR: min-sum gives JAX's hard
bits exactly; sum-product passes its messages through tanh and log, whose
float32 results differ by an ulp between XLA and torch, so its bits are
held equal or, failing that, its error totals within 5% (the differing bits
are counted in the assertion message).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import link_ldpc as jax_link_ldpc
from mimo_ofdm_tpu.ops import ldpc as jax_ldpc
from mimo_ofdm_tpu.ops import nr_ldpc as jax_nr
from mimo_ofdm_tpu.ops import qam as jax_qam
from mimo_ofdm_tpu.ops import transport as jax_tp
from mimo_ofdm_tpu.utils import config as jax_config

from mimo_ofdm_tpu_torch.models import link_ldpc
from mimo_ofdm_tpu_torch.ops import ldpc, nr_ldpc, qam, transport

SMALL_BITS = 768            # 64-QAM on 128 subcarriers
FULL_BITS = 12288           # 64-QAM on 2048 subcarriers


def _code(jcode) -> ldpc.QcLdpcCode:
    return ldpc.QcLdpcCode(jcode.base, jcode.z, jcode.kind)


def _chain(jchain) -> transport.TransportChain:
    c = jchain
    return transport.TransportChain(_code(c.code), c.a, c.e_total, c.c, c.k_prime,
                                    c.n_filler, c.rv)


def _f32(fn, *args):
    """A JAX function, compiled, in float32 semantics."""
    with jax.enable_x64(False):
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))


@pytest.mark.parametrize("bg", [1, 2])
@pytest.mark.parametrize("draw", [0, 1])
def test_base_graphs_bit_exact(bg, draw):
    """The surrogate protograph and base matrix of every lifting set the
    committed chains use (i_ls 0, 1, 3, 4), for surrogate draws 0 and 1."""
    try:
        jax_nr.set_surrogate_draw(draw)
        nr_ldpc.set_surrogate_draw(draw)
        np.testing.assert_array_equal(nr_ldpc._protograph_support(bg),
                                      jax_nr._protograph_support(bg))
        for i_ls in (0, 1, 3, 4):
            assert nr_ldpc._base_graph_cached(bg, i_ls) == jax_nr._base_graph_cached(bg, i_ls)
            zc = nr_ldpc.LIFTING_SETS[i_ls][-2]
            assert nr_ldpc.make_nr_code(bg, zc) == _code(jax_nr.make_nr_code(bg, zc))
    finally:
        jax_nr.set_surrogate_draw(0)
        nr_ldpc.set_surrogate_draw(0)


def test_set_base_graph_tables_round_trip():
    m_b, n_b, _ = nr_ldpc.BG_DIMS[2]
    table = np.random.default_rng(3).integers(-1, 52, (m_b, n_b))
    try:
        jax_nr.set_base_graph_tables(2, 6, table)
        nr_ldpc.set_base_graph_tables(2, 6, table)
        assert nr_ldpc.make_nr_code(2, 52) == _code(jax_nr.make_nr_code(2, 52))
        assert np.array_equal(np.asarray(nr_ldpc.make_nr_code(2, 52).base),
                              np.where(table >= 0, table % 52, -1))
        with pytest.raises(ValueError, match="must be"):
            nr_ldpc.set_base_graph_tables(2, 6, table[:, :-1])
    finally:
        for mod in (jax_nr, nr_ldpc):
            mod._user_tables.pop((2, 6), None)
            mod._base_graph_cached.cache_clear()
    assert nr_ldpc.make_nr_code(2, 52) == _code(jax_nr.make_nr_code(2, 52))


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return str(e)


def test_select_lifting_and_rv_k0():
    for bg in (1, 2):
        for k_prime in range(20, nr_ldpc.KCB[bg] + 1, 37):
            for b in (None, k_prime + 100, 200, 600, 700):
                assert (_outcome(nr_ldpc.select_lifting, bg, k_prime, b)
                        == _outcome(jax_nr.select_lifting, bg, k_prime, b))
        for rv in range(4):
            for n_cb, zc in ((19008, 288), (2600, 52), (7680, 96)):
                assert nr_ldpc.rv_k0(bg, rv, n_cb, zc) == jax_nr.rv_k0(bg, rv, n_cb, zc)
    with pytest.raises(ValueError, match="too large"):
        nr_ldpc.select_lifting(1, 9000)


def _fields(c):
    return (c.a, c.e_total, c.c, c.k_prime, c.n_filler, c.rv, c.code.z, c.code.kind,
            c.code.base)


@pytest.mark.parametrize("e_total", [SMALL_BITS, FULL_BITS])
def test_chain_sizing_matches_jax(e_total):
    """Exact-payload NR chains (the reference's sizing) and target-rate
    chains at rates 1/3 .. 7/8, and the IRA chains of the small modem."""
    for rate in (1 / 3, 1 / 2, 2 / 3, 3 / 4, 7 / 8):
        a = int(round(rate * e_total))
        bg = link_ldpc.select_base_graph(a, rate)
        assert bg == jax_link_ldpc.select_base_graph(a, rate)
        for kw in (dict(a=a), dict(target_rate=rate), dict(a=a, rv=2)):
            assert _fields(transport.make_nr_transport_chain(e_total, bg=bg, **kw)) == \
                _fields(jax_tp.make_nr_transport_chain(e_total, bg=bg, **kw))
    jcfg = jax_config.LinkConfig(modem=jax_config.ModemConfig(n_fft=256, n_sub_carr=128))
    from mimo_ofdm_tpu_torch.utils.config import config_from_dict
    import dataclasses
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    for kw in (dict(family="ira", n_blocks=2), dict(family="ira", code_rate=0.25, n_blocks=1),
               dict(family="nr", code_rate=0.75)):
        assert _fields(link_ldpc.transport_chain_for_modem(pcfg, **kw)) == \
            _fields(jax_link_ldpc.transport_chain_for_modem(jcfg, **kw))
    for rate in (0.5, 0.75):
        assert link_ldpc.code_for_modem(pcfg, rate) == _code(
            jax_link_ldpc.code_for_modem(jcfg, rate))
    assert (_outcome(link_ldpc.code_for_modem, pcfg, 2 / 3)
            == _outcome(jax_link_ldpc.code_for_modem, jcfg, 2 / 3))


def test_chain_sizing_errors():
    code = ldpc.make_default_code(k_b=8, m_b=8, z=24)
    with pytest.raises(ValueError, match="infeasible"):
        transport.make_transport_chain(code, e_total=10, a=5000)
    with pytest.raises(ValueError, match="give a or target_rate"):
        transport.make_nr_transport_chain(768)


@pytest.mark.parametrize("kind", [transport.CRC24A, transport.CRC24B, transport.CRC16])
def test_crc_matches_jax(kind):
    rng = np.random.default_rng(kind[1] & 0xFF)
    length, poly = kind
    for n in (1, 40, 408, 6168):
        bits = rng.integers(0, 2, (3, n)).astype(np.int8)
        want = _f32(functools.partial(jax_tp.crc_remainder, length=length, poly=poly), bits)
        got = transport.crc_remainder(torch.from_numpy(bits), length, poly)
        np.testing.assert_array_equal(got.numpy(), want)
        word = transport.crc_attach(torch.from_numpy(bits), kind)
        assert bool(transport.crc_ok(word, kind).all())
        word[:, 0] ^= 1
        assert not bool(transport.crc_ok(word, kind).any())


@pytest.mark.parametrize("k_b,m_b,z", [(12, 12, 32), (24, 12, 16), (12, 12, 4)])
def test_ira_encode_bit_exact(k_b, m_b, z):
    jcode = jax_ldpc.make_default_code(k_b=k_b, m_b=m_b, z=z)
    code = ldpc.make_default_code(k_b=k_b, m_b=m_b, z=z)
    assert code == _code(jcode)
    info = np.random.default_rng(z).integers(0, 2, (2, 3, code.k)).astype(np.int8)
    cw = ldpc.encode(code, torch.from_numpy(info))
    np.testing.assert_array_equal(cw.numpy(), _f32(functools.partial(jax_ldpc.encode, jcode),
                                                   info))
    assert cw.dtype == torch.int8 and bool(ldpc.syndrome_ok(code, cw).all())
    cw[..., 5] ^= 1
    assert not bool(ldpc.syndrome_ok(code, cw).any())


@pytest.mark.parametrize("bg,zc", [(2, 52), (1, 16), (2, 26), (1, 56)])
def test_nr_encode_bit_exact(bg, zc):
    jcode = jax_nr.make_nr_code(bg, zc)
    code = nr_ldpc.make_nr_code(bg, zc)
    info = np.random.default_rng(zc).integers(0, 2, (3, code.k)).astype(np.int8)
    cw = nr_ldpc.encode(code, torch.from_numpy(info))
    np.testing.assert_array_equal(cw.numpy(), _f32(functools.partial(jax_nr.encode, jcode),
                                                   info))
    np.testing.assert_array_equal(cw[0].numpy(), nr_ldpc.encode_np(code, info[0]))
    np.testing.assert_array_equal(nr_ldpc._core_inverse(code), jax_nr._core_inverse(jcode))
    assert bool(ldpc.syndrome_ok(code, cw).all())


# (name, JAX chain): NR single block, NR rv 2, NR segmented (BG2, C = 2),
# IRA segmented (C = 3) and IRA with repeated bits (rate 1/4)
CHAINS = {
    "nr_small": lambda: jax_tp.make_nr_transport_chain(SMALL_BITS, bg=2, a=384),
    "nr_small_rv2": lambda: jax_tp.make_nr_transport_chain(SMALL_BITS, bg=2, a=384, rv=2),
    "nr_bg2_c2": lambda: jax_tp.make_nr_transport_chain(7680, bg=2, a=3820),
    "ira_c3": lambda: jax_tp.make_transport_chain(
        jax_ldpc.make_default_code(12, 12, 16), e_total=SMALL_BITS, target_rate=0.5),
    "ira_repeat": lambda: jax_tp.make_transport_chain(
        jax_ldpc.make_default_code(12, 12, 16), e_total=SMALL_BITS, target_rate=0.25),
}


def test_chain_cases_cover_segmentation_and_repetition():
    chains = {k: _chain(f()) for k, f in CHAINS.items()}
    assert chains["nr_bg2_c2"].c == 2
    assert chains["ira_c3"].c == 3 and chains["nr_small_rv2"].rv == 2
    order, _ = transport._rm_order(chains["ira_repeat"])
    assert chains["ira_repeat"].e_cb > len(order)               # bits repeat


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_transport_encode_bit_exact(name):
    jchain = CHAINS[name]()
    chain = _chain(jchain)
    pay = np.random.default_rng(len(name)).integers(0, 2, (2, chain.a)).astype(np.int8)
    got = transport.transport_encode(chain, torch.from_numpy(pay))
    np.testing.assert_array_equal(got.numpy(), _f32(
        functools.partial(jax_tp.transport_encode, jchain), pay))
    sel, filler = transport._rm_tables(chain)
    jsel, jfiller = jax_tp._rm_tables(jchain)
    np.testing.assert_array_equal(sel, jsel)
    np.testing.assert_array_equal(filler, jfiller)


def test_soft_llr_matches_jax():
    rng = np.random.default_rng(11)
    sym = ((rng.normal(size=(3, 4, 128)) + 1j * rng.normal(size=(3, 4, 128))) * 4
           ).astype(np.complex64)
    nv = (rng.random((3, 4, 1)) * 10 + 1).astype(np.float32)
    for noise_var, pnv, alpha in ((np.float32(8.4), 8.4, 1.0), (nv, torch.from_numpy(nv), 1.0),
                                  (np.float32(5.3), 5.3, 0.9)):
        want = _f32(lambda s, v, a=alpha: jax_qam.soft_llr(s, 64, v, a), sym, noise_var)
        got = qam.soft_llr(torch.from_numpy(sym), 64, pnv, alpha)
        assert got.shape == want.shape == (3, 4, 768) and got.dtype == torch.float32
        assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-5
    for m in (4, 16):
        s = sym[0, :, :16]
        want = _f32(lambda x, v, m=m: jax_qam.soft_llr(x, m, v), s, np.float32(2.0))
        got = qam.soft_llr(torch.from_numpy(s), m, 2.0).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def _waterfall_llr(code_bits: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    """BPSK LLRs (positive = bit 0) of codewords through AWGN."""
    rng = np.random.default_rng(seed)
    y = (1.0 - 2.0 * code_bits) + sigma * rng.normal(size=code_bits.shape)
    return (2.0 * y / sigma ** 2).astype(np.float32)


def _hold(alg, got, want, truth):
    """Min-sum: equal bits. Sum-product: equal, or error totals within 5%."""
    diff = int((got != want).sum())
    if alg == "minsum" or diff == 0:
        assert diff == 0, f"{alg}: {diff} bits differ"
        return
    e_got, e_want = int((got != truth).sum()), int((want != truth).sum())
    assert abs(e_got - e_want) <= 0.05 * max(e_want, 100), (alg, diff, e_got, e_want)


@pytest.mark.parametrize("alg", ["minsum", "sumprod"])
@pytest.mark.parametrize("kind", ["ira", "nr"])
def test_decode_matches_jax(kind, alg):
    """A batch of 12 codewords at a waterfall SNR: some decode, some fail."""
    if kind == "ira":
        jcode = jax_ldpc.make_default_code(12, 12, 32)
        code = _code(jcode)
        enc = ldpc.encode
    else:
        jcode = jax_nr.make_nr_code(2, 52)
        code = _code(jcode)
        enc = nr_ldpc.encode
    info = np.random.default_rng(5).integers(0, 2, (12, code.k)).astype(np.int8)
    cw = enc(code, torch.from_numpy(info)).numpy()
    llr = _waterfall_llr(cw, 0.8 if kind == "ira" else 1.4, 6)
    got = ldpc.decode(code, torch.from_numpy(llr), n_iters=6, algorithm=alg).numpy()
    want = _f32(functools.partial(jax_ldpc.decode, jcode, n_iters=6, algorithm=alg), llr)
    errs = (got != info).sum(-1)
    assert (errs == 0).any() and (errs > 0).any(), errs       # a waterfall batch
    _hold(alg, got, want, info)
    with pytest.raises(ValueError, match="unknown LDPC decoder"):
        ldpc.decode(code, torch.from_numpy(llr), algorithm="bp")


@pytest.mark.parametrize("alg", ["minsum", "sumprod"])
@pytest.mark.parametrize("name", ["nr_small", "ira_c3", "ira_repeat"])
def test_transport_decode_matches_jax(name, alg):
    """Payload bits and TB CRC flags against JAX's, de-rate-matching of
    repeated bits included; ``serial_blocks`` gives the unchunked bits."""
    jchain = CHAINS[name]()
    chain = _chain(jchain)
    pay = np.random.default_rng(9).integers(0, 2, (3, 2, chain.a)).astype(np.int8)
    coded = transport.transport_encode(chain, torch.from_numpy(pay)).numpy()
    llr = _waterfall_llr(coded, 0.85, 10)
    rx, ok = transport.transport_decode(chain, torch.from_numpy(llr), n_iters=6,
                                        algorithm=alg)
    jrx, jok = _f32(functools.partial(jax_tp.transport_decode, jchain, n_iters=6,
                                      algorithm=alg), llr)
    assert rx.shape == (3, 2, chain.a) and ok.shape == (3, 2) and ok.dtype == torch.bool
    _hold(alg, rx.numpy(), jrx, pay)
    if alg == "minsum" or (rx.numpy() == jrx).all():
        np.testing.assert_array_equal(ok.numpy(), jok)
    ok_truth = (rx.numpy() == pay).all(-1)
    np.testing.assert_array_equal(ok.numpy(), ok_truth)
    rx2, ok2 = transport.transport_decode(chain, torch.from_numpy(llr), n_iters=6,
                                          algorithm=alg, serial_blocks=4)
    assert torch.equal(rx2, rx) and torch.equal(ok2, ok)


def test_derate_match_sums_repeats_in_order():
    """The repeated positions of the rate-1/4 IRA chain get the sum of
    their LLRs; punctured ones 0; filler ones the known-zero value."""
    chain = _chain(CHAINS["ira_repeat"]())
    order, filler = transport._rm_order(chain)
    sel, _ = transport._rm_tables(chain)
    llr = torch.arange(chain.e_total, dtype=torch.float32)[None] / 7.0
    buf = transport._derate_match(chain, llr)[0, 0].numpy()
    want = np.zeros(chain.code.n, np.float32)
    np.add.at(want, sel, llr[0].numpy())
    want[filler] = transport._FILLER_LLR
    np.testing.assert_array_equal(buf, want)
