"""The LDPC decoder's kernels (``kernels/ldpc_decode.py``,
``csrc/ldpc_decode.cu``): the wrapper on CPU tensors against the plain
version ``ops/ldpc.py::_decode``, the block tables against the plain
version's tables, the wrapper's checks, and two models of the kernels'
arithmetic (the same float32 operations with every sum in the kernels'
sequential order, and a float64 interval model of the same sums); and,
marked ``gpu`` (the ``cuda`` fixture skips without a card, decided at run
time), the kernels against the plain version forced on CUDA, against both
models, on the cell's chain and inside a coded frame. On a machine with an
H100:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_ldpc_decode.py -q
"""

import math
import types

import numpy as np
import pytest
import torch

from mimo_ofdm_tpu_torch import kernels
from mimo_ofdm_tpu_torch.kernels import ldpc_decode as kd
from mimo_ofdm_tpu_torch.ops import ldpc, nr_ldpc

DECODE = kd.ldpc_decode
U = 2.0 ** -24                          # float32's unit roundoff
LO_CLAMP = float(np.float32(1e-6))      # the clamps as float32 holds them
HI_CLAMP = 30.0

CODES = {
    "ira_z32": lambda: ldpc.make_default_code(),
    "bg1_z16": lambda: nr_ldpc.make_nr_code(1, 16),
    "bg1_z52": lambda: nr_ldpc.make_nr_code(1, 52),
    "bg2_z12": lambda: nr_ldpc.make_nr_code(2, 12),
    "bg2_z40": lambda: nr_ldpc.make_nr_code(2, 40),
}


def encode(code, info):
    return (nr_ldpc.encode if code.kind.startswith("nr") else ldpc.encode)(code, info)


def llrs(code, words, sigma, seed, device="cpu"):
    """BPSK LLRs (positive = bit 0) of random codewords through AWGN, the
    NR codes' 2 Z punctured bits at exactly 0; and the info bits."""
    rng = np.random.default_rng(seed)
    info = torch.from_numpy(rng.integers(0, 2, (words, code.k)).astype(np.int8))
    cw = encode(code, info).numpy()
    y = (1.0 - 2.0 * cw) + sigma * rng.normal(size=cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    if code.kind.startswith("nr"):
        llr[:, :2 * code.z] = 0.0
    return torch.from_numpy(llr).to(device), info.to(device)


# --- the kernels' arithmetic, modelled in torch ------------------------------

def layout(code):
    """The block tables as padded index tensors: each block row's planes
    ``[m_b, d_c]`` (-1 past its degree) and each check's variable ``[n_blocks,
    Z]``; each block column's flat message index ``[n_b, d_v, Z]`` (-1 past
    its degree), in the kernels' orders."""
    t, z = kd.block_tables(code), code.z
    r = np.arange(z)
    rs, cs = t["row_start"], t["col_start"]
    rows = np.full((code.m_b, np.diff(rs).max()), -1)
    for i in range(code.m_b):
        rows[i, :rs[i + 1] - rs[i]] = np.arange(rs[i], rs[i + 1])
    var_of = t["row_blocks"][:, :1] + (r[None] + t["row_blocks"][:, 1:]) % z
    cols = np.full((code.n_b, np.diff(cs).max(), z), -1)
    for j in range(code.n_b):
        for p, (bz, s) in enumerate(t["col_blocks"][cs[j]:cs[j + 1]]):
            cols[j, p] = bz + (r - s) % z
    return [torch.as_tensor(a) for a in (rows, var_of, cols)]


def _phi32(x):
    """The plain version's ``-log(tanh(clamp(x, 1e-6, 30) / 2))``."""
    return -torch.log(torch.tanh(torch.clamp(x, 1e-6, 30.0) / 2.0))


def sequential_beliefs(code, llr, n_iters, algorithm, normalization=0.75):
    """The kernels' decode in float32 torch operations, each sum in the
    kernels' order (a check row's in increasing block column, a variable's
    in increasing block row, from +0, one addition at a time): the beliefs
    ``llr + sum c2v`` ``[W, N]`` after ``n_iters`` iterations."""
    rows, var_of, cols = (t.to(llr.device) for t in layout(code))
    w, z = llr.shape[0], code.z
    n_blocks = var_of.shape[0]
    c2v = llr.new_zeros(w, n_blocks, z)
    total = llr
    for it in range(n_iters):
        v2c = total[:, var_of] if it == 0 else total[:, var_of] - c2v
        v = v2c[:, rows.clamp(min=0)]                          # [W, m_b, d_c, Z]
        real = (rows >= 0)[None, :, :, None]
        neg = (v < 0) & real
        parity = neg.sum(2) % 2
        mag = v.abs()
        new = torch.zeros_like(v)
        if algorithm == "sumprod":
            phi = _phi32(mag)
            acc = torch.zeros_like(v[:, :, 0])
            for k in range(v.shape[2]):
                acc = torch.where(real[:, :, k], acc + phi[:, :, k], acc)
            for k in range(v.shape[2]):
                new[:, :, k] = _phi32(acc - phi[:, :, k])
        else:
            inf = torch.full_like(v[:, :, 0], math.inf)
            min1, min2 = inf, inf
            arg1 = torch.zeros_like(v[:, :, 0], dtype=torch.long)
            for k in range(v.shape[2]):
                m = torch.where(real[:, :, k], mag[:, :, k], inf)
                lower = m < min1
                min2 = torch.where(lower, min1, torch.minimum(min2, m))
                arg1 = torch.where(lower, k, arg1)
                min1 = torch.where(lower, m, min1)
            for k in range(v.shape[2]):
                new[:, :, k] = normalization * torch.where(arg1 == k, min2, min1)
        new = torch.where((parity[:, :, None] ^ neg.long()) == 1, -new, new)
        c2v = c2v.clone()
        c2v[:, rows[rows >= 0]] = new[:, rows >= 0]
        flat = c2v.reshape(w, -1)
        acc = llr.new_zeros(w, code.n_b, z)
        for p in range(cols.shape[1]):
            idx = cols[:, p]
            acc = torch.where(idx >= 0, acc + flat[:, idx.clamp(min=0)], acc)
        total = llr + acc.reshape(w, -1)
    if n_iters == 0:
        total = llr + 0.0
    return total


def _gamma(n):
    return n * U / (1 - n * U)


def _phi64(x):
    return -torch.log(torch.tanh(x.clamp(LO_CLAMP, HI_CLAMP) / 2))


def _phi_err(p):
    """How far the card's float32 phi may lie from the exact one: tanhf
    errs by at most 2 ulp and logf by 1 (CUDA's math library), which moves
    -log(tanh) by at most 2^-23 (2 + phi); twice that."""
    return 2.0 ** -22 * (2.0 + p)


def _sum_rows(x, real):
    return torch.where(real, x, 0.0).sum(2, keepdim=True)


def belief_bounds(code, llr, n_iters):
    """A float64 interval model of the sum-product decode: every message as
    an interval that holds every value the float32 arithmetic can give,
    whatever order its sums run in (recursive summation of n terms errs by at
    most gamma_(n-1) sum |terms|, each float32 operation by a unit roundoff,
    phi as :func:`_phi_err`). Returns the bounds ``(lo, hi)`` of the beliefs
    ``[W, N]`` after ``n_iters`` iterations."""
    rows, var_of, cols = (t.to(llr.device) for t in layout(code))
    x = llr.double()
    w, z = x.shape[0], code.z
    n_blocks = var_of.shape[0]
    d_v = cols.shape[1]
    real = (rows >= 0)[None, :, :, None]
    lo = x.new_zeros(w, n_blocks, z)
    hi = x.new_zeros(w, n_blocks, z)

    def var_sums(lo, hi):
        """Per variable: llr + sum of its message bounds, and the float32
        sum error bound."""
        def total(m):
            flat = m.reshape(w, -1)
            return sum(torch.where(cols[:, p] >= 0, flat[:, cols[:, p].clamp(min=0)], 0.0)
                       for p in range(d_v)).reshape(w, -1)
        s_lo, s_hi = total(lo), total(hi)
        err = _gamma(d_v + 3) * (x.abs() + total(torch.maximum(lo.abs(), hi.abs())))
        return x + s_lo, x + s_hi, err

    for it in range(n_iters):
        if it == 0:                                  # v2c = llr, read as it is
            v_lo = v_hi = x[:, var_of]
        else:
            t_lo, t_hi, err = var_sums(lo, hi)
            v_lo = t_lo[:, var_of] - lo - err[:, var_of]
            v_hi = t_hi[:, var_of] - hi + err[:, var_of]
        v_lo, v_hi = v_lo[:, rows.clamp(min=0)], v_hi[:, rows.clamp(min=0)]
        pos, neg = v_lo >= 0, v_hi < 0
        unknown = ~(pos | neg) & real
        m_lo = torch.where(pos, v_lo, torch.where(neg, -v_hi, 0.0))
        m_hi = torch.where(pos, v_hi, torch.where(neg, -v_lo, torch.maximum(-v_lo, v_hi)))
        p_hi = _phi64(m_lo) + _phi_err(_phi64(m_lo))
        p_lo = (_phi64(m_hi) - _phi_err(_phi64(m_hi))).clamp(min=0)
        s_lo, s_hi = _sum_rows(p_lo, real), _sum_rows(p_hi, real)
        g = _gamma(rows.shape[1]) * s_hi
        e_lo, e_hi = s_lo - p_lo - g, s_hi - p_hi + g
        e_lo = torch.where(e_lo >= 0, e_lo * (1 - U), e_lo * (1 + U))
        e_hi = torch.where(e_hi >= 0, e_hi * (1 + U), e_hi * (1 - U))
        out_hi = _phi64(e_lo) + _phi_err(_phi64(e_lo))
        out_lo = (_phi64(e_hi) - _phi_err(_phi64(e_hi))).clamp(min=0)
        # a message's sign is the other edges' sign product: known when theirs are
        others_unknown = _sum_rows(unknown.long(), real) - unknown.long() > 0
        flip = (_sum_rows((neg & real).long(), real) - neg.long()) % 2 == 1
        n_lo = torch.where(others_unknown | flip, -out_hi, out_lo)
        n_hi = torch.where(others_unknown | ~flip, out_hi, -out_lo)
        lo, hi = lo.clone(), hi.clone()
        lo[:, rows[rows >= 0]] = n_lo[:, rows >= 0]
        hi[:, rows[rows >= 0]] = n_hi[:, rows >= 0]
    b_lo, b_hi, err = var_sums(lo, hi)
    return b_lo - err, b_hi + err


# --- the wrapper on CPU tensors ----------------------------------------------

@pytest.mark.parametrize("algorithm", ["minsum", "sumprod"])
@pytest.mark.parametrize("name", list(CODES))
def test_wrapper_on_cpu_equals_the_plain_version(name, algorithm):
    """On CPU tensors the wrapper is ``_decode``, bit for bit, and launches
    nothing; ``ldpc.decode`` gives the same bits."""
    code = CODES[name]()
    llr, _ = llrs(code, 3, 0.9, seed=len(name))
    before = DECODE.launches
    got = DECODE(code, llr, 5, algorithm=algorithm)
    want = ldpc._decode(code, llr, 5, 0.75, algorithm)
    assert got.dtype == torch.int8 and got.shape == (3, code.k)
    assert torch.equal(got, want)
    assert torch.equal(ldpc.decode(code, llr, 5, algorithm=algorithm), want)
    assert DECODE.launches == before


@pytest.mark.parametrize("name", list(CODES))
def test_block_tables_give_the_plain_versions_tables(name):
    """Expanded check by check and variable by variable, the block tables
    give ``_decode_tables``: each check's variables in the padded check-row
    layout, and each variable's check-row slots in increasing check order."""
    code = CODES[name]()
    chk_var_idx, chk_mask, var_slot_idx, var_mask = ldpc._decode_tables(code)
    t, z = kd.block_tables(code), code.z
    rs, cs = t["row_start"], t["col_start"]
    d_c = chk_var_idx.shape[1]
    row_of = np.repeat(np.arange(code.m_b), np.diff(rs))
    checks = np.zeros_like(chk_var_idx)
    for i in range(code.m_b):
        for k, (jz, s) in enumerate(t["row_blocks"][rs[i]:rs[i + 1]]):
            checks[i * z:(i + 1) * z, k] = jz + (np.arange(z) + s) % z
    assert np.array_equal(np.where(chk_mask, chk_var_idx, 0), checks)
    assert np.array_equal(chk_mask.sum(1), np.repeat(np.diff(rs), z))
    slots = np.zeros_like(var_slot_idx)
    for j in range(code.n_b):
        for p, (bz, s) in enumerate(t["col_blocks"][cs[j]:cs[j + 1]]):
            b = bz // z
            i, k = row_of[b], b - rs[row_of[b]]
            c = np.arange(z)
            slots[j * z + c, p] = (i * z + (c - s) % z) * d_c + k
    assert np.array_equal(np.where(var_mask, var_slot_idx, 0), slots)
    assert np.array_equal(var_mask.sum(1), np.repeat(np.diff(cs), z))


def _bad_calls(code):
    llr, _ = llrs(code, 4, 0.9, seed=1)
    return {
        "float64": ((llr.double(), 5), {}),
        "float16": ((llr.half(), 5), {}),
        "not contiguous": ((llr.t().contiguous().t(), 5), {}),
        "a strided view": ((llr[::2], 5), {}),
        "wrong length": ((llr[:, :-1].contiguous(), 5), {}),
        "unknown algorithm": ((llr, 5), {"algorithm": "bp"}),
    }


@pytest.mark.parametrize("case", list(_bad_calls(ldpc.make_default_code())))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    code = ldpc.make_default_code()
    args, kw = _bad_calls(code)[case]
    with pytest.raises(ValueError):
        DECODE(code, *args, **kw)


def test_decode_takes_any_float_layout_as_float32():
    """``ldpc.decode`` hands the wrapper contiguous float32 LLRs: float64
    and strided LLRs decode as their contiguous float32 copies."""
    code = CODES["bg2_z12"]()
    llr, _ = llrs(code, 6, 0.9, seed=4)
    want = ldpc.decode(code, llr, 4)
    assert torch.equal(ldpc.decode(code, llr.double(), 4), want)
    assert torch.equal(ldpc.decode(code, llr.t().contiguous().t(), 4), want)
    assert torch.equal(ldpc.decode(code, llr[::2], 4), want[::2])


@pytest.mark.parametrize("algorithm", ["minsum", "sumprod"])
@pytest.mark.parametrize("name", ["ira_z32", "bg1_z16", "bg2_z40"])
def test_sequential_model_decodes_as_the_plain_version(name, algorithm):
    """The model of the kernels' arithmetic, on the CPU: the same hard bits
    as ``_decode`` after 0, 1, 2, 5 and 12 iterations on a batch that
    decodes (only the sums' order differs); after none, the beliefs are
    the LLRs."""
    code = CODES[name]()
    llr, info = llrs(code, 4, 0.7, seed=7)
    for n in (0, 1, 2, 5, 12):
        b = sequential_beliefs(code, llr, n, algorithm)
        hard = (b[:, :code.k] < 0).to(torch.int8)
        assert torch.equal(hard, ldpc._decode(code, llr, n, 0.75, algorithm)), n
    assert torch.equal(sequential_beliefs(code, llr, 0, algorithm), llr + 0.0)
    assert torch.equal(hard, info)


@pytest.mark.parametrize("n_iters", [1, 2])
@pytest.mark.parametrize("name", ["bg1_z16", "ira_z32"])
def test_interval_model_holds_the_sequential_model(name, n_iters):
    """The float64 interval model holds the sequential float32 model's
    beliefs (torch's CPU tanh and log are within CUDA's ulp bounds too), and
    is tight: most beliefs' intervals are under 1e-4 of their size."""
    code = CODES[name]()
    llr, _ = llrs(code, 4, 0.8, seed=3)
    b = sequential_beliefs(code, llr, n_iters, "sumprod").double()
    lo, hi = belief_bounds(code, llr, n_iters)
    assert bool(((lo <= b) & (b <= hi)).all())
    width = (hi - lo) / b.abs().clamp(min=1.0)
    assert float((width < 1e-4).double().mean()) > 0.9


# --- the kernels on the card -------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _decode(code, llr, n_iters, algorithm="sumprod"):
    """One decode through the wrapper on the kernels: exactly one counted."""
    before = DECODE.launches
    out = DECODE(code, llr, n_iters, algorithm=algorithm)
    torch.cuda.synchronize()
    assert DECODE.launches == before + 1
    return out


def _plain(code, llr, n_iters, algorithm="sumprod"):
    before = DECODE.launches
    with kernels.plain_versions():
        out = DECODE(code, llr, n_iters, algorithm=algorithm)
    assert DECODE.launches == before
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["minsum", "sumprod"])
@pytest.mark.parametrize("name", list(CODES) + ["bg1_z288", "bg1_z384", "bg2_z384"])
def test_kernel_equals_the_plain_version_at_high_snr(cuda, name, algorithm):
    """Where every codeword decodes, the kernels' hard bits are the plain
    version's (forced on CUDA) and the sent bits, for every code shape."""
    code = (nr_ldpc.make_nr_code(int(name[2]), int(name.split("z")[1])) if name not in CODES
            else CODES[name]())
    llr, info = llrs(code, 24, 0.5, seed=11, device=cuda)
    got = _decode(code, llr, 12, algorithm)
    assert torch.equal(got, _plain(code, llr, 12, algorithm))
    assert torch.equal(got, info)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [0, 1, 2, 7])
@pytest.mark.parametrize("name", ["ira_z32", "bg1_z52", "bg2_z40"])
def test_minsum_beliefs_equal_the_sequential_model(cuda, name, n_iters):
    """Min-sum has no transcendental: the kernels' beliefs equal the model
    of their arithmetic and sum order bit for bit, and their hard bits the
    beliefs' signs."""
    code = CODES[name]()
    llr, _ = llrs(code, 16, 0.8, seed=n_iters, device=cuda)
    got = kd.kernel_beliefs(code, llr, n_iters, algorithm="minsum")
    want = sequential_beliefs(code, llr, n_iters, "minsum")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    hard = _decode(code, llr, n_iters, "minsum")
    assert torch.equal(hard, (got[:, :code.k] < 0).to(torch.int8))


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 2])
@pytest.mark.parametrize("name", ["bg1_z288", "ira_z32", "bg2_z40"])
def test_sumprod_beliefs_within_the_float32_bound_of_a_float64_model(cuda, name, n_iters):
    """The kernels' sum-product beliefs after 1 and 2 iterations lie inside
    the float64 interval model of the sequential sums (every float32 sum
    within gamma_(n-1) sum |terms|, tanhf and logf within their ulp bounds),
    whose intervals are under 1e-4 of the beliefs' size for most variables;
    the sequential float32 model (torch's CUDA tanh and log) lies inside
    too."""
    code = nr_ldpc.make_nr_code(1, 288) if name == "bg1_z288" else CODES[name]()
    llr, _ = llrs(code, 16, 0.8, seed=5, device=cuda)
    got = kd.kernel_beliefs(code, llr, n_iters, algorithm="sumprod").double()
    lo, hi = belief_bounds(code, llr, n_iters)
    assert bool(((lo <= got) & (got <= hi)).all())
    assert float(((hi - lo) / got.abs().clamp(min=1.0) < 1e-4).double().mean()) > 0.9
    model = sequential_beliefs(code, llr, n_iters, "sumprod").double()
    assert bool(((lo <= model) & (model <= hi)).all())


@pytest.mark.gpu
def test_cell_chain_at_8db_agrees_with_the_plain_version(cuda, monkeypatch):
    """The cell's decoder inputs: 16 coded frames of ``ldpc_ref_ber`` at 64
    antennas and Eb/N0 8 dB through the CNC receiver (8 passes), the 160
    codewords of BG1 at Zc 288 that a round decodes, 12 sum-product
    iterations. Against the plain version forced on CUDA, the block
    outcomes (the word decoded right or not) agree on at least 99% of the
    codewords and the bits on at least 99.9%: the kernels' float32 sums run
    in another order than PyTorch's reductions, which turns a few marginal
    decodes (about 55% of pass 0's words fail at this point)."""
    from mimo_ofdm_tpu_torch.experiments import ber_sweeps
    from mimo_ofdm_tpu_torch.models import link, link_ldpc
    from mimo_ofdm_tpu_torch.ops import transport

    cfg = ber_sweeps.coded_link_config("los", "cnc", 64, 0.0, False)
    chain = link_ldpc.reference_chain(cfg, 0.5)
    frame = link_ldpc.make_transport_frame_fn(cfg, 8, chain, 12, ldpc_algorithm="sumprod",
                                              device=cuda)
    draws = link.FrameDraws.draw(cfg, 16, torch.Generator(device=cuda).manual_seed(8),
                                 n_bits=chain.a)
    seen = []

    def keep(code, llr, *args):
        seen.append(llr.clone())
        return DECODE(code, llr, *args)

    monkeypatch.setattr(ldpc, "ldpc_decode", types.SimpleNamespace(ldpc_decode=keep))
    frame(15.781512503836437, draws)
    monkeypatch.undo()
    (llr,) = seen
    code = chain.code
    assert llr.shape == (10, 16, 1, code.n)
    got, want = _decode(code, llr, 12), _plain(code, llr, 12)

    def word(bits):
        tb = transport.crc_attach(bits.to(cuda), transport.CRC24A)
        return torch.cat([tb, tb.new_zeros(16, chain.n_filler)], -1)

    truth = torch.stack([word(draws.bits_c)] + [word(draws.bits_d)] * 9)[:, :, None]
    ok_got, ok_want = (got == truth).all(-1), (want == truth).all(-1)
    assert 0 < int(ok_want.sum()) < 160
    assert float((ok_got == ok_want).double().mean()) >= 0.99
    assert float((got == want).double().mean()) >= 0.999


@pytest.mark.gpu
def test_kernel_is_deterministic_and_batch_independent(cuda):
    """Two decodes of one batch give the same bits and beliefs; a codeword
    gives the same bits among 160 codewords as among 7, and in any leading
    shape."""
    code = nr_ldpc.make_nr_code(1, 288)
    llr, _ = llrs(code, 160, 0.85, seed=2, device=cuda)
    first, second = _decode(code, llr, 12), _decode(code, llr, 12)
    assert torch.equal(first, second)
    b1 = kd.kernel_beliefs(code, llr, 12, algorithm="sumprod")
    b2 = kd.kernel_beliefs(code, llr, 12, algorithm="sumprod")
    assert torch.equal(b1.view(torch.int32), b2.view(torch.int32))
    assert torch.equal(_decode(code, llr[:7].contiguous(), 12), first[:7])
    assert torch.equal(_decode(code, llr.view(10, 16, code.n), 12).view(160, -1), first)
    assert torch.equal((b1[:, :code.k] < 0).to(torch.int8), first)


@pytest.mark.gpu
def test_launches_count_one_a_decode(cuda):
    """``ldpc_decode.launches`` counts one a decode: through ``ldpc.decode``,
    ``transport_decode`` and a coded round; none under
    ``kernels.plain_versions()``, nor for an empty batch."""
    from mimo_ofdm_tpu_torch.models import link_ldpc
    from mimo_ofdm_tpu_torch.ops import transport
    from mimo_ofdm_tpu_torch.utils import config

    code = CODES["bg2_z40"]()
    llr, info = llrs(code, 4, 0.5, seed=1, device=cuda)
    before = DECODE.launches
    assert torch.equal(ldpc.decode(code, llr, 6), info)
    assert DECODE.launches == before + 1
    with kernels.plain_versions():
        assert torch.equal(ldpc.decode(code, llr, 6), info)
    assert DECODE.launches == before + 1
    assert DECODE(code, llr[:0], 6).shape == (0, code.k)
    assert DECODE.launches == before + 1
    cfg = config.LinkConfig(modem=config.ModemConfig(n_fft=1024, n_sub_carr=512),
                            array=config.ArrayConfig(n_elements=8))
    chain = link_ldpc.reference_chain(cfg, 0.5)
    pay = torch.randint(0, 2, (3, chain.a), dtype=torch.int8, device=cuda)
    coded = transport.transport_encode(chain, pay)
    rx, ok = transport.transport_decode(chain, (1.0 - 2.0 * coded.float()) * 4.0, n_iters=4,
                                        algorithm="sumprod", serial_blocks=2)
    assert torch.equal(rx, pay) and bool(ok.all())
    assert DECODE.launches == before + 3                      # two serial groups
    round_fn = link_ldpc.make_transport_round_fn(cfg, 2, 4, chain, ldpc_iters=4, device=cuda)
    round_fn(0, 0, 20.0)
    assert DECODE.launches == before + 4


@pytest.mark.gpu
def test_kernel_resources(cuda):
    """No instantiation spills, and each keeps at least 8 blocks of 128
    threads an SM."""
    rows = kd.kernel_resources()
    assert len(rows) == len(kd.INSTANTIATIONS)
    assert all(r["local_bytes"] == 0 and r["blocks_per_sm"] >= 8 for r in rows), rows
