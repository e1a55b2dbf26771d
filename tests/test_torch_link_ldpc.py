"""The port's coded link (mimo_ofdm_tpu_torch/models/link_ldpc.py) held
against the JAX package's ``models/link_ldpc.py`` on the CPU, at a small
size (n_fft 256, 64-QAM on 128 subcarriers, 8 antennas, LOS, IBO 3 dB).

The draws are JAX's own, taken where the JAX frames take them: each frame
key splits five ways (``link_ldpc.py:80,253,369``), the channel key into
the RX-offset and fade keys (``models/link.py:75``), the payload bits are
``bernoulli`` draws (``link_ldpc.py:89,103,261,280``) or, in the in-loop
frame, ``random_payload_bits`` (``:377,394``), and the noise is
``normal(k, (2, n_sc))`` (``ops/noise.py:21``). At f32 chain storage the
counters EQUAL those of JAX's frame run op by op (``jax.disable_jit()``,
float32; see tests/test_torch_link.py for why not the compiled frame):
min-sum exactly; sum-product passes its messages through tanh and log,
so it is held equal or, failing that, by totals within 5%. At bf16
storage the totals agree within 5%.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import link_ldpc as jax_ldpc_link
from mimo_ofdm_tpu.models.link import link_static as jax_link_static
from mimo_ofdm_tpu.ops import bits as jax_bits
from mimo_ofdm_tpu.utils import config as jax_config

from mimo_ofdm_tpu_torch.kernels import fused_pa
from mimo_ofdm_tpu_torch.models import link, link_ldpc
from mimo_ofdm_tpu_torch.ops import ldpc, transport
from mimo_ofdm_tpu_torch.utils import config as pt_config

N_ITERS = 1
LDPC_ITERS = 4
SNR_DB = 15.0
N_FRAMES = 4


def _jax_cfg(alg="cnc", storage="float32"):
    return jax_config.LinkConfig(
        modem=jax_config.ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128, cp_len=16),
        array=jax_config.ArrayConfig(n_elements=8),
        channel=jax_config.ChannelConfig(model="los"), precoding="mrt",
        pa=jax_config.PaConfig(model="softlim", ibo_db=3.0),
        rx=jax_config.RxConfig(algorithm=alg), mxu_fft_storage=storage)


def _port_cfg(jcfg):
    return pt_config.config_from_dict(dataclasses.asdict(jcfg))


def _port_code(jcode):
    return ldpc.QcLdpcCode(jcode.base, jcode.z, jcode.kind)


def _port_chain(jc):
    return transport.TransportChain(_port_code(jc.code), jc.a, jc.e_total, jc.c,
                                    jc.k_prime, jc.n_filler, jc.rv)


def _jax_draws(jcfg, keys, n_bits, payload_bits=False):
    """The randoms JAX's coded frames draw for each key, as FrameDraws."""
    n_sc = jcfg.modem.n_sub_carr
    half = jcfg.rx.loc_var / 2.0

    def bits(k):
        if payload_bits:
            return jax_bits.random_payload_bits(k, n_bits)
        return jax.random.bernoulli(k, 0.5, (n_bits,)).astype(jnp.int8)

    def one(key):
        k_chan, k_info_c, k_info_d, k_noise_c, k_noise_d = jax.random.split(key, 5)
        k_loc, _ = jax.random.split(k_chan)
        return (bits(k_info_c), bits(k_info_d),
                jax.random.normal(k_noise_c, (2, n_sc), jnp.float32),
                jax.random.normal(k_noise_d, (2, n_sc), jnp.float32),
                jax.random.uniform(k_loc, (2,), minval=-half, maxval=half))

    with jax.enable_x64(False):
        bc, bd, nc, nd, loc = [np.asarray(a) for a in jax.jit(jax.vmap(one))(keys)]
    return link.FrameDraws.from_numpy(None, bc, bd, nc, nd, loc=loc)


def _jax_eager(frame_fn, jcfg, keys):
    with jax.enable_x64(False), jax.disable_jit():
        c = jax.vmap(frame_fn, in_axes=(0, None, None))(keys, np.float32(SNR_DB),
                                                        jax_link_static(jcfg)[0])
        return {f: np.asarray(getattr(c, f)) for f in c._fields}


def _frames(kind, alg, decoder, storage="float32", seed=3):
    """(JAX's op-by-op counters, the port's counters) of one coded frame."""
    jcfg = _jax_cfg(alg, storage)
    pcfg = _port_cfg(jcfg)
    keys = jax.random.split(jax.random.key(seed), N_FRAMES)
    if kind == "coded":
        jcode = jax_ldpc_link.code_for_modem(jcfg, 0.5)
        jf = jax_ldpc_link.make_coded_frame_fn(jcfg, N_ITERS, jcode, LDPC_ITERS)
        pf = link_ldpc.make_coded_frame_fn(pcfg, N_ITERS, _port_code(jcode), LDPC_ITERS,
                                           device="cpu")
        draws = _jax_draws(jcfg, keys, jcode.k)
    else:
        # the IRA chain of 3 code blocks (CRC24B, filler); the NR chains'
        # encoder is held bit-exact in tests/test_torch_ldpc.py, and JAX's
        # op-by-op NR encoder compiles ~600 distinct rolls
        jchain = jax_ldpc_link.transport_chain_for_modem(jcfg, 0.5, n_blocks=2, family="ira")
        chain = _port_chain(jchain)
        if kind == "inloop":
            jf = jax_ldpc_link.make_transport_inloop_frame_fn(
                jcfg, N_ITERS, jchain, LDPC_ITERS, ldpc_algorithm=decoder)
            pf = link_ldpc.make_transport_inloop_frame_fn(
                pcfg, N_ITERS, chain, LDPC_ITERS, ldpc_algorithm=decoder, device="cpu")
        else:
            nv_adjust = kind == "nvadj"
            jf = jax_ldpc_link.make_transport_frame_fn(
                jcfg, N_ITERS, jchain, LDPC_ITERS, ldpc_algorithm=decoder, nv_adjust=nv_adjust)
            pf = link_ldpc.make_transport_frame_fn(
                pcfg, N_ITERS, chain, LDPC_ITERS, ldpc_algorithm=decoder,
                nv_adjust=nv_adjust, device="cpu")
        draws = _jax_draws(jcfg, keys, jchain.a, payload_bits=kind == "inloop")
    pc = pf(SNR_DB, draws)
    return _jax_eager(jf, jcfg, keys), {f: getattr(pc, f).numpy() for f in pc._fields}


def _totals(c):
    return np.concatenate([np.atleast_1d(v.sum(0)) for v in c.values()]).astype(float)


FRAME_CASES = [("coded", "cnc", "minsum"), ("coded", "mcnc", "minsum"),
               ("transport", "cnc", "minsum"), ("transport", "mcnc", "sumprod"),
               ("nvadj", "cnc", "sumprod"), ("inloop", "cnc", "sumprod"),
               ("inloop", "mcnc", "minsum")]


@pytest.mark.parametrize("kind,alg,decoder", FRAME_CASES,
                         ids=["-".join(c) for c in FRAME_CASES])
def test_frame_counters_equal_jax(kind, alg, decoder):
    """The IRA coded frame, the transport frame (min-sum, sum-product and
    the noise-variance-adjusted LLRs) and the in-loop frame, CNC and MCNC,
    on JAX's draws: per-frame counters equal JAX's op-by-op frame."""
    jc, pc = _frames(kind, alg, decoder)
    assert list(pc) == list(jc)
    for f, v in pc.items():
        assert v.dtype == np.int32 and v.shape == jc[f].shape, f
    if decoder == "minsum" or all(np.array_equal(pc[f], jc[f]) for f in pc):
        for f in pc:
            np.testing.assert_array_equal(pc[f], jc[f], err_msg=f)
    else:
        a, b = _totals(jc), _totals(pc)
        assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, 100)), (a, b)
    assert pc["dist_err"].sum() > 0


def test_frame_bf16_totals_within_5_percent():
    """At bf16 chain storage the two packages round at different places."""
    jc, pc = _frames("transport", "mcnc", "minsum", storage="bfloat16")
    a, b = _totals(jc), _totals(pc)
    assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, 100)), (a, b)


def _small_cfg(alg="cnc", **kw):
    return _port_cfg(_jax_cfg(alg)).replace(**kw)


def test_transport_round_layout_and_determinism():
    """ONE int32 vector [clean_err, dist_err..., clean_blk, dist_blk...]
    summed over the batch, from the round's own draws; the same key gives
    the same counters, another key others; without the clean run its
    counters are 0; serial decoding gives the batched decode's counters."""
    cfg = _small_cfg()
    chain = link_ldpc.transport_chain_for_modem(cfg, 0.5)
    kw = dict(ldpc_iters=LDPC_ITERS, device="cpu")
    rf = link_ldpc.make_transport_round_fn(cfg, 2, 3, chain, **kw)
    a, b, c = rf(0, 1, 14.0), rf(0, 1, 14.0), rf(0, 2, 14.0)
    assert a.dtype == torch.int32 and a.shape == (2 * (2 + 2),)
    assert torch.equal(a, b) and not torch.equal(a, c)
    errs, blks = a[:4], a[4:]
    assert (blks <= 3).all() and (errs <= 3 * chain.a).all() and errs[1] > 0
    serial = link_ldpc.make_transport_round_fn(cfg, 2, 3, chain, serial_decode=2, **kw)
    assert torch.equal(serial(0, 1, 14.0), a)
    no_clean = link_ldpc.make_transport_round_fn(cfg, 2, 3, chain, incl_clean=False, **kw)
    nc = no_clean(0, 1, 14.0)
    assert nc[0] == 0 and nc[4] == 0 and torch.equal(nc[1:4], a[1:4])
    gen = torch.Generator().manual_seed(link.round_seed(0, 1))
    body = link_ldpc.make_transport_body_fn(cfg, 2, chain, **kw)
    draws = link.FrameDraws.draw(cfg, 3, gen, n_bits=chain.a)
    assert torch.equal(body(14.0, draws), a)


def test_inloop_and_coded_rounds():
    cfg = _small_cfg("mcnc")
    chain = link_ldpc.transport_chain_for_modem(cfg, 1 / 3)
    rf = link_ldpc.make_transport_inloop_round_fn(cfg, 2, 2, chain, ldpc_iters=LDPC_ITERS,
                                                  device="cpu")
    out = rf(0, 0, 12.0)
    assert out.shape == (8,) and out.dtype == torch.int32 and torch.equal(out, rf(0, 0, 12.0))
    code = link_ldpc.code_for_modem(cfg, 0.5)
    rc = link_ldpc.make_coded_round_fn(cfg, 2, 2, code, ldpc_iters=LDPC_ITERS, device="cpu")
    out = rc(0, 0, 12.0)
    assert out.shape == (4,) and out.dtype == torch.int32 and int(out[1]) > 0
    assert torch.equal(out, rc(0, 0, 12.0))


def test_coded_round_launches_the_chain_per_pass():
    """With the chain on (the default ``use_mxu_fft``), a round calls the
    fused kernel's wrapper once for the TX and once per replica pass
    (here its plain version, on CPU tensors); the in-loop round too."""
    cfg = _small_cfg("mcnc")
    chain = link_ldpc.transport_chain_for_modem(cfg, 0.5)
    calls = []
    plain = fused_pa.fused_ifft_pa_fft_plain

    def counted(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    fused_pa.fused_ifft_pa_fft_plain = counted
    try:
        link_ldpc.make_transport_round_fn(cfg, 2, 2, chain, ldpc_iters=2, device="cpu")(0, 0, 14.0)
        assert len(calls) == 1 + 3 and calls[0][:-1].numel() == 2 * cfg.array.n_elements
        calls.clear()
        link_ldpc.make_transport_inloop_round_fn(cfg, 2, 2, chain, ldpc_iters=2,
                                                 device="cpu")(0, 0, 14.0)
        assert len(calls) == 1 + 3
    finally:
        fused_pa.fused_ifft_pa_fft_plain = plain


def test_entry_points_check_device_and_config():
    cfg = _small_cfg()
    chain = link_ldpc.transport_chain_for_modem(cfg, 0.5)
    code = link_ldpc.code_for_modem(cfg, 0.5)
    if not torch.cuda.is_available():
        for make in (lambda: link_ldpc.make_transport_round_fn(cfg, 1, 2, chain),
                     lambda: link_ldpc.make_transport_inloop_round_fn(cfg, 1, 2, chain),
                     lambda: link_ldpc.make_coded_round_fn(cfg, 1, 2, code)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    mu = cfg.replace(modem=dataclasses.replace(cfg.modem, n_users=2))
    with pytest.raises(ValueError, match="link_mu"):
        link_ldpc.make_transport_frame_fn(mu, 1, chain, device="cpu")
    other = link_ldpc.transport_chain_for_modem(
        cfg.replace(modem=pt_config.ModemConfig(n_fft=512, n_sub_carr=256)), 0.5)
    with pytest.raises(ValueError, match="chain fills"):
        link_ldpc.make_transport_frame_fn(cfg, 1, other, device="cpu")
    with pytest.raises(ValueError, match="code length"):
        link_ldpc.make_coded_frame_fn(cfg, 1, ldpc.make_default_code(z=8), device="cpu")
