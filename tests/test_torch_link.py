"""The port's planar link frame (mimo_ofdm_tpu_torch/models/link*.py) held
against the JAX package's ``make_planar_frame_fn`` on the JAX package's
own random draws, at a small size on the CPU.

The draws are taken exactly where the JAX frame takes them: each frame key
splits six ways (``link_planar.py:236-237``), the channel key two ways
(``:155``), then the fade (``:166``), payload bits (``ops/bits.py:36``) and
noise normals (``ops/noise.py:21``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import link as jax_link
from mimo_ofdm_tpu.models import link_planar as jax_planar
from mimo_ofdm_tpu.models.link import link_static as jax_link_static
from mimo_ofdm_tpu.ops import bits as jax_bits
from mimo_ofdm_tpu.utils import config as jax_config

from mimo_ofdm_tpu_torch.models import link, link_planar
from mimo_ofdm_tpu_torch.utils import config as pt_config

N_FRAMES = 12
N_ITERS = 2
SNR_DB = 15.0


def _jax_cfg(alg="cnc", storage="float32", **kw):
    return jax_config.LinkConfig(
        modem=jax_config.ModemConfig(constel_size=64, n_fft=1024, n_sub_carr=512),
        array=jax_config.ArrayConfig(n_elements=8),
        channel=jax_config.ChannelConfig(model="rayleigh"),
        rx=jax_config.RxConfig(algorithm=alg),
        channel_storage=storage, mxu_fft_storage=storage, **kw)


def _port_cfg(jcfg):
    return pt_config.config_from_dict(dataclasses.asdict(jcfg))


def _jax_draws(jcfg, keys, storage="float32", reroll=True):
    """The randoms the JAX frame draws for each key, as FrameDraws: only
    those the config uses, in float32 semantics (the suite's x64 mode
    would draw the RX offsets in float64)."""
    st = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    n_ant, n_sc = jcfg.array.n_elements, jcfg.modem.n_sub_carr
    n_bits = jcfg.modem.n_bits_per_ofdm_sym
    half = jcfg.rx.loc_var / 2.0
    model = jcfg.channel.model

    def one(key):
        k_chan, k_csi, k_bits_c, k_bits_d, k_noise_c, k_noise_d = jax.random.split(key, 6)
        k_loc, k_fade = jax.random.split(k_chan)
        return (jax.random.normal(k_fade, (2, n_ant, n_sc), st).astype(jnp.float32),
                jax_bits.random_payload_bits(k_bits_c, n_bits),
                jax_bits.random_payload_bits(k_bits_d, n_bits),
                jax.random.normal(k_noise_c, (2, n_sc), jnp.float32),
                jax.random.normal(k_noise_d, (2, n_sc), jnp.float32),
                jax.random.uniform(k_loc, (2,), minval=-half, maxval=half),
                jax.random.normal(k_csi, (2, n_ant, n_sc), jnp.float32))

    with jax.enable_x64(False):
        fade, bc, bd, nc, nd, loc, csi = [np.asarray(a) for a in jax.jit(jax.vmap(one))(keys)]
    return link.FrameDraws.from_numpy(
        fade if model == "rayleigh" else None, bc, bd, nc, nd,
        loc=loc if reroll and model in ("los", "two_path") else None,
        csi=csi if jcfg.csi_epsilon or jcfg.csi_snr_db is not None else None)


def _run_both(alg, storage, seed=5):
    jcfg = _jax_cfg(alg, storage)
    keys = jax.random.split(jax.random.key(seed), N_FRAMES)
    tx_pos = jax_link_static(jcfg)[0]
    f = jax.jit(jax.vmap(jax_planar.make_planar_frame_fn(jcfg, N_ITERS, storage=storage),
                         in_axes=(0, None, None)))
    jc = f(keys, np.float32(SNR_DB), tx_pos)
    draws = _jax_draws(jcfg, keys, storage)
    frame = link.make_frame_fn(_port_cfg(jcfg), N_ITERS, device="cpu")
    pc = frame(np.float32(SNR_DB), draws)
    return ((np.asarray(jc.clean_err), np.asarray(jc.dist_err)),
            (pc.clean_err.numpy(), pc.dist_err.numpy()))


@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_counters_equal_jax_float32(alg):
    """At f32 storage the per-frame counters equal JAX's exactly: the two
    f32 transform chains differ only by round-off, which flips no hard
    decision at this SNR (the exactness tests/test_mxu_fft.py:99-104
    asserts between two f32 transforms)."""
    (jc, jd), (pc, pd) = _run_both(alg, "float32")
    assert pd.shape == (N_FRAMES, N_ITERS + 1) and pd.dtype == np.int32
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pd, jd)
    assert jd.sum() > 0 and jc.sum() > 0


@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
def test_counters_bf16_within_mc_noise(alg):
    """At bf16 storage the two packages round at different places (both
    round each pass's operand to bf16, the port on the products' operands
    only); totals agree within the rule of tests/test_mxu_fft.py:107-130."""
    (jc, jd), (pc, pd) = _run_both(alg, "bfloat16")
    a = np.concatenate([[jc.sum()], jd.sum(0)]).astype(float)
    b = np.concatenate([[pc.sum()], pd.sum(0)]).astype(float)
    assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, 100)), (a, b)


def test_none_receiver_and_no_clean_run():
    jcfg = _jax_cfg("none", "float32")
    keys = jax.random.split(jax.random.key(2), 4)
    draws = _jax_draws(jcfg, keys, "float32")
    frame = link.make_frame_fn(_port_cfg(jcfg), N_ITERS, device="cpu",
                               incl_clean=False)
    c = frame(np.float32(SNR_DB), draws)
    assert (c.clean_err == 0).all()
    assert (c.dist_err == c.dist_err[:, :1]).all()      # every pass = pass 0
    jf = jax.jit(jax.vmap(jax_planar.make_planar_frame_fn(jcfg, N_ITERS, storage="float32",
                                                          incl_clean=False),
                          in_axes=(0, None, None)))
    jc = jf(keys, np.float32(SNR_DB), jax_link_static(jcfg)[0])
    np.testing.assert_array_equal(c.dist_err.numpy(), np.asarray(jc.dist_err))


def test_config_round_trip_and_eligibility():
    """Same field names and defaults as the JAX configs; the planar gate
    agrees with JAX's on the configs both can run."""
    for name in ("ModemConfig", "PaConfig", "ArrayConfig", "ChannelConfig",
                 "RxConfig", "LinkConfig", "SweepConfig"):
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jax_config, name))}
        pf = {f.name: f.default for f in dataclasses.fields(getattr(pt_config, name))}
        assert jf == pf, name
    jcfg, _ = jax_config.canonical_miso_cnc()
    pcfg, _ = pt_config.canonical_miso_cnc()
    assert _port_cfg(jcfg) == pcfg
    assert pcfg.modem.avg_sample_power == jcfg.modem.avg_sample_power
    base = _jax_cfg()
    variants = [base, base.replace(rx=jax_config.RxConfig(algorithm="mcnc")),
                base.replace(precoding="zf"), base.replace(csi_epsilon=0.1),
                base.replace(channel=jax_config.ChannelConfig(model="random_paths")),
                base.replace(rx=jax_config.RxConfig(algorithm="cnc_mu")),
                base.replace(use_mxu_fft=False), jcfg]
    for v in variants:
        assert link_planar.planar_eligible(_port_cfg(v)) == jax_planar.planar_eligible(v), v


def test_entry_points_dispatch_and_device():
    """Every channel model (LOS, two-path, AWGN, Rician, random paths, TDL,
    GSCM), complex64 storage, the none/phase precoders, both CSI-error
    models and the circular/planar arrays build; multi-user configs raise
    ValueError naming models/link_mu.py, which runs them; an unknown channel
    raises; an entry point with no card and no device="cpu" raises."""
    pcfg = _port_cfg(_jax_cfg())
    geo = dict(n_elements=12, n_rows=3, n_cols=4)
    for cfg in (pcfg.replace(channel_storage="complex64"),
                *[pcfg.replace(channel=pt_config.ChannelConfig(model=m))
                  for m in ("los", "two_path", "rician", "random_paths", "tdl_3gpp", "gscm")],
                pcfg.replace(channel=pt_config.ChannelConfig(model="awgn"), precoding="none"),
                pcfg.replace(precoding="phase"), pcfg.replace(csi_epsilon=0.1),
                pcfg.replace(csi_snr_db=15.0),
                pcfg.replace(array=pt_config.ArrayConfig(geometry="circular", **geo)),
                pcfg.replace(array=pt_config.ArrayConfig(geometry="planar", **geo))):
        link.make_frame_fn(cfg, 1, device="cpu")
    for cfg in (pcfg.replace(modem=dataclasses.replace(pcfg.modem, n_users=2)),
                pcfg.replace(precoding="zf"),
                pcfg.replace(rx=pt_config.RxConfig(algorithm="mcnc_mu"))):
        with pytest.raises(ValueError, match="link_mu"):
            link.make_frame_fn(cfg, 1, device="cpu")
    with pytest.raises(ValueError, match="unknown channel model"):
        link.make_frame_fn(pcfg.replace(channel=pt_config.ChannelConfig(model="quadriga"),
                                        channel_storage="complex64"), 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            link.make_round_fn(pcfg, 1, 2)


def test_round_fn_flat_counters_deterministic():
    pcfg = _port_cfg(_jax_cfg("cnc", "bfloat16"))
    rf = link.make_round_fn(pcfg, N_ITERS, 4, device="cpu")
    a, b, c = rf(0, 3, 12.0), rf(0, 3, 12.0), rf(0, 4, 12.0)
    assert a.dtype == torch.int32 and a.shape == (N_ITERS + 2,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    tup = link.make_round_fn(pcfg, N_ITERS, 4, flat=False, device="cpu")(0, 3, 12.0)
    assert int(tup.clean_err) == int(a[0])
    assert torch.equal(tup.dist_err, a[1:])
    n_bits = 4 * pcfg.modem.n_bits_per_ofdm_sym
    assert 0 < int(a[0]) < int(a[1]) < n_bits // 4


# --- the complex64 branch of make_frame_fn, on JAX's own draws ------------

COMPLEX_CASES = [
    # (channel, precoding, n_ant, receiver, pa model, CSI error)
    *[(chan, prec, n_ant, alg, "softlim", csi)
      for chan, prec, n_ant, alg in (("awgn", "none", 1, "cnc"), ("los", "mrt", 8, "mcnc"),
                                     ("two_path", "phase", 8, "cnc"),
                                     ("rayleigh", "mrt", 8, "mcnc"))
      for csi in ("perfect", "eps", "snr")],
    ("los", "mrt", 8, "cnc", "rapp", "perfect"),
    ("two_path", "mrt", 8, "mcnc", "toi", "eps"),
    ("rayleigh", "phase", 8, "none", "none", "snr"),
]
CSI = {"perfect": {}, "eps": {"csi_epsilon": 0.1}, "snr": {"csi_snr_db": 15.0}}


def _complex_cfg(chan, prec, n_ant, alg, pa_model, csi):
    pa_cfg = jax_config.PaConfig(model=pa_model, ibo_db=20.0 if pa_model == "toi" else 0.0,
                                 alpha_estimate=0.9 if pa_model == "toi" else 1.0)
    return jax_config.LinkConfig(
        modem=jax_config.ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128),
        array=jax_config.ArrayConfig(n_elements=n_ant),
        channel=jax_config.ChannelConfig(model=chan), precoding=prec, pa=pa_cfg,
        rx=jax_config.RxConfig(algorithm=alg), channel_storage="complex64",
        mxu_fft_storage="float32", **CSI[csi])


def _jax_complex(jcfg, keys, eager):
    """JAX's complex64 frames in float32 semantics, compiled or op by op
    (see tests/test_torch_channels.py::_jax_frames)."""
    with jax.enable_x64(False):
        tx_pos = jax_link_static(jcfg)[0]
        run = jax.vmap(jax_link.make_frame_fn(jcfg, N_ITERS), in_axes=(0, None, None))
        if eager:
            with jax.disable_jit():
                c = run(keys, np.float32(20.0), tx_pos)
        else:
            c = jax.jit(run)(keys, np.float32(20.0), tx_pos)
        return np.asarray(c.clean_err), np.asarray(c.dist_err)


@pytest.mark.parametrize("case", COMPLEX_CASES, ids=lambda c: "-".join(map(str, c)))
def test_complex_branch_counters_equal_jax(case):
    """The complex64 branch at f32 chain storage on JAX's draws (fade, RX
    offsets, CSI noise): per-frame counters EQUAL those of JAX's frame run
    op by op, which runs the same operations in the same order. The
    compiled JAX frame rounds the LOS phases differently (XLA folds their
    constant factors, tests/test_torch_channels.py::_jax_frames) and moves
    a few decisions, so against it the per-counter totals agree within the
    5% rule of tests/test_mxu_fft.py:107-130."""
    jcfg = _complex_cfg(*case)
    keys = jax.random.split(jax.random.key(21), 6)
    frame = link.make_frame_fn(_port_cfg(jcfg), N_ITERS, device="cpu")
    pc = frame(np.float32(20.0), _jax_draws(jcfg, keys))
    pcc, pdd = pc.clean_err.numpy(), pc.dist_err.numpy()
    ec, ed = _jax_complex(jcfg, keys, eager=True)
    np.testing.assert_array_equal(pcc, ec)
    np.testing.assert_array_equal(pdd, ed)
    jc, jd = _jax_complex(jcfg, keys, eager=False)
    a = np.concatenate([[jc.sum()], jd.sum(0)]).astype(float)
    b = np.concatenate([[pcc.sum()], pdd.sum(0)]).astype(float)
    assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, 100)), (a, b)
