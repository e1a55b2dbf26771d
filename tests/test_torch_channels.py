"""The port's geometric channels held against the JAX package on the CPU:
the factored LOS phase planes, the LOS / two-path / Rayleigh channel
matrices, the circular and planar arrays, and the planar LOS and two-path
frames (CNC and MCNC, RX reroll on and off, per-call IBO) on the JAX
package's own random draws.

The draws are taken where the JAX frame takes them: each frame key splits
six ways (``models/link_planar.py:236-237``), the channel key into the RX
offset and fade keys (``:155``), the offsets are ``uniform(k_loc, (2,))``
(``:136-137``), then the payload bits (``ops/bits.py:36``) and the noise
normals (``ops/noise.py:21``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import channels as jchannels
from mimo_ofdm_tpu.models import geometry as jgeometry
from mimo_ofdm_tpu.models import link as jlink
from mimo_ofdm_tpu.models import link_planar as jplanar
from mimo_ofdm_tpu.ops import bits as jbits
from mimo_ofdm_tpu.utils import config as jconfig

from mimo_ofdm_tpu_torch.models import channels, geometry, link, link_planar
from mimo_ofdm_tpu_torch.utils import config as pconfig

N_FRAMES = 8
N_ITERS = 2
SNR_DB = 20.0


def _jax_cfg(model="los", alg="cnc", storage="float32", **kw):
    return jconfig.LinkConfig(
        modem=jconfig.ModemConfig(constel_size=64, n_fft=1024, n_sub_carr=512),
        array=jconfig.ArrayConfig(n_elements=8),
        channel=jconfig.ChannelConfig(model=model),
        rx=jconfig.RxConfig(algorithm=alg),
        channel_storage=storage, mxu_fft_storage=storage, **kw)


def _port_cfg(jcfg):
    return pconfig.config_from_dict(dataclasses.asdict(jcfg))


def _jax_draws(jcfg, keys, reroll):
    """The JAX frame's randoms for each key, as FrameDraws (geometric
    channels: no fade)."""
    n_bits = jcfg.modem.n_bits_per_ofdm_sym
    n_sc = jcfg.modem.n_sub_carr
    half = jcfg.rx.loc_var / 2.0

    def one(key):
        k_chan, _, k_bits_c, k_bits_d, k_noise_c, k_noise_d = jax.random.split(key, 6)
        k_loc, _ = jax.random.split(k_chan)
        return (jbits.random_payload_bits(k_bits_c, n_bits),
                jbits.random_payload_bits(k_bits_d, n_bits),
                jax.random.normal(k_noise_c, (2, n_sc), jnp.float32),
                jax.random.normal(k_noise_d, (2, n_sc), jnp.float32),
                jax.random.uniform(k_loc, (2,), minval=-half, maxval=half))

    with jax.enable_x64(False):        # the offsets in float32, as the frame draws them
        bc, bd, nc, nd, loc = [np.asarray(a) for a in jax.jit(jax.vmap(one))(keys)]
    return link.FrameDraws.from_numpy(None, bc, bd, nc, nd,
                                      loc=loc if reroll else None)


def _jax_frames(jcfg, keys, *, reroll=True, ibo=None, eager=False):
    """JAX's frames in float32 semantics (the suite's x64 mode would turn
    the rerolled RX position, and so every LOS phase, into float64).
    ``eager`` runs JAX's operations one by one in their source order;
    compiled, XLA folds the constant factors of the phase products
    ``(2 pi / c) d (fc + df k)`` into one constant, which moves a phase
    near 2e4 rad by one float32 ulp (~2e-3 rad)."""
    with jax.enable_x64(False):
        tx_pos = jlink.link_static(jcfg)[0]
        f = jlink.make_frame_fn(jcfg, N_ITERS, reroll=reroll,
                                ibo_as_arg=ibo is not None)
        args = (np.float32(SNR_DB), tx_pos) + (() if ibo is None else (np.float32(ibo),))
        run = jax.vmap(f, in_axes=(0,) + (None,) * len(args))
        if eager:
            with jax.disable_jit():
                c = run(keys, *args)
        else:
            c = jax.jit(run)(keys, *args)
        return np.asarray(c.clean_err), np.asarray(c.dist_err)


def _assert_totals_close(jax_counters, port_counters):
    """Per-counter totals within 5% (floor 100 errors), the rule of
    tests/test_mxu_fft.py:107-130."""
    (jc, jd), (pc, pd) = jax_counters, port_counters
    a = np.concatenate([[jc.sum()], jd.sum(0)]).astype(float)
    b = np.concatenate([[pc.sum()], pd.sum(0)]).astype(float)
    assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, 100)), (a, b)


@pytest.mark.parametrize("n_sc", [512, 96])
def test_factored_cos_sin_matches_jax(n_sc):
    """512 takes the factored branch, 96 (not a multiple of 64) the direct
    one; the phases reach ~2e4 rad, as at the canonical RX distance."""
    rng = np.random.default_rng(n_sc)
    d = rng.uniform(290.0, 310.0, 8).astype(np.float32)
    w = np.float32(2.0 * np.pi / jgeometry.C_LIGHT) * d
    jc, js = jplanar._factored_cos_sin(jnp.asarray(w), 3.5e9, 15e3, n_sc)
    pc, ps = link_planar._factored_cos_sin(torch.from_numpy(w), 3.5e9, 15e3, n_sc)
    assert pc.shape == (8, n_sc) and pc.dtype == torch.float32
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5, rtol=0)


def test_array_positions_match_jax():
    for args in (("circular", 16, 3.5e9, 0.5, 15.0),
                 ("planar", 12, 3.5e9, 0.5, 15.0, 3, 4),
                 ("linear", 8, 3.5e9, 0.5, 15.0)):
        np.testing.assert_allclose(geometry.array_positions(*args),
                                   jgeometry.array_positions(*args), atol=1e-9, rtol=0)
    np.testing.assert_allclose(geometry.uca_positions(7, 2e9, cord_z=3.0),
                               jgeometry.uca_positions(7, 2e9, cord_z=3.0), atol=1e-9)
    np.testing.assert_allclose(geometry.ura_positions(2, 5, 2e9, cord_z=3.0),
                               jgeometry.ura_positions(2, 5, 2e9, cord_z=3.0), atol=1e-9)


def test_channel_matrices_match_jax():
    """Complex64 channel matrices on the same float32 geometry; the phase
    at ~2e4 rad carries float32 rounding, hence the absolute tolerance
    relative to the attenuation (~1e-7 at 300 m)."""
    tx = geometry.ula_positions(8, 3.5e9, cord_z=15.0).astype(np.float32)
    rx = np.array([[212.0, 212.0, 1.5], [214.5, 209.0, 1.5]], np.float32)
    freqs = (3.5e9 + 15e3 * np.arange(-64, 64)).astype(np.float32)
    normals = np.random.default_rng(0).standard_normal((2, 2, 8, 128)).astype(np.float32)
    t = torch.from_numpy
    for skip in (False, True):
        for name in ("los_channel", "two_path_channel"):
            got = getattr(channels, name)(t(tx), t(rx), t(freqs), skip)
            ref = np.stack([np.asarray(getattr(jchannels, name)(tx, r, freqs, skip))
                            for r in rx])
            assert got.dtype == torch.complex64 and got.shape == (2, 8, 128)
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got.numpy(), ref, atol=5e-3 * scale, rtol=0)
        # JAX draws the fade from a key inside rayleigh_channel, so the
        # port's (given the normals) is held against JAX's formula
        got = channels.rayleigh_channel(t(normals), t(tx), t(rx[0]), t(freqs), skip)
        att = 1.0 if skip else np.asarray(jchannels._fs_attenuation(
            jchannels._distances(tx, rx[0]), freqs))
        expect = (normals[:, 0] + 1j * normals[:, 1]) * np.sqrt(0.5) * att
        assert got.shape == (2, 8, 128)
        np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=0)


@pytest.mark.parametrize("model", ["los", "two_path"])
@pytest.mark.parametrize("alg", ["cnc", "mcnc"])
@pytest.mark.parametrize("reroll", [True, False])
def test_planar_geometric_counters_equal_jax_float32(model, alg, reroll):
    """f32 planes on JAX's draws: per-frame counters EQUAL those of JAX's
    frame run op by op, the source order the port follows. The compiled
    JAX frame rounds its phases differently (see _jax_frames) and moves a
    few of the ~7% erroneous decisions, so against it the per-counter
    totals agree within the 5% rule of tests/test_mxu_fft.py:107-130."""
    jcfg = _jax_cfg(model, alg)
    keys = jax.random.split(jax.random.key(5), N_FRAMES)
    frame = link.make_frame_fn(_port_cfg(jcfg), N_ITERS, reroll=reroll, device="cpu")
    pc = frame(np.float32(SNR_DB), _jax_draws(jcfg, keys, reroll))
    pcc, pdd = pc.clean_err.numpy(), pc.dist_err.numpy()
    ec, ed = _jax_frames(jcfg, keys, reroll=reroll, eager=True)
    np.testing.assert_array_equal(pcc, ec)
    np.testing.assert_array_equal(pdd, ed)
    assert ed.sum() > 0 and ec.sum() > 0
    jc, jd = _jax_frames(jcfg, keys, reroll=reroll)
    _assert_totals_close((jc, jd), (pcc, pdd))


@pytest.mark.parametrize("model", ["los", "two_path"])
def test_planar_geometric_bf16_within_mc_noise(model):
    """bf16 planes round at different places in the two packages; totals
    agree within the rule of tests/test_mxu_fft.py:107-130."""
    jcfg = _jax_cfg(model, "cnc", "bfloat16")
    keys = jax.random.split(jax.random.key(12), N_FRAMES)
    jc, jd = _jax_frames(jcfg, keys)
    frame = link.make_frame_fn(_port_cfg(jcfg), N_ITERS, device="cpu")
    pc = frame(np.float32(SNR_DB), _jax_draws(jcfg, keys, True))
    _assert_totals_close((jc, jd), (pc.clean_err.numpy(), pc.dist_err.numpy()))


def test_ibo_as_arg_equals_fixed_ibo_and_jax():
    """A frame given IBO x per call equals the frame built at IBO x, and
    JAX's ibo_as_arg frame; a second IBO changes the counters."""
    ibo = 2.0
    jcfg = _jax_cfg("los", "cnc")
    keys = jax.random.split(jax.random.key(13), N_FRAMES)
    draws = _jax_draws(jcfg, keys, True)
    pcfg = _port_cfg(jcfg)
    per_call = link.make_frame_fn(pcfg, N_ITERS, ibo_as_arg=True, device="cpu")
    built = link.make_frame_fn(
        pcfg.replace(pa=dataclasses.replace(pcfg.pa, ibo_db=ibo)), N_ITERS, device="cpu")
    a = per_call(np.float32(SNR_DB), ibo, draws)
    b = built(np.float32(SNR_DB), draws)
    torch.testing.assert_close(a.dist_err, b.dist_err, rtol=0, atol=0)
    torch.testing.assert_close(a.clean_err, b.clean_err, rtol=0, atol=0)
    jc, jd = _jax_frames(jcfg, keys, ibo=ibo, eager=True)
    np.testing.assert_array_equal(a.dist_err.numpy(), jd)
    np.testing.assert_array_equal(a.clean_err.numpy(), jc)
    c = per_call(np.float32(SNR_DB), 0.0, draws)
    assert c.dist_err[:, 0].sum() > a.dist_err[:, 0].sum()


def test_canonical_config_runs_unchanged_on_cpu():
    """canonical_miso_cnc() (LOS, rerolled RX) through make_round_fn, at
    the tests' small shape; the CNC iterations cut the errors at IBO 0."""
    cfg, sweep = pconfig.canonical_miso_cnc()
    assert cfg.channel.model == "los" and sweep.reroll_channel
    small = cfg.replace(modem=pconfig.ModemConfig(n_fft=256, n_sub_carr=128),
                        array=dataclasses.replace(cfg.array, n_elements=8))
    c = link.make_round_fn(small, N_ITERS, 8, device="cpu")(0, 1, 25.0)
    assert c.dtype == torch.int32 and c.shape == (N_ITERS + 2,)
    assert int(c[0]) < int(c[1]) and int(c[-1]) < int(c[1])
