"""The port's stochastic channels held against the JAX package on the CPU,
on the JAX package's own draws (tests/torch_parity_draws.py): the Rician,
random-paths and TR 38.901 TDL channel matrices and the CSI error model,
the GSCM taps and matrix of both scenarios, and the complex64 frames on
these channels.

JAX runs in float32 (``jax.enable_x64(False)``); the frames that JAX is
held equal to run op by op (``jax.disable_jit()``), the source order the
port follows (see tests/test_torch_channels.py::_jax_frames).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import channels as jchannels
from mimo_ofdm_tpu.models import gscm as jgscm
from mimo_ofdm_tpu.models import link as jlink
from mimo_ofdm_tpu.ops import bits as jbits
from mimo_ofdm_tpu.ops import ofdm as jofdm
from mimo_ofdm_tpu.utils import config as jconfig

from mimo_ofdm_tpu_torch.models import channels, gscm, link
from mimo_ofdm_tpu_torch.utils import config as pconfig

import torch_parity_draws as pdraws

N_FRAMES = 4
N_ITERS = 2
SNR_DB = 20.0
RX = np.array([[212.0, 212.0, 1.5], [214.5, 209.0, 1.5], [100.0, 180.0, 1.5]], np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _jax_cfg(channel, alg="cnc", n_fft=256, n_sc=128):
    return jconfig.LinkConfig(
        modem=jconfig.ModemConfig(constel_size=64, n_fft=n_fft, n_sub_carr=n_sc),
        array=jconfig.ArrayConfig(n_elements=8), channel=channel,
        rx=jconfig.RxConfig(algorithm=alg), channel_storage="complex64",
        mxu_fft_storage="float32")


def _port_cfg(jcfg):
    return pconfig.config_from_dict(dataclasses.asdict(jcfg))


def _static(jcfg):
    """tx_pos and the data-bin grid, float32, as the frames use them."""
    with jax.enable_x64(False):
        tx_pos, freqs, _ = jlink.link_static(jcfg)
        freqs_sc = jofdm.extract_subcarriers(freqs, jcfg.modem.n_sub_carr)
    return np.array(tx_pos), np.array(freqs_sc)


def _matrices(jcfg, jax_fn, port_fn, seed=3):
    """JAX's matrix per RX position (one fade key each) against the port's
    batch on the same draws."""
    tx, freqs = _static(jcfg)
    keys = jax.random.split(jax.random.key(seed), len(RX))
    with jax.enable_x64(False):
        ref = np.stack([np.asarray(jax_fn(k, tx, r, freqs)) for k, r in zip(keys, RX)])
        draws = pdraws.stack_chan([pdraws.chan_draws(jcfg, k) for k in keys])
    got = port_fn(link.chan_from_numpy(draws, "cpu"), torch.from_numpy(tx), torch.from_numpy(RX),
                  torch.from_numpy(freqs))
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    return got.numpy(), ref


TDL_VARIANTS = {
    "default": {},
    "one_subpath_k": dict(tdl_subpaths=1, tdl_k_db=9.0, tdl_k_std_db=3.5),
    "nlos_tdl_a": dict(tdl_profile="umi_nlos"),
    "tdl_e_no_att": dict(tdl_profile="tdl_e", skip_attenuation=True),
    "random_delay_spread": dict(tdl_ds_log10_std=0.66),
}


def _tdl_kw(ch):
    return dict(profile=ch.tdl_profile, skip_attenuation=ch.skip_attenuation,
                n_subpaths=ch.tdl_subpaths, asd_deg=ch.tdl_asd_deg, k_db=ch.tdl_k_db,
                k_std_db=ch.tdl_k_std_db, ds_log10_std=ch.tdl_ds_log10_std)


@pytest.mark.parametrize("name", ["rician", "rician_no_att", "random_paths",
                                  *[f"tdl_{v}" for v in TDL_VARIANTS]])
def test_channel_matrix_matches_jax(name):
    """Rician, random paths and TDL at relative L2 1e-5 (measured 6e-8, 2e-8
    and 4e-7 on the defaults): the same draws, every phase formed in the
    same float32 order."""
    if name.startswith("rician"):
        ch = jconfig.ChannelConfig(model="rician", rician_k_db=6.0,
                                   skip_attenuation=name.endswith("no_att"))
        got, ref = _matrices(
            _jax_cfg(ch),
            lambda k, tx, r, f: jchannels.rician_channel(k, tx, r, f, 6.0, ch.skip_attenuation),
            lambda d, tx, r, f: channels.rician_channel(d, tx, r, f, 6.0, ch.skip_attenuation))
    elif name == "random_paths":
        ch = jconfig.ChannelConfig(model="random_paths")
        got, ref = _matrices(
            _jax_cfg(ch), lambda k, tx, r, f: jchannels.random_paths_channel(
                k, tx, f, ch.n_paths, ch.max_delay_spread),
            lambda d, tx, r, f: channels.random_paths_channel(d, tx, f))
    else:
        ch = jconfig.ChannelConfig(model="tdl_3gpp", **TDL_VARIANTS[name[4:]])
        got, ref = _matrices(
            _jax_cfg(ch), lambda k, tx, r, f: jchannels.tdl_channel(k, tx, r, f, **_tdl_kw(ch)),
            lambda d, tx, r, f: channels.tdl_channel(d, tx, r, f, **_tdl_kw(ch)))
    assert _rel(got, ref) < 1e-5, _rel(got, ref)


def test_csi_error_channel_matches_jax():
    rng = np.random.default_rng(1)
    h = (rng.standard_normal((8, 256)) + 1j * rng.standard_normal((8, 256))).astype(np.complex64)
    key = jax.random.key(4)
    with jax.enable_x64(False):
        ref = np.asarray(jchannels.csi_error_channel(key, h, 128, 0.2))
        normals = np.asarray(jax.random.normal(key, (2, 8, 128), jnp.float32))
    got = channels.csi_error_channel(torch.from_numpy(normals), torch.from_numpy(h), 128, 0.2)
    assert _rel(got.numpy(), ref) < 1e-5
    np.testing.assert_array_equal(got.numpy()[:, 65:192], h[:, 65:192])   # guard + DC kept


@pytest.mark.parametrize("scenario", ["uma_los", "uma_nlos"])
def test_gscm_taps_and_matrix_match_jax(scenario):
    """The taps at relative 1e-5 given the same ``fc`` (measured 8e-8 /
    8e-7); the frequency response at relative L2 5e-3 (measured 1.6e-3
    uma_los, 7.2e-4 uma_nlos): ``fc = mean(freqs)`` differs by an ulp
    between XLA's and torch's reductions, which moves the ~2e4 rad phase
    of the specular ray by ~1e-3 rad."""
    jcfg = _jax_cfg(jconfig.ChannelConfig(model="gscm", gscm_scenario=scenario))
    tx, freqs = _static(jcfg)
    fc = np.float32(freqs.mean())
    keys = jax.random.split(jax.random.key(8), len(RX))
    with jax.enable_x64(False):
        taps = [jgscm.gscm_taps(k, tx, r, jnp.float32(fc), scenario=scenario)
                for k, r in zip(keys, RX)]
        ref_h = np.stack([np.asarray(jgscm.gscm_channel(k, tx, r, freqs, scenario=scenario))
                          for k, r in zip(keys, RX)])
        draws = link.chan_from_numpy(pdraws.stack_chan([pdraws.gscm_draws(scenario, k)
                                                        for k in keys]), "cpu")
    tv, tt = gscm.gscm_taps(draws, torch.from_numpy(tx), torch.from_numpy(RX),
                            torch.tensor(fc), scenario=scenario)
    ref_v = np.stack([np.asarray(t[0]) for t in taps])
    ref_t = np.stack([np.asarray(t[1]) for t in taps])
    assert tv.shape == ref_v.shape and tt.shape == ref_t.shape
    assert _rel(tv.numpy(), ref_v) < 1e-5, _rel(tv.numpy(), ref_v)
    assert _rel(tt.numpy(), ref_t) < 1e-5, _rel(tt.numpy(), ref_t)
    h = gscm.gscm_channel(draws, torch.from_numpy(tx), torch.from_numpy(RX),
                          torch.from_numpy(freqs), scenario=scenario)
    assert _rel(h.numpy(), ref_h) < 5e-3, _rel(h.numpy(), ref_h)


# --- the complex64 frames on the stochastic channels, on JAX's draws -------

FRAME_CHANNELS = {
    "rician": jconfig.ChannelConfig(model="rician"),
    "random_paths": jconfig.ChannelConfig(model="random_paths"),
    "tdl_3gpp": jconfig.ChannelConfig(model="tdl_3gpp"),
    "gscm_uma_los": jconfig.ChannelConfig(model="gscm"),
    "gscm_uma_nlos": jconfig.ChannelConfig(model="gscm", gscm_scenario="uma_nlos"),
}


def _jax_frame_draws(jcfg, keys):
    """The randoms JAX's complex64 frame draws for each key
    (``models/link.py:184-185,75``), as FrameDraws."""
    n_bits, n_sc = jcfg.modem.n_bits_per_ofdm_sym, jcfg.modem.n_sub_carr
    half = jcfg.rx.loc_var / 2.0
    cols = [[] for _ in range(6)]
    with jax.enable_x64(False):
        for key in keys:
            k_chan, _, k_bits_c, k_bits_d, k_noise_c, k_noise_d = jax.random.split(key, 6)
            k_loc, k_fade = jax.random.split(k_chan)
            for col, a in zip(cols, (
                    jbits.random_payload_bits(k_bits_c, n_bits),
                    jbits.random_payload_bits(k_bits_d, n_bits),
                    jax.random.normal(k_noise_c, (2, n_sc), jnp.float32),
                    jax.random.normal(k_noise_d, (2, n_sc), jnp.float32),
                    jax.random.uniform(k_loc, (2,), minval=-half, maxval=half))):
                col.append(np.asarray(a))
            cols[5].append(pdraws.chan_draws(jcfg, k_fade))
    bc, bd, nc, nd, loc = (np.stack(c) for c in cols[:5])
    loc = loc if jcfg.channel.model in link.RX_REROLL_CHANNELS else None
    return link.FrameDraws.from_numpy(None, bc, bd, nc, nd, loc=loc,
                                      chan=pdraws.stack_chan(cols[5]))


def _jax_frames(jcfg, keys, eager):
    with jax.enable_x64(False):
        tx_pos = jlink.link_static(jcfg)[0]
        run = jax.vmap(jlink.make_frame_fn(jcfg, N_ITERS), in_axes=(0, None, None))
        if eager:
            with jax.disable_jit():
                c = run(keys, np.float32(SNR_DB), tx_pos)
        else:
            c = jax.jit(run)(keys, np.float32(SNR_DB), tx_pos)
        return np.asarray(c.clean_err), np.asarray(c.dist_err)


@pytest.mark.parametrize("name,alg", [("rician", "cnc"), ("random_paths", "mcnc"),
                                      ("tdl_3gpp", "cnc"), ("tdl_3gpp", "mcnc"),
                                      ("gscm_uma_los", "cnc"), ("gscm_uma_nlos", "mcnc")])
def test_frame_counters_match_jax(name, alg):
    """f32 chain storage on JAX's draws. Rician, random paths and TDL: the
    per-frame counters EQUAL JAX's frame run op by op. GSCM: its matrix
    agrees to ~1e-3 only (test_gscm_taps_and_matrix_match_jax), so the
    per-counter totals agree with JAX's compiled frame within the 5% rule
    of tests/test_mxu_fft.py:107-130."""
    jcfg = _jax_cfg(FRAME_CHANNELS[name], alg)
    keys = jax.random.split(jax.random.key(17), N_FRAMES)
    frame = link.make_frame_fn(_port_cfg(jcfg), N_ITERS, device="cpu")
    pc = frame(np.float32(SNR_DB), _jax_frame_draws(jcfg, keys))
    pcc, pdd = pc.clean_err.numpy(), pc.dist_err.numpy()
    assert pdd.shape == (N_FRAMES, N_ITERS + 1)
    if name.startswith("gscm"):
        jc, jd = _jax_frames(jcfg, keys, eager=False)
        a = np.concatenate([[jc.sum()], jd.sum(0)]).astype(float)
        b = np.concatenate([[pcc.sum()], pdd.sum(0)]).astype(float)
        assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, 100)), (a, b)
    else:
        ec, ed = _jax_frames(jcfg, keys, eager=True)
        np.testing.assert_array_equal(pcc, ec)
        np.testing.assert_array_equal(pdd, ed)
    assert pdd[:, 0].sum() > 0


def test_draws_cover_what_the_config_uses():
    """FrameDraws.draw draws the channel's own randoms, and RX offsets only
    for the channels whose RX is rerolled."""
    base = _port_cfg(_jax_cfg(jconfig.ChannelConfig()))
    gen = torch.Generator().manual_seed(0)
    shapes = {}
    for model in ("rician", "random_paths", "tdl_3gpp", "gscm", "rayleigh", "los"):
        d = link.FrameDraws.draw(base.replace(channel=pconfig.ChannelConfig(model=model)),
                                 3, gen)
        shapes[model] = (d.loc is not None, type(d.chan).__name__, d.fade is not None)
    assert shapes == {"rician": (True, "Tensor", False),
                      "random_paths": (False, "RandomPathsDraws", False),
                      "tdl_3gpp": (True, "TdlDraws", False),
                      "gscm": (True, "GscmDraws", False),
                      "rayleigh": (False, "NoneType", True),
                      "los": (True, "NoneType", False)}
    d = link.FrameDraws.draw(base.replace(channel=pconfig.ChannelConfig(model="gscm")), 3, gen)
    assert d.chan.lsp.shape == (3, 4) and d.chan.perm_u.shape == (3, 12, 20)
    assert float(d.chan.delay_u.min()) >= 1e-6 and set(d.chan.xa.unique().tolist()) <= {-1.0, 1.0}
