"""The port's multi-user link (mimo_ofdm_tpu_torch/models/link_mu.py and the
multi-user precoders, AGC, transmit and replicas) held against the JAX
package's on the CPU, on the JAX package's own draws.

The draws are taken where JAX's multi-user frame takes them: the frame key
splits into ``4 + n_usr`` keys (``models/link_mu.py:102-103``); user ``u``'s
channel key splits into RX-offset and fade keys (``models/link.py:75``);
the bits are ``bernoulli`` of shape ``[n_usr, n_bits]`` (``:118,137``;
``[n_sc * bps]`` in the separate-subcarrier frame, ``:242,262``), and user
``u``'s noise is drawn from ``fold_in(k_noise, u)`` (``:127,150``).
JAX runs in float32 and, where it is held equal, op by op
(tests/test_torch_channels.py::_jax_frames).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import link as jlink
from mimo_ofdm_tpu.models import link_mu as jmu
from mimo_ofdm_tpu.models import precoding as jprec
from mimo_ofdm_tpu.utils import config as jconfig

from mimo_ofdm_tpu_torch.models import link, link_mu, precoding
from mimo_ofdm_tpu_torch.utils import config as pconfig

import torch_parity_draws as pdraws

N_FRAMES = 6
N_ITERS = 2
SNR_DB = 20.0


def _jax_cfg(prec="mrt", alg="cnc", storage="float32", model="los", n_ant=8):
    return jconfig.LinkConfig(
        modem=jconfig.ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128, cp_len=16,
                                  n_users=2),
        array=jconfig.ArrayConfig(n_elements=n_ant),
        channel=jconfig.ChannelConfig(model=model), precoding=prec,
        pa=jconfig.PaConfig(model="softlim", ibo_db=0.0),
        rx=jconfig.RxConfig(algorithm=alg), mxu_fft_storage=storage)


def _port_cfg(jcfg):
    return pconfig.config_from_dict(dataclasses.asdict(jcfg))


def _jax_mu_draws(jcfg, keys, n_usr, sep=False):
    """JAX's multi-user frame randoms for each key, as MuFrameDraws."""
    n_sc = jcfg.modem.n_sub_carr
    n_bits = n_sc * jcfg.modem.bits_per_symbol
    bit_shape = (n_bits,) if sep else (n_usr, n_bits)
    half = jcfg.rx.loc_var / 2.0
    rerolled = jcfg.channel.model in link.RX_REROLL_CHANNELS
    users = [([], [], []) for _ in range(n_usr)]
    cols = [[] for _ in range(4)]
    with jax.enable_x64(False):
        for key in keys:
            ks = jax.random.split(key, 4 + n_usr)
            for u in range(n_usr):
                k_loc, k_fade = jax.random.split(ks[4 + u])
                fade = (jax.random.normal(k_fade, (2, jcfg.array.n_elements, n_sc), jnp.float32)
                        if jcfg.channel.model == "rayleigh" else None)
                loc = jax.random.uniform(k_loc, (2,), minval=-half, maxval=half)
                users[u][0].append(None if fade is None else np.asarray(fade))
                users[u][1].append(np.asarray(loc))
                users[u][2].append(pdraws.chan_draws(jcfg, k_fade))
            for col, k in zip(cols[:2], ks[:2]):
                col.append(np.asarray(jax.random.bernoulli(k, 0.5, bit_shape).astype(jnp.int8)))
            for col, k in zip(cols[2:], ks[2:4]):
                col.append(np.stack([np.asarray(jax.random.normal(
                    jax.random.fold_in(k, u), (2, n_sc), jnp.float32)) for u in range(n_usr)]))
    return link_mu.MuFrameDraws.from_numpy(
        [(None if f[0] is None else np.stack(f), np.stack(loc) if rerolled else None,
          pdraws.stack_chan(c)) for f, loc, c in users],
        *(np.stack(c) for c in cols))


def _jax_mu_frames(jcfg, keys, pos, sep=False, eager=True):
    builder = jmu.make_mu_sep_frame_fn if sep else jmu.make_mu_frame_fn
    with jax.enable_x64(False):
        tx_pos = jlink.link_static(jcfg)[0]
        run = jax.vmap(builder(jcfg, N_ITERS, pos), in_axes=(0, None, None))
        if eager:
            with jax.disable_jit():
                c = run(keys, np.float32(SNR_DB), tx_pos)
        else:
            c = jax.jit(run)(keys, np.float32(SNR_DB), tx_pos)
    return np.asarray(c.clean_err), np.asarray(c.dist_err)


def _run_both(prec, alg, storage="float32", sep=False, seed=9, eager=True, pos=None):
    jcfg = _jax_cfg(prec, alg, storage)
    pos = jmu.default_user_positions() if pos is None else pos
    keys = jax.random.split(jax.random.key(seed), N_FRAMES)
    jc, jd = _jax_mu_frames(jcfg, keys, pos, sep, eager)
    builder = link_mu.make_mu_sep_frame_fn if sep else link_mu.make_mu_frame_fn
    frame = builder(_port_cfg(jcfg), N_ITERS, pos, device="cpu")
    pc = frame(np.float32(SNR_DB), _jax_mu_draws(jcfg, keys, len(pos), sep))
    return (jc, jd), (pc.clean_err.numpy(), pc.dist_err.numpy())


def _totals(counters):
    c, d = counters
    return np.concatenate([c.sum(0)[:, None], d.sum(0)], axis=1).astype(float)


def _assert_totals_close(jax_counters, port_counters, around=None, allowances=1):
    """Per-user, per-counter totals within 5% (floor 100 errors), the rule
    of tests/test_mxu_fft.py:107-130; with ``around``, within
    ``allowances`` times 5% of ``around``'s totals (two results each held
    to the rule around one reference are within the sum of their two
    allowances of each other)."""
    a, b = _totals(jax_counters), _totals(port_counters)
    ref = a if around is None else _totals(around)
    assert np.all(np.abs(a - b) <= allowances * 0.05 * np.maximum(ref, 100)), (a, b, ref)


@pytest.mark.parametrize("prec,alg,sep", [("mrt", "cnc", False), ("phase", "cnc", False),
                                          ("mrt", "cnc_mu", False), ("mrt", "mcnc_mu", False),
                                          ("mrt", "cnc", True)])
def test_mu_counters_equal_jax(prec, alg, sep):
    """LOS, RX rerolled, f32 chain: per-frame, per-user counters EQUAL those
    of JAX's multi-user frame run op by op."""
    (jc, jd), (pc, pd) = _run_both(prec, alg, sep=sep)
    assert pc.shape == (N_FRAMES, 2) and pd.shape == (N_FRAMES, 2, N_ITERS + 1)
    assert pd.dtype == np.int32
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pd, jd)
    assert pd[:, :, 0].sum() > 0


def test_zf_precoder_matches_jax():
    """ZF V within relative 1e-4 of JAX's pinv-based precoder: the closed
    form for two users, torch.linalg.pinv for three; and on a batch."""
    rng = np.random.default_rng(3)
    for n_usr in (2, 3):
        h = (rng.standard_normal((4, n_usr, 8, 64))
             + 1j * rng.standard_normal((4, n_usr, 8, 64))).astype(np.complex64)
        with jax.enable_x64(False):
            ref = np.stack([np.asarray(jprec.zf_precoder(hb)) for hb in h])
        got = precoding.zf_precoder(torch.from_numpy(h)).numpy()
        assert got.shape == ref.shape == (4, 8, n_usr, 64)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4
        # zero forcing: user u sees no other user's stream
        eff = np.einsum("buas,bavs->buvs", h, got)
        off = eff[:, ~np.eye(n_usr, dtype=bool)]
        assert np.abs(off).max() < 1e-4 * np.abs(eff).max()


@pytest.mark.parametrize("second", ["same", "scaled", "near", "zero"])
def test_zf_precoder_rank_deficient_matches_jax(second):
    """A (near-)singular Gram matrix, as two users at one position give:
    the closed-form 2 x 2 pseudo-inverse keeps pinv's cutoff, so V is
    finite and within relative 1e-4 of JAX's pinv-based precoder. The
    second user's channel is the first's, a scaled and rotated copy, the
    copy plus 1e-4 noise, or zero."""
    rng = np.random.default_rng(4)
    h0 = (rng.standard_normal((4, 1, 8, 64))
          + 1j * rng.standard_normal((4, 1, 8, 64))).astype(np.complex64)
    h1 = {"same": h0, "scaled": 0.3 * np.exp(0.7j) * h0,
          "near": h0 + 1e-4 * rng.standard_normal(h0.shape),
          "zero": np.zeros_like(h0)}[second]
    h = np.concatenate([h0, h1.astype(np.complex64)], axis=1)
    with jax.enable_x64(False):
        ref = np.stack([np.asarray(jprec.zf_precoder(hb)) for hb in h])
    got = precoding.zf_precoder(torch.from_numpy(h)).numpy()
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4


def test_zf_counters_equal_jax():
    """ZF with the closed-form 2 x 2 inverse: the per-user counters are
    EQUAL to JAX's op-by-op frame (the pinv round-off flips no decision at
    this size and SNR)."""
    (jc, jd), (pc, pd) = _run_both("zf", "cnc")
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pd, jd)


@pytest.mark.parametrize("alg", ["cnc", "mcnc_mu"])
def test_mu_bf16_totals_within_mc_noise(alg):
    """bf16 chain storage, held as JAX holds its own bf16 chain
    (tests/test_mxu_fft.py:107-130): per-user totals within 5% of the
    float32 chain's, here JAX's compiled float32 frame on the same keys
    (which the port's float32 frame equals). Both packages run the bf16
    contract of rounding each pass's operand, at different places (the
    port on the product operands only, JAX also its sums and twiddles), so
    each lies within the rule of the float32 frame, and the port's bf16
    frame lies within the two allowances around it of JAX's bf16 frame (on
    MCNC-MU's last iteration they lie on either side of it, user 2: JAX
    280, port 299, float32 290)."""
    jax_bf16, port_c = _run_both("mrt", alg, "bfloat16", seed=10, eager=False)
    keys = jax.random.split(jax.random.key(10), N_FRAMES)
    f32 = _jax_mu_frames(_jax_cfg("mrt", alg, "float32"), keys, jmu.default_user_positions(),
                         eager=False)
    _assert_totals_close(f32, port_c)
    _assert_totals_close(jax_bf16, port_c, around=f32, allowances=2)


def test_mu_precoders_and_bookkeeping_match_jax():
    """MU MRT / phase / separate-carrier V, and the multi-user forms of the
    per-antenna power, the mean precoding gain and the AGC state of each
    user, against JAX's on one frame (relative 1e-6)."""
    from mimo_ofdm_tpu.models import agc as jagc
    from mimo_ofdm_tpu_torch.models import agc
    rng = np.random.default_rng(5)
    h = (rng.standard_normal((2, 8, 64)) + 1j * rng.standard_normal((2, 8, 64))).astype(np.complex64)
    th = torch.from_numpy(h)

    def close(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.linalg.norm(a - b) <= 1e-6 * np.linalg.norm(b)

    with jax.enable_x64(False):
        close(precoding.mu_mrt_precoder(th), jprec.mu_mrt_precoder(h))
        close(precoding.mu_phase_precoder(th), jprec.mu_phase_precoder(h))
        close(precoding.mu_sep_carrier_precoder(th), jprec.mu_sep_carrier_precoder(h))
        close(precoding.mu_sep_carrier_precoder(th, False),
              jprec.mu_sep_carrier_precoder(h, False))
        v = np.asarray(jprec.mu_mrt_precoder(h))
        tv = torch.from_numpy(v)
        close(precoding.precoding_power_per_antenna(tv, multi_user=True),
              jprec.precoding_power_per_antenna(v))
        close(precoding.avg_precoding_gain(tv, multi_user=True), jprec.avg_precoding_gain(v))
        every = agc.compute_agc_sc(th, tv, 0.0, 8, usr_idx=slice(None))
        for u in range(2):
            ref = jagc.compute_agc_sc(h[u], v, 0.0, 8, usr_idx=u)
            one = agc.compute_agc_sc(th[u], tv, 0.0, 8, usr_idx=u)
            for name in ("hk_vk_agc_sc", "hk_vk_noise_scaler", "ak_hk_vk_agc_sc",
                         "ak_hk_vk_noise_scaler", "ak_vect"):
                close(getattr(one, name), getattr(ref, name))
                close(getattr(every, name)[u] if name != "ak_vect" else every.ak_vect,
                      getattr(ref, name))


def test_mu_replicas_match_jax():
    """The CNC-MU and MCNC-MU replicas on the same detected symbols: each
    user's slice of the port's all-users replica against JAX's two-user
    replica of that user, at relative 1e-5 (torch.fft chain on both sides,
    n_fft 256)."""
    from mimo_ofdm_tpu.models import receivers as jrec
    from mimo_ofdm_tpu_torch.models import receivers
    rng = np.random.default_rng(11)

    def cplx(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    det, tx_sym, h = cplx(2, 128), cplx(2, 128), cplx(2, 8, 128)
    agc_vec = cplx(2, 128) + 4.0
    with jax.enable_x64(False):
        v = np.asarray(jprec.mu_mrt_precoder(h))
        kw = dict(constel_size=64, n_fft=256, n_sc=128)
        ref_cnc = [np.asarray(jrec.make_cnc_mu_replica(tx_sym[1 - u], ibo_db=0.0, **kw)(det[u]))
                   for u in range(2)]
        ref_mcnc = [np.asarray(jrec.make_mcnc_mu_replica(
            tx_sym[1 - u], u, h[u], v, agc_vec[u], sat_power=0.02, **kw)(det[u]))
            for u in range(2)]
    t = torch.from_numpy
    got_cnc = receivers.make_cnc_mu_replica(t(tx_sym[::-1].copy()), ibo_db=0.0, **kw)(t(det))
    every = receivers.make_mcnc_mu_replica(t(tx_sym), t(h), t(v), t(agc_vec),
                                           sat_power=0.02, **kw)(t(det))
    assert every.shape == (2, 128)
    for u in range(2):
        np.testing.assert_allclose(got_cnc[u].numpy(), ref_cnc[u], rtol=0,
                                   atol=1e-5 * np.abs(ref_cnc[u]).max())
        np.testing.assert_allclose(every[u].numpy(), ref_mcnc[u], rtol=0,
                                   atol=1e-5 * np.abs(ref_mcnc[u]).max())


@pytest.mark.parametrize("model", ["rayleigh", "tdl_3gpp"])
def test_mu_other_channels_match_jax(model):
    """The multi-user frame on a fading channel (Rayleigh at each user's
    own position) and on TDL: per-user totals within 5% of JAX's compiled
    frame on the same draws."""
    jcfg = _jax_cfg(model=model)
    pos = jmu.default_user_positions()
    keys = jax.random.split(jax.random.key(12), N_FRAMES)
    jax_c = _jax_mu_frames(jcfg, keys, pos, eager=False)
    frame = link_mu.make_mu_frame_fn(_port_cfg(jcfg), N_ITERS, pos, device="cpu")
    pc = frame(np.float32(SNR_DB), _jax_mu_draws(jcfg, keys, 2))
    _assert_totals_close(jax_c, (pc.clean_err.numpy(), pc.dist_err.numpy()))


def test_round_fn_many_users_and_errors():
    """make_mu_round_fn: [n_usr, n_iters + 2] int32 counters, each user's
    frame counters summed over the batch drawn from round_seed(key, idx);
    plain CNC serves 4 users under ZF; the two-user receivers refuse other
    user counts; no card and no device="cpu" raises."""
    cfg = _port_cfg(_jax_cfg("zf"))
    pos = link_mu.spread_user_positions(4, distance=150.0)
    rf = link_mu.make_mu_round_fn(cfg, 1, 4, pos, device="cpu")
    a, b = rf(0, 2, 18.0), rf(0, 2, 18.0)
    assert a.dtype == torch.int32 and a.shape == (4, 3) and torch.equal(a, b)
    assert not torch.equal(a, rf(0, 3, 18.0))
    gen = torch.Generator().manual_seed(link.round_seed(0, 2))
    c = link_mu.make_mu_frame_fn(cfg, 1, pos, device="cpu")(18.0, batch=4, generator=gen)
    assert torch.equal(c.clean_err.sum(0), a[:, 0]) and torch.equal(c.dist_err.sum(0), a[:, 1:])
    with pytest.raises(ValueError, match="2-user"):
        link_mu.make_mu_frame_fn(_port_cfg(_jax_cfg(alg="mcnc_mu")), 1, pos, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            link_mu.make_mu_round_fn(cfg, 1, 2)


def test_default_positions_match_jax():
    np.testing.assert_allclose(link_mu.default_user_positions(), jmu.default_user_positions())
    np.testing.assert_allclose(link_mu.spread_user_positions(5, 120.0),
                               jmu.spread_user_positions(5, 120.0))
