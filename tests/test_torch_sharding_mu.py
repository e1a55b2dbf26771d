"""The multi-user half of the port's scale-out layer on the CPU: the
antenna-sharded multi-user precoders (ZF Gram and power all-reduce,
MU-MRT norm, separate carriers), AGC and MCNC-MU replica, and the sharded
multi-user rounds, on a 2-rank gloo job (tests/torch_dist_worker.py) at
the JAX scale-out tests' multi-user shapes (16-QAM, n_fft 256, 8
antennas, 2 users at f32 chain storage), held against the port's
single-device rounds and JAX's unsharded functions (tolerances as in
tests/test_torch_sharding.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mimo_ofdm_tpu.models import agc as jagc
from mimo_ofdm_tpu.models import precoding as jprec
from mimo_ofdm_tpu.models import receivers as jrx

import torch_dist_worker as W
from mimo_ofdm_tpu_torch.models.link_mu import make_mu_round_fn
from test_torch_sharding import REL_L2, assert_tp_close, rel_l2


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return W.run_job("mu_tp", 2, tmp_path_factory.mktemp("dist_mu"))


def single_mu_rounds(cfg, batch, sep=False):
    rf = make_mu_round_fn(cfg, W.N_ITERS, batch, sep_carriers=sep, device="cpu")
    return np.stack([rf(W.KEY, i, W.SNR_DB).numpy() for i in W.ROUNDS])


@pytest.mark.parametrize("name", list(W.MU_TP_ROUNDS))
def test_mu_tp_rounds_within_tolerance(job, name):
    """tp 2 multi-user rounds (ZF+CNC, MRT+MCNC-MU, separate-carrier CNC;
    LOS users at +-30 deg) against the single-device round: per-user
    counters ``[n_usr, n_iters + 2]`` within JAX's tolerance for non-exact
    sharding, equal on both ranks, and 1 + n_iters + 1 chain calls a round
    on each rank. Gap measured: 0 differing bits in each config (1024 bits
    a user and round, 2 rounds)."""
    cfg, batch, sep = W.MU_TP_ROUNDS[name]
    single = single_mu_rounds(cfg(), batch, sep)
    assert single.shape == (len(W.ROUNDS), 2, W.N_ITERS + 2) and single[:, :, 1].min() > 0
    n_bits = batch * cfg().modem.n_bits_per_ofdm_sym
    if sep:
        n_bits //= 2                   # each user counts its own half of the carriers
    np.testing.assert_array_equal(job[0][name], job[1][name])
    assert_tp_close(job[0][name], single, n_bits)
    for r in job:
        assert int(r[name + "_launches"]) == len(W.ROUNDS) * (1 + W.N_ITERS + 1)


def test_mu_dp_round_equals_single_device(job):
    """dp 2 on MRT+MCNC-MU equals the single-device multi-user round
    exactly, on both ranks."""
    single = single_mu_rounds(W.mu_cfg("mrt", "mcnc_mu"), 8)
    for r in job:
        np.testing.assert_array_equal(r["dp_mrt_mcnc_mu"], single)


def _jax_mu():
    h, sym = W.mu_inputs()
    h3, _ = W.mu_inputs(n_usr=3, seed=13)
    with jax.enable_x64(False):
        hj, symj = jnp.asarray(h), jnp.asarray(sym)
        v = jprec.mu_mrt_precoder(hj)
        v_zf = jprec.zf_precoder(hj)
        sat = jprec.pa_sat_power(0.0, 0.5, v)
        st = [jagc.compute_agc_sc(hj[u], v, 0.0, 8, usr_idx=u) for u in range(2)]
        reps = [jrx.make_mcnc_mu_replica(symj[1 - u], u, hj[u], v, st[u].ak_hk_vk_agc_sc,
                                         constel_size=16, n_fft=256, n_sc=128,
                                         sat_power=sat)(symj[1 - u]) for u in range(2)]
        out = {"zf": v_zf, "zf3": jprec.zf_precoder(jnp.asarray(h3)), "mu_mrt": v,
               "sep_mrt": jprec.mu_sep_carrier_precoder(hj), "mu_sat": sat,
               "zf_gain": jprec.avg_precoding_gain(v_zf),
               "agc_hv": jnp.stack([s.hk_vk_agc_sc for s in st]),
               "agc_ahv": jnp.stack([s.ak_hk_vk_agc_sc for s in st]),
               "agc_ak": st[0].ak_vect, "mcnc_mu_replica": jnp.stack(reps)}
        return {k: np.asarray(a) for k, a in out.items()}


SHARDED_ROWS = ("zf", "zf3", "mu_mrt", "sep_mrt", "agc_ak")


@pytest.mark.parametrize("name", ["zf", "zf3", "mu_mrt", "sep_mrt", "mu_sat", "zf_gain",
                                  "agc_hv", "agc_ahv", "agc_ak", "mcnc_mu_replica"])
def test_mu_sharded_functions_match_jax(job, name):
    """ZF (two users by the closed form, three by ``pinv``), MU-MRT, the
    separate-carrier MRT, the multi-user saturation power and precoding
    gain, every user's AGC and the MCNC-MU replica on 2 antenna shards,
    against JAX's unsharded functions on the full arrays: within 1e-6
    relative L2, the antenna rows concatenated, the replicated outputs
    equal on both ranks. Gap measured: 0 for the saturation power, 6.3e-8
    to 1.9e-7 for the others but one, and 3.8e-7 for three-user ZF (pinv)."""
    want = _jax_mu()[name]
    if name in SHARDED_ROWS:
        got = np.concatenate([r[name] for r in job], axis=0)
    else:
        np.testing.assert_array_equal(job[0][name], job[1][name])
        got = job[0][name]
    assert got.shape == want.shape
    assert rel_l2(got, want) < REL_L2, rel_l2(got, want)
