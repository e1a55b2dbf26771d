"""The port's scale-out layer (mimo_ofdm_tpu_torch/parallel/{collectives,
sharded,multihost,scaling}.py and the antenna-group arguments of the
single-user models) on the CPU: real 2- and 4-rank gloo jobs
(tests/torch_dist_worker.py) at the JAX scale-out tests' shapes (n_fft
256, 8 antennas), held against the port's single-device rounds and the
JAX package.

* dp-sharded, multi-process and transport rounds sum integers only, so
  they must EQUAL the single-device round of the same ``(key, idx)``.
* An antenna sum split over ranks is not bitwise the single sum (f32
  addition is not associative), so tp rounds are held to the tolerance
  JAX's suite uses for non-exact sharding (``tests/test_sharding.py:
  175-176``: ``rtol=0.05, atol=8/n_bits`` on the BER), and each sharded
  function to JAX's unsharded one on the full arrays within 1e-6 relative
  L2. Each test states the gap measured.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mimo_ofdm_tpu.models import agc as jagc
from mimo_ofdm_tpu.models import channels as jchannels
from mimo_ofdm_tpu.models import precoding as jprec
from mimo_ofdm_tpu.models import receivers as jrx
from mimo_ofdm_tpu.ops import bits as jbits
from mimo_ofdm_tpu.parallel import sharded as jsharded
from mimo_ofdm_tpu.utils import config as jconfig

import torch_dist_worker as W
from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS
from mimo_ofdm_tpu_torch.models import link_ldpc, link_mu
from mimo_ofdm_tpu_torch.models.link import make_round_fn
from mimo_ofdm_tpu_torch.parallel import multihost, sharded

REL_L2 = 1e-6
LOS_JAX_KEY = 4


def jax_cfg(cfg):
    """The JAX package's LinkConfig of a port config (the same fields)."""
    d = dataclasses.asdict(cfg)
    sections = {"modem": jconfig.ModemConfig, "pa": jconfig.PaConfig,
                "array": jconfig.ArrayConfig, "channel": jconfig.ChannelConfig,
                "rx": jconfig.RxConfig}
    return jconfig.LinkConfig(**{k: sections[k](**v) if k in sections else v
                                 for k, v in d.items()})


def single_rounds(cfg, batch):
    rf = make_round_fn(cfg, W.N_ITERS, batch, device="cpu")
    return np.stack([rf(W.KEY, i, W.SNR_DB).numpy() for i in W.ROUNDS])


def rel_l2(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_tp_close(sharded_c, single_c, n_bits):
    """JAX's tolerance for non-exact sharding, on counts: ``|a - b| <= 8 +
    0.05 b`` (``rtol=0.05, atol=8/n_bits`` on the BER)."""
    np.testing.assert_allclose(sharded_c / n_bits, single_c / n_bits, rtol=0.05,
                               atol=8.0 / n_bits)


def los_jax_draws(cfg, batch):
    """The draws of JAX's sharded LOS round for ``key(LOS_JAX_KEY)``, taken
    where its frame takes them (each frame key splits six ways, the channel
    key two ways, ``mimo_ofdm_tpu/models/link.py:66-73,215-216``), in
    float32 semantics."""
    n_sc, n_bits = cfg.modem.n_sub_carr, cfg.modem.n_bits_per_ofdm_sym
    half = cfg.rx.loc_var / 2.0

    def one(key):
        k_chan, _, k_bits_c, k_bits_d, k_noise_c, k_noise_d = jax.random.split(key, 6)
        k_loc, _ = jax.random.split(k_chan)
        return {"bits_c": jbits.random_payload_bits(k_bits_c, n_bits),
                "bits_d": jbits.random_payload_bits(k_bits_d, n_bits),
                "noise_c": jax.random.normal(k_noise_c, (2, n_sc), jnp.float32),
                "noise_d": jax.random.normal(k_noise_d, (2, n_sc), jnp.float32),
                "loc": jax.random.uniform(k_loc, (2,), minval=-half, maxval=half)}

    with jax.enable_x64(False):
        keys = jax.random.split(jax.random.key(LOS_JAX_KEY), batch)
        return {k: np.asarray(v) for k, v in jax.jit(jax.vmap(one))(keys).items()}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The three gloo jobs of this file, run once: dp 2 and tp 2 on two
    ranks, and the four-rank job (which reads JAX's LOS draws)."""
    out = tmp_path_factory.mktemp("dist")
    cfg, _ = W.TP_ROUNDS["los_cnc"]
    np.savez(out / "jax_draws.npz", **los_jax_draws(cfg(), 8))
    return {"dp": W.run_job("dp", 2, out), "tp": W.run_job("tp", 2, out),
            "dp4": W.run_job("dp4", 4, out)}


# --- dp: exact --------------------------------------------------------------------

@pytest.mark.parametrize("job,name", [("dp", n) for n in W.SU_ROUNDS]
                         + [("dp", "multihost"), ("dp4", "rayleigh_mcnc_planar")])
def test_dp_rounds_equal_single_device(jobs, job, name):
    """dp 2 and dp 4 (and the multihost round on the 2-process job's global
    mesh) reproduce the single-device round's counters exactly, on every
    rank: the planar main path, and the complex64 branch on Rayleigh and
    LOS (the JAX tests' ``small_cfg``)."""
    cfg, batch = W.SU_ROUNDS["rayleigh_mcnc_planar" if name == "multihost" else name]
    single = single_rounds(cfg(), batch)
    assert single[:, 1].min() > 0
    for r, res in enumerate(jobs[job]):
        np.testing.assert_array_equal(res[name], single, err_msg=f"rank {r}")


def test_multihost_mesh_and_process_info(jobs):
    """The 2-process job's global mesh is dp 2, and process_info reports
    each rank of 2 processes with one device each."""
    for r, res in enumerate(jobs["dp"]):
        assert int(res["multihost_dp"]) == 2
        assert res["process_info"].tolist() == [r, 2, 2]


def test_dp_transport_round_equals_single_device(jobs):
    """The dp-sharded transport-coded round (IRA chain, 2 code blocks,
    min-sum) equals the single-device ``make_transport_round_fn`` on every
    rank, with and without the serial decode."""
    cfg, chain = W.transport_case()
    rf = link_ldpc.make_transport_round_fn(cfg, W.N_ITERS, 8, chain, 6, device="cpu")
    single = np.stack([rf(W.KEY, i, W.SNR_DB).numpy() for i in W.ROUNDS])
    assert single[:, :4].sum() > 0
    for res in jobs["dp"]:
        np.testing.assert_array_equal(res["transport"], single)
        np.testing.assert_array_equal(res["transport_serial"], single)


def test_dp4_los_on_jax_draws_against_jax_sharded_round(jobs):
    """dp 4 on JAX's own LOS draws (complex64 branch, f32 chain): EQUAL to
    the port's single-device frame on the same draws, on every rank, and
    against JAX's sharded round on the conftest's 8-device CPU mesh ``(4,
    2)`` for the same key (which equals JAX's single-device round,
    tests/test_sharding.py:49-60) within the tp tolerance. Gap measured
    against JAX: 2 bits in one of four counters (6144 bits each). The
    compiled JAX frame folds the constant factors of the LOS phase and
    moves a few decisions (tests/test_torch_link.py::
    test_complex_branch_counters_equal_jax, which holds the port's frame
    EQUAL to JAX's frame run op by op)."""
    from mimo_ofdm_tpu_torch.models.link import FrameDraws, make_frame_fn
    port_cfg, batch = W.TP_ROUNDS["los_cnc"]
    d = los_jax_draws(port_cfg(), batch)
    draws = FrameDraws.from_numpy(None, d["bits_c"], d["bits_d"], d["noise_c"],
                                  d["noise_d"], loc=d["loc"])
    c = make_frame_fn(port_cfg(), W.N_ITERS, device="cpu")(np.float32(W.SNR_DB), draws)
    port = np.concatenate([[int(c.clean_err.sum())], c.dist_err.sum(0).numpy()])
    for res in jobs["dp4"]:
        np.testing.assert_array_equal(res["los_jax_draws"], port)
    with jax.enable_x64(False):
        mesh = jsharded.make_mesh(n_dp=4, n_tp=2)
        jc = jsharded.make_sharded_round_fn(jax_cfg(port_cfg()), W.N_ITERS, batch, mesh)(
            jax.random.key(LOS_JAX_KEY), np.float32(W.SNR_DB))
        want = np.concatenate([[int(jc.clean_err)], np.asarray(jc.dist_err)])
    assert want[1] > 0
    assert_tp_close(port, want, batch * port_cfg().modem.n_bits_per_ofdm_sym)


# --- tp: within JAX's tolerance -------------------------------------------------

@pytest.mark.parametrize("name", list(W.TP_ROUNDS))
def test_tp_rounds_within_tolerance(jobs, name):
    """tp 2 (LOS CNC, Rayleigh MCNC, Rician MCNC under the epsilon CSI
    error, TDL CNC under the CSI-SNR error; complex64 branch, f32 chain)
    against the single-device round of the same config: within JAX's
    tolerance for non-exact sharding, the counters replicated on both
    ranks, and each rank launching the fused chain 1 + n_iters + 1 times a
    round on its own antennas. Gap measured: 0 differing bits in every
    config (6144 bits a round, 2 rounds)."""
    cfg, batch = W.TP_ROUNDS[name]
    single = single_rounds(cfg(), batch)
    n_bits = batch * cfg().modem.n_bits_per_ofdm_sym
    res = jobs["tp"]
    np.testing.assert_array_equal(res[0][name], res[1][name])
    assert_tp_close(res[0][name], single, n_bits)
    for r in res:
        assert int(r[name + "_launches"]) == len(W.ROUNDS) * (1 + W.N_ITERS + 1)


def test_dp2_tp2_mesh_within_tolerance(jobs):
    """The (2, 2) mesh on four ranks (LOS CNC): within the tp tolerance of
    the single-device round, the same counters on all four ranks. Gap
    measured: 0 differing bits."""
    cfg, batch = W.TP_ROUNDS["los_cnc"]
    single = single_rounds(cfg(), batch)
    res = jobs["dp4"]
    for r in res[1:]:
        np.testing.assert_array_equal(r["los_cnc_22"], res[0]["los_cnc_22"])
    assert_tp_close(res[0]["los_cnc_22"], single, batch * cfg().modem.n_bits_per_ofdm_sym)


@pytest.mark.parametrize("model", ["awgn", "los", "two_path", "rayleigh", "rician",
                                   "random_paths", "tdl_3gpp", "gscm"])
def test_channel_rows_are_the_whole_arrays_rows(model):
    """``make_channel_fn(rows=)`` gives an antenna shard its rows of the
    single-device channel, on the same global draws: the per-antenna
    channels from the shard's rows of the draws, the array-relative ones
    (random paths, TDL, GSCM) formed whole and cut. Equal bit for bit."""
    import torch
    from mimo_ofdm_tpu_torch.models.link import FrameDraws, link_static, make_channel_fn
    from mimo_ofdm_tpu_torch.ops import ofdm
    cfg = W.su_cfg(model, "cnc")
    tx_pos, freqs, rx_base = link_static(cfg, "cpu")
    freqs_sc = ofdm.extract_subcarriers(freqs, cfg.modem.n_sub_carr)
    draws = FrameDraws.draw(cfg, 3, torch.Generator().manual_seed(2))
    whole = make_channel_fn(cfg, freqs_sc, rx_base, True)(tx_pos, draws)
    for rows in (slice(0, 4), slice(4, 8), slice(2, 4)):
        part = make_channel_fn(cfg, freqs_sc, rx_base, True, rows)(tx_pos, draws)
        assert torch.equal(part, whole[..., rows, :]), rows


# --- each sharded function against JAX's unsharded one ---------------------------

def _jax_su():
    h, x, sym = W.su_inputs()
    with jax.enable_x64(False):
        v = jprec.mrt_precoder(jnp.asarray(h))
        sat = jprec.pa_sat_power(0.0, 0.5, v)
        st = jagc.compute_agc_sc(jnp.asarray(h), v, 0.0, 8)
        rep = jrx.make_mcnc_replica(jnp.asarray(h), v, st.ak_hk_vk_agc_sc, constel_size=16,
                                    n_fft=256, n_sc=128, sat_power=sat)(jnp.asarray(sym))
        out = {"mrt": v, "sat": sat, "gain": jprec.avg_precoding_gain(v),
               "agc_hv": st.hk_vk_agc_sc, "agc_ahv": st.ak_hk_vk_agc_sc,
               "agc_nhv": st.hk_vk_noise_scaler, "agc_nahv": st.ak_hk_vk_noise_scaler,
               "agc_ak": st.ak_vect, "propagate": jchannels.propagate(jnp.asarray(h),
                                                                       jnp.asarray(x)),
               "mcnc_replica": rep}
        return {k: np.asarray(v) for k, v in out.items()}


SHARDED_ROWS = ("mrt", "agc_ak")          # outputs of the shard's antennas


@pytest.mark.parametrize("name", ["mrt", "sat", "gain", "agc_hv", "agc_ahv", "agc_nhv",
                                  "agc_nahv", "agc_ak", "propagate", "mcnc_replica"])
def test_sharded_functions_match_jax(jobs, name):
    """MRT, the saturation power and precoding gain, the AGC state,
    ``propagate`` and the MCNC replica on 2 antenna shards, against JAX's
    unsharded functions on the full arrays: within 1e-6 relative L2 (the
    antenna rows concatenated, the replicated outputs equal on both ranks).
    Gap measured: 0 for the saturation power, the precoding gain and the
    clean noise scaler; 6.7e-8 to 1.5e-7 for the others; at most 2.0e-7,
    the distorted noise scaler."""
    want = _jax_su()[name]
    res = jobs["tp"]
    if name in SHARDED_ROWS:
        got = np.concatenate([r[name] for r in res], axis=0)
    else:
        np.testing.assert_array_equal(res[0][name], res[1][name])
        got = res[0][name]
    assert got.shape == want.shape
    assert rel_l2(got, want) < REL_L2, rel_l2(got, want)


# --- meshes, errors, one rank -----------------------------------------------------

def test_mesh_shapes_and_errors(jobs):
    """On 2 ranks: ``make_mesh()`` is (2, 1), ``make_mesh(n_tp=2)`` (1, 2),
    ``make_mesh(n_dp=1)`` (1, 1) on rank 0 only; JAX's divisibility errors."""
    for r, res in enumerate(jobs["dp"]):
        assert res["mesh_shapes"].tolist() == [[2, 1, 1], [1, 2, 1], [1, 1, int(r == 0)]]
        assert res["errors"].tolist() == ["batch 3 not divisible by dp=2",
                                          "n_ant 3 not divisible by tp=2"]


def test_one_rank_mesh_runs_the_unsharded_rounds():
    """Without a process group the mesh is this process alone, (1, 1), with
    no groups; its single-user, multi-user and transport rounds equal the
    unsharded ones, and a larger mesh is refused."""
    mesh = sharded.make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.dp_group is None
    cfg, batch = W.SU_ROUNDS["rayleigh_mcnc_planar"]
    rf = sharded.make_sharded_round_fn(cfg(), W.N_ITERS, batch, mesh, device="cpu")
    np.testing.assert_array_equal(np.stack([rf(W.KEY, i, W.SNR_DB).numpy()
                                            for i in W.ROUNDS]),
                                  single_rounds(cfg(), batch))
    mcfg = W.mu_cfg("mrt", "mcnc_mu")
    a = sharded.make_sharded_mu_round_fn(mcfg, 1, 2, mesh, device="cpu")(W.KEY, 0, W.SNR_DB)
    b = link_mu.make_mu_round_fn(mcfg, 1, 2, device="cpu")(W.KEY, 0, W.SNR_DB)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    tcfg, chain = W.transport_case()
    a = sharded.make_sharded_transport_round_fn(tcfg, 1, 2, chain, mesh, ldpc_iters=2,
                                                device="cpu")(W.KEY, 0, W.SNR_DB)
    b = link_ldpc.make_transport_round_fn(tcfg, 1, 2, chain, 2, device="cpu")(
        W.KEY, 0, W.SNR_DB)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="running process group"):
        sharded.make_mesh(n_dp=2)
    info = multihost.process_info()
    assert info["process_count"] == 1 and info["process_index"] == 0


# --- weak scaling -----------------------------------------------------------------

def test_weak_scaling_on_four_ranks(jobs):
    """weak_scaling over 1, 2 and 4 gloo ranks: positive frames/s,
    efficiency 1 at one rank and sane beyond, one draw time per rank, the
    platform named; every rank returns rank 0's numbers."""
    res = jobs["dp4"]
    sc = res[0]["scaling"]
    assert sc[0, 1] == 1.0 and np.all(sc[:, 0] > 0)
    assert np.all((0.01 < sc[1:, 1]) & (sc[1:, 1] <= 2.0)), sc
    assert res[0]["scaling_draw_ms"].tolist() == [1, 2, 4]
    assert str(res[0]["scaling_platform"]) == "cpu"
    for r in res[1:]:
        np.testing.assert_array_equal(r["scaling"], sc)


def test_weak_scaling_one_process_writes_json(tmp_path, monkeypatch):
    """As one process, weak_scaling measures one device and writes its JSON
    under figs/scaling_torch/ (never JAX's figs/scaling/)."""
    monkeypatch.chdir(tmp_path)
    payload = EXPERIMENTS["weak_scaling"](n_ant=4, n_iters=1, batch_per_device=4,
                                          min_seconds=0.05, verbose=False, device="cpu")
    assert payload["platform"] == "cpu" and payload["device_name"] == "cpu"
    res = payload["results"]
    assert list(res) == ["1"] and res["1"]["efficiency"] == 1.0
    assert res["1"]["frames_per_s"] > 0 and len(res["1"]["draw_ms_per_rank"]) == 1
    files = os.listdir(tmp_path / "figs" / "scaling_torch")
    assert files == ["weak_scaling_cpu_tp1_nant4_nfft256.json"]
    assert not (tmp_path / "figs" / "scaling").exists()
    assert torch.distributed.is_initialized() is False
