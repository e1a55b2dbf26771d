"""Multi-process gloo jobs of the port's scale-out tests (helper of
tests/test_torch_sharding.py and tests/test_torch_sharding_mu.py; not a
test file).

:func:`run_job` starts ``world`` CPU processes, each running this file as

    python tests/torch_dist_worker.py <job> <rank> <world> <port> <outdir>

which joins a gloo process group through the port's
``parallel.multihost.initialize`` (at ``tcp://127.0.0.1:<port>``, with a
60 s collective timeout), runs ``JOBS[job]`` and saves what it returns as
``<outdir>/<job>_rank<rank>.npz``. The parent waits a bounded time, kills
every rank on a failure or a timeout, and raises with the ranks' logs.
The ranks import torch and the port only, never JAX.

The jobs run at the JAX scale-out tests' shapes (n_fft 256, 8 antennas)
and make their inputs from fixed seeds; the test files compute the
single-device and JAX sides of each comparison from the same seeds.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = timedelta(seconds=60)
SNR_DB = 15.0
KEY = 3
ROUNDS = (0, 1)
N_ITERS = 2


# --- the configurations, shared with the test files ---------------------------

def su_cfg(chan="rayleigh", alg="mcnc", **kw):
    """The JAX sharding tests' single-user config
    (``tests/test_sharding.py::small_cfg``), port side."""
    from mimo_ofdm_tpu_torch.utils import config
    base = dict(modem=config.ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128,
                                         cp_len=16),
                array=config.ArrayConfig(n_elements=8),
                channel=config.ChannelConfig(model=chan), precoding="mrt",
                pa=config.PaConfig(model="softlim", ibo_db=0.0),
                rx=config.RxConfig(algorithm=alg))
    base.update(kw)
    return config.LinkConfig(**base)


def mu_cfg(precoding="zf", alg="cnc", chan="los"):
    """``tests/test_sharding.py::test_mu_tp_sharding_matches_single_device``'s
    config at f32 chain storage, port side."""
    from mimo_ofdm_tpu_torch.utils import config
    return config.LinkConfig(
        modem=config.ModemConfig(constel_size=16, n_fft=256, n_sub_carr=128, cp_len=16),
        array=config.ArrayConfig(n_elements=8), channel=config.ChannelConfig(model=chan),
        precoding=precoding, pa=config.PaConfig(model="softlim", ibo_db=0.0),
        rx=config.RxConfig(algorithm=alg), mxu_fft_storage="float32")


# the rounds the jobs run: name -> (config, batch[, sep_carriers]). The tp
# rounds run the complex64 branch at f32 chain storage on both sides, as
# tests/test_sharding.py holds its tp rounds, so that the antenna sums'
# order is the only difference from the single-device round.
SU_ROUNDS = {
    "rayleigh_mcnc_planar": (lambda: su_cfg(), 8),
    "rayleigh_mcnc_c64": (lambda: su_cfg(channel_storage="complex64"), 8),
    "los_cnc_c64": (lambda: su_cfg("los", "cnc", channel_storage="complex64"), 8),
}
TP_ROUNDS = {
    "los_cnc": (lambda: su_cfg("los", "cnc", mxu_fft_storage="float32",
                               channel_storage="complex64"), 8),
    "rayleigh_mcnc": (lambda: su_cfg("rayleigh", "mcnc", mxu_fft_storage="float32",
                                     channel_storage="complex64"), 8),
    "rician_mcnc_csi_eps": (lambda: su_cfg("rician", "mcnc", mxu_fft_storage="float32",
                                           csi_epsilon=0.1), 8),
    "tdl_cnc_csi_snr": (lambda: su_cfg("tdl_3gpp", "cnc", mxu_fft_storage="float32",
                                       csi_snr_db=15.0), 8),
}
MU_TP_ROUNDS = {
    "zf_cnc": (lambda: mu_cfg("zf", "cnc"), 8, False),
    "mrt_mcnc_mu": (lambda: mu_cfg("mrt", "mcnc_mu"), 8, False),
    "sep_cnc": (lambda: mu_cfg("mrt", "cnc"), 8, True),
}


def transport_case():
    """The coded config and chain of ``tests/test_sharding.py::
    test_dp_sharded_transport_round_counter_identical``, port side."""
    from mimo_ofdm_tpu_torch.models.link_ldpc import transport_chain_for_modem
    cfg = su_cfg(alg="cnc", channel_storage="complex64")
    return cfg, transport_chain_for_modem(cfg, code_rate=0.5, n_blocks=2, family="ira")


# --- sharded-function inputs ---------------------------------------------------

def su_inputs(n_ant=8, n_sc=128, seed=11):
    """Channel ``h [n_ant, n_sc]``, signal ``x [n_ant, n_sc]`` and
    detected symbols ``sym [n_sc]`` (16-QAM points), complex64."""
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                / np.sqrt(2)).astype(np.complex64)
    pts = np.array([-3, -1, 1, 3], np.float32) / np.sqrt(10.0)
    sym = (rng.choice(pts, n_sc) + 1j * rng.choice(pts, n_sc)).astype(np.complex64)
    return cn(n_ant, n_sc), cn(n_ant, n_sc), sym


def mu_inputs(n_usr=2, n_ant=8, n_sc=128, seed=12):
    """User channels ``h [n_usr, n_ant, n_sc]`` and every user's symbols
    ``sym [n_usr, n_sc]`` (16-QAM points), complex64."""
    rng = np.random.default_rng(seed)
    h = ((rng.standard_normal((n_usr, n_ant, n_sc))
          + 1j * rng.standard_normal((n_usr, n_ant, n_sc))) / np.sqrt(2)).astype(np.complex64)
    pts = np.array([-3, -1, 1, 3], np.float32) / np.sqrt(10.0)
    sym = (rng.choice(pts, (n_usr, n_sc)) + 1j * rng.choice(pts, (n_usr, n_sc))).astype(
        np.complex64)
    return h, sym


def _np(t):
    return t.detach().cpu().numpy()


def su_functions(group, sl):
    """Every single-user function with an antenna group, on this rank's
    antennas ``sl`` of :func:`su_inputs`."""
    import torch
    from mimo_ofdm_tpu_torch.models import agc, channels, precoding, receivers
    h_np, x_np, sym_np = su_inputs()
    n_ant = h_np.shape[0]
    h, x, sym = (torch.as_tensor(a) for a in (h_np[sl], x_np[sl], sym_np))
    v = precoding.mrt_precoder(h, group)
    sat = precoding.pa_sat_power(0.0, 0.5, v, ant_group=group, n_ant_global=n_ant)
    gain = precoding.avg_precoding_gain(v, ant_group=group, n_ant_global=n_ant)
    st = agc.compute_agc_sc(h, v, 0.0, n_ant, ant_group=group)
    prop = channels.propagate(h, x, ant_group=group)
    replica = receivers.make_mcnc_replica(h, v, st.ak_hk_vk_agc_sc, constel_size=16,
                                          n_fft=256, n_sc=128, sat_power=sat,
                                          ant_group=group)
    return {"mrt": _np(v), "sat": _np(sat), "gain": _np(gain),
            "agc_hv": _np(st.hk_vk_agc_sc), "agc_ahv": _np(st.ak_hk_vk_agc_sc),
            "agc_nhv": _np(st.hk_vk_noise_scaler), "agc_nahv": _np(st.ak_hk_vk_noise_scaler),
            "agc_ak": _np(st.ak_vect), "propagate": _np(prop),
            "mcnc_replica": _np(replica(sym))}


def mu_functions(group, sl):
    """Every multi-user function with an antenna group, on this rank's
    antennas ``sl`` of :func:`mu_inputs` (two users; ZF also with three,
    the ``pinv`` branch)."""
    import torch
    from mimo_ofdm_tpu_torch.models import agc, precoding, receivers
    h_np, sym_np = mu_inputs()
    h3_np, _ = mu_inputs(n_usr=3, seed=13)
    n_ant = h_np.shape[1]
    h, sym, h3 = (torch.as_tensor(a) for a in (h_np[:, sl], sym_np, h3_np[:, sl]))
    out = {}
    v_zf = precoding.zf_precoder(h, group, n_ant)
    out["zf"] = _np(v_zf)
    out["zf3"] = _np(precoding.zf_precoder(h3, group, n_ant))
    v = precoding.mu_mrt_precoder(h, group)
    out["mu_mrt"] = _np(v)
    out["sep_mrt"] = _np(precoding.mu_sep_carrier_precoder(h, True, group))
    sat = precoding.pa_sat_power(0.0, 0.5, v, multi_user=True, ant_group=group,
                                 n_ant_global=n_ant)
    out["mu_sat"] = _np(sat)
    out["zf_gain"] = _np(precoding.avg_precoding_gain(v_zf, True, group, n_ant))
    st = agc.compute_agc_sc(h, v, 0.0, n_ant, usr_idx=slice(None), ant_group=group)
    out["agc_hv"] = _np(st.hk_vk_agc_sc)
    out["agc_ahv"] = _np(st.ak_hk_vk_agc_sc)
    out["agc_ak"] = _np(st.ak_vect)
    replica = receivers.make_mcnc_mu_replica(sym, h, v, st.ak_hk_vk_agc_sc, constel_size=16,
                                             n_fft=256, n_sc=128, sat_power=sat,
                                             ant_group=group)
    out["mcnc_mu_replica"] = _np(replica(sym.flip(0)))   # each user's detection: the other's
    return out


# --- the jobs -------------------------------------------------------------------

def _launches(fn):
    """``fn()`` and the fused-chain calls it made (on the CPU: the plain
    version, which the wrapper runs for CPU tensors; counted by wrapping
    it)."""
    from mimo_ofdm_tpu_torch.kernels import fused_pa
    plain = fused_pa.fused_ifft_pa_fft_plain
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)
    fused_pa.fused_ifft_pa_fft_plain = counted
    try:
        out = fn()
    finally:
        fused_pa.fused_ifft_pa_fft_plain = plain
    return out, calls[0]


def _rounds(round_fn):
    return np.stack([round_fn(KEY, i, SNR_DB).numpy() for i in ROUNDS])


def job_dp(rank, world, outdir):
    """dp = world: each single-user round, the multihost round, the
    transport round, the mesh shapes and the divisibility errors."""
    from mimo_ofdm_tpu_torch.parallel import multihost, sharded
    from mimo_ofdm_tpu_torch.utils.config import ArrayConfig
    out = {}
    mesh = sharded.make_mesh(n_dp=world)
    for name, (cfg, batch) in SU_ROUNDS.items():
        out[name] = _rounds(sharded.make_dp_round_fn(cfg(), N_ITERS, batch, mesh,
                                                     device="cpu"))
    rf, gmesh = multihost.make_multihost_round_fn(su_cfg(), N_ITERS, 8, device="cpu")
    out["multihost"] = _rounds(rf)
    out["multihost_dp"] = np.array(gmesh.shape["dp"])
    cfg, chain = transport_case()
    rf = sharded.make_sharded_transport_round_fn(cfg, N_ITERS, 8, chain, mesh,
                                                 ldpc_iters=6, device="cpu")
    out["transport"] = _rounds(rf)
    rf = sharded.make_sharded_transport_round_fn(cfg, N_ITERS, 8, chain, mesh,
                                                 ldpc_iters=6, serial_decode=4, device="cpu")
    out["transport_serial"] = _rounds(rf)
    shapes = [sharded.make_mesh(), sharded.make_mesh(n_tp=2), sharded.make_mesh(n_dp=1)]
    out["mesh_shapes"] = np.array([[m.shape["dp"], m.shape["tp"], m.member] for m in shapes])
    errors = []
    for call in (lambda: sharded.make_sharded_round_fn(su_cfg(), 1, world + 1, mesh,
                                                       device="cpu"),
                 lambda: sharded.make_sharded_round_fn(
                     su_cfg(array=ArrayConfig(n_elements=3)), 1, world,
                     sharded.make_mesh(n_dp=1, n_tp=2), device="cpu")):
        try:
            call()
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)
    info = multihost.process_info()
    out["process_info"] = np.array([info["process_index"], info["process_count"],
                                    info["global_device_count"]])
    return out


def job_tp(rank, world, outdir):
    """tp = 2 (and dp = world / 2): the single-user tp rounds with their
    launches, and every single-user sharded function."""
    from mimo_ofdm_tpu_torch.parallel import sharded
    from mimo_ofdm_tpu_torch.parallel.collectives import ant_slice
    out = {}
    mesh = sharded.make_mesh(n_tp=2)
    for name, (cfg, batch) in TP_ROUNDS.items():
        rf = sharded.make_sharded_round_fn(cfg(), N_ITERS, batch, mesh, device="cpu")
        out[name], out[name + "_launches"] = _launches(lambda: _rounds(rf))
    out.update(su_functions(mesh.tp_group, ant_slice(8, mesh.tp_group)))
    return out


def job_mu_tp(rank, world, outdir):
    """tp = 2: the multi-user tp rounds, and every multi-user sharded
    function."""
    from mimo_ofdm_tpu_torch.parallel import sharded
    from mimo_ofdm_tpu_torch.parallel.collectives import ant_slice
    out = {}
    mesh = sharded.make_mesh(n_tp=2)
    for name, (cfg, batch, sep) in MU_TP_ROUNDS.items():
        rf = sharded.make_sharded_mu_round_fn(cfg(), N_ITERS, batch, mesh,
                                              sep_carriers=sep, device="cpu")
        out[name], out[name + "_launches"] = _launches(lambda: _rounds(rf))
    mesh_dp = sharded.make_mesh(n_dp=world)
    rf = sharded.make_sharded_mu_round_fn(mu_cfg("mrt", "mcnc_mu"), N_ITERS, 8, mesh_dp,
                                          device="cpu")
    out["dp_mrt_mcnc_mu"] = _rounds(rf)
    out.update(mu_functions(mesh.tp_group, ant_slice(8, mesh.tp_group)))
    return out


def job_dp4(rank, world, outdir):
    """Four ranks: dp 4 on the planar Rayleigh round, the (2, 2) mesh on
    LOS, dp 4 on JAX's LOS draws (``jax_draws.npz`` from the parent), and
    the weak-scaling sweep over 1, 2 and 4 ranks."""
    from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS
    from mimo_ofdm_tpu_torch.models.link import FrameDraws
    from mimo_ofdm_tpu_torch.parallel import sharded
    out = {}
    mesh = sharded.make_mesh(n_dp=4)
    cfg, batch = SU_ROUNDS["rayleigh_mcnc_planar"]
    out["rayleigh_mcnc_planar"] = _rounds(sharded.make_dp_round_fn(cfg(), N_ITERS, batch,
                                                                   mesh, device="cpu"))
    mesh22 = sharded.make_mesh(n_dp=2, n_tp=2)
    cfg, batch = TP_ROUNDS["los_cnc"]
    out["los_cnc_22"] = _rounds(sharded.make_sharded_round_fn(cfg(), N_ITERS, batch, mesh22,
                                                              device="cpu"))
    with np.load(os.path.join(outdir, "jax_draws.npz")) as z:
        draws = FrameDraws.from_numpy(None, z["bits_c"], z["bits_d"], z["noise_c"],
                                      z["noise_d"], loc=z["loc"])
    cfg, _ = TP_ROUNDS["los_cnc"]
    rf = sharded.make_dp_round_fn(cfg(), N_ITERS, draws.batch, mesh, device="cpu")
    out["los_jax_draws"] = rf.run(np.float32(SNR_DB), draws).numpy()
    payload = EXPERIMENTS["weak_scaling"](n_ant=4, n_iters=1, batch_per_device=8,
                                          device_counts=[1, 2, 4], small=True,
                                          save_json=False, verbose=False,
                                          min_seconds=0.3, device="cpu")
    res = payload["results"]
    out["scaling"] = np.array([[res[k]["frames_per_s"], res[k]["efficiency"]]
                               for k in ("1", "2", "4")])
    out["scaling_draw_ms"] = np.array([len(res[k]["draw_ms_per_rank"]) for k in ("1", "2", "4")])
    out["scaling_platform"] = np.array(payload["platform"])
    return out


JOBS = {"dp": job_dp, "tp": job_tp, "mu_tp": job_mu_tp, "dp4": job_dp4}


# --- the parent side ---------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(job: str, world: int, outdir, wait_s: float = 150.0) -> list[dict]:
    """Run ``JOBS[job]`` on ``world`` gloo ranks; return each rank's saved
    arrays. Raises (after killing every rank) if a rank fails or the job
    outlasts ``wait_s``."""
    outdir = str(outdir)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    logs = [open(os.path.join(outdir, f"{job}_rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                               str(world), str(port), outdir],
                              cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + wait_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            with open(os.path.join(outdir, f"{job}_rank{r}.log")) as f:
                tails.append(f"--- rank {r} (rc {procs[r].returncode}):\n{f.read()[-3000:]}")
        raise RuntimeError(f"job {job!r} failed on ranks {failed}\n" + "\n".join(tails))
    out = []
    for r in range(world):
        with np.load(os.path.join(outdir, f"{job}_rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def main(job: str, rank: int, world: int, port: int, outdir: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from mimo_ofdm_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                         timeout=GROUP_TIMEOUT)
    try:
        out = JOBS[job](rank, world, outdir)
        np.savez(os.path.join(outdir, f"{job}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
