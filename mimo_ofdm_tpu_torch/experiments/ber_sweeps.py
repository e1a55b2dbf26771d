"""BER sweep experiments (port of ``mimo_ofdm_tpu/experiments/ber_sweeps.py``):
vs Eb/N0, vs IBO, vs antenna count, the fixed-BER required-Eb/N0 grid,
the AWGN, CSI-error and TOI variants, the reproduction of the committed
canonical curve, the multi-user sweep, and the six LDPC-coded sweeps
(raw IRA codeword, transport chain, reference parity, in-loop decoding,
noise-variance-adjusted LLRs, surrogate-table sensitivity).

Same arguments, defaults and CSV files as the JAX package's, plus
``device`` (``cuda`` unless ``"cpu"``). A JAX key ``fold_in(key(seed), i)``
becomes ``round_seed(seed, i)``.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch

from mimo_ofdm_tpu_torch.experiments import register
from mimo_ofdm_tpu_torch.models.link import make_round_fn, round_seed
from mimo_ofdm_tpu_torch.models.link_mu import default_user_positions, make_mu_round_fn
from mimo_ofdm_tpu_torch.ops.metrics import ebn0_to_snr
from mimo_ofdm_tpu_torch.parallel.montecarlo import (SweepResult, run_ber_sweep,
                                                     run_point,
                                                     run_sweep_pipelined)
from mimo_ofdm_tpu_torch.utils import results
from mimo_ofdm_tpu_torch.utils.config import (ArrayConfig, ChannelConfig, LinkConfig,
                                              ModemConfig, PaConfig, RxConfig,
                                              SweepConfig, canonical_miso_cnc)
from mimo_ofdm_tpu_torch.utils.device import resolve_device


def _base_cfg(small: bool) -> LinkConfig:
    """The canonical config, or its n_fft 256 cut for fast runs."""
    cfg0, _ = canonical_miso_cnc()
    if small:
        cfg0 = cfg0.replace(modem=ModemConfig(constel_size=64, n_fft=256,
                                              n_sub_carr=128, cp_len=16))
    return cfg0


def _save(res: SweepResult, cfg: LinkConfig, kind: str, n_iters: int,
          save_csv: bool, chan_suffix: str = ""):
    if not save_csv:
        return None
    fname = results.ber_sweep_filename(
        kind, cfg.rx.algorithm, cfg.channel.model + chan_suffix,
        cfg.array.n_elements, cfg.pa.ibo_db, res.param_values,
        list(range(1, n_iters + 1)))
    return results.save_ber_sweep(res.param_values, res.ber_matrix, fname)


def _sweep(ebn0_min, ebn0_max, ebn0_step, n_err_min, bits_sent_max, batch):
    return SweepConfig(ebn0_min=ebn0_min, ebn0_max=ebn0_max,
                       ebn0_step=ebn0_step, n_err_min=n_err_min,
                       bits_sent_max=bits_sent_max, batch_frames=batch)


@register("miso_ber_vs_ebn0")
def miso_ber_vs_ebn0(channels=("los",), algorithm="cnc", n_ant=64,
                     ibo_db=0.0, n_iters=8, ebn0_min=5.0, ebn0_max=20.0,
                     ebn0_step=0.5, n_err_min=100_000, bits_sent_max=10_000_000,
                     batch=32, channel_kwargs=None, save_suffix="",
                     seed=0, save_csv=True, verbose=True,
                     small=False, device=None):
    """Canonical BER vs Eb/N0 per channel per CNC/MCNC iteration count
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0.py``).
    ``channel_kwargs`` are extra :class:`ChannelConfig` fields;
    ``save_suffix`` is appended to the channel name in the CSV file name."""
    cfg0 = _base_cfg(small)
    out = {}
    for chan in channels:
        cfg = cfg0.replace(
            array=ArrayConfig(n_elements=n_ant, cord_z=cfg0.array.cord_z),
            channel=ChannelConfig(model=chan, **(channel_kwargs or {})),
            pa=PaConfig(model=cfg0.pa.model, ibo_db=ibo_db),
            rx=RxConfig(algorithm=algorithm))
        sweep = _sweep(ebn0_min, ebn0_max, ebn0_step, n_err_min,
                       bits_sent_max, batch)
        res = run_ber_sweep(cfg, sweep, n_iters, seed=seed, verbose=verbose,
                            device=device)
        _save(res, cfg, "ber_vs_ebn0", n_iters, save_csv,
              chan_suffix=save_suffix)
        out[chan] = res
    return out


@register("csi_err_ber_vs_ebn0")
def csi_err_ber_vs_ebn0(channel="los", algorithm="cnc", n_ant=64, ibo_db=0.0,
                        csi_eps=(0.0, 0.1, 0.2, 0.3), n_iters=8, ebn0_min=5.0,
                        ebn0_max=20.0, ebn0_step=0.5, n_err_min=100_000,
                        bits_sent_max=10_000_000, batch=32, seed=0,
                        save_csv=True, verbose=True, small=False, device=None):
    """BER vs Eb/N0 under imperfect CSI: the precoder, AGC and MCNC replica
    see ``H_noisy = sqrt(1-eps^2) H + eps sigma_H CN(0,1)`` while
    propagation uses the true ``H``
    (``reference/main_mp_clipping_noise_cancellation/main_mp_miso_{cnc,mcnc}_csi_err_ber_vs_ebn0.py``,
    ``reference/mp_model.py:264-284``)."""
    cfg0 = _base_cfg(small)
    out = {}
    for i, eps in enumerate(np.atleast_1d(np.asarray(csi_eps, np.float64))):
        cfg = cfg0.replace(
            array=ArrayConfig(n_elements=n_ant, cord_z=cfg0.array.cord_z),
            channel=ChannelConfig(model=channel),
            pa=PaConfig(model=cfg0.pa.model, ibo_db=ibo_db),
            rx=RxConfig(algorithm=algorithm),
            csi_epsilon=float(eps))
        sweep = _sweep(ebn0_min, ebn0_max, ebn0_step, n_err_min,
                       bits_sent_max, batch)
        if verbose:
            print(f"--- csi_eps = {eps:.3f} ---")
        res = run_ber_sweep(cfg, sweep, n_iters, seed=seed + 1000 * i,
                            verbose=verbose, device=device)
        if save_csv:
            fname = results.ber_sweep_filename(
                "ber_vs_ebn0", algorithm, f"{channel}_csi_eps{eps:.3f}",
                n_ant, ibo_db, res.param_values,
                list(range(1, n_iters + 1)))
            results.save_ber_sweep(res.param_values, res.ber_matrix, fname)
        out[float(eps)] = res
    return out


@register("csi_noise_ber_vs_ebn0")
def csi_noise_ber_vs_ebn0(channel="los", algorithm="cnc", n_ant=16,
                          ibo_db=0.0, csi_snr_db=(10.0, 15.0, 20.0, 30.0),
                          n_iters=8, ebn0_min=5.0, ebn0_max=20.0,
                          ebn0_step=1.0, n_err_min=100_000,
                          bits_sent_max=10_000_000, batch=32, seed=0,
                          save_csv=True, verbose=True, small=False,
                          device=None):
    """BER vs Eb/N0 under the additive CSI-noise model: the precoder, AGC
    and MCNC replica see ``H + CN(0, P_H/10^(csi_snr/10))`` while
    propagation uses the true ``H`` (the committed
    ``ber_vs_ebn0_*_csi_noise_dbN_nant16_*`` family)."""
    cfg0 = _base_cfg(small)
    out = {}
    for i, snr_csi in enumerate(np.atleast_1d(np.asarray(csi_snr_db,
                                                         np.float64))):
        cfg = cfg0.replace(
            array=ArrayConfig(n_elements=n_ant, cord_z=cfg0.array.cord_z),
            channel=ChannelConfig(model=channel),
            pa=PaConfig(model=cfg0.pa.model, ibo_db=ibo_db),
            rx=RxConfig(algorithm=algorithm),
            csi_snr_db=float(snr_csi))
        sweep = _sweep(ebn0_min, ebn0_max, ebn0_step, n_err_min,
                       bits_sent_max, batch)
        if verbose:
            print(f"--- csi_snr = {snr_csi:.0f} dB ---")
        res = run_ber_sweep(cfg, sweep, n_iters, seed=seed + 1000 * i,
                            verbose=verbose, device=device)
        if save_csv:
            fname = results.ber_sweep_filename(
                "ber_vs_ebn0", algorithm,
                f"{channel}_csi_noise_db{int(snr_csi)}", n_ant, ibo_db,
                res.param_values, list(range(1, n_iters + 1)))
            results.save_ber_sweep(res.param_values, res.ber_matrix, fname)
        out[float(snr_csi)] = res
    return out


def estimate_toi_alpha(cfg: LinkConfig, toi_db: float, n_est_symbols: int,
                       seed: int, device=None, chunk: int = 64) -> float:
    """Empirical Bussgang gain of the cubic PA (it has no closed form):
    unprecoded array, fixed channel at the base RX position, no noise,
    ``alpha = mean_frames |mean_sc(rx conj(clean) / |clean|^2)|``
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0_toi.py:93-122``)."""
    from mimo_ofdm_tpu_torch.models import channels as chan_mod
    from mimo_ofdm_tpu_torch.models import transmit
    from mimo_ofdm_tpu_torch.models.link import link_static, make_channel_fn
    from mimo_ofdm_tpu_torch.ops import bits as bits_ops
    from mimo_ofdm_tpu_torch.ops import ofdm, pa as pa_ops

    dev = resolve_device(device)
    m, n_fft, n_sc = (cfg.modem.constel_size, cfg.modem.n_fft,
                      cfg.modem.n_sub_carr)
    tx_pos, freqs, rx_base = link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    h_sc = make_channel_fn(cfg, freqs_sc, rx_base, reroll=False)(tx_pos)
    toi_coeff = pa_ops.toi_to_cubic_coeff(toi_db, cfg.modem.avg_sample_power)
    v = torch.ones((cfg.array.n_elements, n_sc), dtype=torch.complex64,
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(round_seed(seed, 77))
    alphas = []
    for start in range(0, n_est_symbols, chunk):
        bits = bits_ops.random_payload_bits(
            gen, (min(chunk, n_est_symbols - start),
                  cfg.modem.n_bits_per_ofdm_sym))
        fd_dist, fd_clean = transmit.array_transmit_fd(
            bits, constel_size=m, n_fft=n_fft, v=v, pa_model="toi",
            sat_power=1.0, toi_coeff=toi_coeff, return_clean=True)
        rx = chan_mod.propagate(h_sc, ofdm.extract_subcarriers(fd_dist, n_sc))
        cl = chan_mod.propagate(h_sc, ofdm.extract_subcarriers(fd_clean, n_sc))
        alphas.append((rx * torch.conj(cl) / (cl.abs() ** 2)).mean(-1).abs())
    return float(torch.cat(alphas).mean())


@register("toi_ber_vs_ebn0")
def toi_ber_vs_ebn0(channel="two_path", algorithm="cnc", n_ant=1,
                    toi_db=22.75, n_iters=8, ebn0_min=5.0, ebn0_max=20.0,
                    ebn0_step=1.0, n_err_min=100_000,
                    bits_sent_max=10_000_000, n_est_symbols=1024, batch=32,
                    seed=0, save_csv=True, verbose=True, small=False,
                    device=None):
    """BER vs Eb/N0 with the third-order-intercept PA
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ebn0_toi.py``;
    TOI 22.75 dB truncates to ``ibo22`` in the file name). The Bussgang
    gain is estimated first (:func:`estimate_toi_alpha`) and then used as a
    constant in the AGC and the CNC replica division
    (``update_distortion(..., alpha_val=...)``, ``:133-135``). Returns
    ``(alpha, SweepResult)``."""
    cfg0 = _base_cfg(small)
    cfg = cfg0.replace(
        array=ArrayConfig(n_elements=n_ant, cord_z=cfg0.array.cord_z),
        channel=ChannelConfig(model=channel),
        pa=PaConfig(model="toi", ibo_db=float(toi_db)),
        rx=RxConfig(algorithm=algorithm))
    alpha = estimate_toi_alpha(cfg, toi_db, n_est_symbols, seed, device)
    if verbose:
        print(f"TOI {toi_db} dB: empirical alpha estimate = {alpha:.5f}")
    cfg = cfg.replace(pa=PaConfig(model="toi", ibo_db=float(toi_db),
                                  alpha_estimate=alpha))
    sweep = _sweep(ebn0_min, ebn0_max, ebn0_step, n_err_min, bits_sent_max,
                   batch)
    res = run_ber_sweep(cfg, sweep, n_iters, seed=seed, verbose=verbose,
                        device=device)
    if save_csv:
        fname = results.ber_sweep_filename(
            "toi_ber_vs_ebn0", algorithm, channel, n_ant, toi_db,
            res.param_values, list(range(1, n_iters + 1)))
        results.save_ber_sweep(res.param_values, res.ber_matrix, fname)
    return alpha, res


@register("awgn_ber_vs_ebn0")
def awgn_ber_vs_ebn0(n_iters=8, ebn0_min=0.0, ebn0_max=20.0, ebn0_step=2.0,
                     ibo_db=0.0, n_err_min=1000, bits_sent_max=1_000_000,
                     batch=16, seed=0, save_csv=True, verbose=True,
                     small=False, device=None):
    """SISO AWGN CNC sanity sweep
    (``reference/main_clipping_noise_cancellation/main_awgn_cnc.py``)."""
    modem = ModemConfig(constel_size=64, n_fft=256 if small else 4096,
                        n_sub_carr=128 if small else 2048,
                        cp_len=16 if small else 128)
    cfg = LinkConfig(modem=modem, array=ArrayConfig(n_elements=1),
                     channel=ChannelConfig(model="awgn"), precoding="none",
                     pa=PaConfig(model="softlim", ibo_db=ibo_db),
                     rx=RxConfig(algorithm="cnc"))
    sweep = _sweep(ebn0_min, ebn0_max, ebn0_step, n_err_min, bits_sent_max,
                   batch)
    res = run_ber_sweep(cfg, sweep, n_iters, seed=seed, verbose=verbose,
                        device=device)
    _save(res, cfg, "ber_vs_ebn0_awgn", n_iters, save_csv)
    return res


@register("miso_ber_vs_ibo")
def miso_ber_vs_ibo(channel="los", algorithm="cnc", n_ant=64, ebn0_db=15.0,
                    ibo_min=0.0, ibo_max=9.5, ibo_step=0.5, ibo_values=None,
                    n_iters=8, n_err_min=100_000, bits_sent_max=1_000_000,
                    batch=32, no_noise=False, seed=0, save_csv=True,
                    verbose=True, small=False, device=None):
    """BER vs IBO at fixed Eb/N0 per iteration count
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_ibo.py``).
    The CSV holds row 0 = IBO values and one row per CNC iteration count
    0..n_iters (no clean-run row, ``:224-229``). ``no_noise=True`` sets
    SNR = +inf, so the noise scale is exactly 0 and the residual errors are
    PA distortion alone; the CSV name gains the ``no_noise_`` prefix. The
    IBO is an argument of one round function for the whole sweep."""
    cfg0 = _base_cfg(small)
    if ibo_values is None:
        ibo_values = np.arange(ibo_min, ibo_max, ibo_step)
    ibo_values = np.asarray(ibo_values, np.float64)
    cfg = cfg0.replace(array=ArrayConfig(n_elements=n_ant,
                                         cord_z=cfg0.array.cord_z),
                       channel=ChannelConfig(model=channel),
                       rx=RxConfig(algorithm=algorithm))
    snr = (np.inf if no_noise
           else ebn0_to_snr(ebn0_db, cfg.modem.n_sub_carr,
                            cfg.modem.n_sub_carr, cfg.modem.constel_size))
    round_fn = make_round_fn(cfg, n_iters, batch, ibo_as_arg=True, flat=True,
                             device=device)
    # one sweep point per IBO value (the SNR is fixed)
    pts = run_sweep_pipelined(
        lambda key, idx, ibo: round_fn(key, idx, float(snr), ibo), seed,
        ibo_values, n_counters=n_iters + 2,
        n_bits_per_frame=cfg.modem.n_bits_per_ofdm_sym, batch=batch,
        n_err_min=n_err_min, bits_sent_max=bits_sent_max)
    res = SweepResult(param_values=ibo_values, points=pts)
    if verbose:
        for ibo, pt in zip(ibo_values, pts):
            print(f"IBO={ibo:4.1f} dB  BER={np.array2string(pt.ber, precision=3)}")
    if save_csv:
        fname = results.ber_vs_ibo_filename(
            algorithm, channel, n_ant, ebn0_db, ibo_values,
            list(range(1, n_iters + 1)))
        if no_noise:
            fname = "no_noise_" + fname
        # the reference's layout: no clean-run row (counter 0 dropped)
        results.save_ber_sweep(ibo_values, res.ber_matrix[1:], fname)
    return res


@register("miso_ber_vs_nant")
def miso_ber_vs_nant(channels=("los", "two_path", "rayleigh"), algorithm="cnc",
                     n_ant_values=(1, 2, 4, 8, 16, 32, 64, 128), ebn0_db=15.0,
                     ibo_db=0.0, n_iters=8, n_err_min=1_000_000,
                     bits_sent_max=10_000_000, batch=32, seed=0, save_csv=True,
                     verbose=True, small=False, device=None):
    """BER vs number of antennas per channel
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_ber_vs_nant_vs_chan.py``).
    One CSV for all channels: row 0 = antenna counts, then per channel the
    clean-run row followed by one row per CNC iteration count 0..n_iters
    (``:282-288``)."""
    cfg0 = _base_cfg(small)
    out = {}
    for ci, chan in enumerate(channels):
        res = SweepResult(param_values=np.asarray(n_ant_values, np.float64))
        for i, n_ant in enumerate(n_ant_values):
            cfg = cfg0.replace(array=ArrayConfig(n_elements=int(n_ant),
                                                 cord_z=cfg0.array.cord_z),
                               channel=ChannelConfig(model=chan),
                               pa=PaConfig(model=cfg0.pa.model, ibo_db=ibo_db),
                               rx=RxConfig(algorithm=algorithm))
            snr = ebn0_to_snr(ebn0_db, cfg.modem.n_sub_carr,
                              cfg.modem.n_sub_carr, cfg.modem.constel_size)
            round_fn = make_round_fn(cfg, n_iters, batch, flat=True,
                                     device=device)
            pt = run_point(round_fn, round_seed(seed, 1000 * ci + i),
                           float(snr), n_counters=n_iters + 2,
                           n_bits_per_frame=cfg.modem.n_bits_per_ofdm_sym,
                           batch=batch, n_err_min=n_err_min,
                           bits_sent_max=bits_sent_max)
            res.points.append(pt)
            if verbose:
                print(f"{chan} n_ant={n_ant}  "
                      f"BER={np.array2string(pt.ber, precision=3)}")
        out[chan] = res
    if save_csv:
        fname = results.ber_vs_nant_filename(
            algorithm, n_ant_values, ebn0_db, ibo_db,
            list(range(1, n_iters + 1)))
        data = [np.asarray(n_ant_values, float)]
        for chan in channels:
            data.extend(np.asarray(r) for r in out[chan].ber_matrix)
        results.save_to_csv(data, fname)
    return out


def interp_req_ebn0(ber_grid: np.ndarray, ebn0_arr: np.ndarray,
                    target_ber: float) -> np.ndarray:
    """Required Eb/N0 per (iteration, IBO) from a full BER grid by 1-D
    interpolation of Eb/N0 as a function of BER (the reference's
    ``interp1d(ber_per_ebn0, ebn0_db_arr)`` at the target,
    ``reference/main_clipping_noise_cancellation/main_miso_cnc_constant_ber_req_ebn0_vs_ibo.py:280-309``);
    out-of-range targets become ``inf``. ``ber_grid``: ``[n_ibo, n_ebn0,
    n_counters]``. Returns ``[n_counters, n_ibo]``."""
    n_ibo, _, n_ctr = ber_grid.shape
    req = np.full((n_ctr, n_ibo), np.inf)
    for c in range(n_ctr):
        for j in range(n_ibo):
            ber = ber_grid[j, :, c]
            order = np.argsort(ber)
            b, e = ber[order], ebn0_arr[order]
            # drop duplicate BER values (flat floors) for a valid interp
            keep = np.concatenate([[True], np.diff(b) > 0])
            b, e = b[keep], e[keep]
            if len(b) >= 2 and b[0] <= target_ber <= b[-1]:
                req[c, j] = np.interp(target_ber, b, e)
    return req


@register("req_ebn0_vs_ibo")
def req_ebn0_vs_ibo(channel="two_path", algorithm="cnc", n_ant=64,
                    target_ber=1e-2, ibo_min=0.0, ibo_max=8.0, ibo_step=0.5,
                    ebn0_min=10.0, ebn0_max=22.1, ebn0_step=0.5, n_iters=8,
                    n_err_min=100_000, bits_sent_max=1_000_000, batch=32,
                    seed=0, save_csv=True, verbose=True, small=False,
                    device=None):
    """Required Eb/N0 for a fixed BER vs IBO, from the full (IBO x Eb/N0)
    BER grid and interpolation
    (``reference/main_clipping_noise_cancellation/main_miso_cnc_constant_ber_req_ebn0_vs_ibo.py``).
    The CSV holds row 0 = IBO values, then IBO-major rows of per-iteration
    BER (one row per Eb/N0 point, ``n_iters+1`` columns, no clean-run
    column). Returns ``(ibo_arr, ebn0_arr, ber_grid, req_ebn0)``."""
    cfg0 = _base_cfg(small)
    ibo_arr = np.arange(ibo_min, ibo_max, ibo_step)
    ebn0_arr = np.arange(ebn0_min, ebn0_max, ebn0_step)
    snrs = ebn0_to_snr(ebn0_arr, cfg0.modem.n_sub_carr,
                       cfg0.modem.n_sub_carr, cfg0.modem.constel_size)
    ber_grid = np.zeros((len(ibo_arr), len(ebn0_arr), n_iters + 1))
    cfg = cfg0.replace(array=ArrayConfig(n_elements=n_ant,
                                         cord_z=cfg0.array.cord_z),
                       channel=ChannelConfig(model=channel),
                       rx=RxConfig(algorithm=algorithm))
    # one round function for the whole grid: the IBO is an argument, and
    # the Eb/N0 axis runs through the cross-point pipelined scheduler
    round_fn = make_round_fn(cfg, n_iters, batch, incl_clean=False, flat=True,
                             ibo_as_arg=True, device=device)
    for j, ibo in enumerate(ibo_arr):
        pts = run_sweep_pipelined(
            lambda k, i, s, _ibo=float(ibo): round_fn(k, i, s, _ibo),
            round_seed(seed, j * len(ebn0_arr)), snrs,
            n_counters=n_iters + 2,
            n_bits_per_frame=cfg.modem.n_bits_per_ofdm_sym, batch=batch,
            n_err_min=n_err_min, bits_sent_max=bits_sent_max)
        for i, pt in enumerate(pts):
            ber_grid[j, i, :] = pt.ber[1:]
        if verbose:
            print(f"IBO={ibo:4.1f}  BER@{ebn0_arr[-1]:.1f}dB="
                  f"{np.array2string(ber_grid[j, -1], precision=3)}",
                  flush=True)
    req = interp_req_ebn0(ber_grid, ebn0_arr, target_ber)
    if verbose:
        with np.printoptions(precision=2):
            print("required Eb/N0 rows (iter 0..n):")
            print(req)
    if save_csv:
        fname = results.fixed_ber_filename(
            target_ber, algorithm, channel, n_ant, ebn0_arr, ibo_arr,
            list(range(1, n_iters + 1)))
        data = [ibo_arr]
        for j in range(len(ibo_arr)):
            data.extend(ber_grid[j, i, :] for i in range(len(ebn0_arr)))
        results.save_to_csv(data, fname)
    return ibo_arr, ebn0_arr, ber_grid, req


# the repo's copy of the reference's committed canonical curve
REFERENCE_CURVE_CSV = (Path(__file__).resolve().parents[2] / "figs" / "csv_results"
                       / "ber_vs_ebn0_cnc_los_nant64_ibo0_ebn0_min5_max20_step0.50"
                         "_niter1_2_3_4_5_6_7_8.csv")


@register("reproduce_reference_curve")
def reproduce_reference_curve(ebn0_points=(10.0, 14.0, 18.0), n_err_min=2000,
                              bits_sent_max=40_000_000, batch=256, seed=0,
                              verbose=True, ref_csv=REFERENCE_CURVE_CSV, device=None):
    """Reproduce the reference's committed canonical BER curve (64-QAM,
    4096-FFT, 64-antenna ULA, LOS, IBO 0 dB, CNC 0-8; ``canonical_miso_cnc()``
    unchanged) at ``ebn0_points`` and report the deviation per counter.
    Returns ``{ebn0: (reference BER [10], measured BER [10], point)}``
    over the counters ``[clean, it0..it8]``, ``point`` the
    :class:`PointResult` with the errors, bits and rounds behind the BERs
    (the JAX package returns the first two)."""
    cfg, _ = canonical_miso_cnc()
    round_fn = make_round_fn(cfg, 8, batch, flat=True, device=device)
    with open(ref_csv, newline="") as f:
        ref = [np.array([float(x) for x in r]) for r in csv.reader(f)]
    out = {}
    for ebn0 in ebn0_points:
        snr = ebn0_to_snr(ebn0, cfg.modem.n_sub_carr, cfg.modem.n_sub_carr,
                          cfg.modem.constel_size)
        pt = run_point(round_fn, round_seed(seed, int(ebn0 * 10)), float(snr),
                       n_counters=10, n_bits_per_frame=cfg.modem.n_bits_per_ofdm_sym,
                       batch=batch, n_err_min=n_err_min, bits_sent_max=bits_sent_max)
        i = int(np.argmin(abs(ref[0] - ebn0)))
        refv = np.array([ref[r][i] for r in range(1, 11)])
        out[ebn0] = (refv, pt.ber, pt)
        if verbose:
            print(f"Eb/N0 {ebn0}:")
            print("  ref :", np.array2string(refv, precision=3))
            print("  ours:", np.array2string(pt.ber, precision=3))
    return out


@register("multiuser_ber")
def multiuser_ber(precoding="mrt", algorithm="cnc", channel="los", n_ant=64,
                  ibo_db=0.0, user_angles=(-30.0, 30.0),
                  user_distances=(100.0, 316.3), n_iters=8, ebn0_min=5.0,
                  ebn0_max=20.0, ebn0_step=1.0, n_err_min=1_000_000,
                  bits_sent_max=10_000_000, batch=16, seed=0, save_csv=True,
                  verbose=True, small=False, sep_carriers=False, device=None):
    """Per-user BER vs Eb/N0 for a user geometry and channel
    (``reference/main_multiuser/main_multiuser_cnc_ber_vs_ebn0.py``).
    Defaults: the canonical 2-user geometry (+-30 deg at 100 / 316.3 m).
    ``algorithm``: cnc | cnc_mu (CNCWI) | mcnc_mu (MCNCWI). Each user stops
    counting when it has ``n_err_min`` errors or ``bits_sent_max`` bits; a
    round's counters reach the host in one fetch. Returns ``(ebn0, ber
    [n_usr, n_iters + 2, n_points])``."""
    n_usr = len(user_angles)
    modem = ModemConfig(constel_size=64, n_fft=256 if small else 4096,
                        n_sub_carr=128 if small else 2048,
                        cp_len=16 if small else 128, n_users=n_usr)
    cfg = LinkConfig(modem=modem, array=ArrayConfig(n_elements=n_ant),
                     channel=ChannelConfig(model=channel), precoding=precoding,
                     pa=PaConfig(model="softlim", ibo_db=ibo_db),
                     rx=RxConfig(algorithm=algorithm))
    user_positions = default_user_positions(tuple(user_angles), tuple(user_distances))
    ebn0 = np.arange(ebn0_min, ebn0_max + ebn0_step / 2, ebn0_step)
    snrs = ebn0_to_snr(ebn0, modem.n_sub_carr, modem.n_sub_carr, modem.constel_size)
    round_fn = make_mu_round_fn(cfg, n_iters, batch, user_positions,
                                sep_carriers=sep_carriers, device=device)
    n_bits_frame = modem.n_bits_per_ofdm_sym
    ber = np.zeros((n_usr, n_iters + 2, len(ebn0)))
    for i, snr in enumerate(snrs):
        n_err = np.zeros((n_usr, n_iters + 2), np.int64)
        n_bits = np.zeros((n_usr, n_iters + 2), np.int64)
        rounds = 0
        key = round_seed(seed, i)
        while True:
            active = (n_err < n_err_min) & (n_bits < bits_sent_max)
            if not active.any():
                break
            errs = round_fn(key, rounds, float(snr)).cpu().numpy()
            n_err += np.where(active, errs, 0)
            n_bits += np.where(active, batch * n_bits_frame, 0)
            rounds += 1
        ber[:, :, i] = n_err / np.maximum(n_bits, 1)
        if verbose:
            print(f"Eb/N0={ebn0[i]:5.1f}  usr0 BER="
                  f"{np.array2string(ber[0, :, i], precision=3)}")
    if save_csv:
        # the reference's layout: row 0 = Eb/N0, then per user the clean
        # row and one row per CNC iteration count 0..n_iters
        # (reference/main_multiuser/main_multiuser_cnc_ber_vs_ebn0.py:665-672)
        prec_ref = {"mrt": "mr"}.get(precoding, precoding)
        fname = results.mu_ber_filename(
            prec_ref, channel, n_ant, ibo_db, ebn0, list(range(1, n_iters + 1)),
            user_angles, user_distances,
            rx_name="cnc" if algorithm in ("cnc", "cnc_mu", "mcnc_mu") else algorithm)
        data = [ebn0]
        for u in range(n_usr):
            data.extend(np.asarray(r) for r in ber[u])
        results.save_to_csv(data, fname)
    return ebn0, ber


def coded_link_config(channel: str, algorithm: str, n_ant: int, ibo_db: float,
                      small: bool) -> LinkConfig:
    """The coded experiments' link: 64-QAM, MRT, soft limiter, the
    canonical modem or its n_fft 256 cut."""
    modem = ModemConfig(constel_size=64, n_fft=256 if small else 4096,
                        n_sub_carr=128 if small else 2048, cp_len=16 if small else 128)
    return LinkConfig(modem=modem, array=ArrayConfig(n_elements=n_ant),
                      channel=ChannelConfig(model=channel), precoding="mrt",
                      pa=PaConfig(model="softlim", ibo_db=ibo_db),
                      rx=RxConfig(algorithm=algorithm))


@register("ldpc_coded_ber")
def ldpc_coded_ber(channel="los", algorithm="cnc", n_ant=64, ibo_db=0.0,
                   n_iters=8, code_rate=0.5, ldpc_iters=25, ebn0_min=5.0,
                   ebn0_max=15.0, ebn0_step=1.0, n_err_min=10_000,
                   bits_sent_max=5_000_000, batch=16, seed=0, save_csv=True,
                   verbose=True, small=False, family="nr", device=None):
    """Coded BER vs Eb/N0 with CNC/MCNC before the LDPC decoder
    (``reference/main_cnc_mcnc_w_ldpc/main_mp_ldpc_cnc_ber_vs_ebn0.py``).
    ``family="nr"``: the 5G-NR code through the rate-matched transport
    chain (:func:`transport_coded_ber`); ``family="ira"``: the raw IRA
    codeword filling the frame (no CRC or rate matching), through the
    Monte-Carlo driver. Returns the :class:`SweepResult` (IRA) or
    ``(ebn0, ber, bler)`` (NR)."""
    from mimo_ofdm_tpu_torch.models.link_ldpc import code_for_modem, make_coded_round_fn
    if family == "nr":
        return transport_coded_ber(
            channel=channel, algorithm=algorithm, n_ant=n_ant, ibo_db=ibo_db,
            n_iters=n_iters, code_rate=code_rate, ldpc_iters=ldpc_iters,
            exact_payload=True, ebn0_min=ebn0_min, ebn0_max=ebn0_max,
            ebn0_step=ebn0_step, n_err_min=n_err_min, bits_sent_max=bits_sent_max,
            batch=batch, seed=seed, save_csv=save_csv, verbose=verbose, small=small,
            device=device)
    cfg = coded_link_config(channel, algorithm, n_ant, ibo_db, small)
    code = code_for_modem(cfg, code_rate=code_rate)
    round_fn = make_coded_round_fn(cfg, n_iters, batch, code, ldpc_iters=ldpc_iters,
                                   device=device)
    ebn0 = np.arange(ebn0_min, ebn0_max + ebn0_step / 2, ebn0_step)
    snrs = ebn0_to_snr(ebn0, cfg.modem.n_sub_carr, cfg.modem.n_sub_carr,
                       cfg.modem.constel_size)
    res = SweepResult(param_values=ebn0)
    for i, snr in enumerate(snrs):
        pt = run_point(round_fn, round_seed(seed, i), float(snr), n_counters=n_iters + 2,
                       n_bits_per_frame=code.k, batch=batch, n_err_min=n_err_min,
                       bits_sent_max=bits_sent_max)
        res.points.append(pt)
        if verbose:
            print(f"Eb/N0={ebn0[i]:5.1f}  coded BER={np.array2string(pt.ber, precision=4)}")
    if save_csv:
        fname = results.ber_sweep_filename(
            f"ldpc_r{code_rate:.2f}_ber_vs_ebn0", algorithm, channel, n_ant, ibo_db,
            ebn0, list(range(1, n_iters + 1)))
        results.save_ber_sweep(ebn0, res.ber_matrix, fname)
    return res


@register("transport_coded_ber")
def transport_coded_ber(channel="los", algorithm="cnc", n_ant=64, ibo_db=0.0,
                        n_iters=8, code_rate=0.5, n_blocks=4, rv=0,
                        ldpc_iters=25, ldpc_algorithm="minsum",
                        serial_decode=False, in_loop=False, nv_adjust=False,
                        exact_payload=False, csv_kind=None,
                        ebn0_min=5.0, ebn0_max=15.0, ebn0_step=1.0,
                        n_err_min=10_000, bits_sent_max=5_000_000, batch=16,
                        seed=0, save_csv=True, verbose=True, small=False, device=None):
    """Coded BER and BLER vs Eb/N0 through the full transport chain
    (CRC24A, segmentation + CRC24B, 5G-NR BG1/BG2 LDPC, rate matching) with
    CNC/MCNC before (or, ``in_loop``, inside) the decoder: the native
    equivalent of ``reference/main_cnc_mcnc_w_ldpc/mp_ldpc_model.py``'s
    MATLAB DL-SCH pipeline. ``exact_payload`` sizes the transport block as
    ``A = rate * n_bits_per_ofdm_sym`` (``mp_ldpc_model.py:99-100``);
    ``csv_kind`` overrides the CSV name prefix. Each point runs rounds under
    ``round_seed(seed, i)`` until every counter has ``n_err_min`` errors or
    ``bits_sent_max`` bits; a round's counters reach the host in one fetch.
    Returns ``(ebn0, ber, bler)``, each row ``[clean, it0..itN]``."""
    import time
    from mimo_ofdm_tpu_torch.models.link_ldpc import (make_transport_inloop_round_fn,
                                                      make_transport_round_fn,
                                                      reference_chain,
                                                      transport_chain_for_modem)
    cfg = coded_link_config(channel, algorithm, n_ant, ibo_db, small)
    modem = cfg.modem
    if exact_payload:
        chain = reference_chain(cfg, code_rate, rv)
    else:
        chain = transport_chain_for_modem(cfg, code_rate=code_rate, n_blocks=n_blocks, rv=rv)
    if verbose:
        print(f"transport chain: A={chain.a} C={chain.c} K'={chain.k_prime} "
              f"filler={chain.n_filler} E_cb={chain.e_cb} rate={chain.coded_rate:.3f}")
    if in_loop:
        if serial_decode or nv_adjust:
            raise ValueError("in_loop=True supports neither serial_decode nor nv_adjust; "
                             "drop those flags or use in_loop=False")
        round_fn = make_transport_inloop_round_fn(cfg, n_iters, batch, chain,
                                                  ldpc_iters=ldpc_iters,
                                                  ldpc_algorithm=ldpc_algorithm, device=device)
    else:
        round_fn = make_transport_round_fn(cfg, n_iters, batch, chain, ldpc_iters=ldpc_iters,
                                           ldpc_algorithm=ldpc_algorithm,
                                           serial_decode=int(serial_decode),
                                           nv_adjust=nv_adjust, device=device)
    ebn0 = np.arange(ebn0_min, ebn0_max + ebn0_step / 2, ebn0_step)
    snrs = ebn0_to_snr(ebn0, modem.n_sub_carr, modem.n_sub_carr, modem.constel_size)
    n_counters = n_iters + 2
    ber = np.zeros((n_counters, len(ebn0)))
    bler = np.zeros((n_counters, len(ebn0)))
    for i, snr in enumerate(snrs):
        key = round_seed(seed, i)
        errs = np.zeros(n_counters, np.int64)
        blks = np.zeros(n_counters, np.int64)
        bits = np.zeros(n_counters, np.int64)
        frames = np.zeros(n_counters, np.int64)
        rounds = 0
        t0 = time.perf_counter()
        while True:
            active = (errs < n_err_min) & (bits < bits_sent_max)
            if not active.any() or rounds >= 100_000:
                break
            c = round_fn(key, rounds, float(snr)).cpu().numpy().astype(np.int64)
            errs += np.where(active, c[:n_counters], 0)
            blks += np.where(active, c[n_counters:], 0)
            bits += np.where(active, batch * chain.a, 0)
            frames += np.where(active, batch, 0)
            rounds += 1
        ber[:, i] = errs / np.maximum(bits, 1)
        bler[:, i] = blks / np.maximum(frames, 1)
        if verbose:
            print(f"Eb/N0={ebn0[i]:5.1f}  rounds={rounds:4d} "
                  f"({time.perf_counter() - t0:.1f}s)  coded BER="
                  f"{np.array2string(ber[:, i], precision=4)}  BLER="
                  f"{np.array2string(bler[:, i], precision=3)}")
    if save_csv:
        kind = csv_kind or f"transport_r{code_rate:.2f}_C{chain.c}_rv{rv}"
        rest = (algorithm, channel, n_ant, ibo_db, ebn0, list(range(1, n_iters + 1)))
        results.save_ber_sweep(ebn0, ber, results.ber_sweep_filename(kind, *rest))
        results.save_ber_sweep(ebn0, bler, results.ber_sweep_filename(kind + "_bler", *rest))
    return ebn0, ber, bler


def _rate(code_rate_str: str) -> tuple[str, str, float]:
    num, den = code_rate_str.split("/")
    return num, den, float(num) / float(den)


@register("ldpc_ref_ber")
def ldpc_ref_ber(code_rate_str="1/2", channel="los", algorithm="cnc",
                 n_ant=16, ibo_db=0.0, n_iters=3, ldpc_iters=12,
                 ebn0_min=-5.0, ebn0_max=15.0, ebn0_step=2.0,
                 n_err_min=20_000, bits_sent_max=10_000_000, batch=16,
                 serial_decode=False, seed=0, save_csv=True, verbose=True,
                 small=False, device=None):
    """Reference-parity 5G-NR coded BER vs Eb/N0, the configuration of
    ``reference/main_cnc_mcnc_w_ldpc/main_mp_ldpc_cnc_ber_vs_ebn0.py``:
    payload ``A = rate * n_bits_per_ofdm_sym`` plus the TB CRC, 38.212
    base-graph selection, 12 sum-product iterations
    (``mp_ldpc_model.py:174-175``), rows clean + CNC passes 0..n_iters,
    under the reference's name ``ldpc_<num>_<den>_ber_vs_ebn0_...``.
    Returns ``(ebn0, ber)``."""
    num, den, rate = _rate(code_rate_str)
    ebn0, ber, _ = transport_coded_ber(
        channel=channel, algorithm=algorithm, n_ant=n_ant, ibo_db=ibo_db,
        n_iters=n_iters, code_rate=rate, rv=0, ldpc_iters=ldpc_iters,
        ldpc_algorithm="sumprod", exact_payload=True, serial_decode=serial_decode,
        csv_kind=f"ldpc_{num}_{den}_ber_vs_ebn0", ebn0_min=ebn0_min, ebn0_max=ebn0_max,
        ebn0_step=ebn0_step, n_err_min=n_err_min, bits_sent_max=bits_sent_max,
        batch=batch, seed=seed, save_csv=save_csv, verbose=verbose, small=small,
        device=device)
    return ebn0, ber


@register("ldpc_in_loop_ber")
def ldpc_in_loop_ber(code_rate_str="1/3", channel="los", algorithm="cnc",
                     n_ant=16, ibo_db=0.0, n_iters=3, ldpc_iters=12,
                     ebn0_min=-5.0, ebn0_max=4.0, ebn0_step=1.0,
                     n_err_min=20_000, bits_sent_max=10_000_000, batch=16,
                     seed=0, save_csv=True, verbose=True, small=False, device=None):
    """LDPC-in-the-loop CNC/MCNC coded BER vs Eb/N0 (the committed
    ``ldpc_in_loop_ber_vs_ebn0_{cnc,mcnc}_los_nant16_*`` results; see
    :func:`mimo_ofdm_tpu_torch.models.link_ldpc.make_transport_inloop_frame_fn`).
    Defaults are the committed files' grid and the configuration the JAX
    package pinned for them: rate 1/3, 12 sum-product iterations.
    Returns ``(ebn0, ber)``."""
    _, _, rate = _rate(code_rate_str)
    ebn0, ber, _ = transport_coded_ber(
        channel=channel, algorithm=algorithm, n_ant=n_ant, ibo_db=ibo_db,
        n_iters=n_iters, code_rate=rate, rv=0, ldpc_iters=ldpc_iters,
        ldpc_algorithm="sumprod", exact_payload=True, in_loop=True,
        csv_kind="ldpc_in_loop_ber_vs_ebn0", ebn0_min=ebn0_min, ebn0_max=ebn0_max,
        ebn0_step=ebn0_step, n_err_min=n_err_min, bits_sent_max=bits_sent_max,
        batch=batch, seed=seed, save_csv=save_csv, verbose=verbose, small=small,
        device=device)
    return ebn0, ber


@register("nvadj_ldpc_ber")
def nvadj_ldpc_ber(code_rate_str="3/4", channel="tdl_3gpp",
                   algorithm="cnc", n_ant=16, ibo_db=0.0, n_iters=3,
                   ldpc_iters=12, ebn0_min=-5.0, ebn0_max=15.0,
                   ebn0_step=2.0, n_err_min=20_000,
                   bits_sent_max=10_000_000, batch=16, serial_decode=16,
                   seed=0, save_csv=True, verbose=True, small=False, device=None):
    """Noise-variance-adjusted LLR coded BER (the committed
    ``nvadj_ldpc_3_4_ber_vs_ebn0_{cnc,mcnc}_*_nant16_*`` results): each
    pass's demapper variance is its measured residual error power, floored
    by the thermal term (:func:`mimo_ofdm_tpu_torch.models.link_ldpc.decoder_llr_nvadj`).
    The default channel is the TDL substitute of the committed files'
    Quadriga arm. Returns ``(ebn0, ber)``."""
    num, den, rate = _rate(code_rate_str)
    ebn0, ber, _ = transport_coded_ber(
        channel=channel, algorithm=algorithm, n_ant=n_ant, ibo_db=ibo_db,
        n_iters=n_iters, code_rate=rate, rv=0, ldpc_iters=ldpc_iters,
        ldpc_algorithm="sumprod", exact_payload=True, nv_adjust=True,
        serial_decode=serial_decode, csv_kind=f"nvadj_ldpc_{num}_{den}_ber_vs_ebn0",
        ebn0_min=ebn0_min, ebn0_max=ebn0_max, ebn0_step=ebn0_step, n_err_min=n_err_min,
        bits_sent_max=bits_sent_max, batch=batch, seed=seed, save_csv=save_csv,
        verbose=verbose, small=small, device=device)
    return ebn0, ber


@register("ldpc_table_sensitivity")
def ldpc_table_sensitivity(draws=(0, 1, 2), code_rate_str="1/2",
                           channel="los", algorithm="cnc", n_ant=16,
                           n_iters=3, ldpc_iters=12, ebn0_min=5.0,
                           ebn0_max=15.0, ebn0_step=2.0, n_err_min=20_000,
                           bits_sent_max=10_000_000, batch=16, seed=0,
                           verbose=True, small=False, device=None):
    """The NR-LDPC surrogate tables' effect apart from the decoder's: the
    reference-parity coded sweep on each surrogate base-graph draw in
    ``draws`` (sum-product, seed ``seed + draw``), plus min-sum on
    ``draws[0]``. Returns ``{label: (ebn0, ber)}``; the draw is reset to 0
    on the way out."""
    from mimo_ofdm_tpu_torch.ops import nr_ldpc
    _, _, rate = _rate(code_rate_str)
    common = dict(channel=channel, algorithm=algorithm, n_ant=n_ant, n_iters=n_iters,
                  code_rate=rate, rv=0, ldpc_iters=ldpc_iters, exact_payload=True,
                  ebn0_min=ebn0_min, ebn0_max=ebn0_max, ebn0_step=ebn0_step,
                  n_err_min=n_err_min, bits_sent_max=bits_sent_max, batch=batch,
                  save_csv=False, verbose=verbose, small=small, device=device)
    out = {}
    try:
        for d in draws:
            nr_ldpc.set_surrogate_draw(d)
            if verbose:
                print(f"--- surrogate draw {d} (sumprod) ---")
            ebn0, ber, _ = transport_coded_ber(ldpc_algorithm="sumprod", seed=seed + d,
                                               **common)
            out[f"draw{d}_sumprod"] = (ebn0, ber)
        nr_ldpc.set_surrogate_draw(draws[0])
        if verbose:
            print(f"--- surrogate draw {draws[0]} (minsum) ---")
        ebn0, ber, _ = transport_coded_ber(ldpc_algorithm="minsum", seed=seed, **common)
        out[f"draw{draws[0]}_minsum"] = (ebn0, ber)
    finally:
        nr_ldpc.set_surrogate_draw(0)
    return out
