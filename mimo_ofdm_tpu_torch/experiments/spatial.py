"""Spatial experiments: beampatterns, SDR vs IBO, channel correlations, PSDs
(port of ``mimo_ofdm_tpu/experiments/spatial.py``).

Same arguments, defaults, CSV names and cell formats as the JAX package's,
plus ``device`` (``cuda`` unless ``"cpu"``). A JAX key ``key(seed)`` becomes
the generator seed ``seed``, and ``fold_in(key(seed), i)`` becomes
``round_seed(seed, i)``.
"""

from __future__ import annotations

import numpy as np
import torch

from mimo_ofdm_tpu_torch.experiments import register
from mimo_ofdm_tpu_torch.models import analysis
from mimo_ofdm_tpu_torch.models import precoding as prec
from mimo_ofdm_tpu_torch.models.channels import los_channel, propagate
from mimo_ofdm_tpu_torch.models.geometry import pts_on_semicircum, pts_on_semisphere
from mimo_ofdm_tpu_torch.models.link import link_static, make_channel_fn, round_seed
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import ofdm, pa
from mimo_ofdm_tpu_torch.utils import results
from mimo_ofdm_tpu_torch.utils.config import (ArrayConfig, ChannelConfig, LinkConfig,
                                              ModemConfig, PaConfig)
from mimo_ofdm_tpu_torch.utils.device import resolve_device


def _cfg(n_ant, ibo_db, geometry="linear", chan="los", small=False,
         n_rows=1, n_cols=1, pa_model="softlim", n_users=1):
    modem = ModemConfig(constel_size=64, n_fft=256 if small else 4096,
                        n_sub_carr=128 if small else 2048,
                        cp_len=16 if small else 128, n_users=n_users)
    return LinkConfig(modem=modem,
                      array=ArrayConfig(geometry=geometry, n_elements=n_ant,
                                        n_rows=n_rows, n_cols=n_cols),
                      channel=ChannelConfig(model=chan),
                      pa=PaConfig(model=pa_model, ibo_db=ibo_db))


@register("beampattern")
def beampattern(n_ant_values=(1, 2, 4, 8, 16, 32, 64), ibo_db=0.0,
                precoding_angle_deg=45.0, n_points=180, n_snapshots=100,
                geometry="linear", seed=0, save_csv=True, verbose=True,
                small=False, device=None):
    """Desired/distortion radiation patterns per antenna count
    (``reference/main_beampatterns_plotting/main_mrt_precoding_radiation_pattern.py``)."""
    out = {}
    for n_ant in n_ant_values:
        cfg = _cfg(n_ant, ibo_db, geometry, small=small)
        res = analysis.beampattern_scan(cfg, seed=seed,
                                        precoding_angle_deg=precoding_angle_deg,
                                        n_points=n_points, n_snapshots=n_snapshots,
                                        device=device)
        out[n_ant] = res
        if verbose:
            sdr = res.sdr_db
            print(f"n_ant={n_ant:3d}  SDR min/max = {sdr.min():.2f}/{sdr.max():.2f} dB")
        if save_csv:
            fname = (f"mrt_radiation_pattern_{geometry}_ibo{int(ibo_db)}"
                     f"_npoints{n_points}_nsnap{n_snapshots}"
                     f"_angle{int(precoding_angle_deg)}_nant{n_ant}")
            results.save_to_csv([res.angles_rad, res.desired_pow, res.distortion_pow], fname)
    return out


@register("mrt_radiation_pattern")
def mrt_radiation_pattern(channels=("los", "two_path", "rayleigh"),
                          n_ant_values=(1, 2, 4, 8, 16, 32, 64, 128),
                          ibo_db=3.0, precoding_angle_deg=45.0,
                          psd_angle_deg=78.0, n_points=180, n_snapshots=100,
                          radial_distance=300.0, n_samp_per_seg=1024,
                          seed=0, save_csv=True, verbose=True, small=False, device=None):
    """Reference-parity MRT radiation-pattern study with per-angle Welch
    PSDs (``reference/main_beampatterns_plotting/main_mrt_precoding_radiation_pattern.py``;
    committed ground truth
    ``psd_mrt_*_chan_ibo3_npoints180_nsnap100_angle{45,78}_nant*`` and
    ``mrt_sig_powers_vs_angle_*``). Per (channel, n_ant) writes the 4-row
    PSD CSVs (freq/psd desired, freq/psd distortion) at both angles and the
    cumulative desired+distortion powers-vs-angle CSV: one python-list cell
    per antenna count so far, as the reference saves inside its loop."""
    out = {}
    for chan in channels:
        des_per_nant, dist_per_nant = [], []
        for n_ant in n_ant_values:
            cfg = _cfg(n_ant, ibo_db, chan=chan, small=small)
            res = analysis.radiation_pattern(
                cfg, seed=seed, precoding_angle_deg=precoding_angle_deg,
                psd_angle_deg=psd_angle_deg, n_points=n_points,
                n_snapshots=n_snapshots, radial_distance=radial_distance,
                n_samp_per_seg=min(n_samp_per_seg, cfg.modem.n_fft // 4), device=device)
            des_per_nant.append(res.desired_pow)
            dist_per_nant.append(res.distortion_pow)
            out[(chan, n_ant)] = res
            if verbose:
                sdr = 10 * np.log10(res.desired_pow / res.distortion_pow)
                print(f"{chan} n_ant={n_ant:3d}  SDR@prec="
                      f"{sdr[int(round(n_points / 180 * precoding_angle_deg))]:.2f} dB"
                      f"  min={sdr.min():.2f} dB")
            if save_csv:
                for ang in (precoding_angle_deg, psd_angle_deg):
                    f, p_des, p_dist = res.psd[float(ang)]
                    results.save_to_csv(
                        [f, p_des, f, p_dist],
                        results.psd_filename(chan, ibo_db, n_points, n_snapshots, ang, n_ant))
                # the reference's cell format, read back with ast.literal_eval
                # (reference/msc_figures/multiuser_mrt_precoding.py:51-53)
                results.save_to_csv(
                    [[p.tolist() for p in des_per_nant], [p.tolist() for p in dist_per_nant]],
                    results.sig_powers_filename(chan, ibo_db, n_points, n_snapshots,
                                                precoding_angle_deg, n_ant))
    return out


@register("mu_radiation_pattern")
def mu_radiation_pattern(channel="two_path", n_ant_values=(8, 16, 128),
                         usr_angles=(45.0, 120.0, 150.0), ibo_db=3.0,
                         psd_angle_deg=78.0, n_points=180, n_snapshots=10,
                         radial_distance=300.0, n_samp_per_seg=2048,
                         seed=0, save_csv=True, verbose=True, small=False, device=None):
    """Multi-user MRT radiation pattern and per-angle PSD: joint MRT toward
    several semicircle angles, desired/distortion powers over the scan
    (committed ground truth ``multiuser_mrt_sig_powers_vs_angle_*`` /
    ``multiuser_psd_mrt_*``; consumer
    ``reference/msc_figures/multiuser_mrt_precoding.py:30-70``: 3 users at
    45/120/150 deg, two-path, IBO 3 dB)."""
    out = {}
    for n_ant in n_ant_values:
        cfg = _cfg(n_ant, ibo_db, chan=channel, small=small, n_users=len(usr_angles))
        res = analysis.radiation_pattern(
            cfg, seed=seed, precoding_angles_deg=tuple(usr_angles),
            psd_angle_deg=psd_angle_deg, n_points=n_points, n_snapshots=n_snapshots,
            radial_distance=radial_distance,
            n_samp_per_seg=min(n_samp_per_seg, cfg.modem.n_fft // 2), device=device)
        out[n_ant] = res
        if verbose:
            sdr = 10 * np.log10(res.desired_pow / res.distortion_pow)
            idxs = [int(round(n_points / 180 * a)) for a in usr_angles]
            print(f"{channel} n_ant={n_ant:3d}  SDR@users="
                  f"{np.array2string(sdr[idxs], precision=2)} dB")
        if save_csv:
            f, p_des, p_dist = res.psd[float(psd_angle_deg)]
            results.save_to_csv(
                [f, p_des, f, p_dist],
                results.psd_filename(channel, ibo_db, n_points, n_snapshots, psd_angle_deg,
                                     n_ant, prefix="multiuser_psd_mrt"))
            results.save_to_csv(
                [[res.desired_pow.tolist()], [res.distortion_pow.tolist()]],
                results.sig_powers_filename(channel, ibo_db, n_points, n_snapshots,
                                            psd_angle_deg, n_ant, prefix="multiuser_mrt"))
    return out


@register("mu_sinr")
def mu_sinr(n_users=8, n_ant=128, ibo_db=0.0, precoding="zf", n_snapshots=16, seed=0,
            verbose=True, small=False, device=None):
    """Per-user SDR/SINR of the nonlinear MU downlink (e.g. 8 users x 128
    antennas; cf. the per-user SDR table of
    ``reference/main_multiuser/main_multiuser_cnc_ber_vs_ebn0.py:184-258``)."""
    from mimo_ofdm_tpu_torch.models.link_mu import spread_user_positions
    cfg = _cfg(n_ant, ibo_db, small=small)
    sdr, sinr = analysis.mu_sinr_sdr(cfg, spread_user_positions(n_users), seed=seed,
                                     n_snapshots=n_snapshots, precoding_kind=precoding,
                                     device=device)
    if verbose:
        print("user  SDR[dB]  SINR[dB]")
        for u in range(n_users):
            print(f"{u:4d}  {sdr[u]:7.2f}  {sinr[u]:8.2f}")
    return sdr, sinr


@register("evm_vs_ibo")
def evm_vs_ibo(n_ant=64, ibo_values=(0.0, 2.0, 4.0, 6.0, 8.0), channel="los",
               n_snapshots=16, seed=0, save_csv=True, verbose=True, small=False,
               device=None):
    """RMS EVM of the equalized received constellation vs IBO (the EVM
    counterpart of the BER/SDR sweeps); the same frames at every IBO. One
    launch per IBO."""
    from mimo_ofdm_tpu_torch.models import agc as agc_mod
    from mimo_ofdm_tpu_torch.ops import qam
    from mimo_ofdm_tpu_torch.ops.metrics import evm_rms
    dev = resolve_device(device)
    evms = []
    for ibo in ibo_values:
        ibo = float(ibo)
        cfg = _cfg(n_ant, ibo, chan=channel, small=small)
        n_sc = cfg.modem.n_sub_carr
        tx_pos, freqs, rx_base = link_static(cfg, dev)
        chan_fn = make_channel_fn(cfg, ofdm.extract_subcarriers(freqs, n_sc), rx_base,
                                  reroll=False)
        d = analysis.draw_snapshots(cfg, torch.Generator(device=dev).manual_seed(seed),
                                    n_snapshots, n_sc, reroll=False)
        h_sc = chan_fn(tx_pos, d).expand(n_snapshots, n_ant, n_sc)
        v = prec.mrt_precoder(h_sc)
        sat = prec.pa_sat_power(ibo, cfg.modem.avg_sample_power, v)
        agc = agc_mod.compute_agc_sc(h_sc, v, ibo, n_ant)
        fd, _ = analysis.tx_sc(d.bits, v, cfg, sat[:, None])
        rx = propagate(h_sc, fd) / agc.ak_hk_vk_agc_sc
        vals = evm_rms(rx, qam.modulate_bits(d.bits, cfg.modem.constel_size))
        evms.append(float(torch.sqrt(torch.mean(vals ** 2))))
        if verbose:
            print(f"IBO={ibo:4.1f} dB  EVM={evms[-1] * 100:.2f}%")
    if save_csv:
        results.save_to_csv([np.asarray(ibo_values, float), np.asarray(evms)],
                            f"evm_vs_ibo_{channel}_nant{n_ant}")
    return np.asarray(ibo_values, float), np.asarray(evms)


@register("sdr_vs_ibo")
def sdr_vs_ibo(channels=("los", "two_path", "rayleigh"), n_ant_values=(1, 4, 16, 32, 64),
               ibo_min=0.0, ibo_max=8.01, ibo_step=0.25, ibo_values=None, n_snapshots=500,
               rx_pos=(212.0, 212.0, 1.5), seed=0, save_csv=True, verbose=True,
               small=False, device=None):
    """SDR vs IBO per antenna count per channel model
    (``reference/main_beampatterns_plotting/main_sdr_vs_ibo_vs_channel.py``;
    committed ground truth ``sdr_vs_ibo_per_channel_ibo0to8_1_4_16_32_64nant.csv``:
    the IBO grid, then nant-major x [los, two_path, rayleigh] rows of the
    linear SDR, each the mean over 500 channel-rerolled snapshots).
    Returns the IBO grid and the dB-mean SDRs."""
    if ibo_values is None:
        ibo_values = np.arange(ibo_min, ibo_max, ibo_step)
    ibo_values = np.asarray(ibo_values, float)
    sdr = np.zeros((len(n_ant_values), len(channels), len(ibo_values)))
    sdr_lin = np.zeros_like(sdr)
    for ai, n_ant in enumerate(n_ant_values):
        for ci, chan in enumerate(channels):
            cfg = _cfg(int(n_ant), 0.0, chan=chan, small=small)
            sdr[ai, ci], sdr_lin[ai, ci] = analysis.sdr_vs_ibo_curve(
                cfg, ibo_values, rx_pos, seed=round_seed(seed, 100 * ai + ci),
                n_snapshots=n_snapshots, device=device)
            if verbose:
                print(f"nant{n_ant} {chan}: SDR[dB] = "
                      f"{np.array2string(sdr[ai, ci], precision=2)}")
    if save_csv:
        # the committed reference CSV stores *linear* SDR ratios (its
        # replot layer applies to_db)
        nants = "_".join(str(int(v)) for v in n_ant_values)
        data = [ibo_values]
        for ai in range(len(n_ant_values)):
            data.extend(sdr_lin[ai, ci] for ci in range(len(channels)))
        results.save_to_csv(
            data, f"sdr_vs_ibo_per_channel_ibo{int(min(ibo_values))}"
                  f"to{int(max(ibo_values))}_{nants}nant")
    return ibo_values, sdr


def _planar_user_position(azim_deg, elev_deg, dist, center):
    """User position from (azimuth, elevation) per the reference's planar
    MU script (``reference/main_planar_rectangular_array/
    main_multiuser_planar_rectangular_array_beampatterns.py:41-48``)."""
    az = np.deg2rad(azim_deg + 90.0)
    el = np.deg2rad(elev_deg + 90.0)
    return (-dist * np.sin(el) * np.cos(az) + center[0],
            -dist * np.sin(el) * np.sin(az) + center[1],
            -dist * np.cos(el) + center[2])


@register("mu_beampattern")
def mu_beampattern(n_ant=64, ibo_db=0.0, usr_angles_deg=(-30.0, 30.0),
                   radial_distance=300.0, n_points=180, n_snapshots=32,
                   precoding="mrt", geometry="linear", n_rows=1, n_cols=1,
                   pa_model="softlim", seed=0, save_csv=True, verbose=True,
                   small=False, device=None):
    """Multi-user distortion radiation pattern for any array geometry.

    * ``geometry="linear"``/``"circular"``: 2-user semicircle scan; with MU
      precoding the third-order clipping products beamform toward
      ``2 theta_1 - theta_2`` and ``2 theta_2 - theta_1``
      (``reference/main_multiuser/2_users_{ula,uca}_distortion_angles_prediction.py``).
      ``usr_angles_deg`` are scan angles; returns ``(angles_rad
      [n_points+1], desired, distortion, predicted_dirs)``.
    * ``geometry="planar"`` (URA ``n_rows x n_cols``): semisphere scan with
      users at ``(azimuth, elevation)`` pairs
      (``reference/main_planar_rectangular_array/
      main_multiuser_planar_rectangular_array_beampatterns.py``);
      with ``pa_model="toi"`` ``ibo_db`` is the TOI in dB and the Bussgang
      gain is estimated from the frames (``:123-177``). Returns
      ``(az_el_grid_deg, desired [g, g], distortion [g, g], None)``.

    The frames are the same at every point, so they are transmitted once
    (one launch); the gain estimate reads the same frames."""
    dev = resolve_device(device)
    planar = geometry == "planar"
    if planar and n_rows * n_cols != n_ant:
        n_rows = n_cols = int(np.sqrt(n_ant))
    usr_angles = [tuple(np.atleast_1d(a)) for a in usr_angles_deg]
    n_usr = len(usr_angles)
    cfg = _cfg(n_ant, ibo_db, geometry=geometry, small=small, n_rows=n_rows,
               n_cols=n_cols, pa_model=pa_model, n_users=n_usr)
    n_sc = cfg.modem.n_sub_carr
    tx_pos, freqs, _ = link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    center = (0.0, 0.0, cfg.array.cord_z)

    if planar:
        pts = pts_on_semisphere(radial_distance, n_points, center)
        grid = int(np.sqrt(n_points))
        angles = np.linspace(0.0, 180.0, grid)       # az == el grid [deg]
        usr_pos = [_planar_user_position(a[0], a[-1], radial_distance, center)
                   for a in usr_angles]
    else:
        pts2d = pts_on_semicircum(radial_distance, n_points)
        pts = np.concatenate([pts2d, np.full((len(pts2d), 1), 1.5)], axis=1)
        angles = np.radians(np.linspace(-90, 90, n_points + 1))
        usr_pos = [pts[int(n_points / 180 * (a[0] + 90))] for a in usr_angles]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    h_usr = los_channel(tx_pos, f32(usr_pos), freqs_sc)   # [U, n_ant, n_sc]
    v = prec.make_precoder(precoding, n_usr)(h_usr)                # [n_ant, U, n_sc]
    toi = pa_model == "toi"
    if toi:
        # ibo_db is the TOI point; the cubic coefficient against the precoded
        # average power (reference/distortion.py:228 with update_distortion's rescale)
        sat = 1.0
        toi_coeff = pa.toi_to_cubic_coeff(
            ibo_db, cfg.modem.avg_sample_power * prec.avg_precoding_gain(v, multi_user=True))
    else:
        sat = prec.pa_sat_power(ibo_db, cfg.modem.avg_sample_power, v,
                                     multi_user=True)
        toi_coeff = 0.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = bits_ops.random_payload_bits(
        gen, (n_snapshots, n_usr, cfg.modem.n_bits_per_ofdm_sym))
    dist, clean = analysis.tx_sc(bits, v, cfg, sat, toi_coeff, sum_users=True)
    if toi:
        # per-antenna empirical Bussgang gain |avg_sc(tx conj(clean) /
        # |clean|^2)|, averaged over snapshots (reference planar script
        # :144-173, before the channel)
        ak = (dist * torch.conj(clean) / (clean.abs() ** 2)).mean(-1).abs().mean(0)
        if verbose:
            print(f"empirical alpha: mean={float(ak.mean()):.4f}")
    else:
        ak = prec.per_antenna_alpha(
            ibo_db, prec.precoding_power_per_antenna(v, multi_user=True), n_sc, n_ant)
    pts_t = f32(pts)
    d_pow, e_pow = analysis.shared_frame_powers(
        dist, clean, ak, (los_channel(tx_pos, pts_t[lo:lo + 16], freqs_sc)
                          for lo in range(0, len(pts), 16)))
    if planar:
        d_pow = d_pow.reshape(grid, grid)
        e_pow = e_pow.reshape(grid, grid)
        pred = None
        if verbose:
            pk = np.unravel_index(np.argmax(d_pow), d_pow.shape)
            print(f"desired peak at az={angles[pk[0]]:.0f} el={angles[pk[1]]:.0f} deg")
    else:
        flat = [a[0] for a in usr_angles]
        pred = (sorted([2 * flat[0] - flat[1], 2 * flat[1] - flat[0]])
                if n_usr == 2 else None)
        if verbose and pred:
            print(f"predicted intermod distortion directions: {pred} deg")
    if save_csv:
        tag = f"{geometry}_" if geometry != "linear" else ""
        results.save_to_csv(
            [np.ravel(angles), d_pow.ravel(), e_pow.ravel()],
            f"mu_radiation_pattern_{tag}{precoding}_nant{n_ant}_ibo{int(ibo_db)}")
    return angles, d_pow, e_pow, pred


@register("channel_corr")
def channel_corr(channels=("los", "two_path", "rayleigh"),
                 n_ant_values=(2, 4, 8, 16, 32, 64, 128),
                 main_usr_angle_deg=45.0, main_user_dist=300.0, n_points=180,
                 seed=0, save_csv=True, verbose=True, small=False, device=None):
    """Channel-matrix correlation coefficient vs angle per antenna count and
    channel model (``reference/main_multiuser/multiuser_channel_mat_correlation.py``)."""
    out = {}
    for chan in channels:
        rows = []
        for n_ant in n_ant_values:
            cfg = _cfg(n_ant, 0.0, chan=chan, small=small)
            angles, corr = analysis.channel_mat_correlation_scan(
                cfg, seed=seed, main_usr_angle_deg=main_usr_angle_deg,
                main_user_dist=main_user_dist, n_points=n_points, device=device)
            rows.append(corr)
            if verbose:
                print(f"{chan} n_ant={n_ant:3d}  corr@main="
                      f"{corr[int(round(n_points / 180 * main_usr_angle_deg))]:.3f}"
                      f"  corr min={corr.min():.3f}")
        out[chan] = (angles, np.stack(rows))
        if save_csv:
            nant_str = "_".join(str(v) for v in n_ant_values)
            results.save_to_csv(
                [angles, *rows],
                f"channel_mat_corr_coeff_{chan}_distance{int(main_user_dist)}"
                f"_angle{int(main_usr_angle_deg)}_nant{nant_str}")
    return out


@register("spatial_corr")
def spatial_corr(channels=("los", "two_path", "rayleigh"),
                 n_ant_values=(2, 4, 8, 16, 32, 64),
                 main_usr_angle_deg=45.0, main_user_dist=300.0, n_points=36,
                 seed=0, save_csv=True, verbose=True, small=False, device=None):
    """MRT beampattern (spatial) correlation vs precoding angle
    (``reference/main_multiuser/multiuser_channel_spatial_correlation.py``)."""
    out = {}
    for chan in channels:
        rows = []
        for n_ant in n_ant_values:
            cfg = _cfg(n_ant, 0.0, chan=chan, small=small)
            angles, corr = analysis.spatial_correlation_scan(
                cfg, seed=seed, main_usr_angle_deg=main_usr_angle_deg,
                main_user_dist=main_user_dist, n_points=n_points, device=device)
            rows.append(corr)
            if verbose:
                print(f"{chan} n_ant={n_ant:3d}  spatial corr min={corr.min():.3f}")
        out[chan] = (angles, np.stack(rows))
        if save_csv:
            nant_str = "_".join(str(v) for v in n_ant_values)
            results.save_to_csv(
                [angles, *rows],
                f"channel_spatial_corr_coeff_{chan}_distance{int(main_user_dist)}"
                f"_angle{int(main_usr_angle_deg)}_nant{nant_str}")
    return out


@register("psd_eval")
def psd_eval(n_ant=64, ibo_db=0.0, pa_model="softlim", n_snapshots=32,
             psd_nfft=128, n_samp_per_seg=64, seed=0, save_csv=True,
             verbose=True, small=False, device=None):
    """Desired vs distortion PSD at the precoded point on LOS
    (``reference/main_beampatterns_plotting/main_mrt_precoding_radiation_pattern.py:181-200``
    and ``reference/main_misc_evals/main_awgn_psd_ber_eval.py``, whose SISO
    all-PA-models sweep is ``--n-ant 1 --pa-model {softlim,rapp,toi}``).
    All snapshots are one ``full``-mode launch."""
    dev = resolve_device(device)
    cfg = _cfg(n_ant, ibo_db, pa_model=pa_model, small=small)
    n_sc = cfg.modem.n_sub_carr
    tx_pos, freqs, rx_base = link_static(cfg, dev)
    h = los_channel(tx_pos, rx_base, freqs)
    v = prec.mrt_precoder(ofdm.extract_subcarriers(h, n_sc))
    sat = prec.pa_sat_power(ibo_db, cfg.modem.avg_sample_power, v)
    # TOI: ibo_db is the intercept point vs the precoded average power
    # (reference/distortion.py:222-228)
    toi_coeff = (pa.toi_to_cubic_coeff(
        ibo_db, cfg.modem.avg_sample_power * prec.avg_precoding_gain(v))
        if pa_model == "toi" else 0.0)
    ak = prec.per_antenna_alpha(ibo_db, prec.precoding_power_per_antenna(v),
                                     n_sc, n_ant)
    bits = bits_ops.random_payload_bits(
        torch.Generator(device=dev).manual_seed(seed),
        (n_snapshots, cfg.modem.n_bits_per_ofdm_sym))
    f, p_des, p_dist = analysis.combined_psd(cfg, bits, v, h, ak, sat, psd_nfft,
                                             n_samp_per_seg, toi_coeff)
    if verbose:
        gap = 10 * np.log10(p_des.mean() / p_dist.mean())
        print(f"mean desired/distortion PSD gap: {gap:.2f} dB")
    if save_csv:
        results.save_to_csv([f, p_des, p_dist], f"psd_mrt_los_ibo{int(ibo_db)}_nant{n_ant}")
    return f, p_des, p_dist


@register("mu_sdr_vs_angle")
def mu_sdr_vs_angle(n_ant=16, ibo_db=0.0, main_angle_deg=60.0, user_dist=300.0,
                    n_points=180, n_snapshots=2, channel="los", seed=0, save_csv=True,
                    verbose=True, small=False, device=None):
    """Two-user SDR and channel correlation vs the secondary user's angle
    (``reference/main_multiuser/main_two_users_sdr_vs_angle_overlap.py``),
    with the worst-case angle of ``main_two_users_wc_angle_vs_precoding_angle.py``:
    the angle (other than the main user's own) of the main user's lowest SDR."""
    cfg = _cfg(n_ant, ibo_db, chan=channel, small=small)
    angles, corr, sdr = analysis.mu_angle_overlap_scan(
        cfg, seed=seed, main_angle_deg=main_angle_deg, user_dist=user_dist,
        n_points=n_points, n_snapshots=n_snapshots, device=device)
    main_idx = int(round(n_points / 180.0 * main_angle_deg))
    off = np.ones(len(angles), bool)
    off[main_idx] = False
    wc_idx = int(np.argmin(np.where(off, sdr[0], np.inf)))
    if verbose:
        print(f"main user @ {main_angle_deg:.0f} deg: SDR there = "
              f"{sdr[0, main_idx]:.2f} dB, corr there = {corr[main_idx]:.4f}")
        print(f"worst-case secondary angle = {angles[wc_idx]:.1f} deg "
              f"(main SDR {sdr[0, wc_idx]:.2f} dB, corr {corr[wc_idx]:.4f})")
    if save_csv:
        results.save_to_csv(
            [angles, corr, sdr[0], sdr[1]],
            f"mu_sdr_vs_angle_{channel}_nant{n_ant}_ibo{int(ibo_db)}"
            f"_main{int(main_angle_deg)}_npoints{n_points}_nsnap{n_snapshots}")
    return angles, corr, sdr


@register("mu_sdr_vs_nusers")
def mu_sdr_vs_nusers(n_users_values=(1, 2, 3, 4, 5), n_ant=32, ibo_min=0.0, ibo_max=7.01,
                     ibo_step=0.25, ibo_values=None, n_snapshots=100, radial_dist=300.0,
                     angular_margin=10.0, channel="los", seed=0, save_csv=True,
                     verbose=True, small=False, device=None):
    """Per-user SDR vs IBO vs number of simultaneously served users
    (``reference/main_multiuser/main_multiuser_sdr_vs_ibo_vs_n_users.py``:
    LOS, 32-antenna ULA, IBO 0..7 step 0.25, 100 random-placement snapshots
    a point). Returns ``{n_users: sdr_db [n_ibo, n_users]}``; the CSV holds
    the IBO grid then, scenario-major, one row per user."""
    if ibo_values is None:
        ibo_values = np.arange(ibo_min, ibo_max, ibo_step)
    ibo_values = np.asarray(ibo_values, float)
    out = {}
    for si, n_users in enumerate(n_users_values):
        cfg = _cfg(n_ant, 0.0, chan=channel, small=small)
        run = analysis.make_mu_nusers_sdr_fn(cfg, int(n_users), radial_dist=radial_dist,
                                             angular_margin=angular_margin,
                                             n_snapshots=n_snapshots, device=device)
        sdr = run(ibo_values, seed=round_seed(seed, si))
        out[int(n_users)] = sdr
        if verbose:
            print(f"n_users={n_users}: mean-user SDR "
                  f"{sdr.mean(1)[0]:.2f} dB @ IBO {ibo_values[0]:.2f} -> "
                  f"{sdr.mean(1)[-1]:.2f} dB @ IBO {ibo_values[-1]:.2f}")
    if save_csv:
        nusrs = "_".join(str(int(v)) for v in n_users_values)
        data = [ibo_values]
        for n_users in n_users_values:
            data.extend(out[int(n_users)][:, u] for u in range(int(n_users)))
        results.save_to_csv(
            data, f"multiuser_sdr_per_usr_vs_ibo_ibo{int(min(ibo_values))}"
                  f"to{int(max(ibo_values))}_{n_ant}nant_nsnap{n_snapshots}_nusrs{nusrs}")
    return out
