"""Diagnostic evaluations: alpha validation, complexity tables, PA transfer
characteristics, channel transfer functions, alpha vs per-antenna power and
the precoding/nonlinearity commutation check (port of
``mimo_ofdm_tpu/experiments/misc_evals.py``).

Same arguments and defaults as the JAX package's, plus ``device`` (``cuda``
unless ``"cpu"``); ``key(seed)`` becomes the generator seed ``seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from mimo_ofdm_tpu_torch.experiments import register
from mimo_ofdm_tpu_torch.models import analysis, precoding, transmit
from mimo_ofdm_tpu_torch.models.channels import los_channel
from mimo_ofdm_tpu_torch.models.link import link_static, make_channel_fn, round_seed
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import ofdm, pa
from mimo_ofdm_tpu_torch.utils.config import (ArrayConfig, ChannelConfig, LinkConfig,
                                              ModemConfig, PaConfig)
from mimo_ofdm_tpu_torch.utils.device import resolve_device


def _modem(small: bool, cp_len: int | None = None) -> ModemConfig:
    return ModemConfig(constel_size=64, n_fft=256 if small else 4096,
                       n_sub_carr=128 if small else 2048,
                       cp_len=cp_len or (16 if small else 128))


def _bits(seed: int, dev: torch.device, *shape) -> torch.Tensor:
    return bits_ops.random_payload_bits(torch.Generator(device=dev).manual_seed(seed), shape)


@register("alpha_eval")
def alpha_eval(n_ant=64, ibo_db=0.0, n_snapshots=64, seed=0, verbose=True, small=False,
               device=None):
    """Empirical per-antenna Bussgang alpha ``E[y x*] / E[x x*]`` of the TX
    signals against the analytic closed form, the reference's own
    validation study (``reference/main_misc_evals/main_alpha_dist_coefficient_eval.py:28-80``).
    JAX averages over the time samples; by Parseval (ortho transforms) the
    same ratio is ``sum_sc Y X* / sum_sc |X|^2`` over the data bins, since
    the clean frame is zero elsewhere, so all snapshots are one ``sc``-mode
    launch. Returns ``(alpha_analytic [n_ant], alpha_empirical [n_ant])``."""
    dev = resolve_device(device)
    cfg = LinkConfig(modem=_modem(small), array=ArrayConfig(n_elements=n_ant),
                     pa=PaConfig(model="softlim", ibo_db=ibo_db))
    n_sc = cfg.modem.n_sub_carr
    tx_pos, freqs, rx_base = link_static(cfg, dev)
    v = precoding.mrt_precoder(los_channel(
        tx_pos, rx_base, ofdm.extract_subcarriers(freqs, n_sc)))
    sat = precoding.pa_sat_power(ibo_db, cfg.modem.avg_sample_power, v)
    ak_analytic = precoding.per_antenna_alpha(
        ibo_db, precoding.precoding_power_per_antenna(v), n_sc, n_ant).cpu().numpy()
    y, x = analysis.tx_sc(_bits(seed, dev, n_snapshots, cfg.modem.n_bits_per_ofdm_sym),
                          v, cfg, sat)
    a = (y * torch.conj(x)).sum(-1) / (x.abs() ** 2).sum(-1)        # [S, n_ant]
    ak_emp = a.mean(0).abs().cpu().numpy()
    if verbose:
        print("alpha analytic (first 4):", ak_analytic[:4])
        print("alpha empirical (first 4):", ak_emp[:4])
        print("max |diff|:", np.max(np.abs(ak_emp - ak_analytic)))
    return ak_analytic, ak_emp


@register("complexity_eval")
def complexity_eval(m=64, n_u=2048, n=4096, k=64, iters=tuple(range(9)), verbose=True,
                    device=None):
    """Closed-form op-count tables for std/CNC/MCNC receivers
    (``reference/main_misc_evals/comp_complexity_eval.py``); host float64,
    ``device`` checked like every entry point's."""
    from mimo_ofdm_tpu_torch.models.complexity import cnc_ops, mcnc_ops, std_rx_ops
    resolve_device(device)
    std_add, std_mul = std_rx_ops(m, n_u, n)
    cnc_add, cnc_mul = cnc_ops(iters, m, n_u, n)
    mcnc_add, mcnc_mul = mcnc_ops(iters, m, n_u, n, k)
    if verbose:
        print(f"std: add/sc={std_add / n_u:.1f} mul/sc={std_mul / n_u:.1f}")
        for i, it in enumerate(iters):
            print(f"I={it}: cnc add/sc={cnc_add[i] / n_u:8.1f} "
                  f"mul/sc={cnc_mul[i] / n_u:8.1f}   "
                  f"mcnc add/sc={mcnc_add[i] / n_u:10.1f} "
                  f"mul/sc={mcnc_mul[i] / n_u:10.1f}")
    return {"std": (std_add, std_mul), "cnc": (cnc_add, cnc_mul), "mcnc": (mcnc_add, mcnc_mul)}


@register("pa_characteristics")
def pa_characteristics(model="softlim", ibo_db=0.0, avg_samp_pow=1.0, ampl_max=4.0,
                       n_points=200, verbose=True, device=None):
    """PA transfer characteristic samples
    (``reference/distortion.py:63-89,167-189,253-279``): ``(input
    amplitudes, output amplitudes)``."""
    dev = resolve_device(device)
    x = np.linspace(0.0, ampl_max, n_points)
    xc = torch.as_tensor(x + 0j, dtype=torch.complex64, device=dev)
    if model == "toi":
        y = pa.third_order(xc, pa.toi_to_cubic_coeff(ibo_db, avg_samp_pow))
    else:
        y = pa.apply_pa(xc, model, pa.ibo_to_sat_power(ibo_db, avg_samp_pow))
    y = y.abs().cpu().numpy()
    if verbose:
        print(f"{model} @ IBO {ibo_db} dB: out amp at max in = {y[-1]:.3f}")
    return x, y


@register("channel_tf")
def channel_tf(channel="two_path", n_ant=4, small=True, verbose=True, seed=0, device=None):
    """Channel transfer function ``[n_ant, n_fft]`` (complex64, on the
    device) of one draw, for inspection of its magnitude
    (``reference/main_misc_evals/channel_tf_test.py``,
    ``random_paths_channel_tf_test.py``)."""
    dev = resolve_device(device)
    cfg = LinkConfig(modem=_modem(small, cp_len=16), array=ArrayConfig(n_elements=n_ant),
                     channel=ChannelConfig(model=channel))
    tx_pos, freqs, rx_base = link_static(cfg, dev)
    d = analysis.draw_snapshots(cfg, torch.Generator(device=dev).manual_seed(seed), 1,
                                cfg.modem.n_fft, reroll=False)
    h = make_channel_fn(cfg, freqs, rx_base, reroll=False)(tx_pos, d)
    h = h.expand(1, n_ant, cfg.modem.n_fft)[0]
    if verbose:
        mag = h.abs()
        print(f"{channel}: |H| mean={float(mag.mean()):.3e} "
              f"min={float(mag.min()):.3e} max={float(mag.max()):.3e}")
    return h


@register("alpha_vs_tx_pow")
def alpha_vs_tx_pow(n_ant=64, ibo_db=0.0, n_snapshots=256,
                    channels_lst=("rayleigh", "two_path", "los"), seed=0,
                    save_csv=True, verbose=True, small=False, device=None):
    """Per-antenna empirical Bussgang lambda vs per-antenna TX power
    (``reference/main_misc_evals/main_alpha_vs_tx_pow_per_ant_eval.py``):
    MRT precoding spreads the power unevenly, so each PA runs at its own IBO
    ``10 log10(P_sat / P_tx,k)`` (``:121``), and the lambda estimate
    ``|E[Y X*] / E[|X|^2]|`` per antenna (``:105-111``) must land on the
    analytic ``alpha(IBO)`` curve. One launch per channel. Returns
    ``(ibo_per_ant [n_chan, n_ant], lam [n_chan, n_ant], ibo_range,
    alpha_analytic)``."""
    dev = resolve_device(device)
    cfg = LinkConfig(modem=_modem(small), array=ArrayConfig(n_elements=n_ant),
                     pa=PaConfig(model="softlim", ibo_db=ibo_db))
    n_fft, n_sc = cfg.modem.n_fft, cfg.modem.n_sub_carr
    tx_pos, freqs, rx_base = link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    ibo_per_ant = np.zeros((len(channels_lst), n_ant))
    lam = np.zeros((len(channels_lst), n_ant))
    for ci, chan in enumerate(channels_lst):
        gen = torch.Generator(device=dev).manual_seed(round_seed(seed, ci))
        fade = analysis._normals(gen, 2, n_ant, n_sc)
        v = precoding.mrt_precoder(analysis._point_channel(chan, fade, tx_pos, rx_base,
                                                           freqs_sc))
        sat = precoding.pa_sat_power(ibo_db, cfg.modem.avg_sample_power, v)
        y, x = analysis.tx_sc(bits_ops.random_payload_bits(
            gen, (n_snapshots, cfg.modem.n_bits_per_ofdm_sym)), v, cfg, sat)
        num = (y * torch.conj(x)).mean(-1)
        den = (x.abs() ** 2).mean(-1)
        p_tx = (x.abs() ** 2).sum(-1) / n_fft
        lam[ci] = (num / den).mean(0).abs().cpu().numpy()
        ibo_per_ant[ci] = 10.0 * np.log10(float(sat) / p_tx.mean(0).cpu().numpy())
        if verbose:
            print(f"{chan:9s}: per-ant IBO {ibo_per_ant[ci].min():.2f}.."
                  f"{ibo_per_ant[ci].max():.2f} dB, lambda "
                  f"{lam[ci].min():.4f}..{lam[ci].max():.4f}")
    ibo_range = np.linspace(ibo_per_ant.min(), ibo_per_ant.max(), 100)
    alpha_analytic = pa.bussgang_alpha(ibo_range).numpy()
    if save_csv:
        from mimo_ofdm_tpu_torch.utils import results
        data = [ibo_per_ant[ci] for ci in range(len(channels_lst))]
        data += [lam[ci] for ci in range(len(channels_lst))]
        results.save_to_csv(data, f"alpha_vs_tx_pow_per_ant_nant{n_ant}_ibo{int(ibo_db)}")
    return ibo_per_ant, lam, ibo_range, alpha_analytic


@register("precoding_nl_commutation")
def precoding_nl_commutation(ibo_db=0.0, phase_cycles=10.0, n_frames=64, small=True,
                             verbose=True, seed=0, device=None):
    """Does the PA nonlinearity commute with phase-only precoding?
    (``reference/main_misc_evals/precoding_after_nl_test.py``, which forces
    a unit-magnitude channel with a frequency-swept phase, ``:72-96``.)

    The distorted-constellation EVM of a phase-precoded frame for three
    precoders: ``"none"``; ``"flat"``, one common phase on every subcarrier
    (a pure phase rotation of every time sample, so the clipping is the
    same and the EVM matches ``"none"`` to rounding); ``"swept"``, a phase
    spanning ``phase_cycles`` cycles across the band (it changes the
    time-domain envelope, so the distortion differs). The same frames for
    every variant, one launch each. Returns ``{name: evm}``."""
    from mimo_ofdm_tpu_torch.ops import metrics, qam
    dev = resolve_device(device)
    modem = ModemConfig(constel_size=64, n_fft=256 if small else 1024,
                        n_sub_carr=128 if small else 512, cp_len=16 if small else 128)
    m, n_fft, n_sc = modem.constel_size, modem.n_fft, modem.n_sub_carr
    sat = pa.ibo_to_sat_power(ibo_db, modem.avg_sample_power)
    alpha = float(pa.bussgang_alpha(ibo_db))
    k = np.arange(n_sc)
    phases = {"none": np.zeros(n_sc), "flat": np.full(n_sc, 0.7),
              "swept": 2.0 * np.pi * phase_cycles * k / n_sc}
    bits = _bits(seed, dev, n_frames, modem.n_bits_per_ofdm_sym)
    sym = qam.modulate_bits(bits, m)
    out = {}
    for name, ph in phases.items():
        ph = torch.as_tensor(ph, dtype=torch.float32, device=dev)
        v = torch.polar(torch.ones_like(ph), ph)[None, :]
        fd = transmit.array_transmit_sc(bits, constel_size=m, n_fft=n_fft, v=v,
                                        pa_model="softlim", sat_power=sat,
                                        **analysis.F32_CHAIN)
        # undo the precoder phase and the Bussgang shrink, then measure the
        # residual clipping-distortion EVM
        eq = fd[:, 0] * torch.conj(v[0]) / alpha
        out[name] = float(metrics.evm_rms(eq, sym).mean())
        if verbose:
            print(f"precoder {name:5s}: distorted EVM = {out[name]:.5f}")
    if verbose:
        print("flat-phase EVM equals baseline (distortion commutes with a "
              "common phase); swept-phase EVM differs (it does not commute "
              "with frequency-selective phase)")
    return out
