"""SISO literature cross-checks, the reference's anchors against the Ochiai
CNC paper (IEEE 9445597) (port of ``mimo_ofdm_tpu/experiments/siso_checks.py``):

* ``siso_ser_vs_snr``: SER vs SNR of clipped SISO OFDM in AWGN
  (``reference/main_clipping_noise_cancellation/main_siso_cnc_reference_ser_vs_snr_check.py``);
* ``siso_rayleigh_zf_cnc``: SISO over a per-bin Rayleigh channel with a
  one-tap ZF equalizer before the CNC loop
  (``reference/main_clipping_noise_cancellation/main_siso_cnc_reference_rayleigh_zf_cnc.py``).

Conventions, as in the JAX package: the distorted run's noise is set
against ``avg_symbol_power * eta``, ``eta`` the measured in-band power ratio
of the clipped signal (``..._ser_vs_snr_check.py:75-96``); a symbol error
is any wrong bit of the symbol (``:134-138``); iteration taps [0, 1, 2, 3,
5, 12] with a clean run first (``:57-64``). The distorted signal is
equalized by the Bussgang alpha before detection, and the Rayleigh noise
scales with the mean channel power ``mean(|h|^2)``; the JAX module's
docstring (``mimo_ofdm_tpu/experiments/siso_checks.py:22-37``) says why
both depart from the committed, stale scripts.

The distorted chain and every CNC replica pass are launches of the fused
kernel in ``sc`` mode at float32 storage: ``n_iters + 2`` a round.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mimo_ofdm_tpu_torch.experiments import register
from mimo_ofdm_tpu_torch.models import receivers, transmit
from mimo_ofdm_tpu_torch.models.analysis import F32_CHAIN
from mimo_ofdm_tpu_torch.models.link import round_seed
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import noise as noise_ops
from mimo_ofdm_tpu_torch.ops import pa, qam
from mimo_ofdm_tpu_torch.utils import results
from mimo_ofdm_tpu_torch.utils.device import resolve_device


def _ser_from_bits(bits_tx: torch.Tensor, bits_rx: torch.Tensor, bps: int) -> torch.Tensor:
    """Symbol errors per frame: any wrong bit among a symbol's ``bps`` bits
    is one error (``..._ser_vs_snr_check.py:134-138``)."""
    tx = bits_tx.reshape(*bits_tx.shape[:-1], -1, bps)
    rx = bits_rx.reshape(*bits_rx.shape[:-1], -1, bps)
    return (tx != rx).any(-1).sum(-1, dtype=torch.int32)


def _sat(m: int, n_fft: int, n_sc: int, ibo_db: float) -> float:
    return pa.ibo_to_sat_power(ibo_db, qam.avg_symbol_power(m) * n_sc / n_fft)


def _measure_eta(m, n_fft, n_sc, ibo_db, n_frames=256, seed=99, device=None) -> float:
    """Empirical in-band power ratio of the clipped OFDM signal
    (``..._ser_vs_snr_check.py:75-96``), over ``n_frames`` frames: one
    launch."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sym = qam.modulate_bits(bits_ops.random_payload_bits(
        gen, (n_frames, n_sc * int(np.log2(m)))), m)
    in_band = transmit.ifft_pa_fft_sc(sym, n_fft, "softlim", _sat(m, n_fft, n_sc, ibo_db),
                                      **F32_CHAIN)
    return float((in_band.abs() ** 2).sum() / (n_frames * n_sc * qam.avg_symbol_power(m)))


class SisoDraws(NamedTuple):
    """Randoms of ``B`` SISO frames: ``fade [B, 2, n_sc]`` unit normals of
    the Rayleigh bins (None in AWGN), payload bits ``bits_c``/``bits_d [B,
    n_bits]`` of the clean and distorted runs, and their noise ``noise_c``/
    ``noise_d [B, 2, n_sc]`` (real, imaginary planes)."""
    fade: torch.Tensor | None
    bits_c: torch.Tensor
    bits_d: torch.Tensor
    noise_c: torch.Tensor
    noise_d: torch.Tensor

    @staticmethod
    def draw(batch: int, n_sc: int, n_bits: int, rayleigh: bool,
             generator: torch.Generator) -> "SisoDraws":
        dev = generator.device

        def normals():
            return torch.randn((batch, 2, n_sc), generator=generator, device=dev)
        fade = normals() if rayleigh else None
        return SisoDraws(fade, bits_ops.random_payload_bits(generator, (batch, n_bits)),
                         bits_ops.random_payload_bits(generator, (batch, n_bits)),
                         normals(), normals())


def _noise_amp(avg_pow: torch.Tensor, snr_db: float) -> torch.Tensor:
    """``sqrt(avg_pow / 10^(snr/10))`` as JAX forms it in float32; the power
    of ten in numpy float32, whose ``pow`` agrees with XLA's where torch's
    can be an ulp off (``models/link_ldpc.py::noise_var``)."""
    f32 = np.float32
    p = float(f32(10.0) ** (f32(snr_db) / f32(10.0)))
    return torch.sqrt(avg_pow / p)[..., None]


def _make_siso_frame_fn(m, n_fft, n_sc, ibo_db, n_iters, eta, rayleigh: bool, device=None):
    """``frame_fn(snr_db, draws) -> (clean_symb_err [B], dist_symb_err [B,
    n_iters + 1])`` over a batch of :class:`SisoDraws`."""
    dev = resolve_device(device)
    bps = int(np.log2(m))
    avg_sym_pow = qam.avg_symbol_power(m)
    sat = _sat(m, n_fft, n_sc, ibo_db)
    alpha = float(pa.bussgang_alpha(ibo_db))
    replica = receivers.make_cnc_replica(m, n_fft, n_sc, ibo_db, "softlim", **F32_CHAIN)

    def frame_fn(snr_db, draws: SisoDraws):
        b = draws.bits_d.shape[0]
        if rayleigh:
            h = noise_ops.complex_normal(draws.fade.to(dev))
            chan_pow = (h.abs() ** 2).mean(-1)
        else:
            h = torch.ones((b, n_sc), dtype=torch.complex64, device=dev)
            chan_pow = torch.ones(b, device=dev)

        # clean run: no distortion, alpha = 1
        bits_c = draws.bits_c.to(dev)
        sym_c = qam.modulate_bits(bits_c, m)
        noise_c = noise_ops.complex_normal(draws.noise_c.to(dev))
        rx_c = (h * sym_c + noise_c * _noise_amp(avg_sym_pow * chan_pow, snr_db)) / h
        clean_err = _ser_from_bits(bits_c, receivers.standard_receive_sc(rx_c, m), bps)

        # distorted run: clip, noise against the eta-scaled power, one-tap
        # ZF, the n_ant = 1 AGC equalizer, CNC
        bits_d = draws.bits_d.to(dev)
        dist_sc = transmit.ifft_pa_fft_sc(qam.modulate_bits(bits_d, m), n_fft, "softlim",
                                          sat, **F32_CHAIN)
        noise_d = noise_ops.complex_normal(draws.noise_d.to(dev))
        rx_d = (h * dist_sc
                + noise_d * _noise_amp(avg_sym_pow * chan_pow * eta, snr_db)) / h
        bits_all, _ = receivers.cnc_iterate(rx_d / alpha, n_iters, m, replica)
        return clean_err, _ser_from_bits(bits_d, bits_all, bps).T

    return frame_fn


def _run_siso_ser(rayleigh, snr_values, iters_lst, m, n_fft, n_sc, ibo_db, n_symb_err_min,
                  n_symb_sent_max, batch, seed, verbose, device=None):
    dev = resolve_device(device)
    eta = _measure_eta(m, n_fft, n_sc, ibo_db, device=dev)
    if verbose:
        print(f"eta power ratio: {eta:.4f} "
              f"(alpha^2 = {float(pa.bussgang_alpha(ibo_db)) ** 2:.4f})")
    n_iters = max(iters_lst)
    frame_fn = _make_siso_frame_fn(m, n_fft, n_sc, ibo_db, n_iters, eta, rayleigh, dev)
    n_bits = n_sc * int(np.log2(m))
    ser = np.zeros((len(iters_lst) + 1, len(snr_values)))
    for i, snr in enumerate(snr_values):
        clean_tot = 0
        dist_tot = np.zeros(n_iters + 1, np.int64)
        sent = 0
        r = 0
        while sent < n_symb_sent_max and dist_tot.min() < n_symb_err_min:
            gen = torch.Generator(device=dev).manual_seed(round_seed(round_seed(seed, i), r))
            c, d = frame_fn(float(snr), SisoDraws.draw(batch, n_sc, n_bits, rayleigh, gen))
            clean_tot += int(c.sum())
            dist_tot += d.sum(0).cpu().numpy().astype(np.int64)
            sent += batch * n_sc
            r += 1
        ser[0, i] = clean_tot / sent
        ser[1:, i] = dist_tot[list(iters_lst)] / sent
        if verbose:
            print(f"SNR={snr:5.1f}  SER(clean,{list(iters_lst)})="
                  f"{np.array2string(ser[:, i], precision=5)}")
    return ser


def _siso(rayleigh, kind, snr_min, snr_max, snr_step, iters, ibo_db, n_symb_err_min,
          n_symb_sent_max, batch, seed, save_csv, verbose, small, device):
    m, n_fft, n_sc = (64, 256, 128) if small else (64, 4096, 2048)
    snrs = np.arange(snr_min, snr_max + snr_step / 2, snr_step)
    ser = _run_siso_ser(rayleigh, snrs, tuple(iters), m, n_fft, n_sc, ibo_db,
                        n_symb_err_min, n_symb_sent_max, batch, seed, verbose, device)
    if save_csv:
        fname = (f"ser_vs_snr_siso_{kind}_ibo{int(ibo_db)}"
                 f"_snr_min{int(min(snrs))}_max{int(max(snrs))}"
                 f"_niter{'_'.join(str(i) for i in iters)}")
        results.save_ber_sweep(snrs, ser, fname)
    return snrs, ser


@register("siso_ser_vs_snr")
def siso_ser_vs_snr(snr_min=15.0, snr_max=31.0, snr_step=2.0, iters=(0, 1, 2, 3, 5, 12),
                    ibo_db=0.0, n_symb_err_min=10_000, n_symb_sent_max=1_000_000,
                    batch=64, seed=4321, save_csv=True, verbose=True, small=False,
                    device=None):
    """Clipped SISO OFDM SER vs SNR in AWGN, the Ochiai-paper anchor
    (``main_siso_cnc_reference_ser_vs_snr_check.py``; 64-QAM, n_fft 4096,
    n_sc 2048, IBO 0 dB, SNR 15-31 step 2). Returns QAM SER rows [clean,
    iters...]; the paper's PAM SER is ``1 - sqrt(1 - SER)``."""
    return _siso(False, "awgn_cnc", snr_min, snr_max, snr_step, iters, ibo_db,
                 n_symb_err_min, n_symb_sent_max, batch, seed, save_csv, verbose, small,
                 device)


@register("siso_rayleigh_zf_cnc")
def siso_rayleigh_zf_cnc(snr_min=15.0, snr_max=40.0, snr_step=5.0, iters=(0, 1, 2, 3, 5, 12),
                         ibo_db=0.0, n_symb_err_min=10_000, n_symb_sent_max=1_000_000,
                         batch=64, seed=4321, save_csv=True, verbose=True, small=False,
                         device=None):
    """Clipped SISO OFDM over per-bin Rayleigh fading with a one-tap ZF
    equalizer before the CNC loop (``main_siso_cnc_reference_rayleigh_zf_cnc.py``;
    SNR 15-40 step 5, fade rerolled every frame)."""
    return _siso(True, "rayleigh_zf_cnc", snr_min, snr_max, snr_step, iters, ibo_db,
                 n_symb_err_min, n_symb_sent_max, batch, seed, save_csv, verbose, small,
                 device)
