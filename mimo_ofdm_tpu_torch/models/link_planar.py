"""Planar (split real/imag) link frame: the port's main path
(port of ``mimo_ofdm_tpu/models/link_planar.py``).

One call simulates a batch of independent frames. A leading batch
dimension ``B`` replaces JAX's ``vmap``, so the per-frame scalars
(saturation power, AGC noise scalers) are ``[B]`` tensors and the
per-antenna gains ``[B, n_ant]``.

* The Rayleigh fade, the MRT precoder and the per-antenna TX signals are
  real/imag planes in the storage dtype (bfloat16 or float32); every
  cross-antenna reduction accumulates in float32.
* The distorted TX, and the MCNC replica on every pass, run
  ``extract_sc(FFT(PA(IFFT(map_sc(.)))))`` over all ``B x n_ant`` rows in one
  launch of the fused CUDA kernel (``kernels/fused_pa.py``); the CNC
  replica runs it over ``B`` rows.

Randoms: JAX's threefry stream cannot be reproduced, so a frame takes its
randoms as a :class:`FrameDraws` -- drawn from a ``torch.Generator`` on the
frame's device (:meth:`FrameDraws.draw`), or handed in, e.g. the JAX
package's own draws (:meth:`FrameDraws.from_numpy`).

Reference semantics: fade reroll per frame (``reference/mp_model.py:140-154``),
AGC/noise scalers (``reference/mp_model.py:290-329``), constant-IBO PA
recalibration (``reference/antenna_array.py:313-360``).
"""

from __future__ import annotations

import math

import torch

from mimo_ofdm_tpu_torch.kernels.fused_pa import check_shapes
from mimo_ofdm_tpu_torch.models import channels, receivers, transmit
from mimo_ofdm_tpu_torch.models.link import (FrameCounters, FrameDraws,
                                              link_static)
from mimo_ofdm_tpu_torch.models.precoding import per_antenna_alpha
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import noise as noise_ops
from mimo_ofdm_tpu_torch.ops import ofdm, pa
from mimo_ofdm_tpu_torch.ops.fused_chain import (fused_sc_ifft_pa_fft_planar_io,
                                                 storage_dtype)
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device


def planar_eligible(cfg: LinkConfig) -> bool:
    """True when the planar path covers this config (the JAX package's
    gate, with the TPU matmul-tiling check replaced by the kernel's own
    shape contract)."""
    try:
        check_shapes(cfg.modem.n_fft, cfg.modem.n_sub_carr, "sc")
    except ValueError:
        return False
    return (cfg.modem.n_users == 1
            and not cfg.csi_epsilon
            and cfg.csi_snr_db is None
            and cfg.precoding == "mrt"
            and cfg.channel.model in ("rayleigh", "los", "two_path")
            and cfg.rx.algorithm in ("cnc", "mcnc", "none")
            and cfg.use_mxu_fft)


def _channel_planes_fn(cfg: LinkConfig, freqs_sc: torch.Tensor,
                       rx_base: torch.Tensor, tx_pos: torch.Tensor,
                       st: torch.dtype):
    """Planar channel generator ``fade_normals [B, 2, n_ant, n_sc] ->
    (hr, hi)`` in ``st``. Rayleigh = IID CN(0,1) x free-space attenuation
    at the base RX position (``reference/channel.py:234-251``); the
    attenuation does not depend on the frame and is computed once."""
    model = cfg.channel.model
    if model in ("los", "two_path"):
        raise NotImplementedError(
            f"the planar {model!r} channel (_factored_cos_sin) is not ported "
            "yet (ROADMAP queue 1: LOS and two-path planes)")
    if model != "rayleigh":
        raise ValueError(f"planar path does not cover channel {model!r}")
    if cfg.channel.skip_attenuation:
        scale = torch.full((), math.sqrt(0.5), dtype=torch.float32,
                           device=freqs_sc.device)
    else:
        d = channels._distances(tx_pos, rx_base)
        scale = channels._fs_attenuation(d, freqs_sc) * math.sqrt(0.5)
    scale = scale.to(st)

    def planes(fade: torch.Tensor):
        fade = fade.to(st)
        return fade[:, 0] * scale, fade[:, 1] * scale

    return planes


def make_planar_frame_fn(cfg: LinkConfig, n_iters: int, *,
                         incl_clean: bool = True, storage: str = "bfloat16",
                         device=None):
    """Planar twin of :func:`mimo_ofdm_tpu_torch.models.link.make_frame_fn`:
    ``frame_fn(snr_db, draws=None, *, batch=None, generator=None) ->
    FrameCounters`` over a batch of frames on ``device`` (``cuda`` unless
    ``device="cpu"``). Without ``draws`` the frame draws ``batch`` frames
    from ``generator``. ``storage`` is the plane dtype, ``"bfloat16"`` or
    ``"float32"``. Each frame's Rayleigh fade is its own draw, so the
    channel is rerolled every frame."""
    if not planar_eligible(cfg):
        raise ValueError(f"config is not planar-eligible: {cfg}")
    st = storage_dtype(storage)
    dev = resolve_device(device)
    m = cfg.modem.constel_size
    n_fft, n_sc = cfg.modem.n_fft, cfg.modem.n_sub_carr
    n_ant = cfg.array.n_elements
    avg_sym_pow = cfg.modem.avg_symbol_power
    avg_samp_pow = cfg.modem.avg_sample_power
    pa_model = cfg.pa.model
    ibo_db = cfg.pa.ibo_db
    if pa_model == "toi":
        alpha_override = cfg.pa.alpha_estimate
    elif pa_model == "none":
        alpha_override = 1.0
    else:
        alpha_override = None

    tx_pos, freqs, rx_base = link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    channel_planes = _channel_planes_fn(cfg, freqs_sc, rx_base, tx_pos, st)
    if cfg.rx.algorithm == "cnc":
        cnc_replica = receivers.make_cnc_replica(
            m, n_fft, n_sc, ibo_db, pa_model, alpha=alpha_override,
            rapp_p=cfg.pa.rapp_p_hardness, storage=cfg.mxu_fft_storage)

    def f32sum(x, dim):
        return x.sum(dim, dtype=torch.float32)

    def frame_fn(snr_db, draws: FrameDraws | None = None, *,
                 batch: int | None = None,
                 generator: torch.Generator | None = None) -> FrameCounters:
        if draws is None:
            draws = FrameDraws.draw(cfg, batch, generator, st)
        hr, hi = channel_planes(draws.fade.to(dev))     # [B, n_ant, n_sc] st

        # MRT precoder V = conj(H) / sqrt(sum_ant |H|^2)
        # (reference/antenna_array.py:167-171), f32 norm accumulation
        rsn = torch.rsqrt(f32sum(hr * hr + hi * hi, -2))[:, None, :]
        vr = (hr * rsn).to(st)
        vi = (-hi * rsn).to(st)

        # constant-IBO bookkeeping (reference/mp_model.py:290-329)
        vk_pow = f32sum(vr * vr + vi * vi, -1)           # [B, n_ant] f32
        if alpha_override is not None:
            ak = torch.full_like(vk_pow, alpha_override)
        else:
            ak = per_antenna_alpha(ibo_db, vk_pow, n_sc, n_ant)
        hvr_t = hr * vr - hi * vi                        # H o V terms, st
        hvi_t = hr * vi + hi * vr
        hv_r, hv_i = f32sum(hvr_t, -2), f32sum(hvi_t, -2)   # [B, n_sc] f32
        akhv_r = f32sum(ak[..., None] * hvr_t, -2)
        akhv_i = f32sum(ak[..., None] * hvi_t, -2)
        hv = torch.complex(hv_r, hv_i)
        akhv = torch.complex(akhv_r, akhv_i)
        hv_noise_scaler = (hv_r * hv_r + hv_i * hv_i).mean(-1)       # [B]
        akhv_noise_scaler = (akhv_r * akhv_r + akhv_i * akhv_i).mean(-1)

        # PA saturation power under constant IBO (reference/antenna_array.py:313-360)
        avg_gain = vk_pow.sum(-1) / (n_ant * n_sc)
        sat_pow = 10.0 ** (ibo_db / 10.0) * avg_samp_pow * avg_gain   # [B]
        toi_coeff = (pa.toi_to_cubic_coeff(ibo_db, avg_samp_pow * avg_gain)
                     if pa_model == "toi" else torch.zeros_like(sat_pow))

        # clean run (reference/mp_model.py:136-175): without the PA the TX
        # (I)FFT round trip is the identity, so propagation reduces to the
        # combined H o V vector
        if incl_clean:
            bits_c = draws.bits_c.to(dev)
            sym_c = transmit.modulate_users(bits_c, m)
            noise_c = noise_ops.complex_normal(draws.noise_c.to(dev))
            rx_c = noise_ops.awgn(sym_c * hv, snr_db,
                                  avg_sym_pow * hv_noise_scaler, noise_c)
            rx_bits_c = receivers.standard_receive_sc(rx_c / hv, m)
            clean_err = bits_ops.count_bit_errors(bits_c, rx_bits_c, axis=-1)
        else:
            clean_err = torch.zeros(hv.shape[0], dtype=torch.int32, device=dev)

        # distorted run (reference/mp_model.py:180-222), all planar
        def tx_propagate(sym: torch.Tensor) -> torch.Tensor:
            """Precode -> fused IFFT/PA/FFT over B x n_ant rows -> channel
            combine, for ``[B, n_sc]`` complex symbols; shared by the
            distorted TX and the MCNC replica
            (``reference/corrector.py:198-205``)."""
            sr = sym.real.to(st)[:, None, :]
            si = sym.imag.to(st)[:, None, :]
            pr = sr * vr - si * vi                       # [B, n_ant, n_sc] st
            pi_ = sr * vi + si * vr
            fr, fi = fused_sc_ifft_pa_fft_planar_io(
                pr, pi_, n_fft, pa_model=pa_model, sat=sat_pow[:, None],
                cubic_coeff=toi_coeff[:, None], rapp_p=cfg.pa.rapp_p_hardness,
                storage=storage)
            # propagate: sum_ant H o X (reference/channel.py:74-89), f32 accum
            return torch.complex(f32sum(hr * fr - hi * fi, -2),
                                 f32sum(hr * fi + hi * fr, -2))

        bits_d = draws.bits_d.to(dev)
        sym_d = transmit.modulate_users(bits_d, m)
        noise_d = noise_ops.complex_normal(draws.noise_d.to(dev))
        rx_d = noise_ops.awgn(tx_propagate(sym_d), snr_db,
                              avg_sym_pow * akhv_noise_scaler, noise_d)
        rx_sc = rx_d / akhv

        if cfg.rx.algorithm == "cnc":
            bits_all, _ = receivers.cnc_iterate(rx_sc, n_iters, m, cnc_replica)
        elif cfg.rx.algorithm == "mcnc":
            # MCNC replica = the same planar TX chain + AGC divide
            bits_all, _ = receivers.cnc_iterate(
                rx_sc, n_iters, m, lambda det_sym: tx_propagate(det_sym) / akhv)
        else:  # "none"
            one = receivers.standard_receive_sc(rx_sc, m)
            bits_all = one.expand(n_iters + 1, *one.shape)

        dist_err = bits_ops.count_bit_errors(bits_d, bits_all, axis=-1)
        return FrameCounters(clean_err=clean_err, dist_err=dist_err.T.contiguous())

    return frame_fn
