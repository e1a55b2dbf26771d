"""Planar (split real/imag) link frame: the port's main path
(port of ``mimo_ofdm_tpu/models/link_planar.py``).

One call simulates a batch of independent frames. A leading batch
dimension ``B`` replaces JAX's ``vmap``, so the per-frame scalars
(saturation power, AGC noise scalers) are ``[B]`` tensors and the
per-antenna gains ``[B, n_ant]``.

* The channel (Rayleigh fade, or the LOS / two-path phase planes), the MRT
  precoder and the per-antenna TX signals are real/imag planes in the
  storage dtype (bfloat16 or float32); every cross-antenna reduction
  accumulates in float32.
* The LOS and two-path planes come from :func:`_factored_cos_sin`: two
  small cos/sin tables per antenna and one angle-addition pass, instead of
  a sin and a cos per antenna and subcarrier.
* The distorted TX, and the MCNC replica on every pass, run
  ``extract_sc(FFT(PA(IFFT(map_sc(s o V)))))`` over all ``B x n_ant`` rows in
  one launch of the fused CUDA kernel (``kernels/fused_pa.py``), whose load
  computes the MRT precode ``s o V`` from the symbols and the precoder's
  planes; the CNC replica runs the chain over ``B`` rows.
* The antenna combine ``sum_ant H o X`` after the chain is one launch of
  the combine kernel (``kernels/antenna_combine.py``) on bf16 planes on
  CUDA, and the eager expression on any other planes.

Randoms: JAX's threefry stream cannot be reproduced, so a frame takes its
randoms as a :class:`FrameDraws` -- drawn from a ``torch.Generator`` on the
frame's device (:meth:`FrameDraws.draw`), or handed in, e.g. the JAX
package's own draws (:meth:`FrameDraws.from_numpy`).

Reference semantics: fade / RX-position reroll per frame
(``reference/mp_model.py:140-154``), AGC/noise scalers
(``reference/mp_model.py:290-329``), constant-IBO PA recalibration
(``reference/antenna_array.py:313-360``).
"""

from __future__ import annotations

import math

import torch

from mimo_ofdm_tpu_torch.kernels.antenna_combine import antenna_combine, antenna_combine_plain
from mimo_ofdm_tpu_torch.models import channels, receivers, transmit
from mimo_ofdm_tpu_torch.models.geometry import C_LIGHT
from mimo_ofdm_tpu_torch.models.link import (FrameCounters, FrameDraws,
                                              bussgang_override, frame_signature,
                                              link_static, rx_positions)
from mimo_ofdm_tpu_torch.models.precoding import per_antenna_alpha
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import noise as noise_ops
from mimo_ofdm_tpu_torch.ops import ofdm, pa
from mimo_ofdm_tpu_torch.ops.fused_chain import (fused_sc_precoded_ifft_pa_fft_planar_io,
                                                 kernel_eligible, storage_dtype)
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device
from mimo_ofdm_tpu_torch.utils.spans import OFF, enabled, span


def planar_eligible(cfg: LinkConfig) -> bool:
    """True when the planar path covers this config (the JAX package's
    gate, with the TPU matmul-tiling check replaced by the kernel's own
    shape contract)."""
    return (kernel_eligible(cfg.modem.n_fft, cfg.modem.n_sub_carr, "sc")
            and cfg.modem.n_users == 1
            and not cfg.csi_epsilon
            and cfg.csi_snr_db is None
            and cfg.precoding == "mrt"
            and cfg.channel.model in ("rayleigh", "los", "two_path")
            and cfg.rx.algorithm in ("cnc", "mcnc", "none")
            and cfg.use_mxu_fft)


def _factored_cos_sin(w: torch.Tensor, center_freq: float, df: float,
                      n_sc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``cos/sin(w[..., None] * freqs_sc)`` on the data-subcarrier grid,
    ``[..., n_ant] -> [..., n_ant, n_sc]``, with O(n_ant (Q + R))
    transcendentals instead of O(n_ant n_sc)
    (``mimo_ofdm_tpu/models/link_planar.py:69-114``).

    The grid is ``f_k = fc + df k`` for ``k`` in ``[-n_sc/2..-1, 1..n_sc/2]``.
    The contiguous part ``k = R q + r - n_sc/2`` splits the phase as
    ``A[a, q] + B[a, r]``, and the planes are angle-addition products of
    two small tables. The straggler ``k = +n_sc/2`` is computed directly
    and the DC column is dropped. Every phase is formed in float32 in the
    JAX package's operation order: at the canonical ~2e4 rad one float32
    ulp is ~2e-3 rad, so another order would move the planes."""
    half = n_sc // 2
    R = 64

    def grid(lo, hi):
        return torch.arange(lo, hi, dtype=torch.float32, device=w.device)

    if n_sc % R or n_sc < 2 * R:
        theta_neg = w[..., None] * (center_freq + df * grid(-half, 0))
        theta_pos = w[..., None] * (center_freq + df * grid(1, half + 1))
        theta = torch.cat([theta_neg, theta_pos], dim=-1)
        return torch.cos(theta), torch.sin(theta)
    q_grid = df * (R * grid(0, n_sc // R) - half)
    th_a = w[..., None] * (center_freq + q_grid)              # [..., n_ant, Q]
    th_b = (w * df)[..., None] * grid(0, R)                   # [..., n_ant, R]
    th_x = w * (center_freq + df * half)                      # [..., n_ant]
    ca, sa = torch.cos(th_a)[..., :, None], torch.sin(th_a)[..., :, None]
    cb, sb = torch.cos(th_b)[..., None, :], torch.sin(th_b)[..., None, :]
    cos_c = (ca * cb - sa * sb).reshape(*w.shape, n_sc)
    sin_c = (sa * cb + ca * sb).reshape(*w.shape, n_sc)
    # contiguous k order -> SC layout [k=-half..-1 | k=1..half-1 | k=half]
    cos_sc = torch.cat([cos_c[..., :half], cos_c[..., half + 1:],
                        torch.cos(th_x)[..., None]], dim=-1)
    sin_sc = torch.cat([sin_c[..., :half], sin_c[..., half + 1:],
                        torch.sin(th_x)[..., None]], dim=-1)
    return cos_sc, sin_sc


def _channel_planes_fn(cfg: LinkConfig, freqs_sc: torch.Tensor,
                       rx_base: torch.Tensor, tx_pos: torch.Tensor,
                       reroll: bool, st: torch.dtype):
    """Planar channel generator ``draws -> (hr, hi)``, ``[B, n_ant, n_sc]``
    in ``st`` (``mimo_ofdm_tpu/models/link_planar.py:117-191``).

    Rayleigh = IID CN(0,1) x free-space attenuation at the base RX position
    (``reference/channel.py:234-251``); its attenuation does not depend on
    the frame and is computed once. LOS = phase at the (rerolled) RX
    position x attenuation (``reference/channel.py:35-72``); two-path adds
    the ground reflection (``reference/channel.py:116-167``). Without the
    reroll the geometric planes are the same every frame and are computed
    once."""
    model = cfg.channel.model
    skip_att = cfg.channel.skip_attenuation
    inv_freqs = 1.0 / freqs_sc
    fc, df = cfg.center_freq, cfg.carrier_spacing
    n_sc = cfg.modem.n_sub_carr

    if model == "rayleigh":
        if skip_att:
            scale = torch.full((), math.sqrt(0.5), dtype=torch.float32,
                               device=freqs_sc.device)
        else:
            d = channels._distances(tx_pos, rx_base)
            scale = channels._fs_attenuation(d, freqs_sc) * math.sqrt(0.5)
        scale = scale.to(st)

        def rayleigh_planes(draws: FrameDraws):
            fade = draws.fade.to(device=freqs_sc.device, dtype=st)
            return fade[:, 0] * scale, fade[:, 1] * scale

        return rayleigh_planes
    if model not in ("los", "two_path"):
        raise ValueError(f"planar path does not cover channel {model!r}")

    def path_planes(d):
        """Factored-phase planes x free-space attenuation for one path at
        distances ``d [..., n_ant]``. The attenuation ``c/(4 pi d f)``
        splits as ``(c/(4 pi d)) (1/f)``, with the static ``1/f`` row."""
        cos_sc, sin_sc = _factored_cos_sin((2.0 * math.pi / C_LIGHT) * d,
                                           fc, df, n_sc)
        if skip_att:
            return cos_sc, sin_sc
        att = ((C_LIGHT / (4.0 * math.pi)) / d[..., None]) * inv_freqs
        return cos_sc * att, sin_sc * att

    def geometric(rx_pos):
        d_los = channels._distances(tx_pos, rx_pos)
        hr, hi = path_planes(d_los)
        if model == "two_path":
            # the ground reflection, coefficient -1
            sr, si = path_planes(channels._mirror_distances(tx_pos, rx_pos))
            hr, hi = hr - sr, hi - si
        return hr.to(st), hi.to(st)

    fixed = []

    def geometric_planes(draws: FrameDraws):
        batch = draws.batch
        if reroll:
            return geometric(rx_positions(rx_base, draws.loc))
        if not fixed:
            fixed.extend(geometric(rx_base[None]))
        return tuple(p.expand(batch, -1, -1) for p in fixed)

    return geometric_planes


def make_planar_frame_fn(cfg: LinkConfig, n_iters: int, *,
                         incl_clean: bool = True, reroll: bool = True,
                         storage: str = "bfloat16", ibo_as_arg: bool = False,
                         device=None):
    """Planar twin of :func:`mimo_ofdm_tpu_torch.models.link.make_frame_fn`:
    ``frame_fn(snr_db, draws=None, *, batch=None, generator=None) ->
    FrameCounters`` over a batch of frames on ``device`` (``cuda`` unless
    ``device="cpu"``). Without ``draws`` the frame draws ``batch`` frames
    from ``generator``. ``storage`` is the plane dtype, ``"bfloat16"`` or
    ``"float32"``. ``reroll`` moves the RX of the geometric channels per
    frame (the Rayleigh fade is always a fresh draw). ``ibo_as_arg=True``
    gives ``frame_fn(snr_db, ibo_db, draws=None, ...)``: the IBO, a Python
    float, is taken per call, and the saturation power, Bussgang gains, AGC
    scalers and CNC replica follow it."""
    with span("setup.frame_fn"):
        return _build_planar_frame_fn(cfg, n_iters, incl_clean, reroll, storage,
                                      ibo_as_arg, device)


def _build_planar_frame_fn(cfg: LinkConfig, n_iters: int, incl_clean: bool,
                           reroll: bool, storage: str, ibo_as_arg: bool, device):
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
    alpha_override = bussgang_override(cfg)

    tx_pos, freqs, rx_base = link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    channel_planes = _channel_planes_fn(cfg, freqs_sc, rx_base, tx_pos,
                                        reroll, st)

    def f32sum(x, dim):
        return x.sum(dim, dtype=torch.float32)

    # the combine kernel takes bf16 planes on CUDA; other planes combine eagerly
    kernel_combine = st == torch.bfloat16 and dev.type == "cuda"
    combine = antenna_combine if kernel_combine else antenna_combine_plain

    def draw(batch: int, generator: torch.Generator) -> FrameDraws:
        return FrameDraws.draw(cfg, batch, generator, st, reroll=reroll)

    def _frame(snr_db, ibo_db: float, draws: FrameDraws | None,
               batch: int | None, generator: torch.Generator | None
               ) -> FrameCounters:
        with (span("frame", frames=batch if draws is None else draws.batch)
              if enabled() else OFF):
            return _stages(snr_db, float(ibo_db), draws, batch, generator)

    def _stages(snr_db, ibo_db: float, draws: FrameDraws | None,
                batch: int | None, generator: torch.Generator | None
                ) -> FrameCounters:
        if draws is None:
            draws = draw(batch, generator)
        with span("frame.channel"):
            hr, hi = channel_planes(draws)               # [B, n_ant, n_sc] st

        with span("frame.precoder"):
            # MRT precoder V = conj(H) / sqrt(sum_ant |H|^2)
            # (reference/antenna_array.py:167-171), f32 norm accumulation
            rsn = torch.rsqrt(f32sum(hr * hr + hi * hi, -2))[:, None, :]
            vr = (hr * rsn).to(st)
            vi = (-hi * rsn).to(st)

            # constant-IBO bookkeeping (reference/mp_model.py:290-329)
            vk_pow = f32sum(vr * vr + vi * vi, -1)       # [B, n_ant] f32
            if alpha_override is not None:
                ak = torch.full_like(vk_pow, alpha_override)
            else:
                ak = per_antenna_alpha(ibo_db, vk_pow, n_sc, n_ant)
            hvr_t = hr * vr - hi * vi                    # H o V terms, st
            hvi_t = hr * vi + hi * vr
            hv_r, hv_i = f32sum(hvr_t, -2), f32sum(hvi_t, -2)   # [B, n_sc] f32
            akhv_r = f32sum(ak[..., None] * hvr_t, -2)
            akhv_i = f32sum(ak[..., None] * hvi_t, -2)
            hv = torch.complex(hv_r, hv_i)
            akhv = torch.complex(akhv_r, akhv_i)
            hv_noise_scaler = (hv_r * hv_r + hv_i * hv_i).mean(-1)       # [B]
            akhv_noise_scaler = (akhv_r * akhv_r + akhv_i * akhv_i).mean(-1)

            # PA saturation power under constant IBO
            # (reference/antenna_array.py:313-360)
            avg_gain = vk_pow.sum(-1) / (n_ant * n_sc)
            sat_pow = 10.0 ** (ibo_db / 10.0) * avg_samp_pow * avg_gain   # [B]
            toi_coeff = (pa.toi_to_cubic_coeff(ibo_db, avg_samp_pow * avg_gain)
                         if pa_model == "toi" else torch.zeros_like(sat_pow))

        # clean run (reference/mp_model.py:136-175): without the PA the TX
        # (I)FFT round trip is the identity, so propagation reduces to the
        # combined H o V vector
        with span("frame.clean"):
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
            combine, for ``[B, n_sc]`` complex64 symbols; shared by the
            distorted TX and the MCNC replica
            (``reference/corrector.py:198-205``). The precode ``s o V`` runs
            in the kernel's load; the precoded planes are never written."""
            with span("tx.precode"):
                s = sym.contiguous()
            rows = vr.shape[0] * vr.shape[1]
            with span("chain", rows=rows, precoded=rows) if enabled() else OFF:
                fr, fi = fused_sc_precoded_ifft_pa_fft_planar_io(
                    s, vr, vi, n_fft, pa_model=pa_model, sat=sat_pow[:, None],
                    cubic_coeff=toi_coeff[:, None], rapp_p=cfg.pa.rapp_p_hardness,
                    storage=storage)
            # propagate: sum_ant H o X (reference/channel.py:74-89), f32 accum
            with (span("tx.combine", combined=sym.shape[0] if kernel_combine else 0)
                  if enabled() else OFF):
                return combine(hr, hi, fr, fi)

        bits_d = draws.bits_d.to(dev)
        sym_d = transmit.modulate_users(bits_d, m)
        tx_d = tx_propagate(sym_d)
        with span("frame.awgn"):
            noise_d = noise_ops.complex_normal(draws.noise_d.to(dev))
            rx_d = noise_ops.awgn(tx_d, snr_db, avg_sym_pow * akhv_noise_scaler, noise_d)
            rx_sc = rx_d / akhv

        if cfg.rx.algorithm == "cnc":
            replica = receivers.make_cnc_replica(
                m, n_fft, n_sc, ibo_db, pa_model, alpha=alpha_override,
                rapp_p=cfg.pa.rapp_p_hardness, use_mxu_fft=True,
                mxu_storage=cfg.mxu_fft_storage)
            bits_all, _ = receivers.cnc_iterate(rx_sc, n_iters, m, replica)
        elif cfg.rx.algorithm == "mcnc":
            # MCNC replica = the same planar TX chain + AGC divide
            bits_all, _ = receivers.cnc_iterate(
                rx_sc, n_iters, m, lambda det_sym: tx_propagate(det_sym) / akhv)
        else:  # "none"
            one = receivers.standard_receive_sc(rx_sc, m)
            bits_all = one.expand(n_iters + 1, *one.shape)

        with span("frame.count"):
            dist_err = bits_ops.count_bit_errors(bits_d, bits_all, axis=-1)
            return FrameCounters(clean_err=clean_err, dist_err=dist_err.T.contiguous())

    return frame_signature(_frame, ibo_as_arg, cfg.pa.ibo_db, draw)
