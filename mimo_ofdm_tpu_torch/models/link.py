"""End-to-end link frame and Monte-Carlo round
(port of ``mimo_ofdm_tpu/models/link.py``).

``make_frame_fn`` builds the simulator of a batch of OFDM frames (channel
draw, precoding, constant-IBO recalibration, AGC, TX array with
per-antenna PA, propagation, AWGN and CNC/MCNC reception), returning
per-pass bit-error counts. ``make_round_fn`` wraps it into the unit of
work the Monte-Carlo loop schedules: a batch of frames with its counters
summed into one int32 vector ``[clean, it0..itN]``.

Two branches, as in the JAX package: the planar path
(``models/link_planar.py``) for single-user MRT on the LOS, two-path and
Rayleigh channels with perfect CSI, and the complex64 branch here for
every other single-user config (the AWGN, Rician, random-paths, TR 38.901
TDL and GSCM channels, the ``none`` and ``phase`` precoders, both CSI-error
models, ``channel_storage="complex64"``, transforms the kernel does not
take). :func:`make_channel_fn` is shared with the multi-user link
(``models/link_mu.py``), which takes the multi-user configs.

Antenna sharding: ``make_frame_fn(..., ant_group=group)`` builds the
complex64 frame of this rank's antennas, with every sum over antennas
all-reduced over ``group`` (``parallel/sharded.py`` builds the group). It
takes the same global :class:`FrameDraws` as an unsharded frame and keeps
its antennas' rows of the per-antenna draws (the Rayleigh fade, the
Rician scatter, the CSI error), so a shard sees the very channel a
single-device frame draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models import agc as agc_mod
from mimo_ofdm_tpu_torch.models import (channels, geometry, gscm, precoding,
                                        receivers, transmit)
from mimo_ofdm_tpu_torch.models.channels import _f32
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import noise as noise_ops
from mimo_ofdm_tpu_torch.ops import ofdm, pa
from mimo_ofdm_tpu_torch.parallel.collectives import all_reduce_mean, ant_slice
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device

# the channels whose RX position is moved per frame when rerolled
# (mimo_ofdm_tpu/models/link.py:78-119); random_paths ignores the RX and
# rayleigh keeps the base position
RX_REROLL_CHANNELS = ("los", "two_path", "rician", "tdl_3gpp", "gscm")
CHANNEL_MODELS = ("awgn", "los", "two_path", "rayleigh", "rician",
                  "random_paths", "tdl_3gpp", "gscm")


class FrameCounters(NamedTuple):
    """Bit-error counts of a batch of frames."""
    clean_err: torch.Tensor     # [B] int32 (clean run, counter [0] in the reference)
    dist_err: torch.Tensor      # [B, n_iters + 1] int32, CNC passes 0..n_iters


class FrameDraws(NamedTuple):
    """Pre-drawn randoms of ``B`` frames (JAX's threefry stream cannot be
    reproduced in torch, so a frame takes its randoms from here).

    * ``fade``: ``[B, 2, n_ant, n_sc]`` unit normals (real, imag planes) of
      the Rayleigh channel, else None;
    * ``bits_c`` / ``bits_d``: ``[B, n_bits]`` payload bits of the clean and
      distorted runs;
    * ``noise_c`` / ``noise_d``: ``[B, 2, n_sc]`` unit normals (real, imag);
    * ``loc``: ``[B, 2]`` RX offsets in x and y, uniform in
      ``+-loc_var/2``, when the channel's RX is rerolled
      (:data:`RX_REROLL_CHANNELS`), else None;
    * ``csi``: ``[B, 2, n_ant, n_sc]`` unit normals of the CSI error, when
      the config has one, else None;
    * ``chan``: the stochastic channel's own draws (:func:`draw_channel`),
      else None.
    """
    fade: torch.Tensor | None
    bits_c: torch.Tensor
    bits_d: torch.Tensor
    noise_c: torch.Tensor
    noise_d: torch.Tensor
    loc: torch.Tensor | None = None
    csi: torch.Tensor | None = None
    chan: object = None

    @property
    def batch(self) -> int:
        return self.bits_d.shape[0]

    @staticmethod
    def from_numpy(fade, bits_c, bits_d, noise_c, noise_d, loc=None, csi=None,
                   chan=None, device="cpu") -> "FrameDraws":
        """Tensors on ``device`` from numpy arrays (or None): normals,
        uniforms and offsets as float32, bits as int8. ``chan`` is a
        NamedTuple of numpy arrays (or None), converted field by field."""
        return FrameDraws(_f32(fade, device), _i8(bits_c, device), _i8(bits_d, device),
                          _f32(noise_c, device), _f32(noise_d, device),
                          _f32(loc, device), _f32(csi, device),
                          chan_from_numpy(chan, device))

    @staticmethod
    def draw(cfg: LinkConfig, batch: int, generator: torch.Generator,
             fade_dtype: torch.dtype = torch.float32,
             reroll: bool = True, n_bits: int | None = None) -> "FrameDraws":
        """Draw ``batch`` frames' randoms from ``generator`` on its device,
        only those the config uses; the fade directly in ``fade_dtype``
        (the plane storage dtype). ``n_bits`` payload bits a run (default:
        the frame's ``n_bits_per_ofdm_sym``; a coded frame's payload is
        shorter)."""
        dev = generator.device
        n_ant, n_sc = cfg.array.n_elements, cfg.modem.n_sub_carr
        if n_bits is None:
            n_bits = cfg.modem.n_bits_per_ofdm_sym
        model = cfg.channel.model

        def normals(*shape, dtype=torch.float32):
            return torch.randn((batch, *shape), generator=generator,
                               device=dev, dtype=dtype)
        fade = normals(2, n_ant, n_sc, dtype=fade_dtype) if model == "rayleigh" else None
        bits_c = bits_ops.random_payload_bits(generator, (batch, n_bits))
        bits_d = bits_ops.random_payload_bits(generator, (batch, n_bits))
        noise_c, noise_d = normals(2, n_sc), normals(2, n_sc)
        loc = draw_rx_offsets(cfg, batch, generator, reroll)
        csi = (normals(2, n_ant, n_sc)
               if cfg.csi_epsilon or cfg.csi_snr_db is not None else None)
        return FrameDraws(fade, bits_c, bits_d, noise_c, noise_d, loc, csi,
                          draw_channel(cfg, batch, generator))


def _i8(a, device):
    return torch.as_tensor(np.array(a, np.int8), device=device)


def chan_from_numpy(chan, device=None):
    """Channel draws of numpy (an array, a NamedTuple of arrays, or None)
    as float32 tensors on ``device`` (``None``: the card, as every entry
    point; ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
    if chan is None or isinstance(chan, np.ndarray):
        return _f32(chan, device)
    return type(chan)(*(_f32(a, device) for a in chan))


def draw_rx_offsets(cfg: LinkConfig, batch: int, generator: torch.Generator,
                    reroll: bool) -> torch.Tensor | None:
    """``[B, 2]`` RX offsets uniform in ``+-loc_var/2`` for the channels
    whose RX is rerolled (``reference/mp_model.py:140-150``), else None."""
    if not (reroll and cfg.channel.model in RX_REROLL_CHANNELS):
        return None
    u = torch.rand((batch, 2), generator=generator, device=generator.device)
    return u * cfg.rx.loc_var - cfg.rx.loc_var / 2.0


def draw_channel(cfg: LinkConfig, batch: int, generator: torch.Generator):
    """The stochastic channel's own draws of ``batch`` frames (the JAX
    channel's ``k_fade`` stream, ``mimo_ofdm_tpu/models/link.py:94-123``):
    Rician scatter normals ``[B, 2, n_ant, n_sc]``, :class:`RandomPathsDraws`,
    :class:`TdlDraws` or :class:`GscmDraws`; None for the other channels
    (the Rayleigh fade is ``FrameDraws.fade``)."""
    ch = cfg.channel
    dev = generator.device
    if ch.model == "rician":
        return torch.randn((batch, 2, cfg.array.n_elements, cfg.modem.n_sub_carr),
                           generator=generator, device=dev)
    if ch.model == "random_paths":
        return channels.RandomPathsDraws.draw(batch, generator, ch.n_paths,
                                              ch.max_delay_spread)
    if ch.model == "tdl_3gpp":
        return channels.TdlDraws.draw(batch, generator, ch.tdl_profile,
                                      ch.tdl_subpaths, ch.tdl_k_db,
                                      ch.tdl_ds_log10_std)
    if ch.model == "gscm":
        return gscm.GscmDraws.draw(ch.gscm_scenario, batch, generator)
    return None


def link_static(cfg: LinkConfig, device=None):
    """Static geometry/frequency tensors of a config, float32 on
    ``device`` (``None``: the card, as every entry point; ``"cpu"`` for the
    CPU): ``(tx_pos [n_ant, 3], freqs [n_fft], rx_base [3])``."""
    device = resolve_device(device)
    tx_pos = geometry.array_positions(
        cfg.array.geometry, cfg.array.n_elements, cfg.center_freq,
        cfg.array.wav_len_spacing, cord_z=cfg.array.cord_z,
        n_rows=cfg.array.n_rows, n_cols=cfg.array.n_cols)
    freqs = ofdm.fft_bin_frequencies(cfg.modem.n_fft, cfg.carrier_spacing,
                                     cfg.center_freq)
    rx_base = np.array([cfg.rx.cord_x, cfg.rx.cord_y, cfg.rx.cord_z])

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return f32(tx_pos), f32(freqs), f32(rx_base)


def rx_positions(rx_base: torch.Tensor, loc: torch.Tensor | None) -> torch.Tensor:
    """Rerolled RX positions ``[B, 3]``: the base position moved by the
    frames' x/y offsets (``reference/mp_model.py:140-150``; each axis uses
    its own base, as in the JAX package)."""
    if loc is None:
        raise ValueError("the channel's RX is rerolled, but the draws carry "
                         "no RX offsets (FrameDraws.loc)")
    loc = loc.to(rx_base.device)
    return rx_base + torch.cat([loc, torch.zeros_like(loc[:, :1])], dim=-1)


def bussgang_override(cfg: LinkConfig) -> float | None:
    """The Bussgang gain that replaces the closed form: the TOI PA's
    estimate (``reference/corrector.py:146-147``), 1 for the linear PA,
    else None (use the soft limiter's closed form)."""
    if cfg.pa.model == "toi":
        return cfg.pa.alpha_estimate
    if cfg.pa.model == "none":
        return 1.0
    return None


def frame_signature(frame, ibo_as_arg: bool, ibo_db: float, draw=None):
    """``frame(snr_db, ibo_db, draws, batch, generator)`` as the public
    ``frame_fn(snr_db, draws=None, *, batch=None, generator=None)`` at the
    config's IBO, or with ``ibo_as_arg`` as ``frame_fn(snr_db, ibo_db,
    draws=None, ...)``. ``draw(batch, generator)``, the draws the frame
    makes for itself when it is given none, is kept as ``frame_fn.draw``:
    a sharded round draws the global batch with it and hands each rank
    its rows."""
    if ibo_as_arg:
        def frame_fn_ibo(snr_db, ibo_db: float, draws: FrameDraws | None = None,
                         *, batch: int | None = None,
                         generator: torch.Generator | None = None) -> FrameCounters:
            return frame(snr_db, ibo_db, draws, batch, generator)
        frame_fn_ibo.draw = draw
        return frame_fn_ibo

    def frame_fn(snr_db, draws: FrameDraws | None = None, *,
                 batch: int | None = None,
                 generator: torch.Generator | None = None) -> FrameCounters:
        return frame(snr_db, ibo_db, draws, batch, generator)

    frame_fn.draw = draw
    return frame_fn


def _check_single_user(cfg: LinkConfig) -> None:
    """Raise ``ValueError`` for configs the single-user frame does not take:
    the multi-user ones go through ``models/link_mu.py``."""
    if (cfg.modem.n_users != 1 or cfg.precoding == "zf"
            or cfg.rx.algorithm in ("cnc_mu", "mcnc_mu")):
        raise ValueError(
            "multi-user configs (n_users > 1, zf precoding, cnc_mu/mcnc_mu "
            "receivers) run through models/link_mu.py (make_mu_frame_fn, "
            "make_mu_round_fn)")
    if cfg.rx.algorithm not in ("cnc", "mcnc", "none"):
        raise ValueError(f"unsupported rx algorithm {cfg.rx.algorithm!r}")


def make_channel_fn(cfg: LinkConfig, freqs: torch.Tensor,
                    rx_base: torch.Tensor, reroll: bool, rows: slice = slice(None)):
    """Channel generator ``channel_fn(tx_pos, draws=None) -> [..., n_ant,
    n_f]`` complex64 (``mimo_ofdm_tpu/models/link.py:54-126``). ``draws``
    is anything with the fields ``fade``, ``loc`` and ``chan`` of
    :class:`FrameDraws` (a :class:`FrameDraws`, or a user's draws in the
    multi-user frame). The channels of :data:`RX_REROLL_CHANNELS` move the
    RX by ``draws.loc`` when ``reroll`` (``reference/mp_model.py:140-150``);
    the stochastic ones take their draws from ``draws.fade`` (Rayleigh) or
    ``draws.chan``. The TDL and GSCM array steering runs at ``fc =
    mean(freqs)``, the mean of the grid handed in. Without a reroll LOS and
    two-path have no batch dim.

    ``rows`` selects the antennas of one antenna shard: ``tx_pos`` stays the
    whole array's, the per-antenna channels (AWGN, LOS, two-path,
    Rayleigh, Rician) are formed for the shard's elements from its rows of
    the draws, and the channels whose steering is relative to the whole
    array (random paths: the first element; TDL and GSCM: the array's
    centre) are formed for the whole array and cut to the shard's rows."""
    model = cfg.channel.model
    if model not in CHANNEL_MODELS:
        raise ValueError(f"unknown channel model {model!r}")
    ch = cfg.channel
    skip_att = ch.skip_attenuation

    def array_channel(tx_pos: torch.Tensor, draws, rx_pos):
        if model == "random_paths":
            return channels.random_paths_channel(draws.chan, tx_pos, freqs)
        if rx_pos.ndim == 1:                      # one drop per frame of the batch
            rx_pos = rx_pos.expand(len(draws.chan[0]), 3)
        if model == "tdl_3gpp":
            return channels.tdl_channel(
                draws.chan, tx_pos, rx_pos, freqs, ch.tdl_profile,
                skip_attenuation=skip_att, n_subpaths=ch.tdl_subpaths,
                asd_deg=ch.tdl_asd_deg, k_db=ch.tdl_k_db, k_std_db=ch.tdl_k_std_db,
                ds_log10_std=ch.tdl_ds_log10_std)
        return gscm.gscm_channel(draws.chan, tx_pos, rx_pos, freqs,
                                 scenario=ch.gscm_scenario, skip_attenuation=skip_att,
                                 element_pattern=ch.gscm_element_pattern)

    def channel_fn(tx_pos: torch.Tensor, draws=None):
        if model in ("random_paths", "tdl_3gpp", "gscm"):
            rx_pos = (rx_positions(rx_base, draws.loc)
                      if reroll and model != "random_paths" else rx_base)
            return array_channel(tx_pos, draws, rx_pos)[..., rows, :]
        tx_pos = tx_pos[rows]
        if model == "awgn":
            return torch.ones((tx_pos.shape[0], freqs.shape[-1]),
                              dtype=torch.complex64, device=freqs.device)
        if model == "rayleigh":
            return channels.rayleigh_channel(draws.fade[..., rows, :].to(freqs.device),
                                             tx_pos, rx_base, freqs, skip_att)
        rx_pos = rx_positions(rx_base, draws.loc) if reroll else rx_base
        if model == "los":
            return channels.los_channel(tx_pos, rx_pos, freqs, skip_att)
        if model == "two_path":
            return channels.two_path_channel(tx_pos, rx_pos, freqs, skip_att)
        return channels.rician_channel(draws.chan[..., rows, :], tx_pos, rx_pos, freqs,
                                       ch.rician_k_db, skip_att)
    return channel_fn


def make_frame_fn(cfg: LinkConfig, n_iters: int, *, incl_clean: bool = True,
                  reroll: bool = True, ibo_as_arg: bool = False, device=None,
                  ant_group=None):
    """Build ``frame_fn(snr_db, draws=None, *, batch=None, generator=None)
    -> FrameCounters`` on ``device`` (``cuda`` unless ``device="cpu"``).

    One call runs ``B`` frames of the reference's clean + distorted
    while-loop bodies (``reference/mp_model.py:136-222``); the distorted run
    feeds the CNC/MCNC receiver and errors are counted per pass. Without
    ``draws`` the frame draws ``batch`` frames from ``generator``.
    ``reroll`` moves the RX of a geometric channel per frame.
    ``ibo_as_arg=True`` gives ``frame_fn(snr_db, ibo_db, draws=None, ...)``
    with the IBO, a Python float, taken per call (one frame function for a
    whole IBO sweep).

    ``ant_group``, a process group, makes this the frame of one antenna
    shard (``mimo_ofdm_tpu/models/link.py:131-300`` under
    ``ant_axis_name``): always the complex64 branch, as in JAX, taking the
    global draws (see the module docstring)."""
    from mimo_ofdm_tpu_torch.models import link_planar

    dev = resolve_device(device)
    _check_single_user(cfg)
    if (ant_group is None and cfg.channel_storage != "complex64"
            and link_planar.planar_eligible(cfg)):
        return link_planar.make_planar_frame_fn(
            cfg, n_iters, incl_clean=incl_clean, reroll=reroll,
            storage=cfg.channel_storage, ibo_as_arg=ibo_as_arg, device=dev)
    return _make_complex_frame_fn(cfg, n_iters, incl_clean, reroll,
                                  ibo_as_arg, dev, ant_group)


def _make_complex_frame_fn(cfg: LinkConfig, n_iters: int, incl_clean: bool,
                           reroll: bool, ibo_as_arg: bool, dev: torch.device,
                           ant_group=None):
    """The complex64 branch of :func:`make_frame_fn`
    (``mimo_ofdm_tpu/models/link.py:162-311``), for this rank's antennas
    under ``ant_group``."""
    m = cfg.modem.constel_size
    n_fft, n_sc = cfg.modem.n_fft, cfg.modem.n_sub_carr
    n_ant = cfg.array.n_elements
    avg_sym_pow = cfg.modem.avg_symbol_power
    avg_samp_pow = cfg.modem.avg_sample_power
    pa_model = cfg.pa.model
    rapp_p = cfg.pa.rapp_p_hardness
    mxu = dict(use_mxu_fft=cfg.use_mxu_fft, mxu_storage=cfg.mxu_fft_storage)
    csi_err = bool(cfg.csi_epsilon) or cfg.csi_snr_db is not None
    alpha_override = bussgang_override(cfg)

    tx_pos, freqs, rx_base = link_static(cfg, dev)
    rows = ant_slice(n_ant, ant_group)                # every antenna without a group
    shard = dict(ant_group=ant_group, n_ant_global=n_ant)
    # the receivers observe the data subcarriers only, so the channel,
    # noise and AGC live on the n_sc grid
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    channel_fn = make_channel_fn(cfg, freqs_sc, rx_base, reroll, rows)
    precoder = precoding.make_precoder(cfg.precoding, cfg.modem.n_users, **shard)

    def draw(batch: int, generator: torch.Generator) -> FrameDraws:
        return FrameDraws.draw(cfg, batch, generator, reroll=reroll)

    def _frame(snr_db, ibo_db: float, draws: FrameDraws | None,
               batch: int | None, generator: torch.Generator | None
               ) -> FrameCounters:
        ibo_db = float(ibo_db)
        if draws is None:
            draws = draw(batch, generator)
        b = draws.batch
        # the true channel
        h_sc = channel_fn(tx_pos, draws).expand(b, rows.stop - rows.start, n_sc)
        if cfg.csi_epsilon:
            h_pre_sc = channels.csi_error_sc(draws.csi[..., rows, :].to(dev), h_sc,
                                             cfg.csi_epsilon)
        elif cfg.csi_snr_db is not None:
            # additive CSI noise at a fixed CSI SNR against the frame's mean
            # per-bin channel power
            p = all_reduce_mean((h_sc.abs() ** 2).mean((-2, -1), keepdim=True), ant_group)
            sigma2 = p / (10.0 ** (cfg.csi_snr_db / 10.0))
            csi_noise = noise_ops.complex_normal(
                draws.csi[..., rows, :].to(dev).movedim(-3, -2))
            h_pre_sc = h_sc + csi_noise * torch.sqrt(sigma2).to(h_sc.dtype)
        else:
            h_pre_sc = h_sc

        v = precoder(h_pre_sc)                            # [B, n_ant, n_sc]
        sat_pow = precoding.pa_sat_power(ibo_db, avg_samp_pow, v, **shard)[:, None]
        # for TOI the IBO is the intercept point against the precoded
        # average power (reference/distortion.py:222-228)
        toi_coeff = (pa.toi_to_cubic_coeff(
            ibo_db, avg_samp_pow * precoding.avg_precoding_gain(v, **shard))[:, None]
            if pa_model == "toi" else 0.0)
        agc = agc_mod.compute_agc_sc(h_pre_sc, v, ibo_db, n_ant,
                                     alpha_override=alpha_override, ant_group=ant_group)

        # clean run (reference/mp_model.py:136-175): without the PA the TX
        # (I)FFT round trip is the identity, so the symbols meet the
        # combined H o V vector
        if incl_clean:
            bits_c = draws.bits_c.to(dev)
            sym_c = transmit.modulate_users(bits_c, m)
            # under CSI error, propagation uses the TRUE channel while the
            # AGC vector comes from the noisy one
            hv_true = (channels.propagate(h_sc, v, ant_group=ant_group) if csi_err
                       else agc.hk_vk_agc_sc)
            rx_c = noise_ops.awgn(sym_c * hv_true, snr_db,
                                  avg_sym_pow * agc.hk_vk_noise_scaler,
                                  noise_ops.complex_normal(draws.noise_c.to(dev)))
            rx_bits_c = receivers.standard_receive_sc(rx_c / agc.hk_vk_agc_sc, m)
            clean_err = bits_ops.count_bit_errors(bits_c, rx_bits_c, axis=-1)
        else:
            clean_err = torch.zeros(b, dtype=torch.int32, device=dev)

        # distorted run (reference/mp_model.py:180-222): one fused-chain
        # launch over the B x n_ant rows
        bits_d = draws.bits_d.to(dev)
        sym_d = transmit.modulate_users(bits_d, m)
        fd_dist_sc = transmit.ifft_pa_fft_sc(
            transmit.precode_symbols(sym_d, v), n_fft, pa_model, sat_pow,
            rapp_p, toi_coeff, **mxu)
        rx_d = noise_ops.awgn(channels.propagate(h_sc, fd_dist_sc, ant_group=ant_group), snr_db,
                              avg_sym_pow * agc.ak_hk_vk_noise_scaler,
                              noise_ops.complex_normal(draws.noise_d.to(dev)))
        rx_sc = rx_d / agc.ak_hk_vk_agc_sc

        if cfg.rx.algorithm == "cnc":
            replica = receivers.make_cnc_replica(
                m, n_fft, n_sc, ibo_db, pa_model, alpha=alpha_override,
                rapp_p=rapp_p, **mxu)
            bits_all, _ = receivers.cnc_iterate(rx_sc, n_iters, m, replica)
        elif cfg.rx.algorithm == "mcnc":
            # the MCNC replica uses the *precoding* channel (noisy under CSI
            # error, reference/mp_model.py:115-119) and the ak AGC vector
            replica = receivers.make_mcnc_replica(
                h_pre_sc, v, agc.ak_hk_vk_agc_sc, constel_size=m, n_fft=n_fft,
                n_sc=n_sc, pa_model=pa_model, sat_power=sat_pow, rapp_p=rapp_p,
                toi_coeff=toi_coeff, ant_group=ant_group, **mxu)
            bits_all, _ = receivers.cnc_iterate(rx_sc, n_iters, m, replica)
        else:  # "none"
            one = receivers.standard_receive_sc(rx_sc, m)
            bits_all = one.expand(n_iters + 1, *one.shape)

        dist_err = bits_ops.count_bit_errors(bits_d, bits_all, axis=-1)
        return FrameCounters(clean_err=clean_err, dist_err=dist_err.T.contiguous())

    return frame_signature(_frame, ibo_as_arg, cfg.pa.ibo_db, draw)


def round_seed(key: int, idx: int) -> int:
    """Deterministic 63-bit generator seed of round ``idx`` under base
    ``key`` (the port's counterpart of ``fold_in(key, idx)``)."""
    state = np.random.SeedSequence([key, idx]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def make_round_fn(cfg: LinkConfig, n_iters: int, batch: int, *,
                  incl_clean: bool = True, reroll: bool = True,
                  ibo_as_arg: bool = False, flat: bool = True, device=None):
    """Monte-Carlo round ``round_fn(key, idx, snr_db[, ibo_db])``: ``batch``
    frames drawn from a generator seeded by :func:`round_seed` ``(key,
    idx)``, counters summed over the batch. With ``flat=True`` it returns
    ONE int32 tensor ``[clean_err, dist_err[0..n_iters]]`` (the reference's
    shared-array layout, ``reference/mp_model.py:132-134``), else summed
    :class:`FrameCounters`. ``ibo_as_arg`` adds the IBO argument, a Python
    float (see :func:`make_frame_fn`). Runs on ``device`` (``cuda`` unless
    ``device="cpu"``); nothing in a round waits for the device."""
    dev = resolve_device(device)
    frame_fn = make_frame_fn(cfg, n_iters, incl_clean=incl_clean,
                             reroll=reroll, ibo_as_arg=ibo_as_arg, device=dev)

    def round_fn(key: int, idx: int, snr_db, *ibo_db) -> torch.Tensor | FrameCounters:
        gen = torch.Generator(device=dev)
        gen.manual_seed(round_seed(key, idx))
        c = frame_fn(snr_db, *ibo_db, batch=batch, generator=gen)
        clean = c.clean_err.sum(0, dtype=torch.int32)
        dist = c.dist_err.sum(0, dtype=torch.int32)
        if flat:
            return torch.cat([clean[None], dist])
        return FrameCounters(clean_err=clean, dist_err=dist)

    return round_fn
