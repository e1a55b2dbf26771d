"""Multi-user link frame and Monte-Carlo round
(port of ``mimo_ofdm_tpu/models/link_mu.py``).

The multi-user experiment family
(``reference/main_multiuser/main_multiuser_cnc_ber_vs_ebn0.py``): one
channel per user at its own position, joint MRT / phase / ZF precoding
over users, one transmit summed over users, then per-user propagation,
AWGN (per-user noise scaler), AGC and reception with per-user counters.

Receivers: ``cnc`` (single-user CNC per user, any number of users),
``cnc_mu`` (CNC with the other user's symbols known, "CNCWI",
``reference/corrector.py:248-345``) and ``mcnc_mu`` (MCNC with the other
user's symbols known, "MCNCWI", ``reference/corrector.py:348-489``); the
last two are two-user prototypes, as in the reference. The
separate-subcarrier frame (:func:`make_mu_sep_frame_fn`) gives each user
its own block of subcarriers.

A call runs a batch of ``B`` frames. The users are folded into the fused
chain's rows, so a round launches the kernel 1 + ``n_iters`` + 1 times:
the TX over ``B x n_ant`` rows (the users are summed before the chain),
then each replica pass over ``B x n_usr`` rows (``cnc``, ``cnc_mu``) or
``B x n_usr x n_ant`` rows (``mcnc_mu``). Per-user tensors run with the
user axis first, ``[n_usr, B, ...]``.

Antenna sharding: with ``ant_group`` both frames run this rank's antennas
(the multi-user precoders, AGC, propagation and MCNC-MU replica
all-reduce over the group) on the same global :class:`MuFrameDraws`, of
which each user's channel keeps the shard's rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models import agc as agc_mod
from mimo_ofdm_tpu_torch.models import channels, precoding, receivers, transmit
from mimo_ofdm_tpu_torch.models.channels import _f32
from mimo_ofdm_tpu_torch.models.link import (_i8, chan_from_numpy, draw_channel,
                                              draw_rx_offsets, link_static,
                                              make_channel_fn, round_seed)
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import noise as noise_ops
from mimo_ofdm_tpu_torch.ops import ofdm
from mimo_ofdm_tpu_torch.parallel.collectives import ant_slice
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device
from mimo_ofdm_tpu_torch.utils.spans import OFF, enabled, span


def default_user_positions(angles_deg=(-30.0, 30.0), distances=(100.0, 316.3),
                           cord_z: float = 1.5) -> np.ndarray:
    """Canonical 2-user geometry: +-30 deg at 100 / 316.3 m
    (``reference/main_multiuser/main_multiuser_cnc_ber_vs_ebn0.py:37-46``)."""
    out = []
    for ang, dist in zip(angles_deg, distances):
        a = np.deg2rad(ang + 90.0)
        out.append((np.cos(a) * dist, np.sin(a) * dist, cord_z))
    return np.asarray(out)


def spread_user_positions(n_users: int, distance: float = 200.0,
                          span_deg: float = 120.0, cord_z: float = 1.5) -> np.ndarray:
    """``n_users`` users spread uniformly over ``span_deg`` around broadside
    at a common distance."""
    angles = np.linspace(-span_deg / 2, span_deg / 2, n_users)
    return default_user_positions(tuple(angles), tuple([distance] * n_users), cord_z)


class MuFrameCounters(NamedTuple):
    """Per-user bit-error counts of a batch of frames (summed over the batch
    by the round: ``[n_usr]`` and ``[n_usr, n_iters + 1]``)."""
    clean_err: torch.Tensor     # [B, n_usr] int32
    dist_err: torch.Tensor      # [B, n_usr, n_iters + 1] int32


class ChannelDraws(NamedTuple):
    """One user's channel draws, the fields :func:`link.make_channel_fn`
    reads: the Rayleigh ``fade [B, 2, n_ant, n_sc]``, the RX offsets ``loc
    [B, 2]`` and the stochastic channel's ``chan`` (each None where the
    config does not use it)."""
    fade: torch.Tensor | None
    loc: torch.Tensor | None
    chan: object = None


class MuFrameDraws(NamedTuple):
    """Pre-drawn randoms of ``B`` multi-user frames:

    * ``users``: one :class:`ChannelDraws` per user;
    * ``bits_c`` / ``bits_d``: ``[B, n_usr, n_bits]`` payload bits of the
      clean and distorted runs (``[B, n_bits]``, one stream over every
      user's block, in the separate-subcarrier frame);
    * ``noise_c`` / ``noise_d``: ``[B, n_usr, 2, n_sc]`` unit normals
      (real, imag), each user's own receiver noise.
    """
    users: tuple
    bits_c: torch.Tensor
    bits_d: torch.Tensor
    noise_c: torch.Tensor
    noise_d: torch.Tensor

    @property
    def batch(self) -> int:
        return self.bits_d.shape[0]

    @staticmethod
    def from_numpy(users, bits_c, bits_d, noise_c, noise_d,
                   device="cpu") -> "MuFrameDraws":
        """Tensors on ``device`` from numpy arrays; ``users`` holds one
        ``(fade, loc, chan)`` triple per user (entries may be None)."""
        return MuFrameDraws(
            tuple(ChannelDraws(_f32(f, device), _f32(loc, device),
                               chan_from_numpy(chan, device)) for f, loc, chan in users),
            _i8(bits_c, device), _i8(bits_d, device), _f32(noise_c, device),
            _f32(noise_d, device))

    @staticmethod
    def draw(cfg: LinkConfig, n_usr: int, batch: int, generator: torch.Generator,
             reroll: bool = True, sep_carriers: bool = False) -> "MuFrameDraws":
        """Draw ``batch`` frames' randoms from ``generator`` on its device,
        only those the config uses."""
        dev = generator.device
        n_ant, n_sc = cfg.array.n_elements, cfg.modem.n_sub_carr
        users = []
        for _ in range(n_usr):
            fade = (torch.randn((batch, 2, n_ant, n_sc), generator=generator, device=dev)
                    if cfg.channel.model == "rayleigh" else None)
            users.append(ChannelDraws(fade, draw_rx_offsets(cfg, batch, generator, reroll),
                                      draw_channel(cfg, batch, generator)))
        shape = ((batch, n_sc * cfg.modem.bits_per_symbol) if sep_carriers
                 else (batch, n_usr, cfg.modem.n_bits_per_ofdm_sym))
        bits_c = bits_ops.random_payload_bits(generator, shape)
        bits_d = bits_ops.random_payload_bits(generator, shape)
        noise_c, noise_d = (torch.randn((batch, n_usr, 2, n_sc), generator=generator,
                                        device=dev) for _ in range(2))
        return MuFrameDraws(tuple(users), bits_c, bits_d, noise_c, noise_d)


def _user_channels(cfg: LinkConfig, user_positions: np.ndarray, reroll: bool,
                   dev: torch.device, ant_group=None):
    """``user_channels(draws) -> [n_usr, B, n_ant, n_sc]``: one channel
    generator per user position on the data-bin grid
    (``mimo_ofdm_tpu/models/link_mu.py:92-99``); each user's RX moves
    around its own position. Under ``ant_group``, this rank's antennas."""
    n_sc = cfg.modem.n_sub_carr
    rows = ant_slice(cfg.array.n_elements, ant_group)   # every antenna without a group
    tx_pos, freqs, _ = link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    fns = [make_channel_fn(cfg, freqs_sc,
                           torch.as_tensor(np.asarray(pos, np.float32), device=dev),
                           reroll, rows)
           for pos in user_positions]

    def user_channels(draws: MuFrameDraws) -> torch.Tensor:
        b = draws.batch
        return torch.stack([fn(tx_pos, d).expand(b, rows.stop - rows.start, n_sc)
                            for fn, d in zip(fns, draws.users)])

    return user_channels


def _mu_signature(frame, cfg: LinkConfig, n_usr: int, reroll: bool, sep: bool):
    """The public ``frame_fn(snr_db, draws=None, *, batch=None,
    generator=None)``, with its own draws kept as ``frame_fn.draw(batch,
    generator)`` (see ``link.frame_signature``)."""
    def draw(batch: int, generator: torch.Generator) -> MuFrameDraws:
        return MuFrameDraws.draw(cfg, n_usr, batch, generator, reroll, sep)

    def frame_fn(snr_db, draws: MuFrameDraws | None = None, *,
                 batch: int | None = None,
                 generator: torch.Generator | None = None) -> MuFrameCounters:
        if draws is None:
            draws = draw(batch, generator)
        return frame(snr_db, draws)

    frame_fn.draw = draw
    return frame_fn


def make_mu_frame_fn(cfg: LinkConfig, n_iters: int, user_positions: np.ndarray, *,
                     incl_clean: bool = True, reroll: bool = True, device=None,
                     ant_group=None):
    """The shared-subcarrier multi-user frame
    ``frame_fn(snr_db, draws=None, *, batch=None, generator=None) ->
    MuFrameCounters`` on ``device`` (``cuda`` unless ``device="cpu"``)
    (``mimo_ofdm_tpu/models/link_mu.py:64-185``). Without ``draws`` the
    frame draws ``batch`` frames from ``generator``. ``ant_group``: the
    frame of this rank's antennas (see the module docstring).

    Its stages carry the planar frame's spans (``utils/spans.py``; the
    ``frame`` span also counts ``users``), and the MCNC-MU replica's
    precode and combine their own, ``mu.precode`` and ``mu.combine``."""
    dev = resolve_device(device)
    m = cfg.modem.constel_size
    n_fft, n_sc = cfg.modem.n_fft, cfg.modem.n_sub_carr
    n_ant = cfg.array.n_elements
    n_usr = len(user_positions)
    ibo_db = cfg.pa.ibo_db
    avg_sym_pow = cfg.modem.avg_symbol_power
    avg_samp_pow = cfg.modem.avg_sample_power
    pa_model = cfg.pa.model
    algorithm = cfg.rx.algorithm
    mxu = dict(use_mxu_fft=cfg.use_mxu_fft, mxu_storage=cfg.mxu_fft_storage)
    if algorithm not in ("cnc", "cnc_mu", "mcnc_mu"):
        raise ValueError(f"unsupported MU rx algorithm {algorithm!r}")
    if algorithm != "cnc" and n_usr != 2:
        raise ValueError("cnc_mu/mcnc_mu are 2-user prototypes, matching the "
                         "reference (reference/corrector.py:248-251)")
    shard = dict(ant_group=ant_group, n_ant_global=n_ant)
    precoder = precoding.make_precoder(cfg.precoding, n_users=n_usr, **shard)
    user_channels = _user_channels(cfg, user_positions, reroll, dev, ant_group)

    def frame(snr_db, draws: MuFrameDraws) -> MuFrameCounters:
        with (span("frame", frames=draws.batch, users=n_usr) if enabled() else OFF):
            return _stages(snr_db, draws)

    def _stages(snr_db, draws: MuFrameDraws) -> MuFrameCounters:
        with span("frame.channel"):
            h_usr = user_channels(draws)                     # [U, B, n_ant, n_sc]
        with span("frame.precoder"):
            v = precoder(h_usr.movedim(0, -3))               # [B, n_ant, U, n_sc]
            sat_pow = precoding.pa_sat_power(ibo_db, avg_samp_pow, v, multi_user=True,
                                             **shard)
            agc = agc_mod.compute_agc_sc(h_usr, v, ibo_db, n_ant, usr_idx=slice(None),
                                         ant_group=ant_group)

        # clean run: the TX (I)FFT round trip is the identity on the data bins
        with span("frame.clean"):
            if incl_clean:
                bits_c = draws.bits_c.to(dev)
                tx_sc = transmit.precode_symbols(transmit.modulate_users(bits_c, m), v,
                                                 sum_users=True)       # [B, n_ant, n_sc]
                rx = noise_ops.awgn(channels.propagate(h_usr, tx_sc, ant_group=ant_group),
                                    snr_db, avg_sym_pow * agc.hk_vk_noise_scaler,
                                    noise_ops.complex_normal(draws.noise_c.to(dev)).movedim(1, 0))
                rx_bits = receivers.standard_receive_sc(rx / agc.hk_vk_agc_sc, m)
                clean_err = bits_ops.count_bit_errors(bits_c.movedim(1, 0), rx_bits,
                                                      axis=-1).T
            else:
                clean_err = torch.zeros((draws.batch, n_usr), dtype=torch.int32, device=dev)

        # distorted run: one chain launch over the B x n_ant rows of the
        # users' summed signal
        bits_d = draws.bits_d.to(dev)
        tx_sym = transmit.modulate_users(bits_d, m)              # [B, U, n_sc]
        with span("tx.precode"):        # the precode runs in the chain's load
            tx_sym = tx_sym.contiguous()
        fd_dist_sc = transmit.precode_ifft_pa_fft_sc(tx_sym, v, n_fft, pa_model,
                                                     sat_pow[:, None], cfg.pa.rapp_p_hardness,
                                                     **mxu)
        with span("tx.combine"):
            rx = channels.propagate(h_usr, fd_dist_sc, ant_group=ant_group)
        with span("frame.awgn"):
            rx = noise_ops.awgn(rx, snr_db, avg_sym_pow * agc.ak_hk_vk_noise_scaler,
                                noise_ops.complex_normal(draws.noise_d.to(dev)).movedim(1, 0))
            rx_sc = rx / agc.ak_hk_vk_agc_sc                      # [U, B, n_sc]

        if algorithm == "cnc":
            replica = receivers.make_cnc_replica(m, n_fft, n_sc, ibo_db, pa_model, **mxu)
        elif algorithm == "cnc_mu":
            other = tx_sym.flip(-2).movedim(-2, 0)                 # the other user's
            replica = receivers.make_cnc_mu_replica(
                other, constel_size=m, n_fft=n_fft, n_sc=n_sc, ibo_db=ibo_db,
                pa_model=pa_model, **mxu)
        else:  # "mcnc_mu"
            replica = receivers.make_mcnc_mu_replica(
                tx_sym, h_usr, v, agc.ak_hk_vk_agc_sc, constel_size=m,
                n_fft=n_fft, n_sc=n_sc, pa_model=pa_model, sat_power=sat_pow[:, None],
                ant_group=ant_group, **mxu)
        bits_all, _ = receivers.cnc_iterate(rx_sc, n_iters, m, replica)
        with span("frame.count"):
            dist_err = bits_ops.count_bit_errors(bits_d.movedim(1, 0), bits_all, axis=-1)
            return MuFrameCounters(clean_err=clean_err.contiguous(),
                                   dist_err=dist_err.permute(2, 1, 0).contiguous())

    return _mu_signature(frame, cfg, n_usr, reroll, False)


def make_mu_sep_frame_fn(cfg: LinkConfig, n_iters: int, user_positions: np.ndarray, *,
                         incl_clean: bool = True, reroll: bool = True, device=None,
                         ant_group=None):
    """The separate-subcarriers-per-user frame
    (``reference/main_multiuser/main_multiuser_cnc_sep_sc_ber_vs_ebn0.py``,
    ``mimo_ofdm_tpu/models/link_mu.py:188-286``): user ``u`` owns the
    ``u``-th contiguous block of ``n_sc / n_usr`` subcarriers, the precoder
    is single-user MRT of the composed channel, and each user's CNC
    receiver runs over the whole frame and counts only its own block's
    bits. ``ant_group``: the frame of this rank's antennas."""
    dev = resolve_device(device)
    m = cfg.modem.constel_size
    n_fft, n_sc = cfg.modem.n_fft, cfg.modem.n_sub_carr
    n_ant = cfg.array.n_elements
    n_usr = len(user_positions)
    if n_sc % n_usr:
        raise ValueError("n_sub_carr must divide by n_users for sep carriers")
    n_bits_usr = n_sc // n_usr * cfg.modem.bits_per_symbol
    ibo_db = cfg.pa.ibo_db
    avg_sym_pow = cfg.modem.avg_symbol_power
    avg_samp_pow = cfg.modem.avg_sample_power
    pa_model = cfg.pa.model
    mxu = dict(use_mxu_fft=cfg.use_mxu_fft, mxu_storage=cfg.mxu_fft_storage)
    user_channels = _user_channels(cfg, user_positions, reroll, dev, ant_group)
    replica = receivers.make_cnc_replica(m, n_fft, n_sc, ibo_db, pa_model, **mxu)

    def own_block_errors(bits: torch.Tensor, rx_bits: torch.Tensor) -> torch.Tensor:
        """Errors of each user on its own block: ``bits [B, n_bits]`` against
        ``rx_bits [..., n_usr, B, n_bits]`` -> ``[..., B, n_usr]``."""
        rx_own = torch.diagonal(rx_bits.unflatten(-1, (n_usr, n_bits_usr)),
                                dim1=-4, dim2=-2)            # [..., B, n_bits_usr, U]
        tx_own = bits.unflatten(-1, (n_usr, n_bits_usr)).transpose(-2, -1)
        return bits_ops.count_bit_errors(tx_own, rx_own, axis=-2)

    def frame(snr_db, draws: MuFrameDraws) -> MuFrameCounters:
        h_usr = user_channels(draws)                         # [U, B, n_ant, n_sc]
        v = precoding.mu_sep_carrier_precoder(h_usr.movedim(0, -3),
                                              ant_group=ant_group)  # [B, n_ant, n_sc]
        comp_h = precoding.sep_carrier_channel(h_usr.movedim(0, -3))
        sat_pow = precoding.pa_sat_power(ibo_db, avg_samp_pow, v, ant_group=ant_group,
                                         n_ant_global=n_ant)
        agc = agc_mod.compute_agc_sc(comp_h, v, ibo_db, n_ant, ant_group=ant_group)

        if incl_clean:
            bits_c = draws.bits_c.to(dev)
            tx_sc = transmit.precode_symbols(transmit.modulate_users(bits_c, m), v)
            rx = noise_ops.awgn(channels.propagate(h_usr, tx_sc, ant_group=ant_group),
                                snr_db, avg_sym_pow * agc.hk_vk_noise_scaler,
                                noise_ops.complex_normal(draws.noise_c.to(dev)).movedim(1, 0))
            rx_bits = receivers.standard_receive_sc(rx / agc.hk_vk_agc_sc, m)
            clean_err = own_block_errors(bits_c, rx_bits)
        else:
            clean_err = torch.zeros((draws.batch, n_usr), dtype=torch.int32, device=dev)

        bits_d = draws.bits_d.to(dev)
        fd_dist_sc = transmit.array_transmit_sc(
            bits_d, constel_size=m, n_fft=n_fft, v=v, pa_model=pa_model,
            sat_power=sat_pow[:, None], rapp_p=cfg.pa.rapp_p_hardness, **mxu)
        rx = noise_ops.awgn(channels.propagate(h_usr, fd_dist_sc, ant_group=ant_group), snr_db,
                            avg_sym_pow * agc.ak_hk_vk_noise_scaler,
                            noise_ops.complex_normal(draws.noise_d.to(dev)).movedim(1, 0))
        bits_all, _ = receivers.cnc_iterate(rx / agc.ak_hk_vk_agc_sc, n_iters, m, replica)
        dist_err = own_block_errors(bits_d, bits_all)        # [n_iters + 1, B, U]
        return MuFrameCounters(clean_err=clean_err.contiguous(),
                               dist_err=dist_err.permute(1, 2, 0).contiguous())

    return _mu_signature(frame, cfg, n_usr, reroll, True)


def make_mu_round_fn(cfg: LinkConfig, n_iters: int, batch: int,
                     user_positions: np.ndarray | None = None, *,
                     incl_clean: bool = True, reroll: bool = True,
                     sep_carriers: bool = False, device=None):
    """Multi-user Monte-Carlo round ``round_fn(key, idx, snr_db)``
    (``mimo_ofdm_tpu/models/link_mu.py:289-307``): ``batch`` frames drawn
    from a generator seeded by ``round_seed(key, idx)``, counters summed
    over the batch into ONE int32 tensor ``[n_usr, n_iters + 2]``, each
    user's ``[clean, it0..itN]``. Runs on ``device`` (``cuda`` unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    if user_positions is None:
        user_positions = default_user_positions()
    builder = make_mu_sep_frame_fn if sep_carriers else make_mu_frame_fn
    frame_fn = builder(cfg, n_iters, user_positions, incl_clean=incl_clean,
                       reroll=reroll, device=dev)

    def round_fn(key: int, idx: int, snr_db) -> torch.Tensor:
        gen = torch.Generator(device=dev)
        gen.manual_seed(round_seed(key, idx))
        c = frame_fn(snr_db, batch=batch, generator=gen)
        return torch.cat([c.clean_err.sum(0, dtype=torch.int32)[:, None],
                          c.dist_err.sum(0, dtype=torch.int32)], dim=1)

    return round_fn
