"""End-to-end link frame and Monte-Carlo round
(port of ``mimo_ofdm_tpu/models/link.py``).

``make_frame_fn`` builds the simulator of a batch of OFDM frames (channel
draw, precoding, constant-IBO recalibration, AGC, TX array with
per-antenna PA, propagation, AWGN and CNC/MCNC reception), returning
per-pass bit-error counts. ``make_round_fn`` wraps it into the unit of
work the Monte-Carlo loop schedules: a batch of frames with its counters
summed into one int32 vector ``[clean, it0..itN]``.

So far only planar-eligible configs run (``models/link_planar.py``); the
complex64 branch waits for a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models import geometry
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import ofdm
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device


class FrameCounters(NamedTuple):
    """Bit-error counts of a batch of frames."""
    clean_err: torch.Tensor     # [B] int32 (clean run, counter [0] in the reference)
    dist_err: torch.Tensor      # [B, n_iters + 1] int32, CNC passes 0..n_iters


class FrameDraws(NamedTuple):
    """Pre-drawn randoms of ``B`` frames (JAX's threefry stream cannot be
    reproduced in torch, so a frame takes its randoms from here).

    * ``fade``: ``[B, 2, n_ant, n_sc]`` unit normals (real, imag planes);
    * ``bits_c`` / ``bits_d``: ``[B, n_bits]`` payload bits of the clean and
      distorted runs;
    * ``noise_c`` / ``noise_d``: ``[B, 2, n_sc]`` unit normals (real, imag).
    """
    fade: torch.Tensor
    bits_c: torch.Tensor
    bits_d: torch.Tensor
    noise_c: torch.Tensor
    noise_d: torch.Tensor

    @staticmethod
    def from_numpy(fade, bits_c, bits_d, noise_c, noise_d,
                   device="cpu") -> "FrameDraws":
        """Tensors on ``device`` from numpy arrays: normals as float32, bits
        as int8."""
        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        def i8(a):
            return torch.as_tensor(np.array(a, np.int8), device=device)
        return FrameDraws(f32(fade), i8(bits_c), i8(bits_d), f32(noise_c),
                          f32(noise_d))

    @staticmethod
    def draw(cfg: LinkConfig, batch: int, generator: torch.Generator,
             fade_dtype: torch.dtype = torch.float32) -> "FrameDraws":
        """Draw ``batch`` frames' randoms from ``generator`` on its device;
        the fade directly in ``fade_dtype`` (the plane storage dtype)."""
        dev = generator.device
        n_ant, n_sc = cfg.array.n_elements, cfg.modem.n_sub_carr
        n_bits = cfg.modem.n_bits_per_ofdm_sym
        fade = torch.randn((batch, 2, n_ant, n_sc), generator=generator,
                           device=dev, dtype=fade_dtype)
        bits_c = bits_ops.random_payload_bits(generator, (batch, n_bits))
        bits_d = bits_ops.random_payload_bits(generator, (batch, n_bits))
        noise_c = torch.randn((batch, 2, n_sc), generator=generator, device=dev)
        noise_d = torch.randn((batch, 2, n_sc), generator=generator, device=dev)
        return FrameDraws(fade, bits_c, bits_d, noise_c, noise_d)


def link_static(cfg: LinkConfig, device="cpu"):
    """Static geometry/frequency tensors of a config, float32 on
    ``device``: ``(tx_pos [n_ant, 3], freqs [n_fft], rx_base [3])``."""
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


def make_frame_fn(cfg: LinkConfig, n_iters: int, *, incl_clean: bool = True,
                  device=None):
    """Build ``frame_fn(snr_db, draws=None, *, batch=None, generator=None)
    -> FrameCounters`` on ``device`` (``cuda`` unless ``device="cpu"``).

    One call runs ``B`` frames of the reference's clean + distorted
    while-loop bodies (``reference/mp_model.py:136-222``); the distorted run
    feeds the CNC/MCNC receiver and errors are counted per pass. Configs
    the planar path does not cover raise ``NotImplementedError``."""
    from mimo_ofdm_tpu_torch.models import link_planar

    dev = resolve_device(device)
    if cfg.channel_storage == "complex64" or not link_planar.planar_eligible(cfg):
        raise NotImplementedError(
            "only planar-eligible configs with channel_storage 'bfloat16' or "
            "'float32' are ported; the complex64 branch of make_frame_fn "
            "waits for a later slice (ROADMAP queue 1)")
    return link_planar.make_planar_frame_fn(
        cfg, n_iters, incl_clean=incl_clean, storage=cfg.channel_storage,
        device=dev)


def round_seed(key: int, idx: int) -> int:
    """Deterministic 63-bit generator seed of round ``idx`` under base
    ``key`` (the port's counterpart of ``fold_in(key, idx)``)."""
    state = np.random.SeedSequence([key, idx]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def make_round_fn(cfg: LinkConfig, n_iters: int, batch: int, *,
                  flat: bool = True, device=None):
    """Monte-Carlo round ``round_fn(key, idx, snr_db)``: ``batch`` frames
    drawn from a generator seeded by :func:`round_seed` ``(key, idx)``,
    counters summed over the batch. With ``flat=True`` it returns ONE int32
    tensor ``[clean_err, dist_err[0..n_iters]]`` (the reference's
    shared-array layout, ``reference/mp_model.py:132-134``), else summed
    :class:`FrameCounters`. Runs on ``device`` (``cuda`` unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    frame_fn = make_frame_fn(cfg, n_iters, device=dev)

    def round_fn(key: int, idx: int, snr_db) -> torch.Tensor | FrameCounters:
        gen = torch.Generator(device=dev)
        gen.manual_seed(round_seed(key, idx))
        c = frame_fn(snr_db, batch=batch, generator=gen)
        clean = c.clean_err.sum(0, dtype=torch.int32)
        dist = c.dist_err.sum(0, dtype=torch.int32)
        if flat:
            return torch.cat([clean[None], dist])
        return FrameCounters(clean_err=clean, dist_err=dist)

    return round_fn
