"""LDPC-coded link (port of ``mimo_ofdm_tpu/models/link_ldpc.py``, the
reference's ``LinkLdpc``, ``reference/main_cnc_mcnc_w_ldpc/mp_ldpc_model.py``).

One OFDM frame carries one transport block (or one raw IRA codeword) of
``n_bits_per_ofdm_sym`` coded bits. Per CNC/MCNC pass the receiver demaps
the corrected symbols softly with ``noise_var = 2 avg_symbol_power /
snr_lin`` (``mp_ldpc_model.py:121``), negates the LLRs (the demapper's
positive = bit 1 against the decoder's positive = bit 0,
``mp_ldpc_model.py:168-169``), decodes, and counts payload bit errors and,
with the transport chain, blocks whose TB CRC fails.

A call runs ``B`` frames. The TX is one fused-chain launch over the ``B x
n_ant`` rows and each of the ``n_iters + 1`` replica passes one more, as in
the uncoded frames. The LLRs of every (frame, pass, code block), the clean
run's included, go through ONE decode (JAX's ``serial_decode`` body,
``link_ldpc.py:525-554``; JAX's plain frame decodes pass by pass with the
same bits). The in-loop frame decodes its ``B x C`` items once per pass,
since each re-encoded decision feeds the next replica.

The coded frames follow the JAX source's order, which is not the uncoded
complex frame's: the clean run propagates ``precode_symbols(sym, v)``
through ``channels.propagate``, and the replicas take JAX's arguments as
they are (no ``alpha`` or ``rapp_p`` for CNC, no ``toi_coeff`` for MCNC).

Each coded frame call runs inside a ``frame`` span (``frames=B``) with the
planar frame's stages as its children (``utils/spans.py``):
``frame.channel``, ``frame.precoder`` (MRT, saturation power, AGC),
``frame.clean``, the distorted TX's ``chain``, ``frame.awgn``, the
receiver's ``rx.pass`` spans, the demapper's ``soft_demap``, the decoder's
``decode`` (``ops/ldpc.py::decode`` counts its ``codewords`` and
``iters``) and ``frame.count``; building the front end is
``setup.frame_fn``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models import agc as agc_mod
from mimo_ofdm_tpu_torch.models import channels, precoding, receivers, transmit
from mimo_ofdm_tpu_torch.models.link import (FrameDraws, _check_single_user,
                                              frame_signature, link_static,
                                              make_channel_fn, round_seed)
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import ldpc, qam, transport
from mimo_ofdm_tpu_torch.ops import noise as noise_ops
from mimo_ofdm_tpu_torch.ops import ofdm
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device
from mimo_ofdm_tpu_torch.utils.spans import OFF, enabled, span


class CodedFrameCounters(NamedTuple):
    """Info-bit errors of a batch of raw-codeword frames (summed over the
    batch by the round)."""
    clean_err: torch.Tensor     # [B] int32, clean coded run
    dist_err: torch.Tensor      # [B, n_iters + 1] int32, CNC passes 0..n_iters


class TransportFrameCounters(NamedTuple):
    """Payload bit errors and failed transport blocks (TB CRC) of a batch of
    frames (summed over the batch by the round)."""
    clean_err: torch.Tensor     # [B] int32
    clean_blk: torch.Tensor     # [B] int32
    dist_err: torch.Tensor      # [B, n_iters + 1] int32
    dist_blk: torch.Tensor      # [B, n_iters + 1] int32


def code_for_modem(cfg: LinkConfig, code_rate: float = 0.5,
                   m_b: int = 12) -> ldpc.QcLdpcCode:
    """The IRA QC-LDPC code whose codeword fills one OFDM frame."""
    n_coded = cfg.modem.n_bits_per_ofdm_sym
    k_b = round(m_b * code_rate / (1.0 - code_rate))
    n_b = k_b + m_b
    if n_coded % n_b:
        raise ValueError(f"n_bits_per_ofdm_sym={n_coded} not divisible by "
                         f"n_b={n_b}; adjust m_b or modem size")
    return ldpc.make_default_code(k_b=k_b, m_b=m_b, z=n_coded // n_b)


def select_base_graph(a: int, rate: float) -> int:
    """38.212 §7.2.2 base-graph selection: BG2 for small or low-rate
    blocks, else BG1 (``nrDLSCHInfo``'s bgn, ``mp_ldpc_model.py:104``)."""
    if a <= 292 or rate <= 0.25 or (a <= 3824 and rate <= 0.67):
        return 2
    return 1


def transport_chain_for_modem(cfg: LinkConfig, code_rate: float = 0.5,
                              n_blocks: int = 4, rv: int = 0,
                              family: str = "nr", bg: int | None = None):
    """A transport chain whose rate-matched output fills one OFDM frame
    (``mp_ldpc_model.py:99-104``). ``family="nr"``: 5G-NR LDPC, base graph
    by §7.2.2 unless ``bg`` is given; ``family="ira"``: the accumulator QC
    code sized for about ``n_blocks`` code blocks."""
    e_total = cfg.modem.n_bits_per_ofdm_sym
    if family == "nr":
        if bg is None:
            bg = select_base_graph(int(np.floor(code_rate * e_total)) - 24, code_rate)
        return transport.make_nr_transport_chain(e_total, bg=bg, target_rate=code_rate,
                                                 rv=rv)
    z = max(4, int(round(e_total * code_rate / n_blocks / 12)))
    code = ldpc.make_default_code(k_b=12, m_b=12, z=z)
    return transport.make_transport_chain(code, e_total=e_total, target_rate=code_rate,
                                          rv=rv)


def reference_chain(cfg: LinkConfig, code_rate: float, rv: int = 0):
    """The reference's transport sizing (``mp_ldpc_model.py:99-104``): the
    payload is exactly ``A = rate * n_bits_per_ofdm_sym``, the TB CRC on
    top, and the base graph by §7.2.2."""
    e_total = cfg.modem.n_bits_per_ofdm_sym
    a = int(round(code_rate * e_total))
    return transport.make_nr_transport_chain(e_total, bg=select_base_graph(a, code_rate),
                                             a=a, rv=rv)


def noise_var(avg_sym_pow: float, snr_db) -> float:
    """The demapper's ``2 avg_symbol_power / 10^(snr/10)``
    (``mp_ldpc_model.py:121``), in float32 arithmetic as JAX forms it, as
    a Python float so that nothing touches the device."""
    f32 = np.float32
    return float(f32(2.0 * avg_sym_pow) / f32(10.0) ** (f32(snr_db) / f32(10.0)))


def decoder_llr(sym: torch.Tensor, constel_size: int, nv: float) -> torch.Tensor:
    """Demapper LLRs in the decoder's sign convention (positive = bit 0)."""
    return -qam.soft_llr(sym, constel_size, nv)


def decoder_llr_nvadj(sym: torch.Tensor, constel_size: int, nv_thermal: float
                      ) -> torch.Tensor:
    """Noise-variance-adjusted LLRs (the ``nvadj_ldpc`` variant,
    ``mimo_ofdm_tpu/models/link_ldpc.py:222-240``): the demapper variance of
    each frame and pass is twice the measured error power ``mean |sym -
    harddet(sym)|^2`` over its subcarriers (thermal noise plus the
    uncancelled PA distortion), floored by the thermal term."""
    det, _ = qam.detect_symbols_and_bits(sym, constel_size, dtype=sym.dtype)
    measured = 2.0 * (torch.abs(sym - det) ** 2).mean(-1, keepdim=True)
    return -qam.soft_llr(sym, constel_size, torch.clamp(measured, min=nv_thermal))


def _coded_link(cfg: LinkConfig, reroll: bool, dev: torch.device):
    """The coded frames' shared front end ``run(snr_db, draws, encode,
    incl_clean) -> (rx_clean [B, n_sc] or None, rx_sc [B, n_sc],
    replica)`` (``mimo_ofdm_tpu/models/link_ldpc.py:252-303``): channel,
    precoder, constant-IBO saturation power, AGC; the clean run (encode,
    modulate, precode, propagate, noise, AGC divide); the distorted run
    (encode, one chain launch over the ``B x n_ant`` rows, propagate,
    noise, AGC divide); and the CNC or MCNC replica."""
    with span("setup.frame_fn"):
        return _build_coded_link(cfg, reroll, dev)


def _build_coded_link(cfg: LinkConfig, reroll: bool, dev: torch.device):
    _check_single_user(cfg)
    m = cfg.modem.constel_size
    n_fft, n_sc = cfg.modem.n_fft, cfg.modem.n_sub_carr
    n_ant = cfg.array.n_elements
    ibo_db = cfg.pa.ibo_db
    avg_sym_pow = cfg.modem.avg_symbol_power
    avg_samp_pow = cfg.modem.avg_sample_power
    pa_model, rapp_p = cfg.pa.model, cfg.pa.rapp_p_hardness
    mxu = dict(use_mxu_fft=cfg.use_mxu_fft, mxu_storage=cfg.mxu_fft_storage)
    tx_pos, freqs, rx_base = link_static(cfg, dev)
    channel_fn = make_channel_fn(cfg, ofdm.extract_subcarriers(freqs, n_sc), rx_base, reroll)
    precoder = precoding.make_precoder(cfg.precoding, cfg.modem.n_users)

    def run(snr_db, draws: FrameDraws, encode, incl_clean: bool):
        b = draws.batch
        with span("frame.channel"):
            h_sc = channel_fn(tx_pos, draws).expand(b, n_ant, n_sc)
        with span("frame.precoder"):
            v = precoder(h_sc)
            sat_pow = precoding.pa_sat_power(ibo_db, avg_samp_pow, v)[:, None]
            agc = agc_mod.compute_agc_sc(h_sc, v, ibo_db, n_ant)
        rx_c = None
        with span("frame.clean"):
            if incl_clean:
                sym_c = qam.modulate_bits(encode(draws.bits_c.to(dev)), m)
                rx = channels.propagate(h_sc, transmit.precode_symbols(sym_c, v))
                rx = noise_ops.awgn(rx, snr_db, avg_sym_pow * agc.hk_vk_noise_scaler,
                                    noise_ops.complex_normal(draws.noise_c.to(dev)))
                rx_c = rx / agc.hk_vk_agc_sc
        fd_dist_sc = transmit.array_transmit_sc(
            encode(draws.bits_d.to(dev)), constel_size=m, n_fft=n_fft, v=v,
            pa_model=pa_model, sat_power=sat_pow, rapp_p=rapp_p, **mxu)
        with span("frame.awgn"):
            rx_d = noise_ops.awgn(channels.propagate(h_sc, fd_dist_sc), snr_db,
                                  avg_sym_pow * agc.ak_hk_vk_noise_scaler,
                                  noise_ops.complex_normal(draws.noise_d.to(dev)))
            rx_sc = rx_d / agc.ak_hk_vk_agc_sc
        if cfg.rx.algorithm == "mcnc":
            replica = receivers.make_mcnc_replica(
                h_sc, v, agc.ak_hk_vk_agc_sc, constel_size=m, n_fft=n_fft, n_sc=n_sc,
                pa_model=pa_model, sat_power=sat_pow, rapp_p=rapp_p, **mxu)
        else:
            replica = receivers.make_cnc_replica(m, n_fft, n_sc, ibo_db, pa_model, **mxu)
        return rx_c, rx_sc, replica

    return run


def _check_chain(cfg: LinkConfig, chain: transport.TransportChain) -> None:
    if chain.e_total != cfg.modem.n_bits_per_ofdm_sym:
        raise ValueError(f"chain fills {chain.e_total} bits, the frame has "
                         f"{cfg.modem.n_bits_per_ofdm_sym}")


def _with_clean(clean: torch.Tensor | None, taps: torch.Tensor) -> torch.Tensor:
    """The clean run's ``[B, ...]`` in front of the passes' ``[T, B, ...]``."""
    return taps if clean is None else torch.cat([clean[None], taps])


def _split_clean(x: torch.Tensor, incl_clean: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``[(1 +) T, B]`` counts -> ``(clean [B], passes [B, T])``, the clean
    counts 0 without a clean run."""
    taps = x[1:] if incl_clean else x
    clean = x[0] if incl_clean else torch.zeros_like(x[0])
    return clean, taps.T.contiguous()


def _framed(frame):
    """``frame(snr_db, ibo_db, draws, batch, generator)`` run inside a
    ``frame`` span that counts its ``frames``, the span a round is counted
    by."""
    def inside(snr_db, ibo_db, draws, batch, generator):
        with (span("frame", frames=batch if draws is None else draws.batch) if enabled()
              else OFF):
            return frame(snr_db, ibo_db, draws, batch, generator)
    return inside


def make_coded_frame_fn(cfg: LinkConfig, n_iters: int, code: ldpc.QcLdpcCode | None = None,
                        ldpc_iters: int = 25, *, incl_clean: bool = True,
                        reroll: bool = True, device=None):
    """The raw-codeword IRA frame ``frame_fn(snr_db, draws=None, *,
    batch=None, generator=None) -> CodedFrameCounters`` on ``device``
    (``cuda`` unless ``device="cpu"``; ``mimo_ofdm_tpu/models/link_ldpc.py:50-134``).
    Without ``draws`` it draws ``batch`` frames (``code.k`` info bits a
    run) from ``generator``."""
    dev = resolve_device(device)
    if code is None:
        code = code_for_modem(cfg)
    if code.n != cfg.modem.n_bits_per_ofdm_sym:
        raise ValueError(f"code length {code.n} != {cfg.modem.n_bits_per_ofdm_sym} "
                         f"bits a frame")
    m = cfg.modem.constel_size
    run = _coded_link(cfg, reroll, dev)

    @_framed
    def frame(snr_db, _ibo_db, draws, batch, generator) -> CodedFrameCounters:
        if draws is None:
            draws = FrameDraws.draw(cfg, batch, generator, reroll=reroll, n_bits=code.k)
        rx_c, rx_sc, replica = run(snr_db, draws, lambda b: ldpc.encode(code, b), incl_clean)
        corr_all = receivers.cnc_iterate_soft(rx_sc, n_iters, m, replica)
        llr = decoder_llr(_with_clean(rx_c, corr_all), m,
                          noise_var(cfg.modem.avg_symbol_power, snr_db))
        hard = ldpc.decode(code, llr, n_iters=ldpc_iters)
        with span("frame.count"):
            info_c = draws.bits_c.to(dev) if incl_clean else None
            info = _with_clean(info_c, draws.bits_d.to(dev).expand(n_iters + 1, -1, -1))
            clean, dist = _split_clean(bits_ops.count_bit_errors(info, hard, axis=-1),
                                       incl_clean)
            return CodedFrameCounters(clean_err=clean, dist_err=dist)

    return frame_signature(frame, False, cfg.pa.ibo_db)


def make_transport_frame_fn(cfg: LinkConfig, n_iters: int, chain: transport.TransportChain,
                            ldpc_iters: int = 25, *, ldpc_algorithm: str = "minsum",
                            incl_clean: bool = True, reroll: bool = True,
                            nv_adjust: bool = False, serial_decode: int = 0,
                            device=None):
    """The transport-chain frame ``frame_fn(snr_db, draws=None, *,
    batch=None, generator=None) -> TransportFrameCounters``
    (``mimo_ofdm_tpu/models/link_ldpc.py:180-315``): CRC24A, segmentation,
    QC-LDPC encode and rate matching fill the OFDM frame; payload bit errors
    and failed blocks are counted per CNC pass. ``nv_adjust`` demaps the
    passes with :func:`decoder_llr_nvadj` (the clean run keeps the thermal
    variance); ``serial_decode=g`` decodes ``g`` items at a time (same
    bits). Draws carry ``chain.a`` payload bits a run."""
    dev = resolve_device(device)
    _check_chain(cfg, chain)
    m = cfg.modem.constel_size
    run = _coded_link(cfg, reroll, dev)

    @_framed
    def frame(snr_db, _ibo_db, draws, batch, generator) -> TransportFrameCounters:
        if draws is None:
            draws = FrameDraws.draw(cfg, batch, generator, reroll=reroll, n_bits=chain.a)
        rx_c, rx_sc, replica = run(snr_db, draws,
                                   lambda b: transport.transport_encode(chain, b), incl_clean)
        corr_all = receivers.cnc_iterate_soft(rx_sc, n_iters, m, replica)
        nv = noise_var(cfg.modem.avg_symbol_power, snr_db)
        llr = (decoder_llr_nvadj if nv_adjust else decoder_llr)(corr_all, m, nv)
        if incl_clean:
            llr = torch.cat([decoder_llr(rx_c, m, nv)[None], llr])
        pay, ok = transport.transport_decode(chain, llr, n_iters=ldpc_iters,
                                             algorithm=ldpc_algorithm,
                                             serial_blocks=serial_decode)
        with span("frame.count"):
            sent = draws.bits_d.to(dev).expand(n_iters + 1, -1, -1)
            if incl_clean:
                sent = torch.cat([draws.bits_c.to(dev)[None], sent])
            clean_err, dist_err = _split_clean(bits_ops.count_bit_errors(sent, pay, axis=-1),
                                               incl_clean)
            clean_blk, dist_blk = _split_clean((~ok).to(torch.int32), incl_clean)
            return TransportFrameCounters(clean_err=clean_err, clean_blk=clean_blk,
                                          dist_err=dist_err, dist_blk=dist_blk)

    return frame_signature(frame, False, cfg.pa.ibo_db)


def make_transport_inloop_frame_fn(cfg: LinkConfig, n_iters: int,
                                   chain: transport.TransportChain, ldpc_iters: int = 25, *,
                                   ldpc_algorithm: str = "sumprod", incl_clean: bool = True,
                                   reroll: bool = True, device=None):
    """The LDPC-in-the-loop CNC/MCNC frame
    (``mimo_ofdm_tpu/models/link_ldpc.py:318-434``): every pass demaps and
    decodes the corrected symbols, re-encodes and re-modulates the decoded
    payload, and feeds that to the replica in place of the hard decisions
    (``reference/corrector.py:52-112`` with detection replaced by the
    decode/re-encode round trip). ``dist_err[:, 0]`` is the plain decode,
    ``dist_err[:, i]`` the decode after ``i`` in-loop passes."""
    dev = resolve_device(device)
    _check_chain(cfg, chain)
    m = cfg.modem.constel_size
    run = _coded_link(cfg, reroll, dev)

    @_framed
    def frame(snr_db, _ibo_db, draws, batch, generator) -> TransportFrameCounters:
        if draws is None:
            draws = FrameDraws.draw(cfg, batch, generator, reroll=reroll, n_bits=chain.a)
        rx_c, rx_sc, replica = run(snr_db, draws,
                                   lambda b: transport.transport_encode(chain, b), incl_clean)
        nv = noise_var(cfg.modem.avg_symbol_power, snr_db)

        def decode_count(sym, sent):
            pay, ok = transport.transport_decode(chain, decoder_llr(sym, m, nv),
                                                 n_iters=ldpc_iters, algorithm=ldpc_algorithm)
            return pay, bits_ops.count_bit_errors(sent, pay, axis=-1), (~ok).to(torch.int32)

        b = draws.batch
        if incl_clean:
            _, clean_err, clean_blk = decode_count(rx_c, draws.bits_c.to(dev))
        else:
            clean_err = clean_blk = torch.zeros(b, dtype=torch.int32, device=dev)
        sent = draws.bits_d.to(dev)
        d_est = torch.zeros_like(rx_sc)
        errs, blks = [], []
        for _ in range(n_iters + 1):
            pay, err, blk = decode_count(rx_sc - d_est, sent)
            errs.append(err)
            blks.append(blk)
            resym = qam.modulate_bits(transport.transport_encode(chain, pay), m)
            d_est = replica(resym) - resym
        return TransportFrameCounters(clean_err=clean_err, clean_blk=clean_blk,
                                      dist_err=torch.stack(errs, 1),
                                      dist_blk=torch.stack(blks, 1))

    return frame_signature(frame, False, cfg.pa.ibo_db)


def _seeded_round(frame_fn, batch: int, dev: torch.device, flatten):
    """``round_fn(key, idx, snr_db)``: ``batch`` frames drawn from a
    generator seeded by ``round_seed(key, idx)``, flattened by ``flatten``."""
    def round_fn(key: int, idx: int, snr_db) -> torch.Tensor:
        gen = torch.Generator(device=dev)
        gen.manual_seed(round_seed(key, idx))
        return flatten(frame_fn(snr_db, batch=batch, generator=gen))

    return round_fn


def _transport_flat(c: TransportFrameCounters) -> torch.Tensor:
    """One int32 vector ``[clean_err, dist_err..., clean_blk, dist_blk...]``
    of counters summed over the batch: a round's one fetch."""
    s = [x.sum(0, dtype=torch.int32) for x in c]
    return torch.cat([s[0][None], s[2], s[1][None], s[3]])


def make_coded_round_fn(cfg: LinkConfig, n_iters: int, batch: int,
                        code: ldpc.QcLdpcCode | None = None, ldpc_iters: int = 25, *,
                        incl_clean: bool = True, reroll: bool = True, device=None):
    """Raw-codeword Monte-Carlo round ``round_fn(key, idx, snr_db)`` -> ONE
    int32 tensor ``[clean_err, dist_err[0..n_iters]]`` summed over ``batch``
    frames (:func:`parallel.montecarlo.run_point`'s layout), on ``device``."""
    dev = resolve_device(device)
    frame_fn = make_coded_frame_fn(cfg, n_iters, code, ldpc_iters, incl_clean=incl_clean,
                                   reroll=reroll, device=dev)
    return _seeded_round(frame_fn, batch, dev,
                         lambda c: torch.cat([c.clean_err.sum(0, dtype=torch.int32)[None],
                                              c.dist_err.sum(0, dtype=torch.int32)]))


def make_transport_body_fn(cfg: LinkConfig, n_iters: int, chain: transport.TransportChain,
                           ldpc_iters: int = 25, *, ldpc_algorithm: str = "minsum",
                           incl_clean: bool = True, reroll: bool = True,
                           serial_decode: int = 0, nv_adjust: bool = False, device=None):
    """The transport round's body ``body(snr_db, draws) -> [2 (n_iters +
    2)]`` int32 (:func:`_transport_flat` of the frames' counters), the
    unit a sharded round runs per shard
    (``mimo_ofdm_tpu/models/link_ldpc.py:494-556``). ``body.draw(batch,
    generator)`` draws a round's frames."""
    frame_fn = make_transport_frame_fn(cfg, n_iters, chain, ldpc_iters,
                                       ldpc_algorithm=ldpc_algorithm, incl_clean=incl_clean,
                                       reroll=reroll, nv_adjust=nv_adjust,
                                       serial_decode=serial_decode, device=device)

    def body(snr_db, draws: FrameDraws) -> torch.Tensor:
        return _transport_flat(frame_fn(snr_db, draws))

    body.draw = lambda batch, generator: FrameDraws.draw(cfg, batch, generator,
                                                         reroll=reroll, n_bits=chain.a)
    return body


def make_transport_round_fn(cfg: LinkConfig, n_iters: int, batch: int,
                            chain: transport.TransportChain, ldpc_iters: int = 25, *,
                            ldpc_algorithm: str = "minsum", incl_clean: bool = True,
                            reroll: bool = True, serial_decode: int = 0,
                            nv_adjust: bool = False, device=None):
    """Transport-coded Monte-Carlo round ``round_fn(key, idx, snr_db)`` ->
    ONE int32 tensor ``[clean_err, dist_err..., clean_blk, dist_blk...]``
    summed over ``batch`` frames, on ``device`` (``cuda`` unless
    ``device="cpu"``); nothing in a round waits for the device."""
    dev = resolve_device(device)
    body = make_transport_body_fn(cfg, n_iters, chain, ldpc_iters,
                                  ldpc_algorithm=ldpc_algorithm, incl_clean=incl_clean,
                                  reroll=reroll, serial_decode=serial_decode,
                                  nv_adjust=nv_adjust, device=dev)

    def round_fn(key: int, idx: int, snr_db) -> torch.Tensor:
        gen = torch.Generator(device=dev)
        gen.manual_seed(round_seed(key, idx))
        return body(snr_db, body.draw(batch, gen))

    return round_fn


def make_transport_inloop_round_fn(cfg: LinkConfig, n_iters: int, batch: int,
                                   chain: transport.TransportChain, ldpc_iters: int = 25, *,
                                   ldpc_algorithm: str = "sumprod", incl_clean: bool = True,
                                   reroll: bool = True, device=None):
    """LDPC-in-the-loop Monte-Carlo round, the layout of
    :func:`make_transport_round_fn`."""
    dev = resolve_device(device)
    frame_fn = make_transport_inloop_frame_fn(cfg, n_iters, chain, ldpc_iters,
                                              ldpc_algorithm=ldpc_algorithm,
                                              incl_clean=incl_clean, reroll=reroll, device=dev)
    return _seeded_round(frame_fn, batch, dev, _transport_flat)
