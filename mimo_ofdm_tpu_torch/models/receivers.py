"""The standard receiver and the CNC clipping-noise-cancellation receivers
(port of ``mimo_ofdm_tpu/models/receivers.py``).

One generic iteration loop parameterized by a *replica function*, the model
of the TX chain whose output minus the detected symbols is the distortion
estimate:

* CNC  (``reference/corrector.py:52-112``): replica = IFFT -> clip -> FFT /
  alpha, a single nominal PA (:func:`make_cnc_replica`).
* MCNC (``reference/corrector.py:165-207``): replica = the full precoded
  array TX + channel + AGC divide (:func:`make_mcnc_replica`; the planar
  frame builds its own on planes).
* CNC-MU / MCNC-MU (``reference/corrector.py:248-489``): the two-user
  variants with the other user's symbols known
  (:func:`make_cnc_mu_replica`, :func:`make_mcnc_mu_replica`).

The loop runs a fixed ``n_iters + 1`` detection passes and stacks every
pass's hard bits, as the JAX ``lax.scan`` does; here it is a Python loop.
The frames call it on their equalized data subcarriers; the single-call
receivers :func:`standard_receive`, :func:`cnc_receive` and
:func:`mcnc_receive` take full-band frames (``[..., n_fft]``, after
:func:`equalize`) and extract the data bins first.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models import channels, transmit
from mimo_ofdm_tpu_torch.ops import ofdm, pa, qam
from mimo_ofdm_tpu_torch.utils.spans import OFF, enabled, span


def equalize(rx_fd: torch.Tensor, agc_nfft: torch.Tensor) -> torch.Tensor:
    """Divide the received frame by the AGC vector
    (``reference/mp_model.py:165,214``)."""
    return rx_fd / agc_nfft


def standard_receive(rx_fd: torch.Tensor, n_sc: int, constel_size: int,
                     alpha: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Hard bits ``[..., n_bits]`` of equalized full-band frames ``[...,
    n_fft]``: the data bins demapped against the ``alpha``-scaled grid
    (``reference/mp_model.py:165-169``; the CP round trip is the identity,
    so the frame is demapped in the frequency domain)."""
    return qam.demodulate_bits(ofdm.extract_subcarriers(rx_fd, n_sc), constel_size, alpha)


def standard_receive_sc(rx_sc: torch.Tensor, constel_size: int,
                        alpha: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Subcarrier-domain standard receive (data bins already extracted)."""
    return qam.demodulate_bits(rx_sc, constel_size, alpha)


def cnc_iterate(rx_sc: torch.Tensor, n_iters: int, constel_size: int,
                replica_fn: Callable[[torch.Tensor], torch.Tensor],
                detect_alpha: torch.Tensor | float = 1.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Clipping-noise-cancellation loop on AGC-equalized data subcarriers
    ``rx_sc [..., n_sc]``. Pass 0 subtracts nothing
    (``reference/corrector.py:72-76``); each pass detects against the
    ``detect_alpha``-scaled grid. Returns ``(bits [n_iters+1, ...,
    n_bits], symbols [n_iters+1, ..., n_sc])``."""
    d_est = torch.zeros_like(rx_sc)
    bits_all, sym_all = [], []
    for i in range(n_iters + 1):
        with span("rx.pass", index=i) if enabled() else OFF:
            with span("rx.detect"):
                det_sym, det_bits = qam.detect_symbols_and_bits(
                    rx_sc - d_est, constel_size, detect_alpha, dtype=rx_sc.dtype)
            bits_all.append(det_bits)
            sym_all.append(det_sym)
            d_est = _replica_update(replica_fn, det_sym)
    return torch.stack(bits_all), torch.stack(sym_all)


def cnc_iterate_soft(rx_sc: torch.Tensor, n_iters: int, constel_size: int,
                     replica_fn: Callable[[torch.Tensor], torch.Tensor],
                     detect_alpha: torch.Tensor | float = 1.0) -> torch.Tensor:
    """The CNC loop returning each pass's *corrected* (distortion-subtracted,
    pre-detection) signal ``[n_iters+1, ..., n_sc]``, the symbols the coded
    link demaps softly (``reference/corrector.py:83-84`` with
    ``return_bits=False``). The replica runs on every pass, the last one
    too, as in :func:`cnc_iterate`."""
    d_est = torch.zeros_like(rx_sc)
    corr_all = []
    for i in range(n_iters + 1):
        with span("rx.pass", index=i) if enabled() else OFF:
            with span("rx.detect"):
                corr = rx_sc - d_est
                det_sym, _ = qam.detect_symbols_and_bits(corr, constel_size, detect_alpha,
                                                         dtype=rx_sc.dtype)
            corr_all.append(corr)
            d_est = _replica_update(replica_fn, det_sym)
    return torch.stack(corr_all)


def _replica_update(replica_fn, det_sym: torch.Tensor) -> torch.Tensor:
    """The next pass's distortion estimate, ``replica_fn(det_sym) - det_sym``."""
    with span("rx.replica"):
        replica = replica_fn(det_sym)
    with span("rx.update"):
        return replica - det_sym


def make_cnc_replica(constel_size: int, n_fft: int, n_sc: int, ibo_db: float,
                     pa_model: str = "softlim", alpha=None,
                     rapp_p: float = 1.1, toi_db: float | None = None,
                     use_mxu_fft: bool = False, mxu_storage: str = "float32"):
    """Replica of a single nominal PA at the receiver
    (``reference/corrector.py:87-110``): the average sample power is
    ``avg_symbol_power / upsample_factor`` (``reference/corrector.py:34-35``)
    and the result is divided by the analytic Bussgang alpha
    (``reference/corrector.py:104-107``). For ``toi`` the intercept point
    is ``toi_db``, or the IBO when it is None. ``ibo_db`` is a Python float,
    so nothing here touches the device."""
    avg_samp_pow = qam.avg_symbol_power(constel_size) / (n_fft / n_sc)
    if pa_model == "toi":
        coeff = pa.toi_to_cubic_coeff(ibo_db if toi_db is None else toi_db, avg_samp_pow)
        sat = 1.0
        a = 1.0 if alpha is None else alpha
    else:
        coeff = 0.0
        sat = pa.ibo_to_sat_power(ibo_db, avg_samp_pow)
        a = float(pa.bussgang_alpha(ibo_db)) if alpha is None else alpha

    def replica(det_sym: torch.Tensor) -> torch.Tensor:
        est = transmit.ifft_pa_fft_sc(det_sym, n_fft, pa_model, sat, rapp_p,
                                      coeff, use_mxu_fft=use_mxu_fft,
                                      mxu_storage=mxu_storage)
        return est / a

    return replica


def make_mcnc_replica(h_sc: torch.Tensor, v: torch.Tensor,
                      agc_corr_sc: torch.Tensor, *, constel_size: int,
                      n_fft: int, n_sc: int, pa_model: str = "softlim",
                      sat_power, rapp_p: float = 1.1, toi_coeff=0.0,
                      use_mxu_fft: bool = False, mxu_storage: str = "float32",
                      ant_group=None):
    """Replica of the full TX array + channel + AGC
    (``reference/corrector.py:198-205``): detected symbols ``[..., n_sc]``
    are precoded, clipped per antenna, propagated through ``h_sc [...,
    n_ant, n_sc]`` on the data bins and divided by the ``sum_k a_k H_k V_k``
    AGC vector ``agc_corr_sc [..., n_sc]``. ``sat_power`` / ``toi_coeff``
    are per row of ``[..., n_ant]``. With ``ant_group``, ``h_sc`` and
    ``v`` hold this rank's antennas and the propagation all-reduces over
    the group (``mimo_ofdm_tpu/models/receivers.py:138-162``)."""
    def replica(det_sym: torch.Tensor) -> torch.Tensor:
        per_ant_sc = transmit.precode_symbols(det_sym, v)
        fd_dist_sc = transmit.ifft_pa_fft_sc(per_ant_sc, n_fft, pa_model,
                                             sat_power, rapp_p, toi_coeff,
                                             use_mxu_fft=use_mxu_fft,
                                             mxu_storage=mxu_storage)
        return channels.propagate(h_sc, fd_dist_sc, ant_group=ant_group) / agc_corr_sc

    return replica


def make_cnc_mu_replica(other_usr_symbols: torch.Tensor, *, constel_size: int,
                        n_fft: int, n_sc: int, ibo_db: float,
                        pa_model: str = "softlim", alpha=None,
                        rapp_p: float = 1.1, use_mxu_fft: bool = False,
                        mxu_storage: str = "float32"):
    """Two-user CNC replica with the other user's symbols known
    (``reference/corrector.py:288-345``): the equal-power combine
    ``sqrt(2)/2 (own + other)`` meets the single-PA replica.
    ``other_usr_symbols`` broadcasts against the detected symbols."""
    base = make_cnc_replica(constel_size, n_fft, n_sc, ibo_db, pa_model, alpha,
                            rapp_p, use_mxu_fft=use_mxu_fft, mxu_storage=mxu_storage)
    w = float(np.sqrt(np.float32(2.0)) / np.float32(2.0))

    def replica(det_sym: torch.Tensor) -> torch.Tensor:
        return base(w * det_sym + w * other_usr_symbols)

    return replica


def make_mcnc_mu_replica(usr_symbols: torch.Tensor, h_sc: torch.Tensor,
                         v: torch.Tensor, agc_corr_sc: torch.Tensor, *,
                         constel_size: int, n_fft: int, n_sc: int,
                         pa_model: str = "softlim", sat_power, rapp_p: float = 1.1,
                         use_mxu_fft: bool = False, mxu_storage: str = "float32",
                         ant_group=None):
    """Multi-user MCNC replica (``reference/corrector.py:405-451``) of every
    user at once, users first: user ``u``'s detected symbols and the known
    symbols of the other users, in user order, go through the full
    multi-user TX (precode ``v [..., n_ant, n_usr, n_sc]``, summed), user
    ``u``'s channel and its AGC divide. The replica takes ``det_sym [n_usr,
    ..., n_sc]``; ``usr_symbols [..., n_usr, n_sc]`` are all users' known
    symbols, of which user ``u``'s row is replaced by its detection; ``h_sc
    [n_usr, ..., n_ant, n_sc]`` and ``agc_corr_sc [n_usr, ..., n_sc]``. One
    chain pass covers all users' antenna rows; user ``u``'s slice equals
    the JAX package's two-user replica with ``usr_idx=u``. With
    ``ant_group``, ``h_sc`` and ``v`` hold this rank's antennas and the
    propagation all-reduces over the group
    (``mimo_ofdm_tpu/models/receivers.py:188-210``). On the fused chain the
    swap and the precode run in the kernel's load
    (:func:`transmit.precode_ifft_pa_fft_sc`)."""
    def replica(det_sym: torch.Tensor) -> torch.Tensor:
        with span("mu.precode"):
            det = det_sym.contiguous()
        fd_dist_sc = transmit.precode_ifft_pa_fft_sc(
            usr_symbols, v, n_fft, pa_model, sat_power, rapp_p, det_sym=det,
            use_mxu_fft=use_mxu_fft, mxu_storage=mxu_storage)
        with span("mu.combine"):
            return channels.propagate(h_sc, fd_dist_sc, ant_group=ant_group) / agc_corr_sc

    return replica


def cnc_receive(rx_fd: torch.Tensor, n_iters: int, *, constel_size: int, n_sc: int,
                ibo_db: float, pa_model: str = "softlim", alpha=None) -> torch.Tensor:
    """CNC receive of equalized full-band frames ``[..., n_fft]``: extract
    the data bins and iterate with the single-PA replica on ``torch.fft``.
    Returns hard bits ``[n_iters+1, ..., n_bits]``
    (``reference/corrector.py:52-112``). ``ibo_db`` and ``alpha`` are
    Python floats, so the loop never waits for the device."""
    rx_sc = ofdm.extract_subcarriers(rx_fd, n_sc)
    replica = make_cnc_replica(constel_size, rx_fd.shape[-1], n_sc, ibo_db, pa_model,
                               alpha)
    return cnc_iterate(rx_sc, n_iters, constel_size, replica)[0]


def mcnc_receive(rx_fd: torch.Tensor, n_iters: int, h_fd: torch.Tensor,
                 v: torch.Tensor, agc_corr_nfft: torch.Tensor, *, constel_size: int,
                 n_sc: int, pa_model: str = "softlim", sat_power) -> torch.Tensor:
    """MCNC receive of equalized full-band frames ``rx_fd [..., n_fft]``
    with the full-band channel ``h_fd [..., n_ant, n_fft]``, the precoder
    ``v [..., n_ant, n_sc]`` and the distorted-signal AGC vector
    ``agc_corr_nfft [..., n_fft]``: the data bins of all three are
    extracted and the full-array replica (:func:`make_mcnc_replica`, on
    ``torch.fft``) iterates. ``sat_power`` is per row of ``[..., n_ant]``.
    Returns hard bits ``[n_iters+1, ..., n_bits]``
    (``reference/corrector.py:165-207``)."""
    rx_sc = ofdm.extract_subcarriers(rx_fd, n_sc)
    replica = make_mcnc_replica(
        ofdm.extract_subcarriers(h_fd, n_sc), v,
        ofdm.extract_subcarriers(agc_corr_nfft, n_sc), constel_size=constel_size,
        n_fft=rx_fd.shape[-1], n_sc=n_sc, pa_model=pa_model, sat_power=sat_power)
    return cnc_iterate(rx_sc, n_iters, constel_size, replica)[0]
