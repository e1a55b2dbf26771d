"""Transmit side: symbol mapping, precoding and the distorted-TX core
(port of ``mimo_ofdm_tpu/models/transmit.py``).

    bits -> QAM symbols [..., n_sc] -> precode [..., n_ant, n_sc]
            (several users: summed over users before the chain)
         -> embed subcarriers -> ortho IFFT -> per-row PA -> ortho FFT

With ``use_mxu_fft`` (the JAX package's name for "run the fused chain") and
a transform the kernel takes, the IFFT -> PA -> FFT core is one launch of
the fused CUDA kernel (``sc`` mode on the data bins, ``full`` mode on whole
frames); otherwise it is the plain ``torch.fft`` chain, as the JAX package
uses ``jnp.fft`` there.

PA parameters (``sat_power``, ``toi_coeff``) are per row: a Python scalar,
or a tensor that broadcasts against the signal's leading dims (one value
per frame, or per frame and antenna).
"""

from __future__ import annotations

import torch

from mimo_ofdm_tpu_torch.ops import fused_chain, ofdm, pa, qam
from mimo_ofdm_tpu_torch.utils.spans import OFF, enabled, span


def modulate_users(bits: torch.Tensor, constel_size: int,
                   dtype=torch.complex64) -> torch.Tensor:
    """bits ``[..., n_bits]`` (or ``[..., n_usr, n_bits]``) -> symbols
    ``[..., n_sc]`` (``[..., n_usr, n_sc]``) (``reference/modulation.py:346-367``)."""
    return qam.modulate_bits(bits, constel_size, dtype)


def precode_symbols(symbols: torch.Tensor, v: torch.Tensor,
                    sum_users: bool | None = None) -> torch.Tensor:
    """Frequency-domain precoding.

    * single user (``sum_users=None``): ``symbols [..., n_sc]`` times ``v
      [..., n_ant, n_sc]`` -> ``[..., n_ant, n_sc]``
      (``reference/modulation.py:373``);
    * multi-user: ``symbols [..., n_usr, n_sc]`` and ``v [..., n_ant, n_usr,
      n_sc]`` -> the users' sum ``[..., n_ant, n_sc]`` with
      ``sum_users=True``, or per user ``[..., n_usr, n_ant, n_sc]`` with
      ``False`` (``reference/modulation.py:373-382``)."""
    if sum_users is None:
        return symbols[..., None, :] * v
    if sum_users:
        return fused_chain.precode_users(symbols, v)
    return symbols[..., :, None, :] * v.transpose(-3, -2)


def _per_sample(v):
    """A per-row PA parameter broadcast over the sample axis."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def make_pa_fn(pa_model: str, sat_power, rapp_p: float = 1.1, toi_coeff=0.0):
    """Closure applying the per-row PA to time samples on the last axis."""
    sat, coeff = _per_sample(sat_power), _per_sample(toi_coeff)

    def pa_fn(td_sig: torch.Tensor) -> torch.Tensor:
        return pa.apply_pa(td_sig, pa_model, sat, rapp_p, coeff)

    return pa_fn


def pa_transfer(td_sig: torch.Tensor, pa_model: str, sat_power,
                rapp_p: float = 1.1, toi_coeff=0.0) -> torch.Tensor:
    """Apply the per-row PA in the time domain."""
    return make_pa_fn(pa_model, sat_power, rapp_p, toi_coeff)(td_sig)


def ifft_pa_fft(fd_clean: torch.Tensor, pa_model: str, sat_power,
                rapp_p: float = 1.1, toi_coeff=0.0, use_mxu_fft: bool = False,
                mxu_storage: str = "float32") -> torch.Tensor:
    """The distorted-TX core on whole ``[..., n_fft]`` frames: ortho IFFT ->
    per-row PA -> ortho FFT; the kernel's ``full`` mode with
    ``use_mxu_fft``."""
    n_fft = fd_clean.shape[-1]
    with span("chain", rows=fd_clean.numel() // n_fft) if enabled() else OFF:
        if use_mxu_fft and fused_chain.kernel_eligible(n_fft, n_fft, "full"):
            return fused_chain.fused_ifft_pa_fft_planar(
                fd_clean, pa_model=pa_model, sat=sat_power, cubic_coeff=toi_coeff,
                rapp_p=rapp_p, storage=mxu_storage)
        td_dist = pa_transfer(ofdm.fd_to_td(fd_clean), pa_model, sat_power, rapp_p,
                              toi_coeff)
        return ofdm.td_to_fd(td_dist)


def ifft_pa_fft_sc(per_ant_sc: torch.Tensor, n_fft: int, pa_model: str,
                   sat_power, rapp_p: float = 1.1, toi_coeff=0.0,
                   use_mxu_fft: bool = False,
                   mxu_storage: str = "float32") -> torch.Tensor:
    """The distorted-TX core on the data bins:
    ``extract_sc(FFT(PA(IFFT(map_sc(x)))))`` for ``[..., n_sc]``; the
    kernel's ``sc`` mode with ``use_mxu_fft``, where the full-band frame is
    never formed (``reference/antenna_array.py:110-140`` then the strip of
    ``reference/corrector.py:66``)."""
    n_sc = per_ant_sc.shape[-1]
    with span("chain", rows=per_ant_sc.numel() // n_sc) if enabled() else OFF:
        if use_mxu_fft and fused_chain.kernel_eligible(n_fft, n_sc, "sc"):
            return fused_chain.fused_sc_ifft_pa_fft_planar(
                per_ant_sc, n_fft, pa_model=pa_model, sat=sat_power,
                cubic_coeff=toi_coeff, rapp_p=rapp_p, storage=mxu_storage)
        fd_clean = ofdm.map_subcarriers(per_ant_sc, n_fft)
        fd_dist = ifft_pa_fft(fd_clean, pa_model, sat_power, rapp_p, toi_coeff,
                              use_mxu_fft=use_mxu_fft, mxu_storage=mxu_storage)
        return ofdm.extract_subcarriers(fd_dist, n_sc)


def precode_ifft_pa_fft_sc(usr_symbols: torch.Tensor, v: torch.Tensor, n_fft: int,
                           pa_model: str, sat_power, rapp_p: float = 1.1, toi_coeff=0.0, *,
                           det_sym: torch.Tensor | None = None, use_mxu_fft: bool = False,
                           mxu_storage: str = "float32") -> torch.Tensor:
    """The multi-user transmitter on the data bins: every user's symbols
    ``usr_symbols [..., n_usr, n_sc]`` precoded by ``v [..., n_ant, n_usr,
    n_sc]`` and summed over users (:func:`precode_symbols`), then
    :func:`ifft_pa_fft_sc`, giving ``[..., n_ant, n_sc]``. With the
    detections ``det_sym [n_usr, ..., n_sc]`` of an MCNC-MU replica pass,
    user ``r``'s rows ``[r, ..., n_ant, n_sc]`` precode the symbols with
    user ``r``'s swapped for ``det_sym[r]``
    (``reference/corrector.py:405-451``). With ``use_mxu_fft`` and a
    complex64 transform the kernel takes, one launch of the fused kernel
    whose load computes the precode
    (``fused_chain.fused_precoded_mu_ifft_pa_fft``), bit for bit the
    precode followed by the chain."""
    n_sc = usr_symbols.shape[-1]
    inputs = (usr_symbols, v) if det_sym is None else (usr_symbols, v, det_sym)
    if (use_mxu_fft and fused_chain.kernel_eligible(n_fft, n_sc, "sc")
            and all(t.dtype == torch.complex64 for t in inputs)):
        rows = v.shape[:-2].numel() * (1 if det_sym is None else usr_symbols.shape[-2])
        with span("chain", rows=rows) if enabled() else OFF:
            return fused_chain.fused_precoded_mu_ifft_pa_fft(
                usr_symbols, v, sat_power, toi_coeff, det_sym=det_sym, pa_model=pa_model,
                n_fft=n_fft, rapp_p=rapp_p, storage=mxu_storage)
    sym = (usr_symbols if det_sym is None
           else fused_chain.swap_detections(det_sym, usr_symbols))
    return ifft_pa_fft_sc(precode_symbols(sym, v, sum_users=True), n_fft, pa_model, sat_power,
                          rapp_p, toi_coeff, use_mxu_fft=use_mxu_fft, mxu_storage=mxu_storage)


def array_transmit_fd(bits: torch.Tensor, *, constel_size: int, n_fft: int,
                      v: torch.Tensor, pa_model: str = "softlim",
                      sat_power=1.0, rapp_p: float = 1.1, toi_coeff=0.0,
                      skip_dist: bool = False, return_clean: bool = False,
                      sum_users: bool | None = None, use_mxu_fft: bool = False,
                      mxu_storage: str = "float32"):
    """Array transmit to the frequency domain
    (``reference/antenna_array.py:58-140``): ``[..., n_ant, n_fft]``
    distorted frames, ``(distorted, clean)`` with ``return_clean``, or the
    clean frames alone with ``skip_dist``. ``sum_users`` as in
    :func:`precode_symbols` (``True``: the multi-user precoder ``v [...,
    n_ant, n_usr, n_sc]``, users summed; ``False``: ``[..., n_usr, n_ant,
    n_fft]``)."""
    symbols = modulate_users(bits, constel_size)
    fd_clean = ofdm.map_subcarriers(precode_symbols(symbols, v, sum_users), n_fft)
    if skip_dist:
        return fd_clean
    fd_dist = ifft_pa_fft(fd_clean, pa_model, sat_power, rapp_p, toi_coeff,
                          use_mxu_fft=use_mxu_fft, mxu_storage=mxu_storage)
    return (fd_dist, fd_clean) if return_clean else fd_dist


def array_transmit_sc(bits: torch.Tensor, *, constel_size: int, n_fft: int,
                      v: torch.Tensor, pa_model: str = "softlim", sat_power=1.0,
                      rapp_p: float = 1.1, toi_coeff=0.0,
                      sum_users: bool | None = None, use_mxu_fft: bool = False,
                      mxu_storage: str = "float32") -> torch.Tensor:
    """Array transmit straight to the ``[..., n_ant, n_sc]`` data bins
    (``mimo_ofdm_tpu/models/transmit.py:178-193``): modulate, precode
    (``sum_users`` as in :func:`precode_symbols`) and one pass of the
    distorted-TX core over every antenna row."""
    per_ant_sc = precode_symbols(modulate_users(bits, constel_size), v,
                                 sum_users=sum_users)
    return ifft_pa_fft_sc(per_ant_sc, n_fft, pa_model, sat_power, rapp_p,
                          toi_coeff, use_mxu_fft=use_mxu_fft,
                          mxu_storage=mxu_storage)


def array_transmit_td(bits: torch.Tensor, *, constel_size: int, n_fft: int,
                      cp_len: int, v: torch.Tensor, pa_model: str = "softlim",
                      sat_power=1.0, rapp_p: float = 1.1, toi_coeff=0.0,
                      skip_dist: bool = False,
                      sum_users: bool | None = None) -> torch.Tensor:
    """Time-domain output with the cyclic prefix, ``[..., n_ant, cp_len +
    n_fft]`` (the reference's ``out_domain_fd=False`` path,
    ``reference/transceiver.py:123-129,167-174``). The PA runs on the
    time samples, so this path has no FFT after it and no kernel."""
    per_ant_sc = precode_symbols(modulate_users(bits, constel_size), v, sum_users)
    td = ofdm.fd_to_td(ofdm.map_subcarriers(per_ant_sc, n_fft))
    if not skip_dist:
        td = pa_transfer(td, pa_model, sat_power, rapp_p, toi_coeff)
    return ofdm.add_cyclic_prefix(td, cp_len)
