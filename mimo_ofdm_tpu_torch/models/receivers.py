"""CNC clipping-noise-cancellation receivers
(port of ``mimo_ofdm_tpu/models/receivers.py:50-135``).

One generic iteration loop parameterized by a *replica function*, the model
of the TX chain whose output minus the detected symbols is the distortion
estimate:

* CNC  (``reference/corrector.py:52-112``): replica = IFFT -> clip -> FFT /
  alpha, a single nominal PA (:func:`make_cnc_replica`).
* MCNC (``reference/corrector.py:165-207``): replica = the full precoded
  array TX + channel + AGC divide (built by ``models/link_planar.py``).

The loop runs a fixed ``n_iters + 1`` detection passes and stacks every
pass's hard bits, as the JAX ``lax.scan`` does; here it is a Python loop.
"""

from __future__ import annotations

from typing import Callable

import torch

from mimo_ofdm_tpu_torch.ops import pa, qam
from mimo_ofdm_tpu_torch.ops.fused_chain import fused_sc_ifft_pa_fft_planar


def standard_receive_sc(rx_sc: torch.Tensor, constel_size: int) -> torch.Tensor:
    """Subcarrier-domain standard receive (data bins already extracted)."""
    return qam.demodulate_bits(rx_sc, constel_size)


def cnc_iterate(rx_sc: torch.Tensor, n_iters: int, constel_size: int,
                replica_fn: Callable[[torch.Tensor], torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Clipping-noise-cancellation loop on AGC-equalized data subcarriers
    ``rx_sc [..., n_sc]``. Pass 0 subtracts nothing
    (``reference/corrector.py:72-76``). Returns
    ``(bits [n_iters+1, ..., n_bits], symbols [n_iters+1, ..., n_sc])``."""
    d_est = torch.zeros_like(rx_sc)
    bits_all, sym_all = [], []
    for _ in range(n_iters + 1):
        det_sym, det_bits = qam.detect_symbols_and_bits(
            rx_sc - d_est, constel_size, dtype=rx_sc.dtype)
        bits_all.append(det_bits)
        sym_all.append(det_sym)
        d_est = replica_fn(det_sym) - det_sym
    return torch.stack(bits_all), torch.stack(sym_all)


def make_cnc_replica(constel_size: int, n_fft: int, n_sc: int, ibo_db: float,
                     pa_model: str = "softlim", alpha=None,
                     rapp_p: float = 1.1, storage: str = "float32"):
    """Replica of a single nominal PA at the receiver
    (``reference/corrector.py:87-110``): the average sample power is
    ``avg_symbol_power / upsample_factor`` (``reference/corrector.py:34-35``)
    and the result is divided by the analytic Bussgang alpha
    (``reference/corrector.py:104-107``). For ``toi`` the IBO is the
    intercept point. ``storage`` is the fused chain's plane dtype."""
    avg_samp_pow = qam.avg_symbol_power(constel_size) / (n_fft / n_sc)
    if pa_model == "toi":
        coeff = pa.toi_to_cubic_coeff(ibo_db, avg_samp_pow)
        sat = 1.0
        a = 1.0 if alpha is None else alpha
    else:
        coeff = 0.0
        sat = pa.ibo_to_sat_power(ibo_db, avg_samp_pow)
        a = float(pa.bussgang_alpha(ibo_db)) if alpha is None else alpha

    def replica(det_sym: torch.Tensor) -> torch.Tensor:
        est = fused_sc_ifft_pa_fft_planar(det_sym, n_fft, pa_model=pa_model,
                                          sat=sat, cubic_coeff=coeff,
                                          rapp_p=rapp_p, storage=storage)
        return est / a

    return replica
