"""Plain reference of the shared-subcarrier multi-user MISO OFDM frame with a
clipping PA and the CNC, CNC-MU and MCNC-MU receivers: the same draws in,
each user's bit-error counters ``[clean, pass 0 .. pass n_iters]`` out.

Written from the simulator's published semantics
(``main_multiuser/main_multiuser_cnc_ber_vs_ebn0.py``, ``antenna_array.py``,
``channel.py``, ``mp_model.py``, ``corrector.py:248-489``), with plain
``torch`` operations only, and the single-user reference's plain helpers
(``miso.py``: the constellation, the chain, the per-user channel, the
Bussgang gain, the AWGN and :class:`~portbench.reference.miso.Precision`).
It imports nothing of the program under test and takes nothing the program
made: the users' positions, channels, the joint precoder, the AGC vectors
and the PA's saturation power are worked out again from the draws. Complex64
arithmetic with float32 sums; the users' positions, the geometry and the
LOS channels in float64 (the Rayleigh channels' attenuation in float32,
as the fade the draws hold), the transforms through ``torch.fft``.

What it models, user ``u`` of ``U``:

* its position ``(cos(a) d, sin(a) d, cord_z)``, ``a = angle + 90`` deg, and
  its channel ``H_u``: Rayleigh from its own fade, or LOS at that position
  moved by its own RX offsets;
* the joint MRT, ``V_u = conj(H_u) / sqrt(sum_u sum_ant |H_u|^2)`` per
  subcarrier;
* the PA's saturation power from the mean precoding gain, each antenna and
  bin's power summed over the users; each antenna's IBO and Bussgang gain
  ``a_k`` from its power summed over the users and subcarriers;
* the equalisers ``sum_ant H_u V_u`` (clean run) and ``sum_ant a_k H_u V_u``
  (distorted run), and the noise powers from their mean ``|.|^2``;
* one TX of the users' summed precoded symbols through the chain, each
  user's antenna combine, noise and AGC divide, and a clean run without
  the PA;
* the receivers: ``cnc``, the single-PA replica of each user's
  detection; ``cnc_mu`` (two users), that replica of ``sqrt(2)/2 (own +
  other)`` with the other user's symbols known (``corrector.py:288-345``);
  ``mcnc_mu`` (two users), for each user the whole multi-user TX with its
  detection in place of its symbols and the other user's known, its own
  channel and its own ``sum_ant a_k H_u V_u`` divide
  (``corrector.py:405-451``).

Departures from the simulator: float32 in place of its float64 NumPy; one
OFDM symbol a frame, as the multi-user sweep counts frames; the clean run's
(I)FFT round trip left out, since it is the identity on the data bins; the
RX offsets and every random taken from the draws.

``planes`` names the precision of the planes, as in ``miso.py``:
``"float32"``, the reference, or a lower one. The multi-user frame keeps
its channels, precoder, AGC vectors and combines in complex64 at every
storage; only the chain stores planes at the configuration's precision
(``link_mu.py`` hands complex64 to ``transmit.ifft_pa_fft_sc``, which
takes the kernel's interleaved layout, ``ops/fused_chain.py``; its bf16
variant rounds the input's halves, each transform pass's operand and the
output). So at a lower precision these, and these alone, are rounded to
it: the chain's input (the users' summed precoded symbols of the TX and of
each MCNC-MU replica, each CNC replica's symbols), each transform pass's
operand, and the chain's output; sums and the PA in float32.

Configurations taken: ``channel.model`` ``rayleigh`` or ``los`` (each RX
moved per frame by its offsets), ``mrt`` precoding, the ``softlim`` PA, no
CSI error, a linear array, one symbol shared by every user on every
subcarrier, the receivers ``cnc`` (any number of users), ``cnc_mu`` and
``mcnc_mu`` (two users). Anything else raises ``ValueError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.miso import (C_LIGHT, Precision, Qam, _awgn, _sc_grid, _tx_positions,
                                     bussgang_alpha, chain, channel)

RECEIVERS = ("cnc", "cnc_mu", "mcnc_mu")
TWO_USER_RECEIVERS = ("cnc_mu", "mcnc_mu")


def check_supported(link: dict, receiver: str, draws: dict | None = None,
                    n_positions: int | None = None) -> None:
    """Raise ``ValueError`` for a configuration this reference does not
    model; ``draws`` and ``n_positions`` (the geometry's users), where
    given, have to be of the configuration's users."""
    problems = []
    n_users = link["modem"]["n_users"]
    if link["channel"]["model"] not in ("rayleigh", "los"):
        problems.append(f"channel {link['channel']['model']!r}")
    if link["precoding"] != "mrt":
        problems.append(f"precoding {link['precoding']!r}")
    if link["pa"]["model"] != "softlim":
        problems.append(f"PA {link['pa']['model']!r}")
    if link["csi_epsilon"] or link["csi_snr_db"] is not None:
        problems.append("CSI error")
    if link["array"]["geometry"] != "linear":
        problems.append(f"array {link['array']['geometry']!r}")
    if receiver not in RECEIVERS:
        problems.append(f"receiver {receiver!r}")
    elif receiver in TWO_USER_RECEIVERS and n_users != 2:
        problems.append(f"receiver {receiver!r} for {n_users} users")
    if n_positions is not None and n_positions != n_users:
        problems.append(f"{n_positions} user positions for {n_users} users")
    if draws is not None:
        if draws["bits_d"].ndim != 3:
            problems.append("the separate-subcarrier frame")
        elif draws["bits_d"].shape[1] != n_users:
            problems.append(f"draws of {draws['bits_d'].shape[1]} users for {n_users}")
    if problems:
        raise ValueError("the multi-user reference does not model: " + ", ".join(problems))


def user_positions(angles_deg, distances_m, cord_z: float) -> np.ndarray:
    """Each user's position ``[U, 3]``, float64: ``angle + 90`` deg from
    the x axis (the array's broadside is +y), at its distance, at height
    ``cord_z``."""
    a = np.deg2rad(np.asarray(angles_deg, np.float64) + 90.0)
    d = np.asarray(distances_m, np.float64)
    return np.stack([np.cos(a) * d, np.sin(a) * d, np.full_like(d, cord_z)], axis=1)


def rayleigh_channel(link: dict, fade: torch.Tensor, position) -> torch.Tensor:
    """One user's Rayleigh channel, complex64 ``[b, n_ant, n_sc]``: its unit
    normals ``fade [b, 2, n_ant, n_sc]`` times ``sqrt(1/2)``, times the
    free-space attenuation ``c / (4 pi d f)`` from each element to the
    user's position, in float32 (the distances from the float64
    geometry)."""
    dev = fade.device
    rx = torch.as_tensor(position, dtype=torch.float64, device=dev)
    d = ((_tx_positions(link, dev) - rx) ** 2).sum(-1).sqrt().to(torch.float32)   # [A]
    f = _sc_grid(link, dev).to(torch.float32)
    att = 1.0 if link["channel"]["skip_attenuation"] else C_LIGHT / (4 * math.pi * d[:, None] * f)
    s = math.sqrt(0.5)
    return torch.complex(fade[:, 0] * s, fade[:, 1] * s) * att


def user_channels(link: dict, draws: dict, positions: np.ndarray) -> torch.Tensor:
    """Every user's channel on the data subcarriers, complex64 ``[b, U,
    n_ant, n_sc]``: Rayleigh from the user's own fade
    (:func:`rayleigh_channel`), or the single-user LOS channel with the RX at
    the user's position moved by the user's own offsets."""
    out = []
    for u, (x, y, z) in enumerate(positions):
        if link["channel"]["model"] == "rayleigh":
            out.append(rayleigh_channel(link, draws["fade"][:, u], (x, y, z)))
        else:
            at = dict(link, rx=dict(link["rx"], cord_x=float(x), cord_y=float(y),
                                    cord_z=float(z)))
            out.append(channel(at, {"bits_d": draws["bits_d"], "loc": draws["loc"][:, u]}))
    return torch.stack(out, dim=1)


def _awgn_users(sig, normals, snr_db, avg_power):
    """:func:`~portbench.reference.miso._awgn` of each user: ``sig [b, U,
    n]``, ``normals [b, U, 2, n]``, ``avg_power [b, U]``."""
    b, users, n = sig.shape
    return _awgn(sig.reshape(b * users, n), normals.reshape(b * users, 2, n), snr_db,
                 avg_power.reshape(b * users)).reshape(b, users, n)


def frame_counters(link: dict, receiver: str, n_iters: int, snr_db: float, draws: dict,
                   planes: str = "float32", *, angles_deg, distances_m,
                   cord_z) -> torch.Tensor:
    """Bit errors of each user of each frame of ``draws`` (a dict of the
    frames' ``fade``/``loc`` ``[b, U, ...]``, ``bits_c``, ``bits_d`` ``[b,
    U, n_bits]``, ``noise_c``, ``noise_d`` ``[b, U, 2, n_sc]``), int64
    ``[b, U, n_iters + 2]``: the clean run, then each receiver pass. The
    users stand at ``angles_deg``/``distances_m``/``cord_z``."""
    check_supported(link, receiver, draws, len(angles_deg))
    prec = Precision(planes)
    store = prec.store
    dev = draws["bits_d"].device
    m, n_fft = link["modem"]["constel_size"], link["modem"]["n_fft"]
    n_sc, n_ant = link["modem"]["n_sub_carr"], link["array"]["n_elements"]
    ibo = link["pa"]["ibo_db"]
    qam = Qam(m, dev)
    avg_samp = qam.avg_power * n_sc / n_fft

    h = user_channels(link, draws, user_positions(angles_deg, distances_m, cord_z))
    v = h.conj() / torch.sqrt((h.abs() ** 2).sum((1, 2), keepdim=True))   # [b, U, A, S]
    gain = (v.abs() ** 2).sum(1)                                       # [b, A, S]
    sat = 10 ** (ibo / 10) * avg_samp * gain.mean((-2, -1))            # [b]
    vk_pow = gain.sum(-1)                                              # [b, A]
    ibo_k = 10 * torch.log10(10 ** (ibo / 10) * n_sc / (vk_pow.double() * n_ant))
    ak = bussgang_alpha(ibo_k).to(torch.float32)
    hv_terms = h * v
    hv = hv_terms.sum(2)                                               # [b, U, S]
    akhv = (ak[:, None, :, None] * hv_terms).sum(2)

    def precode(sym):
        """The users' summed precoded symbols ``[b, A, S]`` of ``[b, U, S]``."""
        return (sym[:, :, None, :] * v).sum(1)

    def tx(sym):
        return store(chain(store(precode(sym)), n_fft, sat[:, None, None], prec))

    def errors(bits_tx, bits_rx):
        return (bits_tx.to(torch.int64) != bits_rx).sum(-1)

    sym_c = qam.modulate(draws["bits_c"])                              # [b, U, S]
    rx_c = _awgn_users((h * precode(sym_c)[:, None]).sum(2), draws["noise_c"], snr_db,
                       qam.avg_power * (hv.abs() ** 2).mean(-1))
    out = [errors(draws["bits_c"], qam.detect(rx_c / hv)[1])]

    bits_d = draws["bits_d"]
    sym_d = qam.modulate(bits_d)
    rx_d = _awgn_users((h * tx(sym_d)[:, None]).sum(2), draws["noise_d"], snr_db,
                       qam.avg_power * (akhv.abs() ** 2).mean(-1))
    rx_sc = rx_d / akhv
    if receiver in ("cnc", "cnc_mu"):
        alpha = float(bussgang_alpha(torch.tensor(float(ibo))))
        sat_c = torch.tensor(10 ** (ibo / 10) * qam.avg_power * n_sc / n_fft, device=dev)

        def one_pa(sym):
            return store(chain(store(sym), n_fft, sat_c, prec)) / alpha

        if receiver == "cnc":
            replica = one_pa
        else:
            w = float(np.sqrt(np.float32(2.0)) / np.float32(2.0))
            other = sym_d.flip(1)

            def replica(sym):
                return one_pa(w * sym + w * other)
    else:
        def replica(sym):
            out_u = []
            for u in range(sym.shape[1]):
                mine = sym_d.clone()
                mine[:, u] = sym[:, u]
                out_u.append((h[:, u] * tx(mine)).sum(1) / akhv[:, u])
            return torch.stack(out_u, dim=1)
    d_est = torch.zeros_like(rx_sc)
    for _ in range(n_iters + 1):
        det, bits = qam.detect(rx_sc - d_est)
        out.append(errors(bits_d, bits))
        d_est = replica(det) - det
    return torch.stack(out, dim=-1)
