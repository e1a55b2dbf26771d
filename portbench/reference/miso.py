"""Plain reference of the single-user MISO OFDM frame with a clipping PA and
the CNC / MCNC receivers: the same draws in, the per-frame bit-error
counters ``[clean, pass 0 .. pass n_iters]`` out.

Written from the simulator's published semantics (the reference repo's
``mp_model.py``, ``antenna_array.py``, ``channel.py``, ``corrector.py``,
``modulation.py``), with plain ``torch`` operations only: complex64
arithmetic with float32 sums (geometry and LOS phases in float64), the
transforms through ``torch.fft``, minimum-distance detection over the whole
constellation. It imports nothing of the program under test and takes
nothing the program made: the channel, the precoder, the AGC vectors and
the PA's saturation powers are worked out again from the draws.

``planes`` names the precision of the planes (:class:`Precision`):
``"float32"``, the reference, or a lower one such as ``"float8_e4m3fn"``:
every plane the configuration stores at its precision (channel, precoder,
their products, the precoded symbols, each transform pass's operand, the
chain's output, the propagated products) rounded to it, sums and the PA in
float32. That is the control of the benchmark's comparison: the reference
put in the program's place one precision below the configuration's.

Configurations taken: ``channel.model`` ``rayleigh`` (fade at the base RX
position) or ``los`` (RX moved per frame by the draws' offsets), ``mrt``
precoding, the ``softlim`` PA, one user, no CSI error, the data bins on a
linear array. Anything else raises ``ValueError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

C_LIGHT = 299_792_458.0


def check_supported(link: dict, receiver: str) -> None:
    """Raise ``ValueError`` for a configuration this reference does not model."""
    problems = []
    if link["channel"]["model"] not in ("rayleigh", "los"):
        problems.append(f"channel {link['channel']['model']!r}")
    if link["precoding"] != "mrt":
        problems.append(f"precoding {link['precoding']!r}")
    if link["pa"]["model"] != "softlim":
        problems.append(f"PA {link['pa']['model']!r}")
    if link["modem"]["n_users"] != 1:
        problems.append("several users")
    if link["csi_epsilon"] or link["csi_snr_db"] is not None:
        problems.append("CSI error")
    if link["array"]["geometry"] != "linear":
        problems.append(f"array {link['array']['geometry']!r}")
    if receiver not in ("cnc", "mcnc"):
        problems.append(f"receiver {receiver!r}")
    if problems:
        raise ValueError("the MISO reference does not model: " + ", ".join(problems))


def constellation(m: int) -> np.ndarray:
    """Square QAM as the reference builds it: a column snake of PAM levels,
    indexed by the Gray code of the bit pattern (MSB first)."""
    n = int(round(math.sqrt(m)))
    pam = np.arange(-n + 1, n, 2)
    snake = np.tile(np.hstack((pam, pam[::-1])), n // 2) * 1j + pam.repeat(n)
    gray = np.arange(m) ^ (np.arange(m) >> 1)
    return snake[gray.argsort()]


def bussgang_alpha(ibo_db: torch.Tensor) -> torch.Tensor:
    """Closed-form Bussgang gain of the ideal clipper at ``ibo_db``, float64."""
    g = 10.0 ** (ibo_db.to(torch.float64) / 20.0)
    return 1.0 - torch.exp(-g ** 2) + (math.sqrt(math.pi) * g / 2.0) * torch.special.erfc(g)


class Precision:
    """Where the planes are stored between the steps. At ``float32`` (the
    reference) nothing is rounded and the transforms are ``torch.fft``'s. At
    a lower precision every stored plane is rounded to it (both halves, with
    a power-of-two scale per row, the last axis, that puts the row's largest
    half near the top of the format), and each transform is computed in
    radix-16 passes whose operands are rounded so, sums in float32."""

    RADIX = 16

    def __init__(self, planes: str = "float32"):
        self.exact = planes == "float32"
        if not self.exact:
            self.dtype = getattr(torch, planes)
            self.top = min(torch.finfo(self.dtype).max, 2.0 ** 15)

    def store(self, z: torch.Tensor) -> torch.Tensor:
        if self.exact:
            return z
        parts = torch.stack([z.real, z.imag])
        amax = parts.abs().amax(dim=(0, -1), keepdim=True).clamp_min(1e-30)
        scale = torch.exp2(torch.floor(torch.log2(self.top / amax)))
        q = (parts * scale).to(self.dtype).to(torch.float32) / scale
        return torch.complex(q[0], q[1])

    def dft(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """Ortho-normalised DFT (``inverse``: IDFT) over the last axis."""
        if self.exact:
            return (torch.fft.ifft if inverse else torch.fft.fft)(x, norm="ortho")
        n = x.shape[-1]
        return self._passes(x, 1.0 if inverse else -1.0) / math.sqrt(n)

    def _passes(self, x: torch.Tensor, sign: float) -> torch.Tensor:
        """Unnormalised DFT by decimation in time: a radix pass over the
        leading digit, the twiddles, then the rest of the transform."""
        n = x.shape[-1]
        r = min(self.RADIX, n)
        k = torch.arange(r, device=x.device, dtype=torch.float64)
        f = torch.polar(torch.ones(r, r, dtype=torch.float64, device=x.device),
                        sign * 2 * math.pi * k[:, None] * k / r).to(torch.complex64)
        if n == r:
            return self.store(x) @ f
        m = n // r
        y = torch.einsum("...am,ak->...km", self.store(x.reshape(*x.shape[:-1], r, m)), f)
        n2 = torch.arange(m, device=x.device, dtype=torch.float64)
        tw = torch.polar(torch.ones(r, m, dtype=torch.float64, device=x.device),
                         sign * 2 * math.pi * k[:, None] * n2 / n).to(torch.complex64)
        z = self._passes(y * tw, sign)                               # [..., k1, k2]
        return z.transpose(-1, -2).reshape(*x.shape[:-1], n)


def _sc_grid(link: dict, dev) -> torch.Tensor:
    """RF frequency of each data subcarrier, in ``[neg | pos]`` order, float64."""
    n_sc = link["modem"]["n_sub_carr"]
    h = n_sc // 2
    k = np.concatenate([np.arange(-h, 0), np.arange(1, h + 1)])
    f = link["center_freq"] + link["carrier_spacing"] * k
    return torch.as_tensor(f, dtype=torch.float64, device=dev)


def _tx_positions(link: dict, dev) -> torch.Tensor:
    """Element positions of the uniform linear array along x, ``[n_ant, 3]``."""
    arr = link["array"]
    n = arr["n_elements"]
    lam = C_LIGHT / link["center_freq"]
    half = (n - 1) * arr["wav_len_spacing"] * lam / 2.0
    x = np.linspace(-half, half, n) if n > 1 else np.zeros(1)
    pos = np.stack([x, np.zeros(n), np.full(n, arr["cord_z"])], axis=1)
    return torch.as_tensor(pos, dtype=torch.float64, device=dev)


def channel(link: dict, draws: dict) -> torch.Tensor:
    """The true channel on the data subcarriers, complex64 ``[b, n_ant, n_sc]``."""
    dev = draws["bits_d"].device
    f = _sc_grid(link, dev)
    tx = _tx_positions(link, dev)
    rx = torch.tensor([link["rx"]["cord_x"], link["rx"]["cord_y"], link["rx"]["cord_z"]],
                      dtype=torch.float64, device=dev)
    skip_att = link["channel"]["skip_attenuation"]
    if link["channel"]["model"] == "rayleigh":
        d = ((tx - rx) ** 2).sum(-1).sqrt()                          # [A]
        att = (1.0 if skip_att else C_LIGHT / (4 * math.pi * d[:, None] * f)) * math.sqrt(0.5)
        fade = draws["fade"].to(torch.float64)                      # [b, 2, A, S]
        return torch.complex(fade[:, 0] * att, fade[:, 1] * att).to(torch.complex64)
    loc = draws["loc"].to(torch.float64)                            # [b, 2]
    rx_b = rx + torch.cat([loc, torch.zeros_like(loc[:, :1])], dim=-1)
    d = ((tx[None] - rx_b[:, None]) ** 2).sum(-1).sqrt()             # [b, A]
    theta = 2 * math.pi * d[..., None] * f / C_LIGHT
    att = 1.0 if skip_att else C_LIGHT / (4 * math.pi * d[..., None] * f)
    return torch.polar(att * torch.ones_like(theta), theta).to(torch.complex64)


def chain(x: torch.Tensor, n_fft: int, sat: torch.Tensor,
          prec: Precision = Precision()) -> torch.Tensor:
    """``extract(FFT(clip(IFFT(embed(x)))))`` over the last axis: the data
    bins embedded around an unused DC bin, ortho transforms, the soft limiter
    at saturation power ``sat`` (per row, broadcast) in float32, the data
    bins read back."""
    n_sc = x.shape[-1]
    h = n_sc // 2
    full = torch.zeros((*x.shape[:-1], n_fft), dtype=x.dtype, device=x.device)
    full[..., 1:h + 1] = x[..., h:]
    full[..., n_fft - h:] = x[..., :h]
    td = prec.dft(full, inverse=True)
    p = td.real ** 2 + td.imag ** 2
    scale = torch.where(p <= sat, torch.ones_like(p), torch.sqrt(sat / p.clamp_min(1e-30)))
    fd = prec.dft(td * scale, inverse=False)
    return torch.cat([fd[..., -h:], fd[..., 1:h + 1]], dim=-1)


class Qam:
    """Gray-mapped square QAM: bits to symbols and minimum-distance
    detection back to bits, on one device."""

    def __init__(self, m: int, dev):
        self.bps = int(round(math.log2(m)))
        self.points = torch.as_tensor(constellation(m), dtype=torch.complex64, device=dev)
        self.avg_power = float(np.mean(np.abs(constellation(m)) ** 2))
        self.weights = 2 ** torch.arange(self.bps - 1, -1, -1, device=dev)

    def modulate(self, bits: torch.Tensor) -> torch.Tensor:
        b = bits.to(torch.int64).reshape(*bits.shape[:-1], -1, self.bps)
        return self.points[(b * self.weights).sum(-1)]

    def detect(self, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Nearest points and their bits ``[..., n_sym * bps]`` (int64)."""
        idx = (y[..., None] - self.points).abs().argmin(-1)
        bits = (idx[..., None] // self.weights) % 2
        return self.points[idx], bits.reshape(*y.shape[:-1], -1)


def _awgn(sig, normals, snr_db, avg_power):
    """Add unit complex normals (real, imag on axis -2) at ``snr_db``
    against ``avg_power`` (per frame, ``[b]``)."""
    noise = torch.complex(normals[:, 0], normals[:, 1]) * math.sqrt(0.5)
    amp = torch.sqrt(avg_power / 10.0 ** (snr_db / 10.0)).to(torch.float32)
    return sig + noise * amp[:, None]


def frame_counters(link: dict, receiver: str, n_iters: int, snr_db: float,
                   draws: dict, planes: str = "float32") -> torch.Tensor:
    """Bit errors of each frame of ``draws`` (a dict of the frames'
    ``fade``/``loc``, ``bits_c``, ``bits_d``, ``noise_c``, ``noise_d``), int64
    ``[b, n_iters + 2]``: the clean run, then each CNC/MCNC pass."""
    check_supported(link, receiver)
    prec = Precision(planes)
    store = prec.store
    dev = draws["bits_d"].device
    m, n_fft = link["modem"]["constel_size"], link["modem"]["n_fft"]
    n_sc, n_ant = link["modem"]["n_sub_carr"], link["array"]["n_elements"]
    ibo = link["pa"]["ibo_db"]
    qam = Qam(m, dev)
    avg_samp = qam.avg_power * n_sc / n_fft

    h = store(channel(link, draws))                                   # [b, A, S]
    v = store(h.conj() / torch.sqrt((h.abs() ** 2).sum(-2, keepdim=True)))
    vk_pow = (v.abs() ** 2).sum(-1)                                   # [b, A]
    ibo_k = 10 * torch.log10(10 ** (ibo / 10) * n_sc / (vk_pow.double() * n_ant))
    ak = bussgang_alpha(ibo_k).to(torch.float32)
    hv_terms = store(h * v)
    hv = hv_terms.sum(-2)                                             # [b, S]
    akhv = (ak[..., None] * hv_terms).sum(-2)
    sat = (10 ** (ibo / 10) * avg_samp * vk_pow.sum(-1) / (n_ant * n_sc))   # [b]

    def errors(bits_tx, bits_rx):
        return (bits_tx.to(torch.int64) != bits_rx).sum(-1)

    sym_c = qam.modulate(draws["bits_c"])
    rx_c = _awgn(sym_c * hv, draws["noise_c"], snr_db, qam.avg_power * (hv.abs() ** 2).mean(-1))
    out = [errors(draws["bits_c"], qam.detect(rx_c / hv)[1])]

    def tx_propagate(sym):
        x = store(sym[:, None, :] * v)                                # [b, A, S]
        y = store(chain(x, n_fft, sat[:, None, None], prec))
        return store(h * y).sum(-2)

    bits_d = draws["bits_d"]
    rx_d = _awgn(tx_propagate(qam.modulate(bits_d)), draws["noise_d"], snr_db,
                 qam.avg_power * (akhv.abs() ** 2).mean(-1))
    rx_sc = rx_d / akhv
    if receiver == "cnc":
        alpha = float(bussgang_alpha(torch.tensor(float(ibo))))
        sat_c = torch.tensor(10 ** (ibo / 10) * qam.avg_power * n_sc / n_fft, device=dev)

        def replica(sym):
            return store(chain(store(sym), n_fft, sat_c, prec)) / alpha
    else:
        def replica(sym):
            return tx_propagate(sym) / akhv
    d_est = torch.zeros_like(rx_sc)
    for _ in range(n_iters + 1):
        det, bits = qam.detect(rx_sc - d_est)
        out.append(errors(bits_d, bits))
        d_est = replica(det) - det
    return torch.stack(out, dim=-1)
