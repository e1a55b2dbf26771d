"""MISO frequency-domain channels (port of
``mimo_ofdm_tpu/models/channels.py``): the antenna combine, TX-RX
distances, free-space attenuation and the channel matrices ``[..., n_ant,
n_f]`` in complex64 of the LOS, two-path, Rayleigh, Rician, random-paths
and TR 38.901 tapped-delay-line models, and the CSI error model.

A leading batch of RX positions ``[..., 3]`` (or of draws) gives a batch of
channels. The randoms are handed in as tensors, as everywhere in the port:
unit normals, and uniforms already scaled to their range
(:class:`RandomPathsDraws`, :class:`TdlDraws`).

Every phase is formed in the JAX source's float32 order: TDL delays reach
~4 us, where ``2 pi f tau`` is ~8e4 rad and one float32 ulp of it ~8e-3
rad. A Python scalar divided by a tensor goes through :func:`_rdiv`,
because ``scalar / tensor`` in torch is ``reciprocal(tensor) * scalar``,
which rounds twice."""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models.geometry import C_LIGHT
from mimo_ofdm_tpu_torch.ops import ofdm
from mimo_ofdm_tpu_torch.ops.noise import complex_normal
from mimo_ofdm_tpu_torch.parallel.collectives import ant_sum


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` with one rounding, as JAX divides."""
    return torch.full_like(t, num) / t


def _f32_sqrt(x: float) -> float:
    """``jnp.sqrt`` of a Python float: the float32 square root of its
    float32 value."""
    return float(np.sqrt(np.float32(x)))


def _f32(a, device) -> torch.Tensor | None:
    """A host array (or None) as a float32 tensor on ``device``, as
    ``jnp.asarray`` makes it without x64."""
    return None if a is None else torch.as_tensor(np.array(a, np.float32), device=device)


def propagate(channel_mat_fd: torch.Tensor, in_sig_mat: torch.Tensor,
              sum_signals: bool = True, ant_group=None) -> torch.Tensor:
    """``H o X`` then (optionally) the sum over the antenna axis ``-2``
    (``reference/channel.py:74-89``). With ``ant_group`` the arrays hold
    this rank's antennas, and the sum is the local one all-reduced over the
    group (``mimo_ofdm_tpu/models/channels.py:33-45``)."""
    out = in_sig_mat * channel_mat_fd
    return ant_sum(out, -2, ant_group) if sum_signals else out


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA computes it. torch's
    CPU ``sqrt`` is accurate to 0.5001 ulp and rounds the other way now and
    then; a distance one ulp off moves a ~2e4 rad phase by ~2e-3 rad. The
    float64 root rounded to float32 is correctly rounded."""
    return torch.sqrt(x.double()).to(x.dtype)


def _distances(tx_pos: torch.Tensor, rx_pos: torch.Tensor) -> torch.Tensor:
    """Euclidean TX-element -> RX distances ``[..., n_ant]``
    (``reference/channel.py:56-58``)."""
    return sqrt_rn(((tx_pos - rx_pos[..., None, :]) ** 2).sum(-1))


def _fs_attenuation(distances: torch.Tensor, freqs: torch.Tensor,
                    tx_gain_db: float = 0.0, rx_gain_db: float = 0.0
                    ) -> torch.Tensor:
    """Free-space amplitude attenuation ``sqrt(10^((gt+gr)/10)) * c/(4 pi d f)``
    (``reference/channel.py:65-67``)."""
    gain = math.sqrt(10.0 ** ((tx_gain_db + rx_gain_db) / 10.0))
    return gain * (C_LIGHT / (4.0 * math.pi * distances[..., :, None] * freqs))


def _path_phase(d: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """``exp(2j pi d f / c)`` with the phase formed in the JAX package's
    float32 order, ``((2 pi d) f) / c``."""
    theta = (2.0 * math.pi) * d[..., :, None] * freqs / C_LIGHT
    return torch.polar(torch.ones_like(theta), theta)


def los_channel(tx_pos: torch.Tensor, rx_pos: torch.Tensor, freqs: torch.Tensor,
                skip_attenuation: bool = False, tx_gain_db: float = 0.0,
                rx_gain_db: float = 0.0) -> torch.Tensor:
    """LOS channel ``H[a,f] = e^{2j pi d_a f / c} * att``
    (``reference/channel.py:35-72``)."""
    d = _distances(tx_pos, rx_pos)
    phase = _path_phase(d, freqs)
    if skip_attenuation:
        return phase
    return phase * _fs_attenuation(d, freqs, tx_gain_db, rx_gain_db)


def _mirror_distances(tx_pos: torch.Tensor, rx_pos: torch.Tensor) -> torch.Tensor:
    """Ground-reflection path lengths ``[..., n_ant]``: the elevation from
    the mirror image, then ``tz / sin(elev) + rz / sin(elev)``
    (``reference/channel.py:141-149``)."""
    rx = rx_pos[..., None, :]
    tz = tx_pos[..., :, 2]
    rz = rx[..., 2]
    horiz = sqrt_rn((tx_pos[..., :, 0] - rx[..., 0]) ** 2
                       + (tx_pos[..., :, 1] - rx[..., 1]) ** 2)
    sin_elev = torch.sin(torch.arctan((tz + rz) / horiz))
    return tz / sin_elev + rz / sin_elev


def two_path_channel(tx_pos: torch.Tensor, rx_pos: torch.Tensor,
                     freqs: torch.Tensor, skip_attenuation: bool = False,
                     tx_gain_db: float = 0.0, rx_gain_db: float = 0.0
                     ) -> torch.Tensor:
    """LOS plus a ground reflection with coefficient -1 at the mirror-image
    distance (``reference/channel.py:116-167``)."""
    d_los = _distances(tx_pos, rx_pos)
    d_sec = _mirror_distances(tx_pos, rx_pos)
    los_mat = _path_phase(d_los, freqs)
    sec_mat = -_path_phase(d_sec, freqs)
    if not skip_attenuation:
        los_mat = los_mat * _fs_attenuation(d_los, freqs, tx_gain_db, rx_gain_db)
        sec_mat = sec_mat * _fs_attenuation(d_sec, freqs, tx_gain_db, rx_gain_db)
    return los_mat + sec_mat


def rayleigh_channel(normals: torch.Tensor, tx_pos: torch.Tensor,
                     rx_pos: torch.Tensor, freqs: torch.Tensor,
                     skip_attenuation: bool = False, tx_gain_db: float = 0.0,
                     rx_gain_db: float = 0.0) -> torch.Tensor:
    """IID CN(0,1) per antenna and bin from unit ``normals [..., 2, n_ant,
    n_f]``, scaled by the LOS free-space attenuation
    (``reference/channel.py:234-251``)."""
    coeffs = complex_normal(normals.movedim(-3, -2))   # re/im axis to -2
    if skip_attenuation:
        return coeffs
    return coeffs * _fs_attenuation(_distances(tx_pos, rx_pos), freqs,
                                    tx_gain_db, rx_gain_db)


def rician_channel(normals: torch.Tensor, tx_pos: torch.Tensor,
                   rx_pos: torch.Tensor, freqs: torch.Tensor,
                   k_factor_db: float = 9.0,
                   skip_attenuation: bool = False) -> torch.Tensor:
    """Rician fading ``H = sqrt(K/(K+1)) H_los + sqrt(1/(K+1)) H_ray`` per
    antenna and bin, the scatter scaled to the LOS part's per-antenna mean
    power (``mimo_ofdm_tpu/models/channels.py:130-148``). ``normals``:
    ``[..., 2, n_ant, n_f]`` unit normals of the scatter."""
    k_lin = 10.0 ** (k_factor_db / 10.0)
    h_los = los_channel(tx_pos, rx_pos, freqs, skip_attenuation)
    scatter = complex_normal(normals.movedim(-3, -2))
    p_los = (h_los.abs() ** 2).mean(-1, keepdim=True)
    w_los = _f32_sqrt(k_lin / (k_lin + 1.0))
    w_sc = _f32_sqrt(1.0 / (k_lin + 1.0))
    return w_los * h_los + w_sc * scatter * torch.sqrt(p_los)


class RandomPathsDraws(NamedTuple):
    """Draws of the random-paths channel: ``angles [..., n_paths]`` uniform
    in ``[-pi/2, pi/2)`` and ``taus [..., n_paths]`` uniform in ``[0,
    max_delay_spread)`` (``mimo_ofdm_tpu/models/channels.py:119-121``)."""
    angles: torch.Tensor
    taus: torch.Tensor

    @staticmethod
    def draw(batch: int, generator: torch.Generator, n_paths: int,
             max_delay_spread: float) -> "RandomPathsDraws":
        dev = generator.device
        u = torch.rand((2, batch, n_paths), generator=generator, device=dev)
        return RandomPathsDraws(u[0] * math.pi - math.pi / 2,
                                u[1] * max_delay_spread)


def random_paths_channel(draws: RandomPathsDraws, tx_pos: torch.Tensor,
                         freqs: torch.Tensor) -> torch.Tensor:
    """Random-paths channel (IEEE 8429913 eq. (62) as the reference writes
    it, ``reference/channel.py:330-344``): ``H[a,f] = 1/sqrt(P) sum_p
    exp(-2j f (tau_p + delta_a sin(theta_p / c)))``, ``delta_a`` the
    element's distance to the first element
    (``mimo_ofdm_tpu/models/channels.py:110-127``). The sum runs over the
    paths one at a time, so no ``[..., n_ant, n_f, n_paths]`` tensor is
    formed. Independent of the RX position."""
    delta = torch.sqrt(((tx_pos - tx_pos[..., 0:1, :]) ** 2).sum(-1))   # [n_ant]
    arg = (draws.taus[..., None, :]
           + delta[:, None] * torch.sin(draws.angles / C_LIGHT)[..., None, :])
    w = -2.0 * freqs                                   # exact: a power of two
    h = None
    for p in range(arg.shape[-1]):
        term = torch.polar(torch.ones((), device=freqs.device),
                           w * arg[..., p:p + 1])
        h = term if h is None else h + term
    return h / _f32_sqrt(float(arg.shape[-1]))


# --- TR 38.901 tapped-delay-line profiles (TDL substitute for Quadriga) -----

# Tables 7.7.2-1..5: normalized delays (multiples of the delay spread) and
# per-tap powers [dB]; TDL-D/E carry a specular LOS component "los_db" on
# their first tap (mimo_ofdm_tpu/models/channels.py:153-220).
TDL_PROFILES: dict[str, dict] = {
    "tdl_a": {
        "delays": np.array([0.0000, 0.3819, 0.4025, 0.5868, 0.4610, 0.5375,
                            0.6708, 0.5750, 0.7618, 1.5375, 1.8978, 2.2242,
                            2.1718, 2.4942, 2.5119, 3.0582, 4.0810, 4.4579,
                            4.5695, 4.7966, 5.0066, 5.3043, 9.6586]),
        "powers_db": np.array([-13.4, 0.0, -2.2, -4.0, -6.0, -8.2, -9.9,
                               -10.5, -7.5, -15.9, -6.6, -16.7, -12.4, -15.2,
                               -10.8, -11.3, -12.7, -16.2, -18.3, -18.9,
                               -16.6, -19.9, -29.7]),
        "los_db": None,
    },
    "tdl_b": {
        "delays": np.array([0.0000, 0.1072, 0.2155, 0.2095, 0.2870, 0.2986,
                            0.3752, 0.5055, 0.3681, 0.3697, 0.5700, 0.5283,
                            1.1021, 1.2756, 1.5474, 1.7842, 2.0169, 2.8294,
                            3.0219, 3.6187, 4.1067, 4.2790, 4.7834]),
        "powers_db": np.array([0.0, -2.2, -4.0, -3.2, -9.8, -1.2, -3.4, -5.2,
                               -7.6, -3.0, -8.9, -9.0, -4.8, -5.7, -7.5,
                               -1.9, -7.6, -12.2, -9.8, -11.4, -14.9, -9.2,
                               -11.3]),
        "los_db": None,
    },
    "tdl_c": {
        "delays": np.array([0.0000, 0.2099, 0.2219, 0.2329, 0.2176, 0.6366,
                            0.6448, 0.6560, 0.6584, 0.7935, 0.8213, 0.9336,
                            1.2285, 1.3083, 2.1704, 2.7105, 4.2589, 4.6003,
                            5.4902, 5.6077, 6.3065, 6.6374, 7.0427, 8.6523]),
        "powers_db": np.array([-4.4, -1.2, -3.5, -5.2, -2.5, 0.0, -2.2, -3.9,
                               -7.4, -7.1, -10.7, -11.1, -5.1, -6.8, -8.7,
                               -13.2, -13.9, -13.9, -15.8, -17.1, -16.0,
                               -15.7, -21.6, -22.8]),
        "los_db": None,
    },
    "tdl_d": {
        "delays": np.array([0.0000, 0.0350, 0.6120, 1.3630, 1.4050, 1.8040,
                            2.5960, 1.7750, 4.0420, 7.9370, 9.4240, 9.7080,
                            12.5250]),
        "powers_db": np.array([-13.5, -18.8, -21.0, -22.8, -17.9, -20.1,
                               -21.9, -22.9, -27.8, -23.6, -24.8, -30.0,
                               -27.7]),
        "los_db": -0.2,
    },
    "tdl_e": {
        "delays": np.array([0.0000, 0.5133, 0.5440, 0.5630, 0.5440, 0.7112,
                            1.9092, 1.9293, 1.9589, 2.6426, 3.7136, 5.4524,
                            12.0034, 20.6519]),
        "powers_db": np.array([-22.03, -15.8, -18.1, -19.8, -22.9, -22.4,
                               -18.6, -20.8, -22.6, -22.3, -25.6, -20.2,
                               -29.8, -29.2]),
        "los_db": -0.03,
    },
}
# the reference's Quadriga scenario strings map onto the closest profile
TDL_PROFILES["uma_los"] = TDL_PROFILES["tdl_d"]
TDL_PROFILES["umi_nlos"] = TDL_PROFILES["tdl_a"]
TDL_PROFILES["uma_nlos"] = TDL_PROFILES["tdl_c"]

# TR 38.901 Table 7.5-3: ray offsets within a cluster (units of the
# per-cluster angular spread), 20 rays as +-pairs
RAY_OFFSETS = np.array([0.0447, 0.1413, 0.2492, 0.3715, 0.5129, 0.6797,
                        0.8844, 1.1481, 1.5195, 2.1551])
RAY_OFFSETS = np.concatenate([RAY_OFFSETS, -RAY_OFFSETS])


@functools.lru_cache(maxsize=None)
def _tdl_tables(profile: str, n_subpaths: int, asd_deg: float,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A profile's normalized delays, tap powers [dB] and ray offsets [rad]
    as float32 tensors on ``device``, made once: a host-to-device copy in
    every frame would wait for the device."""
    prof = TDL_PROFILES[profile]
    offsets = np.resize(RAY_OFFSETS, n_subpaths) * np.radians(asd_deg)
    return (_f32(prof["delays"], device), _f32(prof["powers_db"], device),
            _f32(offsets, device))


class TdlDraws(NamedTuple):
    """Draws of :func:`tdl_channel` (``mimo_ofdm_tpu/models/channels.py:275-313``):
    ``fade [..., 2, n_taps, n_rays]`` (``[..., 2, n_taps]`` with one
    subpath) unit normals, ``doa [..., n_taps]`` uniform in ``[-pi/2,
    pi/2)``, and the unit normals of the K-factor ``k [...]`` (LOS profile
    with ``k_db`` set) and of the delay spread ``ds [...]``
    (``ds_log10_std > 0``), else None."""
    fade: torch.Tensor
    doa: torch.Tensor
    k: torch.Tensor | None = None
    ds: torch.Tensor | None = None

    @staticmethod
    def draw(batch: int, generator: torch.Generator, profile: str,
             n_subpaths: int, k_db: float | None,
             ds_log10_std: float) -> "TdlDraws":
        dev = generator.device
        n_taps = len(TDL_PROFILES[profile]["delays"])
        rays = (n_subpaths,) if n_subpaths > 1 else ()
        fade = torch.randn((batch, 2, n_taps, *rays), generator=generator, device=dev)
        doa = torch.rand((batch, n_taps), generator=generator, device=dev) * math.pi - math.pi / 2
        los = TDL_PROFILES[profile]["los_db"] is not None
        k = (torch.randn((batch,), generator=generator, device=dev)
             if k_db is not None and los else None)
        ds = (torch.randn((batch,), generator=generator, device=dev)
              if ds_log10_std > 0.0 else None)
        return TdlDraws(fade, doa, k, ds)


def tdl_channel(draws: TdlDraws, tx_pos: torch.Tensor, rx_pos: torch.Tensor,
                freqs: torch.Tensor, profile: str = "uma_los",
                delay_spread: float = 300e-9, skip_attenuation: bool = False,
                tx_gain_db: float = 0.0, rx_gain_db: float = 0.0,
                n_subpaths: int = 20, asd_deg: float = 5.0,
                k_db: float | None = None, k_std_db: float = 0.0,
                ds_log10_std: float = 0.0) -> torch.Tensor:
    """Stochastic tapped-delay-line channel on the TR 38.901 Table 7.7.2-x
    profiles (``mimo_ofdm_tpu/models/channels.py:237-329``): per-tap
    Rayleigh fading, each tap a sum of ``n_subpaths`` rays spread by the
    Table 7.5-3 offsets times ``asd_deg`` (one unspread ray with
    ``n_subpaths=1``), the specular ray on the LOS profiles, array steering
    from the element x-offsets at ``fc = mean(freqs)``, total power 1
    before the free-space attenuation. ``k_db`` rescales the LOS profiles
    to the K-factor (drawn per frame as ``N(k_db, k_std_db)`` dB), and
    ``ds_log10_std`` draws the delay spread per frame as a lognormal.

    The taps meet the frequency grid in one batched matmul
    ``[..., n_ant, n_taps] @ [(...,) n_taps, n_f]``, where JAX forms and
    sums an ``[n_ant, n_f, n_taps]`` tensor."""
    prof = TDL_PROFILES[profile]
    dev = freqs.device
    norm_delays, powers_db, offsets = _tdl_tables(profile, n_subpaths, asd_deg, dev)
    if ds_log10_std > 0.0:
        spread = delay_spread * 10.0 ** (ds_log10_std * draws.ds)        # [...]
        delays = norm_delays * spread[..., None]
    else:
        delays = norm_delays * delay_spread                              # [n_taps]
    powers = 10.0 ** (powers_db / 10.0)
    is_los = prof["los_db"] is not None
    los_pow = 10.0 ** (prof["los_db"] / 10.0) if is_los else 0.0
    total = powers.sum() + los_pow
    powers = powers / total
    los_pow = _rdiv(los_pow, total)
    n_taps = delays.shape[-1]
    if k_db is not None and is_los:
        kf_db = k_db + k_std_db * draws.k
        k_lin = 10.0 ** (kf_db / 10.0)
        los_pow = k_lin / (k_lin + 1.0)                                   # [...]
        powers = powers / powers.sum() / (k_lin[..., None] + 1.0)        # [..., n_taps]
    doa = draws.doa
    # per-tap array steering from the element x-offsets (broadside ULA)
    delta = tx_pos[..., :, 0] - tx_pos[..., :, 0].mean(-1, keepdim=True)
    wavenum = 2.0 * math.pi * freqs.mean() / C_LIGHT
    wd = wavenum * delta                                                  # [n_ant]

    def polar(theta):
        return torch.polar(torch.ones((), device=dev), theta)

    if n_subpaths <= 1:
        fade = complex_normal(draws.fade)                                 # [..., n_taps]
        steer = polar(wd[:, None] * torch.sin(doa)[..., None, :])         # [..., n_ant, n_taps]
        gain = torch.sqrt(powers) * fade
        if is_los:
            gain = torch.cat([gain[..., :1] + torch.sqrt(los_pow)[..., None],
                              gain[..., 1:]], dim=-1)
        tap_gain = gain[..., None, :] * steer
    else:
        ray_doa = doa[..., None] + offsets                                # [..., n_taps, n_rays]
        fade = complex_normal(draws.fade.movedim(-3, -2))                 # [..., n_taps, n_rays]
        ray_gain = torch.sqrt(powers / n_subpaths)[..., None] * fade
        steer = polar(wd[:, None, None] * torch.sin(ray_doa)[..., None, :, :])
        tap_gain = (ray_gain[..., None, :, :] * steer).sum(-1)           # [..., n_ant, n_taps]
        if is_los:
            # the unspread specular ray at tap 0's centre DoA
            spec = (torch.sqrt(los_pow)[..., None]
                    * polar(wd * torch.sin(doa[..., :1])))                # [..., n_ant]
            tap_gain = torch.cat([tap_gain[..., :1] + spec[..., None],
                                  tap_gain[..., 1:]], dim=-1)
    phase = polar((-2.0 * math.pi) * freqs[:, None] * delays[..., None, :])   # [(...,) n_f, n_taps]
    h = tap_gain @ phase.transpose(-2, -1)                                # [..., n_ant, n_f]
    if not skip_attenuation:
        h = h * _fs_attenuation(_distances(tx_pos, rx_pos), freqs, tx_gain_db,
                                rx_gain_db)
    return h


def csi_error_sc(normals: torch.Tensor, h_sc: torch.Tensor,
                 epsilon: float) -> torch.Tensor:
    """The CSI error model on a data-bin matrix ``[..., n_ant, n_sc]``:
    ``H_noisy = sqrt(1-eps^2) H + eps CN(0, P_H)`` per antenna, ``P_H`` its
    mean per-bin power (``reference/mp_model.py:264-284``). ``normals``:
    ``[..., 2, n_ant, n_sc]``."""
    p = (h_sc.abs() ** 2).mean(-1, keepdim=True)
    noise = complex_normal(normals.movedim(-3, -2))
    return _f32_sqrt(1.0 - epsilon ** 2) * h_sc + noise * torch.sqrt(p) * epsilon


def csi_error_channel(normals: torch.Tensor, channel_mat_fd: torch.Tensor,
                      n_sub_carr: int, epsilon: float) -> torch.Tensor:
    """:func:`csi_error_sc` on the data subcarriers of a full-band matrix
    ``[..., n_ant, n_fft]``; the other bins are unchanged
    (``mimo_ofdm_tpu/models/channels.py:332-348``). ``normals``: ``[..., 2,
    n_ant, n_sub_carr]``."""
    noisy_sc = csi_error_sc(normals, ofdm.extract_subcarriers(channel_mat_fd, n_sub_carr),
                            epsilon)
    half = n_sub_carr // 2
    out = channel_mat_fd.clone()
    out[..., 1:half + 1] = noisy_sc[..., half:]
    out[..., out.shape[-1] - half:] = noisy_sc[..., :half]
    return out
