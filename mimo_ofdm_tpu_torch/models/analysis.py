"""Spatial and spectral distortion analysis: the Bussgang split, SDR,
beampatterns, channel correlations and the Welch PSD (port of
``mimo_ofdm_tpu/models/analysis.py``).

The JAX package maps over points and snapshots with ``lax.map``/``vmap``;
here each scan is a Python loop over chunks of points (or IBO values) and
snapshots, every chunk one batched computation, with JAX's chunk defaults.
Every distorted transmit is one launch of the fused kernel at float32 plane
storage: ``sc`` mode where only the data bins are observed (every power,
SDR and alpha scan), ``full`` mode where the whole band is (the PSD
signals). bf16 storage would measure its own ~-40 dB quantization as
distortion. The Welch FFT and the PSD's IFFT of the combined signal are
``torch.fft``, as JAX computes them outside any kernel.

**Randoms.** JAX draws inside every scan from ``fold_in``/``split`` keys,
which torch cannot reproduce. Every scan takes its randoms either injected
(``draws``, a :class:`ScanDraws` whose layout each scan states) or from a
``torch.Generator`` seeded with ``seed``, drawn chunk by chunk so that no
scan holds all its randoms at once. The clean frame's data bins are the
precoded symbols themselves (the IFFT -> FFT round trip without a PA is the
identity), as JAX's ``array_transmit_fd(return_clean=True)`` forms them.

Results come back as host numpy arrays, fetched once at the end of a scan.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models import channels, geometry, link, precoding, transmit
from mimo_ofdm_tpu_torch.ops import bits as bits_ops
from mimo_ofdm_tpu_torch.ops import ofdm, qam
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device

F32_CHAIN = dict(use_mxu_fft=True, mxu_storage="float32")
SPATIAL_CHANNELS = ("los", "two_path", "rayleigh")


class ScanDraws(NamedTuple):
    """The randoms of one scan. Each scan's docstring gives the layout; the
    leading axis of ``bits``, ``fade``, ``loc``, ``chan`` and ``angles`` is
    the scan's outer axis (points or IBO values) where it has one.

    * ``bits``: int8 payload bits;
    * ``fade``: unit normals ``[..., 2, n_ant, n_f]`` of the Rayleigh fades
      (real and imaginary planes), else None;
    * ``main``: the main user's Rayleigh normals ``[2, n_ant, n_f]``, else
      None;
    * ``loc``: RX offsets ``[..., 2]`` uniform in ``+-loc_var/2``, else None;
    * ``chan``: a stochastic channel's own draws (:func:`link.draw_channel`),
      else None;
    * ``angles``: unit uniforms ``[..., n_users]`` of the user angles, else
      None.
    """
    bits: torch.Tensor
    fade: torch.Tensor | None = None
    main: torch.Tensor | None = None
    loc: torch.Tensor | None = None
    chan: object = None
    angles: torch.Tensor | None = None

    def take(self, index, device) -> "ScanDraws":
        """The draws at ``index`` of the outer axis, on ``device``
        (``main`` is kept whole)."""
        def pick(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                return a[index].to(device)
            return type(a)(*(pick(f) for f in a))
        return ScanDraws(pick(self.bits), pick(self.fade),
                         None if self.main is None else self.main.to(device),
                         pick(self.loc), pick(self.chan), pick(self.angles))


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _normals(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def bussgang_split(rx_fd: torch.Tensor, clean_fd: torch.Tensor,
                   ak_vect: torch.Tensor):
    """Per-antenna Bussgang decomposition at the receiver: ``desired = a_k
    o clean``, ``distortion = rx - desired``
    (``reference/main_beampatterns_plotting/main_mrt_precoding_radiation_pattern.py:149-151``).
    ``rx_fd``/``clean_fd``: ``[..., n_ant, n_bins]``; ``ak_vect``: ``[...,
    n_ant]``, broadcast against their leading dims."""
    a = ak_vect[..., :, None].to(clean_fd.dtype)
    desired = a * clean_fd
    return desired, rx_fd - desired


def _scipy_hann(n: int) -> np.ndarray:
    """scipy's periodic Hann window, as ``welch`` uses it (``sym=False``)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def welch_psd(x: torch.Tensor, nfft: int, nperseg: int, fs: float | None = None):
    """Two-sided Welch PSD matching ``scipy.signal.welch(x, fs=nfft,
    nfft=nfft, nperseg=nperseg, return_onesided=False)``
    (``main_mrt_precoding_radiation_pattern.py:181-200``): Hann window, 50%
    overlap, constant detrend per segment. Computes in ``x``'s precision.
    Returns ``(freqs, psd)`` in FFT order."""
    if fs is None:
        fs = float(nfft)
    step = nperseg - nperseg // 2
    n_seg = max(1, (x.shape[-1] - nperseg) // step + 1)
    segs = x.unfold(-1, nperseg, step)[..., :n_seg, :]      # [..., n_seg, nperseg]
    segs = segs - segs.mean(-1, keepdim=True)
    real = torch.float64 if x.dtype in (torch.complex128, torch.float64) else torch.float32
    win = torch.as_tensor(_scipy_hann(nperseg), dtype=real, device=x.device)
    scale = 1.0 / (fs * (win ** 2).sum())
    spec = torch.fft.fft(segs * win, n=nfft, dim=-1)
    psd = scale * (spec.abs() ** 2).mean(-2)
    freqs = torch.fft.fftfreq(nfft, d=1.0 / fs, dtype=real, device=x.device)
    return freqs, psd


def _semicircle(cfg_z: float, radius: float, n_points: int) -> np.ndarray:
    """``n_points + 1`` scan points ``[P+1, 3]`` on a semicircle at height
    ``cfg_z``."""
    pts2d = geometry.pts_on_semicircum(radius, n_points)
    return np.concatenate([pts2d, np.full((len(pts2d), 1), cfg_z)], axis=1)


def tx_sc(bits: torch.Tensor, v: torch.Tensor, cfg: LinkConfig, sat, toi_coeff=0.0,
          sum_users: bool | None = None):
    """One frame batch through the PA array, on the data bins: ``(distorted,
    clean)`` ``[..., n_ant, n_sc]``; one ``sc``-mode launch of the kernel."""
    clean = transmit.precode_symbols(qam.modulate_bits(bits, cfg.modem.constel_size),
                                     v, sum_users)
    dist = transmit.ifft_pa_fft_sc(clean, cfg.modem.n_fft, cfg.pa.model, sat,
                                   cfg.pa.rapp_p_hardness, toi_coeff, **F32_CHAIN)
    return dist, clean


def _split_powers(dist: torch.Tensor, clean: torch.Tensor, h: torch.Tensor,
                  ak: torch.Tensor, dims):
    """Desired and distortion powers of the antenna-combined signals
    ``sum_ant a_k H clean`` and ``sum_ant (H dist - a_k H clean)``, summed
    over ``dims`` of the combined ``[..., n_bins]`` signals."""
    desired, distortion = bussgang_split(dist * h, clean * h, ak)
    return ((desired.sum(-2).abs() ** 2).sum(dims),
            (distortion.sum(-2).abs() ** 2).sum(dims))


class BeampatternResult(NamedTuple):
    angles_rad: np.ndarray       # [n_points+1] evaluation angles
    desired_pow: np.ndarray      # [n_points+1] summed desired power
    distortion_pow: np.ndarray   # [n_points+1] summed distortion power

    @property
    def sdr_db(self):
        return 10.0 * np.log10(self.desired_pow / self.distortion_pow)


def beampattern_scan(cfg: LinkConfig, draws: ScanDraws | None = None, *, seed: int = 0,
                     precoding_angle_deg: float = 45.0, n_points: int = 180,
                     n_snapshots: int = 16, radial_distance: float = 300.0,
                     point_chunk: int = 16, device=None) -> BeampatternResult:
    """Desired vs distortion radiation pattern of an MRT-precoded array on
    LOS (``main_mrt_precoding_radiation_pattern.py:117-173``): precode
    toward the semicircle point ``int(n_points/180*angle)``; at each of
    ``n_points+1`` points Bussgang-split ``n_snapshots`` frames and sum
    the data-subcarrier powers. The frames are the same at every point
    (JAX splits one key into the snapshots), so they are transmitted once:
    ``draws.bits [n_snapshots, n_bits]``."""
    dev = resolve_device(device)
    n_sc, n_ant, ibo = cfg.modem.n_sub_carr, cfg.array.n_elements, cfg.pa.ibo_db
    tx_pos, freqs, _ = link.link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    pts = _f32(_semicircle(cfg.rx.cord_z, radial_distance, n_points), dev)
    angles = np.radians(np.linspace(-90, 90, n_points + 1))
    prec_idx = int(n_points / 180 * precoding_angle_deg)

    v = precoding.mrt_precoder(channels.los_channel(tx_pos, pts[prec_idx], freqs_sc))
    sat = precoding.pa_sat_power(ibo, cfg.modem.avg_sample_power, v)
    ak = precoding.per_antenna_alpha(ibo, precoding.precoding_power_per_antenna(v),
                                     n_sc, n_ant)
    bits = (draws.bits.to(dev) if draws is not None else bits_ops.random_payload_bits(
        _generator(seed, dev), (n_snapshots, cfg.modem.n_bits_per_ofdm_sym)))
    dist, clean = tx_sc(bits, v, cfg, sat)                   # [S, n_ant, n_sc]
    d_pow, e_pow = shared_frame_powers(
        dist, clean, ak, (channels.los_channel(tx_pos, pts[lo:lo + point_chunk], freqs_sc)
                          for lo in range(0, n_points + 1, point_chunk)))
    return BeampatternResult(angles, d_pow, e_pow)


def shared_frame_powers(dist: torch.Tensor, clean: torch.Tensor, ak: torch.Tensor,
                         h_chunks):
    """Desired and distortion powers ``[P]`` at every point of ``h_chunks``
    (channel chunks ``[C, n_ant, n_sc]``) of one set of frames ``[S, n_ant,
    n_sc]`` that every point sees: the antenna combine of the Bussgang
    parts, one product per chunk, summed over snapshots and subcarriers."""
    a = ak[:, None].to(clean.dtype)
    x_des = a * clean
    x_dist = dist - x_des
    d_pow, e_pow = [], []
    for h in h_chunks:
        d_pow.append((torch.einsum("sak,cak->csk", x_des, h).abs() ** 2).sum((-2, -1)))
        e_pow.append((torch.einsum("sak,cak->csk", x_dist, h).abs() ** 2).sum((-2, -1)))
    return torch.cat(d_pow).cpu().numpy(), torch.cat(e_pow).cpu().numpy()


class RadiationPatternResult(NamedTuple):
    angles_deg: np.ndarray        # [n_points+1] scan angles (0..180)
    desired_pow: np.ndarray       # [n_points+1] summed desired SC power
    distortion_pow: np.ndarray    # [n_points+1] summed distortion SC power
    # Welch PSDs at the precoding angle and the selected angle:
    # angle_deg -> (freqs, psd_desired, psd_distortion), FFT bin order
    psd: dict


def _point_channel(model: str, fade, tx_pos: torch.Tensor, rx_pos: torch.Tensor,
                   freqs: torch.Tensor) -> torch.Tensor:
    """Channel matrix at evaluation points ``rx_pos [..., 3]`` for the
    spatial scans (``reference/main_multiuser/multiuser_channel_mat_correlation.py:95-105``);
    ``fade``: the Rayleigh normals ``[..., 2, n_ant, n_f]``."""
    if model == "los":
        return channels.los_channel(tx_pos, rx_pos, freqs)
    if model == "two_path":
        return channels.two_path_channel(tx_pos, rx_pos, freqs)
    if model == "rayleigh":
        return channels.rayleigh_channel(fade, tx_pos, rx_pos, freqs)
    raise ValueError(f"unsupported channel model for spatial scan: {model}")


def radiation_pattern(cfg: LinkConfig, draws: ScanDraws | None = None, *, seed: int = 0,
                      precoding_angle_deg: float = 45.0, precoding_angles_deg=None,
                      psd_angle_deg: float = 78.0, n_points: int = 180,
                      n_snapshots: int = 100, radial_distance: float = 300.0,
                      psd_nfft: int | None = None, n_samp_per_seg: int = 1024,
                      point_chunk: int = 4, snap_chunk: int = 10,
                      device=None) -> RadiationPatternResult:
    """The reference's MRT radiation-pattern scan with the per-angle Welch
    PSDs (``main_mrt_precoding_radiation_pattern.py:30-266``):

    1. MRT-precode toward the semicircle point ``round(n_points/180*angle)``
       (joint multi-user MRT toward each of ``precoding_angles_deg``, one
       frame per user, summed; the first angle is then the PSD's
       precoding point);
    2. at each of ``n_points+1`` points transmit ``n_snapshots`` frames,
       Bussgang-split them with the per-antenna ``a_k`` and sum the
       desired and distortion data-subcarrier powers (``:131-173``);
    3. at the precoding point and at ``psd_angle_deg`` form the full-band
       combined desired and distortion signals of the same frames, take
       each snapshot to the time domain (ortho IFFT) and Welch the
       concatenated stream (``:181-200``).

    LOS and two-path are deterministic per point. Rayleigh draws a fade per
    point but keeps the attenuation at the configuration's RX position
    (``reference/channel.py:217-229``); the precoding point's fade is the
    one the scan uses there.

    ``draws``: ``bits [n_points+1, n_snapshots, (n_users,) n_bits]`` and,
    on Rayleigh, ``fade [n_points+1, 2, n_ant, n_fft]`` (full band). From
    the generator: the Rayleigh fades of every point first, then the bits
    point chunk by point chunk."""
    dev = resolve_device(device)
    n_fft, n_sc = cfg.modem.n_fft, cfg.modem.n_sub_carr
    n_ant, ibo, model = cfg.array.n_elements, cfg.pa.ibo_db, cfg.channel.model
    if model not in SPATIAL_CHANNELS:
        raise ValueError(f"unsupported channel for radiation pattern: {model}")
    psd_nfft = n_fft if psd_nfft is None else psd_nfft
    if precoding_angles_deg is None:
        precoding_angles_deg = (precoding_angle_deg,)
    n_usr = len(precoding_angles_deg)
    multi = n_usr > 1
    while n_snapshots % snap_chunk:
        snap_chunk -= 1
    n_pts = n_points + 1
    n_bits = cfg.modem.n_bits_per_ofdm_sym
    usr = (n_usr,) if multi else ()

    tx_pos, freqs, rx_base = link.link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    pts = _f32(_semicircle(cfg.rx.cord_z, radial_distance, n_points), dev)
    angles_deg = np.linspace(0.0, 180.0, n_pts)
    prec_idxs = [int(round(n_points / 180.0 * a)) for a in precoding_angles_deg]
    prec_idx = prec_idxs[0]
    sel_idx = int(round(n_points / 180.0 * psd_angle_deg))
    gen = None if draws is not None else _generator(seed, dev)
    fade = None
    if model == "rayleigh":
        fade = (draws.fade.to(dev) if draws is not None
                else _normals(gen, n_pts, 2, n_ant, n_fft))

    def channel(index, sc: bool) -> torch.Tensor:
        """Channels at scan points ``index``, on the data bins or the full band."""
        f = freqs_sc if sc else freqs
        if model == "rayleigh":
            nrm = fade[index]
            return channels.rayleigh_channel(
                ofdm.extract_subcarriers(nrm, n_sc) if sc else nrm, tx_pos, rx_base, f)
        return _point_channel(model, None, tx_pos, pts[index], f)

    h_usr = channel(prec_idxs, True)                         # [n_usr, n_ant, n_sc]
    v = (precoding.make_precoder("mrt", n_usr)(h_usr) if multi
         else precoding.mrt_precoder(h_usr[0]))
    sat = precoding.pa_sat_power(ibo, cfg.modem.avg_sample_power, v, multi_user=multi)
    ak = precoding.per_antenna_alpha(
        ibo, precoding.precoding_power_per_antenna(v, multi_user=multi), n_sc, n_ant)
    sum_users = True if multi else None

    d_pow, e_pow = [], []
    psd_bits = {}
    for lo in range(0, n_pts, point_chunk):
        hi = min(n_pts, lo + point_chunk)
        bits = (draws.bits[lo:hi].to(dev) if draws is not None
                else bits_ops.random_payload_bits(gen, (hi - lo, n_snapshots, *usr, n_bits)))
        for idx in {prec_idx, sel_idx}:
            if lo <= idx < hi:
                psd_bits[idx] = bits[idx - lo]
        h = channel(slice(lo, hi), True)[:, None]           # [C, 1, n_ant, n_sc]
        d_acc = e_acc = 0.0
        for s0 in range(0, n_snapshots, snap_chunk):
            dist, clean = tx_sc(bits[:, s0:s0 + snap_chunk], v, cfg, sat,
                                 sum_users=sum_users)
            d, e = _split_powers(dist, clean, h, ak, (-2, -1))
            d_acc, e_acc = d_acc + d, e_acc + e
        d_pow.append(d_acc)
        e_pow.append(e_acc)

    psd = {}
    for ang, idx in ((precoding_angle_deg, prec_idx), (psd_angle_deg, sel_idx)):
        psd[float(ang)] = combined_psd(cfg, psd_bits[idx], v, channel([idx], False)[0], ak,
                                       sat, psd_nfft, n_samp_per_seg, sum_users=sum_users)
    return RadiationPatternResult(angles_deg, torch.cat(d_pow).cpu().numpy(),
                                  torch.cat(e_pow).cpu().numpy(), psd)


def combined_psd(cfg: LinkConfig, bits: torch.Tensor, v: torch.Tensor, h: torch.Tensor,
                 ak: torch.Tensor, sat, psd_nfft: int, n_samp_per_seg: int, toi_coeff=0.0,
                 sum_users: bool | None = None):
    """Welch PSDs ``(freqs, desired, distortion)`` (host numpy) of the
    full-band antenna-combined signals ``sum_ant a_k H clean`` and
    ``sum_ant (H dist - a_k H clean)`` of the frames ``bits [S, ...]``
    through the channel ``h [n_ant, n_fft]``, each snapshot taken to the
    time domain and the snapshots concatenated
    (``main_mrt_precoding_radiation_pattern.py:181-200``). All snapshots
    are one ``full``-mode launch."""
    fd_dist, fd_clean = transmit.array_transmit_fd(
        bits, constel_size=cfg.modem.constel_size, n_fft=cfg.modem.n_fft, v=v,
        pa_model=cfg.pa.model, sat_power=sat, rapp_p=cfg.pa.rapp_p_hardness,
        toi_coeff=toi_coeff, return_clean=True, sum_users=sum_users, **F32_CHAIN)
    desired, distortion = bussgang_split(fd_dist * h, fd_clean * h, ak)
    out = []
    for sig in (desired, distortion):
        f, p = welch_psd(ofdm.fd_to_td(sig.sum(-2)).reshape(-1), psd_nfft, n_samp_per_seg)
        out.append(p.cpu().numpy())
    return (f.cpu().numpy(), *out)


def mu_sinr_sdr(cfg: LinkConfig, user_positions, draws: ScanDraws | None = None, *,
                seed: int = 0, n_snapshots: int = 16, precoding_kind: str = "mrt",
                device=None):
    """Per-user SDR and SINR of the distorted multi-user downlink on LOS
    (``reference/main_multiuser/main_multiuser_cnc_ber_vs_ebn0.py:184-258``):
    ``SDR_u = P(desired_u) / P(received - every user's linear part)`` and
    ``SINR_u = P(desired_u) / P(received - desired_u)``, the desired part
    ``sum_ant a_k H_u V_u s_u``; powers summed over the snapshots. All
    snapshots are one launch. ``draws.bits [n_snapshots, n_users,
    n_bits]``. Returns ``(sdr_db [n_users], sinr_db [n_users])``."""
    dev = resolve_device(device)
    n_sc, n_ant, ibo = cfg.modem.n_sub_carr, cfg.array.n_elements, cfg.pa.ibo_db
    pos = np.asarray(user_positions)
    n_usr = len(pos)
    tx_pos, freqs, _ = link.link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    h_usr = channels.los_channel(tx_pos, _f32(pos, dev), freqs_sc)   # [U, n_ant, n_sc]
    v = precoding.make_precoder(precoding_kind, n_usr)(h_usr)       # [n_ant, U, n_sc]
    sat = precoding.pa_sat_power(ibo, cfg.modem.avg_sample_power, v, multi_user=True)
    ak = precoding.per_antenna_alpha(
        ibo, precoding.precoding_power_per_antenna(v, multi_user=True), n_sc, n_ant)
    akc = ak.to(v.dtype)
    g = torch.einsum("a,uas,aus->us", akc, h_usr, v)
    g_cross = torch.einsum("a,uas,avs->uvs", akc, h_usr, v)
    bits = (draws.bits.to(dev) if draws is not None else bits_ops.random_payload_bits(
        _generator(seed, dev), (n_snapshots, n_usr, cfg.modem.n_bits_per_ofdm_sym)))
    sym = qam.modulate_bits(bits, cfg.modem.constel_size)          # [S, U, n_sc]
    fd_sc, _ = tx_sc(bits, v, cfg, sat, sum_users=True)            # [S, n_ant, n_sc]
    rx = torch.einsum("uas,nas->nus", h_usr, fd_sc)
    desired = g * sym
    lin_all = torch.einsum("uvs,nvs->nus", g_cross, sym)
    p_des = (desired.abs() ** 2).sum(-1).sum(0)
    p_dist = ((rx - lin_all).abs() ** 2).sum(-1).sum(0)
    p_id = ((rx - desired).abs() ** 2).sum(-1).sum(0)
    sdr = 10.0 * torch.log10(p_des / p_dist)
    sinr = 10.0 * torch.log10(p_des / p_id)
    return sdr.cpu().numpy(), sinr.cpu().numpy()


def channel_correlation(h_ref: torch.Tensor, h_test: torch.Tensor) -> torch.Tensor:
    """Correlation coefficient of MISO channel matrices ``[..., n_ant,
    n_bins]``: ``trace(|H_ref^T conj(H_test)|) / sqrt(||H_ref||^2
    ||H_test||^2)`` (``multiuser_channel_mat_correlation.py:108-112``), as
    the per-bin antenna inner product (the trace's diagonal only)."""
    nomin = (h_ref * torch.conj(h_test)).sum(-2).abs().sum(-1)
    denom = torch.sqrt((h_ref.abs() ** 2).sum((-2, -1))
                       * (h_test.abs() ** 2).sum((-2, -1)))
    return nomin / denom


def channel_mat_correlation_scan(cfg: LinkConfig, draws: ScanDraws | None = None, *,
                                 seed: int = 0, main_usr_angle_deg: float = 45.0,
                                 main_user_dist: float = 300.0, n_points: int = 180,
                                 point_chunk: int = 32, device=None):
    """Channel-matrix correlation of the main user (semicircle point
    ``round(n_points/180*angle)``) against every semicircle point, over the
    full band (``reference/main_multiuser/multiuser_channel_mat_correlation.py``).
    On Rayleigh every point is its own fade, and the main point reuses the
    main user's matrix (``:101-105``): ``draws.main [2, n_ant, n_fft]``,
    ``draws.fade [n_points+1, 2, n_ant, n_fft]`` (the main point's unused);
    ``draws.bits`` is unused. Returns ``(angles_deg [n_points+1], corr
    [n_points+1])``."""
    dev = resolve_device(device)
    model, n_ant, n_fft = cfg.channel.model, cfg.array.n_elements, cfg.modem.n_fft
    tx_pos, freqs, _ = link.link_static(cfg, dev)
    pts = _f32(_semicircle(cfg.rx.cord_z, main_user_dist, n_points), dev)
    angles_deg = np.linspace(0.0, 180.0, n_points + 1)
    main_idx = int(round(n_points / 180.0 * main_usr_angle_deg))
    rayleigh = model == "rayleigh"
    gen = None if draws is not None or not rayleigh else _generator(seed, dev)
    main = None
    if rayleigh:
        main = draws.main.to(dev) if draws is not None else _normals(gen, 2, n_ant, n_fft)
    h_main = _point_channel(model, main, tx_pos, pts[main_idx], freqs)
    corr = []
    for lo in range(0, n_points + 1, point_chunk):
        hi = min(n_points + 1, lo + point_chunk)
        fade = None
        if rayleigh:
            fade = (draws.fade[lo:hi].to(dev) if draws is not None
                    else _normals(gen, hi - lo, 2, n_ant, n_fft))
        h = _point_channel(model, fade, tx_pos, pts[lo:hi], freqs)
        if lo <= main_idx < hi:
            h[main_idx - lo] = h_main
        corr.append(channel_correlation(h_main, h))
    return angles_deg, torch.cat(corr).cpu().numpy()


def spatial_correlation_scan(cfg: LinkConfig, draws: ScanDraws | None = None, *,
                             seed: int = 0, main_usr_angle_deg: float = 45.0,
                             main_user_dist: float = 300.0, n_points: int = 36,
                             point_chunk: int = 8, device=None):
    """Beampattern (spatial) correlation vs precoding angle
    (``reference/main_multiuser/multiuser_channel_spatial_correlation.py``):
    for every semicircle point ``q``, MRT-precode one frame toward it,
    measure the clean received power at every point ``p``, and correlate
    that beampattern with the one precoded toward the main user. The clean
    data bins are the precoded symbols, so the ``[P, P]`` beampattern matrix
    is a product of channel and precoder stacks, ``point_chunk``
    precoding points at a time (JAX's chunk of 8).

    ``draws.bits [n_bits]`` (the same frame for every precoding angle, as
    the reference resets its bit generator per angle, ``:109``); on
    Rayleigh ``draws.fade [n_points+1, n_points+2, 2, n_ant, n_sc]``: for
    precoding point ``q``, entry 0 is the precoding fade and entry ``p+1``
    the fade measured at ``p`` (at ``p == q`` the precoding fade is used).
    Returns ``(angles_deg [n_points+1], corr [n_points+1])``."""
    dev = resolve_device(device)
    model, n_ant, n_sc = cfg.channel.model, cfg.array.n_elements, cfg.modem.n_sub_carr
    n_pts = n_points + 1
    tx_pos, freqs, _ = link.link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    pts = _f32(_semicircle(cfg.rx.cord_z, main_user_dist, n_points), dev)
    angles_deg = np.linspace(0.0, 180.0, n_pts)
    main_idx = int(round(n_points / 180.0 * main_usr_angle_deg))
    gen = None if draws is not None else _generator(seed, dev)
    bits = (draws.bits.to(dev) if draws is not None
            else bits_ops.random_payload_bits(gen, (cfg.modem.n_bits_per_ofdm_sym,)))
    sym = qam.modulate_bits(bits, cfg.modem.constel_size)
    h_fixed = (None if model == "rayleigh"
               else _point_channel(model, None, tx_pos, pts, freqs_sc))   # [P, n_ant, n_sc]
    rows = []
    for lo in range(0, n_pts, point_chunk):
        hi = min(n_pts, lo + point_chunk)
        q = torch.arange(lo, hi, device=dev)
        if h_fixed is None:
            fade = (draws.fade[lo:hi].to(dev) if draws is not None
                    else _normals(gen, hi - lo, n_pts + 1, 2, n_ant, n_sc))
            h_prec = _point_channel(model, fade[:, 0], tx_pos, pts[lo:hi], freqs_sc)
            h_meas = _point_channel(model, fade[:, 1:], tx_pos, pts, freqs_sc)  # [C, P, ...]
            h_meas[torch.arange(hi - lo, device=dev), q] = h_prec
        else:
            h_prec = h_fixed[lo:hi]
            h_meas = h_fixed.expand(hi - lo, *h_fixed.shape)
        x = precoding.mrt_precoder(h_prec) * sym                    # [C, n_ant, n_sc]
        rows.append((torch.einsum("cpas,cas->cps", h_meas, x).abs() ** 2).sum(-1))
    b = torch.cat(rows)                                             # [P, P]
    b_main = b[main_idx]
    corr = (b @ b_main) / (torch.linalg.vector_norm(b, dim=-1)
                           * torch.linalg.vector_norm(b_main))
    return angles_deg, corr.cpu().numpy()


def draw_snapshots(cfg: LinkConfig, gen: torch.Generator, n: int, n_f: int,
                   reroll: bool, usr: tuple = ()) -> ScanDraws:
    """``n`` snapshots' randoms of the per-snapshot channel scans: bits, and
    what :func:`link.make_channel_fn` reads (Rayleigh normals on ``n_f``
    bins, RX offsets, a stochastic channel's draws)."""
    n_ant = cfg.array.n_elements
    bits = bits_ops.random_payload_bits(gen, (n, *usr, cfg.modem.n_bits_per_ofdm_sym))
    fade = (_normals(gen, n, *usr, 2, n_ant, n_f)
            if cfg.channel.model == "rayleigh" else None)
    return ScanDraws(bits, fade, loc=link.draw_rx_offsets(cfg, n, gen, reroll),
                     chan=link.draw_channel(cfg, n, gen))


def make_sdr_fn(cfg: LinkConfig, rx_pos, *, n_snapshots: int = 500, reroll: bool = True,
                snap_chunk: int = 16, device=None):
    """``run(ibo_values, draws=None, *, seed=0) -> (sdr_db [k], sdr_lin
    [k])`` for one (array, channel) configuration, the per-(IBO, channel)
    measurement of ``reference/main_beampatterns_plotting/main_sdr_vs_ibo_vs_channel.py``:
    every snapshot rerolls the channel (RX moved within ``+-loc_var/2`` on
    the geometric channels, a fresh fade on Rayleigh, ``:103-117``),
    re-precodes (MRT) and re-derives the per-antenna alphas; per IBO the
    dB-mean (the script's live code, ``:147,153``) and the linear mean
    (its committed CSV) of the per-snapshot ratios. ``snap_chunk``
    snapshots are one launch.

    ``draws``: ``bits [k, n_snapshots, n_bits]``, and as the channel reads
    them ``fade [k, n_snapshots, 2, n_ant, n_sc]``, ``loc [k,
    n_snapshots, 2]``, ``chan``. From the generator they are drawn chunk by
    chunk, never all at once."""
    dev = resolve_device(device)
    n_sc, n_ant = cfg.modem.n_sub_carr, cfg.array.n_elements
    tx_pos, freqs, _ = link.link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    chan_fn = link.make_channel_fn(cfg, freqs_sc, _f32(rx_pos, dev), reroll)

    def run(ibo_values, draws: ScanDraws | None = None, *, seed: int = 0):
        gen = None if draws is not None else _generator(seed, dev)
        db, lin = [], []
        for i, ibo in enumerate(np.asarray(ibo_values, np.float32)):
            ibo = float(ibo)
            ratios = []
            for s0 in range(0, n_snapshots, snap_chunk):
                s1 = min(n_snapshots, s0 + snap_chunk)
                d = (draws.take((i, slice(s0, s1)), dev) if draws is not None
                     else draw_snapshots(cfg, gen, s1 - s0, n_sc, reroll))
                h = chan_fn(tx_pos, d).expand(s1 - s0, n_ant, n_sc)
                v = precoding.mrt_precoder(h)
                sat = precoding.pa_sat_power(ibo, cfg.modem.avg_sample_power, v)
                ak = precoding.per_antenna_alpha(
                    ibo, precoding.precoding_power_per_antenna(v), n_sc, n_ant)
                dist, clean = tx_sc(d.bits, v, cfg, sat[:, None])
                p_d, p_e = _split_powers(dist, clean, h, ak, -1)
                ratios.append(p_d / p_e)
            r = torch.cat(ratios)
            db.append((10.0 * torch.log10(r)).mean())
            lin.append(r.mean())
        return torch.stack(db).cpu().numpy(), torch.stack(lin).cpu().numpy()

    return run


def sdr_vs_ibo_curve(cfg: LinkConfig, ibo_values, rx_pos, draws: ScanDraws | None = None,
                     *, seed: int = 0, n_snapshots: int = 500, reroll: bool = True,
                     snap_chunk: int = 16, device=None) -> tuple[np.ndarray, np.ndarray]:
    """``(sdr_db, sdr_linear)`` per IBO value for one (array, channel)
    configuration (:func:`make_sdr_fn`)."""
    run = make_sdr_fn(cfg, rx_pos, n_snapshots=n_snapshots, reroll=reroll,
                      snap_chunk=snap_chunk, device=device)
    return run(ibo_values, draws, seed=seed)


def sdr_at_point(cfg: LinkConfig, rx_pos, draws: ScanDraws | None = None, *,
                 seed: int = 0, n_snapshots: int = 16, reroll: bool = True,
                 snap_chunk: int = 16, device=None) -> np.ndarray:
    """SDR [dB] at one RX point at the config's IBO, as a one-element array
    (the snapshot dB-mean of :func:`make_sdr_fn`)."""
    return sdr_vs_ibo_curve(cfg, [cfg.pa.ibo_db], rx_pos, draws, seed=seed,
                            n_snapshots=n_snapshots, reroll=reroll,
                            snap_chunk=snap_chunk, device=device)[0]


def mu_angle_overlap_scan(cfg: LinkConfig, draws: ScanDraws | None = None, *,
                          seed: int = 0, main_angle_deg: float = 60.0,
                          user_dist: float = 300.0, n_points: int = 180,
                          n_snapshots: int = 2, point_chunk: int = 8, device=None):
    """Two-user SDR vs the secondary user's angle
    (``reference/main_multiuser/main_two_users_sdr_vs_angle_overlap.py``):
    the main user at ``main_angle_deg`` on a semicircle of ``user_dist``,
    the secondary at each of ``n_points+1`` semicircle points. Per point the
    two-user MRT precoder and the constant-IBO alphas are recomputed
    (``:134-146``) and each user's SDR measured over ``n_snapshots`` frames
    (``:148-175``): desired = the Bussgang-scaled combined clean signal of
    both users through user u's channel, distortion = received minus that,
    powers summed over snapshots before the ratio; with the channel
    correlation per point (``:125-131``). One launch per point chunk.

    ``draws``: ``bits [n_points+1, n_snapshots, 2, n_bits]``; on Rayleigh
    ``main [2, n_ant, n_sc]`` and ``fade [n_points+1, 2, n_ant, n_sc]``.
    Returns ``(angles_deg [n_points+1], corr [n_points+1], sdr_db [2,
    n_points+1])`` (row 0 the main user)."""
    dev = resolve_device(device)
    model = cfg.channel.model
    n_sc, n_ant, ibo = cfg.modem.n_sub_carr, cfg.array.n_elements, cfg.pa.ibo_db
    n_pts = n_points + 1
    tx_pos, freqs, _ = link.link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    pts = _f32(_semicircle(cfg.rx.cord_z, user_dist, n_points), dev)
    angles_deg = np.linspace(0.0, 180.0, n_pts)
    main_pos = np.array([np.cos(np.deg2rad(main_angle_deg)) * user_dist,
                         np.sin(np.deg2rad(main_angle_deg)) * user_dist,
                         cfg.rx.cord_z], np.float32)
    rayleigh = model == "rayleigh"
    gen = None if draws is not None else _generator(seed, dev)
    main = None
    if rayleigh:
        main = draws.main.to(dev) if draws is not None else _normals(gen, 2, n_ant, n_sc)
    h_main = _point_channel(model, main, tx_pos, _f32(main_pos, dev), freqs_sc)
    corr, sdr = [], []
    for lo in range(0, n_pts, point_chunk):
        hi = min(n_pts, lo + point_chunk)
        if draws is not None:
            d = draws.take(slice(lo, hi), dev)
        else:
            d = ScanDraws(bits_ops.random_payload_bits(
                gen, (hi - lo, n_snapshots, 2, cfg.modem.n_bits_per_ofdm_sym)),
                _normals(gen, hi - lo, 2, n_ant, n_sc) if rayleigh else None)
        h_sec = _point_channel(model, d.fade, tx_pos, pts[lo:hi], freqs_sc)   # [C, n_ant, n_sc]
        corr.append(channel_correlation(h_main, h_sec))
        h_mu = torch.stack([h_main.expand_as(h_sec), h_sec], dim=1)          # [C, 2, n_ant, n_sc]
        v = precoding.mu_mrt_precoder(h_mu)                                  # [C, n_ant, 2, n_sc]
        sat = precoding.pa_sat_power(ibo, cfg.modem.avg_sample_power, v, multi_user=True)
        ak = precoding.per_antenna_alpha(
            ibo, precoding.precoding_power_per_antenna(v, multi_user=True), n_sc, n_ant)
        dist, clean = tx_sc(d.bits, v[:, None], cfg, sat[:, None, None],
                            sum_users=True)                                 # [C, S, n_ant, n_sc]
        # both users see the combined frame: split it through each one's channel
        p_d, p_e = _split_powers(dist[:, :, None], clean[:, :, None], h_mu[:, None],
                                 ak[:, None, None], -1)                     # [C, S, 2]
        sdr.append(10.0 * torch.log10(p_d.sum(1) / p_e.sum(1)))
    return (angles_deg, torch.cat(corr).cpu().numpy(),
            torch.cat(sdr).T.cpu().numpy())


def draw_user_angles(u: torch.Tensor, n_users: int, angular_margin: float) -> torch.Tensor:
    """User angles [deg] ``[..., n_users]`` from unit uniforms ``u`` with
    the reference's sequential spacing (``main_multiuser_sdr_vs_ibo_vs_n_users.py:84-104``):
    slot ``(180 - 2 margin) / n_users``; user 0 uniform in the first slot,
    user i in ``(prev + slot, margin + slot (i+1))``; one user anywhere in
    ``[margin, 180 - margin)``. Float32, as ``jax.random.uniform`` scales:
    ``max(lo, u (hi - lo) + lo)``."""
    def scale(ui, lo, hi):
        hi = torch.as_tensor(hi, dtype=torch.float32, device=u.device)
        lo = torch.as_tensor(lo, dtype=torch.float32, device=u.device)
        return torch.maximum(lo, ui * (hi - lo) + lo)

    if n_users == 1:
        return scale(u, angular_margin, 180.0 - angular_margin)
    slot = (180.0 - 2.0 * angular_margin) / n_users
    angs = [scale(u[..., 0], angular_margin, angular_margin + slot)]
    for i in range(1, n_users):
        angs.append(scale(u[..., i], angs[-1] + slot, angular_margin + slot * (i + 1)))
    return torch.stack(angs, dim=-1)


def make_mu_nusers_sdr_fn(cfg: LinkConfig, n_users: int, *, radial_dist: float = 300.0,
                          angular_margin: float = 10.0, n_snapshots: int = 100,
                          snap_chunk: int = 8, device=None):
    """``run(ibo_values, draws=None, *, seed=0) -> sdr_db [k, n_users]``,
    the multi-user SDR-vs-IBO-vs-user-count study
    (``reference/main_multiuser/main_multiuser_sdr_vs_ibo_vs_n_users.py``):
    every snapshot draws fresh user angles (:func:`draw_user_angles`),
    re-precodes (joint MU MRT) and re-derives the constant-IBO alphas;
    per user (``:156-181``) desired = the Bussgang-scaled clean signal of
    user u alone through ``H_u``, distortion = received minus the scaled
    combined clean signal; the per-snapshot ratios are averaged linearly,
    then taken to dB. ``snap_chunk`` snapshots are one launch.

    ``draws``: ``angles [k, n_snapshots, n_users]`` unit uniforms, ``bits
    [k, n_snapshots, n_users, n_bits]`` and on Rayleigh ``fade [k,
    n_snapshots, n_users, 2, n_ant, n_sc]``."""
    dev = resolve_device(device)
    model = cfg.channel.model
    n_sc, n_ant = cfg.modem.n_sub_carr, cfg.array.n_elements
    tx_pos, freqs, _ = link.link_static(cfg, dev)
    freqs_sc = ofdm.extract_subcarriers(freqs, n_sc)
    deg = np.float32(np.pi / 180)

    def run(ibo_values, draws: ScanDraws | None = None, *, seed: int = 0):
        gen = None if draws is not None else _generator(seed, dev)
        out = []
        for i, ibo in enumerate(np.asarray(ibo_values, np.float32)):
            ibo = float(ibo)
            ratios = []
            for s0 in range(0, n_snapshots, snap_chunk):
                s1 = min(n_snapshots, s0 + snap_chunk)
                if draws is not None:
                    d = draws.take((i, slice(s0, s1)), dev)
                else:
                    d = draw_snapshots(cfg, gen, s1 - s0, n_sc, False, (n_users,))
                    d = d._replace(angles=torch.rand((s1 - s0, n_users), generator=gen,
                                                     device=dev))
                ang = draw_user_angles(d.angles, n_users, angular_margin) * deg
                pos = torch.stack([torch.cos(ang) * radial_dist, torch.sin(ang) * radial_dist,
                                   torch.full_like(ang, cfg.rx.cord_z)], dim=-1)
                h_mu = _point_channel(model, d.fade, tx_pos, pos, freqs_sc)  # [B, U, n_ant, n_sc]
                v = precoding.mu_mrt_precoder(h_mu)                          # [B, n_ant, U, n_sc]
                sat = precoding.pa_sat_power(ibo, cfg.modem.avg_sample_power, v,
                                             multi_user=True)
                ak = precoding.per_antenna_alpha(
                    ibo, precoding.precoding_power_per_antenna(v, multi_user=True),
                    n_sc, n_ant)
                sym = qam.modulate_bits(d.bits, cfg.modem.constel_size)      # [B, U, n_sc]
                dist, clean = tx_sc(d.bits, v, cfg, sat[:, None], sum_users=True)
                # desired: user u's own clean signal; distortion: the received
                # signal less the scaled combined clean one (:156-181)
                akc = ak[:, None, :, None].to(clean.dtype)                   # [B, 1, n_ant, 1]
                own = akc * transmit.precode_symbols(sym, v, sum_users=False) * h_mu
                resid = (dist - akc[:, 0] * clean)[:, None] * h_mu
                ratios.append((own.sum(-2).abs() ** 2).sum(-1)
                              / (resid.sum(-2).abs() ** 2).sum(-1))
            out.append(10.0 * torch.log10(torch.cat(ratios).mean(0)))
        return torch.stack(out).cpu().numpy()

    return run
