"""TR 38.901 geometric stochastic channel model (GSCM), batched over frames
(port of ``mimo_ofdm_tpu/models/gscm.py``).

One call draws an independent TR 38.901 drop per frame, the procedure of
section 7.5 steps 4-11 that substitutes the reference's Quadriga engine
(``reference/channel.py:404-494``): correlated large-scale parameters,
exponential cluster delays, shadowed cluster powers, power-coupled
departure angles, ZoD/AoD ray coupling, per-ray phases, the 3GPP
directional element pattern, sub-cluster splitting of the two strongest
clusters and the LOS specular ray. The taps ``[B, n_ant, n_taps]`` meet
the frequency grid in one batched ``torch.matmul`` with ``[B, n_taps,
n_f]``.

The nine draws of a drop come in as a :class:`GscmDraws`. Every phase is
formed in the JAX source's float32 order, so the taps agree with JAX's to
float32 round-off. The frequency response agrees to ~1e-3 only: ``fc =
mean(freqs)`` may differ by an ulp between XLA's and torch's reductions,
which moves the ~2e4 rad phase of the specular ray by ~1e-3 rad.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from mimo_ofdm_tpu_torch.models.channels import (_distances, _f32, _fs_attenuation,
                                                 _rdiv, sqrt_rn)
from mimo_ofdm_tpu_torch.models.geometry import C_LIGHT

# TR 38.901 Table 7.5-3 ray offsets alpha_m, m = 1..20 as +-pairs
_RAY_BASE = np.array([0.0447, 0.1413, 0.2492, 0.3715, 0.5129,
                      0.6797, 0.8844, 1.1481, 1.5195, 2.1551])
_OFFSETS_BY_M = np.stack([_RAY_BASE, -_RAY_BASE], axis=1).reshape(-1)
# Table 7.5-5 sub-cluster ray partition, reordered so that each sub-cluster
# is a contiguous slice of the ray axis (delay offsets {0, 1.28, 2.56} c_DS)
_SUB_RAYS = [np.array([1, 2, 3, 4, 5, 6, 7, 8, 19, 20]),
             np.array([9, 10, 11, 12, 17, 18]),
             np.array([13, 14, 15, 16])]
_RAY_ORDER = np.concatenate(_SUB_RAYS) - 1
RAY_OFFSETS_20 = _OFFSETS_BY_M[_RAY_ORDER]
_SUB_SLICES = [(0, 10), (10, 16), (16, 20)]
_SUB_DELAY_FACTORS = np.array([0.0, 1.28, 2.56])

# Table 7.5-2: C_phi(N); Table 7.5-4: C_theta(N)
_C_PHI = {4: 0.779, 5: 0.860, 8: 1.018, 10: 1.090, 11: 1.123, 12: 1.146,
          14: 1.178, 15: 1.194, 16: 1.226, 19: 1.273, 20: 1.289, 25: 1.358}
_C_THETA = {8: 0.889, 10: 0.957, 11: 1.031, 12: 1.104, 15: 1.1088,
            19: 1.184, 20: 1.178, 25: 1.282}

# TR 38.901 Table 7.5-6 (UMa) + Table 7.5-7: lognormals mu = a + b log10(fc_GHz)
# and the cross-correlations of [DS, ASD, ZSD(, K)]
GSCM_SCENARIOS: dict[str, dict] = {
    "uma_los": {
        "los": True,
        "n_clusters": 12, "n_rays": 20, "r_tau": 2.5, "zeta_db": 3.0,
        "c_asd_deg": 5.0,
        "lg_ds": (-6.955, -0.0963, 0.66),
        "lg_asd": (1.06, 0.1114, 0.28),
        "k_db": (9.0, 3.5),
        "corr": {("ds", "asd"): 0.4, ("ds", "zsd"): -0.2, ("ds", "k"): -0.4,
                 ("asd", "zsd"): 0.5, ("asd", "k"): 0.0, ("zsd", "k"): 0.0},
        "zsd_sigma": 0.40,
    },
    "uma_nlos": {
        "los": False,
        "n_clusters": 20, "n_rays": 20, "r_tau": 2.3, "zeta_db": 3.0,
        "c_asd_deg": 2.0,
        "lg_ds": (-6.28, -0.204, 0.39),
        "lg_asd": (1.5, -0.1144, 0.28),
        "k_db": None,
        "corr": {("ds", "asd"): 0.4, ("ds", "zsd"): -0.5,
                 ("asd", "zsd"): 0.5},
        "zsd_sigma": 0.49,
    },
}


def _corr_chol(scn: dict) -> np.ndarray:
    """Cholesky factor of the LSP correlation matrix over [DS, ASD, ZSD(, K)]."""
    names = ["ds", "asd", "zsd"] + (["k"] if scn["k_db"] is not None else [])
    c = np.eye(len(names))
    for (a, b), v in scn["corr"].items():
        i, j = names.index(a), names.index(b)
        c[i, j] = c[j, i] = v
    return np.linalg.cholesky(c)


@functools.lru_cache(maxsize=None)
def _tables(scenario: str, device: torch.device
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A scenario's LSP Cholesky factor, the 20 ray offsets and the
    sub-cluster delay factors as float32 tensors on ``device``, made once:
    a host-to-device copy in every frame would wait for the device."""
    return (_f32(_corr_chol(GSCM_SCENARIOS[scenario]), device),
            _f32(RAY_OFFSETS_20, device), _f32(_SUB_DELAY_FACTORS, device))


def _element_amp(theta_deg: torch.Tensor, phi_rel_deg: torch.Tensor) -> torch.Tensor:
    """3GPP directional element field amplitude (TR 38.901 Table 7.3-1):
    12 dB parabolas with 65 deg HPBW and 30 dB floors."""
    tv = (theta_deg - 90.0) / 65.0
    th = phi_rel_deg / 65.0
    a_v = -torch.clamp(12.0 * (tv * tv), max=30.0)
    a_h = -torch.clamp(12.0 * (th * th), max=30.0)
    a_db = -torch.clamp(-(a_v + a_h), max=30.0)
    return 10.0 ** (a_db / 20.0)


def _wrap_azimuth(phi_deg: torch.Tensor) -> torch.Tensor:
    """Wrap azimuth to (-180, 180]."""
    return phi_deg - 360.0 * torch.round(phi_deg / 360.0)


def _fold_zenith(theta_deg: torch.Tensor) -> torch.Tensor:
    """Fold zenith into [0, 180] by reflection."""
    t = torch.fmod(theta_deg.abs(), 360.0)
    return torch.where(t > 180.0, 360.0 - t, t)


def _cube_poly(x, c0, c1, c2, c3):
    """``c0 + c1 x + c2 x**2 + c3 x**3`` in JAX's order (``x**3 = x (x x)``)."""
    x2 = x * x
    return c0 + c1 * x + c2 * x2 + c3 * (x * x2)


class GscmDraws(NamedTuple):
    """The nine draws of a batch of drops (``mimo_ofdm_tpu/models/gscm.py:171-172``),
    each with a leading batch dim:

    * ``lsp``: ``[B, n_lsp]`` unit normals of the large-scale parameters;
    * ``delay_u``: ``[B, n_cl]`` uniforms in ``[1e-6, 1)``;
    * ``pow_n``: ``[B, n_cl]`` unit normals of the cluster shadowing;
    * ``xa`` / ``ya``: ``[B, n_cl]`` AoD signs (+-1) and unit normals;
    * ``xz`` / ``yz``: ``[B, n_cl]`` ZoD signs and unit normals;
    * ``perm_u``: ``[B, n_cl, n_rays]`` uniforms whose argsort couples ZoD
      against AoD ray offsets;
    * ``phase``: ``[B, n_cl, n_rays]`` ray phases in ``[-pi, pi)``."""
    lsp: torch.Tensor
    delay_u: torch.Tensor
    pow_n: torch.Tensor
    xa: torch.Tensor
    ya: torch.Tensor
    xz: torch.Tensor
    yz: torch.Tensor
    perm_u: torch.Tensor
    phase: torch.Tensor

    @staticmethod
    def draw(scenario: str, batch: int, generator: torch.Generator) -> "GscmDraws":
        scn = GSCM_SCENARIOS[scenario]
        n_cl, n_rays = scn["n_clusters"], scn["n_rays"]
        n_lsp = 4 if scn["k_db"] is not None else 3
        dev = generator.device

        def normal(*shape):
            return torch.randn((batch, *shape), generator=generator, device=dev)

        def uniform(*shape):
            return torch.rand((batch, *shape), generator=generator, device=dev)

        def sign(*shape):
            return (torch.randint(0, 2, (batch, *shape), generator=generator,
                                  device=dev) * 2 - 1).to(torch.float32)

        return GscmDraws(normal(n_lsp), uniform(n_cl) * (1.0 - 1e-6) + 1e-6,
                         normal(n_cl), sign(n_cl), normal(n_cl), sign(n_cl),
                         normal(n_cl), uniform(n_cl, n_rays),
                         uniform(n_cl, n_rays) * (2.0 * math.pi) - math.pi)


def gscm_taps(draws: GscmDraws, tx_pos: torch.Tensor, rx_pos: torch.Tensor,
              fc: torch.Tensor, scenario: str = "uma_los",
              element_pattern: bool = True, boresight_az_deg: float = 90.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tap representation of a batch of drops
    (``mimo_ofdm_tpu/models/gscm.py:159-325``): ``(taps_v [B, n_ant,
    n_taps], taps_tau [B, n_taps])`` with ``n_taps = 3 n_clusters (+1 LOS
    specular)``. ``rx_pos``: ``[B, 3]``; ``fc``: a float32 scalar tensor."""
    scn = GSCM_SCENARIOS[scenario]
    n_cl, n_rays = scn["n_clusters"], scn["n_rays"]
    if n_rays != 20:
        raise ValueError("ray tables are the 20-ray TR 38.901 set")
    is_los = scn["los"]
    dev = tx_pos.device

    fc_ghz = fc / 1e9
    lam = _rdiv(C_LIGHT, fc)
    lg_fc = torch.log10(fc_ghz)

    # geometry: LOS direction from the array centre
    center = tx_pos.mean(-2)
    diff = rx_pos - center                                            # [B, 3]
    d2d = sqrt_rn(diff[:, 0] ** 2 + diff[:, 1] ** 2)
    d3d = sqrt_rn((diff[:, 0] ** 2 + diff[:, 1] ** 2) + diff[:, 2] ** 2)
    deg = 180.0 / math.pi
    phi_los = torch.arctan2(diff[:, 1], diff[:, 0]) * deg             # azimuth AoD
    theta_los = torch.arccos(diff[:, 2] / d3d) * deg                  # zenith AoD
    h_ut = rx_pos[:, 2]

    chol, offsets, sub_factors = _tables(scenario, dev)

    # step 4: correlated LSPs
    z = draws.lsp @ chol.T                                            # [B, n_lsp]
    a, b, sd = scn["lg_ds"]
    ds = 10.0 ** (a + b * lg_fc + sd * z[:, 0])                       # seconds
    a, b, sd = scn["lg_asd"]
    asd = torch.clamp(10.0 ** (a + b * lg_fc + sd * z[:, 1]), max=104.0)
    mu_lg_zsd = torch.clamp(-2.1 * (d2d / 1000.0) - 0.01 * (h_ut - 1.5)
                            + (0.75 if is_los else 0.9), min=-0.5)
    zsd = torch.clamp(10.0 ** (mu_lg_zsd + scn["zsd_sigma"] * z[:, 2]), max=52.0)
    if is_los:
        k_db = scn["k_db"][0] + scn["k_db"][1] * z[:, 3]
        k_lin = 10.0 ** (k_db / 10.0)
        zod_offset = 0.0
    else:
        k_lin = torch.zeros_like(ds)
        e = ((0.208 * lg_fc - 0.782) * torch.log10(torch.clamp(d2d, min=25.0))
             - 0.13 * lg_fc + 2.03 - 0.07 * (h_ut - 1.5))
        zod_offset = 7.66 * lg_fc - 5.96 - 10.0 ** e

    # step 5: cluster delays
    r_tau = scn["r_tau"]
    tau_raw = (-r_tau * ds)[:, None] * torch.log(draws.delay_u)
    tau = torch.sort(tau_raw - tau_raw.min(-1, keepdim=True).values, dim=-1).values
    if is_los:
        c_tau = _cube_poly(k_db, 0.7705, -0.0433, 0.0002, 0.000017)
        tau_coeff = tau / c_tau[:, None]
    else:
        tau_coeff = tau

    # step 6: cluster powers
    zeta = scn["zeta_db"] * draws.pow_n
    p_raw = (torch.exp(-tau * (r_tau - 1.0) / (r_tau * ds)[:, None])
             * 10.0 ** (-zeta / 10.0))
    p = p_raw / p_raw.sum(-1, keepdim=True)                           # diffuse, sum 1
    if is_los:
        p_ang = p / (k_lin + 1.0)[:, None]
        p_ang = torch.cat([p_ang[:, :1] + (k_lin / (k_lin + 1.0))[:, None],
                           p_ang[:, 1:]], dim=-1)
    else:
        p_ang = p

    # step 7: power-coupled departure angles
    c_phi, c_theta = _C_PHI[n_cl], _C_THETA[n_cl]
    if is_los:
        c_phi = c_phi * _cube_poly(k_db, 1.1035, -0.028, -0.002, 0.0001)
        c_theta = c_theta * _cube_poly(k_db, 1.3086, 0.0339, -0.0077, 0.0002)
        c_phi, c_theta = c_phi[:, None], c_theta[:, None]
    neg_log_ratio = torch.clamp(-torch.log(p_ang / p_ang.max(-1, keepdim=True).values),
                                min=0.0)
    phi_p = 2.0 * (asd / 1.4)[:, None] * torch.sqrt(neg_log_ratio) / c_phi
    x_a, y_a = draws.xa, (asd / 7.0)[:, None] * draws.ya
    if is_los:
        phi_cl = (x_a * phi_p + y_a) - (x_a[:, :1] * phi_p[:, :1] + y_a[:, :1]
                                        - phi_los[:, None])
    else:
        phi_cl = x_a * phi_p + y_a + phi_los[:, None]
    theta_p = zsd[:, None] * neg_log_ratio / c_theta
    x_z, y_z = draws.xz, (zsd / 7.0)[:, None] * draws.yz
    if is_los:
        theta_cl = ((x_z * theta_p + y_z)
                    - (x_z[:, :1] * theta_p[:, :1] + y_z[:, :1] - theta_los[:, None]))
    else:
        theta_cl = x_z * theta_p + y_z + theta_los[:, None] + zod_offset[:, None]

    # steps 7/8: ray angles and the random ZoD/AoD coupling
    phi_ray = phi_cl[..., None] + scn["c_asd_deg"] * offsets
    perm = torch.argsort(draws.perm_u, dim=-1)
    zspread = (3.0 / 8.0) * 10.0 ** mu_lg_zsd
    theta_ray = _fold_zenith(theta_cl[..., None] + zspread[:, None, None] * offsets[perm])

    # steps 10-11: ray coefficients
    diffuse_scale = _rdiv(1.0, k_lin + 1.0)[:, None] if is_los else 1.0
    amp = torch.sqrt(p * diffuse_scale / n_rays)[..., None]           # [B, n_cl, 1]
    if element_pattern:
        amp = amp * _element_amp(theta_ray, _wrap_azimuth(phi_ray - boresight_az_deg))
    gain = torch.polar(amp.expand(theta_ray.shape), draws.phase)      # [B, n_cl, n_rays]

    # array steering from the true element positions
    rad = math.pi / 180.0
    th, ph = theta_ray * rad, phi_ray * rad
    rhat = torch.stack([torch.sin(th) * torch.cos(ph), torch.sin(th) * torch.sin(ph),
                        torch.cos(th)], dim=-1)                       # [B, n_cl, n_rays, 3]
    d_el = tx_pos - center                                            # [n_ant, 3]
    proj = torch.einsum("ax,bnmx->banm", d_el, rhat)                  # [B, n_ant, n_cl, n_rays]
    k_wave = _rdiv(2.0 * math.pi, lam)
    g = gain[:, None] * torch.polar(torch.ones((), device=dev), k_wave * proj)

    # sub-cluster taps: ray groups 10/6/4; only the two strongest clusters
    # get nonzero sub-delay offsets
    v = torch.stack([g[..., s0:s1].sum(-1) for s0, s1 in _SUB_SLICES], dim=-1)
    rank = torch.argsort(torch.argsort(-p_ang, dim=-1), dim=-1)
    is_top2 = (rank < 2).to(torch.float32)                            # [B, n_cl]
    c_ds = torch.clamp(6.5622 - 3.4084 * lg_fc, min=0.25) * 1e-9
    sub_off = sub_factors * c_ds
    tau_sub = tau_coeff[..., None] + is_top2[..., None] * sub_off

    batch = v.shape[0]
    taps_v = v.reshape(batch, v.shape[1], -1)                         # [B, n_ant, 3 n_cl]
    taps_tau = tau_sub.reshape(batch, -1)
    if is_los:
        # LOS specular ray (TR 38.901 eq. 7.5-30): sqrt(K/(K+1)) at the LOS
        # departure angles, delay 0, phase from the propagation distance
        spec_amp = torch.sqrt(k_lin / (k_lin + 1.0))
        if element_pattern:
            spec_amp = spec_amp * _element_amp(
                theta_los, _wrap_azimuth(phi_los - boresight_az_deg))
        rhat_los = diff / d3d[:, None]
        proj_los = rhat_los @ d_el.T                                  # [B, n_ant]
        theta = k_wave * proj_los - (2.0 * math.pi) * d3d[:, None] / lam
        spec = torch.polar(spec_amp[:, None].expand(theta.shape), theta)
        taps_v = torch.cat([taps_v, spec[..., None]], dim=-1)
        taps_tau = torch.cat([taps_tau, torch.zeros_like(taps_tau[:, :1])], dim=-1)
    return taps_v, taps_tau


def gscm_channel(draws: GscmDraws, tx_pos: torch.Tensor, rx_pos: torch.Tensor,
                 freqs: torch.Tensor, scenario: str = "uma_los",
                 skip_attenuation: bool = False, tx_gain_db: float = 0.0,
                 rx_gain_db: float = 0.0, element_pattern: bool = True,
                 boresight_az_deg: float = 90.0) -> torch.Tensor:
    """A batch of TR 38.901 drops, ``[B, n_ant, n_f]`` complex64, at the
    element positions ``tx_pos [n_ant, 3]`` toward a single-antenna RX at
    ``rx_pos [B, 3]`` (``mimo_ofdm_tpu/models/gscm.py:328-361``). The
    element boresight is ``boresight_az_deg`` from +x (90: broadside of the
    canonical x-axis ULA). Each frame is an independent drop."""
    taps_v, taps_tau = gscm_taps(draws, tx_pos, rx_pos, freqs.mean(),
                                 scenario=scenario, element_pattern=element_pattern,
                                 boresight_az_deg=boresight_az_deg)
    theta = (-2.0 * math.pi) * freqs * taps_tau[..., None]            # [B, n_taps, n_f]
    ef = torch.polar(torch.ones((), device=freqs.device), theta)
    h = torch.matmul(taps_v, ef)
    if not skip_attenuation:
        h = h * _fs_attenuation(_distances(tx_pos, rx_pos), freqs, tx_gain_db,
                                rx_gain_db)
    return h
