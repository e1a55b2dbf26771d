"""JAX's own random draws of the stochastic channels and of the analysis
scans, taken where the JAX package takes them, as the port's draw tuples of
numpy arrays (helper of tests/test_torch_channels_stochastic.py,
tests/test_torch_link_mu.py, tests/test_torch_analysis*.py and
tests/test_torch_experiments_{analysis,scans,spatial}.py).

Each channel splits its fade key ``k_fade`` (``models/link.py:75``) as the
JAX source does:

* Rician: ``complex_normal(k_fade, (n_ant, n_sc))``, i.e. ``normal(k_fade,
  (2, n_ant, n_sc))`` (``models/channels.py:142``, ``ops/noise.py:21``);
* random paths: ``split(k_fade)`` into angle and delay uniforms
  (``models/channels.py:119-121``);
* TDL: ``split(k_fade, 4)`` into fade, DoA, K-factor and delay-spread keys
  (``models/channels.py:275-313``);
* GSCM: ``split(k_fade, 9)`` (``models/gscm.py:171-172``).

The analysis scans (``models/analysis.py``) draw their bits with
``bernoulli(k, 0.5, shape)`` and their Rayleigh fades with
``complex_normal(k, (n_ant, n_f))``, i.e. ``normal(k, (2, n_ant, n_f))``,
from keys split and folded per point, IBO value and snapshot; the
``scan_*`` functions below follow each scan's key tree and return
:class:`mimo_ofdm_tpu_torch.models.analysis.ScanDraws` of numpy arrays.
The experiments that draw their own bits and fades (``mu_beampattern``,
``evm_vs_ibo``, ``psd_eval``, the alpha studies, ...) get JAX's draws
through :func:`feed_port`, which :func:`run_experiment_pair` uses to run
JAX's experiment and the port's on the same inputs.

Call these under ``jax.enable_x64(False)``: the suite runs JAX in x64 mode,
which would draw in float64 (and ``bernoulli`` would give other bits).
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mimo_ofdm_tpu.models import channels as jchannels
from mimo_ofdm_tpu.models import gscm as jgscm

from mimo_ofdm_tpu_torch.models import channels, gscm
from mimo_ofdm_tpu_torch.models.analysis import ScanDraws


def chan_draws(jcfg, k_fade):
    """The channel's draws from its fade key, one frame, as numpy (None
    for the channels that draw nothing of their own)."""
    ch = jcfg.channel
    n_ant, n_sc = jcfg.array.n_elements, jcfg.modem.n_sub_carr
    if ch.model == "rician":
        return np.asarray(jax.random.normal(k_fade, (2, n_ant, n_sc), jnp.float32))
    if ch.model == "random_paths":
        k_ang, k_tau = jax.random.split(k_fade)
        return channels.RandomPathsDraws(
            np.asarray(jax.random.uniform(k_ang, (ch.n_paths,), minval=-jnp.pi / 2,
                                          maxval=jnp.pi / 2)),
            np.asarray(jax.random.uniform(k_tau, (ch.n_paths,), minval=0.0,
                                          maxval=ch.max_delay_spread)))
    if ch.model == "tdl_3gpp":
        prof = jchannels.TDL_PROFILES[ch.tdl_profile]
        n_taps = len(prof["delays"])
        kf, kd, kk, kds = jax.random.split(k_fade, 4)
        rays = (ch.tdl_subpaths,) if ch.tdl_subpaths > 1 else ()
        k = (np.asarray(jax.random.normal(kk, ()))
             if ch.tdl_k_db is not None and prof["los_db"] is not None else None)
        ds = np.asarray(jax.random.normal(kds, ())) if ch.tdl_ds_log10_std > 0 else None
        return channels.TdlDraws(
            np.asarray(jax.random.normal(kf, (2, n_taps, *rays), jnp.float32)),
            np.asarray(jax.random.uniform(kd, (n_taps,), minval=-jnp.pi / 2,
                                          maxval=jnp.pi / 2)), k, ds)
    if ch.model == "gscm":
        return gscm_draws(ch.gscm_scenario, k_fade)
    return None


def gscm_draws(scenario, key):
    scn = jgscm.GSCM_SCENARIOS[scenario]
    n_cl, n_rays = scn["n_clusters"], scn["n_rays"]
    n_lsp = 4 if scn["k_db"] is not None else 3
    k = jax.random.split(key, 9)
    normal, uniform = jax.random.normal, jax.random.uniform
    out = (normal(k[0], (n_lsp,)),
           uniform(k[1], (n_cl,), minval=1e-6, maxval=1.0),
           normal(k[2], (n_cl,)),
           jax.random.rademacher(k[3], (n_cl,), dtype=jnp.float32),
           normal(k[4], (n_cl,)),
           jax.random.rademacher(k[5], (n_cl,), dtype=jnp.float32),
           normal(k[6], (n_cl,)),
           uniform(k[7], (n_cl, n_rays)),
           uniform(k[8], (n_cl, n_rays), minval=-jnp.pi, maxval=jnp.pi))
    return gscm.GscmDraws(*(np.asarray(a) for a in out))


def stack_chan(draws):
    """Per-frame draw tuples stacked along a new leading batch axis."""
    if draws[0] is None:
        return None
    if isinstance(draws[0], np.ndarray):
        return np.stack(draws)
    return type(draws[0])(*(None if f[0] is None else np.stack(f) for f in zip(*draws)))


# --- the analysis scans' draws ----------------------------------------------

fold, split = jax.random.fold_in, jax.random.split


def bits(key, shape):
    return jax.random.bernoulli(key, 0.5, shape).astype(jnp.int8)


def normals(key, *shape):
    return jax.random.normal(key, (2, *shape), jnp.float32)


def scan_snapshot_bits(key, n_snap, shape):
    """``bits [n_snap, *shape]`` of ``split(key, n_snap)``: the shared frames
    of beampattern_scan, mu_sinr_sdr and the spatial experiments."""
    return np.asarray(jax.vmap(lambda k: bits(k, shape))(split(key, n_snap)))


def scan_radiation(key, n_pts, n_snap, bit_shape, fade_shape=None):
    """radiation_pattern: ``k_chan, k_bits = split(key)``; point ``i``'s
    fade from ``fold_in(k_chan, i)``, its snapshots from
    ``split(fold_in(k_bits, i), n_snap)``."""
    k_chan, k_bits = split(key)
    idx = jnp.arange(n_pts)
    b = jax.vmap(lambda i: jax.vmap(lambda k: bits(k, bit_shape))(
        split(fold(k_bits, i), n_snap)))(idx)
    fade = (None if fade_shape is None
            else np.asarray(jax.vmap(lambda i: normals(fold(k_chan, i), *fade_shape))(idx)))
    return ScanDraws(np.asarray(b), fade)


def scan_channel_corr(key, n_points, fade_shape):
    """channel_mat_correlation_scan: the main fade from ``fold_in(key,
    n_points + 1)``, point ``i``'s from ``fold_in(key, i)``."""
    fade = jax.vmap(lambda i: normals(fold(key, i), *fade_shape))(jnp.arange(n_points + 1))
    return ScanDraws(np.zeros(0, np.int8), np.asarray(fade),
                     main=np.asarray(normals(fold(key, n_points + 1), *fade_shape)))


def scan_spatial(key, n_points, n_bits, fade_shape=None):
    """spatial_correlation_scan: ``k_bits, k_chan = split(key)``; for
    precoding point ``q``, ``kq = fold_in(k_chan, q)``, its precoding fade
    from ``fold_in(kq, 0)`` and the fade measured at ``p`` from
    ``fold_in(kq, p + 1)``."""
    k_bits, k_chan = split(key)
    fade = None
    if fade_shape is not None:
        j = jnp.arange(n_points + 2)
        fade = np.asarray(jax.vmap(lambda q: jax.vmap(
            lambda p: normals(fold(fold(k_chan, q), p), *fade_shape))(j))(j[:-1]))
    return ScanDraws(np.asarray(bits(k_bits, (n_bits,))), fade)


def scan_sdr(key, n_ibo, n_snap, n_bits, fade_shape, loc_var):
    """make_sdr_fn: IBO ``i``'s snapshots ``split(fold_in(key, i), n_snap)``,
    each ``k_chan, k_bits = split(k)`` and ``k_loc, k_fade = split(k_chan)``
    (``models/link.py::make_channel_fn``)."""
    half = loc_var / 2.0

    def snap(k):
        k_chan, k_bits = split(k)
        k_loc, k_fade = split(k_chan)
        return (bits(k_bits, (n_bits,)), normals(k_fade, *fade_shape),
                jax.random.uniform(k_loc, (2,), minval=-half, maxval=half))

    b, f, loc = jax.vmap(lambda i: jax.vmap(snap)(split(fold(key, i), n_snap)))(
        jnp.arange(n_ibo))
    return ScanDraws(np.asarray(b), np.asarray(f), loc=np.asarray(loc))


def scan_overlap(key, n_points, n_snap, n_bits, fade_shape):
    """mu_angle_overlap_scan: the main fade from ``fold_in(key, n_points +
    1)``, point ``i``'s from ``fold_in(key, i)``, its snapshots from
    ``split(fold_in(key, 7000 + i), n_snap)``."""
    idx = jnp.arange(n_points + 1)
    b = jax.vmap(lambda i: jax.vmap(lambda k: bits(k, (2, n_bits)))(
        split(fold(key, 7000 + i), n_snap)))(idx)
    fade = jax.vmap(lambda i: normals(fold(key, i), *fade_shape))(idx)
    return ScanDraws(np.asarray(b), np.asarray(fade),
                     main=np.asarray(normals(fold(key, n_points + 1), *fade_shape)))


def scan_nusers(key, n_ibo, n_snap, n_users, n_bits, fade_shape):
    """make_mu_nusers_sdr_fn: IBO ``i``'s snapshots ``split(fold_in(key,
    i), n_snap)``, each ``k_loc, k_bits = split(k)``; the angle uniforms
    from ``k_loc`` (one user) or ``split(k_loc, n_users)``, user ``u``'s
    fade from ``fold_in(k_loc, u)``."""
    def snap(k):
        k_loc, k_bits = split(k)
        if n_users == 1:
            u = jax.random.uniform(k_loc, (1,))
        else:
            u = jnp.stack([jax.random.uniform(kk, ()) for kk in split(k_loc, n_users)])
        fade = jax.vmap(lambda j: normals(fold(k_loc, j), *fade_shape))(jnp.arange(n_users))
        return bits(k_bits, (n_users, n_bits)), fade, u

    b, f, u = jax.vmap(lambda i: jax.vmap(snap)(split(fold(key, i), n_snap)))(
        jnp.arange(n_ibo))
    return ScanDraws(np.asarray(b), np.asarray(f), angles=np.asarray(u))


def experiment_evm(key, n_snap, n_bits, fade_shape=None):
    """evm_vs_ibo (``experiments/spatial.py:205-223``): snapshot ``k`` of
    ``split(key, n_snap)`` splits into ``k_c, k_b``; the bits from ``k_b``,
    the Rayleigh fade from ``split(k_c)[1]`` (``models/link.py:75``).
    Returns ``(bits [S, n_bits], fade [S, 2, *fade_shape] or None)``."""
    def snap(k):
        k_c, k_b = split(k)
        return bits(k_b, (n_bits,)), normals(split(k_c)[1], *(fade_shape or (1,)))

    b, f = jax.vmap(snap)(split(key, n_snap))
    return np.asarray(b), None if fade_shape is None else np.asarray(f)


def feed_port(monkeypatch, bits_seq=(), normals_seq=()):
    """Make the port draw the given numpy arrays, in order, where it would
    draw from its generator: one of ``bits_seq`` at each
    ``ops.bits.random_payload_bits`` call, one of ``normals_seq`` at each
    ``models.analysis._normals`` call, each checked against the shape asked
    for. Returns the two queues, which are empty once every array was
    drawn."""
    import torch
    from mimo_ofdm_tpu_torch.models import analysis as pan
    from mimo_ofdm_tpu_torch.ops import bits as pbits
    queues = {"bits": list(bits_seq), "normals": list(normals_seq)}

    def pop(kind, gen, shape):
        a = np.asarray(queues[kind].pop(0))
        assert a.shape == tuple(shape), (kind, a.shape, tuple(shape))
        return torch.from_numpy(a.copy()).to(gen.device)

    monkeypatch.setattr(pbits, "random_payload_bits",
                        lambda gen, shape: pop("bits", gen, np.atleast_1d(shape)))
    monkeypatch.setattr(pan, "_normals", lambda gen, *shape: pop("normals", gen, shape))
    return queues


class ExperimentPair(NamedTuple):
    jax: object            # what JAX's experiment returned
    port: object           # what the port's returned, on JAX's draws
    directory: object      # CSVs under directory / "jax" and directory / "port"
    jax_tx: dict           # JAX's first array_transmit_fd call: v, sat_power, toi_coeff
    port_tx: dict          # the port's first analysis.tx_sc call: v, sat, toi_coeff


def run_experiment_pair(jax_fn, port_fn, kw, draws, directory) -> ExperimentPair:
    """Run JAX's experiment and the port's with the same arguments, the
    port on JAX's draws, each writing its CSVs under ``directory``.
    ``draws()`` gives ``(bits_seq, normals_seq)`` as :func:`feed_port`
    takes them. JAX's side and the draws run under
    ``jax.enable_x64(False)``. The first transmit of each records its
    precoder and PA parameters."""
    from mimo_ofdm_tpu.models import transmit as jtx
    from mimo_ofdm_tpu_torch.models import analysis as pan
    jax_tx, port_tx = {}, {}

    def record_jax(bits_, **k):
        if not jax_tx and not isinstance(k["v"], jax.core.Tracer):
            jax_tx.update(v=np.asarray(k["v"]), sat=np.asarray(k.get("sat_power", 1.0)),
                          toi_coeff=np.asarray(k.get("toi_coeff", 0.0)))
        return jax_transmit(bits_, **k)

    def record_port(bits_, v, cfg, sat, toi_coeff=0.0, sum_users=None):
        if not port_tx:
            port_tx.update(v=v.numpy(), sat=np.asarray(sat), toi_coeff=np.asarray(toi_coeff))
        return port_tx_sc(bits_, v, cfg, sat, toi_coeff, sum_users)

    jax_transmit, port_tx_sc = jtx.array_transmit_fd, pan.tx_sc
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MIMO_OFDM_TPU_RESULTS", str(directory / "jax"))
        mp.setenv("MIMO_OFDM_TPU_TORCH_RESULTS", str(directory / "port"))
        mp.setattr(jtx, "array_transmit_fd", record_jax)
        mp.setattr(pan, "tx_sc", record_port)
        with jax.enable_x64(False):
            j = jax_fn(**kw)
            bits_seq, normals_seq = draws()
        queues = feed_port(mp, bits_seq, normals_seq)
        p = port_fn(**kw, device="cpu")
        assert not any(queues.values()), "the port drew fewer arrays than JAX"
    return ExperimentPair(j, p, directory, jax_tx, port_tx)


def peak_rel(a, b):
    """max |a - b| relative to max |b|."""
    a, b = np.asarray(a).astype(np.complex128), np.asarray(b).astype(np.complex128)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def as_torch(draws: ScanDraws) -> ScanDraws:
    """A ScanDraws of numpy arrays as CPU tensors (bits int8, the rest float32)."""
    import torch

    def conv(a):
        if a is None:
            return None
        return torch.from_numpy(np.array(a, np.int8 if a.dtype == np.int8 else np.float32))
    return ScanDraws(*(conv(a) for a in draws))



def siso_draws(keys, n_sc, n_bits, rayleigh):
    """The SISO frame's draws (``experiments/siso_checks.py:99-123``): each
    key splits into fade, clean bits, distorted bits, clean noise and
    distorted noise keys."""
    import torch
    from mimo_ofdm_tpu_torch.experiments.siso_checks import SisoDraws

    def one(key):
        k_fade, k_bc, k_bd, k_nc, k_nd = split(key, 5)
        return (normals(k_fade, n_sc), bits(k_bc, (n_bits,)), bits(k_bd, (n_bits,)),
                normals(k_nc, n_sc), normals(k_nd, n_sc))

    fade, bc, bd, nc, nd = (torch.from_numpy(np.array(a)) for a in jax.vmap(one)(keys))
    return SisoDraws(fade if rayleigh else None, bc, bd, nc, nd)
