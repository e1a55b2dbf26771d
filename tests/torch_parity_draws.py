"""JAX's own random draws of the stochastic channels, taken where the JAX
package takes them, as the port's draw tuples of numpy arrays (helper of
tests/test_torch_channels_stochastic.py and tests/test_torch_link_mu.py).

Each channel splits its fade key ``k_fade`` (``models/link.py:75``) as the
JAX source does:

* Rician: ``complex_normal(k_fade, (n_ant, n_sc))``, i.e. ``normal(k_fade,
  (2, n_ant, n_sc))`` (``models/channels.py:142``, ``ops/noise.py:21``);
* random paths: ``split(k_fade)`` into angle and delay uniforms
  (``models/channels.py:119-121``);
* TDL: ``split(k_fade, 4)`` into fade, DoA, K-factor and delay-spread keys
  (``models/channels.py:275-313``);
* GSCM: ``split(k_fade, 9)`` (``models/gscm.py:171-172``).

Call these under ``jax.enable_x64(False)``: the suite runs JAX in x64 mode,
which would draw in float64.
"""

import numpy as np
import jax
import jax.numpy as jnp

from mimo_ofdm_tpu.models import channels as jchannels
from mimo_ofdm_tpu.models import gscm as jgscm

from mimo_ofdm_tpu_torch.models import channels, gscm


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
