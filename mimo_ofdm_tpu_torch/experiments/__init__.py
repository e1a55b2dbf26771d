"""Experiment entry points of the port (counterpart of
``mimo_ofdm_tpu/experiments``): each is a function over structured
configs, and the CLI runs them by name:

    python -m mimo_ofdm_tpu_torch.experiments <name> [--flag value ...]

Every experiment of the JAX package is registered, all 37:

* ``ber_sweeps.py``: the BER sweeps (vs Eb/N0, IBO and antenna count, the
  fixed-BER grid, the AWGN, CSI-error and TOI variants,
  ``reproduce_reference_curve``, the multi-user sweep ``multiuser_ber``,
  and the LDPC-coded sweeps ``ldpc_coded_ber``, ``transport_coded_ber``,
  ``ldpc_ref_ber``, ``ldpc_in_loop_ber``, ``nvadj_ldpc_ber`` and
  ``ldpc_table_sensitivity``);
* ``spatial.py``: beampatterns, radiation patterns with PSDs, MU SINR,
  EVM and SDR vs IBO, channel and spatial correlation, PSD evaluation and
  the two-user and n-user SDR studies;
* ``misc_evals.py``: alpha validation, complexity tables, PA
  characteristics, channel transfer functions, alpha vs per-antenna power,
  the precoding/nonlinearity commutation check;
* ``siso_checks.py``: the SISO SER anchors in AWGN and Rayleigh;
* ``parallel_evals.py``: ``weak_scaling``, frames/s and efficiency of the
  sharded round over growing dp meshes (``parallel/scaling.py``).

Under ``torchrun`` (``WORLD_SIZE`` set) the CLI joins the job's process
group first (``parallel/multihost.py``), so an experiment's rounds can
shard over its ranks.
"""

from __future__ import annotations

EXPERIMENTS = {}


def register(name):
    def deco(fn):
        EXPERIMENTS[name] = fn
        return fn
    return deco


from mimo_ofdm_tpu_torch.experiments import (  # noqa: E402,F401
    ber_sweeps, misc_evals, parallel_evals, siso_checks, spatial)
