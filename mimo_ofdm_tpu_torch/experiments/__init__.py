"""Experiment entry points of the port (counterpart of
``mimo_ofdm_tpu/experiments``): each is a function over structured
configs, and the CLI runs them by name:

    python -m mimo_ofdm_tpu_torch.experiments <name> [--flag value ...]

Only the ported experiments are registered: the BER sweeps of
``experiments/ber_sweeps.py`` (vs Eb/N0, IBO and antenna count, the
fixed-BER grid, the AWGN, CSI-error and TOI variants, the multi-user
sweep ``multiuser_ber``, and the LDPC-coded sweeps ``ldpc_coded_ber``,
``transport_coded_ber``, ``ldpc_ref_ber``, ``ldpc_in_loop_ber``,
``nvadj_ldpc_ber`` and ``ldpc_table_sensitivity``).
"""

from __future__ import annotations

EXPERIMENTS = {}


def register(name):
    def deco(fn):
        EXPERIMENTS[name] = fn
        return fn
    return deco


from mimo_ofdm_tpu_torch.experiments import ber_sweeps  # noqa: E402,F401
