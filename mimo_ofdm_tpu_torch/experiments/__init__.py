"""Experiment entry points of the port (counterpart of
``mimo_ofdm_tpu/experiments``): each is a function over structured
configs, and the CLI runs them by name:

    python -m mimo_ofdm_tpu_torch.experiments <name> [--flag value ...]

Only the ported experiments are registered: the BER sweeps of
``experiments/ber_sweeps.py`` (vs Eb/N0, IBO and antenna count, the
fixed-BER grid, the AWGN, CSI-error and TOI variants, and the multi-user
sweep ``multiuser_ber``).
"""

from __future__ import annotations

EXPERIMENTS = {}


def register(name):
    def deco(fn):
        EXPERIMENTS[name] = fn
        return fn
    return deco


from mimo_ofdm_tpu_torch.experiments import ber_sweeps  # noqa: E402,F401
