"""kernel.fused_pa_roofline: the fused chain's least time a round
(``portbench/roofline.py``: rows from the configuration, bytes at its
storage, ``5 n log2 n`` operations a transform, the published peaks) over
the fused kernel's device time a round, in percent."""

from portbench import roofline

FUSED_METRIC = "kernel.fused_pa_ms_per_round"


def read(view):
    fused_ms = view.read(FUSED_METRIC)
    if not fused_ms:
        return None
    least_ms = roofline.round_least_seconds(view.link, view.traffic) * 1e3
    return 100.0 * least_ms / fused_ms
