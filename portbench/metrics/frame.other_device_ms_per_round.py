"""frame.other_device_ms_per_round: device time of every kernel that is not
the fused chain kernel, per round: the eager passes of ``link_planar.py``,
``receivers.py`` and ``precoding.py``, and the harness's one ``cat`` a
round that joins the counters for the copy to the host (the copy itself is
no kernel). The fused kernel is told apart by the names that
``kernel.fused_pa_ms_per_round`` lists."""

FUSED_METRIC = "kernel.fused_pa_ms_per_round"


def read(view):
    if not view.kernels or not view.rounds:
        return None
    total = sum(e - s for s, e, _, _ in view.kernels) / 1e3 / view.rounds
    return total - (view.read(FUSED_METRIC) or 0.0)
