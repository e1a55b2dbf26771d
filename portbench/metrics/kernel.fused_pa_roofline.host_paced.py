"""kernel.fused_pa_roofline.host_paced: ``kernel.fused_pa_roofline`` in the
cells whose host paces, or nearly paces, the round; it moves
``frames_per_s.host_paced``."""


def read(view):
    return view.read("kernel.fused_pa_roofline")
