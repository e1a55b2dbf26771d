"""device.idle_in_frame_share.host_paced: ``device.idle_in_frame_share`` in the cells whose
host paces, or nearly paces, the round; it moves
``frames_per_s.host_paced``."""


def read(view):
    return view.read("device.idle_in_frame_share")
