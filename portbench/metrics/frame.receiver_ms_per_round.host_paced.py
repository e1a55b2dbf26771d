"""frame.receiver_ms_per_round.host_paced: ``frame.receiver_ms_per_round`` in the cells whose
host paces, or nearly paces, the round; it moves
``frames_per_s.host_paced``."""


def read(view):
    return view.read("frame.receiver_ms_per_round")
