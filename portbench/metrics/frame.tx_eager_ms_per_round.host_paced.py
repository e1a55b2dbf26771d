"""frame.tx_eager_ms_per_round.host_paced: ``frame.tx_eager_ms_per_round`` in the cells whose
host paces, or nearly paces, the round; it moves
``frames_per_s.host_paced``."""


def read(view):
    return view.read("frame.tx_eager_ms_per_round")
