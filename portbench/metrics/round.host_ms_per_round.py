"""round.host_ms_per_round: the host clock inside the port's frame call
(enqueueing a round), summed over the traced window, per round. Read in
traced runs only, where the profiler adds its own cost: compare traced
runs with traced runs."""


def read(view):
    if not view.rounds or view.host_frame_s <= 0:
        return None
    return view.host_frame_s * 1e3 / view.rounds
