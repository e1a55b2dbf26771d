"""device.idle_in_frame_share: the share of the traced window in which no
operation ran on the card while the host was inside the program's
``frame`` span, enqueueing a round: the part of ``device.idle_share`` that
the port's launch path owns; the rest is the harness's fetch loop. From the
program's spans (``stages.py``); None without them."""

from portbench import stages


def read(view):
    st = stages.of(view)
    if st is None or not st.rounds or not view.device_ops or view.window_us <= 0:
        return None
    return st.idle_in_frame_us() / view.window_us
