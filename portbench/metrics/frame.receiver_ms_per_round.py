"""frame.receiver_ms_per_round: device ms a round of the work the program
launches inside its ``rx.detect`` and ``rx.update`` spans
(``receivers.py::cnc_iterate``): each CNC/MCNC pass's subtraction and
detection and its distortion update, the replica itself left out. From
the program's spans (``stages.py``); None without them."""

from portbench import stages

NAMES = ("rx.detect", "rx.update")


def read(view):
    st = stages.of(view)
    return None if st is None else st.device_ms_per_round(NAMES)
