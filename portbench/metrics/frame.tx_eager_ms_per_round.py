"""frame.tx_eager_ms_per_round: device ms a round of the work the program
launches inside its ``tx.precode`` and ``tx.combine`` spans
(``link_planar.py::tx_propagate``): the precode before the fused kernel and
the antenna combine after it (K3), in the distorted TX and in every MCNC
replica pass. From the program's spans (``stages.py``); None without them."""

from portbench import stages

NAMES = ("tx.precode", "tx.combine")


def read(view):
    st = stages.of(view)
    return None if st is None else st.device_ms_per_round(NAMES)
