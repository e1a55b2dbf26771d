"""frame.demap_ms_per_round: device ms a round of the work the program
launches inside its ``soft_demap`` spans (``ops/qam.py::soft_llr``): the
exact log-sum-exp LLRs of the clean run's and every pass's corrected
symbols. From the program's spans (``stages.py``); None without them."""

from portbench import stages

NAMES = ("soft_demap",)


def read(view):
    st = stages.of(view)
    return None if st is None else st.device_ms_per_round(NAMES)
