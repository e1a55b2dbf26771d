"""frame.precoder_ms_per_round: device ms a round of the work the program
launches inside its ``frame.precoder`` span (``link_planar.py::_frame``):
the MRT precoder, the per-antenna powers, the ``hv``/``akhv`` antenna sums,
the AGC noise scalers and the PA's saturation power. From the program's
spans (``stages.py``); None without them."""

from portbench import stages

NAMES = ("frame.precoder",)


def read(view):
    st = stages.of(view)
    return None if st is None else st.device_ms_per_round(NAMES)
