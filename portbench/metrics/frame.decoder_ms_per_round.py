"""frame.decoder_ms_per_round: device ms a round of the work the program
launches inside its ``decode`` spans (``ops/transport.py::transport_decode``
and, within it, ``ops/ldpc.py::decode``): de-rate-matching, the flooding
sum-product iterations over every (frame, pass) codeword at once, and the
TB CRC check. From the program's spans (``stages.py``); None without them."""

from portbench import stages

NAMES = ("decode",)


def read(view):
    st = stages.of(view)
    return None if st is None else st.device_ms_per_round(NAMES)
