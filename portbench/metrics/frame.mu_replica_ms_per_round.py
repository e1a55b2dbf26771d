"""frame.mu_replica_ms_per_round: device ms a round of the work the program
launches inside its ``mu.precode`` and ``mu.combine`` spans
(``receivers.py::make_mcnc_mu_replica``): the MCNC-MU replica's eager work
around the fused kernel, the joint precode of every user's symbols with
its own detection swapped in, and each user's antenna combine and AGC
divide (K3-MU), in every pass. From the program's spans (``stages.py``);
None without them."""

from portbench import stages

NAMES = ("mu.precode", "mu.combine")


def read(view):
    st = stages.of(view)
    return None if st is None else st.device_ms_per_round(NAMES)
