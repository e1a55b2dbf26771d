"""setup.program_s: host seconds of ``setup_s`` spent inside the program's
top-level spans that end before the traced window: ``setup.frame_fn``
(building the frame function) and the warm-up ``frame`` calls (the kernel's
library, ``setup.kernel_library``, loads or builds inside the first). The
rest of ``setup_s`` is imports, the CUDA context and the input pool. From
the program's spans (``stages.py``); None without them."""

from portbench import stages


def read(view):
    st = stages.of(view)
    return None if st is None else st.setup_s()
