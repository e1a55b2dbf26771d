"""kernel.fused_pa_ms_per_round: device time of the fused IFFT -> PA -> FFT
kernel (``kernels/fused_pa.py`` -> ``csrc/fused_pa.cu``), every
instantiation, per round. A kernel counts when its name holds one of
:data:`NAMES`."""

NAMES = ("fused_ifft_pa_fft",)


def is_fused(name: str) -> bool:
    return any(n in name for n in NAMES)


def read(view):
    fused = [e - s for s, e, name, _ in view.kernels if is_fused(name)]
    if not fused or not view.rounds:
        return None
    return sum(fused) / 1e3 / view.rounds
