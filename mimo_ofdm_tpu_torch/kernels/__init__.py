"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each wrapper decides its own route with :func:`runs_kernel`: it launches its
kernel for CUDA tensors, uses the plain PyTorch version beside it for CPU
tensors, and counts its launches. Inside :func:`plain_versions` every
wrapper runs its plain version on CUDA tensors too, for comparing the two
inside a whole frame (tests and ``chip_smoke.py`` only).
"""

import contextlib

_plain = False


def runs_kernel(device) -> bool:
    """True when a wrapper launches its kernel on ``device``: a CUDA device
    outside :func:`plain_versions`. False for the CPU; raises
    ``ValueError`` for any other device type."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {device}")
    return device.type == "cuda" and not _plain


@contextlib.contextmanager
def plain_versions():
    """Run the plain version of every hand-written kernel, on CUDA tensors
    too, inside the ``with`` block."""
    global _plain
    outer, _plain = _plain, True
    try:
        yield
    finally:
        _plain = outer
