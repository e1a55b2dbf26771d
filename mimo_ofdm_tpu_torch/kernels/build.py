"""Build and load the port's CUDA kernels.

Each kernel's ``csrc/*.cu`` source has a plain C interface. It is compiled
with ``nvcc`` for sm_90a at first use into :data:`BUILD_DIR`, under a name
keyed by the source and :data:`NVCC_FLAGS`, so later processes load the
library without compiling it again (``utils/compile_cache.py`` moves the
directory). :func:`load_library` loads each library once a process, with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from mimo_ofdm_tpu_torch.utils.spans import spanned

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels "
                       "are built from csrc/*.cu at first use")


def library_path(source: Path) -> tuple[str, Path]:
    """The source version's digest and the library built from it."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return digest, BUILD_DIR / f"lib{source.stem}_{digest}.so"


def compile_library(source: Path) -> tuple[Path, str]:
    """Compile the CUDA source ``source`` into :data:`BUILD_DIR`, once per
    source version and flags. Returns the library's path and ptxas's
    register/shared-memory report."""
    digest, so = library_path(source)
    report_path = so.with_suffix(".ptxas.txt")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"lib{source.stem}_{digest}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        report_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return so, report_path.read_text() if report_path.exists() else ""


@functools.lru_cache(maxsize=None)
@spanned("setup.kernel_library")
def load_library(source: Path, declare) -> tuple[ctypes.CDLL, str]:
    """The library built from ``source`` (compiled first if need be), with
    its entry points' argument types set by ``declare(lib)``. Returns the
    library and ptxas's report."""
    so, report = compile_library(source)
    lib = ctypes.CDLL(str(so))
    declare(lib)
    return lib, report
