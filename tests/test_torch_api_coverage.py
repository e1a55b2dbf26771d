"""Every public name of the JAX package has its counterpart in the port.

Both packages are read with ``ast``; neither is imported. For each module
of ``mimo_ofdm_tpu`` and each public top-level name in it (functions,
classes, assignments; not imports), the port's module of the same path,
or the module ``NAME_MAP`` maps it to, must define the name, and each
public parameter of a JAX function must be a parameter of the port's
function of that name; otherwise ``NAME_MAP`` lists the name or the
parameter with its counterpart or the reason it has none. ``NAME_MAP``
holds no entry for something the port does define (no stale entries),
and the README's port section shows every entry.

Keys of ``NAME_MAP``:

* ``"path.py"``: the whole JAX module; the value is the port module (a
  path under ``mimo_ofdm_tpu_torch/``) that holds its counterparts;
* ``"path.py::name"``: a public name the port does not define there;
* ``"path.py::function(param)"``: a parameter the port's function lacks;
* ``"*(param)"``: a parameter the port lacks in every function that has it
  in JAX.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "mimo_ofdm_tpu"
PORT_PKG = ROOT / "mimo_ofdm_tpu_torch"

NAME_MAP = {
    # the TPU's matmul FFT; the port's chain is the CUDA kernel
    "ops/mxu_fft.py": "ops/fused_chain.py",
    "ops/mxu_fft.py::square_radix":
        "`fused_chain.kernel_eligible`: the kernel takes every power of two in [256, 4096]",
    "ops/mxu_fft.py::prune_factors":
        "`fused_chain.kernel_eligible(n_fft, n_sc, \"sc\")`: the kernel skips the guard "
        "band in its first and last pass, with no factors to choose",
    "ops/mxu_fft.py::sc_prune_eligible": "`fused_chain.kernel_eligible(n_fft, n_sc, \"sc\")`",
    "ops/mxu_fft.py::ifft_mxu": "`ofdm.fd_to_td` (`torch.fft`)",
    "ops/mxu_fft.py::fft_mxu": "`ofdm.td_to_fd` (`torch.fft`)",
    "ops/mxu_fft.py::ifft_digit_swapped":
        "the kernel's IFFT passes in registers (`kernels/fused_pa.py::schedule`); the "
        "digit-swapped order never leaves the kernel",
    "ops/mxu_fft.py::fft_from_digit_swapped":
        "the kernel's FFT passes in registers (`kernels/fused_pa.py::schedule`)",
    "ops/mxu_fft.py::fused_ifft_pa_fft":
        "`kernels/fused_pa.py::fused_ifft_pa_fft_complex(mode=\"full\")` on complex64, "
        "`fused_ifft_pa_fft(mode=\"full\")` on planes",
    "*(pa_fn_planar)":
        "`pa_model`, `sat`, `cubic_coeff`, `rapp_p`: the PA runs inside the kernel, so it "
        "is named, not passed as a closure",
    # the Pallas kernel
    "kernels/fused_pa.py::R":
        "the TPU kernel's radix-64 matmul factor (`_cmatmul`, N = R x R); the CUDA "
        "kernel runs radix-16 passes (`kernels/fused_pa.py::schedule`)",
    "kernels/fused_pa.py::fused_ifft_clip_fft(tile)":
        "the TPU's VMEM block of rows; the CUDA kernel sizes its own blocks",
    # randoms, dtypes, sharding
    "*(key)":
        "randoms are passed in drawn: unit normals, draw tuples (`FrameDraws`, "
        "`ScanDraws`, `RandomPathsDraws`, `TdlDraws`, `GscmDraws`) or a `torch.Generator`",
    "ops/noise.py::complex_normal(shape)": "the shape of the drawn `normals [..., 2, n]`",
    "models/channels.py::random_paths_channel(n_paths)":
        "`RandomPathsDraws.draw(batch, generator, n_paths, max_delay_spread)`",
    "models/channels.py::random_paths_channel(max_delay_spread)":
        "`RandomPathsDraws.draw(batch, generator, n_paths, max_delay_spread)`",
    "*(dtype)": "complex64 in every JAX caller, and so in the port",
    "*(ant_axis_name)": "`ant_group`, a `torch.distributed` process group",
    "*(idx_arg)": "`link.round_seed(key, idx)` seeds each round's generator",
    "parallel/sharded.py::make_mesh(devices)":
        "the ranks of the process group (`init_device_mesh`); one device a rank",
    "models/receivers.py::make_mcnc_mu_replica(other_usr_symbols)":
        "`usr_symbols [..., n_usr, n_sc]`: the replica of every user at once, users "
        "first; user u's slice is JAX's replica with `usr_idx=u`",
    "models/receivers.py::make_mcnc_mu_replica(usr_idx)":
        "the user axis leads the all-users replica's input and output",
    "models/link_ldpc.py::make_transport_frame_fn(return_llrs)":
        "`serial_decode` on the round: the frame always decodes, in slices when asked",
    # TPU and XLA plumbing
    "models/transmit.py::make_pa_fn(sample_ndim)":
        "PA parameters are per row and broadcast over the one sample axis; no "
        "digit-swapped sample blocks reach the PA outside the kernel",
    "ops/ldpc.py::decode(fusion_barrier)": "an XLA fusion hint",
    "utils/compile_cache.py::DEFAULT_CACHE_DIR":
        "`kernels/build.py::BUILD_DIR`: the port compiles its kernels' libraries "
        "into the package's `_build/`",
    "utils/compile_cache.py::enable_persistent_cache(min_compile_time_secs)":
        "XLA's cache threshold; the port caches its `nvcc` builds",
    "utils/compile_cache.py::enable_persistent_cache(min_entry_size_bytes)":
        "XLA's cache threshold; the port caches its `nvcc` builds",
}


def _functions_and_names(path: Path) -> dict[str, list[str] | None]:
    """Top-level public names of a module: each function with its parameter
    names (``["**"]`` added when it takes ``**kwargs``), classes and
    assigned names with None. Imports do not count."""
    out: dict[str, list[str] | None] = {}

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
                if a.vararg:
                    params.append(a.vararg.arg)
                if a.kwarg:
                    params.append("**")
                out[node.name] = params
            elif isinstance(node, ast.ClassDef):
                out[node.name] = None
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            out[n.id] = None
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
    visit(ast.parse(path.read_text()).body)
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _jax_modules() -> list[str]:
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _port_module(mod: str) -> Path:
    return PORT_PKG / NAME_MAP.get(mod, mod)


def _gaps(mod: str) -> list[str]:
    """The JAX module's names and parameters that neither the port nor
    NAME_MAP accounts for, as NAME_MAP keys."""
    jax_names = _functions_and_names(JAX_PKG / mod)
    port_path = _port_module(mod)
    port_names = _functions_and_names(port_path) if port_path.exists() else {}
    gaps = []
    for name, params in jax_names.items():
        key = f"{mod}::{name}"
        if name not in port_names:
            if key not in NAME_MAP:
                gaps.append(key)
            continue
        port_params = port_names[name]
        if params is None or port_params is None or "**" in port_params:
            continue
        for p in params:
            if p.startswith("_") or p in port_params:
                continue
            if f"{key}({p})" not in NAME_MAP and f"*({p})" not in NAME_MAP:
                gaps.append(f"{key}({p})")
    return gaps


@pytest.mark.parametrize("mod", _jax_modules())
def test_every_jax_name_has_a_counterpart(mod):
    assert _port_module(mod).exists(), f"the port has no counterpart of {mod}"
    assert _gaps(mod) == [], (
        f"JAX names or parameters with no counterpart in the port's "
        f"{_port_module(mod).relative_to(PORT_PKG)} and no NAME_MAP entry: {_gaps(mod)}")


_KEY = re.compile(r"^(?:(?P<mod>[\w/]+\.py)(?:::(?P<name>\w+)(?:\((?P<param>\w+)\))?)?"
                  r"|\*\((?P<any>\w+)\))$")


def _stale(key: str) -> str | None:
    """Why ``key`` no longer belongs in NAME_MAP, or None."""
    m = _KEY.match(key)
    if m is None:
        return "malformed key"
    if m["any"]:
        # a wildcard stays while some JAX function's parameter needs it
        for mod in _jax_modules():
            jax_names = _functions_and_names(JAX_PKG / mod)
            port_names = (_functions_and_names(_port_module(mod))
                          if _port_module(mod).exists() else {})
            for name, params in jax_names.items():
                port_params = port_names.get(name)
                if (params and m["any"] in params and port_params is not None
                        and m["any"] not in port_params and "**" not in port_params):
                    return None
        return "no JAX parameter needs it"
    mod, name, param = m["mod"], m["name"], m["param"]
    if not (JAX_PKG / mod).exists():
        return "no such JAX module"
    if name is None:
        return None if mod != NAME_MAP[key] else "maps a module to itself"
    jax_names = _functions_and_names(JAX_PKG / mod)
    if name not in jax_names:
        return "no such JAX name"
    port_path = _port_module(mod)
    port_names = _functions_and_names(port_path) if port_path.exists() else {}
    if param is None:
        return "the port defines it" if name in port_names else None
    if param not in (jax_names[name] or []):
        return "no such JAX parameter"
    if name not in port_names:
        return "the port lacks the function, so its parameters need no entry"
    port_params = port_names[name] or []
    return "the port has the parameter" if param in port_params or "**" in port_params else None


def test_name_map_has_no_stale_entries():
    stale = {k: why for k in NAME_MAP if (why := _stale(k))}
    assert stale == {}


def test_readme_renders_the_name_map():
    """The README's port section shows each NAME_MAP key (backquoted)."""
    readme = (ROOT / "README.md").read_text()
    section = readme[readme.index("## PyTorch/CUDA port"):]
    missing = [k for k in NAME_MAP if f"`{k}`" not in section]
    assert missing == []
