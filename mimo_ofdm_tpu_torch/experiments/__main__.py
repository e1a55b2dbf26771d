"""CLI dispatcher: ``python -m mimo_ofdm_tpu_torch.experiments <name> [--k v ...]``.

Flags map onto the experiment function's keyword arguments; values are
parsed as Python literals when possible (``--channels '("los","rayleigh")'``,
``--n-ant 32``), else kept as strings (``--device cpu``). Every experiment
runs on the card unless given ``--device cpu``, and writes its CSV under
``figs/csv_results_torch/`` (or ``$MIMO_OFDM_TPU_TORCH_RESULTS``) unless
given ``--save-csv False``.

Under ``torchrun`` (``WORLD_SIZE`` set) the process first joins the job
through ``parallel.multihost.initialize()`` (over gloo with ``--device
cpu``), e.g.::

    torchrun --nproc_per_node=2 -m mimo_ofdm_tpu_torch.experiments weak_scaling --device cpu
"""

from __future__ import annotations

import ast
import os
import sys

from mimo_ofdm_tpu_torch.experiments import EXPERIMENTS


def _parse_value(s: str):
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def run_grid(specs: list, stop_on_error: bool = False) -> int:
    """Run a batch of experiments in turn, surviving individual failures
    (the headless runner of ``reference/vm_scripts/vm_runner.py:15-31``).
    ``specs``: ``(name, kwargs)`` pairs or ``{"name": ..., **kw}`` dicts.
    Returns the number of failures."""
    failures = 0
    for spec in specs:
        if isinstance(spec, dict):
            spec = dict(spec)
            name = spec.pop("name")
            kwargs = spec
        else:
            name, kwargs = spec
        print(f"=== running {name} {kwargs}")
        try:
            EXPERIMENTS[name](**kwargs)
        except Exception as e:  # noqa: BLE001 - the runner must survive failures
            failures += 1
            print(f"!!! {name} failed: {e!r}")
            if stop_on_error:
                raise
    return failures


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m mimo_ofdm_tpu_torch.experiments <name> "
              "[--key value ...] [--device cpu]")
        print("       python -m mimo_ofdm_tpu_torch.experiments grid "
              "<specs.py-literal|@file>")
        print("experiments:")
        for name, fn in sorted(EXPERIMENTS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"  {name:22s} {doc}")
        return 0
    if argv[0] == "grid":
        arg = argv[1]
        if arg.startswith("@"):
            with open(arg[1:]) as f:
                specs = ast.literal_eval(f.read())
        else:
            specs = ast.literal_eval(arg)
        return run_grid(specs)
    name = argv[0]
    if name not in EXPERIMENTS:
        print(f"unknown experiment {name!r}; run with --help for the list")
        return 1
    kwargs = {}
    it = iter(argv[1:])
    for flag in it:
        if not flag.startswith("--"):
            print(f"expected --flag, got {flag!r}")
            return 1
        key = flag[2:].replace("-", "_")
        try:
            val = next(it)
        except StopIteration:
            val = "True"
        kwargs[key] = _parse_value(val)
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from mimo_ofdm_tpu_torch.parallel import multihost
        if not dist.is_initialized():
            multihost.initialize(backend="gloo" if kwargs.get("device") == "cpu" else None)
    EXPERIMENTS[name](**kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
