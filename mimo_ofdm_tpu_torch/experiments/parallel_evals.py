"""Parallel-scaling evaluations (port of
``mimo_ofdm_tpu/experiments/parallel_evals.py``): the measurement arm of
BASELINE.md's ">80% samples/s scaling efficiency" target (the reference's
analogue is wall-clock prints around its process fan-out,
``reference/main_mp_clipping_noise_cancellation/main_mp_miso_cnc_ber_vs_ebn0.py:119-132``).
"""

from __future__ import annotations

import json
import os

import torch
import torch.distributed as dist

from mimo_ofdm_tpu_torch.experiments import register

SCALING_DIR = os.path.join("figs", "scaling_torch")


@register("weak_scaling")
def weak_scaling(n_ant=8, n_iters=2, batch_per_device=32, n_tp=1, device_counts=None,
                 channel="rayleigh", algorithm="cnc", snr_db=22.0, small=True,
                 save_json=True, verbose=True, min_seconds=5.0, device=None):
    """Weak-scaling sweep of the sharded Monte-Carlo round over growing
    dp meshes (``parallel.scaling.weak_scaling_sweep``), on the ranks of
    the running job: start it under ``torchrun --nproc_per_node=N`` (one
    rank per GPU, or ``--device cpu`` for CPU processes over gloo); as one
    process it measures one device. Rank 0 writes
    ``figs/scaling_torch/weak_scaling_*.json``, with the platform (``cuda``
    or ``cpu``), the card's name and each rank's draw ms a round."""
    from mimo_ofdm_tpu_torch.parallel.multihost import process_info
    from mimo_ofdm_tpu_torch.parallel.scaling import weak_scaling_sweep
    from mimo_ofdm_tpu_torch.utils.config import (ArrayConfig, ChannelConfig,
                                                  LinkConfig, ModemConfig, RxConfig)
    from mimo_ofdm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    modem = (ModemConfig(constel_size=64, n_fft=256, n_sub_carr=128, cp_len=16)
             if small else ModemConfig())
    cfg = LinkConfig(modem=modem, array=ArrayConfig(n_elements=n_ant),
                     channel=ChannelConfig(model=channel), precoding="mrt",
                     rx=RxConfig(algorithm=algorithm))
    results = weak_scaling_sweep(cfg, n_iters=n_iters, batch_per_device=batch_per_device,
                                 device_counts=device_counts, n_tp=n_tp, snr_db=snr_db,
                                 verbose=verbose, min_seconds=min_seconds, device=dev)
    info = process_info()
    payload = {
        "platform": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu"),
        "n_devices_available": info["global_device_count"],
        "process_info": info,
        "n_tp": n_tp,
        "batch_per_device": batch_per_device,
        "n_iters": n_iters,
        "config": {"n_ant": n_ant, "channel": channel, "algorithm": algorithm,
                   "n_fft": modem.n_fft},
        "results": {str(k): v for k, v in results.items()},
    }
    if save_json and (not dist.is_initialized() or dist.get_rank() == 0):
        os.makedirs(SCALING_DIR, exist_ok=True)
        fname = os.path.join(SCALING_DIR, f"weak_scaling_{payload['platform']}"
                                          f"_tp{n_tp}_nant{n_ant}_nfft{modem.n_fft}.json")
        with open(fname, "w") as f:
            json.dump(payload, f, indent=1)
        if verbose:
            print(f"saved {fname}")
    return payload
