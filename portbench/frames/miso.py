"""The single-user frame (``models/link.py::make_frame_fn``): one user, the
CNC or MCNC receiver, the planar path for the benchmark's configurations.

A round's draws are those of the port's ``FrameDraws.draw``, in its shapes
and dtypes:

* ``fade``: ``[B, 2, n_ant, n_sc]`` unit normals in the channel planes'
  dtype, for the Rayleigh channel;
* ``bits_c``, ``bits_d``: ``[B, n_bits]`` int8 fair bits of the clean and
  distorted runs;
* ``noise_c``, ``noise_d``: ``[B, 2, n_sc]`` float32 unit normals;
* ``loc``: ``[B, 2]`` float32 RX offsets uniform in ``+-loc_var/2``, for a
  LOS channel whose RX is rerolled.

Every seed gets the same sizes; only the values differ. The family takes
no ``frame_args``.
"""

from __future__ import annotations

import torch

from portbench.traffic import n_bits, round_seed

PLANE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(link_cfg: dict, n_iters: int, device):
    """The port's frame function, ``make_frame_fn`` looked up on its module
    at the call."""
    from mimo_ofdm_tpu_torch.models import link
    from mimo_ofdm_tpu_torch.utils.config import config_from_dict

    return link.make_frame_fn(config_from_dict(link_cfg), n_iters, device=device)


def draw_round(link: dict, frames: int, seed: int, idx: int, device) -> dict:
    """One round's draws, on ``device``, from a generator seeded by
    :func:`round_seed` ``(seed, idx)``."""
    g = torch.Generator(device=device)
    g.manual_seed(round_seed(seed, idx))
    n_ant, n_sc = link["array"]["n_elements"], link["modem"]["n_sub_carr"]
    model = link["channel"]["model"]

    def normals(*shape, dtype=torch.float32):
        return torch.randn((frames, *shape), generator=g, device=device, dtype=dtype)

    def bits():
        return torch.randint(0, 2, (frames, n_bits(link)), generator=g, device=device,
                             dtype=torch.int8)

    out = {"fade": None, "loc": None}
    if model == "rayleigh":
        out["fade"] = normals(2, n_ant, n_sc, dtype=PLANE_DTYPES[link["channel_storage"]])
    out["bits_c"], out["bits_d"] = bits(), bits()
    out["noise_c"], out["noise_d"] = normals(2, n_sc), normals(2, n_sc)
    if model == "los":
        var = link["rx"]["loc_var"]
        out["loc"] = torch.rand((frames, 2), generator=g, device=device) * var - var / 2.0
    return out


def to_draws(d: dict):
    from mimo_ofdm_tpu_torch.models.link import FrameDraws

    return FrameDraws(d["fade"], d["bits_c"], d["bits_d"], d["noise_c"], d["noise_d"],
                      d["loc"])


def counters(c) -> torch.Tensor:
    """``[B, n_iters + 2]``: each frame's clean count, then its passes'."""
    return torch.cat([c.clean_err[:, None], c.dist_err], dim=1)
