"""The shared-subcarrier multi-user frame (``models/link_mu.py::
make_mu_frame_fn``): one OFDM symbol to every user at once, joint
precoding, each user's own channel, noise and receiver (``cnc``,
``cnc_mu`` or ``mcnc_mu``). A frame is that one symbol to all the users, as
the multi-user sweep counts it.

``frame_args``: the users' geometry, ``angles_deg``, ``distances_m`` and
``cord_z`` (``link_mu.default_user_positions``), one user a position and as
many as the configuration's ``modem.n_users``.

A round's draws are those of the port's ``MuFrameDraws.draw``, in its
shapes and dtypes, with the users stacked after the frame axis:

* ``fade``: ``[B, U, 2, n_ant, n_sc]`` float32 unit normals, for the
  Rayleigh channel;
* ``loc``: ``[B, U, 2]`` float32 RX offsets uniform in ``+-loc_var/2``
  around each user's position, for a LOS channel whose RX is rerolled;
* ``bits_c``, ``bits_d``: ``[B, U, n_bits]`` int8 fair bits;
* ``noise_c``, ``noise_d``: ``[B, U, 2, n_sc]`` float32 unit normals.

They are drawn in ``MuFrameDraws.draw``'s order (each user's fade and
offsets, then the bits, then the noise) from one generator seeded by
``traffic.round_seed(seed, idx)``.
"""

from __future__ import annotations

import torch

from portbench.traffic import n_bits, round_seed


def n_users(link: dict, angles_deg, distances_m) -> int:
    """The users of the geometry, which has to match the configuration's."""
    n = link["modem"]["n_users"]
    if not len(angles_deg) == len(distances_m) == n:
        raise ValueError(f"{len(angles_deg)} angles and {len(distances_m)} distances "
                         f"for a configuration of {n} users")
    return n


def build(link_cfg: dict, n_iters: int, device, *, angles_deg, distances_m, cord_z):
    """The port's multi-user frame, on its normal path: RX rerolled, the
    clean run included."""
    from mimo_ofdm_tpu_torch.models import link_mu
    from mimo_ofdm_tpu_torch.utils.config import config_from_dict

    n_users(link_cfg, angles_deg, distances_m)
    positions = link_mu.default_user_positions(tuple(angles_deg), tuple(distances_m), cord_z)
    return link_mu.make_mu_frame_fn(config_from_dict(link_cfg), n_iters, positions,
                                    device=device)


def draw_round(link: dict, frames: int, seed: int, idx: int, device, *, angles_deg,
               distances_m, cord_z) -> dict:
    """One round's draws, on ``device``, from a generator seeded by
    :func:`round_seed` ``(seed, idx)``."""
    users = n_users(link, angles_deg, distances_m)
    g = torch.Generator(device=device)
    g.manual_seed(round_seed(seed, idx))
    n_ant, n_sc = link["array"]["n_elements"], link["modem"]["n_sub_carr"]
    model = link["channel"]["model"]
    var = link["rx"]["loc_var"]

    def normals(*shape):
        return torch.randn((frames, *shape), generator=g, device=device)

    def bits():
        return torch.randint(0, 2, (frames, users, n_bits(link)), generator=g, device=device,
                             dtype=torch.int8)

    fade, loc = [], []
    for _ in range(users):
        if model == "rayleigh":
            fade.append(normals(2, n_ant, n_sc))
        if model == "los":
            loc.append(torch.rand((frames, 2), generator=g, device=device) * var - var / 2.0)
    out = {"fade": torch.stack(fade, 1) if fade else None,
           "loc": torch.stack(loc, 1) if loc else None}
    out["bits_c"], out["bits_d"] = bits(), bits()
    out["noise_c"], out["noise_d"] = normals(users, 2, n_sc), normals(users, 2, n_sc)
    return out


def to_draws(d: dict):
    from mimo_ofdm_tpu_torch.models.link_mu import ChannelDraws, MuFrameDraws

    users = d["bits_d"].shape[1]
    per_user = [ChannelDraws(None if d["fade"] is None else d["fade"][:, u],
                             None if d["loc"] is None else d["loc"][:, u])
                for u in range(users)]
    return MuFrameDraws(tuple(per_user), d["bits_c"], d["bits_d"], d["noise_c"],
                        d["noise_d"])


def counters(c) -> torch.Tensor:
    """``[B, U, n_iters + 2]``: each user's clean count, then its passes'."""
    return torch.cat([c.clean_err[..., None], c.dist_err], dim=-1)
