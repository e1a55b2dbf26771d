"""The 5G-NR LDPC-coded single-user frame
(``models/link_ldpc.py::make_transport_frame_fn`` on the reference's
transport sizing, ``link_ldpc.reference_chain``): the frame every round of
``experiments/ber_sweeps.py::ldpc_ref_ber`` runs. A frame carries one
transport block of ``A = code_rate * n_bits_per_frame`` payload bits plus
its CRC24A, LDPC-encoded and rate-matched to fill the OFDM symbol; the CNC
or MCNC receiver's corrected signal of each pass, and the clean run's, is
demapped softly and decoded.

``frame_args``: ``code_rate``, ``ldpc_iters`` (sum-product iterations, run
in full) and ``ldpc_algorithm``.

A round's draws are those of the port's ``FrameDraws.draw`` with ``A``
payload bits a run, in its shapes and dtypes:

* ``fade``: ``[B, 2, n_ant, n_sc]`` float32 unit normals, for the Rayleigh
  channel;
* ``bits_c``, ``bits_d``: ``[B, A]`` int8 fair payload bits of the clean and
  distorted runs;
* ``noise_c``, ``noise_d``: ``[B, 2, n_sc]`` float32 unit normals;
* ``loc``: ``[B, 2]`` float32 RX offsets uniform in ``+-loc_var/2``, for a
  LOS channel whose RX is rerolled.

The counters are each frame's payload bit errors ``[clean, pass 0 .. pass
n_iters]``. The frame also counts transport blocks whose CRC fails; those
are not compared: a failed block shows as payload errors, except for the
blocks CRC24A lets through, one in ``2^24`` of those decoded wrong.
"""

from __future__ import annotations

import torch

from portbench.traffic import n_bits, round_seed


def payload_bits(link: dict, code_rate: float) -> int:
    """``A``, as ``link_ldpc.reference_chain`` sizes it."""
    return int(round(code_rate * n_bits(link)))


def build(link_cfg: dict, n_iters: int, device, *, code_rate, ldpc_iters, ldpc_algorithm):
    """The port's coded frame, on its normal path: RX rerolled, the clean run
    included, every (frame, pass) decoded at once."""
    from mimo_ofdm_tpu_torch.models import link_ldpc
    from mimo_ofdm_tpu_torch.utils.config import config_from_dict

    cfg = config_from_dict(link_cfg)
    return link_ldpc.make_transport_frame_fn(
        cfg, n_iters, link_ldpc.reference_chain(cfg, code_rate), ldpc_iters=ldpc_iters,
        ldpc_algorithm=ldpc_algorithm, device=device)


def draw_round(link: dict, frames: int, seed: int, idx: int, device, *, code_rate,
               ldpc_iters, ldpc_algorithm) -> dict:
    """One round's draws, on ``device``, from a generator seeded by
    :func:`round_seed` ``(seed, idx)``."""
    g = torch.Generator(device=device)
    g.manual_seed(round_seed(seed, idx))
    n_ant, n_sc = link["array"]["n_elements"], link["modem"]["n_sub_carr"]
    model = link["channel"]["model"]
    a = payload_bits(link, code_rate)

    def normals(*shape):
        return torch.randn((frames, *shape), generator=g, device=device)

    def bits():
        return torch.randint(0, 2, (frames, a), generator=g, device=device, dtype=torch.int8)

    out = {"fade": normals(2, n_ant, n_sc) if model == "rayleigh" else None, "loc": None}
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
    """``[B, n_iters + 2]``: each frame's clean payload errors, then its
    passes'."""
    return torch.cat([c.clean_err[:, None], c.dist_err], dim=1)
