"""The one generator of the benchmark's inputs: a pool of distinct rounds of
frame draws, made on the device from ``--seed`` and each round's index.

A traffic mix is a JSON file under ``traffic/`` (see ``spec.py``); this
module reads its sizes, and the configuration's, and draws what the
frame uses, in the shapes and dtypes the port's ``FrameDraws.draw`` gives:

* ``fade``: ``[B, 2, n_ant, n_sc]`` unit normals in the channel planes'
  dtype, for the Rayleigh channel;
* ``bits_c``, ``bits_d``: ``[B, n_bits]`` int8 fair bits of the clean and
  distorted runs;
* ``noise_c``, ``noise_d``: ``[B, 2, n_sc]`` float32 unit normals;
* ``loc``: ``[B, 2]`` float32 RX offsets uniform in ``+-loc_var/2``, for a
  LOS channel whose RX is rerolled.

Every seed gets the same sizes; only the values differ.
"""

from __future__ import annotations

import hashlib
import math

import torch

PLANE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
POOL_MIN_ROUNDS = 4
POOL_MIN_BYTES = 200_000_000       # four times the H100's 50 MB L2


def round_seed(seed: int, idx: int) -> int:
    """A 63-bit generator seed for round ``idx`` of run seed ``seed``."""
    digest = hashlib.blake2b(f"{int(seed)}/{int(idx)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def n_bits(link: dict) -> int:
    m = link["modem"]
    return int(round(math.log2(m["constel_size"]))) * m["n_sub_carr"]


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


def round_bytes(draws: dict) -> int:
    return sum(t.numel() * t.element_size() for t in draws.values() if t is not None)


def make_pool(link: dict, traffic: dict, seed: int, device) -> list[dict]:
    """Distinct rounds, at least :data:`POOL_MIN_ROUNDS` of them and at
    least :data:`POOL_MIN_BYTES` in all (several times the card's L2, so no
    round finds its inputs in the cache): round ``i`` is :func:`draw_round`
    ``(seed, i)``."""
    frames = traffic["frames_per_round"]
    pool = [draw_round(link, frames, seed, 0, device)]
    need = max(POOL_MIN_ROUNDS, math.ceil(POOL_MIN_BYTES / round_bytes(pool[0])))
    pool += [draw_round(link, frames, seed, i, device) for i in range(1, need)]
    return pool


def gather(pool: list[dict], picks: list[tuple[int, int]]) -> dict:
    """The draws of the frames ``(slot, frame)`` of ``picks``, stacked in
    that order."""
    out = {}
    for key in pool[0]:
        if pool[0][key] is None:
            out[key] = None
        else:
            out[key] = torch.stack([pool[s][key][f] for s, f in picks])
    return out
