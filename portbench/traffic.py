"""The one generator of the benchmark's inputs: a pool of distinct rounds of
frame draws, made on the device from ``--seed`` and each round's index.

A traffic mix is a JSON file under ``traffic/`` (see ``spec.py``); the
cell's frame family (``frames/<family>.py``) reads its sizes, and the
configuration's, and draws one round of what its frame uses, every tensor
with the frame axis first. This module seeds each round, pools the rounds
and gathers frames of them.

Every seed gets the same sizes; only the values differ.
"""

from __future__ import annotations

import hashlib
import math

import torch

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
    """One round of the single-user family's draws (``frames/miso.py``)."""
    from portbench.frames import miso

    return miso.draw_round(link, frames, seed, idx, device)


def round_bytes(draws: dict) -> int:
    return sum(t.numel() * t.element_size() for t in draws.values() if t is not None)


def make_pool(link: dict, traffic: dict, seed: int, device, draw) -> list[dict]:
    """Distinct rounds, at least :data:`POOL_MIN_ROUNDS` of them and at
    least :data:`POOL_MIN_BYTES` in all (several times the card's L2, so no
    round finds its inputs in the cache): round ``i`` is ``draw(link,
    frames, seed, i, device)``, a family's ``draw_round``."""
    frames = traffic["frames_per_round"]
    pool = [draw(link, frames, seed, 0, device)]
    need = max(POOL_MIN_ROUNDS, math.ceil(POOL_MIN_BYTES / round_bytes(pool[0])))
    pool += [draw(link, frames, seed, i, device) for i in range(1, need)]
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
