"""Multi-GPU Monte-Carlo: trial-parallel x antenna-parallel rounds over
``torch.distributed`` (port of ``mimo_ofdm_tpu/parallel/sharded.py``).

The reference scales by forking OS processes that race on lock-protected
shared BER counters (``reference/mp_model.py:89-222``,
``reference/main_mp_clipping_noise_cancellation/main_mp_miso_cnc_ber_vs_ebn0.py:119-132``).
Here one process drives one device, and the ranks of a process group form
a ``(dp, tp)`` mesh:

* ``dp`` (trial axis): each rank runs its slice of the round's frames, and
  the counters sum with one ``all_reduce`` over the ``dp`` group;
* ``tp`` (antenna axis): each rank holds a block of the antennas; the
  precoder norms, the ZF Gram, the AGC sums and every channel combine
  ``sum_ant H o X`` are local sums all-reduced over the ``tp`` group.

Draws: every rank draws the round's GLOBAL :class:`FrameDraws` from
``round_seed(key, idx)`` on its own device, as the unsharded round does,
and keeps its rows (``dp``) and, inside the frame, its antennas (``tp``).
A dp-sharded round is therefore counter-identical to
:func:`mimo_ofdm_tpu_torch.models.link.make_round_fn` for the same ``(key,
idx)``, and a tp shard sees the same channel as a single-device frame. The
price is that each rank draws the whole batch (see ``PERF.md``).

The counters come back replicated on every rank, one int32 vector of the
unsharded round's layout, so :mod:`mimo_ofdm_tpu_torch.parallel.montecarlo`
and ``run_ber_sweep`` run unchanged on every rank.

A mesh of one rank has no groups and runs no collective.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from mimo_ofdm_tpu_torch.models.link import make_frame_fn, round_seed
from mimo_ofdm_tpu_torch.parallel.collectives import all_reduce_sum, group_rank
from mimo_ofdm_tpu_torch.utils.config import LinkConfig
from mimo_ofdm_tpu_torch.utils.device import resolve_device


class Mesh(NamedTuple):
    """A ``(dp, tp)`` mesh of ranks. ``shape`` maps ``"dp"`` and ``"tp"`` to
    their sizes, as JAX's ``Mesh.shape`` does; ``dp_group`` and
    ``tp_group`` are this rank's process groups along each axis (None
    where the axis has one rank), ``group`` the group of every rank of the
    mesh; ``member`` is False on a rank outside the mesh."""
    shape: dict
    dp_group: object = None
    tp_group: object = None
    group: object = None
    member: bool = True

    @property
    def dp_rank(self) -> int:
        return group_rank(self.dp_group)

    @property
    def tp_rank(self) -> int:
        return group_rank(self.tp_group)


def _axis_group(device_mesh, name: str):
    group = device_mesh.get_group(name)
    return None if dist.get_world_size(group) == 1 else group


def make_mesh(n_dp: int | None = None, n_tp: int = 1, device_type: str | None = None,
              ranks=None) -> Mesh:
    """A ``(dp, tp)`` mesh over the ranks of the running process group
    (``torch.distributed.device_mesh``, dims named ``("dp", "tp")``).
    ``ranks`` (default: every rank) lists the ranks to use, the first
    ``n_dp * n_tp`` of them; ``n_dp`` defaults to ``len(ranks) // n_tp``.
    Every rank of the job must call this, in the same order, as for any
    group creation. ``device_type`` defaults to ``cuda`` under NCCL, else
    ``cpu`` (a gloo group also reduces CUDA tensors, through the host).

    Without a running process group the only mesh is the one of this
    process alone, ``(1, 1)``."""
    if not dist.is_initialized():
        if (n_dp or 1) * n_tp != 1:
            raise ValueError(f"a ({n_dp}, {n_tp}) mesh needs a running process group "
                             "(parallel.multihost.initialize)")
        return Mesh({"dp": 1, "tp": 1})
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if n_dp is None:
        n_dp = len(ranks) // n_tp
    size = n_dp * n_tp
    if not 1 <= size <= len(ranks):
        raise ValueError(f"a ({n_dp}, {n_tp}) mesh does not fit on {len(ranks)} ranks")
    ranks = ranks[:size]
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = ("dp", "tp")
    if size == world and ranks == list(range(world)):
        dm = init_device_mesh(device_type, (n_dp, n_tp), mesh_dim_names=names)
        group = dist.group.WORLD
    else:
        dm = DeviceMesh(device_type, torch.tensor(ranks).view(n_dp, n_tp),
                        mesh_dim_names=names)
        group = dist.new_group(ranks)
    shape = {"dp": n_dp, "tp": n_tp}
    if dist.get_rank() not in ranks:
        return Mesh(shape, member=False)
    return Mesh(shape, _axis_group(dm, "dp"), _axis_group(dm, "tp"),
                None if size == 1 else group)


def _check(mesh: Mesh, batch: int, n_ant: int | None) -> None:
    """JAX's divisibility errors (``mimo_ofdm_tpu/parallel/sharded.py:56-59``)."""
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    n_dp, n_tp = mesh.shape["dp"], mesh.shape["tp"]
    if batch % n_dp:
        raise ValueError(f"batch {batch} not divisible by dp={n_dp}")
    if n_ant is not None and n_ant % n_tp:
        raise ValueError(f"n_ant {n_ant} not divisible by tp={n_tp}")


def take_rows(draws, rows: slice):
    """The frames ``rows`` of a draws tuple: every tensor field cut along
    its leading batch dim, nested tuples (the users' channel draws, the
    stochastic channels' draws) recursively, None kept."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws[rows]
    vals = [take_rows(v, rows) for v in draws]
    return type(draws)(*vals) if hasattr(draws, "_fields") else tuple(vals)


def _sharded_round(frame_fn, draw, flatten, batch: int, mesh: Mesh,
                   dev: torch.device):
    """``round_fn(key, idx, snr_db)``: the global draws of ``(key, idx)``,
    this rank's frames, ``flatten`` of its counters, summed over ``dp``.
    ``round_fn.draw(key, idx)`` gives the global draws alone, and
    ``round_fn.run(snr_db, draws)`` runs the round on given global draws."""
    n_local = batch // mesh.shape["dp"]
    rows = slice(mesh.dp_rank * n_local, (mesh.dp_rank + 1) * n_local)

    def draw_round(key: int, idx: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(round_seed(key, idx))
        return draw(batch, gen)

    def run(snr_db, draws) -> torch.Tensor:
        return all_reduce_sum(flatten(frame_fn(snr_db, take_rows(draws, rows))),
                              mesh.dp_group)

    def round_fn(key: int, idx: int, snr_db) -> torch.Tensor:
        return run(snr_db, draw_round(key, idx))

    round_fn.draw = draw_round
    round_fn.run = run
    return round_fn


def _flat(c) -> torch.Tensor:
    """``[clean, dist...]`` summed over the frames, as ``make_round_fn``'s."""
    return torch.cat([c.clean_err.sum(0, dtype=torch.int32)[None],
                      c.dist_err.sum(0, dtype=torch.int32)])


def make_sharded_round_fn(cfg: LinkConfig, n_iters: int, batch: int, mesh: Mesh, *,
                          incl_clean: bool = True, reroll: bool = True, device=None):
    """SPMD round ``round_fn(key, idx, snr_db)`` with the signature and
    the flat int32 counters ``[clean, it0..itN]`` of
    :func:`mimo_ofdm_tpu_torch.models.link.make_round_fn`, summed over the
    global ``batch`` and replicated on every rank. ``batch`` must divide by
    the ``dp`` size and the antenna count by the ``tp`` size. With ``tp ==
    1`` the frame is the unsharded one (a planar-eligible config stays
    planar); with ``tp > 1`` it is the complex64 frame of this rank's
    antennas."""
    dev = resolve_device(device)
    _check(mesh, batch, cfg.array.n_elements)
    frame_fn = make_frame_fn(cfg, n_iters, incl_clean=incl_clean, reroll=reroll,
                             device=dev, ant_group=mesh.tp_group)
    return _sharded_round(frame_fn, frame_fn.draw, _flat, batch, mesh, dev)


def make_dp_round_fn(cfg: LinkConfig, n_iters: int, batch: int, mesh: Mesh, **kw):
    """Pure data-parallel round (``tp = 1``), the common fast path."""
    return make_sharded_round_fn(cfg, n_iters, batch, mesh, **kw)


def make_sharded_mu_round_fn(cfg: LinkConfig, n_iters: int, batch: int, mesh: Mesh,
                             user_positions=None, *, incl_clean: bool = True,
                             reroll: bool = True, sep_carriers: bool = False,
                             device=None):
    """Multi-user SPMD round ``round_fn(key, idx, snr_db) -> [n_usr, n_iters
    + 2]`` int32, the layout of ``link_mu.make_mu_round_fn``: trial-parallel
    frames, antenna-sharded precoding (ZF Gram, MU-MRT norm), AGC,
    propagation and MCNC-MU replica, per-user counters summed over ``dp``
    (``mimo_ofdm_tpu/parallel/sharded.py:97-141``)."""
    from mimo_ofdm_tpu_torch.models import link_mu

    dev = resolve_device(device)
    _check(mesh, batch, cfg.array.n_elements)
    if user_positions is None:
        user_positions = link_mu.default_user_positions()
    make_frame = link_mu.make_mu_sep_frame_fn if sep_carriers else link_mu.make_mu_frame_fn
    frame_fn = make_frame(cfg, n_iters, user_positions, incl_clean=incl_clean,
                          reroll=reroll, device=dev, ant_group=mesh.tp_group)

    def flatten(c) -> torch.Tensor:
        return torch.cat([c.clean_err.sum(0, dtype=torch.int32)[:, None],
                          c.dist_err.sum(0, dtype=torch.int32)], dim=1)

    return _sharded_round(frame_fn, frame_fn.draw, flatten, batch, mesh, dev)


def make_sharded_transport_round_fn(cfg: LinkConfig, n_iters: int, batch: int, chain,
                                    mesh: Mesh, *, ldpc_iters: int = 25,
                                    ldpc_algorithm: str = "minsum",
                                    serial_decode: int = 0, nv_adjust: bool = False,
                                    incl_clean: bool = True, reroll: bool = True,
                                    device=None):
    """Data-parallel transport-coded round over the ``dp`` axis
    (``mimo_ofdm_tpu/parallel/sharded.py:144-195``), the sharded analogue
    of the reference's per-process ``LinkLdpc`` workers on shared coded-BER
    counters (``reference/main_cnc_mcnc_w_ldpc/mp_ldpc_model.py:15``):
    each rank runs ``batch / dp`` full DL-SCH frames through
    ``link_ldpc.make_transport_body_fn``, and the flat counters ``[clean_err,
    dist_err..., clean_blk, dist_blk...]`` sum over ``dp``. The ``tp`` axis
    is not used."""
    from mimo_ofdm_tpu_torch.models.link_ldpc import make_transport_body_fn

    dev = resolve_device(device)
    _check(mesh, batch, None)
    body = make_transport_body_fn(cfg, n_iters, chain, ldpc_iters,
                                  ldpc_algorithm=ldpc_algorithm, incl_clean=incl_clean,
                                  reroll=reroll, serial_decode=serial_decode,
                                  nv_adjust=nv_adjust, device=dev)
    return _sharded_round(body, body.draw, lambda c: c, batch, mesh, dev)
