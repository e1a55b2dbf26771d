"""A small cell of its own for the CPU tests: the benchmark's files with the
``miso_rayleigh`` configuration cut to n_fft 256, 128 subcarriers and 4
antennas, a few frames a round, and the harness's sizes cut to match
(:func:`shrink`); or, by :func:`make_mu`, a two-user cell of the ``mu``
frame family at that size."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "tiny.t"


def shrink(set_attr=setattr, check_frames=16):
    """One warm-up round, a pool of the fewest rounds, ``check_frames``
    frames compared (``set_attr``: ``monkeypatch.setattr`` in a test)."""
    from portbench import run, traffic
    set_attr(run, "WARMUP_ROUNDS", 1)
    set_attr(run, "CHECK_FRAMES", check_frames)
    set_attr(traffic, "POOL_MIN_BYTES", 0)


def make(tmp, *, storage="float32", receiver="cnc", channel="rayleigh", frames=4,
         n_ant=4, n_fft=256, limits_of="miso_rayleigh.mcnc.b512", snr_db=15.0):
    """Write the cell ``tiny.t`` under ``tmp``, with the limits and the
    metrics of the cell ``limits_of``; returns ``(BENCHMARK.json, root)``."""
    tmp = Path(tmp)
    for d in ("metrics", "reference", "frames"):
        if not (tmp / d).exists():
            shutil.copytree(ROOT / d, tmp / d)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir(exist_ok=True, parents=True)
    cfg = json.loads((ROOT / "configs" / "miso_rayleigh.json").read_text())
    link = cfg["link"]
    link["modem"].update(n_fft=n_fft, n_sub_carr=n_fft // 2)
    link["array"]["n_elements"] = n_ant
    link["channel"]["model"] = channel
    link["mxu_fft_storage"] = link["channel_storage"] = storage
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / "t.json").write_text(json.dumps({
        "receiver": receiver, "frames_per_round": frames, "rounds_in_flight": 3,
        "snr_db": snr_db}))
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "x", "file": "configs/tiny.json",
                         "reduced": [], "why": "x"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "t", "chips": 1,
                           "why": "x"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if limits_of in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(ROOT / "limits" / f"{limits_of}.json", tmp / "limits" / f"{CELL}.json")
    return tmp / "BENCHMARK.json", tmp


MU_FRAME_ARGS = {"angles_deg": [-30.0, 30.0], "distances_m": [100.0, 316.3], "cord_z": 1.5}

# a reference for the plumbing alone: the port's own multi-user frame on the
# harness's draws, each user's counters [clean, pass 0 ..]
MU_PORT_REFERENCE = """
import torch
from mimo_ofdm_tpu_torch.models import link_mu
from mimo_ofdm_tpu_torch.utils.config import config_from_dict


def frame_counters(link, receiver, n_iters, snr_db, draws, planes="float32", *,
                   angles_deg, distances_m, cord_z):
    link = dict(link, rx=dict(link["rx"], algorithm=receiver))
    pos = link_mu.default_user_positions(tuple(angles_deg), tuple(distances_m), cord_z)
    fn = link_mu.make_mu_frame_fn(config_from_dict(link), n_iters, pos, device="cpu")
    users = tuple(link_mu.ChannelDraws(None if draws["fade"] is None else draws["fade"][:, u],
                                       None if draws["loc"] is None else draws["loc"][:, u])
                  for u in range(draws["bits_d"].shape[1]))
    c = fn(snr_db, link_mu.MuFrameDraws(users, draws["bits_c"], draws["bits_d"],
                                        draws["noise_c"], draws["noise_d"]))
    return torch.cat([c.clean_err[..., None], c.dist_err], -1)
"""


def make_mu(tmp, *, receiver="cnc_mu", channel="los", frames=4, n_ant=4, n_fft=256,
            snr_db=20.0, limits=None):
    """Write the two-user cell ``tiny.t`` under ``tmp``: :func:`make`'s
    configuration with two users at float32 (``"frame": "mu"``), a traffic
    file, a limits file (``limits``, by default each of the check's numbers
    held to 0) and :data:`MU_PORT_REFERENCE`; returns ``(BENCHMARK.json,
    root)``."""
    bench, tmp = make(tmp, storage="float32", receiver=receiver, channel=channel,
                      frames=frames, n_ant=n_ant, n_fft=n_fft, snr_db=snr_db)
    cfg = json.loads((tmp / "configs" / "tiny.json").read_text())
    cfg["link"]["modem"]["n_users"] = 2
    cfg.update(reference="mu_port", frame="mu", frame_args=MU_FRAME_ARGS)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "reference" / "mu_port.py").write_text(MU_PORT_REFERENCE)
    tr = json.loads((tmp / "traffic" / "t.json").read_text())
    tr["rounds_in_flight"] = 1              # a CPU round takes a few tenths of a second
    (tmp / "traffic" / "t.json").write_text(json.dumps(tr))
    limits = limits or {k: {"limit": 0.0} for k in ("gap_sq_first", "gap_sq_passes", "ber_gap")}
    (tmp / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    return bench, tmp
