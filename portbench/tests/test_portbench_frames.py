"""Frame families (``frames/``): the single-user family draws the very pools
it drew before it was a family, and the two-user family's draws, counters
and a whole run go through the harness from files alone."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import portbench_tiny
from portbench import run, spec, traffic

ROOT = Path(__file__).resolve().parents[1]

# SHA-256 of traffic.draw_round(link, 3, seed, 1, "cpu") (see round_digest)
# for each configuration with both plane dtypes, recorded at commit 52da98f,
# the last before the frame families
PARENT_DIGESTS = {
    ("miso_rayleigh", "bfloat16", 7):
        "98bac065413612f058be3a23b113bc0efdc64e29aed16334d0a9e37db411bc33",
    ("miso_rayleigh", "bfloat16", 2147495993):
        "e8985ba04f82eeded6847f07cb63d8925c669855ba6def98270fa141d1a6b622",
    ("miso_rayleigh", "float32", 7):
        "911772329932021cfd3d5abf0f96214771a59347d2d3cad39c11b3569eeee7dc",
    ("miso_rayleigh", "float32", 2147495993):
        "eff4b33ab55406abcce61686fea11ad1dd182de35beb3b8a8d1b475aaf651e9f",
    ("miso_los", "bfloat16", 7):
        "d551a22aaf1ba81c19f5e591f87be249a4a8cc15344c7e27807cf2fb7103bc15",
    ("miso_los", "bfloat16", 2147495993):
        "27bd71c997975a95f7a45e2755f1fbe0ce283759d86636477a583b26d346ca35",
    ("miso_los", "float32", 7):
        "d551a22aaf1ba81c19f5e591f87be249a4a8cc15344c7e27807cf2fb7103bc15",
    ("miso_los", "float32", 2147495993):
        "27bd71c997975a95f7a45e2755f1fbe0ce283759d86636477a583b26d346ca35",
}


def round_digest(draws: dict) -> str:
    """SHA-256 over each key, in sorted order, with its dtype, shape and bytes."""
    h = hashlib.sha256()
    for key in sorted(draws):
        t = draws[key]
        h.update(f"{key}:{None if t is None else (str(t.dtype), tuple(t.shape))};".encode())
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _link(config, storage):
    link = json.loads((ROOT / "configs" / f"{config}.json").read_text())["link"]
    link["mxu_fft_storage"] = link["channel_storage"] = storage
    return link


@pytest.mark.parametrize("config,storage,seed", sorted(PARENT_DIGESTS))
def test_the_single_user_pools_are_the_parents_bytes(config, storage, seed):
    """Through ``traffic.draw_round`` and through the family a cell of the
    configuration loads: the same bytes as before the families."""
    link = _link(config, storage)
    want = PARENT_DIGESTS[config, storage, seed]
    assert round_digest(traffic.draw_round(link, 3, seed, 1, "cpu")) == want
    cell = next(w["name"] for w in json.loads((ROOT.parent / "BENCHMARK.json").read_text())
                ["workloads"] if w["config"] == config)
    fam = spec.load_cell(cell)
    assert round_digest(fam.frame.draw_round(link, 3, seed, 1, "cpu", **fam.frame_args)) == want


def _mu_cell(tmp_path, **kw):
    bench, root = portbench_tiny.make_mu(tmp_path, **kw)
    return spec.load_cell(portbench_tiny.CELL, bench, root)


@pytest.mark.parametrize("channel", ["los", "rayleigh"])
def test_the_two_user_draws_have_the_ports_keys_shapes_and_dtypes(channel, tmp_path):
    from mimo_ofdm_tpu_torch.models.link_mu import MuFrameDraws
    from mimo_ofdm_tpu_torch.utils.config import config_from_dict

    cell = _mu_cell(tmp_path, channel=channel)
    assert cell.frame.__file__ == str(tmp_path / "frames" / "mu.py")
    d = cell.frame.draw_round(cell.link, 3, 2 ** 31 + 7, 0, "cpu", **cell.frame_args)
    g = torch.Generator().manual_seed(0)
    port = MuFrameDraws.draw(config_from_dict(cell.link), 2, 3, g)
    for key in ("bits_c", "bits_d", "noise_c", "noise_d"):
        assert (d[key].shape, d[key].dtype) == (getattr(port, key).shape,
                                                 getattr(port, key).dtype), key
    for key in ("fade", "loc"):
        theirs = [getattr(u, key) for u in port.users]
        if theirs[0] is None:
            assert d[key] is None, key
        else:
            want = torch.stack(theirs, 1)
            assert (d[key].shape, d[key].dtype) == (want.shape, want.dtype), key
    # the port's own draw tuple of them, and distinct rounds
    assert cell.frame.to_draws(d).batch == 3
    d1 = cell.frame.draw_round(cell.link, 3, 2 ** 31 + 7, 1, "cpu", **cell.frame_args)
    assert not torch.equal(d["noise_d"], d1["noise_d"])


@pytest.mark.parametrize("receiver", ["cnc", "cnc_mu", "mcnc_mu"])
def test_the_two_user_counters_through_the_harness_are_the_ports(receiver, tmp_path):
    """n_fft 256, 4 antennas, 2 users, float32: ``Harness.launch`` against
    ``make_mu_frame_fn`` called on the same draws, user by user."""
    from mimo_ofdm_tpu_torch.models import link_mu
    from mimo_ofdm_tpu_torch.utils.config import config_from_dict

    cell = _mu_cell(tmp_path, receiver=receiver)
    h = run.Harness(cell, 20260102, "cpu")
    got, _, slot = h.launch(0)
    assert got.shape == (4, 2, cell.n_iters + 2)

    a = portbench_tiny.MU_FRAME_ARGS
    fn = link_mu.make_mu_frame_fn(
        config_from_dict(cell.link), cell.n_iters,
        link_mu.default_user_positions(tuple(a["angles_deg"]), tuple(a["distances_m"]),
                                       a["cord_z"]), device="cpu")
    d = h.pool[slot]
    users = tuple(link_mu.ChannelDraws(None, d["loc"][:, u]) for u in range(2))
    c = fn(h.snr_db, link_mu.MuFrameDraws(users, d["bits_c"], d["bits_d"], d["noise_c"],
                                          d["noise_d"]))
    assert torch.equal(got[..., 0], c.clean_err) and torch.equal(got[..., 1:], c.dist_err)
    assert c.dist_err.sum() > 0                  # errors there to be counted

    # the check's rows: one a user of each frame
    picks, rows = h.sample([(slot, got.numpy())])
    assert rows.shape == (2 * len(picks), cell.n_iters + 2)
    np.testing.assert_array_equal(rows, got.numpy()[[f for _, f in picks]].reshape(-1, 10))


def test_a_two_user_cell_runs_from_files_alone(tmp_path, monkeypatch):
    """A configuration with ``"frame": "mu"``, a traffic file, a limits file
    and a reference, in a folder of their own: ``run.run`` takes them and,
    with the port's own frame as the reference, reads ``correct``."""
    portbench_tiny.shrink(monkeypatch.setattr)
    bench, root = portbench_tiny.make_mu(tmp_path, receiver="mcnc_mu")
    res = run.run(portbench_tiny.CELL, 2 ** 32 + 11, 2.0, False, device="cpu",
                  benchmark=bench, root=root)
    assert res["attempted"] > 0
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"gap_sq_first", "gap_sq_passes", "ber_gap"}


def test_the_two_user_geometry_has_to_match_the_configuration(tmp_path):
    cell = _mu_cell(tmp_path)
    args = dict(cell.frame_args, angles_deg=[0.0])
    with pytest.raises(ValueError, match="1 angles and 2 distances"):
        cell.frame.draw_round(cell.link, 1, 0, 0, "cpu", **args)
