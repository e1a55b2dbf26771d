"""The plain two-user reference (``reference/mu.py``) against the port's
multi-user frame on the CPU, on the same ``frames/mu.py`` draws, at a small
size (n_fft 256, 128 subcarriers, 4 antennas, two users at +-30 deg and
100 / 316.3 m, float32 planes and chain, the cell's SNR): the same frames
must give the same counters; and the reference refuses what it does not
model, and loads nothing of the program."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import check, run
from portbench.frames import mu as family
from portbench.reference import mu
from test_portbench_imports import _top_level_modules_after

ROOT = Path(__file__).resolve().parents[1]
ARGS = {"angles_deg": [-30.0, 30.0], "distances_m": [100.0, 316.3], "cord_z": 1.5}
SNR_DB = 22.78151250383644
RECEIVERS = ["cnc", "cnc_mu", "mcnc_mu"]
SEEDS = [11, 2 ** 31 + 5]
# LOS: ten seeds of 16 frames (the two below and 100-107) read the gap over
# every counter (check.gap_sq) up to 0.073 (cnc), 0.0075 (cnc_mu) and 0.40
# (mcnc_mu); the reference in fp8 e4m3 at least 0.70, 0.090 and 13.4
LOS_GAP = {"cnc": 0.15, "cnc_mu": 0.02, "mcnc_mu": 0.8}


def small_link(channel, receiver, storage="float32"):
    link = json.loads((ROOT / "configs" / "mu_two_user.json").read_text())["link"]
    link["modem"].update(n_fft=256, n_sub_carr=128)
    link["array"]["n_elements"] = 4
    link["channel"]["model"] = channel
    link["mxu_fft_storage"] = link["channel_storage"] = storage
    link["rx"]["algorithm"] = receiver
    return link


def counters(channel, receiver, seed, planes="float32"):
    """``(port, reference)`` counters ``[frames x users, n_iters + 2]`` of
    one round of 16 frames."""
    link = small_link(channel, receiver)
    d = family.draw_round(link, 16, seed, 0, "cpu", **ARGS)
    port = family.counters(family.build(link, 8, "cpu", **ARGS)(SNR_DB, family.to_draws(d)))
    ref = mu.frame_counters(link, receiver, 8, SNR_DB, d, planes=planes, **ARGS)
    assert port.shape == ref.shape == (16, 2, 10)
    return port.long().numpy().reshape(-1, 10), ref.numpy().reshape(-1, 10)


@pytest.mark.parametrize("receiver", RECEIVERS)
@pytest.mark.parametrize("seed", SEEDS)
def test_rayleigh_counters_equal(receiver, seed):
    """Rayleigh: each user's fade is the draws' own and its attenuation the
    same float32 product, every step the same float32 arithmetic up to the
    order of a few sums, so every counter of every user of every frame is
    equal."""
    port, ref = counters("rayleigh", receiver, seed)
    np.testing.assert_array_equal(port, ref)
    assert ref[:, 1].sum() > 1000            # enough errors to tell a difference


@pytest.mark.parametrize("receiver", RECEIVERS)
@pytest.mark.parametrize("seed", SEEDS)
def test_los_counters_agree_within_the_phase_rounding(receiver, seed):
    """LOS: the port forms each phase (up to 2.3e4 rad at 316 m) and each
    distance in float32, where one ulp moves the phase by about 2e-3 rad,
    the reference in float64. With the near user's signal 10 dB above the
    far user's and four antennas, the far user's interference moves by as
    much and flips a few symbols, which the CNC passes feed back (most in
    MCNC-MU, whose replica carries both users). The tolerance,
    :data:`LOS_GAP`, is about twice the largest gap of ten seeds, and well
    under what the reference computed in fp8 reads (the next test)."""
    port, ref = counters("los", receiver, seed)
    assert check.gap_sq(port, ref) < LOS_GAP[receiver]


@pytest.mark.parametrize("receiver", RECEIVERS)
def test_the_reference_in_fp8_reads_outside_the_los_tolerance(receiver):
    """The same frames with the reference computed in fp8 e4m3 where the
    frame stores planes at its configuration's precision (the chain's
    input, passes and output) in place of the program."""
    _, ref = counters("los", receiver, SEEDS[0])
    _, fp8 = counters("los", receiver, SEEDS[0], planes="float8_e4m3fn")
    assert check.gap_sq(fp8, ref) > LOS_GAP[receiver]


@pytest.mark.parametrize("change,match", [
    (lambda link: link["channel"].update(model="two_path"), "channel 'two_path'"),
    (lambda link: link.update(precoding="zf"), "precoding 'zf'"),
    (lambda link: link["pa"].update(model="rapp"), "PA 'rapp'"),
    (lambda link: link.update(csi_epsilon=0.1), "CSI error"),
    (lambda link: link["array"].update(geometry="circular"), "array 'circular'"),
])
def test_the_reference_refuses_what_it_does_not_model(change, match):
    link = small_link("los", "cnc")
    change(link)
    with pytest.raises(ValueError, match=match):
        mu.check_supported(link, "cnc")


@pytest.mark.parametrize("receiver", ["cnc_mu", "mcnc_mu"])
def test_the_two_user_receivers_take_two_users(receiver):
    link = small_link("los", receiver)
    link["modem"]["n_users"] = 3
    with pytest.raises(ValueError, match=f"receiver '{receiver}' for 3 users"):
        mu.check_supported(link, receiver)
    with pytest.raises(ValueError, match="receiver 'mcnc'"):
        mu.check_supported(small_link("los", "mcnc"), "mcnc")


def test_the_reference_refuses_the_separate_subcarrier_frame_and_other_user_counts():
    """The separate-subcarrier frame draws one bit stream over every user's
    block (``MuFrameDraws.draw(sep_carriers=True)``); and the geometry and
    the draws have to hold the configuration's users."""
    link = small_link("los", "cnc")
    d = family.draw_round(link, 2, 5, 0, "cpu", **ARGS)
    sep = dict(d, bits_d=d["bits_d"].reshape(2, -1))
    with pytest.raises(ValueError, match="the separate-subcarrier frame"):
        mu.frame_counters(link, "cnc", 2, SNR_DB, sep, **ARGS)
    with pytest.raises(ValueError, match="3 user positions for 2 users"):
        mu.frame_counters(link, "cnc", 2, SNR_DB, d, angles_deg=[-30, 0, 30],
                          distances_m=[100, 200, 316.3], cord_z=1.5)
    with pytest.raises(ValueError, match="draws of 1 users for 2"):
        mu.check_supported(link, "cnc", dict(d, bits_d=d["bits_d"][:, :1]))


def test_the_users_stand_where_the_simulator_puts_them():
    """``angle + 90`` deg from the x axis: -30 deg at 100 m is right of
    broadside (+y), +30 deg at 316.3 m left of it."""
    pos = mu.user_positions(**ARGS)
    np.testing.assert_allclose(pos[0], [50.0, 100.0 * np.sqrt(3) / 2, 1.5], rtol=1e-12)
    np.testing.assert_allclose(pos[1], [-158.15, 316.3 * np.sqrt(3) / 2, 1.5], rtol=1e-12)


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules_after("""
        import json, sys, torch
        from portbench.frames import mu as family
        from portbench.reference import mu
        link = json.load(open("portbench/configs/mu_two_user.json"))["link"]
        link["modem"].update(n_fft=256, n_sub_carr=128)
        link["array"]["n_elements"] = 4
        args = json.load(open("portbench/configs/mu_two_user.json"))["frame_args"]
        d = family.draw_round(link, 2, 5, 0, "cpu", **args)
        assert mu.frame_counters(link, "mcnc_mu", 2, 15.0, d, **args).shape == (2, 2, 4)
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert "torch" in mods
    assert not mods & {*run.FORBIDDEN, "mimo_ofdm_tpu_torch"}
