"""The plain reference against the port's CPU path on the same draws, at a
small size (n_fft 256, 128 subcarriers, 4 antennas, float32 planes and
chain): the same frames must give the same counters."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mimo_ofdm_tpu_torch.models.link import FrameDraws, make_frame_fn
from mimo_ofdm_tpu_torch.utils.config import config_from_dict

from portbench import check, traffic
from portbench.reference import miso

ROOT = Path(__file__).resolve().parents[1]


def small_link(channel, receiver, storage="float32"):
    link = json.loads((ROOT / "configs" / "miso_rayleigh.json").read_text())["link"]
    link["modem"].update(n_fft=256, n_sub_carr=128)
    link["array"]["n_elements"] = 4
    link["channel"]["model"] = channel
    link["mxu_fft_storage"] = link["channel_storage"] = storage
    link["rx"]["algorithm"] = receiver
    return link


def port_counters(link, draws):
    fn = make_frame_fn(config_from_dict(link), 8, device="cpu")
    c = fn(15.0, FrameDraws(draws["fade"], draws["bits_c"], draws["bits_d"],
                            draws["noise_c"], draws["noise_d"], draws["loc"]))
    return torch.cat([c.clean_err[:, None], c.dist_err], 1).long().numpy()


@pytest.mark.parametrize("receiver", ["cnc", "mcnc"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_rayleigh_counters_equal(receiver, seed):
    """Rayleigh: the fade is the draws' own, every step is the same float32
    arithmetic up to the order of a few sums, so every counter of every
    frame is equal."""
    link = small_link("rayleigh", receiver)
    d = traffic.draw_round(link, 16, seed, 0, "cpu")
    ref = miso.frame_counters(link, receiver, 8, 15.0, d).numpy()
    np.testing.assert_array_equal(port_counters(link, d), ref)
    assert ref[:, 1].sum() > 1000            # enough errors to tell a difference


@pytest.mark.parametrize("receiver", ["cnc", "mcnc"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_los_counters_agree_within_the_phase_rounding(receiver, seed):
    """LOS: the port forms each phase (about 2.2e4 rad) in float32, where one
    ulp is about 2e-3 rad, and the reference in float64. That moves a few
    symbols, and at 4 antennas the CNC passes feed each flip back: over ten
    seeds of 16 frames the gap (``check.gap_sq`` over every counter) read
    up to 0.042 and the sample's BER up to 1.2% apart. The tolerance is
    about twice that, and well under what the reference computed in fp8
    reads at this size (gap 0.24-0.95, BER 1.8-6.0% apart)."""
    link = small_link("los", receiver)
    d = traffic.draw_round(link, 16, seed, 0, "cpu")
    ref = miso.frame_counters(link, receiver, 8, 15.0, d).numpy()
    port = port_counters(link, d)
    assert check.gap_sq(port, ref) < 0.09
    assert check.numbers(port, ref)["ber_gap"] < 0.025


def test_the_reference_refuses_what_it_does_not_model():
    link = small_link("two_path", "cnc")
    with pytest.raises(ValueError, match="channel 'two_path'"):
        miso.frame_counters(link, "cnc", 8, 15.0, traffic.draw_round(link, 1, 0, 0, "cpu"))
