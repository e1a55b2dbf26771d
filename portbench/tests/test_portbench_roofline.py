"""The frozen work counts of ``portbench/roofline.py`` at the bench's shapes."""

import json
from pathlib import Path

import pytest

from portbench import roofline

ROOT = Path(__file__).resolve().parents[1]


def test_bench_tx_shape_is_bound_by_bytes():
    # [32768, 2048] bf16 planes of n_fft 4096: 32768 rows x (2 x 2048 x 4 B + 8 B)
    # = 537.1 MB at 3.35 TB/s, against 1.61e10 operations at 989 TFLOP/s
    t, term = roofline.least_seconds(32768, 4096, 2048, "bfloat16")
    assert term == "bytes"
    assert t * 1e3 == pytest.approx(0.16034, abs=5e-5)
    assert 32768 * roofline.row_flops(4096) / roofline.PEAK_FLOPS["bfloat16"] * 1e3 == (
        pytest.approx(0.01629, abs=5e-5))


def test_f32_rows_count_eight_bytes_a_point():
    assert roofline.row_bytes(2048, "float32") == 2 * 2048 * 8 + 8
    assert roofline.row_bytes(2048, "bfloat16") == 2 * 2048 * 4 + 8


@pytest.mark.parametrize("receiver,rows", [("cnc", 64 + 9), ("mcnc", 64 * 10)])
def test_rows_per_frame(receiver, rows):
    assert roofline.rows_per_frame(receiver, 64, 8) == rows
    assert roofline.rows_per_frame(receiver, 64, 8, n_users=1) == rows


@pytest.mark.parametrize("receiver,rows", [
    ("cnc", 64 + 9 * 2),            # the summed TX, then one row a user a pass
    ("cnc_mu", 64 + 9 * 2),
    ("mcnc_mu", 64 + 9 * 2 * 64),   # every user's whole array a pass
])
def test_rows_per_two_user_frame(receiver, rows):
    assert roofline.rows_per_frame(receiver, 64, 8, n_users=2) == rows


def test_no_single_user_mcnc_rows_for_two_users():
    with pytest.raises(ValueError, match="'mcnc' of 2 users"):
        roofline.rows_per_frame("mcnc", 64, 8, n_users=2)


@pytest.mark.parametrize("config,traffic,least_ms", [
    ("miso_rayleigh", "mcnc.b512", 1.6034),      # 512 x 640 rows
    ("miso_rayleigh", "cnc.b512", 0.18289),      # 512 x 73 rows
    ("miso_los", "cnc.b32", 0.011431),           # 32 x 73 rows
])
def test_round_least_time_of_each_cell(config, traffic, least_ms):
    link = json.loads((ROOT / "configs" / f"{config}.json").read_text())["link"]
    tr = json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())
    assert roofline.round_least_seconds(link, tr) * 1e3 == pytest.approx(least_ms, rel=2e-4)
