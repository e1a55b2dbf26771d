"""The benchmark's plain LDPC-coded reference (``portbench/reference/ldpc.py``)
against the port's coded link, on the CPU.

* (a) At n_fft 256, 128 subcarriers and 8 antennas, where TS 38.212 §7.2.2
  picks BG2 (A = 384), the port's ``link_ldpc.make_transport_frame_fn`` on
  ``reference_chain(cfg, 0.5)`` (the frame of ``ldpc_ref_ber`` and of the
  benchmark's family ``frames/ldpc.py``) and the reference decode the same
  seeded draws, and their per-frame payload errors are held together; the
  reference with its chain's planes in fp8 (the benchmark's control) falls
  outside.
* (b) The reference's BG1 chain alone against the port's
  ``transport_encode``/``transport_decode``: the same surrogate base graphs,
  the same codewords bit for bit, and the same decoded payloads.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mimo_ofdm_tpu_torch.ops import nr_ldpc, transport
from portbench import check
from portbench.frames import ldpc as family
from portbench.reference import ldpc as reference

CONFIG = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "ldpc_ref.json"
N_ITERS = 2
FRAMES = 64
SEED = 2_718_281_828_459
EBN0_DB = 6.0          # the n_fft 256 link's waterfall: the clean runs decode, most passes fail

# Tolerances of (a), in check.py's numbers over the 64 frames (each about 3x
# the gap measured, with room for the CPU's thread count moving float32 sums):
# * the clean run has no chain: the port and the reference differ only in
#   the LOS phases (the port's float32 against the reference's float64) and
#   in the order of float32 sums, so a frame's count moves only where its
#   decode sits on its edge (measured 0 frames apart);
# * the passes go through the chain, whose planes the port's plain CPU
#   version rounds to bf16 (the kernel's arithmetic) where the reference
#   keeps float32: a few frames' decodes turn (measured 0.17 over the
#   passes, 0.014 over the clean run and pass 0; the fp8 control reads 1.12
#   and 0.19).
CLEAN_GAP = 0.05
FIRST_GAP = 0.05
PASSES_GAP = 0.6


def _link():
    cfg = json.loads(CONFIG.read_text())
    link = cfg["link"]
    link["modem"].update(n_fft=256, n_sub_carr=128)
    link["array"]["n_elements"] = 8
    link["rx"]["max_cnc_iters"] = N_ITERS
    return link, cfg["frame_args"]


@pytest.fixture(scope="module")
def frames():
    """The port's counters, the reference's and the fp8 control's on the
    same draws, ``[64, N_ITERS + 2]`` each."""
    link, args = _link()
    snr = EBN0_DB + 10 * np.log10(6)
    draws = family.draw_round(link, FRAMES, SEED, 0, "cpu", **args)
    port = family.build(link, N_ITERS, "cpu", **args)
    program = family.counters(port(snr, family.to_draws(draws))).numpy()
    ref = reference.frame_counters(link, "cnc", N_ITERS, snr, draws, **args).numpy()
    control = reference.frame_counters(link, "cnc", N_ITERS, snr, draws,
                                       planes=check.control_planes(link), **args).numpy()
    return program, ref, control


def test_the_small_link_takes_bg2_and_one_code_block():
    link, args = _link()
    code = reference.code_of(link, args["code_rate"])
    assert (code.bg, code.a, code.e, code.z) == (2, 384, 768, 52)


def test_the_port_and_the_reference_count_the_same_frames(frames):
    program, ref, _ = frames
    assert program.shape == ref.shape == (FRAMES, N_ITERS + 2)
    assert (ref[:, 1:] > 0).any() and (ref == 0).any()      # blocks fail and decode
    assert check.gap_sq(program[:, :1], ref[:, :1]) <= CLEAN_GAP
    found = check.numbers(program, ref)
    assert found["gap_sq_first"] <= FIRST_GAP
    assert found["gap_sq_passes"] <= PASSES_GAP


def test_the_fp8_control_falls_outside(frames):
    _, ref, control = frames
    found = check.numbers(control, ref)
    assert found["gap_sq_first"] > FIRST_GAP or found["gap_sq_passes"] > PASSES_GAP


# (b): a payload of A = 3,840 > 3,824 bits at rate 1/2 (E = 7,680) takes BG1,
# Zc 176. LLRs: BPSK on the codeword bits with noise of standard deviation
# SIGMA, 2 (1 - 2 c + SIGMA n) / SIGMA^2. At 0.6 every block decodes; at 1.0,
# past the cliff (near 0.85), every block fails. Both lie away from the
# decision edge, where float32 sums taken in another order could turn a
# decode; up to one codeword in eight may differ (measured: none).
E_BG1, A_BG1 = 7680, 3840
SHARE_APART = 1 / 8


@pytest.fixture(scope="module")
def bg1():
    code = reference.Code(E_BG1, A_BG1, 0.5)
    chain = transport.make_nr_transport_chain(E_BG1, bg=1, a=A_BG1)
    payload = torch.randint(0, 2, (16, A_BG1), generator=torch.Generator().manual_seed(11),
                            dtype=torch.int8)
    return code, chain, payload


def test_the_surrogate_base_graphs_are_the_ports():
    for bg, i_ls in ((1, 4), (1, 5), (1, 6), (2, 6), (2, 1)):
        assert np.array_equal(reference.base_graph(bg, i_ls),
                              np.array(nr_ldpc._base_graph_cached(bg, i_ls)))


def test_the_bg1_codewords_are_bit_exact(bg1):
    """Both give the one systematic codeword of ``H`` on the same payload,
    CRC24A, filler and rate matching."""
    code, chain, payload = bg1
    assert (code.bg, code.z, chain.code.z, chain.c) == (1, 176, 176, 1)
    sent = reference.encode(code, payload)
    assert torch.equal(sent, transport.transport_encode(chain, payload).to(torch.int64))


@pytest.mark.parametrize("sigma,decodes", [(0.6, True), (1.0, False)])
def test_the_bg1_decodes_agree(bg1, sigma, decodes):
    code, chain, payload = bg1
    bits = reference.encode(code, payload).to(torch.float32)
    noise = torch.randn(bits.shape, generator=torch.Generator().manual_seed(12))
    llr = 2.0 * (1.0 - 2.0 * bits + sigma * noise) / sigma ** 2
    port, _ = transport.transport_decode(chain, llr, n_iters=12, algorithm="sumprod")
    ref = reference.decode(code, reference.derate_match(code, llr), 12)[:, :A_BG1]
    apart = (port.to(torch.int64) != ref).any(-1).float().mean().item()
    assert apart <= SHARE_APART
    wrong = (ref != payload.to(torch.int64)).any(-1)
    assert not wrong.any() if decodes else wrong.all()
