"""The LDPC decoder's work a round, counted from the configuration, and the
card's published peaks: the yardstick of ``frame.decoder_roofline``.

The counts do not depend on what implements the decoder, nor on the
program's own counts:

* codewords: every frame decodes its clean run and each of its ``n_iters +
  1`` receiver passes, ``C`` code blocks each: ``frames x (n_iters + 2) x
  C`` a round (``C = 1`` for a code the LDPC reference models);
* edges: the ones of the code's parity-check matrix, from the reference's
  own base graph (``reference/ldpc.py``): 84,960 for BG1 at ``Zc`` 288;
* operations: 6 an edge an iteration, for ``ldpc_iters`` iterations (a
  check-node and a variable-node update, each a few adds and a table
  look-up, counted at their least);
* bytes: each codeword reads its ``E`` rate-matched LLRs once (float32, 4
  B each) and writes its ``K`` hard information bits (1 B each); messages
  that stay on the chip between iterations are not counted;
* least time: ``max(bytes / HBM bandwidth, operations / float32 peak)``,
  a true lower bound of any decoder of these codewords.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W.
"""

from __future__ import annotations

from portbench.reference import ldpc as reference

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
OPS_PER_EDGE_ITER = 6
LLR_BYTES = 4
BIT_BYTES = 1


def codewords_per_round(frames: int, n_iters: int, n_blocks: int = 1) -> int:
    """Codewords a round: each frame's clean run and ``n_iters + 1`` passes."""
    return frames * (n_iters + 2) * n_blocks


def codeword_ops(edges: int, ldpc_iters: int) -> float:
    return float(OPS_PER_EDGE_ITER * edges * ldpc_iters)


def codeword_bytes(e: int, k: int) -> int:
    """``E`` LLRs in, ``K`` hard bits out."""
    return LLR_BYTES * e + BIT_BYTES * k


def least_seconds(codewords: int, edges: int, ldpc_iters: int, e: int,
                  k: int) -> tuple[float, str]:
    """The least time of ``codewords`` decodes, and which term bounds it."""
    t_bytes = codewords * codeword_bytes(e, k) / HBM_BYTES_PER_S
    t_ops = codewords * codeword_ops(edges, ldpc_iters) / PEAK_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def round_least_seconds(link: dict, traffic: dict, code_rate: float, ldpc_iters: int) -> float:
    """The least time of one round's decodes for a configuration (``link``,
    the port's configuration as a dict, and its ``frame_args``) and a
    traffic mix."""
    code = reference.code_of(link, code_rate)
    words = codewords_per_round(traffic["frames_per_round"], link["rx"]["max_cnc_iters"])
    return least_seconds(words, code.edges, ldpc_iters, code.e, code.k)[0]
