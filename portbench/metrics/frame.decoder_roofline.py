"""frame.decoder_roofline: the LDPC decoder's least time a round
(``portbench/roofline_ldpc.py``: codewords, edges and iterations from the
configuration and the reference's base graph, LLRs in and hard bits out, 6
operations an edge an iteration at the float32 peak) over the device time
of the program's ``decode`` spans a round, in percent. The configuration's
``frame_args`` (code rate, iterations) are those of the traced run's cell;
None outside a traced run of a cell that has them, or without the spans."""

import functools
import sys

from portbench import roofline_ldpc, spec, stages

DECODER_METRIC = "frame.decoder_ms_per_round"


@functools.lru_cache(maxsize=None)
def _frame_args(cell: str) -> dict:
    return spec.load_cell(cell).frame_args


def frame_args() -> dict | None:
    """The traced cell's ``frame_args``, or None outside a traced run."""
    cell = stages.traced_cell(sys.argv)
    return None if cell is None else _frame_args(cell)


def read(view):
    decoder_ms = view.read(DECODER_METRIC)
    args = frame_args()
    if not decoder_ms or not args or "ldpc_iters" not in args:
        return None
    least_ms = roofline_ldpc.round_least_seconds(view.link, view.traffic, args["code_rate"],
                                                 args["ldpc_iters"]) * 1e3
    return 100.0 * least_ms / decoder_ms
