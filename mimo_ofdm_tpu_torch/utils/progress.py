"""Terminal progress bar (port of ``mimo_ofdm_tpu/utils/progress.py``;
``reference/utilities.py:369-392``)."""

from __future__ import annotations

import sys


def print_progress_bar(iteration: int, total: int, prefix: str = "",
                       suffix: str = "", decimals: int = 1,
                       bar_length: int = 50) -> None:
    pct = 100.0 * iteration / float(total)
    filled = int(round(bar_length * iteration / float(total)))
    bar = "|" * filled + "-" * (bar_length - filled)
    sys.stdout.write(f"\r{prefix} |{bar}| {pct:.{decimals}f}% {suffix}")
    if iteration >= total:
        sys.stdout.write("\n")
    sys.stdout.flush()
