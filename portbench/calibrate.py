"""The readings the check's limits are set from, on the card.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--out <file.jsonl>]

For each seed, in one process: the cell's pool from that seed, a short
window of the program at the cell's own load, the sample of its frames
the benchmark compares, and the plain reference on them. Then the
control: the reference put in the program's place and computed one
precision below the configuration's (``check.control_planes``), judged
against the reference on the same frames. One JSON line a seed with the
program's numbers and the control's, each also counter by counter, and
each side's ``correct`` under the cell's limits (``check.judge``), then a
summary line with each number's largest program reading (the lower end of
its limit), smallest control reading (the upper end), and how many seeds
of each side came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import check, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    run.use_cache_dirs()
    from mimo_ofdm_tpu_torch.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache(str(run.CACHE / "build"))
    cell = spec.load_cell(args.workload)
    planes = check.control_planes(cell.link)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        h = run.Harness(cell, seed, "cuda")
        h.warm_up()
        win = h.window(args.seconds)
        h.free_program()
        picks, program = h.sample(win["rounds"])
        ref = h.reference(picks)
        control = h.reference(picks, planes=planes)
        line = {"cell": cell.name, "seed": seed, "frames_per_s": win["frames_per_s"],
                "frames_compared": len(picks), "errors_per_counter": ref.sum(0).tolist()}
        for side, counters in (("program", program), ("control", control)):
            found = check.numbers(counters, ref)
            line[side] = found
            line[f"{side}_correct"] = check.judge(found, cell.limits)[0]
            line[f"{side}_per_counter"] = check.per_counter(counters, ref)
        lines.append(line)
        print(json.dumps(line), flush=True)
        del h
    summary = {"cell": cell.name, "control_planes": planes, "seeds": len(lines),
               "program_correct": sum(ln["program_correct"] for ln in lines),
               "control_correct": sum(ln["control_correct"] for ln in lines),
               "program_max": {k: max(ln["program"][k] for ln in lines)
                               for k in lines[0]["program"]},
               "control_min": {k: min(ln["control"][k] for ln in lines)
                               for k in lines[0]["control"]}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for ln in [*lines, summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
