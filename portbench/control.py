"""Read the control of a cell's comparison on the card: one run of the cell
as ``run.py`` makes it, whose sampled answers are judged twice, once as the
program returned them and once as the control computes them (the reference
in the program's place in bfloat16, the precision below the
configuration's float32: ``harness/check.py``).

    python3 portbench/control.py --workload <cell> --seed <n> --seconds <s>

Prints one JSON line: the cell, the seed, each side's readings and whether
each side came out correct.  The control has to come out not correct; the
benchmark's own runs never compute it.
"""
import json
import sys

import run as runmod


def main(argv=None) -> int:
    args = runmod.parse(argv)
    run, device = runmod.start(args, control=True)
    line = {"workload": args.workload, "seed": args.seed,
            "device": device["kind"], "power_limit_w": device["power_limit_w"],
            "program_correct": run.correct, "program": run.readings,
            "control_correct": run.control["correct"],
            "control": run.control["readings"]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
