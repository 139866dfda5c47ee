"""The control's readings: the reference, put in the program's place
with the configuration's control step (float32 in place of float64, or
reads clipped without their CIGAR), judged as a run is (check.judge).

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed: {"seed", "correct", "check", "seconds"},
"check" holding each number compared beside its limit.  The control has
to come out as not correct on every seed; the command exits 1 where it
does not.  It runs on the host (numpy) at the cell's own size; the
benchmark's runs do not run it.
"""
import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import check, gen, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        work = harness.work_root()
        try:
            t = time.perf_counter()
            inputs = gen.build(os.path.join(work, "data"), cell.config,
                               cell.traffic, seed)
            numbers, detail = check.control(cell, inputs, seed)
            correct = check.passed(numbers)
            for line in detail:
                print(line, file=sys.stderr)
            print(json.dumps({"seed": seed, "correct": correct,
                              "check": numbers,
                              "seconds": time.perf_counter() - t}))
            rc |= int(correct)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
