"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmarks/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, without the program beside this folder, or when jax,
jaxlib, flax or the JAX package is loaded once the window has closed.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    try:
        import torch
        import vapor_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: cannot import the program: {exc}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    result.pop("gen_s", None)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
