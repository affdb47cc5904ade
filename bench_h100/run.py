"""The benchmark of ``toucan_tpu_torch`` on one H100: run one cell.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It exits with a code other than 0 and prints
no result where no CUDA device is visible, where the cell asks for more
cards than there are, or where the JAX stack was loaded.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)
    import torch

    from bench_h100.harness import run, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out, info = run.execute(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = run.forbidden_modules()
    if loaded:
        print(f"the JAX stack is loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    run.report(out, info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
