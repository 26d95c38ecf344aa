"""The readings a cell's comparison limits are set from, on the card.

    python benchmark/readings.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--seconds 2] [--out readings.jsonl]

For each seed of --seeds: the cell's run with a short window (--seconds) at
the cell's own sizes and load, its sampled evaluations held to the plain
reference, and the compared numbers (the program's sound runs: the lower
readings). For each seed of --control-seeds: the same with the reference in
bfloat16 in the program's place (the control: the upper readings). One
process reads every seed, so the interpreter, torch and the kernel library
start once. Prints one JSON line a run, and last the largest lower and the
smallest upper reading of each number.
"""

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float, default=2.0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    cell = harness.Cell(args.workload)
    out = open(args.out, 'a') if args.out else None
    lower, upper = {}, {}
    runs = [(int(s), None) for s in args.seeds.split(',') if s]
    runs += [(int(s), 'bf16') for s in args.control_seeds.split(',') if s]
    for seed, control in runs:
        result, extra = harness.run(cell, seed, args.seconds, False, 'cuda', control=control)
        vals = {k: c['value'] for k, c in result['checks'].items()}
        line = {'workload': cell.name, 'seed': seed, 'control': control, 'numbers': vals,
                'correct': result['correct'], 'attempted': result['attempted'],
                'failed': result['failed'], 'sampled': extra['sampled']}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + '\n')
            out.flush()
        for k, v in vals.items():
            if control:
                upper[k] = min(upper.get(k, float('inf')), v)
            else:
                lower[k] = max(lower.get(k, 0.0), v)
        torch.cuda.empty_cache()
    summary = {'workload': cell.name, 'lower': lower, 'upper': upper}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + '\n')
        out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
