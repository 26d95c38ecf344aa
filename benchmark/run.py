"""Run one cell of BENCHMARK.json once on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Draws the cell's catalog on the card from the seed, builds the program's
``AbacusHOD`` on it, warms up, runs the closed loop of likelihood
evaluations for --seconds, holds a sample of them to the plain reference,
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), ``device`` (with --trace 1 its busy and
window seconds), ``breakdown`` (--trace 1) and ``checks``, each compared
number beside its limit; the same numbers are the last lines of standard
error. Exits non-zero, printing no result, without enough cards, where the
program is not in this checkout, or where JAX or the JAX package was
loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# every cache a run writes stays at a fixed path inside the checkout
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'), ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = str(REPO / 'build' / 'bench_cache' / sub)
os.environ.setdefault('USE_FLAX', '0')
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.entry['chips']):
        print(f'{cell.name} needs {cell.entry["chips"]} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}', file=sys.stderr)
        return 2
    import abacusutils_tpu_torch

    if not Path(abacusutils_tpu_torch.__file__).resolve().is_relative_to(REPO):
        print(f'the program was loaded from {abacusutils_tpu_torch.__file__}, outside {REPO}',
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result, extra = harness.run(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
                                T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f'loaded in this process: {", ".join(bad)}', file=sys.stderr)
        return 3
    print(json.dumps({'extra': extra}), file=sys.stderr)
    for k, c in result['checks'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
