"""Run one cell of the benchmark of ``neurodiffeq_tpu_torch``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Exits with 2, printing no result, without enough CUDA cards or without the
port in the checkout, and with 3 if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = 'neurodiffeq_tpu_torch'


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def caches():
    """Every build and kernel cache inside the checkout, at fixed paths, the
    interpreter's bytecode too: the sources the run imports, the installed
    packages' among them, are then compiled once, by the checkout's first
    run, even where the environment asks for no bytecode to be written
    (``PYTHONDONTWRITEBYTECODE``) or the packages' folders hold none."""
    base = ROOT / 'build' / 'portbench'
    os.environ['TRITON_CACHE_DIR'] = str(base / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(base / 'torch_extensions')
    os.environ['PYTHONPYCACHEPREFIX'] = sys.pycache_prefix = str(base / 'pycache')
    os.environ.pop('PYTHONDONTWRITEBYTECODE', None)
    sys.dont_write_bytecode = False


def main(argv=None):
    args = parse(argv)
    if not (ROOT / PORT / '__init__.py').is_file():
        print(f"portbench: no {PORT} package in {ROOT}", file=sys.stderr)
        return 2
    caches()
    # the checkout's root, in place of this file's folder, whose modules' names are generic
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or '.').resolve() != Path(__file__).resolve().parent]
    import torch
    from portbench import harness

    harness.note(T_START, f'torch {torch.__version__} imported')
    cell = harness.Cell.load(args.workload)
    chips = cell.entry.get('chips', 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    import neurodiffeq_tpu_torch
    harness.note(T_START, f'{PORT} imported')
    if Path(neurodiffeq_tpu_torch.__file__).resolve().parents[1] != ROOT:
        print(f"portbench: {PORT} was imported from {neurodiffeq_tpu_torch.__file__}, not {ROOT}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device='cuda',
                         t_start=T_START, cell=cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result['checks'].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
