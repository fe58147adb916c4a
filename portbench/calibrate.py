"""Readings from which a cell's limits are set (the benchmark's own runs
never run this).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... [--control-seeds ...]
        [--fault-seeds ...] [--faults a,b] [--seconds 2] [--out file.jsonl]

In one process, on the card: the sound program's readings on ``--seeds``
(the lower reading is their largest); the control's, the plain reference
computed in float32 with TF32 products put in the program's place, on
``--control-seeds``; and each fault of ``faults.py`` planted in the program,
on ``--fault-seeds``. Every reading is against the float64 reference at the
cell's own size; a training cell runs its checked steps, an evaluation cell
a short window at its own load. One JSON line per run, then a summary.
"""
import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text):
    return [int(s) for s in text.split(',') if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=seeds, required=True)
    p.add_argument('--control-seeds', type=seeds, default=[])
    p.add_argument('--fault-seeds', type=seeds, default=[])
    p.add_argument('--faults', help='a comma-separated subset of the faults the cell can have (default: all)')
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--out')
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [s for s in sys.path if Path(s or '.').resolve() != Path(__file__).resolve().parent]
    import torch
    from portbench import compare, faults, harness

    cell = harness.Cell.load(args.workload)
    kind = cell.traffic['kind']
    device = torch.device(args.device)
    out = open(args.out, 'w') if args.out else None
    rows = []

    def emit(mode, seed, readings, seconds):
        row = {'workload': cell.name, 'mode': mode, 'seed': seed, 'readings': readings, 'seconds': seconds}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + '\n')
            out.flush()

    def evidence(seed, fault=None):
        t0 = time.perf_counter()
        if fault is None:
            r = harness.RUNNERS[kind](cell, seed, args.seconds, False, device, t0)
        else:
            with faults.planted(fault, kind):
                r = harness.RUNNERS[kind](cell, seed, args.seconds, False, device, t0)
        return r['evidence']

    def readings(ev, control=False):
        if kind == 'train':
            ref = compare.reference_train(cell, ev['p0'], ev['batches'])
            program = (compare.reference_train(cell, ev['p0'], ev['batches'], torch.float32, tf32=True)
                       if control else ev['program'])
            got = compare.train_readings(cell, ev['p0'], ev['batches'], ev['rows'], program, ref)
            # each step's loss gap beside the compared largest, to see which step sets it
            got['loss_gap_by_step'] = [abs(a - b) / abs(b) for a, b in zip(program[0], ref[0])]
            # and each leaf's change (each leaf's gradient gap is among the readings, grad_gap.<leaf>)
            p0 =[ev['p0'][i].double() for i in cell.trainable]
            final = program[2] or [None] * len(p0)
            got['change_gap_by_leaf'] = compare.leaf_gaps(
                [None if f is None else f.double() - p for f, p in zip(final, p0, strict=True)],
                [f.double() - p for f, p in zip(ref[2], p0, strict=True)])
            return got
        points = {i: harness.request_points(cell, ev['seed'], i, device) for i in ev['answers']}
        refs = {i: compare.reference_eval(cell, ev['params'], pts) for i, pts in points.items()}
        answers = ({i: compare.reference_eval(cell, ev['params'], pts, torch.float32, tf32=True)
                    for i, pts in points.items()} if control else ev['answers'])
        return compare.eval_readings(cell, answers, refs)

    plan = ([('program', s, None) for s in args.seeds] + [('control', s, None) for s in args.control_seeds]
            + [(f'fault:{f}', s, f) for f in faults.applicable(cell)
               if not args.faults or f in args.faults.split(',') for s in args.fault_seeds])
    for mode, seed, fault in plan:
        t0 = time.perf_counter()
        ev = evidence(seed, fault)
        emit(mode, seed, readings(ev, control=mode == 'control'), time.perf_counter() - t0)
        del ev
        gc.collect()
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    summary = {}
    for row in rows:
        for name, v in row['readings'].items():
            if not isinstance(v, (int, float)):
                continue
            s = summary.setdefault(name, {})
            key = 'program_max' if row['mode'] == 'program' else row['mode'] + '_min'
            pick = max if row['mode'] == 'program' else min
            s[key] = v if key not in s or math.isnan(v) else pick(s[key], v)
    print(json.dumps({'workload': cell.name, 'summary': summary}), flush=True)
    if out:
        out.write(json.dumps({'workload': cell.name, 'summary': summary}) + '\n')
        out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
