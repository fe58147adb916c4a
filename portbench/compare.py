"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``) in float64 on the same inputs.

Training: the first ``check_steps`` steps of ``fit``, each step's loss, the
first gradient as Adam got it (its first moment after one step over
1 - beta1), and the parameters' change after the last step, the last two by
the worst trainable leaf's gap of norms (frozen leaves go to both sides and
are not compared); each trainable leaf's gradient gap is read besides, as
``grad_gap.<leaf>``, for a cell whose limits name it: where the program's
worst leaf and the control's are not the same leaf, the worst leaf's gap
cannot tell them apart. Leaves whose reference gradient is under
``STILL_LEAF`` of the median leaf's move by round-off alone, so their change
is left out. The batches themselves are judged by the mix's own law
(``laws/<class>.<method>.py``), not by the program's generator: points
outside what the law allows, a batch or a column drawn twice, and the
largest distance of a column's distribution from the law's. Evaluation:
each kept request's residuals, by the widest gap against each equation's
largest reference value.
"""
import math
import statistics
from pathlib import Path

import torch

from .reference import plain

STILL_LEAF = 1e-3


def _norm(t):
    return float(t.double().norm())


def leaf_gaps(program, reference):
    """Each leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median leaf's.
    A leaf the program lacks (``None``) has norm 0; lists of unequal length
    raise, since no pairing of them is sound."""
    if len(program) != len(reference):
        raise ValueError(f"the program has {len(program)} leaves, the reference {len(reference)}")
    ref = [_norm(r) for r in reference]
    med = statistics.median(ref)
    return [abs((0.0 if p is None else _norm(p)) - r) / max(r, med, 1e-300) for p, r in zip(program, ref)]


def norm_gap(program, reference, keep=None):
    """The worst leaf's gap (:func:`leaf_gaps`), over the leaves ``keep``."""
    gaps = leaf_gaps(program, reference)
    return max(gaps[i] for i in (range(len(gaps)) if keep is None else keep))


def reference_train(cell, p0, batches, dtype=torch.float64, tf32=False):
    """``(losses, first gradient, final parameters)`` of the reference's
    steps from ``p0`` (every leaf) over ``batches``, in ``dtype`` (TF32
    products if ``tf32``); the gradient and parameters of the trainable leaves."""
    with plain.matmul_precision(tf32):
        losses, grads, final = plain.train(cell.problem, cell.cfg, [p.to(dtype) for p in p0],
                                           [[c.to(dtype).reshape(-1) for c in cols] for cols in batches],
                                           cell.cfg['reference_block_rows']['train'], cell.trainable)
    return losses, grads, [final[i] for i in cell.trainable]


def leaves(node):
    """The generators that a mix's ``generator`` combines."""
    return [leaf for n in node['product'] for leaf in leaves(n)] if 'product' in node else [node]


def batch_readings(root, generator, batches):
    """``batch_outside``, ``batch_repeats`` and ``batch_law`` of the checked
    steps' ``batches`` (each a list of columns) under the mix's
    ``generator``, each leaf of which is judged by ``laws/<class>.<method>.py``."""
    from .harness import load_module

    laws = []
    for leaf in leaves(generator):
        path = Path(root) / 'laws' / f"{leaf['class']}.{leaf['method']}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no law for {leaf['class']} {leaf['method']!r}: add {path.name} under laws/")
        laws.append((leaf, load_module(path)))
    outside, law, repeats = 0, 0.0, 0
    batches = [[c.reshape(-1) for c in cols] for cols in batches]
    for s, cols in enumerate(batches):
        if sum(mod.COLUMNS for _, mod in laws) != len(cols):
            law = math.inf
            continue
        k = 0
        for leaf, mod in laws:
            got = mod.check(leaf, cols[k:k + mod.COLUMNS])
            k += mod.COLUMNS
            outside, law = outside + got['outside'], max(law, got['law'])
        repeats += sum(torch.equal(a, b) for i, a in enumerate(cols) for b in cols[i + 1:])
        repeats += sum(all(torch.equal(a, b) for a, b in zip(cols, earlier)) for earlier in batches[:s])
    return {'batch_outside': float(outside), 'batch_repeats': float(repeats), 'batch_law': law}


def train_readings(cell, p0, batches, rows, program, ref):
    """The numbers compared for a training cell. ``p0`` is every leaf;
    ``program`` and ``ref`` are ``(losses, first gradient, final
    parameters)`` of the trainable leaves; the program's gradient and final
    parameters may be ``None`` where it made none."""
    steps = cell.traffic['check_steps']
    losses, grads, final = program
    ref_losses, ref_grads, ref_final = ref
    missing = abs(len(batches) - steps) + abs(len(losses) - steps)
    med = statistics.median(_norm(g) for g in ref_grads)
    moving = [i for i, g in enumerate(ref_grads) if _norm(g) >= STILL_LEAF * med]
    p0 = [p0[i].double() for i in cell.trainable]
    final = final if final is not None else [None] * len(p0)
    grad_gaps = leaf_gaps(grads or [None] * len(p0), ref_grads)
    return {
        'batch_rows': float(sum(abs(cols[0].numel() - rows) for cols in batches) + rows * missing),
        **batch_readings(cell.root, cell.traffic['generator'], batches),
        'loss_gap': max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)) if not missing else math.inf,
        'grad_gap': max(grad_gaps),
        'change_gap': norm_gap([None if f is None else f.double() - p for f, p in zip(final, p0, strict=True)],
                               [f.double() - p for f, p in zip(ref_final, p0, strict=True)], moving),
        **{f"grad_gap.{cell.leaves[i]['name']}": g for i, g in zip(cell.trainable, grad_gaps, strict=True)},
    }


def reference_eval(cell, params, points, dtype=torch.float64, tf32=False):
    """Each equation's residual at ``points`` (``(d, N)``), as ``(N,)`` tensors."""
    with plain.matmul_precision(tf32):
        return plain.residuals(cell.problem, cell.cfg, [p.to(dtype) for p in params], [p.to(dtype) for p in points],
                               cell.cfg['reference_block_rows']['eval'])


def eval_readings(cell, answers, refs):
    """The numbers compared for an evaluation cell: ``answers`` and ``refs``
    map each kept request's index to its residuals."""
    n = cell.traffic['points_per_request']
    rows, worst = 0, 0.0
    for index, ref in refs.items():
        out = answers[index]
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        rows += n * abs(len(out) - len(ref)) + sum(abs(o.numel() - r.numel()) for o, r in zip(out, ref))
        for o, r in zip(out, ref):
            if o.numel() != r.numel():
                continue
            gap = float((o.double().reshape(-1) - r.double()).abs().max() / r.double().abs().max().clamp_min(1e-300))
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return {'answer_rows': float(rows), 'residual_gap': worst}


def judge(readings, limits):
    """Whether every number that ``limits`` names is within its limit (one
    that was not read fails; NaN fails), and each beside its limit; a
    reading that ``limits`` does not name is not compared."""
    if not limits:
        return False, {name: {'value': v, 'limit': None} for name, v in readings.items()}
    checks = {name: {'value': readings.get(name, math.inf), 'limit': limit} for name, limit in limits.items()}
    return all(c['value'] <= c['limit'] for c in checks.values()), checks
