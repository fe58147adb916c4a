"""Faults planted in the program underneath a run, for the tests and the
calibration that show the comparison catches them. Nothing of a benchmark
run plants one.

- ``state_unchanged``: the optimizer's step returns with the parameters and
  its state untouched;
- ``half_batch``: training takes the mean squared residual over the first
  half of each batch; evaluation computes the first half of each request
  and returns it twice;
- ``answer_altered``: one residual of each request is moved by 1% of the
  largest in its column;
- ``batch_repeated``: every step trains on the first step's batch;
- ``batch_squeezed``: every point of a batch is moved to half its coordinates;
- ``noise_missing`` (mixes with a noisy grid): the grid's nodes without their noise.
"""
from contextlib import contextmanager

import torch

FAULTS = {'train': ('state_unchanged', 'half_batch', 'batch_repeated', 'batch_squeezed', 'noise_missing'),
          'eval': ('half_batch', 'answer_altered')}


def applicable(cell):
    """The faults that ``cell`` can have."""
    from .compare import leaves

    if cell.traffic['kind'] != 'train':
        return list(FAULTS[cell.traffic['kind']])
    noisy = any((leaf['class'], leaf['method']) == ('Generator2D', 'equally-spaced-noisy')
                for leaf in leaves(cell.traffic['generator']))
    return [f for f in FAULTS['train'] if f != 'noise_missing' or noisy]


@contextmanager
def _patched(owner, name, value, item=False):
    old = owner[name] if item else getattr(owner, name)
    if item:
        owner[name] = value
    else:
        setattr(owner, name, value)
    try:
        yield
    finally:
        if item:
            owner[name] = old
        else:
            setattr(owner, name, old)


def _columns(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _as_returned(cols, like):
    return cols if isinstance(like, (list, tuple)) else cols[0]


@contextmanager
def planted(fault, kind):
    """Plant ``fault`` in the program for a run of a ``kind`` cell."""
    from neurodiffeq_tpu_torch import losses
    from neurodiffeq_tpu_torch.solvers import BaseSolver

    if fault not in FAULTS[kind]:
        raise ValueError(f"a {kind} cell has no fault {fault!r}; it has {FAULTS[kind]}")
    if fault == 'state_unchanged':
        with _patched(torch.optim.Adam, 'step', lambda self, closure=None: None):
            yield
    elif fault in ('batch_repeated', 'batch_squeezed'):
        draw = BaseSolver._generate_batch

        def faulty_batch(self, phase):
            if fault == 'batch_squeezed' or phase != 'train':
                cols = draw(self, phase)
                if phase == 'train':
                    self._batch[phase] = cols = [c * 0.5 for c in cols]
                return cols
            first = self.__dict__.setdefault('_first_train_batch', draw(self, phase))
            self._batch[phase] = list(first)
            return self._batch[phase]

        with _patched(BaseSolver, '_generate_batch', faulty_batch):
            yield
    elif fault == 'noise_missing':
        from neurodiffeq_tpu_torch.generators import Generator2D

        with _patched(Generator2D, 'sample', lambda self, generator: self._grid_points):
            yield
    elif fault == 'half_batch' and kind == 'train':
        def half_mean(residual, funcs, coords):
            r = losses._value(residual)
            return (r[:r.shape[0] // 2] ** 2).mean()

        half_mean.shard_form = 'mean'
        with _patched(losses._losses, 'l2', half_mean, item=True):
            yield
    else:
        whole = BaseSolver.get_residuals

        def faulty(self, *coords, **kwargs):
            if fault == 'half_batch':
                half = [c[:c.shape[0] // 2] for c in coords]
                out = whole(self, *half, **kwargs)
                return _as_returned([torch.cat([c, c]) for c in _columns(out)], out)
            out = whole(self, *coords, **kwargs)
            cols = [c.clone() for c in _columns(out)]
            for c in cols:
                c.view(-1)[0] += 0.01 * c.abs().max()
            return _as_returned(cols, out)

        with _patched(BaseSolver, 'get_residuals', faulty):
            yield
