"""Spans of the solver loop, recorded through ``torch.profiler``.

A span is a ``record_function`` range: it lands in the profiler's trace on
the clock of the kernels it launches, so an idle stretch of the device can be
put down to the solver phase that ran on the host meanwhile. A span is on
exactly while a profiler is, and costs one check otherwise.
``fit(profile_dir=...)`` writes the spans with the rest of its trace.
"""
from contextlib import nullcontext

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

SPANS = {
    'solver.batch': "the generator's draw of a batch; an adaptive generator's scoring nests its spans under it",
    'solver.forward': 'points to coordinate fields, and the conditions enforced on the nets, as lazy fields',
    'solver.residual': 'the equations (the nets and their Taylor kernels run as they ask for derivatives), the loss '
                       'and its extra terms, the metrics; the residual of get_residuals',
    'solver.backward': 'the loss backward into the trained parameters',
    'solver.reduce': "the gradients' sum over the mesh's 'points' axis",
    'solver.readback': "the epoch's records read to the host, its one wait for the device",
    'solver.best': 'the lowest-loss parameters compared and copied',
    'solver.copy_nets': 'the frozen net copies of solutions and get_residuals',
}

_OFF = nullcontext()


def span(name, args=None):
    """A ``record_function(name, args())`` range while a profiler is on, else
    one shared no-op context. ``args``, a callable returning a string, is
    called only while a profiler is on."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name, None if args is None else args())
