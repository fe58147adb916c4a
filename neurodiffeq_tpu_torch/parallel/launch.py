r"""Start the ranks of a mesh from one Python process.

The JAX package drives every device from one controller; PyTorch runs one
process per rank. :func:`launch` is the port's means to the same
convenience: it spawns ``nprocs`` processes, joins them into one
``torch.distributed`` process group through a ``file://`` (or TCP)
rendezvous, runs ``fn(*args)`` in each and returns the results by rank.
A rank's exception ends the others and is raised here; so does a run past
``timeout``, which also bounds every collective (``init_process_group``'s
``timeout``).
"""
import datetime
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback

import torch

from ..utils import get_default_device

__all__ = ['launch']


def _rank_entry(fn, args, rank, nprocs, backend, device_type, init_method, timeout, num_threads, results):
    """One rank: its process group, then ``fn(*args)``; the outcome goes to ``results``."""
    import torch.distributed as dist
    from ..utils import get_default_dtype, set_tensor_type

    try:
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
                          LOCAL_WORLD_SIZE=str(nprocs))
        if num_threads is not None:
            torch.set_num_threads(num_threads)
        if device_type == 'cpu':
            set_tensor_type('cpu', 64 if get_default_dtype() == torch.float64 else 32)
        elif backend == 'nccl':
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=nprocs,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: B036 -- reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def _failures(results, errors, nprocs, grace=2.0):
    """The report of every rank that fails within ``grace`` seconds of the
    first: a rank's failure breaks the others' collectives, and the first
    report to arrive need not be the cause."""
    end = time.monotonic() + grace
    while time.monotonic() < end:
        try:
            rank, ok, out = results.get(timeout=max(end - time.monotonic(), 0.01))
        except _queue.Empty:
            break
        if not ok:
            errors[rank] = out
    return '\n'.join(f"launch: rank {rank} of {nprocs} failed:\n{errors[rank]}" for rank in sorted(errors))


def _stop(procs):
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(10)


def launch(fn, nprocs, backend=None, device_type=None, timeout=300.0, args=(), num_threads=None,
           rendezvous=None):
    """Run ``fn(*args)`` on ``nprocs`` ranks of one process group and return
    the results, one per rank, in rank order.

    :param fn: a function importable by name (a module's top level): the
        ranks are spawned, so it and ``args`` are pickled.
    :param nprocs: the world size.
    :param backend: ``'gloo'`` or ``'nccl'``; defaults to NCCL on the card
        (one card per rank, rank r on ``cuda:r``) and gloo on the CPU. Under
        gloo on the card ``fn`` chooses the card (``make_mesh(devices=...)``).
    :param device_type: ``'cuda'`` or ``'cpu'`` (each rank's default device
        is then the CPU); defaults to the port's default device's type:
        ``'cuda'`` unless ``set_tensor_type('cpu')`` asked for the CPU.
    :param timeout: seconds for the whole run; also every collective's
        limit. On expiry the ranks are killed and ``TimeoutError`` raised.
    :param args: arguments of ``fn``.
    :param num_threads: if given, ``torch.set_num_threads`` in each rank.
    :param rendezvous: a file path (it must not exist yet; removed after),
        or a ``tcp://host:port`` URL; defaults to a fresh file in a
        temporary directory.
    """
    if device_type is None:
        device_type = get_default_device().type
    if backend is None:
        backend = 'nccl' if device_type == 'cuda' else 'gloo'
    if device_type not in ('cpu', 'cuda'):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', got {device_type!r}")
    if backend == 'nccl' and nprocs > torch.cuda.device_count():
        raise ValueError(f"NCCL needs one card per rank: {nprocs} ranks, {torch.cuda.device_count()} cards")
    tmpdir = None
    if rendezvous is None:
        tmpdir = tempfile.mkdtemp(prefix='ndtt_rdzv_')
        rendezvous = os.path.join(tmpdir, 'rendezvous')
    init_method = rendezvous if rendezvous.startswith('tcp://') else 'file://' + os.path.abspath(rendezvous)
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(fn, args, rank, nprocs, backend, device_type, init_method,
                                                   timeout, num_threads, results))
             for rank in range(nprocs)]
    deadline = time.monotonic() + timeout
    outs = {}
    try:
        for p in procs:
            p.start()
        while len(outs) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch: ranks {sorted(set(range(nprocs)) - set(outs))} did not finish "
                                   f"within {timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in outs and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"launch: rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                       f"before reporting")
                continue
            if not ok:
                raise RuntimeError(_failures(results, {rank: out}, nprocs))
            outs[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        _stop(procs)
        results.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
        elif not init_method.startswith('tcp://') and os.path.exists(rendezvous):
            os.remove(rendezvous)
    return [outs[r] for r in range(nprocs)]
