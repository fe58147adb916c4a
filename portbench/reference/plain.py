"""The plain reference shared by the configurations: an FCNN in plain
PyTorch, derivatives by ``torch.autograd``, the mean squared residual, and
Adam written out.

It imports nothing of the program. It takes the weights and points that the
harness made (a copy, in its own precision) and works everything else out
again: conditions, derivatives, residuals, loss, gradients and steps. Rows
go through in blocks, so that a batch of any size fits beside the graph of
its third derivatives.

The leaves come as the harness's flat list; a configuration's reference
turns them into what its ``residuals`` takes by its own ``unpack(cfg,
params)``, or by :func:`as_layers` (an FCNN's pairs) where it has none.
Only the trainable leaves (``trainable``, their indices) are differentiated
and stepped; the others stay as given.
"""
import math
from contextlib import contextmanager

import torch

ACTIVATIONS = {'tanh': torch.tanh, 'sin': torch.sin}


def mlp(layers, x, actv='tanh'):
    """``layers = [(W (n_out, n_in), b), ...]``; the activation between layers."""
    f = ACTIVATIONS[actv]
    for i, (W, b) in enumerate(layers):
        x = x @ W.t() + b
        if i + 1 < len(layers):
            x = f(x)
    return x


def d(u, x):
    """du/dx of a column ``u`` whose row i depends on row i of ``x`` alone."""
    return torch.autograd.grad(u, x, torch.ones_like(u), create_graph=True)[0]


def as_layers(params):
    return list(zip(params[0::2], params[1::2]))


def unpacker(problem):
    """The reference ``problem``'s ``unpack(cfg, params)``, or the FCNN's pairs."""
    return getattr(problem, 'unpack', None) or (lambda cfg, params: as_layers(params))


@contextmanager
def matmul_precision(tf32):
    """Matrix products in TF32 (``tf32``) or in full precision, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _blocks(n, block):
    return [(s, min(s + block, n)) for s in range(0, n, block)]


def residuals(problem, cfg, params, cols, block):
    """Each equation's residual at the points ``cols`` (``(N,)`` tensors), as
    ``(N,)`` tensors detached from the parameters."""
    out, unpack = None, unpacker(problem)
    for s, e in _blocks(cols[0].shape[0], block):
        xs = [c[s:e].reshape(-1, 1).detach().requires_grad_() for c in cols]
        with torch.enable_grad():
            rs = [r.detach().reshape(-1) for r in problem.residuals(cfg, unpack(cfg, params), *xs)]
        out = [[] for _ in rs] if out is None else out
        for acc, r in zip(out, rs):
            acc.append(r)
    return [torch.cat(parts) for parts in out]


def loss_and_grads(problem, cfg, params, cols, block, trainable):
    """The mean over points and equations of the squared residuals, and its
    gradient with respect to the leaves ``trainable`` of ``params``."""
    n, unpack = cols[0].shape[0], unpacker(problem)
    total, grads, n_eq = 0.0, [torch.zeros_like(params[i]) for i in trainable], None
    for s, e in _blocks(n, block):
        xs = [c[s:e].reshape(-1, 1).detach().requires_grad_() for c in cols]
        with torch.enable_grad():
            leaves = [p.detach() for p in params]
            for i in trainable:
                leaves[i].requires_grad_()
            rs = problem.residuals(cfg, unpack(cfg, leaves), *xs)
            n_eq = len(rs)
            sq = sum((r * r).sum() for r in rs)
            for acc, g in zip(grads, torch.autograd.grad(sq, [leaves[i] for i in trainable])):
                acc += g
        total = total + sq.detach()
    scale = 1.0 / (n * n_eq)
    return total * scale, [g * scale for g in grads]


def learning_rate(cfg, step):
    """The learning rate of ``step`` (0, 1, ...): the base rate, under the
    cosine anneal ``alpha + (1 - alpha) (1 + cos(pi min(k, S) / S)) / 2``
    where the configuration has one."""
    lr = cfg['optimizer']['lr']
    sched = cfg.get('lr_schedule')
    if sched is None:
        return lr
    if sched['kind'] != 'cosine_anneal':
        raise ValueError(f"unknown schedule {sched['kind']!r}")
    a, steps = sched['alpha'], sched['steps']
    return lr * (a + (1 - a) * 0.5 * (1 + math.cos(math.pi * min(step, steps) / steps)))


def train(problem, cfg, params, batches, block, trainable=None):
    """Adam (Kingma and Ba, as ``cfg['optimizer']`` sets it) over one batch a
    step, on the leaves ``trainable`` (default: all). Returns each step's
    loss, the first step's gradient of each trainable leaf, and every leaf
    after the last step."""
    opt = cfg['optimizer']
    if opt['name'] != 'Adam':
        raise ValueError(f"unknown optimizer {opt['name']!r}")
    b1, b2 = opt['betas']
    eps = opt['eps']
    params = [p.detach().clone() for p in params]
    trainable = list(range(len(params))) if trainable is None else list(trainable)
    m = [torch.zeros_like(params[i]) for i in trainable]
    v = [torch.zeros_like(params[i]) for i in trainable]
    losses, first_grads = [], None
    for k, cols in enumerate(batches):
        loss, grads = loss_and_grads(problem, cfg, params, cols, block, trainable)
        losses.append(float(loss))
        first_grads = grads if first_grads is None else first_grads
        t = k + 1
        step = learning_rate(cfg, k) / (1 - b1 ** t)
        for p, g, mk, vk in zip([params[i] for i in trainable], grads, m, v):
            mk.mul_(b1).add_(g, alpha=1 - b1)
            vk.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(mk, vk.sqrt() / math.sqrt(1 - b2 ** t) + eps, value=-step)
    return losses, first_grads, params
