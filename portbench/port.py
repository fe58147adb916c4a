"""What the configurations' builders share: the port's FCNN loaded with
the harness's weights, and its Adam and schedule as a configuration
states them. This module and ``configs/*.py`` are the only parts of the
benchmark that import the port."""
import math

import torch

def fcnn(cfg, layers, device, dtype):
    """The port's ``FCNN`` of ``cfg`` holding ``layers = [(W (n_out, n_in), b), ...]``."""
    from neurodiffeq_tpu_torch.networks import FCNN, Tanh

    if cfg['activation'] != 'tanh':
        raise ValueError(f"unknown activation {cfg['activation']!r}")
    net = FCNN(n_input_units=cfg['n_input_units'], n_output_units=cfg['n_output_units'],
               hidden_units=tuple(cfg['hidden_units']), actv=Tanh, device=device, dtype=dtype)
    with torch.no_grad():
        for lin, (W, b) in zip(net.linears, layers):
            lin.weight.copy_(W)
            lin.bias.copy_(b)
    return net


def optimizer(cfg, params):
    opt = cfg['optimizer']
    if opt['name'] != 'Adam':
        raise ValueError(f"unknown optimizer {opt['name']!r}")
    return torch.optim.Adam(params, lr=opt['lr'], betas=tuple(opt['betas']), eps=opt['eps'])


def schedule_callbacks(cfg, opt):
    """The callbacks that step the configuration's schedule once per epoch
    (a ``LambdaLR``), none without one."""
    sched = cfg.get('lr_schedule')
    if sched is None:
        return []
    if sched['kind'] != 'cosine_anneal':
        raise ValueError(f"unknown schedule {sched['kind']!r}")
    a, steps = sched['alpha'], sched['steps']
    lam = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: a + (1 - a) * 0.5 * (1 + math.cos(math.pi * min(k, steps) / steps)))
    return [lambda solver: lam.step()]
