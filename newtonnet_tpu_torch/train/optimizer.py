'''Optimizers and learning-rate schedulers (the JAX package's
train/optimizer.py).

The optimizers follow optax's update rules and defaults, not torch.optim's:
optax.adam / adamw / rmsprop / sgd, with `clip_grad` as
optax.clip_by_global_norm in front (g * max_norm / ||g|| when ||g|| >=
max_norm, unchanged below it; torch's clip_grad_norm_ divides by
||g|| + 1e-6 instead). Where the defaults differ, optax's hold:
rmsprop decays at 0.9 (torch: 0.99), adamw's weight decay is 1e-4 (torch:
1e-2). The update is written by hand over the parameter tensors, in their
dtype, with the learning rate rounded to float32 as optax's injected
hyperparameter is. Parameters with requires_grad False (utils/freeze.py)
get no update and count nothing towards the clip norm; optax's masked
zeroing gives the same for adam, sgd and rmsprop, while optax's adamw
would still decay a frozen parameter.

The schedulers are plain Python state machines with torch.optim.lr_scheduler
semantics, identical to the JAX package's: the Trainer reads `.lr` and sets
it on the optimizer.
'''
import math

import numpy as np
import torch


class Optimizer:
    '''One of adam | adamw | rmsprop | sgd with optax's update rule over the
    named parameters it was built with. `lr` may be set between steps.'''

    def __init__(self, name, named_params, lr=1e-3, clip_grad=0.0, **kwargs):
        defaults = {
            'adam': dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
            'adamw': dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                          weight_decay=1e-4),
            'rmsprop': dict(decay=0.9, eps=1e-8, initial_scale=0.0,
                            eps_in_sqrt=True),
            'sgd': dict(momentum=None, nesterov=False),
        }
        if name not in defaults:
            raise ValueError(f'optimizer {name} is not supported')
        unknown = set(kwargs) - set(defaults[name])
        if unknown:
            raise TypeError(f'{name} got unexpected hyperparameters '
                            f'{sorted(unknown)}')
        self.name = name
        self.hp = {**defaults[name], **kwargs}
        self.params = dict(named_params)
        self.lr = lr
        self.clip_grad = clip_grad or 0.0
        self.count = 0
        self.state = {}
        if name in ('adam', 'adamw'):
            slots = ('mu', 'nu')
        elif name == 'rmsprop':
            slots = ('nu',)
        else:
            slots = ('trace',) if self.hp['momentum'] is not None else ()
        for slot in slots:
            fill = self.hp['initial_scale'] if name == 'rmsprop' else 0.0
            self.state[slot] = {n: torch.full_like(p, fill)
                                for n, p in self.params.items()}

    def _grads(self):
        return {n: p.grad for n, p in self.params.items()
                if p.requires_grad and p.grad is not None}

    def global_norm(self):
        '''The global L2 norm of the current gradients (before any clip),
        as optax.global_norm.'''
        grads = self._grads()
        if not grads:
            return torch.zeros(())
        return torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))

    @torch.no_grad()
    def step(self):
        '''One update from the parameters' .grad.'''
        grads = self._grads()
        if self.clip_grad > 0 and grads:
            norm = self.global_norm()
            grads = {n: torch.where(norm < self.clip_grad, g,
                                    (g / norm) * self.clip_grad)
                     for n, g in grads.items()}
        self.count += 1
        hp = self.hp
        neg_lr = -float(np.float32(self.lr))
        for n, g in grads.items():
            p = self.params[n]
            if self.name in ('adam', 'adamw'):
                mu, nu = self.state['mu'], self.state['nu']
                mu[n] = (1 - hp['b1']) * g + hp['b1'] * mu[n]
                nu[n] = (1 - hp['b2']) * (g * g) + hp['b2'] * nu[n]
                bc1 = float(np.float32(1 - hp['b1'] ** self.count))
                bc2 = float(np.float32(1 - hp['b2'] ** self.count))
                u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2 + hp['eps_root'])
                                     + hp['eps'])
                if self.name == 'adamw':
                    u = u + hp['weight_decay'] * p
            elif self.name == 'rmsprop':
                nu = self.state['nu']
                nu[n] = (1 - hp['decay']) * (g * g) + hp['decay'] * nu[n]
                u = (torch.rsqrt(nu[n] + hp['eps']) if hp['eps_in_sqrt']
                     else 1 / (torch.sqrt(nu[n]) + hp['eps'])) * g
            elif hp['momentum'] is None:
                u = g
            else:
                tr = self.state['trace']
                tr[n] = g + hp['momentum'] * tr[n]
                u = g + hp['momentum'] * tr[n] if hp['nesterov'] else tr[n]
            p.add_(neg_lr * u)

    def state_dict(self):
        '''{'count': int, slot: {name: ndarray}}: the layout train-state
        checkpoints store.'''
        out = {'count': self.count}
        for slot, tensors in self.state.items():
            out[slot] = {n: t.detach().cpu().numpy()
                         for n, t in tensors.items()}
        return out

    def load_state_dict(self, state):
        self.count = int(state['count'])
        for slot, tensors in self.state.items():
            for n, t in tensors.items():
                t.copy_(torch.as_tensor(np.array(state[slot][n])))


def get_optimizer_by_string(optimizer_name, params, clip_grad=0.0, **kwargs):
    '''Build the optimizer (the JAX package's get_optimizer_by_string).

    Args:
        optimizer_name: adam | sgd | rmsprop | adamw.
        params: an nn.Module (its named_parameters) or (name, tensor) pairs.
        clip_grad: global-norm clip (0 disables).
        kwargs: lr and the optimizer's optax hyperparameters.
    '''
    if isinstance(params, torch.nn.Module):
        params = params.named_parameters()
    lr = kwargs.pop('lr', 1e-3)
    return Optimizer(optimizer_name, params, lr=lr, clip_grad=clip_grad,
                     **kwargs)


class _SchedulerBase:
    '''Epoch-level scheduler: call step(metric) after each epoch; read .lr.'''

    def __init__(self, lr):
        self.lr = lr

    def step(self, metric=None):
        raise NotImplementedError

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, state):
        self.__dict__.update(state)

    @property
    def needs_metric(self):
        return False

    @property
    def per_step(self):
        '''True if step() advances per optimizer step (torch OneCycleLR
        semantics) rather than per epoch.'''
        return False

    @property
    def should_stop(self):
        return False


class ReduceLROnPlateau(_SchedulerBase):
    '''torch ReduceLROnPlateau semantics (factor, patience, min_lr,
    rel-threshold 1e-4), stepped on the validation loss
    (ref trainer.py:232-234); `should_stop` reproduces the reference's
    lr <= min_lr early-stop (ref trainer.py:253-255).'''

    def __init__(self, lr, factor=0.1, patience=10, min_lr=0.0,
                 threshold=1e-4, cooldown=0):
        super().__init__(lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.cooldown = cooldown
        self.best = math.inf
        self.num_bad = 0
        self.cooldown_counter = 0

    @property
    def needs_metric(self):
        return True

    def step(self, metric=None):
        if metric is None:
            return self.lr
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.lr

    @property
    def should_stop(self):
        return self.lr <= self.min_lr


class LambdaLR(_SchedulerBase):
    def __init__(self, lr, lr_lambda):
        super().__init__(lr)
        self.base_lr = lr
        # a lambda from the YAML config, evaluated as the JAX package does
        self.lr_lambda = (lr_lambda if callable(lr_lambda)
                          else eval(lr_lambda))  # noqa: S307
        self.epoch = 0

    def step(self, metric=None):
        self.epoch += 1
        self.lr = self.base_lr * self.lr_lambda(self.epoch)
        return self.lr

    def state_dict(self):
        d = dict(self.__dict__)
        d.pop('lr_lambda')
        return d


class LinearLR(_SchedulerBase):
    def __init__(self, lr, start_factor=1.0 / 3, end_factor=1.0,
                 total_iters=5):
        super().__init__(lr * start_factor)
        self.base_lr = lr
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters
        self.epoch = 0

    def step(self, metric=None):
        self.epoch += 1
        t = min(self.epoch, self.total_iters) / self.total_iters
        factor = self.start_factor + (self.end_factor - self.start_factor) * t
        self.lr = self.base_lr * factor
        return self.lr


class CosineAnnealingLR(_SchedulerBase):
    def __init__(self, lr, T_max, eta_min=0.0):
        super().__init__(lr)
        self.base_lr = lr
        self.T_max = T_max
        self.eta_min = eta_min
        self.epoch = 0

    def step(self, metric=None):
        self.epoch += 1
        self.lr = self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.epoch / self.T_max))
        return self.lr


class OneCycleLR(_SchedulerBase):
    '''torch OneCycleLR (anneal_strategy='cos', three_phase=False), stepped
    per *optimizer step* like torch (the Trainer detects `per_step` and
    advances this inside the batch loop instead of per epoch; ref
    optimizer.py:58-61 passes torch's class through, which is per-step).

    lr at step s (s = number of .step() calls since construction; torch
    calls step() once in its constructor, so lr starts at initial_lr):
      phase 1 (s <= pct_start*total_steps - 1): cos-anneal initial->max
      phase 2 (otherwise):                      cos-anneal max->min
    '''

    def __init__(self, lr, max_lr, total_steps, pct_start=0.3,
                 div_factor=25.0, final_div_factor=1e4):
        self.max_lr = max_lr
        self.total_steps = total_steps
        self.pct_start = pct_start
        self.initial_lr = max_lr / div_factor
        self.min_lr = self.initial_lr / final_div_factor
        self.last_step = 0
        super().__init__(self.lr_at(0))

    @property
    def per_step(self):
        return True

    @staticmethod
    def _anneal_cos(start, end, pct):
        # torch _annealing_cos: cosine interpolation from start to end
        return end + (start - end) / 2.0 * (1 + math.cos(math.pi * pct))

    def lr_at(self, step_num):
        '''Closed-form lr after `step_num` scheduler steps (torch-exact).'''
        phase1_end = self.pct_start * self.total_steps - 1
        phase2_end = self.total_steps - 1
        step_num = min(step_num, phase2_end)
        if step_num <= phase1_end and phase1_end > 0:
            pct = step_num / phase1_end
            return self._anneal_cos(self.initial_lr, self.max_lr, pct)
        denom = phase2_end - phase1_end
        pct = (step_num - phase1_end) / denom if denom > 0 else 1.0
        return self._anneal_cos(self.max_lr, self.min_lr, pct)

    def step(self, metric=None):
        self.last_step += 1
        self.lr = self.lr_at(self.last_step)
        return self.lr


class ChainedScheduler(_SchedulerBase):
    def __init__(self, schedulers):
        self.schedulers = schedulers
        super().__init__(schedulers[-1].lr)

    @property
    def needs_metric(self):
        return any(s.needs_metric for s in self.schedulers)

    @property
    def per_step(self):
        # torch ChainedScheduler steps all children together; a chain
        # containing a per-step member is stepped at batch granularity
        return any(s.per_step for s in self.schedulers)

    def step(self, metric=None):
        for s in self.schedulers:
            s.step(metric if s.needs_metric else None)
        self.lr = self.schedulers[-1].lr
        return self.lr

    @property
    def should_stop(self):
        return any(s.should_stop for s in self.schedulers)

    def state_dict(self):
        return {'schedulers': [s.state_dict() for s in self.schedulers],
                'lr': self.lr}

    def load_state_dict(self, state):
        for s, sd in zip(self.schedulers, state['schedulers']):
            s.load_state_dict(sd)
        self.lr = state['lr']


def get_scheduler_by_string(scheduler_list, lr):
    '''Build the (possibly chained) scheduler (ref optimizer.py:38-74).

    scheduler_list: iterable of (name, kwargs) pairs, e.g. the items() of
    the YAML `lr_scheduler` section.
    '''
    if scheduler_list is None:
        return None
    registry = {
        'plateau': ReduceLROnPlateau,
        'lambda': LambdaLR,
        'linear': LinearLR,
        'cosine': CosineAnnealingLR,
        'onecycle': OneCycleLR,
    }
    schedulers = []
    for name, kwargs in scheduler_list:
        if name not in registry:
            raise ValueError(f'scheduler {name} is not supported')
        schedulers.append(registry[name](lr, **(kwargs or {})))
    if len(schedulers) == 1:
        return schedulers[0]
    return ChainedScheduler(schedulers)
