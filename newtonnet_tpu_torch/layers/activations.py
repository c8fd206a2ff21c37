'''Activation registry: every string of the JAX package's
`layers/activations.py`, as PyTorch functions with its numbers.

Three details follow the JAX functions rather than PyTorch's defaults:
`gelu` is the tanh approximation (jax.nn.gelu's default), `softplus` is
log(1 + exp(x)) everywhere (jax.nn.softplus; F.softplus turns linear above
a threshold), and `swiglu` is the non-parametric gated split silu(x1) * x2
over the two halves of the last axis, which halves the width
(models/newtonnet.py sizes the next layer for it).
'''
import math

import torch
import torch.nn.functional as F

_LOG2 = math.log(2.0)


def softplus(x):
    '''log(1 + exp(x)), as jnp.logaddexp(x, 0).'''
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def shifted_softplus(x):
    '''softplus(x) - ln 2.'''
    return softplus(x) - _LOG2


def swiglu(x):
    '''silu(x1) * x2 over the two halves of the last axis.'''
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return F.silu(x1) * x2


_ACTIVATIONS = {
    'swish': F.silu,
    'silu': F.silu,
    'relu': F.relu,
    'elu': F.elu,
    'leaky_relu': lambda x: F.leaky_relu(x, negative_slope=0.01),
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'softplus': softplus,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),
    'ssp': shifted_softplus,
    'swiglu': swiglu,
}

# activations whose output is narrower than their input, by this factor
WIDTH_DIVISOR = {'swiglu': 2}


def get_activation_by_string(key):
    if key not in _ACTIVATIONS:
        raise NotImplementedError(
            f"The activation function '{key}' is unknown.")
    return _ACTIVATIONS[key]
