'''Activation registry: every string of the JAX package's
`layers/activations.py`, as PyTorch functions with its numbers.

Three details follow the JAX functions rather than PyTorch's defaults:
`gelu` is the tanh approximation (jax.nn.gelu's default), `softplus` is
log(1 + exp(x)) everywhere (jax.nn.softplus; F.softplus turns linear above
a threshold), and `swiglu` is the non-parametric gated split silu(x1) * x2
over the two halves of the last axis, which halves the width
(models/newtonnet.py sizes the next layer for it).

bf16 inputs (the compute_dtype='bfloat16' stack) take the JAX primitives'
own decomposition, every step rounded to bf16 as the JAX program compiled
without excess precision rounds it, and their own derivative rules
(_BF16_RULES): silu is x * (1 / (1 + exp(-x))) with logistic's derivative
s * (1 - s), not F.silu's single rounding. Each such function is an
autograd Function whose backward and jvp are built from torch ops, so
every derivative order (the standard training step's reverse over
reverse, fastgrad's reverse over forward) differentiates on through them.
Float32 and float64 inputs keep the library functions.
'''
import functools
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

_LOG2 = math.log(2.0)


@functools.lru_cache(maxsize=None)
def _const(value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


def _c(x, value):
    '''A constant in x's dtype (a JAX weak-typed constant: rounded to the
    dtype before it meets x), made once per dtype and device: a fresh one
    on the card would be a host-to-device copy, a host sync, per call.'''
    return _const(value, x.dtype, x.device)


def _logistic(x):
    '''lax.logistic's lowering: 1 / (1 + exp(-x)), each step rounded.'''
    one = _c(x, 1.0)
    return one / (one + torch.exp(-x))


def _dlogistic(s):
    '''logistic's derivative rule at its output s: s * (1 - s).'''
    return s * (_c(s, 1.0) - s)


def _softplus_bf16(x):
    '''jnp.logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|)) (x where x - 0 is
    nan).'''
    out = torch.maximum(x, _c(x, 0.0)) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def _softplus_slope(x):
    '''logaddexp's jvp factor for its first operand: exp(x - out), with
    +inf read as 0 on both sides.'''
    def finite(v):
        return torch.where(v == float('inf'), torch.zeros_like(v), v)
    return torch.exp(finite(x) - finite(_softplus_bf16(x)))


_K_GELU = math.sqrt(2 / math.pi)


def _gelu_parts(x):
    '''jax.nn.gelu(approximate=True)'s intermediates: x**2, tanh(sqrt(2/pi)
    * (x + 0.044715 * x**3)) and cdf = 0.5 * (1 + tanh(...)).'''
    x2 = x * x
    th = torch.tanh(_c(x, _K_GELU) * (x + _c(x, 0.044715) * (x2 * x)))
    return x2, th, _c(x, 0.5) * (_c(x, 1.0) + th)


def _gelu_vjp(x, g):
    x2, th, cdf = _gelu_parts(x)
    h = _c(x, 0.5) * (x * g) * (_c(x, 1.0) - th)
    gb = _c(x, _K_GELU) * (h + h * th)
    return (g * cdf + gb) + (_c(x, 0.044715) * gb) * (_c(x, 3.0) * x2)


def _gelu_jvp(x, t):
    x2, th, cdf = _gelu_parts(x)
    tu = _c(x, _K_GELU) * (t + _c(x, 0.044715) * (t * (_c(x, 3.0) * x2)))
    tth = (tu + tu * th) * (_c(x, 1.0) - th)
    return t * cdf + x * (_c(x, 0.5) * tth)


class _Rule(NamedTuple):
    '''A bf16 activation: its forward, and its vjp (x, g) and jvp (x, t)
    in the order the JAX derivative rules round them.'''
    f: Callable
    vjp: Callable
    jvp: Callable


def _silu_vjp(x, g):
    s = _logistic(x)
    return g * s + (g * x) * _dlogistic(s)


def _silu_jvp(x, t):
    s = _logistic(x)
    return t * s + x * (t * _dlogistic(s))


def _tanh_vjp(x, g):
    y = torch.tanh(x)
    h = g * (_c(x, 1.0) - y)
    return h + h * y


def _tanh_jvp(x, t):
    y = torch.tanh(x)
    return (t + t * y) * (_c(x, 1.0) - y)


def _leaky(x):
    return torch.where(x >= 0, x, _c(x, 0.01) * x)


def _leaky_d(x, g):
    return torch.where(x >= 0, g, _c(x, 0.01) * g)


def _elu(x):
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x)))


def _elu_d(x, g):
    em1 = torch.expm1(torch.where(x > 0, 0.0, x))
    return torch.where(x > 0, g, g * (em1 + _c(x, 1.0)))


_BF16_RULES = {
    'silu': _Rule(lambda x: x * _logistic(x), _silu_vjp, _silu_jvp),
    'sigmoid': _Rule(_logistic, lambda x, g: g * _dlogistic(_logistic(x)),
                     lambda x, t: t * _dlogistic(_logistic(x))),
    'softplus': _Rule(_softplus_bf16, lambda x, g: g * _softplus_slope(x),
                      lambda x, t: t * _softplus_slope(x)),
    'tanh': _Rule(torch.tanh, _tanh_vjp, _tanh_jvp),
    'gelu': _Rule(lambda x: x * _gelu_parts(x)[2], _gelu_vjp, _gelu_jvp),
    'leaky_relu': _Rule(_leaky, _leaky_d, _leaky_d),
    'elu': _Rule(_elu, _elu_d, _elu_d),
}


class _Bf16Activation(torch.autograd.Function):
    '''apply(x, name): _BF16_RULES[name] with its own vjp and jvp.'''

    @staticmethod
    def forward(x, name):
        return _BF16_RULES[name].f(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, name = inputs
        ctx.save_for_backward(x)
        ctx.x, ctx.rule = x, _BF16_RULES[name]

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return ctx.rule.vjp(x, g), None

    @staticmethod
    def jvp(ctx, t, _):
        return ctx.rule.jvp(ctx.x, t)

    @staticmethod
    def vmap(info, in_dims, x, name):
        # elementwise: the rule runs on the batched tensor as it lies
        return _Bf16Activation.apply(x, name), in_dims[0]


def _rounded(name, library):
    '''`library` for float32/float64 inputs, the bf16 rule `name` for
    bf16 ones.'''
    def act(x):
        if x.dtype == torch.bfloat16:
            return _Bf16Activation.apply(x, name)
        return library(x)
    act.__name__ = name
    return act


silu = _rounded('silu', F.silu)
sigmoid = _rounded('sigmoid', torch.sigmoid)
tanh = _rounded('tanh', torch.tanh)
leaky_relu = _rounded('leaky_relu',
                      lambda x: F.leaky_relu(x, negative_slope=0.01))
elu = _rounded('elu', F.elu)


# log(1 + exp(x)), as jnp.logaddexp(x, 0)
softplus = _rounded('softplus', lambda x: torch.logaddexp(
    x, torch.zeros((), dtype=x.dtype, device=x.device)))


def shifted_softplus(x):
    '''softplus(x) - ln 2 (ln 2 rounded to x's dtype first, as JAX's
    weak-typed constant is).'''
    return softplus(x) - (_c(x, _LOG2) if x.dtype == torch.bfloat16
                          else _LOG2)


gelu = _rounded('gelu', lambda x: F.gelu(x, approximate='tanh'))


def swiglu(x):
    '''silu(x1) * x2 over the two halves of the last axis.'''
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return silu(x1) * x2


_ACTIVATIONS = {
    'swish': silu,
    'silu': silu,
    'relu': F.relu,
    'elu': elu,
    'leaky_relu': leaky_relu,
    'tanh': tanh,
    'sigmoid': sigmoid,
    'softplus': softplus,
    'gelu': gelu,
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
