'''NewtonNet parameter tree as nn.Modules.

The module and parameter names follow the JAX package's flax tree one to
one (`node_embedding`, `interaction_{i}.message_nodepart.TorchLinear_0.
kernel`, ..., `energy_head.TorchLinear_2.bias`, `scaler_energy.scale`,
`charge_head...`, `scaler_charge...`), and
every kernel keeps flax's `x @ kernel` (in, out) layout, so a checkpoint
maps across without transposes (utils/params.py).

Initialization follows the flax one (torch's nn.Linear default): every
kernel and bias is U(+-1/sqrt(fan_in)); the embedding is N(0, 1) with the
padding row 0 zeroed; scale starts at ones and shift at zeros, as do a
layer norm's scale and bias; `bessel_frequencies` (trainable_basis) starts
at the fixed k*pi grid. Random draws come from the `generator` passed in.

The MLPs apply the configured activation between their layers; with
`swiglu`, which halves the width, each layer after an activation takes
half the features (flax infers that fan-in from its input).

These modules hold parameters; the forward computation over them lives in
models/fused_stack.py and models/fused_klist.py (kernel='pallas') and
models/xla_stack.py (kernel='xla').
'''
import math

import torch
from torch import nn

from newtonnet_tpu_torch.layers.activations import (
    WIDTH_DIVISOR,
    get_activation_by_string,
)

N_ELEMENTS = 119


def _uniform(shape, bound, generator, device, dtype):
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.uniform_(-bound, bound, generator=generator)


class TorchLinear(nn.Module):
    '''`x @ kernel (+ bias)` with kernel (fan_in, features).'''

    def __init__(self, fan_in, features, use_bias=True, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        bound = 1.0 / fan_in ** 0.5
        self.kernel = nn.Parameter(_uniform((fan_in, features), bound,
                                            generator, device, dtype))
        self.bias = (nn.Parameter(_uniform((features,), bound, generator,
                                           device, dtype))
                     if use_bias else None)

    def forward(self, x):
        # the parameters in x's dtype, as flax's x @ kernel.astype(x.dtype)
        y = x @ self.kernel.to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)


class MLP(nn.Module):
    '''TorchLinear_0, TorchLinear_1, ... with the activation named
    `activation` between them (not after the last).'''

    def __init__(self, fan_in, features, activation='swish', use_bias=True,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.activation = get_activation_by_string(activation)
        shrink = WIDTH_DIVISOR.get(activation, 1)
        for i, f in enumerate(features):
            self.add_module(f'TorchLinear_{i}', TorchLinear(
                fan_in, f, use_bias, generator, device, dtype))
            fan_in = f // shrink

    def forward(self, x):
        for i, layer in enumerate(self.children()):
            if i > 0:
                x = self.activation(x)
            x = layer(x)
        return x


class ScaleShift(nn.Module):
    '''Per-element (Z-indexed) scale and shift, each (119, 1); with
    use_shift False the shift is None (the direct-force scaler has a scale
    alone, as the JAX package's SCALER_CONFIG gives it).'''

    def __init__(self, use_shift=True, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((N_ELEMENTS, 1), device=device,
                                             dtype=dtype))
        self.shift = (nn.Parameter(torch.zeros((N_ELEMENTS, 1),
                                               device=device, dtype=dtype))
                      if use_shift else None)

    def forward(self, output, z):
        output = output * self.scale[z, 0][..., None]
        if self.shift is None:
            return output
        return output + self.shift[z, 0][..., None]


class LayerNorm(nn.Module):
    '''flax nn.LayerNorm over the last axis (epsilon 1e-5): statistics in at
    least float32 with the fast variance E[x^2] - E[x]^2 (clipped at 0),
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias, returned in the
    promotion of x's dtype and the parameters' (float32 for a bf16 x, as
    flax gives it).'''

    def __init__(self, features, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device,
                                             dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, device=device,
                                             dtype=dtype))

    def forward(self, x):
        stat = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(stat)
        mean = xs.mean(-1, keepdim=True)
        var = torch.clamp((xs * xs).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.to(stat)
        y = (xs - mean) * mul + self.bias.to(stat)
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))


class InteractionNet(nn.Module):
    '''Parameters of one message-passing layer: message_nodepart (2-layer
    biased MLP), message_edgepart (R -> F), equiv_message1/2 (2-layer
    bias-free MLPs), equiv_update (F -> F) and, with layer_norm, a
    LayerNorm over the atom features.'''

    def __init__(self, n_features, n_basis, activation='swish',
                 layer_norm=False, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        f = n_features
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.message_nodepart = MLP(f, [f, f], activation, **kw)
        self.message_edgepart = TorchLinear(n_basis, f, use_bias=False, **kw)
        self.equiv_message1 = MLP(f, [f, f], activation, use_bias=False,
                                  **kw)
        self.equiv_message2 = MLP(f, [f, f], activation, use_bias=False,
                                  **kw)
        self.equiv_update = TorchLinear(f, f, use_bias=False, **kw)
        if layer_norm:
            self.layer_norm = LayerNorm(f, device=device, dtype=dtype)


# the direct heads a core can carry, in the JAX core's order
HEADS = ('energy', 'charge', 'direct_force')


class NewtonNetCore(nn.Module):
    '''All parameters of the model: node_embedding, interaction_{i}, per
    head of `heads` (within HEADS) its MLP {key}_head (F -> F -> F -> 1;
    F -> F -> F -> F for direct_force) and its scaler_{key} (scale and
    shift; a scale alone for direct_force) and, with trainable_basis,
    bessel_frequencies (n_basis,). The JAX core builds the heads its
    model's outputs need (models/output.py there): a model of charges
    alone has no energy head.'''

    def __init__(self, n_features=128, n_basis=20, n_interactions=3,
                 activation='swish', layer_norm=False, trainable_basis=False,
                 heads=('energy',), generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.n_features = n_features
        self.n_basis = n_basis
        self.n_interactions = n_interactions
        kw = dict(generator=generator, device=device, dtype=dtype)
        emb = torch.empty((N_ELEMENTS, n_features), device=device,
                          dtype=dtype).normal_(generator=generator)
        emb[0] = 0.0
        self.node_embedding = nn.Parameter(emb)
        for i in range(n_interactions):
            self.add_module(f'interaction_{i}', InteractionNet(
                n_features, n_basis, activation, layer_norm, **kw))
        self.heads = tuple(k for k in HEADS if k in heads)
        for key in self.heads:
            # the direct-force head's F outputs weigh force_node's features
            direct = key == 'direct_force'
            self.add_module(f'{key}_head', MLP(
                n_features, [n_features, n_features,
                             n_features if direct else 1], activation, **kw))
            self.add_module(f'scaler_{key}', ScaleShift(
                not direct, device=device, dtype=dtype))
        if trainable_basis:
            self.bessel_frequencies = nn.Parameter(
                torch.arange(1, n_basis + 1, device=device, dtype=dtype)
                * math.pi)

    def interactions(self):
        return [getattr(self, f'interaction_{i}')
                for i in range(self.n_interactions)]
