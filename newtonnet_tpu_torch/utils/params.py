'''Weights carried across between the JAX package's flax tree and the
port's modules. Names map one to one (models/newtonnet.py) and kernels
keep the (in, out) layout, so nothing is transposed.'''
import numpy as np
import torch

from newtonnet_tpu_torch.models.newtonnet import HEADS, NewtonNetCore


def _flatten(tree, prefix=''):
    for key, value in tree.items():
        name = f'{prefix}{key}'
        if isinstance(value, dict):
            yield from _flatten(value, name + '.')
        else:
            yield name, value


def params_from_flax(tree, core=None, device='cpu'):
    '''Load a flax `{'params': {...}}` tree of arrays into a NewtonNetCore.

    With core=None a core is built on `device` with the widths, the layer
    norms, the trainable basis and the heads (energy_head, charge_head)
    read from the tree (and the swish activation's layer widths). Raises
    if the names or shapes differ. Returns the core.'''
    p = tree['params']
    if core is None:
        n_int = sum(k.startswith('interaction_') for k in p)
        F = np.shape(p['node_embedding'])[1]
        R = np.shape(p['interaction_0']['message_edgepart']['kernel'])[0]
        core = NewtonNetCore(
            F, R, n_int, layer_norm='layer_norm' in p['interaction_0'],
            trainable_basis='bessel_frequencies' in p,
            heads=[k for k in HEADS if f'{k}_head' in p], device=device)
    flat = dict(_flatten(p))
    own = dict(core.named_parameters())
    if set(flat) != set(own):
        raise ValueError(
            f'parameter names differ: only in the tree '
            f'{sorted(set(flat) - set(own))}, only in the module '
            f'{sorted(set(own) - set(flat))}')
    with torch.no_grad():
        for name, value in flat.items():
            value = torch.as_tensor(np.array(value))
            if tuple(value.shape) != tuple(own[name].shape):
                raise ValueError(f'{name}: shape {tuple(value.shape)} vs '
                                 f'{tuple(own[name].shape)}')
            own[name].copy_(value)
    return core


def params_to_flax(core):
    '''The inverse of params_from_flax: a flax-style `{'params': {...}}`
    tree of numpy arrays.'''
    out = {}
    for name, param in core.named_parameters():
        node = out
        *path, leaf = name.split('.')
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = param.detach().cpu().numpy()
    return {'params': out}
