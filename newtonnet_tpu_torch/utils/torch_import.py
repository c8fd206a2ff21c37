'''Import the reference's (PyTorch) NewtonNet checkpoints into the port
(the JAX package's `utils/torch_import.py`).

The reference saves whole pickled nn.Modules. Those pickles resolve classes
from the `newtonnet` package, whose modules import torch_geometric and les
at import time, which neither machine has. Shim modules registered in
sys.modules before unpickling resolve each class reference to an empty
nn.Module subclass whose state (the parameter tree included) restores as
it was saved. The state_dict then maps onto the flax-named tree that
utils/params.params_from_flax loads: torch Linear weights (out, in) become
kernels (in, out), the JAX package's layout and the port's.

Used by the calculator (a `.pt` model path), the training CLI's `.pt` warm
start, `utils/export_model.py` and utils/ase_interface.py.
'''
import sys
import types

import numpy as np

_SHIM_MODULES = [
    'newtonnet', 'newtonnet.models', 'newtonnet.models.newtonnet',
    'newtonnet.models.output', 'newtonnet.layers',
    'newtonnet.layers.representations', 'newtonnet.layers.activations',
    'newtonnet.layers.scalers', 'newtonnet.layers.cutoff',
    'newtonnet.layers.shells', 'newtonnet.layers.dense',
    'newtonnet.layers.embedding', 'newtonnet.layers.batchrenorm',
    'newtonnet.data', 'newtonnet.data.neighbors',
]


def _install_shims():
    import torch.nn as nn

    class _Shim(nn.Module):
        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)

    def getattr_factory(mod):
        def _getattr(name):
            if name.startswith('__'):
                # never fabricate dunders (__file__, __path__, ...):
                # inspect and importlib probe modules for them
                raise AttributeError(name)
            cls = type(name, (_Shim,), {})
            cls.__module__ = mod.__name__
            setattr(mod, name, cls)
            return cls
        return _getattr

    for name in _SHIM_MODULES:
        if name in sys.modules and not hasattr(sys.modules[name],
                                               '_newtonnet_tpu_shim'):
            continue  # a real package is importable; leave it alone
        mod = types.ModuleType(name)
        # the JAX package's shims carry the same mark, so either importer
        # takes the other's shims over
        mod._newtonnet_tpu_shim = True
        mod.__getattr__ = getattr_factory(mod)
        sys.modules[name] = mod


def load_torch_pickle(path):
    '''Unpickle a reference checkpoint without the reference package.'''
    import torch
    _install_shims()
    return torch.load(path, weights_only=False, map_location='cpu')


def _np(t):
    return np.asarray(t.detach().cpu().numpy())


def _map_mlp(prefix, sd, n_layers, use_bias=True):
    out = {}
    for i in range(n_layers):
        layer = {'kernel': _np(sd[f'{prefix}.{2 * i}.weight']).T}
        if use_bias and f'{prefix}.{2 * i}.bias' in sd:
            layer['bias'] = _np(sd[f'{prefix}.{2 * i}.bias'])
        out[f'TorchLinear_{i}'] = layer
    return out


def _embedding_key(sd):
    # current schema: embedding_layers.*; archived v1 checkpoints:
    # embedding_layer.* -- the same math
    for k in ('embedding_layers.node_embedding.weight',
              'embedding_layer.node_embedding.weight'):
        if k in sd:
            return k
    raise KeyError('no node embedding found in checkpoint')


def convert_state_dict(sd, output_properties, n_interactions, layer_norm):
    '''Map a reference state_dict onto the flax-named parameter tree
    {'params': {...}} of numpy arrays (params_from_flax loads it).'''
    p = {'node_embedding': _np(sd[_embedding_key(sd)])}
    for i in range(n_interactions):
        pre = f'interaction_layers.{i}'
        block = {
            'message_nodepart': _map_mlp(f'{pre}.message_nodepart', sd, 2),
            'message_edgepart': {
                'kernel': _np(sd[f'{pre}.message_edgepart.weight']).T},
            'equiv_message1': _map_mlp(f'{pre}.equiv_message1', sd, 2,
                                       use_bias=False),
            'equiv_message2': _map_mlp(f'{pre}.equiv_message2', sd, 2,
                                       use_bias=False),
            'equiv_update': {
                'kernel': _np(sd[f'{pre}.equiv_update.weight']).T},
        }
        if layer_norm:
            block['layer_norm'] = {
                'scale': _np(sd[f'{pre}.layer_norm.weight']),
                'bias': _np(sd[f'{pre}.layer_norm.bias']),
            }
        p[f'interaction_{i}'] = block

    head_names = {'energy': 'energy_head', 'charge': 'charge_head',
                  'direct_force': 'direct_force_head'}
    for j, key in enumerate(output_properties):
        if key in head_names and f'output_layers.{j}.layers.0.weight' in sd:
            p[head_names[key]] = _map_mlp(f'output_layers.{j}.layers', sd, 3)
        scaler = {}
        if f'scalers.{j}.scale.weight' in sd:
            scaler['scale'] = _np(sd[f'scalers.{j}.scale.weight'])
        if f'scalers.{j}.shift.weight' in sd:
            scaler['shift'] = _np(sd[f'scalers.{j}.shift.weight'])
        if scaler:
            p[f'scaler_{key}'] = scaler
    return {'params': p}


def reference_config(m, sd):
    '''The NewtonNet constructor arguments of an unpickled reference module
    `m` with state_dict `sd`: widths from tensor shapes, the cutoff from
    the radius graph (or the old schema's norm), the outputs from
    output_properties (or the old schema's infer_properties); the
    activation is swish (the reference default, and the only one its
    shipped configs use).'''
    output_properties = list(getattr(m, 'output_properties', None)
                             or m.infer_properties)
    cutoff = 5.0
    for getter in (lambda: m.embedding_layers.edge_embedding.radius_graph.r,
                   lambda: m.embedding_layer.norm.r):
        try:
            cutoff = float(getter())
            break
        except AttributeError:
            continue
    return dict(
        cutoff=cutoff,
        n_features=int(sd[_embedding_key(sd)].shape[1]),
        n_basis=int(sd['interaction_layers.0.message_edgepart.weight']
                    .shape[1]),
        n_interactions=len({k.split('.')[1] for k in sd
                            if k.startswith('interaction_layers.')}),
        layer_norm=any('layer_norm' in k for k in sd),
        output_properties=output_properties)


def load_reference_params(path, mic_mode='reference'):
    '''A pickled reference checkpoint -> (NewtonNet constructor arguments,
    flax-named parameter tree of numpy arrays).'''
    m = load_torch_pickle(path)
    sd = m.state_dict()
    cfg = reference_config(m, sd)
    params = convert_state_dict(sd, cfg['output_properties'],
                                cfg['n_interactions'], cfg['layer_norm'])
    return dict(cfg, mic_mode=mic_mode), params


def load_reference_model(path, mic_mode='reference', device=None):
    '''Load a pickled reference checkpoint as a port NewtonNet, its weights
    loaded and frozen (the serving path, as utils/checkpoint.load_model).
    Runs on CUDA unless device='cpu' is passed.'''
    from newtonnet_tpu_torch.models.output import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_from_flax

    cfg, params = load_reference_params(path, mic_mode)
    model = NewtonNet(**cfg, device=device)
    params_from_flax(params, core=model.core)
    return model.requires_grad_(False).eval()
