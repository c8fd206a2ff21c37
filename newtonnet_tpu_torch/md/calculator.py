'''Single-system calculator: one request per `calculate` call.

Loads a checkpoint, pads the atom count up to a multiple of 8 (so a
molecule keeps one shape from call to call) and returns numpy results. A
neighbour-list model builds its list in every call, as the JAX package's
calculator does: a plain list on the device inside the model (nlist=None,
or the cell grid of a cell_grid model), or, for an inverse_lists or a
newton3 model, the symmetric-slotted or half lists of
md/driver.host_symmetric_nlist (device build, host colouring). A
newton3_compact checkpoint is served through the newton3 layout, with the
same parameters. A charge-head model in ewald_mode 'auto' is served by
its 'periodic' or 'aperiodic' clone (NewtonNet.with_ewald_mode, the same
parameters), chosen per request by the cell, as the JAX calculator
resolves it.

A list of checkpoints is an ensemble: every member is served as above and
the outputs that the first and the last member both give are averaged in
member order, as the JAX calculator averages them; the list is built once
per request, for the first member, and every member takes it.
'''
import numpy as np
import torch

from newtonnet_tpu_torch.layers.precision import (
    check_matmul_precision,
    fp32_matmuls,
    get_precision_by_string,
)
from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
from newtonnet_tpu_torch.models.output import NewtonNet
from newtonnet_tpu_torch.utils.checkpoint import load_model
from newtonnet_tpu_torch.utils.params import params_from_flax

# ASE result name -> model output property
PROPERTY_MAP = {
    'charges': 'charge',
    'bec': 'bec',
    'energy': 'energy',
    'free_energy': 'energy',
    'forces': 'gradient_force',
    'stress': 'stress',
    'virial': 'virial',
    'hessian': 'hessian',
}


def _round_up(x, m=8):
    return max(m, ((x + m - 1) // m) * m)


def _load_one(path, device):
    '''A member's model: a reference `.pt` pickle through
    utils/torch_import, any other path as a checkpoint of the JAX
    package's format.'''
    if str(path).endswith('.pt'):
        from newtonnet_tpu_torch.utils.torch_import import \
            load_reference_model
        return load_reference_model(path, device=device)
    return load_model(path, device=device)


class NewtonNetCalculator:
    '''Evaluate a trained model on one system per call.

    Args:
        model_path: .msgpack checkpoint of the JAX package or reference
            .pt pickle (utils/torch_import.py), or a list of them (an
            ensemble, averaged), or pass model= and params=, as the JAX
            calculator takes them.
        properties: ASE-style result names (default: charges, energy
            and forces where the model has them).
        precision: 'float32' (the kernels' type) or 'float64' (CPU only).
        model: with params, in place of model_path: a NewtonNet of this
            package, whose configuration the calculator serves.
        params: a flax-named tree {'params': {...}} of numpy arrays (the
            JAX package's parameters; utils/params.params_to_flax gives
            them for a port model), loaded into a copy of model.
        matmul_precision: 'highest' (or None): the port computes in IEEE
            fp32, which is what 'highest' asks of the JAX calculator; other
            values raise ValueError.
        device: CUDA unless 'cpu' is passed (default with model=: the
            model's device); raises with no CUDA device.
    '''

    def __init__(self, model_path=None, properties=None, precision='float32',
                 model=None, params=None, matmul_precision='highest',
                 device=None):
        check_matmul_precision(matmul_precision, 'matmul_precision')
        self.dtype = get_precision_by_string(precision)
        members = []
        if model_path is not None:
            paths = (model_path if isinstance(model_path, (list, tuple))
                     else [model_path])
            members = [_load_one(p, device) for p in paths]
            model = members[0]
        elif model is None or params is None:
            raise ValueError('need model_path or (model, params)')
        else:
            # in the serving precision, as the JAX calculator casts the
            # given parameters to it
            own = NewtonNet(**model.config_dict(),
                            device=device or model.device, dtype=self.dtype)
            params_from_flax(params, core=own.core)
            model = own.requires_grad_(False).eval()
            members = [model]
        if properties is None:
            inv = {'charge': 'charges', 'energy': 'energy',
                   'gradient_force': 'forces'}
            properties = [inv[k] for k in model.output_properties
                          if k in inv]
        unknown = set(properties) - set(PROPERTY_MAP)
        if unknown:
            raise ValueError(f'unknown properties {sorted(unknown)}')
        self.properties = list(properties)
        # derivative outputs reuse the trained parameters: extend the
        # first model's outputs with them, and every member's to the same
        # list; a head a checkpoint lacks would be untrained, and is
        # refused as the JAX calculator refuses it
        needed = {PROPERTY_MAP[p] for p in self.properties}
        missing = needed - set(model.output_properties)
        outputs = list(model.output_properties) + sorted(missing)
        self.members = [self._serving(m, outputs) for m in members]
        self.model = self.members[0]
        self.device = self.model.device
        # ewald_mode 'auto': both static clones, sharing the parameters
        self._by_periodicity = {
            periodic: [m.with_ewald_mode('periodic' if periodic
                                         else 'aperiodic')
                       for m in self.members]
            for periodic in (True, False)}

    def _serving(self, model, outputs):
        '''`model` as this calculator serves it: a newton3_compact
        checkpoint through the newton3 layout (the staircase layer creates
        the newton3 layer's parameters; single requests would otherwise
        change their chunk widths from geometry to geometry), with
        `outputs`, in the serving precision.'''
        cfg = model.config_dict()
        if model.newton3_compact:
            cfg.update(newton3_compact=False, newton3=True)
        if model.newton3_compact or outputs != model.output_properties:
            cfg['output_properties'] = outputs
            served = NewtonNet(**cfg, device=model.device, dtype=self.dtype)
            untrained = set(served.core.heads) - set(model.core.heads)
            if untrained:
                raise ValueError(
                    f'checkpoint has no trained head(s) for '
                    f'{sorted(untrained)}')
            served.load_state_dict(model.state_dict())
            model = served.requires_grad_(False).eval()
        return model.to(self.dtype)

    def models_for(self, cell):
        '''The members that serve a request with this cell (None or
        (3, 3)): the calculator's models, their ewald_mode resolved by
        whether the cell is nonzero.'''
        return self._by_periodicity[cell is not None
                                    and bool(np.any(np.asarray(cell)))]

    def model_for(self, cell):
        '''The first member of models_for(cell).'''
        return self.models_for(cell)[0]

    def calculate(self, system=None, numbers=None, positions=None,
                  cell=None):
        '''Run the model on one system: numbers (n,), positions (n, 3),
        optional cell (3, 3), or a System (md/system.py) as the first
        argument, which supplies all three; the JAX package's signature.
        Returns numpy results keyed by property: energy (float), forces
        (n, 3), stress (Voigt-6 xx yy zz yz xz xy), virial (3, 3), charges
        (n,), bec (n, 3, 3), hessian (n, 3, n, 3); an ensemble's mean.
        Matrix products run in IEEE fp32 (fp32_matmuls), the caller's TF32
        flags restored afterwards.'''
        if system is not None:
            numbers, positions, cell = (system.numbers, system.positions,
                                        system.cell)
        with fp32_matmuls():
            return self._calculate(numbers, positions, cell)

    def _calculate(self, numbers, positions, cell):
        numbers = np.asarray(numbers)
        n = len(numbers)
        n_pad = _round_up(n)
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        z = np.zeros((1, n_pad), dtype=np.int64)
        z[0, :n] = numbers
        pos = np.zeros((1, n_pad, 3), dtype=np_dtype)
        pos[0, :n] = positions
        c = np.zeros((1, 3, 3), dtype=np_dtype)
        if cell is not None:
            c[0] = cell
        z, pos, c = (torch.from_numpy(a).to(self.device)
                     for a in (z, pos, c))
        models = self.models_for(cell)
        nlist = None
        if (models[0].graph_mode == 'neighborlist'
                and (models[0].inverse_lists or models[0].newton3)):
            nlist = host_symmetric_nlist(models[0], z, pos, c, skin=0.0)
        outs = [m(z, pos, c, nlist=nlist) for m in models]
        out = outs[0]
        if len(outs) > 1:
            out = {k: sum(o[k] for o in outs) / len(outs)
                   for k in set(outs[0]) & set(outs[-1])}
        results = {}
        for prop in self.properties:
            v = out[PROPERTY_MAP[prop]].cpu().numpy()
            if prop in ('energy', 'free_energy'):
                results[prop] = float(v[0])
            elif prop in ('forces', 'charges', 'bec'):
                results[prop] = v[0, :n]
            elif prop == 'stress':
                s = v[0]
                results[prop] = s[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]]
            elif prop == 'virial':
                results[prop] = v[0]
            elif prop == 'hessian':
                results[prop] = v[0, :n, :, :n, :]
        return results
