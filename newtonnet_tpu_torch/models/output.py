'''User-facing NewtonNet: configuration, parameters and derivative heads.

The JAX package's `models/output.py`, every output: energy, charge,
direct_force, gradient_force, virial, stress, hessian and bec:

* kernel='xla' (the default, as there): the plain formulation of
  models/xla_stack.py, every activation, layer_norm, trainable_basis and
  compute_dtype, over the dense graph or neighbour lists: plain full
  lists (built by the O(N^2) search or, with cell_grid, the cell grid),
  reverse lists, the symmetric-slotted inverse lists of inverse_lists
  models, the half lists of newton3 models and the staircase chunks of
  newton3_compact models (the last three gather and sum through kernel
  K9);
* kernel='pallas': the fused pair ops, graph_mode='dense'
  (models/fused_stack.py, K1/K2) or 'neighborlist' (plain full lists,
  models/fused_klist.py, K5/K6), swish.

Forces, virial and stress are one autograd pass over the energy:

    forces = -dE/dpos, virial = -dE/d(displacement),
    stress = dE/d(displacement) / |det(cell)|,

where `displacement` is an identity-valued (B, 3, 3) strain applied
(symmetrized) to positions and cell before the graph is built.

A charge head (kernel='xla') gives latent charges q (B, N) and adds the
latent Ewald energy of ops/ewald.py to each graph's energy, evaluated at
the raw positions and cell as the JAX package evaluates it: it enters the
forces but not the virial or the stress. Born effective charges are

    Z*_{i,ab} = q_i delta_ab + sum_j r_{j,a} dq_j/dr_{i,b},

the contraction the JAX package takes after a per-graph Jacobian
(jax.jacrev, N reverse passes per graph), computed here as three reverse
passes of the charges, with the raw positions' a-th column as cotangent
(graphs are independent, so one pass serves the batch).

The direct-force head (kernel='xla') is a direct output of the core: an
MLP of atom_node weighing force_node's features (models/xla_stack.py).
The Hessian (kernel='xla') is forward over reverse, per graph, with
hessian_block lanes at a time (NewtonNet._hessian), through the vmap
rules of the list Functions (ops/nlist.py).

Serving holds the parameters constant and detaches the outputs; with
create_graph=True (kernel='xla') the outputs stay differentiable in the
parameters, for the standard training step (train/trainer.py), which
trains energy, force, direct-force, stress and virial losses.

kernel='pallas' takes pallas_dot_dtype 'float32' or 'bfloat16': the
products of K1/K2 (dense) and K5/K6 (neighbour lists) round their
operands to bf16 where the JAX package's Pallas kernels do
(ops/fused_dense.py, ops/fused_klist.py), and so do those of the K-list
duals K7/K8 that train such a model (train/fastgrad.py; the dense duals
K3/K4 take pallas_grad_dot_dtype).
'''
import contextlib
import copy
from typing import Sequence

import torch
from torch import nn

from newtonnet_tpu_torch.layers.precision import fp32_matmuls
from newtonnet_tpu_torch.models.fused_klist import COMPUTE_DTYPES, \
    apply_core_nlist
from newtonnet_tpu_torch.models.fused_stack import apply_core
from newtonnet_tpu_torch.models.newtonnet import HEADS, NewtonNetCore
from newtonnet_tpu_torch.models.xla_stack import apply_core_xla, \
    request_nlist
from newtonnet_tpu_torch.ops.ewald import ewald_energy
from newtonnet_tpu_torch.ops.fused_dense import DOT_DTYPES
from newtonnet_tpu_torch.ops.linalg3 import det3x3

DIRECT_PROPERTIES = ('energy', 'charge', 'direct_force')
DERIVATIVE_PROPERTIES = ('gradient_force', 'virial', 'stress')
SECOND_DERIVATIVE_PROPERTIES = ('hessian', 'bec')
ALL_PROPERTIES = (DIRECT_PROPERTIES + DERIVATIVE_PROPERTIES
                  + SECOND_DERIVATIVE_PROPERTIES)
SERVED_PROPERTIES = ('energy', 'gradient_force', 'virial', 'stress')


def resolve_device(device=None):
    '''The device an entry point runs on: `device` if given, else CUDA.
    Raises where there is no CUDA device and none was named: nothing runs
    on the CPU unless the caller asks for it.'''
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           'CPU')
    return torch.device('cuda')


@contextlib.contextmanager
def constant_parameters(module):
    '''Hold every parameter of `module` constant (requires_grad False)
    inside the block and restore the flags after it. Autograd then asks
    the fused backward (K2) for no weight cotangents: the JAX package's
    force pass closes over the parameters the same way.'''
    params = list(module.parameters())
    saved = [p.requires_grad for p in params]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, saved):
            p.requires_grad_(flag)


class NewtonNet(nn.Module):
    '''NewtonNet energy model with its derivative heads.

    Takes the JAX package's constructor arguments, defaults (kernel='xla')
    and validation, plus `device` (CUDA unless 'cpu' is passed), `dtype` of
    the parameters and a torch.Generator for their initialization.
    '''

    def __init__(
            self,
            cutoff: float = 5.0,
            n_features: int = 128,
            n_basis: int = 20,
            n_interactions: int = 3,
            activation: str = 'swish',
            layer_norm: bool = False,
            output_properties: Sequence[str] = (),
            mic_mode: str = 'exact',
            graph_mode: str = 'dense',
            k_max: int = 48,
            cell_grid: Sequence[int] = (),
            cell_capacity: int = 0,
            reverse_lists: bool = False,
            inverse_lists: bool = False,
            newton3: bool = False,
            newton3_compact: bool = False,
            compute_dtype: str = '',
            trainable_basis: bool = False,
            hessian_block: int = 0,
            ewald_sigma: float = 1.0,
            ewald_n_k: int = 8,
            ewald_mode: str = 'auto',
            kernel: str = 'xla',
            pallas_dot_dtype: str = 'float32',
            pallas_grad_dot_dtype: str = 'bfloat16',
            device=None,
            dtype=torch.float32,
            generator=None,
    ):
        super().__init__()
        for key in output_properties:
            if key not in ALL_PROPERTIES:
                raise NotImplementedError(
                    f'Output type {key} is not implemented yet')
        if newton3_compact and (newton3 or reverse_lists or inverse_lists
                                or graph_mode != 'neighborlist'
                                or kernel != 'xla'):
            raise ValueError(
                'newton3_compact is its own neighborlist edge layout '
                '(kernel=xla, no newton3/reverse_lists/inverse_lists)')
        bad = set(output_properties) & {'hessian', 'bec'}
        if newton3_compact and bad:
            raise ValueError(
                f'newton3_compact does not support {sorted(bad)}: '
                'their per-graph vmap wrappers unpack flat (idx, mask) '
                'nlists, not staircase chunk tuples -- use newton3 for '
                'those heads')
        if kernel not in ('xla', 'pallas'):
            raise ValueError(f'kernel must be xla or pallas, got {kernel}')
        if kernel == 'pallas':
            allowed = set(SERVED_PROPERTIES)
            bad = set(output_properties) - allowed
            if (bad or graph_mode not in ('dense', 'neighborlist')
                    or activation != 'swish' or layer_norm
                    or trainable_basis):
                raise ValueError(
                    'kernel=pallas supports the dense/neighborlist graph '
                    'modes with swish activation, no layer_norm/'
                    'trainable_basis, and outputs '
                    f'within {sorted(allowed)}; offending config: '
                    f'{sorted(bad) or [graph_mode, activation]}')
            if graph_mode == 'dense' and compute_dtype:
                raise ValueError(
                    'kernel=pallas (dense) does not take compute_dtype '
                    '(the fused kernels manage precision internally)')
            if graph_mode == 'neighborlist' and (newton3 or reverse_lists
                                                 or inverse_lists):
                raise ValueError(
                    'kernel=pallas neighborlist uses plain full lists '
                    '(newton3/reverse_lists/inverse_lists unsupported)')
        if kernel == 'xla' and graph_mode not in ('dense', 'neighborlist'):
            raise ValueError(f'unknown graph_mode {graph_mode}')
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f'compute_dtype must be one of '
                             f'{sorted(COMPUTE_DTYPES)}, got '
                             f'{compute_dtype!r}')
        if pallas_dot_dtype not in DOT_DTYPES:
            raise ValueError(f'pallas_dot_dtype must be one of {DOT_DTYPES}, '
                             f'got {pallas_dot_dtype!r}')

        self.output_properties = list(output_properties)
        self.cutoff = cutoff
        self.n_features = n_features
        self.n_basis = n_basis
        self.n_interactions = n_interactions
        self.activation = activation
        self.layer_norm = layer_norm
        self.mic_mode = mic_mode
        self.graph_mode = graph_mode
        self.k_max = k_max
        self.cell_grid = tuple(cell_grid)
        self.cell_capacity = cell_capacity
        self.reverse_lists = reverse_lists
        self.inverse_lists = inverse_lists
        self.newton3 = newton3
        self.newton3_compact = newton3_compact
        self.compute_dtype = compute_dtype
        self.trainable_basis = trainable_basis
        self.hessian_block = hessian_block
        self.ewald_sigma = ewald_sigma
        self.ewald_n_k = ewald_n_k
        self.ewald_mode = ewald_mode
        self.kernel = kernel
        self.pallas_dot_dtype = pallas_dot_dtype
        self.pallas_grad_dot_dtype = pallas_grad_dot_dtype
        needs = set(self.output_properties)
        # derivative heads need the energy, the BEC the charges
        if needs & set(DERIVATIVE_PROPERTIES) or 'hessian' in needs:
            needs.add('energy')
        if 'bec' in needs:
            needs.add('charge')
        self._needs = needs
        self.core = NewtonNetCore(n_features, n_basis, n_interactions,
                                  activation=activation,
                                  layer_norm=layer_norm,
                                  trainable_basis=trainable_basis,
                                  heads=[k for k in HEADS if k in needs],
                                  generator=generator,
                                  device=resolve_device(device), dtype=dtype)

    @property
    def device(self):
        return self.core.node_embedding.device

    def with_ewald_mode(self, mode):
        '''This model with ewald_mode resolved to 'periodic' or
        'aperiodic': one Ewald branch for every graph, where 'auto'
        computes both and picks per graph. The clone shares this model's
        core (the same modules and parameters; the Ewald sum has none).
        Returns self for a model without a charge head or with a static
        mode already; any other mode raises ValueError.'''
        if mode not in ('periodic', 'aperiodic'):
            raise ValueError(
                f"ewald mode must be 'periodic' or 'aperiodic', got {mode!r}")
        if not self.ewald_dispatches_at_runtime:
            return self
        clone = copy.copy(self)
        # its own module registry, holding the same core
        clone._modules = dict(self._modules)
        clone.ewald_mode = mode
        return clone

    @property
    def ewald_dispatches_at_runtime(self):
        '''True when the energy computes both Ewald branches (a charge head
        with ewald_mode 'auto'): callers that know the data's periodicity
        resolve it with with_ewald_mode.'''
        return 'charge' in self._needs and self.ewald_mode == 'auto'

    def config_dict(self):
        '''Serializable model config (the checkpoints' `config`).'''
        return {
            'cutoff': self.cutoff, 'n_features': self.n_features,
            'n_basis': self.n_basis, 'n_interactions': self.n_interactions,
            'activation': self.activation, 'layer_norm': self.layer_norm,
            'output_properties': list(self.output_properties),
            'mic_mode': self.mic_mode, 'graph_mode': self.graph_mode,
            'k_max': self.k_max, 'cell_grid': list(self.cell_grid),
            'cell_capacity': self.cell_capacity,
            'reverse_lists': self.reverse_lists,
            'inverse_lists': self.inverse_lists,
            'newton3': self.newton3,
            'newton3_compact': self.newton3_compact,
            'compute_dtype': self.compute_dtype,
            'trainable_basis': self.trainable_basis,
            'hessian_block': self.hessian_block,
            'ewald_sigma': self.ewald_sigma, 'ewald_n_k': self.ewald_n_k,
            'ewald_mode': self.ewald_mode, 'kernel': self.kernel,
            'pallas_dot_dtype': self.pallas_dot_dtype,
            'pallas_grad_dot_dtype': self.pallas_grad_dot_dtype,
        }

    def _energy_and_aux(self, z, pos, displacement, cell, pair_op=None,
                        nlist=None, plain=False):
        '''Total (summed over graphs) energy and the per-graph outputs, at
        positions and cell strained by the symmetrized displacement
        (displacement None: unstrained). With a charge head each graph's
        energy adds the latent Ewald energy at the raw pos and cell; a
        model without an energy head gives a total of 0.'''
        if displacement is None:
            pos_d, cell_d = pos, cell
        else:
            sym = 0.5 * (displacement + displacement.transpose(-1, -2))
            pos_d = torch.einsum('bni,bij->bnj', pos, sym)
            cell_d = torch.einsum('bxi,bij->bxj', cell, sym)
        if (pair_op is not None and self.kernel != 'pallas') or \
                (plain and self.kernel != 'xla'):
            raise ValueError('pair_op applies to kernel=pallas models, '
                             'plain to kernel=xla models')
        if self.kernel == 'xla':
            out = apply_core_xla(self, z, pos_d, cell_d, nlist=nlist,
                                 plain=plain)
        elif self.graph_mode == 'neighborlist':
            out = apply_core_nlist(self, z, pos_d, cell_d, nlist=nlist,
                                   pair_op=pair_op)
        else:
            out = apply_core(self.core, z, pos_d, cell_d, self.cutoff,
                             mic_mode=self.mic_mode, pair_op=pair_op,
                             dot_dtype=self.pallas_dot_dtype)
        if 'energy' not in self._needs:
            return torch.zeros((), dtype=pos.dtype, device=pos.device), out
        energy = torch.sum(out['atomic_energy'][..., 0], dim=-1)
        if 'charge' in self._needs:
            energy = energy + ewald_energy(
                out['charge'], pos, cell, z > 0, sigma=self.ewald_sigma,
                n_k=self.ewald_n_k, mode=self.ewald_mode)
        out['energy'] = energy
        return torch.sum(energy), out

    def forward(self, z, pos, cell, pair_op=None, nlist=None, plain=False,
                create_graph=False):
        '''Full forward pass.

        Args:
            z: (B, N) int atomic numbers, 0 = padding.
            pos: (B, N, 3) positions.
            cell: (B, 3, 3) lattice rows (all-zero = aperiodic).
            pair_op: kernel='pallas': the pair-interaction op of the graph
                mode (default: the fused kernels).
            nlist: optional precomputed (idx, mask) neighbour lists, each
                (B, N, K); for an inverse_lists or newton3 model
                (kernel='xla') the 4-tuple (idx, mask, inv, inv_mask) of
                md/driver.host_symmetric_nlist (a newton3 model needs
                it); for a reverse_lists model optionally the 4-tuple
                (idx, mask, rev, rev_mask); for a newton3_compact model
                the chunk tuple of ops/staircase.stair_nlist, with the
                frame in the staircase's atom order (graph_mode=
                'neighborlist' only; None builds a plain list at pos).
            plain: kernel='xla': run the inverse-list gathers through the
                plain row gather instead of kernel K9.
            create_graph: keep the graph through the parameters and the
                derivative outputs, so that a loss of the outputs can be
                differentiated in the parameters (the standard training
                step, reverse over reverse: the JAX package's model.apply
                under jax.value_and_grad). kernel='xla' only: the fused
                kernels are first order.

        Returns:
            dict with energy (B,), charge (B, N) and direct_force
            (B, N, 3) where the model has them, the configured derivative
            outputs (gradient_force (B, N, 3), virial/stress (B, 3, 3),
            hessian (B, N, 3, N, 3), bec (B, N, 3, 3)) and atom_node,
            force_node, atomic_energy; detached unless create_graph (bec
            and hessian always are: no loss reads them). Matrix
            products run in IEEE fp32 (fp32_matmuls), whatever TF32 flags
            the caller set, as the JAX package's calculator pins
            'highest'.
        '''
        if create_graph and self.kernel != 'xla':
            raise ValueError('create_graph needs a kernel=xla model: the '
                             'fused kernels are first order')
        with fp32_matmuls():
            return self._forward(z, pos, cell, pair_op, nlist, plain,
                                 create_graph)

    def _forward(self, z, pos, cell, pair_op, nlist, plain, create_graph):
        needs = self._needs
        need_grad = bool(needs & set(DERIVATIVE_PROPERTIES))
        bec = 'bec' in needs
        pos = pos.detach().requires_grad_(need_grad or bec)
        displacement = torch.eye(3, dtype=cell.dtype, device=cell.device) \
            .expand(cell.shape[0], 3, 3).clone().requires_grad_(need_grad)
        # serving holds the parameters constant and detaches the outputs:
        # no parameter cotangent is ever read
        held = contextlib.nullcontext() if create_graph else \
            constant_parameters(self.core)
        with torch.enable_grad(), held:
            total, out = self._energy_and_aux(z, pos, displacement, cell,
                                              pair_op, nlist, plain)
            if need_grad:
                pos_grad, disp_grad = torch.autograd.grad(
                    total, (pos, displacement), create_graph=create_graph,
                    retain_graph=create_graph or bec)
            if bec:
                born = self._bec(pos, out['charge'], keep=create_graph)
        outputs = out if create_graph else \
            {k: v.detach() for k, v in out.items()}
        if bec:
            outputs['bec'] = born
        if 'gradient_force' in needs:
            outputs['gradient_force'] = -pos_grad
        if 'virial' in needs:
            outputs['virial'] = -disp_grad
        if 'stress' in needs:
            volume = torch.abs(det3x3(cell))[:, None, None]
            outputs['stress'] = disp_grad / volume
        if 'hessian' in needs:
            outputs['hessian'] = self._hessian(z, pos.detach(), cell, nlist,
                                               plain)
        return outputs

    def _hessian(self, z, pos, cell, nlist=None, plain=False):
        '''Per-graph Hessian d2E/dpos2 (B, N, 3, N, 3), forward over
        reverse as the JAX package takes it (jax.jacfwd of jax.grad):
        torch.func.vmap over lanes of torch.func.jvp of torch.func.grad of
        the energy, with the parameters held constant and the list built
        once, outside the lanes (xla_stack.request_nlist).

        Graphs are independent, so one lane seeds the same position
        coordinate c in every graph and its jvp is column c of each
        graph's Hessian: there are 3N lanes whatever B, and no cross-graph
        blocks. hessian_block > 0 (below 3N) runs the lanes in blocks of
        that many one-hot seeds, built from indices (never the (3N, 3N)
        identity); the last block's lanes past 3N - 1 seed zero and are
        dropped. Under the vmap the list Functions fold a block's lanes
        into the batch axis (ops/nlist.py), so each gather of the block is
        one row gather (kernel K9 on the card) at L*B.'''
        B, N = pos.shape[:2]
        lanes = 3 * N
        block = int(self.hessian_block)
        if block <= 0 or block >= lanes:
            block = lanes
        nlist = request_nlist(self, z, pos, cell, nlist)

        def energy(p):
            return self._energy_and_aux(z, p, None, cell, nlist=nlist,
                                        plain=plain)[0]

        grad_fn = torch.func.grad(energy)

        def hvp(v):
            return torch.func.jvp(grad_fn, (pos,), (v,))[1]

        cols = torch.arange(lanes, device=pos.device)
        hess = torch.empty((lanes, B, N, 3), dtype=pos.dtype,
                           device=pos.device)
        with torch.no_grad(), constant_parameters(self.core):
            for k0 in range(0, lanes, block):
                lane = k0 + torch.arange(block, device=pos.device)
                seeds = (lane[:, None] == cols[None, :]).to(pos.dtype)
                seeds = seeds.reshape(block, 1, N, 3).expand(
                    block, B, N, 3).contiguous()
                rows = torch.func.vmap(hvp)(seeds)
                hess[k0:k0 + block] = rows[:lanes - k0]
        # hess[(i, a), b, j, d] = d grad[b, j, d] / d pos[b, i, a]
        return hess.reshape(N, 3, B, N, 3).permute(2, 3, 4, 0, 1) \
            .contiguous()

    @staticmethod
    def _bec(pos, charge, keep=False):
        '''Born effective charges (B, N, 3, 3) of charge (B, N) computed
        from pos (B, N, 3): q_i delta_ab + sum_j r_{j,a} dq_j/dr_{i,b},
        one reverse pass per a with the raw positions' column a as the
        charges' cotangent. keep: leave the graph for a later backward.'''
        r = pos.detach()
        rows = [torch.autograd.grad(charge, pos, grad_outputs=r[..., a],
                                    retain_graph=keep or a < 2,
                                    allow_unused=True)[0]
                for a in range(3)]
        rows = [torch.zeros_like(r) if g is None else g for g in rows]
        eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
        return charge.detach()[..., None, None] * eye + \
            torch.stack(rows, dim=-2)
