'''Parameter gradients for energy + gradient-force training, first order
only (the JAX package's train/fastgrad.py, kernel='pallas': the dense
branch and the neighbour-list one).

A loss L(E, F) of the energies and the forces F = -dE/dpos needs, taken
directly, the gradient of a gradient. The chain rule gives the same
parameter gradient as one of a first-order surrogate:

    dL/dtheta = d/dtheta [ e_bar . E(theta) + sum D_v E(theta) ],
    e_bar = dL/dE,  v = -dL/dF  (both held constant),

where D_v E is the derivative of the energies along the position tangent
v. So a step is: the energies and forces (K1 forward, K2 backward, with
the parameters held constant), e_bar and v from autograd of the loss over
the predictions, the geometry's tangent along v, and one reverse pass over
the dual-number energy (K3 forward, K4 backward). With neighbour lists
the same steps run over models/fused_klist.py: K5/K6 for the forces, K7/K8
for the dual. No pass differentiates through another one.
'''
import torch

from newtonnet_tpu_torch.models.fused_klist import (
    apply_core_nlist,
    dual_energy_nlist,
    resolve_nlist,
)
from newtonnet_tpu_torch.models.fused_stack import (
    core_from_geom,
    dual_energy_from_geom,
    geometry,
    geometry_tangent,
)
from newtonnet_tpu_torch.models.output import constant_parameters

# prediction keys whose parameter dependence this path accounts for
SUPPORTED_KEYS = frozenset({'energy', 'gradient_force'})


def supports(losses):
    '''True if the configured loss keys only touch energy/gradient_force.'''
    return losses is not None and set(losses) <= SUPPORTED_KEYS


def refuse_unported_kernel(kernel):
    '''Training runs the fused kernels' first-order surrogate: only
    kernel='pallas' models train so far.'''
    if kernel != 'pallas':
        raise NotImplementedError(
            f'training kernel={kernel!r} models is not ported yet '
            '(ROADMAP.md A, "XLA training"); kernel=\'pallas\' models '
            'train')


def _forces(model, z, pos, cell, pair_op=None, nlist=None):
    '''Energies (B,) and forces (B, N, 3) with every parameter held
    constant, as the JAX package closes over them: K2 (K6) then computes no
    weight cotangents. The strain displacement is left out: it is the
    identity here, and pos @ I == pos exactly.'''
    with torch.enable_grad(), constant_parameters(model.core):
        pos = pos.detach().requires_grad_(True)
        if model.graph_mode == 'neighborlist':
            out = apply_core_nlist(model, z, pos, cell, nlist=nlist,
                                   pair_op=pair_op)
        else:
            adj, dir_t, rbf = geometry(z, pos, cell, model.cutoff,
                                       model.n_basis, model.mic_mode)
            out = core_from_geom(model.core, z, adj, dir_t, rbf,
                                 pair_op=pair_op)
        energy = out['atomic_energy'][..., 0].sum(-1)
        (dpos,) = torch.autograd.grad(energy.sum(), pos)
    return energy.detach(), -dpos


def value_and_grad(model, main_loss, batch, pair_op=None, dual_op=None,
                   nlist=None):
    '''The loss of one batch and its parameter gradient.

    Args:
        model: models.output.NewtonNet with kernel='pallas', dense or
            neighbour-list graph.
        main_loss: from train.loss.get_loss_by_string; must read only
            preds['energy'] / preds['gradient_force'].
        batch: dict of tensors on the model's device: z, pos, cell and the
            labels main_loss reads.
        pair_op, dual_op: the pair layer of the force pass and its dual
            (default: the fused ops, K1/K2 and K3/K4 on the card, or K5/K6
            and K7/K8 with neighbour lists). The plain path passes
            pair_interaction_fwd_ref and fused_pair_interaction_dual with
            plain=True, or fused_klist_interaction(_dual) with plain=True.
        nlist: optional precomputed (idx, mask) neighbour lists (neighbour
            lists only); None builds one at the batch's positions, shared
            by the force pass and the dual.

    Returns (loss, preds): the loss as a 0-d tensor and the detached
    predictions {'energy': (B,), 'gradient_force': (B, N, 3)}. The gradient
    is left in each parameter's .grad (parameters with requires_grad
    False get none).'''
    refuse_unported_kernel(model.kernel)
    z, pos, cell = batch['z'], batch['pos'], batch['cell']
    klist = model.graph_mode == 'neighborlist'
    if klist:
        nlist = resolve_nlist(model, z, pos, cell, nlist)
    energy, forces = _forces(model, z, pos, cell, pair_op, nlist)

    with torch.enable_grad():
        preds = {'energy': energy.requires_grad_(True),
                 'gradient_force': forces.requires_grad_(True)}
        loss = main_loss(preds, batch)
        e_bar, f_bar = torch.autograd.grad(
            loss, (preds['energy'], preds['gradient_force']))
        params = [p for p in model.core.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        if klist:
            # the K-list duals compute in pallas_dot_dtype (float32), not
            # pallas_grad_dot_dtype, as the JAX package's do
            evec, tangent = dual_energy_nlist(model, z, pos, cell, -f_bar,
                                              nlist=nlist, dual_op=dual_op)
        else:
            adj, dir_t, rbf, dirdot, rbfdot = geometry_tangent(
                z, pos, cell, -f_bar, model.cutoff, model.n_basis,
                model.mic_mode)
            evec, tangent = dual_energy_from_geom(
                model.core, z, adj, dir_t, rbf, dirdot, rbfdot,
                dot_dtype=model.pallas_grad_dot_dtype, pair_op=dual_op)
        surrogate = torch.dot(e_bar, evec) + tangent.sum()
        if params:
            surrogate.backward()
    return loss.detach(), {k: v.detach() for k, v in preds.items()}
