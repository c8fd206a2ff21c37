'''Parameter gradients for energy + gradient-force training, first order
in the parameters (the JAX package's train/fastgrad.py: its kernel='pallas'
dense and neighbour-list branches, and its kernel='xla' branch).

A loss L(E, F) of the energies and the forces F = -dE/dpos needs, taken
directly, the gradient of a gradient. The chain rule gives the same
parameter gradient as one of a first-order surrogate:

    dL/dtheta = d/dtheta [ e_bar . E(theta) + sum D_v E(theta) ],
    e_bar = dL/dE,  v = -dL/dF  (both held constant),

where D_v E is the derivative of the energies along the position tangent
v. So a step is: the energies and forces (with the parameters held
constant), e_bar and v from autograd of the loss over the predictions,
D_v E, and one reverse pass over e_bar . E + D_v E.

* kernel='pallas': the forces through K1 forward and K2 backward (K5/K6
  with neighbour lists), D_v E as the hand-written dual-number energy (K3
  forward, K4 backward; K7/K8), over the geometry's tangent along v. No
  pass differentiates through another one.
* kernel='xla': D_v E is one forward-mode pass (torch.func.jvp) of the
  model's energies along v with the parameters live, and the reverse pass
  runs over it: reverse over forward. Every Function on the path has a
  jvp that reverse mode differentiates (ops/nlist.py: gather_nodes,
  inv_gather, inv_scatter_sum; their derivatives in every order are K9
  row gathers on the card). The dense graph is plain PyTorch.

Losses reading anything but energy and gradient_force (stress, virial)
train through the standard step of train/trainer.py instead.
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


def _energies(model, batch, pos, pair_op=None, nlist=None, plain=False):
    '''The energies (B,) at pos. The strain displacement is left out: it
    is the identity here, and pos @ I == pos exactly. kernel='xla': the
    model's own energies (NewtonNet._energy_and_aux), the latent Ewald
    energy of a charge head included, as the JAX package's fastgrad takes
    them.'''
    z, cell = batch['z'], batch['cell']
    if model.kernel == 'xla':
        return model._energy_and_aux(z, pos, None, cell, nlist=nlist,
                                     plain=plain)[1]['energy']
    if model.graph_mode == 'neighborlist':
        out = apply_core_nlist(model, z, pos, cell, nlist=nlist,
                               pair_op=pair_op)
    else:
        adj, dir_t, rbf = geometry(z, pos, cell, model.cutoff, model.n_basis,
                                   model.mic_mode)
        out = core_from_geom(model.core, z, adj, dir_t, rbf, pair_op=pair_op,
                             dot_dtype=model.pallas_dot_dtype)
    return out['atomic_energy'][..., 0].sum(-1)


def _energy_tangent(model, batch, v, dual_op, nlist, plain):
    '''(E, D_v E), the energies and their derivative along the position
    tangent v, with the parameters live.'''
    z, pos, cell = batch['z'], batch['pos'], batch['cell']
    if model.kernel == 'xla':
        # forward mode, so the step is reverse over forward (the JAX
        # package's fastgrad.py:114-118)
        return torch.func.jvp(
            lambda y: _energies(model, batch, y, nlist=nlist, plain=plain),
            (pos.detach(),), (v,))
    if model.graph_mode == 'neighborlist':
        # the K-list duals compute in pallas_dot_dtype, not
        # pallas_grad_dot_dtype, as the JAX package's do
        return dual_energy_nlist(model, z, pos, cell, v, nlist=nlist,
                                 dual_op=dual_op)
    adj, dir_t, rbf, dirdot, rbfdot = geometry_tangent(
        z, pos, cell, v, model.cutoff, model.n_basis, model.mic_mode)
    return dual_energy_from_geom(
        model.core, z, adj, dir_t, rbf, dirdot, rbfdot,
        dot_dtype=model.pallas_grad_dot_dtype, pair_op=dual_op)


def value_and_grad(model, main_loss, batch, pair_op=None, dual_op=None,
                   nlist=None, plain=False):
    '''The loss of one batch and its parameter gradient.

    Args:
        model: models.output.NewtonNet, kernel='pallas' (dense or
            neighbour-list graph) or kernel='xla' (dense, plain lists or
            inverse lists).
        main_loss: from train.loss.get_loss_by_string; must read only
            preds['energy'] / preds['gradient_force'].
        batch: dict of tensors on the model's device: z, pos, cell and the
            labels main_loss reads.
        pair_op, dual_op: kernel='pallas': the pair layer of the force pass
            and its dual (default: the fused ops, K1/K2 and K3/K4 on the
            card, or K5/K6 and K7/K8 with neighbour lists). The plain path
            passes pair_interaction_fwd_ref and fused_pair_interaction_dual
            with plain=True, or fused_klist_interaction(_dual) with
            plain=True.
        nlist: optional precomputed neighbour lists: (idx, mask) for a
            neighbour-list model, or for an inverse_lists model the 4-tuple
            of md/driver.host_symmetric_nlist; None builds a plain list at
            the batch's positions (kernel='pallas': one, shared by the
            force pass and the dual).
        plain: kernel='xla': the inverse-list gathers through the plain
            row gather instead of kernel K9.

    Returns (loss, preds): the loss as a 0-d tensor and the detached
    predictions {'energy': (B,), 'gradient_force': (B, N, 3)}. The gradient
    is left in each parameter's .grad (parameters with requires_grad
    False get none).'''
    if model.kernel == 'pallas' and model.graph_mode == 'neighborlist':
        nlist = resolve_nlist(model, batch['z'], batch['pos'], batch['cell'],
                              nlist)
    pos = batch['pos']
    # energies and forces with every parameter held constant, as the JAX
    # package closes over them: K2 (K6) then computes no weight cotangents
    with torch.enable_grad(), constant_parameters(model.core):
        x = pos.detach().requires_grad_(True)
        energy = _energies(model, batch, x, pair_op, nlist, plain)
        (dpos,) = torch.autograd.grad(energy.sum(), x)

    with torch.enable_grad():
        preds = {'energy': energy.detach().requires_grad_(True),
                 'gradient_force': (-dpos).requires_grad_(True)}
        loss = main_loss(preds, batch)
        # a loss that reads one of the two (energy alone) gives zeros for
        # the other, as jax.grad does
        e_bar, f_bar = [
            torch.zeros_like(x) if g is None else g
            for g, x in zip(torch.autograd.grad(
                loss, (preds['energy'], preds['gradient_force']),
                allow_unused=True),
                (preds['energy'], preds['gradient_force']))]
        params = [p for p in model.core.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        if params:
            evec, tangent = _energy_tangent(model, batch, -f_bar, dual_op,
                                            nlist, plain)
            (torch.dot(e_bar, evec) + tangent.sum()).backward()
    return loss.detach(), {k: v.detach() for k, v in preds.items()}
