'''NewtonNet energy over neighbour lists through the fused K-list ops (the
JAX package's `models/pallas_klist.py`).

The same parameters, math and masking as the dense stack
(models/fused_stack.py), for graph_mode='neighborlist': every pair-tensor
operation runs inside the fused ops of ops/fused_klist.py (K5/K6, and the
dual K7/K8), and the neighbour features reach them through gather_nodes
(ops/nlist.py), whose backward sums onto the atoms over the list's
transpose in a fixed order (row gathers, K9 on the card), built once per
call and shared by every gather: a request repeats its bits. Per layer
device memory sees one gathered (B, N, K, C) edge tensor plus node-sized
tensors.

Entry points (both take a precomputed `nlist = (idx (B,N,K), mask)` or
build a plain full list when nlist is None):

* apply_core_nlist: the primal forward; forces, virial and stress are
  autograd of it (models/output.py).
* dual_energy_nlist: per-graph energies and their directional derivative
  along a position tangent, for the parameter gradient of force training
  (train/fastgrad.py).

Edge tensors (cat_j, rbf and their tangents) travel in model.compute_dtype
('' means the positions' dtype; 'bfloat16' halves their traffic); dir and
the node tensors stay in the positions' dtype.
'''
import torch

from newtonnet_tpu_torch.layers.representations import (
    polynomial_cutoff,
    radial_bessel,
    scaled_norm,
)
from newtonnet_tpu_torch.models.fused_stack import _mlp2_dual, _mlp3_dual
from newtonnet_tpu_torch.ops.fused_klist import (
    fused_klist_interaction,
    fused_klist_interaction_dual,
)
from newtonnet_tpu_torch.ops.nlist import (
    gather_nodes,
    neighbor_list,
    node_transpose,
    recompute_displacements,
)

COMPUTE_DTYPES = {'': None, 'float32': torch.float32,
                  'bfloat16': torch.bfloat16}


def edge_dtype(model, pos):
    '''The dtype of the gathered edge tensors.'''
    return COMPUTE_DTYPES[model.compute_dtype] or pos.dtype


def resolve_nlist(model, z, pos, cell, nlist=None):
    '''(idx (B,N,K) int64, kmask (B,N,K) bool): the given list, or a plain
    full list built at `pos` (the indices carry no gradient).'''
    if nlist is not None:
        return nlist[0].long(), nlist[1].bool()
    idx, kmask, _, _ = neighbor_list(pos.detach(), cell.detach(), z > 0,
                                     model.cutoff, model.k_max,
                                     mic_mode=model.mic_mode)
    return idx, kmask


def geometry(model, pos, cell, idx, kmask, tr):
    '''The edge mask, tightened at the current positions (a stale list
    keeps only the pairs still inside the cutoff), as a float (B, N, K),
    and the function x -> (dir (B,3,N,K), rbf (B,N,K,R)) of the positions,
    differentiable in them and in the cell. tr is the list's
    node_transpose.'''
    with torch.no_grad():
        disp0 = recompute_displacements(pos, cell, idx,
                                        mic_mode=model.mic_mode)
        d2 = torch.sum(disp0 * disp0, dim=-1)
        mask = (kmask & (d2 < model.cutoff * model.cutoff)).to(pos.dtype)

    def feats(x):
        disp = recompute_displacements(x, cell, idx, mic_mode=model.mic_mode,
                                       mask=kmask, transpose=tr)
        dist, dir_edge = scaled_norm(disp, model.cutoff)
        rbf = polynomial_cutoff(dist) * radial_bessel(dist, model.n_basis)
        return dir_edge.movedim(-1, 1).contiguous(), rbf.contiguous()

    return mask, feats


def _layer_weights(lp):
    return (lp.message_edgepart.kernel,
            lp.equiv_message1.TorchLinear_0.kernel,
            lp.equiv_message1.TorchLinear_1.kernel,
            lp.equiv_message2.TorchLinear_0.kernel,
            lp.equiv_message2.TorchLinear_1.kernel)


def _cat(np_, force_t, first):
    '''[np_ | force x|y|z] (B, N, 4F), or np_ alone at the first layer.'''
    if first:
        return np_
    return torch.cat([np_] + [force_t[:, d] for d in range(3)], dim=-1)


def apply_core_nlist(model, z, pos, cell, nlist=None, pair_op=None):
    '''Primal forward: {atom_node, force_node (B,N,3,F), atomic_energy}.
    pair_op defaults to the fused op (K5/K6 on the card);
    fused_klist_interaction with plain=True (ops/fused_klist.py) runs the
    same layer and backward as plain PyTorch ops. Its products run in the
    model's pallas_dot_dtype, as the JAX package's pallas_klist.py hands it
    to K5/K6.'''
    op = pair_op or fused_klist_interaction
    core = model.core
    z = z.long()
    B, N = z.shape
    dtype = pos.dtype
    edt = edge_dtype(model, pos)
    idx, kmask = resolve_nlist(model, z, pos, cell, nlist)
    tr = node_transpose(idx, N, kmask)
    mask, feats = geometry(model, pos, cell, idx, kmask, tr)
    dir_t, rbf = feats(pos)
    rbf = rbf.to(edt)

    fmask = (z > 0).to(dtype)[..., None]
    atom_node = core.node_embedding[z].to(dtype) * fmask
    force_t = torch.zeros((B, 3, N, core.n_features), dtype=dtype,
                          device=pos.device)
    for i, lp in enumerate(core.interactions()):
        np_ = lp.message_nodepart(atom_node)
        cat_j = gather_nodes(_cat(np_, force_t, i == 0).to(edt), idx, kmask,
                             tr)
        inv1, eq = op(np_, cat_j, rbf, dir_t, mask, *_layer_weights(lp),
                      first_layer=(i == 0),
                      dot_dtype=model.pallas_dot_dtype)
        atom_node = atom_node + inv1
        force_t = force_t + eq
        u = lp.equiv_update(force_t)
        atom_node = atom_node + torch.sum(force_t * u, dim=1)
    e = core.scaler_energy(core.energy_head(atom_node), z)
    return {'atom_node': atom_node,
            'force_node': force_t.movedim(1, 2),
            'atomic_energy': e * fmask}


def dual_energy_nlist(model, z, pos, cell, v, nlist=None, dual_op=None):
    '''Per-graph energies (B,) and their directional derivative along the
    position tangent v (B, N, 3), differentiable in the parameters. The
    geometry's tangent comes from one forward-mode pass (torch.func.jvp);
    the pair level goes through dual_op, by default the fused dual op
    (K7/K8 on the card; with plain=True its plain versions). Its products
    run in the model's pallas_dot_dtype, as the JAX package's
    pallas_klist.py hands it to K7/K8.'''
    op = dual_op or fused_klist_interaction_dual
    core = model.core
    z = z.long()
    B, N = z.shape
    dtype = pos.dtype
    edt = edge_dtype(model, pos)
    pos, v = pos.detach(), v.detach()
    idx, kmask = resolve_nlist(model, z, pos, cell, nlist)
    tr = node_transpose(idx, N, kmask)
    mask, feats = geometry(model, pos, cell, idx, kmask, tr)
    (dir_t, rbf), (dirdot_t, rbfdot) = torch.func.jvp(feats, (pos,), (v,))
    dirdot_t = dirdot_t.contiguous()
    rbf, rbfdot = rbf.to(edt), rbfdot.to(edt).contiguous()

    fmask = (z > 0).to(dtype)[..., None]
    atom_node = core.node_embedding[z].to(dtype) * fmask
    atomdot = torch.zeros_like(atom_node)
    force_t = torch.zeros((B, 3, N, core.n_features), dtype=dtype,
                          device=pos.device)
    forcedot_t = torch.zeros_like(force_t)
    for i, lp in enumerate(core.interactions()):
        first = i == 0
        np_, npdot = _mlp2_dual(lp.message_nodepart, atom_node, atomdot)
        cat_j = gather_nodes(_cat(np_, force_t, first).to(edt), idx, kmask,
                             tr)
        catdot_j = gather_nodes(_cat(npdot, forcedot_t, first).to(edt), idx,
                                kmask, tr)
        inv1, eq, inv1dot, eqdot = op(
            np_, npdot, cat_j, catdot_j, rbf, rbfdot, dir_t, dirdot_t, mask,
            *_layer_weights(lp), first_layer=first,
            dot_dtype=model.pallas_dot_dtype)
        atom_node = atom_node + inv1
        atomdot = atomdot + inv1dot
        force_t = force_t + eq
        forcedot_t = forcedot_t + eqdot
        ku = lp.equiv_update.kernel
        u = force_t @ ku
        udot = forcedot_t @ ku
        atom_node = atom_node + torch.sum(force_t * u, dim=1)
        atomdot = atomdot + torch.sum(forcedot_t * u + force_t * udot, dim=1)
    e, edot = _mlp3_dual(core.energy_head, atom_node, atomdot)
    scale = core.scaler_energy.scale[z, 0][..., None]
    shift = core.scaler_energy.shift[z, 0][..., None]
    e = (e * scale + shift) * fmask
    edot = edot * scale * fmask
    return e[..., 0].sum(-1), edot[..., 0].sum(-1)
