'''NewtonNet energy in the kernel='xla' formulation: the JAX package's
NewtonNetCore.__call__ and InteractionNet.__call__ (models/newtonnet.py
there) with its default 'unroll' contractions, as plain PyTorch over the
parameter modules of models/newtonnet.py.

Graph layouts:

* dense: the (B, N, N) pair tensor of ops/neighbors.dense_graph, summed
  over the neighbour axis j = 2.
* neighbour lists, K-major: every per-edge tensor is (B, K, N, ...) and
  the sums run over the slot axis 1. The neighbour features come from
  gather_nodes on a plain full list (built here, or given as (idx, mask)),
  whose backward sums over the list's transpose in a fixed order; or, for
  an inverse_lists model given the 4-tuple (idx, mask, inv, inv_mask) of
  symmetric-slotted lists (md/driver.host_symmetric_nlist), from
  inv_gather, whose backward is inv_scatter_sum. All of them run through
  the row gather (kernel K9 on the card), so no scatter-add runs and a
  request repeats its bits. An inverse_lists model given a plain (idx,
  mask) list, or none, falls back to the plain gather, as the JAX package
  does.

Every layer after the first gathers [nodepart | force x|y|z] as one 4F-wide
row; the first sees force == 0, gathers nodepart alone and skips phi2.
compute_dtype 'bfloat16' gathers the neighbour rows in bf16 (rounded once,
before the gather: half the gather traffic) and runs everything else in
the positions' dtype, as the JAX package's stack computes on the CPU: XLA
elides the bf16 round trips that meet arithmetic (apply_core_xla).
Forces, virial and stress are autograd of the energy (models/output.py).
'''
from typing import Callable, NamedTuple, Optional

import torch

from newtonnet_tpu_torch.layers.representations import (
    polynomial_cutoff,
    radial_bessel,
    scaled_norm,
)
from newtonnet_tpu_torch.models.fused_klist import COMPUTE_DTYPES
from newtonnet_tpu_torch.ops.neighbors import dense_graph
from newtonnet_tpu_torch.ops.nlist import (
    gather_nodes,
    inv_gather,
    neighbor_list,
    node_transpose,
    recompute_displacements,
    recompute_displacements_kn,
)


class Edges(NamedTuple):
    '''The graph one layer sees. Dense: mask (B, N, N), dir (B, N, N, 3),
    rbf (B, N, N, R), gather None. K-major lists: mask (B, K, N), dir
    (B, K, N, 3), rbf (B, K, N, R) and gather: x (B, N, ...) -> (B, K, N,
    ...).'''
    mask: torch.Tensor
    dir: torch.Tensor
    rbf: torch.Tensor
    gather: Optional[Callable] = None


def _features(model, disp):
    '''(dir, rbf) of displacements (..., 3).'''
    core = model.core
    freqs = core.bessel_frequencies if model.trainable_basis else None
    dist, dir_ = scaled_norm(disp, model.cutoff)
    rbf = polynomial_cutoff(dist) * radial_bessel(dist, model.n_basis,
                                                  frequencies=freqs)
    return dir_, rbf


def dense_edges(model, z, pos, cell):
    disp, adj = dense_graph(pos, cell, z > 0, model.cutoff,
                            mic_mode=model.mic_mode)
    dir_, rbf = _features(model, disp)
    return Edges(mask=adj, dir=dir_, rbf=rbf)


def nlist_edges(model, z, pos, cell, nlist=None, plain=False):
    '''K-major list edges: from the inverse-list 4-tuple (inverse_lists
    models), from a plain (idx, mask) list, or from a plain full list built
    at pos. A given list is tightened to the cutoff at the current
    positions (a stale pair drops out).'''
    cut2 = model.cutoff * model.cutoff
    if nlist is not None and len(nlist) == 4 and model.inverse_lists:
        idx, kmask, inv, inv_mask = nlist
        idx_kn = idx.long().transpose(1, 2).contiguous()
        inv, inv_mask = inv.contiguous(), inv_mask.bool()
        disp = recompute_displacements_kn(pos, cell, idx_kn, inv, inv_mask,
                                          mic_mode=model.mic_mode,
                                          plain=plain)
        kmask = kmask.bool().transpose(1, 2) & \
            (torch.sum(disp * disp, dim=-1) < cut2)
        dir_, rbf = _features(model, disp)
        return Edges(mask=kmask, dir=dir_, rbf=rbf,
                     gather=lambda x: inv_gather(x, idx_kn, inv, inv_mask,
                                                 plain))
    if nlist is not None:
        idx, listed = nlist[0].long(), nlist[1].bool()
        disp = recompute_displacements(pos, cell, idx,
                                       mic_mode=model.mic_mode, mask=listed)
        kmask = listed & (torch.sum(disp * disp, dim=-1) < cut2)
    else:
        idx, listed, disp, _ = neighbor_list(pos, cell, z > 0, model.cutoff,
                                             model.k_max,
                                             mic_mode=model.mic_mode)
        kmask = listed
    dir_, rbf = _features(model, disp)
    idx_kn, listed_kn = idx.transpose(1, 2), listed.transpose(1, 2)
    tr = node_transpose(idx_kn, idx.shape[1], listed_kn)
    return Edges(mask=kmask.transpose(1, 2), dir=dir_.transpose(1, 2),
                 rbf=rbf.transpose(1, 2),
                 gather=lambda x: gather_nodes(x, idx_kn, listed_kn, tr))


def interaction(lp, atom_node, force_node, edges, first_layer, layer_norm,
                cd=None):
    '''One message-passing layer (InteractionNet.__call__, 'unroll'):
    atom_node (B, N, F) and force_node (B, N, 3, F) -> updated. With a
    compute dtype cd (bfloat16), the gathered neighbour rows travel in cd
    (rounded once, before the gather) and everything else runs in the
    features' dtype.'''
    f = atom_node.shape[-1]
    dense = edges.gather is None
    jaxis = 2 if dense else 1
    w = edges.mask[..., None].to(atom_node.dtype)

    def bcast_i(x):
        return x[:, :, None] if dense else x[:, None]

    def gather(x):
        return edges.gather(x) if cd is None else \
            edges.gather(x.to(cd)).to(atom_node.dtype)

    nodepart = lp.message_nodepart(atom_node)
    edgepart = lp.message_edgepart(edges.rbf)
    cat_j = None
    if dense:
        nodepart_j = nodepart[:, None]
    elif not first_layer:
        cat_j = gather(torch.cat(
            [nodepart] + [force_node[:, :, d] for d in range(3)], dim=-1))
        nodepart_j = cat_j[..., :f]
    else:
        nodepart_j = gather(nodepart)
    message = edgepart * bcast_i(nodepart) * nodepart_j * w
    atom_node = atom_node + torch.sum(message, dim=jaxis)

    phi1 = lp.equiv_message1(message) * w
    equiv = torch.stack([torch.sum(phi1 * edges.dir[..., d:d + 1], dim=jaxis)
                         for d in range(3)], dim=2)
    if not first_layer:
        phi2 = lp.equiv_message2(message) * w
        if dense:
            parts = [torch.sum(phi2 * force_node[:, None, :, d], dim=2)
                     for d in range(3)]
        else:
            parts = [torch.sum(phi2 * cat_j[..., (d + 1) * f:(d + 2) * f],
                               dim=jaxis) for d in range(3)]
        equiv = equiv + torch.stack(parts, dim=2)
    force_node = force_node + equiv
    update = lp.equiv_update(force_node)
    atom_node = atom_node + torch.sum(force_node * update, dim=2)
    if layer_norm:
        atom_node = lp.layer_norm(atom_node)
    return atom_node, force_node


def apply_core_xla(model, z, pos, cell, nlist=None, plain=False):
    '''Primal forward: {atom_node (B,N,F), force_node (B,N,3,F),
    atomic_energy (B,N,1)}. plain=True runs the inverse-list gathers
    through the plain row gather (the same numbers as K9, bit for bit).'''
    core = model.core
    z = z.long()
    B, N = z.shape
    fmask = (z > 0).to(pos.dtype)[..., None]
    atom_node = core.node_embedding[z].to(pos.dtype) * fmask
    force_node = torch.zeros((B, N, 3, core.n_features), dtype=pos.dtype,
                             device=pos.device)
    if model.graph_mode == 'dense':
        edges = dense_edges(model, z, pos, cell)
    else:
        edges = nlist_edges(model, z, pos, cell, nlist, plain)
    # compute_dtype: the JAX package casts the stack's inputs to it
    # (models/newtonnet.py:769-794), but XLA on the CPU elides every
    # fp32 -> bf16 -> fp32 round trip that meets an arithmetic op (its excess
    # precision); what stays rounded are the bf16 rows that data movement
    # carries, the neighbour gathers. So does the port's stack.
    cd = COMPUTE_DTYPES[model.compute_dtype]
    for i, lp in enumerate(core.interactions()):
        atom_node, force_node = interaction(lp, atom_node, force_node, edges,
                                            i == 0, model.layer_norm, cd)
    e = core.scaler_energy(core.energy_head(atom_node), z)
    return {'atom_node': atom_node, 'force_node': force_node,
            'atomic_energy': e * fmask}
