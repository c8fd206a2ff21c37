'''NewtonNet energy in the kernel='xla' formulation: the JAX package's
NewtonNetCore.__call__ and InteractionNet.__call__ (models/newtonnet.py
there) with its default 'unroll' contractions, as plain PyTorch over the
parameter modules of models/newtonnet.py.

Graph layouts:

* dense: the (B, N, N) pair tensor of ops/neighbors.dense_graph, summed
  over the neighbour axis j = 2. Atom-sharded (graph parallelism,
  parallel/graph_parallel.py): the rows are this rank's block of atoms and
  the columns all of them (ops/neighbors.dense_graph_sharded), and each
  layer all-gathers the neighbour side's node features over the mesh's
  'graph' group (Edges.cols; the JAX package's InteractionNet.gather_cols,
  whose backward is the reduce-scatter).
* neighbour lists, K-major: every per-edge tensor is (B, K, N, ...) and
  the sums run over the slot axis 1. The neighbour features come from
  - gather_nodes on a plain full list (built here by neighbor_list, or by
    the cell grid of ops/cellgrid.py for a cell_grid model, or given as
    (idx, mask)), whose backward sums over the list's transpose in a
    fixed order;
  - edge_gather on a plain full list with its reverse list (reverse_lists:
    the 4-tuple (idx, mask, rev, rev_mask), or rev built here), whose
    backward is edge_pull and a sum over the slots;
  - inv_gather on the symmetric-slotted lists of an inverse_lists model,
    given as the 4-tuple (idx, mask, inv, inv_mask)
    (md/driver.host_symmetric_nlist), whose backward is inv_scatter_sum;
  - inv_gather on an oriented newton3 half list (the same 4-tuple from
    newton3_half_list and build_inverse_list). Each undirected edge is
    computed once, for its stored orientation, and its mirrored
    contribution onto the neighbour (+message, -phi1 * dir + phi2 * f_i)
    is summed by one inv_scatter_sum of [message | 3 x equivariant] rows
    in the forward pass (Edges.mirror).
  - gather_nodes on the halo-extended axis (halo graph parallelism,
    parallel/halo.py): each rank holds an x-sorted slab of the atoms, its
    own rows' list is built against [left halo | own | right halo]
    (ops/nlist.neighbor_list_rect, after exchanging pos and the atom
    mask), and every layer's gather exchanges the n_halo boundary rows of
    its input with the two ring neighbours (parallel/collectives.
    exchange_halo) before gathering; the transpose of that gather over
    the N_loc + 2 n_halo nodes is built once per request, and the
    exchange's backward sends the halos' cotangents back.
  All of them run through the row gather (kernel K9 on the card) or
  torch.gather forwards with gather-only backwards, so no scatter-add runs
  and a request repeats its bits. An inverse_lists model given a plain
  (idx, mask) list, or none, falls back to the plain gather, as the JAX
  package does; a newton3 model needs its half list.
* staircase (newton3_compact): a tuple of per-chunk K-major half-list
  blocks over atom prefixes (ops/staircase.py); each chunk gathers with
  inv_gather and sums its mirror with inv_scatter_sum, and the chunks'
  contributions accumulate onto the prefix with prefix adds (_stair).

Every layer after the first gathers [nodepart | force x|y|z] as one 4F-wide
row; the first sees force == 0, gathers nodepart alone and skips phi2.

compute_dtype 'bfloat16' follows the JAX source's dtype semantics: the
stack's inputs atom_node, force_node, dir and rbf are cast to bf16 where
the JAX package casts them (models/newtonnet.py:769-779 there) and back
after the last layer (:792-794), so every tensor the JAX source types as
bf16 is bf16 here: every linear layer's output (TorchLinear casts its
weights to the input's dtype), every elementwise result (each rounded to
bf16, as the JAX program compiled without excess precision rounds it) and
the activations, which take the JAX primitives' decomposition and
derivative rules in bf16 (layers/activations.py). A layer norm returns
float32, as flax's does, and the stack carries on in the promoted dtype.
Sums: a bf16 sum over an axis accumulates in float32 and rounds once, in
both packages; inv_scatter_sum rounds its accumulator to bf16 after each
chunk of slots, where the JAX one does; gather_nodes' backward sums in a
fixed order in float32 and rounds once, where the JAX package
scatter-adds in bf16 (a rule of the port's own: the fixed order is what
makes a request repeat its bits). The cotangent of a broadcast (dir over
the features, a node row over the slots or atoms) is torch's own: summed
in float32 and rounded once. The layers add in the JAX layer's order
(force_node + equiv1, then + equiv2, then the mirror sum), each add
rounded. What is left between the two bf16 programs is float32
arithmetic in another order: a matmul's accumulation (XLA's CPU dot,
torch's CPU or cuBLAS gemm) and the last bits of the edge features (XLA
fuses the cutoff polynomial with multiply-adds), which flip a few bf16
roundings that grow through the layers (ROADMAP.md C11; chip_smoke.py
C11_BARS).
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
from newtonnet_tpu_torch.ops.cellgrid import cell_grid_neighbor_list
from newtonnet_tpu_torch.ops.neighbors import (
    dense_graph,
    dense_graph_sharded,
)
from newtonnet_tpu_torch.ops.nlist import (
    build_reverse_list,
    edge_gather,
    gather_nodes,
    inv_gather,
    inv_scatter_sum,
    neighbor_list,
    neighbor_list_rect,
    node_transpose,
    recompute_displacements,
    recompute_displacements_kn,
)
from newtonnet_tpu_torch.parallel.collectives import (
    exchange_halo,
    gather_rows,
)


class Edges(NamedTuple):
    '''The graph one layer sees. Dense: mask (B, N, N), dir (B, N, N, 3),
    rbf (B, N, N, R), gather None, and with sharded atoms (B, N_loc, N,
    ...) with cols: x (B, N_loc, ...) -> (B, N, ...), the all-gather of the
    neighbour side. K-major lists: mask (B, K, N), dir (B, K, N, 3), rbf
    (B, K, N, R) and gather: x (B, N, ...) -> (B, K, N, ...); for a newton3
    half list also mirror: y (B, K, N, ...) -> (B, N, ...), the sum onto
    each edge's stored neighbour.'''
    mask: torch.Tensor
    dir: torch.Tensor
    rbf: torch.Tensor
    gather: Optional[Callable] = None
    mirror: Optional[Callable] = None
    cols: Optional[Callable] = None


class StairEdges(NamedTuple):
    '''Staircase chunks: each an Edges over a K-major (B, c, n) half-list
    block whose gather reads, and whose mirror sums onto, the first n
    atoms.'''
    chunks: tuple


def _features(model, disp):
    '''(dir, rbf) of displacements (..., 3).'''
    core = model.core
    freqs = core.bessel_frequencies if model.trainable_basis else None
    dist, dir_ = scaled_norm(disp, model.cutoff)
    rbf = polynomial_cutoff(dist) * radial_bessel(dist, model.n_basis,
                                                  frequencies=freqs)
    return dir_, rbf


def dense_edges(model, z, pos, cell, graph_group=None):
    '''The dense graph's Edges; with a graph group, this rank's rows
    against every atom (dense_graph_sharded) and the columns' gather.'''
    if graph_group is None:
        disp, adj = dense_graph(pos, cell, z > 0, model.cutoff,
                                mic_mode=model.mic_mode)
        cols = None
    else:
        disp, adj = dense_graph_sharded(pos, cell, z > 0, model.cutoff,
                                        graph_group, mic_mode=model.mic_mode)

        def cols(x):
            return gather_rows(x, graph_group, 1)
    dir_, rbf = _features(model, disp)
    return Edges(mask=adj, dir=dir_, rbf=rbf, cols=cols)


def _inverse_edges(model, pos, cell, idx_kn, kmask_kn, inv, inv_mask, plain,
                   half):
    '''K-major edges over lists with inverse lists (symmetric-slotted, or a
    newton3 half list when `half`), tightened to the cutoff at pos (a
    stale pair's cotangent is zero, so inv stays valid).'''
    inv, inv_mask = inv.long().contiguous(), inv_mask.bool()
    disp = recompute_displacements_kn(pos, cell, idx_kn, inv, inv_mask,
                                      mic_mode=model.mic_mode, plain=plain)
    kmask = kmask_kn.bool() & \
        (torch.sum(disp * disp, dim=-1) < model.cutoff * model.cutoff)
    dir_, rbf = _features(model, disp)
    return Edges(mask=kmask, dir=dir_, rbf=rbf,
                 gather=lambda x: inv_gather(x, idx_kn, inv, inv_mask,
                                             plain),
                 mirror=(lambda y: inv_scatter_sum(y, idx_kn, inv, inv_mask,
                                                   plain)) if half else None)


def stair_edges(model, pos, cell, nlist, plain=False):
    '''StairEdges of the per-chunk 4-tuples (idx, mask, inv, inv_mask),
    each (B, c, n) K-major, of ops/staircase.stair_nlist; pos is in the
    staircase's atom order.'''
    if nlist is None:
        raise ValueError(
            'newton3_compact models need a precomputed staircase chunk '
            'tuple -- build it with ops/staircase.staircase_half_list and '
            'pass stair_nlist(sl) with the frame permuted by sl.perm')
    chunks = []
    for cidx, cmask, cinv, cinvm in nlist:
        n = cidx.shape[-1]
        chunks.append(_inverse_edges(model, pos[:, :n], cell, cidx.long(),
                                     cmask, cinv, cinvm, plain, half=True))
    return StairEdges(chunks=tuple(chunks))


def request_nlist(model, z, pos, cell, nlist=None):
    '''The list a request's graph runs over, built at pos (no gradient:
    a list is piecewise constant in the positions), so that several
    passes at these positions (the Hessian's blocks of lanes) can share
    it: a given nlist as it is; for a neighbour-list model without one,
    the plain (idx, mask) list of neighbor_list (or of the cell grid, for
    a cell_grid model), with its reverse list for a reverse_lists model
    (the 4-tuple nlist_edges takes); None for the dense graph and for the
    layouts that need a list from the host (newton3, newton3_compact).'''
    if model.graph_mode != 'neighborlist' or nlist is not None \
            or model.newton3 or model.newton3_compact:
        return nlist
    build = cell_grid_neighbor_list if model.cell_grid else neighbor_list
    extra = ((tuple(model.cell_grid), model.cell_capacity)
             if model.cell_grid else ())
    with torch.no_grad():
        idx, listed, _, _ = build(pos.detach(), cell.detach(), z > 0,
                                  model.cutoff, model.k_max, *extra,
                                  mic_mode=model.mic_mode)
        if model.reverse_lists:
            return (idx, listed) + tuple(build_reverse_list(idx, listed))
    return idx, listed


def nlist_edges(model, z, pos, cell, nlist=None, plain=False):
    '''K-major list edges (see the module docstring): from the 4-tuple of
    inverse or half lists (inverse_lists and newton3 models), a plain
    (idx, mask) list, a reverse-list 4-tuple (idx, mask, rev, rev_mask)
    (reverse_lists models), or a plain full list built at pos by
    request_nlist. The list is tightened to the cutoff at the current
    positions (a stale pair of a given list drops out).'''
    cut2 = model.cutoff * model.cutoff
    if (model.inverse_lists or model.newton3) and model.reverse_lists:
        raise ValueError(
            'inverse_lists/newton3 require the K-major edge layout (no '
            'sharding/reverse_lists)')
    pre_rev = None
    if nlist is not None and len(nlist) == 4 and (model.inverse_lists
                                                  or model.newton3):
        idx, kmask, inv, inv_mask = nlist
        return _inverse_edges(model, pos, cell,
                              idx.long().transpose(1, 2).contiguous(),
                              kmask.bool().transpose(1, 2), inv, inv_mask,
                              plain, half=model.newton3)
    if model.newton3:
        raise ValueError(
            'newton3 models need a precomputed half-list 4-tuple (idx, '
            'mask, inv, inv_mask) -- build it with ops/nlist.'
            'newton3_half_list + build_inverse_list, or md/driver.'
            'host_symmetric_nlist')
    if nlist is None:
        nlist = request_nlist(model, z, pos, cell)
    if len(nlist) == 4:
        pre_rev = (nlist[2].long(), nlist[3].bool())
    idx, listed = nlist[0].long(), nlist[1].bool()
    disp = recompute_displacements(pos, cell, idx, mic_mode=model.mic_mode,
                                   mask=listed)
    kmask = listed & (torch.sum(disp * disp, dim=-1) < cut2)
    dir_, rbf = _features(model, disp)
    if model.reverse_lists:
        # a stale pair's cotangent is zero (the layer multiplies by the
        # mask), so the list's reverse needs no tightening
        rev, rev_mask = pre_rev or build_reverse_list(idx, kmask)

        def gather(x):
            return edge_gather(x, idx, rev, rev_mask).transpose(1, 2)
    else:
        idx_kn, listed_kn = idx.transpose(1, 2), listed.transpose(1, 2)
        tr = node_transpose(idx_kn, idx.shape[1], listed_kn)

        def gather(x):
            return gather_nodes(x, idx_kn, listed_kn, tr)
    return Edges(mask=kmask.transpose(1, 2), dir=dir_.transpose(1, 2),
                 rbf=rbf.transpose(1, 2), gather=gather)


def halo_edges(model, z, pos, cell, n_halo, group):
    '''K-major list edges of this rank's slab under halo graph
    parallelism (the JAX core's halo branch, models/newtonnet.py:646-662
    and :228-236 there): pos and the atom mask exchanged, the own rows'
    list against the extended candidates (self-edges excluded at offset
    n_halo), and a gather that exchanges its input before gathering on the
    extended axis. Refuses what the JAX core refuses under sharding, with
    its messages, before any exchange.'''
    if model.newton3_compact:
        raise ValueError(
            'newton3_compact is its own edge layout: no sharding, '
            'reverse_lists, inverse_lists, or newton3')
    if model.reverse_lists:
        raise ValueError(
            'reverse_lists is incompatible with halo sharding '
            '(transpose lists would span shard boundaries)')
    if model.inverse_lists or model.newton3:
        raise ValueError(
            'inverse_lists/newton3 require the K-major edge layout '
            '(no sharding/reverse_lists, NEWTONNET_EDGE_LAYOUT=kn, '
            'NEWTONNET_EINSUM_IMPL=unroll)')
    mask = z > 0
    pos_ext = exchange_halo(pos, n_halo, group)
    mask_ext = exchange_halo(mask, n_halo, group)
    idx, kmask, disp, _ = neighbor_list_rect(
        pos, pos_ext, cell, mask, mask_ext, model.cutoff, model.k_max,
        self_offset=n_halo, mic_mode=model.mic_mode)
    dir_, rbf = _features(model, disp)
    idx_kn, kmask_kn = idx.transpose(1, 2), kmask.transpose(1, 2)
    tr = node_transpose(idx_kn, pos_ext.shape[1], kmask_kn)

    def gather(x):
        return gather_nodes(exchange_halo(x, n_halo, group), idx_kn,
                            kmask_kn, tr)
    return Edges(mask=kmask_kn, dir=dir_.transpose(1, 2),
                 rbf=rbf.transpose(1, 2), gather=gather)


def _edge_messages(lp, nodepart, cat, edges, first_layer, f, force_i):
    '''The per-edge part of a list layer over K-major edges (B, K, N), in
    the JAX layer's order of operations (so that each tensor's cotangents
    add up in the order of the JAX program's): -> (the atoms' message sum
    (B, N, F), the out-side equivariant sums equiv1 and equiv2 (B, N, 3,
    F; equiv2 None in the first layer), the mirror sum (B, N, 4F) or
    None). force_i: force_node of the edges' own atoms, for a half list's
    mirror.'''
    w = edges.mask[..., None].to(nodepart.dtype)
    edgepart = lp.message_edgepart(edges.rbf)
    cat_j = edges.gather(cat)
    nodepart_j = cat_j if first_layer else cat_j[..., :f]
    message = edgepart * nodepart[:, None] * nodepart_j * w
    msum = torch.sum(message, dim=1)
    phi1 = lp.equiv_message1(message) * w

    def dir_d(d):
        return edges.dir[..., d:d + 1]

    equiv1 = torch.stack([torch.sum(phi1 * dir_d(d), dim=1)
                          for d in range(3)], dim=2)
    equiv2 = None
    if not first_layer:
        phi2 = lp.equiv_message2(message) * w
        equiv2 = torch.stack(
            [torch.sum(phi2 * cat_j[..., (d + 1) * f:(d + 2) * f], dim=1)
             for d in range(3)], dim=2)
    mirror = None
    if edges.mirror is not None:
        if first_layer:
            rows = [message] + [-phi1 * dir_d(d) for d in range(3)]
        else:
            rows = [message] + [
                phi2 * force_i[:, None, :, d] - phi1 * dir_d(d)
                for d in range(3)]
        mirror = edges.mirror(torch.cat(rows, dim=-1))
    return msum, equiv1, equiv2, mirror


def _node_update(lp, atom_node, force_node, layer_norm):
    update = lp.equiv_update(force_node)
    atom_node = atom_node + torch.sum(force_node * update, dim=2)
    if layer_norm:
        atom_node = lp.layer_norm(atom_node)
    return atom_node, force_node


def _cat_rows(nodepart, force_node, first_layer):
    if first_layer:
        return nodepart
    return torch.cat([nodepart] + [force_node[:, :, d] for d in range(3)],
                     dim=-1)


def _stair(lp, atom_node, force_node, edges, first_layer, layer_norm):
    '''The staircase layer (the JAX package's InteractionNet._stair): per
    chunk, the gather over the first n atoms, the out-side sums and the
    mirror's inv_scatter_sum, each added onto the n-atom prefix.'''
    f = atom_node.shape[-1]
    nodepart = lp.message_nodepart(atom_node)
    cat = _cat_rows(nodepart, force_node, first_layer)
    d_atom = torch.zeros_like(atom_node)
    d_equiv = torch.zeros_like(force_node)

    def prefix_add(acc, n, x):
        return torch.cat([acc[:, :n] + x, acc[:, n:]], dim=1)

    for ch in edges.chunks:
        n = ch.mask.shape[-1]
        msum, equiv, equiv2, S = _edge_messages(
            lp, nodepart[:, :n], cat[:, :n], ch, first_layer, f,
            force_node[:, :n])
        d_atom = prefix_add(d_atom, n, msum)
        if equiv2 is not None:
            equiv = equiv + equiv2
        d_atom = prefix_add(d_atom, n, S[..., :f])
        equiv_in = torch.stack([S[..., (d + 1) * f:(d + 2) * f]
                                for d in range(3)], dim=2)
        d_equiv = prefix_add(d_equiv, n, equiv + equiv_in)
    atom_node = atom_node + d_atom
    force_node = force_node + d_equiv
    return _node_update(lp, atom_node, force_node, layer_norm)


def interaction(lp, atom_node, force_node, edges, first_layer, layer_norm):
    '''One message-passing layer (InteractionNet.__call__, 'unroll'):
    atom_node (B, N, F) and force_node (B, N, 3, F) -> updated, in their
    own dtype (bf16 for a bf16 stack).'''
    if isinstance(edges, StairEdges):
        return _stair(lp, atom_node, force_node, edges, first_layer,
                      layer_norm)
    f = atom_node.shape[-1]
    nodepart = lp.message_nodepart(atom_node)
    if edges.gather is None:  # dense: j is axis 2
        cols = edges.cols or (lambda x: x)
        w = edges.mask[..., None].to(atom_node.dtype)
        message = lp.message_edgepart(edges.rbf) \
            * nodepart[:, :, None] * cols(nodepart)[:, None] * w
        atom_node = atom_node + torch.sum(message, dim=2)
        phi1 = lp.equiv_message1(message) * w
        equiv = torch.stack(
            [torch.sum(phi1 * edges.dir[..., d:d + 1], dim=2)
             for d in range(3)], dim=2)
        updated = force_node + equiv
        if not first_layer:
            phi2 = lp.equiv_message2(message) * w
            force_j = cols(force_node)
            updated = updated + torch.stack(
                [torch.sum(phi2 * force_j[:, None, :, d], dim=2)
                 for d in range(3)], dim=2)
        return _node_update(lp, atom_node, updated, layer_norm)
    msum, equiv, equiv2, S = _edge_messages(
        lp, nodepart, _cat_rows(nodepart, force_node, first_layer), edges,
        first_layer, f, force_node)
    atom_node = atom_node + msum
    if S is not None:
        atom_node = atom_node + S[..., :f]
    force_node = force_node + equiv
    if equiv2 is not None:
        force_node = force_node + equiv2
    if S is not None:
        force_node = force_node + torch.stack(
            [S[..., (d + 1) * f:(d + 2) * f] for d in range(3)], dim=2)
    return _node_update(lp, atom_node, force_node, layer_norm)


def _cast_edges(edges, cd):
    if isinstance(edges, StairEdges):
        return StairEdges(chunks=tuple(_cast_edges(c, cd)
                                       for c in edges.chunks))
    return edges._replace(dir=edges.dir.to(cd), rbf=edges.rbf.to(cd))


def apply_core_xla(model, z, pos, cell, nlist=None, plain=False,
                   graph_group=None, halo=0):
    '''Primal forward: {atom_node (B,N,F), force_node (B,N,3,F)} and the
    core's heads, atomic_energy (B,N,1), charge (B,N) and direct_force
    (B,N,3), computed in
    pos's dtype after a bf16 stack casts back, as the JAX core computes
    them. plain=True runs the inverse-list gathers
    through the plain row gather (the same numbers as K9, bit for bit).
    graph_group: the dense graph with atoms sharded over that process
    group (z, pos this rank's block; the JAX core's shard_axis); with
    halo = n_halo > 0 (a neighbour-list model) the halo-exchange graph
    over that group instead (z, pos this rank's x-sorted slab; the JAX
    core's shard_axis with halo, halo_edges).'''
    core = model.core
    z = z.long()
    B, N = z.shape
    fmask = (z > 0).to(pos.dtype)[..., None]
    atom_node = core.node_embedding[z].to(pos.dtype) * fmask
    force_node = torch.zeros((B, N, 3, core.n_features), dtype=pos.dtype,
                             device=pos.device)
    if model.graph_mode == 'dense':
        edges = dense_edges(model, z, pos, cell, graph_group)
    elif halo:
        edges = halo_edges(model, z, pos, cell, halo, graph_group)
    elif model.newton3_compact:
        edges = stair_edges(model, pos, cell, nlist, plain)
    else:
        edges = nlist_edges(model, z, pos, cell, nlist, plain)
    cd = COMPUTE_DTYPES[model.compute_dtype]
    if cd is not None:
        atom_node, force_node = atom_node.to(cd), force_node.to(cd)
        edges = _cast_edges(edges, cd)
    for i, lp in enumerate(core.interactions()):
        atom_node, force_node = interaction(lp, atom_node, force_node, edges,
                                            i == 0, model.layer_norm)
    if cd is not None:
        atom_node, force_node = atom_node.to(pos.dtype), \
            force_node.to(pos.dtype)
    out = {'atom_node': atom_node, 'force_node': force_node}
    if 'energy' in core.heads:
        e = core.scaler_energy(core.energy_head(atom_node), z)
        out['atomic_energy'] = e * fmask
    if 'charge' in core.heads:
        q = core.scaler_charge(core.charge_head(atom_node), z)
        out['charge'] = (q * fmask)[..., 0]
    if 'direct_force' in core.heads:
        # the head's F weights summed against force_node over F
        w = core.direct_force_head(atom_node)
        force = torch.sum(w[:, :, None, :] * force_node, dim=-1)
        out['direct_force'] = core.scaler_direct_force(force, z) * fmask
    return out
