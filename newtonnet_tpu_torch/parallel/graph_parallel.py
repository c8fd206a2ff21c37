'''Graph (atom-partitioned) parallelism over the dense graph (the JAX
package's parallel/graph_parallel.py).

The atoms of each graph are split in equal blocks over the mesh's 'graph'
ranks, and the graphs over its 'data' ranks. Each rank builds its rows of
the pair tensor against every atom (ops/neighbors.dense_graph_sharded)
and, per message-passing layer, all-gathers the neighbour side's node
features over its graph group (models/xla_stack.py, Edges.cols); the
O(N_loc x N) pair tensors stay local, so a rank holds about 1/G of the
one-process request's pair memory. Energies are summed over the graph
group; forces come from each rank's reverse pass, where the all-gather's
backward (the sum of the cotangents over the group, then this rank's
block: a reduce-scatter) adds the other blocks' terms: no hand-written
halo bookkeeping, exact to the one-process result up to the order of
float sums.

This is the path for one dense-mode molecule too large for one device
(inference only). For neighbour-list models parallel/halo.py moves only
the slabs' boundary blocks instead.
'''
import torch

from newtonnet_tpu_torch.models.xla_stack import apply_core_xla
from newtonnet_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_sum,
)


def pad_atoms_to_multiple(z, pos, multiple):
    '''Pad the atom axis with padding atoms (z = 0 at the origin) so that
    it divides the graph-axis size.'''
    n = z.shape[1]
    pad = (-n) % multiple
    if pad:
        z = torch.nn.functional.pad(z, (0, pad))
        pos = torch.nn.functional.pad(pos, (0, 0, 0, pad))
    return z, pos


def make_sharded_energy_force_fn(model, mesh):
    '''A function (z, pos, cell) -> (energy (B,), forces (B, N, 3)) with
    the batch split over the mesh's 'data' ranks and the atoms over its
    'graph' ranks.

    Every rank passes the whole (B, N) request (N a multiple of the graph
    size: pad_atoms_to_multiple) and gets the whole result back: it
    computes its block, then the blocks are all-gathered over the graph
    and data groups.

    It runs the model's core as the kernel='xla' stack
    (models/xla_stack.py), whatever kernel the checkpoint names, as the
    JAX function runs model.core: a kernel='pallas' checkpoint sharded
    this way launches none of the fused pair kernels, and the dense
    graph's gathers here are plain PyTorch. Energy and gradient forces
    only (the large-molecule path); other heads stay on the one-process
    paths.'''
    if model.graph_mode != 'dense':
        raise NotImplementedError(
            'graph parallelism currently shards the dense pair tensor')
    graph_group, data_group = mesh.group('graph'), mesh.group('data')
    D, G = mesh.shape['data'], mesh.shape['graph']
    d, g = mesh.coords

    def fn(z, pos, cell):
        B, N = z.shape
        if B % D or N % G:
            raise ValueError(
                f'batch {B} x atoms {N} does not divide over the mesh '
                f'{D}x{G}; pad the atoms with pad_atoms_to_multiple')
        b, n = B // D, N // G
        z_loc = z[d * b:(d + 1) * b, g * n:(g + 1) * n]
        cell_loc = cell[d * b:(d + 1) * b]
        atom_mask = (z_loc > 0).to(pos.dtype)
        with torch.enable_grad():
            x = pos[d * b:(d + 1) * b, g * n:(g + 1) * n].detach() \
                .requires_grad_(True)
            out = apply_core_xla(model, z_loc, x, cell_loc,
                                 graph_group=graph_group)
            e_local = torch.sum(out['atomic_energy'][..., 0] * atom_mask,
                                dim=-1)
            # differentiate the LOCAL energy sum only: every rank seeds
            # its own, and the all-gathers' backward sums the other
            # blocks' terms onto this one (seeding the summed total
            # would count them G times)
            (grad,) = torch.autograd.grad(e_local.sum(), x)
        energy = all_reduce_sum(e_local.detach(), graph_group)
        forces = all_gather_cat(-grad, graph_group, 1)
        return (all_gather_cat(energy, data_group, 0),
                all_gather_cat(forces, data_group, 0))

    return fn
