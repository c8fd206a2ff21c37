'''Static-shape dense graph construction.

The batch is a dense padded layout -- z (B, N) with 0 = padding,
pos (B, N, 3), cell (B, 3, 3) lattice rows (all-zero = aperiodic) -- and
the graph is the full (B, N, N) displacement tensor with the boolean mask
`adj = (|d| < r) & (i != j) & mask_i & mask_j`.

mic_mode: 'exact' maps the image shift back with cell^T (the exact
row-vector minimum image); 'reference' uses cell, as the original
NewtonNet code does (identical for symmetric cells).
'''
import torch
import torch.distributed as dist

from newtonnet_tpu_torch.ops.linalg3 import inv3x3
from newtonnet_tpu_torch.parallel.collectives import (
    all_gather_cat,
    gather_rows,
)


def minimum_image(disp, cell, is_periodic, mic_mode='exact'):
    '''Minimum-image displacements (B, N, N, 3), unchanged where aperiodic.

    Args:
        disp: (B, N, N, 3) raw displacements pos_i - pos_j.
        cell: (B, 3, 3) lattice rows.
        is_periodic: (B,) bool.
        mic_mode: 'exact' | 'reference'.
    '''
    if mic_mode not in ('exact', 'reference'):
        raise ValueError(f'unknown mic_mode {mic_mode}')
    eye = torch.eye(3, dtype=cell.dtype, device=cell.device)
    safe_cell = torch.where(is_periodic[:, None, None], cell, eye)
    inv_cell_t = inv3x3(safe_cell.transpose(-1, -2))
    frac = torch.einsum('bxy,bijy->bijx', inv_cell_t, disp)
    shift = torch.round(frac)  # half to even, as jnp.round
    if mic_mode == 'reference':
        corrected = disp - torch.einsum('bxy,bijy->bijx', safe_cell, shift)
    else:
        corrected = disp - torch.einsum('byx,bijy->bijx', safe_cell, shift)
    return torch.where(is_periodic[:, None, None, None], corrected, disp)


def dense_graph(pos, cell, atom_mask, cutoff, mic_mode='exact'):
    '''Dense masked radius graph.

    Returns:
        disp: (B, N, N, 3) displacements pos_i - pos_j (minimum-imaged where
            periodic); edge (i, j) aggregates onto i.
        adj: (B, N, N) bool: |d| < cutoff, no self loops, both atoms real.
    '''
    disp = pos[:, :, None, :] - pos[:, None, :, :]
    is_periodic = torch.any((cell != 0).flatten(1), dim=-1)
    disp = minimum_image(disp, cell, is_periodic, mic_mode=mic_mode)
    n = pos.shape[1]
    not_self = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    pair_mask = atom_mask[:, :, None] & atom_mask[:, None, :] & not_self
    d2 = torch.sum(disp * disp, dim=-1)
    return disp, pair_mask & (d2 < cutoff * cutoff)


def dense_graph_sharded(pos, cell, atom_mask, cutoff, group,
                        mic_mode='exact'):
    '''Atom-sharded dense graph: local rows against all-gathered columns
    (the JAX package's dense_graph_sharded).

    The atom axis is split in equal blocks over the ranks of `group` (a
    mesh's 'graph' group), block r on the group's rank r. The positions
    and masks of every block are all-gathered once (they are small, (B, N,
    3)); the O(N_loc x N) pair tensors stay local. The positions' gather
    is differentiable: its backward sums the cotangents over the group and
    keeps this rank's block.

    Args:
        pos: (B, N_loc, 3) this rank's positions.
        atom_mask: (B, N_loc) this rank's validity.
        group: the process group (None: one block, the dense graph).

    Returns:
        disp (B, N_loc, N, 3), adj (B, N_loc, N) -- rows local, columns
        global.
    '''
    pos_all = gather_rows(pos, group, 1)
    mask_all = all_gather_cat(atom_mask, group, 1)
    n_loc, n = pos.shape[1], pos_all.shape[1]
    offset = (dist.get_rank(group) if group is not None else 0) * n_loc
    disp = pos[:, :, None, :] - pos_all[:, None, :, :]
    is_periodic = torch.any((cell != 0).flatten(1), dim=-1)
    disp = minimum_image(disp, cell, is_periodic, mic_mode=mic_mode)
    row_ids = offset + torch.arange(n_loc, device=pos.device)
    not_self = row_ids[:, None] != torch.arange(n, device=pos.device)[None]
    pair_mask = atom_mask[:, :, None] & mask_all[:, None, :] & not_self
    d2 = torch.sum(disp * disp, dim=-1)
    return disp, pair_mask & (d2 < cutoff * cutoff)
