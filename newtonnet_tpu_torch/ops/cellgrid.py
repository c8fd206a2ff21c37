'''O(N) cell-grid (linked-cell) neighbour lists for periodic boxes (the JAX
package's ops/cellgrid.py), in torch ops on the device.

Atoms are binned into a static (nx, ny, nz) grid with a static per-cell
capacity C, and each atom searches only its own cell's (at most 27)
wrapped neighbour cells: O(N * 27C) distances instead of the O(N^2) of
ops/nlist.neighbor_list. The binning is integer work: cell ids, one
stable argsort, each atom's rank in its cell, and a table of atom ids per
cell filled at unique integer positions (no float atomics). The K nearest
candidates come from torch.topk over the 27C candidate axis, and the rows
go back to the atoms' own order. The displacements are recomputed from
the indices with ops/nlist.recompute_displacements, so their backward is
gather_nodes' fixed-order one.

Pick the grid and the capacity on the host with suggest_grid /
suggest_capacity. Overflow (an atom that found no place in a full cell,
which loses its whole row, or an atom with more than K neighbours in
range) is counted and returned, as the JAX function does.
'''
import numpy as np
import torch

from newtonnet_tpu_torch.ops.linalg3 import inv3x3
from newtonnet_tpu_torch.ops.neighbors import minimum_image
from newtonnet_tpu_torch.ops.nlist import recompute_displacements


def _axis_offsets(n):
    '''Unique wrapped neighbour offsets along one grid axis of n cells:
    (-1, 0, 1) for n >= 3, (0, 1) for n == 2 (the -1 and +1 images are one
    cell), (0,) for n == 1.'''
    if n >= 3:
        return (-1, 0, 1)
    if n == 2:
        return (0, 1)
    return (0,)


def suggest_grid(cell, cutoff):
    '''Largest (nx, ny, nz) whose cells still cover `cutoff` (host helper):
    along lattice vector a_i the perpendicular width is V / |a_j x a_k|,
    and n_i cells keep every in-range neighbour in the adjacent layer iff
    width_i / n_i >= cutoff.'''
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    vol = abs(np.linalg.det(cell))
    if vol <= 0:
        raise ValueError('cell-grid build requires a periodic cell')
    grid = []
    for i in range(3):
        cross = np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3])
        grid.append(max(1, int(np.floor(vol / np.linalg.norm(cross)
                                         / cutoff))))
    return tuple(grid)


def suggest_capacity(n_atoms, grid, margin=2.0, multiple=8):
    '''Per-cell capacity C from the average occupancy times `margin`,
    rounded up to a multiple of `multiple` (host helper). A too-small C
    shows as overflow, not as a wrong list.'''
    avg = n_atoms / max(int(np.prod(grid)), 1)
    cap = int(np.ceil(avg * margin))
    return max(multiple, ((cap + multiple - 1) // multiple) * multiple)


def _offsets(grid, device):
    nx, ny, nz = grid
    return torch.tensor([(ox, oy, oz) for ox in _axis_offsets(nx)
                         for oy in _axis_offsets(ny)
                         for oz in _axis_offsets(nz)], device=device)


def _frame(pos, cell, atom_mask, cutoff, k_max, grid, C, mic_mode):
    '''One frame (no gradient): idx (N, k_max), kmask, overflow (0-d).'''
    nx, ny, nz = grid
    ncells = nx * ny * nz
    N, dev = pos.shape[0], pos.device
    gdim = torch.tensor(grid, device=dev)
    frac = pos @ inv3x3(cell)
    frac = frac - torch.floor(frac)                 # wrapped into [0, 1)
    ci = torch.minimum(torch.clamp((frac * gdim).long(), min=0), gdim - 1)
    cid = (ci[:, 0] * ny + ci[:, 1]) * nz + ci[:, 2]
    cid = torch.where(atom_mask, cid, ncells)      # padding -> spill bin
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    rank = torch.arange(N, device=dev) - torch.searchsorted(sorted_cid,
                                                            sorted_cid)
    real = sorted_cid < ncells
    n_spill = ((rank >= C) & real).sum()
    placed = (rank < C) & real
    # cell table (ncells, C) of atom ids, N = empty
    table = torch.full((ncells * C,), N, dtype=torch.long, device=dev)
    table[(sorted_cid * C + rank)[placed]] = order[placed]
    table = table.reshape(ncells, C)

    pos_cells = torch.cat([pos, pos.new_zeros(1, 3)])[table]   # (ncells, C, 3)
    offs = _offsets(grid, dev)
    n_off = offs.shape[0]
    cc = torch.arange(ncells, device=dev)
    nbx = ((cc // (ny * nz))[:, None] + offs[:, 0]) % nx
    nby = (((cc // nz) % ny)[:, None] + offs[:, 1]) % ny
    nbz = ((cc % nz)[:, None] + offs[:, 2]) % nz
    nbr = (nbx * ny + nby) * nz + nbz                          # (ncells, n_off)
    cand_idx = table[nbr].reshape(ncells, n_off * C)
    cand_pos = pos_cells[nbr].reshape(ncells, n_off * C, 3)

    disp = pos_cells[:, :, None, :] - cand_pos[:, None, :, :]
    disp = minimum_image(disp.reshape(1, ncells * C, n_off * C, 3),
                         cell[None], torch.ones(1, dtype=torch.bool,
                                                device=dev),
                         mic_mode=mic_mode).reshape(ncells, C, n_off * C, 3)
    d2 = torch.sum(disp * disp, dim=-1)
    own_valid = table < N
    valid = (own_valid[:, :, None] & (cand_idx < N)[:, None, :]
             & (table[:, :, None] != cand_idx[:, None, :])
             & (d2 < cutoff * cutoff))
    k = min(k_max, n_off * C)
    score = torch.where(valid, -d2, torch.full_like(d2, -torch.inf))
    top_score, top_slot = torch.topk(score, k, dim=-1)       # (ncells, C, k)
    kmask_c = torch.isfinite(top_score)
    n_over = ((valid.sum(-1) > k) & own_valid).sum()
    top_idx = torch.gather(cand_idx[:, None, :].expand(ncells, C, n_off * C),
                           2, top_slot)
    top_idx = torch.where(kmask_c, top_idx, 0)

    # back to the atoms' own order: each atom holds one table position
    own = table.reshape(-1)
    held = own < N
    idx = torch.zeros((N, k_max), dtype=torch.long, device=dev)
    kmask = torch.zeros((N, k_max), dtype=torch.bool, device=dev)
    idx[own[held], :k] = top_idx.reshape(-1, k)[held]
    kmask[own[held], :k] = kmask_c.reshape(-1, k)[held]
    return idx, kmask, n_spill + n_over


def cell_grid_neighbor_list(pos, cell, atom_mask, cutoff, k_max, grid,
                            capacity, mic_mode='exact'):
    '''Padded neighbour lists through a static spatial grid.

    Args:
        pos: (B, N, 3); cell: (B, 3, 3) periodic lattice rows (nonzero);
            atom_mask: (B, N) bool.
        cutoff: radius. k_max: neighbour capacity K.
        grid: static (nx, ny, nz) from suggest_grid.
        capacity: static per-cell atom capacity C from suggest_capacity.

    Returns:
        idx (B, N, K) int64 (0 where the mask is false), mask (B, N, K)
        bool, disp (B, N, K, 3) (differentiable in pos and cell) and
        overflow (B,) int64: atoms that spilled a full cell or had more
        than K in-range neighbours.'''
    grid = tuple(int(g) for g in grid)
    with torch.no_grad():
        outs = [_frame(pos[b].detach(), cell[b].detach(), atom_mask[b],
                       cutoff, k_max, grid, capacity, mic_mode)
                for b in range(pos.shape[0])]
    idx = torch.stack([o[0] for o in outs])
    kmask = torch.stack([o[1] for o in outs])
    overflow = torch.stack([o[2] for o in outs])
    return idx, kmask, recompute_displacements(pos, cell, idx, mic_mode,
                                               mask=kmask), overflow
