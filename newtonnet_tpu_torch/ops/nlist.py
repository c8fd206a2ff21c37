'''Padded full neighbour lists for large systems (the JAX package's
`ops/nlist.py`, its plain full-list part).

Instead of the dense (B, N, N) pair tensor (ops/neighbors.py), the graph
is a padded per-atom list of static width K = k_max:

    idx  (B, N, K) int64  -- neighbour indices j of each atom i
    mask (B, N, K) bool   -- validity (|d| < r, i != j, both atoms real)
    disp (B, N, K, 3)     -- pos_i - pos_j, minimum-imaged

Construction is O(N^2) in distances, row-chunked (never more than
(chunk, N) at once), and keeps the K nearest in-range neighbours per atom
with torch.topk; atoms with more than K neighbours inside the cutoff lose
their farthest ones and are counted in `overflow`. The half, inverse,
reverse, staircase and cell-grid layouts belong to kernel='xla' and are
not here (ROADMAP.md A, "XLA kernel='xla' path"). minimum_image takes
(B, N, K, 3) edges as they are, so the JAX package's `_mic_edges` reshape
has no counterpart.
'''
import torch

from newtonnet_tpu_torch.ops.neighbors import minimum_image


def neighbor_list(pos, cell, atom_mask, cutoff, k_max, mic_mode='exact',
                  chunk=512):
    '''Build padded neighbour lists.

    Args:
        pos: (B, N, 3); cell: (B, 3, 3); atom_mask: (B, N) bool.
        cutoff: radius; k_max: neighbour capacity (at most N - 1 is used).
        chunk: rows per block of the distance search.

    Returns:
        idx (B, N, K) int64 (0 where the mask is false), mask (B, N, K)
        bool, disp (B, N, K, 3) and overflow (B,) int64 -- the number of
        atoms whose in-range neighbour count exceeded K.
    '''
    B, N = pos.shape[:2]
    k_max = min(k_max, N - 1) if N > 1 else 1
    is_periodic = torch.any((cell != 0).flatten(1), dim=-1)
    pos_d = pos.detach()
    idx_c, mask_c, overflow = [], [], torch.zeros(B, dtype=torch.int64,
                                                  device=pos.device)
    col_ids = torch.arange(N, device=pos.device)
    for c0 in range(0, N, chunk):
        rows = pos_d[:, c0:c0 + chunk]
        rmask = atom_mask[:, c0:c0 + chunk]
        disp = rows[:, :, None, :] - pos_d[:, None, :, :]  # (B, c, N, 3)
        disp = minimum_image(disp, cell.detach(), is_periodic,
                             mic_mode=mic_mode)
        d2 = torch.sum(disp * disp, dim=-1)
        row_ids = torch.arange(c0, c0 + rows.shape[1], device=pos.device)
        valid = (rmask[:, :, None] & atom_mask[:, None, :]
                 & (row_ids[:, None] != col_ids[None, :])
                 & (d2 < cutoff * cutoff))
        score = torch.where(valid, -d2, torch.full_like(d2, -torch.inf))
        top_score, top_idx = torch.topk(score, k_max, dim=-1)
        idx_c.append(top_idx)
        mask_c.append(torch.isfinite(top_score))
        n_valid = valid.sum(-1)
        overflow += ((n_valid > k_max) & rmask).sum(-1)
    kmask = torch.cat(mask_c, dim=1)
    idx = torch.where(kmask, torch.cat(idx_c, dim=1), 0)
    return idx, kmask, recompute_displacements(pos, cell, idx, mic_mode), \
        overflow


def recompute_displacements(pos, cell, idx, mic_mode='exact'):
    '''pos_i - pos_j for an index list, minimum-imaged. The indices carry
    no gradient; the displacements are differentiable in pos and cell.'''
    is_periodic = torch.any((cell != 0).flatten(1), dim=-1)
    disp = pos[:, :, None, :] - gather_nodes(pos, idx)
    return minimum_image(disp, cell, is_periodic, mic_mode=mic_mode)


def gather_nodes(x, idx):
    '''Per-atom features at neighbour indices: x (B, N, ...) -> (B, R, K,
    ...) for idx (B, R, K). Its backward is a scatter-add onto the atoms
    (in x's dtype; on CUDA with atomics, so its bits may differ between
    runs).'''
    B, N = x.shape[:2]
    R, K = idx.shape[1], idx.shape[2]
    flat = x.reshape(B, N, -1)
    index = idx.long().reshape(B, R * K, 1).expand(B, R * K, flat.shape[-1])
    return torch.gather(flat, 1, index).reshape((B, R, K) + x.shape[2:])
