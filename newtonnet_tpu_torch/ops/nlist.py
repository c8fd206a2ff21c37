'''Padded neighbour lists for large systems (the JAX package's
`ops/nlist.py`: plain full lists, reverse lists, and the symmetric-slotted
inverse lists and newton3 half lists of kernel='xla').

Instead of the dense (B, N, N) pair tensor (ops/neighbors.py), the graph
is a padded per-atom list of static width K = k_max:

    idx  (B, N, K) int64  -- neighbour indices j of each atom i
    mask (B, N, K) bool   -- validity (|d| < r, i != j, both atoms real)
    disp (B, N, K, 3)     -- pos_i - pos_j, minimum-imaged

Construction is O(N^2) in distances, row-chunked (never more than
(chunk, N) at once), and keeps the K nearest in-range neighbours per atom
with torch.topk; atoms with more than K neighbours inside the cutoff lose
their farthest ones and are counted in `overflow`. minimum_image takes
(B, N, K, 3) edges as they are, so the JAX package's `_mic_edges` reshape
has no counterpart. ops/cellgrid.py builds the same lists in O(N).

Reverse lists (reverse_lists): build_reverse_list finds, for each slot,
where the atom appears in its neighbour's row; edge_gather (the
neighbour gather) and edge_pull (per-edge values moved onto the reverse
slots) are autograd Functions whose backwards are gathers: edge_gather's
is edge_pull and a sum over the slots, edge_pull's is edge_pull, so no
scatter-add runs in any derivative order.

Inverse lists (kernel='xla', inverse_lists): symmetrize_slots (host C++,
csrc/host/symslots.cpp) re-slots a full list so that every undirected edge
holds the same slot in both endpoints' rows; in the K-major (B, K, N)
layout each slot is then an involution, its own inverse list
(build_inverse_list). newton3_half_list (host C++, csrc/host/newton3.cpp)
stores each undirected edge once and colours the slots so that each
slot's map is injective on both sides; build_inverse_list gives its
inverse. inv_gather and
inv_scatter_sum are a mutually transposed pair of autograd Functions over
such lists: the neighbour gather, and its adjoint as a sum of per-chunk
gathers, both through the row gather (ops/row_gather.py, kernel K9), so
every derivative order is gather-only and no scatter-add (and no atomic)
runs. gather_nodes, the plain list's gather, has the same property: its
backward sums over the list's transpose (node_transpose) with K9 row
gathers in a fixed order. The staircase layout of half lists is
ops/staircase.py.
'''
import contextlib
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from newtonnet_tpu_torch.ops import _build
from newtonnet_tpu_torch.ops.neighbors import minimum_image
from newtonnet_tpu_torch.ops.row_gather import (
    folded_lanes,
    row_gather,
    row_gather_ref,
)

# slots per chunk of inv_scatter_sum: one row gather over a (B, c*N, F)
# stack per chunk (the JAX package's NEWTONNET_SCATTER_CHUNK default)
SCATTER_CHUNK = 6
# bytes of gathered rows per chunk of gather_nodes' backward (_scatter_rows)
TRANSPOSE_CHUNK_BYTES = 256 << 20
_FIXED_DEGREE = [0]


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
    return idx, kmask, recompute_displacements(pos, cell, idx, mic_mode,
                                               mask=kmask), overflow


def neighbor_list_rect(pos_own, pos_cand, cell, own_mask, cand_mask, cutoff,
                       k_max, self_offset=None, mic_mode='exact', chunk=512):
    '''Rectangular neighbour list: own rows against a candidate column set
    (the JAX package's neighbor_list_rect). Halo-exchange graph parallelism
    (parallel/halo.py) searches each rank's own atoms' neighbours among its
    extended candidates [left halo | own | right halo], O(N_own x N_cand).

    Args:
        pos_own: (B, N_own, 3) row atoms; pos_cand: (B, N_cand, 3).
        own_mask: (B, N_own) bool; cand_mask: (B, N_cand) bool.
        self_offset: if not None, candidate column self_offset + i is
            excluded for row i (the own atoms sit there in the candidates).
        chunk: rows per block of the distance search.

    Returns:
        idx (B, N_own, K) int64 into the candidate axis (0 where the mask is
        false), mask (B, N_own, K), disp (B, N_own, K, 3) = pos_own_i -
        pos_cand_j minimum-imaged (differentiable in both position sets,
        through gather_nodes), overflow (B,): rows with more in-range
        candidates than K = min(k_max, N_cand - 1).
    '''
    B, N_own = pos_own.shape[:2]
    N_cand = pos_cand.shape[1]
    k_max = min(k_max, N_cand - 1) if N_cand > 1 else 1
    is_periodic = torch.any((cell != 0).flatten(1), dim=-1)
    own_d, cand_d = pos_own.detach(), pos_cand.detach()
    idx_c, mask_c = [], []
    overflow = torch.zeros(B, dtype=torch.int64, device=pos_own.device)
    col_ids = torch.arange(N_cand, device=pos_own.device)
    for c0 in range(0, N_own, chunk):
        rows = own_d[:, c0:c0 + chunk]
        rmask = own_mask[:, c0:c0 + chunk]
        disp = rows[:, :, None, :] - cand_d[:, None, :, :]
        disp = minimum_image(disp, cell.detach(), is_periodic,
                             mic_mode=mic_mode)
        d2 = torch.sum(disp * disp, dim=-1)
        valid = (rmask[:, :, None] & cand_mask[:, None, :]
                 & (d2 < cutoff * cutoff))
        if self_offset is not None:
            row_ids = torch.arange(c0, c0 + rows.shape[1],
                                   device=pos_own.device) + self_offset
            valid = valid & (row_ids[:, None] != col_ids[None, :])
        score = torch.where(valid, -d2, torch.full_like(d2, -torch.inf))
        top_score, top_idx = torch.topk(score, k_max, dim=-1)
        idx_c.append(top_idx)
        mask_c.append(torch.isfinite(top_score))
        overflow += ((valid.sum(-1) > k_max) & rmask).sum(-1)
    kmask = torch.cat(mask_c, dim=1)
    idx = torch.where(kmask, torch.cat(idx_c, dim=1), 0)
    disp = pos_own[:, :, None, :] - gather_nodes(pos_cand, idx, kmask)
    return idx, kmask, minimum_image(disp, cell, is_periodic,
                                     mic_mode=mic_mode), overflow


def recompute_displacements(pos, cell, idx, mic_mode='exact', mask=None,
                            transpose=None):
    '''pos_i - pos_j for an index list, minimum-imaged. The indices carry
    no gradient; the displacements are differentiable in pos and cell
    (through gather_nodes: with a mask, masked slots pass none).'''
    is_periodic = torch.any((cell != 0).flatten(1), dim=-1)
    disp = pos[:, :, None, :] - gather_nodes(pos, idx, mask, transpose)
    return minimum_image(disp, cell, is_periodic, mic_mode=mic_mode)


class NodeTranspose(NamedTuple):
    '''The transpose of a list idx (B, R, K) onto N nodes: slots[b, j, d]
    is the d-th flat slot id r*K + k (in increasing order) with idx[b, r,
    k] == j, for d below j's in-degree, where valid[b, j, d] is True; both
    (B, N, D), D the largest in-degree.'''
    slots: torch.Tensor
    valid: torch.Tensor


@contextlib.contextmanager
def fixed_degree():
    '''Inside the block node_transpose pads to a bound fixed by the list's
    shape instead of reading the largest in-degree on the host, so that a
    traced program (utils/export.py) has fixed shapes and no host sync;
    gather_nodes' backward then adds the slots past that pad through a
    fixed-size overflow path (_overflow_rows), so no term is dropped.'''
    _FIXED_DEGREE[0] += 1
    try:
        yield
    finally:
        _FIXED_DEGREE[0] -= 1


def _slot_order(idx, n_nodes, mask):
    '''(order, sorted keys, bounds) of idx (B, R, K): a stable argsort of
    the flat slot keys (a masked slot's key is n_nodes, past every node),
    the keys in that order, and bounds (B, n_nodes + 1), where node j's
    run of sorted slots is [bounds[j], bounds[j + 1]).'''
    B = idx.shape[0]
    S = idx.shape[1] * idx.shape[2]
    key = idx.reshape(B, S).long()
    if mask is not None:
        key = torch.where(mask.reshape(B, S).bool(), key, n_nodes)
    order = torch.argsort(key, dim=1, stable=True)
    keys = torch.gather(key, 1, order).contiguous()
    bounds = torch.searchsorted(
        keys, torch.arange(n_nodes + 1, device=idx.device)
        .expand(B, -1).contiguous())
    return order, keys, bounds


def node_transpose(idx, n_nodes, mask=None):
    '''NodeTranspose of idx (B, R, K) onto n_nodes nodes, counting only
    the slots where `mask` (B, R, K) is True (all of them without one).
    Integer ops only: a stable argsort of the flat keys (a masked slot's
    key is n_nodes, past every node), then each node's run of the sorted
    slot ids, padded to the largest in-degree, read on the host.

    Under fixed_degree() the pad is min(R, K) columns instead: the list's
    capacity in both layouts (atom-major (B, N, K) and slot-major (B, K,
    N)). A node's in-degree stays within it wherever no atom has more
    neighbours in range than the capacity (neighbor_list's overflow count
    is 0); where one has, another node's in-degree can pass it (a crowded
    atom is listed by more rows than the capacity), and gather_nodes'
    backward sums the slots past the pad through _overflow_rows.'''
    B = idx.shape[0]
    S = idx.shape[1] * idx.shape[2]
    dev = idx.device
    order, _, bounds = _slot_order(idx, n_nodes, mask)
    start, deg = bounds[:, :-1], bounds[:, 1:] - bounds[:, :-1]
    if _FIXED_DEGREE[0]:
        D = max(min(idx.shape[1], idx.shape[2]), 1)
    else:
        D = max(int(deg.max()), 1) if deg.numel() else 1
    col = torch.arange(D, device=dev)
    valid = col < deg[..., None]
    at = (start[..., None] + col).clamp_max(S - 1).reshape(B, -1)
    slots = torch.gather(order, 1, at).reshape(B, n_nodes, D)
    return NodeTranspose(torch.where(valid, slots, 0), valid)


def _gather_rows(x, idx):
    '''x (B, N, ...) -> (B, R, K, ...) at idx (B, R, K): torch.gather.'''
    B, N = x.shape[:2]
    R, K = idx.shape[1], idx.shape[2]
    flat = x.reshape(B, N, -1)
    index = idx.long().reshape(B, R * K, 1).expand(B, R * K, flat.shape[-1])
    return torch.gather(flat, 1, index).reshape((B, R, K) + x.shape[2:])


def _overflow_rows(rows, idx, mask, n_nodes, D):
    '''The sums of each node's slot rows past the first D of its run
    (B, n_nodes, F), in float64, for rows (B, R*K, F) of a list idx (B, R,
    K): the fixed-size overflow path of a transpose padded to D columns
    (fixed_degree). One row gather puts the rows in the transpose's order
    behind a zero row; those at a rank D or more within their node's run
    are kept and the others zeroed, and a prefix sum along the order gives
    at position i the sum of the sorted rows before i. A node's overflow is
    the prefix at the end of its run less the prefix at its D-th slot
    (masked slots sort last, past every node's run, and are never read).
    Where no node passes D every kept row is zero and so is every sum,
    exactly. Fixed shapes, no host read, no atomics: the same bits in every
    run.'''
    B, S, Ff = rows.shape
    order, keys, bounds = _slot_order(idx, n_nodes, mask)
    rank = torch.arange(S, device=rows.device) - torch.gather(bounds, 1, keys)
    keep = torch.nn.functional.pad(rank >= D, (1, 0))
    prefix = torch.cumsum(
        row_gather(rows, torch.nn.functional.pad(order, (1, 0)))
        .masked_fill_(~keep[..., None], 0), dim=1, dtype=torch.float64)
    end = bounds[:, 1:]
    at = torch.cat([torch.minimum(bounds[:, :-1] + D, end), end], 1)
    got = torch.gather(prefix, 1, at[..., None].expand(B, 2 * n_nodes, Ff))
    return got[:, n_nodes:] - got[:, :n_nodes]


def _scatter_rows(y, tr, overflow=None):
    '''out[b, j] = sum_d where(tr.valid[b, j, d], y_flat[b, tr.slots[b, j,
    d]], 0) for y (B, R, K, ...): per chunk of columns d (as many as fit
    TRANSPOSE_CHUNK_BYTES of gathered rows) one row gather of the (B, R*K,
    F) cotangent rows, then the mask and the sum over the chunk,
    accumulated chunk after chunk. Sums run in fp32 (fp64 for fp64 y) in
    the order of d, and the result is rounded to y's dtype once: the same
    bits in every run. overflow: the list (idx, mask) of a transpose
    padded to a fixed width (fixed_degree), whose slots past the pad
    _overflow_rows adds before the rounding.'''
    B, N, D = tr.slots.shape
    feat = y.shape[3:]
    rows = y.reshape(B, y.shape[1] * y.shape[2], -1).contiguous()
    Ff = rows.shape[-1]
    acc_dt = torch.promote_types(y.dtype, torch.float32)
    acc = torch.zeros((B, N, Ff), dtype=acc_dt, device=y.device)
    chunk = max(1, TRANSPOSE_CHUNK_BYTES // max(1, B * N * Ff
                                                * rows.element_size()))
    for d0 in range(0, D, chunk):
        c = min(chunk, D - d0)
        # a one-column chunk would reshape to a strided view: K9 takes
        # contiguous indices
        g = row_gather(rows, tr.slots[:, :, d0:d0 + c].reshape(B, N * c)
                       .contiguous())
        g = torch.where(tr.valid[:, :, d0:d0 + c].reshape(B, N * c, 1), g, 0)
        acc = acc + g.reshape(B, N, c, Ff).sum(2, dtype=acc_dt)
    if overflow is not None:
        acc = acc + _overflow_rows(rows, *overflow, N, D).to(acc_dt)
    return acc.to(y.dtype).reshape((B, N) + feat)


def _masked(y, mask):
    if mask is None:
        return y
    return torch.where(mask.reshape(mask.shape + (1,) * (y.dim() - 3)), y, 0)


def _fold_lanes(fn, info, in_dims, *args):
    '''The vmap rule of the list Functions (the JAX package's batching
    rule of its gather primitives): the vmap axis of L lanes moves to the
    front and folds into the batch axis B, the unbatched lists broadcast
    to it (expanded, then copied contiguous by the fold), and `fn` runs
    once at L*B: one row gather per gather for the whole block of lanes.
    Arguments that are not tensors (flags) and None pass as they are.'''
    L = info.batch_size

    def fold(a, d):
        if not isinstance(a, torch.Tensor):
            return a
        a = a.expand((L,) + a.shape) if d is None else a.movedim(d, 0)
        # a view where it can be: a batch of one keeps the expand's zero
        # stride, which the row gather's layout refuses
        return a.reshape((L * a.shape[1],) + a.shape[2:]).contiguous()

    with folded_lanes():
        out = fn.apply(*(fold(a, d) for a, d in zip(args, in_dims)))
    return out.reshape((L, -1) + out.shape[1:]), 0


class GatherNodes(torch.autograd.Function):
    '''y = x[idx] (all slots); its derivative is that of where(mask,
    x[idx], 0): masked slots are constants. Backward ScatterNodes.

    apply(x, idx, mask, slots, valid) -> (B, R, K, ...)'''

    @staticmethod
    def forward(x, idx, mask, slots, valid):
        return _gather_rows(x, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, idx, mask, slots, valid = inputs
        ctx.save_for_backward(idx, mask, slots, valid)
        ctx.lists, ctx.n_nodes = (idx, mask, slots, valid), x.shape[1]

    @staticmethod
    def backward(ctx, g):
        idx, mask, slots, valid = ctx.saved_tensors
        if slots is None:  # built at the first backward, not in forward
            slots, valid = node_transpose(idx, ctx.n_nodes, mask)
        return (ScatterNodes.apply(g, idx, mask, slots, valid), None, None,
                None, None)

    @staticmethod
    def jvp(ctx, x_t, *_):
        # the gather itself, so that a reverse pass over the tangent runs
        # ScatterNodes (fixed order), not torch.gather's scatter-add
        return _masked(GatherNodes.apply(x_t, *ctx.lists), ctx.lists[1])

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_lanes(GatherNodes, info, in_dims, *args)


class ScatterNodes(torch.autograd.Function):
    '''The adjoint of GatherNodes' derivative: the sum of each node's
    unmasked slot rows, in a fixed order (_scatter_rows). Backward
    GatherNodes, masked.

    apply(y, idx, mask, slots, valid) -> (B, N, ...)'''

    @staticmethod
    def forward(y, idx, mask, slots, valid):
        with torch.profiler.record_function('gather_nodes_backward'):
            # under fixed_degree the transpose is at the fixed pad: the
            # slots past it go through the overflow path
            return _scatter_rows(y, NodeTranspose(slots, valid),
                                 (idx, mask) if _FIXED_DEGREE[0] else None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, mask, slots, valid = inputs
        ctx.save_for_backward(idx, mask, slots, valid)
        ctx.lists = (idx, mask, slots, valid)

    @staticmethod
    def backward(ctx, g):
        idx, mask, slots, valid = ctx.saved_tensors
        return (_masked(GatherNodes.apply(g, idx, mask, slots, valid), mask),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, y_t, *_):
        # linear: the scatter of the tangent, through apply
        return ScatterNodes.apply(y_t, *ctx.lists)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_lanes(ScatterNodes, info, in_dims, *args)


def gather_nodes(x, idx, mask=None, transpose=None):
    '''Per-atom features at neighbour indices: x (B, N, ...) -> (B, R, K,
    ...) for idx (B, R, K).

    The forward is torch.gather at every slot. The backward sums each
    atom's slot cotangents in a fixed order through row gathers (kernel K9
    on the card) over the list's transpose, never with atomics, so it
    repeats its bits; its own backward is this gather again. With a mask
    (B, R, K), masked slots are held constant: their cotangents are dropped
    (the model's are zeros) and their tangents are zero.

    Args:
        x: (B, N, ...) node features.
        idx: (B, R, K) int indices in [0, N).
        mask: optional (B, R, K) bool, the slots that carry derivatives.
        transpose: node_transpose(idx, N, mask), built here when None;
            pass it to share one across the gathers of a list.'''
    slots, valid = transpose if transpose is not None else (None, None)
    return GatherNodes.apply(x, idx, mask, slots, valid)


def recompute_displacements_kn(pos, cell, idx_kn, inv, inv_mask,
                               mic_mode='exact', plain=False):
    '''K-major displacements disp[b, k, n] = pos[b, n] - pos[b,
    idx_kn[b, k, n]], minimum-imaged, with the neighbour positions gathered
    by inv_gather: the backward onto pos is inv_scatter_sum, no
    scatter-add. Needs symmetric-slotted lists (symmetrize_slots).'''
    is_periodic = torch.any((cell != 0).flatten(1), dim=-1)
    pos_j = inv_gather(pos, idx_kn, inv, inv_mask, plain)   # (B, K, N, 3)
    return minimum_image(pos[:, None] - pos_j, cell, is_periodic,
                         mic_mode=mic_mode)


def _per_frame(fn, idx, kmask, k_max):
    '''fn over each frame of (B, N, K) lists, stacked; or over one (N, K).'''
    if idx.ndim == 2:
        return fn(idx, kmask, k_max)
    outs = [fn(idx[b], kmask[b], k_max) for b in range(idx.shape[0])]
    return (np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs]))


def _symslots_fn():
    fn = _build.load_host('symslots').symmetrize_slots
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _symmetrize_frame(idx, kmask, k_max):
    N, K = idx.shape
    k_max = k_max or K
    idx_in = np.ascontiguousarray(idx, dtype=np.int32)
    mask_in = np.ascontiguousarray(kmask, dtype=np.uint8)
    if np.any(mask_in.astype(bool) & ((idx_in < 0) | (idx_in >= N))):
        raise ValueError('symmetrize_slots: a listed index is outside [0, N)')
    idx_out = np.empty((N, k_max), np.int32)
    mask_out = np.empty((N, k_max), np.uint8)
    used = _symslots_fn()(idx_in.ctypes.data, mask_in.ctypes.data, N, K,
                          k_max, idx_out.ctypes.data, mask_out.ctypes.data)
    if used < 0:
        raise ValueError(
            f'symmetrize_slots: >{k_max} shared slots needed (max degree '
            f'{int(mask_in.sum(1).max())}); raise k_max')
    return idx_out.astype(idx.dtype), mask_out.astype(bool)


def symmetrize_slots(idx, kmask, k_max=None):
    '''Re-slot a symmetric neighbour list so that each undirected edge
    (i, j) takes the SAME slot c in both endpoint rows: out_idx[i, c] = j
    and out_idx[j, c] = i. On the host, by the C++ of
    csrc/host/symslots.cpp (a copy of the JAX package's C++), one
    frame at a time.

    The edge set is unchanged. Greedy coloring in descending combined-degree
    edge order (ties in the order of the rows, then of their slots), each
    edge taking the lowest slot free in both rows; it needs a few slots
    more than the largest degree.

    Args:
        idx, kmask: (N, K) or (B, N, K) numpy arrays.
        k_max: output slot capacity (default K). Raises ValueError if the
            coloring needs more.

    Returns:
        (idx2, kmask2) with k_max slots, idx2 in idx's dtype.'''
    return _per_frame(_symmetrize_frame, np.asarray(idx), np.asarray(kmask),
                      k_max)


def _symmetrize_frame_ref(idx, kmask, k_max):
    N, K = idx.shape
    k_max = k_max or K
    rows = np.repeat(np.arange(N), K)[kmask.ravel()]
    cols = idx.ravel()[kmask.ravel()]
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
    deg = np.bincount(pairs[:, 0], minlength=N) \
        + np.bincount(pairs[:, 1], minlength=N)
    order = np.argsort(-(deg[pairs[:, 0]] + deg[pairs[:, 1]]),
                       kind='stable')
    used = np.zeros((N, k_max), bool)
    idx2 = np.zeros((N, k_max), idx.dtype)
    kmask2 = np.zeros((N, k_max), bool)
    for i, j in pairs[order]:
        free = ~(used[i] | used[j])
        if not free.any():
            raise ValueError(
                f'symmetrize_slots: >{k_max} shared slots needed '
                f'(max degree {deg.max()}); raise k_max')
        c = int(np.argmax(free))
        used[i, c] = used[j, c] = True
        idx2[i, c], idx2[j, c] = j, i
        kmask2[i, c] = kmask2[j, c] = True
    return idx2, kmask2


def symmetrize_slots_ref(idx, kmask, k_max=None):
    '''symmetrize_slots as a numpy loop over the edges (the JAX package's
    reference loop), ties in the order of sorted (lo, hi) pairs: the tests'
    reference. Nothing on the serving or training path calls it.'''
    return _per_frame(_symmetrize_frame_ref, np.asarray(idx),
                      np.asarray(kmask), k_max)


def _newton3_fn():
    fn = _build.load_host('newton3').newton3_half_list
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _half_frame(idx, kmask, k_max):
    N, K = idx.shape
    idx_in = np.ascontiguousarray(idx, dtype=np.int32)
    mask_in = np.ascontiguousarray(kmask, dtype=np.uint8)
    if np.any(mask_in.astype(bool) & ((idx_in < 0) | (idx_in >= N))):
        raise ValueError('newton3_half_list: a listed index is outside '
                         '[0, N)')
    k_out = k_max or K  # the half list never needs more than K slots
    idx_out = np.zeros((N, k_out), np.int32)
    mask_out = np.zeros((N, k_out), np.uint8)
    used = _newton3_fn()(idx_in.ctypes.data, mask_in.ctypes.data, N, K,
                         k_out, idx_out.ctypes.data, mask_out.ctypes.data)
    if used < 0:
        raise ValueError(f'newton3_half_list: needs more than k_max={k_out} '
                         'slots (max out/in degree)')
    if not k_max:
        idx_out, mask_out = idx_out[:, :used], mask_out[:, :used]
    return idx_out.astype(idx.dtype), mask_out.astype(bool)


def newton3_half_list(idx, kmask, k_max=None):
    '''Orient and slot-colour a symmetric neighbour list into a HALF list
    (Newton's third law): each undirected edge (i, j) is stored once, on
    the row of one endpoint, and the layer aggregates it onto both. On the
    host, by the C++ of csrc/host/newton3.cpp (a copy of the JAX package's
    native builder: the same lists, bit for bit), one frame at a time: an
    Eulerian orientation (out- and in-degree <= ceil(degree / 2)), then a
    Koenig edge colouring under which no two out-edges of an atom and no
    two in-edges of an atom share a slot, in exactly max(out-degree,
    in-degree) slots. The in-side condition makes each slot's map
    injective, which build_inverse_list and inv_scatter_sum need.

    Args:
        idx, kmask: (N, K) or (B, N, K) numpy arrays of a symmetric list
            (both (i, j) and (j, i) present).
        k_max: the half list's slot capacity; default the Koenig optimum
            (the largest over the frames, the others padded). Raises
            ValueError if a frame needs more.

    Returns:
        (idx2, kmask2) with k_max (or the optimum) slots, idx2 in idx's
        dtype.'''
    idx, kmask = np.asarray(idx), np.asarray(kmask)
    if idx.ndim == 2:
        return _half_frame(idx, kmask, k_max)
    outs = [_half_frame(idx[b], kmask[b], k_max) for b in range(len(idx))]
    k2 = max(o[0].shape[-1] for o in outs)
    return (np.stack([np.pad(o[0], ((0, 0), (0, k2 - o[0].shape[-1])))
                      for o in outs]),
            np.stack([np.pad(o[1], ((0, 0), (0, k2 - o[1].shape[-1])))
                      for o in outs]))


def build_reverse_list(idx, kmask):
    '''Reverse (transpose) lists of a symmetric full list idx (B, N, K):
    rev[b, n, k] is the slot r with idx[b, idx[b, n, k], r] == n, where
    atom n appears in its neighbour's own row. A one-sided edge (its
    reciprocal dropped by a k_max overflow) is masked out of rev_mask.
    Integer gathers only.

    Returns rev (B, N, K) int64 (0 where invalid) and rev_mask (B, N, K)
    bool.'''
    N = idx.shape[1]
    idx = idx.long()
    rows = _gather_rows(idx, idx)                # [b,n,k,r] = idx[b, j, r]
    valid = _gather_rows(kmask.bool(), idx)      # kmask[b, j, r]
    me = torch.arange(N, device=idx.device)[None, :, None, None]
    eq = (rows == me) & valid
    rev = torch.argmax(eq.to(torch.uint8), dim=-1)
    return rev, torch.any(eq, dim=-1) & kmask.bool()


def _pull(y, idx, rev, rev_mask):
    '''out[b, n, k] = where(rev_mask, y[b, idx[b, n, k], rev[b, n, k]], 0)
    for y (B, N, K, ...): one torch.gather of the flat slot rows.'''
    B, N, K = idx.shape
    flat = y.reshape(B, N * K, -1)
    at = (idx.long() * K + rev.long()).reshape(B, N * K, 1)
    out = torch.gather(flat, 1, at.expand(B, N * K, flat.shape[-1]))
    return _masked(out.reshape(y.shape), rev_mask)


class EdgePull(torch.autograd.Function):
    '''_pull: on the valid slots of a symmetric list the slot map (n, k)
    -> (idx[n, k], rev[n, k]) is an involution, so the linear map is its
    own transpose: backward and jvp are EdgePull again.

    apply(y, idx, rev, rev_mask) -> (B, N, K, ...)'''

    @staticmethod
    def forward(y, idx, rev, rev_mask):
        return _pull(y, idx, rev, rev_mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, rev, rev_mask = inputs
        ctx.save_for_backward(idx, rev, rev_mask)
        ctx.lists = (idx, rev, rev_mask)

    @staticmethod
    def backward(ctx, g):
        return EdgePull.apply(g, *ctx.saved_tensors), None, None, None

    @staticmethod
    def jvp(ctx, y_t, *_):
        return EdgePull.apply(y_t, *ctx.lists)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_lanes(EdgePull, info, in_dims, *args)


class EdgeGather(torch.autograd.Function):
    '''x[idx] (torch.gather at every slot) whose backward pulls the slot
    cotangents onto the reverse slots and sums them over K: grad_x[b, j] =
    sum_k cot[b, idx[b, j, k], rev[b, j, k]], gathers only (exact where
    the model does not mask; a masked slot's cotangent is zero). jvp: the
    gather of the tangent.

    apply(x, idx, rev, rev_mask) -> (B, N, K, ...)'''

    @staticmethod
    def forward(x, idx, rev, rev_mask):
        return _gather_rows(x, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, rev, rev_mask = inputs
        ctx.save_for_backward(idx, rev, rev_mask)
        ctx.lists = (idx, rev, rev_mask)

    @staticmethod
    def backward(ctx, g):
        return (EdgePull.apply(g, *ctx.saved_tensors).sum(2), None, None,
                None)

    @staticmethod
    def jvp(ctx, x_t, *_):
        return EdgeGather.apply(x_t, *ctx.lists)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_lanes(EdgeGather, info, in_dims, *args)


def edge_pull(y, idx, rev, rev_mask):
    '''Transpose-permute per-edge values of a symmetric list: out[b, n, k]
    = y[b, idx[b, n, k], rev[b, n, k]] where rev_mask, else 0. Every
    derivative order is this gather again.'''
    return EdgePull.apply(y, idx, rev, rev_mask)


def edge_gather(x, idx, rev, rev_mask):
    '''x (B, N, ...) -> (B, N, K, ...) at idx (B, N, K), with a gather-only
    backward through the reverse lists (build_reverse_list): edge_pull,
    then a sum over the slots.'''
    return EdgeGather.apply(x, idx, rev, rev_mask)


def build_inverse_list(idx_kn, kmask_kn):
    '''Per-slot inverse lists of a K-major list idx_kn (B, K, N):
    idx_kn[b, k, inv[b, k, j]] == j wherever inv_mask[b, k, j]. Exact only
    where each slot's map n -> idx_kn[k, n] is injective on valid entries,
    as for symmetric-slotted lists (there inv == idx_kn); a colliding edge
    is dropped.

    Returns inv (B, K, N) int64 (0 where invalid) and inv_mask (B, K, N)
    bool.'''
    B, K, N = idx_kn.shape
    src = torch.arange(N, device=idx_kn.device).expand(B, K, N)
    tgt = torch.where(kmask_kn, idx_kn.long(), N)  # invalid -> column N
    filled = torch.full((B, K, N + 1), -1, dtype=torch.int64,
                        device=idx_kn.device)
    filled.scatter_reduce_(2, tgt, src, reduce='amax')
    inv = filled[..., :N]
    return inv.clamp_min(0), inv >= 0


def _gather_kn(x, idx_kn, plain):
    '''x (B, N, ...) -> (B, K, N, ...) at idx_kn (B, K, N): one row
    gather.'''
    B, K, N = idx_kn.shape
    flat = x.reshape(B, x.shape[1], -1)
    fn = row_gather_ref if plain else row_gather
    out = fn(flat, idx_kn.reshape(B, K * N))
    return out.reshape((B, K, N) + x.shape[2:])


def _scatter_kn(y, inv, inv_mask, plain):
    '''out[b, j] = sum_k where(inv_mask[b, k, j], y[b, k, inv[b, k, j]], 0)
    for y (B, K, N, ...): per chunk of SCATTER_CHUNK slots one row gather
    whose source is the chunk's (B, c*N, F) stack (a view of y), then the
    mask, the sum over the chunk and the accumulation, in y's dtype (the
    JAX package's _inv_scatter_impl; its last chunk is padded with masked
    slots, here it is narrower, which adds the same zeros).'''
    B, K, N = inv.shape
    feat = y.shape[3:]
    y = y.reshape(B, K, N, -1).contiguous()
    Ff = y.shape[-1]
    fn = row_gather_ref if plain else row_gather
    acc = torch.zeros((B, N, Ff), dtype=y.dtype, device=y.device)
    for k0 in range(0, K, SCATTER_CHUNK):
        c = min(SCATTER_CHUNK, K - k0)
        offs = torch.arange(c, device=inv.device, dtype=inv.dtype) * N
        iv = (inv[:, k0:k0 + c] + offs[None, :, None]).reshape(B, c * N)
        g = fn(y[:, k0:k0 + c].reshape(B, c * N, Ff), iv)
        g = torch.where(inv_mask[:, k0:k0 + c].reshape(B, c * N, 1), g, 0)
        acc = acc + g.reshape(B, c, N, Ff).sum(1)
    return acc.reshape((B, N) + feat)


class InvGather(torch.autograd.Function):
    '''out[b, k, n] = x[b, idx_kn[b, k, n]]; backward InvScatterSum. Linear,
    so its jvp is the gather of the tangent, through apply: a reverse pass
    over that tangent runs InvScatterSum again.

    apply(x, idx_kn, inv, inv_mask, plain) -> (B, K, N, ...)'''

    @staticmethod
    def forward(x, idx_kn, inv, inv_mask, plain):
        return _gather_kn(x, idx_kn, plain)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx_kn, inv, inv_mask, plain = inputs
        ctx.save_for_backward(idx_kn, inv, inv_mask)
        ctx.lists, ctx.plain = (idx_kn, inv, inv_mask), plain

    @staticmethod
    def backward(ctx, g):
        return (InvScatterSum.apply(g, *ctx.saved_tensors, ctx.plain),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, x_t, *_):
        return InvGather.apply(x_t, *ctx.lists, ctx.plain)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_lanes(InvGather, info, in_dims, *args)


class InvScatterSum(torch.autograd.Function):
    '''The adjoint of InvGather; backward InvGather. Linear: its jvp is
    the scatter-sum of the tangent, through apply.

    apply(y, idx_kn, inv, inv_mask, plain) -> (B, N, ...)'''

    @staticmethod
    def forward(y, idx_kn, inv, inv_mask, plain):
        return _scatter_kn(y, inv, inv_mask, plain)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx_kn, inv, inv_mask, plain = inputs
        ctx.save_for_backward(idx_kn, inv, inv_mask)
        ctx.lists, ctx.plain = (idx_kn, inv, inv_mask), plain

    @staticmethod
    def backward(ctx, g):
        return (InvGather.apply(g, *ctx.saved_tensors, ctx.plain),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, y_t, *_):
        return InvScatterSum.apply(y_t, *ctx.lists, ctx.plain)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _fold_lanes(InvScatterSum, info, in_dims, *args)


def inv_gather(x, idx_kn, inv, inv_mask, plain=False):
    '''K-major neighbour gather with a scatter-free backward.

    out[b, k, n] = x[b, idx_kn[b, k, n]] (gather_nodes' values on the
    transposed list), through row_gather: kernel K9 on the card, or with
    plain=True its plain version on any device. Its cotangent accumulates
    onto the atoms through inv_scatter_sum, whose own backward is this
    gather, so every derivative order runs gathers only.

    Args:
        x: (B, N, ...) node features.
        idx_kn, inv, inv_mask: (B, K, N) forward and inverse lists
            (build_inverse_list; symmetric-slotted lists are their own).

    Returns:
        (B, K, N, ...) gathered neighbour features.'''
    return InvGather.apply(x, idx_kn, inv, inv_mask, plain)


def inv_scatter_sum(y, idx_kn, inv, inv_mask, plain=False):
    '''Adjoint of inv_gather: out[b, j] = sum over (k, n) with
    idx_kn[b, k, n] == j of y[b, k, n], as chunks of row gathers (see
    _scatter_kn). Exact only for per-slot injective lists
    (build_inverse_list).'''
    return InvScatterSum.apply(y, idx_kn, inv, inv_mask, plain)
