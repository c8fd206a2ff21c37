'''Precomputed per-frame neighbour lists for training datasets (the JAX
package's data/prelists.py).

A training frame's geometry never changes, so its list is built once on
the host, cached, and fed through the batch: the step then builds no
graph, and it can use the list formats that need a host-side slot
colouring:

  * mode='inverse': symmetric-slotted lists (ops/nlist.symmetrize_slots)
    for inverse_lists models;
  * mode='newton3': newton3 half lists (ops/nlist.newton3_half_list) for
    newton3 models;
  * mode='newton3c' (NeighborListDataset only): staircase chunks
    (ops/staircase.py) for newton3_compact models.

The full list comes from the O(N) cell-list search of
csrc/host/celllist.cpp (a copy of the JAX package's native one, built by
g++ at first use; no fallback). The model recomputes displacements from
pos, so derivatives through positions stay exact; only the integer index
structure is precomputed.
'''
import ctypes

import numpy as np

from newtonnet_tpu_torch.data.loader import Sample
from newtonnet_tpu_torch.ops import _build
from newtonnet_tpu_torch.ops.nlist import newton3_half_list, symmetrize_slots


def cell_list_neighbors(pos, cell, cutoff, k_max):
    '''Padded neighbour list of one system by the C++ cell list.

    Args:
        pos: (n, 3) positions (wrapped into the cell here if periodic).
        cell: (3, 3) lattice rows, or None / zeros for aperiodic.
        cutoff: radius; k_max: neighbour capacity.

    Returns:
        idx (n, k_max) int32, count (n,) int32, overflow (int: neighbours
        in range beyond k_max).'''
    lib = _build.load_host('celllist')
    fn = lib.cell_list_neighbors
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_double, ctypes.c_int32, ctypes.c_void_p,
                   ctypes.c_void_p]
    pos = np.ascontiguousarray(pos, np.float64)
    n = pos.shape[0]
    cell_arr = (np.zeros((3, 3)) if cell is None
                else np.ascontiguousarray(cell, np.float64))
    if cell_arr.any():
        # bins and raw distances agree only inside the cell
        frac = pos @ np.linalg.inv(cell_arr)
        pos = np.ascontiguousarray((frac - np.floor(frac)) @ cell_arr)
    idx = np.zeros((n, k_max), np.int32)
    count = np.zeros(n, np.int32)
    overflow = fn(pos.ctypes.data, n, cell_arr.ctypes.data, float(cutoff),
                  int(k_max), idx.ctypes.data, count.ctypes.data)
    return idx, count, int(overflow)


def frame_neighbor_lists(z, pos, cell, cutoff, k_max, mode='plain',
                         mic_mode='exact'):
    '''One frame's padded neighbour list, built on the host.

    Args:
        z: (N,) atomic numbers (padding, z == 0, at the end: no edges).
        pos: (N, 3); cell: (3, 3) lattice rows or zeros.
        cutoff: radius.
        k_max: the capacity of the RETURNED list: the full list's for
            'plain' / 'inverse', the half list's (>= ceil(max degree / 2))
            for 'newton3', whose full list is built at 2 * k_max + 8.
        mode: 'plain' | 'inverse' | 'newton3'.
        mic_mode: accepted for the JAX signature; the cell list takes the
            exact minimum image.

    Returns:
        idx (N, k_max) int32, mask (N, k_max) bool.'''
    del mic_mode
    z = np.asarray(z)
    pos = np.asarray(pos, np.float64)
    cell = np.asarray(cell, np.float64)
    n = len(z)
    n_real = int((z > 0).sum())
    if (z[:n_real] <= 0).any():
        raise ValueError('padding atoms (z == 0) must sit at the end')
    if mode not in ('plain', 'inverse', 'newton3'):
        raise ValueError(f'unknown mode {mode}')
    build_k = 2 * k_max + 8 if mode == 'newton3' else k_max
    idx_r, count, ovf = cell_list_neighbors(
        pos[:n_real], cell if cell.any() else None, cutoff, build_k)
    if ovf:
        raise ValueError(f'neighbor overflow ({ovf} atoms exceed '
                         f'k={build_k}); raise k_max')
    idx = np.zeros((n, build_k), np.int32)
    mask = np.zeros((n, build_k), bool)
    idx[:n_real] = idx_r
    mask[:n_real] = np.arange(build_k)[None, :] < count[:, None]
    if mode == 'plain':
        return idx, mask
    if mode == 'inverse':
        idx2, m2 = symmetrize_slots(idx, mask, k_max=k_max)
    else:
        idx2, m2 = newton3_half_list(idx, mask, k_max=k_max)
    return idx2.astype(np.int32), m2


# the per-atom arrays permuted into the staircase's atom order (those of
# them a sample carries, one row per atom)
STAIR_PERMUTED_KEYS = ('z', 'pos', 'force', 'charge')


class NeighborListDataset:
    '''A dataset whose samples carry their precomputed lists: 'nlist_idx'
    and 'nlist_mask' (N, k_max), which data/loader.collate pads and the
    Trainer hands to the model. Lists are built at first access and
    cached.

    Match cutoff and k_max to the model, and the mode to its layout
    ('inverse' for inverse_lists, 'newton3' for newton3, 'newton3c' for
    newton3_compact).

    mode='newton3c' (staircase chunks, ops/staircase.py): samples gain
    'nlist_stair', the tuple of per-chunk (idx, mask, inv, inv_mask), and
    the frame's per-atom arrays (STAIR_PERMUTED_KEYS) are permuted into the
    staircase's need-sorted order (the loss is permutation-covariant;
    per-atom predictions come back in that order). The first frame built
    fixes the shape plan (its chunk widths plus `stair_margin` spare rows,
    and `stair_extra_colors` spare colours, default one chunk); a later
    frame that does not fit raises.'''

    def __init__(self, dataset, cutoff, k_max, mode='plain',
                 mic_mode='exact', stair_chunk=4, stair_pad=8,
                 stair_margin=16, stair_extra_colors=None):
        self.dataset = dataset
        self.cutoff = cutoff
        self.k_max = k_max
        self.mode = mode
        self.mic_mode = mic_mode
        self.stair_chunk = stair_chunk
        self.stair_pad = stair_pad
        self.stair_margin = stair_margin
        self.stair_extra_colors = (stair_chunk if stair_extra_colors is None
                                   else stair_extra_colors)
        self._stair_plan = None
        self._cache = {}

    def __len__(self):
        return len(self.dataset)

    @property
    def max_atoms(self):
        return self.dataset.max_atoms

    @property
    def precision(self):
        return self.dataset.precision

    @property
    def frame_sizes(self):
        # the wrapped dataset's (AttributeError where it has none)
        return self.dataset.frame_sizes

    def __getitem__(self, i):
        s = Sample(self.dataset[i])
        if self.mode == 'newton3c':
            if i not in self._cache:
                self._cache[i] = self._build_stair(s)
            sl = self._cache[i]
            for key in STAIR_PERMUTED_KEYS:
                v = s.get(key)
                if v is not None and np.ndim(v) >= 1 \
                        and len(v) == len(sl.perm):
                    s[key] = np.asarray(v)[sl.perm]
            s['nlist_stair'] = tuple(tuple(a[0] for a in ch)
                                     for ch in sl.chunks)
            return s
        if i not in self._cache:
            self._cache[i] = frame_neighbor_lists(
                s.z, s.pos, s.cell, self.cutoff, self.k_max, mode=self.mode,
                mic_mode=self.mic_mode)
        s['nlist_idx'], s['nlist_mask'] = self._cache[i]
        return s

    def _build_stair(self, s):
        from newtonnet_tpu_torch.ops.staircase import (staircase_chunks,
                                                       staircase_colors)
        idx, mask = frame_neighbor_lists(
            s['z'], s['pos'], s['cell'], self.cutoff, 2 * self.k_max + 8,
            mode='plain', mic_mode=self.mic_mode)
        try:
            colored = staircase_colors(idx, mask, plan=self._stair_plan)
            if self._stair_plan is None:
                # this frame's widths plus spare rows, so that the frames
                # of a homogeneous dataset fit one shape
                pad = self.stair_pad
                m = -(-self.stair_margin // pad) * pad
                first = staircase_chunks(colored, chunk=self.stair_chunk,
                                         pad=pad)
                nmax = int(getattr(self.dataset, 'max_atoms', None)
                           or len(s['z']))

                def width(n):
                    return min(n + m, nmax)
                plan = [(c, width(n)) for c, n in first.widths]
                if self.stair_extra_colors:
                    plan.append((self.stair_extra_colors,
                                 width(first.widths[-1][1])))
                self._stair_plan = tuple(plan)
            return staircase_chunks(colored, chunk=self.stair_chunk,
                                    pad=self.stair_pad,
                                    plan=self._stair_plan)
        except ValueError as e:
            raise ValueError(
                f'{e} -- a frame exceeded the staircase shape plan fixed '
                'by the first frame; raise stair_margin (or rebuild the '
                'dataset wrapper so a representative frame comes first)'
            ) from None
