'''Staircase-compacted newton3 half lists (the JAX package's
ops/staircase.py), for newton3_compact models.

A newton3 half list (ops/nlist.newton3_half_list) keeps every undirected
edge once in an (N, K) slot grid whose K is the largest per-atom need, so
the per-edge row operations (the fused 4F gathers, the mirror sums, the
pair MLPs) pay N*K slot rows while only about two thirds hold edges. The
staircase removes most of that padding:

  1. orient and Koenig-colour the half list, then lower each atom's
     highest colour on either side by Kempe chain flips (the dual-side
     compaction), so each atom's colours sit just above its own need;
  2. sort the atoms by need, descending (a permutation the caller applies
     to the frame);
  3. cut the colour axis into chunks of `chunk` colours; the chunk
     [k0, k0 + c) carries only the atom PREFIX that needs colours above
     k0. Both endpoints of each of its edges lie in that prefix, so each
     chunk is a square K-major block on which inv_gather and
     inv_scatter_sum run unchanged (models/xla_stack._stair).

Phase 1 is the C++ of csrc/host/staircase.cpp (a copy of the JAX
package's native builder, which shares csrc/host/graphcolor.h with
newton3.cpp), built by g++ at first use; there is no numpy fallback.
Phase 2 and 3 are numpy. One frame at a time (B = 1).
'''
import ctypes
from typing import NamedTuple

import numpy as np

from newtonnet_tpu_torch.ops import _build


class StairChunk(NamedTuple):
    '''One chunk: (1, c, n) arrays over c consecutive colours and the
    padded prefix of n sorted atoms. idx[0, t, s] is the in-side endpoint
    (a sorted atom id below n) of the edge at colour k0 + t on sorted atom
    s's out-row; inv its per-colour inverse (idx[0, t, inv[0, t, j]] == j
    where inv_mask).'''
    idx: np.ndarray
    mask: np.ndarray
    inv: np.ndarray
    inv_mask: np.ndarray


class StairList(NamedTuple):
    '''perm (N,): sorted position -> original atom id (permute z, pos and
    per-atom targets by it); inv_perm: original -> sorted position; chunks:
    StairChunks (int32 / bool); widths: (c, n) per chunk, the shape plan,
    reusable through `plan` so that every frame has the same shapes.'''
    perm: np.ndarray
    inv_perm: np.ndarray
    chunks: tuple
    widths: tuple


def _color_fn():
    fn = _build.load_host('staircase').staircase_color_edges
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64]
    return fn


def _color_edges(idx, kmask, sweeps, cap):
    '''(src, dst, color) int32 of the oriented half edges, or None when
    cap is below the Koenig optimum.'''
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    kmask = np.ascontiguousarray(kmask, dtype=np.uint8)
    n, k_in = idx.shape
    m_cap = int(kmask.sum())
    src, dst, color = (np.zeros(m_cap, np.int32) for _ in range(3))
    m = int(_color_fn()(idx.ctypes.data, kmask.ctypes.data, n, k_in, sweeps,
                        cap, src.ctypes.data, dst.ctypes.data,
                        color.ctypes.data, m_cap))
    if m < 0:
        return None
    return src[:m], dst[:m], color[:m]


def staircase_colors(idx, kmask, sweeps=6, plan=None):
    '''Phase 1 (C++): orient, colour and compact one frame's symmetric
    list (N, K). A plan colours into its palette. Returns (N, src, dst,
    color) for staircase_chunks.'''
    idx, kmask = np.asarray(idx), np.asarray(kmask)
    if idx.ndim != 2:
        raise ValueError('staircase_half_list takes one frame (N, K); '
                         'large-N trains at B=1 per chip')
    N = idx.shape[0]
    plan_cap = sum(c for c, _ in plan) if plan is not None else 0
    out = _color_edges(idx, kmask, sweeps, plan_cap)
    if out is None:  # the plan's palette is below this frame's optimum
        _, _, color = _color_edges(idx, kmask, 0, 0)
        needed = int(color.max()) + 1 if len(color) else 1
        raise ValueError(f'staircase_half_list: frame needs {needed} '
                         f'colors; the plan provides {plan_cap}')
    src, dst, color = out
    return N, src.astype(np.int64), dst.astype(np.int64), \
        color.astype(np.int64)


def _per_atom_need(src, dst, color, N):
    '''Slots needed per atom: 1 + its highest colour on either side.'''
    need = np.zeros(N, np.int64)
    np.maximum.at(need, src, color + 1)
    np.maximum.at(need, dst, color + 1)
    return need


def staircase_chunks(colored, chunk=4, pad=8, plan=None):
    '''Phase 2 and 3: the need-sorted atom order and the chunks (numpy).
    With a plan, its chunk boundaries and widths, checked to fit.'''
    N, src, dst, color = colored
    cap = int(color.max()) + 1 if len(color) else 1
    if plan is not None:
        plan_cap = sum(c for c, _ in plan)
        if cap > plan_cap:
            raise ValueError(f'staircase_half_list: frame needs {cap} '
                             f'colors; the plan provides {plan_cap}')
        cap = plan_cap
    need = _per_atom_need(src, dst, color, N)
    order = np.argsort(-need, kind='stable')
    spos = np.empty(N, np.int64)
    spos[order] = np.arange(N)

    widths, k0 = [], 0
    if plan is not None:
        for pc, pn in plan:
            n_k = int((need > k0).sum())
            n_k = max(pad, -(-n_k // pad) * pad)
            if min(n_k, N) > pn:
                raise ValueError(
                    f'staircase_half_list: chunk {len(widths)} needs '
                    f'{min(n_k, N)} rows; the plan provides {pn}')
            widths.append((pc, pn))
            k0 += pc
    else:
        while k0 < cap:
            c = min(chunk, cap - k0)
            n_k = int((need > k0).sum())
            n_k = max(pad, -(-n_k // pad) * pad)
            widths.append((c, min(n_k, N)))
            k0 += c

    starts = np.cumsum([0] + [c for c, _ in widths])
    ci_all = np.searchsorted(starts, color, side='right') - 1
    su_all, sv_all = spos[src], spos[dst]
    chunks = []
    for ci, (c, n) in enumerate(widths):
        sel = ci_all == ci
        t = color[sel] - starts[ci]
        su, sv = su_all[sel], sv_all[sel]
        if len(su) and (su.max() >= n or sv.max() >= n):
            raise AssertionError('staircase_half_list: edge endpoint beyond '
                                 'its chunk prefix')
        if (len(np.unique(t * n + su)) != len(su)
                or len(np.unique(t * n + sv)) != len(sv)):
            raise AssertionError('staircase_half_list: slot collision')
        idx_c = np.zeros((c, n), np.int32)
        mask_c = np.zeros((c, n), bool)
        inv_c = np.zeros((c, n), np.int32)
        invm_c = np.zeros((c, n), bool)
        idx_c[t, su], mask_c[t, su] = sv, True
        inv_c[t, sv], invm_c[t, sv] = su, True
        chunks.append(StairChunk(idx=idx_c[None], mask=mask_c[None],
                                 inv=inv_c[None], inv_mask=invm_c[None]))
    return StairList(perm=order.astype(np.int32),
                     inv_perm=spos.astype(np.int32), chunks=tuple(chunks),
                     widths=tuple(widths))


def staircase_half_list(idx, kmask, chunk=4, pad=8, sweeps=6, plan=None):
    '''Orient, colour, compact and chunk one frame's symmetric list (N, K)
    (both (i, j) and (j, i) present): staircase_colors, then
    staircase_chunks. Returns a StairList in which every undirected edge
    appears once and each colour's maps are injective on both sides.'''
    return staircase_chunks(staircase_colors(idx, kmask, sweeps=sweeps,
                                             plan=plan),
                            chunk=chunk, pad=pad, plan=plan)


def stair_nlist(stair):
    '''The model's nlist: the tuple of per-chunk (idx, mask, inv,
    inv_mask), for a newton3_compact model fed the frame permuted by
    stair.perm.'''
    return tuple((c.idx, c.mask, c.inv, c.inv_mask) for c in stair.chunks)
