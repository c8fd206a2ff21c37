'''Host-built neighbour lists for the inverse-list and newton3 serving
paths (the JAX package's `md/driver.py:host_symmetric_nlist`). The MD
driver itself, with its staircase host rebuild, is ROADMAP.md A, "MD".
'''
import numpy as np
import torch

from newtonnet_tpu_torch.data.prelists import cell_list_neighbors
from newtonnet_tpu_torch.ops.nlist import (
    build_inverse_list,
    newton3_half_list,
    symmetrize_slots,
)


def host_symmetric_nlist(model, z, pos, cell, skin=1.0):
    '''The 4-tuple (idx (B, N, K), mask (B, N, K), inv (B, K, N), inv_mask
    (B, K, N)) that NewtonNet.forward takes as nlist for an inverse_lists
    or a newton3 model, K = model.k_max, on model.device.

    The full list of each structure's real atoms (z > 0, at the end of the
    row: padding) is built on the host by the C++ cell list
    (data/prelists.cell_list_neighbors, radius cutoff + skin; raises
    ValueError on overflow), as the JAX package builds it, so that the
    lists are the JAX package's, bit for bit; then:
    * inverse_lists: re-slotted by symmetrize_slots (csrc/host/
      symslots.cpp) at capacity k_max. With shared slots each slot's list
      is its own inverse, so inv and inv_mask are the K-major transposes of
      idx and mask.
    * newton3: k_max is the HALF list's capacity, so the full list is
      built at 2 * k_max + 8 and oriented and coloured by
      newton3_half_list (csrc/host/newton3.cpp; ValueError if the half
      list needs more than k_max slots). A half list is no involution:
      inv and inv_mask come from build_inverse_list on the device.

    Args:
        model: a NewtonNet (kernel='xla', inverse_lists or newton3).
        z (B, N), pos (B, N, 3), cell (B, 3, 3): tensors or numpy arrays.
        skin: added to the cutoff for the build (0 for one request).
    '''
    dev = model.device
    z, pos, cell = (np.asarray(torch.as_tensor(a).detach().cpu())
                    for a in (z, pos, cell))
    k = model.k_max
    k_full = 2 * k + 8 if model.newton3 else k
    B, N = z.shape
    idx = np.zeros((B, N, k_full), np.int32)
    kmask = np.zeros((B, N, k_full), bool)
    for b in range(B):
        n_real = int((z[b] > 0).sum())
        idx_r, count, over = cell_list_neighbors(
            pos[b, :n_real], cell[b] if cell[b].any() else None,
            model.cutoff + skin, k_full)
        if over:
            raise ValueError(f'neighbour overflow ({over} atoms over '
                             f'k_max={k_full})')
        idx[b, :n_real] = idx_r
        kmask[b, :n_real] = np.arange(k_full)[None, :] < count[:, None]
    if model.newton3:
        try:
            idx2, kmask2 = newton3_half_list(idx, kmask, k_max=k)
        except ValueError:
            raise ValueError(
                f'newton3 half list needs more than k_max={k} slots at '
                f'build radius cutoff+skin={model.cutoff + skin:g} A; '
                'raise model k_max or lower the skin') from None
    else:
        idx2, kmask2 = symmetrize_slots(idx, kmask, k_max=k)
    idx2 = torch.from_numpy(idx2.astype(np.int64)).to(dev)
    kmask2 = torch.from_numpy(np.ascontiguousarray(kmask2)).to(dev)
    idx_kn, kmask_kn = (idx2.transpose(1, 2).contiguous(),
                        kmask2.transpose(1, 2).contiguous())
    if model.newton3:
        return (idx2, kmask2) + build_inverse_list(idx_kn, kmask_kn)
    return idx2, kmask2, idx_kn, kmask_kn
