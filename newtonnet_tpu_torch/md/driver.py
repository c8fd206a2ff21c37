'''Host-built neighbour lists for the inverse-list serving path (the JAX
package's `md/driver.py:host_symmetric_nlist`, its inverse_lists branch).
'''
import numpy as np
import torch

from newtonnet_tpu_torch.ops.nlist import neighbor_list, symmetrize_slots


def host_symmetric_nlist(model, z, pos, cell, skin=1.0):
    '''Symmetric-slotted lists for an inverse_lists model: the 4-tuple
    (idx (B, N, K), mask (B, N, K), inv (B, K, N), inv_mask (B, K, N)) that
    NewtonNet.forward takes as nlist, K = model.k_max, on model.device.

    The full list is built on the device (ops/nlist.neighbor_list, radius
    cutoff + skin, capacity k_max; raises ValueError on overflow), copied
    to the host and re-slotted there by symmetrize_slots (the C++ of
    csrc/host/symslots.cpp), one structure at a time. With shared slots
    each slot's list is its own inverse, so inv and inv_mask are the
    K-major transposes of idx and mask.

    Args:
        model: a NewtonNet (kernel='xla', inverse_lists).
        z (B, N), pos (B, N, 3), cell (B, 3, 3): tensors or numpy arrays.
        skin: added to the cutoff for the build (0 for one request).
    '''
    if model.newton3:
        raise NotImplementedError(
            'newton3 half lists are not ported yet (ROADMAP.md A, "XLA '
            "kernel='xla' path\": newton3_half_list)")
    dev = model.device
    z, pos, cell = (torch.as_tensor(a).to(dev) for a in (z, pos, cell))
    idx, kmask, _, over = neighbor_list(pos, cell, z > 0,
                                        model.cutoff + skin, model.k_max,
                                        mic_mode=model.mic_mode)
    n_over = int(over.sum())
    if n_over:
        raise ValueError(f'neighbour overflow ({n_over} atoms over '
                         f'k_max={model.k_max})')
    idx2, kmask2 = symmetrize_slots(idx.cpu().numpy(), kmask.cpu().numpy(),
                                    k_max=model.k_max)
    idx2 = torch.from_numpy(np.ascontiguousarray(idx2)).to(dev)
    kmask2 = torch.from_numpy(np.ascontiguousarray(kmask2)).to(dev)
    return (idx2, kmask2, idx2.transpose(1, 2).contiguous(),
            kmask2.transpose(1, 2).contiguous())
