'''The CUDA source of kernels K1/K2 (newtonnet_tpu_torch/csrc/fused_dense.cu)
runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain PyTorch versions. The card
checks the same in chip_smoke.py; this catches faults of indexing, masking,
barriers and fragment layouts before a source goes to the card.
'''
import ctypes

import pytest
import torch

from newtonnet_tpu_torch.ops import fused_dense as fd
from torch_kernel_emu import (BAR, compile_emu, nan, pair_inputs, ptrs, source,
                              worst_ratio)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    handle = compile_emu(tmp_path_factory.mktemp('emu'), 'fused_dense_emu',
                         source('fused_dense'))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_pair_fwd.argtypes = [p] * 13 + [i] * 6 + [p]
    handle.nn_pair_fwd.restype = i
    handle.nn_pair_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
    handle.nn_pair_bwd.restype = i
    handle.nn_pair_scratch_floats.argtypes = [i] * 5
    handle.nn_pair_scratch_floats.restype = ctypes.c_size_t
    return handle


def _run_pair(handle, ins, dinv1, deq, first_layer, max_blocks=3):
    '''(kernel, plain) output pairs of K1 and of K2 with and without weight
    cotangents, emulated, NaN-initialised, with scratch (NaN too) of the
    size the source gives. K1's grid is at most max_blocks blocks, so a
    block walks several tiles.'''
    B, N, F = ins[0].shape
    R = ins[1].shape[-1]
    inv1, eq = nan(B, N, F), nan(B, 3, N, F)
    scratch = nan(handle.nn_pair_scratch_floats(B, N, F, R, 2))
    assert handle.nn_pair_fwd(*ptrs(ins + [inv1, eq, scratch]), B, N, F, R,
                              int(first_layer), max_blocks, None) == 0
    pairs = list(zip((inv1, eq), fd.pair_interaction_fwd_ref(
        *ins, first_layer=first_layer)))
    n_w = R * F + 4 * F * F
    for wg in (True, False):
        outs = [nan(B, N, F), nan(B, N, N, R), nan(B, 3, N, N),
                nan(B, 3, N, F)]
        dw = nan(n_w)
        scratch = nan(handle.nn_pair_scratch_floats(B, N, F, R, int(wg)))
        assert handle.nn_pair_bwd(
            *ptrs(ins + [dinv1, deq] + outs),
            dw.data_ptr() if wg else None, scratch.data_ptr(),
            B, N, F, R, int(first_layer), int(wg), None) == 0
        if wg:
            outs += [v.view(s) for v, s in zip(
                dw.split([R * F] + [F * F] * 4), [(R, F)] + [(F, F)] * 4)]
        ref = fd.pair_interaction_bwd_ref(*ins, dinv1, deq,
                                          first_layer=first_layer,
                                          weight_grads=wg)
        pairs += list(zip(outs, ref))
    return pairs


@pytest.mark.parametrize('first_layer', [False, True])
@pytest.mark.parametrize('shape', [(2, 10, 32, 8), (1, 17, 64, 16),
                                   (1, 21, 128, 20), (3, 13, 32, 12)])
def test_emulated_kernels_match_plain(lib, shape, first_layer):
    '''Ragged atom counts (10, 13, 17, 21 are no multiple of K1's 8-row and
    8-column tiles, nor of K2's 8-row and 4-column ones), every width the
    kernels are built for, weight cotangents on and off; three molecules
    with R=12 (a radial depth padded to 32 in the products); K1's grid of
    at most 3 blocks walks several tiles.'''
    B, N, F, R = shape
    ins, dinv1, deq = pair_inputs(B, N, F, R, seed=N)
    pairs = _run_pair(lib, ins, dinv1, deq, first_layer)
    for k, (got, want) in enumerate(pairs):
        assert torch.isfinite(got).all(), k
        err = (got - want).abs().max().item()
        assert err <= BAR * want.abs().max().item(), (k, err)


def test_emulated_kernels_refuse_what_they_do_not_take(lib):
    '''F outside (32, 64, 128), or an R whose tiles overflow the 227 KB of
    shared memory a block may use, return cudaErrorInvalidValue.'''
    ins, dinv1, deq = pair_inputs(1, 4, 32, 4, seed=0)
    out = [nan(1, 4, 32), nan(1, 3, 4, 32), nan(1, 4, 32)]
    assert lib.nn_pair_fwd(*ptrs(ins + out), 1, 4, 48, 4, 0, 3, None) == 1
    assert lib.nn_pair_fwd(*ptrs(ins + out), 1, 4, 128, 900, 0, 3,
                           None) == 1


def test_emulation_catches_a_k2_fragment_fault(tmp_path):
    '''A mutant of fused_dense.cu whose K2 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth (k + 3 for k + 4,
    a fragment index of the PTX layout) fails the comparison of K2 with its
    plain version that the source passes.'''
    src = source('fused_dense')
    good = 'const uint2 b0 = w[0], b1 = w[4];'
    assert src.count(good) == 1
    mutant = compile_emu(
        tmp_path, 'fused_dense_mutant',
        src.replace(good, 'const uint2 b0 = w[0], b1 = w[3];'))
    p, i = ctypes.c_void_p, ctypes.c_int
    mutant.nn_pair_fwd.argtypes = [p] * 13 + [i] * 6 + [p]
    mutant.nn_pair_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
    mutant.nn_pair_scratch_floats.argtypes = [i] * 5
    mutant.nn_pair_scratch_floats.restype = ctypes.c_size_t
    ins, dinv1, deq = pair_inputs(1, 10, 32, 8, seed=4)
    pairs = _run_pair(mutant, ins, dinv1, deq, False)[2:]  # K2's outputs
    assert worst_ratio([g for g, _ in pairs], [w for _, w in pairs]) > BAR


def test_emulation_catches_a_k1_fragment_fault(tmp_path):
    '''A mutant of fused_dense.cu whose K1 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth of the swizzled
    ring row (k + 5 for k + 4) fails the comparison of K1 with its plain
    version that the source passes.'''
    src = source('fused_dense')
    good = 'wk4 = w[(s * 8) ^ o0 ^ 4];'
    assert src.count(good) == 1
    mutant = compile_emu(tmp_path, 'fused_dense_k1_mutant',
                         src.replace(good, 'wk4 = w[(s * 8) ^ o0 ^ 5];'))
    p, i = ctypes.c_void_p, ctypes.c_int
    mutant.nn_pair_fwd.argtypes = [p] * 13 + [i] * 6 + [p]
    mutant.nn_pair_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
    mutant.nn_pair_scratch_floats.argtypes = [i] * 5
    mutant.nn_pair_scratch_floats.restype = ctypes.c_size_t
    ins, dinv1, deq = pair_inputs(1, 10, 32, 8, seed=4)
    pairs = _run_pair(mutant, ins, dinv1, deq, False)[:2]  # K1's outputs
    assert worst_ratio([g for g, _ in pairs], [w for _, w in pairs]) > BAR
