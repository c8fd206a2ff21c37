'''The CUDA source of kernel K2 (newtonnet_tpu_torch/csrc/fused_dense.cu)
runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain PyTorch version: the full
layer here, the first layer in test_torch_kernel_emulation_dense_bwd_first.py
(one file each, so that two test workers share K2's emulation time); K1,
from the same source, is in test_torch_kernel_emulation_dense.py.
'''
import pytest

from torch_kernel_emu import (BAR, DENSE_CASES, check_pairs, compile_emu,
                              dense_handle, pair_inputs, run_k2, source,
                              width_libs, worst_ratio)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    '''width F -> the emulated library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu'), 'fused_dense',
                      dense_handle)


@pytest.mark.parametrize('first_layer', [False])
@pytest.mark.parametrize('shape', DENSE_CASES)
def test_emulated_kernels_match_plain(lib, shape, first_layer):
    '''K2 at the cases of test_torch_kernel_emulation_dense.py (ragged
    atom counts, no multiple of its 8-row and 4-column tiles; at 32, 64
    and 128, each from its own library; three molecules with R=12, padded to 32), with
    and without weight cotangents.'''
    B, N, F, R = shape
    ins, dinv1, deq = pair_inputs(B, N, F, R, seed=N)
    check_pairs(run_k2(lib(F), ins, dinv1, deq, first_layer))


def test_emulation_catches_a_k2_fragment_fault(tmp_path):
    '''A mutant of fused_dense.cu whose K2 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth (k + 3 for k + 4,
    a fragment index of the PTX layout) fails the comparison of K2 with its
    plain version that the source passes.'''
    src = source('fused_dense')
    good = 'const uint2 b0 = w[0], b1 = w[4];'
    assert src.count(good) == 1
    mutant = dense_handle(compile_emu(
        tmp_path, 'fused_dense_mutant',
        src.replace(good, 'const uint2 b0 = w[0], b1 = w[3];'), 32))
    ins, dinv1, deq = pair_inputs(1, 10, 32, 8, seed=4)
    pairs = run_k2(mutant, ins, dinv1, deq, False)
    assert worst_ratio([g for g, _ in pairs], [w for _, w in pairs]) > BAR
