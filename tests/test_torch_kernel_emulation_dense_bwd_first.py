'''The first layer of kernel K2 (newtonnet_tpu_torch/csrc/fused_dense.cu)
under the CPU emulation of CUDA's thread model (tests/torch_kernel_emu.py),
against the plain PyTorch version; the full layer and the mutant are in
test_torch_kernel_emulation_dense_bwd.py.
'''
import pytest

from torch_kernel_emu import (DENSE_CASES, check_pairs, dense_handle,
                              pair_inputs, run_k2, width_libs)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    '''width F -> the emulated library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu'), 'fused_dense',
                      dense_handle)


@pytest.mark.parametrize('first_layer', [True])
@pytest.mark.parametrize('shape', DENSE_CASES)
def test_emulated_kernels_match_plain(lib, shape, first_layer):
    '''K2 at the cases of test_torch_kernel_emulation_dense.py (ragged
    atom counts, no multiple of its 8-row and 4-column tiles; at 32, 64
    and 128, each from its own library; three molecules with R=12, padded to 32), with
    and without weight cotangents.'''
    B, N, F, R = shape
    ins, dinv1, deq = pair_inputs(B, N, F, R, seed=N)
    check_pairs(run_k2(lib(F), ins, dinv1, deq, first_layer))
