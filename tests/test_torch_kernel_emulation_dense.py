'''The CUDA source of kernel K1 (newtonnet_tpu_torch/csrc/fused_dense.cu)
runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain PyTorch version; K2, from
the same source, is in test_torch_kernel_emulation_dense_bwd.py (one file
per kernel, so that the test workers take them in parallel). The card
checks the same in chip_smoke.py; this catches faults of indexing, masking,
barriers and fragment layouts before a source goes to the card.
'''
import pytest

from torch_kernel_emu import (BAR, DENSE_CASES, check_pairs, compile_emu,
                              dense_handle, nan, pair_inputs, ptrs, run_k1,
                              source, width_libs, worst_ratio)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    '''width F -> the emulated library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu'), 'fused_dense',
                      dense_handle)


@pytest.mark.parametrize('first_layer', [False, True])
@pytest.mark.parametrize('shape', DENSE_CASES)
def test_emulated_kernels_match_plain(lib, shape, first_layer):
    '''K1 at ragged atom counts (10, 13, 17, 21 are no multiple of its
    8-row and 8-column tiles), at 32, 64 and 128 (each from its own
    library, as on the card); three
    molecules with R=12 (a radial depth padded to 32 in the products); a
    grid of at most 3 blocks walks several tiles. The same cases of K2
    are test_torch_kernel_emulation_dense_bwd.py's.'''
    B, N, F, R = shape
    ins, _, _ = pair_inputs(B, N, F, R, seed=N)
    check_pairs(run_k1(lib(F), ins, first_layer))


def test_emulated_kernels_refuse_what_they_do_not_take(lib):
    '''A width the kernels do not take (0 and 288 here: they take 1 to
    256), or an R whose tiles overflow the 227 KB of shared memory a block
    may use, returns cudaErrorInvalidValue, as does a width another
    library runs (64 of the library of 32, 48 of the one of 64).'''
    ins, dinv1, deq = pair_inputs(1, 4, 32, 4, seed=0)
    out = [nan(1, 4, 32), nan(1, 3, 4, 32), nan(1, 4, 32)]
    for F in (0, 288, 64):
        assert lib(32).nn_pair_fwd(*ptrs(ins + out), 1, 4, F, 4, 0, 3,
                                   None) == 1
    assert lib(64).nn_pair_fwd(*ptrs(ins + out), 1, 4, 48, 4, 0, 3,
                               None) == 1
    assert lib(128).nn_pair_fwd(*ptrs(ins + out), 1, 4, 128, 900, 0, 3,
                                None) == 1


def test_emulation_catches_a_k1_fragment_fault(tmp_path):
    '''A mutant of fused_dense.cu whose K1 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth of the swizzled
    ring row (k + 5 for k + 4) fails the comparison of K1 with its plain
    version that the source passes.'''
    src = source('fused_dense')
    good = 'wk4 = w[(s * 8) ^ o0 ^ 4];'
    assert src.count(good) == 1
    mutant = dense_handle(compile_emu(
        tmp_path, 'fused_dense_k1_mutant',
        src.replace(good, 'wk4 = w[(s * 8) ^ o0 ^ 5];'), 32))
    ins, _, _ = pair_inputs(1, 10, 32, 8, seed=4)
    pairs = run_k1(mutant, ins, False)
    assert worst_ratio([g for g, _ in pairs], [w for _, w in pairs]) > BAR
