'''The CUDA source of kernels K5/K6 (newtonnet_tpu_torch/csrc/fused_klist.cu)
runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain PyTorch versions. K7/K8,
from the same source, are in test_torch_kernel_emulation_klist_dual.py:
one file per kernel pair, so that the test workers take them in parallel.
'''
import pytest
import torch

from newtonnet_tpu_torch.ops import fused_klist as fk
from torch_kernel_emu import (BAR, KLIST_CASES, check_klist, compile_emu,
                              klist_handle, klist_inputs, nan, ptrs, run_k5,
                              run_k56, source, width_libs, worst_ratio)


@pytest.fixture(scope='module')
def klist_lib(tmp_path_factory):
    '''width F -> the emulated library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu_klist'), 'fused_klist',
                      klist_handle)


@pytest.mark.parametrize('shape, first_layer, bf16', KLIST_CASES)
def test_emulated_klist_kernels_match_plain(klist_lib, shape, first_layer,
                                            bf16):
    '''K5 and K6 at ragged sizes (N = 10 and 9 are no multiple of the
    8-atom tiles, K = 13, 6 and 5 none of the 8- or 4-slot tiles), every
    width of 32, 64 and 128 (each from its own library, as on the card),
    both variants, fp32 and bf16 edges, K6
    with and without weight cotangents; K6 (tensor cores, 3xTF32) with a
    grid of at most 3 blocks, so that a block walks several atom tiles,
    the weight stream runs across them and the weight partial sums them
    (R = 8, 16 and 20 pad to 32 in K6's products). fp32 outputs hold BAR;
    the bf16-stored ones (dcat, drbf) one bf16 ulp, 2^-8 of the output's
    largest magnitude (a last-bit fp32 difference before the rounding can
    move a value to the neighbouring bf16 value). The same cases of K7/K8
    are test_torch_kernel_emulation_klist_dual.py's.'''
    B, N, K, F, R = shape
    ins, _, cots = klist_inputs(B, N, K, F, R, first_layer, bf16,
                                seed=N + K)
    got, want = run_k56(klist_lib(F), ins, cots, first_layer, bf16)
    check_klist(got, want, bf16)
    # masked slots: exact zeros in K6's dcat and drbf
    off = ins[4] == 0
    for k in (3, 4, 7, 8):
        assert not got[k].float()[off].any(), k


def test_emulated_klist_kernels_refuse_what_they_do_not_take(klist_lib):
    '''A width the kernels do not take (0 and 288 here: they take 1 to
    256), an R whose tiles overflow the 227 KB of shared memory a block may
    use, or an empty list: cudaErrorInvalidValue, as does a width another
    library runs (64 of the library of 32).'''
    ins, _, _ = klist_inputs(1, 4, 3, 32, 4, False, False, seed=0)
    out = [nan(1, 4, 32), nan(1, 3, 4, 32), nan(4096)]
    for F in (0, 288, 64):
        assert klist_lib(32).nn_klist_fwd(*ptrs(ins + out), 1, 4, 3, F, 4, 0,
                                          0, 1, None) == 1
    assert klist_lib(128).nn_klist_fwd(*ptrs(ins + out), 1, 4, 3, 128, 900,
                                       0, 0, 1, None) == 1
    assert klist_lib(32).nn_klist_fwd(*ptrs(ins + out), 1, 4, 0, 32, 4, 0, 0,
                                      1, None) == 1


def test_emulation_catches_a_k6_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K6 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth of the swizzled
    ring row (k + 5 for k + 4) fails the comparison of K6 with its plain
    version that the source passes.'''
    src = source('fused_klist')
    good = 'b4 = w[(s * 8) ^ o0 ^ 4];'
    assert src.count(good) == 1
    mutant = klist_handle(compile_emu(
        tmp_path, 'fused_klist_k6_mutant',
        src.replace(good, 'b4 = w[(s * 8) ^ o0 ^ 5];'), 32))
    ins, _, cots = klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = run_k56(mutant, ins, cots, False, False)
    # K6 without and with weight cotangents: dnpi, dcat, drbf, ddir, dW*
    assert worst_ratio(got[2:15], want[2:15]) > BAR


@pytest.mark.parametrize('first_layer, bf16', [(False, True), (True, False)])
def test_emulated_k5_walks_atom_tiles_and_repeats_its_bits(klist_lib,
                                                           first_layer, bf16):
    '''K5 (tensor cores, 3xTF32, 16-atom tiles of 128 slot rows) with a grid
    of 3 blocks over 6 tiles of two molecules (N = 37, no multiple of 16; K
    = 11, no multiple of the 8-slot step), so that each block walks two
    tiles and the weight stream runs across steps and tiles: BAR against
    its plain version, and a second launch gives the same bits.'''
    ins, _, _ = klist_inputs(2, 37, 11, 32, 8, first_layer, bf16, seed=37)
    got = run_k5(klist_lib(32), ins, first_layer, bf16)
    want = fk.klist_fwd_ref(*ins, first_layer=first_layer)
    assert worst_ratio(got, want) <= BAR
    again = run_k5(klist_lib(32), ins, first_layer, bf16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_emulation_catches_a_k5_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K5 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth of the swizzled
    ring row (k + 5 for k + 4) fails the comparison of K5 with its plain
    version that the source passes.'''
    src = source('fused_klist')
    good = 'u4 = w[(s * 8) ^ o0 ^ 4];'
    assert src.count(good) == 1
    mutant = klist_handle(compile_emu(
        tmp_path, 'fused_klist_k5_mutant',
        src.replace(good, 'u4 = w[(s * 8) ^ o0 ^ 5];'), 32))
    ins, _, _ = klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got = run_k5(mutant, ins, False, False)
    assert worst_ratio(got, fk.klist_fwd_ref(*ins)) > BAR
