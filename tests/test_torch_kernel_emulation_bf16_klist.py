'''The bf16 mode of kernels K5 and K6 (newtonnet_tpu_torch/csrc/
fused_klist.cu built with -DNN_BF16, the JAX package's pallas_dot_dtype
bfloat16) runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain bf16 versions
(ops/fused_klist.py, dot_dtype='bfloat16'): each output within BF16_BAR of
its largest magnitude and its median element error within BF16_MEDIAN_BAR
of it, the bars of chip_smoke.py phase 10a. One small shape per kernel and
layer variant at F=32 and at a padded width (F=20), with fp32 edges, and
one case with bf16 edges; K6 with and without weight cotangents. The same
library runs K7/K8 (test_torch_kernel_emulation_bf16_klist_dual.py holds
them at more shapes).
'''
import pytest

from torch_kernel_emu import (BF16_MEDIAN_BAR, bf16_errors, check_bf16_pairs,
                              compile_emu, klist_handle, klist_inputs,
                              run_k56, run_k78, source, width_libs)

# ((B, N, K, F, R), first_layer, bf16 edges)
CASES = [((2, 10, 9, 32, 8), False, False), ((2, 10, 9, 32, 8), True, False),
         ((1, 9, 7, 20, 12), False, False), ((1, 9, 7, 20, 12), True, False),
         ((1, 9, 7, 32, 8), False, True)]


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    '''width F -> the emulated bf16 library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu'), 'fused_klist',
                      klist_handle, bf16=True)


@pytest.mark.parametrize('shape, first_layer, bf16', CASES)
def test_emulated_bf16_k5_k6_match_plain(lib, shape, first_layer, bf16):
    '''K5 and K6 in bf16 mode (grids of at most 3 blocks, walking several
    atom tiles) against their plain bf16 versions; dcat and drbf are stored
    in the edge dtype on both sides.'''
    ins, _, cots = klist_inputs(*shape, first_layer, bf16, seed=sum(shape))
    got, want = run_k56(lib(shape[3]), ins, cots, first_layer, bf16,
                        dot_dtype='bfloat16')
    check_bf16_pairs(list(zip(got, want)))


def test_bf16_library_runs_k7_k8(lib):
    '''The bf16 library runs the K-list duals too (it refused them before
    their bf16 mode was ported): K7 and K8 at one small shape against their
    plain bf16 versions; the widths, layers and the mutant are in
    test_torch_kernel_emulation_bf16_klist_dual.py.'''
    ins, tans, cots = klist_inputs(1, 8, 4, 32, 8, False, False, seed=8)
    got, want = run_k78(lib(32), ins, tans, cots, False, False,
                        dot_dtype='bfloat16')
    check_bf16_pairs(list(zip(got, want)))


def test_emulation_catches_a_bf16_k5_k6_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose bf16 K5 and K6 products read the
    second B fragment word of an m16n8k16 tile from the wrong depth of the
    swizzled ring row (depth 2t.. for 2t+8..) fails the median bar that the
    source passes.'''
    src = source('fused_klist')
    good = 'b[j][1] = w[(s * 8 + t + 4) ^ sw];'
    assert src.count(good) == 2
    mutant = klist_handle(compile_emu(
        tmp_path, 'fused_klist_bf16_mutant',
        src.replace(good, 'b[j][1] = w[(s * 8 + t) ^ sw];'), 32,
        bf16=True))
    ins, _, cots = klist_inputs(1, 9, 7, 32, 8, False, False, seed=4)
    got, want = run_k56(mutant, ins, cots, False, False,
                        dot_dtype='bfloat16')
    assert max(bf16_errors(g, w)[1] for g, w in zip(got, want)) > \
        BF16_MEDIAN_BAR
