'''The bf16 mode of kernels K1 and K2 (newtonnet_tpu_torch/csrc/
fused_dense.cu built with -DNN_BF16, the JAX package's pallas_dot_dtype
bfloat16) runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain bf16 versions
(ops/fused_dense.py, dot_dtype='bfloat16'): each output within BF16_BAR of
its largest magnitude and its median element error within BF16_MEDIAN_BAR
of it, the bars of chip_smoke.py phase 10a. One small shape per kernel and
layer variant, at F=32 and at a padded width (F=20, the library of 32
with its pad lanes masked); K2 with and without weight cotangents. The
K-list kernels' bf16 mode is test_torch_kernel_emulation_bf16_klist.py's.
'''
import pytest

from torch_kernel_emu import (BF16_MEDIAN_BAR, bf16_errors, check_bf16_pairs,
                              compile_emu, dense_handle, pair_inputs, run_k1,
                              run_k2, source, width_libs)

# (B, N, F, R): ragged atom counts (no multiple of K1's 8 x 8 or K2's 8 x
# 4 tiles) and radial depths padded to 32
CASES = [(2, 10, 32, 12), (1, 11, 20, 8)]


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    '''width F -> the emulated bf16 library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu'), 'fused_dense',
                      dense_handle, bf16=True)


@pytest.mark.parametrize('first_layer', [False, True])
@pytest.mark.parametrize('shape', CASES)
def test_emulated_bf16_k1_k2_match_plain(lib, shape, first_layer):
    '''K1 (a grid of 3 blocks walking several tiles) and K2 in bf16 mode
    against their plain bf16 versions: K2's chain and weight cotangents in
    bf16, its cotangent products in 3xTF32.'''
    B, N, F, R = shape
    ins, dinv1, deq = pair_inputs(B, N, F, R, seed=N + F)
    check_bf16_pairs(run_k1(lib(F), ins, first_layer, dot_dtype='bfloat16')
                     + run_k2(lib(F), ins, dinv1, deq, first_layer,
                              dot_dtype='bfloat16'))


def test_emulation_catches_a_bf16_k1_fragment_fault(tmp_path):
    '''A mutant of fused_dense.cu whose bf16 K1 products read the second B
    fragment word of an m16n8k16 tile from the wrong depth of the swizzled
    ring row (depth 2t.. for 2t+8..) fails the median bar that the source
    passes.'''
    src = source('fused_dense')
    good = 'b[j][1] = w[(s * 8 + t + 4) ^ sw];'
    assert src.count(good) == 1
    mutant = dense_handle(compile_emu(
        tmp_path, 'fused_dense_bf16_mutant',
        src.replace(good, 'b[j][1] = w[(s * 8 + t) ^ sw];'), 32,
        bf16=True))
    ins, _, _ = pair_inputs(1, 10, 32, 8, seed=4)
    pairs = run_k1(mutant, ins, False, dot_dtype='bfloat16')
    assert max(bf16_errors(g, w)[1] for g, w in pairs) > BF16_MEDIAN_BAR
