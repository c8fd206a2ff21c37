'''The bf16 mode of kernels K7 and K8 (newtonnet_tpu_torch/csrc/
fused_klist.cu built with -DNN_BF16, the JAX package's pallas_dot_dtype
bfloat16) runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain bf16 versions
(ops/fused_klist.py, dot_dtype='bfloat16'): each output within BF16_BAR of
its largest magnitude and its median element error within BF16_MEDIAN_BAR
of it, the bars of chip_smoke.py phases 10a and 11a. One small ragged
shape at F=32 (full layer, fp32 edges) and one at a padded width (F=20,
first layer, bf16 edges); K8's grid is at most 3 blocks, so a block walks
several atom tiles into one weight partial.
'''
import pytest

from torch_kernel_emu import (BF16_MEDIAN_BAR, bf16_errors, check_bf16_pairs,
                              compile_emu, klist_handle, klist_inputs,
                              run_k78, source, width_libs)

# ((B, N, K, F, R), first_layer, bf16 edges): N = 10 and 9 are no multiple
# of the 8-atom tiles, K = 9 and 7 none of the 4-slot tiles, R pads to 32
CASES = [((2, 10, 9, 32, 8), False, False), ((1, 9, 7, 20, 12), True, True)]


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    '''width F -> the emulated bf16 library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu'), 'fused_klist',
                      klist_handle, bf16=True)


@pytest.mark.parametrize('shape, first_layer, bf16', CASES)
def test_emulated_bf16_k7_k8_match_plain(lib, shape, first_layer, bf16):
    '''K7 and K8 in bf16 mode against their plain bf16 versions: the dual
    forward, dnpi, dnpidot, dcat and dcatdot (in the edge dtype on both
    sides) and the five weight cotangents; masked slots give exact zeros
    in dcat and dcatdot.'''
    ins, tans, cots = klist_inputs(*shape, first_layer, bf16,
                                   seed=sum(shape))
    got, want = run_k78(lib(shape[3]), ins, tans, cots, first_layer, bf16,
                        dot_dtype='bfloat16')
    check_bf16_pairs(list(zip(got, want)))
    off = ins[4] == 0
    for k in (6, 7):
        assert not got[k].float()[off].any(), k


def test_emulation_catches_a_bf16_k8_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose bf16 K8 products read the second B
    fragment word of an m16n8k16 tile from the wrong depth of the swizzled
    chunk row (depth 2t.. for 2t+8..) fails the median bar that the source
    passes.'''
    src = source('fused_klist')
    good = 'wr[(s * 8 + t + 4) ^ sw]'
    assert src.count(good) == 1
    mutant = klist_handle(compile_emu(
        tmp_path, 'fused_klist_bf16_k8_mutant',
        src.replace(good, 'wr[(s * 8 + t) ^ sw]'), 32, bf16=True))
    ins, tans, cots = klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = run_k78(mutant, ins, tans, cots, False, False,
                        dot_dtype='bfloat16')
    # K8's outputs: dnpi, dnpidot, dcat, dcatdot and the weight cotangents
    assert max(bf16_errors(g.float(), w.float())[1]
               for g, w in zip(got[4:], want[4:])) > BF16_MEDIAN_BAR
