'''The CUDA source of kernels K7/K8 (newtonnet_tpu_torch/csrc/fused_klist.cu)
runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain PyTorch versions: the
cases of KLIST_CASES at F=32 and 64 and the mutants here, those at F=128
in test_torch_kernel_emulation_klist_dual_wide.py (two files, so that two
test workers share K7/K8's emulation time). K5/K6, from the same source,
are in test_torch_kernel_emulation_klist.py.
'''
import pytest

from torch_kernel_emu import (BAR, KLIST_CASES, case_params, check_klist,
                              compile_emu, klist_handle, klist_inputs,
                              run_k78, source, width_libs, worst_ratio)

# KLIST_CASES below F=128; test_torch_kernel_emulation_klist_dual_wide.py
# runs the rest
NARROW = [i for i, (shape, _, _) in enumerate(KLIST_CASES)
          if shape[3] < 128]


@pytest.fixture(scope='module')
def klist_lib(tmp_path_factory):
    '''width F -> the emulated library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu_klist'), 'fused_klist',
                      klist_handle)


@pytest.mark.parametrize('shape, first_layer, bf16',
                         case_params(KLIST_CASES, NARROW))
def test_emulated_klist_kernels_match_plain(klist_lib, shape, first_layer,
                                            bf16):
    '''K7 and K8 at the ragged sizes of
    test_torch_kernel_emulation_klist.py's cases (N = 10 and 9 are no
    multiple of the 8-atom tiles, K = 13, 6 and 5 none of the 4-slot
    tiles), at 32, 64 and 128, each from its own library, both variants,
    fp32 and bf16 edges; K8 (tensor cores, 3xTF32) with a grid of at most 3 blocks,
    so that a block walks several atom tiles into one weight partial (R
    pads to 32 in K7's products). fp32 outputs hold BAR; the bf16-stored
    ones (dcat, dcatdot) one bf16 ulp of the output's largest magnitude.'''
    B, N, K, F, R = shape
    ins, tans, cots = klist_inputs(B, N, K, F, R, first_layer, bf16,
                                   seed=N + K)
    got, want = run_k78(klist_lib(F), ins, tans, cots, first_layer, bf16)
    check_klist(got, want, bf16)
    # masked slots: exact zeros in K8's dcat and dcatdot
    off = ins[4] == 0
    for k in (6, 7):
        assert not got[k].float()[off].any(), k


def test_emulation_catches_a_tensor_core_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K8 reads the second B fragment of
    an mma tile from the wrong depth row (k + 3 for k + 4, a fragment
    index of the PTX layout) fails the comparison of K8 with its plain
    version that the source passes.'''
    src = source('fused_klist')
    good = 'wc[(kb + 4) * S::WLD + n]'
    assert src.count(good) == 1
    mutant = klist_handle(compile_emu(
        tmp_path, 'fused_klist_mutant',
        src.replace(good, 'wc[(kb + 3) * S::WLD + n]'), 32))
    ins, tans, cots = klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = run_k78(mutant, ins, tans, cots, False, False)
    worst = max((g - w).abs().max().item() / w.abs().max().item()
                for g, w in zip(got[-9:], want[-9:]))
    assert worst > BAR


def test_emulation_catches_a_k7_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K7 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth of the swizzled
    ring row (k + 5 for k + 4) fails the comparison of K7 with its plain
    version that the source passes.'''
    src = source('fused_klist')
    good = 'wk4 = w[(s * 8) ^ o0 ^ 4];'
    assert src.count(good) == 1
    mutant = klist_handle(compile_emu(
        tmp_path, 'fused_klist_k7_mutant',
        src.replace(good, 'wk4 = w[(s * 8) ^ o0 ^ 5];'), 32))
    ins, tans, cots = klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = run_k78(mutant, ins, tans, cots, False, False)
    # inv1, eq, inv1dot, eqdot
    assert worst_ratio(got[:4], want[:4]) > BAR
