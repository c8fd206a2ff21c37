'''The CUDA source of kernels K7/K8 (newtonnet_tpu_torch/csrc/fused_klist.cu)
under the CPU emulation of CUDA's thread model (tests/torch_kernel_emu.py)
at the cases of KLIST_CASES at F=128; the others and the mutants are in
test_torch_kernel_emulation_klist_dual.py.
'''
import pytest

from torch_kernel_emu import (KLIST_CASES, case_params, check_klist,
                              klist_handle, klist_inputs, run_k78,
                              width_libs)

WIDE = [i for i, (shape, _, _) in enumerate(KLIST_CASES) if shape[3] >= 128]


@pytest.fixture(scope='module')
def klist_lib(tmp_path_factory):
    '''width F -> the emulated library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu_klist'), 'fused_klist',
                      klist_handle)


@pytest.mark.parametrize('shape, first_layer, bf16',
                         case_params(KLIST_CASES, WIDE))
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
