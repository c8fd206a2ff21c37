'''The CUDA source of kernels K3/K4 (newtonnet_tpu_torch/csrc/fused_dual.cu)
under the CPU emulation of CUDA's thread model (tests/torch_kernel_emu.py)
at the cases of DUAL_CASES at F=64 and 128; those at F=32, the refusals
and the mutants are in test_torch_kernel_emulation_dual.py.
'''
import pytest

from newtonnet_tpu_torch.ops import fused_dual as fdd
from torch_kernel_emu import (BAR, BF16_BAR, DUAL_CASES, case_params,
                              dual_handle, dual_inputs, run_dual, width_libs,
                              worst_ratio)

WIDE = [i for i, (shape, _, _) in enumerate(DUAL_CASES) if shape[2] != 32]


@pytest.fixture(scope='module')
def dual_lib(tmp_path_factory):
    '''width F -> the emulated library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu_dual'), 'fused_dual',
                      dual_handle)


@pytest.mark.parametrize('shape, first_layer, bf16',
                         case_params(DUAL_CASES, WIDE))
def test_emulated_dual_kernels_match_plain(dual_lib, shape, first_layer,
                                           bf16):
    '''K3/K4 at ragged atom counts (10, 11, 13 and 21 are no multiple of
    the 8-row or 4-column tiles), both variants and both dot dtypes at F=32
    and 64; at F=128 the training path's variant (the card runs them
    all, chip_smoke.py phase 3); three molecules with R=12 (a radial depth
    padded to 32 in the tensor-core products), in both modes. fp32 mode
    holds
    BAR. bf16 mode holds BF16_BAR = 2e-3: where an fp32 sum of the kernel
    and of the plain version differ in their last bit, the bf16 roundings
    of a later product operand (h, g, dp, msg, rbf-tangent products) can
    differ by one bf16 ulp (2^-8 = 3.9e-3 relative) in that one element;
    summed with the others into an output, that moves it well under 1e-3
    of its largest magnitude.'''
    B, N, F, R = shape
    args, cots = dual_inputs(B, N, F, R, seed=N)
    dot_dtype = 'bfloat16' if bf16 else 'float32'
    fwd, bwd = run_dual(dual_lib(F), args, cots, first_layer, bf16)
    want_f = fdd.pair_interaction_dual_fwd_ref(*args, first_layer=first_layer,
                                               dot_dtype=dot_dtype)
    want_b = fdd.pair_interaction_dual_bwd_ref(*args, *cots,
                                               first_layer=first_layer,
                                               dot_dtype=dot_dtype)
    worst = max(worst_ratio(fwd, want_f), worst_ratio(bwd, want_b))
    assert worst <= (BF16_BAR if bf16 else BAR), worst
    if first_layer:  # dnpdot, dforce, dforcedot, dW2a, dW2b: exact zeros
        for k in (1, 2, 3, 7, 8):
            assert not bwd[k].any(), k
