'''The CUDA source of kernels K3/K4 (newtonnet_tpu_torch/csrc/fused_dual.cu)
runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain PyTorch versions, in fp32
and bf16 mode: the cases of DUAL_CASES at F=32 here, those at F=64 and
128 in test_torch_kernel_emulation_dual_wide.py (two files, so that two
test workers share K3/K4's emulation time).
'''
import pytest

from newtonnet_tpu_torch.ops import fused_dual as fdd
from torch_kernel_emu import (BAR, BF16_BAR, DUAL_CASES, case_params,
                              compile_emu, dual_handle, dual_inputs, nan,
                              ptrs, run_dual, source, width_libs,
                              worst_ratio)

# DUAL_CASES at F=32; test_torch_kernel_emulation_dual_wide.py runs the rest
NARROW = [i for i, (shape, _, _) in enumerate(DUAL_CASES) if shape[2] == 32]


@pytest.fixture(scope='module')
def dual_lib(tmp_path_factory):
    '''width F -> the emulated library that runs F.'''
    return width_libs(tmp_path_factory.mktemp('emu_dual'), 'fused_dual',
                      dual_handle)


@pytest.mark.parametrize('shape, first_layer, bf16',
                         case_params(DUAL_CASES, NARROW))
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


def test_emulated_dual_kernels_refuse_what_they_do_not_take(dual_lib):
    '''A width the kernels do not take (0 and 288 here: they take 1 to
    256), or an R whose tiles overflow the 227 KB of shared memory a block
    may use, returns cudaErrorInvalidValue, as does a width another
    library runs (64 of the library of 32).'''
    args, cots = dual_inputs(1, 4, 32, 4, seed=0)
    out = [nan(1, 4, 32), nan(1, 3, 4, 32)] * 2 + [nan(1, 4, 32)]
    for F in (0, 288, 64):
        assert dual_lib(32).nn_dual_fwd(*ptrs(args + out), 1, 4, F, 4, 0, 0,
                                        None) == 1
    scratch = [nan(1, 4, 32)] * 6
    assert dual_lib(128).nn_dual_bwd(*ptrs(args + cots + scratch), 1, 4,
                                     128, 200, 0, 0, None) == 1


def test_emulation_catches_a_dual_kernel_fault(tmp_path):
    '''A mutant of fused_dual.cu whose K4 drops the tangent term of the
    column part of dnp (a fault of the kind that only shows through a
    reduction across blocks) fails the comparison that the source passes.'''
    src = source('fused_dual')
    good = 's += p_s[o] * ai + (pdot_s[o] * ai + h_s[o] * npdoti_s[il * F + f]);'
    assert src.count(good) == 1
    mutant = dual_handle(compile_emu(
        tmp_path, 'fused_dual_mutant',
        src.replace(good, 's += p_s[o] * ai + pdot_s[o] * ai;'), 32))
    args, cots = dual_inputs(1, 10, 32, 8, seed=3)
    fwd, bwd = run_dual(mutant, args, cots, False, False)
    want = fdd.pair_interaction_dual_bwd_ref(*args, *cots,
                                             dot_dtype='float32')
    assert worst_ratio(fwd + bwd[:1], fdd.pair_interaction_dual_fwd_ref(
        *args, dot_dtype='float32') + want[:1]) > BAR


def test_emulation_catches_a_bf16_fragment_fault(tmp_path):
    '''A mutant of fused_dual.cu whose bf16 products read the second B
    fragment register of an m16n8k16 tile from the wrong depth word (k+6
    for k+8, a fragment index of the PTX layout) fails the comparison of
    K3/K4 with their plain versions in bf16 mode that the source passes.'''
    src = source('fused_dual')
    good = 'const unsigned b[2] = {w[0], w[4]};'
    assert src.count(good) == 1
    mutant = dual_handle(compile_emu(
        tmp_path, 'fused_dual_bf16_mutant',
        src.replace(good, 'const unsigned b[2] = {w[0], w[3]};'), 32))
    args, cots = dual_inputs(1, 10, 32, 8, seed=5)
    fwd, bwd = run_dual(mutant, args, cots, False, True)
    kw = dict(dot_dtype='bfloat16')
    want = (fdd.pair_interaction_dual_fwd_ref(*args, **kw)
            + fdd.pair_interaction_dual_bwd_ref(*args, *cots, **kw))
    assert worst_ratio(fwd + bwd, want) > BF16_BAR
