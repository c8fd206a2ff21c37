'''K1-K4 (newtonnet_tpu_torch/csrc/fused_dense.cu and fused_dual.cu) at
widths other than 32, 64 and 128, under the emulation of CUDA's thread
model (tests/torch_kernel_emu.py), against the plain PyTorch versions.

The kernels run a width F at a padded width Fp (the next multiple of 32,
past 128 of 64) with pad lanes of their own: F = 48 (Fp = 64, the trained
LJ checkpoint's width) in the variants of test_torch_kernel_emulation_
dense.py and _dual.py (first layer or not, weight cotangents on and off,
bf16 and fp32 duals), F = 20 (Fp = 32, no multiple of 8) and F = 96 (Fp =
96, no pad; a library of its own, built with -DNN_WIDTH=96 as
ops/_build.py builds it on the card) one case each, at the smallest ragged
shapes (N = 5 or 9). Each library is built for its one padded width. A
mutant whose weight preparation reads the memory past F in place of the
zero pad fails. The wide tiles past F = 128 (half the slot rows, Fp = 192
or 256) are checked on the card only, at F = 256 (chip_smoke.py phase 9a):
with one std::thread per CUDA thread (csrc/emu/cuda_emu.h) a wide case
costs from 20 s to over a minute here, depending on the machine's load.
'''
import pytest
import torch

from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_dual as fdd
from torch_kernel_emu import (BAR, BF16_BAR, check_pairs, compile_emu,
                              dense_handle, dual_handle, dual_inputs, nan,
                              pair_inputs, ptrs, run_dual, run_pair, source,
                              width_libs, worst_ratio)


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    '''(source, width F) -> the emulated library that runs F (its padded
    width alone, as ops/_build.py builds it), built at its first use.'''
    out = tmp_path_factory.mktemp('emu_widths')
    get = {'fused_dense': width_libs(out, 'fused_dense', dense_handle),
           'fused_dual': width_libs(out, 'fused_dual', dual_handle)}
    return lambda name, F: get[name](F)


def _worst_dual(handle, args, cots, first_layer, bf16):
    '''Worst ratio of K3's and K4's outputs against their plain versions.'''
    fwd, bwd = run_dual(handle, args, cots, first_layer, bf16)
    kw = dict(first_layer=first_layer,
              dot_dtype='bfloat16' if bf16 else 'float32')
    return worst_ratio(
        fwd + bwd, list(fdd.pair_interaction_dual_fwd_ref(*args, **kw))
        + list(fdd.pair_interaction_dual_bwd_ref(*args, *cots, **kw)))


@pytest.mark.parametrize('F, N, R, first_layer', [
    (48, 9, 12, False), (48, 5, 12, True), (20, 5, 8, False),
    (96, 5, 8, False)])
def test_emulated_k1_k2_at_any_width(libs, F, N, R, first_layer):
    '''K1 and K2 (weight cotangents on and off) at a width with pad lanes
    (48 in both variants, 20) and at 96 (its own library), ragged N (no
    multiple of the 8-row and 8- or 4-column tiles) and R padded to 32: BAR
    against the plain versions, NaN-filled outputs all written.'''
    ins, dinv1, deq = pair_inputs(1, N, F, R, seed=F + N)
    check_pairs(run_pair(libs('fused_dense', F), ins, dinv1, deq,
                         first_layer))


@pytest.mark.parametrize('F, N, R, first_layer, bf16', [
    (48, 5, 12, False, False), (48, 5, 12, False, True),
    (48, 5, 12, True, False), (48, 5, 12, True, True),
    (20, 5, 8, False, True), (96, 5, 8, False, True)])
def test_emulated_k3_k4_at_any_width(libs, F, N, R, first_layer, bf16):
    '''K3 and K4 at a width with pad lanes (48 in both variants and both
    dot modes, 20 in bf16) and at 96: BAR in fp32 mode, BF16_BAR in bf16
    mode (test_torch_kernel_emulation_dual.py derives it): the pad lanes
    round to bf16 zeros, so they change no bf16 product.'''
    args, cots = dual_inputs(1, N, F, R, seed=F + N)
    worst = _worst_dual(libs('fused_dual', F), args, cots,
                      first_layer, bf16)
    assert worst <= (BF16_BAR if bf16 else BAR), worst


def test_emulation_catches_pad_lanes_read_from_memory(tmp_path):
    '''A mutant of fused_dense.cu whose K1 weight preparation fills the pad
    rows and columns of W1a, W1b, W2a and W2b with the memory past F (the
    next rows, then what lies beyond the weight) in place of zeros fails
    the comparison of K1 with its plain version at F = 48. The weights sit
    at the start of larger buffers, so the mutant's reads stay in memory
    the test owns; the source passes on the same buffers.'''
    src = source('fused_dense')
    good = 'v = q < Fg && n < Fg ? W[(size_t)q * Fg + n] : 0.0f;'
    assert src.count(good) == 1
    bad = 'v = W[(size_t)q * Fg + n];'
    F, N, R = 48, 5, 12
    ins, dinv1, deq = pair_inputs(1, N, F, R, seed=3)
    gen = torch.Generator().manual_seed(3)
    for k in range(6, 10):  # W1a, W1b, W2a, W2b with memory past them
        buf = torch.randn(2 * F * F, generator=gen) / F ** 0.5
        buf[:F * F] = ins[k].reshape(-1)
        ins[k] = buf[:F * F].view(F, F)
    worst = {}
    for name, code in (('source', good), ('mutant', bad)):
        handle = dense_handle(compile_emu(
            tmp_path, f'fused_dense_pad_{name}', src.replace(good, code), F))
        inv1, eq = nan(1, N, F), nan(1, 3, N, F)
        scratch = nan(handle.nn_pair_scratch_floats(1, N, F, R, 2))
        assert handle.nn_pair_fwd(*ptrs(ins + [inv1, eq, scratch]), 1, N, F,
                                  R, 0, 3, None) == 0
        worst[name] = worst_ratio([inv1, eq],
                                  fd.pair_interaction_fwd_ref(*ins))
    assert worst['source'] <= BAR < worst['mutant'], worst
