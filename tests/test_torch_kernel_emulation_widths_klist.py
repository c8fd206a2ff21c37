'''K5-K8 (newtonnet_tpu_torch/csrc/fused_klist.cu) at widths other than
32, 64 and 128, under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain PyTorch versions.

The kernels run a width F at the next multiple of 32, Fp, with pad lanes
of their own, and read the edge tensors cat and catdot at their true width
(blocks at offsets d*F). F = 48 (Fp = 64, the trained LJ checkpoint's
width) takes the variants of test_torch_kernel_emulation_klist.py's F=64
cases (first layer or not, fp32 and bf16 edges, K6 with and without
weight cotangents) at the smallest ragged shape; F = 20 (Fp = 32, no
multiple of 8) and F = 96 (Fp = 96, no pad; a library of its own, built
with -DNN_WIDTH=96 as ops/_build.py builds it on the card) one case each.
Each library is built for its one padded width. A mutant whose weight
preparation reads the memory past F in place of the zero pad fails. The
wide tiles past F = 128 (half the slot rows, shallower weight chunks; Fp =
192 or 256) are checked on the card only, at F = 256 (chip_smoke.py phase
9a): with one std::thread per CUDA thread (csrc/emu/cuda_emu.h) a wide case
of K5-K8 costs from one to several minutes here, depending on the
machine's load.
'''
import pytest
import torch

from newtonnet_tpu_torch.ops import fused_klist as fk
from torch_kernel_emu import (BAR, check_klist, compile_emu, klist_handle,
                              klist_inputs, run_k5, run_k56, run_k78, source,
                              width_libs, worst_ratio)


@pytest.fixture(scope='module')
def libs(tmp_path_factory):
    '''width F -> the emulated library that runs F (its padded width
    alone, as ops/_build.py builds it), built at its first use.'''
    return width_libs(tmp_path_factory.mktemp('emu_widths_klist'),
                      'fused_klist', klist_handle)


@pytest.mark.parametrize('shape, first_layer, bf16', [
    ((1, 9, 6, 48, 16), False, True), ((1, 5, 6, 48, 16), True, False),
    ((2, 5, 5, 20, 8), False, False), ((1, 5, 5, 96, 8), False, True)])
def test_emulated_klist_kernels_at_any_width(libs, shape, first_layer,
                                             bf16):
    '''K5, K6 (with and without weight cotangents), K7 and K8 at a width
    with pad lanes (48 in both variants, 20 over two molecules) and at 96,
    ragged N and K, fp32 and bf16 edges, grids of at most 3 blocks: fp32
    outputs at BAR, bf16-stored ones (dcat, dcatdot, drbf) at one bf16
    ulp; masked slots give exact zeros in dcat, dcatdot and drbf.'''
    B, N, K, F, R = shape
    handle = libs(F)
    ins, tans, cots = klist_inputs(B, N, K, F, R, first_layer, bf16,
                                   seed=F + N + K)
    got, want = run_k56(handle, ins, cots, first_layer, bf16)
    check_klist(got, want, bf16)
    got2, want2 = run_k78(handle, ins, tans, cots, first_layer, bf16)
    check_klist(got2, want2, bf16)
    off = ins[4] == 0
    for g in (got[3], got[4], got[7], got[8], got2[6], got2[7]):
        assert not g.float()[off].any()


def test_emulation_catches_pad_lanes_read_from_memory(tmp_path):
    '''A mutant of fused_klist.cu whose K5/K6 weight preparation fills the
    pad rows and columns of W1a, W1b, W2a and W2b with the memory past F
    (the next rows, then what lies beyond the weight) in place of zeros
    fails the comparison of K5 with its plain version at F = 48. The
    weights sit at the start of larger buffers, so the mutant's reads stay
    in memory the test owns; the source passes on the same buffers.'''
    src = source('fused_klist')
    good = 'v = q.src == 1 ? W[(size_t)dq * Fg + n] : W[(size_t)n * Fg + dq];'
    assert src.count(good) == 1
    old_mask = '''    else if (dq >= Fg || n >= Fg)
      v = 0.0f;
'''
    assert src.count(old_mask) == 1
    F, N, K, R = 48, 5, 6, 8
    ins, _, _ = klist_inputs(1, N, K, F, R, False, False, seed=5)
    gen = torch.Generator().manual_seed(5)
    for k in range(6, 10):  # W1a, W1b, W2a, W2b with memory past them
        buf = torch.randn(2 * F * F, generator=gen) / F ** 0.5
        buf[:F * F] = ins[k].reshape(-1)
        ins[k] = buf[:F * F].view(F, F)
    worst = {}
    for name, code in (('source', src),
                       ('mutant', src.replace(old_mask, ''))):
        handle = klist_handle(compile_emu(tmp_path, f'fused_klist_pad_{name}',
                                          code, F))
        worst[name] = worst_ratio(run_k5(handle, ins, False, False),
                                  fk.klist_fwd_ref(*ins))
    assert worst['source'] <= BAR < worst['mutant'], worst
