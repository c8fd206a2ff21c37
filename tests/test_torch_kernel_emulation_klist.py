'''The CUDA source of kernels K5-K8 (newtonnet_tpu_torch/csrc/fused_klist.cu)
runs on the CPU under the emulation of CUDA's thread model
(tests/torch_kernel_emu.py), against the plain PyTorch versions.
'''
import ctypes

import numpy as np
import pytest
import torch

from newtonnet_tpu_torch.ops import fused_klist as fk
from torch_kernel_emu import BAR, compile_emu, nan, ptrs, source, worst_ratio


def _klist_handle(handle):
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_klist_fwd.argtypes = [p] * 13 + [i] * 8 + [p]
    handle.nn_klist_bwd.argtypes = [p] * 19 + [i] * 9 + [p]
    handle.nn_klist_dual_fwd.argtypes = [p] * 19 + [i] * 7 + [p]
    handle.nn_klist_dual_bwd.argtypes = [p] * 24 + [i] * 8 + [p]
    for fn in (handle.nn_klist_fwd, handle.nn_klist_bwd,
               handle.nn_klist_dual_fwd, handle.nn_klist_dual_bwd):
        fn.restype = i
    handle.nn_klist_scratch_floats.argtypes = [i] * 3
    handle.nn_klist_scratch_floats.restype = ctypes.c_size_t
    return handle


@pytest.fixture(scope='module')
def klist_lib(tmp_path_factory):
    return _klist_handle(compile_emu(tmp_path_factory.mktemp('emu_klist'),
                                     'fused_klist_emu', source('fused_klist')))


def _klist_inputs(B, N, K, F, R, first_layer, bf16, seed):
    '''K5's inputs, K7's tangents and the cotangents of both, with the edge
    tensors (cat, rbf and their tangents) in the edge dtype.'''
    rs = np.random.RandomState(seed)
    C = F if first_layer else 4 * F
    edt = torch.bfloat16 if bf16 else torch.float32

    def t(*shape, scale=1.0, dtype=torch.float32):
        return torch.tensor(rs.randn(*shape) * scale, dtype=torch.float32) \
            .to(dtype)

    mask = torch.tensor(rs.rand(B, N, K) < 0.7, dtype=torch.float32)
    ins = [t(B, N, F, scale=0.3), t(B, N, K, C, scale=0.3, dtype=edt),
           t(B, N, K, R, scale=0.3, dtype=edt), t(B, 3, N, K), mask]
    ins += [t(*s, scale=s[0] ** -0.5)
            for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    tans = [t(B, N, F, scale=0.1), t(B, N, K, C, scale=0.1, dtype=edt),
            t(B, N, K, R, scale=0.1, dtype=edt), t(B, 3, N, K, scale=0.1)]
    cots = [t(B, N, F), t(B, 3, N, F), t(B, N, F, scale=0.3),
            t(B, 3, N, F, scale=0.3)]
    return ins, tans, cots


def _run_k5(handle, ins, first_layer, bf16, max_blocks=3):
    '''(inv1, eq) of the emulated K5, NaN-initialised, its scratch too, with
    a grid of at most max_blocks blocks.'''
    B, N, F = ins[0].shape
    K, R = ins[1].shape[2], ins[2].shape[-1]
    out = [nan(B, N, F), nan(B, 3, N, F),
           nan(handle.nn_klist_scratch_floats(F, R, 0))]
    assert handle.nn_klist_fwd(*ptrs(ins + out), B, N, K, F, R,
                               int(first_layer), int(bf16), max_blocks,
                               None) == 0
    return out[:2]


def _run_klist(handle, ins, tans, cots, first_layer, bf16, max_blocks=3):
    '''(K5, K6 without and with weight cotangents, K7, K8) outputs of the
    emulated kernels, NaN-initialised, and the plain versions' values. The
    grids of K6 and K8 are at most max_blocks blocks, so a block walks
    several atom tiles (of both molecules where B = 2) into one weight
    partial.'''
    B, N, F = ins[0].shape
    K, R = ins[1].shape[2], ins[2].shape[-1]
    fl, bf = int(first_layer), int(bf16)
    n_w = R * F + 4 * F * F
    n_blk = B * ((N + 7) // 8)

    def nan_like(x):
        return torch.full_like(x, float('nan'))

    got, want = [], []
    fwd = _run_k5(handle, ins, first_layer, bf16, max_blocks)
    got += fwd
    want += fk.klist_fwd_ref(*ins, first_layer=first_layer)
    for wg in (False, True):
        outs = [nan(B, N, F), nan_like(ins[1]), nan_like(ins[2]),
                nan(B, 3, N, K)]
        wpart, dw = nan(min(n_blk, max_blocks), n_w), nan(n_w)
        scratch = nan(handle.nn_klist_scratch_floats(F, R, 1))
        assert handle.nn_klist_bwd(
            *ptrs(ins + cots[:2] + outs),
            wpart.data_ptr() if wg else None, dw.data_ptr() if wg else None,
            scratch.data_ptr(), B, N, K, F, R, fl, int(wg), bf, max_blocks,
            None) == 0
        ref = fk.klist_bwd_ref(*ins, *cots[:2], first_layer=first_layer,
                               weight_grads=wg)
        got += outs + (list(dw.split([R * F] + [F * F] * 4)) if wg else [])
        want += list(ref[:4]) + ([r.reshape(-1) for r in ref[4:]]
                                 if wg else [])
    args = [ins[0], tans[0], ins[1], tans[1], ins[2], tans[2], ins[3],
            tans[3], ins[4]] + ins[5:]
    dfwd = [nan(B, N, F), nan(B, 3, N, F), nan(B, N, F), nan(B, 3, N, F)]
    scratch = nan(handle.nn_klist_scratch_floats(F, R, 2))
    assert handle.nn_klist_dual_fwd(*ptrs(args + dfwd + [scratch]), B, N, K,
                                    F, R, fl, bf, None) == 0
    got += dfwd
    want += fk.klist_dual_fwd_ref(*args, first_layer=first_layer)
    dbwd = [nan(B, N, F), nan(B, N, F), nan_like(ins[1]), nan_like(tans[1])]
    wpart, dw = nan(min(n_blk, max_blocks), n_w), nan(n_w)
    assert handle.nn_klist_dual_bwd(*ptrs(args + cots + dbwd + [wpart, dw]),
                                    B, N, K, F, R, fl, bf, max_blocks,
                                    None) == 0
    ref = fk.klist_dual_bwd_ref(*args, *cots, first_layer=first_layer)
    got += dbwd + list(dw.split([R * F] + [F * F] * 4))
    want += list(ref[:4]) + [r.reshape(-1) for r in ref[4:]]
    return got, want


@pytest.mark.parametrize('shape, first_layer, bf16', [
    ((2, 10, 13, 32, 8), False, False), ((2, 10, 13, 32, 8), True, False),
    ((2, 10, 13, 32, 8), False, True), ((2, 10, 13, 32, 8), True, True),
    ((1, 9, 6, 64, 16), False, True), ((1, 9, 6, 64, 16), True, False),
    ((1, 9, 5, 128, 20), False, True), ((1, 9, 5, 128, 20), True, False)])
def test_emulated_klist_kernels_match_plain(klist_lib, shape, first_layer,
                                            bf16):
    '''K5-K8 at ragged sizes (N = 10 and 9 are no multiple of the 8-atom
    tiles, K = 13, 6 and 5 none of the 8- or 4-slot tiles), every width the
    kernels are built for, both variants, fp32 and bf16 edges, K6 with and
    without weight cotangents; K6 and K8 (tensor cores, 3xTF32) with a grid
    of at most 3 blocks, so that a block walks several atom tiles, the
    weight stream runs across them and the weight partial sums them (R = 8,
    16 and 20 pad to 32 in K6's and K7's products). fp32 outputs hold
    BAR; the bf16-stored ones (dcat, dcatdot, drbf) one bf16 ulp, 2^-8 of
    the output's largest magnitude (a last-bit fp32 difference before the
    rounding can move a value to the neighbouring bf16 value).'''
    B, N, K, F, R = shape
    ins, tans, cots = _klist_inputs(B, N, K, F, R, first_layer, bf16,
                                    seed=N + K)
    got, want = _run_klist(klist_lib, ins, tans, cots, first_layer, bf16)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, k
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), k
        bar = 2.0 ** -8 if bf16 and got[k].dtype == torch.bfloat16 else BAR
        err = (g - w).abs().max().item()
        assert err <= bar * w.abs().max().item(), (k, err)
    # masked slots: exact zeros in dcat (K6 and K8) and drbf
    off = ins[4] == 0
    for k in (3, 4, 7, 8, 21, 22):
        assert not got[k].float()[off].any(), k


def test_emulated_klist_kernels_refuse_what_they_do_not_take(klist_lib):
    '''F outside (32, 64, 128), an R whose tiles overflow the 227 KB of
    shared memory a block may use, or an empty list: cudaErrorInvalidValue.'''
    ins, _, _ = _klist_inputs(1, 4, 3, 32, 4, False, False, seed=0)
    out = [nan(1, 4, 32), nan(1, 3, 4, 32), nan(4096)]
    assert klist_lib.nn_klist_fwd(*ptrs(ins + out), 1, 4, 3, 48, 4, 0, 0, 1,
                                  None) == 1
    assert klist_lib.nn_klist_fwd(*ptrs(ins + out), 1, 4, 3, 128, 900, 0, 0,
                                  1, None) == 1
    assert klist_lib.nn_klist_fwd(*ptrs(ins + out), 1, 4, 0, 32, 4, 0, 0, 1,
                                  None) == 1


def test_emulation_catches_a_tensor_core_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K8 reads the second B fragment of
    an mma tile from the wrong depth row (k + 3 for k + 4, a fragment
    index of the PTX layout) fails the comparison of K8 with its plain
    version that the source passes.'''
    src = source('fused_klist')
    good = 'wc[(kb + 4) * S::WLD + n]'
    assert src.count(good) == 1
    mutant = _klist_handle(compile_emu(
        tmp_path, 'fused_klist_mutant',
        src.replace(good, 'wc[(kb + 3) * S::WLD + n]')))
    ins, tans, cots = _klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = _run_klist(mutant, ins, tans, cots, False, False)
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
    mutant = _klist_handle(compile_emu(
        tmp_path, 'fused_klist_k7_mutant',
        src.replace(good, 'wk4 = w[(s * 8) ^ o0 ^ 5];')))
    ins, tans, cots = _klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = _run_klist(mutant, ins, tans, cots, False, False)
    # inv1, eq, inv1dot, eqdot
    assert worst_ratio(got[15:19], want[15:19]) > BAR


def test_emulation_catches_a_k6_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K6 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth of the swizzled
    ring row (k + 5 for k + 4) fails the comparison of K6 with its plain
    version that the source passes.'''
    src = source('fused_klist')
    good = 'b4 = w[(s * 8) ^ o0 ^ 4];'
    assert src.count(good) == 1
    mutant = _klist_handle(compile_emu(
        tmp_path, 'fused_klist_k6_mutant',
        src.replace(good, 'b4 = w[(s * 8) ^ o0 ^ 5];')))
    ins, tans, cots = _klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = _run_klist(mutant, ins, tans, cots, False, False)
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
    ins, _, _ = _klist_inputs(2, 37, 11, 32, 8, first_layer, bf16, seed=37)
    got = _run_k5(klist_lib, ins, first_layer, bf16)
    want = fk.klist_fwd_ref(*ins, first_layer=first_layer)
    assert worst_ratio(got, want) <= BAR
    again = _run_k5(klist_lib, ins, first_layer, bf16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_emulation_catches_a_k5_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K5 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth of the swizzled
    ring row (k + 5 for k + 4) fails the comparison of K5 with its plain
    version that the source passes.'''
    src = source('fused_klist')
    good = 'u4 = w[(s * 8) ^ o0 ^ 4];'
    assert src.count(good) == 1
    mutant = _klist_handle(compile_emu(
        tmp_path, 'fused_klist_k5_mutant',
        src.replace(good, 'u4 = w[(s * 8) ^ o0 ^ 5];')))
    ins, _, _ = _klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got = _run_k5(mutant, ins, False, False)
    assert worst_ratio(got, fk.klist_fwd_ref(*ins)) > BAR
