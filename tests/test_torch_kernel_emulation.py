'''The CUDA sources of kernels K1/K2 (newtonnet_tpu_torch/csrc/fused_dense.cu),
K3/K4 (csrc/fused_dual.cu), K5-K8 (csrc/fused_klist.cu), K9/K12
(csrc/row_gather.cu) and K10/K11 (csrc/window.cu) run on the CPU under an
emulation of CUDA's thread model
(newtonnet_tpu_torch/csrc/emu/cuda_emu.h), against the plain PyTorch
versions. The card checks the same in chip_smoke.py; this catches
faults of indexing, masking and barriers before a source goes to the card.

Bar: max|kernel - plain| <= 1e-4 * max|plain| per output, as on the card:
both are float32 and sum in another order. In bf16 mode a one-ulp fp32
difference of a sum can flip the bf16 rounding of a later operand (one bf16
ulp is 2^-8 relative), so the bar there is BF16_BAR, derived in
test_emulated_dual_kernels_match_plain.
'''
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_dual as fdd
from newtonnet_tpu_torch.ops import fused_klist as fk
from newtonnet_tpu_torch.ops import row_gather as rg
from newtonnet_tpu_torch.ops import window as wn

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'newtonnet_tpu_torch')
BAR = 1e-4
BF16_BAR = 2e-3


def _for_gxx(src):
    '''Rewrite a CUDA source for g++ over the emulation header.'''
    src = src.replace('#include <cuda_runtime.h>', '#include "cuda_emu.h"')
    src = src.replace('#include <cuda_bf16.h>', '')
    src = src.replace('extern __shared__ float smem[];',
                      'float* smem = g_smem;')

    def launch(m):
        grid, block, smem = [p.strip() for p in m.group(2).split(',')][:3]
        return (f'emu_launch({grid}, {block}, {smem}, '
                f'[&] {{ {m.group(1).strip()}({m.group(3)}); }});')

    return re.sub(r'([\w<>, ]+?)<<<(.*?)>>>\((.*?)\);', launch, src,
                  flags=re.S)


def _compile(out, name, src):
    '''Compile a rewritten source with g++ into out/lib<name>.so.'''
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    (out / f'{name}.cpp').write_text(_for_gxx(src))
    so = out / f'lib{name}.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-I', os.path.join(PKG, 'csrc', 'emu'), '-o', str(so),
                    str(out / f'{name}.cpp')], check=True, timeout=600)
    return ctypes.CDLL(str(so))


def _source(name):
    with open(os.path.join(PKG, 'csrc', name + '.cu')) as f:
        return f.read()


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    handle = _compile(tmp_path_factory.mktemp('emu'), 'fused_dense_emu',
                      _source('fused_dense'))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_pair_fwd.argtypes = [p] * 12 + [i] * 5 + [p]
    handle.nn_pair_fwd.restype = i
    handle.nn_pair_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
    handle.nn_pair_bwd.restype = i
    handle.nn_pair_scratch_floats.argtypes = [i] * 5
    handle.nn_pair_scratch_floats.restype = ctypes.c_size_t
    return handle


def _inputs(B, N, F, R, seed):
    rs = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32)

    adj = (rs.rand(B, N, N) < 0.6) & ~np.eye(N, dtype=bool)
    ins = [t(rs.randn(B, N, F) * 0.3), t(rs.randn(B, N, N, R) * 0.3),
           t(rs.randn(B, 3, N, N)), t(adj), t(rs.randn(B, 3, N, F) * 0.2)]
    ins += [t(rs.randn(*s) / np.sqrt(s[0]))
            for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    return ins, t(rs.randn(B, N, F)), t(rs.randn(B, 3, N, F))


def _nan(*shape):
    return torch.full(shape, float('nan'))


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _run_pair(handle, ins, dinv1, deq, first_layer):
    '''(kernel, plain) output pairs of K1 and of K2 with and without weight
    cotangents, emulated, NaN-initialised, with K2's scratch (NaN too) of
    the size the source gives.'''
    B, N, F = ins[0].shape
    R = ins[1].shape[-1]
    inv1, eq = _nan(B, N, F), _nan(B, 3, N, F)
    assert handle.nn_pair_fwd(*_ptrs(ins + [inv1, eq]), B, N, F, R,
                              int(first_layer), None) == 0
    pairs = list(zip((inv1, eq), fd.pair_interaction_fwd_ref(
        *ins, first_layer=first_layer)))
    n_w = R * F + 4 * F * F
    for wg in (True, False):
        outs = [_nan(B, N, F), _nan(B, N, N, R), _nan(B, 3, N, N),
                _nan(B, 3, N, F)]
        dw = _nan(n_w)
        scratch = _nan(handle.nn_pair_scratch_floats(B, N, F, R, int(wg)))
        assert handle.nn_pair_bwd(
            *_ptrs(ins + [dinv1, deq] + outs),
            dw.data_ptr() if wg else None, scratch.data_ptr(),
            B, N, F, R, int(first_layer), int(wg), None) == 0
        if wg:
            outs += [v.view(s) for v, s in zip(
                dw.split([R * F] + [F * F] * 4), [(R, F)] + [(F, F)] * 4)]
        ref = fd.pair_interaction_bwd_ref(*ins, dinv1, deq,
                                          first_layer=first_layer,
                                          weight_grads=wg)
        pairs += list(zip(outs, ref))
    return pairs


@pytest.mark.parametrize('first_layer', [False, True])
@pytest.mark.parametrize('shape', [(2, 10, 32, 8), (1, 17, 64, 16),
                                   (1, 21, 128, 20), (3, 13, 32, 12)])
def test_emulated_kernels_match_plain(lib, shape, first_layer):
    '''Ragged atom counts (10, 13, 17, 21 are no multiple of K1's 8-row
    tiles, nor of K2's 8-row and 4-column ones), every width the kernels
    are built for, weight cotangents on and off; three molecules with
    R=12 (a radial depth padded to 32 in K2's products).'''
    B, N, F, R = shape
    ins, dinv1, deq = _inputs(B, N, F, R, seed=N)
    pairs = _run_pair(lib, ins, dinv1, deq, first_layer)
    for k, (got, want) in enumerate(pairs):
        assert torch.isfinite(got).all(), k
        err = (got - want).abs().max().item()
        assert err <= BAR * want.abs().max().item(), (k, err)


def test_emulated_kernels_refuse_what_they_do_not_take(lib):
    '''F outside (32, 64, 128), or an R whose tiles overflow the 227 KB of
    shared memory a block may use, return cudaErrorInvalidValue.'''
    ins, dinv1, deq = _inputs(1, 4, 32, 4, seed=0)
    out = [_nan(1, 4, 32), _nan(1, 3, 4, 32)]
    assert lib.nn_pair_fwd(*_ptrs(ins + out), 1, 4, 48, 4, 0, None) == 1
    assert lib.nn_pair_fwd(*_ptrs(ins + out), 1, 4, 128, 900, 0, None) == 1


def _dual_handle(handle):
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_dual_fwd.argtypes = [p] * 19 + [i] * 6 + [p]
    handle.nn_dual_fwd.restype = i
    handle.nn_dual_bwd.argtypes = [p] * 24 + [i] * 6 + [p]
    handle.nn_dual_bwd.restype = i
    handle.nn_dual_scratch_floats.argtypes = [i] * 5
    handle.nn_dual_scratch_floats.restype = ctypes.c_size_t
    return handle


@pytest.fixture(scope='module')
def dual_lib(tmp_path_factory):
    return _dual_handle(_compile(tmp_path_factory.mktemp('emu_dual'),
                                 'fused_dual_emu', _source('fused_dual')))


def _dual_inputs(B, N, F, R, seed):
    '''K3's inputs and K4's cotangents, of the scale the model produces.'''
    ins, di, dq = _inputs(B, N, F, R, seed)
    rs = np.random.RandomState(seed + 100)

    def t(*shape):
        return torch.tensor(rs.randn(*shape) * 0.1, dtype=torch.float32)

    np_, rbf, dir_, adj, force = ins[:5]
    args = [np_, t(B, N, F), rbf, t(B, N, N, R), dir_, t(B, 3, N, N), adj,
            force, t(B, 3, N, F)] + ins[5:]
    return args, [di, dq, t(B, N, F), t(B, 3, N, F)]


def _run_dual(handle, args, cots, first_layer, bf16):
    '''(K3 outputs, K4 outputs) of the emulated kernels, NaN-initialised,
    with scratch (NaN too) of the size the source gives.'''
    B, N, F = args[0].shape
    R = args[2].shape[-1]
    fwd = [_nan(B, N, F), _nan(B, 3, N, F), _nan(B, N, F), _nan(B, 3, N, F)]
    scratch = _nan(handle.nn_dual_scratch_floats(B, N, F, R, 0))
    assert handle.nn_dual_fwd(*_ptrs(args + fwd + [scratch]), B, N, F, R,
                              int(first_layer), int(bf16), None) == 0
    n_w = R * F + 4 * F * F
    bwd = [_nan(B, N, F), _nan(B, N, F), _nan(B, 3, N, F), _nan(B, 3, N, F)]
    dw = _nan(n_w)
    scratch = _nan(handle.nn_dual_scratch_floats(B, N, F, R, 1))
    assert handle.nn_dual_bwd(*_ptrs(args + cots + bwd + [dw, scratch]), B, N,
                              F, R, int(first_layer), int(bf16), None) == 0
    bwd += [v.view(s) for v, s in zip(dw.split([R * F] + [F * F] * 4),
                                      [(R, F)] + [(F, F)] * 4)]
    return fwd, bwd


def _worst(got, want):
    '''max over outputs of max|got - want| / max|want|; fails on non-finite.'''
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all(), k
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        worst = max(worst, err / scale if scale else err)
    return worst


@pytest.mark.parametrize('shape, first_layer, bf16', [
    (shape, first, bf16) for shape in [(2, 10, 32, 8), (1, 13, 64, 16)]
    for first in (False, True) for bf16 in (False, True)]
    + [((1, 21, 128, 20), False, True), ((3, 11, 32, 12), False, True),
       ((3, 11, 32, 12), True, False)])
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
    args, cots = _dual_inputs(B, N, F, R, seed=N)
    dot_dtype = 'bfloat16' if bf16 else 'float32'
    fwd, bwd = _run_dual(dual_lib, args, cots, first_layer, bf16)
    want_f = fdd.pair_interaction_dual_fwd_ref(*args, first_layer=first_layer,
                                               dot_dtype=dot_dtype)
    want_b = fdd.pair_interaction_dual_bwd_ref(*args, *cots,
                                               first_layer=first_layer,
                                               dot_dtype=dot_dtype)
    worst = max(_worst(fwd, want_f), _worst(bwd, want_b))
    assert worst <= (BF16_BAR if bf16 else BAR), worst
    if first_layer:  # dnpdot, dforce, dforcedot, dW2a, dW2b: exact zeros
        for k in (1, 2, 3, 7, 8):
            assert not bwd[k].any(), k


def test_emulated_dual_kernels_refuse_what_they_do_not_take(dual_lib):
    '''F outside (32, 64, 128), or an R whose tiles overflow the 227 KB of
    shared memory a block may use, return cudaErrorInvalidValue.'''
    args, cots = _dual_inputs(1, 4, 32, 4, seed=0)
    out = [_nan(1, 4, 32), _nan(1, 3, 4, 32)] * 2 + [_nan(1, 4, 32)]
    assert dual_lib.nn_dual_fwd(*_ptrs(args + out), 1, 4, 48, 4, 0, 0,
                                None) == 1
    scratch = [_nan(1, 4, 32)] * 6
    assert dual_lib.nn_dual_bwd(*_ptrs(args + cots + scratch), 1, 4, 128,
                                200, 0, 0, None) == 1


def _klist_handle(handle):
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_klist_fwd.argtypes = [p] * 12 + [i] * 7 + [p]
    handle.nn_klist_bwd.argtypes = [p] * 18 + [i] * 8 + [p]
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
    return _klist_handle(_compile(tmp_path_factory.mktemp('emu_klist'),
                                  'fused_klist_emu', _source('fused_klist')))


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


def _run_klist(handle, ins, tans, cots, first_layer, bf16, max_blocks=3):
    '''(K5, K6 without and with weight cotangents, K7, K8) outputs of the
    emulated kernels, NaN-initialised, and the plain versions' values. K8's
    grid is at most max_blocks blocks, so a block walks several atom tiles
    (of both molecules where B = 2) into one weight partial.'''
    B, N, F = ins[0].shape
    K, R = ins[1].shape[2], ins[2].shape[-1]
    fl, bf = int(first_layer), int(bf16)
    n_w = R * F + 4 * F * F
    n_blk = B * ((N + 7) // 8)

    def nan_like(x):
        return torch.full_like(x, float('nan'))

    got, want = [], []
    fwd = [_nan(B, N, F), _nan(B, 3, N, F)]
    assert handle.nn_klist_fwd(*_ptrs(ins + fwd), B, N, K, F, R, fl, bf,
                               None) == 0
    got += fwd
    want += fk.klist_fwd_ref(*ins, first_layer=first_layer)
    for wg in (False, True):
        outs = [_nan(B, N, F), nan_like(ins[1]), nan_like(ins[2]),
                _nan(B, 3, N, K)]
        wpart, dw = _nan(n_blk, n_w), _nan(n_w)
        assert handle.nn_klist_bwd(
            *_ptrs(ins + cots[:2] + outs),
            wpart.data_ptr() if wg else None, dw.data_ptr() if wg else None,
            B, N, K, F, R, fl, int(wg), bf, None) == 0
        ref = fk.klist_bwd_ref(*ins, *cots[:2], first_layer=first_layer,
                               weight_grads=wg)
        got += outs + (list(dw.split([R * F] + [F * F] * 4)) if wg else [])
        want += list(ref[:4]) + ([r.reshape(-1) for r in ref[4:]]
                                 if wg else [])
    args = [ins[0], tans[0], ins[1], tans[1], ins[2], tans[2], ins[3],
            tans[3], ins[4]] + ins[5:]
    dfwd = [_nan(B, N, F), _nan(B, 3, N, F), _nan(B, N, F), _nan(B, 3, N, F)]
    scratch = _nan(handle.nn_klist_scratch_floats(F, R, 2))
    assert handle.nn_klist_dual_fwd(*_ptrs(args + dfwd + [scratch]), B, N, K,
                                    F, R, fl, bf, None) == 0
    got += dfwd
    want += fk.klist_dual_fwd_ref(*args, first_layer=first_layer)
    dbwd = [_nan(B, N, F), _nan(B, N, F), nan_like(ins[1]), nan_like(tans[1])]
    wpart, dw = _nan(min(n_blk, max_blocks), n_w), _nan(n_w)
    assert handle.nn_klist_dual_bwd(*_ptrs(args + cots + dbwd + [wpart, dw]),
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
    without weight cotangents; K8 (tensor cores, 3xTF32) with a grid of at
    most 3 blocks, so that a block sums several atom tiles. fp32 outputs hold
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
    out = [_nan(1, 4, 32), _nan(1, 3, 4, 32)]
    assert klist_lib.nn_klist_fwd(*_ptrs(ins + out), 1, 4, 3, 48, 4, 0, 0,
                                  None) == 1
    assert klist_lib.nn_klist_fwd(*_ptrs(ins + out), 1, 4, 3, 128, 900, 0, 0,
                                  None) == 1
    assert klist_lib.nn_klist_fwd(*_ptrs(ins + out), 1, 4, 0, 32, 4, 0, 0,
                                  None) == 1


def test_emulation_catches_a_dual_kernel_fault(tmp_path):
    '''A mutant of fused_dual.cu whose K4 drops the tangent term of the
    column part of dnp (a fault of the kind that only shows through a
    reduction across blocks) fails the comparison that the source passes.'''
    src = _source('fused_dual')
    good = 's += p_s[o] * ai + (pdot_s[o] * ai + h_s[o] * npdoti_s[il * F + f]);'
    assert src.count(good) == 1
    mutant = _dual_handle(_compile(
        tmp_path, 'fused_dual_mutant',
        src.replace(good, 's += p_s[o] * ai + pdot_s[o] * ai;')))
    args, cots = _dual_inputs(1, 10, 32, 8, seed=3)
    fwd, bwd = _run_dual(mutant, args, cots, False, False)
    want = fdd.pair_interaction_dual_bwd_ref(*args, *cots,
                                             dot_dtype='float32')
    assert _worst(fwd + bwd[:1], fdd.pair_interaction_dual_fwd_ref(
        *args, dot_dtype='float32') + want[:1]) > BAR


def test_emulation_catches_a_bf16_fragment_fault(tmp_path):
    '''A mutant of fused_dual.cu whose bf16 products read the second B
    fragment register of an m16n8k16 tile from the wrong depth word (k+6
    for k+8, a fragment index of the PTX layout) fails the comparison of
    K3/K4 with their plain versions in bf16 mode that the source passes.'''
    src = _source('fused_dual')
    good = 'const unsigned b[2] = {w[0], w[4]};'
    assert src.count(good) == 1
    mutant = _dual_handle(_compile(
        tmp_path, 'fused_dual_bf16_mutant',
        src.replace(good, 'const unsigned b[2] = {w[0], w[3]};')))
    args, cots = _dual_inputs(1, 10, 32, 8, seed=5)
    fwd, bwd = _run_dual(mutant, args, cots, False, True)
    kw = dict(dot_dtype='bfloat16')
    want = (fdd.pair_interaction_dual_fwd_ref(*args, **kw)
            + fdd.pair_interaction_dual_bwd_ref(*args, *cots, **kw))
    assert _worst(fwd + bwd, want) > BF16_BAR


def test_emulation_catches_a_tensor_core_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K8 reads the second B fragment of
    an mma tile from the wrong depth row (k + 3 for k + 4, a fragment
    index of the PTX layout) fails the comparison of K8 with its plain
    version that the source passes.'''
    src = _source('fused_klist')
    good = 'wc[(kb + 4) * S::WLD + n]'
    assert src.count(good) == 1
    mutant = _klist_handle(_compile(
        tmp_path, 'fused_klist_mutant',
        src.replace(good, 'wc[(kb + 3) * S::WLD + n]')))
    ins, tans, cots = _klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = _run_klist(mutant, ins, tans, cots, False, False)
    worst = max((g - w).abs().max().item() / w.abs().max().item()
                for g, w in zip(got[-9:], want[-9:]))
    assert worst > BAR


def test_emulation_catches_a_k2_fragment_fault(tmp_path):
    '''A mutant of fused_dense.cu whose K2 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth (k + 3 for k + 4,
    a fragment index of the PTX layout) fails the comparison of K2 with its
    plain version that the source passes.'''
    src = _source('fused_dense')
    good = 'const uint2 b0 = w[0], b1 = w[4];'
    assert src.count(good) == 1
    mutant = _compile(tmp_path, 'fused_dense_mutant',
                      src.replace(good, 'const uint2 b0 = w[0], b1 = w[3];'))
    p, i = ctypes.c_void_p, ctypes.c_int
    mutant.nn_pair_fwd.argtypes = [p] * 12 + [i] * 5 + [p]
    mutant.nn_pair_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
    mutant.nn_pair_scratch_floats.argtypes = [i] * 5
    mutant.nn_pair_scratch_floats.restype = ctypes.c_size_t
    ins, dinv1, deq = _inputs(1, 10, 32, 8, seed=4)
    pairs = _run_pair(mutant, ins, dinv1, deq, False)[2:]  # K2's outputs
    assert _worst([g for g, _ in pairs], [w for _, w in pairs]) > BAR


def test_emulation_catches_a_k7_fragment_fault(tmp_path):
    '''A mutant of fused_klist.cu whose K7 products read the second B
    fragment word of an m16n8k8 tile from the wrong depth of the swizzled
    ring row (k + 5 for k + 4) fails the comparison of K7 with its plain
    version that the source passes.'''
    src = _source('fused_klist')
    good = 'wk4 = w[(s * 8) ^ o0 ^ 4];'
    assert src.count(good) == 1
    mutant = _klist_handle(_compile(
        tmp_path, 'fused_klist_k7_mutant',
        src.replace(good, 'wk4 = w[(s * 8) ^ o0 ^ 5];')))
    ins, tans, cots = _klist_inputs(1, 9, 6, 32, 8, False, False, seed=15)
    got, want = _run_klist(mutant, ins, tans, cots, False, False)
    assert _worst(got[15:19], want[15:19]) > BAR  # inv1, eq, inv1dot, eqdot


@pytest.fixture(scope='module')
def gather_lib(tmp_path_factory):
    handle = _compile(tmp_path_factory.mktemp('emu_gather'),
                      'row_gather_emu', _source('row_gather'))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_row_gather.argtypes = [p, p, p, i, i, i, i, ctypes.c_longlong,
                                     i, p]
    handle.nn_row_gather.restype = i
    return handle


@pytest.mark.parametrize('B, N, F, R, dtype, idx_dtype', [
    (2, 7, 3, 11, torch.float32, torch.int32),       # 12-byte rows: words
    (1, 10, 16, 37, torch.bfloat16, torch.int64),    # 16-byte vectors
    (2, 5, 5, 9, torch.bfloat16, torch.int32),       # 10 bytes: half-words
    (3, 6, 64, 20, torch.float32, torch.int64)])
def test_emulated_row_gather_matches_plain(gather_lib, B, N, F, R, dtype,
                                           idx_dtype):
    """K9 copies rows bit for bit at every word size the source picks, from
    a source whose batch stride is not N rows (a slot chunk of a larger
    tensor, as inv_scatter_sum passes it)."""
    rs = np.random.RandomState(B * 100 + F)
    big = torch.tensor(rs.randn(B, N + 3, F), dtype=torch.float32).to(dtype)
    x = big[:, 2:2 + N]
    idx = torch.tensor(rs.randint(0, N, size=(B, R)), dtype=idx_dtype)
    out = torch.full((B, R, F), float('nan'), dtype=dtype)
    assert gather_lib.nn_row_gather(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, R,
        F * x.element_size(), x.stride(0) // F,
        int(idx_dtype == torch.int64), None) == 0
    assert torch.equal(out, rg.row_gather_ref(x, idx))


def test_emulated_row_gather_zeroes_rows_out_of_range(gather_lib):
    """An index outside [0, N) gives a zero row and no read outside x; an
    empty problem is refused."""
    x = torch.randn(1, 4, 8)
    idx = torch.tensor([[0, 4, -1, 3]], dtype=torch.int32)
    out = torch.full((1, 4, 8), float('nan'))
    assert gather_lib.nn_row_gather(x.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), 1, 4, 4, 32, 4, 0,
                                    None) == 0
    assert torch.equal(out[0, 0], x[0, 0]) and torch.equal(out[0, 3], x[0, 3])
    assert not out[0, 1:3].any()
    assert gather_lib.nn_row_gather(x.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), 1, 4, 0, 32, 4, 0,
                                    None) == 1


@pytest.fixture(scope='module')
def window_lib(tmp_path_factory):
    handle = _compile(tmp_path_factory.mktemp('emu_window'), 'window_emu',
                      _source('window'))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_window_gather.argtypes = [p, p, p] + [i] * 8 + [p]
    handle.nn_window_gather.restype = i
    handle.nn_window_scatter.argtypes = [p] * 4 + [i] * 8 + [p]
    handle.nn_window_scatter.restype = i
    handle.nn_window_scratch_bytes.argtypes = [i] * 6
    handle.nn_window_scratch_bytes.restype = ctypes.c_size_t
    return handle


@pytest.mark.parametrize('B, K, N, F, W, T, dtype', [
    (2, 3, 256, 16, 128, 128, torch.bfloat16),
    (1, 5, 96, 6, 40, 32, torch.float32)])
def test_emulated_window_kernels_match_plain(window_lib, B, K, N, F, W, T,
                                             dtype):
    """K10 equals its plain version bit for bit (the window test and the
    bf16 rounding); K11 equals the plain index_add_ within 1e-6 of the
    largest magnitude plus one ulp of the output dtype (fp32 sums in
    another order), with edges in and out of their windows and indices of
    both widths; with int64 indices a third of the edges point at atom 0,
    a window row with a long run of edges (as masked slots pointed at a
    block's start make)."""
    rs = np.random.RandomState(N + K)
    x = torch.tensor(rs.randn(B, N, F), dtype=torch.float32).to(dtype)
    y = torch.tensor(rs.randn(B, K, N, F), dtype=torch.float32).to(dtype)
    for idx_dtype in (torch.int32, torch.int64):
        idx = torch.tensor(rs.randint(0, N, size=(B, K, N)), dtype=idx_dtype)
        if idx_dtype == torch.int64:
            idx[..., ::3] = 0
        loc = wn.window_locals(idx, W, T)
        assert (loc < W).any() and (loc >= W).any()
        i64 = int(idx_dtype == torch.int64)
        bf = int(dtype == torch.bfloat16)
        out = torch.full((B, K, N, F), float('nan'), dtype=dtype)
        assert window_lib.nn_window_gather(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, K, N, F, W, T,
            bf, i64, None) == 0
        assert torch.equal(out, wn.window_gather_ref(x, idx, W, T))
        scratch = torch.full(
            (window_lib.nn_window_scratch_bytes(B, K, N, F, W, T),), 255,
            dtype=torch.uint8)
        got = torch.full((B, N, F), float('nan'), dtype=dtype)
        assert window_lib.nn_window_scatter(
            y.data_ptr(), idx.data_ptr(), scratch.data_ptr(), got.data_ptr(), B,
            K, N, F, W, T, bf, i64, None) == 0
        want = wn.window_scatter_sum_ref(y, idx, W, T).float()
        ulp = torch.finfo(dtype).eps * want.abs()
        assert ((got.float() - want).abs()
                <= 1e-6 * want.abs().max() + ulp).all()


def test_emulated_window_kernels_refuse_what_they_do_not_take(window_lib):
    """N not a multiple of T, W above N, or more edges per block than the
    sort holds: cudaErrorInvalidValue (and no scratch size)."""
    x, idx, out = torch.zeros(1, 8, 4), torch.zeros(1, 2, 8,
                                                   dtype=torch.int32), \
        torch.zeros(1, 2, 8, 4)
    args = (x.data_ptr(), idx.data_ptr(), out.data_ptr())
    assert window_lib.nn_window_gather(*args, 1, 2, 8, 4, 4, 3, 0, 0,
                                       None) == 1
    assert window_lib.nn_window_gather(*args, 1, 2, 8, 4, 9, 4, 0, 0,
                                       None) == 1
    assert window_lib.nn_window_scratch_bytes(1, 300, 256, 4, 128, 128) == 0
    assert window_lib.nn_window_scatter(x.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), out.data_ptr(), 1,
                                        300, 256, 4, 128, 128, 0, 0,
                                        None) == 1
