'''Helpers of the CUDA emulation tests
(tests/test_torch_kernel_emulation_*.py): a kernel source of
newtonnet_tpu_torch/csrc is rewritten for g++ over the emulation of CUDA's
thread model (newtonnet_tpu_torch/csrc/emu/cuda_emu.h), compiled into a
shared library and called through its C interface, as the wrappers call
the card's build.

Bar: max|kernel - plain| <= 1e-4 * max|plain| per output, as on the card:
both are float32 and sum in another order. In bf16 mode a one-ulp fp32
difference of a sum can flip the bf16 rounding of a later operand (one bf16
ulp is 2^-8 relative), so the bar there is BF16_BAR, derived in
test_torch_kernel_emulation_dual.py:test_emulated_dual_kernels_match_plain.
'''
import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_klist as fk
from newtonnet_tpu_torch.ops._build import width_flags

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'newtonnet_tpu_torch')
BAR = 1e-4
BF16_BAR = 2e-3
# bf16 mode of K1/K2 and K5-K8 (pallas_dot_dtype): the median element
# error, over the plain output's largest magnitude. Where the kernel rounds
# the operands the plain version rounds, the two differ by the fp32
# summation order and a rare flip of a rounding; an operand rounded that
# the plain version leaves fp32 (or the reverse) moves the median by about
# a bf16 ulp of the products, 1e-4 (tests/test_torch_bf16_pair.py).
BF16_MEDIAN_BAR = 1e-5


def for_gxx(src):
    '''Rewrite a CUDA source for g++ over the emulation header.'''
    src = src.replace('#include <cuda_runtime.h>', '#include "cuda_emu.h"')
    src = src.replace('#include <cuda_bf16.h>', '')
    src = src.replace('extern __shared__ float smem[];',
                      'float* smem = g_smem;')

    def launch(m):
        grid, block, smem = [p.strip() for p in m.group(2).split(',')][:3]
        kernel = m.group(1).strip()
        return (f'emu_launch("{kernel}", {grid}, {block}, {smem}, '
                f'[&] {{ {kernel}({m.group(3)}); }});')

    return re.sub(r'([\w<>, ]+?)<<<(.*?)>>>\((.*?)\);', launch, src,
                  flags=re.S)


# compiled emulation libraries, shared by the test files of one checkout
# (several compile the same source at the same width): one per content
# hash, so that a changed source, header or flag compiles anew
EMU_CACHE = os.path.join(PKG, '_build', 'emu')


def _headers():
    '''The text of every header a rewritten source may include.'''
    text = ''
    for d in (os.path.join(PKG, 'csrc', 'emu'), os.path.join(PKG, 'csrc')):
        for f in sorted(os.listdir(d)):
            if f.endswith(('.h', '.cuh')):
                with open(os.path.join(d, f)) as fh:
                    text += f + fh.read()
    return text


def compile_emu(out, name, src, F=None, bf16=False):
    '''Compile a rewritten source with g++ into a shared library (written
    to out/<name>.cpp for reading); for a source of K1-K8, the library that
    runs width F (its padded width alone, with the defines
    ops/_build.width_flags(F)) and, with bf16, its bf16 library
    (-DNN_BF16), as ops/_build.py builds them for the card. The shared
    headers of csrc/ are found by -I. A library of the same source, flags
    and headers compiled before (by any test file) is loaded from
    EMU_CACHE instead.'''
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    code = for_gxx(src)
    (out / f'{name}.cpp').write_text(code)
    flags = (() if F is None else width_flags(F)) + \
        (('-DNN_BF16',) if bf16 else ())
    cmd = ['-std=c++20', '-O1', '-shared', '-fPIC', '-pthread', *flags,
           '-I', os.path.join(PKG, 'csrc', 'emu'), '-I',
           os.path.join(PKG, 'csrc')]
    key = hashlib.sha256('\0'.join([code, _headers(), *cmd]).encode()) \
        .hexdigest()[:20]
    so = os.path.join(EMU_CACHE, f'lib{key}.so')
    if not os.path.exists(so):
        os.makedirs(EMU_CACHE, exist_ok=True)
        # written under a name of this process, then renamed into place:
        # another worker compiling the same library at once is harmless
        tmp = f'{so}.{os.getpid()}.tmp'
        subprocess.run([gxx, *cmd, '-o', tmp, str(out / f'{name}.cpp')],
                       check=True, timeout=600)
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def width_libs(out, name, wrap, bf16=False):
    '''width F -> wrap(the emulated library of csrc/<name>.cu that runs
    F, the bf16 one with bf16), compiled at the first use of its (padded
    width, padded).'''
    built = {}

    def get(F):
        key = width_flags(F)
        if key not in built:
            built[key] = wrap(compile_emu(out, f'{name}_{len(built)}',
                                          source(name), F, bf16=bf16))
        return built[key]
    return get


def source(name):
    with open(os.path.join(PKG, 'csrc', name + '.cu')) as f:
        return f.read()


def worst_ratio(got, want):
    '''max over outputs of max|got - want| / max|want|; fails on non-finite.'''
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all(), k
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        worst = max(worst, err / scale if scale else err)
    return worst


def pair_inputs(B, N, F, R, seed):
    '''K1's inputs and K2's cotangents, of the scale the model produces.'''
    rs = np.random.RandomState(seed)

    def t(a):
        return torch.tensor(a, dtype=torch.float32)

    adj = (rs.rand(B, N, N) < 0.6) & ~np.eye(N, dtype=bool)
    ins = [t(rs.randn(B, N, F) * 0.3), t(rs.randn(B, N, N, R) * 0.3),
           t(rs.randn(B, 3, N, N)), t(adj), t(rs.randn(B, 3, N, F) * 0.2)]
    ins += [t(rs.randn(*s) / np.sqrt(s[0]))
            for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    return ins, t(rs.randn(B, N, F)), t(rs.randn(B, 3, N, F))


def nan(*shape):
    return torch.full(shape, float('nan'))


def ptrs(ts):
    return [t.data_ptr() for t in ts]


# ----------------------------------------------------------------- K1-K4 --
# (B, N, F, R): the cases of test_emulated_kernels_match_plain, K1 in
# test_torch_kernel_emulation_dense.py and K2 in ..._dense_bwd.py
DENSE_CASES = [(2, 10, 32, 8), (1, 17, 64, 16), (1, 21, 128, 20),
               (3, 13, 32, 12)]


def dense_handle(handle):
    '''The argument and result types of fused_dense.cu's C functions.'''
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_pair_fwd.argtypes = [p] * 13 + [i] * 6 + [p]
    handle.nn_pair_fwd.restype = i
    handle.nn_pair_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
    handle.nn_pair_bwd.restype = i
    handle.nn_pair_scratch_floats.argtypes = [i] * 5
    handle.nn_pair_scratch_floats.restype = ctypes.c_size_t
    return handle


def dual_handle(handle):
    '''The argument and result types of fused_dual.cu's C functions.'''
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_dual_fwd.argtypes = [p] * 19 + [i] * 6 + [p]
    handle.nn_dual_fwd.restype = i
    handle.nn_dual_bwd.argtypes = [p] * 24 + [i] * 6 + [p]
    handle.nn_dual_bwd.restype = i
    handle.nn_dual_scratch_floats.argtypes = [i] * 5
    handle.nn_dual_scratch_floats.restype = ctypes.c_size_t
    return handle


def run_k1(handle, ins, first_layer, max_blocks=3, dot_dtype='float32'):
    '''(kernel, plain) output pairs of K1, emulated, NaN-initialised, with
    scratch (NaN too) of the size the source gives; its grid is at most
    max_blocks blocks, so a block walks several tiles. dot_dtype is the
    library's mode (its plain version's).'''
    B, N, F = ins[0].shape
    R = ins[1].shape[-1]
    inv1, eq = nan(B, N, F), nan(B, 3, N, F)
    scratch = nan(handle.nn_pair_scratch_floats(B, N, F, R, 2))
    assert handle.nn_pair_fwd(*ptrs(ins + [inv1, eq, scratch]), B, N, F, R,
                              int(first_layer), max_blocks, None) == 0
    return list(zip((inv1, eq), fd.pair_interaction_fwd_ref(
        *ins, first_layer=first_layer, dot_dtype=dot_dtype)))


def run_k2(handle, ins, dinv1, deq, first_layer, dot_dtype='float32'):
    '''(kernel, plain) output pairs of K2 with and without weight
    cotangents, emulated as run_k1's.'''
    B, N, F = ins[0].shape
    R = ins[1].shape[-1]
    n_w = R * F + 4 * F * F
    pairs = []
    for wg in (True, False):
        outs = [nan(B, N, F), nan(B, N, N, R), nan(B, 3, N, N),
                nan(B, 3, N, F)]
        dw = nan(n_w)
        scratch = nan(handle.nn_pair_scratch_floats(B, N, F, R, int(wg)))
        assert handle.nn_pair_bwd(
            *ptrs(ins + [dinv1, deq] + outs),
            dw.data_ptr() if wg else None, scratch.data_ptr(),
            B, N, F, R, int(first_layer), int(wg), None) == 0
        if wg:
            outs += [v.view(s) for v, s in zip(
                dw.split([R * F] + [F * F] * 4), [(R, F)] + [(F, F)] * 4)]
        ref = fd.pair_interaction_bwd_ref(*ins, dinv1, deq,
                                          first_layer=first_layer,
                                          weight_grads=wg,
                                          dot_dtype=dot_dtype)
        pairs += list(zip(outs, ref))
    return pairs


def run_pair(handle, ins, dinv1, deq, first_layer):
    '''run_k1's and run_k2's pairs.'''
    return (run_k1(handle, ins, first_layer)
            + run_k2(handle, ins, dinv1, deq, first_layer))


def check_pairs(pairs):
    '''Each (kernel, plain) pair finite and within BAR of the plain
    output's largest magnitude.'''
    for k, (got, want) in enumerate(pairs):
        assert torch.isfinite(got).all(), k
        err = (got - want).abs().max().item()
        assert err <= BAR * want.abs().max().item(), (k, err)


def bf16_errors(got, want):
    '''(max element error, median element error over the elements where
    want is not zero), both over want's largest magnitude.'''
    g, w = got.double(), want.double()
    scale = w.abs().max().item()
    err = (g - w).abs()
    if scale == 0:  # an output that is zero (the first layer's dW2a)
        return err.max().item(), 0.0
    return err.max().item() / scale, err[w != 0].median().item() / scale


def check_bf16_pairs(pairs):
    '''bf16 mode: each (kernel, plain) pair finite, within BF16_BAR of the
    plain output's largest magnitude and its median element error within
    BF16_MEDIAN_BAR of it (the bars of chip_smoke.py phase 10a).'''
    for k, (got, want) in enumerate(pairs):
        assert torch.isfinite(got.float()).all(), k
        worst, median = bf16_errors(got, want)
        assert worst <= BF16_BAR, (k, worst)
        assert median <= BF16_MEDIAN_BAR, (k, median)


def dual_inputs(B, N, F, R, seed):
    '''K3's inputs and K4's cotangents, of the scale the model produces.'''
    ins, di, dq = pair_inputs(B, N, F, R, seed)
    rs = np.random.RandomState(seed + 100)

    def t(*shape):
        return torch.tensor(rs.randn(*shape) * 0.1, dtype=torch.float32)

    np_, rbf, dir_, adj, force = ins[:5]
    args = [np_, t(B, N, F), rbf, t(B, N, N, R), dir_, t(B, 3, N, N), adj,
            force, t(B, 3, N, F)] + ins[5:]
    return args, [di, dq, t(B, N, F), t(B, 3, N, F)]


def run_dual(handle, args, cots, first_layer, bf16):
    '''(K3 outputs, K4 outputs) of the emulated kernels, NaN-initialised,
    with scratch (NaN too) of the size the source gives.'''
    B, N, F = args[0].shape
    R = args[2].shape[-1]
    fwd = [nan(B, N, F), nan(B, 3, N, F), nan(B, N, F), nan(B, 3, N, F)]
    scratch = nan(handle.nn_dual_scratch_floats(B, N, F, R, 0))
    assert handle.nn_dual_fwd(*ptrs(args + fwd + [scratch]), B, N, F, R,
                              int(first_layer), int(bf16), None) == 0
    n_w = R * F + 4 * F * F
    bwd = [nan(B, N, F), nan(B, N, F), nan(B, 3, N, F), nan(B, 3, N, F)]
    dw = nan(n_w)
    scratch = nan(handle.nn_dual_scratch_floats(B, N, F, R, 1))
    assert handle.nn_dual_bwd(*ptrs(args + cots + bwd + [dw, scratch]), B, N,
                              F, R, int(first_layer), int(bf16), None) == 0
    bwd += [v.view(s) for v, s in zip(dw.split([R * F] + [F * F] * 4),
                                      [(R, F)] + [(F, F)] * 4)]
    return fwd, bwd


# ----------------------------------------------------------------- K5-K8 --
# (B, N, K, F, R), first_layer, bf16 edges: the cases of
# test_emulated_klist_kernels_match_plain, K5/K6 in
# test_torch_kernel_emulation_klist.py and K7/K8 in ..._klist_dual.py
KLIST_CASES = [
    ((2, 10, 13, 32, 8), False, False), ((2, 10, 13, 32, 8), True, False),
    ((2, 10, 13, 32, 8), False, True), ((2, 10, 13, 32, 8), True, True),
    ((1, 9, 6, 64, 16), False, True), ((1, 9, 6, 64, 16), True, False),
    ((1, 9, 5, 128, 20), False, True), ((1, 9, 5, 128, 20), True, False)]


# K3/K4's cases: ragged atom counts, both variants and both dot dtypes at
# F=32 and 64, the training path's variant at F=128, three molecules with
# R=12 (test_torch_kernel_emulation_dual.py and _dual_wide.py)
DUAL_CASES = ([(shape, first, bf16)
               for shape in [(2, 10, 32, 8), (1, 13, 64, 16)]
               for first in (False, True) for bf16 in (False, True)]
              + [((1, 21, 128, 20), False, True),
                 ((3, 11, 32, 12), False, True),
                 ((3, 11, 32, 12), True, False)])


def case_params(cases, keep):
    '''pytest.param entries of the (shape, first_layer, bf16) cases whose
    index is in `keep`, each with the id it has in the whole list
    (shape<i>-<first_layer>-<bf16>), so that the cases of one list split
    across two files keep their test ids.'''
    return [pytest.param(*case, id=f'shape{i}-{case[1]}-{case[2]}')
            for i, case in enumerate(cases) if i in keep]


def klist_handle(handle):
    '''The argument and result types of fused_klist.cu's C functions.'''
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_klist_fwd.argtypes = [p] * 13 + [i] * 8 + [p]
    handle.nn_klist_bwd.argtypes = [p] * 19 + [i] * 9 + [p]
    handle.nn_klist_dual_fwd.argtypes = [p] * 19 + [i] * 7 + [p]
    handle.nn_klist_dual_bwd.argtypes = [p] * 24 + [i] * 8 + [p]
    for fn in (handle.nn_klist_fwd, handle.nn_klist_bwd,
               handle.nn_klist_dual_fwd, handle.nn_klist_dual_bwd):
        fn.restype = i
    for fn in (handle.nn_klist_scratch_floats, handle.nn_klist_wpart_floats):
        fn.argtypes = [i] * 3
        fn.restype = ctypes.c_size_t
    return handle


def klist_inputs(B, N, K, F, R, first_layer, bf16, seed):
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


def run_k5(handle, ins, first_layer, bf16, max_blocks=3):
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


def _nan_like(x):
    return torch.full_like(x, float('nan'))


def _wpart(handle, B, N, F, R, max_blocks):
    '''K6's and K8's weight partials, NaN, of the size the source gives.'''
    n_blk = min(B * ((N + 7) // 8), max_blocks)
    return nan(handle.nn_klist_wpart_floats(n_blk, F, R))


def run_k56(handle, ins, cots, first_layer, bf16, max_blocks=3,
            dot_dtype='float32'):
    '''(K5, K6 without and with weight cotangents) outputs of the emulated
    kernels, NaN-initialised, and the plain versions' values (in the
    library's mode, dot_dtype). K6's grid is at most max_blocks blocks, so
    a block walks several atom tiles (of both molecules where B = 2) into
    one weight partial.'''
    B, N, F = ins[0].shape
    K, R = ins[1].shape[2], ins[2].shape[-1]
    fl, bf = int(first_layer), int(bf16)
    n_w = R * F + 4 * F * F
    got, want = [], []
    got += run_k5(handle, ins, first_layer, bf16, max_blocks)
    want += fk.klist_fwd_ref(*ins, first_layer=first_layer,
                             dot_dtype=dot_dtype)
    for wg in (False, True):
        outs = [nan(B, N, F), _nan_like(ins[1]), _nan_like(ins[2]),
                nan(B, 3, N, K)]
        wpart, dw = _wpart(handle, B, N, F, R, max_blocks), nan(n_w)
        scratch = nan(handle.nn_klist_scratch_floats(F, R, 1))
        assert handle.nn_klist_bwd(
            *ptrs(ins + cots[:2] + outs),
            wpart.data_ptr() if wg else None, dw.data_ptr() if wg else None,
            scratch.data_ptr(), B, N, K, F, R, fl, int(wg), bf, max_blocks,
            None) == 0
        ref = fk.klist_bwd_ref(*ins, *cots[:2], first_layer=first_layer,
                               weight_grads=wg, dot_dtype=dot_dtype)
        got += outs + (list(dw.split([R * F] + [F * F] * 4)) if wg else [])
        want += list(ref[:4]) + ([r.reshape(-1) for r in ref[4:]]
                                 if wg else [])
    return got, want


def run_k78(handle, ins, tans, cots, first_layer, bf16, max_blocks=3,
            dot_dtype='float32'):
    '''(K7, K8) outputs of the emulated kernels, NaN-initialised, and the
    plain versions' values (in the library's mode, dot_dtype). K8's grid is
    at most max_blocks blocks.'''
    B, N, F = ins[0].shape
    K, R = ins[1].shape[2], ins[2].shape[-1]
    fl, bf = int(first_layer), int(bf16)
    n_w = R * F + 4 * F * F
    args = [ins[0], tans[0], ins[1], tans[1], ins[2], tans[2], ins[3],
            tans[3], ins[4]] + ins[5:]
    dfwd = [nan(B, N, F), nan(B, 3, N, F), nan(B, N, F), nan(B, 3, N, F)]
    scratch = nan(handle.nn_klist_scratch_floats(F, R, 2))
    assert handle.nn_klist_dual_fwd(*ptrs(args + dfwd + [scratch]), B, N, K,
                                    F, R, fl, bf, None) == 0
    got = list(dfwd)
    want = list(fk.klist_dual_fwd_ref(*args, first_layer=first_layer,
                                      dot_dtype=dot_dtype))
    dbwd = [nan(B, N, F), nan(B, N, F), _nan_like(ins[1]), _nan_like(tans[1])]
    wpart, dw = _wpart(handle, B, N, F, R, max_blocks), nan(n_w)
    assert handle.nn_klist_dual_bwd(*ptrs(args + cots + dbwd + [wpart, dw]),
                                    B, N, K, F, R, fl, bf, max_blocks,
                                    None) == 0
    ref = fk.klist_dual_bwd_ref(*args, *cots, first_layer=first_layer,
                                dot_dtype=dot_dtype)
    got += dbwd + list(dw.split([R * F] + [F * F] * 4))
    want += list(ref[:4]) + [r.reshape(-1) for r in ref[4:]]
    return got, want


def check_klist(got, want, bf16):
    '''Each output against its plain value: fp32 outputs hold BAR; the
    bf16-stored ones (dcat, dcatdot, drbf) one bf16 ulp, 2^-8 of the
    output's largest magnitude (a last-bit fp32 difference before the
    rounding can move a value to the neighbouring bf16 value).'''
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, k
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all(), k
        bar = 2.0 ** -8 if bf16 and got[k].dtype == torch.bfloat16 else BAR
        err = (g - w).abs().max().item()
        assert err <= bar * w.abs().max().item(), (k, err)
