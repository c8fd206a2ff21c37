'''The CUDA source of kernels K1/K2 (newtonnet_tpu_torch/csrc/fused_dense.cu)
run on the CPU under an emulation of CUDA's thread model
(newtonnet_tpu_torch/csrc/emu/cuda_emu.h), against the plain PyTorch
versions. The card checks the same in chip_smoke.py; this catches faults of
indexing, masking and barriers before a source goes to the card.

Bar: max|kernel - plain| <= 1e-4 * max|plain| per output, as on the card:
both are float32 and sum in another order.
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

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'newtonnet_tpu_torch')
BAR = 1e-4


def _for_gxx(src):
    '''Rewrite a CUDA source for g++ over the emulation header.'''
    src = src.replace('#include <cuda_runtime.h>', '#include "cuda_emu.h"')
    src = src.replace('extern __shared__ float smem[];',
                      'float* smem = g_smem;')

    def launch(m):
        grid, block, smem = [p.strip() for p in m.group(2).split(',')][:3]
        return (f'emu_launch({grid}, {block}, {smem}, '
                f'[&] {{ {m.group(1).strip()}({m.group(3)}); }});')

    return re.sub(r'([\w<>, ]+?)<<<(.*?)>>>\((.*?)\);', launch, src,
                  flags=re.S)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    out = tmp_path_factory.mktemp('emu')
    with open(os.path.join(PKG, 'csrc', 'fused_dense.cu')) as f:
        (out / 'fused_dense_emu.cpp').write_text(_for_gxx(f.read()))
    so = out / 'libfused_dense_emu.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-I', os.path.join(PKG, 'csrc', 'emu'), '-o', str(so),
                    str(out / 'fused_dense_emu.cpp')], check=True,
                   timeout=600)
    handle = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.nn_pair_fwd.argtypes = [p] * 12 + [i] * 5 + [p]
    handle.nn_pair_fwd.restype = i
    handle.nn_pair_bwd.argtypes = [p] * 20 + [i] * 6 + [p]
    handle.nn_pair_bwd.restype = i
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


@pytest.mark.parametrize('first_layer', [False, True])
@pytest.mark.parametrize('shape', [(2, 10, 32, 8), (1, 17, 64, 16),
                                   (1, 21, 128, 20)])
def test_emulated_kernels_match_plain(lib, shape, first_layer):
    '''Ragged atom counts (10, 17, 21 are no multiple of the 8-row tiles),
    every width the kernels are built for, weight cotangents on and off.'''
    B, N, F, R = shape
    ins, dinv1, deq = _inputs(B, N, F, R, seed=N)
    inv1, eq = _nan(B, N, F), _nan(B, 3, N, F)
    assert lib.nn_pair_fwd(*_ptrs(ins + [inv1, eq]), B, N, F, R,
                           int(first_layer), None) == 0
    pairs = list(zip((inv1, eq), fd.pair_interaction_fwd_ref(
        *ins, first_layer=first_layer)))
    n_it = (N + 7) // 8
    n_w = R * F + 4 * F * F
    for wg in (True, False):
        outs = [_nan(B, N, F), _nan(B, N, N, R), _nan(B, 3, N, N),
                _nan(B, 3, N, F)]
        scratch = [_nan(B, n_it, N, F), _nan(B, n_it, 3, N, F)]
        wpart, dw = _nan(B * n_it, n_w), _nan(n_w)
        assert lib.nn_pair_bwd(
            *_ptrs(ins + [dinv1, deq] + outs + scratch),
            wpart.data_ptr() if wg else None, dw.data_ptr() if wg else None,
            B, N, F, R, int(first_layer), int(wg), None) == 0
        if wg:
            outs += [v.view(s) for v, s in zip(
                dw.split([R * F] + [F * F] * 4), [(R, F)] + [(F, F)] * 4)]
        ref = fd.pair_interaction_bwd_ref(*ins, dinv1, deq,
                                          first_layer=first_layer,
                                          weight_grads=wg)
        pairs += list(zip(outs, ref))
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
