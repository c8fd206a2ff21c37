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
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'newtonnet_tpu_torch')
BAR = 1e-4
BF16_BAR = 2e-3


def for_gxx(src):
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


def compile_emu(out, name, src):
    '''Compile a rewritten source with g++ into out/lib<name>.so.'''
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    (out / f'{name}.cpp').write_text(for_gxx(src))
    so = out / f'lib{name}.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-I', os.path.join(PKG, 'csrc', 'emu'), '-o', str(so),
                    str(out / f'{name}.cpp')], check=True, timeout=600)
    return ctypes.CDLL(str(so))


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
