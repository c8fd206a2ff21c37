'''The port's row gather (newtonnet_tpu_torch/ops/row_gather.py, the plain
version of kernel K9) against the JAX package's Pallas row gather
(ops/pallas_gather.py:row_gather, K9) and its 2-D experiment form
(tools/exp_pallas_gather.py:pallas_gather, K12), both in interpret mode on
the CPU. A gather is a copy: the bar is bitwise equality.
'''
import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu_torch.ops import row_gather as rg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(B, N, F, R, dtype, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, N, F).astype(np.float32)
    idx = rs.randint(0, N, size=(B, R)).astype(np.int32)
    jx = jnp.asarray(x, dtype)
    # the same values on both sides (bf16 rounding done once, by JAX)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        tx = tx.to(torch.bfloat16)
    return jx, tx, idx


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize('B, N, F, R, dtype', [
    (2, 64, 128, 200, jnp.float32),
    (1, 50, 256, 1000, jnp.bfloat16),
    (3, 17, 128, 9, jnp.float32)])
def test_plain_row_gather_equals_pallas_k9(monkeypatch, B, N, F, R, dtype):
    monkeypatch.setenv('NEWTONNET_PALLAS_INTERPRET', '1')
    from newtonnet_tpu.ops import pallas_gather as pg
    jx, tx, idx = _case(B, N, F, R, dtype, seed=R)
    want = np.asarray(pg.row_gather(jx, jnp.asarray(idx)).astype(jnp.float32))
    for it in (torch.int32, torch.int64):
        got = rg.row_gather(tx, torch.from_numpy(idx).to(it))
        assert got.dtype == tx.dtype and got.shape == (B, R, F)
        np.testing.assert_array_equal(_np(got), want)


def test_plain_row_gather_equals_pallas_k12(monkeypatch):
    '''K12 is K9's function without the batch axis: the port runs it as
    row_gather at B = 1.'''
    monkeypatch.setenv('NEWTONNET_PALLAS_INTERPRET', '1')
    monkeypatch.syspath_prepend(ROOT)
    sys.modules.pop('tools.exp_pallas_gather', None)
    exp = importlib.import_module('tools.exp_pallas_gather')
    assert exp.INTERPRET
    for dtype in (jnp.bfloat16, jnp.float32):
        jx, tx, idx = _case(1, 96, 128, 2048, dtype, seed=7)
        want = np.asarray(exp.pallas_gather(jx[0], jnp.asarray(idx[0]),
                                            block=1024).astype(jnp.float32))
        got = rg.row_gather(tx, torch.from_numpy(idx))[0]
        np.testing.assert_array_equal(_np(got), want)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    '''On the CPU the wrapper is the plain version (any dtype, a strided
    batch) and launches nothing; a tensor on no supported device raises.'''
    rg.reset_launch_counts()
    x = torch.randn(2, 9, 5, dtype=torch.float64)
    big = torch.randn(2, 4, 9, 5)
    idx = torch.randint(0, 9, (2, 30))
    assert torch.equal(rg.row_gather(x, idx), rg.row_gather_ref(x, idx))
    view = big[:, 1:3].reshape(2, 18, 5)
    got = rg.row_gather(view, idx)
    for b in range(2):
        assert torch.equal(got[b], view[b][idx[b]])
    assert not any(rg.LAUNCHES.values())
    with pytest.raises(ValueError, match='no kernel'):
        rg.row_gather(x.to('meta'), idx.to('meta'))


@pytest.mark.cuda
def test_row_gather_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rs = np.random.RandomState(0)
    for B, N, F, R, dt in [(1, 4096, 512, 50000, torch.bfloat16),
                           (2, 21, 3, 1000, torch.float32),
                           (3, 70, 128, 333, torch.float32)]:
        x = torch.from_numpy(rs.randn(B, N, F).astype(np.float32)).to(dt)
        idx = torch.from_numpy(rs.randint(0, N, size=(B, R)))
        got = rg.row_gather(x.cuda(), idx.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), rg.row_gather_ref(x, idx))
