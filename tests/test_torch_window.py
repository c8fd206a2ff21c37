'''The port's windowed gather and its transpose (newtonnet_tpu_torch/
ops/window.py: the plain versions of kernels K10 and K11, the window
arithmetic and the cell sort) against the JAX package's Pallas kernels
(ops/pallas_window.py) in interpret mode on the CPU, at the shapes of
tests/test_pallas_window.py (N=256, T=W=128).

Bars: the gather selects one bf16-rounded row: bitwise. The scatter sums
bf16-rounded rows in float32 in another order than the Pallas kernel's
matrix product: 1e-6 of the largest magnitude.
'''
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.ops import pallas_window as pw
from newtonnet_tpu_torch.ops import window as wn

B, K, N, F = 2, 5, 256, 12
T, W = 128, 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(seed=0):
    '''tests/test_pallas_window.py's recipe: in-window indices, a mask.'''
    rs = np.random.RandomState(seed)
    starts = np.repeat(
        np.array([(i * T + T // 2 - W // 2) % N for i in range(N // T)]), T)
    idx = ((starts[None, None, :] + rs.randint(0, W, size=(B, K, N))) % N
           ).astype(np.int32)
    mask = rs.rand(B, K, N) < 0.8
    x = rs.randn(B, N, F).astype(np.float32)
    y = rs.randn(B, K, N, F).astype(np.float32)
    return idx, mask, x, y


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_gather_equals_pallas_k10(monkeypatch, dtype):
    monkeypatch.setenv('NEWTONNET_PALLAS_INTERPRET', '1')
    idx, _, x, _ = _case()
    # out-of-window entries on both sides (the window drops them to 0)
    idx[0, 0, :40] = (idx[0, 0, :40] + W + 3) % N
    jx = jnp.asarray(x, dtype)
    want = np.asarray(pw.window_gather(jx, jnp.asarray(idx), W, T)
                      .astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = wn.window_gather(tx, torch.from_numpy(idx), W, T)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_scatter_equals_pallas_k11(monkeypatch, dtype):
    monkeypatch.setenv('NEWTONNET_PALLAS_INTERPRET', '1')
    idx, _, _, y = _case(1)
    idx[1, 2, 100:130] = (idx[1, 2, 100:130] + W) % N
    jy = jnp.asarray(y, dtype)
    want = np.asarray(pw.window_scatter_sum(jy, jnp.asarray(idx), W, T)
                      .astype(jnp.float32))
    ty = torch.from_numpy(np.array(jy.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = wn.window_scatter_sum(ty, torch.from_numpy(idx), W, T)
    assert got.dtype == ty.dtype
    ulp = np.finfo(np.float32).eps if dtype == 'float32' else 2.0 ** -8
    assert (np.abs(got.float().numpy() - want)
            <= 1e-6 * np.abs(want).max() + ulp * np.abs(want)).all()


def test_window_arithmetic_matches_jax():
    '''window_locals, check_window and window_margin against the JAX
    package's, on a list that passes and one with an edge moved out.'''
    idx, mask, _, _ = _case(2)
    bad = idx.copy()
    bad[0, 0, 0] = (bad[0, 0, 0] + W + 7) % N
    badmask = mask.copy()
    badmask[0, 0, 0] = True
    for i, m in ((idx, mask), (bad, badmask)):
        ti, tm = torch.from_numpy(i), torch.from_numpy(m)
        ji, jm = jnp.asarray(i), jnp.asarray(m)
        np.testing.assert_array_equal(wn.window_locals(ti, W, T).numpy(),
                                      np.asarray(pw._locals_kn(ji, N, W, T)))
        assert wn.check_window(ti, tm, W, T) == pw.check_window(ji, jm, W, T)
        assert wn.window_margin(ti, tm, W, T) == \
            pw.window_margin(ji, jm, W, T)
    assert wn.window_starts(N, W, T) == pw._starts(N, W, T)
    assert not wn.check_window(torch.from_numpy(bad),
                               torch.from_numpy(badmask), W, T)


def test_gather_and_scatter_are_transposes_and_each_others_backward():
    '''<gather(x), y> = <x, scatter(y)> in float64 over bf16-exact
    payloads, to the scatter's float32 sums (1e-6 relative); the gradient
    of the first in x is scatter(y), and the gradient of that in y, along
    v, is gather(v): each op's backward is the other.'''
    idx, _, x, y = _case(3)
    ti = torch.from_numpy(idx)

    def bf16_exact(a):
        return torch.from_numpy(a).to(torch.bfloat16).double()

    xb = bf16_exact(x).requires_grad_(True)
    yb = bf16_exact(y).requires_grad_(True)
    v = bf16_exact(x[::-1].copy())
    lhs = torch.sum(wn.window_gather(xb, ti, W, T) * yb)
    rhs = torch.sum(xb * wn.window_scatter_sum(yb, ti, W, T))
    assert abs(float((lhs - rhs).detach())) <= 1e-6 * abs(float(lhs.detach()))
    (g,) = torch.autograd.grad(lhs, xb, create_graph=True)
    assert torch.equal(g, wn.window_scatter_sum(yb, ti, W, T))
    (gy,) = torch.autograd.grad(torch.sum(g * v), yb)
    assert torch.equal(gy, wn.window_gather(v, ti, W, T))


def test_cell_sort_order_matches_the_experiment_tool(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    exp = importlib.import_module('tools.exp_window_gather')
    z, pos, cell, cutoff = exp.make_config(512)
    for frac in (1.0, 0.5):
        np.testing.assert_array_equal(
            wn.cell_sort_order(pos, cell, cutoff * frac),
            exp.cell_sort_order(pos, cell, cutoff * frac))


def test_shapes_the_window_ops_do_not_take_are_refused():
    x = torch.zeros(1, 100, 4)
    idx = torch.zeros(1, 2, 100, dtype=torch.int64)
    with pytest.raises(ValueError, match='N % T'):
        wn.window_gather(x, idx, 64, 128)
    with pytest.raises(ValueError, match='W <= N'):
        wn.window_scatter_sum(torch.zeros(1, 2, 128, 4),
                              torch.zeros(1, 2, 128, dtype=torch.int64),
                              256, 128)


@pytest.mark.cuda
def test_window_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    idx, _, x, y = _case(4)
    ti = torch.from_numpy(idx)
    for dt in (torch.float32, torch.bfloat16):
        tx, ty = torch.from_numpy(x).to(dt), torch.from_numpy(y).to(dt)
        got = wn.window_gather(tx.cuda(), ti.cuda(), W, T)
        s = wn.window_scatter_sum(ty.cuda(), ti.cuda(), W, T)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), wn.window_gather_ref(tx, ti, W, T))
        want = wn.window_scatter_sum_ref(ty, ti, W, T).float()
        ulp = torch.finfo(dt).eps * want.abs()
        assert ((s.cpu().float() - want).abs()
                <= 1e-6 * want.abs().max() + ulp).all()


@pytest.mark.cuda
def test_scatter_kernel_repeats_its_bits_on_cuda():
    '''Three K11 launches on one input give equal bits, fp32 and bf16
    payloads: its sums run in a fixed order, with no float atomics.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    idx, _, _, y = _case(4)
    ti = torch.from_numpy(idx).cuda()
    for dt in (torch.float32, torch.bfloat16):
        ty = torch.from_numpy(y).to(dt).cuda()
        runs = [wn.window_scatter_sum_fwd(ty, ti, W, T) for _ in range(3)]
        torch.cuda.synchronize()
        assert all(torch.equal(runs[0], r) for r in runs[1:])
