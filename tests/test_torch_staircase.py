'''The staircase (newton3_compact) layout in the port (ops/staircase.py,
the _stair layer of models/xla_stack.py, the calculator's swap to the
newton3 layout, training over newton3c lists) against the JAX package.

* The host build: the port's C++ colouring (csrc/host/staircase.cpp, a
  copy of the JAX package's native one) and its numpy chunking give the
  JAX package's StairList bit for bit; the builder's invariants (every
  edge once, per-colour injectivity, the inverse maps, endpoints inside
  the chunk prefix, non-increasing widths); a plan fixes the shapes and a
  frame that does not fit it raises.
* The model at F <= 32, 2 interactions: the staircase equals the newton3
  layout at 1e-10 in float64 (energy, forces and the parameter gradient
  of a force loss), and the JAX package's staircase model at atol 2e-4 in
  float32.
* A newton3_compact checkpoint served by the calculator through the
  newton3 layout; a Trainer step over newton3c batches equals the
  newton3 model's over newton3 batches.
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.ops import staircase as jst
from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator
from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
from newtonnet_tpu_torch.ops import staircase as tst
from newtonnet_tpu_torch.ops.nlist import neighbor_list
from newtonnet_tpu_torch.utils.params import params_to_flax

OUTS = ['energy', 'gradient_force']
CUTOFF = 4.5


def frame(n=120, rho=0.08, seed=0, dtype=np.float64):
    L = (n / rho) ** (1 / 3)
    rs = np.random.RandomState(seed)
    z = rs.choice([1, 6, 8], size=(1, n)).astype(np.int64)
    pos = (rs.rand(1, n, 3) * L).astype(dtype)
    cell = np.diag([L, L, L]).astype(dtype)[None]
    return z, pos, cell


def full_list(z, pos, cell, k=64):
    idx, kmask, _, _ = neighbor_list(
        torch.from_numpy(pos), torch.from_numpy(cell),
        torch.from_numpy(z > 0), CUTOFF, k)
    return idx[0].numpy(), kmask[0].numpy()


def test_staircase_equals_the_jax_builder_bitwise():
    z, pos, cell = frame()
    idx, kmask = full_list(z, pos, cell)
    for kw in ({}, {'chunk': 5, 'pad': 4}):
        got = tst.staircase_half_list(idx, kmask, **kw)
        want = jst.staircase_half_list(idx, kmask, **kw)
        assert np.array_equal(got.perm, want.perm)
        assert np.array_equal(got.inv_perm, want.inv_perm)
        assert got.widths == want.widths
        for a, b in zip(got.chunks, want.chunks):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)


def test_staircase_builder_invariants_and_plans():
    z, pos, cell = frame(seed=1)
    idx, kmask = full_list(z, pos, cell)
    n = idx.shape[0]
    sl = tst.staircase_half_list(idx, kmask, chunk=5, pad=4)
    assert np.array_equal(sl.perm[sl.inv_perm], np.arange(n))
    rows = np.repeat(np.arange(n), idx.shape[1])[kmask.ravel()]
    cols = idx.ravel()[kmask.ravel()]
    want = set(map(tuple, np.sort(np.stack([rows, cols], 1), axis=1)))
    got = []
    for ch in sl.chunks:
        ci, cm, cv, cvm = (a[0] for a in ch)
        for t in range(ci.shape[0]):
            src = np.flatnonzero(cm[t])
            dst = ci[t][src]
            assert len(dst) == len(np.unique(dst))
            tgt = np.flatnonzero(cvm[t])
            assert np.array_equal(ci[t][cv[t][tgt]], tgt)
            assert dst.max(initial=-1) < ci.shape[1]
            got += [(min(u, v), max(u, v))
                    for u, v in zip(sl.perm[src], sl.perm[dst])]
    assert len(got) == len(set(got)) == len(want) and set(got) == want
    widths = [w for _, w in sl.widths]
    assert widths == sorted(widths, reverse=True)
    # a nearby frame fits the plan; a much denser one raises
    pos2 = pos + np.random.RandomState(1).randn(*pos.shape) * 0.02
    sl2 = tst.staircase_half_list(*full_list(z, pos2, cell), chunk=5,
                                  plan=sl.widths)
    assert sl2.widths == sl.widths
    with pytest.raises(ValueError, match='plan provides'):
        tst.staircase_half_list(*full_list(z, pos * 0.55, cell * 0.55,
                                           k=96), chunk=5, plan=sl.widths)


def _stair_inputs(z, pos, cell, chunk=6):
    '''(permuted z, pos, the chunk tuple as tensors, the StairList).'''
    sl = tst.staircase_half_list(*full_list(z, pos, cell), chunk=chunk)
    nl = tuple(tuple(torch.from_numpy(a) for a in ch)
               for ch in tst.stair_nlist(sl))
    return z[:, sl.perm], pos[:, sl.perm], nl, sl


def _pair(dtype, seed=0):
    cfg = dict(cutoff=CUTOFF, n_features=16, n_basis=8, n_interactions=2,
               output_properties=OUTS, graph_mode='neighborlist', k_max=48)
    m3 = NewtonNet(newton3=True, **cfg, device='cpu', dtype=dtype,
                   generator=torch.Generator().manual_seed(seed))
    mc = NewtonNet(newton3_compact=True, **cfg, device='cpu', dtype=dtype)
    mc.load_state_dict(m3.state_dict())
    return m3, mc


def _grads(model, args, nl, force):
    model.requires_grad_(True)
    out = model(*args, nlist=nl, create_graph=True)
    loss = (out['energy'] ** 2).sum() + \
        ((out['gradient_force'] - force) ** 2).sum()
    params = list(model.core.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return out, torch.cat([(torch.zeros_like(p) if g is None else g)
                           .flatten() for p, g in zip(params, grads)])


def test_staircase_matches_newton3_in_float64():
    z, pos, cell = frame(n=80, seed=3)
    m3, mc = _pair(torch.float64)
    args3 = [torch.from_numpy(a) for a in (z, pos, cell)]
    nl3 = host_symmetric_nlist(m3, *args3, skin=0.0)
    zs, ps, nlc, sl = _stair_inputs(z, pos, cell)
    argsc = [torch.from_numpy(a) for a in (zs, ps, cell)]
    force = torch.from_numpy(np.random.RandomState(7).randn(*pos.shape))
    o3, g3 = _grads(m3, args3, nl3, force)
    oc, gc = _grads(mc, argsc, nlc, force[:, sl.perm])
    np.testing.assert_allclose(oc['energy'].detach().numpy(),
                               o3['energy'].detach().numpy(), atol=1e-10)
    np.testing.assert_allclose(
        oc['gradient_force'].detach().numpy()[0][sl.inv_perm],
        o3['gradient_force'].detach().numpy()[0], atol=1e-10)
    assert float((gc - g3).abs().max()) <= 1e-10 * float(g3.abs().max())


def test_staircase_matches_jax_in_float32():
    z, pos, cell = frame(n=80, seed=4, dtype=np.float32)
    zs, ps, nlc, _ = _stair_inputs(z, pos, cell)
    cfg = dict(cutoff=CUTOFF, n_features=16, n_basis=8, n_interactions=2,
               output_properties=OUTS, graph_mode='neighborlist', k_max=48,
               newton3_compact=True)
    tm = NewtonNet(**cfg, device='cpu',
                   generator=torch.Generator().manual_seed(2))
    jm = JaxNewtonNet(**cfg)
    jnl = tuple(tuple(jnp.asarray(a.numpy()) for a in ch) for ch in nlc)
    jo = jax.jit(lambda p, n: jm.apply(p, zs.astype(np.int32), ps, cell,
                                       nlist=n))(params_to_flax(tm.core), jnl)
    to = tm(*(torch.from_numpy(a) for a in (zs, ps, cell)), nlist=nlc)
    for key in OUTS:
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   atol=2e-4)


def test_staircase_guards_and_calculator_swap():
    '''The layout refuses to combine with newton3 and needs its chunks; the
    calculator serves a newton3_compact model through the newton3 layout
    with the same parameters.'''
    with pytest.raises(ValueError, match='newton3_compact'):
        NewtonNet(graph_mode='neighborlist', newton3_compact=True,
                  newton3=True, output_properties=['energy'], device='cpu')
    z, pos, cell = frame(n=40, seed=5)
    m3, mc = _pair(torch.float32, seed=1)
    with pytest.raises(ValueError, match='staircase'):
        mc(*(torch.from_numpy(a) for a in (z, pos, cell)))
    calc = NewtonNetCalculator(model=mc, params={'params': params_to_flax(
        mc.core)['params']}, properties=['energy', 'forces'],
        precision='float64', device='cpu')
    assert calc.model.newton3 and not calc.model.newton3_compact
    r = calc.calculate(numbers=z[0], positions=pos[0], cell=cell[0])
    m3 = m3.double()
    args = [torch.from_numpy(a) for a in (z, pos, cell)]
    o3 = m3(*args, nlist=host_symmetric_nlist(m3, *args, skin=0.0))
    assert r['energy'] == pytest.approx(float(o3['energy'][0]), abs=1e-10)
    np.testing.assert_allclose(r['forces'],
                               o3['gradient_force'][0].numpy(), atol=1e-10)
