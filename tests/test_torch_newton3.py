'''newton3 half lists in the port (ops/nlist.newton3_half_list, the
layer's mirror aggregation in models/xla_stack.py, md/driver's half-list
branch and the calculator) against the JAX package, on the CPU.

* The host lists: the port's C++ (csrc/host/newton3.cpp, a copy of the
  JAX package's native builder) gives the JAX native builder's lists bit
  for bit; the JAX package's numpy newton3_half_list is the reference of
  their structure (each undirected edge once, per-slot injective on both
  sides, the Koenig slot count).
* The model, at F <= 32 and 2 interactions: newton3 over half lists equals
  the plain full-list model at 1e-10 in float64 (energy, forces, stress
  and the parameter gradient of a force loss, reverse over reverse), and
  the JAX package's newton3 model on the same lists at atol 2e-4 in
  float32 (tests/test_torch_xla_model.py's bar).
* Every derivative order of the newton3 forward and its training step
  runs gathers only: no scatter-add, index_add or float index_put.
The trained newton3 checkpoint artifacts/lj_liquid_newton3 is served
against the JAX package's calculator in tests/test_torch_xla_reference.py
(its `lj` recipe).
'''
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from newtonnet_tpu import native
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.ops.nlist import newton3_half_list as jax_half_ref
from newtonnet_tpu_torch import NewtonNet
from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
from newtonnet_tpu_torch.ops.nlist import (
    build_inverse_list,
    neighbor_list,
    newton3_half_list,
)
from newtonnet_tpu_torch.utils.params import params_to_flax

OUTS = ['energy', 'gradient_force', 'stress']
# aten ops that accumulate floats by index (scatter-adds and atomics)
SCATTERS = ('scatter_add', 'index_add', 'index_put', 'scatter_reduce',
            'index_reduce', 'put_')


def system(seed, B=2, N=14, L=8.0, dtype=np.float64):
    '''Random periodic frames, the last two atoms of each padding.'''
    rs = np.random.RandomState(seed)
    z = rs.choice([1, 6, 8], size=(B, N)).astype(np.int64)
    z[:, -2:] = 0
    pos = (rs.rand(B, N, 3) * L).astype(dtype)
    cell = np.broadcast_to(np.eye(3) * L, (B, 3, 3)).astype(dtype).copy()
    return z, pos, cell


def full_list(z, pos, cell, cutoff=5.0, k=13):
    '''The port's O(N^2) full list (numpy idx, mask), no overflow.'''
    idx, kmask, _, over = neighbor_list(
        torch.from_numpy(pos), torch.from_numpy(cell),
        torch.from_numpy(z > 0), cutoff, k)
    assert int(over.sum()) == 0
    return idx.numpy(), kmask.numpy()


def half_nlist(idx, kmask, k_max=None):
    '''The model's 4-tuple of a half list: (idx, mask, inv, inv_mask).'''
    idx2, m2 = newton3_half_list(idx, kmask, k_max=k_max)
    idx2, m2 = torch.from_numpy(idx2).long(), torch.from_numpy(m2)
    return (idx2, m2) + build_inverse_list(idx2.transpose(1, 2),
                                           m2.transpose(1, 2))


def models(seed, dtype, k_half, **kw):
    '''(plain full-list model, newton3 model) with one seeded set of
    parameters.'''
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=2,
               output_properties=OUTS, graph_mode='neighborlist', **kw)
    plain = NewtonNet(k_max=13, **cfg, device='cpu', dtype=dtype,
                      generator=torch.Generator().manual_seed(seed))
    n3 = NewtonNet(k_max=k_half, newton3=True, **cfg, device='cpu',
                   dtype=dtype)
    n3.load_state_dict(plain.state_dict())
    return plain, n3


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_half_lists_equal_the_native_builder_bitwise(seed):
    '''The port's C++ half list against the JAX package's native one on
    the same full list (default capacity, and a given k_max), bit for
    bit; its structure against the numpy reference's.'''
    if not (native.available() or native.ensure_built()):
        pytest.skip('the JAX package\'s native library does not build here')
    z, pos, cell = system(seed, B=1, N=60, L=11.0)
    idx, kmask = full_list(z, pos, cell, k=40)
    got = newton3_half_list(idx[0], kmask[0])
    want = native.newton3_half_list_native(idx[0], kmask[0])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                               want[1])
    k = got[0].shape[1] + 2
    got_k = newton3_half_list(idx[0].astype(np.int32), kmask[0], k_max=k)
    want_k = native.newton3_half_list_native(idx[0], kmask[0], k_out=k)
    assert np.array_equal(got_k[0], want_k[0])
    assert np.array_equal(got_k[1], want_k[1])
    # the reference's structure: the same undirected edges, each once,
    # and the same Koenig slot count
    ref = jax_half_ref(idx[0], kmask[0])
    n = idx.shape[1]

    def edges(i2, m2):
        rows = np.repeat(np.arange(n), i2.shape[1])[m2.ravel()]
        e = np.sort(np.stack([rows, i2.ravel()[m2.ravel()]], 1), 1)
        return sorted(map(tuple, e.tolist()))
    assert edges(*got) == edges(*ref)
    assert len(set(edges(*got))) == len(edges(*got))
    assert got[0].shape[1] == ref[0].shape[1]
    for k2 in range(got[0].shape[1]):
        tgt = got[0][:, k2][got[1][:, k2]]
        assert len(tgt) == len(set(tgt.tolist()))


def test_star_graph_orients_balanced_and_capacity_raises():
    '''A degree-5 star needs ceil(5/2) = 3 slots; a too-small k_max
    raises.'''
    N, K = 6, 5
    idx = np.zeros((N, K), np.int64)
    kmask = np.zeros((N, K), bool)
    idx[0], kmask[0] = np.arange(1, 6), True
    idx[1:, 0], kmask[1:, 0] = 0, True
    idx2, m2 = newton3_half_list(idx, kmask)
    assert idx2.shape[-1] == 3 and int(m2.sum()) == 5
    with pytest.raises(ValueError, match='k_max=2'):
        newton3_half_list(idx, kmask, k_max=2)


def test_newton3_matches_the_full_list_model_in_float64():
    '''Energy, forces and stress at 1e-10, and the parameter gradient of
    an energy + force loss (the standard step, reverse over reverse) at
    1e-10 of its largest component.'''
    z, pos, cell = system(3)
    idx, kmask = full_list(z, pos, cell)
    nl3 = half_nlist(idx, kmask)
    plain, n3 = models(0, torch.float64, nl3[0].shape[-1])
    args = [torch.from_numpy(a) for a in (z, pos, cell)]
    nlp = (torch.from_numpy(idx), torch.from_numpy(kmask))

    def run(model, nl):
        model.requires_grad_(True)
        out = model(*args, nlist=nl, create_graph=True)
        loss = (out['energy'] ** 2).sum() + \
            (out['gradient_force'] ** 2).sum()
        params = list(model.core.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return out, torch.cat([(torch.zeros_like(p) if g is None else g)
                               .flatten() for p, g in zip(params, grads)])
    (op, gp), (o3, g3) = run(plain, nlp), run(n3, nl3)
    for key in OUTS:
        np.testing.assert_allclose(o3[key].detach().numpy(),
                                   op[key].detach().numpy(), atol=1e-10)
    assert float((g3 - gp).abs().max()) <= 1e-10 * float(gp.abs().max())


@pytest.mark.parametrize('first_cd', ['', 'bfloat16'])
def test_newton3_matches_jax_on_the_same_lists(first_cd):
    '''float32 (atol 2e-4) and a bf16 stack (2e-2 of each output's
    largest magnitude, tests/test_torch_xla_model.py's bf16 bar) against
    the JAX package's newton3 model fed the same 4-tuple.'''
    z, pos, cell = system(4, dtype=np.float32)
    idx, kmask = full_list(z, pos, cell)
    nl3 = half_nlist(idx, kmask)
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=2,
               output_properties=OUTS, graph_mode='neighborlist',
               k_max=nl3[0].shape[-1], newton3=True, compute_dtype=first_cd)
    tm = NewtonNet(**cfg, device='cpu',
                   generator=torch.Generator().manual_seed(1))
    jm = JaxNewtonNet(**cfg)
    params = params_to_flax(tm.core)
    jnl = tuple(jnp.asarray(t.numpy()) for t in nl3)
    jo = jax.jit(lambda p, n: jm.apply(p, z.astype(np.int32), pos, cell,
                                       nlist=n))(params, jnl)
    to = tm(*(torch.from_numpy(a) for a in (z, pos, cell)), nlist=nl3)
    for key in OUTS:
        want = np.asarray(jo[key])
        bar = 2e-4 if not first_cd else 2e-2 * np.abs(want).max()
        np.testing.assert_allclose(to[key].numpy(), want, atol=bar)


class _Ops(TorchDispatchMode):
    '''Counts the aten ops that run, by name. The backward of a lookup in
    a per-element parameter table (node_embedding[z], the energy scaler's
    scale[z] and shift[z]: 119 rows) is an index_put into the table's
    gradient, as in the JAX package; it is counted apart, as
    'table_index_put'.'''

    def __init__(self):
        super().__init__()
        self.seen = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split('.')[0]
        if name.startswith('index_put') and args[0].shape[0] == 119:
            name = 'table_index_put'
        self.seen[name] += 1
        return func(*args, **(kwargs or {}))


def test_every_derivative_order_is_gather_only():
    '''The newton3 forward, its forces (reverse), and the parameter
    gradient of a force loss (reverse over reverse) run no aten
    scatter-add, index_add or index_put over atoms or edges: the mirror
    sum and the gathers' adjoints are row gathers (inv_scatter_sum /
    inv_gather).'''
    z, pos, cell = system(5)
    idx, kmask = full_list(z, pos, cell)
    nl3 = half_nlist(idx, kmask)
    _, n3 = models(2, torch.float64, nl3[0].shape[-1])
    n3.requires_grad_(True)
    args = [torch.from_numpy(a) for a in (z, pos, cell)]
    with _Ops() as ops:
        out = n3(*args, nlist=nl3, create_graph=True)
        loss = (out['gradient_force'] ** 2).sum()
        loss.backward()
    assert ops.seen['index'] > 0  # the row gathers (plain K9 on the CPU)
    bad = {k: v for k, v in ops.seen.items()
           if any(k.startswith(s) for s in SCATTERS)}
    assert not bad, bad


def test_host_lists_for_a_newton3_model():
    '''md/driver.host_symmetric_nlist builds the half list at 2k+8, its
    inverse on the device, and raises with the JAX text when k_max is too
    small for the half list.'''
    z, pos, cell = system(6)
    _, n3 = models(0, torch.float64, 8)
    idx2, m2, inv, invm = host_symmetric_nlist(n3, z, pos, cell, skin=0.0)
    assert idx2.shape == (2, 14, 8)
    ii = torch.where(invm, torch.gather(idx2.transpose(1, 2), 2, inv), -1)
    assert torch.equal(ii, torch.where(invm, torch.arange(14), -1))
    small = NewtonNet(cutoff=5.0, n_features=8, n_basis=4, n_interactions=1,
                      graph_mode='neighborlist', k_max=3, newton3=True,
                      output_properties=['energy'], device='cpu')
    with pytest.raises(ValueError, match='newton3 half list needs more'):
        host_symmetric_nlist(small, z, pos, cell, skin=0.0)


@pytest.mark.parametrize('layout', ['inverse_lists', 'newton3'])
def test_host_symmetric_nlist_equals_the_jax_packages(layout):
    '''md/driver.host_symmetric_nlist against the JAX package's on the
    same frames (two structures with padding, 200 atoms at the box's
    density): the same four arrays, bit for bit (both build the full list
    with the C++ cell list, then colour it with the same C++).'''
    if not (native.available() or native.ensure_built()):
        pytest.skip('the JAX package\'s native library does not build here')
    from newtonnet_tpu.md.driver import host_symmetric_nlist as jax_lists
    rs = np.random.RandomState(11)
    B, N, L = 2, 200, (196 / 0.1) ** (1 / 3)
    z = rs.choice([1, 1, 8], size=(B, N)).astype(np.int32)
    z[1, -4:] = 0
    pos = (rs.rand(B, N, 3) * L).astype(np.float32)
    cell = np.broadcast_to(np.eye(3) * L, (B, 3, 3)).astype(np.float32)
    cfg = dict(cutoff=5.0, n_features=8, n_basis=4, n_interactions=1,
               graph_mode='neighborlist', output_properties=['energy'],
               **{layout: True}, k_max=88 if layout == 'inverse_lists' else 48)
    got = host_symmetric_nlist(NewtonNet(**cfg, device='cpu'), z, pos, cell,
                               skin=0.0)
    want = jax_lists(JaxNewtonNet(**cfg), z, pos, cell, skin=0.0)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy()
                                                              .dtype))


def test_newton3_model_needs_its_half_list():
    '''Without a 4-tuple the newton3 model refuses (its k_max is a half
    list's), as the JAX model does outside init.'''
    z, pos, cell = system(7)
    _, n3 = models(0, torch.float64, 8)
    with pytest.raises(ValueError, match='precomputed half-list'):
        n3(*(torch.from_numpy(a) for a in (z, pos, cell)))


def test_fastgrad_over_half_lists_matches_the_standard_step():
    '''train/fastgrad.py's reverse over forward (fast_grad True) over the
    half lists gives the standard step's loss and parameter gradient
    (energy + force loss, float64, 1e-12): InvGather / InvScatterSum have
    jvps through their own apply.'''
    from newtonnet_tpu_torch.train import fastgrad
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
    z, pos, cell = system(8)
    nl3 = half_nlist(*full_list(z, pos, cell))
    _, n3 = models(3, torch.float64, nl3[0].shape[-1])
    n3.requires_grad_(True)
    loss, _ = get_loss_by_string({'energy': {'weight': 1.0},
                                  'gradient_force': {'weight': 5.0}})
    rs = np.random.RandomState(0)
    batch = {'z': torch.from_numpy(z), 'pos': torch.from_numpy(pos),
             'cell': torch.from_numpy(cell),
             'energy': torch.from_numpy(rs.randn(2)),
             'force': torch.from_numpy(rs.randn(*pos.shape)),
             'graph_mask': torch.ones(2, dtype=torch.bool)}
    out = []
    for step in (fastgrad.value_and_grad, standard_value_and_grad):
        value, _ = step(n3, loss, batch, nlist=nl3)
        out.append((float(value), [
            p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for p in n3.core.parameters()]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-12)
    for a, b in zip(out[0][1], out[1][1]):
        assert float((a - b).abs().max()) <= 1e-12 * max(
            1.0, float(b.abs().max()))
