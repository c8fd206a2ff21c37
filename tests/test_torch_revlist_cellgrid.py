'''Reverse lists and the cell grid in the port (ops/nlist.build_reverse_list,
edge_gather, edge_pull; ops/cellgrid.py; the reverse_lists and cell_grid
branches of models/xla_stack.py) against the JAX package on the CPU.

* build_reverse_list equals the JAX package's on the same list; edge_gather
  and edge_pull equal torch.gather's autograd in every derivative order
  (vjp, jvp, grad of grad, reverse over forward) at 1e-12 in float64.
* The cell grid gives neighbor_list's edge set (batches, padding, a 2x2x2
  grid whose wrapped images coincide) and counts overflow; its host
  helpers equal the JAX package's.
* Models at F <= 16, 2 interactions: reverse-list and cell-grid models
  equal the plain full-list model at 1e-10 in float64, and the JAX
  package's same-layout models at atol 2e-4 in float32.
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.ops import cellgrid as jcg
from newtonnet_tpu.ops import nlist as jnl
from newtonnet_tpu_torch import NewtonNet
from newtonnet_tpu_torch.ops import cellgrid as tcg
from newtonnet_tpu_torch.ops.nlist import (
    build_reverse_list,
    edge_gather,
    edge_pull,
    neighbor_list,
)
from newtonnet_tpu_torch.utils.params import params_to_flax

OUTS = ['energy', 'gradient_force', 'stress']


def system(seed, B=2, N=14, L=8.0, dtype=np.float64, pad=2):
    rs = np.random.RandomState(seed)
    z = rs.choice([1, 6, 8], size=(B, N)).astype(np.int64)
    if pad:
        z[:, -pad:] = 0
    pos = (rs.rand(B, N, 3) * L).astype(dtype)
    cell = np.broadcast_to(np.eye(3) * L, (B, 3, 3)).astype(dtype).copy()
    return z, pos, cell


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def edge_sets(idx, kmask):
    idx, kmask = np.asarray(idx), np.asarray(kmask)
    return [{(i, int(idx[b, i, k])) for i, k in zip(*np.nonzero(kmask[b]))}
            for b in range(idx.shape[0])]


def test_reverse_lists_equal_the_jax_packages():
    z, pos, cell = system(0, N=12)
    idx, kmask, _, _ = neighbor_list(*t(pos, cell), torch.from_numpy(z > 0),
                                     5.0, 11)
    rev, rev_mask = build_reverse_list(idx, kmask)
    jrev, jmask = jnl.build_reverse_list(jnp.asarray(idx.numpy()),
                                         jnp.asarray(kmask.numpy()))
    assert np.array_equal(rev.numpy(), np.asarray(jrev))
    assert np.array_equal(rev_mask.numpy(), np.asarray(jmask))
    # the slot map is an involution on the valid slots
    K = idx.shape[-1]
    flat = (idx * K + rev).flatten(1)
    back = torch.gather(flat, 1, flat)
    ok = rev_mask.flatten(1)
    assert torch.equal(back[ok], torch.arange(flat.shape[1]).expand_as(
        flat)[ok])


def _lists(seed):
    z, pos, cell = system(seed, N=10)
    idx, kmask, _, _ = neighbor_list(*t(pos, cell), torch.from_numpy(z > 0),
                                     5.0, 9)
    rev, rev_mask = build_reverse_list(idx, kmask)
    return idx, kmask, rev, rev_mask


@pytest.mark.parametrize('order', ['vjp', 'jvp', 'grad_of_grad',
                                   'reverse_over_forward'])
def test_edge_ops_in_every_derivative_order(order):
    '''edge_gather (masked, as the model uses it) against torch.gather's
    autograd, and edge_pull against its own dense definition, in float64:
    every order at 1e-12.'''
    idx, kmask, rev, rev_mask = _lists(1)
    B, N, K = idx.shape
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, N, 5, generator=g, dtype=torch.float64)
    w = torch.randn(B, N, K, 5, generator=g, dtype=torch.float64)
    m = kmask[..., None].double()

    def ref_gather(v):
        return torch.gather(v[:, None].expand(B, N, N, 5), 2,
                            idx[..., None].expand(B, N, K, 5)) * m

    def ours(v):
        return edge_gather(v, idx, rev, rev_mask) * m

    def f(op, v):
        return (op(v) ** 2 * w).sum()

    def rof(op, v):
        # reverse over forward: the gradient of a directional derivative
        return torch.func.grad(lambda s: torch.func.jvp(
            lambda q: f(op, q), (s,), (v.flip(1),))[1])(v)

    def pull_ref(y):
        flat = y.reshape(B, N * K, 5)
        at = (idx * K + rev).reshape(B, N * K, 1).expand(B, N * K, 5)
        return torch.where(rev_mask[..., None],
                           torch.gather(flat, 1, at).reshape(y.shape), 0)
    y = torch.randn(B, N, K, 5, generator=g, dtype=torch.float64)
    if order == 'vjp':
        a = torch.func.vjp(ours, x)[1](w)[0]
        b = torch.func.vjp(ref_gather, x)[1](w)[0]
        pa = torch.func.vjp(lambda u: edge_pull(u, idx, rev, rev_mask),
                            y)[1](w)[0]
        pb = torch.func.vjp(pull_ref, y)[1](w)[0]
    elif order == 'jvp':
        a = torch.func.jvp(ours, (x,), (x.flip(1),))[1]
        b = torch.func.jvp(ref_gather, (x,), (x.flip(1),))[1]
        pa = torch.func.jvp(lambda u: edge_pull(u, idx, rev, rev_mask),
                            (y,), (w,))[1]
        pb = torch.func.jvp(pull_ref, (y,), (w,))[1]
    elif order == 'grad_of_grad':
        def gg(op, v):
            v = v.clone().requires_grad_(True)
            gv, = torch.autograd.grad(f(op, v), v, create_graph=True)
            return torch.autograd.grad((gv ** 2).sum(), v)[0]
        a, b = gg(ours, x), gg(ref_gather, x)
        pa = torch.func.grad(lambda u: (torch.func.grad(
            lambda s: (edge_pull(s, idx, rev, rev_mask) ** 2 * w).sum())(u)
            ** 2).sum())(y)
        pb = torch.func.grad(lambda u: (torch.func.grad(
            lambda s: (pull_ref(s) ** 2 * w).sum())(u) ** 2).sum())(y)
    else:
        a, b = rof(ours, x), rof(ref_gather, x)
        pa = rof(lambda u: edge_pull(u, idx, rev, rev_mask), y)
        pb = rof(pull_ref, y)
    assert float((a - b).abs().max()) <= 1e-12 * max(1.0, float(b.abs().max()))
    assert float((pa - pb).abs().max()) <= 1e-12 * max(1.0,
                                                       float(pb.abs().max()))


def _pair(seed, dtype, **layout):
    '''(plain full-list model, model with `layout`), one set of weights.'''
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=2,
               output_properties=OUTS, graph_mode='neighborlist')
    k = layout.pop('k_max', 13)
    plain = NewtonNet(k_max=k, **cfg, device='cpu', dtype=dtype,
                      generator=torch.Generator().manual_seed(seed))
    other = NewtonNet(k_max=k, **cfg, **layout, device='cpu', dtype=dtype)
    other.load_state_dict(plain.state_dict())
    return plain, other


def _close(a, b, atol):
    for key in OUTS:
        np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]),
                                   atol=atol)


@pytest.mark.parametrize('given', [False, True])
def test_reverse_list_model_matches_the_full_list_model(given):
    '''float64, 1e-10: rev built in the model, or given as the 4-tuple.'''
    z, pos, cell = system(2)
    plain, rev_model = _pair(0, torch.float64, reverse_lists=True)
    args = t(z, pos, cell)
    nl = None
    if given:
        idx, kmask, _, _ = neighbor_list(args[1], args[2], args[0] > 0, 5.0,
                                         13)
        nl = (idx, kmask) + build_reverse_list(idx, kmask)
    _close(rev_model(*args, nlist=nl), plain(*args), 1e-10)


def _jax_compare(seed, nlist_fn=None, **layout):
    z, pos, cell = system(seed, dtype=np.float32)
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=2,
               output_properties=OUTS, graph_mode='neighborlist', k_max=13,
               **layout)
    tm = NewtonNet(**cfg, device='cpu',
                   generator=torch.Generator().manual_seed(seed))
    jm = JaxNewtonNet(**cfg)
    to = tm(*t(z, pos, cell))
    jo = jax.jit(lambda p: jm.apply(p, z.astype(np.int32), pos, cell))(
        params_to_flax(tm.core))
    _close(to, jo, 2e-4)


def test_reverse_list_model_matches_jax():
    _jax_compare(3, reverse_lists=True)


def test_cell_grid_model_matches_jax():
    _jax_compare(4, cell_grid=(1, 1, 1), cell_capacity=16)


@pytest.mark.parametrize('n, L, seed', [(128, 12.0, 0), (300, 16.0, 1)])
def test_cell_grid_matches_the_n2_build(n, L, seed):
    '''The edge set, the displacements' lengths and the overflow of
    neighbor_list; the host helpers equal the JAX package's.'''
    rs = np.random.RandomState(seed)
    pos = (rs.rand(1, n, 3) * L).astype(np.float32)
    cell = np.diag([L] * 3).astype(np.float32)[None]
    mask = torch.ones((1, n), dtype=torch.bool)
    grid = tcg.suggest_grid(cell[0], 5.0)
    cap = tcg.suggest_capacity(n, grid, margin=3.0)
    assert grid == jcg.suggest_grid(cell[0], 5.0)
    assert cap == jcg.suggest_capacity(n, grid, margin=3.0)
    ig, mg, dg, og = tcg.cell_grid_neighbor_list(*t(pos, cell), mask, 5.0,
                                                 64, grid, cap)
    ir, mr, dr, orf = neighbor_list(*t(pos, cell), mask, 5.0, 64)
    assert edge_sets(ig, mg) == edge_sets(ir, mr)
    assert int(og.sum()) == int(orf.sum()) == 0
    lg = torch.where(mg, dg.norm(dim=-1), 0).sum(-1)
    lr = torch.where(mr, dr.norm(dim=-1), 0).sum(-1)
    np.testing.assert_allclose(lg.numpy(), lr.numpy(), rtol=1e-5)


def test_cell_grid_batch_padding_small_grid_and_overflow():
    '''Two frames with padded atoms; a 2x2x2 grid (the wrapped -1 and +1
    cells coincide: no row lists a neighbour twice); a capacity too small
    for the cells, which shows as overflow.'''
    rs = np.random.RandomState(3)
    L = 11.0
    pos = (rs.rand(2, 96, 3) * L).astype(np.float32)
    cell = np.tile(np.diag([L] * 3)[None], (2, 1, 1)).astype(np.float32)
    mask = torch.ones((2, 96), dtype=torch.bool)
    mask[1, 80:] = False
    grid = tcg.suggest_grid(cell[0], 5.0)
    ig, mg, _, _ = tcg.cell_grid_neighbor_list(
        *t(pos, cell), mask, 5.0, 48, grid,
        tcg.suggest_capacity(96, grid, margin=3.0))
    ir, mr, _, _ = neighbor_list(*t(pos, cell), mask, 5.0, 48)
    assert edge_sets(ig, mg) == edge_sets(ir, mr)
    assert not bool(mg[1, 80:].any()) and not bool((mg[1] & (ig[1] >= 80))
                                                   .any())
    L2 = 10.2
    pos2 = (rs.rand(1, 64, 3) * L2).astype(np.float32)
    cell2 = np.diag([L2] * 3).astype(np.float32)[None]
    m2 = torch.ones((1, 64), dtype=torch.bool)
    i2, k2, _, o2 = tcg.cell_grid_neighbor_list(*t(pos2, cell2), m2, 5.0,
                                                63, (2, 2, 2), 32)
    assert int(o2.sum()) == 0
    for i in range(64):
        ids = i2[0, i][k2[0, i]]
        assert len(ids) == len(set(ids.tolist()))
    ir2, mr2, _, _ = neighbor_list(*t(pos2, cell2), m2, 5.0, 63)
    assert edge_sets(i2, k2) == edge_sets(ir2, mr2)
    _, _, _, ovf = tcg.cell_grid_neighbor_list(
        *t(pos[:1], cell[:1]), mask[:1], 5.0, 64, grid, 8)
    _, _, _, jovf = jcg.cell_grid_neighbor_list(
        jnp.asarray(pos[:1]), jnp.asarray(cell[:1]),
        jnp.asarray(mask[:1].numpy()), 5.0, 64, grid, 8)
    assert int(ovf.sum()) == int(np.asarray(jovf).sum()) > 0


def test_cell_grid_model_matches_the_full_list_model():
    '''float64, 1e-10, at 128 atoms on a 2x2x2 grid.'''
    rs = np.random.RandomState(5)
    L = 11.0
    z = rs.choice([1, 6, 8], size=(1, 128)).astype(np.int64)
    pos = rs.rand(1, 128, 3) * L
    cell = np.diag([L] * 3)[None]
    grid = tcg.suggest_grid(cell[0], 5.0)
    plain, grid_model = _pair(1, torch.float64, k_max=64, cell_grid=grid,
                              cell_capacity=tcg.suggest_capacity(128, grid,
                                                                 3.0))
    args = t(z, pos, cell)
    _close(grid_model(*args), plain(*args), 1e-10)
