'''The port's inverse-list machinery (newtonnet_tpu_torch/ops/nlist.py:
symmetrize_slots, build_inverse_list, inv_gather / inv_scatter_sum,
recompute_displacements_kn) against the JAX package's, on the CPU in
float64, with lists built from the same seeded positions.

Bars: lists and gathers are integer or copy operations (exact); the sums
of inv_scatter_sum and the derivatives through it run in another order
than JAX's (atol 1e-12 in float64). Forward mode too: torch.func.jvp of
both ops against jax.jvp, and the reverse pass over each jvp, which the
kernel='xla' training step takes (train/fastgrad.py).
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.ops import nlist as jnl
from newtonnet_tpu_torch.ops import nlist as tnl


def _lists(B=2, N=14, K=10, cutoff=3.0, seed=0):
    '''A plain full list of seeded random atoms (the port's builder), its
    symmetric re-slotting, and the K-major lists.'''
    rs = np.random.RandomState(seed)
    pos = rs.rand(B, N, 3) * 6.0
    cell = np.zeros((B, 3, 3))
    idx, kmask, _, over = tnl.neighbor_list(
        torch.from_numpy(pos), torch.from_numpy(cell),
        torch.ones(B, N, dtype=torch.bool), cutoff, K)
    assert int(over.sum()) == 0
    idx2, m2 = tnl.symmetrize_slots(idx.numpy(), kmask.numpy(), k_max=K + 3)
    idx_kn = torch.from_numpy(idx2).transpose(1, 2).contiguous()
    m_kn = torch.from_numpy(m2).transpose(1, 2).contiguous()
    return pos, cell, idx.numpy(), kmask.numpy(), idx_kn, m_kn


def _edges(idx, mask):
    return {(b, i, int(j)) for b, i, k in zip(*np.nonzero(mask))
            for j in [idx[b, i, k]]}


def test_symmetrize_slots_keeps_the_edges_and_shares_slots():
    '''The same edge set as the input and as the JAX package's re-slotting
    (which may run its C++ builder and pick other slots), and the shared
    slot property idx2[i, c] = j <=> idx2[j, c] = i.'''
    _, _, idx, kmask, idx_kn, m_kn = _lists()
    idx2 = idx_kn.transpose(1, 2).numpy()
    m2 = m_kn.transpose(1, 2).numpy()
    j2, jm2 = jnl.symmetrize_slots(idx, kmask, k_max=idx2.shape[-1])
    assert _edges(idx2, m2) == _edges(idx, kmask) == _edges(j2, jm2)
    for b, i, c in zip(*np.nonzero(m2)):
        j = idx2[b, i, c]
        assert m2[b, j, c] and idx2[b, j, c] == i
    with pytest.raises(ValueError, match='raise k_max'):
        tnl.symmetrize_slots(idx[0], kmask[0], k_max=2)


def test_build_inverse_list_matches_jax():
    _, _, _, _, idx_kn, m_kn = _lists(seed=1)
    inv, invm = tnl.build_inverse_list(idx_kn, m_kn)
    j_inv, j_invm = jnl.build_inverse_list(jnp.asarray(idx_kn.numpy()),
                                           jnp.asarray(m_kn.numpy()))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(j_inv))
    np.testing.assert_array_equal(invm.numpy(), np.asarray(j_invm))
    # symmetric slots: the list is its own inverse
    assert torch.equal(torch.where(m_kn, inv, 0), torch.where(m_kn, idx_kn,
                                                                0))
    assert torch.equal(invm, m_kn)


def _jax_lists(idx_kn, m_kn):
    j_idx = jnp.asarray(idx_kn.numpy())
    j_m = jnp.asarray(m_kn.numpy())
    return (j_idx,) + tuple(jnl.build_inverse_list(j_idx, j_m))


def test_inv_gather_and_scatter_match_jax_in_every_derivative_order():
    '''Values, the VJP, grad-of-grad and the JVP (torch's double-backward
    form) of inv_gather, and inv_scatter_sum's values and VJP, against the
    JAX primitives, at K = 13 slots (three chunks of 6, the last narrower).'''
    _, _, _, _, idx_kn, m_kn = _lists(seed=2)
    inv, invm = tnl.build_inverse_list(idx_kn, m_kn)
    j_lists = _jax_lists(idx_kn, m_kn)
    B, K, N = idx_kn.shape
    assert K % tnl.SCATTER_CHUNK
    rs = np.random.RandomState(3)
    x, dx = rs.randn(B, N, 5), rs.randn(B, N, 5)
    y = rs.randn(B, K, N, 5) * m_kn.numpy()[..., None]
    m = m_kn.numpy()[..., None]
    lists = (idx_kn, inv, invm)

    def t(a, grad=False):
        return torch.tensor(a, requires_grad=grad)

    g = tnl.inv_gather(t(x), *lists)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jnl.inv_gather(jnp.asarray(x), *j_lists)))
    s = tnl.inv_scatter_sum(t(y), *lists)
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jnl.inv_scatter_sum(jnp.asarray(y), *j_lists)),
        atol=1e-12)

    def f_t(xt):
        return torch.sum((tnl.inv_gather(xt, *lists) * t(m)) ** 2)

    def f_j(xj):
        return jnp.sum((jnl.inv_gather(xj, *j_lists) * m) ** 2)

    xt = t(x, True)
    (gt,) = torch.autograd.grad(f_t(xt), xt, create_graph=True)
    np.testing.assert_allclose(gt.detach().numpy(),
                               np.asarray(jax.grad(f_j)(jnp.asarray(x))),
                               atol=1e-12)
    (ggt,) = torch.autograd.grad(torch.sum(gt ** 2), xt)
    ggj = jax.grad(lambda v: jnp.sum(jax.grad(f_j)(v) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(ggt.numpy(), np.asarray(ggj), atol=1e-10)
    _, jv_t = torch.autograd.functional.jvp(
        lambda v: tnl.inv_gather(v, *lists), t(x), t(dx))
    _, jv_j = jax.jvp(lambda v: jnl.inv_gather(v, *j_lists),
                      (jnp.asarray(x),), (jnp.asarray(dx),))
    np.testing.assert_array_equal(jv_t.numpy(), np.asarray(jv_j))
    yt = t(y, True)
    (vs_t,) = torch.autograd.grad(
        torch.sum(tnl.inv_scatter_sum(yt, *lists) * t(dx)), yt)
    vs_j = jax.grad(lambda v: jnp.sum(jnl.inv_scatter_sum(v, *j_lists)
                                      * dx))(jnp.asarray(y))
    np.testing.assert_allclose(vs_t.numpy() * m, np.asarray(vs_j) * m,
                               atol=1e-12)


def test_plain_flag_and_bf16_follow_the_same_path():
    '''plain=True gives the wrapper path's bits on the CPU; a bf16 scatter
    accumulates in bf16 as the JAX package's does (within two bf16 ulps
    of the float64 sum at this size).'''
    _, _, _, _, idx_kn, m_kn = _lists(seed=4)
    inv, invm = tnl.build_inverse_list(idx_kn, m_kn)
    y = torch.randn(idx_kn.shape + (8,), dtype=torch.float64) \
        * m_kn[..., None]
    a = tnl.inv_scatter_sum(y, idx_kn, inv, invm)
    b = tnl.inv_scatter_sum(y, idx_kn, inv, invm, plain=True)
    assert torch.equal(a, b)
    c = tnl.inv_scatter_sum(y.to(torch.bfloat16), idx_kn, inv, invm)
    assert c.dtype == torch.bfloat16
    assert (c.double() - a).abs().max() <= 2 * 2 ** -8 * a.abs().max()


def test_recompute_displacements_kn_matches_jax():
    '''Periodic displacements and their position gradient (through
    inv_scatter_sum) against the JAX package's.'''
    pos, _, _, _, idx_kn, m_kn = _lists(seed=5)
    cell = np.broadcast_to(np.eye(3) * 6.0, (2, 3, 3)).copy()
    inv, invm = tnl.build_inverse_list(idx_kn, m_kn)
    j_lists = _jax_lists(idx_kn, m_kn)
    w = np.random.RandomState(6).randn(*idx_kn.shape, 3) \
        * m_kn.numpy()[..., None]
    pt = torch.tensor(pos, requires_grad=True)
    d_t = tnl.recompute_displacements_kn(pt, torch.tensor(cell), idx_kn,
                                         inv, invm)
    (g_t,) = torch.autograd.grad(torch.sum(d_t * torch.tensor(w)), pt)

    def f_j(p):
        return jnl.recompute_displacements_kn(p, jnp.asarray(cell),
                                              *j_lists)

    d_j = f_j(jnp.asarray(pos))
    g_j = jax.grad(lambda p: jnp.sum(f_j(p) * w))(jnp.asarray(pos))
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j),
                               atol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-12)


def test_inv_gather_and_scatter_jvps_match_jax_and_differentiate():
    """torch.func.jvp of inv_gather and inv_scatter_sum against jax.jvp of
    the JAX primitives, and the gradient of a loss of each jvp in a
    parameter w that its tangent depends on (reverse over forward) against
    JAX's, in float64 at 1e-12; plain=True gives the same bits."""
    _, _, _, _, idx_kn, m_kn = _lists(seed=7)
    inv, invm = tnl.build_inverse_list(idx_kn, m_kn)
    lists = (idx_kn, inv, invm)
    j_lists = _jax_lists(idx_kn, m_kn)
    B, K, N = idx_kn.shape
    rs = np.random.RandomState(8)
    m = m_kn.numpy()[..., None]
    w = rs.randn(5, 5)
    cases = (
        (tnl.inv_gather, jnl.inv_gather, rs.randn(B, N, 5),
         rs.randn(B, N, 5), rs.randn(B, K, N, 5) * m),
        (tnl.inv_scatter_sum, jnl.inv_scatter_sum, rs.randn(B, K, N, 5) * m,
         rs.randn(B, K, N, 5) * m, rs.randn(B, N, 5)))
    for op_t, op_j, primal, tangent, cot in cases:
        _, out_t = torch.func.jvp(lambda v: op_t(v, *lists),
                                  (torch.tensor(primal),),
                                  (torch.tensor(tangent),))
        _, out_j = jax.jvp(lambda v: op_j(v, *j_lists),
                           (jnp.asarray(primal),), (jnp.asarray(tangent),))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=0, atol=1e-12)

        def loss_t(wt, plain=False):
            _, o = torch.func.jvp(
                lambda v: op_t(torch.sin(v), *lists, plain=plain),
                (torch.tensor(primal),), (torch.tensor(tangent) @ wt,))
            return torch.sum(o * torch.tensor(cot))

        def loss_j(wj):
            _, o = jax.jvp(lambda v: op_j(jnp.sin(v), *j_lists),
                           (jnp.asarray(primal),),
                           (jnp.asarray(tangent) @ wj,))
            return jnp.sum(o * cot)

        grads = []
        for plain in (False, True):
            wt = torch.tensor(w, requires_grad=True)
            grads.append(torch.autograd.grad(loss_t(wt, plain), wt)[0])
        assert torch.equal(grads[0], grads[1])
        np.testing.assert_allclose(
            grads[0].numpy(), np.asarray(jax.grad(loss_j)(jnp.asarray(w))),
            rtol=0, atol=1e-12)
