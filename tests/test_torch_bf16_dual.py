'''The plain bf16 modes of K7/K8 (the K-list dual forward and backward,
pallas_dot_dtype: bfloat16) against the JAX package's Pallas dual op and
its custom VJP in interpret mode, on the CPU.

The Pallas dual kernels round to bf16 both operands of every product
(ops/pallas_klist.py `_mk_dot` / `_mk_dotT`: me, medot, p, pdot, phi,
phidot; dh, dhdot; dmsg, dmsgdot; the weight cotangents) and accumulate in
fp32. The plain versions (ops/fused_klist.py, dot_dtype='bfloat16') round
the same operands and multiply them in fp32, where a product of two bf16
values is exact.

Bars, per output (those of tests/test_torch_bf16_pair.py): the largest
element error within 2e-3 of the output's largest magnitude, and the
median element error, over the elements where the JAX output is not zero,
within 1e-6 of it. A plain version that rounds one operand more or one
less passes the first bar but not the second: the control, a K8 that
leaves the tangent operand of dh/dhdot (gdot) unrounded, fails the median
bar.
'''
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.ops.pallas_klist import make_fused_klist_interaction_dual
from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_klist as fk
from test_torch_bf16_pair import (
    MAX_BAR,
    MEDIAN_BAR,
    WIDTHS,
    _arrays,
    _bf16_round,
    _weights,
    check_outputs,
    errors,
)

EDGE = (2, 3, 4, 5)  # cat, catdot, rbf, rbfdot among the dual's inputs


def dual_case(F, first, bf16_edges, seed=0):
    '''The dual's inputs at B=2, N=8, K=6, R=5 (npi, npidot, cat, catdot,
    rbf, rbfdot, dir, dirdot, mask; the edge inputs rounded to bf16 where
    they are stored so), the five weights and K8's cotangents (di, dq,
    didot, dqdot).'''
    rs = np.random.RandomState(seed + F + 3 * first + 11 * bf16_edges)
    B, N, K, R = 2, 8, 6, 5
    C = F if first else 4 * F
    mask = (rs.rand(B, N, K) < 0.75).astype(np.float32)
    args = _arrays(rs, [(B, N, F), (B, N, F), (B, N, K, C), (B, N, K, C),
                        (B, N, K, R), (B, N, K, R), (B, 3, N, K),
                        (B, 3, N, K)],
                   [0.5, 0.3, 0.5, 0.3, 0.5, 0.3, 1.0, 0.3]) + [mask]
    if bf16_edges:
        for k in EDGE:
            args[k] = _bf16_round(args[k])
    ws = _weights(rs, F, R)
    cots = _arrays(rs, [(B, N, F), (B, 3, N, F), (B, N, F), (B, 3, N, F)],
                   [1.0, 1.0, 0.5, 0.5])
    return args, ws, cots


def jax_dual(args, ws, cots, first, bf16_edges):
    '''(outputs, the VJP's cotangents of npi, npidot, cat, catdot and the
    five weights) of the Pallas dual op in bf16 mode.'''
    op = make_fused_klist_interaction_dual(nb=4, interpret=True,
                                           dot_dtype=jnp.bfloat16,
                                           with_force=not first)
    jin = [jnp.asarray(a, jnp.bfloat16 if bf16_edges and k in EDGE
                       else jnp.float32) for k, a in enumerate(args)]
    out, vjp = jax.vjp(lambda *a: op(*a), *jin,
                       *[jnp.asarray(w) for w in ws])
    cot = vjp(tuple(jnp.asarray(c) for c in cots))
    for z in cot[4:9]:  # rbf, rbfdot, dir, dirdot, mask: none by design
        assert not np.asarray(z).any()
    return out, [np.asarray(jnp.asarray(c, jnp.float32))
                 for c in cot[:4] + cot[9:]]


def torch_args(args, ws, cots, bf16_edges):
    tin = []
    for k, a in enumerate(args):
        t = torch.from_numpy(np.array(a, np.float32))
        tin.append(t.bfloat16() if bf16_edges and k in EDGE else t)
    return tin, [torch.from_numpy(w) for w in ws], \
        [torch.from_numpy(c) for c in cots]


def _first_layer_zeros(cot_t, cot_j, first):
    '''At the first layer dW2a and dW2b are zeros on both sides; the other
    outputs.'''
    if not first:
        return cot_t, cot_j
    for k in (7, 8):
        assert not cot_t[k].any() and not np.asarray(cot_j[k]).any()
    return cot_t[:7], cot_j[:7]


@pytest.mark.parametrize('F', WIDTHS)
@pytest.mark.parametrize('first', (False, True))
@pytest.mark.parametrize('bf16_edges', (False, True))
def test_plain_bf16_k7_k8_match_pallas(F, first, bf16_edges):
    '''K7's and K8's plain bf16 versions (the dual forward; dnpi, dnpidot,
    dcat, dcatdot and the five weight cotangents) against the Pallas dual
    op and its VJP, with fp32 and bf16 edges (dcat and dcatdot stored in
    the edge dtype on both sides).'''
    args, ws, cots = dual_case(F, first, bf16_edges)
    out_j, cot_j = jax_dual(args, ws, cots, first, bf16_edges)
    tin, tw, tc = torch_args(args, ws, cots, bf16_edges)
    out_t = fk.klist_dual_fwd_ref(*tin, *tw, first_layer=first,
                                  dot_dtype='bfloat16')
    check_outputs(out_t, out_j, 'K7')
    cot_t = fk.klist_dual_bwd_ref(*tin, *tw, *tc, first_layer=first,
                                  dot_dtype='bfloat16')
    edt = torch.bfloat16 if bf16_edges else torch.float32
    assert cot_t[2].dtype == cot_t[3].dtype == edt
    check_outputs(*_first_layer_zeros(cot_t, cot_j, first), 'K8')


def k8_with_dhdot_tangent_unrounded(tin, tw, tc):
    '''K8's plain bf16 version with one rounding left out: dhdot = gdot
    Wb^T takes gdot in fp32 (Wb^T still rounded), as a paired product that
    rounds only its primal operand would. dh and dhdot are the products
    whose B is a transposed W1b or W2b, dh first in each branch.'''
    wbs = (tw[2], tw[4])
    seen = []

    def dots(dot_dtype):
        dot, dotT = fd._dots(dot_dtype)

        def dot_control(a, b):
            if any(b._base is w for w in wbs):
                seen.append(b)
                if len(seen) % 2 == 0:  # dhdot
                    return a @ b.bfloat16().float()
            return dot(a, b)
        return dot_control, dotT

    with mock.patch.object(fk, '_dots', dots):
        out = fk.klist_dual_bwd_ref(*tin, *tw, *tc, dot_dtype='bfloat16')
    assert len(seen) == 4  # dh, dhdot of both branches
    return out


def test_k8_with_an_unrounded_tangent_operand_fails_the_median_bar():
    '''The control: K8 with dhdot's tangent operand left in fp32 stays
    within 10x the max bar of the Pallas K8 but fails the median bar on
    the cotangents dhdot feeds, while the true rule passes it
    (test_plain_bf16_k7_k8_match_pallas).'''
    args, ws, cots = dual_case(32, False, False)
    _, cot_j = jax_dual(args, ws, cots, False, False)
    tin, tw, tc = torch_args(args, ws, cots, False)
    control = k8_with_dhdot_tangent_unrounded(tin, tw, tc)
    worst = [errors(g, w) for g, w in zip(control, cot_j)]
    assert all(m <= 10 * MAX_BAR for m, _ in worst), worst
    # dnpi, dnpidot and the weight cotangents of We, W1a and W2a
    for k in (0, 1, 4, 5, 7):
        assert worst[k][1] > MEDIAN_BAR, (k, worst[k])
    right = fk.klist_dual_bwd_ref(*tin, *tw, *tc, dot_dtype='bfloat16')
    for k in (0, 1, 4, 5, 7):
        assert errors(right[k], cot_j[k])[1] <= MEDIAN_BAR


def test_the_duals_dot_dtype_is_checked_and_counted():
    '''A dot dtype other than float32 and bfloat16 raises in the dual
    wrappers before anything runs; the autograd op hands its dot dtype to
    the backward, whose cotangents are the plain bf16 version's.'''
    args, ws, cots = dual_case(32, False, False)
    tin, tw, tc = torch_args(args, ws, cots, False)
    with pytest.raises(ValueError, match='dot_dtype'):
        fk.klist_dual_fwd(*tin, *tw, dot_dtype='float16')
    with pytest.raises(ValueError, match='dot_dtype'):
        fk.klist_dual_bwd(*tin, *tw, *tc, dot_dtype='float16')
    assert {'klist_dual_fwd_bf16', 'klist_dual_fwd_first_bf16',
            'klist_dual_bwd_bf16', 'klist_dual_bwd_first_bf16'} \
        <= set(fk.LAUNCHES)
    leaves = [t.clone().requires_grad_(k in (0, 1, 2, 3))
              for k, t in enumerate(tin)]
    wl = [w.clone().requires_grad_(True) for w in tw]
    outs = fk.fused_klist_interaction_dual(*leaves, *wl,
                                           dot_dtype='bfloat16')
    want = fk.klist_dual_fwd_ref(*tin, *tw, dot_dtype='bfloat16')
    for a, b in zip(outs, want):
        assert torch.equal(a, b)
    torch.autograd.backward(outs, tc)
    ref = fk.klist_dual_bwd_ref(*tin, *tw, *tc, dot_dtype='bfloat16')
    for g, r in zip([t.grad for t in leaves[:4]] + [w.grad for w in wl],
                    ref):
        assert torch.equal(g, r)
