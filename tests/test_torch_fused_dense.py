'''The port's fused pair-interaction op (newtonnet_tpu_torch/ops/
fused_dense.py) against the JAX package's Pallas op
(newtonnet_tpu/ops/pallas_dense.py), run in interpret mode on the CPU as
tests/test_pallas_stack.py runs it, at that file's op shapes
(B=4, N=8, F=32, R=8) in float32.

Tolerances: the Pallas path returns float32 and sums in another order
than PyTorch's CPU kernels, so outputs agree to float32 rounding of sums
over N and F terms: atol 1e-5 for the forward (outputs of order 1) and
3e-5 for the cotangents, the bar of test_first_order_weight_grads_match_xla
(the weight cotangents sum over all B*N*N pair slots).
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.ops.pallas_dense import make_fused_pair_interaction
from newtonnet_tpu_torch.ops import fused_dense as fd

W_NAMES = ['We', 'W1a', 'W1b', 'W2a', 'W2b']


def _inputs(B=4, N=8, F=32, R=8, seed=0, dtype=np.float32):
    rs = np.random.RandomState(seed)
    np_ = rs.randn(B, N, F) * 0.3
    rbf = rs.randn(B, N, N, R) * 0.3
    dir_ = rs.randn(B, 3, N, N)
    adj = ((rs.rand(B, N, N) < 0.6) & ~np.eye(N, dtype=bool)) * 1.0
    force = rs.randn(B, 3, N, F) * 0.2
    ws = [rs.randn(*s) / np.sqrt(s[0])
          for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    dinv1 = rs.randn(B, N, F)
    deq = rs.randn(B, 3, N, F)
    cast = [a.astype(dtype) for a in [np_, rbf, dir_, adj, force] + ws]
    return cast, dinv1.astype(dtype), deq.astype(dtype)


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize('first_layer', [False, True])
def test_forward_matches_pallas(first_layer):
    ins, _, _ = _inputs(seed=1)
    op = make_fused_pair_interaction(bb=2, interpret=True,
                                     first_layer=first_layer)
    inv1_j, eq_j = op(*[jnp.asarray(a) for a in ins])
    inv1_t, eq_t = fd.pair_interaction_fwd_ref(*_torch(ins),
                                               first_layer=first_layer)
    np.testing.assert_allclose(inv1_t.numpy(), np.asarray(inv1_j), atol=1e-5)
    np.testing.assert_allclose(eq_t.numpy(), np.asarray(eq_j), atol=1e-5)


@pytest.mark.parametrize('first_layer', [False, True])
def test_backward_matches_pallas_vjp(first_layer):
    '''The hand-written backward against jax.vjp of the Pallas op: all
    nine cotangents (adj gets none).'''
    ins, dinv1, deq = _inputs(seed=2)
    op = make_fused_pair_interaction(bb=2, interpret=True,
                                     first_layer=first_layer)
    _, vjp = jax.vjp(op, *[jnp.asarray(a) for a in ins])
    cot_j = vjp((jnp.asarray(dinv1), jnp.asarray(deq)))
    cot_j = [c for k, c in enumerate(cot_j) if k != 3]  # drop adj
    cot_t = fd.pair_interaction_bwd_ref(*_torch(ins + [dinv1, deq]),
                                        first_layer=first_layer)
    names = ['dnp', 'drbf', 'ddir', 'dforce'] + ['d' + n for n in W_NAMES]
    for name, t, j in zip(names, cot_t, cot_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=3e-5,
                                   err_msg=name)


def test_backward_without_weight_grads_matches():
    '''weight_grads=False (the serving path) gives the same input
    cotangents and no weight cotangents.'''
    ins, dinv1, deq = _inputs(seed=3)
    args = _torch(ins + [dinv1, deq])
    full = fd.pair_interaction_bwd_ref(*args)
    lean = fd.pair_interaction_bwd_ref(*args, weight_grads=False)
    for a, b in zip(full[:4], lean[:4]):
        assert torch.equal(a, b)
    assert all(g is None for g in lean[4:])


@pytest.mark.parametrize('first_layer', [False, True])
def test_autograd_function_gradcheck(first_layer):
    '''FusedPairInteraction's backward (the hand-written one) against
    finite differences, in float64 on the CPU at a small size.'''
    ins, _, _ = _inputs(B=2, N=5, F=4, R=3, seed=4, dtype=np.float64)
    args = [t.requires_grad_(k != 3) for k, t in enumerate(_torch(ins))]

    def f(*a):
        return fd.FusedPairInteraction.apply(*a, first_layer)

    assert torch.autograd.gradcheck(f, tuple(args), eps=1e-6, atol=1e-6)


def test_autograd_function_returns_only_requested_weight_grads():
    ins, _, _ = _inputs(B=2, N=5, F=4, R=3, seed=5)
    args = _torch(ins)
    args[0].requires_grad_(True)
    args[6].requires_grad_(True)  # W1a only
    inv1, eq = fd.fused_pair_interaction(*args)
    (inv1.sum() + eq.sum()).backward()
    assert args[0].grad is not None and args[6].grad is not None
    assert all(args[k].grad is None for k in (5, 7, 8, 9))


def test_wrappers_take_the_plain_version_on_cpu():
    '''On CPU tensors the wrappers run the plain versions and launch
    nothing.'''
    ins, dinv1, deq = _inputs(seed=6)
    args = _torch(ins)
    fd.reset_launch_counts()
    out = fd.pair_interaction_fwd(*args)
    ref = fd.pair_interaction_fwd_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    fd.pair_interaction_bwd(*args, *_torch([dinv1, deq]))
    assert sum(fd.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    '''K1 and K2 against the plain versions on the card (both variants,
    weight cotangents on and off), at 1e-4 of each output's largest
    magnitude: fp32 sums in another order.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    for (B, N, F, R) in [(3, 21, 128, 20), (2, 19, 64, 16)]:
        ins, dinv1, deq = _inputs(B, N, F, R, seed=7)
        args = [t.cuda() for t in _torch(ins + [dinv1, deq])]
        for first in (False, True):
            got = fd.pair_interaction_fwd(*args[:10], first_layer=first)
            ref = fd.pair_interaction_fwd_ref(*args[:10], first_layer=first)
            for wg in (True, False):
                got += fd.pair_interaction_bwd(*args, first_layer=first,
                                               weight_grads=wg)
                ref += fd.pair_interaction_bwd_ref(*args, first_layer=first,
                                                   weight_grads=wg)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if r is None:
                    assert g is None
                    continue
                bar = 1e-4 * r.abs().max().item()
                assert (g - r).abs().max().item() <= bar


@pytest.mark.cuda
def test_backward_kernel_repeats_its_bits_on_cuda():
    '''Three K2 launches on one input give equal bits, both variants, with
    and without weight cotangents: every sum across blocks (the row and
    column partials of dnp and dforce, the weight partials) is taken in a
    fixed order, with no float atomics. B=5, N=21: 15 i-tiles and 30
    j-tiles of partials.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    ins, dinv1, deq = _inputs(5, 21, 128, 20, seed=11)
    args = [t.cuda() for t in _torch(ins + [dinv1, deq])]
    for first in (False, True):
        for wg in (False, True):
            runs = [fd.pair_interaction_bwd(*args, first_layer=first,
                                            weight_grads=wg)
                    for _ in range(3)]
            torch.cuda.synchronize()
            for run in runs[1:]:
                for a, b in zip(runs[0], run):
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert torch.equal(a, b)


@pytest.mark.cuda
def test_forward_kernel_repeats_its_bits_on_cuda():
    '''Three K1 launches on one input give equal bits, both variants: its
    row sums over the column tiles are taken in a fixed order, with no
    float atomics. B=5, N=21: 45 tiles, 3 column tiles per row.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    ins, _, _ = _inputs(5, 21, 128, 20, seed=12)
    args = [t.cuda() for t in _torch(ins)]
    for first in (False, True):
        runs = [fd.pair_interaction_fwd(*args, first_layer=first)
                for _ in range(3)]
        torch.cuda.synchronize()
        for run in runs[1:]:
            for a, b in zip(runs[0], run):
                assert torch.equal(a, b)

