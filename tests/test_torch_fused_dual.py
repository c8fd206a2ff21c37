'''The port's dual pair-interaction op (newtonnet_tpu_torch/ops/fused_dual.py)
against the JAX package's Pallas op (make_fused_pair_interaction_dual of
newtonnet_tpu/ops/pallas_dense.py), run in interpret mode on the CPU as
tests/test_pallas_stack.py runs it, at that file's op shapes (B=4, N=8,
F=32, R=8).

Tolerances. fp32 mode: the four outputs at atol 2e-5 and the cotangents at
5e-5, the bars of test_dual_forward_matches_jvp and test_dual_vjp_matches_xla
(float32 sums in another order). bf16 mode: both sides round the same
operands to bf16 and accumulate in fp32, so they differ where an fp32 sum
taken in another order flips a bf16 rounding of a later operand (one bf16
ulp is 2^-8 = 3.9e-3 relative); held at 2e-3 of each output's largest
magnitude, ten times tighter than the JAX package's own bf16-vs-fp32 bar
of 2e-2 (tests/test_pallas_stack.py:240).
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.ops.pallas_dense import make_fused_pair_interaction_dual
from newtonnet_tpu_torch.ops import fused_dual as fdd

NAMES = ('np_', 'npdot', 'rbf', 'rbfdot', 'dir_', 'dirdot', 'adj', 'force',
         'forcedot', 'We', 'W1a', 'W1b', 'W2a', 'W2b')
GRAD_NAMES = ('dnp', 'dnpdot', 'dforce', 'dforcedot', 'dWe', 'dW1a', 'dW1b',
              'dW2a', 'dW2b')
BF16_REL = 2e-3


def _inputs(B=4, N=8, F=32, R=8, seed=0, dtype=np.float32):
    '''The dual op's 14 inputs and the 4 cotangents of its outputs.'''
    rs = np.random.RandomState(seed)
    adj = ((rs.rand(B, N, N) < 0.6) & ~np.eye(N, dtype=bool)) * 1.0
    ins = [rs.randn(B, N, F) * 0.3, rs.randn(B, N, F) * 0.1,
           rs.randn(B, N, N, R) * 0.3, rs.randn(B, N, N, R) * 0.1,
           rs.randn(B, 3, N, N), rs.randn(B, 3, N, N) * 0.1, adj,
           rs.randn(B, 3, N, F) * 0.2, rs.randn(B, 3, N, F) * 0.1]
    ins += [rs.randn(*s) / np.sqrt(s[0])
            for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    cots = [rs.randn(B, N, F), rs.randn(B, 3, N, F), rs.randn(B, N, F),
            rs.randn(B, 3, N, F)]
    return ([a.astype(dtype) for a in ins], [c.astype(dtype) for c in cots])


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_op(first_layer, dot_dtype):
    return make_fused_pair_interaction_dual(
        bb=2, interpret=True, first_layer=first_layer,
        dot_dtype=jnp.bfloat16 if dot_dtype == 'bfloat16' else jnp.float32)


def _jax_vjp(ins, cots, first_layer, dot_dtype):
    '''The nine cotangents the op defines (np, npdot, force, forcedot, the
    five weights) through jax.vjp of the Pallas op.'''
    _, vjp = jax.vjp(_jax_op(first_layer, dot_dtype),
                     *[jnp.asarray(a) for a in ins])
    got = vjp(tuple(jnp.asarray(c) for c in cots))
    return [got[k] for k in (0, 1, 7, 8, 9, 10, 11, 12, 13)]


@pytest.mark.parametrize('first_layer', [False, True])
def test_dual_forward_matches_pallas(first_layer):
    ins, _ = _inputs(seed=1)
    want = _jax_op(first_layer, 'float32')(*[jnp.asarray(a) for a in ins])
    got = fdd.pair_interaction_dual_fwd_ref(*_torch(ins),
                                            first_layer=first_layer,
                                            dot_dtype='float32')
    for name, g, w in zip(('inv1', 'eq', 'inv1dot', 'eqdot'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize('first_layer', [False, True])
def test_dual_backward_matches_pallas_vjp(first_layer):
    '''The hand-written backward against jax.vjp of the Pallas op: every
    cotangent the op defines, the first layer's exact zeros included.'''
    ins, cots = _inputs(seed=2)
    want = _jax_vjp(ins, cots, first_layer, 'float32')
    got = fdd.pair_interaction_dual_bwd_ref(*_torch(ins + cots),
                                            first_layer=first_layer,
                                            dot_dtype='float32')
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   err_msg=name)
    if first_layer:
        for k in (1, 2, 3, 7, 8):
            assert not got[k].any(), GRAD_NAMES[k]


@pytest.mark.parametrize('first_layer', [False, True])
def test_dual_bf16_mode_matches_pallas_bf16(first_layer):
    '''Both packages in bf16 mode (every product operand rounded to bf16,
    fp32 accumulation), forward and backward, at BF16_REL of each output's
    largest magnitude; and bf16 mode is really on (it differs from fp32).'''
    ins, cots = _inputs(seed=3)
    args = _torch(ins + cots)
    want = list(_jax_op(first_layer, 'bfloat16')(
        *[jnp.asarray(a) for a in ins]))
    want += _jax_vjp(ins, cots, first_layer, 'bfloat16')
    got = list(fdd.pair_interaction_dual_fwd_ref(
        *args[:14], first_layer=first_layer, dot_dtype='bfloat16'))
    got += fdd.pair_interaction_dual_bwd_ref(
        *args, first_layer=first_layer, dot_dtype='bfloat16')
    f32 = fdd.pair_interaction_dual_bwd_ref(
        *args, first_layer=first_layer, dot_dtype='float32')
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= BF16_REL * scale, k
    assert (got[4] - f32[0]).abs().max() > 1e-4  # dnp moved by the rounding


@pytest.mark.parametrize('first_layer', [False, True])
def test_dual_autograd_function_gradcheck(first_layer):
    '''FusedPairInteractionDual's backward (the hand-written one) against
    finite differences, in float64 on the CPU at a small size, for the
    inputs it defines cotangents for.'''
    ins, _ = _inputs(B=2, N=5, F=4, R=3, seed=4, dtype=np.float64)
    grad_at = {0, 1, 7, 8, 9, 10, 11, 12, 13}
    args = [t.requires_grad_(k in grad_at) for k, t in enumerate(_torch(ins))]

    def f(*a):
        return fdd.FusedPairInteractionDual.apply(*a, first_layer, 'float32')

    assert torch.autograd.gradcheck(f, tuple(args), eps=1e-6, atol=1e-6)


def test_dual_autograd_function_gives_no_geometry_gradient():
    '''rbf, rbfdot, dir_, dirdot and adj get None, as the JAX custom VJP
    gives zeros there: the op backs the parameter gradient only.'''
    ins, _ = _inputs(B=2, N=5, F=4, R=3, seed=5)
    args = [t.requires_grad_(True) for t in _torch(ins)]
    outs = fdd.fused_pair_interaction_dual(*args, dot_dtype='float32')
    sum(o.sum() for o in outs).backward()
    for k, name in enumerate(NAMES):
        assert (args[k].grad is None) == (k in (2, 3, 4, 5, 6)), name


def test_dual_wrappers_take_the_plain_version_on_cpu():
    ins, cots = _inputs(seed=6)
    args = _torch(ins + cots)
    fdd.reset_launch_counts()
    out = fdd.pair_interaction_dual_fwd(*args[:14])
    ref = fdd.pair_interaction_dual_fwd_ref(*args[:14])
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    fdd.pair_interaction_dual_bwd(*args)
    assert sum(fdd.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match='dot_dtype'):
        fdd.pair_interaction_dual_fwd(*args[:14], dot_dtype='float16')


@pytest.mark.cuda
def test_dual_kernels_match_plain_on_cuda():
    '''K3 and K4 against the plain versions on the card, both variants:
    fp32 mode at 1e-4 of each output's largest magnitude (sums in another
    order), bf16 mode at BF16_REL.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    for (B, N, F, R) in [(3, 21, 128, 20), (2, 19, 64, 16)]:
        ins, cots = _inputs(B, N, F, R, seed=7)
        args = [t.cuda() for t in _torch(ins + cots)]
        for first in (False, True):
            for dt, bar in (('float32', 1e-4), ('bfloat16', BF16_REL)):
                kw = dict(first_layer=first, dot_dtype=dt)
                got = list(fdd.pair_interaction_dual_fwd(*args[:14], **kw))
                got += fdd.pair_interaction_dual_bwd(*args, **kw)
                ref = list(fdd.pair_interaction_dual_fwd_ref(*args[:14], **kw))
                ref += fdd.pair_interaction_dual_bwd_ref(*args, **kw)
                torch.cuda.synchronize()
                for g, r in zip(got, ref):
                    scale = r.abs().max().item()
                    assert (g - r).abs().max().item() <= bar * scale


@pytest.mark.cuda
def test_dual_bwd_kernel_repeats_its_bits_on_cuda():
    '''Three K4 launches on one input give equal bits, both modes and both
    variants, at the training shape: every sum that crosses blocks is a
    fixed-order reduction of per-block partials (no float atomics).'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    ins, cots = _inputs(10, 24, 128, 20, seed=8)
    args = [t.cuda() for t in _torch(ins + cots)]
    for first in (False, True):
        for dt in ('float32', 'bfloat16'):
            runs = [fdd.pair_interaction_dual_bwd(*args, first_layer=first,
                                                  dot_dtype=dt)
                    for _ in range(3)]
            for run in runs[1:]:
                assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
