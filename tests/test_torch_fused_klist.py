'''The port's fused K-list ops (newtonnet_tpu_torch/ops/fused_klist.py: the
plain versions of K5-K8 and their autograd Functions) against the JAX
package's Pallas ops (newtonnet_tpu/ops/pallas_klist.py), run in interpret
mode on the CPU as tests/test_pallas_klist.py runs them, at B=2, N=8,
K in {8, 13}, F=16, R=4, both variants, fp32 and bf16 edge storage.

Tolerances. fp32 edges: both sides compute in float32 and sum in another
order, so outputs agree to float32 rounding: atol 1e-5 for the forwards
(outputs of order 1) and 3e-5 for the cotangents (the weight cotangents sum
over all B*N*K slots). bf16 edges: both sides read the same bf16 inputs and
round the per-edge cotangents (dcat, dcatdot, drbf) to bf16 on store. A
float32 difference in the last bit of such a value before the rounding can
move it to the neighbouring bf16 value: one bf16 ulp, 2^-8 of its
magnitude. So the bf16-stored outputs are held to BF16_BAR = 2^-8 of each
output's largest magnitude, and the fp32 outputs to the fp32 bars.
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.ops.pallas_klist import (
    make_fused_klist_interaction,
    make_fused_klist_interaction_dual,
)
from newtonnet_tpu_torch.ops import fused_klist as fk

BF16_BAR = 2.0 ** -8


def _inputs(K, first_layer, seed, B=2, N=8, F=16, R=4):
    '''Layer inputs, the dual's tangents and both cotangent sets, in numpy
    float32, at the scale the model produces.'''
    rs = np.random.RandomState(seed)
    C = F if first_layer else 4 * F

    def r(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    mask = (rs.rand(B, N, K) < 0.7).astype(np.float32)
    ins = [r(B, N, F, scale=0.3), r(B, N, K, C, scale=0.3),
           r(B, N, K, R, scale=0.3), r(B, 3, N, K), mask]
    ws = [r(*s, scale=s[0] ** -0.5)
          for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    tangents = [r(B, N, F, scale=0.1), r(B, N, K, C, scale=0.1),
                r(B, N, K, R, scale=0.1), r(B, 3, N, K, scale=0.1)]
    cots = [r(B, N, F), r(B, 3, N, F), r(B, N, F, scale=0.3),
            r(B, 3, N, F, scale=0.3)]
    return ins, ws, tangents, cots


def _round_edges(arrays, bf16, edge_slots):
    '''Edge inputs rounded to bf16 (stored as bf16 in both packages).'''
    if not bf16:
        return arrays
    return [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            if k in edge_slots else a for k, a in enumerate(arrays)]


def _jax(a, bf16):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


def _torch(a, bf16):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.bfloat16() if bf16 else t


def _close(got, want, atol, bf16_stored=False):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if bf16_stored:
        atol = BF16_BAR * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


CASES = [(K, first, bf16) for K in (8, 13) for first in (False, True)
         for bf16 in (False, True)]


@pytest.mark.parametrize('K, first_layer, bf16', CASES)
def test_forward_and_backward_match_pallas(K, first_layer, bf16):
    '''K5 and K6 (with weight cotangents) against the Pallas op and its
    custom VJP; the mask gets no cotangent.'''
    ins, ws, _, (dinv1, deq, _, _) = _inputs(K, first_layer, seed=K)
    ins = _round_edges(ins, bf16, (1, 2))
    op = make_fused_klist_interaction(nb=4, interpret=True,
                                      dot_dtype=jnp.float32,
                                      with_force=not first_layer)
    jin = [jnp.asarray(a) for a in ins]
    for k in (1, 2):
        jin[k] = _jax(ins[k], bf16)
    jw = [jnp.asarray(w) for w in ws]
    out_j, vjp = jax.vjp(lambda *a: op(*a), *jin, *jw)
    cot_j = vjp((jnp.asarray(dinv1), jnp.asarray(deq)))
    tin = [_torch(a, bf16 and k in (1, 2)) for k, a in enumerate(ins)]
    tw = [torch.from_numpy(w) for w in ws]
    out_t = fk.klist_fwd_ref(*tin, *tw, first_layer=first_layer)
    for a, b in zip(out_t, out_j):
        _close(a, b, 1e-5)
    cot_t = fk.klist_bwd_ref(*tin, *tw, torch.from_numpy(dinv1),
                             torch.from_numpy(deq), first_layer=first_layer)
    # (dnpi, dcat, drbf, ddir, dWe, dW1a, dW1b, dW2a, dW2b); JAX adds dmask
    for k, (a, b) in enumerate(zip(cot_t, cot_j[:4] + cot_j[5:])):
        if k in (1, 2):
            assert a.dtype == (torch.bfloat16 if bf16 else torch.float32)
        _close(a, b, 3e-5, bf16_stored=bf16 and k in (1, 2))
    assert not np.asarray(cot_j[4]).any()
    # a masked slot gives exact zeros in dcat and drbf
    off = ins[4] == 0
    assert not cot_t[1].float().numpy()[off].any()
    assert not cot_t[2].float().numpy()[off].any()


@pytest.mark.parametrize('K, first_layer, bf16', CASES)
def test_dual_forward_and_backward_match_pallas(K, first_layer, bf16):
    '''K7 and K8 against the Pallas dual op and its custom VJP (which gives
    zeros for the geometry and the mask).'''
    ins, ws, tans, cots = _inputs(K, first_layer, seed=100 + K)
    npi, cat, rbf, dir_, mask = ins
    npidot, catdot, rbfdot, dirdot = tans
    args = [npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot, mask]
    edge = (2, 3, 4, 5)
    args = _round_edges(args, bf16, edge)
    op = make_fused_klist_interaction_dual(nb=4, interpret=True,
                                           dot_dtype=jnp.float32,
                                           with_force=not first_layer)
    jin = [_jax(a, bf16 and k in edge) for k, a in enumerate(args)]
    jw = [jnp.asarray(w) for w in ws]
    out_j, vjp = jax.vjp(lambda *a: op(*a), *jin, *jw)
    cot_j = vjp(tuple(jnp.asarray(c) for c in cots))
    tin = [_torch(a, bf16 and k in edge) for k, a in enumerate(args)]
    tw = [torch.from_numpy(w) for w in ws]
    out_t = fk.klist_dual_fwd_ref(*tin, *tw, first_layer=first_layer)
    for a, b in zip(out_t, out_j):
        _close(a, b, 1e-5)
    cot_t = fk.klist_dual_bwd_ref(*tin, *tw,
                                  *[torch.from_numpy(c) for c in cots],
                                  first_layer=first_layer)
    # (dnpi, dnpidot, dcat, dcatdot, dW*); JAX: the 9 args then the weights
    for k, (a, b) in enumerate(zip(cot_t, cot_j[:4] + cot_j[9:])):
        _close(a, b, 3e-5, bf16_stored=bf16 and k in (2, 3))
    for z in cot_j[4:9]:
        assert not np.asarray(z).any()


@pytest.mark.parametrize('first_layer', [False, True])
def test_autograd_functions_give_the_plain_cotangents(first_layer):
    '''FusedKlistInteraction(Dual).backward hands on the plain backward's
    cotangents (gradcheck in float64 of the first-order op), and the dual
    gives none for rbf, rbfdot, dir, dirdot and mask.'''
    ins, ws, tans, _ = _inputs(5, first_layer, seed=7, N=5, F=4, R=3)
    t = [torch.from_numpy(a).double().requires_grad_(k != 4)
         for k, a in enumerate(ins)]
    w = [torch.from_numpy(a).double().requires_grad_(True) for a in ws]
    if first_layer:  # the dead branch's weights get zero cotangents
        w[3].requires_grad_(False)
        w[4].requires_grad_(False)
    assert torch.autograd.gradcheck(
        lambda *a: fk.fused_klist_interaction(*a, first_layer=first_layer),
        t + w, eps=1e-6, atol=1e-6)
    npi, cat, rbf, dir_, mask = [a.detach() for a in t]
    dual = [npi.requires_grad_(True),
            torch.from_numpy(tans[0]).double().requires_grad_(True),
            cat.requires_grad_(True),
            torch.from_numpy(tans[1]).double().requires_grad_(True),
            rbf.requires_grad_(True),
            torch.from_numpy(tans[2]).double().requires_grad_(True),
            dir_.requires_grad_(True),
            torch.from_numpy(tans[3]).double().requires_grad_(True), mask]
    outs = fk.fused_klist_interaction_dual(*dual, *w,
                                           first_layer=first_layer)
    sum(o.sum() for o in outs).backward()
    for k in (4, 5, 6, 7):
        assert dual[k].grad is None
    assert all(a.grad is not None for a in dual[:4])


def test_wrappers_take_the_plain_version_on_cpu():
    '''On CPU tensors each wrapper runs its plain version and counts no
    launch.'''
    ins, ws, tans, cots = _inputs(8, False, seed=3)
    tin = [torch.from_numpy(a) for a in ins]
    tw = [torch.from_numpy(a) for a in ws]
    fk.reset_launch_counts()
    got = fk.klist_fwd(*tin, *tw)
    want = fk.klist_fwd_ref(*tin, *tw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    args = [tin[0], torch.from_numpy(tans[0]), tin[1],
            torch.from_numpy(tans[1]), tin[2], torch.from_numpy(tans[2]),
            tin[3], torch.from_numpy(tans[3]), tin[4]]
    got = fk.klist_dual_bwd(*args, *tw, *[torch.from_numpy(c) for c in cots])
    want = fk.klist_dual_bwd_ref(*args, *tw,
                                 *[torch.from_numpy(c) for c in cots])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(fk.LAUNCHES.values())


def test_launch_checks_refuse_what_the_kernels_do_not_take():
    '''The checks a CUDA launch makes first (run here on CPU tensors): the
    shapes they read, a bf16 edge flag, any width from 1 to 256 (F=16
    here), and refusals of a width without a kernel (past 256), a mixed
    edge dtype, a wrong shape and a strided tensor.'''
    ins, ws, _, _ = _inputs(5, False, seed=1, F=32, R=8)
    tin = [torch.from_numpy(a) for a in ins]
    tin[1], tin[2] = tin[1].bfloat16(), tin[2].bfloat16()
    tw = [torch.from_numpy(a) for a in ws]

    def check(ts, first_layer=False):
        named = list(zip(fk._NAMES, ts, fk._KINDS))
        return fk._checked(ts[0], ts[1], ts[2], named, first_layer)
    assert check(tin + tw) == (2, 8, 5, 32, 8, 1)
    small, small_w, _, _ = _inputs(5, False, seed=1)  # F=16
    assert check([torch.from_numpy(a) for a in small + small_w])[3] == 16
    with pytest.raises(ValueError, match='ROADMAP.md B'):
        wide, wide_w, _, _ = _inputs(5, False, seed=1, F=288, N=2)
        check([torch.from_numpy(a) for a in wide + wide_w])
    mixed = list(tin)
    mixed[2] = mixed[2].float()
    with pytest.raises(TypeError, match='rbf'):
        check(mixed + tw)
    with pytest.raises(ValueError, match='shape'):
        check(tin + tw, first_layer=True)  # cat is 4F wide, not F
    strided = list(tin)
    strided[3] = tin[3].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match='contiguous'):
        check(strided + tw)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    '''K5-K8 against their plain versions on the card, both variants, fp32
    and bf16 edges, ragged K; bars as chip_smoke.py's klist phase.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    for K, first, bf16 in CASES:
        ins, ws, tans, cots = _inputs(K, first, seed=K, F=32, R=8, N=21)
        edge = lambda a, e: _torch(a, bf16 and e).cuda()  # noqa: E731
        tin = [edge(a, k in (1, 2)) for k, a in enumerate(ins)]
        tw = [torch.from_numpy(w).cuda() for w in ws]
        tc = [torch.from_numpy(c).cuda() for c in cots]
        pairs = list(zip(fk.klist_fwd(*tin, *tw, first_layer=first),
                         fk.klist_fwd_ref(*tin, *tw, first_layer=first)))
        for wg in (False, True):
            got = fk.klist_bwd(*tin, *tw, *tc[:2], first_layer=first,
                               weight_grads=wg)
            want = fk.klist_bwd_ref(*tin, *tw, *tc[:2], first_layer=first,
                                    weight_grads=wg)
            pairs += [(a, b) for a, b in zip(got, want) if b is not None]
        args = [tin[0], edge(tans[0], False), tin[1], edge(tans[1], True),
                tin[2], edge(tans[2], True), tin[3], edge(tans[3], False),
                tin[4]]
        pairs += list(zip(fk.klist_dual_fwd(*args, *tw, first_layer=first),
                          fk.klist_dual_fwd_ref(*args, *tw,
                                                first_layer=first)))
        pairs += list(zip(
            fk.klist_dual_bwd(*args, *tw, *tc, first_layer=first),
            fk.klist_dual_bwd_ref(*args, *tw, *tc, first_layer=first)))
        torch.cuda.synchronize()
        for a, b in pairs:
            scale = b.float().abs().max().item()
            bar = BF16_BAR if (bf16 and a.dtype == torch.bfloat16) else 1e-4
            assert (a.float() - b.float()).abs().max().item() <= bar * scale


@pytest.mark.cuda
def test_dual_forward_kernel_repeats_its_bits_on_cuda():
    '''Three K7 launches on one input give equal bits, both variants, fp32
    and bf16 edges: its sums over the list stay inside a block, in a fixed
    order, and its products are deterministic.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    for first in (False, True):
        for bf16 in (False, True):
            ins, ws, tans, _ = _inputs(13, first, seed=5, F=128, R=20, N=37)
            edge = lambda a, e: _torch(a, bf16 and e).cuda()  # noqa: E731
            args = [edge(ins[0], False), edge(tans[0], False),
                    edge(ins[1], True), edge(tans[1], True),
                    edge(ins[2], True), edge(tans[2], True),
                    edge(ins[3], False), edge(tans[3], False),
                    edge(ins[4], False)]
            tw = [torch.from_numpy(w).cuda() for w in ws]
            runs = [fk.klist_dual_fwd(*args, *tw, first_layer=first)
                    for _ in range(3)]
            torch.cuda.synchronize()
            for run in runs[1:]:
                for a, b in zip(runs[0], run):
                    assert torch.equal(a, b)


@pytest.mark.cuda
def test_backward_kernel_repeats_its_bits_on_cuda():
    '''Three K6 launches on one input give equal bits, both variants, fp32
    and bf16 edges, with and without weight cotangents: its sums over the
    list stay inside a block and its weight partials are summed in a fixed
    order, with no float atomics.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    for first in (False, True):
        for bf16 in (False, True):
            ins, ws, _, cots = _inputs(13, first, seed=6, F=128, R=20, N=37)
            edge = lambda a, e: _torch(a, bf16 and e).cuda()  # noqa: E731
            tin = [edge(a, k in (1, 2)) for k, a in enumerate(ins)]
            tw = [torch.from_numpy(w).cuda() for w in ws]
            tc = [torch.from_numpy(c).cuda() for c in cots[:2]]
            for wg in (False, True):
                runs = [fk.klist_bwd(*tin, *tw, *tc, first_layer=first,
                                     weight_grads=wg) for _ in range(3)]
                torch.cuda.synchronize()
                for run in runs[1:]:
                    for a, b in zip(runs[0], run):
                        assert (a is None) == (b is None)
                        if a is not None:
                            assert torch.equal(a, b)



@pytest.mark.cuda
def test_forward_kernel_repeats_its_bits_on_cuda():
    '''Three K5 launches on one input give equal bits, both variants, fp32
    and bf16 edges, with more atom tiles than blocks on a 3-block grid
    and on the wrapper's one block per SM: its sums over the list stay
    inside a block, in a fixed order, with no float atomics.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    for first in (False, True):
        for bf16 in (False, True):
            ins, ws, _, _ = _inputs(13, first, seed=4, F=128, R=20, N=37)
            edge = lambda a, e: _torch(a, bf16 and e).cuda()  # noqa: E731
            tin = [edge(a, k in (1, 2)) for k, a in enumerate(ins)]
            tw = [torch.from_numpy(w).cuda() for w in ws]
            runs = [fk.klist_fwd(*tin, *tw, first_layer=first)
                    for _ in range(3)]
            torch.cuda.synchronize()
            for run in runs[1:]:
                for a, b in zip(runs[0], run):
                    assert torch.equal(a, b)
