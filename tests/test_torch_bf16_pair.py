'''The plain bf16 modes of K1/K2 and K5/K6 (pallas_dot_dtype: bfloat16)
against the JAX package's Pallas ops in interpret mode, on the CPU.

    python tests/test_torch_bf16_pair.py aspirin   # JAX_BF16_ASPIRIN_*
    python tests/test_torch_bf16_pair.py lj        # JAX_BF16_LJ_*

The Pallas kernels round to bf16 both operands of each product they cast
and accumulate in fp32 (ops/pallas_dense.py `_chain` and K2's `dotT`;
K2's cotangent products dh, dmsg, drbf stay fp32. ops/pallas_klist.py
`_mk_dot` / `_mk_dotT`: every product of K5/K6). The plain versions
(ops/fused_dense.py, ops/fused_klist.py) round the same operands and
multiply them in fp32, where a product of two bf16 values is exact.

Bars, per output: the largest element error within 2e-3 of the output's
largest magnitude (DUAL_BF16_BAR: an fp32 difference of a sum can flip
the bf16 rounding of a later operand, one bf16 ulp, 2^-8 of it), and the
median element error, over the elements where the JAX output is not zero,
within 1e-6 of that magnitude: where the rounding sites match, the two
differ only by the fp32 summation order and a rare flip. A plain version
that rounds one operand more or one less passes the first bar but not the
second; the control case shows it (K2 with K6's rounding rule, its
cotangent products rounded too, fails the median bar).

As a script it prints the JAX package's bf16 numbers that chip_smoke.py
phase 10 embeds (the card's machine has no flax): `aspirin` the first
ASPIRIN_FRAMES aspirin test frames through artifacts/md17_model_pallas
with pallas_dot_dtype bfloat16 (dense), and the bf16-to-fp32 spread of
the JAX package on those frames (about 3 minutes); `lj` the trained LJ
checkpoint as a kernel='pallas' bf16 model (chip_smoke.LJ_PALLAS) on
lj_box's 64-atom box, dense and over plain K-lists with fp32 and bf16
edges, with the same spreads (about a minute).
'''
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == '__main__':  # the recipe, run as a script
    sys.path.insert(0, ROOT)

from newtonnet_tpu.ops.pallas_dense import make_fused_pair_interaction
from newtonnet_tpu.ops.pallas_klist import make_fused_klist_interaction
from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_klist as fk

MAX_BAR = 2e-3      # of each output's largest magnitude
MEDIAN_BAR = 1e-6   # of the same, for the median element error
WIDTHS = (32, 48)
ASPIRIN_FRAMES = 50
# the LJ checkpoint's layouts: (graph_mode, compute_dtype of the edges)
LJ_LAYOUTS = {'dense': ('dense', ''),
              'klist_fp32_edges': ('neighborlist', ''),
              'klist_bf16_edges': ('neighborlist', 'bfloat16')}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _arrays(rs, shapes, scales):
    return [(rs.randn(*s) * c).astype(np.float32)
            for s, c in zip(shapes, scales)]


def _weights(rs, F, R):
    return [(rs.randn(*s) / np.sqrt(s[0])).astype(np.float32)
            for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def errors(got, want):
    '''(max element error, median element error over want != 0), both
    over want's largest magnitude.'''
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    nz = want != 0
    median = float(np.median(err[nz])) if nz.any() else 0.0
    return float(err.max() / scale), median / scale


def check_outputs(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        worst, median = errors(g, w)
        assert worst <= MAX_BAR, (what, k, worst)
        assert median <= MEDIAN_BAR, (what, k, median)


def dense_case(F, first, seed=0):
    '''Inputs of K1 at B=2, N=6, R=5, and K2's cotangents.'''
    rs = np.random.RandomState(seed + F + 7 * first)
    B, N, R = 2, 6, 5
    adj = ((rs.rand(B, N, N) < 0.7) & ~np.eye(N, dtype=bool)) \
        .astype(np.float32)
    ins = _arrays(rs, [(B, N, F), (B, N, N, R), (B, 3, N, N)],
                  [0.5, 0.5, 1.0]) + [adj]
    ins += _arrays(rs, [(B, 3, N, F)], [0.3]) + _weights(rs, F, R)
    cots = _arrays(rs, [(B, N, F), (B, 3, N, F)], [1.0, 1.0])
    return ins, cots


def jax_dense(ins, cots, first):
    op = make_fused_pair_interaction(bb=1, interpret=True,
                                     dot_dtype=jnp.bfloat16,
                                     first_layer=first)
    out, vjp = jax.vjp(op, *[jnp.asarray(a) for a in ins])
    cot = vjp(tuple(jnp.asarray(c) for c in cots))
    return out, [c for k, c in enumerate(cot) if k != 3]  # no adj


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize('F', WIDTHS)
@pytest.mark.parametrize('first', (False, True))
def test_plain_bf16_k1_k2_match_pallas(F, first):
    '''K1's and K2's plain bf16 versions (forward, every input cotangent
    and the five weight cotangents) against the Pallas op and its VJP.'''
    ins, cots = dense_case(F, first)
    out_j, cot_j = jax_dense(ins, cots, first)
    out_t = fd.pair_interaction_fwd_ref(*_t(ins), first_layer=first,
                                        dot_dtype='bfloat16')
    check_outputs(out_t, out_j, 'K1')
    cot_t = fd.pair_interaction_bwd_ref(*_t(ins + cots), first_layer=first,
                                        dot_dtype='bfloat16')
    if first:  # dforce, dW2a, dW2b: zeros on both sides
        keep = [0, 1, 2, 4, 5, 6]
        for k in (3, 7, 8):
            assert not cot_t[k].any() and not np.asarray(cot_j[k]).any()
        cot_t, cot_j = [cot_t[k] for k in keep], [cot_j[k] for k in keep]
    check_outputs(cot_t, cot_j, 'K2')


def klist_case(F, first, bf16_edges, seed=0):
    '''Inputs of K5 at B=2, N=8, K=6, R=5 (the edge inputs rounded to bf16
    where they are stored so), and K6's cotangents.'''
    rs = np.random.RandomState(seed + F + 3 * first + 11 * bf16_edges)
    B, N, K, R = 2, 8, 6, 5
    C = F if first else 4 * F
    mask = (rs.rand(B, N, K) < 0.75).astype(np.float32)
    ins = _arrays(rs, [(B, N, F), (B, N, K, C), (B, N, K, R),
                       (B, 3, N, K)], [0.5, 0.5, 0.5, 1.0]) + [mask]
    if bf16_edges:
        ins[1], ins[2] = _bf16_round(ins[1]), _bf16_round(ins[2])
    ins += _weights(rs, F, R)
    cots = _arrays(rs, [(B, N, F), (B, 3, N, F)], [1.0, 1.0])
    return ins, cots


def _edges(arrays, bf16_edges, jax_side):
    out = list(arrays)
    for k in (1, 2):
        if jax_side:
            out[k] = jnp.asarray(out[k],
                                 jnp.bfloat16 if bf16_edges else jnp.float32)
        else:
            t = torch.from_numpy(np.ascontiguousarray(out[k]))
            out[k] = t.bfloat16() if bf16_edges else t
    return out


@pytest.mark.parametrize('F', WIDTHS)
@pytest.mark.parametrize('first', (False, True))
@pytest.mark.parametrize('bf16_edges', (False, True))
def test_plain_bf16_k5_k6_match_pallas(F, first, bf16_edges):
    '''K5's and K6's plain bf16 versions against the Pallas K-list op and
    its VJP, with fp32 and with bf16 edges (dcat and drbf stored in the
    edge dtype on both sides).'''
    ins, cots = klist_case(F, first, bf16_edges)
    op = make_fused_klist_interaction(nb=4, interpret=True,
                                      dot_dtype=jnp.bfloat16,
                                      with_force=not first)
    jins = [jnp.asarray(a) for a in ins]
    jins = _edges(jins, bf16_edges, True)
    out_j, vjp = jax.vjp(lambda *a: op(*a), *jins)
    cot_j = vjp(tuple(jnp.asarray(c) for c in cots))
    cot_j = [np.asarray(jnp.asarray(c, jnp.float32))
             for k, c in enumerate(cot_j) if k != 4]  # no mask
    tins = _edges(_t(ins), bf16_edges, False)
    out_t = fk.klist_fwd_ref(*tins, first_layer=first, dot_dtype='bfloat16')
    check_outputs(out_t, out_j, 'K5')
    cot_t = fk.klist_bwd_ref(*tins, *_t(cots), first_layer=first,
                             dot_dtype='bfloat16')
    assert cot_t[1].dtype == cot_t[2].dtype == \
        (torch.bfloat16 if bf16_edges else torch.float32)
    if first:
        keep = [0, 1, 2, 3, 4, 5, 6]
        for k in (7, 8):
            assert not cot_t[k].any() and not np.asarray(cot_j[k]).any()
        cot_t, cot_j = [cot_t[k] for k in keep], [cot_j[k] for k in keep]
    check_outputs(cot_t, cot_j, 'K6')


def k2_with_k6_rounding(ins, cots, first):
    '''K2's cotangents computed by K6's plain bf16 version, which rounds
    the cotangent products too: the dense layer as a K-list of every atom
    (slot k = atom j, mask = adj), its per-slot cotangents summed over i.
    -> (dnp, drbf, ddir, dforce, dWe, dW1a, dW1b, dW2a, dW2b).'''
    np_, rbf, dir_, adj, force, *ws = _t(ins)
    B, N, F = np_.shape
    cat = np_[:, None].expand(B, N, N, F)
    if not first:
        cat = torch.cat([cat] + [force[:, d][:, None].expand(B, N, N, F)
                                 for d in range(3)], dim=-1)
    dnpi, dcat, drbf, ddir, *dws = fk.klist_bwd_ref(
        np_, cat.contiguous(), rbf, dir_, adj, *ws, *_t(cots),
        first_layer=first, dot_dtype='bfloat16')
    cols = dcat.sum(1)                                 # over i: (B, N, C)
    dforce = torch.zeros_like(force) if first else \
        torch.stack([cols[..., (d + 1) * F:(d + 2) * F] for d in range(3)],
                    dim=1)
    return [dnpi + cols[..., :F], drbf, ddir, dforce, *dws]


def test_k2_with_k6_rounding_fails_the_median_bar():
    '''The control: K2 with every cotangent product rounded (K6's rule) is
    within the max bar of the Pallas K2 but fails the median bar on the
    cotangents those products feed, while the fp32 ones of the true rule
    pass it (test_plain_bf16_k1_k2_match_pallas).'''
    ins, cots = dense_case(32, False)
    _, cot_j = jax_dense(ins, cots, False)
    control = k2_with_k6_rounding(ins, cots, False)
    worst = [errors(g, w) for g, w in zip(control, cot_j)]
    assert all(m <= 10 * MAX_BAR for m, _ in worst), worst
    # dnp, drbf and the weight cotangents of W1a, W2a and We
    for k in (0, 1, 4, 5, 7):
        assert worst[k][1] > MEDIAN_BAR, (k, worst[k])
    right = fd.pair_interaction_bwd_ref(*_t(ins + cots),
                                        dot_dtype='bfloat16')
    for k in (0, 1, 4, 5, 7):
        assert errors(right[k], cot_j[k])[1] <= MEDIAN_BAR


def test_the_dot_dtype_is_checked():
    '''A dot dtype other than float32 and bfloat16 raises, in the plain
    versions and in the wrappers, before anything runs.'''
    ins, cots = dense_case(32, False)
    with pytest.raises(ValueError, match='dot_dtype'):
        fd.pair_interaction_fwd(*_t(ins), dot_dtype='float16')
    with pytest.raises(ValueError, match='dot_dtype'):
        fd.pair_interaction_bwd_ref(*_t(ins + cots), dot_dtype='float16')
    ins, cots = klist_case(32, False, False)
    with pytest.raises(ValueError, match='dot_dtype'):
        fk.klist_fwd(*_t(ins), dot_dtype='float16')
    with pytest.raises(ValueError, match='dot_dtype'):
        fk.klist_bwd_ref(*_t(ins + cots), dot_dtype='float16')


# -------------------------------------------- the JAX numbers of phase 10 --
def jax_aspirin_frames(cs, n=ASPIRIN_FRAMES):
    '''The first n aspirin test frames as chip_smoke serves them (collate,
    n_pad=21).'''
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    return collate(parse_xyz(cs.XYZ)[:n], n_pad=21)


def jax_pallas_model(ckpt, **changes):
    from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
    from newtonnet_tpu.utils.checkpoint import load_model
    model, params = load_model(ckpt)
    return JaxNewtonNet(param_dtype=model.param_dtype,
                        **{**model.config_dict(), **changes}), params


def jax_aspirin(cs, dot_dtype):
    '''(energies (n,), forces (n, 21, 3)) of the first aspirin test frames
    through the JAX package's pallas checkpoint in dot_dtype (interpret
    mode on the CPU).'''
    b = jax_aspirin_frames(cs)
    model, params = jax_pallas_model(cs.CKPT, pallas_dot_dtype=dot_dtype)
    out = model.apply(params, jnp.asarray(b['z']), jnp.asarray(b['pos']),
                      jnp.asarray(b['cell']))
    return (np.asarray(out['energy'], np.float64),
            np.asarray(out['gradient_force'], np.float64))


def jax_lj(cs, layout, dot_dtype):
    '''(energy, forces (64, 3)) of lj_box's box through the JAX package's
    calculator, the LJ checkpoint as a kernel='pallas' model in dot_dtype
    over `layout` (LJ_LAYOUTS).'''
    from newtonnet_tpu.md.calculator import NewtonNetCalculator
    graph_mode, compute_dtype = LJ_LAYOUTS[layout]
    z, pos, cell, _, _ = cs.lj_box()
    model, params = jax_pallas_model(
        cs.LJ_CKPT, **cs.LJ_PALLAS, graph_mode=graph_mode,
        compute_dtype=compute_dtype, pallas_dot_dtype=dot_dtype)
    r = NewtonNetCalculator(model=model, params=params).calculate(
        numbers=z[0], positions=pos[0], cell=cell[0])
    return float(r['energy']), np.asarray(r['forces'], np.float64)


def spread(bf, fp):
    '''The JAX package's bf16-to-fp32 spread: the largest absolute
    difference.'''
    return float(np.abs(np.asarray(bf) - np.asarray(fp)).max())


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    cs = chip_smoke()
    if sys.argv[1:] == ['aspirin']:
        e, f = jax_aspirin(cs, 'bfloat16')
        e32, f32 = jax_aspirin(cs, 'float32')
        print(f'JAX_BF16_ASPIRIN_ENERGY = {e.tolist()!r}')
        print(f'JAX_BF16_ASPIRIN_FORCES_4 = '
              f'{np.round(f[:4], 7).tolist()!r}')
        print(f'JAX_BF16_ASPIRIN_SPREAD = '
              f"{ {'energy': spread(e, e32), 'forces': spread(f, f32)} !r}")
    elif sys.argv[1:] == ['lj']:
        out = {}
        for layout in LJ_LAYOUTS:
            e, f = jax_lj(cs, layout, 'bfloat16')
            e32, f32 = jax_lj(cs, layout, 'float32')
            out[layout] = (e, np.round(f[:8], 8).tolist(),
                           {'energy': abs(e - e32),
                            'forces': spread(f, f32)})
        for name, k in (('ENERGY', 0), ('FORCES_8', 1), ('SPREAD', 2)):
            print(f'JAX_BF16_LJ_{name} = '
                  f'{ {lay: out[lay][k] for lay in LJ_LAYOUTS} !r}')
    else:
        sys.exit('usage: python tests/test_torch_bf16_pair.py aspirin|lj')
