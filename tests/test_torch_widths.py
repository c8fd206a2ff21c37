'''K1-K8 at any width, and the trained LJ checkpoint (F=48) as a
kernel='pallas' model, against the JAX package on the CPU.

    python tests/test_torch_widths.py lj-pallas   # JAX_LJ_PALLAS_*

The plain versions of K1-K8 (ops/fused_dense.py, fused_dual.py,
fused_klist.py) against the JAX package's Pallas ops in interpret mode at
F = 20, 48, 96 and 256, tiny B, N and K, with the bars of
test_torch_fused_dense.py, _dual.py and _klist.py (float32: 1e-5 forward,
3e-5 cotangents, 2e-5 / 5e-5 for the duals; bf16 duals 2e-3 of each
output's largest magnitude). The CUDA kernels take 1 <= F <= 256 (at the
next multiple of 32, and past 128 of 64); _build.padded_width refuses the
rest before anything is built.

The trained LJ checkpoint (artifacts/lj_liquid_newton3: newton3, F=48,
R=16, 2 interactions, k_max 16) overridden to kernel='pallas' with
newton3 off (chip_smoke.LJ_PALLAS), dense and over plain K-lists of its
k_max, on chip_smoke.lj_box's 64-atom box through both packages'
calculators: energy at rtol 1e-5 and forces to 1e-4 of their largest
magnitude (the float32 bars of phase 8a), and the embedded
JAX_LJ_PALLAS_* are this recipe's numbers. Step 1 of LJ_CONFIG's
fine-tuning (fastgrad, as both Trainers resolve fast_grad 'auto' for a
pallas model) on 3 frames, dense and over plain precomputed lists: the
loss at 1e-5 and the global gradient norm at 1e-3 (fp32 K-list duals) or
2e-3 (bf16 dense duals) relative. `lj-pallas` prints the JAX numbers that
chip_smoke.py embeds (the card's machine has no flax): about 2 minutes.
'''
import importlib.util
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == '__main__':  # the recipe, run as a script
    sys.path.insert(0, ROOT)

from newtonnet_tpu.ops.pallas_dense import (make_fused_pair_interaction,
                                            make_fused_pair_interaction_dual)
from newtonnet_tpu.ops.pallas_klist import (make_fused_klist_interaction,
                                            make_fused_klist_interaction_dual)
from newtonnet_tpu_torch.ops import _build
from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_dual as fdd
from newtonnet_tpu_torch.ops import fused_klist as fk

WIDTHS = (20, 48, 96, 256)
LAYOUTS = ('dense', 'neighborlist')


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


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# -------------------------------------------------------------- kernels --
@pytest.mark.parametrize('F', WIDTHS)
def test_plain_k1_k2_match_pallas_at_any_width(F):
    '''K1's and K2's plain versions against the Pallas op and its VJP (both
    variants), B=2, N=5, R=4.'''
    rs = np.random.RandomState(F)
    B, N, R = 2, 5, 4
    adj = ((rs.rand(B, N, N) < 0.6) & ~np.eye(N, dtype=bool)) \
        .astype(np.float32)
    ins = _arrays(rs, [(B, N, F), (B, N, N, R), (B, 3, N, N)],
                  [0.3, 0.3, 1.0]) + [adj]
    ins += _arrays(rs, [(B, 3, N, F)], [0.2]) + _weights(rs, F, R)
    dinv1, deq = _arrays(rs, [(B, N, F), (B, 3, N, F)], [1.0, 1.0])
    for first in (False, True):
        op = make_fused_pair_interaction(bb=1, interpret=True,
                                         first_layer=first)
        out_j, vjp = jax.vjp(op, *_j(ins))
        cot_j = vjp((jnp.asarray(dinv1), jnp.asarray(deq)))
        out_t = fd.pair_interaction_fwd_ref(*_t(ins), first_layer=first)
        for a, b in zip(out_t, out_j):
            _close(a, b, 1e-5)
        cot_t = fd.pair_interaction_bwd_ref(*_t(ins + [dinv1, deq]),
                                            first_layer=first)
        for a, b in zip(cot_t, [c for k, c in enumerate(cot_j) if k != 3]):
            _close(a, b, 3e-5)


@pytest.mark.parametrize('F', WIDTHS)
def test_plain_k3_k4_match_pallas_at_any_width(F):
    '''K3's and K4's plain versions against the Pallas dual op and its VJP
    in both dot modes (not at the first layer), B=2, N=5, R=4.'''
    rs = np.random.RandomState(F + 1)
    B, N, R = 2, 5, 4
    adj = ((rs.rand(B, N, N) < 0.6) & ~np.eye(N, dtype=bool)) \
        .astype(np.float32)
    ins = _arrays(rs, [(B, N, F), (B, N, F), (B, N, N, R), (B, N, N, R),
                       (B, 3, N, N), (B, 3, N, N)],
                  [0.3, 0.1, 0.3, 0.1, 1.0, 0.1]) + [adj]
    ins += _arrays(rs, [(B, 3, N, F), (B, 3, N, F)], [0.2, 0.1])
    ins += _weights(rs, F, R)
    cots = _arrays(rs, [(B, N, F), (B, 3, N, F)] * 2, [1.0] * 4)
    for dot, bf16 in (('float32', False), ('bfloat16', True)):
        op = make_fused_pair_interaction_dual(
            bb=1, interpret=True,
            dot_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        out_j, vjp = jax.vjp(op, *_j(ins))
        cot_j = vjp(tuple(_j(cots)))
        cot_j = [cot_j[k] for k in (0, 1, 7, 8, 9, 10, 11, 12, 13)]
        out_t = fdd.pair_interaction_dual_fwd_ref(*_t(ins), dot_dtype=dot)
        cot_t = fdd.pair_interaction_dual_bwd_ref(*_t(ins + cots),
                                                  dot_dtype=dot)
        for got, want, atol in ([(a, b, 2e-5) for a, b in zip(out_t, out_j)]
                                + [(a, b, 5e-5)
                                   for a, b in zip(cot_t, cot_j)]):
            if bf16:
                atol = 2e-3 * float(np.abs(np.asarray(want)).max())
            _close(got, want, atol)


@pytest.mark.parametrize('F', WIDTHS)
def test_plain_k5_k8_match_pallas_at_any_width(F):
    '''K5-K8's plain versions against the Pallas K-list ops and their VJPs
    (both variants, fp32 edges), B=2, N=8, K=5, R=4.'''
    rs = np.random.RandomState(F + 2)
    B, N, K, R = 2, 8, 5, 4
    mask = (rs.rand(B, N, K) < 0.7).astype(np.float32)
    ws = _weights(rs, F, R)
    for first in (False, True):
        C = F if first else 4 * F
        ins = _arrays(rs, [(B, N, F), (B, N, K, C), (B, N, K, R),
                           (B, 3, N, K)], [0.3, 0.3, 0.3, 1.0]) + [mask]
        tans = _arrays(rs, [(B, N, F), (B, N, K, C), (B, N, K, R),
                            (B, 3, N, K)], [0.1] * 4)
        cots = _arrays(rs, [(B, N, F), (B, 3, N, F)] * 2, [1, 1, .3, .3])
        op = make_fused_klist_interaction(nb=4, interpret=True,
                                          dot_dtype=jnp.float32,
                                          with_force=not first)
        out_j, vjp = jax.vjp(lambda *a: op(*a), *_j(ins + ws))
        cot_j = vjp(tuple(_j(cots[:2])))
        out_t = fk.klist_fwd_ref(*_t(ins + ws), first_layer=first)
        for a, b in zip(out_t, out_j):
            _close(a, b, 1e-5)
        cot_t = fk.klist_bwd_ref(*_t(ins + ws + cots[:2]),
                                 first_layer=first)
        for a, b in zip(cot_t, cot_j[:4] + cot_j[5:]):
            _close(a, b, 3e-5)
        args = [ins[0], tans[0], ins[1], tans[1], ins[2], tans[2], ins[3],
                tans[3], ins[4]]
        dop = make_fused_klist_interaction_dual(nb=4, interpret=True,
                                                dot_dtype=jnp.float32,
                                                with_force=not first)
        out_j, vjp = jax.vjp(lambda *a: dop(*a), *_j(args + ws))
        cot_j = vjp(tuple(_j(cots)))
        out_t = fk.klist_dual_fwd_ref(*_t(args + ws), first_layer=first)
        for a, b in zip(out_t, out_j):
            _close(a, b, 1e-5)
        cot_t = fk.klist_dual_bwd_ref(*_t(args + ws + cots),
                                      first_layer=first)
        for a, b in zip(cot_t, cot_j[:4] + cot_j[9:]):
            _close(a, b, 3e-5)


def test_kernel_widths_and_their_libraries():
    '''Every F from 1 to 128 runs at the next multiple of 32 and every F
    from 129 to 256 at the next multiple of 64 (the wide tiles), each from
    a library of its padded width alone, with the pad lanes masked
    (NN_PADDED) only below it; the sources of K9-K12 have one library; 0
    and widths past 256 are refused with ROADMAP.md B's section named,
    before anything is built or launched, as is a source of K1-K8 without
    a width.'''
    assert [_build.padded_width(F) for F in (
        1, 16, 20, 32, 33, 48, 64, 96, 128, 129, 160, 192, 200, 256)] == \
        [32, 32, 32, 32, 64, 64, 64, 96, 128, 192, 192, 192, 256, 256]
    assert _build._key('fused_klist', 64) == 'fused_klist-w64'
    assert _build._key('window') == 'window'
    assert _build._key('fused_klist', 48) == 'fused_klist-w64p'
    assert _build._key('fused_klist', 96) == 'fused_klist-w96'
    assert _build._key('fused_dual', 200) == 'fused_dual-w256p'
    assert _build.width_flags(128) == ('-DNN_WIDTH=128',)
    assert _build.flags('row_gather') == _build.NVCC_FLAGS
    assert _build.width_flags(48) == ('-DNN_WIDTH=64', '-DNN_PADDED')
    assert _build.width_flags(256) == ('-DNN_WIDTH=256',)
    assert _build._lib_target('fused_dense', 96) != \
        _build._lib_target('fused_dense', 64)
    for F in (0, 257, 288):
        with pytest.raises(ValueError,
                           match='Widths other than 32, 64 and 128'):
            _build.padded_width(F)
        with pytest.raises(ValueError, match='Widths other than'):
            _build.load('fused_dense', F)
    with pytest.raises(ValueError, match='give F'):
        _build.load('fused_klist')
    with pytest.raises(ValueError, match='not built per feature width'):
        _build.load('window', 32)


# ------------------------------------------------------ the LJ checkpoint --
def _jax_model(cs, graph_mode):
    from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
    from newtonnet_tpu.utils.checkpoint import load_model
    model, params = load_model(cs.LJ_CKPT)
    return JaxNewtonNet(param_dtype=model.param_dtype,
                        **{**model.config_dict(), **cs.LJ_PALLAS,
                           'graph_mode': graph_mode}), params


def _port_model(cs, graph_mode, **changes):
    from newtonnet_tpu_torch import NewtonNet, load_model
    base = load_model(cs.LJ_CKPT, device='cpu')
    model = NewtonNet(**dict(base.config_dict(), **cs.LJ_PALLAS,
                             graph_mode=graph_mode, **changes), device='cpu')
    model.load_state_dict(base.state_dict())
    return model


def jax_lj_pallas_request(cs, graph_mode):
    '''The JAX package's calculator on lj_box's box with the LJ checkpoint
    as a pallas model: (energy, forces (64, 3)).'''
    from newtonnet_tpu.md.calculator import NewtonNetCalculator
    z, pos, cell, _, _ = cs.lj_box()
    model, params = _jax_model(cs, graph_mode)
    r = NewtonNetCalculator(model=model, params=params).calculate(
        numbers=z[0], positions=pos[0], cell=cell[0])
    return r['energy'], np.asarray(r['forces'])


def _lj_batches(cs, root, graph_mode, n_steps, small):
    '''Batches of LJ_CONFIG's training split as parse_train_test yields them
    (lj_pallas_data_settings; with `small`, 3 frames of a 9-frame set).'''
    from newtonnet_tpu.data import parse_train_test
    cs.write_lj_dataset(root, n_frames=9 if small else cs.LJ_FRAMES)
    data = cs.lj_pallas_data_settings(root, graph_mode)
    if small:
        data.update(train_size=3, val_size=3, test_size=3,
                    train_batch_size=3, val_batch_size=3, test_batch_size=3)
    train_gen, _, _, stats = parse_train_test(seed=0, **data)
    return [b for _, b in zip(range(n_steps), train_gen)], stats, data


def jax_lj_pallas_steps(cs, graph_mode, n_steps=10, small=False):
    '''The JAX package's first fine-tuning steps of LJ_CONFIG with the LJ
    checkpoint as a pallas model (its Trainer's step: fastgrad, the batch's
    lists): (losses, global gradient norms before the clip).'''
    import optax
    import yaml

    from newtonnet_tpu.data.statistics import set_scalers
    from newtonnet_tpu.train import fastgrad
    from newtonnet_tpu.train.loss import get_loss_by_string
    from newtonnet_tpu.train.optimizer import get_optimizer_by_string
    with open(cs.LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as root:
        batches, stats, _ = _lj_batches(cs, root, graph_mode, n_steps, small)
    model, params = _jax_model(cs, graph_mode)
    params = set_scalers(params, model.output_properties, stats,
                         {'energy': dict(cfg['training']['fit_scalers'])})
    main_loss, _ = get_loss_by_string(cfg['training']['loss'])
    tx = get_optimizer_by_string(
        'adam', clip_grad=cfg['training']['clip_grad'],
        lr=cfg['training']['optimizer']['adam']['lr'])
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b):
        nl = (b['nlist_idx'], b['nlist_mask']) if 'nlist_idx' in b else None
        loss, grads, _ = fastgrad.value_and_grad(model, main_loss, p, b,
                                                 nlist=nl)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, \
            optax.global_norm(grads)

    losses, norms = [], []
    for batch in batches:
        params, opt, loss, norm = step(
            params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms


def port_lj_pallas_step1(cs, graph_mode):
    '''Step 1 of the same recipe through the port's Trainer on the CPU
    (small): (loss, global gradient norm before the clip).'''
    import yaml

    from newtonnet_tpu_torch import Trainer
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    with open(cs.LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as root:
        _, _, data = _lj_batches(cs, root, graph_mode, 0, True)
        train_gen, _, _, stats = parse_train_test(seed=0, **data)
        batch = next(iter(train_gen))
    model = _port_model(cs, graph_mode).requires_grad_(True)
    set_scalers(model.core, model.output_properties, stats,
                {'energy': dict(cfg['training']['fit_scalers'])})
    opt = get_optimizer_by_string(
        'adam', model.core, clip_grad=cfg['training']['clip_grad'],
        lr=cfg['training']['optimizer']['adam']['lr'])
    trainer = Trainer(model, loss_fns=get_loss_by_string(
        cfg['training']['loss']), optimizer=opt, fast_grad='auto')
    assert trainer.fast_grad
    loss, _ = trainer.loss_and_grad(
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(loss), float(opt.global_norm())


@pytest.mark.parametrize('graph_mode', LAYOUTS)
def test_lj_checkpoint_as_pallas_served_against_jax(graph_mode):
    '''The LJ checkpoint as a pallas model through the port's calculator
    (the plain K1/K2 or K5/K6 on the CPU) against the JAX package's, and
    the embedded JAX_LJ_PALLAS_* are this recipe's numbers.'''
    from newtonnet_tpu_torch import NewtonNetCalculator
    from newtonnet_tpu_torch.utils.params import params_to_flax
    cs = chip_smoke()
    z, pos, cell, _, _ = cs.lj_box()
    model = _port_model(cs, graph_mode)
    assert model.kernel == 'pallas' and model.n_features == 48
    calc = NewtonNetCalculator(model=model, params=params_to_flax(model.core),
                               device='cpu')
    r = calc.calculate(numbers=z[0], positions=pos[0], cell=cell[0])
    e, f = jax_lj_pallas_request(cs, graph_mode)
    assert r['energy'] == pytest.approx(e, rel=1e-5)
    assert np.abs(r['forces'] - f).max() <= 1e-4 * np.abs(f).max()
    assert cs.JAX_LJ_PALLAS_ENERGY[graph_mode] == pytest.approx(e, rel=1e-6)
    np.testing.assert_allclose(cs.JAX_LJ_PALLAS_FORCES_8[graph_mode], f[:8],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('graph_mode', LAYOUTS)
def test_lj_pallas_fine_tuning_step1_against_jax(graph_mode):
    '''Step 1 of LJ_CONFIG's fine-tuning with the checkpoint as a pallas
    model, 3 frames, through the port's Trainer (fastgrad over the plain
    K1-K4 or K5-K8) against the JAX package's step.'''
    cs = chip_smoke()
    loss, norm = port_lj_pallas_step1(cs, graph_mode)
    losses, norms = jax_lj_pallas_steps(cs, graph_mode, n_steps=1,
                                        small=True)
    assert loss == pytest.approx(losses[0], rel=1e-5)
    bar = 2e-3 if graph_mode == 'dense' else 1e-3
    assert norm == pytest.approx(norms[0], rel=bar)


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    if sys.argv[1:] == ['lj-pallas']:
        cs = chip_smoke()
        out = {}
        for gm in LAYOUTS:
            e, f = jax_lj_pallas_request(cs, gm)
            losses, norms = jax_lj_pallas_steps(cs, gm)
            out[gm] = (e, f[:8].tolist(), losses, norms)
        for name, k in (('ENERGY', 0), ('FORCES_8', 1), ('STEP_LOSS', 2),
                        ('STEP_GRAD_NORM', 3)):
            print(f'JAX_LJ_PALLAS_{name} = '
                  f'{ {gm: out[gm][k] for gm in LAYOUTS} !r}')
    else:
        sys.exit('usage: python tests/test_torch_widths.py lj-pallas')
