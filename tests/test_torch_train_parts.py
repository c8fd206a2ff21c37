'''The port's losses, optimizers and schedulers (newtonnet_tpu_torch/train/
loss.py, optimizer.py) against the JAX package's (train/loss.py and the
optax chains of train/optimizer.py), and the freeze flags
(utils/freeze.py) against its optax mask.

Tolerances: losses at rtol 1e-6 (float32 means of the same terms);
optimizer trajectories over 5 steps at rtol 1e-5 / atol 1e-7 (float32
updates, the clip norm summed over the parameters in another order);
scheduler learning rates exactly (the same Python arithmetic).
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.train import optimizer as jopt
from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
from newtonnet_tpu.train.trainer import set_learning_rate
from newtonnet_tpu.utils.freeze import build_freeze_mask
from newtonnet_tpu_torch.train import optimizer as topt
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.utils.freeze import apply_freeze, group_frozen

ALL_LOSSES = {
    'energy': {'mode': 'huber', 'weight': 2.0, 'delta': 0.3},
    'gradient_force': {'mode': 'mae', 'weight': 5.0},
    'direct_force': {'mode': 'mse'},
    'stress': {'mode': 'mse', 'weight': 0.5},
    'virial': {'mode': 'mae'},
}


def _loss_inputs(seed=0, B=4, N=6):
    rs = np.random.RandomState(seed)
    z = np.zeros((B, N), np.int32)
    for b in range(B - 1):  # the last graph is padding
        z[b, :rs.randint(2, N + 1)] = rs.randint(1, 9)
    f32 = np.float32
    preds = {'energy': rs.randn(B).astype(f32),
             'gradient_force': rs.randn(B, N, 3).astype(f32),
             'direct_force': rs.randn(B, N, 3).astype(f32),
             'stress': rs.randn(B, 3, 3).astype(f32),
             'virial': rs.randn(B, 3, 3).astype(f32)}
    batch = {'z': z, 'graph_mask': np.arange(B) < B - 1,
             'energy': rs.randn(B).astype(f32),
             'force': rs.randn(B, N, 3).astype(f32),
             'stress': rs.randn(B, 3, 3).astype(f32),
             'virial': rs.randn(B, 3, 3).astype(f32)}
    return preds, batch


def test_losses_match_jax():
    preds, batch = _loss_inputs()
    main_j, eval_j = jax_loss(ALL_LOSSES)
    main_t, eval_t = get_loss_by_string(ALL_LOSSES)
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    to_t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa
    np.testing.assert_allclose(float(main_t(to_t(preds), to_t(batch))),
                               float(main_j(to_j(preds), to_j(batch))),
                               rtol=1e-6)
    ej, et = eval_j(to_j(preds), to_j(batch)), eval_t(to_t(preds),
                                                      to_t(batch))
    assert sorted(ej) == sorted(et)
    for k in ej:
        np.testing.assert_allclose(float(et[k]), float(ej[k]), rtol=1e-6,
                                   err_msg=k)
    assert main_t.keys == main_j.keys and main_t.config == main_j.config
    with pytest.raises(NotImplementedError):
        get_loss_by_string({'charge': {}})


def _trajectory_inputs(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {'node_embedding': (5, 3), 'interaction_0.k': (3, 3),
              'energy_head.b': (4,), 'scaler_energy.scale': (5, 1)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rs.randn(*s) * scale).astype(np.float32)
              for n, s in shapes.items()}
             for scale in (0.01, 3.0, 0.05, 10.0, 0.2)]
    return params, grads


def _nest(flat):
    out = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split('.')
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = v
    return {'params': out}


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree['params'])[0]
    return {'.'.join(k.key for k in path): np.asarray(v)
            for path, v in leaves}


class _Params(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for name, v in params.items():
            self.register_parameter(name.replace('.', '__'),
                                    torch.nn.Parameter(torch.tensor(v)))

    def named_parameters(self, *a, **k):
        for n, p in super().named_parameters(*a, **k):
            yield n.replace('__', '.'), p


@pytest.mark.parametrize('name, kw, clip, frozen', [
    ('adam', {'lr': 1e-2}, 1.0, ()),
    ('adam', {'lr': 3e-3, 'b1': 0.8}, 0.0, ('node_embedding',)),
    ('sgd', {'lr': 0.1}, 2.0, ()),
    ('sgd', {'lr': 0.05, 'momentum': 0.9, 'nesterov': True}, 0.0, ()),
    ('rmsprop', {'lr': 1e-2}, 1.0, ()),
    ('adamw', {'lr': 1e-2}, 0.5, ()),
])
def test_optimizer_trajectory_matches_optax(name, kw, clip, frozen):
    '''Five steps of the same gradients, with the lr changed before the
    fourth, against the JAX package's optax chain; the clip triggers on
    the steps with large gradients; frozen groups stay put.'''
    params, grads = _trajectory_inputs()
    tree = _nest(params)
    freeze = (build_freeze_mask(tree, freeze_encoder=True) if frozen
              else None)
    tx = jopt.get_optimizer_by_string(name, clip_grad=clip, freeze=freeze,
                                      **dict(kw))
    state = tx.init(tree)
    module = _Params(params)
    if frozen:
        apply_freeze(module, freeze_encoder=True)
    opt = topt.get_optimizer_by_string(name, module, clip_grad=clip,
                                       **dict(kw))
    for k, g in enumerate(grads):
        if k == 3:
            state = set_learning_rate(state, kw['lr'] * 0.5)
            opt.lr = kw['lr'] * 0.5
        upd, state = tx.update(_nest(g), state, tree)
        tree = jax.tree.map(lambda p, u: p + u, tree, upd)
        for n, p in module.named_parameters():
            p.grad = torch.tensor(g[n]) if p.requires_grad else None
        opt.step()
        want = _flat(tree)
        for n, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f'{n} step {k}')
    for n in frozen:
        np.testing.assert_array_equal(dict(module.named_parameters())[n]
                                      .detach().numpy(), params[n])


def test_clip_is_optax_global_norm_clip():
    '''g * max_norm / ||g|| above the threshold, g unchanged below it; not
    torch's clip_grad_norm_, which divides by ||g|| + 1e-6.'''
    module = _Params({'w': np.array([3.0, 4.0], np.float32)})
    opt = topt.get_optimizer_by_string('sgd', module, clip_grad=1.0, lr=1.0)
    module.w.grad = torch.tensor([3.0, 4.0])
    assert float(opt.global_norm()) == 5.0
    opt.step()
    np.testing.assert_array_equal(module.w.detach().numpy(),
                                  np.float32([3.0 - 0.6, 4.0 - 0.8]))
    with pytest.raises(TypeError):
        topt.get_optimizer_by_string('adam', module, weight_decay=0.1)
    with pytest.raises(ValueError):
        topt.get_optimizer_by_string('lamb', module)


def test_optimizer_state_round_trips():
    params, grads = _trajectory_inputs(seed=1)
    a, b = _Params(params), _Params(params)
    opt_a = topt.get_optimizer_by_string('adam', a, lr=1e-2)
    for g in grads[:2]:
        for n, p in a.named_parameters():
            p.grad = torch.tensor(g[n])
        opt_a.step()
    b.load_state_dict(a.state_dict())
    opt_b = topt.get_optimizer_by_string('adam', b, lr=1e-2)
    opt_b.load_state_dict(opt_a.state_dict())
    for m, opt in ((a, opt_a), (b, opt_b)):
        for n, p in m.named_parameters():
            p.grad = torch.tensor(grads[2][n])
        opt.step()
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n


SCHEDULES = [
    ([('plateau', {'patience': 1, 'factor': 0.5, 'min_lr': 1e-4})],
     [1.0, 0.9, 0.95, 0.97, 0.5, 0.6, 0.7, 0.8]),
    ([('lambda', {'lr_lambda': 'lambda e: 0.9 ** e'})], None),
    ([('linear', {'start_factor': 0.25, 'total_iters': 4})], None),
    ([('cosine', {'T_max': 6, 'eta_min': 1e-5})], None),
    ([('onecycle', {'max_lr': 1e-2, 'total_steps': 8})], None),
    ([('linear', {'total_iters': 3}),
      ('plateau', {'patience': 0, 'factor': 0.5})],
     [1.0, 1.1, 1.2, 0.5, 0.6, 0.7, 0.8, 0.9]),
]


@pytest.mark.parametrize('config, metrics', SCHEDULES)
def test_schedulers_match_jax(config, metrics):
    sj = jopt.get_scheduler_by_string(config, 1e-3)
    st = topt.get_scheduler_by_string(config, 1e-3)
    assert (st.per_step, st.needs_metric) == (sj.per_step, sj.needs_metric)
    lrs_j, lrs_t = [sj.lr], [st.lr]
    for k in range(8):
        m = metrics[k] if metrics else None
        lrs_j.append(sj.step(m))
        lrs_t.append(st.step(m))
        assert st.should_stop == sj.should_stop
    assert lrs_t == lrs_j
    assert st.state_dict().keys() == sj.state_dict().keys()


def test_freeze_groups_match_jax_mask():
    tree = {'params': {'node_embedding': 0, 'interaction_0': {'a': 0},
                       'energy_head': {'b': 0}, 'scaler_energy': {'c': 0}}}
    for flag in ('freeze_encoder', 'freeze_interaction', 'freeze_decoder',
                 'freeze_scaler'):
        mask = build_freeze_mask(tree, **{flag: True})['params']
        for name, sub in mask.items():
            assert group_frozen(name, **{flag: True}) == \
                bool(jax.tree.leaves(sub)[0]), (flag, name)
