'''The port's training gradient (newtonnet_tpu_torch/train/fastgrad.py over
models/fused_stack.py:dual_energy_from_geom and ops/fused_dual.py) against
the JAX package's fastgrad.value_and_grad, kernel='pallas', with the same
weights and batch, at a small size (F=32, R=8, 2 interactions, B=4, N=6).

Tolerances. fp32 duals: loss at rtol 2e-5 and gradients at atol 2e-4, the
bars of tests/test_pallas_stack.py:test_fastgrad_pallas_matches_xla (fp32
sums over pairs, layers and the batch in another order). bf16 duals: both
packages round the same product operands to bf16; the gradients are held
at 2e-3 in relative norm, ten times tighter than the JAX package's own
bf16-vs-fp32 bar (2e-2), and they do differ from the fp32 ones by more.
Against double backward the port is held in float64, where the two
algorithms agree to rounding: rtol 1e-9. One test runs the MD17 checkpoint
at full width for the first fine-tuning step's loss (its own bars there).
The neighbour-list branch (graph_mode='neighborlist', K5-K8) is held to
the JAX package's at atol 2e-4 and to double backward in float64.
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train import fastgrad as jax_fastgrad
from newtonnet_tpu.train import get_loss_by_string as jax_loss
from newtonnet_tpu_torch import NewtonNet
from newtonnet_tpu_torch.models.fused_stack import core_from_geom, geometry
from newtonnet_tpu_torch.ops.fused_dense import pair_interaction_fwd_ref
from newtonnet_tpu_torch.train import fastgrad
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.utils.params import params_from_flax

LOSSES = {'energy': {'weight': 1.0}, 'gradient_force': {'weight': 20.0}}


def _setup(grad_dot='float32', seed=8, B=4, N=6):
    cfg = dict(cutoff=5.0, n_features=32, n_basis=8, n_interactions=2,
               output_properties=['energy', 'gradient_force'],
               kernel='pallas', pallas_grad_dot_dtype=grad_dot)
    jm = JaxNewtonNet(**cfg)
    rs = np.random.RandomState(seed)
    z = np.zeros((B, N), np.int32)
    for b in range(B):
        n = rs.randint(3, N + 1)
        z[b, :n] = rs.choice([1, 6, 7, 8], size=n)
    batch = {'z': z, 'pos': (rs.randn(B, N, 3) * 1.6).astype(np.float32),
             'cell': np.zeros((B, 3, 3), np.float32),
             'graph_mask': np.ones(B, bool),
             'energy': rs.randn(B).astype(np.float32),
             'force': rs.randn(B, N, 3).astype(np.float32)}
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(z),
                     jnp.asarray(batch['pos']), jnp.asarray(batch['cell']))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jm, params, batch, cfg


def _port(cfg, params, dtype=torch.float32):
    tm = NewtonNet(**cfg, device='cpu', dtype=dtype)
    params_from_flax(params, core=tm.core)
    return tm


def _jax_grads(jm, params, batch):
    main_loss, _ = jax_loss(LOSSES)
    loss, grads, _ = jax_fastgrad.value_and_grad(
        jm, main_loss, params, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = jax.tree_util.tree_flatten_with_path(grads['params'])[0]
    return float(loss), {'.'.join(k.key for k in path): np.asarray(g)
                         for path, g in flat}


def _port_grads(tm, batch, dtype=torch.float32):
    main_loss, _ = get_loss_by_string(LOSSES)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ('pos', 'cell', 'energy', 'force'):
        b[k] = b[k].to(dtype)
    loss, preds = fastgrad.value_and_grad(tm, main_loss, b)
    return loss, preds, {n: p.grad.clone() if p.grad is not None
                         else torch.zeros_like(p)
                         for n, p in tm.core.named_parameters()}


@pytest.fixture(scope='module')
def jax_fp32():
    '''The JAX package's fp32-dual loss and gradients on _setup()'s batch
    (interpret-mode Pallas: traced once for the module).'''
    jm, params, batch, _ = _setup()
    return _jax_grads(jm, params, batch)


def test_fastgrad_matches_jax_fp32_duals(jax_fp32):
    _, params, batch, cfg = _setup()
    l_j, g_j = jax_fp32
    loss, preds, g_t = _port_grads(_port(cfg, params), batch)
    np.testing.assert_allclose(float(loss), l_j, rtol=2e-5)
    assert set(g_t) == set(g_j)
    for name, g in g_t.items():
        np.testing.assert_allclose(g.numpy(), g_j[name], atol=2e-4,
                                   err_msg=name)
    assert set(preds) == {'energy', 'gradient_force'}


def test_fastgrad_matches_jax_bf16_duals(jax_fp32):
    jm, params, batch, cfg = _setup(grad_dot='bfloat16')
    l_j, g_j = _jax_grads(jm, params, batch)
    loss, _, g_t = _port_grads(_port(cfg, params), batch)
    # the loss comes from the fp32 force path: the dual dtype leaves it be
    np.testing.assert_allclose(float(loss), l_j, rtol=2e-5)
    names = sorted(g_j)
    gt = np.concatenate([g_t[n].numpy().ravel() for n in names])
    gj = np.concatenate([g_j[n].ravel() for n in names])
    assert np.linalg.norm(gt - gj) <= 2e-3 * np.linalg.norm(gj)
    g_32 = jax_fp32[1]
    g32 = np.concatenate([g_32[n].ravel() for n in names])
    assert np.linalg.norm(gj - g32) > 2e-3 * np.linalg.norm(gj)


def test_fastgrad_equals_double_backward_in_float64():
    '''The first-order surrogate gives the gradient that autograd of the
    force loss (a gradient of a gradient, through the plain pair layer)
    gives, in float64.'''
    _, params, batch, cfg = _setup(seed=3)
    tm = _port(cfg, params, dtype=torch.float64)
    loss, _, g_fast = _port_grads(tm, batch, dtype=torch.float64)

    main_loss, _ = get_loss_by_string(LOSSES)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ('pos', 'cell', 'energy', 'force'):
        b[k] = b[k].double()
    pos = b['pos'].clone().requires_grad_(True)
    adj, dir_t, rbf = geometry(b['z'], pos, b['cell'], tm.cutoff, tm.n_basis)
    out = core_from_geom(tm.core, b['z'], adj, dir_t, rbf,
                         pair_op=pair_interaction_fwd_ref)
    energy = out['atomic_energy'][..., 0].sum(-1)
    (dpos,) = torch.autograd.grad(energy.sum(), pos, create_graph=True)
    ref_loss = main_loss({'energy': energy, 'gradient_force': -dpos}, b)
    names = [n for n, _ in tm.core.named_parameters()]
    ref = torch.autograd.grad(ref_loss, list(tm.core.parameters()),
                              allow_unused=True)
    assert float(loss) == pytest.approx(ref_loss.item(), rel=1e-12)
    for name, r, p in zip(names, ref, tm.core.parameters()):
        # the first layer's phi2 branch is dead (zero force input)
        r = torch.zeros_like(p) if r is None else r
        torch.testing.assert_close(g_fast[name], r, rtol=1e-9, atol=1e-12,
                                   msg=name)


def test_md17_step1_loss_agrees_to_float32_rounding():
    '''The first fine-tuning step of scripts/config_md17_pallas.yml (the
    trained checkpoint, refitted scalers, the first batch of 10 frames), at
    full width, in both packages on the CPU.

    In float64 the port's loss equals the JAX package's (kernel='xla', the
    same function without Pallas) to rtol 1e-10. In float32 the energies
    (near -17,600 eV, where one ulp is 0.002 eV) land a few ulp apart
    between any two programs that sum them in another order, the JAX
    package's own forward and fastgrad programs included, and one ulp of
    one frame's energy moves the loss by about 1.4e-4 of itself. So the
    float32 losses are held to one ulp of every frame's energy,
    (2/B) sum_b |E_b - E_ref_b| ulp(E_b), as chip_smoke.py holds the card's
    step 1, and each frame's energy to 2 ulp. Run with -s for the numbers.'''
    import os

    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.utils.params import params_to_flax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(root, 'data', 'md17_aspirin')
    losses = {'energy': {'weight': 1.0, 'mode': 'mse'},
              'gradient_force': {'weight': 50.0, 'mode': 'mse'}}
    train_gen, _, _, stats = parse_train_test(
        train_root=os.path.join(data, 'ccsd_train'),
        test_root=os.path.join(data, 'ccsd_test'), train_size=950,
        train_batch_size=10, val_batch_size=50, test_batch_size=500, seed=0)
    batch = next(iter(train_gen))

    def port_model(dtype):
        tm = load_model(os.path.join(root, 'artifacts', 'md17_model_pallas',
                                     'best_model.msgpack'), device='cpu')
        set_scalers(tm.core, tm.output_properties, stats,
                    {'energy': {'fit_scale': True, 'fit_shift': True}})
        return tm.to(dtype)

    def cast(dtype, conv):
        return {k: conv(v.astype(dtype) if v.dtype.kind == 'f' else v)
                for k, v in batch.items()}

    main_loss, _ = get_loss_by_string(losses)
    jax_main_loss, _ = jax_loss(losses)
    tm = port_model(torch.float32)
    flax_params = params_to_flax(tm.core)
    cfg = tm.config_dict()

    # float64: the same function in both packages
    b64 = cast(np.float64, torch.as_tensor)
    preds = port_model(torch.float64)(b64['z'], b64['pos'], b64['cell'],
                                      pair_op=pair_interaction_fwd_ref)
    loss64, e64 = float(main_loss(preds, b64)), preds['energy'].numpy()
    jm = JaxNewtonNet(**dict(cfg, kernel='xla'))
    jb = cast(np.float64, jnp.asarray)
    out = jax.jit(lambda p, b: jm.apply(p, b['z'], b['pos'], b['cell']))(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), flax_params), jb)
    assert float(jax_main_loss(out, jb)) == pytest.approx(loss64, rel=1e-10)

    # float32: the port's training step against the JAX package's training
    # step (jitted, as the Trainer runs it) and its forward
    loss_t, preds_t = fastgrad.value_and_grad(
        tm, main_loss, cast(np.float32, torch.as_tensor))
    jm = JaxNewtonNet(**cfg)
    p32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), flax_params)
    jb = cast(np.float32, jnp.asarray)
    loss_j, _, preds_j = jax.jit(lambda p, b: jax_fastgrad.value_and_grad(
        jm, jax_main_loss, p, b))(p32, jb)
    out = jax.jit(lambda p, b: jm.apply(p, b['z'], b['pos'], b['cell']))(
        p32, jb)
    loss_f = float(jax_main_loss(out, jb))
    e_t = preds_t['energy'].numpy()
    ulp = np.spacing(np.abs(e_t))
    bar = 2.0 / len(e64) * float(
        (np.abs(e64 - batch['energy']) * ulp).sum()) / loss64
    rel = {'port_step': float(loss_t) / loss64 - 1.0,
           'jax_step': float(loss_j) / loss64 - 1.0,
           'jax_forward': loss_f / loss64 - 1.0}
    print(f'\nstep 1 loss: float64 {loss64!r}, port step {float(loss_t)!r}, '
          f'JAX step {float(loss_j)!r}, JAX forward {loss_f!r}; relative to '
          f'float64 {rel}; port step vs JAX step '
          f'{float(loss_t) / float(loss_j) - 1.0!r}; bar {bar!r}')
    for e in (np.asarray(preds_j['energy']), np.asarray(out['energy'])):
        assert np.all(np.abs(e_t.astype(np.float64) - e) <= 2 * ulp)
    assert max(abs(v) for v in rel.values()) <= bar
    assert abs(float(loss_t) - float(loss_j)) <= bar * loss64


def test_frozen_parameters_get_no_gradient():
    _, params, batch, cfg = _setup(seed=4)
    tm = _port(cfg, params)
    tm.core.node_embedding.requires_grad_(False)
    main_loss, _ = get_loss_by_string(LOSSES)
    fastgrad.value_and_grad(tm, main_loss,
                            {k: torch.as_tensor(v) for k, v in batch.items()})
    assert tm.core.node_embedding.grad is None
    assert tm.core.energy_head.TorchLinear_0.kernel.grad is not None
    assert not tm.core.node_embedding.requires_grad


def _klist_setup(seed=8, B=2, N=12, K=16):
    """The neighbour-list model of tests/test_pallas_klist.py's fastgrad
    test (F=32, R=8, 2 interactions, k_max 16) with a batch from a seed."""
    cfg = dict(cutoff=5.0, n_features=32, n_basis=8, n_interactions=2,
               graph_mode='neighborlist', k_max=K, kernel='pallas',
               output_properties=['energy', 'gradient_force'])
    jm = JaxNewtonNet(**cfg)
    rs = np.random.RandomState(seed)
    z = np.zeros((B, N), np.int32)
    for b in range(B):
        n = rs.randint(6, N + 1)
        z[b, :n] = rs.choice([1, 6, 7, 8], size=n)
    batch = {'z': z, 'pos': (rs.randn(B, N, 3) * 1.8).astype(np.float32),
             'cell': np.zeros((B, 3, 3), np.float32),
             'graph_mask': np.ones(B, bool),
             'energy': rs.randn(B).astype(np.float32),
             'force': rs.randn(B, N, 3).astype(np.float32)}
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(z),
                     jnp.asarray(batch['pos']), jnp.asarray(batch['cell']))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jm, params, batch, cfg


def test_klist_fastgrad_matches_jax():
    """The neighbour-list branch (K5/K6 force pass, K7/K8 dual; their plain
    versions here) against the JAX package's fastgrad with interpret-mode
    Pallas: loss at rtol 2e-5, gradients at atol 2e-4, the bars of
    tests/test_pallas_klist.py:test_klist_fastgrad_matches_xla_training_
    gradient."""
    jm, params, batch, cfg = _klist_setup()
    l_j, g_j = _jax_grads(jm, params, batch)
    loss, preds, g_t = _port_grads(_port(cfg, params), batch)
    np.testing.assert_allclose(float(loss), l_j, rtol=2e-5)
    assert set(g_t) == set(g_j)
    for name, g in g_t.items():
        np.testing.assert_allclose(g.numpy(), g_j[name], atol=2e-4,
                                   err_msg=name)
    assert preds['gradient_force'].shape == batch['force'].shape


def test_klist_fastgrad_equals_double_backward_in_float64():
    """In float64 the K-list surrogate gradient equals autograd of the force
    loss taken through the plain K-list layer's forward (a gradient of a
    gradient), to rounding: rtol 1e-9."""
    from newtonnet_tpu_torch.models.fused_klist import apply_core_nlist
    from newtonnet_tpu_torch.ops.fused_klist import klist_fwd_ref
    _, params, batch, cfg = _klist_setup(seed=3)
    tm = _port(cfg, params, dtype=torch.float64)
    loss, _, g_fast = _port_grads(tm, batch, dtype=torch.float64)
    main_loss, _ = get_loss_by_string(LOSSES)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ('pos', 'cell', 'energy', 'force'):
        b[k] = b[k].double()
    pos = b['pos'].clone().requires_grad_(True)
    out = apply_core_nlist(tm, b['z'], pos, b['cell'], pair_op=klist_fwd_ref)
    energy = out['atomic_energy'][..., 0].sum(-1)
    (dpos,) = torch.autograd.grad(energy.sum(), pos, create_graph=True)
    ref_loss = main_loss({'energy': energy, 'gradient_force': -dpos}, b)
    names = [n for n, _ in tm.core.named_parameters()]
    ref = torch.autograd.grad(ref_loss, list(tm.core.parameters()),
                              allow_unused=True)
    assert float(loss) == pytest.approx(ref_loss.item(), rel=1e-12)
    for name, r, p in zip(names, ref, tm.core.parameters()):
        r = torch.zeros_like(p) if r is None else r
        torch.testing.assert_close(g_fast[name], r, rtol=1e-9, atol=1e-12,
                                   msg=name)


def _standard_grads(tm, batch, dtype, nlist=None):
    """The standard step's loss and gradients (train/trainer.py:
    standard_value_and_grad, reverse over reverse)."""
    from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
    main_loss, _ = get_loss_by_string(LOSSES)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ('pos', 'cell', 'energy', 'force'):
        b[k] = b[k].to(dtype)
    tm.requires_grad_(True)
    loss, _ = standard_value_and_grad(tm, main_loss, b, nlist=nlist)
    return loss, {n: p.grad.clone() if p.grad is not None
                  else torch.zeros_like(p)
                  for n, p in tm.core.named_parameters()}


def test_fastgrad_refuses_what_is_not_ported():
    """(The name is kept from when XLA models were refused.) On the XLA
    model of the same weights, fastgrad.value_and_grad (reverse over
    forward) gives the standard step's loss and gradients in float32, to
    1e-5 of each gradient's largest magnitude."""
    _, params, batch, cfg = _setup(seed=5)
    tm = _port(dict(cfg, kernel='xla'), params)
    loss, preds, g_fast = _port_grads(tm, batch)
    loss_s, g_std = _standard_grads(tm, batch, torch.float32)
    assert float(loss) == pytest.approx(float(loss_s), rel=1e-6)
    assert preds['gradient_force'].shape == batch['force'].shape
    for name, g in g_std.items():
        torch.testing.assert_close(g_fast[name], g, rtol=0,
                                   atol=1e-5 * float(g.abs().max()) + 1e-12,
                                   msg=name)


def _xla_box(layout, seed=3, B=2, N=12, L=6.0):
    """A float64 XLA model (F=16, 2 interactions) in `layout` and a
    periodic batch of two boxes (the second padded by 2 atoms), with the
    host-built inverse lists for 'inverse'."""
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    kw = {} if layout == 'dense' else dict(
        graph_mode='neighborlist', k_max=16,
        inverse_lists=layout == 'inverse')
    tm = NewtonNet(n_features=16, n_basis=6, n_interactions=2,
                   output_properties=['energy', 'gradient_force'],
                   device='cpu', dtype=torch.float64,
                   generator=torch.Generator().manual_seed(seed), **kw)
    rs = np.random.RandomState(seed)
    z = rs.choice([1, 6, 8], size=(B, N)).astype(np.int32)
    z[1, -2:] = 0
    batch = {'z': z, 'pos': rs.rand(B, N, 3) * L,
             'cell': np.broadcast_to(np.eye(3) * L, (B, 3, 3)).copy(),
             'graph_mask': np.ones(B, bool), 'energy': rs.randn(B),
             'force': rs.randn(B, N, 3)}
    nl = None
    if layout == 'inverse':
        nl = host_symmetric_nlist(tm, batch['z'], batch['pos'],
                                  batch['cell'], skin=0.0)
    return tm, batch, nl


@pytest.mark.parametrize('layout', ['dense', 'plain', 'inverse'])
def test_xla_fastgrad_equals_the_standard_step_in_float64(layout):
    """kernel='xla': fastgrad's reverse over forward against the standard
    step's reverse over reverse, dense, over plain lists and over inverse
    lists, in float64 at rtol 1e-9 (the two algorithms agree to
    rounding)."""
    tm, batch, nl = _xla_box(layout)
    main_loss, _ = get_loss_by_string(LOSSES)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    tm.requires_grad_(True)
    loss, _ = fastgrad.value_and_grad(tm, main_loss, b, nlist=nl)
    g_fast = {n: p.grad.clone() if p.grad is not None
              else torch.zeros_like(p) for n, p in tm.core.named_parameters()}
    loss_s, g_std = _standard_grads(tm, batch, torch.float64, nlist=nl)
    assert float(loss) == pytest.approx(float(loss_s), rel=1e-12)
    for name, g in g_std.items():
        torch.testing.assert_close(g_fast[name], g, rtol=1e-9, atol=1e-12,
                                   msg=name)
