'''The port's kernel='xla' NewtonNet (models/output.py over
models/xla_stack.py) against the JAX package's NewtonNet.apply on the CPU,
at F=16, R=8, 2 interactions and N <= 16: the same weights (the JAX
package's init, loaded into the port) and the same seeded inputs.

Layouts: dense; a plain full list built in the model (gather_nodes); and
inverse lists, the 4-tuple of symmetric-slotted lists that the port's
md/driver.host_symmetric_nlist builds, handed to both packages
(inv_gather / inv_scatter_sum, the plain row gather on the CPU).

Bars: float32, atol 2e-4 for energy, forces, virial and stress (float32
sums over neighbours, features and layers in another order; the K-list
model's bar, tests/test_torch_klist_model.py). compute_dtype='bfloat16'
runs the interaction stack in bf16 in both packages; against the JAX
program as jax.jit compiles it by default (which keeps float32 between
some of its bf16 operations) a one-ulp difference (2^-8 relative) of an
intermediate moves an output by a few 1e-3 of its largest magnitude: the
bf16 bar is 2e-2 of each output's largest magnitude. The bf16 stack's
own rules: every activation and its vjp equal the JAX functions compiled
without excess precision bit for bit, and a dtype audit finds every
tensor inside the layers bf16 (tests/test_torch_xla_reference.py holds the
whole stack to that JAX program in units of its bf16 shift).
'''
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.layers import activations as jact
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator, load_model
from newtonnet_tpu_torch.layers import activations as tact
from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
from newtonnet_tpu_torch.ops import row_gather as rg
from newtonnet_tpu_torch.utils.checkpoint import save_model
from newtonnet_tpu_torch.utils.params import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ['energy', 'gradient_force', 'virial', 'stress']


def _models(seed, B=2, N=16, periodic=True, **changes):
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=2,
               output_properties=OUTPUTS, k_max=24, **changes)
    jm = JaxNewtonNet(**cfg)
    rs = np.random.RandomState(seed)
    z = np.zeros((B, N), np.int32)
    for b in range(B):
        n = rs.randint(N - 4, N + 1)
        z[b, :n] = rs.choice([1, 6, 7, 8], size=n)
    L = 8.0
    if periodic:
        pos = (rs.rand(B, N, 3) * L).astype(np.float32)
        cell = np.broadcast_to(np.eye(3, dtype=np.float32) * L,
                               (B, 3, 3)).copy()
    else:
        pos = (rs.randn(B, N, 3) * 1.8).astype(np.float32)
        cell = np.zeros((B, 3, 3), np.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(z),
                     jnp.asarray(pos), jnp.asarray(cell))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tm = NewtonNet(**cfg, device='cpu')
    params_from_flax(params, core=tm.core)
    return jm, params, tm, z, pos, cell


def _compare(jm, params, tm, z, pos, cell, nlist=None, rel=None):
    '''Both packages on the same inputs (and lists); atol 2e-4, or rel
    times each output's largest magnitude.'''
    jnl = None if nlist is None else tuple(jnp.asarray(a.numpy())
                                           for a in nlist)
    out_j = jax.jit(lambda p, a, b, c, nl: jm.apply(p, a, b, c, nlist=nl))(
        params, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(cell), jnl)
    out_t = tm(*[torch.from_numpy(a) for a in (z, pos, cell)], nlist=nlist)
    for key in OUTPUTS + ['atom_node']:
        a, b = out_t[key].float().numpy(), np.asarray(out_j[key], np.float32)
        ok = np.isfinite(b)
        assert (np.isfinite(a) == ok).all(), key
        bar = 2e-4 if rel is None else rel * np.abs(b[ok]).max()
        np.testing.assert_allclose(a[ok], b[ok], atol=bar, err_msg=key)
    return out_t


@pytest.mark.parametrize('layout, periodic, changes', [
    ('dense', True, {}),
    ('dense', False, dict(activation='gelu', layer_norm=True,
                          trainable_basis=True)),
    ('plain', True, dict(activation='swiglu', layer_norm=True)),
    ('inverse', True, {}),
    ('inverse', False, dict(activation='elu', layer_norm=True,
                            trainable_basis=True)),
])
def test_model_matches_jax(layout, periodic, changes):
    '''Energy, forces, virial and stress (aperiodic stress divides by a
    zero volume in both packages, ROADMAP.md C: only its finite entries
    are compared), over every layout, with activations, layer norms and
    trained Bessel frequencies.'''
    graph = dict(graph_mode='dense') if layout == 'dense' else dict(
        graph_mode='neighborlist', inverse_lists=layout == 'inverse')
    jm, params, tm, z, pos, cell = _models(
        seed=len(layout) + len(changes), periodic=periodic,
        **graph, **changes)
    nlist = (host_symmetric_nlist(tm, z, pos, cell, skin=0.0)
             if layout == 'inverse' else None)
    _compare(jm, params, tm, z, pos, cell, nlist)


@pytest.mark.parametrize('layout', ['dense', 'inverse'])
def test_bf16_stack_matches_jax(layout):
    '''compute_dtype='bfloat16' (with a layer norm, whose float32 output
    carries on as flax's does), at the bf16 bar.'''
    graph = dict(graph_mode='dense') if layout == 'dense' else dict(
        graph_mode='neighborlist', inverse_lists=True)
    jm, params, tm, z, pos, cell = _models(
        seed=3, compute_dtype='bfloat16', layer_norm=layout == 'dense',
        **graph)
    nlist = (host_symmetric_nlist(tm, z, pos, cell, skin=0.0)
             if layout == 'inverse' else None)
    _compare(jm, params, tm, z, pos, cell, nlist, rel=2e-2)


@pytest.mark.parametrize('name', sorted(jact._ACTIVATIONS))
def test_activations_match_jax(name):
    '''Every activation string, on values from -30 to 30 (float32, 1e-6
    relative); gelu is the tanh approximation, softplus has no linear
    threshold, swiglu halves the width.'''
    x = np.linspace(-30, 30, 2 * 600, dtype=np.float32).reshape(2, 600)
    want = np.asarray(jact.get_activation_by_string(name)(jnp.asarray(x)))
    got = tact.get_activation_by_string(name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_inverse_lists_equal_the_plain_list_and_the_plain_gather():
    '''The inverse-list model computes the plain-list model's function
    (float64, 1e-10), and plain=True (the plain row gather) gives the
    default path's bits; on the CPU no kernel launch is counted.'''
    _, params, tm, z, pos, cell = _models(seed=9, graph_mode='neighborlist',
                                          inverse_lists=True)
    plain_list = NewtonNet(**dict(tm.config_dict(), inverse_lists=False),
                           device='cpu')
    params_from_flax(params, core=plain_list.core)
    tm, plain_list = tm.double(), plain_list.double()
    args = [torch.from_numpy(z), torch.from_numpy(pos).double(),
            torch.from_numpy(cell).double()]
    nlist = host_symmetric_nlist(tm, *args, skin=0.0)
    rg.reset_launch_counts()
    a = tm(*args, nlist=nlist)
    b = plain_list(*args)
    c = tm(*args, nlist=nlist, plain=True)
    for key in OUTPUTS:
        torch.testing.assert_close(a[key], b[key], rtol=1e-10, atol=1e-10,
                                   msg=key)
        assert torch.equal(a[key], c[key]), key
    assert not any(rg.LAUNCHES.values())
    with pytest.raises(ValueError, match='pair_op applies'):
        tm(*args, nlist=nlist, pair_op=lambda *a, **k: None)


def test_xla_checkpoints_load_as_xla_and_round_trip(tmp_path):
    '''The trained kernel='xla' checkpoint (its config has no kernel key)
    loads as an XLA model, as in the JAX package; an XLA config with layer
    norms and a trained basis crosses both ways through the checkpoint
    format with its parameters unchanged.'''
    from newtonnet_tpu.utils import checkpoint as jckpt
    base = load_model(os.path.join(ROOT, 'artifacts', 'md17_model',
                                   'best_model.msgpack'), device='cpu')
    assert base.kernel == 'xla' and NewtonNet(device='cpu').kernel == 'xla'
    jm, params, tm, *_ = _models(seed=4, layer_norm=True,
                                 trainable_basis=True, activation='tanh')
    path = str(tmp_path / 'port.msgpack')
    save_model(path, tm)
    jm2, p2 = jckpt.load_model(path)
    assert jm2.config_dict() == jm.config_dict()
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_model(str(tmp_path / 'jax.msgpack'), jm, params)
    back = load_model(str(tmp_path / 'jax.msgpack'), device='cpu')
    assert back.config_dict() == tm.config_dict()
    for (n, a), (_, b) in zip(back.core.named_parameters(),
                              tm.core.named_parameters()):
        assert torch.equal(a, b), n


def test_calculator_with_inverse_lists_matches_jax(tmp_path):
    '''One periodic request through the port's calculator (host-built
    symmetric lists in every call) against the JAX package's calculator on
    the same checkpoint (its lists from its own builder).'''
    from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
    _, _, tm, z, pos, cell = _models(seed=6, graph_mode='neighborlist',
                                     inverse_lists=True)
    path = str(tmp_path / 'inv.msgpack')
    save_model(path, tm)
    props = ['energy', 'forces', 'stress']
    n = int((z[0] > 0).sum())
    req = dict(numbers=z[0, :n], positions=pos[0, :n], cell=cell[0])
    got = NewtonNetCalculator(path, properties=props,
                              device='cpu').calculate(**req)
    want = JaxCalc(path, properties=props).calculate(**req)
    assert got['energy'] == pytest.approx(want['energy'], abs=2e-4)
    for key in ('forces', 'stress'):
        np.testing.assert_allclose(got[key], want[key], atol=2e-4,
                                   err_msg=key)


def test_training_an_xla_model_is_refused_before_any_work(tmp_path):
    """(The name is kept from when the port refused it.) The Trainer takes
    an XLA model and chooses the standard step for it, as the JAX Trainer
    does; the CLI trains a config without `kernel:` (an XLA model) and one
    warm-started from the XLA checkpoint, each through one epoch to
    log.csv."""
    from newtonnet_tpu_torch import Trainer
    from newtonnet_tpu_torch.train.cli import train_from_settings
    trainer = Trainer(NewtonNet(n_features=16, n_basis=4, n_interactions=1,
                                output_properties=['energy'], device='cpu'))
    assert trainer.fast_grad is False and trainer.model.kernel == 'xla'
    aspirin = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_train')
    data = {'train_root': aspirin, 'test_root': None, 'train_size': 2,
            'val_size': 1, 'test_size': 1, 'train_batch_size': 2,
            'val_batch_size': 1, 'test_batch_size': 1}
    loss = {'energy': {'weight': 1.0},
            'gradient_force': {'weight': 50.0}}
    for n, model in enumerate((
            {'n_features': 16, 'n_basis': 4, 'n_interactions': 1,
             'output_properties': ['energy', 'gradient_force']},
            {'pretrained_model': {'path': os.path.join(
                ROOT, 'artifacts', 'md17_model', 'best_model.msgpack')}})):
        settings = {'general': {'device': 'cpu', 'precision': 'float32',
                                'output': str(tmp_path / str(n))},
                    'data': dict(data), 'model': model,
                    'training': {'epochs': 1, 'loss': loss}}
        trainer = train_from_settings(settings)
        assert trainer.model.kernel == 'xla' and not trainer.fast_grad
        assert os.path.exists(os.path.join(trainer.output_path, 'log.csv'))


NO_EXCESS_PRECISION = {'xla_allow_excess_precision': False}


@pytest.mark.parametrize('name', sorted(jact._ACTIVATIONS))
def test_bf16_activation_and_gradient_match_compiled_jax_bitwise(name):
    '''On 20,000 seeded bf16 values, every activation and its vjp equal
    the JAX function's compiled without excess precision, bit for bit:
    the bf16 rules of layers/activations.py (silu is x * (1 / (1 + exp(-x)))
    with each step rounded and logistic's derivative s * (1 - s)).'''
    rs = np.random.RandomState(0)
    x = jnp.asarray((rs.randn(4, 5000) * 4).astype(np.float32)).astype(
        jnp.bfloat16)
    fn = jact.get_activation_by_string(name)
    y = jax.jit(fn).lower(x).compile(compiler_options=NO_EXCESS_PRECISION)(x)
    g = jnp.asarray(rs.randn(*y.shape).astype(np.float32)).astype(
        jnp.bfloat16)
    gx = jax.jit(lambda a, b: jax.vjp(fn, a)[1](b)[0]).lower(x, g).compile(
        compiler_options=NO_EXCESS_PRECISION)(x, g)

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16()
    tx = t(x).requires_grad_(True)
    ty = tact.get_activation_by_string(name)(tx)
    tgx, = torch.autograd.grad(ty, tx, t(g))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.detach().float().numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    np.testing.assert_array_equal(tgx.float().numpy(),
                                  np.asarray(gx.astype(jnp.float32)))


class _DtypeAudit(torch.utils._python_dispatch.TorchDispatchMode):
    '''Records the dtype of every floating-point tensor an aten op
    returns.'''

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for v in torch.utils._pytree.tree_leaves(out):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                self.seen.setdefault(v.dtype, set()).add(
                    func.__name__.split('.')[0])
        return out


@pytest.mark.parametrize('layout', ['dense', 'lists', 'inverse', 'newton3'])
def test_bf16_stack_dtype_audit(layout, monkeypatch):
    '''With compute_dtype bfloat16, every floating-point tensor that an
    operation makes between the stack's casts (inside each interaction
    layer: linear layers, activations, elementwise products, sums, gathers
    and mirror sums) is bf16, as the JAX source types it.'''
    from newtonnet_tpu_torch.models import xla_stack
    graph = {'dense': dict(graph_mode='dense'),
             'lists': dict(graph_mode='neighborlist'),
             'inverse': dict(graph_mode='neighborlist', inverse_lists=True),
             'newton3': dict(graph_mode='neighborlist', newton3=True)}[
                 layout]
    _, _, tm, z, pos, cell = _models(seed=5, compute_dtype='bfloat16',
                                     **graph)
    nlist = (host_symmetric_nlist(tm, z, pos, cell, skin=0.0)
             if layout in ('inverse', 'newton3') else None)
    audits = []
    layer = xla_stack.interaction

    def audited(lp, atom_node, force_node, *rest):
        assert atom_node.dtype == force_node.dtype == torch.bfloat16
        with _DtypeAudit() as audit:
            out = layer(lp, atom_node, force_node, *rest)
        audits.append(audit.seen)
        return out
    monkeypatch.setattr(xla_stack, 'interaction', audited)
    out = tm(*(torch.from_numpy(a) for a in (z, pos, cell)), nlist=nlist)
    assert len(audits) == tm.n_interactions
    for seen in audits:
        assert set(seen) == {torch.bfloat16}, {
            str(k): sorted(v) for k, v in seen.items()}
    assert out['energy'].dtype == torch.float32
