'''Repairs of the port's faults against the JAX package (ROADMAP.md C4, C6,
C7, C8, C9, C10; C5 is in tests/test_torch_xla_reference.py).

C4: gather_nodes' backward sums each atom's slot cotangents over the list's
transpose in a fixed order, no atomics. Held to torch.gather's autograd (the
scatter-add it replaces) in float64 at 1e-12, in first and second order,
on lists with overflow (in-degrees other than K) and on a padded batch; on
the card, three runs of the backward give the same bits.
C6: NewtonNet.forward and NewtonNetCalculator.calculate run their matrix
products with TF32 off, as the JAX calculator pins 'highest', and give the
caller's flags back.
C7: calculate(system=None, numbers=None, positions=None, cell=None), the
JAX calculator's signature.
C8: the JAX Trainer's steps_per_call is accepted (a no-op), profile_dir
is refused before any data is read, and halo without a graph mesh gives
the JAX Trainer's ValueError (ROADMAP.md A11b ported it).
C9: training.wandb and training.parallel given without a value, and
training.eval_matmul_precision / general.matmul_precision 'highest', reach
training; set values of the first two and other precisions are refused
before any data is read.
C10: NewtonNetCalculator(model_path=None, properties=None,
precision='float32', model=None, params=None, matmul_precision='highest',
device=None), the JAX calculator's keywords, with its refusals.
Also: a kernel='pallas' model without fastgrad is refused when the
Trainer is built (the standard step needs create_graph); the Trainer's
edge counter gives 0 above 2048 atoms, as the JAX Trainer's does; and
gather_nodes' jvp is the gather itself, so a reverse
pass over a tangent runs its fixed-order transpose, never torch.gather's
scatter-add.
'''
import os

import numpy as np
import pytest
import torch
import yaml

from newtonnet_tpu_torch import NewtonNetCalculator, load_model
from newtonnet_tpu_torch.ops import nlist
from newtonnet_tpu_torch.train import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLA_CKPT = os.path.join(ROOT, 'artifacts', 'md17_model',
                        'best_model.msgpack')
ASPIRIN = os.path.join(ROOT, 'data', 'md17_aspirin')


def _list(k_max, seed):
    '''A full list on two random boxes (the second padded by 3 atoms), with
    k_max below the neighbour count, so that in-degrees differ from K.'''
    rs = np.random.RandomState(seed)
    B, N, L = 2, 14, 5.0
    pos = torch.tensor(rs.rand(B, N, 3) * L)
    cell = torch.tensor(np.broadcast_to(np.eye(3) * L, (B, 3, 3)).copy())
    atoms = torch.ones(B, N, dtype=torch.bool)
    atoms[1, -3:] = False
    idx, kmask, _, over = nlist.neighbor_list(pos, cell, atoms, 3.0, k_max)
    return idx, kmask, over


def _old_gather(x, idx):
    '''gather_nodes as it was: torch.gather, whose autograd scatter-adds.'''
    B, N = x.shape[:2]
    R, K = idx.shape[1:]
    flat = x.reshape(B, N, -1)
    index = idx.reshape(B, R * K, 1).expand(B, R * K, flat.shape[-1])
    return torch.gather(flat, 1, index).reshape((B, R, K) + x.shape[2:])


@pytest.mark.parametrize('k_max, masked', [(6, True), (6, False),
                                           (13, True)])
def test_gather_nodes_backward_matches_the_scatter_add(k_max, masked):
    '''First and second order against torch.gather's autograd in float64
    at 1e-12. Masked: the cotangents vanish on masked slots (the model's
    do), as the loss is a masked sum; unmasked: every slot counts.'''
    idx, kmask, over = _list(k_max, seed=k_max)
    if k_max == 6:
        assert over.sum() > 0
    deg = torch.stack([torch.bincount(idx[b][kmask[b]], minlength=14)
                       for b in range(2)])
    assert (deg != k_max).any() and (deg[1, -3:] == 0).all()
    rs = np.random.RandomState(1)
    x = torch.tensor(rs.randn(2, 14, 3, 4), requires_grad=True)
    w = torch.tensor(rs.randn(2, 14, idx.shape[2], 3, 4))
    v = torch.tensor(rs.randn(2, 14, 3, 4))
    keep = kmask[..., None, None] if masked else torch.ones_like(w)
    mask = kmask if masked else None

    def loss(gather):
        return (w * keep * torch.sin(gather(x))).sum()

    grads = []
    for gather in (lambda t: _old_gather(t, idx),
                   lambda t: nlist.gather_nodes(t, idx, mask)):
        (g,) = torch.autograd.grad(loss(gather), x, create_graph=True)
        (h,) = torch.autograd.grad((g * v).sum(), x)
        grads.append((g.detach(), h))
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12)
    # a shared transpose gives the same numbers as one built in backward
    tr = nlist.node_transpose(idx, 14, mask)
    (g,) = torch.autograd.grad(
        loss(lambda t: nlist.gather_nodes(t, idx, mask, tr)), x)
    assert torch.equal(g, grads[1][0])


def test_node_transpose_lists_each_atoms_slots_in_order():
    '''slots[b, j] holds, in increasing order, the flat slot ids of the
    unmasked slots that point at j; valid marks the first in-degree
    entries.'''
    idx, kmask, _ = _list(6, seed=3)
    B, N, K = idx.shape
    tr = nlist.node_transpose(idx, N, kmask)
    for b in range(B):
        for j in range(N):
            want = [r * K + k for r in range(N) for k in range(K)
                    if kmask[b, r, k] and idx[b, r, k] == j]
            got = tr.slots[b, j][tr.valid[b, j]].tolist()
            assert got == want
            assert not tr.slots[b, j][~tr.valid[b, j]].any()


@pytest.mark.cuda
def test_gather_nodes_backward_repeats_its_bits_on_cuda():
    '''Three backward passes of one box-sized bf16 gather (the K-list
    path's cat_j: 4096 atoms, K = 88, 512 features) give the same bits.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    g = torch.Generator(device='cuda').manual_seed(0)
    B, N, K, C = 1, 4096, 88, 512
    idx = torch.randint(0, N, (B, N, K), generator=g, device='cuda')
    mask = torch.rand((B, N, K), generator=g, device='cuda') < 0.7
    idx = torch.where(mask, idx, 0)
    x = torch.randn((B, N, C), generator=g, device='cuda').bfloat16() \
        .requires_grad_(True)
    cot = torch.randn((B, N, K, C), generator=g, device='cuda').bfloat16()
    tr = nlist.node_transpose(idx, N, mask)
    grads = [torch.autograd.grad(nlist.gather_nodes(x, idx, mask, tr), x,
                                 cot)[0] for _ in range(3)]
    assert all(torch.equal(grads[0], h) for h in grads[1:])


def _aspirin_request():
    from newtonnet_tpu_torch.data.loader import parse_xyz
    s = parse_xyz(os.path.join(ASPIRIN, 'ccsd_test', 'raw',
                               'aspirin_ccsd-test.xyz'))[0]
    n = int((s['z'] > 0).sum())
    return s['z'][:n], s['pos'][:n]


class _FlagProbe:
    '''Forward pre-hook that records the TF32 flags a module runs under.'''

    def __init__(self):
        self.seen = []

    def __call__(self, module, args):
        self.seen.append((torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32))


def test_forward_and_calculate_run_with_tf32_off_and_restore_the_flags():
    '''With both TF32 flags switched on by the caller, the model's matrix
    products see them off inside NewtonNet.forward and calculate, and the
    caller finds them on again afterwards.'''
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    calc = NewtonNetCalculator(XLA_CKPT, device='cpu')
    probe = _FlagProbe()
    calc.model.core.energy_head.register_forward_pre_hook(probe)
    numbers, positions = _aspirin_request()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        calc.calculate(numbers=numbers, positions=positions)
        z = torch.tensor(np.asarray(numbers)[None])
        calc.model(z, torch.tensor(np.asarray(positions, np.float32)[None]),
                   torch.zeros(1, 3, 3))
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert probe.seen == [(False, False)] * 2
    assert after == (True, True)


@pytest.mark.cuda
def test_calculate_gives_the_same_bits_with_tf32_on_cuda():
    '''One calculator request with TF32 switched on gives the bits of the
    same request with it off.'''
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    saved = torch.backends.cuda.matmul.allow_tf32
    calc = NewtonNetCalculator(XLA_CKPT)
    numbers, positions = _aspirin_request()
    try:
        out = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            out[tf32] = calc.calculate(numbers=numbers, positions=positions)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert out[True]['energy'] == out[False]['energy']
    assert np.array_equal(out[True]['forces'], out[False]['forces'])


def test_calculate_takes_the_jax_calculators_positional_arguments():
    '''calculate(None, numbers, positions, cell) means what it means in the
    JAX package: the same numbers as the keyword call, and the JAX
    calculator's at the parity bar (atol 2e-4); a System as the first
    argument (md/system.py, ROADMAP.md A, "MD", ported) supplies numbers,
    positions and cell: the keyword call's numbers, bit for bit.'''
    from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
    numbers, positions = _aspirin_request()
    calc = NewtonNetCalculator(XLA_CKPT, device='cpu')
    got = calc.calculate(None, numbers, positions, None)
    kw = calc.calculate(numbers=numbers, positions=positions)
    assert got['energy'] == kw['energy']
    assert np.array_equal(got['forces'], kw['forces'])
    want = JaxCalc(XLA_CKPT).calculate(None, numbers, positions, None)
    assert got['energy'] == pytest.approx(want['energy'], abs=2e-4)
    np.testing.assert_allclose(got['forces'], want['forces'], atol=2e-4)
    from newtonnet_tpu_torch.md import System
    by_system = calc.calculate(System(numbers, positions))
    assert by_system['energy'] == kw['energy']
    assert np.array_equal(by_system['forces'], kw['forces'])


def _settings(tmp_path, train_root):
    with open(os.path.join(ROOT, 'scripts', 'config_md17_pallas.yml')) as f:
        cfg = yaml.safe_load(f)
    cfg['general'].update(device='cpu', output=str(tmp_path / 'runs'))
    cfg['data'].update(train_root=train_root, test_root=None, train_size=4,
                       val_size=4, test_size=4, train_batch_size=4,
                       val_batch_size=4, test_batch_size=4)
    cfg['model'].update(n_features=32, n_basis=8, n_interactions=1)
    cfg['training'].update(epochs=1)
    return cfg


@pytest.mark.parametrize('key, value, item', [
    ('steps_per_call', 8, None),
    ('profile_dir', 'prof', 'training extras'),
    ('halo', {'axis': 'atoms'}, 'parallelism'),
    ('wandb', None, None),
    ('parallel', None, None),
    ('eval_matmul_precision', 'highest', None),
    ('wandb', {'project': 'x'}, 'training extras'),
    ('parallel', {'data': -1}, 'parallelism')])
def test_jax_training_keys(tmp_path, key, value, item):
    '''training.steps_per_call trains (eager PyTorch has no dispatch
    chunking to do), and so do wandb and parallel without a value and
    eval_matmul_precision 'highest' (C9: each ended in a TypeError after
    the data were read); profile_dir and a set wandb raise
    NotImplementedError naming their ROADMAP.md A item, before any data
    is read (the data root does not exist). A set parallel trains
    (ROADMAP.md A11a, "parallelism"): {data: -1} fills the mesh with the
    ranks of the world, here this one process. A set halo (ROADMAP.md
    A11b) reaches the Trainer, which raises the JAX Trainer's ValueError:
    there is no mesh with a 'graph' axis of at least 2.'''
    if key == 'halo':
        cfg = _settings(tmp_path, os.path.join(ASPIRIN, 'ccsd_train'))
        cfg['training'][key] = value
        with pytest.raises(ValueError, match="mesh with a 'graph' axis"):
            cli.train_from_settings(cfg)
        return
    if item is None or key == 'parallel':
        cfg = _settings(tmp_path, os.path.join(ASPIRIN, 'ccsd_train'))
        cfg['training'][key] = value
        trainer = cli.train_from_settings(cfg)
        assert os.path.exists(os.path.join(trainer.output_path, 'log.csv'))
        return
    cfg = _settings(tmp_path, str(tmp_path / 'no_such_data'))
    cfg['training'][key] = value
    with pytest.raises(NotImplementedError,
                       match=f'training.{key}.*ROADMAP.md A, "{item}"'):
        cli.train_from_settings(cfg)
    assert not os.path.exists(tmp_path / 'runs')


def test_trainer_takes_the_jax_trainers_keys():
    '''Trainer(profile_dir=...) is refused before the model is looked at;
    Trainer(halo=...) without a mesh raises the JAX Trainer's ValueError
    (halo needs a 'graph' axis of at least 2).'''
    from newtonnet_tpu_torch import Trainer
    model = load_model(os.path.join(ROOT, 'artifacts', 'md17_model',
                                    'best_model.msgpack'), device='cpu')
    with pytest.raises(NotImplementedError, match='training extras'):
        Trainer(model, profile_dir='prof')
    with pytest.raises(ValueError, match="mesh with a 'graph' axis"):
        Trainer(model, halo={'axis': 'atoms'})


@pytest.mark.parametrize('where, key, value', [
    ('general', 'matmul_precision', 'highest'),
    ('general', 'matmul_precision', 'default'),
    ('training', 'eval_matmul_precision', 'bfloat16')])
def test_matmul_precision_settings(tmp_path, where, key, value):
    """general.matmul_precision 'highest' (artifacts/md17_model/config.yml
    has it) trains; any precision other than 'highest' raises ValueError
    before any data is read: the port computes in IEEE fp32 only."""
    if value == 'highest':
        cfg = _settings(tmp_path, os.path.join(ASPIRIN, 'ccsd_train'))
        cfg[where][key] = value
        assert os.path.exists(os.path.join(
            cli.train_from_settings(cfg).output_path, 'log.csv'))
        return
    cfg = _settings(tmp_path, str(tmp_path / 'no_such_data'))
    cfg[where][key] = value
    with pytest.raises(ValueError, match=f'{key}=.{value}. is not'):
        cli.train_from_settings(cfg)
    assert not os.path.exists(tmp_path / 'runs')
    from newtonnet_tpu_torch import Trainer
    model = load_model(XLA_CKPT, device='cpu')
    with pytest.raises(ValueError, match='eval_matmul_precision'):
        Trainer(model, eval_matmul_precision=value)


def test_calculator_takes_the_jax_constructors_keywords():
    """C10: model= with params= (a flax-named tree of numpy arrays), as
    the JAX calculator takes them, and matmul_precision='highest' give the
    bits of the checkpoint's calculator, served from a copy of the model,
    and match the JAX calculator built from the same model and params; the
    JAX refusal text for no path and no (model, params) pair (model= alone
    included), and the refusal of a precision other than 'highest'. An
    ensemble (ROADMAP.md A8, ported) of one checkpoint twice gives that
    checkpoint's bits: the mean of two equal outputs."""
    from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
    from newtonnet_tpu.utils.checkpoint import load_model as jax_load
    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_to_flax
    numbers, positions = _aspirin_request()
    req = dict(numbers=numbers, positions=positions)
    want = NewtonNetCalculator(XLA_CKPT, device='cpu',
                               matmul_precision='highest').calculate(**req)
    model = load_model(XLA_CKPT, device='cpu')
    fresh = NewtonNet(**model.config_dict(), device='cpu')
    params = params_to_flax(model.core)
    for calc in (NewtonNetCalculator(model=model, params=params),
                 NewtonNetCalculator(model=fresh, params=params,
                                     matmul_precision=None)):
        got = calc.calculate(**req)
        assert got['energy'] == want['energy']
        assert np.array_equal(got['forces'], want['forces'])
        assert calc.model is not model and calc.model is not fresh
    jm, _ = jax_load(XLA_CKPT)
    jax_got = JaxCalc(model=jm, params=params).calculate(**req)
    assert want['energy'] == pytest.approx(jax_got['energy'], abs=2e-4)
    np.testing.assert_allclose(want['forces'], jax_got['forces'], atol=2e-4)
    for kw in ({}, {'model': model}, {'params': params}):
        with pytest.raises(ValueError, match='need model_path or'):
            NewtonNetCalculator(**kw)
    with pytest.raises(ValueError, match='matmul_precision'):
        NewtonNetCalculator(XLA_CKPT, device='cpu', matmul_precision='high')
    twice = NewtonNetCalculator([XLA_CKPT, XLA_CKPT], device='cpu')
    assert len(twice.members) == 2
    got = twice.calculate(**req)
    assert got['energy'] == want['energy']
    assert np.array_equal(got['forces'], want['forces'])


def test_standard_step_over_a_pallas_model_is_refused_when_built(tmp_path):
    """A kernel='pallas' model with fast_grad=False and an energy loss
    (which the JAX Trainer trains by its standard step): the port's
    standard step needs NewtonNet.forward(create_graph=True), which the
    fused kernels do not give, so the Trainer raises NotImplementedError
    naming ROADMAP.md A, "training extras" when it is built, and the CLI
    before it makes a run directory; 'auto' takes fastgrad."""
    from newtonnet_tpu_torch import NewtonNet, Trainer
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    model = NewtonNet(n_features=32, n_basis=8, n_interactions=1,
                      kernel='pallas', output_properties=['energy'],
                      device='cpu')
    energy = get_loss_by_string({'energy': {}})
    with pytest.raises(NotImplementedError,
                       match='ROADMAP.md A, "training extras"'):
        Trainer(model, loss_fns=energy, fast_grad=False)
    assert Trainer(model, loss_fns=energy).fast_grad is True
    cfg = _settings(tmp_path, os.path.join(ASPIRIN, 'ccsd_train'))
    cfg['training'].update(fast_grad=False, loss={'energy': {}})
    with pytest.raises(NotImplementedError,
                       match='ROADMAP.md A, "training extras"'):
        cli.train_from_settings(cfg)
    assert not os.path.exists(tmp_path / 'runs')


def test_edges_metric_is_zero_above_2048_atoms():
    """The Trainer's edge count for throughput logging: the dense graph's
    edges up to 2048 atoms, 0 above, as the JAX Trainer's _count_edges
    gives them (which skips the pair tensor there)."""
    from types import SimpleNamespace

    from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
    from newtonnet_tpu_torch import NewtonNet, Trainer
    trainer = Trainer(NewtonNet(n_features=16, n_basis=4, n_interactions=1,
                                output_properties=['energy'], device='cpu'))
    fake = SimpleNamespace(model=SimpleNamespace(cutoff=trainer.model.cutoff))
    rs = np.random.RandomState(0)
    for n in (64, 2049):
        L = (n / 0.1) ** (1 / 3)
        batch = {'z': np.ones((1, n), np.int32),
                 'pos': (rs.rand(1, n, 3) * L).astype(np.float32),
                 'cell': (np.eye(3) * L)[None].astype(np.float32),
                 'energy': np.zeros(1, np.float32),
                 'graph_mask': np.ones(1, bool)}
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        edges = trainer._metrics(torch.zeros(()), {'energy': b['energy']},
                                 b, edges=True)['edges']
        want = float(JaxTrainer._count_edges(fake, batch))
        assert float(edges) == want
        assert (want > 0) == (n <= 2048)


def test_gather_nodes_jvp_stays_on_the_fixed_order_path():
    """A tangent of gather_nodes that depends on a parameter w: its jvp is
    GatherNodes itself, so the tangent's graph holds GatherNodes and no
    GatherBackward0 (torch.gather's), and the reverse pass over it runs
    ScatterNodes (the 'gather_nodes_backward' range) and no scatter-add;
    the values match torch.gather's in float64 at 1e-12."""
    from torch.profiler import profile
    idx, kmask, _ = _list(6, seed=3)
    rs = np.random.RandomState(4)
    x = torch.tensor(rs.randn(2, 14, 5))
    x_t = torch.tensor(rs.randn(2, 14, 5))
    w = torch.tensor(rs.randn(5, 5), requires_grad=True)
    cot = torch.tensor(rs.randn(2, 14, idx.shape[2], 5)) \
        * kmask[..., None]

    def names(root):
        seen, todo = set(), [root]
        while todo:
            fn = todo.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            todo += [f for f, _ in fn.next_functions]
        return {type(fn).__name__ for fn in seen}

    runs = []
    for gather in (lambda t: nlist.gather_nodes(t, idx, kmask),
                   lambda t: torch.where(kmask[..., None],
                                         _old_gather(t, idx), 0)):
        _, y_t = torch.func.jvp(lambda v: gather(torch.tanh(v @ w)), (x,),
                                (x_t,))
        with profile() as prof:
            (g,) = torch.autograd.grad((y_t * cot).sum(), w)
        ran = {e.key for e in prof.key_averages()}
        runs.append((g, names(y_t.grad_fn), ran))
    (g, graph, ran), (g_ref, graph_ref, ran_ref) = runs
    assert 'GatherNodesBackward' in graph and 'GatherBackward0' not in graph
    assert 'gather_nodes_backward' in ran
    assert not {'aten::scatter_add', 'aten::scatter_add_'} & ran
    assert 'GatherBackward0' in graph_ref
    assert {'aten::scatter_add', 'aten::scatter_add_'} & ran_ref
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=0, atol=1e-12)
