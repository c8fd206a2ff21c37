'''Repairs of the port's faults against the JAX package (ROADMAP.md C4, C6,
C7, C8; C5 is in tests/test_torch_xla_reference.py).

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
and halo are refused, each before any data is read.
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
    calculator's at the parity bar (atol 2e-4); a system object as the
    first argument is refused until md/system.py is ported.'''
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
    with pytest.raises(NotImplementedError, match='ROADMAP.md A, "MD"'):
        calc.calculate(object())


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
    ('halo', {'axis': 'atoms'}, 'parallelism')])
def test_jax_training_keys(tmp_path, key, value, item):
    '''training.steps_per_call trains (eager PyTorch has no dispatch
    chunking to do); profile_dir and halo raise NotImplementedError naming
    their ROADMAP.md A item, before any data is read (the data root does
    not exist).'''
    if item is None:
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
    '''Trainer(profile_dir=...) and Trainer(halo=...) are refused before
    the model is looked at.'''
    from newtonnet_tpu_torch import Trainer
    model = load_model(os.path.join(ROOT, 'artifacts', 'md17_model',
                                    'best_model.msgpack'), device='cpu')
    with pytest.raises(NotImplementedError, match='training extras'):
        Trainer(model, profile_dir='prof')
    with pytest.raises(NotImplementedError, match='parallelism'):
        Trainer(model, halo={'axis': 'atoms'})
