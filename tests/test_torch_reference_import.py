'''Reference (.pt) checkpoints in the port (ROADMAP.md A10,
utils/torch_import.py), the pretrained cache (utils/pretrained.py) and the
ASE bridge (utils/ase_interface.py), against the JAX package's on the CPU.

The pickles are written here as tests/test_torch_import.py writes one (the
reference's old schema: embedding_layer, infer_properties, a layer norm,
F=32, cutoff 4.5) and in the current schema (embedding_layers with its
radius graph, output_properties); the shims resolve both without the
reference package. Bars (float32): energy 2e-4, forces 1e-4; parameters
bitwise.
'''
import csv
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.utils import checkpoint as jckpt
from newtonnet_tpu.utils import pretrained as jpretrained
from newtonnet_tpu.utils import torch_import as jimport
from newtonnet_tpu_torch import NewtonNetCalculator
from newtonnet_tpu_torch.train import cli
from newtonnet_tpu_torch.utils import pretrained, torch_import
from newtonnet_tpu_torch.utils.params import params_to_flax
from test_torch_import import _fabricate_old_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASPIRIN = os.path.join(ROOT, 'data', 'md17_aspirin')
E_ATOL, F_ATOL = 2e-4, 1e-4
ARCH = dict(cutoff=4.5, n_features=32, n_basis=8, n_interactions=2)


def _flat(tree, prefix=''):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f'{prefix}{key}.')
        else:
            yield f'{prefix}{key}', np.asarray(value)


def _to_new_schema(old_path, new_path):
    '''The old-schema pickle rewritten in the current schema:
    embedding_layers (node embedding and edge_embedding.radius_graph.r)
    and output_properties in place of embedding_layer / infer_properties.'''
    m = torch_import.load_torch_pickle(old_path)
    emb = m.embedding_layer
    del m.embedding_layer
    edge = type(emb)()
    edge.radius_graph = type(emb)()
    edge.radius_graph.r = emb.norm.r
    emb.edge_embedding = edge
    del emb.norm
    m.embedding_layers = emb
    m.output_properties = list(m.infer_properties)
    del m.infer_properties
    torch.save(m, new_path)


@pytest.fixture(scope='module')
def checkpoints(tmp_path_factory):
    '''{schema: .pt path} of one set of weights, and those weights.'''
    tmp = tmp_path_factory.mktemp('pt')
    src = JaxNewtonNet(mic_mode='reference', layer_norm=True,
                       output_properties=['energy', 'gradient_force'],
                       **ARCH)
    rs = np.random.RandomState(0)
    z = jnp.asarray(rs.choice([1, 6, 8], size=(2, 6)).astype(np.int32))
    pos = jnp.asarray(rs.randn(2, 6, 3) * 1.5, jnp.float32)
    params = jax.device_get(src.init(jax.random.PRNGKey(0), z, pos,
                                     jnp.zeros((2, 3, 3), jnp.float32)))
    old = str(tmp / 'old_schema.pt')
    _fabricate_old_checkpoint(old, params, **ARCH)
    new = str(tmp / 'new_schema.pt')
    _to_new_schema(old, new)
    return {'old': old, 'new': new}, params


def _frame(seed=3, n=6):
    rs = np.random.RandomState(seed)
    return (rs.choice([1, 6, 8], size=n).astype(np.int64),
            (rs.randn(n, 3) * 1.5).astype(np.float32))


@pytest.mark.parametrize('schema', ['old', 'new'])
def test_both_importers_give_the_same_model(checkpoints, schema):
    '''The port's importer and the JAX package's read one pickle into the
    same configuration and the same parameters (bitwise, names one to
    one, and equal to the weights that were pickled); the port model
    (CPU) gives the JAX model's energy and forces.'''
    paths, params = checkpoints
    cfg, tree = torch_import.load_reference_params(paths[schema])
    jm, jparams = jimport.load_reference_model(paths[schema])
    assert {k: v for k, v in jm.config_dict().items() if k in cfg} == cfg
    mine, theirs = dict(_flat(tree)), dict(_flat(jparams))
    assert sorted(mine) == sorted(theirs) == sorted(dict(_flat(params)))
    for key, value in mine.items():
        np.testing.assert_array_equal(value, theirs[key], err_msg=key)
    model = torch_import.load_reference_model(paths[schema], device='cpu')
    assert not any(p.requires_grad for p in model.parameters())
    for key, value in dict(_flat(params_to_flax(model.core))).items():
        np.testing.assert_array_equal(value, theirs[key], err_msg=key)
    z, pos = _frame()
    out = model(torch.from_numpy(z)[None], torch.from_numpy(pos)[None],
                torch.zeros((1, 3, 3)))
    want = jax.jit(jm.apply)(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams),
        jnp.asarray(z[None], jnp.int32), jnp.asarray(pos[None]),
        jnp.zeros((1, 3, 3), jnp.float32))
    np.testing.assert_allclose(out['energy'].numpy(), want['energy'],
                               rtol=0, atol=E_ATOL)
    np.testing.assert_allclose(out['gradient_force'].numpy(),
                               want['gradient_force'], rtol=0, atol=F_ATOL)


def test_calculator_serves_a_pt_path_and_an_ensemble_of_them(checkpoints):
    '''A .pt model path in the port's calculator (and a list of two, an
    ensemble) against the JAX calculator of the same path.'''
    paths, _ = checkpoints
    z, pos = _frame(seed=4)
    want = JaxCalc(model_path=paths['new']).calculate(numbers=z,
                                                      positions=pos)
    for model_path in (paths['new'], [paths['old'], paths['new']]):
        calc = NewtonNetCalculator(model_path, device='cpu')
        got = calc.calculate(numbers=z, positions=pos)
        assert abs(got['energy'] - want['energy']) <= E_ATOL
        np.testing.assert_allclose(got['forces'], want['forces'], rtol=0,
                                   atol=F_ATOL)
    assert len(calc.members) == 2


def _cli_settings(tmp_path, run, path, **freeze):
    '''config_md17_pallas.yml on the CPU: 4 training frames in batches of
    2 (two steps), warm-started from `path`, written under tmp_path/run.'''
    with open(os.path.join(ROOT, 'scripts', 'config_md17_pallas.yml')) as f:
        cfg = yaml.safe_load(f)
    root = tmp_path / 'data'
    if not root.exists():
        shutil.copytree(os.path.join(ASPIRIN, 'ccsd_train', 'raw'),
                        root / 'raw')
    cfg['general'].update(device='cpu', output=str(tmp_path / run))
    cfg['data'].update(train_root=str(root), test_root=None, train_size=4,
                       val_size=2, test_size=2, train_batch_size=2,
                       val_batch_size=2, test_batch_size=2)
    cfg['model'] = {'pretrained_model': {'path': path, **freeze}}
    cfg['training'].update(epochs=1)
    return cfg


def _log(trainer):
    '''The rows of log.csv without the timings.'''
    with open(os.path.join(trainer.output_path, 'log.csv')) as f:
        return [{k: v for k, v in row.items()
                 if 'seconds' not in k and not k.endswith('_per_s')}
                for row in csv.DictReader(f)]


def test_cli_warm_starts_from_a_pt(checkpoints, tmp_path):
    '''The CLI's .pt warm start (refused before) trains two steps, each
    logged value equal to those of a warm start from the JAX package's
    checkpoint of the JAX importer's parameters (its save_model), both
    with freeze flags of pretrained_model, which hold the frozen groups
    bitwise.'''
    paths, _ = checkpoints
    jm, jparams = jimport.load_reference_model(paths['old'])
    msgpack = str(tmp_path / 'jax.msgpack')
    jckpt.save_model(msgpack, jm, jparams)
    freeze = dict(freeze_interaction=True, freeze_encoder=True)
    logs, trainers = [], []
    for run, path in (('pt', paths['old']), ('msgpack', msgpack)):
        trainer = cli.train_from_settings(_cli_settings(tmp_path, run, path,
                                                        **freeze))
        assert trainer.model.n_features == 32
        logs.append(_log(trainer))
        trainers.append(trainer)
    assert logs[0] == logs[1]
    assert float(logs[0][0]['step']) == 2
    assert float(logs[0][0]['train_loss']) > 0
    start = torch_import.load_reference_model(paths['old'], device='cpu')
    after = dict(trainers[0].model.core.named_parameters())
    moved = set()
    for name, value in start.core.named_parameters():
        frozen_group = (name.startswith('interaction_')
                        or name == 'node_embedding')
        if not torch.equal(value, after[name].detach()):
            moved.add(name)
            assert not frozen_group, name
    assert any(name.startswith('energy_head') for name in moved)


def test_pretrained_cache_is_the_jax_packages(monkeypatch, tmp_path):
    '''The registry and the cache root are the JAX package's, so either
    package finds the other's unpacked checkpoint; a cached file is
    returned without a fetch; a fetch that cannot reach the network raises
    RuntimeError naming the way out (urlretrieve is patched: nothing
    leaves this machine).'''
    assert pretrained.URLS == jpretrained.URLS
    assert pretrained.CACHE_ROOT == jpretrained.CACHE_ROOT
    assert pretrained.checkpoint_path('ani1x') == \
        jpretrained.checkpoint_path('ani1x')
    monkeypatch.setattr(pretrained, 'CACHE_ROOT', str(tmp_path))
    target = pretrained.checkpoint_path('t1x')
    os.makedirs(os.path.dirname(target))
    with open(target, 'wb') as f:
        f.write(b'cached')

    def offline(*args, **kwargs):
        raise OSError('no network')
    monkeypatch.setattr(pretrained, 'urlretrieve', offline)
    assert pretrained.download_checkpoint('t1x') == target
    with pytest.raises(RuntimeError, match='unable to reach.*'
                       'pretrained_model.path'):
        pretrained.download_checkpoint('ani1')


class _Atoms:
    '''The part of ase.Atoms the calculator reads.'''

    def __init__(self, numbers, positions):
        self.numbers, self.positions = numbers, positions

    def get_pbc(self):
        return np.zeros(3, bool)

    def get_cell(self):
        return np.zeros((3, 3))

    def get_atomic_numbers(self):
        return self.numbers

    def get_positions(self, wrap=False):
        return self.positions


def _stub_ase(monkeypatch):
    '''A stand-in ase.calculators.calculator (ASE is on neither machine).'''
    class Calculator:
        def __init__(self, **kwargs):
            self.results = {}

        def calculate(self, atoms=None, properties=None,
                      system_changes=None):
            self.atoms = atoms
    mod = types.ModuleType('ase.calculators.calculator')
    mod.Calculator, mod.all_changes = Calculator, ['positions']
    for name in ('ase', 'ase.calculators'):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, 'ase.calculators.calculator', mod)


def test_ase_calculator(checkpoints, monkeypatch, tmp_path):
    '''Without ASE, construction raises the JAX module's ImportError; with
    a stand-in ASE, MLAseCalculator on a .pt path (device='cpu') gives
    the JAX package's MLAseCalculator results, and a pretrained alias
    loads the cached checkpoint.'''
    from newtonnet_tpu_torch.utils import ase_interface
    paths, _ = checkpoints
    with pytest.raises(ImportError, match='ase is not installed'):
        ase_interface.MLAseCalculator(paths['new'], device='cpu')
    _stub_ase(monkeypatch)
    import importlib

    from newtonnet_tpu.utils import ase_interface as jase
    try:
        mine = importlib.reload(ase_interface)
        theirs = importlib.reload(jase)
        atoms = _Atoms(*_frame(seed=5))
        calc = mine.MLAseCalculator(paths['new'], device='cpu')
        calc.calculate(atoms)
        ref = theirs.MLAseCalculator(paths['new'])
        ref.calculate(atoms)
        assert sorted(calc.results) == sorted(ref.results)
        assert abs(calc.results['energy'] - ref.results['energy']) <= E_ATOL
        np.testing.assert_allclose(calc.results['forces'],
                                   ref.results['forces'], rtol=0,
                                   atol=F_ATOL)
        monkeypatch.setattr(pretrained, 'CACHE_ROOT', str(tmp_path))
        cached = pretrained.checkpoint_path('ani1')
        os.makedirs(os.path.dirname(cached))
        shutil.copy(paths['new'], cached)
        alias = mine.MLAseCalculator('ani1', device='cpu')
        alias.calculate(atoms)
        assert alias.results['energy'] == calc.results['energy']
    finally:
        monkeypatch.undo()
        importlib.reload(ase_interface)
        importlib.reload(jase)
