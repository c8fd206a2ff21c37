'''The port (newtonnet_tpu_torch) stands alone: importing it loads no JAX,
flax, optax or msgpack and nothing of newtonnet_tpu, its native sources
are its own copies under newtonnet_tpu_torch/csrc/, and its entry points
refuse to run quietly on the CPU.'''
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'artifacts', 'md17_model_pallas',
                    'best_model.msgpack')


def test_import_loads_no_jax_and_no_reference_package():
    code = textwrap.dedent('''
        import sys
        import newtonnet_tpu_torch
        import newtonnet_tpu_torch.data.loader
        import newtonnet_tpu_torch.data.pipeline
        import newtonnet_tpu_torch.data.prelists
        import newtonnet_tpu_torch.data.preprocess
        import newtonnet_tpu_torch.data.statistics
        import newtonnet_tpu_torch.data.units
        import newtonnet_tpu_torch.data.xyz
        import newtonnet_tpu_torch.layers.activations
        import newtonnet_tpu_torch.md
        import newtonnet_tpu_torch.md.calculator
        import newtonnet_tpu_torch.md.driver
        import newtonnet_tpu_torch.md.integrators
        import newtonnet_tpu_torch.md.optimize
        import newtonnet_tpu_torch.md.simulate
        import newtonnet_tpu_torch.md.system
        import newtonnet_tpu_torch.models.fused_klist
        import newtonnet_tpu_torch.models.fused_stack
        import newtonnet_tpu_torch.models.xla_stack
        import newtonnet_tpu_torch.ops._build
        import newtonnet_tpu_torch.layers.precision
        import newtonnet_tpu_torch.ops.ewald
        import newtonnet_tpu_torch.ops.fused_dense
        import newtonnet_tpu_torch.ops.fused_dual
        import newtonnet_tpu_torch.ops.fused_klist
        import newtonnet_tpu_torch.ops.nlist
        import newtonnet_tpu_torch.ops.row_gather
        import newtonnet_tpu_torch.ops.window
        import newtonnet_tpu_torch.parallel
        import newtonnet_tpu_torch.parallel.collectives
        import newtonnet_tpu_torch.parallel.distributed
        import newtonnet_tpu_torch.parallel.graph_parallel
        import newtonnet_tpu_torch.parallel.launch
        import newtonnet_tpu_torch.parallel.mesh
        import newtonnet_tpu_torch.train.cli
        import newtonnet_tpu_torch.train.fastgrad
        import newtonnet_tpu_torch.train.loss
        import newtonnet_tpu_torch.train.optimizer
        import newtonnet_tpu_torch.train.trainer
        import newtonnet_tpu_torch.utils.ase_interface
        import newtonnet_tpu_torch.utils.checkpoint
        import newtonnet_tpu_torch.utils.export
        import newtonnet_tpu_torch.utils.export_model
        import newtonnet_tpu_torch.utils.freeze
        import newtonnet_tpu_torch.utils.params
        import newtonnet_tpu_torch.utils.pretrained
        import newtonnet_tpu_torch.utils.torch_import
        banned = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack')
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in banned
                     or m == 'newtonnet_tpu'
                     or m.startswith('newtonnet_tpu.'))
        print(','.join(bad))
    ''')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == ''


def test_served_model_process_imports_no_model_and_no_jax(tmp_path):
    '''A process that replays a serving artifact (utils/export.ServedModel)
    imports the op modules and no model module, no JAX and nothing of
    newtonnet_tpu; the package itself imports its entry points lazily.'''
    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.utils.export import (export_inference,
                                                  save_serving_artifact)
    model = NewtonNet(n_features=4, n_basis=4, n_interactions=1,
                      output_properties=['energy'], device='cpu')
    path = str(tmp_path / 'tiny.npz')
    save_serving_artifact(path, *export_inference(model, n_atoms=3))
    code = textwrap.dedent(f'''
        import sys
        import numpy as np
        from newtonnet_tpu_torch.utils.export import ServedModel
        out = ServedModel({path!r}, device='cpu')(
            np.array([1, 8, 1]), np.eye(3, dtype=np.float32))
        assert np.isfinite(out['energy'])
        bad = sorted(m for m in sys.modules
                     if m.startswith('newtonnet_tpu_torch.models')
                     or m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                            'msgpack', 'newtonnet_tpu'))
        print(','.join(bad))
    ''')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == ''


def test_native_sources_are_the_ports_own():
    '''The host C++ builds from newtonnet_tpu_torch/csrc/host/ (its copy of
    native/symslots.cpp), and no file of the port or chip_smoke.py names
    the JAX package's native/ directory or its loader.'''
    from newtonnet_tpu_torch.ops import _build
    pkg = os.path.join(ROOT, 'newtonnet_tpu_torch')
    assert _build.HOST_DIR == os.path.join(pkg, 'csrc', 'host')
    assert os.path.exists(os.path.join(_build.HOST_DIR, 'symslots.cpp'))
    paths = [os.path.join(ROOT, 'chip_smoke.py')]
    for base, _, files in os.walk(pkg):
        paths += [os.path.join(base, f) for f in files
                  if f.endswith(('.py', '.cu', '.cpp', '.h'))]
    for path in paths:
        with open(path) as f:
            text = f.read()
        for banned in ("'native'", 'native/', 'newtonnet_tpu.native',
                       'newtonnet_tpu/native'):
            assert banned not in text, (path, banned)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid')
    from newtonnet_tpu_torch import (NewtonNet, NewtonNetCalculator,
                                     load_model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(CKPT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NewtonNetCalculator(CKPT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NewtonNet(output_properties=['energy'])
    assert load_model(CKPT, device='cpu').device.type == 'cpu'
    from newtonnet_tpu_torch.train.cli import train_from_settings
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_from_settings({'general': {'device': 'cuda'}, 'training': {}})
    from newtonnet_tpu_torch.md.simulate import main as simulate
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(['--steps', '1', '--on-device'])


@pytest.mark.parametrize('kw, item', [
    ({'kernel': 'xla', 'output_properties': ['energy', 'direct_force']},
     'remaining heads'),
    ({'graph_mode': 'neighborlist', 'kernel': 'pallas',
      'pallas_dot_dtype': 'bfloat16'}, 'training extras'),
    ({'kernel': 'xla', 'output_properties': ['energy', 'hessian']},
     'Hessian'),
    ({'calculator_properties': ['energy', 'hessian']}, 'Hessian'),
    ({'md_system': True}, 'MD'),
    ({'pt_checkpoint': True}, 'export'),
])
def test_unported_configurations_name_their_roadmap_item(kw, item):
    '''Each configuration the port does not have yet raises, naming its
    ROADMAP.md item. A bf16 kernel='pallas' model builds, serves and
    trains (section B's last item, ported): the Trainer takes the
    first-order step, and only the standard step over it (fast_grad=False)
    is refused, naming section A's item. The items "remaining heads" and
    "Hessian" are ported (ROADMAP.md A6 and A8): a direct-force or a
    Hessian head in a model, and the Hessian asked of the calculator, now
    build and give their outputs, and raise NotImplementedError no
    more; so does the item "MD" (ROADMAP.md A9): the calculator takes a
    System, and the on-device driver runs it; and the item "export"
    (ROADMAP.md A10): a reference .pt checkpoint, refused as a warm start
    before, loads (utils/torch_import.py) and serves.'''
    from newtonnet_tpu_torch import NewtonNet
    small = dict(device='cpu', n_features=8, n_basis=4, n_interactions=1)
    z = torch.tensor([[1, 6, 8, 1]])
    pos = torch.tensor([[[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [0.0, 1.2, 0.0],
                         [0.3, 0.4, 1.0]]])
    cell = torch.zeros((1, 3, 3))
    if 'calculator_properties' in kw:
        from newtonnet_tpu_torch import NewtonNetCalculator
        from newtonnet_tpu_torch.utils.params import params_to_flax
        model = NewtonNet(**small,
                          output_properties=['energy', 'gradient_force'])
        calc = NewtonNetCalculator(model=model,
                                   params=params_to_flax(model.core),
                                   properties=kw['calculator_properties'],
                                   device='cpu')
        out = calc.calculate(numbers=z[0].numpy(), positions=pos[0].numpy())
        assert out['hessian'].shape == (4, 3, 4, 3)
        assert np.isfinite(out['hessian']).all()
        return
    if kw.get('md_system'):
        from newtonnet_tpu_torch import NewtonNetCalculator
        from newtonnet_tpu_torch.md import System
        from newtonnet_tpu_torch.md.driver import run_langevin_on_device
        from newtonnet_tpu_torch.utils.params import params_to_flax
        model = NewtonNet(**small,
                          output_properties=['energy', 'gradient_force'])
        calc = NewtonNetCalculator(model=model,
                                   params=params_to_flax(model.core),
                                   properties=['energy', 'forces'],
                                   device='cpu')
        system = System(z[0].numpy(), pos[0].numpy())
        out = calc.calculate(system)
        assert out['forces'].shape == (4, 3)
        system, log = run_langevin_on_device(
            model, None, system, timestep=0.1, temperature_K=300.0,
            friction=0.01, n_steps=4, log_every=2)
        assert log['epot'].shape == (2,)
        assert np.isfinite(system.positions).all()
        return
    if kw.get('pt_checkpoint'):
        import tempfile

        from newtonnet_tpu_torch import NewtonNetCalculator
        from newtonnet_tpu_torch.utils.params import params_to_flax
        from test_torch_import import _fabricate_old_checkpoint
        model = NewtonNet(**small, layer_norm=True,
                          output_properties=['energy', 'gradient_force'])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'reference.pt')
            _fabricate_old_checkpoint(path, params_to_flax(model.core),
                                      n_features=8, n_basis=4,
                                      n_interactions=1, cutoff=5.0)
            calc = NewtonNetCalculator(path, device='cpu')
        out = calc.calculate(numbers=z[0].numpy(), positions=pos[0].numpy())
        want = model(z, pos, cell)
        assert abs(out['energy'] - float(want['energy'][0])) <= 1e-5
        return
    if kw.get('pallas_dot_dtype') == 'bfloat16':
        from newtonnet_tpu_torch.train.trainer import Trainer
        model = NewtonNet(**small,
                          output_properties=['energy', 'gradient_force'],
                          **kw)
        assert Trainer(model).fast_grad
        with pytest.raises(NotImplementedError,
                           match=f'ROADMAP.md A.*{item}'):
            Trainer(model, fast_grad=False)
        return
    model = NewtonNet(**small, **kw)
    out = model(z, pos, cell)
    key = kw['output_properties'][-1]
    shape = {'direct_force': (1, 4, 3), 'hessian': (1, 4, 3, 4, 3)}[key]
    assert out[key].shape == shape and torch.isfinite(out[key]).all()


@pytest.mark.parametrize('kw', [
    {'reverse_lists': True}, {'newton3': True},
    {'newton3_compact': True}, {'cell_grid': (2, 2, 2), 'cell_capacity': 8}])
def test_ported_list_layouts_construct(kw):
    '''The kernel='xla' list layouts of ROADMAP.md A3 build a model (they
    were refused before the port had them).'''
    from newtonnet_tpu_torch import NewtonNet
    model = NewtonNet(graph_mode='neighborlist', n_features=8, n_basis=4,
                      n_interactions=1, output_properties=['energy'],
                      device='cpu', **kw)
    for key, value in kw.items():
        assert getattr(model, key) == value
