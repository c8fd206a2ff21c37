'''The port's parallelism (ROADMAP.md A11a, newtonnet_tpu_torch/parallel/)
on the CPU: the mesh, the multi-process set-up, data-parallel training
through the Trainer and the CLI, and the dense graph-parallel request.

Without processes: the mesh's shapes and asserts against the JAX
package's make_mesh, process_local_batch_slice, global_data_batch's
counts, the backend rule, the no-op set-up without the environment, and
the launcher's exit status.

One spawned group: parallel/launch.py starts two ranks of this file's
`worker` (gloo, one thread each), which write their results to the test's
temporary directory; the module fixture compares them with the same work
in this process, one rank. In float32, 2 ranks against 1 on the same
global batches (within 1e-5 relative): the step-1 loss and gradient of a
dense kernel='pallas' fastgrad step (fp32 duals), a kernel='xla' fastgrad
step and a standard step, and their losses over 3 steps; the batches'
halves hold different padding (3-4 atoms against 7-8), and two controls
must fail: a rank that skips the gradient's all-reduce, and ranks that
normalise by their local counts and average. The parameters are equal
across ranks after 3 steps, and a (1, 2) mesh replicates the batch over
its graph ranks. A CLI run of 2 epochs with training.parallel
{data: 2} against data 1 (log.csv within 1e-5, one training_1 directory,
written by the chief) and its resume for a third epoch with both ranks
restarted (a second launch), against the one-rank resume. In float64, the
graph-parallel energies and forces at (data, graph) = (1, 2) and (2, 1)
against the one-process model at 1e-10.

JAX's numbers are stored, never recomputed here: the same steps through
the JAX Trainer on make_mesh(data=2), and the sharded energies and forces
of make_sharded_energy_force_fn on make_mesh(1, 2), both on two virtual
CPU devices, from the parameters stored beside them. The recipe:

    python tests/test_torch_parallel.py jax

(about a minute) writes tests/reference/jax_parallel.npz. The port's
steps are held to them at the bars of tests/test_torch_xla_training.py
(metrics rtol 2e-5, parameters atol 2e-6), the energies and forces at
1e-10.
'''
import csv
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, 'tests', 'reference', 'jax_parallel.npz')
ASPIRIN = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_train', 'raw')
EF = {'energy': {'weight': 1.0, 'mode': 'mse'},
      'gradient_force': {'weight': 50.0, 'mode': 'mse'}}
CFG = dict(cutoff=5.0, n_features=16, n_basis=6, n_interactions=2,
           output_properties=['energy', 'gradient_force'])
# case -> (model config changes, fast_grad)
CASES = {'pallas': (dict(kernel='pallas', pallas_grad_dot_dtype='float32'),
                    'auto'),
         'xla_fastgrad': ({}, True),
         'standard': ({}, 'auto')}
GP_CFG = dict(n_features=16, n_basis=8, n_interactions=2,
              output_properties=['energy', 'gradient_force'])
GP_MESHES = ((1, 2), (2, 1))
REL = 1e-5
TIMING = ('epoch_seconds', 'steps_per_s', 'edges_per_s')


def make_batches(n_batches=3, B=4, n_pad=8, seed=0):
    '''Global batches of 4 random molecules padded to 8 atoms: the first
    half of each has 3-4 atoms, the second 7-8, so that the two ranks'
    halves hold different padding.'''
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        z = np.zeros((B, n_pad), np.int32)
        pos = np.zeros((B, n_pad, 3), np.float32)
        force = np.zeros((B, n_pad, 3), np.float32)
        for b in range(B):
            k = rs.randint(3, 5) if b < B // 2 else rs.randint(7, 9)
            z[b, :k] = rs.choice([1, 6, 7, 8], size=k)
            pos[b, :k] = rs.randn(k, 3) * 1.6
            force[b, :k] = rs.randn(k, 3)
        out.append({'z': z, 'pos': pos,
                    'cell': np.zeros((B, 3, 3), np.float32),
                    'energy': rs.randn(B).astype(np.float32),
                    'force': force, 'graph_mask': np.ones(B, bool)})
    return out


def gp_inputs():
    '''The JAX graph-parallel test's request: 4 graphs of 30 atoms (the
    last 3 padding), float64, aperiodic.'''
    rs = np.random.RandomState(0)
    z = rs.choice([1, 6, 8], size=(4, 30)).astype(np.int64)
    z[:, 27:] = 0
    pos = rs.randn(4, 30, 3) * 3.0
    return z, pos, np.zeros((4, 3, 3))


def tree(ref, prefix):
    '''The flax {'params': ...} tree stored under `prefix` in the npz.'''
    out = {}
    for key in ref.files:
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split('.')
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = ref[key]
    return {'params': out}


def port_trainer(case, ref, mesh=None):
    from newtonnet_tpu_torch import NewtonNet, Trainer
    from newtonnet_tpu_torch.train import optimizer as topt
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.utils.params import params_from_flax
    kw, fast_grad = CASES[case]
    model = NewtonNet(**CFG, **kw, device='cpu')
    params_from_flax(tree(ref, 'dp.'), core=model.core)
    return Trainer(model, loss_fns=get_loss_by_string(EF),
                   optimizer=topt.get_optimizer_by_string(
                       'sgd', model.core, clip_grad=1.0, lr=1e-2,
                       momentum=0.9),
                   fast_grad=fast_grad, mesh=mesh)


def flat_params(trainer):
    import torch
    return torch.cat([p.detach().reshape(-1)
                      for p in trainer.model.core.parameters()]).numpy()


def grads(trainer):
    import torch
    return torch.cat([p.grad.reshape(-1)
                      for p in trainer.model.core.parameters()
                      if p.grad is not None])


def global_gradient(trainer, batch):
    '''The global batch's loss and flat parameter gradient for a numpy
    batch, nothing stepped: this rank's rows (Trainer._shard), its loss and
    gradient, the gradients summed over the data group
    (Trainer.reduce_gradients) and the loss likewise.'''
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.parallel import collectives
    with fp32_matmuls():
        loss, _ = trainer.loss_and_grad(
            trainer._to_device(trainer._shard(batch)))
        trainer.reduce_gradients()
    return collectives.all_reduce_sum(loss, trainer._data_group()), \
        grads(trainer)


def dp_steps(case, ref, mesh=None):
    '''-> {key: array} of one case: the step-1 loss and flat gradient,
    the controls' gradients (with a mesh of 2), then per step the global
    metrics and the flat parameters.'''
    import torch

    from newtonnet_tpu_torch.parallel import collectives
    from newtonnet_tpu_torch.parallel.distributed import COUNT_KEYS
    batches = make_batches()
    out = {}
    t = port_trainer(case, ref, mesh)
    loss, grad = global_gradient(t, batches[0])
    out['loss1'], out['grad1'] = loss.numpy(), grad.numpy()
    group = None if mesh is None else mesh.group('data')
    if group is not None:
        b = t._to_device(t._shard(batches[0]))
        t.loss_and_grad(b)  # this rank's partial gradient, not reduced
        out['grad1_no_allreduce'] = grads(t).numpy()
        t.loss_and_grad({k: v for k, v in b.items() if k not in COUNT_KEYS})
        local = grads(t)
        out['grad1_local_counts'] = (collectives.all_reduce_sum(local, group)
                                     / mesh.shape['data']).numpy()
    t = port_trainer(case, ref, mesh)
    names = None
    metrics, params = [], []
    for batch in batches:
        m = t.train_step(batch)
        names = list(m)
        v = torch.stack([m[k].to(torch.float64) for k in names])
        metrics.append(collectives.all_reduce_sum(v, group).numpy())
        params.append(flat_params(t))
    out['metrics'] = np.stack(metrics)
    out['metric_names'] = np.asarray(names)
    out['params'] = np.stack(params)
    return out


def gp_port(ref, mesh):
    import torch

    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.parallel.graph_parallel import (
        make_sharded_energy_force_fn,
        pad_atoms_to_multiple,
    )
    from newtonnet_tpu_torch.utils.params import params_from_flax
    model = NewtonNet(**GP_CFG, device='cpu', dtype=torch.float64)
    params_from_flax(tree(ref, 'gp.'), core=model.core)
    z, pos, cell = (torch.from_numpy(a) for a in gp_inputs())
    if mesh is None:
        out = model(z, pos, cell)
        return out['energy'].detach().numpy(), \
            out['gradient_force'].detach().numpy()
    zp, posp = pad_atoms_to_multiple(z, pos, mesh.shape['graph'])
    e, f = make_sharded_energy_force_fn(model, mesh)(zp, posp, cell)
    return e.numpy(), f[:, :z.shape[1]].numpy()


def cli_config(path, out, data_root, epochs):
    with open(os.path.join(ROOT, 'scripts', 'config_md17_pallas.yml')) as f:
        cfg = yaml.safe_load(f)
    cfg['general'].update(device='cpu', output=out)
    cfg['data'].update(train_root=data_root, test_root=None, train_size=8,
                       val_size=4, test_size=4, train_batch_size=4,
                       val_batch_size=4, test_batch_size=4)
    cfg['model'].update(n_features=16, n_basis=6, n_interactions=1)
    cfg['training'].update(epochs=epochs,
                           checkpoint={'check_val': 1, 'check_test': 1,
                                       'check_log': 1})
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def worker(out_dir):
    '''One rank of the spawned group (started by parallel/launch.py).'''
    import torch
    torch.set_num_threads(1)
    from newtonnet_tpu_torch.parallel import distributed
    from newtonnet_tpu_torch.parallel.mesh import make_mesh
    from newtonnet_tpu_torch.train import cli
    assert distributed.maybe_initialize_from_env('cpu')
    rank = distributed.world()[0]
    ref = np.load(REF)
    res = {}
    mesh = make_mesh(data=2)
    for case in CASES:
        for k, v in dp_steps(case, ref, mesh).items():
            res[f'{case}/{k}'] = v
    for k, v in dp_steps('xla_fastgrad', ref,
                         make_mesh(data=1, graph=2)).items():
        res[f'graph2/{k}'] = v
    for d, g in GP_MESHES:
        e, f = gp_port(ref, make_mesh(data=d, graph=g))
        res[f'gp{d}{g}/energy'], res[f'gp{d}{g}/forces'] = e, f
    cli.main(['--config', os.path.join(out_dir, 'mp.yml')])
    np.savez(os.path.join(out_dir, f'rank{rank}.npz'), **res)


def _env():
    env = dict(os.environ)
    for k in list(env):
        if k.startswith('NEWTONNET_DIST_'):
            del env[k]
    env.update(OMP_NUM_THREADS='1', PYTHONPATH=ROOT)
    return env


def _launch(cmd, log_dir):
    return subprocess.Popen(
        [sys.executable, '-m', 'newtonnet_tpu_torch.parallel.launch',
         '--nprocs', '2', '--log-dir', log_dir, '--timeout', '300', '--',
         sys.executable, *cmd],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _wait(proc, log_dir):
    text = proc.communicate(timeout=330)[0]
    logs = ''
    for i in range(2):
        p = os.path.join(log_dir, f'proc_{i}.log')
        if os.path.exists(p):
            with open(p) as f:
                logs += f'--- rank {i} ---\n' + f.read()[-3000:]
    assert proc.returncode == 0, (text, logs)


def _log(out):
    with open(os.path.join(out, 'log.csv')) as f:
        return list(csv.DictReader(f))


def _set_epochs(run_dir, epochs):
    path = os.path.join(run_dir, 'run_scripts', 'sp.yml')
    if not os.path.exists(path):
        path = os.path.join(run_dir, 'run_scripts', 'mp.yml')
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg['training']['epochs'] = epochs
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)


@pytest.fixture(scope='module')
def spawned(tmp_path_factory):
    '''Both ranks' results and this process's one-rank runs.'''
    from newtonnet_tpu_torch.data.preprocess import main as preprocess
    from newtonnet_tpu_torch.train import cli
    tmp = str(tmp_path_factory.mktemp('parallel'))
    data = os.path.join(tmp, 'aspirin')
    shutil.copytree(ASPIRIN, os.path.join(data, 'raw'))
    preprocess(['-r', data])  # both ranks read the cache, none writes it
    mp_out, sp_out = os.path.join(tmp, 'mp_out'), os.path.join(tmp, 'sp_out')
    cli_config(os.path.join(tmp, 'mp.yml'), mp_out, data, 2)
    cli_config(os.path.join(tmp, 'sp.yml'), sp_out, data, 2)
    proc = _launch([os.path.abspath(__file__), 'worker', tmp],
                   os.path.join(tmp, 'logs'))
    # the one-rank runs while the ranks work
    ref = np.load(REF)
    one = {case: dp_steps(case, ref) for case in CASES}
    gp_one = gp_port(ref, None)
    cli.main(['--config', os.path.join(tmp, 'sp.yml')])
    sp_log = _log(os.path.join(sp_out, 'training_1'))
    _set_epochs(os.path.join(sp_out, 'training_1'), 3)
    cli.main(['--resume', os.path.join(sp_out, 'training_1')])
    _wait(proc, os.path.join(tmp, 'logs'))
    mp_log = _log(os.path.join(mp_out, 'training_1'))
    mp_dirs = sorted(os.listdir(mp_out))
    _set_epochs(os.path.join(mp_out, 'training_1'), 3)
    proc = _launch(['-m', 'newtonnet_tpu_torch.train.cli', '--resume',
                    os.path.join(mp_out, 'training_1')],
                   os.path.join(tmp, 'logs_resume'))
    _wait(proc, os.path.join(tmp, 'logs_resume'))
    return dict(
        ranks=[dict(np.load(os.path.join(tmp, f'rank{r}.npz')))
               for r in range(2)],
        one=one, gp_one=gp_one, ref=ref, sp_log=sp_log, mp_log=mp_log,
        mp_dirs=mp_dirs,
        sp_resumed=_log(os.path.join(sp_out, 'training_2')),
        mp_resumed=_log(os.path.join(mp_out, 'training_2')),
        mp_after=sorted(os.listdir(mp_out)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- #
# no processes


@pytest.mark.parametrize('data, graph, n', [
    (-1, 1, 8), (-1, 2, 8), (2, 4, 8), (2, 2, 8), (1, 1, 1), (-1, 1, 1),
    (2, 1, 1), (-1, 3, 8), (3, 3, 8)])
def test_mesh_shapes_and_asserts_match_jax(data, graph, n):
    '''make_mesh over n ranks gives the JAX make_mesh's shape over n
    devices, and raises where it asserts.'''
    import jax

    from newtonnet_tpu.parallel.mesh import make_mesh as jax_mesh
    from newtonnet_tpu_torch.parallel.mesh import make_mesh
    try:
        want = dict(jax_mesh(data, graph, jax.devices()[:n]).shape)
    except AssertionError:
        with pytest.raises(AssertionError):
            make_mesh(data, graph, ranks=range(n))
        return
    mesh = make_mesh(data, graph, ranks=range(n))
    assert mesh.shape == want
    assert mesh.coords == (0, 0)
    assert mesh.groups == {'data': None, 'graph': None}


def test_one_process_has_a_one_by_one_mesh_and_no_set_up(monkeypatch):
    '''Without a process group the world is this process: a 1x1 mesh, the
    whole batch, no set-up without the environment or for one process.'''
    from newtonnet_tpu_torch.parallel import distributed as pd
    from newtonnet_tpu_torch.parallel.mesh import make_mesh
    for k in pd.ENV:
        monkeypatch.delenv(k, raising=False)
    assert make_mesh().shape == {'data': 1, 'graph': 1}
    assert pd.make_global_mesh(data=-1, graph=1).shape == \
        {'data': 1, 'graph': 1}
    assert not pd.maybe_initialize_from_env('cpu')
    assert not pd.initialize_distributed('127.0.0.1:1', 1, 0, 'cpu')
    monkeypatch.setenv('NEWTONNET_DIST_COORD', '127.0.0.1:1')
    monkeypatch.setenv('NEWTONNET_DIST_NPROCS', '1')
    monkeypatch.setenv('NEWTONNET_DIST_PROCID', '0')
    assert not pd.maybe_initialize_from_env('cpu')
    assert not pd.is_multiprocess() and pd.backend() is None
    assert pd.process_local_batch_slice(10) == (0, 10)


def test_batch_slices_and_global_counts():
    '''A rank's rows follow its data index (the graph ranks of a data row
    share them), and the batch carries the global batch's counts; a batch
    that does not divide raises.'''
    from newtonnet_tpu_torch.parallel import distributed as pd
    from newtonnet_tpu_torch.parallel.mesh import Mesh
    groups = {'data': None, 'graph': None}
    ranks = np.arange(4).reshape(2, 2)
    batch = make_batches(1)[0]
    batch['graph_mask'][3] = False
    for r, rows in ((0, slice(0, 2)), (1, slice(0, 2)), (2, slice(2, 4)),
                    (3, slice(2, 4))):
        mesh = Mesh(ranks, groups, r)
        assert pd.process_local_batch_slice(4, mesh) == \
            (rows.start, rows.stop - rows.start)
        got = pd.global_data_batch(mesh, batch)
        np.testing.assert_array_equal(got['z'], batch['z'][rows])
        assert got['graph_count'] == 3
        assert got['atom_count'] == np.count_nonzero(batch['z'])
    with pytest.raises(ValueError, match='not divisible'):
        pd.global_data_batch(Mesh(np.arange(3)[:, None], groups, 0), batch)
    with pytest.raises(AssertionError):
        pd.process_local_batch_slice(5, Mesh(ranks, groups, 0))


@pytest.mark.parametrize('device, nprocs, cards, backend, devices', [
    ('cpu', 2, 0, 'gloo', ['cpu', 'cpu']),
    ('cuda', 2, 1, 'gloo', ['cuda:0', 'cuda:0']),
    ('cuda', 4, 1, 'gloo', ['cuda:0'] * 4),
    ('cuda', 2, 2, 'nccl', ['cuda:0', 'cuda:1']),
    ('cuda', 4, 8, 'nccl', ['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3'])])
def test_backend_rule(device, nprocs, cards, backend, devices):
    '''NCCL where every rank has a card of its own, gloo where ranks share
    one and on the CPU; a shared card serves every rank.'''
    from newtonnet_tpu_torch.parallel import distributed as pd
    assert pd.choose_backend(device, nprocs, n_cards=cards) == backend
    assert [str(pd.rank_device(device, r, n_cards=cards))
            for r in range(nprocs)] == devices


def test_no_card_raises_for_cuda():
    from newtonnet_tpu_torch.parallel import distributed as pd
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pd.choose_backend('cuda', 2, n_cards=0)


def test_launcher_fails_with_a_failing_child(tmp_path):
    '''A failing rank fails the set with its code, and the others are
    killed; each rank sees the three variables.'''
    from newtonnet_tpu_torch.parallel import launch
    code = ('import os, sys, time;'
            ' r = int(os.environ["NEWTONNET_DIST_PROCID"]);'
            ' assert os.environ["NEWTONNET_DIST_NPROCS"] == "2";'
            ' sys.exit(3) if r == 1 else time.sleep(60)')
    assert launch.run([sys.executable, '-c', code], 2,
                      str(tmp_path), timeout=50) == 3
    assert launch.run([sys.executable, '-c', 'pass'], 2, str(tmp_path)) == 0


# ---------------------------------------------------------------- #
# the spawned group


@pytest.mark.parametrize('case', list(CASES))
def test_data_parallel_step_equals_one_rank(spawned, case):
    '''Step 1's loss and gradient and the 3 steps' metrics of 2 ranks
    equal the one-rank run's on the same global batches (1e-5 relative);
    the parameters are equal across the ranks after 3 steps.'''
    one = spawned['one'][case]
    for r in range(2):
        got = {k.split('/', 1)[1]: v for k, v in spawned['ranks'][r].items()
               if k.startswith(case + '/')}
        assert _rel(got['loss1'], one['loss1']) < REL
        assert _rel(got['grad1'], one['grad1']) < REL
        assert list(got['metric_names']) == list(one['metric_names'])
        np.testing.assert_allclose(got['metrics'], one['metrics'], rtol=REL)
        np.testing.assert_allclose(got['params'], one['params'], rtol=0,
                                   atol=1e-6)
    a, b = (spawned['ranks'][r][f'{case}/params'] for r in range(2))
    np.testing.assert_array_equal(a, b)


def test_graph_axis_replicates_the_data_rows(spawned):
    '''A (data, graph) = (1, 2) mesh without halo: both graph ranks take
    the whole batch (P('data') on a (D, G) mesh), and their steps equal
    the one-rank run's.'''
    one = spawned['one']['xla_fastgrad']
    for r in range(2):
        res = spawned['ranks'][r]
        assert _rel(res['graph2/grad1'], one['grad1']) < REL
        np.testing.assert_allclose(res['graph2/metrics'], one['metrics'],
                                   rtol=REL)
        np.testing.assert_allclose(res['graph2/params'], one['params'],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize('case', list(CASES))
def test_data_parallel_step_matches_the_jax_mesh(spawned, case):
    '''The ranks' 3 steps against the JAX Trainer's on make_mesh(data=2)
    (stored): metrics at rtol 2e-5, parameters at atol 2e-6.'''
    ref = spawned['ref']
    got = {k.split('/', 1)[1]: v for k, v in spawned['ranks'][0].items()
           if k.startswith(case + '/')}
    names = [str(n) for n in ref[f'{case}/metric_names']]
    idx = [list(got['metric_names']).index(n) for n in names]
    np.testing.assert_allclose(got['metrics'][:, idx], ref[f'{case}/metrics'],
                               rtol=2e-5)
    np.testing.assert_allclose(got['params'], ref[f'{case}/params'], rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize('control', ['grad1_no_allreduce',
                                     'grad1_local_counts'])
def test_controls_fail_the_gradient_bar(spawned, control):
    '''A rank that skips the all-reduce, and ranks that divide by their
    local counts and average (each half of a batch has its own padding),
    miss the one-rank gradient by far more than the bar, in every case.'''
    for case in CASES:
        one = spawned['one'][case]['grad1']
        for r in range(2):
            assert _rel(spawned['ranks'][r][f'{case}/{control}'], one) \
                > 100 * REL, (case, r)


@pytest.mark.parametrize('data, graph', GP_MESHES)
def test_graph_parallel_matches_one_process_and_jax(spawned, data, graph):
    '''Sharded energies and forces (float64) equal the one-process model's
    and the JAX package's sharded ones on make_mesh(1, 2) at 1e-10.'''
    e1, f1 = spawned['gp_one']
    ref = spawned['ref']
    for r in range(2):
        res = spawned['ranks'][r]
        np.testing.assert_allclose(res[f'gp{data}{graph}/energy'], e1,
                                   rtol=1e-10)
        np.testing.assert_allclose(res[f'gp{data}{graph}/forces'], f1,
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(res[f'gp{data}{graph}/energy'],
                                   ref['gp/energy'], rtol=1e-10)
        np.testing.assert_allclose(res[f'gp{data}{graph}/forces'],
                                   ref['gp/forces'], rtol=0, atol=1e-10)


def _assert_logs_agree(got, want):
    assert [r['epoch'] for r in got] == [r['epoch'] for r in want]
    for a, b in zip(got, want):
        for key, value in b.items():
            if key in TIMING or not value or key == 'epoch':
                continue
            if value in ('True', 'False'):
                assert a[key] == value, key
                continue
            np.testing.assert_allclose(float(a[key]), float(value),
                                       rtol=REL, err_msg=f'{a["epoch"]} {key}')


def test_cli_two_ranks_equal_one(spawned):
    '''training.parallel {data: 2}: the chief's log.csv equals the
    one-rank run's within 1e-5 (the epochs, then the last and best
    re-evaluations), and only one run directory was made.'''
    assert spawned['mp_dirs'] == ['training_1']
    assert [r['epoch'] for r in spawned['mp_log']] == \
        ['0', '1', 'last', 'best']
    _assert_logs_agree(spawned['mp_log'], spawned['sp_log'])


def test_cli_resume_with_both_ranks_restarted(spawned):
    '''Both ranks restarted with --resume train a third epoch that equals
    the one-rank resume's; the chief alone made the new directory.'''
    assert spawned['mp_after'] == ['training_1', 'training_2']
    assert '2' in [r['epoch'] for r in spawned['mp_resumed']]
    _assert_logs_agree(spawned['mp_resumed'], spawned['sp_resumed'])


# ---------------------------------------------------------------- #
# the JAX recipe


def jax_recipe():
    '''Write tests/reference/jax_parallel.npz (two virtual CPU devices).'''
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
    from newtonnet_tpu.parallel import make_mesh
    from newtonnet_tpu.parallel.graph_parallel import (
        make_sharded_energy_force_fn,
        pad_atoms_to_multiple,
    )
    from newtonnet_tpu.train import optimizer as jopt
    from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
    from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
    out = {}

    def store(prefix, params):
        leaves = jax.tree_util.tree_flatten_with_path(params['params'])[0]
        for path, v in leaves:
            out[prefix + '.'.join(k.key for k in path)] = np.asarray(v)

    jm = JaxNewtonNet(**CFG)
    z0 = jnp.ones((1, 4), jnp.int32)
    pos0 = jnp.asarray(np.random.RandomState(0).randn(1, 4, 3), jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), z0, pos0, jnp.zeros((1, 3, 3)))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    store('dp.', params)
    from newtonnet_tpu_torch import NewtonNet
    order = [n for n, _ in
             NewtonNet(**CFG, device='cpu').core.named_parameters()]
    mesh = make_mesh(data=2)
    for case, (kw, fast_grad) in CASES.items():
        model = JaxNewtonNet(**CFG, **kw)
        jt = JaxTrainer(model, params, loss_fns=jax_loss(EF),
                        optimizer=jopt.get_optimizer_by_string(
                            'sgd', clip_grad=1.0, lr=1e-2, momentum=0.9),
                        fast_grad=fast_grad, mesh=mesh, steps_per_call=1)
        names = ['loss'] + jt._eval_metric_names() + ['edges']
        metrics, flat = [], []
        for batch in make_batches():
            totals = {n: jnp.zeros((), jnp.float32) for n in names}
            jt.params, jt.opt_state, totals = jt._train_step(
                jt.params, jt.opt_state, totals, batch)
            metrics.append([float(totals[n]) for n in names])
            step = {}
            leaves = jax.tree_util.tree_flatten_with_path(
                jax.device_get(jt.params)['params'])[0]
            for path, v in leaves:
                step['.'.join(k.key for k in path)] = np.asarray(v)
            flat.append(step)
        out[f'{case}/metric_names'] = np.asarray(names)
        out[f'{case}/metrics'] = np.asarray(metrics)
        # flat, in the port's parameter order
        out[f'{case}/params'] = np.stack([
            np.concatenate([step[n].reshape(-1) for n in order])
            for step in flat])
        print(case, out[f'{case}/metrics'][:, 0])

    gm = JaxNewtonNet(**GP_CFG, param_dtype=jnp.float64)
    z, pos, cell = gp_inputs()
    z, pos, cell = jnp.asarray(z, jnp.int32), jnp.asarray(pos), \
        jnp.asarray(cell)
    gparams = gm.init(jax.random.PRNGKey(1), z, pos, cell)
    store('gp.', gparams)
    zp, posp = pad_atoms_to_multiple(z, pos, 2)
    e, f = make_sharded_energy_force_fn(gm, make_mesh(1, 2))(gparams, zp,
                                                             posp, cell)
    out['gp/energy'] = np.asarray(e)
    out['gp/forces'] = np.asarray(f)[:, :z.shape[1]]
    np.savez(REF, **out)
    print('wrote', REF)


if __name__ == '__main__':
    if sys.argv[1] == 'worker':
        worker(sys.argv[2])
    elif sys.argv[1] == 'jax':
        jax_recipe()
