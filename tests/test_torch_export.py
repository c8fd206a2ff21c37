'''Serving artifacts of the port (ROADMAP.md A10, utils/export.py) on the
CPU: the custom ops K1/K2, K5/K6 and K9/K12 run through, export, replay
in this process and in a fresh one, and the JAX package's ServedModel of
the same weights.

Models are small (F <= 32, 1-2 interactions, at most 8 atoms padded to 8
or 16), one artifact per module fixture, one JAX export in the suite.
Bars (float32): energy 2e-4, forces 1e-4 (absolute), and the same between
the eager port and the JAX package's model.apply. A kernel='pallas' model
is held to the JAX package's kernel='xla' apply of the same weights: the
two formulations compute one function, and Pallas' interpret mode would
cost this file most of its time. On the card, chip_smoke.py's phase 16
replays the trained checkpoints and counts the kernels' launches in the
replaying process.
'''
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.utils import export as jexport
from newtonnet_tpu_torch import NewtonNet
from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_klist as fk
from newtonnet_tpu_torch.ops import nlist as tnl
from newtonnet_tpu_torch.utils import export as ex
from newtonnet_tpu_torch.utils.params import params_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E_ATOL, F_ATOL = 2e-4, 1e-4
FORCES = ('energy', 'gradient_force')


def frames(seed=0, B=2, N=6, L=6.0, periodic=True):
    '''B seeded frames of N atoms on a jittered 2x2x2 lattice of spacing
    L/2; the second graph has one padding atom.'''
    rs = np.random.RandomState(seed)
    sites = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing='ij'),
                     -1).reshape(8, 3) * (L / 2) + L / 4
    z = rs.choice([1, 6, 8], size=(B, N)).astype(np.int64)
    z[1:, -1] = 0
    pos = np.stack([sites[rs.permutation(8)[:N]]
                    + rs.uniform(-0.075, 0.075, (N, 3)) * L
                    for _ in range(B)]).astype(np.float32)
    cell = np.broadcast_to(np.eye(3, dtype=np.float32) * L * periodic,
                           (B, 3, 3)).copy()
    return z, pos, cell


def port_model(outputs=FORCES, **kw):
    cfg = dict(dict(cutoff=3.5, n_features=16, n_basis=6, n_interactions=2,
                    output_properties=list(outputs)), **kw)
    return NewtonNet(**cfg, device='cpu',
                     generator=torch.Generator().manual_seed(5))


def jax_apply(model, params, z, pos, cell, **kw):
    '''The JAX package's model.apply of the port model's weights, float32,
    at the config `model` has, with `kw` changed.'''
    jm = JaxNewtonNet(**dict(model.config_dict(), **kw))
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    out = jax.jit(jm.apply)(p, jnp.asarray(z, jnp.int32),
                            jnp.asarray(pos), jnp.asarray(cell))
    return {k: np.asarray(v) for k, v in out.items()}


def port_out(model, z, pos, cell, nlist=None):
    out = model(torch.from_numpy(z), torch.from_numpy(pos),
                torch.from_numpy(cell), nlist=nlist)
    return {k: v.numpy() for k, v in out.items()}


def assert_close(got, want, keys=FORCES):
    for key in keys:
        bar = E_ATOL if key == 'energy' else F_ATOL
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=bar,
                                   err_msg=key)


def exported(model, path, **kw):
    header, blob = ex.export_inference(model, None, **kw)
    ex.save_serving_artifact(path, header, blob)
    return path


def graph_ops(served):
    return {str(n.target) for n in served._program.graph.nodes
            if n.op == 'call_function'
            and str(n.target).startswith('newtonnet_tpu_torch')}


# ---------------------------------------------------------------- #
# the custom ops


def _rnd(g, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=g).to(dtype)


def _pair_args(first, dot):
    g = torch.Generator().manual_seed(1)
    B, N, F, R = 2, 5, 8, 4
    adj = (_rnd(g, B, N, N) > 0).float()
    return (_rnd(g, B, N, F), _rnd(g, B, N, N, R), _rnd(g, B, 3, N, N), adj,
            _rnd(g, B, 3, N, F), _rnd(g, R, F),
            *[_rnd(g, F, F) for _ in range(4)]), (first, dot)


def _klist_args(first, edt):
    g = torch.Generator().manual_seed(2)
    B, N, K, F, R = 2, 5, 3, 8, 4
    C = F if first else 4 * F
    mask = (_rnd(g, B, N, K) > 0).float()
    return (_rnd(g, B, N, F), _rnd(g, B, N, K, C, dtype=edt),
            _rnd(g, B, N, K, R, dtype=edt), _rnd(g, B, 3, N, K), mask,
            _rnd(g, R, F), *[_rnd(g, F, F) for _ in range(4)])


OPS = {
    'pair_fwd': [(False, 'float32'), (True, 'bfloat16')],
    'pair_bwd': [(False, True, 'float32'), (True, False, 'bfloat16')],
    'klist_fwd': [(False, torch.float32), (True, torch.bfloat16)],
    'klist_bwd': [(False, True, torch.float32), (True, False,
                                                 torch.bfloat16)],
    'row_gather': [(torch.int64,), (torch.int32,)],
}


@pytest.mark.parametrize('name, case', [(n, c) for n, cases in OPS.items()
                                        for c in cases])
def test_custom_ops_pass_opcheck(name, case):
    '''torch.library.opcheck (schema, fake implementation against the real
    one, dispatch under the tracers torch.export and AOT use) on each op,
    in both variants and both modes; the op is what the wrapper calls.'''
    op = getattr(torch.ops.newtonnet_tpu_torch, name).default
    g = torch.Generator().manual_seed(3)
    if name.startswith('pair'):
        ins, (first, dot) = _pair_args(case[0], case[-1])
        B, N, F = ins[0].shape
        if name == 'pair_bwd':
            args = (*ins, _rnd(g, B, N, F), _rnd(g, B, 3, N, F), first,
                    case[1], dot)
        else:
            args = (*ins, first, dot)
    elif name.startswith('klist'):
        ins = _klist_args(case[0], case[-1])
        B, N, F = ins[0].shape
        if name == 'klist_bwd':
            args = (*ins, _rnd(g, B, N, F), _rnd(g, B, 3, N, F), case[0],
                    case[1], 'float32')
        else:
            args = (*ins, case[0], 'float32')
    else:
        big = _rnd(g, 2, 3, 6, 4)
        # a slot chunk of a larger tensor: a batch stride past N * F
        args = (big[:, 1:3].reshape(2, 12, 4)[:, :9],
                torch.randint(0, 9, (2, 7), generator=g).to(case[0]))
    torch.library.opcheck(op, args)


def test_wrappers_go_through_the_ops_with_unchanged_numbers():
    '''The wrappers call the ops: on the CPU each equals its plain version
    bitwise, weight cotangents come back split (None without them).'''
    ins, (first, dot) = _pair_args(False, 'float32')
    assert all(torch.equal(a, b) for a, b in zip(
        fd.pair_interaction_fwd(*ins), fd.pair_interaction_fwd_ref(*ins)))
    g = torch.Generator().manual_seed(4)
    cots = (_rnd(g, 2, 5, 8), _rnd(g, 2, 3, 5, 8))
    for wg in (True, False):
        got = fd.pair_interaction_bwd(*ins, *cots, weight_grads=wg)
        want = fd.pair_interaction_bwd_ref(*ins, *cots, weight_grads=wg)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    kin = _klist_args(False, torch.float32)
    got = fk.klist_bwd(*kin, *cots, weight_grads=True)
    want = fk.klist_bwd_ref(*kin, *cots, weight_grads=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fixed_degree_transpose_sums_the_same_bits():
    '''Under fixed_degree node_transpose pads to the list's capacity
    (min(R, K)) instead of reading the largest in-degree; on a list where
    no atom overflows, the transposed sum (gather_nodes' backward, with
    the fixed pad's overflow path, which then adds exact zeros) gives the
    eager request's bits.'''
    g = torch.Generator().manual_seed(6)
    pos = torch.rand(2, 9, 3, generator=g) * 7.0
    cell = torch.zeros(2, 3, 3)
    idx, mask, _, overflow = tnl.neighbor_list(
        pos, cell, torch.ones(2, 9, dtype=torch.bool), 3.0, 8)
    assert int(overflow.sum()) == 0
    y = torch.randn(2, 9, 8, 5, generator=g)
    eager = tnl.node_transpose(idx, 9, mask)
    with tnl.fixed_degree():
        fixed = tnl.node_transpose(idx, 9, mask)
    assert fixed.slots.shape == (2, 9, 8)
    assert eager.slots.shape[2] < 8
    assert torch.equal(tnl._scatter_rows(y, eager),
                       tnl._scatter_rows(y, fixed, (idx, mask)))


# ---------------------------------------------------------------- #
# export and replay


@pytest.fixture(scope='module')
def xla_case(tmp_path_factory):
    '''A kernel='xla' newton3 model (energy, forces, stress), exported
    through the plain list by both packages from one set of weights.'''
    tmp = tmp_path_factory.mktemp('xla')
    model = port_model(('energy', 'gradient_force', 'stress'),
                       n_interactions=1, graph_mode='neighborlist',
                       newton3=True, k_max=4)
    params = params_to_flax(model.core)
    path = exported(model, str(tmp / 'port.npz'), n_atoms=6, batch_size=2)
    jm = JaxNewtonNet(**model.config_dict())
    header, blob = jexport.export_inference(jm, params, n_atoms=6,
                                            batch_size=2)
    jexport.save_serving_artifact(str(tmp / 'jax.npz'), header, blob)
    return (model, params, path, str(tmp / 'jax.npz'),
            ex.ServedModel(path, device='cpu'))


def test_xla_replay_matches_the_eager_port_and_jax(xla_case):
    '''The replay (the plain list, capacity 2 * 4 + 8) against the eager
    newton3 request over its host half lists and against the eager plain
    list; the eager plain list against the JAX package's apply; K9 is in
    the program (the plain list's gather backward).'''
    model, params, _, _, served = xla_case
    assert served.header['model_config']['k_max'] == 16
    assert not served.header['model_config']['newton3']
    assert 'newtonnet_tpu_torch.row_gather.default' in graph_ops(served)
    z, pos, cell = frames()
    got = {k: v.numpy() for k, v in served.call_raw(
        np.pad(z, ((0, 0), (0, 2))), np.pad(pos, ((0, 0), (0, 2), (0, 0))),
        cell).items()}
    got = {k: v[:, :6] if v.ndim == 3 and k != 'stress' else v
           for k, v in got.items()}
    t = tuple(torch.from_numpy(a) for a in (z, pos, cell))
    n3 = port_out(model, z, pos, cell,
                  nlist=host_symmetric_nlist(model, *t, skin=0.0))
    plain = ex._plain_list_model(model)
    eager = port_out(plain, z, pos, cell)
    keys = ('energy', 'gradient_force', 'stress')
    assert_close(got, n3, keys)
    assert_close(got, eager, keys)
    assert_close(eager, jax_apply(plain, params, z, pos, cell), keys)


def test_port_served_model_matches_the_jax_served_model(xla_case):
    '''Both ServedModels of the same weights: one system (padded), a list
    of systems with per-system cells (one periodic, one not) and with one
    shared cell; the same keys and shapes, values at the bars.'''
    _, _, _, jax_path, mine = xla_case
    theirs = jexport.ServedModel(jax_path)
    z, pos, cell = frames(seed=1)
    n = [6, 5]
    systems = ([z[0][:n[0]], z[1][:n[1]]], [pos[0][:n[0]], pos[1][:n[1]]])
    cases = [((z[0][:5], pos[0][:5], cell[0]), True),
             (systems + ([cell[0], np.zeros((3, 3), np.float32)],), False),
             (systems + (cell[1],), False)]
    for args, single in cases:
        got, want = mine(*args), theirs(*args)
        for g, w in ([(got, want)] if single else zip(got, want)):
            assert sorted(g) == sorted(w)
            for key in g:
                assert np.shape(g[key]) == np.shape(w[key]), key
            assert_close(g, w, ('energy', 'gradient_force', 'stress'))


def test_refusals(xla_case, tmp_path):
    '''A JAX artifact in the port's ServedModel names both formats, and a
    port artifact in the JAX one is refused; too many atoms or systems, a
    newer version, a device the artifact was not captured for, the default
    device without CUDA; export of a head the model lacks, a matmul
    precision other than 'highest', a platform other than the model's.'''
    model, _, path, jax_path, served = xla_case
    with pytest.raises(ValueError, match='newtonnet-tpu-serving.*'
                       'newtonnet-tpu-torch-serving'):
        ex.ServedModel(jax_path, device='cpu')
    with pytest.raises(ValueError, match='not a newtonnet-tpu-serving'):
        jexport.ServedModel(path)
    z, pos, _ = frames()
    with pytest.raises(ValueError, match='exported shapes'):
        served.call_raw(z, pos, np.zeros((2, 3, 3), np.float32))
    with pytest.raises(ValueError, match='exported capacity 8'):
        served(np.ones(9, np.int64), np.zeros((9, 3), np.float32))
    with pytest.raises(ValueError, match='exported batch_size 2'):
        served([z[0]] * 3, [pos[0]] * 3)
    with np.load(path) as f:
        header, blob = json.loads(str(f['header'][()])), f['blob']
    for change, err, text in (({'version': 2}, ValueError, 'newer'),
                              ({'platforms': ['cuda']}, ValueError,
                               'captured for')):
        p = str(tmp_path / 'changed.npz')
        np.savez(p, header=np.asarray(json.dumps({**header, **change})),
                 blob=blob)
        with pytest.raises(err, match=text):
            ex.ServedModel(p, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex.ServedModel(path)
    with pytest.raises(ValueError, match='no output head'):
        ex.export_inference(model, n_atoms=6, properties=['hessian'])
    with pytest.raises(ValueError, match='is not available'):
        ex.export_inference(model, n_atoms=6, matmul_precision='high')
    with pytest.raises(ValueError, match='captured on'):
        ex.export_inference(model, n_atoms=6, platforms=['cuda'])


def test_replay_in_a_fresh_process(pallas_case):
    '''A fresh interpreter replays an artifact with the export module
    alone: no model module and no JAX is imported, and the outputs equal
    this process's replay bit for bit.'''
    _, path, served = pallas_case['dense']
    z, pos, cell = frames(N=8, periodic=False)
    code = textwrap.dedent(f'''
        import json, sys
        import numpy as np
        from newtonnet_tpu_torch.utils.export import ServedModel
        served = ServedModel({path!r}, device='cpu')
        out = served.call_raw(np.asarray({z.tolist()}),
                              np.asarray({pos.tolist()}, np.float32),
                              np.asarray({cell.tolist()}, np.float32))
        bad = sorted(m for m in sys.modules
                     if m.startswith('newtonnet_tpu_torch.models')
                     or m.split('.')[0] in ('jax', 'jaxlib', 'flax')
                     or m.split('.')[0] == 'newtonnet_tpu')
        print(json.dumps({{'bad': bad, 'out': {{
            k: v.numpy().tolist() for k, v in out.items()}}}}))
    ''')
    run = subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got['bad'] == []
    for key, value in served.call_raw(z, pos, cell).items():
        np.testing.assert_array_equal(np.asarray(got['out'][key],
                                                 np.float32), value.numpy())


@pytest.fixture(scope='module')
def pallas_case(tmp_path_factory):
    '''kernel='pallas' models (F=32), dense (K1/K2) and over K-lists
    (K5/K6, K9 in the gather backward), one artifact each.'''
    tmp = tmp_path_factory.mktemp('pallas')
    cases = {}
    for layout, kw in (('dense', {}),
                       ('klist', dict(graph_mode='neighborlist', k_max=5))):
        model = port_model(kernel='pallas', n_features=32, **kw)
        path = exported(model, str(tmp / f'{layout}.npz'), n_atoms=6,
                        batch_size=2)
        cases[layout] = (model, path, ex.ServedModel(path, device='cpu'))
    return cases


@pytest.mark.parametrize('layout, ops', [
    ('dense', {'pair_fwd', 'pair_bwd'}),
    ('klist', {'klist_fwd', 'klist_bwd', 'row_gather'})])
def test_pallas_replay_matches_the_eager_port_and_jax(pallas_case, layout,
                                                      ops):
    '''The replay against the eager model, the eager model against the
    JAX package's apply of the same weights; the program calls the
    layer's ops; the replay pins IEEE fp32 products whatever TF32 flag
    the caller set, and restores it.'''
    model, _, served = pallas_case[layout]
    assert graph_ops(served) == {f'newtonnet_tpu_torch.{o}.default'
                                 for o in ops}
    z, pos, cell = frames(periodic=False)
    pad = ((0, 0), (0, 2))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        raw = served.call_raw(np.pad(z, pad),
                              np.pad(pos, pad + ((0, 0),)), cell)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got = {'energy': raw['energy'].numpy(),
           'gradient_force': raw['gradient_force'].numpy()[:, :6]}
    eager = port_out(model, z, pos, cell)
    assert_close(got, eager)
    assert_close(eager, jax_apply(model, params_to_flax(model.core), z, pos,
                                  cell, kernel='xla'))


def test_hessian_artifact_matches_the_eager_hessian(tmp_path):
    '''The Hessian head (vmap of jvp of grad, through the list Functions'
    vmap rules and K9) captured over the plain list and replayed: within
    1e-4 of the largest entry of the eager Hessian, which
    tests/test_torch_hessian.py holds to the JAX package's.'''
    model = port_model(('energy', 'gradient_force', 'hessian'),
                       n_features=8, n_basis=4, n_interactions=1,
                       graph_mode='neighborlist', k_max=3)
    path = exported(model, str(tmp_path / 'h.npz'), n_atoms=4,
                    batch_size=2)
    served = ex.ServedModel(path, device='cpu')
    assert 'newtonnet_tpu_torch.row_gather.default' in graph_ops(served)
    z, pos, cell = frames(N=4)
    got = served([z[0], z[1][:3]], [pos[0], pos[1][:3]], cell[0])
    eager = port_out(model, z, pos, cell)['hessian']
    bar = 1e-4 * np.abs(eager).max()
    np.testing.assert_allclose(got[0]['hessian'], eager[0], rtol=0,
                               atol=bar)
    np.testing.assert_allclose(got[1]['hessian'], eager[1, :3, :, :3],
                               rtol=0, atol=bar)
    assert got[1]['hessian'].shape == (3, 3, 3, 3)


def test_export_model_command(tmp_path, capsys):
    '''python -m newtonnet_tpu_torch.utils.export_model writes an artifact
    of a checkpoint and prints the JAX script's line; --periodic resolves
    a charge head's ewald_mode 'auto' to the periodic branch (in the
    header), and the replay gives the eager periodic model's energy and
    charges.'''
    from newtonnet_tpu_torch.utils.checkpoint import save_model
    from newtonnet_tpu_torch.utils.export_model import main
    model = port_model(('energy', 'charge'), n_features=8, n_interactions=1,
                       ewald_n_k=2)
    assert model.ewald_mode == 'auto'
    ckpt, out = str(tmp_path / 'm.msgpack'), str(tmp_path / 'a.npz')
    save_model(ckpt, model)
    main(['--checkpoint', ckpt, '--n-atoms', '5', '--out', out, '--batch',
          '2', '--device', 'cpu', '--periodic'])
    line = capsys.readouterr().out
    assert line.startswith(f'wrote {out}: ') and 'n_pad=8' in line
    assert "properties=['energy', 'charge']" in line
    assert "platforms=['cpu']" in line
    served = ex.ServedModel(out, device='cpu')
    assert served.header['model_config']['ewald_mode'] == 'periodic'
    z, pos, cell = frames(N=5)
    got = served([z[0], z[1]], [pos[0], pos[1]], cell[0])
    want = port_out(model.with_ewald_mode('periodic'), z, pos, cell)
    for i in range(2):
        assert abs(got[i]['energy'] - want['energy'][i]) <= E_ATOL
        np.testing.assert_allclose(got[i]['charge'], want['charge'][i],
                                   rtol=0, atol=F_ATOL)
