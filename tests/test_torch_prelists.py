'''Precomputed neighbour lists in the port (data/prelists.py, the
precompute_nlist hook of data/pipeline.py, collate's list padding and the
Trainer's list feeding and checks) against the JAX package, on the CPU.

* The host cell list (csrc/host/celllist.cpp) and frame_neighbor_lists in
  modes plain, inverse and newton3 give the JAX package's native lists
  bit for bit.
* NeighborListDataset: list keys on every sample; newton3c's samples
  (chunks, permuted per-atom arrays, the plan fixed by the first frame
  read, the overflow text) equal the JAX dataset's bit for bit; collate
  pads the lists.
* Three Trainer steps of a newton3 model over precompute_nlist mode
  newton3, and of an inverse_lists model over mode inverse, against the
  JAX Trainer on the same batches (tests/test_torch_xla_training.py's
  bars: metrics at rtol 2e-5, parameters at atol 2e-6); a newton3_compact
  model over newton3c batches against the newton3 model (float64,
  1e-10); the Trainer's refusals of a list mode that does not match the
  model, with the JAX Trainer's text.
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu import native
from newtonnet_tpu.data import prelists as jpre
from newtonnet_tpu.data.loader import PaddedLoader as JaxPaddedLoader
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train import optimizer as jopt
from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
from newtonnet_tpu_torch import NewtonNet, Trainer
from newtonnet_tpu_torch.data import prelists as tpre
from newtonnet_tpu_torch.data.loader import PaddedLoader, Sample, collate
from newtonnet_tpu_torch.train import optimizer as topt
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.utils.params import params_from_flax

EF = {'energy': {'weight': 1.0, 'mode': 'mse'},
      'gradient_force': {'weight': 50.0, 'mode': 'mse'}}


class Frames(list):
    '''Samples with the dataset attributes the loaders read.'''
    precision = np.float32

    @property
    def max_atoms(self):
        return max(len(s['z']) for s in self)


def frames(n=8, seed=0, L=8.0, n_min=10, n_max=14):
    rs = np.random.RandomState(seed)
    out = Frames()
    for _ in range(n):
        k = rs.randint(n_min, n_max + 1)
        out.append(Sample(
            z=rs.choice([1, 6, 8], size=k).astype(np.int32),
            pos=(rs.rand(k, 3) * L).astype(np.float32),
            cell=(np.eye(3) * L).astype(np.float32),
            energy=np.float32(rs.randn()),
            force=rs.randn(k, 3).astype(np.float32)))
    return out


def _native():
    if not (native.available() or native.ensure_built()):
        pytest.skip('the JAX package\'s native library does not build here')


@pytest.mark.parametrize('periodic', [True, False])
def test_cell_list_equals_the_native_one(periodic):
    _native()
    rs = np.random.RandomState(1)
    L = 14.0
    pos = rs.rand(200, 3) * L
    cell = np.eye(3) * L if periodic else None
    got = tpre.cell_list_neighbors(pos, cell, 4.5, 48)
    want = native.cell_list_neighbors(pos, cell, 4.5, 48)
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a, b)
    assert got[2] == want[2]


@pytest.mark.parametrize('mode, k', [('plain', 24), ('inverse', 24),
                                     ('newton3', 12)])
def test_frame_lists_equal_the_jax_packages(mode, k):
    '''Padding atoms (z == 0 at the end) get no edges; mode newton3
    builds its full list at 2k+8.'''
    _native()
    s = frames(1, seed=2, n_min=14, n_max=14)[0]
    z = np.concatenate([s['z'], [0, 0]])
    pos = np.concatenate([s['pos'], np.zeros((2, 3), np.float32)])
    got = tpre.frame_neighbor_lists(z, pos, s['cell'], 5.0, k, mode=mode)
    want = jpre.frame_neighbor_lists(z, pos, s['cell'], 5.0, k, mode=mode)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                               want[1])
    assert not got[1][-2:].any()
    with pytest.raises(ValueError, match='unknown mode'):
        tpre.frame_neighbor_lists(z, pos, s['cell'], 5.0, k, mode='bogus')


def test_datasets_and_collate():
    data = frames(4, seed=3)
    ds = tpre.NeighborListDataset(data, cutoff=5.0, k_max=12, mode='newton3')
    batch = collate([ds[i] for i in range(3)], n_pad=16, batch_pad=4)
    assert batch['nlist_idx'].shape == (4, 16, 12)
    assert batch['nlist_mask'].dtype == bool
    assert not batch['nlist_mask'][3].any()
    n0 = len(data[0]['z'])
    assert not batch['nlist_mask'][0, n0:].any()
    with pytest.raises(ValueError, match='mixed batch'):
        collate([ds[0], data[1]], n_pad=16)
    st = tpre.NeighborListDataset(data, cutoff=5.0, k_max=12,
                                  mode='newton3c', stair_chunk=3,
                                  stair_pad=2, stair_margin=2)
    samples = [st[i] for i in range(4)]
    widths = [tuple(ch[0].shape for ch in s['nlist_stair'])
              for s in samples]
    assert len(set(widths)) == 1     # one plan for every frame
    sl = st._cache[1]
    assert np.array_equal(samples[1]['pos'], data[1]['pos'][sl.perm])
    assert np.array_equal(samples[1]['energy'], data[1]['energy'])
    b = collate(samples[:2], n_pad=16)
    assert len(b['nlist_stair']) == len(widths[0])


def test_newton3c_samples_equal_the_jax_datasets():
    '''mode newton3c over frames of 8 to 16 atoms in one cell (densities
    apart by 2x), each with a per-atom charge: every sample's chunks and
    permuted arrays (z, pos, force, charge) equal the JAX package's
    NeighborListDataset's bit for bit, with the plan fixed by the first
    frame read; a frame beyond that plan raises the JAX text in both.'''
    _native()
    data = frames(6, seed=7, n_min=8, n_max=16)
    for k, smp in enumerate(data):
        smp['charge'] = np.linspace(-1, 1, len(smp['z'])).astype(np.float32)
    kw = dict(cutoff=5.0, k_max=12, mode='newton3c', stair_chunk=3,
              stair_pad=2, stair_margin=8)
    got_ds = tpre.NeighborListDataset(data, **kw)
    want_ds = jpre.NeighborListDataset(data, **kw)
    for i in (2, 0, 5, 1, 4, 3):
        got, want = got_ds[i], want_ds[i]
        for key in ('z', 'pos', 'force', 'charge', 'cell', 'energy'):
            assert np.array_equal(got[key], want[key]), key
        assert len(got['nlist_stair']) == len(want['nlist_stair'])
        for gc, wc in zip(got['nlist_stair'], want['nlist_stair']):
            for a, b in zip(gc, wc):
                assert np.array_equal(np.asarray(a), np.asarray(b))
    assert got_ds._stair_plan == want_ds._stair_plan
    tight = dict(kw, stair_margin=0, stair_extra_colors=0)
    texts = []
    for mod in (tpre, jpre):
        ds = mod.NeighborListDataset(data, **tight)
        ds[0]
        with pytest.raises(ValueError, match='shape plan fixed') as e:
            for i in range(len(data)):
                ds[i]
        texts.append(str(e.value))
    assert texts[0] == texts[1]


def _steps(cfg, mode, data, steps=3):
    '''Three steps of both Trainers over NeighborListDataset batches of
    `mode`, from one set of parameters: -> per step ((port metrics, port
    parameters), (JAX metrics, JAX parameters)).'''
    jm = JaxNewtonNet(**cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                     jnp.asarray(np.random.RandomState(0).randn(1, 4, 3),
                                 jnp.float32), jnp.zeros((1, 3, 3)))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    kw = dict(cutoff=cfg['cutoff'], k_max=cfg['k_max'], mode=mode)
    jt = JaxTrainer(jm, params, loss_fns=jax_loss(EF),
                    optimizer=jopt.get_optimizer_by_string(
                        'sgd', clip_grad=1.0, lr=1e-2, momentum=0.9),
                    train_generator=JaxPaddedLoader(
                        jpre.NeighborListDataset(data, **kw), 4,
                        shuffle=True, n_pad=16),
                    steps_per_call=1)
    tm = NewtonNet(**cfg, device='cpu')
    params_from_flax(params, core=tm.core)
    tt = Trainer(tm, loss_fns=get_loss_by_string(EF),
                 optimizer=topt.get_optimizer_by_string(
                     'sgd', tm.core, clip_grad=1.0, lr=1e-2, momentum=0.9),
                 train_generator=PaddedLoader(
                     tpre.NeighborListDataset(data, **kw), 4, shuffle=True,
                     n_pad=16))
    names = ['loss'] + jt._eval_metric_names() + ['edges']
    out = []
    for _, bj, bt in zip(range(steps), jt.train_generator,
                         tt.train_generator):
        for key in bj:
            np.testing.assert_array_equal(bt[key], bj[key])
        totals = {n: jnp.zeros((), jnp.float32) for n in names}
        jt.params, jt.opt_state, totals = jt._train_step(
            jt.params, jt.opt_state, totals, bj)
        metrics = tt.train_step(bt)
        leaves = jax.tree_util.tree_flatten_with_path(
            jax.device_get(jt.params)['params'])[0]
        want = {'.'.join(k.key for k in path): np.asarray(v)
                for path, v in leaves}
        out.append((({n: float(v) for n, v in metrics.items()},
                     {n: p.detach().numpy().copy()
                      for n, p in tm.core.named_parameters()}),
                    ({n: float(totals[n]) for n in names}, want)))
    return out


@pytest.mark.parametrize('mode', ['newton3', 'inverse'])
def test_trainer_steps_over_precomputed_lists_match_jax(mode):
    _native()
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=2,
               output_properties=['energy', 'gradient_force'],
               graph_mode='neighborlist', k_max=12 if mode == 'newton3'
               else 24, newton3=mode == 'newton3',
               inverse_lists=mode == 'inverse')
    for k, ((m_t, p_t), (m_j, p_j)) in enumerate(
            _steps(cfg, mode, frames(12, seed=4))):
        for n in m_j:
            np.testing.assert_allclose(m_t[n], m_j[n], rtol=2e-5,
                                       err_msg=f'{n} step {k}')
        for n in p_j:
            np.testing.assert_allclose(p_t[n], p_j[n], atol=2e-6,
                                       err_msg=f'{n} step {k}')


def test_newton3c_training_step_matches_newton3():
    '''One standard step's loss and parameter gradient over newton3c
    batches (staircase chunks, frames permuted) equal a newton3 model's
    over newton3 batches of the same frames, in float64 at 1e-10.'''
    data = frames(4, seed=5)
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=2,
               output_properties=['energy', 'gradient_force'],
               graph_mode='neighborlist', k_max=12)
    out = {}
    for mode, layout in (('newton3', {'newton3': True}),
                         ('newton3c', {'newton3_compact': True})):
        model = NewtonNet(**cfg, **layout, device='cpu', dtype=torch.float64,
                          generator=torch.Generator().manual_seed(0))
        ds = tpre.NeighborListDataset(data, 5.0, 12, mode=mode,
                                      stair_chunk=3, stair_pad=2)
        batch = collate([ds[i] for i in range(4)], n_pad=16,
                        dtype=np.float64)
        t = Trainer(model, loss_fns=get_loss_by_string(EF))
        b = t._to_device(batch)
        t._check_batch_nlist(batch)
        loss, _ = t.loss_and_grad(b)
        out[mode] = (float(loss), torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
            for p in model.core.parameters()]))
    assert out['newton3c'][0] == pytest.approx(out['newton3'][0], rel=1e-10)
    g3, gc = out['newton3'][1], out['newton3c'][1]
    assert float((gc - g3).abs().max()) <= 1e-10 * float(g3.abs().max())


def test_trainer_refuses_a_list_mode_that_does_not_match():
    '''The JAX Trainer's checks: plain lists to a newton3 model, lists
    that are no involution to an inverse_lists model, and staircase
    batches paired with anything but a newton3_compact model.'''
    data = frames(4, seed=6)
    common = dict(cutoff=5.0, n_features=8, n_basis=4, n_interactions=1,
                  output_properties=['energy', 'gradient_force'],
                  graph_mode='neighborlist', device='cpu')
    plain = collate([tpre.NeighborListDataset(data, 5.0, 24)[i]
                     for i in range(2)], n_pad=16)
    half = collate([tpre.NeighborListDataset(data, 5.0, 12,
                                             mode='newton3')[i]
                    for i in range(2)], n_pad=16)
    stair_ds = tpre.NeighborListDataset(data, 5.0, 12, mode='newton3c')
    stair = collate([stair_ds[i] for i in range(2)], n_pad=16)
    cases = [(dict(newton3=True, k_max=24), plain, 'reciprocal edge'),
             (dict(inverse_lists=True, k_max=24), half, 'symmetric-slotted'),
             (dict(k_max=24), stair, 'newton3_compact models pair'),
             (dict(newton3_compact=True, k_max=12), half,
              'newton3_compact models pair')]
    for layout, batch, text in cases:
        t = Trainer(NewtonNet(**common, **layout),
                    loss_fns=get_loss_by_string(EF))
        with pytest.raises(ValueError, match=text):
            t.run_one_epoch([batch], step=True)
