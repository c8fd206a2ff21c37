'''The port's on-device MD drivers (newtonnet_tpu_torch/md/driver.py)
against the JAX package's, on the CPU, at small widths.

* The Langevin step, fed the xi / eta that the JAX host Langevin draws,
  follows its trajectory within 1e-10 over 10 steps (float64), padding
  atoms held at rest.
* friction=0 run_langevin_on_device (velocity Verlet: no noise enters)
  and run_nhc_on_device follow the JAX drivers within 1e-5 A over 10
  float32 steps, dense and over plain lists with on-device cell-grid
  rebuilds.
* The inverse-list, newton3 and staircase host-rebuild modes follow the
  port's plain-list driver (tests/test_md.py:324-410's checks), the
  staircase's positions back in the input's atom order.
* Both list-quality counters equal the JAX package's on the cases of
  tests/test_md.py:268 and :412, and warn.
* Replica lists give per-replica logs of the JAX shapes.

`python tests/test_torch_md_driver.py lj-newton3` (about a minute on the
CPU) runs the JAX package's newton3 MD of the trained LJ checkpoint that
chip_smoke.py phase 15c holds the port to, writes its final positions
and energies to tests/reference/jax_md_lj_newton3.npz and prints
JAX_MD_LJ_NEWTON3_*.
'''
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == '__main__':  # the card recipe, run as a script
    sys.path.insert(0, ROOT)

from newtonnet_tpu.md import driver as jax_driver
from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
from newtonnet_tpu.md.integrators import Langevin as JaxLangevin
from newtonnet_tpu.md.system import System as JaxSystem
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.ops.nlist import neighbor_list as jax_neighbor_list
from newtonnet_tpu_torch import NewtonNet
from newtonnet_tpu_torch.data import units
from newtonnet_tpu_torch.md import driver
from newtonnet_tpu_torch.md.system import System, maxwell_boltzmann
from newtonnet_tpu_torch.utils.params import params_from_flax

OUTS = ['energy', 'gradient_force']



def _jax_params(cfg, z, pos, cell, seed=0, scale=None):
    model = JaxNewtonNet(**cfg, output_properties=OUTS)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(z),
                        jnp.asarray(pos, jnp.float32),
                        jnp.asarray(cell, jnp.float32))
    if scale is not None:
        params = jax.tree.map(lambda x: x * scale, params)
    return model, params


def _port(cfg, params=None, dtype=torch.float32, **changes):
    model = NewtonNet(**dict(cfg, **changes), output_properties=OUTS,
                      device='cpu', dtype=dtype)
    if params is not None:
        params_from_flax(params, core=model.core)
    return model.requires_grad_(False)


def _aspirin():
    from newtonnet_tpu_torch.data.xyz import read_extxyz
    return read_extxyz(os.path.join(ROOT, 'data', 'md17_aspirin',
                                    'ccsd_test', 'raw',
                                    'aspirin_ccsd-test.xyz'))[0]


def _box(pkg_system, n=128, L=20.0, seed=0, temperature=300.0):
    rs = np.random.RandomState(seed)
    numbers = rs.choice([1, 6, 8], n)
    s = pkg_system(numbers, rs.rand(n, 3) * L, cell=np.diag([L, L, L]),
                   pbc=[True] * 3)
    s.set_momenta(np.random.default_rng(seed).standard_normal((n, 3))
                  * np.sqrt(units.kB * temperature * s.masses)[:, None])
    return s


class _Recorder:
    '''A numpy Generator that records its standard_normal draws.'''

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.draws = []

    def standard_normal(self, shape):
        x = self.rng.standard_normal(shape)
        self.draws.append(x)
        return x


def test_langevin_step_follows_the_jax_host_langevin():
    '''The port's step function, fed the xi and eta the JAX host Langevin
    draws (float64 model, JAX calculator in float64), follows the host
    trajectory within 1e-10 A over 10 steps; padding atoms (mass 1) keep
    exactly zero velocity.'''
    frame = _aspirin()
    n = len(frame.numbers)
    cfg = dict(n_features=16, n_basis=6, n_interactions=2)
    z = np.zeros((1, 24), np.int64)
    z[0, :n] = frame.numbers
    pos = np.zeros((1, 24, 3))
    pos[0, :n] = frame.positions
    jmodel, params = _jax_params(cfg, z, pos, np.zeros((1, 3, 3)))
    host = JaxSystem(frame.numbers, frame.positions)
    host.momenta = np.random.default_rng(3).standard_normal((n, 3)) * 0.3
    mom0 = host.momenta.copy()
    host.calc = JaxCalc(model=jmodel, params=params,
                        properties=['energy', 'forces'], precision='float64')
    rec = _Recorder(5)
    kw = dict(timestep=0.5 * units.fs, temperature_K=300.0,
              friction=1 / (20 * units.fs))
    dyn = JaxLangevin(host, rng=rec, **kw)
    traj = []
    dyn.attach(lambda s, t: traj.append(s.positions.copy()))
    dyn.run(10)

    model = _port(cfg, params, dtype=torch.float64)
    masses = np.ones((1, 24))
    masses[0, :n] = host.masses
    zt, mt = torch.from_numpy(z), torch.from_numpy(masses)
    cell = torch.zeros((1, 3, 3), dtype=torch.float64)
    p = torch.from_numpy(pos)
    v = torch.zeros((1, 24, 3), dtype=torch.float64)
    v[0, :n] = torch.from_numpy(mom0 / host.masses[:, None])
    _, f = driver._energy_forces(model, zt, p, cell)
    state = (p, v, f)
    for k in range(10):
        noise = []
        for draw in rec.draws[2 * k:2 * k + 2]:
            x = torch.zeros((1, 24, 3), dtype=torch.float64)
            x[0, :n] = torch.from_numpy(draw)
            noise.append(x)
        state, epot, ekin = driver.langevin_step(
            model, zt, mt, cell, state, *noise, dt=kw['timestep'],
            temp=units.kB * 300.0, friction=kw['friction'])
        np.testing.assert_allclose(state[0][0, :n].numpy(), traj[k + 1],
                                   rtol=0, atol=1e-10)
    assert torch.equal(state[1][0, n:], torch.zeros_like(state[1][0, n:]))
    assert torch.equal(state[0][0, n:], p[0, n:])
    np.testing.assert_allclose(state[1][0, :n].numpy() * host.masses[:, None],
                               host.momenta, rtol=0, atol=1e-10)


def _jax_run(kind, jmodel, params, s, **kw):
    fn = (jax_driver.run_langevin_on_device if kind == 'langevin'
          else jax_driver.run_nhc_on_device)
    return fn(jmodel, params, s, **kw)


def _driver_kw(kind):
    kw = dict(timestep=0.25 * units.fs, temperature_K=300.0, n_steps=10,
              log_every=2)
    if kind == 'langevin':
        kw['friction'] = 0.0
    else:
        kw['tdamp'] = 10 * units.fs
    return kw


@pytest.mark.parametrize('kind', ['langevin', 'nhc'])
@pytest.mark.parametrize('layout', ['dense', 'cellgrid'])
def test_drivers_follow_the_jax_drivers(kind, layout):
    '''friction=0 Langevin (deterministic: velocity Verlet) and the NHC
    driver against the JAX drivers in float32, 10 steps: two aspirin
    replicas over the dense graph, and a 128-atom box over plain lists
    rebuilt every 5 steps by the cell grid (skin 1 A). Positions within
    1e-5 A, energies within 1e-4 eV, the same log keys and shapes, both
    counters 0.'''
    if layout == 'dense':
        frame = _aspirin()
        cfg = dict(n_features=16, n_basis=6, n_interactions=2)

        def systems(pkg):
            out = []
            for k in range(2):
                s = pkg(frame.numbers, frame.positions + 0.01 * k)
                maxwell_boltzmann(s, 300.0, rng=np.random.default_rng(k))
                out.append(s)
            return out
        z = np.asarray(frame.numbers)[None]
        jmodel, params = _jax_params(cfg, z, frame.positions[None],
                                     np.zeros((1, 3, 3)))
        extra = {}
    else:
        cfg = dict(n_features=8, n_basis=4, n_interactions=1,
                   graph_mode='neighborlist', k_max=48)

        def systems(pkg):
            return [_box(pkg)]
        s = _box(System)
        jmodel, params = _jax_params(cfg, s.numbers[None], s.positions[None],
                                     s.cell[None])
        extra = dict(nlist_every=5, skin=1.0)
        assert min(driver.suggest_grid(s.cell, 6.0)) >= 3  # the grid path
    kw = dict(_driver_kw(kind), **extra)
    mine, log = (driver.run_langevin_on_device if kind == 'langevin'
                 else driver.run_nhc_on_device)(_port(cfg), params,
                                                systems(System), **kw)
    theirs, jlog = _jax_run(kind, jmodel, params, systems(JaxSystem), **kw)
    assert set(log) >= set(jlog) and log['epot'].shape == jlog['epot'].shape
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.positions, b.positions, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(a.momenta, b.momenta, rtol=0, atol=1e-4)
    for key in ('epot', 'ekin') + (('conserved',) if kind == 'nhc' else ()):
        np.testing.assert_allclose(log[key], jlog[key], rtol=0, atol=1e-4)
    assert log['nlist_overflow'] == 0 and log['skin_violations'] == 0
    assert not np.allclose(mine[0].positions, systems(System)[0].positions)


def _lj_like_box(seed=1, n=48):
    rs = np.random.RandomState(seed)
    L = (n / 0.02) ** (1 / 3)
    cell = np.diag([L, L, L])
    return rs.choice([1, 1, 8], size=n), rs.rand(n, 3) @ cell, cell


@pytest.mark.parametrize('mode', ['inverse', 'newton3', 'staircase'])
def test_host_rebuild_modes_follow_the_plain_list_driver(mode):
    '''Host-rebuild MD (symmetric-slotted inverse lists, newton3 half lists,
    staircase chunks with their per-rebuild re-sorts) integrates the
    trajectory of the all-on-device driver over plain lists (the same
    weights, rebuild cadence and skin): positions within 1e-5 A in the
    input's atom order, energies within 1e-4 eV, both counters 0. The
    staircase runs at friction 0: its noise is drawn in sorted order.'''
    numbers, pos, cell = _lj_like_box()
    friction = 0.0 if mode == 'staircase' else 0.02

    def fresh():
        s = System(numbers, pos.copy(), cell=cell, pbc=[True] * 3)
        maxwell_boltzmann(s, 300.0, rng=np.random.default_rng(0))
        return s
    torch.manual_seed(0)
    plain = _port(dict(n_features=8, n_basis=4, n_interactions=2,
                       graph_mode='neighborlist', k_max=40))
    layout = {'inverse': dict(inverse_lists=True),
              'newton3': dict(newton3=True, k_max=24),
              'staircase': dict(newton3_compact=True, k_max=24)}[mode]
    cfg = plain.config_dict()
    del cfg['output_properties']
    model = _port(cfg, **layout)
    model.load_state_dict(plain.state_dict())
    kw = dict(timestep=0.5 * units.fs, temperature_K=300.0,
              friction=friction, n_steps=10, log_every=1, nlist_every=5,
              seed=0)
    ref, ref_log = driver.run_langevin_on_device(plain, None, fresh(), **kw)
    s, log = driver.run_langevin_on_device(model, None, fresh(), **kw)
    np.testing.assert_allclose(s.positions, ref.positions, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(s.momenta, ref.momenta, rtol=0, atol=1e-4)
    np.testing.assert_allclose(log['epot'], ref_log['epot'], rtol=0,
                               atol=1e-4)
    assert log['nlist_overflow'] == 0 and log['skin_violations'] == 0
    assert np.abs(s.positions - pos).max() > 1e-4
    if mode == 'staircase':
        # the staircase runs needed a re-sort: compact lists are not the
        # input order, yet the results come back in it
        plan = {}
        _, perm = driver.host_staircase_nlist(
            model, numbers[None], pos[None], cell[None], 1.0, plan)
        assert not np.array_equal(perm[0], np.arange(len(numbers)))
        with pytest.raises(ValueError, match='host-rebuild mode'):
            driver.run_langevin_on_device(model, None, fresh(),
                                          **dict(kw, nlist_every=0))
        with pytest.raises(ValueError, match='newton3_compact'):
            driver.run_nhc_on_device(model, None, fresh(),
                                     timestep=0.5 * units.fs,
                                     temperature_K=300.0,
                                     tdamp=10 * units.fs, n_steps=10,
                                     nlist_every=5)


def test_overflow_counter_equals_the_jax_count():
    '''tests/test_md.py:268's case: an undersized k_max (24) reports
    exactly the overflow count of the list at the rebuild positions, the
    JAX neighbor_list's count there (what the JAX driver reports), and
    warns; an ample k_max (127) reports 0 and 0 with no warning.'''
    rs = np.random.RandomState(3)
    N, L, skin = 128, 12.0, 1.0
    numbers = rs.choice([1, 6, 8], N)
    pos0 = rs.rand(N, 3) * L
    cell = np.diag([L, L, L])
    _, _, _, ovf = jax_neighbor_list(
        jnp.asarray(pos0, jnp.float32)[None], jnp.asarray(cell)[None],
        jnp.ones((1, N), bool), 5.0 + skin, 24)
    expected = int(np.sum(np.asarray(ovf)))
    assert expected > 0
    cfg = dict(n_features=8, n_basis=4, n_interactions=1,
               graph_mode='neighborlist')
    _, params = _jax_params(dict(cfg, k_max=24), numbers[None], pos0[None],
                            cell[None])

    def run(k_max):
        s = System(numbers, pos0.copy(), cell=cell)
        maxwell_boltzmann(s, 300, rng=np.random.default_rng(0))
        return driver.run_langevin_on_device(
            _port(cfg, k_max=k_max), params, s, timestep=0.25 * units.fs,
            temperature_K=300, friction=1 / (100 * units.fs), n_steps=4,
            log_every=2, nlist_every=4, skin=skin)

    with pytest.warns(UserWarning, match='list quality'):
        _, log = run(24)
    assert log['nlist_overflow'] == expected
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        _, log2 = run(127)
    assert log2['nlist_overflow'] == 0 and log2['skin_violations'] == 0


def test_skin_violation_counter_equals_the_jax_count():
    '''tests/test_md.py:412's case (nearly free atoms at 600 K, skin 1e-3
    A, two chunks of 20 steps): the port's count of chunks in which an
    atom moved past skin/2 equals the JAX driver's, and the driver warns
    naming skin/2.'''
    numbers, pos, cell = _lj_like_box(seed=2, n=24)

    def fresh(pkg):
        s = pkg(numbers, pos.copy(), cell=cell, pbc=[True] * 3)
        maxwell_boltzmann(s, 600.0, rng=np.random.default_rng(0))
        return s
    cfg = dict(n_features=8, n_basis=4, n_interactions=1,
               graph_mode='neighborlist', k_max=23)
    jmodel, params = _jax_params(cfg, numbers[None], pos[None], cell[None],
                                 scale=0.01)
    kw = dict(timestep=2.0 * units.fs, temperature_K=600, friction=0.02,
              n_steps=40, log_every=10, nlist_every=20, skin=1e-3)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        _, log = driver.run_langevin_on_device(_port(cfg), params,
                                               fresh(System), **kw)
        _, jlog = jax_driver.run_langevin_on_device(jmodel, params,
                                                    fresh(JaxSystem), **kw)
    assert log['skin_violations'] == jlog['skin_violations'] > 0
    assert log['nlist_overflow'] == jlog['nlist_overflow']
    assert sum('skin/2' in str(x.message) for x in w) == 2


def test_replica_lists_give_per_replica_logs():
    '''A list of Systems runs as replicas with independent noise: logs
    (n_logged, M) as the JAX driver's, a single System's (n_logged,),
    every System written back with finite state; the two drivers' logs
    carry the JAX keys.'''
    frame = _aspirin()
    torch.manual_seed(1)
    model = _port(dict(n_features=8, n_basis=4, n_interactions=1))
    systems = []
    for i in range(4):
        s = System(frame.numbers[:5], frame.positions[:5])
        maxwell_boltzmann(s, 300, rng=np.random.default_rng(i))
        systems.append(s)
    kw = dict(timestep=0.25 * units.fs, temperature_K=300, n_steps=12,
              log_every=4)
    out, log = driver.run_langevin_on_device(
        model, None, systems, friction=1 / (100 * units.fs), **kw)
    assert {k: np.shape(v) for k, v in log.items()} == {
        'epot': (3, 4), 'ekin': (3, 4), 'temperature': (3, 4),
        'nlist_overflow': (), 'skin_violations': ()}
    assert len(out) == 4
    assert not np.allclose(out[0].positions, out[1].positions)
    assert all(np.isfinite(s.positions).all() for s in out)
    one, log1 = driver.run_nhc_on_device(model, None, out[0],
                                         tdamp=10 * units.fs, **kw)
    assert one is out[0]
    assert {k: np.shape(v) for k, v in log1.items()} == {
        'epot': (3,), 'ekin': (3,), 'temperature': (3,), 'conserved': (3,),
        'nlist_overflow': (), 'skin_violations': ()}
    with pytest.raises(ValueError, match="'highest'"):
        driver.run_nhc_on_device(model, None, out[0], tdamp=10 * units.fs,
                                 matmul_precision='default', **kw)


def jax_lj_newton3():
    '''The JAX package's newton3 MD of the trained LJ checkpoint from
    chip_smoke.lj_md_start (lj_box's 512-atom frame, Maxwell-Boltzmann
    momenta): chip_smoke.MD_LJ's friction-0 Langevin (velocity Verlet),
    float32. -> (final positions (N, 3), epot per step).'''
    sys.path.insert(0, ROOT)
    import chip_smoke
    from newtonnet_tpu.utils.checkpoint import load_model
    LJ_MD = chip_smoke.MD_LJ
    model, params = load_model(chip_smoke.LJ_CKPT)
    numbers, pos, cell, mom = chip_smoke.lj_md_start()
    s = JaxSystem(numbers, pos, cell=cell, pbc=[True] * 3, momenta=mom)
    s, log = jax_driver.run_langevin_on_device(
        model, params, s, timestep=LJ_MD['timestep_fs'] * units.fs,
        temperature_K=LJ_MD['temperature'], friction=0.0,
        n_steps=LJ_MD['steps'], log_every=1,
        nlist_every=LJ_MD['nlist_every'], skin=LJ_MD['skin'])
    return s.positions, np.asarray(log['epot'], np.float64)


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    warnings.simplefilter('ignore')
    if sys.argv[1:] == ['lj-newton3']:
        import chip_smoke
        LJ_REF = chip_smoke.MD_LJ_REF
        final, epot = jax_lj_newton3()
        np.savez(LJ_REF, JAX_MD_LJ_NEWTON3_POS=final,
                 JAX_MD_LJ_NEWTON3_EPOT=epot)
        print('wrote', os.path.relpath(LJ_REF, ROOT))
        print('JAX_MD_LJ_NEWTON3_EPOT =', [float(v) for v in epot])
        print('JAX_MD_LJ_NEWTON3_POS[:2] =', final[:2].tolist())
    else:
        sys.exit('usage: test_torch_md_driver.py lj-newton3')
