'''The port's host-side MD (newtonnet_tpu_torch.md: System, the host-loop
integrators, FIRE, MDLogger, write_extxyz, calculate(system) and the
simulate entry point) against the JAX package's, on the CPU, in float64
where the code is numpy.

* System and maxwell_boltzmann draw the same numbers from the same numpy
  Generator; MDLogger and write_extxyz write the same bytes.
* VelocityVerlet, Langevin (default_rng noise), NoseHooverChain,
  BerendsenNVT, BerendsenNPT and FIRE follow the JAX package's
  trajectories within 1e-12 over 20 steps, on a harmonic calculator that
  also gives a stress (for NPT).
* calculate(system) gives calculate(numbers=, positions=, cell=)'s numbers
  bit for bit.
* python -m newtonnet_tpu_torch.md.simulate --device cpu writes an md.log
  in the format of the JAX package's scripts/simulate.py (the header and
  the line format of artifacts/md17_model/md.log, which it wrote), from
  the host loop and from the on-device driver.
'''
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from newtonnet_tpu.data import units as jax_units
from newtonnet_tpu.data.xyz import Frame as JaxFrame
from newtonnet_tpu.data.xyz import write_extxyz as jax_write_extxyz
from newtonnet_tpu.md import integrators as jax_integrators
from newtonnet_tpu.md import optimize as jax_optimize
from newtonnet_tpu.md import system as jax_system
from newtonnet_tpu_torch.data import units
from newtonnet_tpu_torch.data.xyz import ATOMIC_MASSES, Frame, write_extxyz
from newtonnet_tpu_torch.md import integrators, optimize, system

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLA_CKPT = os.path.join(ROOT, 'artifacts', 'md17_model', 'best_model.msgpack')
MD_LOG = os.path.join(ROOT, 'artifacts', 'md17_model', 'md.log')
LINE = re.compile(r'^(\S+)\s+(\S+)\s+(\S+)\s+(\S+)\s+(\S+)$')


class HarmonicCalculator:
    '''E = 0.5 k sum |r - r0|^2 with an analytic stress-like tensor
    (deterministic in the positions), as tests/test_md.py:15 with a
    stress for NPT.'''

    def __init__(self, r0, k=5.0):
        self.r0 = np.asarray(r0)
        self.k = k

    def calculate(self, s):
        d = s.positions - self.r0
        vol = abs(np.linalg.det(s.cell)) or 1.0
        stress = -self.k * np.einsum('ia,ib->ab', d, s.positions) / vol
        return {'energy': 0.5 * self.k * float((d ** 2).sum()),
                'forces': -self.k * d, 'stress': 0.5 * (stress + stress.T)}


def _box(pkg, seed=0, n=12, L=9.0):
    rs = np.random.RandomState(seed)
    numbers = rs.choice([1, 6, 8], n)
    r0 = rs.rand(n, 3) * L
    s = pkg.System(numbers, r0 + rs.randn(n, 3) * 0.05,
                   cell=np.eye(3) * L, pbc=[True] * 3)
    pkg.maxwell_boltzmann(s, 300.0, rng=np.random.default_rng(seed))
    s.calc = HarmonicCalculator(r0)
    return s


def test_masses_and_system_match_the_jax_package():
    from newtonnet_tpu.data.xyz import ATOMIC_MASSES as JAX_MASSES
    assert np.array_equal(ATOMIC_MASSES, JAX_MASSES)
    mine, theirs = _box(system), _box(jax_system)
    for key in ('numbers', 'positions', 'cell', 'pbc', 'masses', 'momenta'):
        assert np.array_equal(getattr(mine, key), getattr(theirs, key)), key
    assert mine.temperature() == theirs.temperature()
    assert mine.kinetic_energy() == theirs.kinetic_energy()
    assert np.array_equal(mine.get_velocities(), theirs.get_velocities())
    assert mine.get_potential_energy() == theirs.get_potential_energy()
    for zero in (False, True):
        a = system.maxwell_boltzmann(_box(system), 50.0, zero_momentum=zero)
        b = jax_system.maxwell_boltzmann(_box(jax_system), 50.0,
                                         zero_momentum=zero)
        assert np.array_equal(a.momenta, b.momenta)


def test_logger_and_extxyz_write_the_jax_bytes(tmp_path):
    mine, theirs = _box(system), _box(jax_system)
    for pkg, s, tag in ((integrators, mine, 'a'),
                        (jax_integrators, theirs, 'b')):
        log = pkg.MDLogger(str(tmp_path / f'{tag}.log'))
        for k in range(3):
            log(s, k * 0.5 * units.fs)
    assert (tmp_path / 'a.log').read_bytes() == \
        (tmp_path / 'b.log').read_bytes()
    rs = np.random.RandomState(1)
    kw = [dict(), dict(cell=np.eye(3) * 7.5, pbc=[True, True, False],
                       energy=-1.25, forces=rs.randn(5, 3),
                       stress=rs.randn(3, 3), virial=rs.randn(3, 3))]
    numbers, pos = [8, 1, 1, 6, 18], rs.randn(5, 3)
    for i, extra in enumerate(kw):
        write_extxyz(str(tmp_path / 'a.xyz'), Frame(numbers, pos, **extra),
                     mode='w' if i == 0 else 'a')
        jax_write_extxyz(str(tmp_path / 'b.xyz'),
                         JaxFrame(numbers, pos, **extra),
                         mode='w' if i == 0 else 'a')
    assert (tmp_path / 'a.xyz').read_bytes() == \
        (tmp_path / 'b.xyz').read_bytes()
    # the trajectory observer too
    for pkg, s, tag in ((integrators, _box(system), 'a'),
                        (jax_integrators, _box(jax_system), 'b')):
        pkg.XYZTrajectory(str(tmp_path / f'{tag}.traj'))(s, 0.0)
    assert (tmp_path / 'a.traj').read_bytes() == \
        (tmp_path / 'b.traj').read_bytes()


def _integrator(pkg, name, s):
    dt = 0.5 * units.fs
    if name == 'VelocityVerlet':
        return pkg.VelocityVerlet(s, timestep=dt)
    if name == 'Langevin':
        return pkg.Langevin(s, timestep=dt, temperature_K=300,
                            friction=1 / (20 * units.fs),
                            rng=np.random.default_rng(7))
    if name == 'NoseHooverChain':
        return pkg.NoseHooverChain(s, timestep=dt, temperature_K=300,
                                   tdamp=10 * units.fs)
    if name == 'BerendsenNVT':
        return pkg.BerendsenNVT(s, timestep=dt, temperature_K=500,
                                taut=5 * units.fs)
    return pkg.BerendsenNPT(s, timestep=dt, temperature_K=500,
                            taut=5 * units.fs, taup=20 * units.fs,
                            pressure=0.01)


@pytest.mark.parametrize('name', ['VelocityVerlet', 'Langevin',
                                  'NoseHooverChain', 'BerendsenNVT',
                                  'BerendsenNPT', 'FIRE'])
def test_host_integrators_follow_the_jax_trajectories(name):
    '''20 steps of each host-loop integrator from the same start: the
    positions, momenta, cell and energies within 1e-12 of the JAX
    package's (the same algebra and draws; in practice equal bits).'''
    runs = []
    for pkg_int, pkg_opt, pkg_sys in ((integrators, optimize, system),
                                      (jax_integrators, jax_optimize,
                                       jax_system)):
        s = _box(pkg_sys)
        trace = []
        if name == 'FIRE':
            opt = pkg_opt.FIRE(s)
            result = opt.run(fmax=1e-9, steps=20)
            trace.append((result[1], result[2], opt.dt, opt.a))
        else:
            dyn = _integrator(pkg_int, name, s)
            dyn.attach(lambda sy, t: trace.append(
                (t, sy.get_potential_energy(), sy.kinetic_energy())))
            dyn.run(20)
            if name == 'NoseHooverChain':
                trace.append((0.0, dyn.conserved_quantity(), 0.0))
            if name == 'BerendsenNPT':
                trace.append((0.0, dyn.pressure(), 0.0))
        runs.append((s, np.array(trace, dtype=np.float64)))
    (a, ta), (b, tb) = runs
    assert len(ta) == len(tb) and len(ta) > 0
    np.testing.assert_allclose(ta, tb, rtol=0, atol=1e-12)
    for key in ('positions', 'momenta', 'cell'):
        np.testing.assert_allclose(getattr(a, key), getattr(b, key), rtol=0,
                                   atol=1e-12, err_msg=key)
    assert not np.allclose(a.positions, _box(system).positions)


def test_pressure_and_units_match_the_jax_package():
    s, t = _box(system), _box(jax_system)
    assert integrators._pressure(s) == jax_integrators._pressure(t)
    for key in ('fs', 'ps', 'kB', 'bar'):
        assert getattr(units, key) == getattr(jax_units, key)
    s.cell = np.zeros((3, 3))
    with pytest.raises(ValueError, match='volume'):
        integrators._pressure(s)


@pytest.fixture(scope='module')
def calc():
    from newtonnet_tpu_torch import NewtonNetCalculator
    return NewtonNetCalculator(XLA_CKPT, properties=['energy', 'forces'],
                               device='cpu')


def test_calculate_takes_a_system(calc):
    '''calculate(system) supplies numbers, positions and cell from the
    System: the keyword call's numbers, bit for bit, aperiodic and in a
    box; and a System's get_forces goes through it.'''
    from newtonnet_tpu_torch.data.xyz import read_extxyz
    frame = read_extxyz(os.path.join(ROOT, 'data', 'md17_aspirin',
                                     'ccsd_test', 'raw',
                                     'aspirin_ccsd-test.xyz'))[0]
    for cell in (None, np.eye(3) * 30.0):
        s = system.System(frame.numbers, frame.positions, cell=cell)
        got = calc.calculate(s)
        want = calc.calculate(numbers=s.numbers, positions=s.positions,
                              cell=cell)
        assert got['energy'] == want['energy']
        assert np.array_equal(got['forces'], want['forces'])
        s.calc = calc
        assert np.array_equal(s.get_forces(), want['forces'])
        assert s.get_potential_energy() == want['energy']


def _check_log(path, n_lines):
    with open(path) as f:
        lines = f.read().splitlines()
    with open(MD_LOG) as f:
        header = f.readline().rstrip('\n')
    assert lines[0] == header
    assert len(lines) == n_lines + 1
    for line in lines[1:]:
        m = LINE.match(line)
        assert m, line
        t, etot, epot, ekin, temp = (float(v) for v in m.groups())
        assert np.isfinite([t, etot, epot, ekin, temp]).all()
        assert line == (f'{t:<10.4f} {etot:12.4f} {epot:12.4f} '
                        f'{ekin:12.4f} {temp:6.1f}')
        assert abs(epot + 17592.0) < 5.0
    return lines


@pytest.mark.parametrize('mode, steps, n_lines', [('host', 20, 1),
                                                   ('on-device', 101, 2)])
def test_simulate_entry_point_writes_the_jax_md_log(tmp_path, mode, steps,
                                                    n_lines):
    '''python -m newtonnet_tpu_torch.md.simulate --device cpu: md.log with
    scripts/simulate.py's header and line format (artifacts/md17_model/
    md.log, written by it), finite values near the aspirin record's
    energies; the host loop also writes its extxyz trajectory.'''
    out = tmp_path / 'md'
    cmd = [sys.executable, '-m', 'newtonnet_tpu_torch.md.simulate',
           '--device', 'cpu', '--steps', str(steps), '--out', str(out)]
    if mode == 'on-device':
        cmd.append('--on-device')
    # one thread: the small model's steps run several times faster so,
    # and the run does not compete with the test workers for the cores
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1',
               MKL_NUM_THREADS='1')
    subprocess.run(cmd, cwd=str(tmp_path), env=env, check=True,
                   capture_output=True, timeout=300)
    lines = _check_log(str(out / 'md.log'), n_lines)
    if mode == 'host':
        with open(out / 'md.traj.xyz') as f:
            assert f.readline().strip() == '21'
        # the first line is the start, at rest
        assert lines[1].split()[3] == '0.0000'
