'''Molecular dynamics integrators: host loops over a calculator (the JAX
package's md/integrators.py, the same algebra, units and order of random
draws).

  * VelocityVerlet -- NVE.
  * Langevin -- the Vanden-Eijnden / Ciccotti (2006) splitting of ASE's
    ase.md.langevin, with its coefficients; xi then eta drawn per step
    from a numpy Generator.
  * NoseHooverChain -- deterministic NVT (Martyna-Tuckerman-Klein chain,
    Suzuki-Yoshida factorization) with its conserved extended Hamiltonian.
  * BerendsenNVT / BerendsenNPT -- weak coupling (equilibration).

The loops run wherever their calculator runs (NewtonNetCalculator: CUDA
unless built with device='cpu'); md/driver.py keeps the whole trajectory
on the device instead.
'''
import math

import numpy as np

from newtonnet_tpu_torch.data.units import bar, kB, ps
from newtonnet_tpu_torch.data.xyz import write_extxyz


class MDLogger:
    '''ASE-style md.log writer: Time[ps] Etot Epot Ekin T[K].'''

    def __init__(self, path):
        self.path = path
        with open(path, 'w') as f:
            f.write(log_header())

    def __call__(self, system, time):
        epot = system.get_potential_energy()
        ekin = system.kinetic_energy()
        with open(self.path, 'a') as f:
            f.write(log_line(time / ps, epot, ekin, system.temperature()))


def log_header():
    '''The md.log header line.'''
    return ('Time[ps]      Etot[eV]     Epot[eV]     Ekin[eV]'
            '    T[K]\n')


def log_line(time_ps, epot, ekin, temperature):
    '''One md.log line.'''
    return (f'{time_ps:<10.4f} {epot + ekin:12.4f} {epot:12.4f} '
            f'{ekin:12.4f} {temperature:6.1f}\n')


class XYZTrajectory:
    '''Append frames to an extxyz trajectory file.'''

    def __init__(self, path):
        self.path = path
        open(path, 'w').close()

    def __call__(self, system, time):
        frame = system.to_frame(energy=system.get_potential_energy(),
                                forces=system.get_forces())
        write_extxyz(self.path, frame, mode='a')


class _Integrator:
    def __init__(self, system, timestep, logfile=None, trajectory=None,
                 loginterval=1):
        self.system = system
        self.dt = timestep
        self.observers = []
        if logfile is not None:
            self.observers.append((MDLogger(logfile), loginterval))
        if trajectory is not None:
            self.observers.append((XYZTrajectory(trajectory), loginterval))
        self.nsteps = 0

    def attach(self, fn, interval=1):
        self.observers.append((fn, interval))

    def _notify(self):
        for fn, interval in self.observers:
            if self.nsteps % interval == 0:
                fn(self.system, self.nsteps * self.dt)

    def run(self, steps):
        self._notify()
        for _ in range(steps):
            self.step()
            self.nsteps += 1
            self._notify()

    def _verlet(self):
        '''Half kick, drift, half kick.'''
        s = self.system
        f = s.get_forces()
        s.momenta = s.momenta + 0.5 * self.dt * f
        s.positions = s.positions + self.dt * s.momenta / s.masses[:, None]
        f = s.get_forces()
        s.momenta = s.momenta + 0.5 * self.dt * f


class VelocityVerlet(_Integrator):
    def step(self):
        self._verlet()


class Langevin(_Integrator):
    '''Langevin NVT, ASE-compatible coefficients.

    Args:
        system: System with a calculator attached.
        timestep: in internal units (pass e.g. 0.5 * units.fs).
        temperature_K: bath temperature.
        friction: friction coefficient in inverse internal time
            (e.g. 1 / (500 * units.fs)).
        rng: numpy Generator for the thermostat noise.
    '''

    def __init__(self, system, timestep, temperature_K, friction,
                 rng=None, **kwargs):
        super().__init__(system, timestep, **kwargs)
        self.temp = kB * temperature_K
        self.fr = friction
        self.rng = rng or np.random.default_rng(0)
        self._update_coeffs()

    def _update_coeffs(self):
        dt, fr, T = self.dt, self.fr, self.temp
        masses = self.system.masses[:, None]
        sigma = np.sqrt(2 * T * fr / masses)
        self.c1 = dt / 2.0 - dt * dt * fr / 8.0
        self.c2 = dt * fr / 2.0 - dt * dt * fr * fr / 8.0
        self.c3 = math.sqrt(dt) * sigma / 2.0 - dt ** 1.5 * fr * sigma / 8.0
        self.c5 = dt ** 1.5 * sigma / (2.0 * math.sqrt(3.0))
        self.c4 = fr / 2.0 * self.c5

    def step(self):
        s = self.system
        masses = s.masses[:, None]
        f = s.get_forces()
        v = s.get_velocities()
        xi = self.rng.standard_normal((len(s), 3))
        eta = self.rng.standard_normal((len(s), 3))
        v += self.c1 * f / masses - self.c2 * v + self.c3 * xi - self.c4 * eta
        s.positions = s.positions + self.dt * v + self.c5 * eta
        f = s.get_forces()
        v += self.c1 * f / masses - self.c2 * v + self.c3 * xi - self.c4 * eta
        s.set_velocities(v)


class NoseHooverChain(_Integrator):
    '''Deterministic NVT: Nose-Hoover chain (Martyna-Tuckerman-Klein).

    A chain of `chain_length` thermostats propagated with the 3-point
    Suzuki-Yoshida factorization around a velocity-Verlet core; it carries
    an exactly conserved extended Hamiltonian (`conserved_quantity()`),
    whose drift is the integration-quality diagnostic.

    Args:
        system: System with a calculator attached.
        timestep: integration step (e.g. 0.5 * units.fs).
        temperature_K: target temperature.
        tdamp: thermostat time constant (e.g. 50 * units.fs).
        chain_length: number of chained thermostats (>= 1, default 3).
        n_sub: chain-propagator substeps per half step (default 1).
    '''

    _SY = (1.3512071919596578, -1.7024143839193155, 1.3512071919596578)

    def __init__(self, system, timestep, temperature_K, tdamp,
                 chain_length=3, n_sub=1, **kwargs):
        super().__init__(system, timestep, **kwargs)
        if chain_length < 1:
            raise ValueError('chain_length must be >= 1')
        self.temp = kB * temperature_K
        self.dof = 3 * len(system)
        self.Q = np.full(chain_length, self.temp * tdamp ** 2)
        self.Q[0] *= self.dof
        self.xi = np.zeros(chain_length)   # thermostat coordinates
        self.vxi = np.zeros(chain_length)  # thermostat velocities
        self.n_sub = int(n_sub)

    def _g(self, j, akin):
        if j == 0:
            return (akin - self.dof * self.temp) / self.Q[0]
        return (self.Q[j - 1] * self.vxi[j - 1] ** 2 - self.temp) / self.Q[j]

    def _chain(self, dt):
        '''Propagate the chain for dt/2 (the 0.5/0.25/0.125 coefficients
        encode the half step, as in the MTK factorization); returns the
        momentum scale.'''
        M = len(self.Q)
        akin = 2.0 * self.system.kinetic_energy()
        scale = 1.0
        for _ in range(self.n_sub):
            for w in self._SY:
                wdt = w * dt / self.n_sub
                self.vxi[M - 1] += 0.25 * wdt * self._g(M - 1, akin)
                for j in range(M - 2, -1, -1):
                    aa = math.exp(-0.125 * wdt * self.vxi[j + 1])
                    self.vxi[j] = (self.vxi[j] * aa
                                   + 0.25 * wdt * self._g(j, akin)) * aa
                sfac = math.exp(-0.5 * wdt * self.vxi[0])
                scale *= sfac
                akin *= sfac * sfac
                self.xi += 0.5 * wdt * self.vxi
                for j in range(M - 1):
                    aa = math.exp(-0.125 * wdt * self.vxi[j + 1])
                    self.vxi[j] = (self.vxi[j] * aa
                                   + 0.25 * wdt * self._g(j, akin)) * aa
                self.vxi[M - 1] += 0.25 * wdt * self._g(M - 1, akin)
        return scale

    def step(self):
        s = self.system
        s.momenta = s.momenta * self._chain(self.dt)
        self._verlet()
        s.momenta = s.momenta * self._chain(self.dt)

    def conserved_quantity(self):
        '''Extended Hamiltonian H' = E + sum Q v_xi^2/2 + Nf kT xi_1
        + kT sum_{j>1} xi_j, conserved by the exact dynamics.'''
        e = self.system.get_potential_energy() + self.system.kinetic_energy()
        e += 0.5 * float(np.sum(self.Q * self.vxi ** 2))
        e += self.dof * self.temp * self.xi[0]
        e += self.temp * float(np.sum(self.xi[1:]))
        return e


def _pressure(system):
    '''Instantaneous isotropic pressure in eV/A^3: the ideal-gas kinetic
    part plus the virial part from the calculator's stress (ASE sign
    convention stress = (1/V) dE/d(strain)).'''
    vol = abs(float(np.linalg.det(system.cell)))
    if vol <= 0:
        raise ValueError('pressure needs a periodic cell with volume > 0')
    stress = np.asarray(system.get_stress())
    trace = (np.sum(stress[:3]) if stress.shape == (6,)
             else np.trace(stress.reshape(3, 3)))
    return (2.0 * system.kinetic_energy() - trace * vol) / (3.0 * vol)


class BerendsenNVT(_Integrator):
    '''Berendsen weak-coupling thermostat around a velocity-Verlet core (an
    equilibration tool: it does not sample the canonical ensemble).
    Velocities are rescaled by sqrt(1 + dt/taut (T0/T - 1)) once per step,
    capped to +-10% as in ASE's NVTBerendsen.'''

    def __init__(self, system, timestep, temperature_K, taut, **kwargs):
        super().__init__(system, timestep, **kwargs)
        self.t0 = float(temperature_K)
        self.taut = taut

    def _rescale(self):
        s = self.system
        t = max(s.temperature(), 1e-12)
        lam2 = 1.0 + self.dt / self.taut * (self.t0 / t - 1.0)
        lam = math.sqrt(min(max(lam2, 0.81), 1.21))
        s.momenta = s.momenta * lam

    def step(self):
        self._rescale()
        self._verlet()


class BerendsenNPT(BerendsenNVT):
    '''Isotropic Berendsen NPT: weak-coupling barostat and thermostat.

    Scales the cell and positions by mu = (1 - compressibility dt/taup
    (P0 - P))^(1/3) each step (capped to +-2% linear strain), P the
    instantaneous pressure with the ideal-gas kinetic term. The
    calculator must give `stress`.

    Args:
        pressure: target pressure in eV/A^3 (units.bar / units.GPa).
        taup: barostat time constant.
        compressibility: isothermal compressibility in (eV/A^3)^-1; the
            default is water's 4.57e-5 bar^-1, as in ASE.
    '''

    def __init__(self, system, timestep, temperature_K, taut, taup,
                 pressure=0.0, compressibility=None, **kwargs):
        super().__init__(system, timestep, temperature_K, taut, **kwargs)
        self.p0 = float(pressure)
        self.taup = taup
        self.compr = (4.57e-5 / bar if compressibility is None
                      else float(compressibility))

    def pressure(self):
        return _pressure(self.system)

    def _scale_box(self):
        s = self.system
        p = self.pressure()
        mu3 = 1.0 - self.compr * self.dt / self.taup * (self.p0 - p)
        # clamped before the cube root: a large overpressure can push mu3
        # negative
        mu = min(max(mu3, 0.98 ** 3), 1.02 ** 3) ** (1.0 / 3.0)
        s.cell = s.cell * mu
        s.positions = s.positions * mu

    def step(self):
        self._scale_box()
        super().step()
