'''Geometry optimization: FIRE (Fast Inertial Relaxation Engine; Bitzek et
al., PRL 97, 170201 (2006)), the JAX package's md/optimize.py, with ASE's
ase.optimize.FIRE default parameters.
'''
import numpy as np


class FIRE:
    '''Minimize forces on a System with an attached calculator.

    Args:
        system: System with .calc set (or pass force_fn(positions)->forces).
        dt: initial timestep (ASE's default 0.1 in internal time units).
        maxstep: cap on per-atom displacement per step (Angstrom).
    '''

    def __init__(self, system, force_fn=None, dt=0.1, maxstep=0.2,
                 dtmax=1.0, Nmin=5, finc=1.1, fdec=0.5, astart=0.1,
                 fa=0.99):
        self.system = system
        self.force_fn = force_fn
        self.dt = dt
        self.maxstep = maxstep
        self.dtmax = dtmax
        self.Nmin = Nmin
        self.finc = finc
        self.fdec = fdec
        self.astart = astart
        self.fa = fa
        self.a = astart
        self.Nsteps = 0
        self.v = np.zeros_like(system.positions)

    def _forces(self):
        if self.force_fn is not None:
            return self.force_fn(self.system.positions)
        self.system._cache = None
        return self.system.get_forces()

    def run(self, fmax=0.05, steps=1000):
        '''Optimize until max per-atom |F| < fmax. Returns (converged,
        n_steps, final_fmax).'''
        for it in range(steps):
            f = self._forces()
            fnorm = float(np.sqrt((f ** 2).sum(axis=1)).max())
            if fnorm < fmax:
                return True, it, fnorm
            vf = float((f * self.v).sum())
            if vf > 0:
                f_unit = f / (np.sqrt((f ** 2).sum()) + 1e-30)
                v_norm = np.sqrt((self.v ** 2).sum())
                self.v = (1.0 - self.a) * self.v + self.a * f_unit * v_norm
                if self.Nsteps > self.Nmin:
                    self.dt = min(self.dt * self.finc, self.dtmax)
                    self.a *= self.fa
                self.Nsteps += 1
            else:
                self.v[:] = 0.0
                self.a = self.astart
                self.dt *= self.fdec
                self.Nsteps = 0
            self.v = self.v + self.dt * f
            dr = self.dt * self.v
            norm = np.sqrt((dr ** 2).sum(axis=1)).max()
            if norm > self.maxstep:
                dr = dr * (self.maxstep / norm)
            self.system.positions = self.system.positions + dr
        f = self._forces()
        fnorm = float(np.sqrt((f ** 2).sum(axis=1)).max())
        return fnorm < fmax, steps, fnorm
