'''Atomistic system container for MD (the JAX package's md/system.py, an
ASE Atoms analogue).

System holds numbers, positions, cell and momenta as numpy float64 arrays
in ASE units (Angstrom, eV, amu; the derived time unit makes fs = 0.09823
as in ase.units), and caches its calculator's results by the bytes of its
positions and cell.
'''
import numpy as np

from newtonnet_tpu_torch.data.units import kB
from newtonnet_tpu_torch.data.xyz import ATOMIC_MASSES, Frame


class System:
    def __init__(self, numbers, positions, cell=None, pbc=None, masses=None,
                 momenta=None):
        self.numbers = np.asarray(numbers, dtype=np.int32)
        self.positions = np.array(positions, dtype=np.float64)
        self.cell = (np.zeros((3, 3)) if cell is None
                     else np.asarray(cell, dtype=np.float64).reshape(3, 3))
        self.pbc = (np.zeros(3, dtype=bool) if pbc is None
                    else np.asarray(pbc, dtype=bool))
        self.masses = (ATOMIC_MASSES[self.numbers] if masses is None
                       else np.asarray(masses, dtype=np.float64))
        self.momenta = (np.zeros_like(self.positions) if momenta is None
                        else np.asarray(momenta, dtype=np.float64))
        self.calc = None
        self._cache = None

    @classmethod
    def from_frame(cls, frame):
        return cls(frame.numbers, frame.positions, cell=frame.cell,
                   pbc=frame.pbc)

    def to_frame(self, energy=None, forces=None):
        return Frame(self.numbers, self.positions.copy(),
                     cell=self.cell.copy(), pbc=self.pbc.copy(),
                     energy=energy, forces=forces)

    def __len__(self):
        return len(self.numbers)

    def set_momenta(self, momenta):
        self.momenta = np.asarray(momenta, dtype=np.float64)

    def get_velocities(self):
        return self.momenta / self.masses[:, None]

    def set_velocities(self, velocities):
        self.momenta = np.asarray(velocities) * self.masses[:, None]

    def kinetic_energy(self):
        return 0.5 * float(
            np.sum(self.momenta ** 2 / self.masses[:, None]))

    def temperature(self):
        '''Instantaneous kinetic temperature in K (3N degrees of freedom,
        as ASE reports by default).'''
        dof = 3 * len(self)
        return 2.0 * self.kinetic_energy() / (dof * kB)

    def _results(self):
        if self.calc is None:
            raise RuntimeError('no calculator attached to System.calc')
        key = (self.positions.tobytes(), self.cell.tobytes())
        if self._cache is None or self._cache[0] != key:
            self._cache = (key, self.calc.calculate(self))
        return self._cache[1]

    def get_potential_energy(self):
        return float(self._results()['energy'])

    def get_forces(self):
        return np.asarray(self._results()['forces'])

    def get_stress(self):
        return np.asarray(self._results()['stress'])


def maxwell_boltzmann(system, temperature_K, rng=None, zero_momentum=True):
    '''Draw initial momenta from the Maxwell-Boltzmann distribution (numpy
    Generator `rng`, default default_rng(0)).'''
    rng = rng or np.random.default_rng(0)
    sigma = np.sqrt(kB * temperature_K * system.masses)[:, None]
    momenta = rng.standard_normal((len(system), 3)) * sigma
    if zero_momentum:
        momenta -= momenta.mean(axis=0)
    system.set_momenta(momenta)
    return system
