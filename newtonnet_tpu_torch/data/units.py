'''Unit system, numerically identical to ASE's (ase.units, CODATA 2014):
Angstrom = 1, eV = 1, amu = 1; the JAX package's data/units.py, copied so
that the port needs no ASE and nothing of that package. `get_unit` takes
the strings the configs use for data_length_unit / data_energy_unit.
'''
import math

# CODATA 2014 (matching ase.units defaults)
_c = 299792458.0           # m/s
_mu0 = 4.0e-7 * math.pi    # vacuum permeability
_grav = 6.67408e-11
_hplanck = 6.626070040e-34  # J s
_e = 1.6021766208e-19      # C
_me = 9.10938356e-31       # kg
_mp = 1.672621898e-27      # kg
_nav = 6.022140857e23      # 1/mol
_k = 1.38064852e-23        # J/K
_amu = 1.660539040e-27     # kg

# base units
Ang = Angstrom = 1.0
nm = 10.0
Bohr = (4e10 * math.pi * (1 / (_mu0 * _c**2)) * _hplanck**2
        / (4 * math.pi**2) / _me / _e**2)  # ~0.52917721 Angstrom

eV = 1.0
_eps0 = 1.0 / (_mu0 * _c**2)
Hartree = Ha = _e / (4 * math.pi * _eps0 * Bohr * 1e-10)  # ~27.211386 eV
kJ = 1000.0 / _e
kcal = 4.184 * kJ
mol = _nav
Rydberg = Ry = 0.5 * Hartree

second = 1e10 * math.sqrt(_e / _amu)
fs = 1e-15 * second
ps = 1e-12 * second

kB = _k / _e               # eV/K
amu = 1.0
GPa = 1e9 / (_e * 1e30)    # eV/Ang^3
Pascal = 1.0 / (_e * 1e30)
bar = 1e5 * Pascal
Debye = 1.0 / 1e11 / _e / _c

_REGISTRY = {
    'Ang': Ang, 'Angstrom': Ang, 'nm': nm, 'Bohr': Bohr,
    'eV': eV, 'Hartree': Hartree, 'Ha': Ha, 'Rydberg': Rydberg, 'Ry': Ry,
    'kJ': kJ, 'kcal': kcal, 'mol': mol,
    'kcal/mol': kcal / mol, 'kJ/mol': kJ / mol,
    'second': second, 'fs': fs, 'ps': ps,
    'kB': kB, 'amu': amu, 'GPa': GPa, 'Pascal': Pascal, 'bar': bar,
    'Debye': Debye,
}


def get_unit(name):
    '''Look up a unit factor by its reference-compatible string name.'''
    if name not in _REGISTRY:
        raise ValueError(f'unknown unit {name!r}')
    return _REGISTRY[name]
