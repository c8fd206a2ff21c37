'''Extended-XYZ (extxyz) readers for the dialect of the NewtonNet datasets
(`Properties=species:S:1:pos:R:3:forces:R:3 energy=... pbc="F F F"`,
optional `Lattice="..."`, `stress=`/`virial=`): `read_extxyz` in Python,
and `parse_extxyz` through the C++ parser of csrc/host/extxyz.cpp (built
by g++ at first use; a failed build raises), which reads no stress= or
virial= fields. `write_extxyz` writes the JAX package's bytes (MD
trajectories), and `ATOMIC_MASSES` are the masses the MD module uses.'''
import os
import re

import numpy as np

CHEMICAL_SYMBOLS = [
    'X', 'H', 'He', 'Li', 'Be', 'B', 'C', 'N', 'O', 'F', 'Ne', 'Na', 'Mg',
    'Al', 'Si', 'P', 'S', 'Cl', 'Ar', 'K', 'Ca', 'Sc', 'Ti', 'V', 'Cr',
    'Mn', 'Fe', 'Co', 'Ni', 'Cu', 'Zn', 'Ga', 'Ge', 'As', 'Se', 'Br', 'Kr',
    'Rb', 'Sr', 'Y', 'Zr', 'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag', 'Cd',
    'In', 'Sn', 'Sb', 'Te', 'I', 'Xe', 'Cs', 'Ba', 'La', 'Ce', 'Pr', 'Nd',
    'Pm', 'Sm', 'Eu', 'Gd', 'Tb', 'Dy', 'Ho', 'Er', 'Tm', 'Yb', 'Lu', 'Hf',
    'Ta', 'W', 'Re', 'Os', 'Ir', 'Pt', 'Au', 'Hg', 'Tl', 'Pb', 'Bi', 'Po',
    'At', 'Rn', 'Fr', 'Ra', 'Ac', 'Th', 'Pa', 'U', 'Np', 'Pu', 'Am', 'Cm',
    'Bk', 'Cf', 'Es', 'Fm', 'Md', 'No', 'Lr', 'Rf', 'Db', 'Sg', 'Bh', 'Hs',
    'Mt', 'Ds', 'Rg', 'Cn', 'Nh', 'Fl', 'Mc', 'Lv', 'Ts', 'Og',
]
SYMBOL_TO_Z = {s: i for i, s in enumerate(CHEMICAL_SYMBOLS)}

# atomic masses (amu), IUPAC 2016 abridged -- used by the MD module
ATOMIC_MASSES = np.array([
    0.0, 1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999,
    18.998403163, 20.1797, 22.98976928, 24.305, 26.9815385, 28.085,
    30.973761998, 32.06, 35.45, 39.948, 39.0983, 40.078, 44.955908,
    47.867, 50.9415, 51.9961, 54.938044, 55.845, 58.933194, 58.6934,
    63.546, 65.38, 69.723, 72.63, 74.921595, 78.971, 79.904, 83.798,
    85.4678, 87.62, 88.90584, 91.224, 92.90637, 95.95, 97.90721, 101.07,
    102.9055, 106.42, 107.8682, 112.414, 114.818, 118.71, 121.76, 127.6,
    126.90447, 131.293, 132.90545196, 137.327, 138.90547, 140.116,
    140.90766, 144.242, 144.91276, 150.36, 151.964, 157.25, 158.92535,
    162.5, 164.93033, 167.259, 168.93422, 173.054, 174.9668, 178.49,
    180.94788, 183.84, 186.207, 190.23, 192.217, 195.084, 196.966569,
    200.592, 204.38, 207.2, 208.9804, 208.98243, 209.98715, 222.01758,
    223.01974, 226.02541, 227.02775, 232.0377, 231.03588, 238.02891,
    237.04817, 244.06421, 243.06138, 247.07035, 247.07031, 251.07959,
    252.083, 257.09511, 258.09843, 259.101, 262.11, 267.122, 268.126,
    271.134, 270.133, 269.1338, 278.156, 281.165, 281.166, 285.177,
    286.182, 289.19, 289.194, 293.204, 293.208, 294.214,
])

_KEY_VALUE_RE = re.compile(
    r'''([A-Za-z_][A-Za-z0-9_/-]*)=(?:"([^"]*)"|(\S+))''')


def _parse_comment(line):
    return {key: quoted if quoted else bare
            for key, quoted, bare in _KEY_VALUE_RE.findall(line)}


def _parse_properties(spec):
    '''Properties=species:S:1:pos:R:3:... -> [(name, kind, ncols)].'''
    fields = spec.split(':')
    return [(fields[i], fields[i + 1], int(fields[i + 2]))
            for i in range(0, len(fields), 3)]


def _parse_3x3(text):
    '''9 numbers (row-major) or 6 (Voigt xx yy zz yz xz xy) -> (3, 3).'''
    v = np.array(text.split(), dtype=np.float64)
    if v.size == 9:
        return v.reshape(3, 3)
    if v.size == 6:
        xx, yy, zz, yz, xz, xy = v
        return np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
    raise ValueError(f'expected 9 or 6 numbers for a 3x3 tensor, got '
                     f'{v.size}')


class Frame:
    '''One frame: numbers (n,), positions (n, 3) and optional cell (3, 3),
    pbc (3,), energy, forces (n, 3), stress/virial (3, 3).'''

    def __init__(self, numbers, positions, cell=None, pbc=None, energy=None,
                 forces=None, stress=None, virial=None, info=None,
                 arrays=None):
        self.numbers = np.asarray(numbers, dtype=np.int32)
        self.positions = np.asarray(positions, dtype=np.float64)
        self.cell = (np.zeros((3, 3)) if cell is None
                     else np.asarray(cell, dtype=np.float64).reshape(3, 3))
        self.pbc = (np.zeros(3, dtype=bool) if pbc is None
                    else np.asarray(pbc, dtype=bool))
        self.energy = None if energy is None else float(energy)
        self.forces = None if forces is None else np.asarray(
            forces, dtype=np.float64)
        self.stress = None if stress is None else np.asarray(
            stress, dtype=np.float64).reshape(3, 3)
        self.virial = None if virial is None else np.asarray(
            virial, dtype=np.float64).reshape(3, 3)
        self.info = info or {}
        self.arrays = arrays or {}

    def __len__(self):
        return len(self.numbers)

    def wrapped_positions(self):
        '''Positions wrapped into the cell on periodic axes.'''
        if not self.pbc.any() or not self.cell.any():
            return self.positions
        frac = self.positions @ np.linalg.inv(self.cell)
        frac = np.where(self.pbc[None, :], frac % 1.0, frac)
        return frac @ self.cell


def read_extxyz(path):
    '''All frames of an (ext)xyz file.'''
    frames = []
    with open(path) as f:
        while True:
            line = f.readline()
            if not line.strip():
                break
            n = int(line)
            info = _parse_comment(f.readline())
            props = _parse_properties(
                info.pop('Properties', 'species:S:1:pos:R:3'))
            rows = [f.readline().split() for _ in range(n)]
            columns = {}
            col = 0
            for name, kind, ncols in props:
                vals = [row[col:col + ncols] for row in rows]
                if kind == 'S':
                    columns[name] = np.array([v[0] for v in vals])
                elif kind == 'R':
                    columns[name] = np.array(vals, dtype=np.float64)
                elif kind == 'I':
                    columns[name] = np.array(vals, dtype=np.int64).squeeze(-1)
                col += ncols
            if 'species' in columns:
                numbers = np.array([SYMBOL_TO_Z[s]
                                    for s in columns.pop('species')],
                                   dtype=np.int32)
            else:
                numbers = columns.pop('Z').astype(np.int32)
            positions = columns.pop('pos')
            forces = columns.pop('forces', columns.pop('force', None))
            cell = None
            if 'Lattice' in info:
                cell = np.array(info.pop('Lattice').split(),
                                dtype=np.float64).reshape(3, 3)
            pbc = None
            if 'pbc' in info:
                pbc = np.array([t in ('T', 'True', '1')
                                for t in info.pop('pbc').split()])
            elif cell is not None:
                pbc = np.ones(3, dtype=bool)
            energy = info.pop('energy', None)
            stress = virial = None
            if 'stress' in info:
                stress = _parse_3x3(info.pop('stress'))
            if 'virial' in info:
                virial = _parse_3x3(info.pop('virial'))
            frames.append(Frame(numbers, positions, cell=cell, pbc=pbc,
                                energy=energy, forces=forces, stress=stress,
                                virial=virial, info=info, arrays=columns))
    return frames


def write_extxyz(path, frames, mode='w'):
    '''Write a Frame or a list of them to an extxyz file (mode 'w' or
    'a'), in the JAX package's format, byte for byte.'''
    if isinstance(frames, Frame):
        frames = [frames]
    with open(path, mode) as f:
        for fr in frames:
            parts = []
            if fr.cell.any():
                lat = ' '.join(f'{x:.10f}' for x in fr.cell.ravel())
                parts.append(f'Lattice="{lat}"')
            prop = 'species:S:1:pos:R:3'
            if fr.forces is not None:
                prop += ':forces:R:3'
            parts.append(f'Properties={prop}')
            if fr.energy is not None:
                parts.append(f'energy={fr.energy!r}')
            for key in ('stress', 'virial'):
                value = getattr(fr, key)
                if value is not None:
                    s = ' '.join(f'{x:.10g}' for x in value.ravel())
                    parts.append(f'{key}="{s}"')
            pbc = ' '.join('T' if b else 'F' for b in fr.pbc)
            parts.append(f'pbc="{pbc}"')
            f.write(f'{len(fr)}\n{" ".join(parts)}\n')
            for i in range(len(fr)):
                sym = CHEMICAL_SYMBOLS[fr.numbers[i]]
                row = f'{sym:3s} ' + ' '.join(
                    f'{x:16.8f}' for x in fr.positions[i])
                if fr.forces is not None:
                    row += ' ' + ' '.join(f'{x:16.8f}' for x in fr.forces[i])
                f.write(row + '\n')


def _extxyz_lib():
    '''The ctypes handle of csrc/host/extxyz.cpp (built by g++ at first
    use; a failed build raises), its functions typed.'''
    import ctypes

    from newtonnet_tpu_torch.ops import _build
    lib = _build.load_host('extxyz')
    if not getattr(lib, '_nn_typed', False):
        p = ctypes.c_void_p
        lib.xyz_parse.restype = p
        lib.xyz_parse.argtypes = [ctypes.c_char_p]
        lib.xyz_error.restype = ctypes.c_char_p
        lib.xyz_error.argtypes = [p]
        for fn in ('xyz_n_frames', 'xyz_total_atoms'):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [p]
        for fn in ('xyz_has_energy', 'xyz_has_forces'):
            getattr(lib, fn).restype = ctypes.c_uint8
            getattr(lib, fn).argtypes = [p]
        lib.xyz_fill.restype = None
        lib.xyz_fill.argtypes = [p] * 8
        lib.xyz_free.restype = None
        lib.xyz_free.argtypes = [p]
        lib._nn_typed = True
    return lib


def parse_extxyz(path):
    '''Parse an extxyz file with the C++ parser (csrc/host/extxyz.cpp),
    which reads no stress=/virial= fields.

    Returns a dict: ptr (n_frames + 1,), z (atoms,), pos (atoms, 3),
    forces (atoms, 3) or None, cell (n_frames, 3, 3), energy (n_frames,)
    or None, pbc (n_frames, 3) bool. Raises ValueError on a malformed
    file.'''
    import ctypes
    lib = _extxyz_lib()
    h = lib.xyz_parse(os.fsencode(path))
    try:
        err = lib.xyz_error(h)
        if err:
            raise ValueError(f'{path}: {err.decode()}')
        n_frames = lib.xyz_n_frames(h)
        atoms = lib.xyz_total_atoms(h)
        z = np.empty(atoms, np.int32)
        pos = np.empty((atoms, 3), np.float64)
        forces = np.empty((atoms, 3), np.float64)
        cell = np.empty((n_frames, 3, 3), np.float64)
        energy = np.empty(n_frames, np.float64)
        pbc = np.empty((n_frames, 3), np.uint8)
        ptr = np.empty(n_frames + 1, np.int64)
        lib.xyz_fill(h, *(a.ctypes.data_as(ctypes.c_void_p)
                          for a in (z, pos, forces, cell, energy, pbc, ptr)))
        return {
            'ptr': ptr, 'z': z, 'pos': pos,
            'forces': forces if lib.xyz_has_forces(h) else None,
            'cell': cell,
            'energy': energy if lib.xyz_has_energy(h) else None,
            'pbc': pbc.astype(bool),
        }
    finally:
        lib.xyz_free(h)
