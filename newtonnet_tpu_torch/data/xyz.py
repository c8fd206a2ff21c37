'''Extended-XYZ (extxyz) readers for the dialect of the NewtonNet datasets
(`Properties=species:S:1:pos:R:3:forces:R:3 energy=... pbc="F F F"`,
optional `Lattice="..."`, `stress=`/`virial=`): `read_extxyz` in Python,
and `parse_extxyz` through the C++ parser of csrc/host/extxyz.cpp (built
by g++ at first use; a failed build raises), which reads no stress= or
virial= fields.'''
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
