'''Samples from extxyz files and padded batching.

`parse_xyz` reads frames into Samples in eV and Angstrom; `collate` pads
a list of Samples into one static-shape batch, atoms padded with z = 0.
'''
import numpy as np

from newtonnet_tpu_torch.data.xyz import read_extxyz

EV_ANGSTROM = {'length': 1.0, 'energy': 1.0}


class Sample(dict):
    '''One frame: z (n,), pos (n, 3), cell (3, 3), energy, force (n, 3).'''
    __getattr__ = dict.__getitem__


def parse_xyz(raw_path, units=EV_ANGSTROM):
    '''Read an (ext)xyz file into Samples. `units` gives the factors that
    turn the file's length and energy units into Angstrom and eV (the
    identity for data already in eV/Angstrom).'''
    stress_unit = units['energy'] / units['length'] ** 3
    samples = []
    for frame in read_extxyz(raw_path):
        cell = frame.cell.copy()
        cell[~frame.pbc] = 0.0
        sample = Sample(
            z=frame.numbers.astype(np.int32),
            pos=frame.wrapped_positions() * units['length'],
            cell=cell * units['length'],
            energy=(np.float64(frame.energy) * units['energy']
                    if frame.energy is not None else None),
            force=(frame.forces * units['energy'] / units['length']
                   if frame.forces is not None else None),
        )
        if frame.stress is not None:
            sample['stress'] = frame.stress * stress_unit
        if frame.virial is not None:
            sample['virial'] = frame.virial * units['energy']
        samples.append(sample)
    return samples


def collate(samples, n_pad):
    '''Pad Samples into one float32 batch of numpy arrays: z (B, N),
    pos (B, N, 3), cell (B, 3, 3), energy (B,), force (B, N, 3), with
    B = len(samples) and N = n_pad.'''
    B, N = len(samples), n_pad
    oversized = max((len(s['z']) for s in samples), default=0)
    if oversized > N:
        raise ValueError(f'sample with {oversized} atoms does not fit '
                         f'n_pad={N}')
    batch = {
        'z': np.zeros((B, N), dtype=np.int32),
        'pos': np.zeros((B, N, 3), dtype=np.float32),
        'cell': np.zeros((B, 3, 3), dtype=np.float32),
        'energy': np.zeros((B,), dtype=np.float32),
        'force': np.zeros((B, N, 3), dtype=np.float32),
    }
    for i, s in enumerate(samples):
        n = len(s['z'])
        batch['z'][i, :n] = s['z']
        batch['pos'][i, :n] = s['pos']
        batch['cell'][i] = s['cell']
        if s.get('energy') is not None:
            batch['energy'][i] = s['energy']
        if s.get('force') is not None:
            batch['force'][i, :n] = s['force']
    return batch
