'''Samples from extxyz files, datasets and padded batching (the JAX
package's data/loader.py, in-memory and unbucketed).

`parse_xyz` reads frames into Samples in eV and Angstrom;
`MolecularInMemoryDataset` holds a directory's raw files in memory;
`Subset` and `random_split` cut it; `collate` pads a list of Samples into
one static-shape batch (atoms padded with z = 0, missing graphs with
graph_mask False); `PaddedLoader` iterates over batches.
'''
import os
import os.path as osp

import numpy as np

from newtonnet_tpu_torch.data.units import get_unit
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


class MolecularInMemoryDataset:
    '''Every frame of `root`/raw/*.xyz|*.extxyz (sorted by name) in memory,
    with float data in `precision`. Unlike the JAX package's dataset it
    writes no processed/ cache: the raw files are parsed at construction.

    Args:
        root: directory holding a raw/ subdirectory.
        precision: numpy dtype of the float data (default float32).
        data_length_unit / data_energy_unit: units of the raw files
            (converted into eV and Angstrom).
        force_reload: taken for the config schema's sake; there is no
            cache to reload.
    '''

    def __init__(self, root, precision=np.float32, data_length_unit='Ang',
                 data_energy_unit='eV', force_reload=False):
        self.precision = np.dtype(precision)
        units = {'length': get_unit(data_length_unit),
                 'energy': get_unit(data_energy_unit)}
        raw_dir = osp.join(root, 'raw')
        names = sorted(n for n in os.listdir(raw_dir)
                       if n.endswith(('.npz', '.xyz', '.extxyz')))
        self._samples = []
        for name in names:
            if name.endswith('.npz'):
                raise NotImplementedError(
                    f'{name}: npz datasets are not ported yet (ROADMAP.md A, '
                    '"data pipeline")')
            self._samples += [self._cast(s) for s in
                              parse_xyz(osp.join(raw_dir, name), units)]

    def _cast(self, s):
        out = Sample(s)
        for key in ('pos', 'cell', 'force', 'stress', 'virial'):
            if out.get(key) is not None:
                out[key] = np.asarray(out[key]).astype(self.precision)
        if out.get('energy') is not None:
            out['energy'] = self.precision.type(out['energy'])
        return out

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, idx):
        return self._samples[idx]

    @property
    def max_atoms(self):
        return max(len(s['z']) for s in self._samples)


class Subset:
    '''Index-based view of a dataset.'''

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    @property
    def max_atoms(self):
        return self.dataset.max_atoms

    @property
    def precision(self):
        return self.dataset.precision


def random_split(dataset, sizes, rng):
    '''Split into consecutive Subsets of one permutation drawn from the
    numpy Generator `rng`, as the JAX package does without locality
    blocks.'''
    if sum(sizes) != len(dataset):
        raise ValueError(f'sizes {sizes} do not add up to {len(dataset)}')
    perm = rng.permutation(len(dataset))
    out, start = [], 0
    for size in sizes:
        out.append(Subset(dataset, perm[start:start + size]))
        start += size
    return out


def collate(samples, n_pad, batch_pad=None, dtype=np.float32):
    '''Pad Samples into one batch of numpy arrays: z (B, N), pos (B, N, 3),
    cell (B, 3, 3), energy (B,), force (B, N, 3) and graph_mask (B,), with
    B = batch_pad (default len(samples)) and N = n_pad, and stress / virial
    (B, 3, 3) where the samples carry them (all or none: a partial label
    would train on zeros), and the samples' precomputed lists
    (data/prelists.py): nlist_idx / nlist_mask (B, N, K) padded along
    the atoms, or nlist_stair, a tuple of per-chunk (idx, mask, inv,
    inv_mask) arrays (B, c, n). Rows past len(samples) are empty graphs
    (graph_mask False).'''
    B, N = batch_pad or len(samples), n_pad
    oversized = max((len(s['z']) for s in samples), default=0)
    if oversized > N:
        raise ValueError(f'sample with {oversized} atoms does not fit '
                         f'n_pad={N}')
    batch = {
        'z': np.zeros((B, N), dtype=np.int32),
        'pos': np.zeros((B, N, 3), dtype=dtype),
        'cell': np.zeros((B, 3, 3), dtype=dtype),
        'energy': np.zeros((B,), dtype=dtype),
        'force': np.zeros((B, N, 3), dtype=dtype),
        'graph_mask': np.zeros((B,), dtype=bool),
    }
    # precomputed lists (data/prelists.py): padded along the atoms, the
    # slot width K the builder's
    with_nl = sum('nlist_idx' in s for s in samples)
    if with_nl and with_nl != len(samples):
        raise ValueError(
            'mixed batch: some samples carry precomputed neighbor lists '
            'and some do not (wrap every dataset in NeighborListDataset)')
    if with_nl:
        K = samples[0]['nlist_idx'].shape[-1]
        batch['nlist_idx'] = np.zeros((B, N, K), np.int32)
        batch['nlist_mask'] = np.zeros((B, N, K), bool)
    with_st = sum('nlist_stair' in s for s in samples)
    if with_st and with_st != len(samples):
        raise ValueError(
            'mixed batch: some samples carry staircase lists and some do '
            'not (wrap every dataset in NeighborListDataset)')
    if with_st:
        widths = tuple(ch[0].shape for ch in samples[0]['nlist_stair'])
        if any(tuple(ch[0].shape for ch in s['nlist_stair']) != widths
               for s in samples[1:]):
            raise ValueError(
                'staircase shape plan differs across the batch (use one '
                'NeighborListDataset wrapper per dataset so the plan is '
                'shared)')
        if any(n > N for _, n in widths):
            raise ValueError(
                f'staircase chunk width exceeds n_pad={N}; raise n_pad')
        batch['nlist_stair'] = tuple(
            tuple(np.zeros((B, c, n), dt) for dt in (np.int32, bool,
                                                      np.int32, bool))
            for c, n in widths)
    for key in ('stress', 'virial'):
        labelled = sum(s.get(key) is not None for s in samples)
        if labelled and labelled != len(samples):
            raise ValueError(f'mixed batch: {labelled}/{len(samples)} '
                             f'samples carry a {key} label')
        if labelled:
            batch[key] = np.zeros((B, 3, 3), dtype=dtype)
    for i, s in enumerate(samples):
        n = len(s['z'])
        batch['z'][i, :n] = s['z']
        batch['pos'][i, :n] = s['pos']
        batch['cell'][i] = s['cell']
        if s.get('energy') is not None:
            batch['energy'][i] = s['energy']
        if s.get('force') is not None:
            batch['force'][i, :n] = s['force']
        for key in ('stress', 'virial'):
            if key in batch:
                batch[key][i] = s[key]
        if with_nl:
            batch['nlist_idx'][i, :n] = s['nlist_idx']
            batch['nlist_mask'][i, :n] = s['nlist_mask']
        if with_st:
            for arrs, src in zip(batch['nlist_stair'], s['nlist_stair']):
                for a, src_a in zip(arrs, src):
                    a[i] = src_a
        batch['graph_mask'][i] = True
    return batch


class PaddedLoader:
    '''Batches of identical shape (batch_size, n_pad): atoms padded with
    z = 0, the last partial batch padded with empty graphs. With shuffle,
    each epoch draws one permutation from its own numpy Generator, seeded
    with `seed` (the JAX package's PaddedLoader, shuffle_block None).

    Args:
        dataset: indexable dataset or Subset.
        batch_size: graphs per batch.
        shuffle: reshuffle at every epoch.
        n_pad: atom padding (default: dataset.max_atoms rounded up to a
            multiple of 8).
        seed: shuffling seed.
    '''

    def __init__(self, dataset, batch_size, shuffle=False, n_pad=None,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.n_pad = n_pad or max(8, -(-dataset.max_atoms // 8) * 8)
        self._rng = np.random.default_rng(seed)
        self.dtype = np.dtype(getattr(dataset, 'precision', np.float32))

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        order = (self._rng.permutation(len(self.dataset)) if self.shuffle
                 else np.arange(len(self.dataset)))
        for start in range(len(self)):
            idx = order[start * self.batch_size:(start + 1) * self.batch_size]
            yield collate([self.dataset[i] for i in idx], self.n_pad,
                          self.batch_size, dtype=self.dtype)
