'''Samples from raw files, datasets and padded batching (the JAX package's
data/loader.py).

`parse_xyz` and `parse_npz` read frames into Samples in eV and Angstrom
(extxyz files through the C++ parser of csrc/host/extxyz.cpp, those with
stress=/virial= labels through the Python reader, where the JAX package
routes them). A dataset root holds raw/*.{xyz,extxyz,npz}, processed once
into root/processed/, the JAX package's cache layout, so either package
reads a cache the other wrote: `MolecularInMemoryDataset` (data.npz, every
frame in memory), `MolecularDataset` (one data_{i}.npz per frame, read
when indexed) and `MolecularShardedDataset` (shard_{j}.npz packs and
meta.npz, an LRU of decoded shards). `Subset` and `random_split` cut a
dataset (with a locality block: runs of consecutive frames); `collate`
pads Samples into one static-shape batch (atoms padded with z = 0,
missing graphs with graph_mask False); `PaddedLoader` (one n_pad) and
`BucketedLoader` (one n_pad per size bucket) iterate over batches, and
`PrefetchLoader` assembles them on a background thread. Every random draw
is the JAX package's, in its order, so splits and batches are its own,
frame for frame.
'''
import os
import os.path as osp

import numpy as np

from newtonnet_tpu_torch.data.units import get_unit
from newtonnet_tpu_torch.data.xyz import parse_extxyz, read_extxyz

EV_ANGSTROM = {'length': 1.0, 'energy': 1.0}


class Sample(dict):
    '''One frame: z (n,), pos (n, 3), cell (3, 3), energy, force (n, 3).'''
    __getattr__ = dict.__getitem__


def parse_xyz(raw_path, units=EV_ANGSTROM, pre_transform=None,
              pre_filter=None):
    '''Read an (ext)xyz file into Samples. `units` gives the factors that
    turn the file's length and energy units into Angstrom and eV (the
    identity for data already in eV/Angstrom). pre_filter(sample) False
    drops a frame; pre_transform(sample) replaces it.

    The C++ parser reads the file unless its first comment line carries
    stress= or virial= (the parser decodes neither), as the JAX package's
    loader chooses; the two branches wrap periodic positions as the JAX
    package's do, so each file's Samples are its own, bit for bit.'''
    if not _has_tensor_labels(raw_path):
        return _parse_xyz_native(raw_path, units, pre_transform, pre_filter)
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
        _keep(samples, sample, pre_transform, pre_filter)
    return samples


def _keep(samples, sample, pre_transform, pre_filter):
    '''Append the sample unless pre_filter drops it, pre_transformed.'''
    if pre_filter is not None and not pre_filter(sample):
        return
    if pre_transform is not None:
        sample = pre_transform(sample)
    samples.append(sample)


def _has_tensor_labels(raw_path):
    '''True when the first frame's comment line carries stress= or
    virial=.'''
    try:
        with open(raw_path) as f:
            f.readline()
            comment = f.readline()
        return 'stress=' in comment or 'virial=' in comment
    except OSError:
        return False


def _parse_xyz_native(raw_path, units, pre_transform=None, pre_filter=None):
    '''parse_xyz through the C++ parser: periodic positions wrapped by
    the fractional coordinates of the cell with its aperiodic rows
    zeroed, as the JAX package's native branch wraps them.'''
    data = parse_extxyz(raw_path)
    samples = []
    for i in range(len(data['ptr']) - 1):
        lo, hi = data['ptr'][i], data['ptr'][i + 1]
        cell = data['cell'][i].copy()
        pbc = data['pbc'][i]
        cell[~pbc] = 0.0
        pos = data['pos'][lo:hi]
        if pbc.any() and cell.any():
            frac = pos @ np.linalg.inv(cell)
            frac = np.where(pbc[None, :], frac % 1.0, frac)
            pos = frac @ cell
        sample = Sample(
            z=data['z'][lo:hi],
            pos=pos * units['length'],
            cell=cell * units['length'],
            energy=(np.float64(data['energy'][i]) * units['energy']
                    if data['energy'] is not None else None),
            force=(data['forces'][lo:hi] * units['energy'] / units['length']
                   if data['forces'] is not None else None),
        )
        _keep(samples, sample, pre_transform, pre_filter)
    return samples


def parse_npz(raw_path, units=EV_ANGSTROM, pre_transform=None,
              pre_filter=None):
    '''Read an npz file with keys Z (n,) or (m, n), R (m, n, 3) or (n, 3),
    optional L (3,) or (3, 3), E (m,) and F (m, n, 3) into Samples.'''
    raw = np.load(raw_path)
    z = raw['Z'].astype(np.int32)
    pos = raw['R'].astype(np.float64)
    if pos.ndim == 2:
        pos = pos[None]
    cell = raw['L'].astype(np.float64) if 'L' in raw else np.zeros(3)
    if cell.size == 3:
        cell = np.diag(cell.ravel())
    elif cell.size == 9:
        cell = cell.reshape(3, 3)
    else:
        raise ValueError('The lattice must be a single 3x3 matrix per file.')
    energy = raw['E'].reshape(-1) if 'E' in raw else None
    force = raw['F'] if 'F' in raw else None
    samples = []
    for i in range(pos.shape[0]):
        sample = Sample(
            z=(z if z.ndim < 2 else z[i]).reshape(-1),
            pos=pos[i].reshape(-1, 3) * units['length'],
            cell=cell * units['length'],
            energy=(np.float64(energy[i]) * units['energy']
                    if energy is not None else None),
            force=(force[i].reshape(-1, 3) * units['energy'] / units['length']
                   if force is not None else None),
        )
        _keep(samples, sample, pre_transform, pre_filter)
    return samples


def _parse_raw(raw_path, units, pre_transform, pre_filter):
    if raw_path.endswith('.npz'):
        return parse_npz(raw_path, units, pre_transform, pre_filter)
    if raw_path.endswith(('.xyz', '.extxyz')):
        return parse_xyz(raw_path, units, pre_transform, pre_filter)
    raise ValueError(f'unsupported raw file {raw_path}')


def _pack(samples):
    '''Samples as the flat ragged arrays of one npz: ptr, z, pos, cell,
    energy and force (empty where the samples carry none), and stress /
    virial (B, 3, 3) where they carry them.'''
    ptr = np.zeros(len(samples) + 1, dtype=np.int64)
    for i, s in enumerate(samples):
        ptr[i + 1] = ptr[i] + len(s['z'])
    has_energy = samples[0]['energy'] is not None
    has_force = samples[0]['force'] is not None
    packed = {
        'ptr': ptr,
        'z': np.concatenate([s['z'] for s in samples]),
        'pos': np.concatenate([s['pos'] for s in samples]),
        'cell': np.stack([s['cell'] for s in samples]),
        'energy': (np.array([s['energy'] for s in samples])
                   if has_energy else np.zeros(0)),
        'force': (np.concatenate([s['force'] for s in samples])
                  if has_force else np.zeros((0, 3))),
    }
    for key in ('stress', 'virial'):
        if samples[0].get(key) is not None:
            packed[key] = np.stack([s[key] for s in samples])
    return packed


def _savez(path, **arrays):
    '''np.savez into `path` through a file of this process renamed into
    place, so that a process reading the cache never sees it half
    written.'''
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class MolecularInMemoryDataset:
    '''Every frame of `root`/raw/*.{xyz,extxyz,npz} (sorted by name) in
    memory, processed once into root/processed/data.npz (the arrays of
    _pack, in float64) and read from there after.

    Args:
        root: directory holding a raw/ subdirectory.
        precision: numpy dtype of the float data (default float32).
        data_length_unit / data_energy_unit: units of the raw files
            (converted into eV and Angstrom).
        force_reload: process the raw files even where the cache exists.
        pre_transform / pre_filter: per-sample hooks applied when the raw
            files are processed.
    '''

    def __init__(self, root, precision=np.float32, data_length_unit='Ang',
                 data_energy_unit='eV', force_reload=False,
                 pre_transform=None, pre_filter=None):
        self._setup(root, precision, data_length_unit, data_energy_unit,
                    pre_transform, pre_filter)
        path = osp.join(self.processed_dir, 'data.npz')
        if force_reload or not osp.exists(path):
            self.process()
        data = np.load(path)
        self._ptr = data['ptr']
        self._z = data['z']
        self._pos = data['pos'].astype(self.precision)
        self._cell = data['cell'].astype(self.precision)
        self._energy = data['energy'].astype(self.precision)
        self._force = data['force'].astype(self.precision)
        self._stress = (data['stress'].astype(self.precision)
                        if 'stress' in data.files else None)
        self._virial = (data['virial'].astype(self.precision)
                        if 'virial' in data.files else None)

    def _setup(self, root, precision, data_length_unit, data_energy_unit,
               pre_transform, pre_filter):
        self.root = root
        self.precision = np.dtype(precision)
        self.units = {'length': get_unit(data_length_unit),
                      'energy': get_unit(data_energy_unit)}
        self.pre_transform = pre_transform
        self.pre_filter = pre_filter

    @property
    def raw_dir(self):
        return osp.join(self.root, 'raw')

    @property
    def processed_dir(self):
        return osp.join(self.root, 'processed')

    @property
    def raw_paths(self):
        names = sorted(name for name in os.listdir(self.raw_dir)
                       if name.endswith(('.npz', '.xyz', '.extxyz')))
        return [osp.join(self.raw_dir, n) for n in names]

    def _raw_samples(self):
        for raw_path in self.raw_paths:
            yield from _parse_raw(raw_path, self.units, self.pre_transform,
                                  self.pre_filter)

    def process(self):
        os.makedirs(self.processed_dir, exist_ok=True)
        _savez(osp.join(self.processed_dir, 'data.npz'),
               **_pack(list(self._raw_samples())))

    def __len__(self):
        return len(self._ptr) - 1

    def __getitem__(self, idx):
        lo, hi = self._ptr[idx], self._ptr[idx + 1]
        s = Sample(
            z=self._z[lo:hi], pos=self._pos[lo:hi], cell=self._cell[idx],
            energy=self._energy[idx] if self._energy.size else None,
            force=self._force[lo:hi] if self._force.size else None)
        if self._stress is not None:
            s['stress'] = self._stress[idx]
        if self._virial is not None:
            s['virial'] = self._virial[idx]
        return s

    @property
    def max_atoms(self):
        return int(np.max(self.frame_sizes))

    @property
    def frame_sizes(self):
        '''Each frame's atom count, from the metadata alone.'''
        return (self._ptr[1:] - self._ptr[:-1]).astype(np.int64)


class MolecularDataset(MolecularInMemoryDataset):
    '''On-disk variant: root/processed/ holds one data_{i}.npz per frame
    (n, z, pos, cell, energy (NaN where absent), force (empty where
    absent), stress / virial where labelled), each read when indexed.'''

    def __init__(self, root, precision=np.float32, data_length_unit='Ang',
                 data_energy_unit='eV', force_reload=False,
                 pre_transform=None, pre_filter=None):
        self._setup(root, precision, data_length_unit, data_energy_unit,
                    pre_transform, pre_filter)
        if force_reload or not self._processed_files():
            self.process()
        self._files = self._processed_files()
        self._n_atoms = np.array(
            [int(np.load(f)['n']) for f in self._files])

    def _processed_files(self):
        if not osp.exists(self.processed_dir):
            return []
        names = [n for n in os.listdir(self.processed_dir)
                 if n.startswith('data_') and n.endswith('.npz')]
        names.sort(key=lambda n: int(n[5:-4]))
        return [osp.join(self.processed_dir, n) for n in names]

    def process(self):
        os.makedirs(self.processed_dir, exist_ok=True)
        for idx, s in enumerate(self._raw_samples()):
            extra = {k: s[k] for k in ('stress', 'virial')
                     if s.get(k) is not None}
            _savez(
                osp.join(self.processed_dir, f'data_{idx}.npz'),
                n=len(s['z']), z=s['z'], pos=s['pos'], cell=s['cell'],
                energy=(np.float64(s['energy'])
                        if s['energy'] is not None else np.nan),
                force=(s['force'] if s['force'] is not None
                       else np.zeros((0, 3))), **extra)

    def __len__(self):
        return len(self._files)

    def __getitem__(self, idx):
        d = np.load(self._files[idx])
        energy = d['energy']
        force = d['force']
        s = Sample(
            z=d['z'].astype(np.int32),
            pos=d['pos'].astype(self.precision),
            cell=d['cell'].astype(self.precision),
            energy=(self.precision.type(energy) if not np.isnan(energy)
                    else None),
            force=force.astype(self.precision) if force.size else None)
        for key in ('stress', 'virial'):
            if key in d.files:
                s[key] = d[key].astype(self.precision)
        return s

    @property
    def frame_sizes(self):
        return self._n_atoms.astype(np.int64)


class MolecularShardedDataset(MolecularInMemoryDataset):
    '''Sharded on-disk variant for very large datasets: root/processed/
    holds shard_{j}.npz packs of `shard_size` frames (the arrays of _pack)
    and meta.npz (n_atoms per frame, offsets of the shards). Processing
    streams the raw frames shard by shard, and reading keeps an LRU of
    `cache_shards` decoded shards; `shard_loads` counts the shards
    decoded (the LRU's misses).'''

    def __init__(self, root, precision=np.float32, data_length_unit='Ang',
                 data_energy_unit='eV', force_reload=False,
                 pre_transform=None, pre_filter=None, shard_size=8192,
                 cache_shards=2):
        self._setup(root, precision, data_length_unit, data_energy_unit,
                    pre_transform, pre_filter)
        self.shard_size = int(shard_size)
        self.cache_shards = max(1, int(cache_shards))
        meta_path = osp.join(self.processed_dir, 'meta.npz')
        if force_reload or not osp.exists(meta_path):
            self.process()
        meta = np.load(meta_path)
        self._n_atoms = meta['n_atoms']
        self._shard_offsets = meta['offsets']
        self._cache = {}
        self._cache_order = []
        self.shard_loads = 0

    def process(self):
        os.makedirs(self.processed_dir, exist_ok=True)
        pending, n_atoms, offsets = [], [], [0]

        def flush():
            if not pending:
                return
            _savez(osp.join(self.processed_dir,
                            f'shard_{len(offsets) - 1}.npz'),
                   **_pack(pending))
            offsets.append(offsets[-1] + len(pending))
            pending.clear()

        for s in self._raw_samples():
            pending.append(s)
            n_atoms.append(len(s['z']))
            if len(pending) == self.shard_size:
                flush()
        flush()
        _savez(osp.join(self.processed_dir, 'meta.npz'),
               n_atoms=np.asarray(n_atoms, np.int32),
               offsets=np.asarray(offsets, np.int64))

    def _shard(self, j):
        if j not in self._cache:
            if len(self._cache) >= self.cache_shards:
                self._cache.pop(self._cache_order.pop(0))
            d = np.load(osp.join(self.processed_dir, f'shard_{j}.npz'))
            self._cache[j] = {k: d[k] for k in d.files}
            self._cache_order.append(j)
            self.shard_loads += 1
        return self._cache[j]

    def __len__(self):
        return int(self._shard_offsets[-1])

    def __getitem__(self, idx):
        idx = int(idx)
        if idx < 0:
            idx += len(self)
        j = int(np.searchsorted(self._shard_offsets, idx, 'right') - 1)
        d = self._shard(j)
        i = idx - int(self._shard_offsets[j])
        lo, hi = d['ptr'][i], d['ptr'][i + 1]
        s = Sample(
            z=d['z'][lo:hi].astype(np.int32),
            pos=d['pos'][lo:hi].astype(self.precision),
            cell=d['cell'][i].astype(self.precision),
            energy=(self.precision.type(d['energy'][i])
                    if d['energy'].size else None),
            force=(d['force'][lo:hi].astype(self.precision)
                   if d['force'].size else None))
        for key in ('stress', 'virial'):
            if key in d:
                s[key] = d[key][i].astype(self.precision)
        return s

    @property
    def frame_sizes(self):
        return self._n_atoms


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

    @property
    def frame_sizes(self):
        return np.asarray(self.dataset.frame_sizes)[self.indices]


def random_split(dataset, sizes, rng, block=None):
    '''Split into Subsets of the given sizes with draws from the numpy
    Generator `rng`, as the JAX package splits.

    block None: consecutive pieces of one permutation. An int: stratified
    over blocks of `block` consecutive frames, visited in a random order;
    each block gives every subset a contiguous run in proportion to what
    that subset still needs (largest remainders take the leftover frames,
    so the sizes are exact), the subsets' order within the block rotated
    at random. Each subset's indices are then runs of consecutive frames,
    the locality a sharded dataset needs to decode a shard or two per
    batch.'''
    if sum(sizes) != len(dataset):
        raise ValueError(f'sizes {sizes} do not add up to {len(dataset)}')
    if block is None:
        perm = rng.permutation(len(dataset))
        out, start = [], 0
        for size in sizes:
            out.append(Subset(dataset, perm[start:start + size]))
            start += size
        return out
    block = int(block)
    n = len(dataset)
    sizes_arr = np.asarray(sizes, np.int64)
    counts = np.zeros(len(sizes), np.int64)
    parts = [[] for _ in sizes]
    remaining = n
    for bi in rng.permutation(-(-n // block)):
        lo = bi * block
        nb = min(lo + block, n) - lo
        need = sizes_arr - counts
        base = need * nb // remaining
        leftover = nb - int(base.sum())
        if leftover:
            remainder = need * nb % remaining
            base[np.argsort(-remainder, kind='stable')[:leftover]] += 1
        rot = int(rng.integers(len(sizes))) if len(sizes) > 1 else 0
        pos = lo
        for j in np.roll(np.arange(len(sizes)), -rot):
            parts[j].append(np.arange(pos, pos + base[j]))
            pos += int(base[j])
        counts += base
        remaining -= nb
    return [Subset(dataset, np.concatenate(p) if p
                   else np.zeros(0, np.int64)) for p in parts]


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


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _block_shuffled(positions, rng, block):
    '''`positions` shuffled by the numpy Generator `rng`: one permutation
    (block None), or, with a block, runs of `block` consecutive entries,
    each shuffled within, in a shuffled order (the run order drawn first),
    so that a window of a batch's entries stays within a run or two.'''
    if block is None:
        return positions[rng.permutation(len(positions))]
    block = int(block)
    runs = [positions[s:s + block] for s in range(0, len(positions), block)]
    if not runs:
        return positions
    order = rng.permutation(len(runs))
    return np.concatenate([runs[r][rng.permutation(len(runs[r]))]
                           for r in order])


class PaddedLoader:
    '''Batches of identical shape (batch_size, n_pad): atoms padded with
    z = 0, the last partial batch padded with empty graphs (or dropped,
    drop_last). With shuffle, each epoch draws its order from the loader's
    own numpy Generator, seeded with `seed` (_block_shuffled, with
    shuffle_block as the block).

    Args:
        dataset: indexable dataset or Subset.
        batch_size: graphs per batch.
        shuffle: reshuffle at every epoch.
        n_pad: atom padding (default: dataset.max_atoms rounded up to a
            multiple of 8).
        seed: shuffling seed.
        drop_last: drop the last partial batch instead of padding it.
        shuffle_block: locality block of the shuffle; None shuffles
            exactly.
    '''

    def __init__(self, dataset, batch_size, shuffle=False, n_pad=None,
                 seed=0, drop_last=False, shuffle_block=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.n_pad = n_pad or max(8, _round_up(dataset.max_atoms, 8))
        self.drop_last = drop_last
        self.shuffle_block = shuffle_block
        self._rng = np.random.default_rng(seed)
        self.dtype = np.dtype(getattr(dataset, 'precision', np.float32))

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = _block_shuffled(order, self._rng, self.shuffle_block)
        for start in range(len(self)):
            idx = order[start * self.batch_size:(start + 1) * self.batch_size]
            yield collate([self.dataset[i] for i in idx], self.n_pad,
                          self.batch_size, dtype=self.dtype)


class BucketedLoader:
    '''Batches padded per size bucket, for datasets of molecules of
    different sizes: each frame goes to the bucket of its atom count
    rounded up to a multiple of `bucket_multiple` (at least that
    multiple), and each batch is padded to its bucket's size, so a small
    molecule does not pay for the largest one's padding.

    An epoch with shuffle: each bucket's frames shuffled in turn
    (_block_shuffled with shuffle_block), cut into batches, then the
    batches' order drawn as one permutation, all from the loader's own
    numpy Generator (seeded with `seed`), as the JAX package draws them.
    Without shuffle, the buckets in increasing size, each in frame
    order.'''

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 bucket_multiple=8, shuffle_block=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.bucket_multiple = bucket_multiple
        self.shuffle_block = shuffle_block
        self._rng = np.random.default_rng(seed)
        self.dtype = np.dtype(getattr(dataset, 'precision', np.float32))
        if hasattr(dataset, 'frame_sizes'):
            # from the metadata: no frame is decoded to learn its size
            sizes = np.asarray(dataset.frame_sizes)
        else:
            sizes = np.array([len(dataset[i]['z'])
                              for i in range(len(dataset))])
        self._bucket_of = np.maximum(bucket_multiple,
                                     _round_up(sizes, bucket_multiple))
        self.buckets = sorted(set(self._bucket_of.tolist()))

    def __len__(self):
        return sum(-(-int(np.sum(self._bucket_of == b)) // self.batch_size)
                   for b in self.buckets)

    def __iter__(self):
        batches = []
        for b in self.buckets:
            idxs = np.nonzero(self._bucket_of == b)[0]
            if self.shuffle:
                idxs = _block_shuffled(idxs, self._rng, self.shuffle_block)
            for start in range(0, len(idxs), self.batch_size):
                batches.append((b, idxs[start:start + self.batch_size]))
        if self.shuffle:
            # the batch order is always drawn whole: shuffle_block only
            # bounds how far apart one batch's frames sit
            batches = [batches[i]
                       for i in self._rng.permutation(len(batches))]
        for n_pad, idxs in batches:
            yield collate([self.dataset[i] for i in idxs], n_pad,
                          self.batch_size, dtype=self.dtype)


class PrefetchLoader:
    '''A background thread assembles the next `depth` batches of `loader`
    (the samples, their cached lists, the padding) while the caller
    computes. An exception in the thread is raised to the caller at the
    batch where it happened. Each epoch starts a thread of its own; the
    thread is a daemon, so an epoch left unfinished leaves at most one
    blocked thread holding `depth` batches.

    n_pad, batch_size, dataset, buckets, dtype and _rng (the shuffling
    Generator the Trainer checkpoints as loader_rng_state) are the
    wrapped loader's own.'''

    def __init__(self, loader, depth=2):
        self.loader = loader
        self.depth = max(1, int(depth))
        for attr in ('n_pad', 'batch_size', 'dataset', 'buckets', 'dtype',
                     '_rng'):
            if hasattr(loader, attr):
                setattr(self, attr, getattr(loader, attr))

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading
        q = queue.Queue(maxsize=self.depth)
        end = object()

        def worker():
            try:
                for batch in self.loader:
                    q.put(batch)
                q.put(end)
            except BaseException as e:  # raised to the consumer
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
