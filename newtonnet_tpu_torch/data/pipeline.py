'''Train/val/test loaders and scaler statistics (the JAX package's
data/pipeline.py).

The same split cascade and the same random draws, in the same order, from
one np.random.default_rng(seed): train from train_root (the remainder
cascades to val), val from val_root or that remainder, test from test_root
or the val remainder, each a random_split (with the locality block); the
loaders shuffle with their own Generators seeded seed, seed + 1 and
seed + 2; last, the statistics sample. So the splits, the batches and the
statistics are the JAX package's, frame for frame.
'''
import numpy as np

from newtonnet_tpu_torch.data.loader import (
    BucketedLoader,
    MolecularDataset,
    MolecularInMemoryDataset,
    MolecularShardedDataset,
    PaddedLoader,
    PrefetchLoader,
    random_split,
)
from newtonnet_tpu_torch.data.prelists import NeighborListDataset
from newtonnet_tpu_torch.data.statistics import compute_statistics


def spatial_sort(z, pos, cell=None, extra=None, n_shards=1):
    '''Sort each graph's atoms along x (numpy), the order a slab
    decomposition of the atoms needs: periodic graphs by fractional x,
    padding atoms (z == 0) last, the sort stable. The atom axis is padded
    to a multiple of n_shards.

    Args:
        z: (B, N) int; pos: (B, N, 3); cell: (B, 3, 3) or None;
        extra: optional dict of (B, N, ...) per-atom arrays permuted
            alongside (force labels).

    Returns:
        (z_sorted, pos_sorted, extra_sorted).
    '''
    z = np.asarray(z)
    pos = np.asarray(pos)
    B, N = z.shape
    extra = {k: np.asarray(v) for k, v in (extra or {}).items()}
    keys = np.empty((B, N))
    for b in range(B):
        x = pos[b, :, 0]
        if cell is not None and np.any(cell[b] != 0):
            frac = np.linalg.solve(np.asarray(cell[b]).T, pos[b].T).T
            x = frac[:, 0] % 1.0
        keys[b] = np.where(z[b] > 0, x, np.inf)
    order = np.argsort(keys, axis=1, kind='stable')
    take = np.take_along_axis
    z_s = take(z, order, axis=1)
    pos_s = take(pos, order[..., None], axis=1)
    extra_s = {k: take(v, order.reshape(order.shape + (1,) * (v.ndim - 2)),
                       axis=1)
               for k, v in extra.items()}
    pad = (-N) % n_shards
    if pad:
        z_s = np.pad(z_s, ((0, 0), (0, pad)))
        pos_s = np.pad(pos_s, ((0, 0), (0, pad), (0, 0)))
        extra_s = {k: np.pad(v, ((0, 0), (0, pad)) + ((0, 0),) * (v.ndim - 2))
                   for k, v in extra_s.items()}
    return z_s, pos_s, extra_s


class SpatialSortDataset:
    '''A dataset whose frames come with their atoms sorted along
    (fractional) x by spatial_sort, the force labels permuted alongside,
    at access time, so cached datasets need no reprocessing.'''

    def __init__(self, dataset):
        self.dataset = dataset
        for attr in ('max_atoms', 'precision', 'frame_sizes'):
            if hasattr(dataset, attr):
                setattr(self, attr, getattr(dataset, attr))

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        s = dict(self.dataset[i])
        extra = {}
        if s.get('force') is not None:
            extra['force'] = s['force'][None]
        z_s, pos_s, extra_s = spatial_sort(
            s['z'][None], s['pos'][None],
            s['cell'][None] if s.get('cell') is not None else None, extra)
        s['z'], s['pos'] = z_s[0], pos_s[0]
        if 'force' in extra_s:
            s['force'] = extra_s['force'][0]
        return s


# in_memory: True (one cache npz in memory), False (one npz per frame,
# read when indexed) or 'sharded' (shard_{j}.npz packs behind an LRU)
DATASETS = {True: MolecularInMemoryDataset, False: MolecularDataset,
            'sharded': MolecularShardedDataset}


def parse_train_test(
        in_memory=True,
        train_root=None,
        val_root=None,
        test_root=None,
        train_size=None,
        val_size=None,
        test_size=None,
        stats_size=None,
        train_batch_size=32,
        val_batch_size=32,
        test_batch_size=32,
        seed=0,
        n_pad=None,
        bucketed=False,
        bucket_multiple=8,
        precompute_nlist=None,
        prefetch=0,
        locality_block='auto',
        spatial_sort=False,
        **dataset_kwargs):
    '''Build the three loaders and the scaler statistics from the JAX
    package's arguments (the YAML `data` section).

    in_memory picks the dataset (DATASETS); dataset_kwargs go to it
    (precision, units, force_reload, shard_size, cache_shards, ...).
    bucketed: BucketedLoaders, one padding per bucket of bucket_multiple
    atoms, in place of PaddedLoaders with one n_pad (default the largest
    frame rounded up to 8). precompute_nlist ({cutoff, k_max, mode},
    data/prelists.py) wraps the datasets in NeighborListDataset, whose
    samples carry their lists. prefetch > 0 wraps each loader in a
    PrefetchLoader of that depth. locality_block: 'auto' is the dataset's
    shard_size with in_memory 'sharded' and None otherwise; an int is the
    block of random_split and of the training loader's shuffle (of every
    PaddedLoader's); None or 0 splits and shuffles exactly. spatial_sort
    wraps the datasets in SpatialSortDataset.

    Returns:
        (train_gen, val_gen, test_gen, stats)
    '''
    if train_root is None:
        raise ValueError('train_root must be provided')
    cls = DATASETS[in_memory]
    rng = np.random.default_rng(seed)

    print('Data:')
    train_data = cls(root=train_root, **dataset_kwargs)
    print(f'load {len(train_data)} data from {train_root}')
    if locality_block == 'auto':
        locality_block = (getattr(train_data, 'shard_size', None)
                          if in_memory == 'sharded' else None)
    locality_block = locality_block or None
    train_size = len(train_data) if train_size is None else train_size
    train_data, left_data = random_split(
        train_data, [train_size, len(train_data) - train_size], rng,
        block=locality_block)
    if val_root is not None:
        val_data = cls(root=val_root, **dataset_kwargs)
        print(f'load {len(val_data)} data from {val_root}')
    else:
        val_data = left_data
    val_size = len(val_data) if val_size is None else val_size
    val_data, left_data = random_split(
        val_data, [val_size, len(val_data) - val_size], rng,
        block=locality_block)
    if test_root is not None:
        test_data = cls(root=test_root, **dataset_kwargs)
        print(f'load {len(test_data)} data from {test_root}')
    else:
        test_data = left_data
    test_size = len(test_data) if test_size is None else test_size
    test_data, _ = random_split(
        test_data, [test_size, len(test_data) - test_size], rng,
        block=locality_block)
    print(f'data size (train, val, test): '
          f'{len(train_data)}, {len(val_data)}, {len(test_data)}')

    if spatial_sort:
        train_data, val_data, test_data = (
            SpatialSortDataset(d) for d in (train_data, val_data, test_data))
    if precompute_nlist:
        # {cutoff, k_max, mode}: each frame's list built once on the host
        train_data, val_data, test_data = (
            NeighborListDataset(d, **precompute_nlist)
            for d in (train_data, val_data, test_data))

    if bucketed:
        train_gen = BucketedLoader(train_data, train_batch_size,
                                   shuffle=True, seed=seed,
                                   bucket_multiple=bucket_multiple,
                                   shuffle_block=locality_block)
        val_gen = BucketedLoader(val_data, val_batch_size, shuffle=False,
                                 seed=seed + 1,
                                 bucket_multiple=bucket_multiple)
        test_gen = BucketedLoader(test_data, test_batch_size, shuffle=False,
                                  seed=seed + 2,
                                  bucket_multiple=bucket_multiple)
    else:
        # one atom padding shared by the three loaders
        if n_pad is None:
            n_pad = max(8, -(-max(d.max_atoms for d in
                                  (train_data, val_data, test_data)
                                  if len(d) > 0) // 8) * 8)
        train_gen, val_gen, test_gen = (
            PaddedLoader(d, size, shuffle=shuffle, n_pad=n_pad, seed=s,
                         shuffle_block=locality_block)
            for d, size, shuffle, s in (
                (train_data, train_batch_size, True, seed),
                (val_data, val_batch_size, len(val_data) > 0, seed + 1),
                (test_data, test_batch_size, len(test_data) > 0, seed + 2)))
    if prefetch:
        train_gen, val_gen, test_gen = (
            PrefetchLoader(g, depth=prefetch)
            for g in (train_gen, val_gen, test_gen))
    print(f'batch size (train, val, test): '
          f'{train_batch_size}, {val_batch_size}, {test_batch_size}')

    # statistics from one sample of the training set, visited in sorted
    # position order (sequential access for the sharded dataset)
    size = len(train_data) if stats_size is None else min(stats_size,
                                                          len(train_data))
    stats_idx = np.sort(rng.permutation(len(train_data))[:size])
    stats = compute_statistics(train_data[i] for i in stats_idx)
    return train_gen, val_gen, test_gen, stats
