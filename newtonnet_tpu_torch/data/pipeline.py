'''Train/val/test loaders and scaler statistics (the JAX package's
data/pipeline.py, for in-memory, unbucketed data).

The same split cascade and the same random draws, in the same order, from
one np.random.default_rng(seed): train from train_root (the remainder
cascades to val), val from val_root or that remainder, test from test_root
or the val remainder, each a random_split; the loaders shuffle with their
own Generators seeded seed, seed + 1 and seed + 2; last, the statistics
sample. So the splits, the batches and the statistics are the JAX
package's, frame for frame.
'''
import numpy as np

from newtonnet_tpu_torch.data.loader import (
    MolecularInMemoryDataset,
    PaddedLoader,
    random_split,
)
from newtonnet_tpu_torch.data.prelists import NeighborListDataset
from newtonnet_tpu_torch.data.statistics import compute_statistics

_NOT_PORTED = 'is not ported yet (ROADMAP.md A, "data pipeline")'


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
    '''Build the three loaders and the scaler statistics.

    Takes the JAX package's arguments (the YAML `data` section).
    precompute_nlist ({cutoff, k_max, mode}, data/prelists.py) wraps the
    three datasets in NeighborListDataset, whose samples carry their
    lists. What this port does not have raises NotImplementedError:
    in_memory other than True, bucketed, prefetch (ROADMAP.md A4),
    spatial_sort and an integer locality_block. bucket_multiple only
    matters with bucketed.

    Returns:
        (train_gen, val_gen, test_gen, stats)
    '''
    for name, value in (('in_memory', in_memory is not True),
                        ('bucketed', bucketed),
                        ('prefetch', prefetch),
                        ('spatial_sort', spatial_sort),
                        ('locality_block', locality_block not in
                         ('auto', None, 0))):
        if value:
            raise NotImplementedError(f'data: {name} {_NOT_PORTED}')
    if train_root is None:
        raise ValueError('train_root must be provided')
    rng = np.random.default_rng(seed)

    print('Data:')
    train_data = MolecularInMemoryDataset(root=train_root, **dataset_kwargs)
    print(f'load {len(train_data)} data from {train_root}')
    train_size = len(train_data) if train_size is None else train_size
    train_data, left_data = random_split(
        train_data, [train_size, len(train_data) - train_size], rng)
    if val_root is not None:
        val_data = MolecularInMemoryDataset(root=val_root, **dataset_kwargs)
        print(f'load {len(val_data)} data from {val_root}')
    else:
        val_data = left_data
    val_size = len(val_data) if val_size is None else val_size
    val_data, left_data = random_split(
        val_data, [val_size, len(val_data) - val_size], rng)
    if test_root is not None:
        test_data = MolecularInMemoryDataset(root=test_root, **dataset_kwargs)
        print(f'load {len(test_data)} data from {test_root}')
    else:
        test_data = left_data
    test_size = len(test_data) if test_size is None else test_size
    test_data, _ = random_split(
        test_data, [test_size, len(test_data) - test_size], rng)
    print(f'data size (train, val, test): '
          f'{len(train_data)}, {len(val_data)}, {len(test_data)}')

    if precompute_nlist:
        # {cutoff, k_max, mode}: each frame's list built once on the host
        train_data, val_data, test_data = (
            NeighborListDataset(d, **precompute_nlist)
            for d in (train_data, val_data, test_data))

    # one atom padding shared by the three loaders
    if n_pad is None:
        n_pad = max(8, -(-max(d.max_atoms for d in
                              (train_data, val_data, test_data)
                              if len(d) > 0) // 8) * 8)
    train_gen = PaddedLoader(train_data, train_batch_size, shuffle=True,
                             n_pad=n_pad, seed=seed)
    val_gen = PaddedLoader(val_data, val_batch_size,
                           shuffle=len(val_data) > 0, n_pad=n_pad,
                           seed=seed + 1)
    test_gen = PaddedLoader(test_data, test_batch_size,
                            shuffle=len(test_data) > 0, n_pad=n_pad,
                            seed=seed + 2)
    print(f'batch size (train, val, test): '
          f'{train_batch_size}, {val_batch_size}, {test_batch_size}')

    # statistics from one sample of the training set, visited in sorted
    # position order
    size = len(train_data) if stats_size is None else min(stats_size,
                                                          len(train_data))
    stats_idx = np.sort(rng.permutation(len(train_data))[:size])
    stats = compute_statistics(train_data[i] for i in stats_idx)
    return train_gen, val_gen, test_gen, stats
