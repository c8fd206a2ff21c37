'''The port's data pipeline (newtonnet_tpu_torch/data) against the JAX
package's (newtonnet_tpu/data) on the CPU: the same files, seeds and
arguments give array-equal samples, splits, batches and statistics.

Cases: parse_xyz through the C++ parser (csrc/host/extxyz.cpp) and through
the Python reader, each bitwise against the JAX package's parse, on
aperiodic, periodic and stress-labelled files, and the two branches'
arrays against each other; a failed build of the parser raises;
parse_npz; the three datasets (in memory, one npz per frame, sharded with
its LRU and shard_loads) over each package's cache, written by either;
random_split with a locality block; PaddedLoader with shuffle_block;
BucketedLoader; parse_train_test with bucketed, sharded, on-disk, locality
and prefetched loaders and spatial_sort, two epochs of every loader;
PrefetchLoader's exceptions and its Generator; the preprocess entry
point. The datasets are copies of data/lj_hetero and data/md17_aspirin
in temporary directories, so no cache is written into the tree.
'''
import os
import shutil

import numpy as np
import pytest

from newtonnet_tpu.data import loader as jl
from newtonnet_tpu.data import pipeline as jp
from newtonnet_tpu.parallel.halo import spatial_sort as jax_spatial_sort
from newtonnet_tpu_torch.data import loader as tl
from newtonnet_tpu_torch.data import pipeline as tp
from newtonnet_tpu_torch.data import preprocess
from newtonnet_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HETERO = os.path.join(ROOT, 'data', 'lj_hetero')
ASPIRIN = os.path.join(ROOT, 'data', 'md17_aspirin')
UNITS = {'length': 1.0, 'energy': 1.0}
JAX_DATASETS = {True: jl.MolecularInMemoryDataset, False: jl.MolecularDataset,
                'sharded': jl.MolecularShardedDataset}


def _copy(src_root, splits, out):
    for split in splits:
        shutil.copytree(os.path.join(src_root, split, 'raw'),
                        os.path.join(out, split, 'raw'))
    return str(out)


@pytest.fixture(scope='module')
def hetero(tmp_path_factory):
    '''Two copies of data/lj_hetero, one for each package's caches.'''
    return [_copy(HETERO, ('train', 'test'), tmp_path_factory.mktemp(p))
            for p in ('jax', 'port')]


def _frames_text(n_frames, seed, periodic=False, stress=False):
    '''An extxyz file's text: LJ-like clusters of 3-7 atoms with energies
    and forces from a numpy seed; periodic frames in a skewed cell with
    atoms outside it (so the parsers wrap them); optionally stress
    labels.'''
    rs = np.random.RandomState(seed)
    lines = []
    for _ in range(n_frames):
        n = rs.randint(3, 8)
        comment = ['Properties=species:S:1:pos:R:3:forces:R:3',
                   f'energy={rs.randn():.12f}']
        if periodic:
            cell = np.diag(rs.uniform(6.0, 9.0, 3))
            cell[1, 0] = rs.uniform(0.5, 1.5)
            comment.append('Lattice="' + ' '.join(
                f'{v:.10f}' for v in cell.ravel()) + '"')
            comment.append('pbc="T T T"')
            pos = rs.uniform(-4.0, 12.0, (n, 3))
        else:
            comment.append('pbc="F F F"')
            pos = rs.randn(n, 3) * 2.0
        if stress:
            comment.append('stress="' + ' '.join(
                f'{v:.10f}' for v in rs.randn(9) * 1e-3) + '"')
        lines += [str(n), ' '.join(comment)]
        for p, f in zip(pos, rs.randn(n, 3)):
            sym = 'Ar' if rs.rand() < 0.7 else 'Ne'
            lines.append(f'{sym} ' + ' '.join(f'{v:.10f}' for v in p)
                         + ' ' + ' '.join(f'{v:.10f}' for v in f))
    return '\n'.join(lines) + '\n'


def _same_samples(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in b:
            if b[key] is None:
                assert a[key] is None, key
                continue
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, key)


@pytest.mark.parametrize('kind', ['aperiodic', 'periodic', 'stress'])
def test_parse_xyz_matches_jax_bitwise(tmp_path, kind):
    '''parse_xyz takes the C++ parser where the JAX package's loader takes
    its native one (no stress=/virial= on the first comment line) and the
    Python reader elsewhere: the Samples are the JAX package's bit for
    bit. Both branches give the same raw arrays.'''
    path = str(tmp_path / f'{kind}.extxyz')
    with open(path, 'w') as f:
        f.write(_frames_text(6, seed=len(kind), periodic=kind != 'aperiodic',
                             stress=kind == 'stress'))
    units = {'length': 0.52917721, 'energy': 27.211386}
    got = tl.parse_xyz(path, units)
    _same_samples(got, jl.parse_xyz(path, units))
    assert ('stress' in got[0]) == (kind == 'stress')
    if kind == 'stress':
        _same_samples(tl._parse_xyz_native(path, UNITS),
                      jl._parse_xyz_native(path, UNITS))
        return
    python = [tl.Sample(
        z=f.numbers, pos=f.positions, cell=f.cell, energy=f.energy,
        force=f.forces) for f in tl.read_extxyz(path)]
    raw = tl.parse_extxyz(path)
    for i, s in enumerate(python):
        lo, hi = raw['ptr'][i], raw['ptr'][i + 1]
        np.testing.assert_array_equal(raw['z'][lo:hi], s['z'])
        np.testing.assert_array_equal(raw['pos'][lo:hi], s['pos'])
        np.testing.assert_array_equal(raw['forces'][lo:hi], s['force'])
        np.testing.assert_array_equal(raw['cell'][i], s['cell'])
        assert raw['energy'][i] == s['energy']
    if kind == 'periodic':
        # the two branches wrap by one formula: the same Samples here
        wrapped = [dict(s, pos=f.wrapped_positions()) for s, f in
                   zip(python, tl.read_extxyz(path))]
        for a, b in zip(tl.parse_xyz(path), wrapped):
            np.testing.assert_array_equal(a['pos'], b['pos'])


def test_vendored_files_parse_as_the_jax_package_parses():
    '''Both vendored datasets' raw files (the C++ parser's branch).'''
    for path in (os.path.join(HETERO, 'test', 'raw', 'lj_clusters.extxyz'),
                 os.path.join(ASPIRIN, 'ccsd_test', 'raw',
                              'aspirin_ccsd-test.xyz')):
        _same_samples(tl.parse_xyz(path), jl.parse_xyz(path, UNITS))


def test_a_failed_parser_build_raises(tmp_path, monkeypatch):
    '''A broken extxyz.cpp raises the compiler's output from parse_xyz:
    no quiet fallback to the Python reader.'''
    host = tmp_path / 'host'
    host.mkdir()
    (host / 'extxyz.cpp').write_text('extern "C" void* xyz_parse( {\n')
    monkeypatch.setattr(_build, 'HOST_DIR', str(host))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_LIBS', {})
    path = os.path.join(HETERO, 'test', 'raw', 'lj_clusters.extxyz')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        tl.parse_xyz(path)


def test_parse_npz_and_hooks_match_jax(tmp_path):
    '''An npz raw file (Z per frame, R, a diagonal L, E, F) in a dataset
    root, with a pre_filter and a pre_transform: the JAX package's
    Samples and dataset.'''
    rs = np.random.RandomState(3)
    m, n = 5, 4
    root = tmp_path / 'npz'
    (root / 'raw').mkdir(parents=True)
    np.savez(root / 'raw' / 'frames.npz', Z=rs.randint(1, 9, (m, n)),
             R=rs.randn(m, n, 3), L=np.array([10.0, 11.0, 12.0]),
             E=rs.randn(m), F=rs.randn(m, n, 3))
    path = str(root / 'raw' / 'frames.npz')
    units = {'length': 1.0, 'energy': 0.5}

    def keep(s):
        return s['energy'] < 0.5

    def shift(s):
        return tl.Sample(s, pos=s['pos'] + 1.0)
    _same_samples(tl.parse_npz(path, units, shift, keep),
                  jl.parse_npz(path, units, shift, keep))
    port = tl.MolecularInMemoryDataset(str(root), pre_filter=keep)
    shutil.rmtree(root / 'processed')
    jax = jl.MolecularInMemoryDataset(str(root), pre_filter=keep)
    assert 0 < len(port) == len(jax) < m
    _same_samples([port[i] for i in range(len(port))],
                  [jax[i] for i in range(len(jax))])


@pytest.mark.parametrize('in_memory', [True, False, 'sharded'])
def test_datasets_read_each_others_caches(tmp_path, in_memory):
    '''Each dataset class over a cache the other package wrote: the
    frames, frame_sizes and max_atoms of the JAX dataset, array for
    array; a force_reload rewrites the cache.'''
    kw = {'shard_size': 50, 'cache_shards': 2} if in_memory == 'sharded' \
        else {}
    for k, (writer, reader) in enumerate(((JAX_DATASETS, tp.DATASETS),
                                          (tp.DATASETS, JAX_DATASETS))):
        root = _copy(HETERO, ('test',), tmp_path / str(k))
        first = writer[in_memory](root=os.path.join(root, 'test'), **kw)
        second = reader[in_memory](root=os.path.join(root, 'test'), **kw)
        assert type(first).__module__ != type(second).__module__
        assert len(first) == len(second) == 180
        np.testing.assert_array_equal(second.frame_sizes, first.frame_sizes)
        assert second.max_atoms == first.max_atoms
        _same_samples([second[i] for i in range(len(second))],
                      [first[i] for i in range(len(first))])
    again = tp.DATASETS[in_memory](root=os.path.join(root, 'test'),
                                   force_reload=True, **kw)
    _same_samples([again[i] for i in (0, 179)], [first[i] for i in (0, 179)])


def test_sharded_lru_counts_the_jax_shard_loads(tmp_path):
    '''The sharded dataset's LRU of cache_shards decoded shards misses
    where the JAX package's does: the same shard_loads after the same
    accesses (a locality-shuffled epoch, then an exact one).'''
    roots = [_copy(HETERO, ('train',), tmp_path / p) for p in ('j', 'p')]
    kw = dict(shard_size=64, cache_shards=2)
    jd = jl.MolecularShardedDataset(os.path.join(roots[0], 'train'), **kw)
    td = tl.MolecularShardedDataset(os.path.join(roots[1], 'train'), **kw)
    loads = []
    for block in (64, None):
        rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
        order_j = jl._block_shuffled(np.arange(len(jd)), rng_j, block)
        order_t = tl._block_shuffled(np.arange(len(td)), rng_t, block)
        np.testing.assert_array_equal(order_t, order_j)
        for i in order_t:
            td[i]
            jd[i]
        assert td.shard_loads == jd.shard_loads
        loads.append(td.shard_loads - sum(loads))
    # a shard per run of the block shuffle; the exact one thrashes
    assert loads[0] <= 13 < 10 * loads[0] < loads[1]


@pytest.mark.parametrize('block', [None, 1, 7, 64])
def test_random_split_with_blocks_matches_jax(block):
    '''random_split(block=...) draws the JAX package's split: the same
    indices, each subset runs of consecutive frames within a block.'''
    class Frames:
        def __len__(self):
            return 500
    sizes = [300, 120, 80]
    got = tl.random_split(Frames(), sizes, np.random.default_rng(1), block)
    want = jl.random_split(Frames(), sizes, np.random.default_rng(1), block)
    for g, w, size in zip(got, want, sizes):
        np.testing.assert_array_equal(g.indices, w.indices)
        assert len(g) == size
    assert sorted(np.concatenate([g.indices for g in got])) == \
        list(range(500))


def test_padded_loader_shuffle_block_matches_jax(hetero):
    '''PaddedLoader with a shuffle block and drop_last: two epochs of the
    JAX package's batches.'''
    datasets = (jl.MolecularInMemoryDataset(os.path.join(hetero[0], 'test')),
                tl.MolecularInMemoryDataset(os.path.join(hetero[1], 'test')))
    for kw in (dict(shuffle_block=16), dict(shuffle_block=None,
                                            drop_last=True)):
        loaders = [mod.PaddedLoader(d, 24, shuffle=True, seed=4, **kw)
                   for mod, d in zip((jl, tl), datasets)]
        assert len(loaders[0]) == len(loaders[1])
        for _ in range(2):
            _same_batches(*loaders)


def _same_batches(jax_gen, port_gen):
    n = 0
    for bj, bt in zip(jax_gen, port_gen):
        assert bj.keys() == bt.keys()
        for key in bj:
            assert bt[key].dtype == bj[key].dtype, key
            np.testing.assert_array_equal(bt[key], bj[key], key)
        n += 1
    assert n == len(jax_gen) == len(port_gen)


def _same_stats(sj, st):
    for key, val in sj.items():
        if isinstance(val, dict):
            for part in val:
                np.testing.assert_array_equal(np.asarray(st[key][part]),
                                              np.asarray(val[part]))
        else:
            assert st[key] == val


@pytest.mark.parametrize('data', [
    dict(bucketed=True),
    dict(bucketed=True, locality_block=32, bucket_multiple=16),
    dict(in_memory='sharded', shard_size=64, locality_block='auto',
         bucketed=True, prefetch=2),
    dict(in_memory=False, locality_block=16, train_size=100, val_size=30,
         test_size=40),
    dict(spatial_sort=True, prefetch=1),
], ids=['bucketed', 'bucketed_block', 'sharded_prefetch', 'on_disk_block',
        'spatial_sort'])
def test_parse_train_test_matches_jax(hetero, data):
    '''parse_train_test on data/lj_hetero's copies: the loaders' lengths,
    n_pad and buckets, two epochs of every loader's batches and the
    statistics are the JAX package's.'''
    kw = dict(dict(train_size=300, val_size=60, train_batch_size=20,
                   val_batch_size=40, test_batch_size=40, seed=3), **data)
    outs = [mod.parse_train_test(
        train_root=os.path.join(root, 'train'),
        test_root=os.path.join(root, 'test'), **kw)
        for mod, root in ((jp, hetero[0]), (tp, hetero[1]))]
    for gj, gt in zip(outs[0][:3], outs[1][:3]):
        assert type(gt).__name__ == type(gj).__name__
        for attr in ('n_pad', 'buckets'):
            assert getattr(gt, attr, None) == getattr(gj, attr, None)
        for _ in range(2):
            _same_batches(gj, gt)
    _same_stats(outs[0][3], outs[1][3])


def test_prefetch_loader_raises_and_shares_the_generator():
    '''A worker exception reaches the consumer at its batch; the wrapped
    loader's Generator is the PrefetchLoader's own (_rng), so setting its
    state moves the wrapped loader's draws, and an epoch restarts.'''
    class Faulty:
        _rng = np.random.default_rng(0)
        n_pad = 8

        def __len__(self):
            return 3

        def __iter__(self):
            yield {'k': 0}
            yield {'k': 1}
            raise KeyError('bad frame')
    pf = tl.PrefetchLoader(Faulty(), depth=2)
    assert pf._rng is Faulty._rng and pf.n_pad == 8 and len(pf) == 3
    got = []
    with pytest.raises(KeyError, match='bad frame'):
        for b in pf:
            got.append(b['k'])
    assert got == [0, 1]

    data = [tl.Sample(z=np.ones(k, np.int32), pos=np.zeros((k, 3)),
                      cell=np.zeros((3, 3)), energy=float(k),
                      force=np.zeros((k, 3))) for k in range(1, 21)]
    inner = tl.BucketedLoader(data, 4, shuffle=True, seed=2)
    pf = tl.PrefetchLoader(inner, depth=3)
    assert pf.buckets == inner.buckets == [8, 16, 24]
    state = pf._rng.bit_generator.state
    first = [b['energy'].tolist() for b in pf]
    pf._rng.bit_generator.state = state
    assert [b['energy'].tolist() for b in inner] == first


def test_spatial_sort_matches_jax():
    '''spatial_sort (the port's copy) on periodic and aperiodic batches
    with padding and force labels, and SpatialSortDataset's frames.'''
    rs = np.random.RandomState(7)
    z = rs.randint(1, 5, (3, 10)).astype(np.int32)
    z[1, 7:] = 0
    pos = rs.randn(3, 10, 3) * 4.0
    cell = np.stack([np.zeros((3, 3)), np.diag([5.0, 6.0, 7.0]),
                     np.array([[5.0, 0, 0], [1.0, 6.0, 0], [0, 0, 7.0]])])
    extra = {'force': rs.randn(3, 10, 3)}
    for c, shards in ((None, 1), (cell, 4)):
        got = tp.spatial_sort(z, pos, c, extra, n_shards=shards)
        want = jax_spatial_sort(z, pos, c, extra, n_shards=shards)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[2]['force'], want[2]['force'])
    frames = [tl.Sample(z=z[b], pos=pos[b], cell=cell[b], energy=1.0,
                        force=extra['force'][b]) for b in range(3)]
    _same_samples([tp.SpatialSortDataset(frames)[b] for b in range(3)],
                  [jp.SpatialSortDataset(frames)[b] for b in range(3)])


@pytest.mark.parametrize('in_memory', [True, False])
def test_preprocess_writes_the_jax_cache(tmp_path, in_memory):
    '''python -m newtonnet_tpu_torch.data.preprocess -r ROOT writes the
    cache the JAX package's scripts/preprocess.py writes: the JAX dataset
    reads it as its own frames.'''
    root = os.path.join(_copy(HETERO, ('test',), tmp_path), 'test')
    flag = '--in-memory' if in_memory else '--no-in-memory'
    data = preprocess.main(['-r', root, '-p', 'single', flag])
    assert type(data) is (tl.MolecularInMemoryDataset if in_memory
                          else tl.MolecularDataset)
    cls = JAX_DATASETS[in_memory]
    jax = cls(root=root)
    fresh = _copy(HETERO, ('test',), tmp_path / 'fresh')
    want = cls(root=os.path.join(fresh, 'test'))
    _same_samples([jax[i] for i in range(len(jax))],
                  [want[i] for i in range(len(want))])
