'''The host slot coloring in C++ (newtonnet_tpu_torch/csrc/host/symslots.cpp,
built by g++ through ops/_build.load_host) against the numpy loop it
replaced (ops/nlist.symmetrize_slots_ref), on aspirin frames and on the
512-atom periodic box of chip_smoke.py.

The two scan the edges in different orders among equal combined degrees
(the C++ by row, then slot; the loop by sorted (lo, hi) pairs), so they
may give an edge different slots. Both are held to the input's edge set
and to shared slots (idx[i, c] = j <=> idx[j, c] = i), and to equal bits
where the two orders agree (rows listed in increasing neighbour order).
A model over either's lists sums its slots in another order: float64
outputs at rtol 1e-12.
'''
import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from newtonnet_tpu_torch.ops import _build
from newtonnet_tpu_torch.ops import nlist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XYZ = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_test', 'raw',
                   'aspirin_ccsd-test.xyz')


def _box(n_atoms):
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.box_system(n_atoms)[:3]


def _aspirin(n_frames=10):
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    b = collate(parse_xyz(XYZ)[:n_frames], n_pad=24)
    return b['z'], b['pos'], b['cell']


def _full_list(z, pos, cell, k_max, dtype=torch.float64):
    idx, kmask, _, over = nlist.neighbor_list(
        torch.tensor(pos, dtype=dtype), torch.tensor(cell, dtype=dtype),
        torch.tensor(z) > 0, 5.0, k_max)
    assert int(over.sum()) == 0
    return idx.numpy(), kmask.numpy()


def _edges(idx, mask):
    return {(b, i, int(idx[b, i, k])) for b, i, k in zip(*np.nonzero(mask))}


def _check_shared_slots(idx, mask):
    for b, i, c in zip(*np.nonzero(mask)):
        j = idx[b, i, c]
        assert mask[b, j, c] and idx[b, j, c] == i


@pytest.mark.parametrize('system, k_max', [('aspirin', 48), ('box', 88)])
def test_cpp_coloring_keeps_the_edges_and_shares_slots(system, k_max):
    z, pos, cell = _aspirin() if system == 'aspirin' else _box(512)
    idx, kmask = _full_list(z, pos, cell, k_max)
    got = nlist.symmetrize_slots(idx, kmask, k_max=k_max)
    ref = nlist.symmetrize_slots_ref(idx, kmask, k_max=k_max)
    assert got[0].dtype == idx.dtype and got[1].dtype == np.bool_
    assert got[0].shape == ref[0].shape == idx.shape[:2] + (k_max,)
    assert _edges(*got) == _edges(idx, kmask) == _edges(*ref)
    _check_shared_slots(*got)
    assert not got[0][~got[1]].any()


def test_cpp_coloring_equals_the_loop_where_the_orders_agree():
    '''With each row's neighbours in increasing order, the C++ scan meets
    the edges in the loop's (lo, hi) order: the same slots, bit for bit.'''
    z, pos, cell = _box(512)
    idx, kmask = _full_list(z, pos, cell, 88)
    key = np.where(kmask, idx, np.iinfo(idx.dtype).max)
    order = np.argsort(key, axis=-1, kind='stable')
    idx = np.take_along_axis(idx, order, -1)
    kmask = np.take_along_axis(kmask, order, -1)
    got = nlist.symmetrize_slots(idx, kmask)
    ref = nlist.symmetrize_slots_ref(idx, kmask)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def test_too_few_slots_raise():
    z, pos, cell = _aspirin(2)
    idx, kmask = _full_list(z, pos, cell, 48)
    for fn in (nlist.symmetrize_slots, nlist.symmetrize_slots_ref):
        with pytest.raises(ValueError, match='raise k_max'):
            fn(idx, kmask, k_max=8)
    bad = idx.copy()
    bad[0, 0, 0] = 99
    with pytest.raises(ValueError, match='outside'):
        nlist.symmetrize_slots(bad, kmask)


def test_model_over_either_coloring_agrees():
    '''An inverse-list XLA model (F=16, float64) on the 512-atom box over
    the C++ lists and over the loop's: energy, forces and stress at rtol
    1e-12 (slots summed in another order).'''
    from newtonnet_tpu_torch import NewtonNet
    z, pos, cell = _box(512)
    model = NewtonNet(n_features=16, n_basis=6, n_interactions=2,
                      output_properties=['energy', 'gradient_force',
                                         'stress'],
                      graph_mode='neighborlist', k_max=88,
                      inverse_lists=True, device='cpu', dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    idx, kmask = _full_list(z, pos, cell, 88)
    args = [torch.tensor(z), torch.tensor(pos, dtype=torch.float64),
            torch.tensor(cell, dtype=torch.float64)]
    outs = []
    for fn in (nlist.symmetrize_slots, nlist.symmetrize_slots_ref):
        i2, m2 = (torch.from_numpy(a) for a in fn(idx, kmask, k_max=88))
        nl = (i2, m2, i2.transpose(1, 2).contiguous(),
              m2.transpose(1, 2).contiguous())
        outs.append(model(*args, nlist=nl))
    for key in ('energy', 'gradient_force', 'stress'):
        torch.testing.assert_close(outs[0][key], outs[1][key], rtol=1e-12,
                                   atol=1e-12 * float(
                                       outs[1][key].abs().max()), msg=key)


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    '''load_host compiles the source it is given and raises with the
    compiler's output when that fails: no quiet fallback to the loop.'''
    host = tmp_path / 'host'
    host.mkdir()
    shutil.copy(os.path.join(_build.HOST_DIR, 'symslots.cpp'), host)
    (host / 'broken.cpp').write_text('extern "C" int f( { return 0; }\n')
    monkeypatch.setattr(_build, 'HOST_DIR', str(host))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_LIBS', {})
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        _build.load_host('broken')
    assert _build.load_host('symslots').symmetrize_slots
