'''ROADMAP.md C17: a serving artifact over a neighbour list keeps every
force term when an atom is crowded past the list's capacity.

An exported program pads the list's transpose to a fixed width
(ops/nlist.fixed_degree, min(R, K) columns); an atom listed by more rows
than that has slots past the pad, which gather_nodes' backward now sums
through a fixed-size overflow path (ops/nlist._overflow_rows) instead of
dropping them. The frame here: one atom at the centre of seven, each of
which lists it among its k_max = 4 nearest, so its in-degree is 7. The
artifact's forces are held to the eager plain list's and to the JAX
package's model.apply at the bars of tests/test_torch_export.py (energy
2e-4, forces 1e-4), and the old pad (the overflow path taken out) fails
them. Where no atom overflows, the overflow path adds exact zeros
(tests/test_torch_export.py::test_fixed_degree_transpose_sums_the_same_bits).
'''
import os

import numpy as np
import pytest
import torch

from test_torch_export import (
    FORCES,
    assert_close,
    exported,
    jax_apply,
    port_model,
    port_out,
)

from newtonnet_tpu_torch.ops import nlist as tnl
from newtonnet_tpu_torch.utils import export as ex
from newtonnet_tpu_torch.utils.params import params_to_flax

K = 4


def crowded_frame():
    '''One atom at the origin and seven around it at distinct distances
    from 1.0 to 1.48 (cutoff 3.5; no ties in any list's order): each
    outer atom lists the centre among its four nearest.'''
    rs = np.random.RandomState(3)
    v = rs.randn(7, 3)
    outer = (1.0 + 0.08 * np.arange(7))[:, None] * v \
        / np.linalg.norm(v, axis=1, keepdims=True)
    pos = np.concatenate([np.zeros((1, 3)), outer])[None].astype(np.float32)
    z = np.asarray([[6, 1, 1, 8, 1, 6, 1, 1]], np.int64)
    return z, pos, np.zeros((1, 3, 3), np.float32)


@pytest.fixture(scope='module')
def crowded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('overflow')
    model = port_model(graph_mode='neighborlist', k_max=K, n_interactions=1)
    z, pos, cell = crowded_frame()
    idx, mask, _, overflow = tnl.neighbor_list(
        torch.from_numpy(pos), torch.from_numpy(cell),
        torch.from_numpy(z) > 0, model.cutoff, K)
    assert int(overflow.sum()) > 0
    key = torch.where(mask, idx, 8)
    assert int((key == 0).sum()) == 7 > K  # the centre's in-degree
    return model, (z, pos, cell), str(tmp)


def _replay(model, frame, path):
    served = ex.ServedModel(exported(model, path, n_atoms=8, batch_size=1),
                            device='cpu')
    raw = served.call_raw(*frame)
    return {k: raw[k].numpy() for k in FORCES}


def test_artifact_keeps_the_forces_past_the_capacity(crowded):
    model, frame, tmp = crowded
    got = _replay(model, frame, os.path.join(tmp, 'fixed.npz'))
    eager = port_out(model, *frame)
    assert_close(got, eager)
    assert_close(got, jax_apply(model, params_to_flax(model.core), *frame))


def test_the_old_pad_fails(crowded, monkeypatch):
    '''The control: the transpose at the fixed pad with the overflow path
    taken out (the pad before the repair) drops the centre's slots past
    it, and its forces miss the eager ones by more than the bar.'''
    model, frame, tmp = crowded

    def dropped(rows, idx, mask, n_nodes, D):
        return rows.new_zeros((rows.shape[0], n_nodes, rows.shape[2]),
                              dtype=torch.float64)

    monkeypatch.setattr(tnl, '_overflow_rows', dropped)
    got = _replay(model, frame, os.path.join(tmp, 'old.npz'))
    eager = port_out(model, *frame)
    with pytest.raises(AssertionError):
        assert_close(got, eager)


def test_overflow_sum_equals_the_full_transpose_in_float64():
    '''_scatter_rows at the fixed pad with its overflow path equals the
    transpose padded to the largest in-degree, in float64 at 1e-12, on
    lists with repeated neighbours (a periodic image listed twice) and
    masked slots; without the path it does not.'''
    g = torch.Generator().manual_seed(11)
    B, R, Kk, N, F = 2, 6, 3, 6, 5
    idx = torch.randint(0, 2, (B, R, Kk), generator=g)  # two hot nodes
    idx[:, :, -1] = torch.randint(0, N, (B, R), generator=g)
    mask = torch.rand(B, R, Kk, generator=g) > 0.2
    y = torch.randn(B, R, Kk, F, generator=g, dtype=torch.float64)
    full = tnl._scatter_rows(y, tnl.node_transpose(idx, N, mask))
    with tnl.fixed_degree():
        fixed = tnl.node_transpose(idx, N, mask)
    assert fixed.slots.shape[2] == Kk < int(tnl.node_transpose(
        idx, N, mask).slots.shape[2])
    got = tnl._scatter_rows(y, fixed, (idx, mask))
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                               atol=1e-12)
    assert np.abs(tnl._scatter_rows(y, fixed).numpy()
                  - full.numpy()).max() > 1e-3
