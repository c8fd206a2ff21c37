'''The trained full-width MD17-aspirin checkpoint through the port (on the
CPU, plain versions) and through the JAX package (Pallas in interpret
mode), on frames of the vendored aspirin test set.

Tolerances: aspirin's total energies are about -17,600 eV, where one
float32 ulp is 0.002 eV, so energies agree to atol 2e-2 eV (a few ulp;
a relative 1e-5 would allow 0.18 eV). Forces are sums of float32 products
of order 1 taken in another order: atol 1e-4 eV/Angstrom.
'''
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalculator
from newtonnet_tpu.utils.checkpoint import load_model as jax_load_model
from newtonnet_tpu_torch import NewtonNetCalculator, load_model
from newtonnet_tpu_torch.data.loader import collate, parse_xyz
from newtonnet_tpu_torch.utils._msgpack import msgpack_restore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'artifacts', 'md17_model_pallas',
                    'best_model.msgpack')
XYZ = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_test', 'raw',
                   'aspirin_ccsd-test.xyz')
E_ATOL, F_ATOL = 2e-2, 1e-4


@pytest.fixture(scope='module')
def samples():
    return parse_xyz(XYZ)


def test_msgpack_decoder_matches_flax():
    with open(CKPT, 'rb') as f:
        data = f.read()
    ours, ref = msgpack_restore(data), serialization.msgpack_restore(data)
    assert json.loads(ours['config']) == json.loads(ref['config'])
    flat_o = jax.tree_util.tree_flatten_with_path(ours['params'])[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref['params'])[0]
    assert [k for k, _ in flat_o] == [k for k, _ in flat_r]
    for (key, a), (_, b) in zip(flat_o, flat_r):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_calculator_matches_jax(samples):
    ours = NewtonNetCalculator(CKPT, properties=['energy', 'forces'],
                               device='cpu')
    ref = JaxCalculator(CKPT, properties=['energy', 'forces'])
    for s in samples[:3]:
        a = ours.calculate(numbers=s['z'], positions=s['pos'])
        b = ref.calculate(numbers=s['z'], positions=s['pos'])
        assert abs(a['energy'] - b['energy']) <= E_ATOL
        np.testing.assert_allclose(a['forces'], b['forces'], atol=F_ATOL)


def test_batched_forward_matches_jax(samples):
    '''The first 100 test frames in one batch padded to 24 atoms, as the
    JAX package's evaluation batches them.'''
    batch = collate(samples[:100], n_pad=24)
    model = load_model(CKPT, device='cpu')
    out = model(*[torch.from_numpy(batch[k]) for k in ('z', 'pos', 'cell')])
    jm, params = jax_load_model(CKPT)
    with jax.default_matmul_precision('highest'):
        ref = jax.jit(jm.apply)(params, *[jnp.asarray(batch[k])
                                          for k in ('z', 'pos', 'cell')])
    e, e_ref = out['energy'].numpy(), np.asarray(ref['energy'])
    f, f_ref = (out['gradient_force'].numpy(),
                np.asarray(ref['gradient_force']))
    assert np.abs(e - e_ref).max() <= E_ATOL
    np.testing.assert_allclose(f, f_ref, atol=F_ATOL)
    # and both are the trained model: errors against the labels are small
    assert np.abs(e - batch['energy']).mean() < 0.05
    assert np.abs(f - batch['force']).mean() < 0.05


def test_msgpack_encoder_writes_what_flax_reads():
    '''utils/_msgpack.py's encoder over every type it takes, every length
    class of str / bin / array / map and every int width, read back by
    flax.serialization.msgpack_restore and by the port's own decoder.'''
    from newtonnet_tpu_torch.utils._msgpack import msgpack_serialize
    tree = {
        'ints': [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                 2 ** 63, -1, -32, -33, -128, -129, -2 ** 15 - 1,
                 -2 ** 31 - 1, -2 ** 63],
        'floats': [0.0, -1.5, 1e300], 'flags': [True, False, None],
        'text': ['', 'a' * 31, 'b' * 32, 'c' * 300, 'd' * 70000],
        'raw': [b'', b'x' * 300, b'y' * 70000],
        'long_list': list(range(20)),
        'wide_map': {f'k{i}': i for i in range(20)},
        'arrays': {'f32': np.arange(6, dtype=np.float32).reshape(2, 3),
                   'i64': np.array([-5, 7], np.int64),
                   'f64_0d': np.array(2.5), 'b': np.array([True, False]),
                   'one': np.arange(1, dtype=np.int8)},
    }
    data = msgpack_serialize(tree)
    for back in (serialization.msgpack_restore(data), msgpack_restore(data)):
        for key in ('ints', 'floats', 'flags', 'text', 'raw', 'long_list',
                    'wide_map'):
            assert list(back[key]) == list(tree[key]) if key != 'wide_map' \
                else back[key] == tree[key], key
        for name, arr in tree['arrays'].items():
            got = np.asarray(back['arrays'][name])
            assert got.dtype == arr.dtype and np.array_equal(got, arr), name
    with pytest.raises(TypeError):
        msgpack_serialize({1: 2})
    with pytest.raises(TypeError):
        msgpack_serialize(object())
