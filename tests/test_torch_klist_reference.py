'''The JAX package's numbers that chip_smoke.py holds the neighbour-list
phases to, the recipes that make them, and a check of the box recipe
against the port at a small size.

    python tests/test_torch_klist_reference.py steps   # JAX_NLIST_STEP_*
    python tests/test_torch_klist_reference.py box     # JAX_BOX_*

`steps`: the first 10 fine-tuning steps (loss, global gradient norm before
the clip) of scripts/config_md17_pallas.yml from the trained MD17
checkpoint with model.graph_mode neighborlist (k_max 48, fp32 edges), as
chip_smoke.py's train-nlist phase takes them. `box`: one request (energy,
forces of the first 8 atoms) on chip_smoke.py's box recipe (box_system) at
BOX_REF_ATOMS = 512 atoms, with box_model's weights (numpy, seed 0; the
trained aspirin weights overflow float32 at the random box's 0.2 A
contacts) and k_max 88, with bf16 edges and, for the spread that their
rounding makes, with fp32 edges. Both run the JAX package on the CPU with
the Pallas kernels in interpret mode. The JAX package needs flax, which
the machine with the card does not have, so its numbers come from a CPU;
the 512-atom box keeps that run small (the 4096-atom box is held to the
port's plain path on the card).

Rounding the edge tensors to bf16 moves the outputs by far more than
float32 rounding does, so the bf16 comparisons are held to a bar derived
from that spread: four times the difference between the bf16-edge and
fp32-edge results of one package.
'''
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'artifacts', 'md17_model_pallas',
                    'best_model.msgpack')
BOX_REF_ATOMS = 512


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_box_model(compute_dtype):
    '''chip_smoke.py's box_model on the CPU: the checkpoint's widths, k_max
    88, weights from numpy (box_weights).'''
    import torch

    from newtonnet_tpu_torch import load_model
    base = load_model(CKPT, device='cpu')
    return chip_smoke().box_model(
        torch, base.config_dict(), compute_dtype,
        ['energy', 'gradient_force', 'stress'], device='cpu')


def jax_box_request(n_atoms, compute_dtype='bfloat16'):
    '''The JAX package's energy, forces and stress on box_system(n_atoms)
    with box_model's weights.'''
    from newtonnet_tpu.models import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_to_flax
    tm = port_box_model(compute_dtype)
    jm = NewtonNet(**tm.config_dict())
    params = params_to_flax(tm.core)
    z, pos, cell, _, _ = chip_smoke().box_system(n_atoms)
    out = jax.jit(lambda p, a, b, c: jm.apply(p, a, b, c))(
        params, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(cell))
    return (float(out['energy'][0]), np.asarray(out['gradient_force'][0]),
            np.asarray(out['stress'][0]))


def jax_nlist_steps(n_steps=10):
    '''The JAX package's first fine-tuning steps in neighbour-list mode:
    (losses, global gradient norms before the clip).'''
    import optax
    import yaml

    from newtonnet_tpu.data import parse_train_test
    from newtonnet_tpu.data.statistics import set_scalers
    from newtonnet_tpu.models import NewtonNet
    from newtonnet_tpu.train import fastgrad
    from newtonnet_tpu.train.loss import get_loss_by_string
    from newtonnet_tpu.train.optimizer import get_optimizer_by_string
    from newtonnet_tpu.utils.checkpoint import load_model
    with open(os.path.join(ROOT, 'scripts', 'config_md17_pallas.yml')) as f:
        cfg = yaml.safe_load(f)
    data = os.path.join(ROOT, 'data', 'md17_aspirin')
    train_gen, _, _, stats = parse_train_test(
        train_root=os.path.join(data, 'ccsd_train'),
        test_root=os.path.join(data, 'ccsd_test'), train_size=950,
        train_batch_size=10, val_batch_size=50, test_batch_size=500, seed=0)
    model, params = load_model(CKPT)
    jm = NewtonNet(**dict(model.config_dict(), graph_mode='neighborlist'))
    params = set_scalers(params, jm.output_properties, stats,
                         {'energy': dict(cfg['training']['fit_scalers'])})
    main_loss, _ = get_loss_by_string(cfg['training']['loss'])
    tx = get_optimizer_by_string('adam', clip_grad=1.0, lr=1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b):
        loss, grads, _ = fastgrad.value_and_grad(jm, main_loss, p, b)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, \
            optax.global_norm(grads)

    losses, norms = [], []
    for _, batch in zip(range(n_steps), train_gen):
        params, opt, loss, norm = step(
            params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms


def test_box_recipe_matches_the_port_at_256_atoms():
    """box_system at 256 atoms (a 13.7 A box, still over twice the cutoff)
    with box_model's weights: the port's neighbour-list model (plain
    versions of K5/K6) against the JAX package's. fp32 edges: energy at
    rtol 1e-5 and forces to 1e-4 of their largest magnitude (float32 sums
    in another order). bf16 edges: within four times the JAX package's own
    bf16-to-fp32 spread."""
    import torch
    z, pos, cell, _, _ = chip_smoke().box_system(256)
    got = {}
    for cd in ('', 'bfloat16'):
        out = port_box_model(cd)(*[torch.from_numpy(a)
                                   for a in (z, pos, cell)])
        got[cd] = (float(out['energy'][0]), out['gradient_force'][0].numpy())
    e32, f32, _ = jax_box_request(256, '')
    e16, f16, _ = jax_box_request(256, 'bfloat16')
    assert got[''][0] == pytest.approx(e32, rel=1e-5)
    assert np.abs(got[''][1] - f32).max() <= 1e-4 * np.abs(f32).max()
    assert abs(got['bfloat16'][0] - e16) <= 4 * abs(e16 - e32)
    assert np.abs(got['bfloat16'][1] - f16).max() <= \
        4 * np.abs(f16 - f32).max()
    assert chip_smoke().BOX_REF_ATOMS == BOX_REF_ATOMS


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    jax.config.update('jax_platforms', 'cpu')
    np.set_printoptions(precision=9)
    if sys.argv[1:] == ['steps']:
        losses, norms = jax_nlist_steps()
        print('JAX_NLIST_STEP_LOSS =', [float(f'{v:.7g}') for v in losses])
        print('JAX_NLIST_STEP_GRAD_NORM =',
              [float(f'{v:.5g}') for v in norms])
    elif sys.argv[1:] == ['box']:
        for cd, tag in (('bfloat16', ''), ('', '_FP32_EDGES')):
            e, f, s = jax_box_request(BOX_REF_ATOMS, cd)
            print(f'JAX_BOX{tag}_ENERGY =', repr(e))
            print(f'JAX_BOX{tag}_FORCES_8 =', f[:8].tolist(), flush=True)
    else:
        sys.exit('usage: test_torch_klist_reference.py steps|box')
