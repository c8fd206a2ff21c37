'''The JAX package's numbers that chip_smoke.py holds the kernel='xla'
phases to, the recipes that make them, and checks that they reproduce.

    python tests/test_torch_xla_reference.py mae        # JAX_XLA_*_MAE
    python tests/test_torch_xla_reference.py box        # JAX_XLA_BOX_*
    python tests/test_torch_xla_reference.py steps      # JAX_XLA_*STEP_*
    python tests/test_torch_xla_reference.py box-steps  # JAX_XLA_BOX_STEP_*
    python tests/test_torch_xla_reference.py bf16-shift # ROADMAP.md C11

`mae`: the energy and force MAE of the trained kernel='xla' checkpoint
artifacts/md17_model/best_model.msgpack on the 500 MD17-aspirin test
frames in batches of 100 (padded to 21 atoms), through the dense model and
through graph_mode neighborlist with inverse_lists, k_max 48 and the lists
of the JAX package's host_symmetric_nlist. `box`: one request (energy,
forces of the first 8 atoms) on chip_smoke.py's box recipe (box_system) at
BOX_REF_ATOMS = 512 atoms, in inverse-list mode with k_max 88 and
box_weights' weights, with a bf16 interaction stack and, for the spread
that its rounding makes, in float32. `steps`: the first 10 fine-tuning
steps (loss, global gradient norm before the clip) of that checkpoint with
its own config (artifacts/md17_model/config.yml: energy + 50 x force mse,
Adam 1e-3, clip 1.0, batch 10, scalers refit, matmul precision
'highest') by the JAX package's standard step (jax.value_and_grad of the
loss over model.apply, which fast_grad 'auto' gives an XLA model), dense
and with graph_mode neighborlist, k_max 48. `box-steps`: step 1 of that
standard step on box_system(BOX_REF_ATOMS) over inverse lists, with
box_weights' weights and chip_smoke.py's BOX_XLA_LOSS (energy + force +
stress, labels from box_system and box_stress), bf16 stack and float32.
`bf16-shift`: both packages' bf16-to-fp32 energy shift on small seeded
molecules and the bf16 roundings JAX's compiled program keeps
(bf16_shift_report).
All run the JAX package on the CPU (the machine with the card has no
flax). test_embedded_xla_steps_reproduce recomputes the first two dense
steps at full width (about 10 s on the CPU).
'''
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLA_CKPT = os.path.join(ROOT, 'artifacts', 'md17_model',
                        'best_model.msgpack')
XYZ = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_test', 'raw',
                   'aspirin_ccsd-test.xyz')
BOX_REF_ATOMS = 512


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def aspirin_batches():
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    samples = parse_xyz(XYZ)
    return [collate(samples[k:k + 100], n_pad=21)
            for k in range(0, len(samples), 100)]


def jax_aspirin_mae(inverse_lists, batches=None):
    '''The JAX package's (energy MAE, force MAE) of the XLA checkpoint over
    the batches (default: all 500 test frames).'''
    from newtonnet_tpu.md.driver import host_symmetric_nlist
    from newtonnet_tpu.models import NewtonNet
    from newtonnet_tpu.utils.checkpoint import load_model
    model, params = load_model(XLA_CKPT)
    if inverse_lists:
        model = NewtonNet(**dict(model.config_dict(),
                                 graph_mode='neighborlist', k_max=48,
                                 inverse_lists=True))
    apply = jax.jit(lambda p, z, pos, cell, nl: model.apply(
        p, z, pos, cell, nlist=nl))
    ae = af = 0.0
    n_frames = n_forces = 0
    for b in batches or aspirin_batches():
        nl = (host_symmetric_nlist(model, b['z'], b['pos'], b['cell'],
                                   skin=0.0) if inverse_lists else None)
        out = apply(params, jnp.asarray(b['z']), jnp.asarray(b['pos']),
                    jnp.asarray(b['cell']), nl)
        e = np.asarray(out['energy'], np.float64)
        f = np.asarray(out['gradient_force'], np.float64)
        ae += np.abs(e - b['energy']).sum()
        af += np.abs(f - b['force']).sum()
        n_frames += len(e)
        n_forces += f.size
    return ae / n_frames, af / n_forces


def port_box_model(compute_dtype):
    '''chip_smoke.py's XLA box model on the CPU.'''
    import torch

    from newtonnet_tpu_torch import load_model
    base = load_model(XLA_CKPT, device='cpu')
    return chip_smoke().box_model(
        torch, base.config_dict(), compute_dtype,
        ['energy', 'gradient_force', 'stress'], device='cpu',
        inverse_lists=True)


def jax_box_request(n_atoms, compute_dtype):
    '''The JAX package's energy and forces on box_system(n_atoms) with
    box_model's weights, inverse lists from its host_symmetric_nlist.'''
    from newtonnet_tpu.md.driver import host_symmetric_nlist
    from newtonnet_tpu.models import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_to_flax
    tm = port_box_model(compute_dtype)
    jm = NewtonNet(**tm.config_dict())
    params = params_to_flax(tm.core)
    z, pos, cell, _, _ = chip_smoke().box_system(n_atoms)
    nl = host_symmetric_nlist(jm, z, pos, cell, skin=0.0)
    out = jax.jit(lambda p, a, b, c, n: jm.apply(p, a, b, c, nlist=n))(
        params, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(cell), nl)
    return float(out['energy'][0]), np.asarray(out['gradient_force'][0])


def jax_xla_steps(n_steps=10, **changes):
    """The JAX package's first fine-tuning steps of the XLA checkpoint with
    its config, standard step: (losses, global gradient norms before the
    clip). `changes` go into the model's config (graph_mode, k_max)."""
    import optax
    import yaml

    from newtonnet_tpu.data import parse_train_test
    from newtonnet_tpu.data.statistics import set_scalers
    from newtonnet_tpu.models import NewtonNet
    from newtonnet_tpu.train.loss import get_loss_by_string
    from newtonnet_tpu.train.optimizer import get_optimizer_by_string
    from newtonnet_tpu.utils.checkpoint import load_model
    cs = chip_smoke()
    with open(cs.XLA_CONFIG) as f:
        cfg = yaml.safe_load(f)
    data = os.path.join(ROOT, 'data', 'md17_aspirin')
    train_gen, _, _, stats = parse_train_test(
        train_root=os.path.join(data, 'ccsd_train'),
        test_root=os.path.join(data, 'ccsd_test'), train_size=950,
        train_batch_size=10, val_batch_size=50, test_batch_size=500, seed=0)
    model, params = load_model(XLA_CKPT)
    jm = NewtonNet(**dict(model.config_dict(), **changes))
    params = set_scalers(params, jm.output_properties, stats,
                         {'energy': dict(cfg['training']['fit_scalers'])})
    main_loss, _ = get_loss_by_string(cfg['training']['loss'])
    tx = get_optimizer_by_string('adam', clip_grad=1.0, lr=1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b):
        def loss_fn(q):
            return main_loss(jm.apply(q, b['z'], b['pos'], b['cell']), b)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, \
            optax.global_norm(grads)

    losses, norms = [], []
    with jax.default_matmul_precision(cfg['general']['matmul_precision']):
        for _, batch in zip(range(n_steps), train_gen):
            params, opt, loss, norm = step(
                params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(loss))
            norms.append(float(norm))
    return losses, norms


def jax_xla_box_step(n_atoms, compute_dtype):
    """The JAX package's standard step 1 on box_system(n_atoms) over its
    inverse lists with box_model's weights and BOX_XLA_LOSS: (loss, global
    gradient norm)."""
    from newtonnet_tpu.md.driver import host_symmetric_nlist
    from newtonnet_tpu.models import NewtonNet
    from newtonnet_tpu.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.utils.params import params_to_flax
    cs = chip_smoke()
    tm = port_box_model(compute_dtype)
    jm = NewtonNet(**tm.config_dict())
    params = params_to_flax(tm.core)
    z, pos, cell, energy, force = cs.box_system(n_atoms)
    batch = {'z': z, 'pos': pos, 'cell': cell, 'energy': energy,
             'force': force, 'stress': cs.box_stress(),
             'graph_mask': np.ones(1, bool)}
    nl = host_symmetric_nlist(jm, z, pos, cell, skin=0.0)
    main_loss, _ = get_loss_by_string(cs.BOX_XLA_LOSS)

    @jax.jit
    def step(p, b, n):
        def loss_fn(q):
            return main_loss(jm.apply(q, b['z'], b['pos'], b['cell'],
                                      nlist=n), b)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        return loss, jnp.sqrt(sum(jnp.sum(g * g) for g in
                                  jax.tree_util.tree_leaves(grads)))

    loss, norm = step(params, {k: jnp.asarray(v) for k, v in batch.items()},
                      nl)
    return float(loss), float(norm)


def test_embedded_xla_steps_reproduce():
    """chip_smoke.py's JAX_XLA_STEP_* are this recipe's numbers: the first
    two dense steps, as the script prints them (loss to 7 digits,
    gradient norm to 5). The recipe runs as its script
    does, with JAX's 64-bit mode off (the suite's conftest turns it on,
    which moves step 2's loss by 1.4e-5)."""
    cs = chip_smoke()
    with jax.enable_x64(False):
        losses, norms = jax_xla_steps(n_steps=2)
    assert [float(f'{v:.7g}') for v in losses] == cs.JAX_XLA_STEP_LOSS[:2]
    assert [float(f'{v:.5g}') for v in norms] == \
        cs.JAX_XLA_STEP_GRAD_NORM[:2]


def test_embedded_aspirin_maes_reproduce():
    '''chip_smoke.py's JAX_XLA_* constants are this recipe's numbers: the
    dense and inverse-list MAEs over all 500 frames, to 1e-6 relative.'''
    cs = chip_smoke()
    batches = aspirin_batches()
    for inverse, (e_want, f_want) in (
            (False, (cs.JAX_XLA_ENERGY_MAE, cs.JAX_XLA_FORCE_MAE)),
            (True, (cs.JAX_XLA_INV_ENERGY_MAE, cs.JAX_XLA_INV_FORCE_MAE))):
        e_mae, f_mae = jax_aspirin_mae(inverse, batches)
        assert e_mae == pytest.approx(e_want, rel=1e-6)
        assert f_mae == pytest.approx(f_want, rel=1e-6)


def test_box_recipe_matches_the_port_at_256_atoms():
    '''The XLA box recipe at 256 atoms: the port's inverse-list model
    (plain row gather) against the JAX package's, each with its own
    lists. float32: energy at rtol 1e-5, forces to 1e-4 of their largest
    magnitude. bf16 stack: within four times the larger bf16-to-fp32
    spread of the two packages (XLA on the CPU keeps float32 between the
    bf16 operations of a fusion, the port rounds every operation's
    output, so its spread is the larger).'''
    import torch

    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    z, pos, cell, _, _ = chip_smoke().box_system(256)
    got = {}
    for cd in ('', 'bfloat16'):
        tm = port_box_model(cd)
        args = [torch.from_numpy(a) for a in (z, pos, cell)]
        out = tm(*args, nlist=host_symmetric_nlist(tm, *args, skin=0.0))
        got[cd] = (float(out['energy'][0]), out['gradient_force'][0].numpy())
    e32, f32 = jax_box_request(256, '')
    e16, f16 = jax_box_request(256, 'bfloat16')
    assert got[''][0] == pytest.approx(e32, rel=1e-5)
    assert np.abs(got[''][1] - f32).max() <= 1e-4 * np.abs(f32).max()
    spread_e = max(abs(e16 - e32), abs(got['bfloat16'][0] - got[''][0]))
    spread_f = max(np.abs(f16 - f32).max(),
                   np.abs(got['bfloat16'][1] - got[''][1]).max())
    assert abs(got['bfloat16'][0] - e16) <= 4 * spread_e
    assert np.abs(got['bfloat16'][1] - f16).max() <= 4 * spread_f
    assert chip_smoke().BOX_REF_ATOMS == BOX_REF_ATOMS



def test_bf16_stack_spread_at_512_atoms_is_within_4x_jax():
    '''The port's bf16-to-fp32 spread on the box recipe at BOX_REF_ATOMS
    (energy) lies within four times the JAX package's, from chip_smoke.py's
    JAX_XLA_BOX_* numbers (this script's `box` output). The bf16 stack
    gathers its neighbour rows in bf16 and computes in fp32, as XLA does on
    the CPU, where rounding every operation put the port 40 times farther
    from fp32 than the JAX package.'''
    import torch

    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    cs = chip_smoke()
    z, pos, cell, _, _ = cs.box_system(BOX_REF_ATOMS)
    args = [torch.from_numpy(a) for a in (z, pos, cell)]
    energy = {}
    for cd in ('', 'bfloat16'):
        tm = port_box_model(cd)
        out = tm(*args, nlist=host_symmetric_nlist(tm, *args, skin=0.0))
        energy[cd] = float(out['energy'][0])
    jax_spread = abs(cs.JAX_XLA_BOX_ENERGY - cs.JAX_XLA_BOX_FP32_ENERGY)
    assert abs(energy['bfloat16'] - energy['']) <= 4 * jax_spread
    assert abs(energy['bfloat16'] - cs.JAX_XLA_BOX_ENERGY) <= 4 * jax_spread

def bf16_shift_report():
    '''`bf16-shift`: on four random molecules of at most 8 atoms (numpy
    seed 1) with a seeded F=32, R=8, 2-interaction model, each package's
    bf16-to-fp32 energy shift (largest over the molecules), dense and over
    plain lists (k_max 12), and the values JAX's compiled bf16 energy
    program rounds to bf16: the count of its converts to bf16, by what
    they convert (a parameter of a fusion, or an operation).'''
    import re
    from collections import Counter

    import torch

    from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_from_flax
    rs = np.random.RandomState(1)
    B, n = 4, 8
    z, pos = np.zeros((B, n), np.int32), np.zeros((B, n, 3), np.float32)
    for b in range(B):
        k = rs.randint(3, n + 1)
        z[b, :k] = rs.choice([1, 6, 7, 8], size=k)
        pos[b, :k] = rs.randn(k, 3) * 1.6
    cell = np.zeros((B, 3, 3), np.float32)
    base = dict(cutoff=5.0, n_features=32, n_basis=8, n_interactions=2,
                output_properties=['energy', 'gradient_force'])
    for layout in ({'graph_mode': 'dense'},
                   {'graph_mode': 'neighborlist', 'k_max': 12}):
        energy, converts = {}, None
        for cd in ('', 'bfloat16'):
            cfg = dict(base, compute_dtype=cd, **layout)
            jm = JaxNewtonNet(**cfg)
            params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4),
                                                             jnp.int32),
                             jnp.asarray(pos[:1, :4]), jnp.zeros((1, 3, 3)))
            params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  params)
            fn = jax.jit(lambda p: jm.apply(p, z, pos, cell)['energy'])
            tm = NewtonNet(**cfg, device='cpu')
            params_from_flax(params, core=tm.core)
            energy[cd] = (np.asarray(fn(params)), tm(
                *(torch.from_numpy(a) for a in (z, pos, cell)))
                ['energy'].numpy())
            if cd:
                hlo = fn.lower(params).compile().as_text()
                converts = Counter(
                    'parameter' if m.group(1).startswith('param')
                    else re.sub(r'[._]\d+$', '', m.group(1))
                    for m in re.finditer(
                        r'= bf16\[[^\]]*\][^ ]* convert\(%([\w.]+)\)',
                        hlo))
        shift = [float(np.abs(energy['bfloat16'][i] - energy[''][i]).max())
                 for i in (0, 1)]
        print({'layout': layout, 'jax_bf16_energy_shift': shift[0],
               'port_bf16_energy_shift': shift[1],
               'jax_bf16_converts': dict(converts)}, flush=True)


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    jax.config.update('jax_platforms', 'cpu')
    np.set_printoptions(precision=9)
    if sys.argv[1:] == ['mae']:
        for inverse, tag in ((False, ''), (True, '_INV')):
            e, f = jax_aspirin_mae(inverse)
            print(f'JAX_XLA{tag}_ENERGY_MAE, JAX_XLA{tag}_FORCE_MAE =',
                  repr(e), ',', repr(f), flush=True)
    elif sys.argv[1:] == ['box']:
        for cd, tag in (('bfloat16', ''), ('', '_FP32')):
            e, f = jax_box_request(BOX_REF_ATOMS, cd)
            print(f'JAX_XLA_BOX{tag}_ENERGY =', repr(e))
            print(f'JAX_XLA_BOX{tag}_FORCES_8 =', f[:8].tolist(), flush=True)
    elif sys.argv[1:] == ['steps']:
        for changes, tag in (({}, ''), ({'graph_mode': 'neighborlist',
                                         'k_max': 48}, '_NLIST')):
            losses, norms = jax_xla_steps(**changes)
            print(f'JAX_XLA{tag}_STEP_LOSS =',
                  [float(f'{v:.7g}') for v in losses])
            print(f'JAX_XLA{tag}_STEP_GRAD_NORM =',
                  [float(f'{v:.5g}') for v in norms], flush=True)
    elif sys.argv[1:] == ['box-steps']:
        out = {cd or 'float32': jax_xla_box_step(BOX_REF_ATOMS, cd)
               for cd in ('bfloat16', '')}
        print('JAX_XLA_BOX_STEP_LOSS =',
              {k: v[0] for k, v in out.items()})
        print('JAX_XLA_BOX_STEP_GRAD_NORM =',
              {k: v[1] for k, v in out.items()}, flush=True)
    elif sys.argv[1:] == ['bf16-shift']:
        bf16_shift_report()
    else:
        sys.exit('usage: test_torch_xla_reference.py mae|box|steps|'
                 'box-steps|bf16-shift')
