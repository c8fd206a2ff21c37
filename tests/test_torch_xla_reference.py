'''The JAX package's numbers that chip_smoke.py holds the kernel='xla'
phases to, the recipes that make them, and checks that they reproduce.

    python tests/test_torch_xla_reference.py mae        # JAX_XLA_*_MAE
    python tests/test_torch_xla_reference.py box        # JAX_XLA_BOX_FP32_*
    python tests/test_torch_xla_reference.py steps      # JAX_XLA_*STEP_*
    python tests/test_torch_xla_reference.py box-steps  # JAX_XLA_BOX_STEP_*
    python tests/test_torch_xla_reference.py bf16-shift # ROADMAP.md C11
    python tests/test_torch_xla_reference.py bf16-boxes # C11_REF
    python tests/test_torch_xla_reference.py c11-probe  # C11's cause
    python tests/test_torch_xla_reference.py lj         # JAX_LJ_N3_*
    python tests/test_torch_xla_reference.py lj-steps   # JAX_LJ_STEP_*

`mae`: the energy and force MAE of the trained kernel='xla' checkpoint
artifacts/md17_model/best_model.msgpack on the 500 MD17-aspirin test
frames in batches of 100 (padded to 21 atoms), through the dense model and
through graph_mode neighborlist with inverse_lists, k_max 48 and the lists
of the JAX package's host_symmetric_nlist. `box`: one request (energy,
forces of the first 8 atoms) on chip_smoke.py's box recipe (box_system) at
BOX_REF_ATOMS = 512 atoms, in inverse-list mode with k_max 88 and
box_weights' weights, in float32. `bf16-boxes`: the energy, per-atom
energies and forces on the C11 boxes (chip_smoke.C11_BOXES) with a bf16
stack and in float32, written to chip_smoke.C11_REF
(tests/reference/jax_xla_bf16_boxes.npz), and the port's numbers against
them in C11's units. `steps`: the first 10 fine-tuning
steps (loss, global gradient norm before the clip) of that checkpoint with
its own config (artifacts/md17_model/config.yml: energy + 50 x force mse,
Adam 1e-3, clip 1.0, batch 10, scalers refit, matmul precision
'highest') by the JAX package's standard step (jax.value_and_grad of the
loss over model.apply, which fast_grad 'auto' gives an XLA model), dense
and with graph_mode neighborlist, k_max 48. `box-steps`: step 1 of that
standard step on box_system(BOX_REF_ATOMS) over inverse lists, with
box_weights' weights and chip_smoke.py's BOX_XLA_LOSS (energy + force +
stress, labels from box_system and box_stress), bf16 stack and float32.
`bf16-shift`: on small seeded molecules, dense and over plain and inverse
lists, both packages' bf16-to-fp32 energy and force shifts, the port's
bf16 result against the JAX package's, and the bf16 roundings JAX's
compiled program keeps (bf16_shift_report).
All run the JAX package on the CPU (the machine with the card has no
flax). Every JAX program of a bf16 stack here (`bf16-boxes`,
`box-steps`, `bf16-shift`) is compiled without excess precision
(compiler_options={'xla_allow_excess_precision': False}, strict_jit): the
program that keeps every bf16 rounding the source declares, which the
port's bf16 stack follows (models/xla_stack.py). XLA's default CPU compile
keeps float32 between some of them. test_embedded_xla_steps_reproduce
recomputes the first two dense steps at full width (about 10 s on the
CPU).
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
# XLA compile options of the reference: no float32 kept between the bf16
# operations of a fusion
NO_EXCESS_PRECISION = {'xla_allow_excess_precision': False}


def strict_jit(fn, **kw):
    '''jax.jit compiled without excess precision.'''
    return jax.jit(fn, compiler_options=NO_EXCESS_PRECISION, **kw)


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


def jax_box_outputs(n_atoms, compute_dtype, seed=0):
    '''The JAX package's energy, per-atom energies (N,) and forces (N, 3)
    on box_system(n_atoms, seed) with box_model's weights, inverse lists
    from its host_symmetric_nlist.'''
    from newtonnet_tpu.md.driver import host_symmetric_nlist
    from newtonnet_tpu.models import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_to_flax
    tm = port_box_model(compute_dtype)
    jm = NewtonNet(**tm.config_dict())
    params = params_to_flax(tm.core)
    z, pos, cell, _, _ = chip_smoke().box_system(n_atoms, seed=seed)
    nl = host_symmetric_nlist(jm, z, pos, cell, skin=0.0)
    out = strict_jit(lambda p, a, b, c, n: jm.apply(p, a, b, c, nlist=n))(
        params, jnp.asarray(z), jnp.asarray(pos), jnp.asarray(cell), nl)
    return (float(out['energy'][0]),
            np.asarray(out['atomic_energy'][0]).reshape(-1),
            np.asarray(out['gradient_force'][0]))


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

    def step(p, b, n):
        def loss_fn(q):
            return main_loss(jm.apply(q, b['z'], b['pos'], b['cell'],
                                      nlist=n), b)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        return loss, jnp.sqrt(sum(jnp.sum(g * g) for g in
                                  jax.tree_util.tree_leaves(grads)))
    step = strict_jit(step)

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
    '''The XLA box recipe at 256 atoms (seed 0): the port's inverse-list
    model (plain row gather) against the JAX package's, each with its own
    lists. float32: energy at rtol 1e-5, forces to 1e-4 of their largest
    magnitude. The JAX outputs equal C11_REF's entry for this box bit for
    bit (the file reproduces). bf16 stack: against the JAX package's bf16
    program, the per-atom energies and the force components as root mean
    squares in units of that program's own bf16-to-fp32 shift, within 0.8
    (measured on the CPU: 0.36 and 0.67), which the float32 model, held
    the same way, fails (1.0).'''
    import torch

    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    cs = chip_smoke()
    z, pos, cell, _, _ = cs.box_system(256)
    got = {}
    for cd in ('', 'bfloat16'):
        tm = port_box_model(cd)
        args = [torch.from_numpy(a) for a in (z, pos, cell)]
        out = tm(*args, nlist=host_symmetric_nlist(tm, *args, skin=0.0))
        got[cd] = (float(out['energy'][0]),
                   out['atomic_energy'][0].reshape(-1).numpy(),
                   out['gradient_force'][0].numpy())
    jax = {cd: jax_box_outputs(256, cd) for cd in ('', 'bfloat16')}
    ref = cs.c11_reference()
    for cd, tag in (('', 'fp32'), ('bfloat16', 'bf16')):
        for i, key in enumerate(('energy', 'atom_energy', 'forces')):
            assert np.array_equal(np.asarray(jax[cd][i], np.float32),
                                  ref[f'256_0_{tag}_{key}'])
    (e32, _, f32), (_, a16, f16) = jax[''], jax['bfloat16']
    assert abs(got[''][0] - e32) <= 1e-5 * abs(e32)
    assert np.abs(got[''][2] - f32).max() <= 1e-4 * np.abs(f32).max()

    def rms(x):
        return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    unit_a, unit_f = rms(a16 - jax[''][1]), rms(f16 - f32)
    assert rms(got['bfloat16'][1] - a16) <= 0.8 * unit_a
    assert rms(got['bfloat16'][2] - f16) <= 0.8 * unit_f
    assert rms(got[''][1] - a16) > 0.8 * unit_a
    assert rms(got[''][2] - f16) > 0.8 * unit_f
    assert cs.BOX_REF_ATOMS == BOX_REF_ATOMS


def test_bf16_stack_on_c11_boxes_against_jax():
    '''The CPU twin of chip_smoke.py phase 5c's C11 bars: the port's bf16
    stack on the C11_BOXES against the JAX package's bf16 program
    (C11_REF, this script's `bf16-boxes` output, compiled without excess
    precision), pooled root mean squares of the total energies, per-atom
    energies and force components in units of that program's own
    bf16-to-fp32 shift, within C11_BARS; the float32 model, what the bf16
    stack was before C11, must fail every bar; and the float32 request at
    BOX_REF_ATOMS within the float32 bars of JAX_XLA_BOX_FP32_*.'''
    import torch

    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
    cs = chip_smoke()
    ref = cs.c11_reference()
    models = {cd: port_box_model(cd) for cd in ('', 'bfloat16')}
    stats = {cd: cs.c11_box_stats(np, ref, cs.c11_box_requests(
        torch, m, device='cpu')) for cd, m in models.items()}
    for key, bar in cs.C11_BARS.items():
        assert stats['bfloat16'][key] <= bar, (key, stats)
        assert stats[''][key] > bar, (key, stats)
    z, pos, cell, _, _ = cs.box_system(BOX_REF_ATOMS)
    args = [torch.from_numpy(a) for a in (z, pos, cell)]
    tm = models['']
    out = tm(*args, nlist=host_symmetric_nlist(tm, *args, skin=0.0))
    jf8_32 = np.asarray(cs.JAX_XLA_BOX_FP32_FORCES_8)
    assert abs(float(out['energy'][0]) - cs.JAX_XLA_BOX_FP32_ENERGY) <= \
        1e-5 * abs(cs.JAX_XLA_BOX_FP32_ENERGY)
    assert np.abs(out['gradient_force'][0, :8].numpy() - jf8_32).max() <= \
        1e-4 * np.abs(jf8_32).max()


def write_bf16_boxes():
    '''`bf16-boxes`: the JAX package's energy, per-atom energies and forces
    on chip_smoke.py's C11_BOXES (box_system at 256 and 512 atoms, four
    seeds each, inverse lists, box_weights' weights), with a bf16 stack
    (compiled without excess precision) and in float32, written to C11_REF;
    then the port's bf16 stack and its float32 model (the control) against
    them in C11's units (chip_smoke.c11_box_stats), on the CPU.'''
    import torch
    cs = chip_smoke()
    ref = {}
    for n, seed in cs.C11_BOXES:
        for cd, tag in (('bfloat16', 'bf16'), ('', 'fp32')):
            e, a, f = jax_box_outputs(n, cd, seed=seed)
            ref[f'{n}_{seed}_{tag}_energy'] = np.float32(e)
            ref[f'{n}_{seed}_{tag}_atom_energy'] = a.astype(np.float32)
            ref[f'{n}_{seed}_{tag}_forces'] = f.astype(np.float32)
    os.makedirs(os.path.dirname(cs.C11_REF), exist_ok=True)
    np.savez_compressed(cs.C11_REF, **ref)
    print('wrote', os.path.relpath(cs.C11_REF, ROOT), flush=True)
    ref = cs.c11_reference()
    got = {}
    for cd, tag in (('bfloat16', 'bf16'), ('', 'fp32_control')):
        got[tag] = cs.c11_box_requests(torch, port_box_model(cd),
                                       device='cpu')
        print({tag: cs.c11_box_stats(np, ref, got[tag]),
               'bars': cs.C11_BARS}, flush=True)
    # the bf16 stack (and phase 5c's fp8-rows control) against the port's
    # own float32 model, in the same units: BOX_BF16_VS_FP32's readings
    model = port_box_model('bfloat16')
    handles = cs.node_rows_fp8(torch, model)
    got['fp8_rows_control'] = cs.c11_box_requests(torch, model, device='cpu')
    for h in handles:
        h.remove()
    units = cs.c11_box_stats(np, ref, got['bf16'])

    def vs_fp32(tag, i):
        v = np.concatenate([np.ravel(got[tag][b][i]
                                     - got['fp32_control'][b][i])
                            for b in cs.C11_BOXES]).astype(np.float64)
        return float(np.sqrt(np.mean(v * v)))
    for tag in ('bf16', 'fp8_rows_control'):
        print({f'{tag}_vs_port_fp32_in_jax_shifts': {
            key: vs_fp32(tag, i) / units[f'{key}_jax_shift']
            for i, key in ((1, 'atom_energy'), (2, 'forces'))},
            'bar': cs.BOX_BF16_VS_FP32}, flush=True)


def c11_probe(n_atoms=BOX_REF_ATOMS, seed=0):
    '''`c11-probe`: what keeps the port's bf16 stack from the JAX
    package's bf16 program on box_system(n_atoms, seed) (ROADMAP.md C11).
    JAX's float32 edge features are captured from its compiled program
    (jax.debug.callback on scaled_norm, polynomial_cutoff and
    radial_bessel; the forward takes JAX's values, the backward the
    port's) and its lists are fed into the port; the port's bf16 matmuls
    are optionally done as XLA's CPU dot does them (a float32 product of
    the bf16 operands, rounded once). Prints, for each combination, the
    per-atom energies' and the forces' root mean square distance from the
    JAX bf16 program in units of that program's own bf16-to-fp32 shift.'''
    from unittest import mock

    import torch

    import newtonnet_tpu.models.newtonnet as jnn
    import newtonnet_tpu_torch.models.newtonnet as tnn
    import newtonnet_tpu_torch.models.xla_stack as xs
    from newtonnet_tpu.md.driver import host_symmetric_nlist
    from newtonnet_tpu.models import NewtonNet
    cap = {}

    def capture(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
                jax.debug.callback(
                    lambda v, key=f'{name}{i}': cap.__setitem__(
                        key, np.asarray(v)), o)
            return out
        return wrapped
    with mock.patch.multiple(
            jnn, scaled_norm=capture('norm', jnn.scaled_norm),
            polynomial_cutoff=capture('cut', jnn.polynomial_cutoff),
            radial_bessel=capture('bessel', jnn.radial_bessel)):
        j16 = jax_box_outputs(n_atoms, 'bfloat16', seed)
    j32 = jax_box_outputs(n_atoms, '', seed)
    jdir = torch.from_numpy(cap['norm1'])
    jrbf = torch.from_numpy((cap['cut0'] * cap['bessel0'])
                            .astype(np.float32))

    class Take(torch.autograd.Function):
        @staticmethod
        def forward(ctx, own, given):
            return given.clone()

        @staticmethod
        def backward(ctx, g):
            return g, None
    features = xs._features

    def jax_features(model, disp):
        d, r = features(model, disp)
        return Take.apply(d, jdir), Take.apply(r, jrbf)
    linear = tnn.TorchLinear.forward

    def xla_dot(self, x):
        if x.dtype != torch.bfloat16:
            return linear(self, x)
        y = (x.float() @ self.kernel.to(x.dtype).float()).to(x.dtype)
        return y if self.bias is None else y + self.bias.to(x.dtype)
    model = port_box_model('bfloat16')
    z, pos, cell, _, _ = chip_smoke().box_system(n_atoms, seed=seed)
    nl = tuple(torch.from_numpy(np.asarray(a)) for a in host_symmetric_nlist(
        NewtonNet(**model.config_dict()), z, pos, cell, skin=0.0))
    args = [torch.from_numpy(a) for a in (z, pos, cell)]

    def rms(x):
        return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    for feats in ('port', 'jax'):
        for dot in ('torch', 'xla'):
            with mock.patch.object(
                    xs, '_features',
                    jax_features if feats == 'jax' else features), \
                    mock.patch.object(tnn.TorchLinear, 'forward',
                                      xla_dot if dot == 'xla' else linear):
                out = model(*args, nlist=nl)
            a = out['atomic_energy'][0].reshape(-1).detach().numpy()
            f = out['gradient_force'][0].detach().numpy()
            print({'features': feats, 'matmul': dot,
                   'atom_energy': rms(a - j16[1]) / rms(j16[1] - j32[1]),
                   'forces': rms(f - j16[2]) / rms(j16[2] - j32[2]),
                   'energy_diff_ev': float(out['energy'][0]) - j16[0]},
                  flush=True)


def jax_lj_request():
    '''The JAX package's calculator on chip_smoke.lj_box() with the
    trained newton3 checkpoint: (energy, forces (64, 3)).'''
    from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
    cs = chip_smoke()
    z, pos, cell, _, _ = cs.lj_box()
    r = JaxCalc(cs.LJ_CKPT).calculate(numbers=z[0], positions=pos[0],
                                      cell=cell[0])
    return r['energy'], np.asarray(r['forces'])


def jax_lj_steps(n_steps=10):
    '''The JAX package's first fine-tuning steps of the newton3 checkpoint
    with its config (lj_n3_cfg.yml: energy + 50 x force mse, Adam 2e-3,
    clip 1.0, batch 12, scalers refit) on write_lj_dataset's frames over
    precompute_nlist mode newton3: (losses, global gradient norms before
    the clip).'''
    import tempfile

    import optax
    import yaml

    from newtonnet_tpu.data import parse_train_test
    from newtonnet_tpu.data.statistics import set_scalers
    from newtonnet_tpu.ops.nlist import build_inverse_list
    from newtonnet_tpu.train.loss import get_loss_by_string
    from newtonnet_tpu.train.optimizer import get_optimizer_by_string
    from newtonnet_tpu.utils.checkpoint import load_model
    cs = chip_smoke()
    with open(cs.LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as root:
        cs.write_lj_dataset(root)
        train_gen, _, _, stats = parse_train_test(
            seed=0, **cs.lj_data_settings(root))
        model, params = load_model(cs.LJ_CKPT)
        params = set_scalers(params, model.output_properties, stats,
                             {'energy': dict(cfg['training']['fit_scalers'])})
        main_loss, _ = get_loss_by_string(cfg['training']['loss'])
        tx = get_optimizer_by_string(
            'adam', clip_grad=cfg['training']['clip_grad'],
            lr=cfg['training']['optimizer']['adam']['lr'])
        opt = tx.init(params)

        @jax.jit
        def step(p, o, b):
            inv = build_inverse_list(jnp.swapaxes(b['nlist_idx'], 1, 2),
                                     jnp.swapaxes(b['nlist_mask'], 1, 2))
            nl = (b['nlist_idx'], b['nlist_mask']) + tuple(inv)

            def loss_fn(q):
                return main_loss(model.apply(q, b['z'], b['pos'], b['cell'],
                                             nlist=nl), b)
            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, o = tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, loss, \
                optax.global_norm(grads)

        losses, norms = [], []
        with jax.default_matmul_precision('highest'):
            for _, batch in zip(range(n_steps), train_gen):
                params, opt, loss, norm = step(
                    params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
                losses.append(float(loss))
                norms.append(float(norm))
    return losses, norms


def test_lj_checkpoint_served_against_jax():
    '''The trained newton3 checkpoint (F=48, 2 interactions, k_max 16) on
    the 64-atom LJ box through both calculators: energy at rtol 1e-5,
    forces to 1e-4 of their largest magnitude (float32); and
    chip_smoke.py's embedded JAX_LJ_N3_* are this recipe's numbers.'''
    from newtonnet_tpu_torch import NewtonNetCalculator
    cs = chip_smoke()
    z, pos, cell, _, _ = cs.lj_box()
    calc = NewtonNetCalculator(cs.LJ_CKPT, device='cpu')
    assert calc.model.newton3 and calc.model.n_features == 48
    r = calc.calculate(numbers=z[0], positions=pos[0], cell=cell[0])
    e, f = jax_lj_request()
    assert r['energy'] == pytest.approx(e, rel=1e-5)
    assert np.abs(r['forces'] - f).max() <= 1e-4 * np.abs(f).max()
    assert cs.JAX_LJ_N3_ENERGY == pytest.approx(e, rel=1e-6)
    np.testing.assert_allclose(cs.JAX_LJ_N3_FORCES_8, f[:8], rtol=1e-5,
                               atol=1e-6)


BF16_LAYOUTS = {'dense': {'graph_mode': 'dense'},
                'lists': {'graph_mode': 'neighborlist', 'k_max': 12},
                'inverse': {'graph_mode': 'neighborlist', 'k_max': 12,
                            'inverse_lists': True}}


def bf16_shift_case(layout):
    '''Four random molecules of at most 8 atoms (numpy seed 1), a seeded
    F=32, R=8, 2-interaction model in the given BF16_LAYOUTS layout: each
    package's energy (B,) and forces (B, n, 3) with a float32 and a bf16
    stack, {cd: (jax_e, jax_f, port_e, port_f)}, the JAX program compiled
    without excess precision; and its bf16 energy program's HLO text.'''
    import torch

    from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
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
                output_properties=['energy', 'gradient_force'],
                **BF16_LAYOUTS[layout])
    out, hlo = {}, None
    for cd in ('', 'bfloat16'):
        cfg = dict(base, compute_dtype=cd)
        jm = JaxNewtonNet(**cfg)
        params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                         jnp.asarray(pos[:1, :4]), jnp.zeros((1, 3, 3)))
        params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        tm = NewtonNet(**cfg, device='cpu')
        params_from_flax(params, core=tm.core)
        args = [torch.from_numpy(a) for a in (z, pos, cell)]
        nl = (host_symmetric_nlist(tm, *args, skin=0.0)
              if cfg.get('inverse_lists') else None)
        jnl = None if nl is None else tuple(jnp.asarray(t.numpy())
                                            for t in nl)
        jo = strict_jit(lambda p, q: jm.apply(p, z, pos, cell, nlist=q))(
            params, jnl)
        to = tm(*args, nlist=nl)
        out[cd] = (np.asarray(jo['energy']), np.asarray(jo['gradient_force']),
                   to['energy'].numpy(), to['gradient_force'].numpy())
        if cd:
            hlo = strict_jit(lambda p, q: jm.apply(
                p, z, pos, cell, nlist=q)['energy']).lower(
                    params, jnl).compile().as_text()
    return out, hlo


@pytest.mark.parametrize('layout', sorted(BF16_LAYOUTS))
def test_bf16_stack_follows_jax_bf16_program(layout):
    '''`bf16-shift`'s molecules: the port's bf16 stack against the JAX
    package's bf16 program, in units of the JAX package's bf16-to-fp32
    shift (its largest over the molecules), plus the float32 bar (atol
    2e-4, tests/test_torch_xla_model.py): energy within 0.05 of it, forces
    within 0.25 (measured on the CPU: 6e-5 and 0.10-0.11).'''
    out, _ = bf16_shift_case(layout)
    (je32, jf32, te32, tf32), (je16, jf16, te16, tf16) = out[''], \
        out['bfloat16']
    np.testing.assert_allclose(te32, je32, atol=2e-4)
    np.testing.assert_allclose(tf32, jf32, atol=2e-4)
    spread_e, spread_f = np.abs(je16 - je32).max(), np.abs(jf16 - jf32).max()
    assert np.abs(te16 - je16).max() <= 0.05 * spread_e + 2e-4
    assert np.abs(tf16 - jf16).max() <= 0.25 * spread_f + 2e-4


def bf16_shift_report():
    '''`bf16-shift`: for each layout of bf16_shift_case, each package's
    bf16-to-fp32 energy and force shift, the port's bf16 result against
    the JAX package's (also in units of the JAX shift), and the values
    JAX's compiled bf16 energy program rounds to bf16: the count of its
    converts to bf16, by what they convert (a parameter of a fusion, or an
    operation).'''
    import re
    from collections import Counter
    for layout in sorted(BF16_LAYOUTS):
        out, hlo = bf16_shift_case(layout)
        (je32, jf32, te32, tf32), (je16, jf16, te16, tf16) = out[''], \
            out['bfloat16']
        converts = Counter(
            'parameter' if m.group(1).startswith('param')
            else re.sub(r'[._]\d+$', '', m.group(1))
            for m in re.finditer(
                r'= bf16\[[^\]]*\][^ ]* convert\(%([\w.]+)\)', hlo))
        row = {
            'jax_shift_energy': float(np.abs(je16 - je32).max()),
            'jax_shift_forces': float(np.abs(jf16 - jf32).max()),
            'port_shift_energy': float(np.abs(te16 - te32).max()),
            'port_shift_forces': float(np.abs(tf16 - tf32).max()),
            'port16_vs_jax16_energy': float(np.abs(te16 - je16).max()),
            'port16_vs_jax16_forces': float(np.abs(tf16 - jf16).max())}
        row['energy_in_jax_shifts'] = row['port16_vs_jax16_energy'] / \
            row['jax_shift_energy']
        row['forces_in_jax_shifts'] = row['port16_vs_jax16_forces'] / \
            row['jax_shift_forces']
        print({'layout': layout, **row, 'jax_bf16_converts': dict(converts)},
              flush=True)


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
        e, _, f = jax_box_outputs(BOX_REF_ATOMS, '')
        print('JAX_XLA_BOX_FP32_ENERGY =', repr(e))
        print('JAX_XLA_BOX_FP32_FORCES_8 =', f[:8].tolist(), flush=True)
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
    elif sys.argv[1:] == ['bf16-boxes']:
        write_bf16_boxes()
    elif sys.argv[1:] == ['c11-probe']:
        c11_probe()
    elif sys.argv[1:] == ['lj']:
        e, f = jax_lj_request()
        print('JAX_LJ_N3_ENERGY =', repr(float(e)))
        print('JAX_LJ_N3_FORCES_8 =', f[:8].tolist(), flush=True)
    elif sys.argv[1:] == ['lj-steps']:
        losses, norms = jax_lj_steps()
        print('JAX_LJ_STEP_LOSS =', [float(f'{v:.7g}') for v in losses])
        print('JAX_LJ_STEP_GRAD_NORM =', [float(f'{v:.5g}') for v in norms],
              flush=True)
    else:
        sys.exit('usage: test_torch_xla_reference.py mae|box|steps|'
                 'box-steps|bf16-shift|bf16-boxes|c11-probe|lj|lj-steps')
