'''Halo-exchange graph parallelism of the port (ROADMAP.md A11b:
newtonnet_tpu_torch/parallel/halo.py, md/halo_md.py, the XLA stack's halo
branch, ops/nlist.neighbor_list_rect, ops/ewald.
ewald_energy_periodic_sharded, the Trainer's and the CLI's halo) on the
CPU, mirroring tests/test_halo.py and tests/test_halo_md.py case by case.

Without processes: neighbor_list_rect against the JAX function (lists as
sets per row, displacements at 1e-12 in float64), the sharded Ewald
energy on one rank against the whole one, the capacity check, and every
refusal with the JAX package's error type and message.

One spawned group: parallel/launch.py starts four gloo ranks of this
file's `worker` (one thread each), which build the meshes (data, graph) =
(1, 4), (2, 2) and (1, 2) from those ranks and write their results to the
test's temporary directory; the module fixture runs the one-process side
in this process while the ranks work. Held in float64 to the port's own
one-process model (dense graph) at the JAX tests' bars (energy 1e-9;
forces rtol 1e-7 atol 1e-9; stress rtol 1e-7; loss rtol 1e-8; gradients
and parameters after one Adam step rtol 3e-5 atol 1e-7), and to the JAX
halo numbers stored in tests/reference/jax_halo.npz at the same bars:
energies, forces and stress; one training step with the energy + force,
stress, virial, charge + Ewald and direct-force losses; the exchange's
placement and adjoint; every exchange's payload of 2 n_halo rows, counted
by collectives.STATS; the Trainer's halo mode against the standard
Trainer, and its capacity check on every batch; a CLI epoch with
training.parallel {data: 2, graph: 2} and training.halo against the same
epoch in one process; NVE with a re-sort against one process, with and
without a charge head (the halo ranks add their shares of the sharded
Ewald energy); Langevin with re-sorts against one-process Langevin steps
fed the ranks' noise; the permutation round trip, an invalid partition and
the partition's ageing.

The JAX numbers come from the JAX halo functions on make_mesh(data=2,
graph=4) and make_mesh(1, 4) over 8 virtual CPU devices, from the
parameters stored beside them. The recipe:

    python tests/test_torch_halo.py jax

(about a minute) writes tests/reference/jax_halo.npz; the test never
recomputes them.
'''
import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, 'tests', 'reference', 'jax_halo.npz')
CUTOFF = 3.0
BOX = (48.0, 6.0, 6.0)
N_ATOMS = 48
N_HALO = 6
MD_HALO = 8
BASE = dict(cutoff=CUTOFF, n_features=16, n_basis=4, n_interactions=2)
EWALD = dict(ewald_mode='periodic', ewald_sigma=1.5, ewald_n_k=4)
MESHES = ((1, 4), (2, 2), (1, 2))
EF = ['energy', 'gradient_force']
# case -> (output properties, loss weights, batch seed, label seed, ewald)
TRAIN = {
    'ef': (EF, {'energy': 1.0, 'gradient_force': 50.0}, 1, None, {}),
    'stress': (EF + ['stress'], {'energy': 1.0, 'gradient_force': 50.0,
                                 'stress': 100.0}, 11, 12, {}),
    'virial': (['energy', 'virial'], {'energy': 1.0, 'virial': 10.0}, 21,
               22, {}),
    'charge': (['charge'] + EF, {'energy': 1.0, 'gradient_force': 50.0}, 31,
               None, EWALD),
    'direct': (['energy', 'direct_force'],
               {'energy': 1.0, 'direct_force': 20.0}, 41, None, {}),
}
DIRECT_METRICS = ('direct_force_mae', 'direct_force_mse',
                  'direct_force_cos_mae', 'direct_force_cos_mse',
                  'direct_force_norm_mae', 'direct_force_norm_mse')
TRAINER_KEYS = ('loss', 'energy_mae', 'energy_mse', 'energy_per_atom_mae',
                'gradient_force_mae', 'gradient_force_mse')
MD = dict(dt=0.2, n_steps=8, resort_every=4)
LANGEVIN = dict(timestep=0.1, n_steps=12, resort_every=4,
                temperature_K=300.0, friction=0.02, skin=0.5, seed=3)
TIMING = ('epoch_seconds', 'steps_per_s', 'edges_per_s')


def gas(B, N, box, seed, periodic, n_shards=4):
    '''The JAX test's random gas, sorted for the slab decomposition.'''
    from newtonnet_tpu_torch.data.pipeline import spatial_sort
    rs = np.random.RandomState(seed)
    z = rs.choice([1, 6, 8], size=(B, N)).astype(np.int32)
    pos = rs.rand(B, N, 3) * np.asarray(box)
    if periodic:
        cell = np.broadcast_to(np.diag(box), (B, 3, 3)).astype(float).copy()
    else:
        cell = np.zeros((B, 3, 3))
    force = rs.randn(B, N, 3)
    energy = rs.randn(B)
    z, pos, extra = spatial_sort(z, pos, cell if periodic else None,
                                 extra={'force': force}, n_shards=n_shards)
    return {'z': z, 'pos': pos, 'cell': cell, 'energy': energy,
            'force': extra['force'], 'graph_mask': np.ones(B, bool)}


def train_batch(case):
    _, _, seed, label_seed, _ = TRAIN[case]
    batch = gas(2, N_ATOMS, BOX, seed, periodic=True)
    if case == 'stress':
        batch['stress'] = np.random.RandomState(label_seed).randn(2, 3, 3) \
            * 1e-2
    if case == 'virial':
        batch['virial'] = np.random.RandomState(label_seed).randn(2, 3, 3)
    return batch


def md_system(seed=0, temperature_K=300.0):
    '''The JAX halo MD test's system.'''
    from newtonnet_tpu_torch.md.system import System, maxwell_boltzmann
    rs = np.random.RandomState(seed)
    numbers = rs.choice([1, 6, 8], size=N_ATOMS).astype(np.int32)
    pos = rs.rand(N_ATOMS, 3) * np.asarray(BOX)
    s = System(numbers, pos, cell=np.diag(BOX), pbc=[True] * 3)
    if temperature_K:
        maxwell_boltzmann(s, temperature_K, rng=np.random.default_rng(seed))
    return s


def tree(ref, prefix):
    '''The flax {'params': ...} tree stored under `prefix` in the npz.'''
    out = {}
    for key in ref.files:
        if not key.startswith(prefix):
            continue
        node = out
        *path, leaf = key[len(prefix):].split('.')
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = ref[key]
    return {'params': out}


def port_model(ref, case, graph_mode='neighborlist', **changes):
    import torch

    from newtonnet_tpu_torch import NewtonNet
    from newtonnet_tpu_torch.utils.params import params_from_flax
    props, _, _, _, ewald = TRAIN[case]
    kw = dict(graph_mode='neighborlist', k_max=24) \
        if graph_mode == 'neighborlist' else {}
    model = NewtonNet(**BASE, **kw, **ewald, output_properties=props,
                      device='cpu', dtype=torch.float64, **changes)
    params_from_flax(tree(ref, f'{case}.'), core=model.core)
    return model


def flat(model, grads=False):
    '''The parameters, or their gradients (zeros where a parameter has
    none: the first layer's equiv_message2), flat in parameter order.'''
    import torch

    def value(p):
        if not grads:
            return p.detach()
        return torch.zeros_like(p) if p.grad is None else p.grad
    return torch.cat([value(p).reshape(-1)
                      for p in model.core.parameters()]).numpy()


def adam(model):
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    return get_optimizer_by_string('adam', model.core, lr=1e-3)


def losses(case):
    return {k: {'weight': v, 'mode': 'mse'} for k, v in TRAIN[case][1].items()}


# ---------------------------------------------------------------- #
# the one-process side


def one_process(ref):
    '''Everything the ranks are held to, in this process: the dense
    model's requests, one standard Adam step per case, the standard
    Trainer's epoch, the velocity-Verlet trajectories without and with a
    charge head, and the Langevin trajectory fed the ranks' noise.'''
    import torch

    from newtonnet_tpu_torch import Trainer
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
    out = {}
    for periodic in (False, True):
        b = gas(2, N_ATOMS, BOX, 0, periodic)
        m = port_model(ref, 'stress', 'dense')
        o = m(*(torch.from_numpy(b[k]) for k in ('z', 'pos', 'cell')))
        key = 'per' if periodic else 'aper'
        out[f'{key}/energy'] = o['energy'].numpy()
        out[f'{key}/forces'] = o['gradient_force'].numpy()
        out[f'{key}/stress'] = o['stress'].numpy()
    for case in TRAIN:
        m = port_model(ref, case, 'dense')
        batch = {k: torch.as_tensor(v) for k, v in train_batch(case).items()}
        main_loss, eval_loss = get_loss_by_string(losses(case))
        loss, preds = standard_value_and_grad(m, main_loss, batch)
        out[f'{case}/loss'] = loss.numpy()
        out[f'{case}/grads'] = flat(m, grads=True)
        if case == 'direct':
            ev = eval_loss(preds, batch)
            for k in DIRECT_METRICS:
                out[f'direct/{k}'] = ev[k].numpy()
        adam(m).step()
        out[f'{case}/params'] = flat(m)
    m = port_model(ref, 'ef', 'dense')
    t = Trainer(m, loss_fns=get_loss_by_string(losses('ef')),
                optimizer=adam(m), fast_grad=False)
    batch = gas(2, N_ATOMS, BOX, 3, periodic=True)
    tr = t.run_one_epoch([dict(batch)], step=True)
    ev = t.run_one_epoch([dict(batch)], step=False)
    for k in TRAINER_KEYS:
        out[f'trainer/{k}'] = tr[k]
    out['trainer/eval_loss'] = ev['loss']
    out['trainer/params'] = flat(m)
    for case in ('ef', 'charge'):
        epots, pos, vel = verlet(port_model(ref, case, 'dense'))
        key = 'md' if case == 'ef' else 'md_charged'
        out[f'{key}/epot'], out[f'{key}/positions'], \
            out[f'{key}/velocities'] = epots, pos, vel
    out.update(langevin_one_process(port_model(ref, 'ef', 'dense')))
    return out


def verlet(m):
    '''MD's velocity-Verlet trajectory of md_system(0) over a dense model:
    -> (potential energies, final positions, final velocities).'''
    import torch
    s = md_system(0)
    z = torch.from_numpy(s.numbers[None]).long()
    cell = torch.from_numpy(s.cell[None])
    mass = s.masses[:, None]
    pos, vel = s.positions.copy(), s.get_velocities().copy()

    def ef(p):
        o = m(z, torch.from_numpy(p[None]), cell)
        return float(o['energy'][0]), o['gradient_force'][0].numpy()
    epots = []
    _, f = ef(pos)
    for _ in range(MD['n_steps']):
        vel = vel + 0.5 * MD['dt'] * f / mass
        pos = pos + MD['dt'] * vel
        e, f = ef(pos)
        vel = vel + 0.5 * MD['dt'] * f / mass
        epots.append(e)
    return np.asarray(epots), pos, vel


def langevin_one_process(m, n_shards=4):
    '''LANGEVIN's trajectory of md_system(2) in one process
    (md/driver.langevin_step over a dense model), fed the noise the halo
    ranks of a (1, n_shards) mesh draw: each slab's generator, seeded from
    (seed, slab), draws xi then eta per step over its slab of the chunk's
    x-sorted order, which the chunk's sort maps back to the atoms.'''
    import torch

    from newtonnet_tpu_torch.data.pipeline import spatial_sort
    from newtonnet_tpu_torch.data.units import kB
    from newtonnet_tpu_torch.md.driver import langevin_step
    from newtonnet_tpu_torch.md.halo_md import _seed
    s = md_system(2)
    n_loc = N_ATOMS // n_shards
    gens = [torch.Generator().manual_seed(_seed(LANGEVIN['seed'], g))
            for g in range(n_shards)]
    z = torch.from_numpy(s.numbers[None]).long()
    cell = torch.from_numpy(s.cell[None])
    masses = torch.from_numpy(s.masses[None])
    pos = torch.from_numpy(s.positions[None].copy())
    vel = torch.from_numpy(s.get_velocities()[None].copy())
    state = (pos, vel, m(z, pos, cell)['gradient_force'])
    epots = []
    for _ in range(LANGEVIN['n_steps'] // LANGEVIN['resort_every']):
        _, _, extra = spatial_sort(
            s.numbers[None], state[0].numpy(), s.cell[None],
            extra={'tag': np.arange(N_ATOMS)[None]}, n_shards=n_shards)
        order = torch.from_numpy(extra['tag'][0])
        for _ in range(LANGEVIN['resort_every']):
            draws = [[torch.randn((1, n_loc, 3), generator=g,
                                  dtype=torch.float64) for _ in range(2)]
                     for g in gens]
            noise = []
            for i in range(2):  # xi, eta
                a = torch.empty((1, N_ATOMS, 3), dtype=torch.float64)
                a[:, order] = torch.cat([d[i] for d in draws], dim=1)
                noise.append(a)
            state, epot, _ = langevin_step(
                m, z, masses, cell, state, *noise, dt=LANGEVIN['timestep'],
                temp=float(kB * LANGEVIN['temperature_K']),
                friction=LANGEVIN['friction'])
            epots.append(float(epot[0]))
    return {'langevin/epot': np.asarray(epots),
            'langevin/positions': state[0][0].detach().numpy(),
            'langevin/velocities': state[1][0].detach().numpy()}


# ---------------------------------------------------------------- #
# the ranks


def _raises(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ''


def rank_requests(ref, mesh, res, tag):
    '''Energies, forces and stress of the halo request, and the exchanges'
    payloads of the periodic one.'''
    import torch

    from newtonnet_tpu_torch.parallel import collectives
    from newtonnet_tpu_torch.parallel.halo import (
        check_halo_capacity,
        make_halo_energy_force_fn,
    )
    model = port_model(ref, 'stress')
    G = mesh.shape['graph']
    for periodic in (False, True):
        b = gas(2, N_ATOMS, BOX, 0, periodic)
        res[f'{tag}/capacity_{periodic}'] = check_halo_capacity(
            b['z'], b['pos'], b['cell'] if periodic else None, G, N_HALO,
            CUTOFF)
        collectives.reset_stats()
        fn = make_halo_energy_force_fn(model, mesh, N_HALO,
                                       compute_stress=periodic)
        got = fn(*(torch.from_numpy(b[k]) for k in ('z', 'pos', 'cell')))
        key = 'per' if periodic else 'aper'
        res[f'{tag}/{key}/energy'] = got[0].numpy()
        res[f'{tag}/{key}/forces'] = got[1].numpy()
        if periodic:
            res[f'{tag}/per/stress'] = got[2].numpy()
        res[f'{tag}/{key}/stats'] = np.asarray(
            [collectives.STATS[k] for k in (
                'halo_calls', 'halo_rows', 'halo_bytes', 'halo_row_bytes',
                'halo_rows_max')])


def rank_steps(ref, mesh, res, tag):
    '''One halo Adam step per training case: the loss, the gradient and
    the parameters after the step (and the direct-force decompositions),
    with the exchanges' payloads of the ef case.'''
    from newtonnet_tpu_torch.parallel import collectives
    from newtonnet_tpu_torch.parallel.halo import (
        make_halo_grads_fn,
        shard_halo_batch,
    )
    for case in TRAIN:
        model = port_model(ref, case)
        fn = make_halo_grads_fn(model, mesh, N_HALO,
                                loss_config=losses(case))
        collectives.reset_stats()
        metrics = fn(shard_halo_batch(train_batch(case), mesh))
        if case == 'ef':
            res[f'{tag}/ef/stats'] = np.asarray(
                [collectives.STATS[k] for k in (
                    'halo_calls', 'halo_rows', 'halo_bytes',
                    'halo_row_bytes', 'halo_rows_max')])
        res[f'{tag}/{case}/loss'] = metrics['loss'].numpy()
        res[f'{tag}/{case}/grads'] = flat(model, grads=True)
        if case == 'direct':
            for k in DIRECT_METRICS:
                res[f'{tag}/direct/{k}'] = metrics[k].numpy()
        adam(model).step()
        res[f'{tag}/{case}/params'] = flat(model)


def rank_exchange(mesh, res, tag):
    '''The JAX round trip (16 rows over 4 ranks, n_halo 2) and the
    adjoint identity <exchange(x), y> = <x, reverse(y)> summed over the
    ranks, in the first and second order.'''
    import torch

    from newtonnet_tpu_torch.parallel.collectives import (
        HaloExchange,
        HaloReturn,
        all_reduce_sum,
        exchange_halo,
    )
    group, g = mesh.group('graph'), mesh.index('graph')
    G = mesh.shape['graph']
    n = 16 // G
    x = torch.arange(16, dtype=torch.float64)[None, g * n:(g + 1) * n]
    res[f'{tag}/roundtrip'] = exchange_halo(x, 2, group)[0].numpy()
    gen = torch.Generator().manual_seed(g)
    a = torch.randn(2, n, 3, generator=gen, dtype=torch.float64)
    y = torch.randn(2, n + 4, 3, generator=gen, dtype=torch.float64)
    dots = torch.stack([torch.sum(HaloExchange.apply(a, 2, group) * y),
                        torch.sum(a * HaloReturn.apply(y, 2, group))])
    # the second order: the reverse exchange's backward is the exchange
    y.requires_grad_(True)
    (ga,) = torch.autograd.grad(HaloReturn.apply(y, 2, group), y,
                                grad_outputs=a)
    dots = torch.cat([dots, torch.sum(ga.detach() * y.detach())[None]])
    res[f'{tag}/adjoint'] = all_reduce_sum(dots.detach(), group).numpy()


def rank_guards(mesh2, res):
    '''The refusals that need a process group: the exchange's own.'''
    import torch

    from newtonnet_tpu_torch.parallel.collectives import exchange_halo
    group = mesh2.group('graph')
    x = torch.zeros(1, 16, 3)
    res['guard/double_count'] = _raises(lambda: exchange_halo(x, 10, group))
    res['guard/too_large'] = _raises(lambda: exchange_halo(x, 17, group))
    res['guard/zero'] = _raises(lambda: exchange_halo(x, 0, group))


def rank_trainer(ref, mesh, mesh_cap, res):
    '''The Trainer's halo mode on (2, 2) (one training epoch, one eval
    epoch), then its capacity check on every batch on (1, 4).'''
    import torch  # noqa: F401

    from newtonnet_tpu_torch import Trainer
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    model = port_model(ref, 'ef')
    t = Trainer(model, loss_fns=get_loss_by_string(losses('ef')),
                optimizer=adam(model), mesh=mesh, halo={'n_halo': 9})
    batch = gas(2, N_ATOMS, BOX, 3, periodic=True)
    tr = t.run_one_epoch([dict(batch)], step=True)
    ev = t.run_one_epoch([dict(batch)], step=False)
    for k in TRAINER_KEYS:
        res[f'trainer/{k}'] = tr[k]
    res['trainer/eval_loss'] = ev['loss']
    res['trainer/params'] = flat(model)
    res['trainer/fast_grad'] = t.fast_grad
    model = port_model(ref, 'ef')
    t = Trainer(model, loss_fns=get_loss_by_string(losses('ef')),
                optimizer=adam(model), mesh=mesh_cap, halo={'n_halo': 9})
    res['capacity/clean_loss'] = t.run_one_epoch(
        [dict(batch), dict(batch)], step=True)['loss']
    bad = {k: np.array(v) for k, v in batch.items()}
    perm = np.random.RandomState(0).permutation(N_ATOMS)
    for key in ('z', 'pos', 'force'):
        bad[key][0] = bad[key][0][perm]
    res['capacity/message'] = _raises(
        lambda: t.run_one_epoch([dict(batch), bad], step=True))


def rank_md(ref, mesh, res, tag, all_cases):
    '''NVE with a re-sort, without and with a charge head; on (1, 4) also
    the JAX MD test's other cases.'''
    import warnings

    from newtonnet_tpu_torch.md.halo_md import run_md_halo
    for case in ('ef', 'charge'):
        s = md_system(0)
        _, log = run_md_halo(port_model(ref, case), None, s, mesh, MD_HALO,
                             timestep=MD['dt'], n_steps=MD['n_steps'],
                             resort_every=MD['resort_every'],
                             integrator='nve', dtype=np.float64)
        key = f'{tag}/md' if case == 'ef' else f'{tag}/md_charged'
        res[f'{key}/epot'] = log['epot']
        res[f'{key}/counters'] = np.asarray([log['n_resorts'],
                                             log['skin_violations']])
        res[f'{key}/positions'] = s.positions
        res[f'{key}/velocities'] = s.get_velocities()
    if not all_cases:
        return
    model = port_model(ref, 'ef')
    s = md_system(1)
    pos0, mom0 = s.positions.copy(), s.momenta.copy()
    _, log = run_md_halo(model, None, s, mesh, MD_HALO, timestep=0.0,
                         n_steps=4, resort_every=2, integrator='nve',
                         dtype=np.float64)
    res['md/roundtrip_pos'] = s.positions - pos0
    res['md/roundtrip_mom'] = np.abs(s.momenta - mom0) / np.maximum(
        np.abs(mom0), 1e-300)
    res['md/roundtrip_epot'] = log['epot']
    s = md_system(2)
    _, log = run_md_halo(model, None, s, mesh, MD_HALO, **LANGEVIN,
                         integrator='langevin', dtype=np.float64,
                         log_every=2)
    res['md/langevin_epot'] = log['epot']
    res['md/langevin_temperature'] = log['temperature']
    res['md/langevin_positions'] = s.positions
    res['md/langevin_velocities'] = s.get_velocities()
    s = md_system(3)
    res['md/invalid'] = _raises(lambda: run_md_halo(
        model, None, s, mesh, 1, timestep=0.1, n_steps=2, resort_every=2,
        integrator='nve'))
    s = md_system(4, temperature_K=None)
    s.set_velocities(np.full((len(s), 3), 0.5))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        _, log = run_md_halo(model, None, s, mesh, MD_HALO, timestep=0.5,
                             n_steps=4, resort_every=4, integrator='nve',
                             skin=0.2, dtype=np.float64)
    res['md/ageing'] = log['skin_violations']
    res['md/ageing_warned'] = any('halo MD partition quality'
                                  in str(w.message) for w in caught)


def worker(out_dir):
    '''One rank of the spawned group (started by parallel/launch.py).'''
    import torch
    torch.set_num_threads(1)
    from newtonnet_tpu_torch.parallel import distributed
    from newtonnet_tpu_torch.parallel.mesh import make_mesh
    from newtonnet_tpu_torch.train import cli
    assert distributed.maybe_initialize_from_env('cpu')
    rank = distributed.world()[0]
    ref = np.load(REF)
    res = {}
    meshes = {(d, g): make_mesh(data=d, graph=g, ranks=range(d * g))
              for d, g in MESHES}
    for (d, g), mesh in meshes.items():
        if mesh.coords is None:
            continue
        tag = f'm{d}{g}'
        rank_requests(ref, mesh, res, tag)
        rank_steps(ref, mesh, res, tag)
        rank_md(ref, mesh, res, tag, all_cases=(d, g) == (1, 4))
        if d == 1:
            rank_exchange(mesh, res, tag)
        if (d, g) == (1, 2):
            rank_guards(mesh, res)
    rank_trainer(ref, meshes[(2, 2)], meshes[(1, 4)], res)
    cli.main(['--config', os.path.join(out_dir, 'mp.yml')])
    np.savez(os.path.join(out_dir, f'rank{rank}.npz'), **res)


# ---------------------------------------------------------------- #
# the CLI epoch


def write_frames(root, n_frames=8, seed=5):
    '''Seeded periodic gas frames as root/raw/gas.extxyz (energy and
    force labels from numpy).'''
    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, 'raw'), exist_ok=True)
    names = {1: 'H', 6: 'C', 8: 'O'}
    L = 'Lattice="{} 0 0 0 {} 0 0 0 {}"'.format(*BOX)
    with open(os.path.join(root, 'raw', 'gas.extxyz'), 'w') as f:
        for _ in range(n_frames):
            z = rs.choice([1, 6, 8], size=N_ATOMS)
            pos = rs.rand(N_ATOMS, 3) * np.asarray(BOX)
            force = rs.randn(N_ATOMS, 3)
            f.write(f'{N_ATOMS}\n{L} Properties=species:S:1:pos:R:3:'
                    f'forces:R:3 energy={rs.randn():.10f} pbc="T T T"\n')
            for a, p, fo in zip(z, pos, force):
                f.write(f'{names[a]} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f} '
                        f'{fo[0]:.8f} {fo[1]:.8f} {fo[2]:.8f}\n')


def cli_config(path, out, root, halo):
    cfg = {
        'general': {'device': 'cpu', 'output': out, 'precision': 'double',
                    'seed': 0},
        'data': {'train_root': root, 'test_root': None, 'train_size': 4,
                 'val_size': 2, 'test_size': 2, 'train_batch_size': 2,
                 'val_batch_size': 2, 'test_batch_size': 2,
                 'spatial_sort': True},
        'model': dict(BASE, graph_mode='neighborlist', k_max=24,
                      output_properties=EF),
        'training': {'epochs': 1, 'loss': losses('ef'),
                     'optimizer': {'adam': {'lr': 1e-3}},
                     'checkpoint': {'check_val': 1, 'check_test': 1,
                                    'check_log': 1}},
    }
    if halo:
        cfg['training'].update(parallel={'data': 2, 'graph': 2},
                               halo={'n_halo': 9})
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)


def _env():
    env = dict(os.environ)
    for k in list(env):
        if k.startswith('NEWTONNET_DIST_'):
            del env[k]
    env.update(OMP_NUM_THREADS='1', PYTHONPATH=ROOT)
    return env


def _log(out):
    with open(os.path.join(out, 'training_1', 'log.csv')) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def spawned(tmp_path_factory):
    '''The four ranks' results and this process's one-process side.'''
    from newtonnet_tpu_torch.data.preprocess import main as preprocess
    from newtonnet_tpu_torch.train import cli
    tmp = str(tmp_path_factory.mktemp('halo'))
    data = os.path.join(tmp, 'gas')
    write_frames(data)
    preprocess(['-r', data])  # the ranks read the cache, none writes it
    mp_out, sp_out = os.path.join(tmp, 'mp_out'), os.path.join(tmp, 'sp_out')
    cli_config(os.path.join(tmp, 'mp.yml'), mp_out, data, True)
    cli_config(os.path.join(tmp, 'sp.yml'), sp_out, data, False)
    logs = os.path.join(tmp, 'logs')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'newtonnet_tpu_torch.parallel.launch',
         '--nprocs', '4', '--log-dir', logs, '--timeout', '300', '--',
         sys.executable, os.path.abspath(__file__), 'worker', tmp],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    ref = np.load(REF)
    one = one_process(ref)
    cli.main(['--config', os.path.join(tmp, 'sp.yml')])
    text = proc.communicate(timeout=330)[0]
    tails = ''
    for i in range(4):
        p = os.path.join(logs, f'proc_{i}.log')
        if os.path.exists(p):
            with open(p) as f:
                tails += f'--- rank {i} ---\n' + f.read()[-3000:]
    assert proc.returncode == 0, (text, tails)
    ranks = [dict(np.load(os.path.join(tmp, f'rank{r}.npz')))
             for r in range(4)]
    return dict(ranks=ranks, one=one, ref=ref, mp_log=_log(mp_out),
                sp_log=_log(sp_out), mp_dirs=sorted(os.listdir(mp_out)))


def _each(spawned, d, g):
    '''(rank, results) of the ranks in mesh (d, g).'''
    return [(r, res) for r, res in enumerate(spawned['ranks'])
            if r < d * g]


# ---------------------------------------------------------------- #
# no processes


def _rect_inputs(seed, periodic):
    rs = np.random.RandomState(seed)
    B, n_own, n_cand = 2, 12, 24
    box = np.asarray([9.0, 7.0, 8.0])
    pos_cand = rs.rand(B, n_cand, 3) * box
    pos_own = pos_cand[:, 6:18]
    cell = (np.broadcast_to(np.diag(box), (B, 3, 3)).copy() if periodic
            else np.zeros((B, 3, 3)))
    own_mask = np.ones((B, n_own), bool)
    own_mask[1, -2:] = False
    cand_mask = np.ones((B, n_cand), bool)
    cand_mask[1, 16:18] = False
    cand_mask[0, 2] = False
    return pos_own, pos_cand, cell, own_mask, cand_mask


@pytest.mark.parametrize('periodic', [False, True])
@pytest.mark.parametrize('k_max', [6, 40])
def test_neighbor_list_rect_matches_jax(periodic, k_max):
    '''Own rows against a candidate set with self-edges excluded at offset
    6: the same neighbours per row (as sets: torch.topk may order ties
    otherwise), displacements at 1e-12, the same overflow counts; k_max
    past N_cand - 1 is clamped as there.'''
    import jax.numpy as jnp
    import torch

    from newtonnet_tpu.ops.nlist import neighbor_list_rect as jax_rect
    from newtonnet_tpu_torch.ops.nlist import neighbor_list_rect
    args = _rect_inputs(3, periodic)
    j_idx, j_mask, j_disp, j_ovf = (np.asarray(a) for a in jax_rect(
        *(jnp.asarray(a) for a in args), 4.0, k_max, self_offset=6))
    p_idx, p_mask, p_disp, p_ovf = (a.numpy() for a in neighbor_list_rect(
        *(torch.from_numpy(a) for a in args), 4.0, k_max, self_offset=6,
        chunk=5))
    assert p_idx.shape == j_idx.shape
    np.testing.assert_array_equal(p_ovf, j_ovf)
    for b in range(2):
        for i in range(p_idx.shape[1]):
            want = {int(j): k for k, j in enumerate(j_idx[b, i])
                    if j_mask[b, i, k]}
            got = {int(j): k for k, j in enumerate(p_idx[b, i])
                   if p_mask[b, i, k]}
            assert set(got) == set(want), (b, i)
            assert 6 + i not in got
            for j, k in got.items():
                np.testing.assert_allclose(p_disp[b, i, k],
                                           j_disp[b, i, want[j]],
                                           rtol=0, atol=1e-12)
    assert np.all(p_idx[~p_mask] == 0)


def test_sharded_ewald_on_one_rank_is_the_whole_sum():
    '''With one rank (the reduce the identity) the share is the whole
    graph's energy, and so are its position and charge gradients.'''
    import torch

    from newtonnet_tpu_torch.ops.ewald import (
        ewald_energy_periodic,
        ewald_energy_periodic_sharded,
    )
    rs = np.random.RandomState(0)
    q = torch.tensor(rs.randn(2, 10), requires_grad=True)
    pos = torch.tensor(rs.rand(2, 10, 3) * 6.0, requires_grad=True)
    cell = torch.from_numpy(np.broadcast_to(np.diag([6.0, 7.0, 5.0]),
                                            (2, 3, 3)).copy())
    mask = torch.ones(2, 10, dtype=torch.bool)
    a = ewald_energy_periodic(q, pos, cell, mask, sigma=1.5, n_k=3)
    b = ewald_energy_periodic_sharded(q, pos, cell, mask, lambda s: s,
                                      sigma=1.5, n_k=3)
    np.testing.assert_allclose(b.detach(), a.detach(), rtol=1e-13)
    ga = torch.autograd.grad(a.sum(), (q, pos))
    gb = torch.autograd.grad(b.sum(), (q, pos))
    for x, y in zip(gb, ga):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-14)


def test_check_halo_capacity_flags_undersized():
    '''The JAX test's case: a 1-atom halo cannot cover a 3 A boundary
    layer of the gas; 8 atoms can. The same counts as the JAX function.'''
    from newtonnet_tpu.parallel.halo import check_halo_capacity as jax_check
    from newtonnet_tpu_torch.parallel.halo import check_halo_capacity
    batch = gas(2, 48, BOX, 3, periodic=False)
    for n_halo in (8, 1):
        got = check_halo_capacity(batch['z'], batch['pos'], None, 4,
                                  n_halo, CUTOFF)
        assert got == jax_check(batch['z'], batch['pos'], None, 4, n_halo,
                                CUTOFF)
        assert (got == 0) == (n_halo == 8)
    per = gas(2, 48, BOX, 3, periodic=True)
    assert check_halo_capacity(per['z'], per['pos'], per['cell'], 4, 2,
                               CUTOFF) == jax_check(
        per['z'], per['pos'], per['cell'], 4, 2, CUTOFF)


@pytest.mark.parametrize('chunk_columns', [1, 2, 4, 8])
def test_gather_backward_hands_k9_contiguous_indices(monkeypatch,
                                                     chunk_columns):
    '''gather_nodes' backward sums each node's slots in chunks of
    transpose columns, one row gather (K9 on the card, which takes
    contiguous indices only) per chunk: a last chunk of one column must
    not reach it as a strided view (the halo MD's extended axis met one on
    the card). Every chunking gives the unchunked sum.'''
    import torch

    from newtonnet_tpu_torch.ops import nlist
    rs = np.random.RandomState(0)
    idx = torch.from_numpy(rs.randint(0, 9, size=(1, 9, 7)))
    mask = torch.from_numpy(rs.rand(1, 9, 7) > 0.2)
    x = torch.randn(1, 9, 5, dtype=torch.float64, requires_grad=True)
    y = torch.randn(1, 9, 7, 5, dtype=torch.float64)
    (want,) = torch.autograd.grad(nlist.gather_nodes(x, idx, mask), x, y)
    tr = nlist.node_transpose(idx, 9, mask)
    assert tr.slots.shape[2] % chunk_columns == 1 or chunk_columns == 1
    seen = []
    real = nlist.row_gather

    def spy(rows, index):
        seen.append(index.is_contiguous() and rows.is_contiguous())
        return real(rows, index)
    monkeypatch.setattr(nlist, 'row_gather', spy)
    monkeypatch.setattr(nlist, 'TRANSPOSE_CHUNK_BYTES',
                        chunk_columns * 9 * 5 * 8)
    (got,) = torch.autograd.grad(nlist.gather_nodes(x, idx, mask), x, y)
    assert seen and all(seen)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)


def _fake_mesh(data, graph):
    from newtonnet_tpu_torch.parallel.mesh import Mesh
    return Mesh(np.arange(data * graph).reshape(data, graph),
                {'data': None, 'graph': None}, 0)


def _model(props=('energy',), **kw):
    import torch

    from newtonnet_tpu_torch import NewtonNet
    return NewtonNet(graph_mode=kw.pop('graph_mode', 'neighborlist'),
                     k_max=8, n_features=8, n_basis=4, n_interactions=1,
                     output_properties=list(props), device='cpu',
                     dtype=torch.float64, **kw)


@pytest.mark.parametrize('what, match', [
    ('n_halo_0', 'n_halo must be >= 1'),
    ('graph_1', '>= 2 shards'),
    ('dense', "graph_mode='neighborlist'"),
    ('hessian', 'second-derivative'),
    ('bec', 'second-derivative'),
    ('direct_head', 'direct_force head'),
    ('charge_auto', "ewald_mode='periodic'"),
    ('md_charge_auto', "halo MD with a charge head requires ewald_mode"),
    ('loss_key', 'losses within'),
    ('loss_mode', 'mse-only'),
    ('reverse_lists', 'reverse_lists is incompatible with halo sharding'),
    ('newton3', 'inverse_lists/newton3 require the K-major edge layout'),
    ('inverse_lists', 'inverse_lists/newton3 require the K-major edge'),
    ('newton3_compact', 'newton3_compact is its own edge layout')])
def test_halo_guards(what, match):
    '''Degenerate or unsupported halo configurations raise the JAX
    package's ValueError (tests/test_halo.py's guards and the JAX core's
    halo refusals), before any exchange.'''
    import torch

    from newtonnet_tpu_torch.md.halo_md import run_md_halo
    from newtonnet_tpu_torch.models.xla_stack import apply_core_xla
    from newtonnet_tpu_torch.parallel.halo import (
        make_halo_energy_force_fn,
        make_halo_train_step,
    )
    mesh = _fake_mesh(2, 4)
    ef = {'energy': {}}

    def step(model, n_halo=4, loss=ef, m=mesh):
        make_halo_train_step(model, adam(model), m, n_halo, loss_config=loss)
    cases = {
        'n_halo_0': lambda: step(_model(), n_halo=0),
        'graph_1': lambda: step(_model(), m=_fake_mesh(8, 1)),
        'dense': lambda: make_halo_energy_force_fn(
            _model(graph_mode='dense'), mesh, 4),
        'hessian': lambda: step(_model(('energy', 'hessian'),
                                       ewald_mode='periodic')),
        'bec': lambda: step(_model(('charge', 'energy', 'bec'),
                                   ewald_mode='periodic')),
        'direct_head': lambda: step(_model(), loss={'energy': {},
                                                    'direct_force': {}}),
        'charge_auto': lambda: step(_model(('charge', 'energy'))),
        'md_charge_auto': lambda: run_md_halo(
            _model(('charge', 'energy')), None, md_system(0), mesh, 4,
            timestep=0.1, n_steps=2, resort_every=2),
        'loss_key': lambda: step(_model(), loss={'hessian': {}}),
        'loss_mode': lambda: step(_model(), loss={'energy': {'mode':
                                                             'mae'}}),
    }
    if what in cases:
        with pytest.raises(ValueError, match=match):
            cases[what]()
        return
    model = _model(**{what: True})
    z = torch.ones((1, 8), dtype=torch.long)
    pos = torch.rand((1, 8, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        apply_core_xla(model, z, pos, torch.zeros(1, 3, 3), halo=2)


def test_trainer_halo_guards():
    '''Trainer(halo=...) without a graph axis of 2 raises the JAX
    Trainer's ValueError, and so does a loss outside the mse battery.'''
    from newtonnet_tpu_torch import Trainer
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    model = _model(('energy', 'gradient_force'))
    with pytest.raises(ValueError, match="'graph' axis"):
        Trainer(model, loss_fns=get_loss_by_string(losses('ef')),
                halo={'n_halo': 4})
    with pytest.raises(ValueError, match="'graph' axis"):
        Trainer(model, loss_fns=get_loss_by_string(losses('ef')),
                mesh=_fake_mesh(4, 1), halo={'n_halo': 4})
    with pytest.raises(ValueError, match='energy'):
        Trainer(model, loss_fns=get_loss_by_string({'energy': {'mode':
                                                               'mae'}}),
                mesh=_fake_mesh(2, 4), halo={'n_halo': 4})
    with pytest.raises(ValueError, match='get_loss_by_string'):
        Trainer(model, loss_fns=(lambda p, b: 0.0, lambda p, b: {}),
                mesh=_fake_mesh(2, 4), halo={'n_halo': 4})


# ---------------------------------------------------------------- #
# the spawned group


@pytest.mark.parametrize('periodic', [False, True])
@pytest.mark.parametrize('data, graph', MESHES)
def test_halo_energy_force_parity(spawned, data, graph, periodic):
    '''Halo energies and forces (and the stress, periodic) equal the
    one-process dense model's and the JAX halo function's.'''
    key = 'per' if periodic else 'aper'
    one, ref = spawned['one'], spawned['ref']
    for r, res in _each(spawned, data, graph):
        tag = f'm{data}{graph}/{key}'
        assert res[f'm{data}{graph}/capacity_{periodic}'] == 0
        for want in (one, {f'{key}/{k}': ref[f'{key}/{k}']
                           for k in ('energy', 'forces', 'stress')
                           if f'{key}/{k}' in ref}):
            np.testing.assert_allclose(res[f'{tag}/energy'],
                                       want[f'{key}/energy'], rtol=1e-9,
                                       atol=1e-9)
            np.testing.assert_allclose(res[f'{tag}/forces'],
                                       want[f'{key}/forces'], rtol=1e-7,
                                       atol=1e-9)
            if periodic:
                np.testing.assert_allclose(res[f'{tag}/stress'],
                                           want[f'{key}/stress'], rtol=1e-7,
                                           atol=1e-10)


@pytest.mark.parametrize('case', list(TRAIN))
@pytest.mark.parametrize('data, graph', MESHES)
def test_halo_train_step_parity(spawned, data, graph, case):
    '''One halo Adam step equals the one-process standard step (loss,
    gradient, parameters) and the JAX halo step (loss, parameters): the
    JAX tests' energy + force, stress, virial, charge + Ewald and
    direct-force cases, with the direct force's cos / norm metrics.'''
    one, ref = spawned['one'], spawned['ref']
    loss_rtol = 1e-6 if case == 'direct' else 1e-8
    for r, res in _each(spawned, data, graph):
        tag = f'm{data}{graph}/{case}'
        for want in (one[f'{case}/loss'], ref[f'{case}/loss']):
            np.testing.assert_allclose(res[f'{tag}/loss'], want,
                                       rtol=loss_rtol)
        np.testing.assert_allclose(res[f'{tag}/grads'], one[f'{case}/grads'],
                                   rtol=3e-5, atol=1e-7)
        for want in (one[f'{case}/params'], ref[f'{case}/params']):
            np.testing.assert_allclose(res[f'{tag}/params'], want,
                                       rtol=3e-5, atol=1e-7)
        if case == 'direct':
            for k in DIRECT_METRICS:
                np.testing.assert_allclose(res[f'm{data}{graph}/direct/{k}'],
                                           one[f'direct/{k}'], rtol=2e-5,
                                           err_msg=k)


@pytest.mark.parametrize('data, graph', MESHES)
def test_halo_comm_is_boundary_sized(spawned, data, graph):
    '''Every exchange of a request and of a training step (whose force
    loss differentiates the reverse exchanges again) sends 2 n_halo rows
    per rank, n_halo below the slab's atoms: never an atom-sized tensor
    (collectives.STATS).'''
    n_loc = N_ATOMS // graph
    assert N_HALO < n_loc
    for r, res in _each(spawned, data, graph):
        for what in ('aper', 'per', 'ef'):
            calls, rows, nbytes, row_bytes, rows_max = \
                res[f'm{data}{graph}/{what}/stats']
            assert calls >= 4, what
            assert rows_max == 2 * N_HALO
            assert rows == 2 * N_HALO * calls
            assert nbytes == 2 * N_HALO * row_bytes


@pytest.mark.parametrize('data, graph', [(1, 4), (1, 2)])
def test_exchange_halo_roundtrip(spawned, data, graph):
    '''exchange_halo places the ring neighbours' boundary blocks (the JAX
    test's 16 rows, n_halo 2), and the reverse exchange is its adjoint,
    in the first order and through its own backward.'''
    n = 16 // graph
    for r, res in _each(spawned, data, graph):
        ext = np.arange(16)[np.arange(r * n - 2, (r + 1) * n + 2) % 16]
        np.testing.assert_array_equal(res[f'm{data}{graph}/roundtrip'], ext)
        a, b, c = res[f'm{data}{graph}/adjoint']
        np.testing.assert_allclose([b, c], [a, a], rtol=1e-12)
    if graph == 4:
        got = spawned['ranks'][1]['m14/roundtrip']
        np.testing.assert_array_equal(got, [2, 3, 4, 5, 6, 7, 8, 9])
        got = spawned['ranks'][0]['m14/roundtrip']
        np.testing.assert_array_equal(got, [14, 15, 0, 1, 2, 3, 4, 5])


@pytest.mark.parametrize('guard, match', [
    ('double_count', 'double-count'),
    ('too_large', r'n_halo must be in \[1, N_loc=16\]'),
    ('zero', r'n_halo must be in \[1, N_loc=16\]')])
def test_exchange_guards(spawned, guard, match):
    '''With 2 ranks, 2 n_halo past N_loc raises (both halos come from the
    one neighbour), and so does an n_halo outside [1, N_loc].'''
    import re
    for r in range(2):
        assert re.search(match, str(spawned['ranks'][r][f'guard/{guard}']))


def test_trainer_halo_mode_matches_standard(spawned):
    '''Trainer(mesh=(2, 2), halo=...) trains the standard epoch loop: the
    epoch's metrics and the parameters equal the one-process standard
    Trainer's, and so does an evaluation epoch; fast_grad is off.'''
    one = spawned['one']
    for r, res in _each(spawned, 2, 2):
        for k in TRAINER_KEYS:
            np.testing.assert_allclose(res[f'trainer/{k}'],
                                       one[f'trainer/{k}'], rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(res['trainer/eval_loss'],
                                   one['trainer/eval_loss'], rtol=1e-5)
        np.testing.assert_allclose(res['trainer/params'],
                                   one['trainer/params'], rtol=0,
                                   atol=1e-7)
        assert not res['trainer/fast_grad']


def test_trainer_halo_capacity_enforced_every_batch(spawned):
    '''A frame that breaks the slab decomposition in batch 2 raises before
    it trains; the clean epoch trains.'''
    for r, res in _each(spawned, 1, 4):
        assert np.isfinite(res['capacity/clean_loss'])
        assert 'capacity violations in batch 2' in \
            str(res['capacity/message'])


def test_cli_halo_epoch_equals_one_process(spawned):
    '''training.parallel {data: 2, graph: 2} with training.halo and
    data.spatial_sort: the chief's log.csv equals the one-process
    standard epoch's within 1e-5 (the epoch, then the last and best
    re-evaluations), in one training_1 directory.'''
    assert spawned['mp_dirs'] == ['training_1']
    got, want = spawned['mp_log'], spawned['sp_log']
    assert [r['epoch'] for r in got] == [r['epoch'] for r in want] == \
        ['0', 'last', 'best']
    for a, b in zip(got, want):
        for key, value in b.items():
            if key in TIMING or not value or key == 'epoch':
                continue
            if value in ('True', 'False'):
                assert a[key] == value, key
                continue
            np.testing.assert_allclose(float(a[key]), float(value),
                                       rtol=1e-5,
                                       err_msg=f'{a["epoch"]} {key}')


@pytest.mark.parametrize('data, graph', MESHES)
def test_halo_md_nve_matches_single_device(spawned, data, graph):
    '''8 velocity-Verlet steps with a re-sort after step 4 equal the
    one-process trajectory of the dense model and the JAX halo run's
    (float64; atoms cross slab boundaries between chunks).'''
    one, ref = spawned['one'], spawned['ref']
    for r, res in _each(spawned, data, graph):
        tag = f'm{data}{graph}/md'
        np.testing.assert_array_equal(res[f'{tag}/counters'], [2, 0])
        for want in (one, ref):
            np.testing.assert_allclose(res[f'{tag}/epot'], want['md/epot'],
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(res[f'{tag}/positions'],
                                       want['md/positions'], rtol=1e-8,
                                       atol=1e-9)
            np.testing.assert_allclose(res[f'{tag}/velocities'],
                                       want['md/velocities'], rtol=1e-7,
                                       atol=1e-10)


@pytest.mark.parametrize('data, graph', MESHES)
def test_halo_md_charged_nve_matches_single_device(spawned, data, graph):
    '''With a charge head (ewald_mode 'periodic') each rank adds its share
    of the sharded Ewald energy to its local energy, so the halo NVE
    trajectory equals the one-process dense model's, whose energy holds
    the whole Ewald term (float64, the NVE bars).'''
    one = spawned['one']
    for r, res in _each(spawned, data, graph):
        tag = f'm{data}{graph}/md_charged'
        np.testing.assert_array_equal(res[f'{tag}/counters'], [2, 0])
        np.testing.assert_allclose(res[f'{tag}/epot'],
                                   one['md_charged/epot'], rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(res[f'{tag}/positions'],
                                   one['md_charged/positions'], rtol=1e-8,
                                   atol=1e-9)
        np.testing.assert_allclose(res[f'{tag}/velocities'],
                                   one['md_charged/velocities'], rtol=1e-7,
                                   atol=1e-10)


def test_halo_md_permutation_roundtrip(spawned):
    '''dt = 0: sort, shard and unsort return every atom to its slot, bit
    for bit (momenta through mom / m * m: one ulp).'''
    for r, res in _each(spawned, 1, 4):
        np.testing.assert_array_equal(res['md/roundtrip_pos'], 0.0)
        assert res['md/roundtrip_mom'].max() <= 1e-14
        assert np.all(np.isfinite(res['md/roundtrip_epot']))


def test_halo_md_langevin_runs(spawned):
    for r, res in _each(spawned, 1, 4):
        assert res['md/langevin_epot'].shape == (6,)
        assert np.all(np.isfinite(res['md/langevin_temperature']))
        assert res['md/langevin_temperature'][-1] > 0


def test_halo_md_langevin_matches_single_device_noise(spawned):
    '''12 Langevin steps with re-sorts after steps 4 and 8 equal
    md/driver.langevin_step in one process fed the same noise (each slab's
    draws mapped back through that chunk's sort): the coefficients, the
    masks and the noise's placement of the halo chunk (float64, the NVE
    bars).'''
    one = spawned['one']
    for r, res in _each(spawned, 1, 4):
        np.testing.assert_allclose(res['md/langevin_epot'],
                                   one['langevin/epot'][::2], rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(res['md/langevin_positions'],
                                   one['langevin/positions'], rtol=1e-8,
                                   atol=1e-9)
        np.testing.assert_allclose(res['md/langevin_velocities'],
                                   one['langevin/velocities'], rtol=1e-7,
                                   atol=1e-10)


def test_halo_md_invalid_partition_raises(spawned):
    '''A 1-atom halo cannot cover a 3 A boundary layer.'''
    for r, res in _each(spawned, 1, 4):
        assert 'halo partition invalid' in str(res['md/invalid'])


def test_halo_md_reports_partition_aging(spawned):
    '''Atoms racing across the skin margin within a chunk are counted and
    warned about.'''
    for r, res in _each(spawned, 1, 4):
        assert res['md/ageing'] == 1
        assert res['md/ageing_warned']


# ---------------------------------------------------------------- #
# the JAX recipe


def jax_recipe():
    '''Write tests/reference/jax_halo.npz (eight virtual CPU devices).'''
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    import optax

    from newtonnet_tpu.md.halo_md import run_md_halo
    from newtonnet_tpu.md.system import System, maxwell_boltzmann
    from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
    from newtonnet_tpu.parallel import make_mesh
    from newtonnet_tpu.parallel.halo import (
        make_halo_energy_force_fn,
        make_halo_train_step,
        shard_halo_batch,
    )
    from newtonnet_tpu_torch import NewtonNet
    out = {}
    rng = jax.random.PRNGKey(0)
    mesh = make_mesh(data=2, graph=4)

    def store(prefix, params):
        for path, v in jax.tree_util.tree_flatten_with_path(
                params['params'])[0]:
            out[prefix + '.'.join(k.key for k in path)] = np.asarray(v)

    def flat_jax(params, props, ewald):
        order = [n for n, _ in NewtonNet(
            **BASE, **ewald, output_properties=props,
            device='cpu').core.named_parameters()]
        leaves = {'.'.join(k.key for k in path): np.asarray(v)
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      params['params'])[0]}
        return np.concatenate([leaves[n].reshape(-1) for n in order])

    def init(props, ewald, batch):
        dense = JaxNewtonNet(**BASE, output_properties=props, **ewald)
        return dense.init(rng, *(jnp.asarray(batch[k])
                                 for k in ('z', 'pos', 'cell')))

    for case, (props, weights, _, _, ewald) in TRAIN.items():
        batch = train_batch(case)
        params = init(props, ewald, batch)
        store(f'{case}.', params)
        nl = JaxNewtonNet(**BASE, graph_mode='neighborlist', k_max=24,
                          output_properties=props, **ewald)
        tx = optax.adam(1e-3)
        step = make_halo_train_step(
            nl, tx, mesh, N_HALO,
            loss_config={k: {'weight': v} for k, v in weights.items()})
        sb = shard_halo_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              mesh)
        new, _, metrics = step(jax.tree.map(jnp.array, params),
                               tx.init(params), sb)
        out[f'{case}/loss'] = np.asarray(metrics['loss'])
        out[f'{case}/params'] = flat_jax(jax.device_get(new), props, ewald)
        print(case, float(metrics['loss']))
    params = tree(out_npz(out), 'stress.')
    nl = JaxNewtonNet(**BASE, graph_mode='neighborlist', k_max=24,
                      output_properties=EF)
    for periodic in (False, True):
        b = gas(2, N_ATOMS, BOX, 0, periodic)
        fn = make_halo_energy_force_fn(nl, mesh, N_HALO,
                                       compute_stress=periodic)
        sb = shard_halo_batch({k: jnp.asarray(v) for k, v in b.items()},
                              mesh)
        got = fn(params, sb['z'], sb['pos'], sb['cell'])
        key = 'per' if periodic else 'aper'
        out[f'{key}/energy'] = np.asarray(got[0])
        out[f'{key}/forces'] = np.asarray(got[1])
        if periodic:
            out[f'{key}/stress'] = np.asarray(got[2])
    s = md_system(0)
    js = System(s.numbers, s.positions.copy(), cell=s.cell, pbc=[True] * 3)
    maxwell_boltzmann(js, 300.0, rng=np.random.default_rng(0))
    np.testing.assert_array_equal(js.momenta, s.momenta)
    _, log = run_md_halo(nl, tree(out_npz(out), 'ef.'), js,
                         make_mesh(data=1, graph=4), n_halo=MD_HALO,
                         timestep=MD['dt'], n_steps=MD['n_steps'],
                         resort_every=MD['resort_every'], integrator='nve',
                         dtype=np.float64)
    out['md/epot'] = np.asarray(log['epot'])
    out['md/positions'] = js.positions
    out['md/velocities'] = js.get_velocities()
    np.savez(REF, **out)
    print('wrote', REF)


class out_npz:
    '''A dict of arrays read like an npz (tree() over `files`).'''

    def __init__(self, d):
        self.files = list(d)
        self._d = d

    def __getitem__(self, k):
        return self._d[k]


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    if sys.argv[1] == 'worker':
        worker(sys.argv[2])
    elif sys.argv[1] == 'jax':
        jax_recipe()
