'''Molecular dynamics of one large system with its atoms split over the
ranks of a mesh's 'graph' group (the JAX package's md/halo_md.py).

Each rank owns a contiguous slab of the x-sorted atom order
(parallel/halo.py): its forces come from the halo-exchange graph (the
model's XLA stack with boundary-only exchanges per layer), and the
integrator's update is local: positions, velocities and forces stay on
the rank's device inside a chunk.

Atoms move, so the slab decomposition ages: the trajectory advances in
chunks of `resort_every` steps, and between chunks every rank gathers the
whole state, re-sorts it on the host the same way and takes its slab
again. Validity is checked, never assumed:

  * at every re-sort, check_halo_capacity at cutoff + skin verifies that
    each slab's halo blocks cover every atom that could become a
    cross-boundary neighbour during the chunk; a violation raises (a
    missed edge would silently corrupt the forces);
  * within a chunk the largest displacement since the sort is tracked on
    the device; a chunk in which an atom moved more than skin/2 is
    counted in skin_violations and warned about.

The list is rebuilt at every force call from the current positions
(ops/nlist.neighbor_list_rect over the extended axis), so only the
partition ages, never the list. Forces are exact across slab boundaries:
each rank differentiates its local energy sum and the exchanges' backward
brings the other slabs' terms. A charge head (ewald_mode 'periodic') adds
each rank's share of the sharded Ewald energy, as halo serving does
(parallel/halo.py), so the forces are those of the one-process model; the
JAX function has no Ewald term.

Every rank runs the same host loop on the same host arrays (the same
sort, the same checks). The Langevin noise comes from a torch.Generator
on each rank's device, seeded from (seed, the rank's graph index), xi
then eta per step, each over the rank's slab (JAX's threefry draws with
the slab index folded in are not reproduced).
'''
import warnings

import numpy as np
import torch

from newtonnet_tpu_torch.data.units import kB
from newtonnet_tpu_torch.layers.precision import (
    check_matmul_precision,
    fp32_matmuls,
)
from newtonnet_tpu_torch.md.driver import _TORCH_DTYPES, _langevin_coeffs, \
    _md_model
from newtonnet_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_max,
    all_reduce_sum,
)
from newtonnet_tpu_torch.parallel.halo import (
    _check_charge_mode,
    _local_energy,
    check_halo_capacity,
    check_halo_model,
    spatial_sort,
)


def _seed(seed, shard):
    '''One 63-bit seed of (seed, shard).'''
    return int(np.random.SeedSequence([int(seed), int(shard)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def run_md_halo(model, params, system, mesh, n_halo, *, timestep, n_steps,
                resort_every=20, integrator='nve', temperature_K=None,
                friction=None, log_every=1, seed=0, skin=1.0,
                dtype=np.float32, matmul_precision='highest'):
    '''Integrate one System with its atoms sharded over the mesh's 'graph'
    ranks; every rank of the mesh calls it with the same arguments.

    Args:
        model: a NewtonNet with graph_mode='neighborlist' (its XLA stack
            runs, whatever its kernel; a charge head needs ewald_mode
            'periodic'); params: a flax-named tree loaded into a copy of
            it, or None for its own weights.
        mesh: parallel/mesh.Mesh with >= 2 ranks on its graph axis (data
            rows, if any, repeat the trajectory); slabs must stay wider
            than the cutoff (checked at every re-sort).
        n_halo: boundary block size (atoms) exchanged per layer.
        timestep: in internal ASE-compatible units (fs = 0.09823).
        resort_every: steps between host re-sorts; no atom should move
            more than skin/2 within a chunk (tracked and reported).
        integrator: 'nve' (velocity Verlet) or 'langevin' (needs
            temperature_K and friction).
        skin: widens the capacity check to cutoff + skin.
        dtype: float32 or float64, of the model copy and the state.

    Returns:
        (system, log): the System advanced in place, in its own atom order;
        log = {'epot', 'ekin', 'temperature' (strided by log_every),
        'n_resorts', 'skin_violations'}.
    '''
    if integrator not in ('nve', 'langevin'):
        raise ValueError(f'unknown integrator {integrator!r}')
    if integrator == 'langevin' and (temperature_K is None
                                     or friction is None):
        raise ValueError('langevin needs temperature_K and friction')
    if n_steps % resort_every:
        raise ValueError('n_steps must be divisible by resort_every')
    check_halo_model(model, mesh, n_halo)
    _check_charge_mode(model, 'halo MD')
    check_matmul_precision(matmul_precision, 'matmul_precision')
    np_dtype = np.dtype(dtype)
    if np_dtype not in _TORCH_DTYPES:
        raise ValueError(f'dtype must be float32 or float64, got {dtype}')
    md = _md_model(model, params, _TORCH_DTYPES[np_dtype])
    dev = md.device
    group = mesh.group('graph')
    n_shards, shard = mesh.shape['graph'], mesh.index('graph')

    n_real = len(system)
    pad = (-n_real) % n_shards
    n_loc = (n_real + pad) // n_shards
    # padded once so every re-sort sees the same shapes; the tag row rides
    # along through each sort to invert the permutation at the end
    # (padding tags are -1, never written back)
    z = np.concatenate([system.numbers, np.zeros(pad, np.int32)])[None]
    pos = np.concatenate([system.positions, np.zeros((pad, 3))])[None]
    vel = np.concatenate([system.get_velocities(), np.zeros((pad, 3))])[None]
    masses = np.concatenate([system.masses, np.ones(pad)])[None]
    tag = np.concatenate([np.arange(n_real, dtype=np.int64),
                          np.full(pad, -1)])[None]
    pos, vel, masses = (a.astype(np_dtype) for a in (pos, vel, masses))
    cell = np.asarray(system.cell, dtype=np_dtype)[None]
    periodic = bool(np.any(cell != 0))
    cell_t = torch.from_numpy(cell).to(dev)
    dt = float(timestep)
    gen = torch.Generator(device=dev).manual_seed(_seed(seed, shard))
    own = slice(shard * n_loc, (shard + 1) * n_loc)

    def energy_forces(z_t, pos_t):
        x = pos_t.detach().requires_grad_(True)
        with torch.enable_grad():
            # the LOCAL energy (with a charge head plus this rank's share of
            # the sharded Ewald sum): the exchanges' backward brings the
            # other slabs' terms
            e_local, _ = _local_energy(md, n_halo, group, z_t, x, cell_t,
                                       z_t > 0, (x, cell_t))
            (grad,) = torch.autograd.grad(e_local.sum(), x)
        return e_local.detach(), -grad

    def chunk(z_t, pos_t, vel_t, m_t):
        mask = (z_t > 0).to(pos_t.dtype)[..., None]
        m_c = m_t[..., None]
        if integrator == 'langevin':
            c1, c2, c3, c4, c5 = _langevin_coeffs(
                m_c, dt, float(kB * temperature_K), float(friction))
        pos_ref = pos_t
        _, f = energy_forces(z_t, pos_t)
        e_steps, k_steps, disp2 = [], [], []
        for _ in range(resort_every):
            if integrator == 'nve':
                vel_t = vel_t + (0.5 * dt) * f / m_c * mask
                pos_t = pos_t + dt * vel_t
                e_local, f = energy_forces(z_t, pos_t)
                vel_t = vel_t + (0.5 * dt) * f / m_c * mask
            else:  # md/driver.langevin_step with the noise drawn here
                xi, eta = (torch.randn(pos_t.shape, generator=gen,
                                       device=dev, dtype=pos_t.dtype)
                           for _ in range(2))
                vel_t = (vel_t + c1 * f / m_c - c2 * vel_t
                         + c3 * xi - c4 * eta) * mask
                pos_t = pos_t + dt * vel_t + c5 * eta * mask
                e_local, f = energy_forces(z_t, pos_t)
                vel_t = (vel_t + c1 * f / m_c - c2 * vel_t
                         + c3 * xi - c4 * eta) * mask
            e_steps.append(e_local)
            k_steps.append(0.5 * torch.sum(m_c * vel_t * vel_t * mask,
                                           dim=(-1, -2)))
            disp2.append(torch.max(torch.sum((pos_t - pos_ref) ** 2, -1)))
        # one collective each per chunk, not per step
        epot = all_reduce_sum(torch.stack(e_steps), group)
        ekin = all_reduce_sum(torch.stack(k_steps), group)
        maxdisp2 = all_reduce_max(torch.stack(disp2).max(), group)
        return pos_t, vel_t, epot, ekin, maxdisp2

    ep_list, ek_list = [], []
    skin_violations = 0
    with torch.no_grad(), fp32_matmuls():
        for c in range(n_steps // resort_every):
            z, pos, extra = spatial_sort(
                z, pos, cell if periodic else None,
                extra={'vel': vel, 'masses': masses, 'tag': tag},
                n_shards=n_shards)
            vel, masses, tag = extra['vel'], extra['masses'], extra['tag']
            masses = np.where(z > 0, masses, 1.0).astype(np_dtype)
            bad = check_halo_capacity(z, pos, cell if periodic else None,
                                      n_shards, n_halo, md.cutoff + skin)
            if bad:
                raise ValueError(
                    f'halo partition invalid at chunk {c}: {bad} atoms '
                    f'within cutoff+skin={md.cutoff + skin:g} of a slab '
                    f'boundary fall outside the n_halo={n_halo} blocks '
                    '(raise n_halo, use fewer graph shards, or shrink skin)')
            z_t, pos_t, vel_t, m_t = (
                torch.from_numpy(np.ascontiguousarray(a[:, own])).to(dev)
                for a in (z, pos, vel, masses))
            pos_t, vel_t, ep, ek, maxdisp2 = chunk(z_t, pos_t, vel_t, m_t)
            pos = all_gather_cat(pos_t, group, 1).cpu().numpy()
            vel = all_gather_cat(vel_t, group, 1).cpu().numpy()
            skin_violations += int(float(maxdisp2) > (skin / 2.0) ** 2)
            ep_list.append(ep.cpu().numpy())
            ek_list.append(ek.cpu().numpy())

    if skin_violations:
        warnings.warn(
            f'halo MD partition quality: in {skin_violations} chunks an '
            'atom moved > skin/2 before the re-sort -- cross-boundary '
            'neighbors may have left halo coverage there; shrink '
            'resort_every or enlarge skin/n_halo', stacklevel=2)

    # the accumulated permutation inverted back to the caller's atom order
    real = z[0] > 0
    order = tag[0, real].astype(np.int64)
    system.positions[order] = pos[0, real].astype(np.float64)
    system.momenta[order] = (vel[0, real].astype(np.float64)
                             * masses[0, real, None].astype(np.float64))
    epots = np.concatenate(ep_list)[:, 0][::log_every]
    ekins = np.concatenate(ek_list)[:, 0][::log_every]
    log = {'epot': epots, 'ekin': ekins,
           'temperature': 2.0 * ekins / (3 * n_real * kB),
           'n_resorts': n_steps // resort_every,
           'skin_violations': skin_violations}
    return system, log
