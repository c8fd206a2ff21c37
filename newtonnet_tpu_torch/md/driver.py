'''On-device MD (the JAX package's md/driver.py): Langevin and Nose-Hoover
chain trajectories of a replica batch whose state stays on model.device,
and the host-built neighbour lists of the inverse-list, newton3 and
staircase layouts.

The JAX driver runs a trajectory under one lax.scan; here it is a Python
loop of tensor operations on the model's device. Positions, velocities,
forces, the per-step epot / ekin logs and both list-quality counters are
device tensors until the trajectory ends: no step reads a value back to
the host, except what the model's own forward reads (a plain list's
transpose takes its largest degree, ops/nlist.node_transpose; the cell
grid's binning indexes by a mask) and the host-rebuild modes' one copy
of the positions per rebuild. The thermostat noise comes from a
torch.Generator on the device seeded by `seed`: xi then eta, each
(M, N, 3), per step (JAX's threefry draws are not reproduced). Forces are
the model's gradient_force, one forward and backward per step, with no
graph kept from step to step.

Neighbour-list models (graph_mode='neighborlist'):
* nlist_every <= 1: the model builds its list at every force call.
* nlist_every > 1 (plain, reverse-list, cell-grid and kernel='pallas'
  K-list models): the list is rebuilt on the device every nlist_every
  steps at the radius cutoff + skin (ops/nlist.neighbor_list or, for
  identical periodic cells of at least 3 cells per axis, the O(N)
  ops/cellgrid build), and the model drops the stale pairs at each step.
* nlist_every > 1 with inverse_lists, newton3 or newton3_compact: the
  lists are built and coloured on the host at each rebuild
  (host_symmetric_nlist, host_staircase_nlist). A staircase rebuild
  re-sorts the atoms by slot need: z, masses, positions, velocities and
  forces are permuted together, and the cumulative permutation is undone
  before the results are written back into the Systems.

Both counters are kept in every rebuild mode: nlist_overflow (atoms
over k_max or a full grid cell at the device rebuilds; the host builds
raise instead) and skin_violations (chunks in which an atom moved more
than skin/2 from its rebuild position); either warns.
'''
import copy
import math
import warnings

import numpy as np
import torch

from newtonnet_tpu_torch.data.prelists import cell_list_neighbors
from newtonnet_tpu_torch.data.units import kB
from newtonnet_tpu_torch.layers.precision import (
    check_matmul_precision,
    fp32_matmuls,
)
from newtonnet_tpu_torch.ops.cellgrid import (
    cell_grid_neighbor_list,
    suggest_capacity,
    suggest_grid,
)
from newtonnet_tpu_torch.ops.nlist import (
    build_inverse_list,
    build_reverse_list,
    neighbor_list,
    newton3_half_list,
    symmetrize_slots,
)
from newtonnet_tpu_torch.ops.staircase import staircase_chunks, \
    staircase_colors
from newtonnet_tpu_torch.utils.params import params_from_flax

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}
_SY_WEIGHTS = (1.3512071919596578, -1.7024143839193155, 1.3512071919596578)


def _host_full_lists(model, z, pos, cell, radius, k):
    '''Full lists (idx (B, N, k) int32, kmask) of each structure's real
    atoms (z > 0, padding at the end of the row) by the C++ cell list, as
    the JAX package builds them; ValueError on overflow.'''
    B, N = z.shape
    idx = np.zeros((B, N, k), np.int32)
    kmask = np.zeros((B, N, k), bool)
    for b in range(B):
        n_real = int((z[b] > 0).sum())
        idx_r, count, over = cell_list_neighbors(
            pos[b, :n_real], cell[b] if cell[b].any() else None, radius, k)
        if over:
            raise ValueError(f'neighbour overflow ({over} atoms over '
                             f'k_max={k})')
        idx[b, :n_real] = idx_r
        kmask[b, :n_real] = np.arange(k)[None, :] < count[:, None]
    return idx, kmask


def _host(*arrays):
    return tuple(np.asarray(torch.as_tensor(a).detach().cpu())
                 for a in arrays)


def host_symmetric_nlist(model, z, pos, cell, skin=1.0):
    '''The 4-tuple (idx (B, N, K), mask (B, N, K), inv (B, K, N), inv_mask
    (B, K, N)) that NewtonNet.forward takes as nlist for an inverse_lists
    or a newton3 model, K = model.k_max, on model.device.

    The full list of each structure's real atoms (z > 0, at the end of the
    row: padding) is built on the host by the C++ cell list
    (data/prelists.cell_list_neighbors, radius cutoff + skin; raises
    ValueError on overflow), as the JAX package builds it, so that the
    lists are the JAX package's, bit for bit; then:
    * inverse_lists: re-slotted by symmetrize_slots (csrc/host/
      symslots.cpp) at capacity k_max. With shared slots each slot's list
      is its own inverse, so inv and inv_mask are the K-major transposes of
      idx and mask.
    * newton3: k_max is the HALF list's capacity, so the full list is
      built at 2 * k_max + 8 and oriented and coloured by
      newton3_half_list (csrc/host/newton3.cpp; ValueError if the half
      list needs more than k_max slots). A half list is no involution:
      inv and inv_mask come from build_inverse_list on the device.

    Args:
        model: a NewtonNet (kernel='xla', inverse_lists or newton3).
        z (B, N), pos (B, N, 3), cell (B, 3, 3): tensors or numpy arrays.
        skin: added to the cutoff for the build (0 for one request).
    '''
    dev = model.device
    z, pos, cell = _host(z, pos, cell)
    k = model.k_max
    idx, kmask = _host_full_lists(model, z, pos, cell, model.cutoff + skin,
                                  2 * k + 8 if model.newton3 else k)
    if model.newton3:
        try:
            idx2, kmask2 = newton3_half_list(idx, kmask, k_max=k)
        except ValueError:
            raise ValueError(
                f'newton3 half list needs more than k_max={k} slots at '
                f'build radius cutoff+skin={model.cutoff + skin:g} A; '
                'raise model k_max or lower the skin') from None
    else:
        idx2, kmask2 = symmetrize_slots(idx, kmask, k_max=k)
    idx2 = torch.from_numpy(idx2.astype(np.int64)).to(dev)
    kmask2 = torch.from_numpy(np.ascontiguousarray(kmask2)).to(dev)
    idx_kn, kmask_kn = (idx2.transpose(1, 2).contiguous(),
                        kmask2.transpose(1, 2).contiguous())
    if model.newton3:
        return (idx2, kmask2) + build_inverse_list(idx_kn, kmask_kn)
    return idx2, kmask2, idx_kn, kmask_kn


def host_staircase_nlist(model, z, pos, cell, skin, plan_box):
    '''Staircase half lists for the newton3_compact MD path.

    Per rebuild: the full symmetric list at cutoff + skin per replica (C++
    cell list, at 2 * k_max + 8), the C++ colour and compact phase
    (ops/staircase.staircase_colors), and chunks under one shape plan
    shared by the replicas. The plan is fixed by the first rebuild in
    `plan_box` (a mutable dict): chunks of 4 colours covering the largest
    replica's palette, one spare chunk, and each chunk's width rounded up
    to a grid of max(32, N // 16) rows plus one step, so that later
    rebuilds (and later calls given the same dict) keep its shapes; a
    rebuild that outgrows it raises ValueError.

    Returns (nlist, perm): nlist the tuple of per-chunk (idx, mask, inv,
    inv_mask), each (M, c, n) K-major on model.device, with the inverse
    lists built on the device (build_inverse_list); perm (M, N) int64
    numpy, sorted position -> current atom, by which the caller permutes
    the frame.
    '''
    z, pos, cell = _host(z, pos, cell)
    M, N = z.shape
    idx, kmask = _host_full_lists(model, z, pos, cell, model.cutoff + skin,
                                  2 * model.k_max + 8)
    had_plan = plan_box.get('plan') is not None
    try:
        coloreds = [staircase_colors(idx[m], kmask[m],
                                     plan=plan_box.get('plan'))
                    for m in range(M)]
        if not had_plan:
            firsts = [staircase_chunks(c, pad=8) for c in coloreds]
            cw = 4  # staircase_chunks' colours per chunk
            max_cap = max((int(c[3].max()) + 1 if len(c[3]) else 1)
                          for c in coloreds)
            n_chunks = -(-max_cap // cw)
            q = max(32, N // 16)

            def width(n):
                return min((n // q + 2) * q, N)
            plan = [(cw, width(max(
                (f.widths[ci][1] if ci < len(f.widths) else 0)
                for f in firsts))) for ci in range(n_chunks)]
            plan.append((cw, plan[-1][1]))  # spare colours
            plan_box['plan'] = tuple(plan)
        sls = [staircase_chunks(c, pad=8, plan=plan_box['plan'])
               for c in coloreds]
    except ValueError as e:
        if not had_plan:
            raise
        raise ValueError(
            f'{e} -- a skin rebuild outgrew the staircase shape plan '
            'fixed at the first rebuild (atoms drifted into a denser '
            'configuration); enlarge model k_max headroom or restart '
            'the trajectory to re-plan') from None
    dev = model.device
    nlist = []
    for ci in range(len(plan_box['plan'])):
        cidx = np.stack([sl.chunks[ci].idx[0] for sl in sls])
        cmask = np.stack([sl.chunks[ci].mask[0] for sl in sls])
        cidx = torch.from_numpy(np.where(cmask, cidx, 0).astype(np.int64))
        cmask = torch.from_numpy(cmask)
        cidx, cmask = cidx.to(dev), cmask.to(dev)
        nlist.append((cidx, cmask) + build_inverse_list(cidx, cmask))
    perm = np.stack([sl.perm for sl in sls]).astype(np.int64)
    return tuple(nlist), perm


def _pad_systems(systems, dtype, multiple=8):
    '''Pad a list of Systems into one (M, n_pad, ...) replica batch (numpy;
    padding: z 0, mass 1).'''
    n_max = max(len(s) for s in systems)
    n_pad = max(multiple, ((n_max + multiple - 1) // multiple) * multiple)
    M = len(systems)
    z = np.zeros((M, n_pad), dtype=np.int64)
    pos = np.zeros((M, n_pad, 3), dtype=dtype)
    mom = np.zeros((M, n_pad, 3), dtype=dtype)
    masses = np.ones((M, n_pad), dtype=dtype)
    cell = np.zeros((M, 3, 3), dtype=dtype)
    for i, s in enumerate(systems):
        n = len(s)
        z[i, :n] = s.numbers
        pos[i, :n] = s.positions
        mom[i, :n] = s.momenta
        masses[i, :n] = s.masses
        cell[i] = s.cell
    return z, pos, mom, masses, cell


def _md_model(model, params, dtype):
    '''The model a trajectory runs: a copy of `model` cast to `dtype` on its
    device, holding `params` (a flax-named tree {'params': {...}}, the JAX
    driver's argument) or, with params None, the model's own weights.'''
    md = copy.deepcopy(model).to(dtype)
    if params is not None:
        params_from_flax(params, core=md.core)
    return md.requires_grad_(False).eval()


def _energy_forces(model, z, pos, cell, nlist=None):
    out = model(z, pos, cell, nlist=nlist)
    return out['energy'], out['gradient_force']


def _make_nlist_builder(model, z, cell, skin, nlist_grid, nlist_capacity):
    '''Skin-radius list builder: the list stays valid until an atom moves
    about skin/2; the model drops stale pairs beyond the cutoff at every
    step. build(pos) -> (nlist, overflow (0-d device tensor)).'''

    def build(pos):
        if nlist_grid:
            idx, kmask, _, ovf = cell_grid_neighbor_list(
                pos, cell, z > 0, model.cutoff + skin, model.k_max,
                nlist_grid, nlist_capacity, mic_mode=model.mic_mode)
        else:
            idx, kmask, _, ovf = neighbor_list(
                pos, cell, z > 0, model.cutoff + skin, model.k_max,
                mic_mode=model.mic_mode)
        if model.reverse_lists:
            # the transpose list's build amortized with the rebuild
            return (idx, kmask) + tuple(build_reverse_list(idx, kmask)), \
                ovf.sum()
        return (idx, kmask), ovf.sum()

    return build


def _grid_for(model, cell, n_pad, nlist_every, skin):
    '''(grid, capacity) of the O(N) cell-grid rebuild when the identical,
    periodic replica cells hold at least 3 cells of cutoff + skin per axis,
    else ((), 0).'''
    if (nlist_every > 1 and model.graph_mode == 'neighborlist'
            and np.abs(np.linalg.det(cell[0])) > 0
            and all(np.allclose(c, cell[0]) for c in cell)):
        g = suggest_grid(cell[0], model.cutoff + skin)
        if min(g) >= 3:  # below that the O(N^2) build is as good
            return g, suggest_capacity(n_pad, g)
    return (), 0


def _langevin_coeffs(masses_c, dt, temp, friction):
    sigma = torch.sqrt(2 * temp * friction / masses_c)
    c1 = dt / 2.0 - dt * dt * friction / 8.0
    c2 = dt * friction / 2.0 - dt * dt * friction * friction / 8.0
    c3 = math.sqrt(dt) * sigma / 2.0 - dt ** 1.5 * friction * sigma / 8.0
    c5 = dt ** 1.5 * sigma / (2.0 * math.sqrt(3.0))
    c4 = friction / 2.0 * c5
    return c1, c2, c3, c4, c5


def langevin_step(model, z, masses, cell, state, xi, eta, *, dt, temp,
                  friction, nlist=None):
    '''One Langevin step of the replica batch, the body of the JAX
    driver's scans, with the noise given: z (M, N), masses (M, N), cell
    (M, 3, 3), state (pos, vel, f), xi and eta (M, N, 3). Velocities and
    displacements of padding atoms (z == 0) are held at 0.
    -> ((pos, vel, f), epot (M,), ekin (M,)).'''
    pos, vel, f = state
    masses_c = masses[..., None]
    atom_mask = (z > 0).to(pos.dtype)[..., None]
    c1, c2, c3, c4, c5 = _langevin_coeffs(masses_c, dt, temp, friction)
    vel = (vel + c1 * f / masses_c - c2 * vel
           + c3 * xi - c4 * eta) * atom_mask
    pos = pos + dt * vel + c5 * eta * atom_mask
    epot, f = _energy_forces(model, z, pos, cell, nlist)
    vel = (vel + c1 * f / masses_c - c2 * vel
           + c3 * xi - c4 * eta) * atom_mask
    ekin = 0.5 * torch.sum(masses_c * vel * vel, dim=(-1, -2))
    return (pos, vel, f), epot, ekin


def _nhc_update(vel, masses_c, xi, vxi, Q, kT, dof, dt, n_sub=1):
    '''Replica-batched MTK chain propagation for dt/2: vel (M, N, 3),
    xi / vxi / Q (M, C), dof (M,). -> (momentum scale (M,), xi, vxi).'''
    C = Q.shape[1]
    akin = torch.sum(masses_c * vel * vel, dim=(-1, -2))
    scale = torch.ones_like(akin)
    v, q = list(vxi.unbind(1)), list(Q.unbind(1))

    def g(j, akin):
        if j == 0:
            return (akin - dof * kT) / q[0]
        return (q[j - 1] * v[j - 1] ** 2 - kT) / q[j]

    for _ in range(n_sub):
        for w in _SY_WEIGHTS:
            wdt = w * dt / n_sub
            v[C - 1] = v[C - 1] + 0.25 * wdt * g(C - 1, akin)
            for j in range(C - 2, -1, -1):
                aa = torch.exp(-0.125 * wdt * v[j + 1])
                v[j] = (v[j] * aa + 0.25 * wdt * g(j, akin)) * aa
            s = torch.exp(-0.5 * wdt * v[0])
            scale = scale * s
            akin = akin * s * s
            xi = xi + 0.5 * wdt * torch.stack(v, 1)
            for j in range(C - 1):
                aa = torch.exp(-0.125 * wdt * v[j + 1])
                v[j] = (v[j] * aa + 0.25 * wdt * g(j, akin)) * aa
            v[C - 1] = v[C - 1] + 0.25 * wdt * g(C - 1, akin)
    return scale, xi, torch.stack(v, 1)


def nhc_step(model, z, masses, cell, state, chain, *, dt, temp, Q, dof,
             nlist=None):
    '''One Nose-Hoover chain step (the JAX _run_nhc body): chain (xi, vxi)
    (M, C). -> ((pos, vel, f), chain, (epot, ekin, conserved))'''
    pos, vel, f = state
    xi, vxi = chain
    masses_c = masses[..., None]
    atom_mask = (z > 0).to(pos.dtype)[..., None]
    scale, xi, vxi = _nhc_update(vel, masses_c, xi, vxi, Q, temp, dof, dt)
    vel = vel * scale[:, None, None]
    vel = (vel + 0.5 * dt * f / masses_c) * atom_mask
    pos = pos + dt * vel * atom_mask
    epot, f = _energy_forces(model, z, pos, cell, nlist)
    vel = (vel + 0.5 * dt * f / masses_c) * atom_mask
    scale, xi, vxi = _nhc_update(vel, masses_c, xi, vxi, Q, temp, dof, dt)
    vel = vel * scale[:, None, None]
    ekin = 0.5 * torch.sum(masses_c * vel * vel, dim=(-1, -2))
    chain_energy = (0.5 * torch.sum(Q * vxi ** 2, dim=1)
                    + dof * temp * xi[:, 0]
                    + temp * torch.sum(xi[:, 1:], dim=1))
    return (pos, vel, f), (xi, vxi), (epot, ekin,
                                      epot + ekin + chain_energy)


class _Atoms:
    '''The replica batch on the device in its current atom order, with the
    lists of its rebuild mode. mode: None (the model builds its own
    list per call), 'device' (rebuilt on the device every chunk) or
    'host' (host_symmetric_nlist, or host_staircase_nlist for a
    newton3_compact model, whose rebuilds re-sort the atoms).'''

    def __init__(self, model, z, masses, cell, mode, skin, grid=(),
                 capacity=0, plan_box=None):
        dev = model.device
        self.model, self.mode, self.skin = model, mode, skin
        self.z_host, self.cell_host = z, cell
        self.z = torch.from_numpy(z).to(dev)
        self.masses = torch.from_numpy(masses).to(dev)
        self.cell = torch.from_numpy(cell).to(dev)
        self.perm = np.tile(np.arange(z.shape[1]), (z.shape[0], 1))
        self.plan_box = {} if plan_box is None else plan_box
        self.counters = torch.zeros(2, dtype=torch.int64, device=dev)
        if mode == 'device':
            self._build = _make_nlist_builder(model, self.z, self.cell, skin,
                                              grid, capacity)

    def rebuild(self, tensors):
        '''The list at tensors[0] (the positions); -> (nlist, tensors),
        tensors permuted with the atoms where a staircase rebuild re-sorts
        them.'''
        if self.mode == 'device':
            nlist, ovf = self._build(tensors[0])
            self.counters[0] += ovf
            return nlist, tensors
        if not self.model.newton3_compact:
            return host_symmetric_nlist(self.model, self.z_host, tensors[0],
                                        self.cell_host, skin=self.skin), \
                tensors
        nlist, perm = host_staircase_nlist(self.model, self.z_host,
                                           tensors[0], self.cell_host,
                                           self.skin, self.plan_box)
        self.z_host = np.take_along_axis(self.z_host, perm, axis=1)
        self.perm = np.take_along_axis(self.perm, perm, axis=1)
        perm = torch.from_numpy(perm).to(self.z.device)
        self.z = torch.take_along_dim(self.z, perm, dim=1)
        self.masses = torch.take_along_dim(self.masses, perm, dim=1)
        return nlist, tuple(torch.take_along_dim(t, perm[..., None], dim=1)
                            for t in tensors)

    def unsort(self, a):
        '''(M, N, ...) numpy in the current order -> the input's order.'''
        out = np.empty_like(a)
        for m in range(len(a)):
            out[m, self.perm[m]] = a[m]
        return out


def _trajectory(atoms, pos, vel, *, n_steps, log_every, nlist_every, step,
                carry=()):
    '''The loop both drivers share: chunks of nlist_every steps over one
    list each (the whole run as one chunk without rebuilds), step(state,
    carry, nlist) -> (state, carry, logged (M,) tensors), logged at steps
    0, log_every, ... Returns ((pos, vel), carry, [stacked logs]).'''
    model = atoms.model
    chunk = nlist_every if atoms.mode else max(n_steps, 1)
    if atoms.mode and n_steps % nlist_every:
        raise ValueError(f'n_steps={n_steps} must be divisible by '
                         f'nlist_every={nlist_every}')
    nlist = None
    if atoms.mode == 'host':
        nlist, (pos, vel) = atoms.rebuild((pos, vel))
    _, f = _energy_forces(model, atoms.z, pos, atoms.cell, nlist)
    state, logs = (pos, vel, f), []
    half_skin2 = (atoms.skin / 2.0) ** 2
    for c0 in range(0, n_steps, chunk):
        if atoms.mode and (c0 > 0 or atoms.mode == 'device'):
            nlist, state = atoms.rebuild(state)
        ref, dmax = state[0], None
        for i in range(c0, c0 + chunk):
            state, carry, logged = step(state, carry, nlist)
            if atoms.mode:
                d = torch.amax(torch.sum((state[0] - ref) ** 2, dim=-1))
                dmax = d if dmax is None else torch.maximum(dmax, d)
            if i % log_every == 0:
                logs.append(logged)
        if atoms.mode:
            atoms.counters[1] += (dmax > half_skin2).to(torch.int64)
    return state[:2], carry, [torch.stack(c) for c in zip(*logs)]


def _finish(systems, single, atoms, pos, vel, logs, names):
    '''Write the final state back into the Systems and build the log: the
    names' arrays (n_logged, M), temperature, and both counters; squeezed
    to (n_logged,) for a single System.'''
    pos_f = atoms.unsort(pos.cpu().numpy())
    mom_f = atoms.unsort((vel * atoms.masses[..., None]).cpu().numpy())
    n_overflow, n_skin = (int(v) for v in atoms.counters.cpu())
    if n_overflow or n_skin:
        warnings.warn(
            f'amortized MD list quality: {n_overflow} neighbor-capacity '
            f'overflows, {n_skin} chunks where an atom moved '
            f'> skin/2 before the rebuild -- forces in those chunks '
            f'missed neighbors; raise k_max/cell capacity, shrink '
            f'nlist_every, or enlarge skin', stacklevel=3)
    for i, s in enumerate(systems):
        n = len(s)
        s.positions = pos_f[i, :n].astype(np.float64)
        s.momenta = mom_f[i, :n].astype(np.float64)
    log = {name: v.cpu().numpy() for name, v in zip(names, logs)}
    dof = np.array([3 * len(s) for s in systems])
    log['temperature'] = 2.0 * log['ekin'] / (dof[None, :] * kB)
    log.update(nlist_overflow=n_overflow, skin_violations=n_skin)
    if single:
        log = {k: v[:, 0] if np.ndim(v) == 2 else v for k, v in log.items()}
        return systems[0], log
    return systems, log


def _prepare(model, params, system, dtype, matmul_precision):
    check_matmul_precision(matmul_precision, 'matmul_precision')
    np_dtype = np.dtype(dtype)
    if np_dtype not in _TORCH_DTYPES:
        raise ValueError(f'dtype must be float32 or float64, got {dtype}')
    single = not isinstance(system, (list, tuple))
    systems = [system] if single else list(system)
    md = _md_model(model, params, _TORCH_DTYPES[np_dtype])
    return md, systems, single, _pad_systems(systems, np_dtype)


def run_langevin_on_device(model, params, system, *, timestep, temperature_K,
                           friction, n_steps, log_every=100, seed=0,
                           dtype=np.float32, matmul_precision='highest',
                           nlist_every=0, skin=1.0, stair_plan=None):
    '''Run Langevin MD on model.device (CUDA unless the model was built
    with device='cpu').

    `system` is one System or a list of Systems: a list runs as a batched
    replica ensemble (independent trajectories and noise, padded to a
    multiple of 8 atoms). `params` is a flax-named tree loaded into a
    copy of the model (the JAX driver's argument), or None for the model's
    own weights; `dtype` casts that copy and the state. matmul_precision
    'highest' is the only one (IEEE fp32 products with TF32 off,
    layers/precision.fp32_matmuls): lower-precision force passes heat the
    thermostat (the JAX driver records over 100 K with bf16 passes).
    `stair_plan`: a dict shared by calls that should keep one staircase
    shape plan (newton3_compact models).

    Returns (system(s), log): the System(s) updated in place to the final
    state, and a dict with the strided 'epot', 'ekin', 'temperature'
    arrays, (n_logged,) for one System and (n_logged, M) for a list, and
    the counters 'nlist_overflow' and 'skin_violations'.
    '''
    md, systems, single, (z, pos, mom, masses, cell) = _prepare(
        model, params, system, dtype, matmul_precision)
    nl = nlist_every > 1 and md.graph_mode == 'neighborlist'
    compact = md.newton3_compact
    if compact and not nl:
        raise ValueError(
            'newton3_compact MD requires the host-rebuild mode: '
            "graph_mode='neighborlist' and nlist_every > 1 (staircase "
            'lists are recoloured on the host per skin rebuild; there is '
            'no on-device build for them)')
    host = nl and (md.inverse_lists or md.newton3 or compact)
    grid, capacity = (((), 0) if host else
                      _grid_for(md, cell, z.shape[1], nlist_every, skin))
    atoms = _Atoms(md, z, masses, cell,
                   'host' if host else 'device' if nl else None, skin, grid,
                   capacity, stair_plan)
    dev = md.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    kw = dict(dt=float(timestep), temp=float(kB * temperature_K),
              friction=float(friction))

    def step(state, carry, nlist):
        noise = [torch.randn(state[0].shape, generator=gen, device=dev,
                             dtype=state[0].dtype) for _ in range(2)]
        state, epot, ekin = langevin_step(md, atoms.z, atoms.masses,
                                          atoms.cell, state, *noise,
                                          nlist=nlist, **kw)
        return state, carry, (epot, ekin)

    with torch.no_grad(), fp32_matmuls():
        pos_t = torch.from_numpy(pos).to(dev)
        vel_t = torch.from_numpy(mom / masses[..., None]).to(dev)
        (pos_t, vel_t), _, logs = _trajectory(
            atoms, pos_t, vel_t, n_steps=int(n_steps),
            log_every=int(log_every), nlist_every=int(nlist_every),
            step=step)
    return _finish(systems, single, atoms, pos_t, vel_t, logs,
                   ('epot', 'ekin'))


def run_nhc_on_device(model, params, system, *, timestep, temperature_K,
                      tdamp, chain_length=3, n_steps, log_every=100,
                      dtype=np.float32, matmul_precision='highest',
                      nlist_every=0, skin=1.0):
    '''Deterministic NVT (Nose-Hoover chain) on model.device.

    The surface of run_langevin_on_device (one System or a replica list,
    params, dtype, device list rebuilds every nlist_every steps with both
    counters). The log also carries 'conserved', the extended Hamiltonian
    E + sum Q v_xi^2/2 + Nf kT xi_1 + kT sum_{j>1} xi_j, whose drift is
    the integration-quality diagnostic (md/integrators.NoseHooverChain is
    the host-loop counterpart, with the same algebra). newton3_compact
    models are refused (no host-rebuild mode here).
    '''
    if model.newton3_compact:
        raise ValueError(
            'newton3_compact models are not supported by the NHC driver '
            '(it has no host-rebuild mode); run Langevin with '
            'nlist_every > 1, or rebuild the model with newton3=True -- '
            'the checkpoint is layout-portable')
    md, systems, single, (z, pos, mom, masses, cell) = _prepare(
        model, params, system, dtype, matmul_precision)
    nl = nlist_every > 1 and md.graph_mode == 'neighborlist'
    grid, capacity = _grid_for(md, cell, z.shape[1], nlist_every, skin)
    atoms = _Atoms(md, z, masses, cell, 'device' if nl else None, skin, grid,
                   capacity)
    dev, tdt = md.device, _TORCH_DTYPES[np.dtype(dtype)]
    M = z.shape[0]
    temp = float(kB * temperature_K)
    dof = 3.0 * (atoms.z > 0).sum(dim=1).to(tdt)
    Q = torch.full((M, int(chain_length)), temp * float(tdamp) ** 2,
                   dtype=tdt, device=dev)
    Q[:, 0] *= dof

    def step(state, chain, nlist):
        return nhc_step(md, atoms.z, atoms.masses, atoms.cell, state, chain,
                        dt=float(timestep), temp=temp, Q=Q, dof=dof,
                        nlist=nlist)

    with torch.no_grad(), fp32_matmuls():
        pos_t = torch.from_numpy(pos).to(dev)
        vel_t = torch.from_numpy(mom / masses[..., None]).to(dev)
        xi0 = torch.zeros((M, int(chain_length)), dtype=tdt, device=dev)
        (pos_t, vel_t), _, logs = _trajectory(
            atoms, pos_t, vel_t, n_steps=int(n_steps),
            log_every=int(log_every), nlist_every=int(nlist_every),
            step=step, carry=(xi0, xi0))
    return _finish(systems, single, atoms, pos_t, vel_t, logs,
                   ('epot', 'ekin', 'conserved'))
