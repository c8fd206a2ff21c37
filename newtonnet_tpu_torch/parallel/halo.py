'''Halo-exchange graph parallelism (the JAX package's parallel/halo.py):
boundary-only communication for one large periodic (or aperiodic)
system.

Atoms are sorted along x (fractional x for periodic cells;
data/pipeline.spatial_sort) and split into contiguous slabs, one per rank
of the mesh's 'graph' group. Each rank owns N_loc atoms; because the
order is spatial, every neighbour of an own atom within the cutoff lies
in the slab itself or among the first / last n_halo atoms of the two
adjacent slabs. Per message-passing layer each rank therefore swaps only
those boundary blocks with its ring neighbours
(parallel/collectives.exchange_halo): communication and memory follow
the boundary, not the global atom count.

Per rank (B graphs of its data row):

    own:  pos (B, N_loc, 3)     the sorted slab
    ext:  [left halo | own | right halo]  (B, N_loc + 2H, ...)
    idx:  (B, N_loc, K) indices into the extended axis
          (ops/nlist.neighbor_list_rect, self-edges excluded at offset H)

models/xla_stack.halo_edges builds the graph; every layer's gather is
gather_nodes on the exchanged rows, whose backward sums each node's slots
through K9 row gathers on the card. A kernel='pallas' checkpoint sharded
this way runs the XLA stack, as the JAX functions run model.core: it
launches none of the fused pair kernels.

Derivatives: each rank differentiates its LOCAL energy sum only; the
exchange's backward (the reverse exchange) delivers the other ranks'
dE_j/dpos_mine terms, so forces are exact, and every rank must run the
same exchanges in the same order (the process group's timeout turns a
mismatch into an error). A replicated quantity seeded on every rank would
be counted G times. Validity needs slabs wider than the cutoff and n_halo
large enough for every atom within the cutoff of a slab boundary:
check_halo_capacity verifies both from the sorted positions.

The ring wraps, so periodic cells parallelize naturally (the left halo of
rank 0 is the last slab's boundary, and the minimum image maps the
displacement across the wrap). At least 2 ranks on the graph axis: with
one the wrapped halo would duplicate the slab's own atoms.
'''
import contextlib

import numpy as np
import torch

from newtonnet_tpu_torch.data.pipeline import spatial_sort
from newtonnet_tpu_torch.layers.precision import fp32_matmuls
from newtonnet_tpu_torch.models.output import constant_parameters
from newtonnet_tpu_torch.models.xla_stack import apply_core_xla
from newtonnet_tpu_torch.ops.ewald import ewald_energy_periodic_sharded
from newtonnet_tpu_torch.ops.linalg3 import det3x3
from newtonnet_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_sum,
    psum,
    sum_gradients,
)

__all__ = ['spatial_sort', 'check_halo_capacity',
           'make_halo_energy_force_fn', 'HALO_LOSS_KEYS',
           'make_halo_grads_fn', 'make_halo_train_step', 'halo_batch_specs',
           'shard_halo_batch']


def check_halo_capacity(z, pos, cell, n_shards, n_halo, cutoff):
    '''Validate the slab decomposition of sorted positions (numpy).

    For every slab boundary, every real atom within `cutoff` (along the
    sort coordinate) of the boundary must fall inside the adjacent n_halo
    block. Returns the number of violating atoms (0 = safe), counting also
    slabs narrower than the cutoff when there are more than 2 (they would
    need the next-nearest slab, which the ring exchange does not reach).
    '''
    z = np.asarray(z)
    pos = np.asarray(pos)
    B, N = z.shape
    assert N % n_shards == 0
    n_loc = N // n_shards
    violations = 0
    for b in range(B):
        x = pos[b, :, 0].astype(float)
        periodic = cell is not None and np.any(np.asarray(cell[b]) != 0)
        if periodic:
            c = np.asarray(cell[b], dtype=float)
            frac = np.linalg.solve(c.T, pos[b].T.astype(float)).T
            x = frac[:, 0] % 1.0
            # the spacing of the frac-x planes is V / |a2 x a3| (|a1| only
            # for orthogonal cells): the cutoff's fractional width
            d_perp = abs(np.linalg.det(c)) / np.linalg.norm(
                np.cross(c[1], c[2]))
            width = cutoff / d_perp
        else:
            width = cutoff
        real = z[b] > 0
        for s in range(n_shards):
            lo, hi = s * n_loc, (s + 1) * n_loc
            own = np.arange(lo, hi)
            own_real = own[real[lo:hi]]
            if own_real.size == 0:
                continue
            x_lo, x_hi = x[own_real].min(), x[own_real].max()
            if x_hi - x_lo < width and n_shards > 2:
                violations += 1  # slab narrower than the cutoff
            near_left = own_real[x[own_real] < x_lo + width]
            violations += int(np.sum(near_left >= lo + n_halo))
            near_right = own_real[x[own_real] > x_hi - width]
            violations += int(np.sum(near_right < hi - n_halo))
    return violations


def check_halo_model(model, mesh, n_halo):
    '''The JAX package's _halo_core guards: a neighbour-list model, n_halo
    of at least 1, and a graph axis of at least 2 ranks.'''
    if model.graph_mode != 'neighborlist':
        raise ValueError("halo exchange requires graph_mode='neighborlist' "
                         "(use parallel/graph_parallel.py for the dense "
                         "all-gather path)")
    if n_halo < 1:
        raise ValueError('n_halo must be >= 1 (with halo=0 the core builds '
                         'a purely local graph, silently dropping every '
                         'cross-shard edge)')
    if mesh is not None and mesh.shape['graph'] < 2:
        raise ValueError(
            'halo exchange needs >= 2 shards on the graph axis (with one '
            'shard the wrapped halo duplicates local atoms as distance-0 '
            'ghosts); use the plain neighborlist path instead')


def _strained(pos, cell, disp):
    '''pos and cell under the symmetrized displacement (models/output.py's
    virial trick), or as they are with disp None.'''
    if disp is None:
        return pos, cell
    sym = 0.5 * (disp + disp.transpose(-1, -2))
    return (torch.einsum('bni,bij->bnj', pos, sym),
            torch.einsum('bxi,bij->bxj', cell, sym))


def _identity_disp(pos, b, requires_grad):
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    return eye.expand(b, 3, 3).clone().requires_grad_(requires_grad)


def _local_energy(model, n_halo, group, z, pos, cell, atom_mask, ewald_at):
    '''This rank's energies (B,) of its own atoms (atom_mask) and the
    core's outputs: the atomic energies, plus with a charge head its share
    of the sharded Ewald energy, evaluated at the (pos, cell) pair
    `ewald_at`.'''
    out = apply_core_xla(model, z, pos, cell, graph_group=group, halo=n_halo)
    e_local = torch.sum(out['atomic_energy'][..., 0]
                        * atom_mask.to(pos.dtype), dim=-1)
    if 'charge' in model.core.heads:
        e_local = e_local + ewald_energy_periodic_sharded(
            out['charge'], *ewald_at, atom_mask, lambda s: psum(s, group),
            sigma=model.ewald_sigma, n_k=model.ewald_n_k)
    return e_local, out


def _check_charge_mode(model, what='halo training'):
    '''The sharded Ewald sum is the periodic one: a charge head needs
    ewald_mode 'periodic' (the JAX halo training's refusal).'''
    if 'charge' in model.core.heads and model.ewald_mode != 'periodic':
        raise ValueError(
            f"{what} with a charge head requires ewald_mode="
            "'periodic' (set it in the model config; the CLI auto-selects "
            "it for all-periodic datasets)")


def make_halo_energy_force_fn(model, mesh, n_halo, compute_stress=False):
    '''A function (z, pos, cell) -> (energy (B,), forces (B, N, 3)[,
    stress (B, 3, 3)]) with the batch split over the mesh's 'data' ranks
    and the atoms (sorted with spatial_sort; N a multiple of the graph
    size) over its 'graph' ranks with halo exchange.

    Every rank passes the whole (B, N) request and gets the whole result
    back: it computes its slab, then the blocks are all-gathered over the
    graph and data groups (only the exchanges run inside the model).

    compute_stress (a periodic cell) applies the strain displacement of
    the virial trick to each rank's LOCAL positions and cell before the
    in-core exchange, so the displacement cotangent rides the reverse
    exchanges like the force cotangent; the ranks' displacement gradients
    are summed over the graph group. A charge head (ewald_mode 'periodic')
    adds each rank's share of the sharded Ewald energy at the raw
    positions and cell, where the one-process model evaluates it: it
    enters the forces and not the stress (models/output.py); the JAX
    function has no Ewald term.

    It runs the model's core as the kernel='xla' stack
    (models/xla_stack.py), whatever kernel the checkpoint names, as the
    JAX function runs model.core: a kernel='pallas' checkpoint sharded
    this way launches none of the fused pair kernels, and its gathers'
    backwards launch K9.'''
    check_halo_model(model, mesh, n_halo)
    _check_charge_mode(model, 'halo serving')
    group, data_group = mesh.group('graph'), mesh.group('data')
    D, G = mesh.shape['data'], mesh.shape['graph']
    d, g = mesh.coords

    def fn(z, pos, cell):
        B, N = z.shape
        if B % D or N % G:
            raise ValueError(
                f'batch {B} x atoms {N} does not divide over the mesh '
                f'{D}x{G}; pad the atoms with spatial_sort(n_shards=G)')
        b, n = B // D, N // G
        z_loc = z[d * b:(d + 1) * b, g * n:(g + 1) * n]
        cell_loc = cell[d * b:(d + 1) * b]
        mask = z_loc > 0
        with fp32_matmuls(), torch.enable_grad(), \
                constant_parameters(model.core):
            x = pos[d * b:(d + 1) * b, g * n:(g + 1) * n].detach() \
                .requires_grad_(True)
            disp = _identity_disp(x, b, compute_stress)
            pos_d, cell_d = _strained(x, cell_loc,
                                      disp if compute_stress else None)
            e_local, _ = _local_energy(model, n_halo, group, z_loc, pos_d,
                                       cell_d, mask, (x, cell_loc))
            # the LOCAL energy sum only: the exchanges' backward adds the
            # other slabs' terms onto this one
            wrt = (x, disp) if compute_stress else (x,)
            grads = torch.autograd.grad(e_local.sum(), wrt)
        energy = all_reduce_sum(e_local.detach(), group)
        forces = all_gather_cat(-grads[0], group, 1)
        result = [all_gather_cat(energy, data_group, 0),
                  all_gather_cat(forces, data_group, 0)]
        if compute_stress:
            volume = torch.abs(det3x3(cell_loc))[:, None, None]
            stress = all_reduce_sum(grads[1], group) / volume
            result.append(all_gather_cat(stress, data_group, 0))
        return tuple(result)

    return fn


HALO_LOSS_KEYS = frozenset(
    {'energy', 'gradient_force', 'direct_force', 'stress', 'virial'})


def _halo_loss_config(loss_config, energy_weight, force_weight):
    '''Normalize and validate the halo loss config; None falls back to the
    classic energy+force pair built from the two weight scalars.'''
    if loss_config is None:
        loss_config = {'energy': {'weight': energy_weight},
                       'gradient_force': {'weight': force_weight}}
    cfg = {k: dict(v or {}) for k, v in loss_config.items()}
    bad = set(cfg) - HALO_LOSS_KEYS
    if bad or not cfg:
        raise ValueError(
            f'halo training supports losses within '
            f'{sorted(HALO_LOSS_KEYS)} (got {sorted(cfg) or None})')
    for k, v in cfg.items():
        if v.get('mode', 'mse') != 'mse':
            raise ValueError(
                f"halo training losses are mse-only (got mode="
                f"{v.get('mode')!r} for {k}); the surrogate-gradient "
                f"algebra below is derived for squared error")
    return cfg


def _reduce(x, *groups):
    for group in groups:
        x = all_reduce_sum(x, group)
    return x


def make_halo_grads_fn(model, mesh, n_halo, loss_config=None,
                       energy_weight=1.0, force_weight=50.0,
                       with_grads=True):
    '''A function batch -> metrics for the halo-parallel configuration:
    the building block of the Trainer's halo mode and
    make_halo_train_step. `batch` is this rank's block of the global batch
    (shard_halo_batch: its data row's graphs, its slab of their atoms) as
    numpy arrays or tensors; the metrics are 0-d tensors of the global
    batch, equal on every rank. With with_grads the parameters' .grad hold
    the gradient of the global loss, summed over both mesh axes; with
    with_grads=False (evaluation) no parameter backward runs.

    batch = {z (b, n), pos (b, n, 3), cell (b, 3, 3), energy (b,), force
    (b, n, 3), graph_mask (b,), [stress (b, 3, 3)], [virial ...]}.
    loss_config follows train/loss.py ({'energy': {'weight': w},
    'gradient_force': ..., 'direct_force': ..., 'stress': ..., 'virial':
    ...}, mse modes); None = the classic energy+force pair from the two
    weight scalars. The masked means are train/loss.py's over the global
    batch (direct_force also reports the cos / norm decompositions);
    second-derivative heads (hessian / bec) are refused: their lanes couple
    atoms far beyond the one-ring halo.

    Per-graph predictions (energy, stress, virial) are sums over the
    ranks, so each mse term is a local surrogate sum(detached residual *
    local contribution), whose gradient summed over the ranks is exactly
    that of the global mse (the JAX function's algebra). Stress and virial
    come from the strain displacement applied to each rank's local pos and
    cell before the exchange. A charge head adds the sharded Ewald energy
    (ops/ewald.ewald_energy_periodic_sharded: the structure factor summed
    over the graph group, differentiable), at the strained positions and
    cell, as the JAX function adds it; it needs ewald_mode 'periodic'.'''
    cfg = _halo_loss_config(loss_config, energy_weight, force_weight)
    check_halo_model(model, mesh, n_halo)
    needs_disp = 'stress' in cfg or 'virial' in cfg
    props = set(model.output_properties)
    second = {'hessian', 'bec'} & props
    if second:
        raise ValueError(
            f'halo training does not support second-derivative heads '
            f'({sorted(second)}); drop them from output_properties for the '
            f'sharded run and evaluate them post-training on the unsharded '
            f'model')
    if 'direct_force' in cfg and 'direct_force' not in props:
        raise ValueError(
            "loss config has 'direct_force' but the model has no "
            "direct_force head (add it to output_properties)")
    _check_charge_mode(model)
    w = {k: float(v.get('weight', 1.0)) for k, v in cfg.items()}
    group, data_group = mesh.group('graph'), mesh.group('data')
    chief = mesh.index('graph') == 0
    params = list(model.core.parameters())
    dev = model.device
    needs_pos_grad = 'gradient_force' in cfg or needs_disp

    def fn(batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        z, pos, cell = batch['z'], batch['pos'], batch['cell']
        b = z.shape[0]
        gmask_b = batch['graph_mask'].bool()
        gmask = gmask_b.to(pos.dtype)
        atom_mask = (z > 0) & gmask_b[:, None]
        fmask = atom_mask.to(pos.dtype)[..., None]
        # global counts: graphs (replicated over the graph ranks: the
        # chief of each data row counts them), force components, and each
        # graph's real atoms; max(count, 1) as train/loss.py's guard
        per_graph = _reduce(atom_mask.to(pos.dtype).sum(1), group)
        counts = _reduce(torch.stack([gmask.sum() * chief, fmask.sum()]),
                         group, data_group)
        n_graphs = torch.clamp(counts[0], min=1.0)
        n_force = torch.clamp(3.0 * counts[1], min=1.0)
        n_tensor = 9.0 * n_graphs
        volume = torch.abs(det3x3(cell))
        if with_grads:
            for p in params:
                p.grad = None
        held = contextlib.nullcontext() if with_grads else \
            constant_parameters(model.core)
        with fp32_matmuls(), torch.enable_grad(), held:
            x = pos.detach().requires_grad_(needs_pos_grad)
            disp = _identity_disp(x, b, needs_disp)
            pos_d, cell_d = _strained(x, cell, disp if needs_disp else None)
            e_local, out = _local_energy(model, n_halo, group, z, pos_d,
                                         cell_d, atom_mask, (pos_d, cell_d))
            pos_grad = disp_grad = None
            if needs_pos_grad:
                wrt = (x, disp) if needs_disp else (x,)
                grads = torch.autograd.grad(e_local.sum(), wrt,
                                            create_graph=with_grads)
                pos_grad = grads[0]
                disp_grad = grads[1] if needs_disp else None
            # the graphs' sums over the ranks: energies, and the stress or
            # virial shares (no gradient: they enter as residuals)
            shares = {'stress': (lambda: disp_grad / volume[:, None, None]),
                      'virial': (lambda: -disp_grad)}
            tensor_keys = [k for k in ('stress', 'virial') if k in cfg]
            local = {k: shares[k]() for k in tensor_keys}
            summed = _reduce(torch.cat(
                [e_local.detach()[:, None]]
                + [local[k].detach().reshape(b, 9) for k in tensor_keys],
                dim=1), group)
            e_pred = summed[:, 0]
            loss = torch.zeros((), dtype=pos.dtype, device=dev)
            part = {}
            if 'energy' in cfg:
                resid = 2.0 * gmask * (e_pred - batch['energy']) / n_graphs
                loss = loss + w['energy'] * torch.sum(resid * e_local)
            if 'gradient_force' in cfg:
                f_err = (-pos_grad - batch['force']) * fmask
                part['f_se'] = torch.sum(f_err * f_err)
                part['f_ae'] = torch.sum(torch.abs(f_err))
                loss = loss + w['gradient_force'] * part['f_se'] / n_force
            if 'direct_force' in cfg:
                d_pred = out['direct_force'] * fmask
                d_err = (d_pred - batch['force']) * fmask
                part['d_se'] = torch.sum(d_err * d_err)
                part['d_ae'] = torch.sum(torch.abs(d_err))
                loss = loss + w['direct_force'] * part['d_se'] / n_force
            for i, key in enumerate(tensor_keys):
                t_pred = summed[:, 1 + 9 * i:10 + 9 * i].reshape(b, 3, 3)
                t_err = (t_pred - batch[key]) * gmask[:, None, None]
                # graph-replicated: counted by each data row's chief
                part[f'{key}_se'] = torch.sum(t_err * t_err) * chief
                part[f'{key}_ae'] = torch.sum(torch.abs(t_err)) * chief
                resid = 2.0 * gmask[:, None, None] * t_err / n_tensor
                loss = loss + w[key] * torch.sum(resid * local[key])
        if with_grads:
            loss.backward()
            sum_gradients(params, group, data_group)

        # metrics: the global masked means of train/loss.py
        with torch.no_grad():
            e_err = (e_pred - batch['energy']) * gmask
            names, values = ['e_se', 'e_ae'], [
                torch.sum(e_err * e_err) * chief,
                torch.sum(torch.abs(e_err)) * chief]
            if 'energy' in cfg:
                ea_err = e_err / torch.clamp(per_graph, min=1.0)
                names += ['ea_se', 'ea_ae']
                values += [torch.sum(ea_err * ea_err) * chief,
                           torch.sum(torch.abs(ea_err)) * chief]
            if 'direct_force' in cfg:
                amaskf = fmask[..., 0]
                pred, ref = d_pred.detach(), batch['force']
                dot = torch.sum(pred * ref, dim=-1)
                norm = (torch.linalg.norm(pred, dim=-1)
                        * torch.linalg.norm(ref, dim=-1))
                cos = dot / torch.clamp(norm, min=1e-8)
                c_err = (cos - 1.0) * amaskf
                n_err = (torch.linalg.norm(pred, dim=-1)
                         - torch.linalg.norm(ref, dim=-1)) * amaskf
                part.update(c_se=torch.sum(c_err * c_err),
                            c_ae=torch.sum(torch.abs(c_err)),
                            n_se=torch.sum(n_err * n_err),
                            n_ae=torch.sum(torch.abs(n_err)))
            names += list(part)
            values += [v.detach() for v in part.values()]
            tot = dict(zip(names, _reduce(torch.stack(values), group,
                                          data_group)))
            metrics = {'loss': torch.zeros((), dtype=pos.dtype, device=dev)}
            if 'energy' in cfg:
                e_mse = tot['e_se'] / n_graphs
                metrics.update(
                    energy_mae=tot['e_ae'] / n_graphs, energy_mse=e_mse,
                    energy_per_atom_mae=tot['ea_ae'] / n_graphs,
                    energy_per_atom_mse=tot['ea_se'] / n_graphs)
                metrics['loss'] = metrics['loss'] + w['energy'] * e_mse
            if 'gradient_force' in cfg:
                f_mse = tot['f_se'] / n_force
                metrics.update(gradient_force_mae=tot['f_ae'] / n_force,
                               gradient_force_mse=f_mse)
                metrics['loss'] = metrics['loss'] + \
                    w['gradient_force'] * f_mse
            if 'direct_force' in cfg:
                d_mse = tot['d_se'] / n_force
                n_at = n_force / 3.0
                metrics.update(
                    direct_force_mae=tot['d_ae'] / n_force,
                    direct_force_mse=d_mse,
                    direct_force_cos_mae=tot['c_ae'] / n_at,
                    direct_force_cos_mse=tot['c_se'] / n_at,
                    direct_force_norm_mae=tot['n_ae'] / n_at,
                    direct_force_norm_mse=tot['n_se'] / n_at)
                metrics['loss'] = metrics['loss'] + w['direct_force'] * d_mse
            for key in tensor_keys:
                t_mse = tot[f'{key}_se'] / n_tensor
                metrics.update({f'{key}_mae': tot[f'{key}_ae'] / n_tensor,
                                f'{key}_mse': t_mse})
                metrics['loss'] = metrics['loss'] + w[key] * t_mse
        return metrics

    return fn


def make_halo_train_step(model, optimizer, mesh, n_halo, loss_config=None,
                         energy_weight=1.0, force_weight=50.0):
    '''A training step for the halo-parallel configuration: step(batch) ->
    metrics, batch this rank's block (shard_halo_batch); the gradient of
    make_halo_grads_fn, then `optimizer` (train/optimizer.py, over
    model.core) steps on every rank alike.'''
    grads_fn = make_halo_grads_fn(
        model, mesh, n_halo, loss_config=loss_config,
        energy_weight=energy_weight, force_weight=force_weight)

    def step(batch):
        metrics = grads_fn(batch)
        optimizer.step()
        return metrics

    return step


def halo_batch_specs(tensor_labels=()):
    '''The mesh axis each dimension of a halo training batch is split over
    (the JAX package's PartitionSpecs, as tuples of the mesh's axis names;
    None: not split), for make_halo_grads_fn and shard_halo_batch.
    `tensor_labels` adds the per-graph 3x3 labels ('stress' / 'virial') the
    loss config uses.'''
    specs = {
        'z': ('data', 'graph'),
        'pos': ('data', 'graph', None),
        'cell': ('data',),
        'energy': ('data',),
        'force': ('data', 'graph', None),
        'graph_mask': ('data',),
    }
    for key in tensor_labels:
        specs[key] = ('data',)
    return specs


def shard_halo_batch(batch, mesh):
    '''This rank's block of a (sorted, padded) global numpy batch: its data
    row's graphs and, for the per-atom keys, its slab of their atoms, by
    halo_batch_specs; keys outside the specs pass as they are. Raises
    ValueError when the batch or the atoms do not divide over the
    mesh.'''
    specs = halo_batch_specs([k for k in ('stress', 'virial')
                              if k in batch])
    index = dict(zip(mesh.axis_names, mesh.coords))
    out = {}
    for key, value in batch.items():
        if key not in specs:
            out[key] = value
            continue
        value = np.asarray(value)
        for dim, axis in enumerate(specs[key]):
            if axis is None:
                continue
            n = mesh.shape[axis]
            if value.shape[dim] % n:
                raise ValueError(
                    f'{key}: dimension {dim} ({value.shape[dim]}) does not '
                    f'divide over the {axis} axis ({n})')
            size = value.shape[dim] // n
            value = value.take(np.arange(index[axis] * size,
                                         (index[axis] + 1) * size), axis=dim)
        out[key] = np.ascontiguousarray(value)
    return out
