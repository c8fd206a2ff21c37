'''Multi-process execution (the JAX package's parallel/distributed.py).

A multi-process run is the one-process program on every rank, joined by a
torch.distributed process group: each process calls
initialize_distributed() (or maybe_initialize_from_env()) first, builds
the mesh with make_global_mesh(), and the Trainer and graph_parallel use
it. Every rank iterates the same seeded loader and keeps its rows of each
batch (global_data_batch).

Launching: one process per rank, each exporting
    NEWTONNET_DIST_COORD=<host0>:<port>
    NEWTONNET_DIST_NPROCS=<N>  NEWTONNET_DIST_PROCID=<i>
(parallel/launch.py spawns such a set on one machine); the training CLI
calls maybe_initialize_from_env() before any device use.

Backend rule (choose_backend): NCCL where every rank has a card of its
own, gloo where ranks share a card (NCCL refuses two ranks on one device)
and on the CPU. A rank with a card of its own runs on cuda:<rank mod
cards>; ranks that share one all run on it. A failed initialisation
raises: nothing drops to the CPU or to one process.
'''
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from newtonnet_tpu_torch.parallel.mesh import make_mesh, world

ENV = ('NEWTONNET_DIST_COORD', 'NEWTONNET_DIST_NPROCS',
       'NEWTONNET_DIST_PROCID')
# the batch keys carrying the global batch's masked counts (train/loss.py)
COUNT_KEYS = ('graph_count', 'atom_count')
# seconds a collective or a point-to-point exchange waits for its peers:
# ranks that disagree on the order of their exchanges (a halo backward run
# in another order) fail with an error instead of hanging
TIMEOUT_S = 600


def choose_backend(device, num_processes, n_cards=None):
    '''The backend of `num_processes` ranks on one machine: 'nccl' when
    device is CUDA and there are at least as many cards as ranks, 'gloo'
    otherwise (ranks sharing a card, or the CPU).'''
    if torch.device(device).type != 'cuda':
        return 'gloo'
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    if n_cards < 1:
        raise RuntimeError('no CUDA device: pass device=\'cpu\' to run on '
                           'the CPU')
    return 'nccl' if n_cards >= num_processes else 'gloo'


def rank_device(device, rank, n_cards=None):
    '''The device rank `rank` runs on: the CPU, or cuda:<rank mod
    cards>.'''
    if torch.device(device).type != 'cuda':
        return torch.device('cpu')
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    return torch.device('cuda', rank % n_cards)


def initialize_distributed(coordinator_address, num_processes, process_id,
                           device='cuda'):
    '''Join the process group of `num_processes` ranks at
    tcp://<coordinator_address> as rank `process_id`, over the backend
    choose_backend gives for `device` ('cuda' or 'cpu'), and make this
    rank's card the current one. A no-op returning False for one process
    or when already initialised; True when it joined. A failed join
    raises, and so does a collective whose peers have not come after
    TIMEOUT_S seconds.'''
    if num_processes is None or int(num_processes) <= 1:
        return False
    if dist.is_initialized():
        return False
    num_processes, process_id = int(num_processes), int(process_id)
    backend = choose_backend(device, num_processes)
    dev = rank_device(device, process_id)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend,
                            init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def maybe_initialize_from_env(device='cuda'):
    '''initialize_distributed from the NEWTONNET_DIST_* variables; False
    (nothing done) when they are absent or NPROCS <= 1. Must run before
    the first device use.'''
    coord, nprocs, procid = (os.environ.get(k) for k in ENV)
    if not (coord and nprocs and procid):
        return False
    return initialize_distributed(coord, int(nprocs), int(procid),
                                  device=device)


def backend():
    '''The default group's backend, or None outside a process group.'''
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def is_multiprocess():
    '''True when this run spans more than one process.'''
    return world()[1] > 1


def describe(device):
    '''One line naming this rank, the world, the backend and the device,
    as the training CLI prints it.'''
    rank, size = world()
    b = backend()
    if b == 'gloo' and torch.device(device).type == 'cuda':
        how = (f'gloo: {size} ranks share {torch.cuda.device_count()} '
               f'card(s), collectives through host memory')
    elif b == 'nccl':
        how = 'nccl: one card per rank'
    else:
        how = 'gloo on the CPU'
    return f'distributed: rank {rank}/{size}, {how}, device {device}'


def make_global_mesh(data=-1, graph=1):
    '''The mesh over every rank of the world (make_mesh's semantics).'''
    return make_mesh(data=data, graph=graph)


def process_local_batch_slice(global_batch_size, mesh=None):
    '''(start, size) of this process's rows of a global batch: by rank
    over the world (as the JAX function, one device per process), or by
    the data index over the mesh's data axis, where the graph ranks of one
    data row share its rows.'''
    if mesh is None:
        index, n = world()
    else:
        index, n = mesh.index('data'), mesh.shape['data']
    if global_batch_size % n:
        raise AssertionError(
            f'global batch {global_batch_size} not divisible by {n} '
            f'processes')
    size = global_batch_size // n
    return index * size, size


def _rows(x, start, size):
    if isinstance(x, tuple):  # staircase chunk tuples
        return tuple(_rows(a, start, size) for a in x)
    x = np.asarray(x)
    if x.ndim == 0:
        return x
    return np.ascontiguousarray(x[start:start + size])


def global_data_batch(mesh, batch):
    '''This rank's rows of a host batch of the global batch (every rank
    iterates the same seeded loader, so slicing here is per-process
    loading), with the global batch's masked counts the losses divide by
    (COUNT_KEYS: the real graphs and the real atoms), so that the ranks'
    losses and gradients sum to the global batch's.

    Raises ValueError when the batch does not divide over the data
    axis.'''
    n = mesh.shape['data']
    b = int(np.asarray(batch['z']).shape[0])
    if b % n:
        raise ValueError(f'batch dim {b} not divisible by {n} processes')
    start, size = process_local_batch_slice(b, mesh)
    out = {k: _rows(v, start, size) for k, v in batch.items()}
    z = np.asarray(batch['z'])
    gmask = np.asarray(batch.get('graph_mask', np.ones(b, bool)))
    out['graph_count'] = np.int64(np.count_nonzero(gmask))
    out['atom_count'] = np.int64(np.count_nonzero(z > 0))
    return out
