'''The ('data', 'graph') process mesh (the JAX package's
parallel/mesh.py).

The JAX package lays its devices out on a jax.sharding.Mesh with two
axes: 'data' (the batch: data parallelism, the gradient summed over it)
and 'graph' (the atoms of one large graph: graph parallelism). Here a
device is a process, one torch.distributed rank: rank r sits at
(d, g) = divmod(r, graph) of a (data, graph) array of ranks, and the mesh
holds one process group per data row (the ranks of one data index, which
share the atoms of their graphs: the 'graph' collectives) and per graph
column (the ranks of one graph index, which share the batch: the 'data'
collectives, the gradient's all-reduce).

Axis sizes of -1 consume the remaining ranks. Without an initialised
process group the world is this one process and the mesh is 1x1.
'''
import numpy as np
import torch.distributed as dist


def world():
    '''(rank, world size) of this process: (0, 1) without a process
    group.'''
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    '''A (data, graph) array of ranks with its process groups.

    Attributes:
        ranks: (data, graph) int array of global ranks.
        shape: {'data': D, 'graph': G}.
        axis_names: ('data', 'graph').
        coords: this rank's (d, g), or None when it is not in the mesh.
        groups: {'data': the group of this rank's graph column, 'graph':
            that of its data row}; None for an axis of size 1 (its
            collectives are the identity) or outside a process group.
    '''
    axis_names = ('data', 'graph')

    def __init__(self, ranks, groups, rank):
        self.ranks = np.asarray(ranks)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        hit = np.argwhere(self.ranks == rank)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        self.groups = groups

    def group(self, axis):
        return self.groups[axis]

    def index(self, axis):
        '''This rank's coordinate along `axis`.'''
        return self.coords[self.axis_names.index(axis)]

    def __repr__(self):
        return (f'Mesh(data={self.shape["data"]}, '
                f'graph={self.shape["graph"]}, coords={self.coords})')


def make_mesh(data=-1, graph=1, ranks=None):
    '''Create a Mesh with ('data', 'graph') axes.

    Args:
        data: data-parallel axis size (-1 = fill with remaining ranks).
        graph: atom-partition axis size.
        ranks: explicit rank list (default: every rank of the world).

    Every rank of the world must call it, in the same order as its other
    group creations (torch.distributed.new_group is collective).'''
    rank, size = world()
    ranks = list(ranks) if ranks is not None else list(range(size))
    n = len(ranks)
    if data == -1:
        if n % graph:
            raise AssertionError(
                f'{n} ranks not divisible by graph={graph}')
        data = n // graph
    if data * graph > n:
        raise AssertionError(
            f'mesh {data}x{graph} needs more than {n} ranks')
    grid = np.asarray(ranks[:data * graph]).reshape(data, graph)
    groups = {'data': None, 'graph': None}
    if size > 1:
        # new_group is collective: every rank creates every group of more
        # than one rank, in the same order, and keeps its own
        for axis, lines in (('graph', grid), ('data', grid.T)):
            for line in lines:
                members = [int(r) for r in line]
                if len(members) == 1:
                    continue
                grp = dist.new_group(members)
                if rank in members:
                    groups[axis] = grp
    return Mesh(grid, groups, rank)
