'''The collectives of the port's parallelism, over torch.distributed.

The JAX package's collectives are XLA's (psum, all_gather, and their
transposes inside shard_map). Here each is one torch.distributed call on a
mesh axis's process group, with None (an axis of one rank, or no process
group) meaning the identity.

Two backends (parallel/distributed.choose_backend): NCCL, where every
rank has a card of its own, moves CUDA tensors card to card; gloo moves
CPU tensors, and where ranks share one card their CUDA tensors cross
through host memory: each collective copies its tensor to the host, runs
there, and copies the result back (a host sync each way). Nothing
computes on the host: the copies are the transport.

`STATS` counts the collectives and the host-clock seconds spent in them
(`reset_stats`), which chip_smoke.py reports per step.
'''
import time

import torch
import torch.distributed as dist

STATS = {'calls': 0, 'seconds': 0.0}


def reset_stats():
    STATS.update(calls=0, seconds=0.0)


def _host_staged(x, group):
    return x.is_cuda and dist.get_backend(group) == 'gloo'


def _wire(x):
    # gloo and NCCL reduce bf16 in bf16; summing in fp32 and rounding once
    # keeps a bf16 all-reduce the same in both
    return x.float() if x.dtype == torch.bfloat16 else x


class _Timed:
    def __enter__(self):
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        STATS['calls'] += 1
        STATS['seconds'] += time.perf_counter() - self.t


def all_reduce_sum(x, group):
    '''The sum of x over the ranks of `group` (a new tensor; x itself when
    the group is None).'''
    if group is None:
        return x
    with _Timed():
        buf = _wire(x)
        buf = buf.cpu() if _host_staged(x, group) else buf.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf.to(device=x.device, dtype=x.dtype)


def all_gather_cat(x, group, dim):
    '''x of every rank of `group`, in rank order, concatenated along
    `dim` (x itself when the group is None). Shapes must agree.'''
    if group is None:
        return x
    with _Timed():
        staged = _host_staged(x, group)
        src = (x.cpu() if staged else x).contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if staged else out


def broadcast_(tensors, src=0, group=None):
    '''Overwrite `tensors` (a list) with those of global rank `src`, as
    one flat buffer; a no-op outside a process group.'''
    if not (dist.is_available() and dist.is_initialized()) or not tensors:
        return
    with _Timed():
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in tensors])
        staged = _host_staged(flat, group)
        buf = flat.cpu() if staged else flat
        dist.broadcast(buf, src=src, group=group)
        buf = buf.to(flat.device)
        at = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel()
                t.copy_(buf[at:at + n].reshape(t.shape).to(t.dtype))
                at += n


class AllGatherRows(torch.autograd.Function):
    '''all_gather_cat along `dim` with its transpose as the backward: the
    cotangent of the gathered tensor summed over the group (all-reduce),
    then this rank's block, which is the sum a reduce-scatter gives. A
    reduce-scatter would move 1/G of the bytes (gloo has one in torch
    2.13 on the CPU); the all-reduce is the one collective every backend
    here has for host-staged and card tensors alike, and the cotangents
    of node rows (B, N, F) are small beside the pair tensors.

    apply(x, group, dim) -> (..., G * n, ...)'''

    @staticmethod
    def forward(x, group, dim):
        return all_gather_cat(x, group, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, group, dim = inputs
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_sum(g.contiguous(), ctx.group)
        r = dist.get_rank(ctx.group)
        return total.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def gather_rows(x, group, dim=1):
    '''Differentiable all_gather_cat along `dim` (the identity without a
    group).'''
    if group is None:
        return x
    return AllGatherRows.apply(x, group, dim)
