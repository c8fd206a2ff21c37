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
(`reset_stats`), which chip_smoke.py reports per step, and the halo
exchanges' payloads: calls, the atom rows this rank sent (2 * n_halo per
call), their bytes, the bytes of one row per call summed (so that
halo_bytes == n_halo * 2 * halo_row_bytes is checkable) and the most rows
one call sent.

The halo exchange (exchange_halo, the JAX package's parallel/halo.py
exchange_halo) swaps the first and last n_halo atom rows of each rank's
slab with its two neighbours on the ring of the 'graph' group, by
point-to-point sends in a fixed order; its transpose sends the halos'
cotangents back and adds them onto the boundary rows they came from. Both
are autograd Functions whose backward is the other, so every derivative
order of a halo-sharded energy runs the exchanges (the force loss's
parameter gradient differentiates through the force pass's reverse
exchange). AllReduceSum is the all-reduce whose backward is the
all-reduce of the cotangent: the transpose the JAX package's legacy
shard_map gives psum, which the sharded Ewald sum relies on
(ops/ewald.ewald_energy_periodic_sharded, called with psum by
parallel/halo.py).
'''
import time

import torch
import torch.distributed as dist

STATS = {'calls': 0, 'seconds': 0.0, 'halo_calls': 0, 'halo_rows': 0,
         'halo_bytes': 0, 'halo_row_bytes': 0, 'halo_rows_max': 0}


def reset_stats():
    STATS.update(calls=0, seconds=0.0, halo_calls=0, halo_rows=0,
                 halo_bytes=0, halo_row_bytes=0, halo_rows_max=0)


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


def all_reduce_max(x, group):
    '''The elementwise maximum of x over the ranks of `group` (x itself
    when the group is None).'''
    if group is None:
        return x
    with _Timed():
        buf = x.cpu() if _host_staged(x, group) else x.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
        return buf.to(x.device)


def sum_gradients(params, *groups):
    '''Sum the parameters' gradients over each of `groups` in turn (None
    skipped), as one flat buffer in parameter order; parameters without a
    gradient (frozen ones) are left out on every rank.'''
    groups = [g for g in groups if g is not None]
    grads = [p.grad for p in params if p.grad is not None]
    if not groups or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    for group in groups:
        flat = all_reduce_sum(flat, group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


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


class AllReduceSum(torch.autograd.Function):
    '''all_reduce_sum whose backward is the all-reduce of the cotangent
    (itself again, so every derivative order is): the transpose of psum
    under the JAX package's legacy shard_map. Summed over the ranks, each
    rank seeding its own share, a function of the reduced value then gets
    its exact derivative. apply(x, group) -> sum over the group.'''

    @staticmethod
    def forward(x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return AllReduceSum.apply(g.contiguous(), ctx.group), None


def psum(x, group):
    '''Differentiable all_reduce_sum (AllReduceSum); the identity without
    a group.'''
    if group is None:
        return x
    return AllReduceSum.apply(x, group)


def _ring(group):
    '''(global rank of the left neighbour, of the right one) on the ring
    of `group` (group ranks r - 1 and r + 1, wrapping).'''
    r, n = dist.get_rank(group), dist.get_world_size(group)
    return (dist.get_global_rank(group, (r - 1) % n),
            dist.get_global_rank(group, (r + 1) % n))


def _swap(to_left, to_right, group):
    '''Send `to_left` to the left neighbour and `to_right` to the right
    one; -> (what the left one sent rightwards, what the right one sent
    leftwards). Shapes agree across ranks. The two directions carry their
    own tags, so with 2 ranks, where both neighbours are the same rank, the
    messages cannot cross; every rank posts its four operations in the
    same order. gloo stages CUDA tensors through host memory.'''
    left, right = _ring(group)
    staged = _host_staged(to_left, group)
    dev = to_left.device
    out_l, out_r = to_left.contiguous(), to_right.contiguous()
    if staged:
        out_l, out_r = out_l.cpu(), out_r.cpu()
    from_left, from_right = torch.empty_like(out_r), torch.empty_like(out_l)
    ops = [dist.P2POp(dist.isend, out_r, right, group, 0),
           dist.P2POp(dist.irecv, from_left, left, group, 0),
           dist.P2POp(dist.isend, out_l, left, group, 1),
           dist.P2POp(dist.irecv, from_right, right, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        from_left, from_right = from_left.to(dev), from_right.to(dev)
    return from_left, from_right


def _count_halo(block):
    '''STATS of one exchange that sends `block` (B, H, ...) each way.'''
    rows = 2 * block.shape[1]
    row_bytes = block[:, :1].numel() * block.element_size()
    STATS['halo_calls'] += 1
    STATS['halo_rows'] += rows
    STATS['halo_bytes'] += rows * row_bytes
    STATS['halo_row_bytes'] += row_bytes
    STATS['halo_rows_max'] = max(STATS['halo_rows_max'], rows)


def _check_halo(n_loc, n_halo, group):
    if not 0 < n_halo <= n_loc:
        raise ValueError(f'n_halo must be in [1, N_loc={n_loc}]; got '
                         f'{n_halo} (n_halo=0 would slice x[:, -0:] as the '
                         'whole shard)')
    if dist.get_world_size(group) == 2 and 2 * n_halo > n_loc:
        raise ValueError(
            f'with 2 graph shards both halos come from the same neighbor; '
            f'2*n_halo={2 * n_halo} > N_loc={n_loc} would duplicate atoms '
            'in the extended axis and double-count their edges')


def _exchange(x, n_halo, group):
    with _Timed():
        first, last = x[:, :n_halo], x[:, -n_halo:]
        _count_halo(first)
        left, right = _swap(first, last, group)
        return torch.cat([left, x, right], dim=1)


def _return(g, n_halo, group):
    with _Timed():
        g_left, g_right = g[:, :n_halo], g[:, -n_halo:]
        _count_halo(g_left)
        # what the left neighbour sent back is the cotangent of its right
        # halo (our first rows), the right one's that of its left halo
        from_left, from_right = _swap(g_left, g_right, group)
        n_loc = g.shape[1] - 2 * n_halo
        out = g[:, n_halo:n_halo + n_loc].clone()
        # (with n_halo < N_loc < 2 n_halo the two blocks overlap)
        out[:, :n_halo] += from_left
        out[:, n_loc - n_halo:] += from_right
        return out


class HaloExchange(torch.autograd.Function):
    '''exchange_halo as an autograd Function; backward HaloReturn.
    apply(x, n_halo, group) -> (B, N_loc + 2 n_halo, ...)'''

    @staticmethod
    def forward(x, n_halo, group):
        return _exchange(x, n_halo, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n_halo, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return HaloReturn.apply(g, ctx.n_halo, ctx.group), None, None


class HaloReturn(torch.autograd.Function):
    '''The transpose of the exchange: the halos' cotangents sent back to
    the ranks they came from and added onto those boundary rows, the own
    block kept. Backward HaloExchange. apply(g, n_halo, group) ->
    (B, N_loc, ...)'''

    @staticmethod
    def forward(g, n_halo, group):
        return _return(g, n_halo, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n_halo, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return HaloExchange.apply(g, ctx.n_halo, ctx.group), None, None


def exchange_halo(x, n_halo, group):
    '''Ring-exchange boundary blocks: x (B, N_loc, ...) -> (B, N_loc +
    2 n_halo, ...), [left halo | own | right halo] along axis 1, the left
    halo being the left ring neighbour's last n_halo rows and the right
    halo the right neighbour's first n_halo rows. Each call sends 2 *
    n_halo rows per rank, whatever the global atom count. Differentiable
    in every order (HaloExchange / HaloReturn); tensors that are not
    floating point (masks) are exchanged as they are.

    Raises ValueError unless 0 < n_halo <= N_loc, and with 2 ranks unless
    2 * n_halo <= N_loc (both halos then come from the one neighbour).'''
    _check_halo(x.shape[1], n_halo, group)
    if x.dtype == torch.bool:
        return _exchange(x.to(torch.uint8), n_halo, group).bool()
    if not x.is_floating_point():
        return _exchange(x, n_halo, group)
    return HaloExchange.apply(x, n_halo, group)
