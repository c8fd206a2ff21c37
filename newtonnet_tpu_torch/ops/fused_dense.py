'''Fused dense pair-interaction layer: plain versions, CUDA wrappers and the
autograd Function.

The layer (the JAX package's `ops/pallas_dense.py`), for B molecules of N
atoms, F features and R radial basis functions:

    msg  = (rbf @ We) * np_i * np_j * adj          (B, N, N, F)
    inv1 = sum_j msg                               (B, N, F)
    phi1 = (silu(msg @ W1a) @ W1b) * adj
    phi2 = (silu(msg @ W2a) @ W2b) * adj
    eq[:, d] = sum_j phi1 * dir[:, d, ..., None]
             + sum_j phi2 * force[:, d, None, :, :]   (B, 3, N, F)

`first_layer=True` drops phi2: the stack's first layer sees force == 0.

`dot_dtype='bfloat16'` (the JAX package's `pallas_dot_dtype`) rounds to
bf16 both operands of the products the Pallas kernels cast
(`ops/pallas_dense.py`: `_chain`'s `dot` and K2's weight cotangents
`dotT`), accumulating in fp32; K2's cotangent products (dh, dmsg, drbf)
stay fp32, as the Pallas kernel leaves them, and all elementwise
arithmetic stays fp32. The plain versions compute such a product as an
fp32 product of the rounded operands (`_dots`): a product of two bf16
values is exact in fp32, so only the summation order is left to differ.

On the card the forward runs `csrc/fused_dense.cu:nn_pair_fwd` (K1) and
the backward `nn_pair_bwd` (K2), on the tensor cores: in fp32 mode in
3xTF32 (each operand split in a TF32 high and low part, three products
summed in fp32), in bf16 mode the rounded products as bf16 `mma.sync`
with fp32 accumulation (K2's fp32 cotangent products still in 3xTF32),
from a library built for that mode (`_build.load(..., dot_dtype)`); on
the CPU the wrappers run the plain versions below. A CUDA tensor either
launches the kernel or raises: nothing falls back. The kernels take any F
from 1 to `_build.MAX_WIDTH`: they run at its padded width (the next
multiple of 32, past 128 of 64; `_build.padded_width`) with zero pad
lanes of their own, reading and writing every tensor at F, from the
library that runs that width (`_build.load`).

Each launch is a torch custom op (`newtonnet_tpu_torch::pair_fwd`,
`pair_bwd`; torch.library): its implementation is the launch on CUDA
tensors and the plain version on CPU ones, its fake implementation gives
the outputs' shapes, so that torch.export records the op in a serving
artifact (utils/export.py) and a replay of it launches the kernel. The
wrappers check what the kernels take and call the ops.
'''
import ctypes

import torch

from newtonnet_tpu_torch.ops._build import DOT_DTYPES

# Launches of each kernel variant, counted by its wrapper (bf16 mode under
# the names ending in '_bf16').
LAUNCHES = {'pair_fwd': 0, 'pair_fwd_first': 0,
            'pair_bwd': 0, 'pair_bwd_first': 0,
            'pair_fwd_bf16': 0, 'pair_fwd_first_bf16': 0,
            'pair_bwd_bf16': 0, 'pair_bwd_first_bf16': 0}
# K2 launches among those that computed the weight cotangents
WEIGHT_GRAD_LAUNCHES = {'pair_bwd': 0, 'pair_bwd_first': 0,
                        'pair_bwd_bf16': 0, 'pair_bwd_first_bf16': 0}


def reset_launch_counts():
    for counts in (LAUNCHES, WEIGHT_GRAD_LAUNCHES):
        for key in counts:
            counts[key] = 0


def launch_key(name, first_layer, dot_dtype):
    '''The LAUNCHES key of a kernel variant.'''
    return (name + ('_first' if first_layer else '')
            + ('_bf16' if dot_dtype == 'bfloat16' else ''))


_silu = torch.nn.functional.silu


def check_dot_dtype(dot_dtype):
    if dot_dtype not in DOT_DTYPES:
        raise ValueError(f'dot_dtype must be one of {DOT_DTYPES}, got '
                         f'{dot_dtype!r}')
    return dot_dtype


def _dots(dot_dtype):
    '''(dot, dotT): a @ b and a^T @ b over the flattened slots, with both
    operands rounded to bf16 first in bf16 mode.'''
    if check_dot_dtype(dot_dtype) == 'bfloat16':
        def cast(a):
            return a.bfloat16().to(a.dtype)
    else:
        def cast(a):
            return a

    def dot(a, b):
        return cast(a) @ cast(b)

    def dotT(a, b):
        return cast(a).reshape(-1, a.shape[-1]).T @ \
            cast(b).reshape(-1, b.shape[-1])

    return dot, dotT


def _dsilu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def pair_interaction_fwd_ref(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a,
                             W2b, first_layer=False, dot_dtype='float32'):
    '''Plain PyTorch forward of the layer -> (inv1 (B,N,F), eq (B,3,N,F)).'''
    dot, _ = _dots(dot_dtype)
    adj4 = adj[..., None]
    msg = dot(rbf, We) * np_[:, :, None, :] * np_[:, None, :, :] * adj4
    inv1 = msg.sum(2)
    phi1 = dot(_silu(dot(msg, W1a)), W1b) * adj4
    eqs = [(phi1 * dir_[:, d, :, :, None]).sum(2) for d in range(3)]
    if not first_layer:
        phi2 = dot(_silu(dot(msg, W2a)), W2b) * adj4
        eqs = [e + (phi2 * force[:, d, None, :, :]).sum(2)
               for d, e in enumerate(eqs)]
    return inv1, torch.stack(eqs, dim=1)


def pair_interaction_bwd_ref(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a,
                             W2b, dinv1, deq, first_layer=False,
                             weight_grads=True, dot_dtype='float32'):
    '''Plain PyTorch backward of the layer, written out by hand (not
    autograd of the forward): the cotangents of every input given those of
    (inv1, eq).

    Returns (dnp, drbf, ddir, dforce, dWe, dW1a, dW1b, dW2a, dW2b); the five
    weight cotangents are None unless weight_grads. At the first layer
    dforce, dW2a and dW2b are zeros. In bf16 mode the chain and the weight
    cotangents take rounded operands, the cotangent products (dh, dmsg,
    drbf) fp32 ones, as the Pallas kernel computes them.'''
    dot, dotT = _dots(dot_dtype)
    adj4 = adj[..., None]
    ni, nj = np_[:, :, None, :], np_[:, None, :, :]
    me = dot(rbf, We)
    msg = me * ni * nj * adj4
    p1 = dot(msg, W1a)
    h1 = _silu(p1)
    phi1 = dot(h1, W1b) * adj4
    g = deq[:, :, :, None, :]                          # (B, 3, N, 1, F)
    dphi1 = sum(g[:, d] * dir_[:, d, :, :, None] for d in range(3)) * adj4
    ddir = (phi1[:, None] * g).sum(-1)                 # (B, 3, N, N)
    dh1 = dphi1 @ W1b.T
    dp1 = dh1 * _dsilu(p1)
    dmsg = dp1 @ W1a.T
    if first_layer:
        dforce = torch.zeros_like(force)
    else:
        p2 = dot(msg, W2a)
        h2 = _silu(p2)
        phi2 = dot(h2, W2b) * adj4
        dforce = (phi2[:, None] * g).sum(2)            # sum over i
        dphi2 = sum(g[:, d] * force[:, d, None, :, :]
                    for d in range(3)) * adj4
        dp2 = (dphi2 @ W2b.T) * _dsilu(p2)
        dmsg = dmsg + dp2 @ W2a.T
    dmsg4 = (dmsg + dinv1[:, :, None, :]) * adj4
    dnp = (dmsg4 * me * nj).sum(2) + (dmsg4 * me * ni).sum(1)
    dme = dmsg4 * ni * nj
    drbf = dme @ We.T
    if not weight_grads:
        return dnp, drbf, ddir, dforce, None, None, None, None, None
    dWe = dotT(rbf, dme)
    dW1a = dotT(msg, dp1)
    dW1b = dotT(h1, dphi1)
    if first_layer:
        dW2a, dW2b = torch.zeros_like(W2a), torch.zeros_like(W2b)
    else:
        dW2a, dW2b = dotT(msg, dp2), dotT(h2, dphi2)
    return dnp, drbf, ddir, dforce, dWe, dW1a, dW1b, dW2a, dW2b


# ----------------------------------------------------------------------- #
def _lib(F, dot_dtype='float32'):
    from newtonnet_tpu_torch.ops import _build
    lib = _build.load('fused_dense', F, dot_dtype)
    if not getattr(lib, '_nn_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn_pair_fwd.argtypes = [p] * 13 + [i] * 6 + [p]
        lib.nn_pair_fwd.restype = i
        lib.nn_pair_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
        lib.nn_pair_bwd.restype = i
        lib.nn_pair_scratch_floats.argtypes = [i] * 5
        lib.nn_pair_scratch_floats.restype = ctypes.c_size_t
        lib._nn_typed = True
    return lib


def _check_cuda(named, shapes):
    '''Device, dtype, shape and contiguity checks before a launch.'''
    device = named[0][1].device
    for (name, t), shape in zip(named, shapes):
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, expected {device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32 on CUDA, got {t.dtype}')
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, '
                             f'expected {tuple(shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _shapes(np_, rbf):
    from newtonnet_tpu_torch.ops import _build
    B, N, F = np_.shape
    R = rbf.shape[-1]
    _build.padded_width(F)  # refuses a width the kernels do not take
    if B * N == 0:
        raise ValueError(f'empty batch: B={B}, N={N}')
    return B, N, F, R, [(B, N, F), (B, N, N, R), (B, 3, N, N), (B, N, N),
                        (B, 3, N, F), (R, F), (F, F), (F, F), (F, F), (F, F)]


_NAMES = ('np_', 'rbf', 'dir_', 'adj', 'force', 'We', 'W1a', 'W1b', 'W2a',
          'W2b')


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f'{what} launch failed: cudaError_t {err}')


def _w_flat(dws):
    """The five weight cotangents as one flat tensor (the ops' last
    output), or an empty one without them."""
    if dws[0] is None:
        return torch.empty((0,))
    return torch.cat([w.reshape(-1) for w in dws])


def split_weight_grads(dw, F, R):
    """(dWe, dW1a, dW1b, dW2a, dW2b) as views of the flat dw of a backward
    op, or five None where it is empty (no weight cotangents)."""
    if dw.numel() == 0:
        return (None,) * 5
    shapes = [(R, F)] + [(F, F)] * 4
    return tuple(v.view(s) for v, s in zip(dw.split([R * F] + [F * F] * 4),
                                           shapes))


@torch.library.custom_op('newtonnet_tpu_torch::pair_fwd', mutates_args=())
def _pair_fwd_op(np_: torch.Tensor, rbf: torch.Tensor, dir_: torch.Tensor,
                 adj: torch.Tensor, force: torch.Tensor, We: torch.Tensor,
                 W1a: torch.Tensor, W1b: torch.Tensor, W2a: torch.Tensor,
                 W2b: torch.Tensor, first_layer: bool,
                 dot_dtype: str) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors (checked by pair_interaction_fwd), the plain
    version on CPU ones. -> (inv1, eq)."""
    ins = (np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b)
    if np_.device.type == 'cpu':
        inv1, eq = pair_interaction_fwd_ref(*ins, first_layer=first_layer,
                                            dot_dtype=dot_dtype)
        # contiguous, as the kernel writes them and the fake gives them
        return inv1.contiguous(), eq.contiguous()
    B, N, F = np_.shape
    R = rbf.shape[-1]
    opts = dict(device=np_.device, dtype=torch.float32)
    inv1 = torch.empty((B, N, F), **opts)
    eq = torch.empty((B, 3, N, F), **opts)
    lib = _lib(F, dot_dtype)
    # the prepared weights (tf32 pairs, or bf16) and the row partials
    scratch = torch.empty((lib.nn_pair_scratch_floats(B, N, F, R, 2),),
                          **opts)
    # at most one block per SM, each walking tiles
    sms = torch.cuda.get_device_properties(np_.device).multi_processor_count
    err = lib.nn_pair_fwd(*[t.data_ptr() for t in ins], inv1.data_ptr(),
                          eq.data_ptr(), scratch.data_ptr(), B, N, F, R,
                          int(first_layer), sms,
                          torch.cuda.current_stream(np_.device).cuda_stream)
    _raise_on(err, 'nn_pair_fwd')
    LAUNCHES[launch_key('pair_fwd', first_layer, dot_dtype)] += 1
    return inv1, eq


@_pair_fwd_op.register_fake
def _(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b, first_layer,
      dot_dtype):
    B, N, F = np_.shape
    return np_.new_empty((B, N, F)), np_.new_empty((B, 3, N, F))


@torch.library.custom_op('newtonnet_tpu_torch::pair_bwd', mutates_args=())
def _pair_bwd_op(np_: torch.Tensor, rbf: torch.Tensor, dir_: torch.Tensor,
                 adj: torch.Tensor, force: torch.Tensor, We: torch.Tensor,
                 W1a: torch.Tensor, W1b: torch.Tensor, W2a: torch.Tensor,
                 W2b: torch.Tensor, dinv1: torch.Tensor, deq: torch.Tensor,
                 first_layer: bool, weight_grads: bool, dot_dtype: str
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors (checked by pair_interaction_bwd), the plain
    version on CPU ones. -> (dnp, drbf, ddir, dforce, dw): dw the five
    weight cotangents flat (R*F + 4*F*F,), or empty without
    weight_grads."""
    ins = (np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b)
    if np_.device.type == 'cpu':
        grads = pair_interaction_bwd_ref(*ins, dinv1, deq,
                                         first_layer=first_layer,
                                         weight_grads=weight_grads,
                                         dot_dtype=dot_dtype)
        return (*[g.contiguous() for g in grads[:4]],
                _w_flat(grads[4:]).to(np_.dtype))
    B, N, F = np_.shape
    R = rbf.shape[-1]
    opts = dict(device=np_.device, dtype=torch.float32)
    dnp = torch.empty((B, N, F), **opts)
    drbf = torch.empty((B, N, N, R), **opts)
    ddir = torch.empty((B, 3, N, N), **opts)
    dforce = torch.empty((B, 3, N, F), **opts)
    dw = torch.empty((R * F + 4 * F * F if weight_grads else 0,), **opts)
    lib = _lib(F, dot_dtype)
    # the prepared weights, the cross-block partials and, with
    # weight cotangents, one partial per block
    scratch = torch.empty(
        (lib.nn_pair_scratch_floats(B, N, F, R, int(weight_grads)),), **opts)
    err = lib.nn_pair_bwd(
        *[t.data_ptr() for t in ins + (dinv1, deq, dnp, drbf, ddir, dforce)],
        dw.data_ptr() if weight_grads else None, scratch.data_ptr(),
        B, N, F, R, int(first_layer), int(weight_grads),
        torch.cuda.current_stream(np_.device).cuda_stream)
    _raise_on(err, 'nn_pair_bwd')
    key = launch_key('pair_bwd', first_layer, dot_dtype)
    LAUNCHES[key] += 1
    if weight_grads:
        WEIGHT_GRAD_LAUNCHES[key] += 1
    return dnp, drbf, ddir, dforce, dw


@_pair_bwd_op.register_fake
def _(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b, dinv1, deq,
      first_layer, weight_grads, dot_dtype):
    B, N, F = np_.shape
    R = rbf.shape[-1]
    return (np_.new_empty((B, N, F)), np_.new_empty((B, N, N, R)),
            np_.new_empty((B, 3, N, N)), np_.new_empty((B, 3, N, F)),
            np_.new_empty((R * F + 4 * F * F if weight_grads else 0,)))


def _checked_device(np_):
    if np_.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {np_.device}')
    return np_.device.type == 'cuda'


def pair_interaction_fwd(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b,
                         first_layer=False, dot_dtype='float32'):
    '''The layer's forward: kernel K1 for CUDA tensors, the plain version
    for CPU tensors (the op newtonnet_tpu_torch::pair_fwd). -> (inv1,
    eq).'''
    ins = (np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b)
    check_dot_dtype(dot_dtype)
    if _checked_device(np_):
        _, _, _, _, shapes = _shapes(np_, rbf)
        _check_cuda(list(zip(_NAMES, ins)), shapes)
    return _pair_fwd_op(*ins, bool(first_layer), dot_dtype)


def pair_interaction_bwd(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b,
                         dinv1, deq, first_layer=False, weight_grads=True,
                         dot_dtype='float32'):
    '''The layer's backward: kernel K2 for CUDA tensors, the plain version
    for CPU tensors (the op newtonnet_tpu_torch::pair_bwd). -> (dnp, drbf,
    ddir, dforce, dWe, dW1a, dW1b, dW2a, dW2b), weight cotangents None
    unless weight_grads.'''
    ins = (np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b)
    check_dot_dtype(dot_dtype)
    if _checked_device(np_):
        B, N, F, R, shapes = _shapes(np_, rbf)
        _check_cuda(list(zip(_NAMES + ('dinv1', 'deq'), ins + (dinv1, deq))),
                    shapes + [(B, N, F), (B, 3, N, F)])
    *grads, dw = _pair_bwd_op(*ins, dinv1, deq, bool(first_layer),
                              bool(weight_grads), dot_dtype)
    return (*grads, *split_weight_grads(dw, np_.shape[-1], rbf.shape[-1]))


class FusedPairInteraction(torch.autograd.Function):
    '''The layer as an autograd op: forward K1, backward K2 (plain versions
    on the CPU). Differentiable to first order in np_, rbf, dir_, force and
    the five weights; adj is a mask and gets no gradient.

    apply(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b, first_layer,
          dot_dtype) -> (inv1, eq)'''

    @staticmethod
    def forward(ctx, np_, rbf, dir_, adj, force, We, W1a, W1b, W2a, W2b,
                first_layer=False, dot_dtype='float32'):
        ctx.first_layer = bool(first_layer)
        ctx.dot_dtype = dot_dtype
        ctx.save_for_backward(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a,
                              W2b)
        return pair_interaction_fwd(np_, rbf, dir_, adj, force, We, W1a,
                                     W1b, W2a, W2b,
                                     first_layer=ctx.first_layer,
                                     dot_dtype=dot_dtype)

    @staticmethod
    def backward(ctx, dinv1, deq):
        need_w = ctx.needs_input_grad[5:10]
        grads = pair_interaction_bwd(
            *ctx.saved_tensors, dinv1.contiguous(), deq.contiguous(),
            first_layer=ctx.first_layer, weight_grads=any(need_w),
            dot_dtype=ctx.dot_dtype)
        dnp, drbf, ddir, dforce = grads[:4]
        dws = [g if need else None for g, need in zip(grads[4:], need_w)]
        return (dnp, drbf, ddir, None, dforce, *dws, None, None)


def fused_pair_interaction(np_, rbf, dir_, adj, force, We, W1a, W1b, W2a,
                           W2b, first_layer=False, dot_dtype='float32'):
    '''The layer through FusedPairInteraction (the kernels on the card).
    pair_interaction_fwd_ref, autograd-differentiated, is the same layer as
    plain PyTorch ops on any device.'''
    return FusedPairInteraction.apply(np_, rbf, dir_, adj, force, We, W1a,
                                      W1b, W2a, W2b, first_layer, dot_dtype)

