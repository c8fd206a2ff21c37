'''Fused neighbour-list (K-list) pair-interaction layer and its dual: plain
versions, CUDA wrappers and the autograd Functions.

The layer (the JAX package's `ops/pallas_klist.py`), for B molecules of N
atoms, K list slots, F features and R radial basis functions:

    npi     (B, N, F)      node part of atom i
    cat     (B, N, K, C)   gathered neighbour features [np_j | force_j x|y|z],
                           C = 4F, or C = F at the first layer
    rbf     (B, N, K, R),  dir (B, 3, N, K),  mask (B, N, K) float

    msg  = (rbf @ We) * npi_i * np_j * mask
    inv1 = sum_k msg                                       (B, N, F)
    phi1 = (silu(msg @ W1a) @ W1b) * mask
    phi2 = (silu(msg @ W2a) @ W2b) * mask
    eq[:, d] = sum_k phi1 * dir[:, d] + phi2 * force_j[d]  (B, 3, N, F)

`first_layer=True` (the JAX package's with_force=False) drops phi2: the
stack's first layer sees force == 0. The dual carries a position tangent
(npidot, catdot, rbfdot, dirdot; the weights carry none) and gives
(inv1, eq, inv1dot, eqdot); its backward gives the cotangents of npi,
npidot, cat, catdot and the five weights, and none for the geometry.

Edge tensors (cat, rbf and their tangents) may be bfloat16: the kernels
and the plain versions read them into fp32 and round the per-edge
cotangents (dcat, dcatdot, drbf) to the edge dtype on store, as the JAX
kernels do. The JAX package's K-list kernels compute their products in
model.pallas_dot_dtype. K5-K8 take it as `dot_dtype`: with 'bfloat16'
both operands of every product are rounded to bf16 (`_mk_dot` /
`_mk_dotT` in ops/pallas_klist.py: the chains, the tangent products
beside the primal ones, K6's and K8's cotangent products and their weight
cotangents) and accumulated in fp32, the plain versions as fp32 products
of the rounded operands (fused_dense `_dots`); all elementwise arithmetic
and every sum stays fp32.

On the card the kernels are `csrc/fused_klist.cu`: nn_klist_fwd (K5),
nn_klist_bwd (K6), nn_klist_dual_fwd (K7) and nn_klist_dual_bwd (K8); on
the CPU the wrappers run the plain versions below. All four multiply on
the tensor cores, in fp32 mode in 3xTF32 (each operand split in a TF32
high and low part, three products summed in fp32), which keeps
fp32-level accuracy; in bf16 mode as bf16 `mma.sync` with fp32
accumulation, from a library built for that mode. A CUDA tensor either
launches the kernel or raises: nothing falls back. The
kernels take any F from 1 to `_build.MAX_WIDTH` at its padded width
(`_build.padded_width`) with zero pad lanes of their own: every tensor is
read and written at F, and no edge tensor is copied to another width.
K5 and K6 are torch custom ops (`newtonnet_tpu_torch::klist_fwd`,
`klist_bwd`), as K1/K2 are (ops/fused_dense.py), so that a serving
artifact records and replays them; K7/K8 train and stay ctypes calls.
'''
import ctypes

import torch

from newtonnet_tpu_torch.ops.fused_dense import (
    _dots,
    _dsilu,
    _raise_on,
    _silu,
    _w_flat,
    check_dot_dtype,
    launch_key,
    split_weight_grads,
)
from newtonnet_tpu_torch.ops.fused_dual import _d2silu

# Launches of each kernel variant, counted by its wrapper (bf16 mode under
# the names ending in '_bf16').
LAUNCHES = {'klist_fwd': 0, 'klist_fwd_first': 0,
            'klist_bwd': 0, 'klist_bwd_first': 0,
            'klist_dual_fwd': 0, 'klist_dual_fwd_first': 0,
            'klist_dual_bwd': 0, 'klist_dual_bwd_first': 0,
            'klist_fwd_bf16': 0, 'klist_fwd_first_bf16': 0,
            'klist_bwd_bf16': 0, 'klist_bwd_first_bf16': 0,
            'klist_dual_fwd_bf16': 0, 'klist_dual_fwd_first_bf16': 0,
            'klist_dual_bwd_bf16': 0, 'klist_dual_bwd_first_bf16': 0}
# K6 launches among those that computed the weight cotangents
WEIGHT_GRAD_LAUNCHES = {'klist_bwd': 0, 'klist_bwd_first': 0,
                        'klist_bwd_bf16': 0, 'klist_bwd_first_bf16': 0}
EDGE_DTYPES = (torch.float32, torch.bfloat16)
_TI = 8  # atoms per tile in K6-K8 (csrc/fused_klist.cu: TI)


def reset_launch_counts():
    for counts in (LAUNCHES, WEIGHT_GRAD_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _chain(npi, cat, rbf, mask, weights, first_layer, dot):
    '''The per-slot forward chain, products by `dot`, the rest fp32: npj,
    me, msg and, per branch, (p, h, phi); branch 2 is None at the first
    layer.'''
    We, W1a, W1b, W2a, W2b = weights
    F = npi.shape[-1]
    m = mask[..., None]
    npj = cat[..., :F].to(npi.dtype)
    me = dot(rbf.to(npi.dtype), We)
    msg = me * npi[:, :, None] * npj * m

    def branch(wa, wb):
        p = dot(msg, wa)
        h = _silu(p)
        return p, h, dot(h, wb) * m

    return npj, me, msg, branch(W1a, W1b), \
        None if first_layer else branch(W2a, W2b)


def _forces(cat, npi):
    F = npi.shape[-1]
    return [cat[..., (d + 1) * F:(d + 2) * F].to(npi.dtype)
            for d in range(3)]


def klist_fwd_ref(npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b,
                  first_layer=False, dot_dtype='float32'):
    '''Plain PyTorch forward of the layer -> (inv1 (B,N,F), eq (B,3,N,F)).'''
    dot, _ = _dots(dot_dtype)
    _, _, msg, b1, b2 = _chain(npi, cat, rbf, mask, (We, W1a, W1b, W2a, W2b),
                               first_layer, dot)
    eqs = [(b1[2] * dir_[:, d, ..., None]).sum(2) for d in range(3)]
    if not first_layer:
        fj = _forces(cat, npi)
        eqs = [e + (b2[2] * fj[d]).sum(2) for d, e in enumerate(eqs)]
    return msg.sum(2), torch.stack(eqs, dim=1)


def klist_bwd_ref(npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b, dinv1,
                  deq, first_layer=False, weight_grads=True,
                  dot_dtype='float32'):
    '''Plain PyTorch backward of the layer, written out by hand (the JAX
    package's `_bwd_kernel`), given the cotangents of (inv1, eq). In bf16
    mode every product takes rounded operands.

    Returns (dnpi, dcat, drbf, ddir, dWe, dW1a, dW1b, dW2a, dW2b): dcat and
    drbf in the edge dtype, the rest fp32; the weight cotangents are None
    unless weight_grads, and dW2a, dW2b are zeros at the first layer.'''
    dot, dotT = _dots(dot_dtype)
    m = mask[..., None]
    npj, me, msg, (p1, h1, phi1), b2 = _chain(
        npi, cat, rbf, mask, (We, W1a, W1b, W2a, W2b), first_layer, dot)
    g = [deq[:, d, :, None, :] for d in range(3)]      # (B, N, 1, F)
    dphi1 = sum(g[d] * dir_[:, d, ..., None] for d in range(3)) * m
    ddir = torch.stack([(phi1 * g[d]).sum(-1) for d in range(3)], dim=1)
    dp1 = dot(dphi1, W1b.T) * _dsilu(p1)
    dmsg = dot(dp1, W1a.T)
    dcat_f = []
    if not first_layer:
        p2, h2, phi2 = b2
        fj = _forces(cat, npi)
        dcat_f = [phi2 * g[d] for d in range(3)]
        dphi2 = sum(g[d] * fj[d] for d in range(3)) * m
        dp2 = dot(dphi2, W2b.T) * _dsilu(p2)
        dmsg = dmsg + dot(dp2, W2a.T)
    dmsg3 = (dmsg + dinv1[:, :, None, :]) * m
    ni = npi[:, :, None, :]
    dnpi = (dmsg3 * me * npj).sum(2)
    dcat = torch.cat([dmsg3 * me * ni] + dcat_f, dim=-1).to(cat.dtype)
    dme = dmsg3 * ni * npj
    drbf = dot(dme, We.T).to(rbf.dtype)
    if not weight_grads:
        return dnpi, dcat, drbf, ddir, None, None, None, None, None
    dWe = dotT(rbf.to(npi.dtype), dme)
    dW1a, dW1b = dotT(msg, dp1), dotT(h1, dphi1)
    if first_layer:
        dW2a, dW2b = torch.zeros_like(W2a), torch.zeros_like(W2b)
    else:
        dW2a, dW2b = dotT(msg, dp2), dotT(h2, dphi2)
    return dnpi, dcat, drbf, ddir, dWe, dW1a, dW1b, dW2a, dW2b


def _dual_chain(npi, npidot, cat, catdot, rbf, rbfdot, mask, weights,
                first_layer, dot):
    '''The per-slot primal and tangent chain (the JAX package's
    `_dual_chain`), products by `dot`, the rest fp32: npj, npjdot, me,
    medot, msg, msgdot and, per branch, (p, pdot, h, hdot, phi, phidot).'''
    We, W1a, W1b, W2a, W2b = weights
    F = npi.shape[-1]
    m = mask[..., None]
    npj, npjdot = cat[..., :F].to(npi.dtype), catdot[..., :F].to(npi.dtype)
    me, medot = dot(rbf.to(npi.dtype), We), dot(rbfdot.to(npi.dtype), We)
    ai, aidot = npi[:, :, None], npidot[:, :, None]
    msg = me * ai * npj * m
    msgdot = (medot * ai * npj + me * aidot * npj + me * ai * npjdot) * m

    def branch(wa, wb):
        p, pdot = dot(msg, wa), dot(msgdot, wa)
        h, hdot = _silu(p), _dsilu(p) * pdot
        return p, pdot, h, hdot, dot(h, wb) * m, dot(hdot, wb) * m

    b2 = None if first_layer else branch(W2a, W2b)
    return npj, npjdot, me, medot, msg, msgdot, branch(W1a, W1b), b2


def klist_dual_fwd_ref(npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot,
                       mask, We, W1a, W1b, W2a, W2b, first_layer=False,
                       dot_dtype='float32'):
    '''Plain PyTorch dual forward -> (inv1, eq, inv1dot, eqdot). In bf16
    mode every product takes rounded operands.'''
    dot, _ = _dots(dot_dtype)
    *_, msg, msgdot, b1, b2 = _dual_chain(
        npi, npidot, cat, catdot, rbf, rbfdot, mask,
        (We, W1a, W1b, W2a, W2b), first_layer, dot)
    phi1, phi1dot = b1[4], b1[5]
    fjs, fjdots = _forces(cat, npi), _forces(catdot, npi)
    eq, eqdot = [], []
    for d in range(3):
        dird, dirddot = dir_[:, d, ..., None], dirdot[:, d, ..., None]
        e = (phi1 * dird).sum(2)
        edot = (phi1dot * dird + phi1 * dirddot).sum(2)
        if not first_layer:
            phi2, phi2dot = b2[4], b2[5]
            fj, fjdot = fjs[d], fjdots[d]
            e = e + (phi2 * fj).sum(2)
            edot = edot + (phi2dot * fj + phi2 * fjdot).sum(2)
        eq.append(e)
        eqdot.append(edot)
    return (msg.sum(2), torch.stack(eq, dim=1), msgdot.sum(2),
            torch.stack(eqdot, dim=1))


def klist_dual_bwd_ref(npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot,
                       mask, We, W1a, W1b, W2a, W2b, di, dq, didot, dqdot,
                       first_layer=False, dot_dtype='float32'):
    '''Plain PyTorch reverse of the dual forward, written out by hand (the
    JAX package's `_dual_bwd_kernel`), given the cotangents (di, dq, didot,
    dqdot) of (inv1, eq, inv1dot, eqdot). In bf16 mode every product takes
    rounded operands: the chain, dh, dhdot, dmsg, dmsgdot and the weight
    cotangents.

    Returns (dnpi, dnpidot, dcat, dcatdot, dWe, dW1a, dW1b, dW2a, dW2b):
    dcat and dcatdot in the edge dtype; dW2a, dW2b zeros at the first
    layer.'''
    dot, dotT = _dots(dot_dtype)
    m = mask[..., None]
    npj, npjdot, me, medot, msg, msgdot, b1, b2 = _dual_chain(
        npi, npidot, cat, catdot, rbf, rbfdot, mask,
        (We, W1a, W1b, W2a, W2b), first_layer, dot)
    q = [dq[:, d, :, None, :] for d in range(3)]
    qd = [dqdot[:, d, :, None, :] for d in range(3)]
    dirs = [dir_[:, d, ..., None] for d in range(3)]
    dirdots = [dirdot[:, d, ..., None] for d in range(3)]
    dphi1 = sum(q[d] * dirs[d] + qd[d] * dirdots[d] for d in range(3))
    dphi1dot = sum(qd[d] * dirs[d] for d in range(3))

    def backprop_branch(dphi, dphidot, br, wa, wb):
        p, pdot, h, hdot = br[:4]
        g, gdot = dphi * m, dphidot * m
        dh, dhdot = dot(g, wb.T), dot(gdot, wb.T)
        dwb = dotT(h, g) + dotT(hdot, gdot)
        dp = _dsilu(p) * dh + _d2silu(p) * pdot * dhdot
        dpdot = _dsilu(p) * dhdot
        dwa = dotT(msg, dp) + dotT(msgdot, dpdot)
        return dot(dp, wa.T), dot(dpdot, wa.T), dwa, dwb

    dmsg, dmsgdot, dW1a, dW1b = backprop_branch(dphi1, dphi1dot, b1, W1a, W1b)
    dcat_f, dcatdot_f = [], []
    if first_layer:
        dW2a, dW2b = torch.zeros_like(W2a), torch.zeros_like(W2b)
    else:
        phi2, phi2dot = b2[4], b2[5]
        fj, fjdot = _forces(cat, npi), _forces(catdot, npi)
        dphi2 = sum(q[d] * fj[d] + qd[d] * fjdot[d] for d in range(3))
        dphi2dot = sum(qd[d] * fj[d] for d in range(3))
        dcat_f = [phi2 * q[d] + phi2dot * qd[d] for d in range(3)]
        dcatdot_f = [phi2 * qd[d] for d in range(3)]
        dm2, dm2dot, dW2a, dW2b = backprop_branch(dphi2, dphi2dot, b2, W2a,
                                                  W2b)
        dmsg, dmsgdot = dmsg + dm2, dmsgdot + dm2dot
    t = (dmsg + di[:, :, None, :]) * m
    tdot = (dmsgdot + didot[:, :, None, :]) * m
    ai, aidot = npi[:, :, None], npidot[:, :, None]
    dme = t * ai * npj + tdot * (aidot * npj + ai * npjdot)
    dmedot = tdot * ai * npj
    dnpi = (t * me * npj + tdot * (medot * npj + me * npjdot)).sum(2)
    dnpidot = (tdot * me * npj).sum(2)
    dcat = torch.cat([t * me * ai + tdot * (medot * ai + me * aidot)]
                     + dcat_f, dim=-1).to(cat.dtype)
    dcatdot = torch.cat([tdot * me * ai] + dcatdot_f,
                        dim=-1).to(catdot.dtype)
    dWe = dotT(rbf.to(npi.dtype), dme) + dotT(rbfdot.to(npi.dtype), dmedot)
    return dnpi, dnpidot, dcat, dcatdot, dWe, dW1a, dW1b, dW2a, dW2b


# ----------------------------------------------------------------------- #
def _lib(F, dot_dtype='float32'):
    from newtonnet_tpu_torch.ops import _build
    lib = _build.load('fused_klist', F, dot_dtype)
    if not getattr(lib, '_nn_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn_klist_fwd.argtypes = [p] * 13 + [i] * 8 + [p]
        lib.nn_klist_bwd.argtypes = [p] * 19 + [i] * 9 + [p]
        lib.nn_klist_dual_fwd.argtypes = [p] * 19 + [i] * 7 + [p]
        lib.nn_klist_dual_bwd.argtypes = [p] * 24 + [i] * 8 + [p]
        for fn in (lib.nn_klist_fwd, lib.nn_klist_bwd, lib.nn_klist_dual_fwd,
                   lib.nn_klist_dual_bwd):
            fn.restype = i
        for fn in (lib.nn_klist_smem_bytes, lib.nn_klist_scratch_floats,
                   lib.nn_klist_wpart_floats):
            fn.argtypes = [i] * 3
            fn.restype = ctypes.c_size_t
        lib._nn_typed = True
    return lib


def smem_bytes(F, R, kind):
    '''Dynamic shared memory of one block of K5 ('fwd'), K6 ('bwd'), K7
    ('dual_fwd') or K8 ('dual_bwd'), as the CUDA source computes it.'''
    kinds = ('fwd', 'bwd', 'dual_fwd', 'dual_bwd')
    return _lib(F).nn_klist_smem_bytes(F, R, kinds.index(kind))


def _checked(npi, cat, rbf, named, first_layer):
    '''(B, N, K, F, R, bf16) after the device, dtype, shape and contiguity
    checks of a launch. `named` lists (name, tensor, kind); kinds 'cat' and
    'rbf' take the edge dtype (cat's), the others fp32.'''
    B, N, F = npi.shape
    K, R = cat.shape[2], rbf.shape[-1]
    C = F if first_layer else 4 * F
    from newtonnet_tpu_torch.ops import _build
    _build.padded_width(F)  # refuses a width the kernels do not take
    if B * N * K == 0:
        raise ValueError(f'empty batch: B={B}, N={N}, K={K}')
    edt = cat.dtype
    if edt not in EDGE_DTYPES:
        raise TypeError(f'edge tensors must be one of {EDGE_DTYPES}, got '
                        f'{edt}')
    shapes = {'node': (B, N, F), 'vec': (B, 3, N, F), 'cat': (B, N, K, C),
              'rbf': (B, N, K, R), 'dir': (B, 3, N, K), 'mask': (B, N, K),
              'We': (R, F), 'W': (F, F)}
    for name, t, kind in named:
        if t.device != npi.device:
            raise ValueError(f'{name} is on {t.device}, expected '
                             f'{npi.device}')
        want = edt if kind in ('cat', 'rbf') else torch.float32
        if t.dtype != want:
            raise TypeError(f'{name} must be {want}, got {t.dtype}')
        if tuple(t.shape) != shapes[kind]:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                             f'{shapes[kind]}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return B, N, K, F, R, int(edt == torch.bfloat16)


_KINDS = ('node', 'cat', 'rbf', 'dir', 'mask', 'We', 'W', 'W', 'W', 'W')
_NAMES = ('npi', 'cat', 'rbf', 'dir_', 'mask', 'We', 'W1a', 'W1b', 'W2a',
          'W2b')
_DUAL_KINDS = ('node', 'node', 'cat', 'cat', 'rbf', 'rbf', 'dir', 'dir',
               'mask', 'We', 'W', 'W', 'W', 'W')
_DUAL_NAMES = ('npi', 'npidot', 'cat', 'catdot', 'rbf', 'rbfdot', 'dir_',
               'dirdot', 'mask', 'We', 'W1a', 'W1b', 'W2a', 'W2b')


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _n_blocks(B, N, device):
    '''The grid of K6 and K8: one block per SM at most, each walking atom
    tiles and summing them into one weight partial.'''
    return min(B * ((N + _TI - 1) // _TI), _sms(device))


def _device(t):
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {t.device}')
    return t.device.type


@torch.library.custom_op('newtonnet_tpu_torch::klist_fwd', mutates_args=())
def _klist_fwd_op(npi: torch.Tensor, cat: torch.Tensor, rbf: torch.Tensor,
                  dir_: torch.Tensor, mask: torch.Tensor, We: torch.Tensor,
                  W1a: torch.Tensor, W1b: torch.Tensor, W2a: torch.Tensor,
                  W2b: torch.Tensor, first_layer: bool,
                  dot_dtype: str) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors (checked by klist_fwd), the plain version on CPU
    ones. -> (inv1, eq)."""
    ins = (npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b)
    if npi.device.type == 'cpu':
        inv1, eq = klist_fwd_ref(*ins, first_layer=first_layer,
                                 dot_dtype=dot_dtype)
        return inv1.contiguous(), eq.contiguous()
    B, N, F = npi.shape
    K, R = cat.shape[2], rbf.shape[-1]
    opts = dict(device=npi.device, dtype=torch.float32)
    outs = (torch.empty((B, N, F), **opts), torch.empty((B, 3, N, F), **opts))
    lib = _lib(F, dot_dtype)
    # the weights prepared (tf32 (hi, lo) pairs, or bf16), once per launch;
    # at most one block per SM, each walking atom tiles
    scratch = torch.empty((lib.nn_klist_scratch_floats(F, R, 0),), **opts)
    err = lib.nn_klist_fwd(*[t.data_ptr() for t in ins + outs + (scratch,)],
                           B, N, K, F, R, int(first_layer),
                           int(cat.dtype == torch.bfloat16),
                           _sms(npi.device), _stream(npi))
    _raise_on(err, 'nn_klist_fwd')
    LAUNCHES[launch_key('klist_fwd', first_layer, dot_dtype)] += 1
    return outs


@_klist_fwd_op.register_fake
def _(npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b, first_layer,
      dot_dtype):
    B, N, F = npi.shape
    return npi.new_empty((B, N, F)), npi.new_empty((B, 3, N, F))


@torch.library.custom_op('newtonnet_tpu_torch::klist_bwd', mutates_args=())
def _klist_bwd_op(npi: torch.Tensor, cat: torch.Tensor, rbf: torch.Tensor,
                  dir_: torch.Tensor, mask: torch.Tensor, We: torch.Tensor,
                  W1a: torch.Tensor, W1b: torch.Tensor, W2a: torch.Tensor,
                  W2b: torch.Tensor, dinv1: torch.Tensor, deq: torch.Tensor,
                  first_layer: bool, weight_grads: bool, dot_dtype: str
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """K6 on CUDA tensors (checked by klist_bwd), the plain version on CPU
    ones. -> (dnpi, dcat, drbf, ddir, dw): dw the five weight cotangents
    flat (R*F + 4*F*F,), or empty without weight_grads."""
    ins = (npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b)
    if npi.device.type == 'cpu':
        grads = klist_bwd_ref(*ins, dinv1, deq, first_layer=first_layer,
                              weight_grads=weight_grads, dot_dtype=dot_dtype)
        return (*[g.contiguous() for g in grads[:4]],
                _w_flat(grads[4:]).to(npi.dtype))
    B, N, F = npi.shape
    K, R = cat.shape[2], rbf.shape[-1]
    opts = dict(device=npi.device, dtype=torch.float32)
    outs = (torch.empty((B, N, F), **opts), torch.empty_like(cat),
            torch.empty_like(rbf), torch.empty((B, 3, N, K), **opts))
    lib = _lib(F, dot_dtype)
    n_blocks = _n_blocks(B, N, npi.device)
    # one weight partial per block, at the kernels' padded width
    wpart = (torch.empty((lib.nn_klist_wpart_floats(n_blocks, F, R),),
                         **opts) if weight_grads else None)
    dw = torch.empty((R * F + 4 * F * F if weight_grads else 0,), **opts)
    # the weights prepared (tf32 (hi, lo) pairs, or bf16), once per launch
    scratch = torch.empty((lib.nn_klist_scratch_floats(F, R, 1),), **opts)
    err = lib.nn_klist_bwd(
        *[t.data_ptr() for t in ins + (dinv1, deq) + outs],
        wpart.data_ptr() if weight_grads else None,
        dw.data_ptr() if weight_grads else None, scratch.data_ptr(),
        B, N, K, F, R, int(first_layer), int(weight_grads),
        int(cat.dtype == torch.bfloat16), n_blocks, _stream(npi))
    _raise_on(err, 'nn_klist_bwd')
    key = launch_key('klist_bwd', first_layer, dot_dtype)
    LAUNCHES[key] += 1
    if weight_grads:
        WEIGHT_GRAD_LAUNCHES[key] += 1
    return (*outs, dw)


@_klist_bwd_op.register_fake
def _(npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b, dinv1, deq,
      first_layer, weight_grads, dot_dtype):
    B, N, F = npi.shape
    K, R = cat.shape[2], rbf.shape[-1]
    return (npi.new_empty((B, N, F)), torch.empty_like(cat),
            torch.empty_like(rbf), npi.new_empty((B, 3, N, K)),
            npi.new_empty((R * F + 4 * F * F if weight_grads else 0,)))


def klist_fwd(npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b,
              first_layer=False, dot_dtype='float32'):
    '''The layer's forward: kernel K5 for CUDA tensors, the plain version
    for CPU tensors (the op newtonnet_tpu_torch::klist_fwd). -> (inv1,
    eq).'''
    ins = (npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b)
    check_dot_dtype(dot_dtype)
    if _device(npi) == 'cuda':
        _checked(npi, cat, rbf, list(zip(_NAMES, ins, _KINDS)), first_layer)
    return _klist_fwd_op(*ins, bool(first_layer), dot_dtype)


def klist_bwd(npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b, dinv1, deq,
              first_layer=False, weight_grads=True, dot_dtype='float32'):
    '''The layer's backward: kernel K6 for CUDA tensors, the plain version
    for CPU tensors (the op newtonnet_tpu_torch::klist_bwd). -> (dnpi,
    dcat, drbf, ddir, dWe, dW1a, dW1b, dW2a, dW2b), weight cotangents None
    unless weight_grads.'''
    ins = (npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b)
    check_dot_dtype(dot_dtype)
    if _device(npi) == 'cuda':
        _checked(npi, cat, rbf,
                 list(zip(_NAMES + ('dinv1', 'deq'), ins + (dinv1, deq),
                          _KINDS + ('node', 'vec'))), first_layer)
    *grads, dw = _klist_bwd_op(*ins, dinv1, deq, bool(first_layer),
                               bool(weight_grads), dot_dtype)
    return (*grads, *split_weight_grads(dw, npi.shape[-1], rbf.shape[-1]))


def klist_dual_fwd(npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot, mask,
                   We, W1a, W1b, W2a, W2b, first_layer=False,
                   dot_dtype='float32'):
    '''The dual forward: kernel K7 for CUDA tensors, the plain version for
    CPU tensors. -> (inv1, eq, inv1dot, eqdot).'''
    ins = (npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot, mask, We,
           W1a, W1b, W2a, W2b)
    check_dot_dtype(dot_dtype)
    if _device(npi) == 'cpu':
        return klist_dual_fwd_ref(*ins, first_layer=first_layer,
                                  dot_dtype=dot_dtype)
    B, N, K, F, R, bf = _checked(npi, cat, rbf,
                                 list(zip(_DUAL_NAMES, ins, _DUAL_KINDS)),
                                 first_layer)
    opts = dict(device=npi.device, dtype=torch.float32)
    outs = (torch.empty((B, N, F), **opts), torch.empty((B, 3, N, F), **opts),
            torch.empty((B, N, F), **opts), torch.empty((B, 3, N, F), **opts))
    lib = _lib(F, dot_dtype)
    # the weights prepared (tf32 (hi, lo) pairs, or bf16), once per launch
    scratch = torch.empty((lib.nn_klist_scratch_floats(F, R, 2),), **opts)
    err = lib.nn_klist_dual_fwd(*[t.data_ptr() for t in ins + outs],
                                scratch.data_ptr(), B, N, K, F, R,
                                int(first_layer), bf, _stream(npi))
    _raise_on(err, 'nn_klist_dual_fwd')
    LAUNCHES[launch_key('klist_dual_fwd', first_layer, dot_dtype)] += 1
    return outs


def klist_dual_bwd(npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot, mask,
                   We, W1a, W1b, W2a, W2b, di, dq, didot, dqdot,
                   first_layer=False, dot_dtype='float32'):
    '''The dual backward: kernel K8 for CUDA tensors, the plain version for
    CPU tensors. -> (dnpi, dnpidot, dcat, dcatdot, dWe, dW1a, dW1b, dW2a,
    dW2b).'''
    ins = (npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot, mask, We,
           W1a, W1b, W2a, W2b)
    cots = (di, dq, didot, dqdot)
    check_dot_dtype(dot_dtype)
    if _device(npi) == 'cpu':
        return klist_dual_bwd_ref(*ins, *cots, first_layer=first_layer,
                                  dot_dtype=dot_dtype)
    named = list(zip(_DUAL_NAMES + ('di', 'dq', 'didot', 'dqdot'),
                     ins + cots, _DUAL_KINDS + ('node', 'vec', 'node', 'vec')))
    B, N, K, F, R, bf = _checked(npi, cat, rbf, named, first_layer)
    for name, w in zip(_DUAL_NAMES[9:], ins[9:]):
        if w.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned (cp.async)')
    opts = dict(device=npi.device, dtype=torch.float32)
    outs = (torch.empty((B, N, F), **opts), torch.empty((B, N, F), **opts),
            torch.empty_like(cat), torch.empty_like(catdot))
    n_w = R * F + 4 * F * F
    lib = _lib(F, dot_dtype)
    n_blocks = _n_blocks(B, N, npi.device)
    # one weight partial per block at the kernels' padded width and the
    # weights prepared for the products (bf16), or, where F is not the
    # padded width, padded to it (fp32)
    wpart = torch.empty((lib.nn_klist_wpart_floats(n_blocks, F, R),), **opts)
    dw = torch.empty((n_w,), **opts)
    err = lib.nn_klist_dual_bwd(
        *[t.data_ptr() for t in ins + cots + outs + (wpart, dw)], B, N, K, F,
        R, int(first_layer), bf, n_blocks, _stream(npi))
    _raise_on(err, 'nn_klist_dual_bwd')
    LAUNCHES[launch_key('klist_dual_bwd', first_layer, dot_dtype)] += 1
    return (*outs, *split_weight_grads(dw, F, R))


# ----------------------------------------------------------------------- #
class FusedKlistInteraction(torch.autograd.Function):
    '''The layer as an autograd op: forward K5, backward K6 (the plain
    versions on the CPU, or everywhere with plain=True). Differentiable to
    first order in npi, cat, rbf, dir_ and the five weights; mask gets no
    gradient. K6 computes the weight cotangents only when a weight needs
    one (the force pass holds the parameters constant).

    apply(npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b, first_layer,
          plain, dot_dtype) -> (inv1, eq)'''

    @staticmethod
    def forward(ctx, npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b,
                first_layer=False, plain=False, dot_dtype='float32'):
        ctx.first_layer, ctx.plain = bool(first_layer), bool(plain)
        ctx.dot_dtype = dot_dtype
        ins = (npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a, W2b)
        ctx.save_for_backward(*ins)
        fwd = klist_fwd_ref if plain else klist_fwd
        return fwd(*ins, first_layer=ctx.first_layer, dot_dtype=dot_dtype)

    @staticmethod
    def backward(ctx, dinv1, deq):
        need_w = ctx.needs_input_grad[5:10]
        bwd = klist_bwd_ref if ctx.plain else klist_bwd
        grads = bwd(*ctx.saved_tensors, dinv1.contiguous(), deq.contiguous(),
                    first_layer=ctx.first_layer, weight_grads=any(need_w),
                    dot_dtype=ctx.dot_dtype)
        dws = [g if need else None for g, need in zip(grads[4:], need_w)]
        return (*grads[:4], None, *dws, None, None, None)


class FusedKlistInteractionDual(torch.autograd.Function):
    '''The dual layer as an autograd op: forward K7, backward K8 (the plain
    versions on the CPU, or everywhere with plain=True). Its backward gives
    the cotangents of npi, npidot, cat, catdot and the five weights, and
    None for rbf, rbfdot, dir_, dirdot and mask, as the JAX package's custom
    VJP gives zeros there.

    apply(npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot, mask, We,
          W1a, W1b, W2a, W2b, first_layer, plain, dot_dtype) -> (inv1, eq,
          inv1dot, eqdot)'''

    @staticmethod
    def forward(ctx, npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot,
                mask, We, W1a, W1b, W2a, W2b, first_layer=False, plain=False,
                dot_dtype='float32'):
        ctx.first_layer, ctx.plain = bool(first_layer), bool(plain)
        ctx.dot_dtype = dot_dtype
        ins = (npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot, mask, We,
               W1a, W1b, W2a, W2b)
        ctx.save_for_backward(*ins)
        fwd = klist_dual_fwd_ref if plain else klist_dual_fwd
        return fwd(*ins, first_layer=ctx.first_layer, dot_dtype=dot_dtype)

    @staticmethod
    def backward(ctx, di, dq, didot, dqdot):
        bwd = klist_dual_bwd_ref if ctx.plain else klist_dual_bwd
        dnpi, dnpidot, dcat, dcatdot, *dws = bwd(
            *ctx.saved_tensors, di.contiguous(), dq.contiguous(),
            didot.contiguous(), dqdot.contiguous(),
            first_layer=ctx.first_layer, dot_dtype=ctx.dot_dtype)
        return (dnpi, dnpidot, dcat, dcatdot, None, None, None, None, None,
                *dws, None, None, None)


def fused_klist_interaction(npi, cat, rbf, dir_, mask, We, W1a, W1b, W2a,
                            W2b, first_layer=False, plain=False,
                            dot_dtype='float32'):
    '''The layer through FusedKlistInteraction: K5/K6 on the card, or with
    plain=True the plain versions on any device.'''
    return FusedKlistInteraction.apply(npi, cat, rbf, dir_, mask, We, W1a,
                                       W1b, W2a, W2b, first_layer, plain,
                                       dot_dtype)


def fused_klist_interaction_dual(npi, npidot, cat, catdot, rbf, rbfdot, dir_,
                                 dirdot, mask, We, W1a, W1b, W2a, W2b,
                                 first_layer=False, plain=False,
                                 dot_dtype='float32'):
    '''The dual layer through FusedKlistInteractionDual: K7/K8 on the card,
    or with plain=True the plain versions on any device.'''
    return FusedKlistInteractionDual.apply(
        npi, npidot, cat, catdot, rbf, rbfdot, dir_, dirdot, mask, We, W1a,
        W1b, W2a, W2b, first_layer, plain, dot_dtype)
