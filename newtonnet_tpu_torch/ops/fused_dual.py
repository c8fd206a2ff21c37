'''Dual (primal + position tangent) fused pair-interaction layer: plain
versions, CUDA wrappers and the autograd Function.

The layer of ops/fused_dense.py carried with a tangent (the JAX package's
`make_fused_pair_interaction_dual`, ops/pallas_dense.py:247-577). Inputs
np_, rbf, dir_ and force come with tangents npdot, rbfdot, dirdot and
forcedot; the weights carry none. Per pair slot (i, j):

    me    = rbf @ We,  medot = rbfdot @ We
    msg   = me * np_i * np_j * adj
    msgdot = (medot np_i np_j + me npdot_i np_j + me np_i npdot_j) * adj
    p = msg @ Wa,  pdot = msgdot @ Wa,  h = silu(p),  hdot = silu'(p) pdot
    phi = (h @ Wb) * adj,  phidot = (hdot @ Wb) * adj       (branches 1, 2)
    inv1 = sum_j msg,  inv1dot = sum_j msgdot
    eq[d]    = sum_j phi1 dir[d] + phi2 force_j[d]
    eqdot[d] = sum_j phi1dot dir[d] + phi1 dirdot[d]
                   + phi2dot force_j[d] + phi2 forcedot_j[d]

`first_layer=True` drops phi2 and every npdot term: at the stack's first
layer force, forcedot and npdot are zero. The backward gives the
cotangents of np_, npdot, force, forcedot and the five weights only; rbf,
dir and their tangents get none (this op backs the parameter-gradient
surrogate of train/fastgrad.py, where the geometry is constant).

`dot_dtype='bfloat16'` rounds every operand of every matrix product to
bf16 and accumulates in fp32, exactly where the JAX package does
(`_dual_chain`'s and `_dual_bwd_kernel`'s `dot`/`dotT`); the elementwise
arithmetic stays fp32. The plain version computes such a product as
`a.bfloat16().float() @ b.bfloat16().float()`: a product of two bf16
values is exact in fp32, so only the summation order is left to differ.

On the card the forward runs `csrc/fused_dual.cu:nn_dual_fwd` (K3) and the
backward `nn_dual_bwd` (K4); on the CPU the wrappers run the plain
versions below. A CUDA tensor either launches the kernel or raises.
'''
import ctypes

import torch

from newtonnet_tpu_torch.ops.fused_dense import (
    DOT_DTYPES,
    _check_cuda,
    _dots,
    _dsilu,
    _raise_on,
    _silu,
)

# Launches of each kernel variant, counted by its wrapper.
LAUNCHES = {'dual_fwd': 0, 'dual_fwd_first': 0,
            'dual_bwd': 0, 'dual_bwd_first': 0}


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _d2silu(x):
    s = torch.sigmoid(x)
    return s * (1.0 - s) * (2.0 + x * (1.0 - 2.0 * s))


def _chain(np_, npdot, rbf, rbfdot, adj4, weights, dot, first_layer):
    '''The per-slot dual chain: me, medot, msg, msgdot and, per branch,
    (p, pdot, h, hdot, phi, phidot); branch 2 is None at the first layer.'''
    We, W1a, W1b, W2a, W2b = weights
    ai, aj = np_[:, :, None, :], np_[:, None, :, :]
    me, medot = dot(rbf, We), dot(rbfdot, We)
    msg = me * ai * aj * adj4
    if first_layer:
        msgdot = medot * ai * aj * adj4
    else:
        msgdot = (medot * ai * aj + me * npdot[:, :, None, :] * aj
                  + me * ai * npdot[:, None, :, :]) * adj4

    def branch(wa, wb):
        p, pdot = dot(msg, wa), dot(msgdot, wa)
        h, hdot = _silu(p), _dsilu(p) * pdot
        return p, pdot, h, hdot, dot(h, wb) * adj4, dot(hdot, wb) * adj4

    b2 = None if first_layer else branch(W2a, W2b)
    return me, medot, msg, msgdot, branch(W1a, W1b), b2


def pair_interaction_dual_fwd_ref(np_, npdot, rbf, rbfdot, dir_, dirdot, adj,
                                  force, forcedot, We, W1a, W1b, W2a, W2b,
                                  first_layer=False, dot_dtype='bfloat16'):
    '''Plain PyTorch dual forward -> (inv1, eq, inv1dot, eqdot).'''
    dot, _ = _dots(dot_dtype)
    adj4 = adj[..., None]
    _, _, msg, msgdot, b1, b2 = _chain(np_, npdot, rbf, rbfdot, adj4,
                                       (We, W1a, W1b, W2a, W2b), dot,
                                       first_layer)
    phi1, phi1dot = b1[4], b1[5]
    eq, eqdot = [], []
    for d in range(3):
        dir_d, dirdot_d = dir_[:, d, :, :, None], dirdot[:, d, :, :, None]
        e = (phi1 * dir_d).sum(2)
        edot = (phi1dot * dir_d + phi1 * dirdot_d).sum(2)
        if not first_layer:
            phi2, phi2dot = b2[4], b2[5]
            fj, fjdot = force[:, d, None, :, :], forcedot[:, d, None, :, :]
            e = e + (phi2 * fj).sum(2)
            edot = edot + (phi2dot * fj + phi2 * fjdot).sum(2)
        eq.append(e)
        eqdot.append(edot)
    return (msg.sum(2), torch.stack(eq, dim=1), msgdot.sum(2),
            torch.stack(eqdot, dim=1))


def pair_interaction_dual_bwd_ref(np_, npdot, rbf, rbfdot, dir_, dirdot, adj,
                                  force, forcedot, We, W1a, W1b, W2a, W2b,
                                  di, dq, didot, dqdot, first_layer=False,
                                  dot_dtype='bfloat16'):
    '''Plain PyTorch reverse of the dual forward, written out by hand (the
    JAX package's `_dual_bwd_kernel`), given the cotangents (di, dq, didot,
    dqdot) of (inv1, eq, inv1dot, eqdot).

    Returns (dnp, dnpdot, dforce, dforcedot, dWe, dW1a, dW1b, dW2a, dW2b).
    At the first layer dnpdot, dforce, dforcedot, dW2a and dW2b are zeros.'''
    dot, dotT = _dots(dot_dtype)
    adj4 = adj[..., None]
    me, medot, msg, msgdot, b1, b2 = _chain(np_, npdot, rbf, rbfdot, adj4,
                                            (We, W1a, W1b, W2a, W2b), dot,
                                            first_layer)
    dq5, dqdot5 = dq[:, :, :, None, :], dqdot[:, :, :, None, :]
    dphi1 = sum(dq5[:, d] * dir_[:, d, :, :, None]
                + dqdot5[:, d] * dirdot[:, d, :, :, None] for d in range(3))
    dphi1dot = sum(dqdot5[:, d] * dir_[:, d, :, :, None] for d in range(3))

    def backprop_branch(dphi, dphidot, br, wa, wb):
        p, pdot, h, hdot = br[:4]
        g, gdot = dphi * adj4, dphidot * adj4
        dh, dhdot = dot(g, wb.T), dot(gdot, wb.T)
        dwb = dotT(h, g) + dotT(hdot, gdot)
        dp = _dsilu(p) * dh + _d2silu(p) * pdot * dhdot
        dpdot = _dsilu(p) * dhdot
        dwa = dotT(msg, dp) + dotT(msgdot, dpdot)
        return dot(dp, wa.T), dot(dpdot, wa.T), dwa, dwb

    dmsg, dmsgdot, dW1a, dW1b = backprop_branch(dphi1, dphi1dot, b1, W1a, W1b)
    if first_layer:
        dforce = torch.zeros_like(force)
        dforcedot = torch.zeros_like(forcedot)
        dW2a, dW2b = torch.zeros_like(W2a), torch.zeros_like(W2b)
    else:
        phi2, phi2dot = b2[4], b2[5]
        fj = [force[:, d, None, :, :] for d in range(3)]
        fjdot = [forcedot[:, d, None, :, :] for d in range(3)]
        dphi2 = sum(dq5[:, d] * fj[d] + dqdot5[:, d] * fjdot[d]
                    for d in range(3))
        dphi2dot = sum(dqdot5[:, d] * fj[d] for d in range(3))
        dforce = torch.stack([(phi2 * dq5[:, d] + phi2dot * dqdot5[:, d])
                              .sum(1) for d in range(3)], dim=1)
        dforcedot = torch.stack([(phi2 * dqdot5[:, d]).sum(1)
                                 for d in range(3)], dim=1)
        dm2, dm2dot, dW2a, dW2b = backprop_branch(dphi2, dphi2dot, b2, W2a,
                                                  W2b)
        dmsg, dmsgdot = dmsg + dm2, dmsgdot + dm2dot
    t = (dmsg + di[:, :, None, :]) * adj4
    tdot = (dmsgdot + didot[:, :, None, :]) * adj4
    ai, aj = np_[:, :, None, :], np_[:, None, :, :]
    dmedot = tdot * ai * aj
    if first_layer:
        dme = t * ai * aj
        dnp = ((t * me * aj + tdot * medot * aj).sum(2)
               + (t * me * ai + tdot * medot * ai).sum(1))
        dnpdot = torch.zeros_like(npdot)
    else:
        aidot, ajdot = npdot[:, :, None, :], npdot[:, None, :, :]
        dme = t * ai * aj + tdot * (aidot * aj + ai * ajdot)
        dnp = ((t * me * aj + tdot * (medot * aj + me * ajdot)).sum(2)
               + (t * me * ai + tdot * (medot * ai + me * aidot)).sum(1))
        dnpdot = (tdot * me * aj).sum(2) + (tdot * me * ai).sum(1)
    dWe = dotT(rbf, dme) + dotT(rbfdot, dmedot)
    return dnp, dnpdot, dforce, dforcedot, dWe, dW1a, dW1b, dW2a, dW2b


# ----------------------------------------------------------------------- #
def _lib(F):
    from newtonnet_tpu_torch.ops import _build
    lib = _build.load('fused_dual', F)
    if not getattr(lib, '_nn_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn_dual_fwd.argtypes = [p] * 19 + [i] * 6 + [p]
        lib.nn_dual_fwd.restype = i
        lib.nn_dual_bwd.argtypes = [p] * 24 + [i] * 6 + [p]
        lib.nn_dual_bwd.restype = i
        lib.nn_dual_smem_bytes.argtypes = [i] * 4
        lib.nn_dual_smem_bytes.restype = ctypes.c_size_t
        lib.nn_dual_scratch_floats.argtypes = [i] * 5
        lib.nn_dual_scratch_floats.restype = ctypes.c_size_t
        lib._nn_typed = True
    return lib


def smem_bytes(F, R, kind, dot_dtype='bfloat16'):
    '''Dynamic shared memory of one block of K3 (kind 'fwd') or K4 ('bwd')
    in the given dot mode, as the CUDA source computes it (builds the
    source if needed).'''
    return _lib(F).nn_dual_smem_bytes(F, R, int(kind == 'bwd'),
                                      int(dot_dtype == 'bfloat16'))


def _scratch(B, N, F, R, kind, device):
    '''The scratch of one K3 (kind 'fwd') or K4 ('bwd') launch, sized by
    the CUDA source (csrc/fused_dual.cu: nn_dual_scratch_floats).'''
    n = _lib(F).nn_dual_scratch_floats(B, N, F, R, int(kind == 'bwd'))
    return torch.empty((n,), device=device, dtype=torch.float32)


_NAMES = ('np_', 'npdot', 'rbf', 'rbfdot', 'dir_', 'dirdot', 'adj', 'force',
          'forcedot', 'We', 'W1a', 'W1b', 'W2a', 'W2b')


def _checked(ins, dot_dtype, cots=()):
    '''(B, N, F, R) after the device, dtype, shape and contiguity checks of
    a launch.'''
    if dot_dtype not in DOT_DTYPES:
        raise ValueError(f'dot_dtype must be one of {DOT_DTYPES}, got '
                         f'{dot_dtype!r}')
    from newtonnet_tpu_torch.ops import _build
    B, N, F = ins[0].shape
    R = ins[2].shape[-1]
    _build.padded_width(F)  # refuses a width the kernels do not take
    if B * N == 0:
        raise ValueError(f'empty batch: B={B}, N={N}')
    node, pair, vec = (B, N, F), (B, N, N, R), (B, 3, N, F)
    shapes = [node, node, pair, pair, (B, 3, N, N), (B, 3, N, N), (B, N, N),
              vec, vec, (R, F)] + [(F, F)] * 4
    names = _NAMES + ('di', 'dq', 'didot', 'dqdot')[:len(cots)]
    _check_cuda(list(zip(names, ins + tuple(cots))),
                shapes + [node, vec, node, vec][:len(cots)])
    return B, N, F, R


def pair_interaction_dual_fwd(np_, npdot, rbf, rbfdot, dir_, dirdot, adj,
                              force, forcedot, We, W1a, W1b, W2a, W2b,
                              first_layer=False, dot_dtype='bfloat16'):
    '''The dual forward: kernel K3 for CUDA tensors, the plain version for
    CPU tensors. -> (inv1, eq, inv1dot, eqdot).'''
    ins = (np_, npdot, rbf, rbfdot, dir_, dirdot, adj, force, forcedot, We,
           W1a, W1b, W2a, W2b)
    if np_.device.type == 'cpu':
        return pair_interaction_dual_fwd_ref(*ins, first_layer=first_layer,
                                             dot_dtype=dot_dtype)
    if np_.device.type != 'cuda':
        raise ValueError(f'no kernel for device {np_.device}')
    B, N, F, R = _checked(ins, dot_dtype)
    opts = dict(device=np_.device, dtype=torch.float32)
    outs = (torch.empty((B, N, F), **opts), torch.empty((B, 3, N, F), **opts),
            torch.empty((B, N, F), **opts), torch.empty((B, 3, N, F), **opts))
    scratch = _scratch(B, N, F, R, 'fwd', np_.device)
    err = _lib(F).nn_dual_fwd(
        *[t.data_ptr() for t in ins + outs + (scratch,)], B, N, F, R,
        int(first_layer), int(dot_dtype == 'bfloat16'),
        torch.cuda.current_stream(np_.device).cuda_stream)
    _raise_on(err, 'nn_dual_fwd')
    LAUNCHES['dual_fwd_first' if first_layer else 'dual_fwd'] += 1
    return outs


def pair_interaction_dual_bwd(np_, npdot, rbf, rbfdot, dir_, dirdot, adj,
                              force, forcedot, We, W1a, W1b, W2a, W2b, di, dq,
                              didot, dqdot, first_layer=False,
                              dot_dtype='bfloat16'):
    '''The dual backward: kernel K4 for CUDA tensors, the plain version for
    CPU tensors. -> (dnp, dnpdot, dforce, dforcedot, dWe, dW1a, dW1b, dW2a,
    dW2b).'''
    ins = (np_, npdot, rbf, rbfdot, dir_, dirdot, adj, force, forcedot, We,
           W1a, W1b, W2a, W2b)
    cots = (di, dq, didot, dqdot)
    if np_.device.type == 'cpu':
        return pair_interaction_dual_bwd_ref(*ins, *cots,
                                             first_layer=first_layer,
                                             dot_dtype=dot_dtype)
    if np_.device.type != 'cuda':
        raise ValueError(f'no kernel for device {np_.device}')
    B, N, F, R = _checked(ins, dot_dtype, cots)
    opts = dict(device=np_.device, dtype=torch.float32)
    outs = (torch.empty((B, N, F), **opts), torch.empty((B, N, F), **opts),
            torch.empty((B, 3, N, F), **opts),
            torch.empty((B, 3, N, F), **opts))
    dw = torch.empty((R * F + 4 * F * F,), **opts)
    scratch = _scratch(B, N, F, R, 'bwd', np_.device)
    err = _lib(F).nn_dual_bwd(
        *[t.data_ptr() for t in ins + cots + outs + (dw, scratch)],
        B, N, F, R, int(first_layer), int(dot_dtype == 'bfloat16'),
        torch.cuda.current_stream(np_.device).cuda_stream)
    _raise_on(err, 'nn_dual_bwd')
    LAUNCHES['dual_bwd_first' if first_layer else 'dual_bwd'] += 1
    shapes_w = [(R, F)] + [(F, F)] * 4
    return (*outs, *[v.view(s) for v, s in
                     zip(dw.split([R * F] + [F * F] * 4), shapes_w)])


class FusedPairInteractionDual(torch.autograd.Function):
    '''The dual layer as an autograd op: forward K3, backward K4 (plain
    versions on the CPU, or everywhere with plain=True). Its backward
    returns the cotangents of np_, npdot, force, forcedot and the five
    weights, and None for rbf, rbfdot, dir_, dirdot and adj, as the JAX
    package's custom VJP returns zeros there.

    apply(np_, npdot, rbf, rbfdot, dir_, dirdot, adj, force, forcedot, We,
          W1a, W1b, W2a, W2b, first_layer, dot_dtype, plain)
    -> (inv1, eq, inv1dot, eqdot)'''

    @staticmethod
    def forward(ctx, np_, npdot, rbf, rbfdot, dir_, dirdot, adj, force,
                forcedot, We, W1a, W1b, W2a, W2b, first_layer=False,
                dot_dtype='bfloat16', plain=False):
        ins = (np_, npdot, rbf, rbfdot, dir_, dirdot, adj, force, forcedot,
               We, W1a, W1b, W2a, W2b)
        ctx.first_layer, ctx.dot_dtype = bool(first_layer), dot_dtype
        ctx.plain = bool(plain)
        ctx.save_for_backward(*ins)
        fwd = pair_interaction_dual_fwd_ref if plain else \
            pair_interaction_dual_fwd
        return fwd(*ins, first_layer=ctx.first_layer, dot_dtype=dot_dtype)

    @staticmethod
    def backward(ctx, di, dq, didot, dqdot):
        bwd = pair_interaction_dual_bwd_ref if ctx.plain else \
            pair_interaction_dual_bwd
        (dnp, dnpdot, dforce, dforcedot, *dws) = bwd(
            *ctx.saved_tensors, di.contiguous(), dq.contiguous(),
            didot.contiguous(), dqdot.contiguous(),
            first_layer=ctx.first_layer, dot_dtype=ctx.dot_dtype)
        return (dnp, dnpdot, None, None, None, None, None, dforce, dforcedot,
                *dws, None, None, None)


def fused_pair_interaction_dual(np_, npdot, rbf, rbfdot, dir_, dirdot, adj,
                                force, forcedot, We, W1a, W1b, W2a, W2b,
                                first_layer=False, dot_dtype='bfloat16',
                                plain=False):
    '''The dual layer through FusedPairInteractionDual: K3/K4 on the card,
    or with plain=True the plain versions on any device (the same forward
    and the same hand-written backward, as plain PyTorch ops).'''
    return FusedPairInteractionDual.apply(
        np_, npdot, rbf, rbfdot, dir_, dirdot, adj, force, forcedot, We, W1a,
        W1b, W2a, W2b, first_layer, dot_dtype, plain)
