'''Windowed neighbour gather and its transpose over cell-sorted lists: the
plain versions, the CUDA wrappers of kernels K10 and K11, their autograd
Functions, and the window arithmetic (the JAX package's
`ops/pallas_window.py`), plus the cell sort that makes the windows small
(`tools/exp_window_gather.py:cell_sort_order` there).

With atoms relabelled in raster order of spatial cells, every neighbour j
of atom n lies in the window of W rows that starts at

    start(n) = (T * (n // T) + T // 2 - W // 2) mod N

(centred on n's block of T atoms), i.e. loc = (j - start(n)) mod N < W.
Over a K-major list idx (B, K, N):

    window_gather(x)[b, k, n]  = bf16(x[b, idx[b, k, n]]) in x's dtype if
                                 loc < W, else 0
    window_scatter_sum(y)[b, j] = sum of bf16(y[b, k, n]) over the
                                 in-window (k, n) with idx[b, k, n] == j,
                                 summed in fp32, in y's dtype

the TPU kernels' semantics (their one-hot matrix products round the
payload to bf16 and accumulate in fp32). The two are exact transposes, and
their autograd Functions are each other's backward. check_window says
whether every valid edge is in its window; window_margin by how many rows.

On the card the wrappers launch `csrc/window.cu` (nn_window_gather, K10:
a row gather with the window test; nn_window_scatter, K11: a stable radix
sort of the edges by destination row, then segment sums of the sorted
edges with the pieces of each run joined in a fixed order, no float
atomics); on the CPU they run the plain versions. A CUDA tensor
either launches the kernel or raises.
'''
import ctypes

import numpy as np
import torch

# Launches counted by the wrappers.
LAUNCHES = {'window_gather': 0, 'window_scatter_sum': 0}
DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def cell_sort_order(pos, cell, sort_cell):
    '''Atom order by raster-ordered sort cells of edge about sort_cell,
    serpentine in the two fast axes (so adjacent slow-axis planes join
    without a jump). pos (N, 3) and a diagonal cell (3, 3), numpy.'''
    L = np.diag(cell)
    nc = np.maximum((L // sort_cell).astype(int), 1)
    ijk = np.minimum((pos / (L / nc)).astype(int), nc - 1)
    iy = np.where(ijk[:, 2] % 2 == 1, nc[1] - 1 - ijk[:, 1], ijk[:, 1])
    ix = np.where(iy % 2 == 1, nc[0] - 1 - ijk[:, 0], ijk[:, 0])
    cid = (ijk[:, 2] * nc[1] + iy) * nc[0] + ix
    return np.argsort(cid, kind='stable')


def window_starts(N, W, T):
    '''The window start of each of the N // T atom blocks.'''
    return [(i * T + T // 2 - W // 2) % N for i in range(N // T)]


def window_locals(idx_kn, W, T):
    '''Window-local indices (idx - start(n)) mod N, (B, K, N) int64.'''
    N = idx_kn.shape[-1]
    st = torch.tensor(window_starts(N, W, T), device=idx_kn.device)
    return (idx_kn.long() - st.repeat_interleave(T)[None, None]) % N


def check_window(idx_kn, mask_kn, W, T):
    '''True iff every valid edge lies in its block's window.'''
    loc = window_locals(idx_kn, W, T)
    return bool(torch.all(torch.where(mask_kn, loc < W, True)))


def window_margin(idx_kn, mask_kn, W, T):
    '''The least slack, in rows, between a valid edge and the edges of its
    window; >= 0 iff check_window passes.'''
    loc = window_locals(idx_kn, W, T)
    lo = torch.where(mask_kn, loc, W)
    hi = torch.where(mask_kn, W - 1 - loc, W)
    return int(torch.minimum(lo.min(), hi.min()))


def _check_shapes(N, W, T):
    if T <= 0 or N % T or not 0 < W <= N:
        raise ValueError(f'the window ops need N % T == 0 and 0 < W <= N, '
                         f'got N={N}, W={W}, T={T}')


def window_gather_ref(x, idx_kn, W, T=128):
    '''Plain PyTorch K10: x (B, N, ...) -> (B, K, N, ...).'''
    B, K, N = idx_kn.shape
    _check_shapes(N, W, T)
    flat = x.reshape(B, N, -1)
    b = torch.arange(B, device=x.device)[:, None]
    out = flat[b, idx_kn.reshape(B, K * N).long()]
    out = out.to(torch.bfloat16).to(x.dtype)
    inwin = (window_locals(idx_kn, W, T) < W).reshape(B, K * N, 1)
    return torch.where(inwin, out, 0).reshape((B, K, N) + x.shape[2:])


def window_scatter_sum_ref(y, idx_kn, W, T=128):
    '''Plain PyTorch K11: y (B, K, N, ...) -> (B, N, ...), an index_add_
    of the rounded payload into fp32.'''
    B, K, N = idx_kn.shape
    _check_shapes(N, W, T)
    feat = y.shape[3:]
    yf = y.reshape(B, K * N, -1).to(torch.bfloat16).float()
    inwin = (window_locals(idx_kn, W, T) < W).reshape(B, K * N, 1)
    yf = torch.where(inwin, yf, 0)
    out = torch.zeros((B, N, yf.shape[-1]), dtype=torch.float32,
                      device=y.device)
    for b in range(B):
        out[b].index_add_(0, idx_kn[b].reshape(-1).long(), yf[b])
    return out.to(y.dtype).reshape((B, N) + feat)


def _lib():
    from newtonnet_tpu_torch.ops import _build
    lib = _build.load('window')
    if not getattr(lib, '_nn_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn_window_gather.argtypes = [p, p, p] + [i] * 8 + [p]
        lib.nn_window_gather.restype = i
        lib.nn_window_scatter.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.nn_window_scatter.restype = i
        lib.nn_window_scratch_bytes.argtypes = [i] * 6
        lib.nn_window_scratch_bytes.restype = ctypes.c_size_t
        lib._nn_typed = True
    return lib


def _checked(payload, idx_kn, W, T, name):
    '''The device, dtype and layout checks of a launch.'''
    if payload.device.type != 'cuda':
        raise ValueError(f'no kernel for device {payload.device}')
    if idx_kn.device != payload.device:
        raise ValueError(f'idx_kn is on {idx_kn.device}, expected '
                         f'{payload.device}')
    if payload.dtype not in DTYPES:
        raise TypeError(f'{name} must be one of {DTYPES}, got '
                        f'{payload.dtype}')
    if idx_kn.dtype not in (torch.int32, torch.int64):
        raise TypeError(f'idx_kn must be int32 or int64, got {idx_kn.dtype}')
    if not (payload.is_contiguous() and idx_kn.is_contiguous()):
        raise ValueError(f'{name} and idx_kn must be contiguous')
    _check_shapes(idx_kn.shape[-1], W, T)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def window_gather_fwd(x, idx_kn, W, T=128):
    '''K10 for CUDA tensors, the plain version for CPU tensors.'''
    if x.device.type == 'cpu':
        return window_gather_ref(x, idx_kn, W, T)
    _checked(x, idx_kn, W, T, 'x')
    B, K, N = idx_kn.shape
    F = x[0, 0].numel()
    out = torch.empty((B, K, N) + x.shape[2:], dtype=x.dtype,
                      device=x.device)
    err = _lib().nn_window_gather(
        x.data_ptr(), idx_kn.data_ptr(), out.data_ptr(), B, K, N, F, W, T,
        int(x.dtype == torch.bfloat16), int(idx_kn.dtype == torch.int64),
        _stream(x))
    if err != 0:
        raise RuntimeError(f'nn_window_gather launch failed: cudaError_t '
                           f'{err}')
    LAUNCHES['window_gather'] += 1
    return out


def window_scatter_sum_fwd(y, idx_kn, W, T=128):
    '''K11 for CUDA tensors, the plain version for CPU tensors.'''
    if y.device.type == 'cpu':
        return window_scatter_sum_ref(y, idx_kn, W, T)
    _checked(y, idx_kn, W, T, 'y')
    B, K, N = idx_kn.shape
    F = y[0, 0, 0].numel()
    lib = _lib()
    n_bytes = lib.nn_window_scratch_bytes(B, K, N, F, W, T)
    if n_bytes == 0:
        raise ValueError(f'K11 takes B * K * N < 2^31 edges, got B={B}, '
                         f'K={K}, N={N}')
    scratch = torch.empty((n_bytes,), dtype=torch.uint8, device=y.device)
    out = torch.empty((B, N) + y.shape[3:], dtype=y.dtype, device=y.device)
    err = lib.nn_window_scatter(
        y.data_ptr(), idx_kn.data_ptr(), scratch.data_ptr(), out.data_ptr(), B,
        K, N, F, W, T, int(y.dtype == torch.bfloat16),
        int(idx_kn.dtype == torch.int64), _stream(y))
    if err != 0:
        raise RuntimeError(f'nn_window_scatter launch failed: cudaError_t '
                           f'{err}')
    LAUNCHES['window_scatter_sum'] += 1
    return out


class WindowGather(torch.autograd.Function):
    '''window_gather as an autograd op; backward WindowScatterSum.

    apply(x, idx_kn, W, T, plain) -> (B, K, N, ...)'''

    @staticmethod
    def forward(ctx, x, idx_kn, W, T, plain=False):
        ctx.save_for_backward(idx_kn)
        ctx.W, ctx.T, ctx.plain = W, T, plain
        fn = window_gather_ref if plain else window_gather_fwd
        return fn(x, idx_kn, W, T)

    @staticmethod
    def backward(ctx, g):
        (idx_kn,) = ctx.saved_tensors
        return (WindowScatterSum.apply(g.contiguous(), idx_kn, ctx.W, ctx.T,
                                       ctx.plain), None, None, None, None)


class WindowScatterSum(torch.autograd.Function):
    '''window_scatter_sum as an autograd op; backward WindowGather.

    apply(y, idx_kn, W, T, plain) -> (B, N, ...)'''

    @staticmethod
    def forward(ctx, y, idx_kn, W, T, plain=False):
        ctx.save_for_backward(idx_kn)
        ctx.W, ctx.T, ctx.plain = W, T, plain
        fn = window_scatter_sum_ref if plain else window_scatter_sum_fwd
        return fn(y, idx_kn, W, T)

    @staticmethod
    def backward(ctx, g):
        (idx_kn,) = ctx.saved_tensors
        return (WindowGather.apply(g.contiguous(), idx_kn, ctx.W, ctx.T,
                                   ctx.plain), None, None, None, None)


def window_gather(x, idx_kn, W, T=128, plain=False):
    '''K-major neighbour gather over cell-sorted atoms (see the module
    docstring): x (B, N, ...) -> (B, K, N, ...), 0 outside the window.
    Callers guarantee every valid edge is in its window (check_window).'''
    return WindowGather.apply(x, idx_kn, int(W), int(T), plain)


def window_scatter_sum(y, idx_kn, W, T=128, plain=False):
    '''Adjoint of window_gather: y (B, K, N, ...) -> (B, N, ...).'''
    return WindowScatterSum.apply(y, idx_kn, int(W), int(T), plain)
