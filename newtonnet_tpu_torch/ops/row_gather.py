'''Row gather out[b, r] = x[b, idx[b, r]]: the plain version and the CUDA
wrapper of kernel K9 (the JAX package's `ops/pallas_gather.py`; K12,
`tools/exp_pallas_gather.py`, is the same function at B = 1).

The neighbour gather of the inverse-list layout and every chunk of its
transpose run through row_gather (ops/nlist.py: inv_gather,
inv_scatter_sum). On the card it launches `csrc/row_gather.cu:nn_row_gather`
for any width and dtype; on the CPU it runs the plain version. A CUDA
tensor either launches the kernel or raises: nothing falls back. The TPU
kernel's eligibility rules (F >= 128, a VMEM budget, the NEWTONNET_GATHER
opt-in) are TPU limits with no counterpart here.

Under torch.func transforms (the Hessian's vmap of jvp of grad) the list
Functions of ops/nlist.py fold a block of L lanes into the batch axis
(their vmap rules), so the wrapper sees one plain (L*B, ...) tensor per
gather; a functorch-wrapped tensor (batched, dual or grad-tracking) that
reaches it raises, on any device, instead of launching on its storage.

The gather is the custom op `newtonnet_tpu_torch::row_gather`
(torch.library): its implementation launches K9 for a CUDA tensor and runs
the plain version for a CPU one, and its fake implementation gives the
output's shape, so that torch.export records the op in a program
(utils/export.py) and a replay of that program launches the kernel.
'''
import contextlib
import ctypes

import torch

# Launches counted by the wrapper: all of them, those at B = 1 (the 2-D
# form of tools/exp_pallas_gather.py, K12), and those at B > 1 made inside
# a vmap rule's fold of lanes (folded_lanes).
LAUNCHES = {'row_gather': 0, 'row_gather_b1': 0, 'row_gather_folded': 0}
INDEX_DTYPES = (torch.int32, torch.int64)
# the kernel indexes its vectors with 32 bits (csrc/row_gather.cu)
MAX_VECTORS = 1 << 31
_FOLDING = [0]


@contextlib.contextmanager
def folded_lanes():
    '''Marks the launches inside the block as made at a fold of vmap lanes
    into the batch axis (counted under row_gather_folded when B > 1).'''
    _FOLDING[0] += 1
    try:
        yield
    finally:
        _FOLDING[0] -= 1


def _refuse_wrapped(*tensors):
    is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    for t in tensors:
        if is_wrapped(t):
            raise TypeError(
                'row_gather was handed a torch.func-wrapped (batched, dual '
                'or grad-tracking) tensor: call it inside an autograd '
                'Function with a vmap rule (ops/nlist.py), which hands it '
                'plain tensors')


def vector_bytes(row_bytes, *ptrs):
    '''The width of the words the kernel moves (its dispatch in
    csrc/row_gather.cu): 16, 4, 2 or 1 bytes, the widest that divides the
    row length and every pointer.'''
    for width in (16, 4, 2):
        if row_bytes % width == 0 and all(p % width == 0 for p in ptrs):
            return width
    return 1


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def row_gather_ref(x, idx):
    '''Plain PyTorch: x (B, N, F), idx (B, R) int -> (B, R, F).'''
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx.long()]


def _lib():
    from newtonnet_tpu_torch.ops import _build
    lib = _build.load('row_gather')
    if not getattr(lib, '_nn_typed', False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn_row_gather.argtypes = [p, p, p, i, i, i, i, ctypes.c_longlong,
                                      i, p]
        lib.nn_row_gather.restype = i
        lib._nn_typed = True
    return lib


@torch.library.custom_op('newtonnet_tpu_torch::row_gather', mutates_args=())
def _row_gather_op(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    '''The op row_gather calls, its layout checked: K9 on CUDA tensors, the
    plain version on CPU ones.'''
    if x.device.type == 'cpu':
        return row_gather_ref(x, idx)
    B, N, F = x.shape
    R = idx.shape[1]
    out = torch.empty((B, R, F), dtype=x.dtype, device=x.device)
    if B * R * F == 0:
        return out
    row_bytes = F * x.element_size()
    if B * R * (row_bytes // vector_bytes(row_bytes, x.data_ptr(),
                                          out.data_ptr())) >= MAX_VECTORS:
        raise ValueError(
            f'row_gather: {B} x {R} rows of {row_bytes} bytes pass the '
            f'kernel\'s 2^31 vectors; use smaller blocks of lanes '
            f'(hessian_block)')
    bstride = x.stride(0) // F if B > 1 else N
    err = _lib().nn_row_gather(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, R,
        row_bytes, bstride, int(idx.dtype == torch.int64),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'nn_row_gather launch failed: cudaError_t {err}')
    LAUNCHES['row_gather'] += 1
    if B == 1:
        LAUNCHES['row_gather_b1'] += 1
    elif _FOLDING[0]:
        LAUNCHES['row_gather_folded'] += 1
    return out


@_row_gather_op.register_fake
def _(x, idx):
    return x.new_empty((x.shape[0], idx.shape[1], x.shape[2]))


def row_gather(x, idx):
    '''out[b, r] = x[b, idx[b, r]]: kernel K9 for CUDA tensors, the plain
    version for CPU tensors.

    Args:
        x: (B, N, F) with contiguous rows (a batch stride other than N*F is
            taken as it is: a slot chunk of a larger tensor needs no copy).
        idx: (B, R) int32 or int64, in [0, N).

    Returns:
        (B, R, F) in x's dtype. The kernel's layout rules hold on every
        device, so that a CPU run refuses what the card would.'''
    _refuse_wrapped(x, idx)
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f'expected x (B, N, F) and idx (B, R), got '
                         f'{tuple(x.shape)} and {tuple(idx.shape)}')
    if idx.device != x.device:
        raise ValueError(f'idx is on {idx.device}, expected {x.device}')
    if idx.dtype not in INDEX_DTYPES:
        raise TypeError(f'idx must be one of {INDEX_DTYPES}, got {idx.dtype}')
    B, N, F = x.shape
    R = idx.shape[1]
    if not idx.is_contiguous():
        raise ValueError('idx must be contiguous')
    if x.stride(2) != 1 or (N > 1 and x.stride(1) != F) \
            or x.stride(0) % max(F, 1) or (B > 1 and x.stride(0) < N * F):
        raise ValueError('the rows of x must be contiguous')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no kernel for device {x.device}')
    return _row_gather_op(x, idx)
