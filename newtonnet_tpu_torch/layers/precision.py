'''Precision string -> torch dtype map (the JAX package's
`layers/precision.get_precision_by_string`, returning torch dtypes), and
fp32_matmuls, the port's counterpart of running under
`jax.default_matmul_precision('highest')`, with check_matmul_precision,
which refuses any other matmul precision a JAX setting asks for.'''
import contextlib

import torch

_PRECISION = {
    'float32': torch.float32,
    'float': torch.float32,
    'single': torch.float32,
    'float64': torch.float64,
    'double': torch.float64,
    'float16': torch.float16,
    'half': torch.float16,
    'bfloat16': torch.bfloat16,
    'bf16': torch.bfloat16,
}


def get_precision_by_string(key):
    '''The torch dtype named by `key`; raises ValueError on an unknown one.'''
    if key not in _PRECISION:
        raise ValueError(f'precision {key} is not supported')
    return _PRECISION[key]


@contextlib.contextmanager
def fp32_matmuls():
    '''TF32 off for matrix products and cuDNN, and bf16 products reduced in
    fp32 (no split-K partial sums rounded to bf16 by cuBLAS), the caller's
    flags restored afterwards: every fp32 product inside runs in IEEE
    fp32, as the JAX package's calculator and Trainer pin 'highest', and a
    bf16 product accumulates in fp32 and rounds once, as the JAX program
    does.'''
    matmul = torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


def check_matmul_precision(value, key):
    '''ValueError unless `value`, a JAX matmul precision setting named
    `key`, is 'highest' or None: the port's products are IEEE fp32
    (fp32_matmuls), and it has no lower-precision mode that the JAX
    package's would match.'''
    if value not in ('highest', None):
        raise ValueError(
            f'{key}={value!r} is not available: the port computes in IEEE '
            "fp32, which is 'highest'")
