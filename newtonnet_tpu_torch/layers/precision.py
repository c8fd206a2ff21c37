'''Precision string -> torch dtype map (the JAX package's
`layers/precision.get_precision_by_string`, returning torch dtypes).'''
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
