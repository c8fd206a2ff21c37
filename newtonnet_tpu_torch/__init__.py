'''newtonnet_tpu_torch: the PyTorch / CUDA port of newtonnet_tpu.

Serves the NewtonNet energy model (energy, forces, virial, stress) on an
NVIDIA Hopper GPU through hand-written CUDA kernels for the fused dense
pair interaction (csrc/fused_dense.cu), built with nvcc at first use. It
imports torch and numpy only: no JAX and nothing of newtonnet_tpu.

Entry points run on CUDA unless the caller passes device='cpu'.
'''
from newtonnet_tpu_torch.md.calculator import NewtonNetCalculator
from newtonnet_tpu_torch.models.output import NewtonNet
from newtonnet_tpu_torch.utils.checkpoint import load_model

__all__ = ['NewtonNet', 'NewtonNetCalculator', 'load_model']
__version__ = '0.1.0'
