from newtonnet_tpu_torch.models.newtonnet import NewtonNetCore
from newtonnet_tpu_torch.models.output import NewtonNet

__all__ = ['NewtonNet', 'NewtonNetCore']
