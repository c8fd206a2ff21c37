'''Read the JAX package's model checkpoints: a msgpack
`{config: json, params: {'params': tree}}` file, decoded without flax or
msgpack (utils/_msgpack.py).'''
import json

from newtonnet_tpu_torch.models.output import NewtonNet
from newtonnet_tpu_torch.utils._msgpack import msgpack_restore
from newtonnet_tpu_torch.utils.params import params_from_flax


def load_model(path, device=None):
    '''Rebuild the model from its embedded config and load its weights.

    Runs on CUDA unless device='cpu' is passed (raises where there is no
    CUDA device). The parameters are frozen (requires_grad False): this is
    the serving path.'''
    with open(path, 'rb') as f:
        payload = msgpack_restore(f.read())
    model = NewtonNet(**json.loads(payload['config']), device=device)
    params_from_flax(payload['params'], core=model.core)
    return model.requires_grad_(False).eval()
