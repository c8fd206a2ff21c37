'''Model and train-state checkpoints in the JAX package's format: msgpack
files of `{config: json, params: {'params': tree}}` (utils/checkpoint.py
there), read and written without flax or msgpack (utils/_msgpack.py).
A model file either package writes loads in the other.'''
import json

from newtonnet_tpu_torch.models.output import NewtonNet
from newtonnet_tpu_torch.utils._msgpack import msgpack_restore, \
    msgpack_serialize
from newtonnet_tpu_torch.utils.params import params_from_flax, params_to_flax


def load_model(path, device=None):
    '''Rebuild the model from its embedded config and load its weights.

    Runs on CUDA unless device='cpu' is passed (raises where there is no
    CUDA device). The parameters are frozen (requires_grad False): this is
    the serving path; the Trainer turns gradients back on.'''
    with open(path, 'rb') as f:
        payload = msgpack_restore(f.read())
    model = NewtonNet(**json.loads(payload['config']), device=device)
    params_from_flax(payload['params'], core=model.core)
    return model.requires_grad_(False).eval()


def save_model(path, model):
    '''Write {config, params}: the JAX package's save_model format, which
    its load_model and this package's both read.'''
    payload = {'config': json.dumps(model.config_dict()),
               'params': params_to_flax(model.core)}
    with open(path, 'wb') as f:
        f.write(msgpack_serialize(payload))


def save_train_state(path, *, epoch, step, model, opt_state, scheduler_state,
                     best_val_loss, loader_rng_state):
    '''Training-state checkpoint with the JAX package's `meta` and `params`
    keys. `opt_state` is the port's own layout (Optimizer.state_dict()), so
    only this package resumes from it.'''
    payload = {
        'meta': json.dumps({
            'epoch': int(epoch), 'step': int(step),
            'best_val_loss': float(best_val_loss),
            'scheduler_state': scheduler_state,
            'loader_rng_state': loader_rng_state,
        }),
        'params': params_to_flax(model.core),
        'opt_state': opt_state,
    }
    with open(path, 'wb') as f:
        f.write(msgpack_serialize(payload))


def load_train_state(path):
    '''-> (meta dict, flax-style params tree, opt_state).'''
    with open(path, 'rb') as f:
        payload = msgpack_restore(f.read())
    return json.loads(payload['meta']), payload['params'], \
        payload['opt_state']
