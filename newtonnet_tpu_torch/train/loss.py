'''Losses over padded batches (the JAX package's train/loss.py).

`get_loss_by_string(losses)` returns (main_loss, eval_loss):
  * main_loss(preds, batch) -> the weighted sum that training minimises,
  * eval_loss(preds, batch) -> the fixed evaluation battery (mae/mse,
    energy per atom, cos/norm transforms of direct forces).
Every mean is masked: padding atoms (z = 0) and padding graphs
(graph_mask False) contribute nothing. Inputs are torch tensors.

A data-parallel rank holds some rows of the global batch
(parallel/distributed.global_data_batch), which carries the global
batch's counts of real graphs and atoms (batch['graph_count'],
batch['atom_count']). Each mean then divides by the global count, so the
ranks' losses are partial sums that add up to the global batch's loss (a
mean over local counts would weigh a rank by its own padding).
'''
import torch


def _masked_mean(err, mask, count=None):
    '''Mean of err over the entries where mask is True; mask broadcasts over
    err's trailing dimensions, which all count. `count`: the number of
    True entries of the global batch's mask (default: mask's own).'''
    mask = mask.to(err.dtype)
    extra = 1
    for d in err.shape[mask.ndim:]:
        extra *= d
    total = torch.sum(err * mask.reshape(mask.shape
                                         + (1,) * (err.ndim - mask.ndim)))
    count = torch.sum(mask) if count is None else count.to(err.dtype)
    return total / torch.clamp(count * extra, min=1.0)


def _elementwise(mode, pred, ref, delta=1.0):
    diff = pred - ref
    if mode == 'mse':
        return diff * diff
    if mode == 'mae':
        return torch.abs(diff)
    if mode == 'huber':
        a = torch.abs(diff)
        return torch.where(a <= delta, 0.5 * diff * diff,
                           delta * (a - 0.5 * delta))
    raise ValueError(f'loss mode {mode} not implemented')


def _energy_loss(mode, per_atom=False, weight=1.0, **kw):
    def fn(preds, batch):
        pred, ref = preds['energy'], batch['energy']
        if per_atom:
            n = torch.clamp(torch.sum(batch['z'] > 0, dim=-1), min=1)
            n = n.to(pred.dtype)
            pred, ref = pred / n, ref / n
        err = _elementwise(mode, pred, ref, **kw)
        return weight * _masked_mean(err, batch['graph_mask'],
                                     batch.get('graph_count'))
    return fn


def _force_loss(key, mode, transform=None, weight=1.0, **kw):
    def fn(preds, batch):
        pred, ref = preds[key], batch['force']  # (B, N, 3)
        atom_mask = batch['z'] > 0
        if transform == 'cos':
            dot = torch.sum(pred * ref, dim=-1)
            norm = (torch.linalg.norm(pred, dim=-1)
                    * torch.linalg.norm(ref, dim=-1))
            cos = dot / torch.clamp(norm, min=1e-8)
            err = _elementwise(mode, cos, torch.ones_like(cos), **kw)
        elif transform == 'norm':
            err = _elementwise(mode, torch.linalg.norm(pred, dim=-1),
                               torch.linalg.norm(ref, dim=-1), **kw)
        elif transform is None:
            err = _elementwise(mode, pred, ref, **kw)
        else:
            raise ValueError(f'transform {transform} not implemented')
        return weight * _masked_mean(err, atom_mask,
                                     batch.get('atom_count'))
    return fn


def _graph_tensor_loss(key, mode, weight=1.0, **kw):
    '''Per-graph (B, 3, 3) labels (stress, virial), masked over padding
    graphs.'''
    def fn(preds, batch):
        err = _elementwise(mode, preds[key], batch[key], **kw)
        return weight * _masked_mean(err, batch['graph_mask'],
                                     batch.get('graph_count'))
    return fn


def get_loss_by_string(losses):
    '''Build (main_loss, eval_loss) from the config dict.

    losses: {'energy': {'weight': .., 'mode': ..}, 'gradient_force': {...},
             'direct_force': {...}, 'stress': {...}, 'virial': {...}}
    main_loss.keys is the set of prediction keys the training loss reads
    and main_loss.config the config it was built from.'''
    if losses is None:
        raise AssertionError('losses is not defined.')
    main, evals = [], {}
    for key, kwargs in losses.items():
        kwargs = dict(kwargs or {})
        mode = kwargs.pop('mode', 'mse')
        weight = kwargs.pop('weight', 1.0)
        if key == 'energy':
            main.append(_energy_loss(mode, weight=weight, **kwargs))
            evals['energy_mae'] = _energy_loss('mae')
            evals['energy_mse'] = _energy_loss('mse')
            evals['energy_per_atom_mae'] = _energy_loss('mae', per_atom=True)
            evals['energy_per_atom_mse'] = _energy_loss('mse', per_atom=True)
        elif key == 'gradient_force':
            main.append(_force_loss(key, mode, weight=weight, **kwargs))
            evals['gradient_force_mae'] = _force_loss(key, 'mae')
            evals['gradient_force_mse'] = _force_loss(key, 'mse')
        elif key == 'direct_force':
            main.append(_force_loss(key, mode, weight=weight, **kwargs))
            evals['direct_force_mae'] = _force_loss(key, 'mae')
            evals['direct_force_mse'] = _force_loss(key, 'mse')
            evals['direct_force_cos_mae'] = _force_loss(key, 'mae', 'cos')
            evals['direct_force_cos_mse'] = _force_loss(key, 'mse', 'cos')
            evals['direct_force_norm_mae'] = _force_loss(key, 'mae', 'norm')
            evals['direct_force_norm_mse'] = _force_loss(key, 'mse', 'norm')
        elif key in ('stress', 'virial'):
            main.append(_graph_tensor_loss(key, mode, weight=weight,
                                           **kwargs))
            evals[f'{key}_mae'] = _graph_tensor_loss(key, 'mae')
            evals[f'{key}_mse'] = _graph_tensor_loss(key, 'mse')
        else:
            raise NotImplementedError(f'loss for {key} is not implemented')

    def main_loss(preds, batch):
        return sum(fn(preds, batch) for fn in main)

    main_loss.keys = frozenset(losses)
    main_loss.config = {k: dict(v or {}) for k, v in losses.items()}

    def eval_loss(preds, batch):
        return {name: fn(preds, batch) for name, fn in evals.items()}

    return main_loss, eval_loss
