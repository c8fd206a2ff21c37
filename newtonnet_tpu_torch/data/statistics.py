'''Dataset statistics for output scalers.

Numpy re-statement of the reference MolecularStatistics
(newtonnet/data/loader.py:197-230): least-squares per-element energy
regression (one-hot formula matrix vs total energy -> per-Z shift; residual
std -> per-Z scale) and mean per-element force-norm scale. The outputs feed
ScaleShift parameters of the model's core through `set_scalers`.
'''
import numpy as np


def compute_statistics(samples):
    '''
    Args:
        samples: iterable of Sample dicts with z, energy, force.

    Returns:
        stats dict: {'energy': {'shift': (119,), 'scale': (119,)},
                     'force': {'scale': (119,)}} (keys present only when the
        corresponding labels exist), float64.
    '''
    stats = {}
    samples = list(samples)
    z_all = np.concatenate([s['z'] for s in samples])
    z_unique = np.unique(z_all)

    if samples[0].get('energy') is not None:
        energy = np.array([s['energy'] for s in samples], dtype=np.float64)
        formula = np.zeros((len(samples), 119))
        for i, s in enumerate(samples):
            np.add.at(formula[i], s['z'], 1.0)
        # lstsq of formula vs energy (ref loader.py:212-213, driver='gelsd')
        solution = np.linalg.lstsq(formula, energy, rcond=None)[0]
        shifts = np.zeros(119)
        shifts[z_unique] = solution[z_unique]
        residual = energy - formula @ solution
        # scalar residual std spread over present elements (ref :216-218)
        std = np.sqrt((residual ** 2).sum() / formula.sum())
        scale = np.ones(119)
        scale[z_unique] = std
        stats['energy'] = {'shift': shifts, 'scale': scale}

    if samples[0].get('force') is not None:
        fnorm = np.concatenate(
            [np.linalg.norm(s['force'], axis=-1) for s in samples])
        scale = np.ones(119)
        for zi in z_unique:
            scale[zi] = fnorm[z_all == zi].mean()  # ref :222-227
        stats['force'] = {'scale': scale}

    # dataset periodicity over the stats sample: lets the pipeline pick a
    # STATIC ewald_mode so the charge-head long-range energy stops paying
    # the dead branch that 'auto' (per-graph runtime dispatch) computes
    # (ops/ewald.py). 'mixed' keeps the runtime dispatch.
    periodic = [bool(np.any(np.asarray(s.get('cell', 0)) != 0))
                for s in samples]
    stats['periodicity'] = ('periodic' if all(periodic) else
                            'aperiodic' if not any(periodic) else 'mixed')
    return stats


def set_scalers(core, output_properties, stats, fit_config=None):
    '''Load statistics into the scaler parameters of a NewtonNetCore, in
    place (the JAX package's set_scalers, which returns a new pytree).

    For each output property with a scaler (`scaler_<key>` on the core)
    and statistics, overwrite its scale and shift rows, unless
    `fit_config[key]` sets fit_scale / fit_shift False. Returns the core.'''
    import torch

    fit_config = fit_config or {}
    for key in output_properties:
        scaler = getattr(core, f'scaler_{key}', None)
        if scaler is None or key not in stats:
            continue
        fit = fit_config.get(key, {})
        with torch.no_grad():
            for name in ('scale', 'shift'):
                param = getattr(scaler, name)
                if param is not None and name in stats[key] \
                        and fit.get(f'fit_{name}', True):
                    param.copy_(torch.as_tensor(
                        np.asarray(stats[key][name]).reshape(-1, 1),
                        dtype=param.dtype))
    return core
