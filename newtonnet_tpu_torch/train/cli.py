'''Training command line (the JAX package's scripts/newtonnet_train.py):

    python -m newtonnet_tpu_torch.train.cli --config config.yml
    python -m newtonnet_tpu_torch.train.cli --resume runs/x/training_1

The same YAML schema (general / data / model / training). general.device
'cpu' trains on the CPU (the kernels' plain versions); any other value
trains on CUDA and raises where there is none. model.pretrained_model.path
to a .msgpack checkpoint, or to a reference .pt checkpoint
(utils/torch_import.py), warm-starts from it, with its freeze flags. Both
kernels train: kernel='xla' (the default, as scripts/config.yml and
artifacts/md17_model/config.yml have it) and kernel='pallas'.
general.matmul_precision and training.eval_matmul_precision take
'highest' (or nothing): the port computes in IEEE fp32; other values raise
ValueError.

Several processes: started by parallel/launch.py (or any launcher that
exports NEWTONNET_DIST_COORD, _NPROCS and _PROCID), each process joins the
process group before any device use (parallel/distributed.
maybe_initialize_from_env: NCCL where each rank has a card of its own,
gloo where they share one or on the CPU; the choice is printed), and
training.parallel {data: D, graph: G} builds the Trainer's mesh
(parallel/mesh.make_mesh), and training.halo {n_halo: H} with it trains
halo-exchange graph parallel (the Trainer's halo mode; the frames sorted
along x by data.spatial_sort: true, the atom padding a multiple of G).

Not ported, and refused with NotImplementedError before any data is read:
a set training.wandb, training.profile_dir and general.debug_nans.
training.steps_per_call is accepted and does nothing (eager PyTorch has
no dispatch chunking, and bucketed batches change shape anyway).
'''
import argparse
import os

import numpy as np

_NOT_PORTED = '{} is not ported yet (ROADMAP.md A, "{}")'


def _config_path(args):
    if args.resume is None:
        if args.config is None:
            raise SystemExit('give --config or --resume')
        return args.config
    if args.config is not None:
        raise SystemExit('Cannot resume and train from scratch at the same '
                         'time.')
    scripts = os.path.join(args.resume, 'run_scripts')
    configs = [f for f in os.listdir(scripts)
               if f.endswith(('.yaml', '.yml'))]
    if len(configs) != 1:
        raise SystemExit(f'Found {len(configs)} config files in '
                         f'{args.resume}.')
    return os.path.join(scripts, configs[0])


def train_from_settings(settings, settings_path=None, resume=None):
    '''Build the data, model, loss, optimizer and Trainer from a settings
    dict of the YAML schema (consumed as the JAX CLI consumes it), train,
    and return the Trainer. `resume` is a training_{n} directory.'''
    general, training = settings['general'], settings['training']
    # popped as the JAX CLI pops it: the Trainer does not take it
    if training.pop('wandb', None):
        raise NotImplementedError(
            _NOT_PORTED.format('training.wandb', 'training extras'))
    parallel = training.pop('parallel', None)
    if general.get('debug_nans', False):
        raise NotImplementedError(
            _NOT_PORTED.format('general.debug_nans', 'training extras'))
    from newtonnet_tpu_torch.layers.precision import check_matmul_precision
    from newtonnet_tpu_torch.train.trainer import refuse_unported_extras
    refuse_unported_extras(**training)
    check_matmul_precision(general.get('matmul_precision'),
                           'general.matmul_precision')
    check_matmul_precision(training.get('eval_matmul_precision'),
                           'training.eval_matmul_precision')
    import torch

    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.layers.precision import get_precision_by_string
    from newtonnet_tpu_torch.models.output import NewtonNet, resolve_device
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import (
        get_optimizer_by_string,
        get_scheduler_by_string,
    )
    from newtonnet_tpu_torch.train.trainer import Trainer
    from newtonnet_tpu_torch.utils.checkpoint import load_model

    from newtonnet_tpu_torch.parallel import distributed
    kind = 'cpu' if general.get('device') == 'cpu' else 'cuda'
    if kind == 'cuda':
        resolve_device()  # raises where there is no card
    # before any device use, as the JAX CLI initialises jax.distributed
    if distributed.maybe_initialize_from_env(kind):
        device = distributed.rank_device(kind, distributed.world()[0])
        print(distributed.describe(device))
    else:
        device = resolve_device('cpu' if kind == 'cpu' else None)
    mesh = None
    if parallel:
        from newtonnet_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(**parallel)
        print(f'mesh: {mesh}')
    pretrained = settings['model'].get('pretrained_model')
    dtype = get_precision_by_string(general['precision'])
    seed = general.get('seed', 0)
    train_gen, val_gen, test_gen, stats = parse_train_test(
        precision=np.dtype(str(dtype).split('.')[-1]), seed=seed,
        **settings['data'])

    settings['model'].pop('pretrained_model', None)
    freeze = None
    if pretrained is not None:
        path = str(pretrained['path'])
        if path.endswith('.pt'):
            from newtonnet_tpu_torch.utils.torch_import import \
                load_reference_model
            model = load_reference_model(path, device=device)
        else:
            model = load_model(path, device=device)
        freeze = {k: pretrained.get(k, False)
                  for k in ('freeze_encoder', 'freeze_interaction',
                            'freeze_decoder', 'freeze_scaler')}
    else:
        # a static ewald_mode from the dataset's periodicity, as the JAX
        # CLI picks it ('auto' computes both branches in every step)
        if ('charge' in settings['model'].get('output_properties', ())
                and settings['model'].get('ewald_mode', 'auto') == 'auto'
                and stats.get('periodicity') in ('periodic', 'aperiodic')):
            settings['model']['ewald_mode'] = stats['periodicity']
            print(f"ewald_mode: auto -> {stats['periodicity']} "
                  f"(from dataset periodicity)")
        model = NewtonNet(
            **settings['model'], device=device, dtype=dtype,
            generator=torch.Generator(device=device).manual_seed(seed))

    # fit scalers as the JAX CLI does: per output property, its entry of
    # training.fit_scalers, or {} (fit scale and shift) where it has none
    fit_scalers = training.pop('fit_scalers', {}) or {}
    fit_config = {key: fit_scalers.pop(key, {})
                  for key in model.output_properties}
    set_scalers(model.core, model.output_properties, stats, fit_config)

    main_loss, eval_loss = get_loss_by_string(training.pop('loss', None))
    clip_grad = training.pop('clip_grad', 0.0) or 0.0
    opt_name, opt_kwargs = training.pop('optimizer',
                                        {'adam': {}}).popitem()
    optimizer = get_optimizer_by_string(opt_name, model.core,
                                        clip_grad=clip_grad,
                                        **(opt_kwargs or {}))
    lr = (opt_kwargs or {}).get('lr', 1e-3)
    sched_cfg = training.pop('lr_scheduler', None)
    lr_scheduler = get_scheduler_by_string(
        sched_cfg.items() if sched_cfg else None, lr)

    trainer = Trainer(
        model=model,
        loss_fns=(main_loss, eval_loss),
        optimizer=optimizer,
        lr_scheduler=lr_scheduler,
        output_base_path=general['output'],
        script_path=os.path.abspath(__file__),
        settings_path=settings_path,
        train_generator=train_gen,
        val_generator=val_gen,
        test_generator=test_gen,
        freeze=freeze,
        mesh=mesh,
        **training,
    )
    if resume is not None:
        trainer.resume(resume)
    trainer.train()
    return trainer


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Train NewtonNet with the PyTorch port.')
    parser.add_argument('-c', '--config', type=str,
                        help='The path to the YAML configuration file.')
    parser.add_argument('-r', '--resume', type=str,
                        help='A training_{n} directory to continue.')
    args = parser.parse_args(argv)
    import yaml

    settings_path = os.path.abspath(_config_path(args))
    with open(settings_path) as f:
        settings = yaml.safe_load(f)
    trainer = train_from_settings(settings, settings_path, args.resume)
    print('done!')
    return trainer


if __name__ == '__main__':
    main()
