'''The training loop (the JAX package's train/trainer.py, one process on
one device).

Same surface and the same records: training_{n}/ with run_scripts/ and
models/{best,last}_model.msgpack, train/val/test cadence, log.csv with the
JAX package's column names, plateau (or any epoch-level or per-step)
scheduler stepping, the lr early stop, train_state.msgpack with resume,
and the final re-evaluation of the last and best models. Training steps
take the first-order parameter gradient of train/fastgrad.py (kernels
K1-K4 on the card, or K5-K8 for a neighbour-list model, whose lists are
built on the device in every step); evaluation runs NewtonNet.forward
(K1/K2, or K5/K6). All matrix products are IEEE fp32: TF32 is off while
the Trainer runs.

Not here (ROADMAP.md A, "parallelism", "XLA training" and "XLA
kernel='xla' path"): kernel='xla' models (refused before anything else),
meshes, halo exchange, several processes, precomputed neighbour lists,
wandb and the profiler hook (`halo` and `profile_dir` raise
NotImplementedError). The JAX Trainer's steps_per_call, which chunks
steps into one device dispatch, is accepted and does nothing: eager
PyTorch dispatches each operation as it comes.
'''
import csv
import os
import shutil
import time

import numpy as np
import torch

from newtonnet_tpu_torch.layers.precision import fp32_matmuls
from newtonnet_tpu_torch.ops.neighbors import dense_graph
from newtonnet_tpu_torch.train import fastgrad
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
from newtonnet_tpu_torch.utils import checkpoint as ckpt
from newtonnet_tpu_torch.utils.freeze import apply_freeze
from newtonnet_tpu_torch.utils.params import params_from_flax


# Trainer arguments of the JAX package that the port refuses when set, with
# the ROADMAP.md A item that ports each.
UNPORTED_EXTRAS = {'profile_dir': 'training extras', 'halo': 'parallelism'}


def refuse_unported_extras(**given):
    '''NotImplementedError for the first of UNPORTED_EXTRAS given a value.'''
    for key, item in UNPORTED_EXTRAS.items():
        if given.get(key):
            raise NotImplementedError(
                f'training.{key} is not ported yet (ROADMAP.md A, "{item}")')


class Trainer:
    '''See the module docstring. Arguments follow the JAX Trainer's, with
    the parameters living in `model` (a models.output.NewtonNet) and
    `optimizer` from train.optimizer.get_optimizer_by_string over
    model.core (default: adam with `clip_grad`). `freeze` holds the
    pretrained warm start's freeze flags (utils/freeze.py); every other
    parameter is trained, whatever requires_grad it came with.'''

    def __init__(
            self,
            model,
            loss_fns=None,
            optimizer=None,
            lr_scheduler=None,
            output_base_path=None,
            script_path=None,
            settings_path=None,
            checkpoint=None,
            train_generator=None,
            val_generator=None,
            test_generator=None,
            epochs=100,
            clip_grad=0.0,
            freeze=None,
            fast_grad='auto',
            steps_per_call=1,
            profile_dir=None,
            halo=None,
            ):
        del steps_per_call  # no dispatch chunking in eager PyTorch
        refuse_unported_extras(profile_dir=profile_dir, halo=halo)
        fastgrad.refuse_unported_kernel(model.kernel)
        self.model = model
        model.requires_grad_(True)
        apply_freeze(model.core, **(freeze or {}))
        self.main_loss, self.eval_loss = (
            loss_fns or get_loss_by_string({'energy': {}}))
        loss_keys = getattr(self.main_loss, 'keys', None)
        if not fastgrad.supports(loss_keys):
            raise NotImplementedError(
                f'training on {sorted(loss_keys or ())} is not ported yet: '
                f'losses within {sorted(fastgrad.SUPPORTED_KEYS)} only '
                '(ROADMAP.md A, "energy+stress training")')
        if fast_grad not in (True, 'auto'):
            raise NotImplementedError(
                'the second-order training step is not ported: the fused '
                'kernels are first order, so fast_grad must be True or auto')
        self.optimizer = optimizer if optimizer is not None else \
            get_optimizer_by_string('adam', model.core, clip_grad=clip_grad)
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            # a scheduler's initial factor shapes the very first step
            self.optimizer.lr = lr_scheduler.lr
        self._per_step_sched = bool(lr_scheduler is not None
                                    and lr_scheduler.per_step)
        self.best_val_loss = float('inf')
        self.train_generator = train_generator
        self.val_generator = val_generator
        self.test_generator = test_generator
        self.start_epoch = 0
        self.start_step = 0
        self.epochs = epochs
        self.log_rows = []
        if output_base_path is not None:
            self.make_subdirs(output_base_path, script_path, settings_path)
        else:
            self.output_path = None
            self.model_path = None
        checkpoint = checkpoint or {}
        self.check_log = checkpoint.get('check_log', 1)
        self.check_val = checkpoint.get('check_val', 1)
        self.check_test = checkpoint.get('check_test', 1)
        self.print_layers()

    # ------------------------------------------------------------------ #
    def make_subdirs(self, output_base_path, script_path, settings_path):
        '''training_{n}/ with run_scripts/ and models/.'''
        n = 1
        while os.path.exists(os.path.join(output_base_path,
                                          f'training_{n}')):
            n += 1
        self.output_path = os.path.join(output_base_path, f'training_{n}')
        os.makedirs(self.output_path)
        print(f'Output directory: {self.output_path}')
        script_out = os.path.join(self.output_path, 'run_scripts')
        os.makedirs(script_out)
        for src in (script_path, settings_path):
            if src is not None and os.path.exists(src):
                shutil.copyfile(
                    src, os.path.join(script_out, os.path.basename(src)))
        self.model_path = os.path.join(self.output_path, 'models')
        os.makedirs(self.model_path)

    def resume(self, checkpoint_dir):
        '''Continue the run in a previous training_{n} directory: its train
        state, best model and log are copied into this run's directory.'''
        if self.output_path is not None:
            for name in ('models/train_state.msgpack',
                         'models/best_model.msgpack', 'log.csv'):
                src = os.path.join(checkpoint_dir, name)
                if os.path.exists(src):
                    shutil.copyfile(src, os.path.join(self.output_path, name))
            state_dir = self.output_path
        else:
            state_dir = checkpoint_dir
        meta, params, opt_state = ckpt.load_train_state(
            os.path.join(state_dir, 'models', 'train_state.msgpack'))
        self.start_epoch = meta['epoch'] + 1
        self.start_step = meta['step']
        self.best_val_loss = meta['best_val_loss']
        params_from_flax(params, core=self.model.core)
        self.optimizer.load_state_dict(opt_state)
        if self.lr_scheduler is not None and meta.get('scheduler_state'):
            self.lr_scheduler.load_state_dict(meta['scheduler_state'])
            self.optimizer.lr = self.lr_scheduler.lr
        if meta.get('loader_rng_state') and self.train_generator is not None:
            self.train_generator._rng.bit_generator.state = \
                meta['loader_rng_state']
        if self.output_path is not None:
            log_path = os.path.join(self.output_path, 'log.csv')
            if os.path.exists(log_path):
                with open(log_path) as f:
                    self.log_rows = list(csv.DictReader(f))

    def print_layers(self):
        n = sum(p.numel() for p in self.model.core.parameters())
        print('Model:')
        print(f'  NewtonNet({self.model.config_dict()})')
        print(f'total trainable parameters: {n}')
        print()

    def local_log(self, log):
        '''Append a row and rewrite log.csv.'''
        self.log_rows.append({k: str(v) for k, v in log.items()})
        cols = []
        for row in self.log_rows:
            for k in row:
                if k not in cols:
                    cols.append(k)
        with open(os.path.join(self.output_path, 'log.csv'), 'w',
                  newline='') as f:
            w = csv.DictWriter(f, fieldnames=cols)
            w.writeheader()
            for row in self.log_rows:
                w.writerow(row)

    def _save_checkpoint(self, epoch, step):
        ckpt.save_train_state(
            os.path.join(self.model_path, 'train_state.msgpack'),
            epoch=epoch, step=step, model=self.model,
            opt_state=self.optimizer.state_dict(),
            scheduler_state=(self.lr_scheduler.state_dict()
                             if self.lr_scheduler is not None else None),
            best_val_loss=self.best_val_loss,
            loader_rng_state=(self.train_generator._rng.bit_generator.state
                              if self.train_generator is not None else None))

    # ------------------------------------------------------------------ #
    def _to_device(self, batch):
        dev = self.model.device
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def _metrics(self, loss, preds, batch, edges):
        metrics = {'loss': loss}
        evals = self.eval_loss(preds, batch)
        metrics.update({k: evals[k] for k in sorted(evals)})
        if edges:
            _, adj = dense_graph(batch['pos'], batch['cell'],
                                 batch['z'] > 0, self.model.cutoff)
            metrics['edges'] = adj.sum().to(torch.float32)
        return metrics

    def train_step(self, batch):
        '''One optimizer step on a numpy batch; -> its metrics as 0-d
        tensors on the device: loss, the eval battery and the edge count.'''
        b = self._to_device(batch)
        with fp32_matmuls():
            loss, preds = fastgrad.value_and_grad(self.model, self.main_loss,
                                                  b)
            if self._per_step_sched:
                # the lr of step k is the scheduler's value before its
                # k-th advance (torch semantics)
                self.optimizer.lr = self.lr_scheduler.lr
                self.lr_scheduler.step()
            self.optimizer.step()
            return self._metrics(loss, preds, b, edges=True)

    def eval_step(self, batch, model=None):
        '''Metrics of one numpy batch through NewtonNet.forward.'''
        model = model or self.model
        b = self._to_device(batch)
        with fp32_matmuls():
            preds = model(b['z'], b['pos'], b['cell'])
            return self._metrics(self.main_loss(preds, b), preds, b,
                                 edges=False)

    def run_one_epoch(self, generator, step=False, model=None):
        '''One pass over a loader; the metrics averaged per batch.'''
        totals, n = None, 0
        for batch in generator:
            m = self.train_step(batch) if step else \
                self.eval_step(batch, model)
            totals = m if totals is None else \
                {k: totals[k] + v for k, v in m.items()}
            n += 1
        return {k: float(v) / max(n, 1) for k, v in (totals or {}).items()}

    def train(self):
        '''The epoch loop, then the re-evaluation of the last and best
        models.'''
        step = self.start_step
        for epoch in range(self.start_epoch, self.epochs):
            log_one_epoch = {'epoch': epoch,
                             'lr': float(np.float32(self.optimizer.lr))}
            t_epoch = time.perf_counter()
            train_log = self.run_one_epoch(self.train_generator, step=True)
            epoch_seconds = time.perf_counter() - t_epoch
            n_batches = len(self.train_generator)
            step += n_batches
            log_one_epoch['step'] = step
            edges_mean = train_log.pop('edges', None)
            log_one_epoch |= {f'train_{k}': v for k, v in train_log.items()}
            log_one_epoch['epoch_seconds'] = round(epoch_seconds, 4)
            log_one_epoch['steps_per_s'] = round(
                n_batches / max(epoch_seconds, 1e-9), 3)
            if edges_mean:
                log_one_epoch['edges_per_s'] = round(
                    edges_mean * n_batches / max(epoch_seconds, 1e-9), 1)

            if epoch % self.check_val == 0 and self.val_generator is not None:
                val_log = self.run_one_epoch(self.val_generator)
                log_one_epoch |= {f'val_{k}': v for k, v in val_log.items()}
            if (epoch % self.check_test == 0
                    and self.test_generator is not None):
                test_log = self.run_one_epoch(self.test_generator)
                log_one_epoch |= {f'test_{k}': v for k, v in test_log.items()}

            if epoch % self.check_log == 0 and self.model_path is not None:
                val_loss = log_one_epoch.get('val_loss', float('inf'))
                if val_loss < self.best_val_loss:
                    self.best_val_loss = val_loss
                    ckpt.save_model(os.path.join(self.model_path,
                                                 'best_model.msgpack'),
                                    self.model)
                    log_one_epoch['best_model'] = True
                ckpt.save_model(os.path.join(self.model_path,
                                             'last_model.msgpack'),
                                self.model)
            if self.output_path is not None:
                self.local_log(log_one_epoch)

            # epoch-level schedule; a per-step one advanced in train_step
            if self.lr_scheduler is not None and not self._per_step_sched:
                if self.lr_scheduler.needs_metric:
                    if 'val_loss' in log_one_epoch:
                        self.lr_scheduler.step(log_one_epoch['val_loss'])
                else:
                    self.lr_scheduler.step()
                self.optimizer.lr = self.lr_scheduler.lr

            if epoch % self.check_log == 0 and self.model_path is not None:
                self._save_checkpoint(epoch, step)
                if (self.lr_scheduler is not None
                        and self.lr_scheduler.should_stop):
                    break

        print('Training finished')
        if self.model_path is None:
            return
        ckpt.save_model(os.path.join(self.model_path, 'last_model.msgpack'),
                        self.model)
        for tag in ('last', 'best'):
            path = os.path.join(self.model_path, f'{tag}_model.msgpack')
            if not os.path.exists(path):
                continue
            model = ckpt.load_model(path, device=self.model.device)
            log_one_epoch = {'epoch': tag}
            for name, gen in (('train', self.train_generator),
                              ('val', self.val_generator),
                              ('test', self.test_generator)):
                if gen is not None:
                    log = self.run_one_epoch(gen, model=model)
                    log_one_epoch |= {f'{name}_{k}': v
                                      for k, v in log.items()}
            self.local_log(log_one_epoch)
