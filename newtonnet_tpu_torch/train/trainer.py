'''The training loop (the JAX package's train/trainer.py): one process
on one device, or data-parallel ranks over a mesh (below).

Same surface and the same records: training_{n}/ with run_scripts/ and
models/{best,last}_model.msgpack, train/val/test cadence, log.csv with the
JAX package's column names, plateau (or any epoch-level or per-step)
scheduler stepping, the lr early stop, train_state.msgpack with resume,
and the final re-evaluation of the last and best models.

A training step is one of two, chosen as the JAX Trainer chooses
(fast_grad, resolved in __init__):
* the first-order parameter gradient of train/fastgrad.py (energy and
  gradient_force losses): kernels K1-K4 for a kernel='pallas' model, K5-K8
  with neighbour lists (built on the device in every step), and for a
  kernel='xla' model reverse over forward (K9 row gathers with lists);
* the standard step, reverse over reverse: the loss over
  NewtonNet.forward(..., create_graph=True), then loss.backward(). It
  trains every loss the model has outputs for: energy, gradient_force,
  direct_force, stress and virial (kernel='xla' only; the fused
  kernels are first order, so a kernel='pallas' model with
  fast_grad=False is refused when the Trainer is built).
Evaluation runs NewtonNet.forward (K1/K2, or K5/K6, for kernel='pallas').
Batches may change shape from one step to the next (a BucketedLoader pads
each bucket to its own size): nothing is kept by shape between steps. A
PrefetchLoader's shuffling Generator is its wrapped loader's, so the
train state's loader_rng_state resumes either.
All matrix products are IEEE fp32: TF32 is off while the Trainer runs,
which is what eval_matmul_precision='highest' asks of the JAX Trainer.

A charge-head model in ewald_mode 'auto' is resolved as the JAX Trainer
resolves it: from the first batch's periodicity when train_generator can
be iterated again (a loader, a list), printing the choice; otherwise it
warns and computes both Ewald branches in every step.

A batch's precomputed lists (data.precompute_nlist, data/prelists.py)
go to the model as its nlist (_batch_nlist), and the first batch of each
pass is checked against the model's list mode with the JAX Trainer's
errors (_check_batch_nlist). Every list layout keeps the step gather-only:
inv_gather / inv_scatter_sum, gather_nodes and edge_gather have gather
backwards in every order.

Data parallelism (mesh=, parallel/mesh.make_mesh; the JAX Trainer's
mesh): every rank iterates the same seeded loader and keeps its rows of
each batch (parallel/distributed.global_data_batch), whose global masked
counts make each rank's loss a partial sum of the global batch's loss
(train/loss.py). After each rank's gradient, the gradients are summed
over the mesh's data group as one flat buffer in parameter order, before
the optimizer (so clip_grad sees the global norm); the parameters are
broadcast from rank 0 when the Trainer is built; the metrics (losses,
MAEs, edge counts) are summed over the data group, so log.csv has the
global batch's; validation and test epochs are sharded the same way. A
graph axis above 1 replicates the data rows over the graph ranks (P('data')
on a (D, G) mesh). Only the chief (rank 0) writes the run directory, the
checkpoints and log.csv. The final re-evaluation of the last and best
models runs on every rank from the parameters in memory (the best ones
kept as they pass), with or without a mesh.

Not here (ROADMAP.md A, "parallelism" and "training extras"): halo
exchange, wandb, the profiler hook and the standard step over a
kernel='pallas' model (`halo`, `profile_dir` and that step raise
NotImplementedError).
The JAX Trainer's steps_per_call, which chunks steps into one device
dispatch, is accepted and does nothing: eager PyTorch dispatches each
operation as it comes.
'''
import copy
import csv
import os
import shutil
import time
import warnings

import numpy as np
import torch

from newtonnet_tpu_torch.layers.precision import (
    check_matmul_precision,
    fp32_matmuls,
)
from newtonnet_tpu_torch.ops.neighbors import dense_graph
from newtonnet_tpu_torch.ops.nlist import build_inverse_list
from newtonnet_tpu_torch.parallel import collectives
from newtonnet_tpu_torch.parallel.distributed import global_data_batch
from newtonnet_tpu_torch.parallel.mesh import world
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


def standard_value_and_grad(model, main_loss, batch, nlist=None,
                            plain=False):
    '''The standard training step's loss and parameter gradient, reverse
    over reverse (the JAX Trainer's jax.value_and_grad of the loss over
    model.apply): the loss of NewtonNet.forward(..., create_graph=True),
    then one backward pass. Any loss the model has outputs for (energy,
    gradient_force, direct_force, stress, virial); kernel='xla' models
    only.

    Arguments and result as train/fastgrad.value_and_grad's: nlist and
    plain pass through to the model (plain: the inverse-list gathers
    through the plain row gather instead of kernel K9).'''
    for p in model.core.parameters():
        p.grad = None
    preds = model(batch['z'], batch['pos'], batch['cell'], nlist=nlist,
                  plain=plain, create_graph=True)
    loss = main_loss(preds, batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in preds.items()}


class Trainer:
    '''See the module docstring. Arguments follow the JAX Trainer's, with
    the parameters living in `model` (a models.output.NewtonNet) and
    `optimizer` from train.optimizer.get_optimizer_by_string over
    model.core (default: adam with `clip_grad`). `freeze` holds the
    pretrained warm start's freeze flags (utils/freeze.py); every other
    parameter is trained, whatever requires_grad it came with. `mesh`: a
    parallel/mesh.Mesh for data parallelism (module docstring).'''

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
            eval_matmul_precision='highest',
            mesh=None,
            ):
        del steps_per_call  # no dispatch chunking in eager PyTorch
        refuse_unported_extras(profile_dir=profile_dir, halo=halo)
        if mesh is not None and mesh.coords is None:
            raise ValueError(f'rank {world()[0]} is not in {mesh}')
        check_matmul_precision(eval_matmul_precision,
                               'eval_matmul_precision')
        if model.ewald_dispatches_at_runtime:
            mode = self._peek_periodicity(train_generator)
            if mode is not None:
                model = model.with_ewald_mode(mode)
                print(f'ewald_mode: auto -> {mode} '
                      f'(from the first training batch)')
            else:
                warnings.warn(
                    "ewald_mode='auto' computes BOTH Ewald branches every "
                    "step; resolve statically with "
                    "model.with_ewald_mode('periodic'|'aperiodic') when "
                    "the data's periodicity is known", stacklevel=2)
        self.model = model
        self.mesh = mesh
        # every rank tracks the best model where a run directory is asked
        # for; only the chief (rank 0) writes it
        self._is_chief = world()[0] == 0
        self._keeps_best = output_base_path is not None
        self._best_state = None
        if mesh is not None:
            # every rank starts from rank 0's parameters
            collectives.broadcast_(list(model.core.parameters()))
        model.requires_grad_(True)
        apply_freeze(model.core, **(freeze or {}))
        self.main_loss, self.eval_loss = (
            loss_fns or get_loss_by_string({'energy': {}}))
        loss_keys = getattr(self.main_loss, 'keys', None)
        self.fast_grad = self._resolve_fast_grad(fast_grad, loss_keys)
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
        if output_base_path is not None and self._is_chief:
            self.make_subdirs(output_base_path, script_path, settings_path)
        else:
            self.output_path = None
            self.model_path = None
        checkpoint = checkpoint or {}
        self.check_log = checkpoint.get('check_log', 1)
        self.check_val = checkpoint.get('check_val', 1)
        self.check_test = checkpoint.get('check_test', 1)
        self.print_layers()

    @staticmethod
    def _peek_periodicity(generator):
        '''The JAX Trainer's: 'periodic' or 'aperiodic' when the first batch
        of a generator that can be iterated again (not a one-shot iterator,
        which peeking would consume) has only periodic or only aperiodic
        graphs among those its graph_mask keeps; None otherwise (mixed,
        empty, or not peekable).'''
        if generator is None:
            return None
        try:
            it = iter(generator)
            if it is generator:
                return None
            first = next(it)
        except (TypeError, StopIteration):
            return None
        if not isinstance(first, dict) or 'cell' not in first:
            return None
        cell = np.asarray(first['cell'])
        periodic = np.any(cell.reshape(cell.shape[0], -1) != 0, axis=1)
        gmask = np.asarray(first.get('graph_mask',
                                     np.ones(len(periodic), bool)))
        periodic = periodic[gmask.astype(bool)]
        if periodic.size == 0:
            return None
        if periodic.all():
            return 'periodic'
        if not periodic.any():
            return 'aperiodic'
        return None

    def _resolve_fast_grad(self, fast_grad, loss_keys):
        '''fast_grad as the JAX Trainer resolves it: 'auto' takes
        train/fastgrad.py for kernel='pallas' models whose loss it covers,
        the standard step otherwise; True forces fastgrad (any kernel).
        The JAX Trainer's ValueErrors; a kernel='pallas' model without
        fastgrad raises too (the standard step needs create_graph).'''
        pallas = self.model.kernel == 'pallas'
        if fast_grad == 'auto':
            fast_grad = pallas and fastgrad.supports(loss_keys)
        if fast_grad and not fastgrad.supports(loss_keys):
            raise ValueError(
                f'fast_grad requires losses within '
                f'{sorted(fastgrad.SUPPORTED_KEYS)}, got {loss_keys}')
        keys = set(loss_keys or ())
        if pallas and not fast_grad and 'gradient_force' in keys:
            raise ValueError(
                'kernel=pallas force training needs fast_grad (the fused '
                'kernels are first-order); pass fast_grad=True or "auto"')
        if pallas and not fast_grad and keys & {'stress', 'virial'}:
            # the standard step would differentiate K2 (K6) again
            raise ValueError(
                f'kernel=pallas cannot train {sorted(keys)}: the fused '
                'kernels are first order; use a kernel=xla model')
        if pallas and not fast_grad:
            # the standard step needs NewtonNet.forward(create_graph=True)
            raise NotImplementedError(
                'the standard step (fast_grad=False) over a kernel=pallas '
                'model is not ported yet (ROADMAP.md A, "training '
                'extras"); pass fast_grad=True or "auto"')
        return bool(fast_grad)

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
        state, best model and log are copied into this run's directory. With
        a mesh every rank restarts from the directory (which each must be
        able to read); the chief copies it.'''
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
        best_path = os.path.join(state_dir, 'models', 'best_model.msgpack')
        if self._keeps_best and os.path.exists(best_path):
            # the best so far, kept in memory as train() keeps it (every
            # rank reads the checkpoint directory, as the train state)
            self._best_state = ckpt.load_model(
                best_path, device=self.model.device).core.state_dict()
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

        def move(v):
            if isinstance(v, tuple):  # nlist_stair's chunk tuples
                return tuple(move(a) for a in v)
            return torch.as_tensor(v).to(dev)
        return {k: move(v) for k, v in batch.items()}

    def _batch_nlist(self, batch, model=None):
        '''The nlist a batch of device tensors carries for the model
        (data/prelists.py), or None (the model builds its graph): the
        staircase chunk tuples as they are; for a newton3 model the half
        list with its inverse (build_inverse_list, on the device); for an
        inverse_lists model the symmetric-slotted list with its K-major
        transposes, its own inverse; else (idx, mask).'''
        model = model or self.model
        if 'nlist_stair' in batch:
            return batch['nlist_stair']
        if 'nlist_idx' not in batch:
            return None
        idx, mask = batch['nlist_idx'].long(), batch['nlist_mask']
        idx_kn, mask_kn = (idx.transpose(1, 2).contiguous(),
                           mask.transpose(1, 2).contiguous())
        if model.newton3:
            return (idx, mask) + build_inverse_list(idx_kn, mask_kn)
        if model.inverse_lists:
            return idx, mask, idx_kn, mask_kn
        return idx, mask

    def _check_batch_nlist(self, batch):
        '''The first batch's lists against the model's list mode, with the
        JAX Trainer's errors: a newton3_compact model pairs with staircase
        batches and only it; a newton3 model refuses a list with a
        reciprocal pair (a full list); an inverse_lists model refuses
        lists that are no per-slot involution.'''
        compact = self.model.newton3_compact
        if compact != ('nlist_stair' in batch):
            raise ValueError(
                'newton3_compact models pair with staircase batches '
                "(data.precompute_nlist mode: 'newton3c') and vice versa; "
                f'model compact={compact}, batch '
                f'{"carries" if "nlist_stair" in batch else "lacks"} '
                'nlist_stair')
        if 'nlist_idx' not in batch:
            return
        idx = np.asarray(batch['nlist_idx'])[0]
        mask = np.asarray(batch['nlist_mask'])[0]
        n = idx.shape[0]
        if self.model.newton3:
            rows = np.repeat(np.arange(n), idx.shape[1])[mask.ravel()]
            cols = idx.ravel()[mask.ravel()]
            fwd = set(zip(rows.tolist(), cols.tolist()))
            if any((j, i) in fwd for i, j in fwd):
                raise ValueError(
                    'newton3 model fed a full/symmetric neighbor list '
                    '(reciprocal edge found) -- set '
                    "data.precompute_nlist mode: 'newton3'")
        elif self.model.inverse_lists:
            ii = np.where(mask, idx, np.arange(n)[:, None])
            if not (np.take_along_axis(ii, ii, axis=0)
                    == np.arange(n)[:, None]).all():
                raise ValueError(
                    'inverse_lists model fed lists that are not '
                    'symmetric-slotted (per-slot involution fails) -- set '
                    "data.precompute_nlist mode: 'inverse'")

    def _metrics(self, loss, preds, batch, edges):
        metrics = {'loss': loss}
        evals = self.eval_loss(preds, batch)
        metrics.update({k: evals[k] for k in sorted(evals)})
        if edges and batch['z'].shape[-1] > 2048:
            # the JAX Trainer counts no edges above 2048 atoms, where the
            # pair tensor would rival the model's own memory
            metrics['edges'] = torch.zeros((), dtype=torch.float32,
                                           device=batch['z'].device)
        elif edges:
            _, adj = dense_graph(batch['pos'], batch['cell'],
                                 batch['z'] > 0, self.model.cutoff)
            metrics['edges'] = adj.sum().to(torch.float32)
        return metrics

    def loss_and_grad(self, batch):
        '''The loss of a batch of device tensors and its parameter gradient
        (left in each parameter's .grad) by the step fast_grad chose:
        -> (loss, detached predictions).'''
        step = fastgrad.value_and_grad if self.fast_grad else \
            standard_value_and_grad
        return step(self.model, self.main_loss, batch,
                    nlist=self._batch_nlist(batch))

    def _shard(self, batch):
        '''This rank's rows of a numpy batch with the global counts (with a
        mesh), or the batch.'''
        if self.mesh is None:
            return batch
        return global_data_batch(self.mesh, batch)

    def _data_group(self):
        return None if self.mesh is None else self.mesh.group('data')

    def reduce_gradients(self):
        '''Sum the parameters' gradients over the mesh's data group, as one
        flat buffer in the order of model.core.parameters() (parameters
        without a gradient, frozen ones, are left out on every rank).'''
        group = self._data_group()
        if group is None:
            return
        grads = [p.grad for p in self.model.core.parameters()
                 if p.grad is not None]
        if not grads:
            return
        flat = collectives.all_reduce_sum(
            torch.cat([g.reshape(-1) for g in grads]), group)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()

    def train_step(self, batch):
        '''One optimizer step on a numpy batch; -> its metrics as 0-d
        tensors on the device: loss, the eval battery and the edge count
        (with a mesh, this rank's partial sums of the global batch's).'''
        b = self._to_device(self._shard(batch))
        with fp32_matmuls():
            loss, preds = self.loss_and_grad(b)
            self.reduce_gradients()
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
        b = self._to_device(self._shard(batch))
        with fp32_matmuls():
            preds = model(b['z'], b['pos'], b['cell'],
                          nlist=self._batch_nlist(b, model))
            return self._metrics(self.main_loss(preds, b), preds, b,
                                 edges=False)

    def run_one_epoch(self, generator, step=False, model=None):
        '''One pass over a loader; the metrics averaged per batch (with a
        mesh, the global batches': summed over the data group once, at the
        end).'''
        totals, n = None, 0
        for batch in generator:
            if n == 0:
                self._check_batch_nlist(batch)
            m = self.train_step(batch) if step else \
                self.eval_step(batch, model)
            totals = m if totals is None else \
                {k: totals[k] + v for k, v in m.items()}
            n += 1
        if totals and self._data_group() is not None:
            keys = list(totals)
            summed = collectives.all_reduce_sum(
                torch.stack([totals[k].to(torch.float64) for k in keys]),
                self._data_group())
            totals = dict(zip(keys, summed))
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

            if epoch % self.check_log == 0 and self._keeps_best:
                val_loss = log_one_epoch.get('val_loss', float('inf'))
                if val_loss < self.best_val_loss:
                    self.best_val_loss = val_loss
                    # every rank keeps the best parameters for the final
                    # re-evaluation (no shared disk)
                    self._best_state = {
                        k: v.detach().clone() for k, v in
                        self.model.core.state_dict().items()}
                    if self.model_path is not None:
                        ckpt.save_model(os.path.join(self.model_path,
                                                     'best_model.msgpack'),
                                        self.model)
                    log_one_epoch['best_model'] = True
                if self.model_path is not None:
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

            if epoch % self.check_log == 0 and self._keeps_best:
                if self.model_path is not None:
                    self._save_checkpoint(epoch, step)
                # every rank stops together: the schedulers see the same
                # global metrics
                if (self.lr_scheduler is not None
                        and self.lr_scheduler.should_stop):
                    break

        print('Training finished')
        if not self._keeps_best:
            return
        if self.model_path is not None:
            ckpt.save_model(os.path.join(self.model_path,
                                         'last_model.msgpack'), self.model)
        # the last and best models re-evaluated from the parameters in
        # memory, on every rank (with a mesh the eval epochs are
        # collectives); only the chief has files to write
        finals = [('last', self.model)]
        if self._best_state is not None:
            best = copy.deepcopy(self.model)
            best.core.load_state_dict(self._best_state)
            finals.append(('best', best))
        for tag, model in finals:
            log_one_epoch = {'epoch': tag}
            for name, gen in (('train', self.train_generator),
                              ('val', self.val_generator),
                              ('test', self.test_generator)):
                if gen is not None:
                    log = self.run_one_epoch(gen, model=model)
                    log_one_epoch |= {f'{name}_{k}': v
                                      for k, v in log.items()}
            if self.output_path is not None:
                self.local_log(log_one_epoch)
