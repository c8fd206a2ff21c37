'''Serving artifacts: the inference step captured once and replayed without
the model's code (the JAX package's `utils/export.py`).

`export_inference` traces the whole inference step at a fixed
(batch_size, n_pad) shape, every requested head included (forces, stress
and the Hessian are autograd and torch.func compositions, traced like any
other op), with the parameters captured as constants:

1. `make_fx` (fake tensors) records the step below autograd: the forward,
   the reverse passes and the Hessian's vmap of jvp of grad become one flat
   graph of aten ops and the port's custom ops, `newtonnet_tpu_torch::
   pair_fwd`, `pair_bwd` (K1/K2), `klist_fwd`, `klist_bwd` (K5/K6) and
   `row_gather` (K9/K12). The plain list's transpose pads to the list's
   capacity (ops/nlist.fixed_degree), so the graph has fixed shapes and no
   host read.
2. `torch.export.export` turns that graph into an ExportedProgram, which
   `torch.export.save` writes.

`torch.export` alone cannot take the step: an einsum's backward under
`torch.autograd.grad` leaves a fake constant in the program, and
`torch.func`'s transforms do not run under its tracer.

Artifact layout (.npz), as the JAX package's:
    header  -- one JSON string: format/version, padded shapes, dtype,
               output property names, platforms, matmul precision, model
               config.
    blob    -- the bytes of torch.export.save (uint8).

The format string is the port's own: a JAX artifact (StableHLO) and a
port artifact (an ExportedProgram) do not replay in each other's
ServedModel, and each refuses the other's by name.

`ServedModel` replays an artifact with no model code: it imports the op
modules (whose custom ops the program calls; the kernels build at first
launch) and never `newtonnet_tpu_torch.models`. TF32 is process state in
torch, not part of a graph, so it pins IEEE fp32 products
(layers/precision.fp32_matmuls) around every call, as the header's
'highest' asks.
'''
import copy
import importlib
import io
import json

import numpy as np
import torch

from newtonnet_tpu_torch.layers.precision import (
    check_matmul_precision,
    fp32_matmuls,
    get_precision_by_string,
)

FORMAT = 'newtonnet-tpu-torch-serving'
JAX_FORMAT = 'newtonnet-tpu-serving'
VERSION = 1
# the modules that register the custom ops an artifact may call
OP_MODULES = ('newtonnet_tpu_torch.ops.fused_dense',
              'newtonnet_tpu_torch.ops.fused_klist',
              'newtonnet_tpu_torch.ops.row_gather')


def _round_up(x, m=8):
    return max(m, ((x + m - 1) // m) * m)


def _plain_list_model(model):
    '''The model over the plain full list, with the same parameters: the
    newton3, newton3_compact, inverse and reverse layouts need lists built
    on the host per structure, which a captured program cannot run (as
    the JAX exporter serves them). The newton3 family's k_max is the half
    list's capacity; the full list takes 2*k_max + 8 (data/prelists.py).'''
    from newtonnet_tpu_torch.models.output import NewtonNet
    if not (model.newton3 or model.newton3_compact or model.inverse_lists
            or model.reverse_lists):
        return model
    cfg = model.config_dict()
    if cfg['newton3'] or cfg['newton3_compact']:
        cfg['k_max'] = 2 * cfg['k_max'] + 8
    for key in ('newton3', 'newton3_compact', 'inverse_lists',
                'reverse_lists'):
        cfg[key] = False
    plain = NewtonNet(**cfg, device=model.device,
                      dtype=model.core.node_embedding.dtype)
    plain.load_state_dict(model.state_dict())
    plain.ewald_mode = model.ewald_mode
    return plain.requires_grad_(False).eval()


class _Program(torch.nn.Module):
    '''The traced step as the module torch.export takes.'''

    def __init__(self, graph):
        super().__init__()
        self.step = graph

    def forward(self, z, pos, cell):
        return self.step(z, pos, cell)


def export_inference(model, params=None, n_atoms=None, batch_size=1,
                     properties=None, dtype='float32',
                     matmul_precision='highest', platforms=None,
                     periodic=None):
    '''Capture the inference step for serving.

    Args:
        model: a NewtonNet of this package, on the device the artifact
            serves (CUDA, or the CPU where the caller asked for it).
        params: None for the model's own weights, or a flax-named tree
            {'params': {...}} (the JAX package's parameters) loaded into a
            copy of the model. Captured as constants.
        n_atoms: the most atoms the artifact serves (padded up to a
            multiple of 8, as the calculator pads).
        batch_size: systems per call.
        properties: model output names to emit (default: the model's
            output_properties); a name the model lacks raises ValueError.
        dtype: position and cell dtype ('float32'; 'float64' on the CPU).
        matmul_precision: 'highest' (or None): the port's products are IEEE
            fp32, and the replay pins that; others raise ValueError.
        platforms: None, or the one platform of the model's device
            ('cuda' or 'cpu'): a captured program runs where it was
            captured.
        periodic: True/False resolves a charge-head model's ewald_mode
            'auto' to one Ewald branch (NewtonNet.with_ewald_mode); None
            keeps 'auto', which computes both branches and picks per graph.

    Returns:
        (header dict, artifact bytes) -- save_serving_artifact writes the
        .npz file.
    '''
    from torch.fx.experimental.proxy_tensor import make_fx

    from newtonnet_tpu_torch.ops.nlist import fixed_degree
    from newtonnet_tpu_torch.utils.params import params_from_flax

    check_matmul_precision(matmul_precision, 'matmul_precision')
    if n_atoms is None:
        raise ValueError('n_atoms is required')
    device = model.device
    if platforms is not None and [str(p) for p in platforms] != [device.type]:
        raise ValueError(
            f'platforms={list(platforms)}: a captured program runs on the '
            f'device it was captured on ({device.type}); load the model on '
            f'the device to serve')
    t_dtype = get_precision_by_string(dtype)
    if params is not None:
        from newtonnet_tpu_torch.models.output import NewtonNet
        own = NewtonNet(**model.config_dict(), device=device)
        params_from_flax(params, core=own.core)
        model = own
    if periodic is not None:
        model = model.with_ewald_mode('periodic' if periodic
                                      else 'aperiodic')
    model = _plain_list_model(model)
    props = list(properties or model.output_properties)
    missing = [p for p in props if p not in model.output_properties]
    if missing:
        raise ValueError(
            f'model has no output head(s) {missing}; rebuild the model '
            f'with output_properties covering them before exporting')
    if model.core.node_embedding.dtype != t_dtype:
        model = copy.deepcopy(model).to(t_dtype)
    n_pad = _round_up(int(n_atoms))
    B = int(batch_size)

    def infer(z, pos, cell):
        with fp32_matmuls(), fixed_degree():
            out = model(z, pos, cell)
        return tuple(out[k] for k in props)

    args = (torch.zeros((B, n_pad), dtype=torch.int64, device=device),
            torch.zeros((B, n_pad, 3), dtype=t_dtype, device=device),
            torch.zeros((B, 3, 3), dtype=t_dtype, device=device))
    graph = make_fx(infer, tracing_mode='fake',
                    _allow_non_fake_inputs=True)(*args)
    # the trace keeps what autograd computed and nothing read (a third of
    # a Hessian's nodes), which costs export, save and load time
    graph.graph.eliminate_dead_code()
    graph.recompile()
    program = torch.export.export(_Program(graph), args)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = {
        'format': FORMAT,
        'version': VERSION,
        'batch_size': B,
        'n_pad': n_pad,
        'dtype': str(t_dtype).split('.')[-1],
        'properties': props,
        'platforms': [device.type],
        'matmul_precision': matmul_precision or 'highest',
        'model_config': model.config_dict(),
    }
    return header, buf.getvalue()


def save_serving_artifact(path, header, blob):
    '''Write an export_inference result to one .npz artifact file.'''
    np.savez(path, header=np.asarray(json.dumps(header)),
             blob=np.frombuffer(blob, np.uint8))


def _resolve_device(device):
    '''models/output.resolve_device, which ServedModel does not import:
    the device given, else CUDA, raising where there is none.'''
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to replay a "
                           'CPU artifact on the CPU')
    return torch.device('cuda')


class ServedModel:
    '''Replay a serving artifact: load once, call per system or batch.

    No model code runs: the artifact replays its captured step at the
    exported shape. Inputs are padded here as the exporter padded them;
    outputs come back unpadded, as numpy.

    Args:
        path: artifact written by save_serving_artifact.
        device: CUDA unless 'cpu' is passed; raises where there is no CUDA
            device, and where the artifact was not captured for the device.
    '''

    def __init__(self, path, device=None):
        with np.load(path) as f:
            self.header = json.loads(str(f['header'][()]))
            blob = f['blob'].tobytes()
        fmt = self.header.get('format')
        if fmt != FORMAT:
            extra = (' (a JAX package artifact: replay it with '
                     'newtonnet_tpu.utils.export.ServedModel, or export the '
                     'checkpoint with newtonnet_tpu_torch.utils.'
                     'export_model)' if fmt == JAX_FORMAT else '')
            raise ValueError(f'{path}: a {fmt!r} artifact, not a {FORMAT} '
                             f'one{extra}')
        if self.header.get('version', 0) > VERSION:
            raise ValueError(
                f'{path}: artifact version {self.header["version"]} is '
                f'newer than this loader ({VERSION})')
        check_matmul_precision(self.header.get('matmul_precision'),
                               'the artifact\'s matmul_precision')
        self.device = _resolve_device(device)
        if self.device.type not in self.header['platforms']:
            raise ValueError(
                f'artifact was captured for {self.header["platforms"]}, not '
                f'{self.device.type}; export it on that device')
        for name in OP_MODULES:
            importlib.import_module(name)
        self._program = torch.export.load(io.BytesIO(blob)).module()
        self.properties = list(self.header['properties'])
        self.n_pad = int(self.header['n_pad'])
        self.batch_size = int(self.header['batch_size'])
        self.dtype = get_precision_by_string(self.header['dtype'])

    def call_raw(self, z, pos, cell):
        '''Run at the exported padded shapes: z (B, n_pad) int, pos (B,
        n_pad, 3), cell (B, 3, 3), numpy or tensors; returns the padded
        outputs as tensors on the device, keyed by property.'''
        z, pos, cell = (torch.as_tensor(a).to(self.device, dt) for a, dt in (
            (z, torch.int64), (pos, self.dtype), (cell, self.dtype)))
        if z.shape != (self.batch_size, self.n_pad):
            raise ValueError(
                f'call_raw takes the exported shapes: z {tuple(z.shape)}, '
                f'expected {(self.batch_size, self.n_pad)}')
        with fp32_matmuls(), torch.no_grad():
            outs = self._program(z, pos, cell)
        return dict(zip(self.properties, outs))

    def __call__(self, numbers, positions, cell=None):
        '''Evaluate one system (or a list of up to batch_size systems).

        Returns a dict keyed by the exported property names with padding
        stripped; for a single system the batch axis is squeezed away.'''
        single = not isinstance(numbers, (list, tuple))
        num_list = [numbers] if single else list(numbers)
        pos_list = [positions] if single else list(positions)
        cell_list = ([cell] * len(num_list) if single or cell is None
                     or np.ndim(cell) == 2 else list(cell))
        if len(num_list) > self.batch_size:
            raise ValueError(
                f'{len(num_list)} systems > exported batch_size '
                f'{self.batch_size}')
        if len(pos_list) != len(num_list):
            raise ValueError(
                f'{len(num_list)} number lists but {len(pos_list)} '
                f'position arrays')
        if len(cell_list) != len(num_list):
            raise ValueError(
                f'{len(num_list)} systems but {len(cell_list)} cells; pass '
                f'one 3x3 cell (shared) or exactly one per system')
        counts = [len(n) for n in num_list]
        if max(counts) > self.n_pad:
            raise ValueError(
                f'{max(counts)} atoms > exported capacity {self.n_pad}')
        B, n_pad = self.batch_size, self.n_pad
        np_dtype = np.dtype(self.header['dtype'])
        z = np.zeros((B, n_pad), np.int64)
        pos = np.zeros((B, n_pad, 3), np_dtype)
        c = np.zeros((B, 3, 3), np_dtype)
        for i, (ni, pi, ci) in enumerate(zip(num_list, pos_list, cell_list)):
            z[i, :counts[i]] = ni
            pos[i, :counts[i]] = pi
            if ci is not None:
                c[i] = ci
        out = {k: v.cpu().numpy() for k, v in self.call_raw(z, pos, c).items()}
        results = []
        for i, n in enumerate(counts):
            r = {}
            for k, v in out.items():
                if k == 'energy':
                    r[k] = float(v[i])
                elif k == 'hessian':
                    r[k] = v[i, :n, :, :n, :]
                elif v.ndim >= 2 and v.shape[1] == n_pad:
                    r[k] = v[i, :n]
                else:
                    r[k] = v[i]
            results.append(r)
        return results[0] if single else results
