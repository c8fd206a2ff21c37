'''newtonnet_tpu_torch: the PyTorch / CUDA port of newtonnet_tpu.

Serves the NewtonNet energy model (energy, forces, virial, stress) and
trains it (energy + force losses) on an NVIDIA Hopper GPU through
hand-written CUDA kernels for the fused pair interaction and its dual for
the parameter gradient, over the dense graph (csrc/fused_dense.cu,
csrc/fused_dual.cu) or over neighbour lists (csrc/fused_klist.cu); and it
serves kernel='xla' checkpoints (the default) as plain PyTorch, whose
inverse-list gathers run the hand-written row gather (csrc/row_gather.cu;
the windowed gather ops are csrc/window.cu). The kernels are built with
nvcc at first use. It imports torch and numpy only: no JAX and nothing of
newtonnet_tpu.

Entry points run on CUDA unless the caller passes device='cpu'. A model
exported by utils/export.py replays through ServedModel with the op
modules alone.
'''
# the entry points import at first use, so that importing a module of the
# package (utils/export's ServedModel, an op module) loads no model code
_LAZY = {'NewtonNet': 'newtonnet_tpu_torch.models.output',
         'NewtonNetCalculator': 'newtonnet_tpu_torch.md.calculator',
         'Trainer': 'newtonnet_tpu_torch.train.trainer',
         'load_model': 'newtonnet_tpu_torch.utils.checkpoint',
         'save_model': 'newtonnet_tpu_torch.utils.checkpoint'}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def main(argv=None):
    '''The training CLI (newtonnet_tpu_torch.train.cli), imported when
    called so that `python -m newtonnet_tpu_torch.train.cli` runs it
    fresh.'''
    from newtonnet_tpu_torch.train.cli import main as cli_main
    return cli_main(argv)

__all__ = ['NewtonNet', 'NewtonNetCalculator', 'Trainer', 'load_model',
           'main', 'save_model']
__version__ = '0.2.0'
