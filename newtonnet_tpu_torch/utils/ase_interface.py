'''ASE Calculator bridge (the JAX package's `utils/ase_interface.py`;
reference: newtonnet/utils/ase_interface.py).

When ASE is installed, MLAseCalculator plugs the port's calculator
(md/calculator.NewtonNetCalculator) into ase.md / ase.optimize drivers with
the reference calculator's surface (implemented_properties, Voigt stress,
the Hessian's shape). Where ASE is absent, the native equivalents live in
newtonnet_tpu_torch.md (System and the integrators share the same
calculator), and constructing MLAseCalculator raises ImportError.
'''
import numpy as np

from newtonnet_tpu_torch.md.calculator import NewtonNetCalculator

try:
    from ase.calculators.calculator import Calculator, all_changes
    HAVE_ASE = True
except ImportError:  # ASE not installed
    HAVE_ASE = False

    class Calculator:  # minimal stand-in so the class definition loads
        def __init__(self, **kwargs):
            self.results = {}
    all_changes = None

PRETRAINED = ('ani1', 'ani1x', 't1x')


class MLAseCalculator(Calculator):
    '''ASE Calculator for NewtonNet models of the port.

    Args:
        model_path: .msgpack checkpoint, reference .pt pickle, a list of
            them (an ensemble), or a pretrained alias ('ani1' | 'ani1x' |
            't1x', fetched or found in the cache by utils/pretrained.py).
        properties: subset of implemented_properties.
        device: CUDA unless 'cpu' is passed (raises with no CUDA device).
        precision: 'float32' | 'float64' (the CPU only).
    '''
    implemented_properties = ['charges', 'bec', 'energy', 'free_energy',
                              'forces', 'hessian', 'stress']

    def __init__(self, model_path, properties=None, device=None,
                 precision='float32', **kwargs):
        if not HAVE_ASE:
            raise ImportError(
                'ase is not installed; use newtonnet_tpu_torch.md.System '
                'with NewtonNetCalculator instead')
        Calculator.__init__(self, **kwargs)
        if model_path in PRETRAINED:
            from newtonnet_tpu_torch.utils.pretrained import \
                download_checkpoint
            model_path = download_checkpoint(model_path)
        self.engine = NewtonNetCalculator(model_path=model_path,
                                          properties=properties,
                                          precision=precision, device=device)
        self.properties = self.engine.properties

    def calculate(self, atoms=None, properties=None, system_changes=None):
        super().calculate(atoms, self.properties,
                          system_changes or all_changes)
        pbc = atoms.get_pbc()
        cell = np.array(atoms.get_cell())
        cell[~pbc] = 0.0  # ref ase_interface.py:138
        out = self.engine.calculate(
            numbers=atoms.get_atomic_numbers(),
            positions=atoms.get_positions(wrap=pbc.any()),
            cell=cell)
        self.results.update(out)
