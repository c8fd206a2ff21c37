from newtonnet_tpu_torch.md.calculator import NewtonNetCalculator
from newtonnet_tpu_torch.md.integrators import (
    BerendsenNPT,
    BerendsenNVT,
    Langevin,
    MDLogger,
    NoseHooverChain,
    VelocityVerlet,
)
from newtonnet_tpu_torch.md.system import System, maxwell_boltzmann
from newtonnet_tpu_torch.md.optimize import FIRE
