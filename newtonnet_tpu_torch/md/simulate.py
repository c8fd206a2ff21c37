'''Aspirin MD with the port: the counterpart of the JAX package's
scripts/simulate.py, with its flags and setup.

    python -m newtonnet_tpu_torch.md.simulate [--model CKPT] [--xyz XYZ]
        [--steps 20000] [--out DIR] [--on-device] [--device cuda|cpu]

Langevin dynamics of the first frame of --xyz from rest at 300 K, 0.5 fs
steps, friction 1/(500 fs), logging every 100 steps to DIR/md.log (Time[ps]
Etot Epot Ekin T[K]):

  * default: the host-loop integrator (md/integrators.Langevin, numpy
    default_rng(0) noise) over the calculator, with the trajectory in
    DIR/md.traj.xyz;
  * --on-device: the whole trajectory on the device
    (md/driver.run_langevin_on_device, seed 0), md.log written from its
    strided log.

Runs on CUDA (raises without a CUDA device) unless --device cpu.
'''
import argparse
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description='Aspirin MD with the '
                                     'PyTorch port of NewtonNet')
    parser.add_argument('--model', default=os.path.join(
        ROOT, 'artifacts', 'md17_model', 'best_model.msgpack'))
    parser.add_argument('--xyz', default=os.path.join(
        ROOT, 'data', 'md17_aspirin', 'ccsd_test', 'raw',
        'aspirin_ccsd-test.xyz'))
    parser.add_argument('--steps', type=int, default=20000)
    parser.add_argument('--out', default='md17_md')
    parser.add_argument('--on-device', action='store_true',
                        help='run the whole trajectory on the device')
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                        help='cuda (default; raises without a CUDA device) '
                             'or cpu')
    args = parser.parse_args(argv)

    import numpy as np

    from newtonnet_tpu_torch.data import units
    from newtonnet_tpu_torch.data.xyz import read_extxyz
    from newtonnet_tpu_torch.md.calculator import NewtonNetCalculator
    from newtonnet_tpu_torch.md.integrators import Langevin, log_header, \
        log_line
    from newtonnet_tpu_torch.md.system import System
    from newtonnet_tpu_torch.models.output import resolve_device

    device = resolve_device(None if args.device == 'cuda' else 'cpu')
    print('Running aspirin MD simulation with the NewtonNet port...')
    system = System.from_frame(read_extxyz(args.xyz)[0])
    calc = NewtonNetCalculator(model_path=args.model,
                               properties=['energy', 'forces'],
                               precision='float32', device=device)
    system.calc = calc
    os.makedirs(args.out, exist_ok=True)
    timestep, every = 0.5 * units.fs, 100
    if args.on_device:
        from newtonnet_tpu_torch.md.driver import run_langevin_on_device
        system, log = run_langevin_on_device(
            calc.model, None, system, timestep=timestep, temperature_K=300,
            friction=1 / (500 * units.fs), n_steps=args.steps,
            log_every=every)
        with open(os.path.join(args.out, 'md.log'), 'w') as f:
            f.write(log_header())
            for i, (ep, ek, t) in enumerate(zip(log['epot'], log['ekin'],
                                                log['temperature'])):
                f.write(log_line(i * every * timestep / units.ps, ep, ek, t))
    else:
        dyn = Langevin(
            system, timestep=timestep, temperature_K=300,
            friction=1 / (500 * units.fs),
            logfile=os.path.join(args.out, 'md.log'),
            trajectory=os.path.join(args.out, 'md.traj.xyz'),
            loginterval=every, rng=np.random.default_rng(0))
        dyn.run(args.steps)
    print('MD simulation finished')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
