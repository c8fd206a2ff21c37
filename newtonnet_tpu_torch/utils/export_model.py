'''Export a trained checkpoint to a serving artifact (the JAX package's
scripts/export_model.py):

    python -m newtonnet_tpu_torch.utils.export_model \
        --checkpoint best_model.msgpack --n-atoms 21 --out serving.npz \
        [--batch 1] [--properties energy gradient_force] [--device cuda] \
        [--dtype float32] [--periodic | --aperiodic]

The artifact replays through newtonnet_tpu_torch.utils.export.ServedModel
on the device it was exported on, with the port's op modules and no model
code (utils/export.py).
'''
import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--checkpoint', required=True,
                    help='.msgpack checkpoint (or reference .pt)')
    ap.add_argument('--n-atoms', type=int, required=True,
                    help='max atoms the artifact serves (padded to x8)')
    ap.add_argument('--out', required=True, help='output .npz artifact')
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--properties', nargs='*', default=None,
                    help='model output names (default: all trained heads)')
    ap.add_argument('--platforms', nargs='*', default=None,
                    help="the export device's platform, cuda or cpu "
                         '(default: that of --device)')
    ap.add_argument('--dtype', default='float32')
    ap.add_argument('--matmul-precision', default='highest')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                    help='the device the artifact runs on (default cuda)')
    ap.add_argument('--periodic', action='store_true', default=None,
                    help="statically resolve a charge-head model's "
                         "ewald_mode='auto' to the periodic branch "
                         "(single-branch artifact)")
    ap.add_argument('--aperiodic', dest='periodic', action='store_false',
                    help='resolve to the aperiodic branch instead')
    args = ap.parse_args(argv)

    from newtonnet_tpu_torch.models.output import resolve_device
    from newtonnet_tpu_torch.utils.export import (export_inference,
                                                  save_serving_artifact)
    device = resolve_device('cpu' if args.device == 'cpu' else None)
    if args.checkpoint.endswith('.pt'):
        from newtonnet_tpu_torch.utils.torch_import import \
            load_reference_model
        model = load_reference_model(args.checkpoint, device=device)
    else:
        from newtonnet_tpu_torch.utils.checkpoint import load_model
        model = load_model(args.checkpoint, device=device)

    header, blob = export_inference(
        model, None, n_atoms=args.n_atoms, batch_size=args.batch,
        properties=args.properties, dtype=args.dtype,
        matmul_precision=args.matmul_precision, platforms=args.platforms,
        periodic=args.periodic)
    save_serving_artifact(args.out, header, blob)
    print(f'wrote {args.out}: {os.path.getsize(args.out)} bytes, '
          f'B={header["batch_size"]} n_pad={header["n_pad"]} '
          f'platforms={header["platforms"]} '
          f'properties={header["properties"]}')


if __name__ == '__main__':
    main()
