'''Offline processing of a dataset root into its processed/ cache, so that
training starts without parsing the raw files (the JAX package's
scripts/preprocess.py; either package reads the cache the other writes):

    python -m newtonnet_tpu_torch.data.preprocess -r ROOT [-p single]
        [--in-memory | --no-in-memory]

ROOT holds raw/*.{xyz,extxyz,npz}. --in-memory (the default) writes
processed/data.npz (MolecularInMemoryDataset), --no-in-memory one
processed/data_{i}.npz per frame (MolecularDataset). The cache is written
anew even where one exists.
'''
import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Preprocess raw data for NewtonNet training.')
    parser.add_argument('-r', '--root', type=str, required=True,
                        help='The path to the raw data root directory.')
    parser.add_argument('-p', '--precision', type=str, default='single',
                        help='The precision of the data. Default: single.')
    parser.add_argument('--in-memory', action=argparse.BooleanOptionalAction,
                        default=True,
                        help='Whether to store as one in-memory npz.')
    args = parser.parse_args(argv)

    from newtonnet_tpu_torch.data.loader import (
        MolecularDataset,
        MolecularInMemoryDataset,
    )
    from newtonnet_tpu_torch.layers.precision import get_precision_by_string
    precision = np.dtype(
        str(get_precision_by_string(args.precision)).split('.')[-1])
    cls = MolecularInMemoryDataset if args.in_memory else MolecularDataset
    data = cls(root=args.root, precision=precision, force_reload=True)
    print(f'processed {len(data)} frames (max atoms {data.max_atoms})')
    print('done!')
    return data


if __name__ == '__main__':
    main()
