#!/usr/bin/env python3
'''Where kernels K3 and K4 (dual_fwd_kernel / dual_bwd_kernel of
newtonnet_tpu_torch/csrc/fused_dual.cu) and their wrappers spend their
time on the card.

    python3 dual_breakdown.py

Builds the source as it is and in variants with one part taken out
(written to newtonnet_tpu_torch/_build/dual_breakdown/, gitignored; all
nvcc runs at once): no_wgrad (wgrad_pair returns at its first barrier), no_wstore (the
weight-cotangent partials are computed but stored only where a value
equals 1234.5, which keeps the products from being optimised away),
no_products (tc_pair runs no chunk: no staging, no tensor-core product),
no_mma (tc_pair stages its chunks but issues no mma). A variant computes
wrong numbers; only its time is read. At chip_smoke.py's training shape (B=10,
N=24, F=128, R=20), full and first layer, it prints one JSON line per
variant and dot mode: the device microseconds per call of each kernel
(torch.profiler over 20 calls) and, for the source as it is, the host
microseconds per wrapper call (host clock over 50 calls, no synchronise:
checks, allocations, the ctypes call and the launches). Needs a CUDA card
and nvcc.
'''
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, 'newtonnet_tpu_torch', '_build', 'dual_breakdown')
VARIANTS = {
    'as_is': [],
    'no_wgrad': [('  __syncthreads();\n  const int n_groups',
                  '  __syncthreads();\n  return;\n  const int n_groups')],
    'no_wstore': [('      if (qa < qrows)\n',
                   '      if (qa < qrows && d[0][j][0] == 1234.5f)\n'),
                  ('      if (qb < qrows)\n',
                   '      if (qb < qrows && d[0][j][2] == 1234.5f)\n')],
    'no_products': [('  const int nch = Qp / S::KC;',
                     '  const int nch = 0 * Qp;')],
    'no_mma': [('          mma_bf16(d[0][j], a[0], b);\n'
                '          mma_bf16(d[1][j], a[1], b);',
                '          d[0][j][0] += __uint_as_float(a[0][0] ^ b[0]);\n'
                '          d[1][j][0] += __uint_as_float(a[1][0] ^ b[1]);'),
               ('          mma3(d[0][j], ah[0], al[0], bh, bl);\n'
                '          mma3(d[1][j], ah[1], al[1], bh, bl);',
                '          d[0][j][0] += __uint_as_float(ah[0][0] ^ bh[0]);\n'
                '          d[1][j][0] += __uint_as_float(al[1][0] ^ bl[1]);')],
}


def build():
    '''{variant: path of its shared library}, built all at once.'''
    from newtonnet_tpu_torch.ops import _build
    with open(os.path.join(_build.SRC_DIR, 'fused_dual.cu')) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'{name}: {old!r} is not in the source')
            text = text.replace(old, new)
        cu = os.path.join(OUT, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        so = os.path.join(OUT, f'lib{name}.so')
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        libs[name] = so
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print('dual_breakdown: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import fused_dual as fdd

    libs = build()
    args, cots = cs.dual_inputs(torch, 10, 24, 128, 20, seed=0)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    for name, so in libs.items():
        _build._LIBS['fused_dual'] = ctypes.CDLL(so)  # the wrapper's library
        for dt in ('bfloat16', 'float32'):
            dev, host = {}, {}
            for kind in ('fwd', 'bwd'):
                for first in (False, True):
                    kw = dict(first_layer=first, dot_dtype=dt)
                    if kind == 'fwd':
                        def fn(kw=kw):
                            fdd.pair_interaction_dual_fwd(*args, **kw)
                    else:
                        def fn(kw=kw):
                            fdd.pair_interaction_dual_bwd(*args, *cots, **kw)
                    call = f'{kind}{"_first" if first else ""}'
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(50):
                        fn()
                    host[call] = 1e6 * (time.perf_counter() - t) / 50
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(20):
                            fn()
                        torch.cuda.synchronize()
                    for e in prof.key_averages():
                        if e.self_device_time_total > 0:
                            kname = e.key.split('::')[-1].split('(')[0]
                            dev[f'{call} {kname.split("<")[0]}'] = \
                                e.self_device_time_total / 20
            line = {'variant': name, 'dot_dtype': dt, 'device_us': dev,
                    'card': card}
            if name == 'as_is':
                line['host_us_per_call'] = host
            print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
