#!/usr/bin/env python3
'''Where kernels K3 and K4 (dual_fwd_kernel / dual_bwd_kernel of
newtonnet_tpu_torch/csrc/fused_dual.cu) and their wrappers spend their
time on the card; with the argument `k2k7`, kernels K2 (pair_bwd_kernel,
csrc/fused_dense.cu) and K7 (klist_dual_fwd_kernel, csrc/fused_klist.cu).

    python3 dual_breakdown.py [k2k7]

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

With `k2k7` the variants are no_products (k2_prod / k7_pair run no chunk:
no staging, no tensor-core product) and no_mma (the chunks are staged and
their fragments loaded, but no mma is issued), beside the source as it is;
it prints one JSON line per source and variant: K2's device milliseconds
per call at the serving shape (B=100, N=21) and at the training shape
(B=10, N=24), and K7's milliseconds per call at the box shape (B=1,
N=4096, K=88, bf16 edges; CUDA events, chip_smoke.time_ms), full and
first layer, no weight cotangents.
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


# the K2 and K7 variants, by source
K2K7_VARIANTS = {
    'fused_dense': {
        'as_is': [],
        'no_products': [('  const int nch = Qp / KC2;',
                         '  const int nch = 0 * Qp;')],
        'no_mma': [('          mma3(d[x][j], ah, al, bh, bl);',
                    '          d[x][j][0] += __uint_as_float(ah[0] ^ bh[0]'
                    ' ^ al[1] ^ bl[1]);')]},
    'fused_klist': {
        'as_is': [],
        'no_products': [('  const int nch = Qp / KC7;\n  // chunk v',
                         '  const int nch = 0 * Qp;\n  // chunk v')],
        'no_mma': [(f'        for (int x = 0; x < 2; ++x) mma_tf32(d[x][j], '
                    f'{a}[x], {b}[j]);',
                    f'        for (int x = 0; x < 2; ++x) d[x][j][{e}] += '
                    f'__uint_as_float({a}[x][{e}] ^ {b}[j][1]);')
                   for e, (a, b) in enumerate((('al', 'bh'), ('ah', 'bl'),
                                               ('ah', 'bh')))]}}


def build(source='fused_dual', variants=VARIANTS):
    '''{variant: path of its shared library}, built all at once.'''
    from newtonnet_tpu_torch.ops import _build
    with open(os.path.join(_build.SRC_DIR, source + '.cu')) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'{name}: {old!r} is not in the source')
            text = text.replace(old, new)
        cu = os.path.join(OUT, f'{source}_{name}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        so = os.path.join(OUT, f'lib{source}_{name}.so')
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


def k2k7(torch, cs, card):
    '''The K2 and K7 lines (module docstring).'''
    import threading
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import fused_dense as fd
    from newtonnet_tpu_torch.ops import fused_klist as fk
    built = {}
    threads = [threading.Thread(target=lambda s=src, v=vs: built.update(
        {s: build(s, v)})) for src, vs in K2K7_VARIANTS.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    pair = {s: cs.random_inputs(torch, s[0], s[1], 128, 20, seed=0)
            for s in ((100, 21), (10, 24))}
    box = {}
    for first in (False, True):
        ins, tans, cots = cs.klist_inputs(torch, 1, cs.BOX_ATOMS,
                                          cs.BOX_K_MAX, 128, 20, first,
                                          torch.bfloat16, seed=30)
        box[first] = cs.klist_calls(fk, ins, tans, cots, first)[
            'klist_dual_fwd']
    for src, libs in built.items():
        for name, so in libs.items():
            _build._LIBS[src] = ctypes.CDLL(so)  # the wrapper's library
            ms = {}
            for first in (False, True):
                tag = 'first' if first else 'full'
                if src == 'fused_dense':
                    for (B, N), (ins, dinv1, deq) in pair.items():
                        def fn(ins=ins, dinv1=dinv1, deq=deq, first=first):
                            fd.pair_interaction_bwd(
                                *ins, dinv1, deq, first_layer=first,
                                weight_grads=False)
                        ms[f'K2 B={B} N={N} {tag} device'] = \
                            cs.device_ms(torch, fn)
                else:
                    f, a, kw = box[first]
                    ms[f'K7 box {tag}'] = cs.time_ms(
                        torch, lambda: f(*a, first_layer=first, **kw),
                        inner=3)
            print(json.dumps({'source': src, 'variant': name, 'ms': ms,
                              'card': card}), flush=True)


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

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if sys.argv[1:] == ['k2k7']:
        k2k7(torch, cs, card)
        return 0
    libs = build()
    args, cots = cs.dual_inputs(torch, 10, 24, 128, 20, seed=0)
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
