#!/usr/bin/env python3
'''Where kernels K3 and K4 (dual_fwd_kernel / dual_bwd_kernel of
newtonnet_tpu_torch/csrc/fused_dual.cu) and their wrappers spend their
time on the card; with the argument `k2k7`, kernels K2 (pair_bwd_kernel,
csrc/fused_dense.cu) and K7 (klist_dual_fwd_kernel, csrc/fused_klist.cu);
with `k6k1`, kernels K6 (klist_bwd_kernel) and K1 (pair_fwd_kernel).

    python3 dual_breakdown.py [k2k7 | k6k1 | k5k11 | k1train ROOT... |
                               steptime ROOT... | kerneltime ROOT... |
                               k2diag ROOT... | k78sass ROOT ROOT]

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

With `k6k1` the same three versions of K6 (klist_bwd_kernel, csrc/
fused_klist.cu: k6_prod) and K1 (pair_fwd_kernel, csrc/fused_dense.cu:
k1_prod): K6's milliseconds per call at the box shape (CUDA events, no
weight cotangents, the force pass's) and K1's device milliseconds per call
at the serving shape (B=100, N=21), full and first layer, and the weight
bytes one launch streams from L2 into shared memory, beside those of the
K7/K2 design (32-slot tiles) and of the CUDA-core kernels they replace.

With `k1train ROOT...` it times K1 at the training shape (B=10, N=24,
F=128, R=20) in the package of each checkout ROOT in turn, each in a
process of its own (its kernels built from its own sources): the device
milliseconds per call, full and first layer. Give the parent commit's
checkout (a `git archive` unpacked into a gitignored directory) and this
one in turns, e.g. `k1train runs/parent . . runs/parent`.

With `steptime ROOT...` it times chip_smoke.py's dense kernel='pallas'
fine-tuning step (phase 7a: scripts/config_md17_pallas.yml from the MD17
checkpoint, B=10, N=24, fastgrad with K1-K4, Adam) in the package of each
checkout ROOT in turn, each in a process of its own: the host-clock
milliseconds of 30 steps (three passes over the first 10 batches; the
median of steps 2-10, as phase 7a reports it, and of steps 2-30) and one
step under torch.profiler (device busy ms, idle share). Give the parent
and this checkout in turns, e.g. `steptime runs/parent . . runs/parent`.

With `kerneltime ROOT...` it times K1-K8 at F=128 at the shapes of
chip_smoke.py's timing phase (K1/K2 at B=100, N=21, R=20, K2 without
weight cotangents; K3/K4 at B=10, N=24 in bf16 mode; K5-K8 at the box
shape, bf16 edges, K6 without weight cotangents), full and first layer,
in the package of each checkout ROOT in turn, each in a process of its
own: CUDA-event milliseconds per call (chip_smoke.time_ms). Give the
parent and this checkout in turns, e.g. `kerneltime runs/parent . .
runs/parent`.

With `k2diag ROOT...` it compares K2 (pair_bwd_kernel, csrc/fused_dense.cu)
at F=128 across checkouts, each in a process of its own: the device
microseconds per call of each kernel of a K2 launch (the weight
preparation, pair_bwd_kernel, the node sums; torch.profiler over 20 calls
at B=100, N=21, R=20, no weight cotangents, full and first layer), and,
from the library the checkout's wrapper loads, the ptxas registers,
stack and spills and the SASS instruction counts by opcode (cuobjdump
-sass) of pair_bwd_kernel<128,*,*>, k2_prod, k2_wgrad and the node-sum and
preparation kernels. A last line gives the opcode counts of the second
root minus the first's, per function. E.g. `k2diag runs/parent .`.

With `k78sass ROOT ROOT` it builds csrc/fused_klist.cu of both checkouts
as ops/_build.py builds the fp32 libraries of F = 48, 128 and 256 (all
nvcc runs at once, into newtonnet_tpu_torch/_build/dual_breakdown/) and
compares their SASS (cuobjdump -sass) function by function, instruction
by instruction (addresses, encodings and the anonymous namespace's hash
dropped): one JSON line per width with the functions identical in both,
those that differ and those in one checkout only. Then the ptxas
registers, stack and spills of K7 and K8 (klist_dual_fwd_kernel,
klist_dual_bwd_kernel) in the second checkout's fp32 and bf16 libraries
of each width. E.g. `k78sass runs/parent .`: the fp32 libraries should
compile the parent's code.

With `k5k11`, kernel K5 (klist_fwd_kernel, csrc/fused_klist.cu: k5_prod)
as it is (16-atom tiles, 128 slot rows a step), with 8-atom tiles (m64: 64
rows a step, K6's), with two slots unrolled in its elementwise passes
(unroll2) or four (unroll4) against eight, with no product and with no
mma issued: its
milliseconds per call at the box shape (CUDA events), full and first layer,
and the weight bytes one launch streams at 128 and at 64 rows a step;
then kernel K11 (csrc/window.cu) at the window-op cell of chip_smoke.py,
as it is (four payload rows in flight per warp, 256-position segments),
with its segment sums built for two blocks per SM (lb2), with eight rows
in flight (rows8) and on 128-position segments (seg128): the device
microseconds per call of each
of its kernels (the radix passes' histogram, offsets and scatter, the run
bounds, the segment sums and the join; torch.profiler over 20 calls) and
its milliseconds per call (CUDA events) beside index_add_'s.

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
import difflib
import json
import os
import re
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
        'no_products': [('  const int nch = Qp / KC;',
                         '  const int nch = 0 * Qp;')],
        'no_mma': [('          mma3(d[x][j], ah, al, bh, bl);',
                    '          d[x][j][0] += __uint_as_float(ah[0] ^ bh[0]'
                    ' ^ al[1] ^ bl[1]);')]},
    'fused_klist': {
        'as_is': [],
        'no_products': [('  const int nch = Qp / KC;\n  // chunk v',
                         '  const int nch = 0 * Qp;\n  // chunk v')],
        'no_mma': [(f'        for (int x = 0; x < 2; ++x) mma_tf32(d[x][j], '
                    f'{a}[x], {b}[j]);',
                    f'        for (int x = 0; x < 2; ++x) d[x][j][{e}] += '
                    f'__uint_as_float({a}[x][{e}] ^ {b}[j][1]);')
                   for e, (a, b) in enumerate((('al', 'bh'), ('ah', 'bl'),
                                               ('ah', 'bh')))]}}


# the K6 and K1 variants, by source
K6K1_VARIANTS = {
    'fused_klist': {
        'as_is': [],
        'no_products': [('  const int nch = cur.qp / RW;',
                         '  const int nch = 0 * cur.qp;')],
        'no_mma': [(f'          for (int rg = 0; rg < RG; ++rg)\n'
                    f'            mma_tf32(d[o][rg][j], {a}[rg], {b}[j]);',
                    f'          for (int rg = 0; rg < RG; ++rg)\n'
                    f'            d[o][rg][j][{e}] += '
                    f'__uint_as_float({a}[rg][{e}] ^ {b}[j][1]);')
                   for e, (a, b) in enumerate((('al', 'bh'), ('ah', 'bl'),
                                               ('ah', 'bh')))]},
    'fused_dense': {
        'as_is': [],
        'no_products': [('  const int nch = cur.qp / RW;',
                         '  const int nch = 0 * cur.qp;')],
        'no_mma': [(f'          for (int rg = 0; rg < RG; ++rg)\n'
                    f'            mma_tf32(d[x][rg][j], {a}[rg], {b}[j]);',
                    f'          for (int rg = 0; rg < RG; ++rg)\n'
                    f'            d[x][rg][j][{e}] += '
                    f'__uint_as_float({a}[rg][{e}] ^ {b}[j][1]);')
                   for e, (a, b) in enumerate((('al', 'bh'), ('ah', 'bl'),
                                               ('ah', 'bh')))]}}


# the K5 variants
K5_VARIANTS = {
    'fused_klist': {
        'as_is': [],
        'm64': [('constexpr int TA5 = 16;', 'constexpr int TA5 = 8;')],
        'unroll2': [('constexpr int kRowUnroll5 = 8;',
                     'constexpr int kRowUnroll5 = 2;')],
        'unroll4': [('constexpr int kRowUnroll5 = 8;',
                     'constexpr int kRowUnroll5 = 4;')],
        'no_products': [('  const int n_chunks = cur.qp / RW;',
                         '  const int n_chunks = 0 * cur.qp;')],
        'no_mma': [(f'            mma_tf32(acc[x][rg][j], {a}[rg], {b}[j]);',
                    f'            acc[x][rg][j][{e}] += '
                    f'__uint_as_float({a}[rg][{e}] ^ {b}[j][1]);')
                   for e, (a, b) in enumerate((('al', 'bh'), ('ah', 'bl'),
                                               ('ah', 'bh')))]},
    'window': {
        'as_is': [],
        'lb2': [('constexpr int kSegMinBlocks = 1;',
                 'constexpr int kSegMinBlocks = 2;')],
        'rows8': [('constexpr int kRowsInFlight = 4;',
                   'constexpr int kRowsInFlight = 8;')],
        'seg128': [('constexpr int kSeg = 256;', 'constexpr int kSeg = 128;')]}}


def pad32(q):
    return (q + 31) // 32 * 32


def weight_bytes(kernel, B, N, K, F, R, first):
    '''Weight bytes one launch of K6 (kernel 'K6', at the list width K) or K1
    ('K1', K ignored) streams from L2: per tile, every prepared weight of its
    products as tf32 (hi, lo) pairs of 8 bytes; beside the same for 32-slot
    tiles (the K7/K2 design) and the fp32 weights the CUDA-core kernels
    streamed per 64-slot tile (the old K6 computed me twice and streamed
    each weight once per product).'''
    nb = 1 if first else 2
    ff, fr = F * F, F * pad32(R)
    if kernel == 'K6':
        tiles = B * -(-N // 8) * -(-K // 8)
        pairs = 2 * fr + 4 * nb * ff  # me, p, phi, dh, dmsg, drbf
        old = 4 * (2 * R * F + 4 * nb * ff)
    else:
        tiles = B * (-(-N // 8)) ** 2
        pairs = fr + 2 * nb * ff  # me, p, phi
        old = 4 * (R * F + 2 * nb * ff)
    return {'tiles_of_64_slots': tiles, 'bytes': 8 * pairs * tiles,
            'bytes_32_slot_tiles': 2 * 8 * pairs * tiles,
            'bytes_cuda_core_kernel': old * tiles}


def k6k1(torch, cs, card):
    '''The K6 and K1 lines (module docstring).'''
    import threading
    from newtonnet_tpu_torch.ops import fused_dense as fd
    from newtonnet_tpu_torch.ops import fused_klist as fk
    built = {}
    threads = [threading.Thread(target=lambda s=src, v=vs: built.update(
        {s: build(s, v)})) for src, vs in K6K1_VARIANTS.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    pair = cs.random_inputs(torch, 100, 21, 128, 20, seed=0)[0]
    box = {}
    for first in (False, True):
        ins, tans, cots = cs.klist_inputs(torch, 1, cs.BOX_ATOMS,
                                          cs.BOX_K_MAX, 128, 20, first,
                                          torch.bfloat16, seed=30)
        box[first] = cs.klist_calls(fk, ins, tans, cots, first)[
            'klist_bwd(wg=0)']
    streamed = {}
    for first in (False, True):
        tag = 'first' if first else 'full'
        streamed[f'K6 box {tag}'] = weight_bytes(
            'K6', 1, cs.BOX_ATOMS, cs.BOX_K_MAX, 128, 20, first)
        streamed[f'K1 B=100 N=21 {tag}'] = weight_bytes(
            'K1', 100, 21, 0, 128, 20, first)
    print(json.dumps({'weight_bytes_per_launch': streamed, 'card': card}),
          flush=True)
    for src, libs in built.items():
        for name, so in libs.items():
            use(src, so)
            ms = {}
            for first in (False, True):
                tag = 'first' if first else 'full'
                if src == 'fused_dense':
                    ms[f'K1 B=100 N=21 {tag} device'] = cs.device_ms(
                        torch, lambda: fd.pair_interaction_fwd(
                            *pair, first_layer=first))
                else:
                    f, a, kw = box[first]
                    ms[f'K6 box {tag}'] = cs.time_ms(
                        torch, lambda: f(*a, first_layer=first, **kw),
                        inner=3)
            print(json.dumps({'source': src, 'variant': name, 'ms': ms,
                              'card': card}), flush=True)


def k5_weight_bytes(B, N, K, F, R, first, rows):
    '''Weight bytes one K5 launch streams from L2 into shared memory at
    `rows` slot rows a step (8 slots of rows/8 atoms): every prepared
    weight of a step (me, p, phi) as tf32 (hi, lo) pairs of 8 bytes.'''
    atoms = rows // 8
    steps = B * -(-N // atoms) * -(-K // 8)
    pairs = F * pad32(R) + 2 * (1 if first else 2) * F * F
    return 8 * pairs * steps


def k5k11(torch, cs, card):
    '''The K5 and K11 lines (module docstring).'''
    import threading
    from torch.profiler import ProfilerActivity, profile
    from newtonnet_tpu_torch.ops import fused_klist as fk
    from newtonnet_tpu_torch.ops import window as wn
    built = {}
    threads = [threading.Thread(target=lambda s=src, v=vs: built.update(
        {s: build(s, v)})) for src, vs in K5_VARIANTS.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    box = {}
    for first in (False, True):
        ins, tans, cots = cs.klist_inputs(torch, 1, cs.BOX_ATOMS,
                                          cs.BOX_K_MAX, 128, 20, first,
                                          torch.bfloat16, seed=30)
        box[first] = cs.klist_calls(fk, ins, tans, cots, first)['klist_fwd']
    print(json.dumps({'k5_weight_bytes_per_launch': {
        f'{tag} rows={rows}': k5_weight_bytes(
            1, cs.BOX_ATOMS, cs.BOX_K_MAX, 128, 20, first, rows)
        for first, tag in ((False, 'full'), (True, 'first'))
        for rows in (128, 64)}, 'card': card}), flush=True)
    for name, so in built['fused_klist'].items():
        use('fused_klist', so)
        ms = {}
        for first in (False, True):
            f, a, kw = box[first]
            ms[f'K5 box {"first" if first else "full"}'] = cs.time_ms(
                torch, lambda: f(*a, first_layer=first, **kw), inner=3)
        print(json.dumps({'source': 'fused_klist', 'variant': name,
                          'ms': ms, 'card': card}), flush=True)
    idx_kn, mask_kn, W = cs.window_list(torch)[:3]
    K, N, F = idx_kn.shape[1], cs.BOX_ATOMS, 4 * 128
    g = torch.Generator(device='cuda').manual_seed(50)
    y = (torch.randn((1, K, N, F), generator=g, device='cuda')
         * mask_kn[..., None]).to(torch.bfloat16)
    acc = torch.zeros((N, F), device='cuda')
    flat, y2f = idx_kn.reshape(-1), y.reshape(K * N, F).float()

    def k11():
        wn.window_scatter_sum_fwd(y, idx_kn, W, cs.WINDOW_T)
    for name, so in built['window'].items():
        use('window', so)
        for _ in range(3):
            k11()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                k11()
            torch.cuda.synchronize()
        dev = {}
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                m = re.search(r'(\w+_kernel)', e.key)
                kname = m.group(1) if m else e.key
                dev[kname] = dev.get(kname, 0.0) + \
                    e.self_device_time_total / 20
        print(json.dumps({
            'source': 'window', 'variant': name,
            'K11 window cell': dict(K=K, N=N, F=F, W=W, T=cs.WINDOW_T),
            'device_us_per_call': dev,
            'ms': cs.time_ms(torch, k11, inner=5),
            'index_add_ms': cs.time_ms(
                torch, lambda: acc.index_add_(0, flat, y2f), inner=5),
            'card': card}), flush=True)


def k1train(roots, card):
    '''The K1 training-shape lines (module docstring): one process per
    checkout root, in the order given.'''
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              'k1time', os.path.abspath(root)],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f'k1time {root} failed:\n{out.stderr[-3000:]}')
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({'root': root, 'K1 B=10 N=24 device ms': ms,
                          'card': card}), flush=True)


def k1time(torch, root):
    '''K1's device ms per call at the training shape, full and first layer,
    from the package under root (printed as one JSON line), with this
    checkout's chip_smoke.py making the inputs and timing.'''
    import importlib.util
    sys.path.insert(0, root)  # the package under root, not this one's
    from newtonnet_tpu_torch.ops import fused_dense as fd
    assert fd.__file__.startswith(root), fd.__file__
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ins = cs.random_inputs(torch, 10, 24, 128, 20, seed=0)[0]
    print(json.dumps({tag: cs.device_ms(torch, lambda first=first: (
        fd.pair_interaction_fwd(*ins, first_layer=first)))
        for tag, first in (('full', False), ('first', True))}), flush=True)


def kerneltime(roots, card):
    '''The K1-K8 lines (module docstring): one process per checkout root,
    in the order given.'''
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              'kernelone', os.path.abspath(root)],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f'kernelone {root} failed:\n'
                               f'{out.stderr[-3000:]}')
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({'root': root, 'F=128 ms': ms, 'card': card}),
              flush=True)


def kernelone(torch, root):
    '''K1-K8's ms per call at F=128 (kerneltime's shapes), from the package
    under root (printed as one JSON line), with this checkout's
    chip_smoke.py making the inputs and timing.'''
    import importlib.util
    sys.path.insert(0, root)  # the package under root, not this one's
    from newtonnet_tpu_torch.ops import fused_dense as fd
    from newtonnet_tpu_torch.ops import fused_dual as fdd
    from newtonnet_tpu_torch.ops import fused_klist as fk
    assert fd.__file__.startswith(root), fd.__file__
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ms = {}
    ins, dinv1, deq = cs.random_inputs(torch, 100, 21, 128, 20, seed=0)
    args, cots = cs.dual_inputs(torch, 10, 24, 128, 20, seed=0)
    for first in (False, True):
        sfx = '_first' if first else ''
        ms['pair_fwd' + sfx] = cs.time_ms(
            torch, lambda: fd.pair_interaction_fwd(*ins, first_layer=first))
        ms['pair_bwd' + sfx] = cs.time_ms(
            torch, lambda: fd.pair_interaction_bwd(
                *ins, dinv1, deq, first_layer=first, weight_grads=False))
        kw = dict(first_layer=first, dot_dtype='bfloat16')
        ms['dual_fwd' + sfx] = cs.time_ms(
            torch, lambda: fdd.pair_interaction_dual_fwd(*args, **kw))
        ms['dual_bwd' + sfx] = cs.time_ms(
            torch, lambda: fdd.pair_interaction_dual_bwd(*args, *cots, **kw))
    del ins, args, cots
    for first in (False, True):
        kins, tans, kcots = cs.klist_inputs(
            torch, 1, cs.BOX_ATOMS, cs.BOX_K_MAX, 128, 20, first,
            torch.bfloat16, seed=30)
        calls = cs.klist_calls(fk, kins, tans, kcots, first)
        for call in ('klist_fwd', 'klist_bwd(wg=0)', 'klist_dual_fwd',
                     'klist_dual_bwd'):
            fn, a, kw = calls[call]
            ms[call.split('(')[0] + ('_first' if first else '')] = \
                cs.time_ms(torch, lambda: fn(*a, first_layer=first, **kw),
                           inner=3)
        del kins, tans, kcots, calls
        torch.cuda.empty_cache()
    print(json.dumps(ms), flush=True)


K2_FUNCS = re.compile(r'(pair_bwd\w*?_kernel|k2_[a-z]+)(?:I((?:L[ib]\d+E)+)E|E)')


def k2_function(mangled):
    """The short name of a K2 function at F=128 (its template arguments
    in <>), or None for another function."""
    m = K2_FUNCS.search(mangled)
    if m is None:
        return None
    args = re.findall(r'L[ib](\d+)E', m.group(2) or '')
    if args and args[0] != '128' and not (
            m.group(1).startswith('k2_') and args[0] == '32'):
        return None
    return m.group(1) + (f'<{",".join(args)}>' if args else '')


def k2_ptxas(log):
    """{function: {registers, stack, spill_bytes}} of K2's functions in an
    nvcc -Xptxas -v log."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            entry = k2_function(line.split("'")[1])
        elif 'Function properties for' in line:
            props = k2_function(line.split('for', 1)[1])
            if props:
                out.setdefault(props, {})
        elif 'stack frame' in line and props:
            v = [int(x) for x in re.findall(r'(\d+) bytes', line)]
            out[props].update(stack=v[0], spill_bytes=v[1] + v[2])
        elif 'Used' in line and 'registers' in line and entry:
            out.setdefault(entry, {})['registers'] = int(
                re.search(r'Used (\d+) registers', line).group(1))
    return out


def k2_sass(so):
    """{function: {opcode: count}} of K2's functions in a library's SASS."""
    from newtonnet_tpu_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    text = subprocess.run([cuobjdump, '-sass', so], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if 'Function : ' in line:
            name = k2_function(line.split('Function : ', 1)[1])
            cur = out.setdefault(name, {}) if name else None
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?'
                     r'([A-Z][A-Z0-9_]*)', line)
        if cur is not None and m:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return out


KLIST_ANON = re.compile(r'_GLOBAL__N__[0-9a-f]+_\d+_fused_klist_cu_[0-9a-f]+')


def klist_sass(so):
    """{function: [instruction]} of a fused_klist library's SASS, the
    anonymous namespace's hash, addresses and encodings dropped."""
    from newtonnet_tpu_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), 'cuobjdump')
    text = subprocess.run([cuobjdump, '-sass', so], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if 'Function : ' in line:
            cur = out.setdefault(KLIST_ANON.sub(
                '_', line.split('Function : ', 1)[1].strip()), [])
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*/\* 0x', line)
        if cur is not None and m:
            cur.append(KLIST_ANON.sub('_', m.group(1)))
    return out


def klist_dual_ptxas(log):
    """{kernel<F,first,edge type>: {registers, stack, spill_bytes}} of K7 and
    K8 in an nvcc -Xptxas -v log: the entry's own properties, which
    ptxas prints before its registers."""
    out, entry = {}, None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            m = re.search(r'(klist_dual_(?:fwd|bwd)_kernel)ILi(\d+)ELb(\d)E'
                          r'(f|13__nv_bfloat16)E', line)
            entry = (f'{m.group(1)}<{m.group(2)},{m.group(3)},'
                     f'{"f32" if m.group(4) == "f" else "bf16"} edges>'
                     if m else None)
            if entry:
                out[entry] = {}
        elif entry and 'stack frame' in line and 'registers' not in \
                out[entry]:
            v = [int(x) for x in re.findall(r'(\d+) bytes', line)]
            out[entry].update(stack=v[0], spill_bytes=v[1] + v[2])
        elif entry and 'Used' in line and 'registers' in line:
            out[entry]['registers'] = int(
                re.search(r'Used (\d+) registers', line).group(1))
            entry = None
    return out


def k78sass(roots, card):
    """The K7/K8 build lines (module docstring)."""
    from newtonnet_tpu_torch.ops import _build
    out_dir = os.path.join(_build.BUILD_DIR, 'dual_breakdown')
    os.makedirs(out_dir, exist_ok=True)
    widths = (48, 128, 256)
    jobs = {}
    for r, root in enumerate(roots[:2]):
        for F in widths:
            for dt in ('float32',) + (('bfloat16',) if r == 1 else ()):
                so = os.path.join(out_dir, f'k78sass_{r}_{F}_{dt}.so')
                cmd = [_build._nvcc(), *_build.flags('fused_klist', F, dt),
                       '-o', so, os.path.join(root, 'newtonnet_tpu_torch',
                                              'csrc', 'fused_klist.cu')]
                jobs[(r, F, dt)] = (so, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
    logs = {}
    for key, (so, proc) in jobs.items():
        logs[key] = proc.communicate(timeout=1200)[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc {key} failed:\n{logs[key][-3000:]}')
    for F in widths:
        a = klist_sass(jobs[(0, F, 'float32')][0])
        b = klist_sass(jobs[(1, F, 'float32')][0])
        both = sorted(set(a) & set(b))
        differ = [f for f in both if a[f] != b[f]]
        print(json.dumps({
            'F': F, 'roots': roots[:2], 'fp32_library_functions': len(b),
            'identical': len(both) - len(differ), 'differ': differ,
            'only_first': sorted(set(a) - set(b)),
            'only_second': sorted(set(b) - set(a)),
            # the first lines where each differing function differs
            'diff_excerpts': {f: list(difflib.unified_diff(
                a[f], b[f], n=1, lineterm=''))[2:40] for f in differ},
            'card': card}), flush=True)
    print(json.dumps({'ptxas_second_root': {
        f'F={F} {dt}': klist_dual_ptxas(logs[(1, F, dt)])
        for F in widths for dt in ('float32', 'bfloat16')}, 'card': card}),
        flush=True)


def k2diag(roots, card):
    """The K2 lines (module docstring): one process per checkout root."""
    sass = []
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              'k2one', os.path.abspath(root)],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f'k2one {root} failed:\n{out.stderr[-3000:]}')
        line = json.loads(out.stdout.strip().splitlines()[-1])
        sass.append(line['sass'])
        line['sass_total'] = {f: sum(c.values())
                              for f, c in line['sass'].items()}
        print(json.dumps({'root': root, **line, 'card': card}), flush=True)
    if len(sass) >= 2:
        a, b = sass[0], sass[1]
        diff = {}
        for f in sorted(set(a) | set(b)):
            ops = set(a.get(f, {})) | set(b.get(f, {}))
            d = {op: b.get(f, {}).get(op, 0) - a.get(f, {}).get(op, 0)
                 for op in sorted(ops)}
            diff[f] = {op: n for op, n in d.items() if n}
        print(json.dumps({'sass_second_minus_first': diff,
                          'roots': roots[:2]}), flush=True)


def k2one(torch, root):
    """K2's per-kernel device microseconds at F=128 and its functions'
    ptxas and SASS reports, from the package under root (one JSON line),
    with this checkout's chip_smoke.py making the inputs."""
    import importlib.util
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, root)  # the package under root, not this one's
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import fused_dense as fd
    assert fd.__file__.startswith(root), fd.__file__
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ins, dinv1, deq = cs.random_inputs(torch, 100, 21, 128, 20, seed=0)
    dev = {}
    for first in (False, True):
        def fn():
            fd.pair_interaction_bwd(*ins, dinv1, deq, first_layer=first,
                                    weight_grads=False)
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        tag = 'first' if first else 'full'
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                kname = e.key.split('::')[-1].split('(')[0].split('<')[0]
                dev[f'{tag} {kname}'] = e.self_device_time_total / 20
    so = next(lib._name for key, lib in _build._LIBS.items()
              if key.startswith('fused_dense'))
    with open(so[:-3] + '.log') as f:
        ptxas = k2_ptxas(f.read())
    print(json.dumps({'device_us': dev, 'library': os.path.basename(so),
                      'ptxas': ptxas, 'sass': k2_sass(so)}), flush=True)


def steptime(roots, card):
    '''The dense training step lines (module docstring): one process per
    checkout root, in the order given.'''
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              'stepone', os.path.abspath(root)],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            raise RuntimeError(f'stepone {root} failed:\n'
                               f'{out.stderr[-3000:]}')
        res = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({'root': root, 'dense pallas step': res,
                          'card': card}), flush=True)


def stepone(torch, root):
    '''chip_smoke.py phase 7a's step, from the package under root, timed
    (one JSON line), with this checkout's chip_smoke.py giving the
    settings and the profile.'''
    import importlib.util
    import statistics
    sys.path.insert(0, root)  # the package under root, not this one's
    import newtonnet_tpu_torch
    assert newtonnet_tpu_torch.__file__.startswith(root)
    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.data.pipeline import parse_train_test
    from newtonnet_tpu_torch.data.statistics import set_scalers
    from newtonnet_tpu_torch.layers.precision import fp32_matmuls
    from newtonnet_tpu_torch.train import fastgrad
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.optimizer import get_optimizer_by_string
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_here', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = cs.md17_settings(None, 1)
    train_gen, _, _, stats = parse_train_test(seed=0, **cfg['data'])
    main_loss, _ = get_loss_by_string(cfg['training']['loss'])
    model = load_model(cs.CKPT).requires_grad_(True)
    set_scalers(model.core, model.output_properties, stats,
                {'energy': dict(cfg['training']['fit_scalers'])})
    opt = get_optimizer_by_string('adam', model.core, clip_grad=1.0, lr=1e-3)
    it = iter(train_gen)
    batches = [{k: torch.as_tensor(v).cuda() for k, v in next(it).items()}
               for _ in range(10)]

    def step(b):
        fastgrad.value_and_grad(model, main_loss, b)
        opt.global_norm()
        opt.step()

    step_ms = []
    with fp32_matmuls():
        for b in batches * 3:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(b)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
        prof = cs.profile_call(torch, lambda: step(batches[0]))
    print(json.dumps({
        'step_ms_median_2_10': statistics.median(step_ms[1:10]),
        'step_ms_median_2_30': statistics.median(step_ms[1:]),
        'step_ms': step_ms, 'profiled_wall_ms': prof['wall_ms'],
        'device_busy_ms': prof['device_busy_ms'],
        'device_idle_share': prof['device_idle_share']}), flush=True)


def width(source):
    '''The feature width of the library of `source` that the variants are
    built as: 128 for a source of K1-K8, none for the others.'''
    from newtonnet_tpu_torch.ops import _build
    return 128 if source in _build.WIDE_SOURCES else None


def use(source, so):
    '''Have the wrappers call the library `so` in place of source's own.'''
    from newtonnet_tpu_torch.ops import _build
    _build._LIBS[_build._key(source, width(source))] = ctypes.CDLL(so)


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
            [_build._nvcc(), *_build.flags(source, width(source)), '-o',
             so, cu],
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
            use(src, so)
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
    if sys.argv[1:2] == ['k1time']:  # before this checkout's package loads
        k1time(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ['stepone']:  # the same
        stepone(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ['kernelone']:  # the same
        kernelone(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ['k2one']:  # the same
        k2one(torch, sys.argv[2])
        return 0
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from newtonnet_tpu_torch.ops import fused_dual as fdd

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if sys.argv[1:] == ['k2k7']:
        k2k7(torch, cs, card)
        return 0
    if sys.argv[1:] == ['k6k1']:
        k6k1(torch, cs, card)
        return 0
    if sys.argv[1:] == ['k5k11']:
        k5k11(torch, cs, card)
        return 0
    if sys.argv[1:2] == ['k1train']:
        k1train(sys.argv[2:], card)
        return 0
    if sys.argv[1:2] == ['steptime']:
        steptime(sys.argv[2:], card)
        return 0
    if sys.argv[1:2] == ['kerneltime']:
        kerneltime(sys.argv[2:], card)
        return 0
    if sys.argv[1:2] == ['k2diag']:
        k2diag(sys.argv[2:], card)
        return 0
    if sys.argv[1:2] == ['k78sass']:
        k78sass(sys.argv[2:], card)
        return 0
    libs = build()
    args, cots = cs.dual_inputs(torch, 10, 24, 128, 20, seed=0)
    for name, so in libs.items():
        use('fused_dual', so)
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
