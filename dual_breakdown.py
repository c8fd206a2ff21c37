#!/usr/bin/env python3
'''Where kernels K3 and K4 (dual_fwd_kernel / dual_bwd_kernel of
newtonnet_tpu_torch/csrc/fused_dual.cu) and their wrappers spend their
time on the card; with the argument `k2k7`, kernels K2 (pair_bwd_kernel,
csrc/fused_dense.cu) and K7 (klist_dual_fwd_kernel, csrc/fused_klist.cu);
with `k6k1`, kernels K6 (klist_bwd_kernel) and K1 (pair_fwd_kernel).

    python3 dual_breakdown.py [k2k7 | k6k1 | k5k11 | k1train ROOT... |
                               steptime ROOT...]

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


# the K6 and K1 variants, by source
K6K1_VARIANTS = {
    'fused_klist': {
        'as_is': [],
        'no_products': [('  const int nch = cur.qp / RW;',
                         '  const int nch = 0 * cur.qp;')],
        'no_mma': [(f'          for (int rg = 0; rg < 2; ++rg) mma_tf32('
                    f'd[o][rg][j], {a}[rg], {b}[j]);',
                    f'          for (int rg = 0; rg < 2; ++rg) d[o][rg][j][{e}]'
                    f' += __uint_as_float({a}[rg][{e}] ^ {b}[j][1]);')
                   for e, (a, b) in enumerate((('al', 'bh'), ('ah', 'bl'),
                                               ('ah', 'bh')))]},
    'fused_dense': {
        'as_is': [],
        'no_products': [('  const int nch = cur.qp / RW;',
                         '  const int nch = 0 * cur.qp;')],
        'no_mma': [(f'          for (int rg = 0; rg < 2; ++rg) mma_tf32('
                    f'd[x][rg][j], {a}[rg], {b}[j]);',
                    f'          for (int rg = 0; rg < 2; ++rg) d[x][rg][j][{e}]'
                    f' += __uint_as_float({a}[rg][{e}] ^ {b}[j][1]);')
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
    from newtonnet_tpu_torch.ops import _build
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
            _build._LIBS[src] = ctypes.CDLL(so)  # the wrapper's library
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
    from newtonnet_tpu_torch.ops import _build
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
        _build._LIBS['fused_klist'] = ctypes.CDLL(so)  # the wrapper's library
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
        _build._LIBS['window'] = ctypes.CDLL(so)  # the wrapper's library
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
    if sys.argv[1:2] == ['k1time']:  # before this checkout's package loads
        k1time(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ['stepone']:  # the same
        stepone(torch, sys.argv[2])
        return 0
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
