#!/usr/bin/env python3
'''Smoke run of the PyTorch / CUDA port (newtonnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (the run stops at the first failure,
with a non-zero exit code and no result line):

1. env      the card, its power limit (nvidia-smi), torch / CUDA versions;
            TF32 off for matmuls and cuDNN.
2. build    nvcc builds every kernel source of the package (sm_90a).
3. kernels  each kernel against its plain PyTorch version on the card, at
            the batched serving shape (B=100, N=21, F=128, R=20), at one
            calculator request (B=1, N=24) and at (B=2, N=70, F=64, R=16);
            bar: max|kernel - plain| <= 1e-4 * max|plain| per output.
4. serve    the trained MD17-aspirin checkpoint serves all 500 test frames
            in batches of 100 through the kernels; energy and force errors
            against the labels must reproduce the JAX package's (energy MAE
            0.007094 +- 5e-4 eV, force MAE 0.022353 +- 5e-5 eV/A); the same
            batches through the plain path on the card must agree (energy
            atol 2e-2 eV: one float32 ulp at -17,600 eV is 0.002 eV; forces
            atol 1e-4 eV/A).
5. requests 20 single-molecule calculator calls (energy, forces, stress,
            virial), 10 aperiodic and 10 in a 30 A periodic box; they must
            match phase 4 at the same tolerances.
   profile  one batch and one request under torch.profiler: device busy
            time, idle share, the fused kernels' share, the top kernels.
6. timing   each kernel variant's launches during phases 4-5, its time and
            its plain version's at the batched shape (CUDA events, median of
            7 reps), and the least time the card could take (fp32 bound).

Then the card's nvidia-smi line, the `kernels` JSON line and, last,
{"ok": true, "device": {...}}.
'''
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, 'artifacts', 'md17_model_pallas',
                    'best_model.msgpack')
XYZ = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_test', 'raw',
                   'aspirin_ccsd-test.xyz')
JAX_ENERGY_MAE, JAX_FORCE_MAE = 0.007094, 0.022353  # JAX package, CPU
E_ATOL, F_ATOL = 2e-2, 1e-4
KERNEL_BAR = 1e-4
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
KERNEL_SOURCE = 'newtonnet_tpu_torch/csrc/fused_dense.cu'
REPLACES = {'pair_fwd': 'newtonnet_tpu/ops/pallas_dense.py:78',
            'pair_fwd_first': 'newtonnet_tpu/ops/pallas_dense.py:78',
            'pair_bwd': 'newtonnet_tpu/ops/pallas_dense.py:102',
            'pair_bwd_first': 'newtonnet_tpu/ops/pallas_dense.py:102'}


class PhaseFailed(Exception):
    pass


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def random_inputs(torch, B, N, F, R, seed):
    '''Layer inputs of the scale the model produces, made on the card.'''
    g = torch.Generator(device='cuda').manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device='cuda') * scale

    eye = torch.eye(N, device='cuda', dtype=torch.bool)
    adj = ((torch.rand((B, N, N), generator=g, device='cuda') < 0.6)
           & ~eye).float()
    ins = [rnd(B, N, F, scale=0.3), rnd(B, N, N, R, scale=0.3),
           rnd(B, 3, N, N), adj, rnd(B, 3, N, F, scale=0.2)]
    ins += [rnd(*s, scale=s[0] ** -0.5)
            for s in [(R, F), (F, F), (F, F), (F, F), (F, F)]]
    return ins, rnd(B, N, F), rnd(B, 3, N, F)


def layer_work(B, N, F, R, kind, first):
    '''(flops, bytes) the layer function needs: matrix products plus the
    per-feature multiply-adds over all B*N*N pair slots (sigmoids not
    counted); each input read once and each output written once, fp32.'''
    S = B * N * N
    nb = 1 if first else 2
    if kind == 'fwd':
        flops = S * (2 * R * F + 4 * F + nb * (4 * F * F + 6 * F))
        floats = (B * N * F + S * R + 4 * S + R * F + nb * 2 * F * F
                  + (0 if first else 3 * B * N * F) + 4 * B * N * F)
    else:
        flops = S * (4 * R * F + 11 * F + nb * (8 * F * F + 12 * F))
        floats = (B * N * F + S * R + 4 * S + R * F + nb * 2 * F * F
                  + (0 if first else 3 * B * N * F) + 4 * B * N * F
                  + B * N * F + S * R + 3 * S + 3 * B * N * F)
    return flops, 4 * floats


def time_ms(torch, fn, reps=7, inner=10):
    '''Median over `reps` of the mean time of `inner` back-to-back calls,
    from CUDA events.'''
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def profile_call(torch, fn):
    """One call of fn under torch.profiler: wall ms (host clock, ending in
    a synchronise), device busy ms (the sum of the device's own events),
    the fused kernels' share of it, and the five longest device kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    dev = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()
           if str(e.device_type).endswith('CUDA')]
    busy = sum(ms for _, ms, _ in dev)
    fused = sum(ms for key, ms, _ in dev if 'pair_' in key)
    top = sorted(dev, key=lambda d: -d[1])[:5]
    return {'wall_ms': wall, 'device_busy_ms': busy,
            'device_idle_share': 1.0 - busy / wall if busy else None,
            'fused_kernels_ms': fused,
            'top_device_ms': [[k[:70], ms, n] for k, ms, n in top]}


def phase_kernels(torch, fd):
    '''Phase 3: every kernel variant against its plain version.'''
    errs = {}
    shapes = [(100, 21, 128, 20), (1, 24, 128, 20), (2, 70, 64, 16)]
    for si, (B, N, F, R) in enumerate(shapes):
        ins, dinv1, deq = random_inputs(torch, B, N, F, R, seed=si)
        worst = 0.0
        for first in (False, True):
            name = 'pair_fwd_first' if first else 'pair_fwd'
            got = fd.pair_interaction_fwd(*ins, first_layer=first)
            ref = fd.pair_interaction_fwd_ref(*ins, first_layer=first)
            torch.cuda.synchronize()
            outs = [(name, 'inv1', got[0], ref[0]),
                    (name, 'eq', got[1], ref[1])]
            bname = 'pair_bwd_first' if first else 'pair_bwd'
            for wg in (False, True):
                got = fd.pair_interaction_bwd(*ins, dinv1, deq,
                                              first_layer=first,
                                              weight_grads=wg)
                ref = fd.pair_interaction_bwd_ref(*ins, dinv1, deq,
                                                  first_layer=first,
                                                  weight_grads=wg)
                torch.cuda.synchronize()
                labels = ['dnp', 'drbf', 'ddir', 'dforce', 'dWe', 'dW1a',
                          'dW1b', 'dW2a', 'dW2b']
                for lab, a, b in zip(labels, got, ref):
                    check((a is None) == (b is None), f'{bname} {lab}')
                    if a is not None:
                        outs.append((bname, f'{lab}(wg={int(wg)})', a, b))
            for kname, lab, a, b in outs:
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                check(bool(torch.isfinite(a).all()),
                      f'{kname} {lab} not finite at {(B, N, F, R)}')
                check(err <= KERNEL_BAR * scale,
                      f'{kname} {lab} at {(B, N, F, R)}: max err {err} > '
                      f'{KERNEL_BAR} * {scale}')
                worst = max(worst, err / max(scale, 1e-30))
                if si == 0:
                    errs[kname] = max(errs.get(kname, 0.0), err)
        emit('kernel_vs_plain', shape=dict(B=B, N=N, F=F, R=R),
             worst_err_over_max=worst, bar=KERNEL_BAR)
    return errs


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, 'newtonnet_tpu_torch')):
        print('chip_smoke: run from a checkout of the repository',
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from newtonnet_tpu_torch import NewtonNetCalculator, load_model
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import fused_dense as fd

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else 'nvidia-smi gave nothing'
    emit('env', device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. build
    t0 = time.perf_counter()
    report = _build.build_all()
    ptxas = []
    for name, (_, log) in report.items():
        entry = None
        for line in log.splitlines():
            if 'Compiling entry function' in line:
                entry = line.split("'")[1]
            elif 'registers' in line and entry:
                ptxas.append(f'{entry}: {line.split(":", 1)[1].strip()}')
            elif 'spill' in line and entry:
                ptxas.append(f'{entry}: {line.strip()}')
    emit('build', seconds=time.perf_counter() - t0,
         built=sorted(report), ptxas=ptxas)

    # 3. kernels against their plain versions
    errs = phase_kernels(torch, fd)

    # 4. + 5. the main path: batched serving, then calculator requests
    samples = parse_xyz(XYZ)
    check(len(samples) == 500, f'expected 500 frames, got {len(samples)}')
    model = load_model(CKPT)
    batches = [collate(samples[k:k + 100], n_pad=21)
               for k in range(0, 500, 100)]

    def to_dev(b):
        return [torch.from_numpy(b[k]).cuda() for k in ('z', 'pos', 'cell')]

    model(*to_dev(batches[0]))  # first use loads the library
    calc = NewtonNetCalculator(CKPT, properties=['energy', 'forces',
                                                 'stress', 'virial'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fd.reset_launch_counts()
    served, batch_s = [], []
    for b in batches:
        t = time.perf_counter()
        out = model(*to_dev(b))
        e = out['energy'].cpu().numpy()
        f = out['gradient_force'].cpu().numpy()
        batch_s.append(time.perf_counter() - t)
        served.append((e, f))
    box = 30.0 * np.eye(3)
    requests, lat = [], []
    for k in range(20):
        s = samples[k]
        t = time.perf_counter()
        r = calc.calculate(numbers=s['z'], positions=s['pos'],
                           cell=box if k >= 10 else None)
        lat.append(time.perf_counter() - t)
        requests.append(r)
    launches = dict(fd.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    ae = af = sf = 0.0
    for b, (e, f) in zip(batches, served):
        check(np.isfinite(e).all() and np.isfinite(f).all(),
              'non-finite served output')
        check(e.shape == (100,) and f.shape == (100, 21, 3), 'output shape')
        ae += np.abs(e - b['energy']).astype(np.float64).sum()
        df = (f - b['force']).astype(np.float64)
        af += np.abs(df).sum()
        sf += (df ** 2).sum()
    e_mae, f_mae = ae / 500, af / (500 * 21 * 3)
    f_rmse = float(np.sqrt(sf / (500 * 21 * 3)))
    emit('serve', frames=500, batch=100, n_pad=21, energy_mae=e_mae,
         force_mae=f_mae, force_rmse=f_rmse,
         jax_energy_mae=JAX_ENERGY_MAE, jax_force_mae=JAX_FORCE_MAE,
         batch_ms_median=1e3 * statistics.median(batch_s),
         frames_per_s=500 / sum(batch_s), peak_mib=peak_mib)
    check(abs(e_mae - JAX_ENERGY_MAE) <= 5e-4, f'energy MAE {e_mae}')
    check(abs(f_mae - JAX_FORCE_MAE) <= 5e-5, f'force MAE {f_mae}')

    plain_s, e_err, f_err = [], 0.0, 0.0
    for b, (e, f) in zip(batches, served):
        t = time.perf_counter()
        out = model(*to_dev(b), pair_op=fd.pair_interaction_fwd_ref)
        ep = out['energy'].cpu().numpy()
        fp = out['gradient_force'].cpu().numpy()
        plain_s.append(time.perf_counter() - t)
        e_err = max(e_err, float(np.abs(e - ep).max()))
        f_err = max(f_err, float(np.abs(f - fp).max()))
    emit('serve_vs_plain', energy_max_abs_diff=e_err,
         force_max_abs_diff=f_err, energy_atol=E_ATOL, force_atol=F_ATOL,
         plain_batch_ms_median=1e3 * statistics.median(plain_s))
    check(e_err <= E_ATOL and f_err <= F_ATOL, 'kernel vs plain serving')

    e_ref, f_ref = served[0]
    r_e = r_f = r_s = 0.0
    for k, r in enumerate(requests):
        check(np.isfinite(r['energy']) and np.isfinite(r['forces']).all()
              and np.isfinite(r['virial']).all(), f'request {k} not finite')
        r_e = max(r_e, abs(r['energy'] - float(e_ref[k])))
        r_f = max(r_f, float(np.abs(r['forces'] - f_ref[k]).max()))
        if k >= 10:  # periodic box: stress = -virial / volume
            v = -r['virial'] / 30.0 ** 3
            voigt = v[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]]
            r_s = max(r_s, float(np.abs(r['stress'] - voigt).max()))
    emit('requests', calls=20, n_pad=24, energy_max_abs_diff=r_e,
         force_max_abs_diff=r_f, stress_vs_virial_max_abs_diff=r_s,
         latency_ms_median=1e3 * statistics.median(lat),
         latency_ms_min=1e3 * min(lat), latency_ms_max=1e3 * max(lat))
    check(r_e <= E_ATOL and r_f <= F_ATOL, 'requests vs batched serving')
    check(r_s <= 1e-6, 'stress is not -virial / volume')
    check(all(launches[k] > 0 for k in fd.LAUNCHES),
          f'a kernel was not launched on the main path: {launches}')
    emit('launches', **launches)
    emit('profile', what='one batch of 100 frames (N=21)',
         **profile_call(torch, lambda: model(*to_dev(batches[0]))))
    s = samples[0]
    emit('profile', what='one calculator request (N=24)',
         **profile_call(torch, lambda: calc.calculate(
             numbers=s['z'], positions=s['pos'])))

    # 6. timing at the batched serving shape
    B, N, F, R = 100, 21, 128, 20
    ins, dinv1, deq = random_inputs(torch, B, N, F, R, seed=0)
    rows = []
    for name in ('pair_fwd', 'pair_fwd_first', 'pair_bwd', 'pair_bwd_first'):
        first = name.endswith('first')
        if name.startswith('pair_fwd'):
            kind = 'fwd'

            def run(ref=False, first=first):
                f = fd.pair_interaction_fwd_ref if ref else \
                    fd.pair_interaction_fwd
                return f(*ins, first_layer=first)
        else:
            kind = 'bwd'

            def run(ref=False, first=first):
                f = fd.pair_interaction_bwd_ref if ref else \
                    fd.pair_interaction_bwd
                return f(*ins, dinv1, deq, first_layer=first,
                         weight_grads=False)
        plain1 = time_ms(torch, lambda: run(True))
        ms = time_ms(torch, run)
        ms2 = time_ms(torch, run)
        plain2 = time_ms(torch, lambda: run(True))
        flops, nbytes = layer_work(B, N, F, R, kind, first)
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        rows.append({
            'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE,
            'replaces': REPLACES[name], 'launches': launches[name],
            'max_abs_err': errs[name], 'ms': statistics.median([ms, ms2]),
            'plain_ms': statistics.median([plain1, plain2]),
            'bound_ms': 1e3 * max(t_ops, t_bytes),
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes',
            'library_ms': None,
            'flops': flops, 'bytes': nbytes,
            'ms_runs': [ms, ms2], 'plain_ms_runs': [plain1, plain2]})
    emit('timing', shape=dict(B=B, N=N, F=F, R=R), weight_grads=False,
         peak_fp32_tflops=PEAK_FP32_FLOPS / 1e12,
         peak_tb_per_s=PEAK_BYTES_PER_S / 1e12)

    print(card, flush=True)
    print(json.dumps({'kernels': rows}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f'chip_smoke: FAILED: {exc}', file=sys.stderr, flush=True)
        sys.exit(1)
