#!/usr/bin/env python3
'''Where kernel K8 (klist_dual_bwd_kernel, the K-list dual backward in
newtonnet_tpu_torch/csrc/fused_klist.cu) spends its cycles on the card.

    python3 k8_breakdown.py

Copies the package into chiprun_out/k8_breakdown/ (gitignored), adds
clock64 counters to that copy's K8 (thread 0 of each block adds the cycles
of the kernel, of each mma_product call and of each wgrad_tc call to
device counters), builds it with nvcc, times K8 at the box shape of
chip_smoke.py (B=1, N=4096, K=88, F=128, R=20, bf16 edges; full and first
layer; CUDA events, chip_smoke.time_ms) and prints one JSON line: ms, the
cycles per block and the shares of the products and the weight
cotangents in them. The counters cost a few atomics per call; the times
are those of the instrumented kernel. Needs a CUDA card and nvcc.
'''
import ctypes
import importlib.util
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
COPY = os.path.join(HERE, 'chiprun_out', 'k8_breakdown')
COUNTERS = '''#include <stddef.h>
__device__ unsigned long long g_k8_cycles[4];
extern "C" int nn_k8_cycles(unsigned long long* out, int zero) {
  if (zero) {
    unsigned long long z[4] = {0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(g_k8_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_k8_cycles, sizeof(g_k8_cycles));
}
'''


def _count(src, head, slot, start_after=None):
    '''Wrap the body of the function whose signature starts with `head`
    in a cycle count into g_k8_cycles[slot].'''
    a = src.index(head)
    b = src.index('{', src.index(start_after, a) if start_after else a) + 1
    src = src[:b] + '\n  const long long k8_t0 = clock64();' + src[b:]
    e = src.index('\n}\n', b)
    return (src[:e] + f'\n  if (threadIdx.x == 0) atomicAdd(&g_k8_cycles'
            f'[{slot}], (unsigned long long)(clock64() - k8_t0));' + src[e:])


def instrumented(src):
    src = src.replace('#include <stddef.h>\n', COUNTERS, 1)
    src = _count(src, '__device__ __noinline__ void mma_product(', 0)
    src = _count(src, '__device__ __noinline__ void wgrad_tc(', 1)
    return _count(src, 'klist_dual_bwd_kernel(const float* __restrict__ npi,',
                  2, start_after='int n_itiles, int n_tiles)')


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('k8_breakdown.py needs a CUDA device')
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, 'newtonnet_tpu_torch'),
                    os.path.join(COPY, 'newtonnet_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    path = os.path.join(COPY, 'newtonnet_tpu_torch', 'csrc', 'fused_klist.cu')
    with open(path) as f:
        src = f.read()
    with open(path, 'w') as f:
        f.write(instrumented(src))
    sys.path.insert(0, COPY)
    from newtonnet_tpu_torch.ops import _build
    from newtonnet_tpu_torch.ops import fused_klist as fk
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    lib = _build.load('fused_klist', 128)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, N, K, F, R = 1, cs.BOX_ATOMS, cs.BOX_K_MAX, 128, 20
    out = {'device': torch.cuda.get_device_name(0),
           'shape': dict(B=B, N=N, K=K, F=F, R=R)}
    for first in (False, True):
        ins, tans, cots = cs.klist_inputs(torch, B, N, K, F, R, first,
                                          torch.bfloat16, seed=30)
        fn, a, kw = cs.klist_calls(fk, ins, tans, cots, first)[
            'klist_dual_bwd']
        ms = cs.time_ms(torch, lambda: fn(*a, first_layer=first, **kw),
                        inner=3)
        cycles = (ctypes.c_ulonglong * 4)()
        torch.cuda.synchronize()
        lib.nn_k8_cycles(cycles, 1)
        fn(*a, first_layer=first, **kw)
        torch.cuda.synchronize()
        lib.nn_k8_cycles(cycles, 0)
        total = cycles[2]
        out['first_layer' if first else 'full_layer'] = {
            'ms': ms, 'cycles_per_block': total / min(sms, B * N // 8),
            'products_share': cycles[0] / total,
            'weight_cotangents_share': cycles[1] / total}
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
