'''Build the package's native sources at first use and load them with
ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for sm_90a into `newtonnet_tpu_torch/_build/lib<name>-<hash>.so`, where the
hash covers the source and the flags: an edited source builds anew, an
unchanged one loads from the cache. `build_all` starts one `nvcc` per
source at once and waits for all of them. The host-side C++ in
`csrc/host/<name>.cpp` (plain C interface too) is built the same way by
`g++` (`load_host`): it needs no CUDA toolkit, so it also builds where
there is no card. Nothing here runs at import.
'''
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, 'csrc')
HOST_DIR = os.path.join(SRC_DIR, 'host')
BUILD_DIR = os.path.join(_PKG, '_build')
SOURCES = ('fused_dense', 'fused_dual', 'fused_klist', 'row_gather',
           'window')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
GXX_FLAGS = ('-std=c++17', '-O3', '-shared', '-fPIC')

_LIBS = {}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels build only where '
                       'the CUDA toolkit is installed')


def _target(name, src=None, flags=NVCC_FLAGS, prefix='lib', headers=()):
    with open(src or os.path.join(SRC_DIR, name + '.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(flags).encode())
    for path in headers:
        with open(path, 'rb') as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f'{prefix}{name}-{digest.hexdigest()[:16]}.so')


def build_all(names=SOURCES):
    '''Compile every source whose library is missing, all in parallel.

    Returns {name: (seconds, ptxas report)} for the sources it compiled.
    Raises RuntimeError with the compiler's output if one fails.'''
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        so = _target(name)
        if os.path.exists(so):
            continue
        tmp = f'{so}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
               os.path.join(SRC_DIR, name + '.cu')]
        jobs[name] = (so, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (so, tmp, t0, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name}:\n{out}')
            continue
        os.replace(tmp, so)
        with open(so[:-3] + '.log', 'w') as f:
            f.write(out)
        report[name] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return report


def load(name):
    '''The ctypes handle of csrc/<name>.cu, built first if needed.'''
    if name not in _LIBS:
        build_all((name,))
        _LIBS[name] = ctypes.CDLL(_target(name))
    return _LIBS[name]


def load_host(name):
    '''The ctypes handle of csrc/host/<name>.cpp, built by g++ at first use
    (a changed source, or header of csrc/host/, builds anew). Raises
    RuntimeError with the compiler's output if the build fails: there is
    no fallback.'''
    key = 'host/' + name
    if key not in _LIBS:
        src = os.path.join(HOST_DIR, name + '.cpp')
        headers = sorted(os.path.join(HOST_DIR, h)
                         for h in os.listdir(HOST_DIR) if h.endswith('.h'))
        so = _target(name, src, GXX_FLAGS, prefix='libhost_',
                     headers=headers)
        if not os.path.exists(so):
            cxx = shutil.which('g++') or shutil.which('c++')
            if cxx is None:
                raise RuntimeError(f'no C++ compiler (g++) to build {src}')
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{so}.{os.getpid()}.tmp'
            out = subprocess.run([cxx, *GXX_FLAGS, '-o', tmp, src],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f'g++ failed for {src}:\n{out.stdout}'
                                   f'{out.stderr}')
            os.replace(tmp, so)
        _LIBS[key] = ctypes.CDLL(so)
    return _LIBS[key]
