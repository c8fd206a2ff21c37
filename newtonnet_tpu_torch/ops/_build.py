'''Build the package's native sources at first use and load them with
ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for sm_90a into `newtonnet_tpu_torch/_build/lib<name>-<hash>.so`, where the
hash covers the source and the flags: an edited source builds anew, an
unchanged one loads from the cache. The fused pair sources (WIDE_SOURCES)
run a feature width F at its padded width Fp (`padded_width`), one library
per (padded width, padded): `lib<name>-w<Fp>[p]-<hash>.so`, compiled with
`-DNN_WIDTH=<Fp>` and, where F is below Fp, `-DNN_PADDED` (the kernels
then mask the pad lanes, which a library of F = Fp folds away;
`width_flags`), at the first call of such a width (`load(name, F)`), so a
model builds only its own width. The sources of K1/K2 and K5-K8
(BF16_SOURCES) also build a bf16 library per width, compiled with
`-DNN_BF16` (`lib<name>-w<Fp>[p]-bf16-<hash>.so`), where K1, K2 and K5-K8
run the `pallas_dot_dtype: bfloat16` mode (`load(name, F, 'bfloat16')`);
an fp32 model builds none of them. The hash covers the shared headers of
csrc/ (`*.cuh`) too. `build_all` starts one `nvcc` per library at once
and waits for all of them. The host-side C++ in
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
# the sources of K1-K8, built one library per padded feature width
WIDE_SOURCES = ('fused_dense', 'fused_dual', 'fused_klist')
# the sources with a bf16 library (K1/K2, K5-K8): -DNN_BF16
BF16_SOURCES = ('fused_dense', 'fused_klist')
DOT_DTYPES = ('float32', 'bfloat16')
MAX_WIDTH = 256  # the widest F the kernels take
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


def padded_width(F):
    '''The padded width the kernels of K1-K8 run a true width F at: the
    next multiple of 32, and past 128 of 64 (their wide tiles split the
    columns eight ways; csrc/fused_*.cu: padded_width). Raises ValueError
    for a width they do not take.'''
    if not 1 <= F <= MAX_WIDTH:
        raise ValueError(
            f'the CUDA kernels take 1 <= F <= {MAX_WIDTH}, got F={F} '
            '(ROADMAP.md B, "Widths other than 32, 64 and 128")')
    return (F + 31) // 32 * 32 if F <= 128 else (F + 63) // 64 * 64


def width_flags(F):
    """The compiler defines of the library of K1-K8 that runs width F: its
    padded width and, where F is below it, NN_PADDED."""
    Fp = padded_width(F)
    return (f'-DNN_WIDTH={Fp}',) + (('-DNN_PADDED',) if F != Fp else ())


def _check(name, F, dot_dtype='float32'):
    """Refuses a width for a source of K1-K8 that lacks one, or has one it
    does not take, a width for any other source, and a bf16 library of a
    source that has none."""
    if dot_dtype not in DOT_DTYPES:
        raise ValueError(f'dot_dtype must be one of {DOT_DTYPES}, got '
                         f'{dot_dtype!r}')
    if dot_dtype == 'bfloat16' and name not in BF16_SOURCES:
        raise ValueError(f'{name} has no bf16 library')
    if name in WIDE_SOURCES:
        if F is None:
            raise ValueError(f'{name} is built per feature width: give F')
        padded_width(F)
    elif F is not None:
        raise ValueError(f'{name} is not built per feature width')


def _key(name, F=None, dot_dtype='float32'):
    """The library of source `name` that runs width F (None for a source
    not built per width) in dot_dtype's mode."""
    if F is None:
        return name
    Fp = padded_width(F)
    return (f'{name}-w{Fp}' + ('p' if F != Fp else '')
            + ('-bf16' if dot_dtype == 'bfloat16' else ''))


def flags(name, F=None, dot_dtype='float32'):
    """nvcc's flags for the library of source `name` that runs width F in
    dot_dtype's mode."""
    return (NVCC_FLAGS + (() if F is None else width_flags(F))
            + (('-DNN_BF16',) if dot_dtype == 'bfloat16' else ()))


def _headers():
    """The shared headers the CUDA sources include (csrc/*.cuh)."""
    return sorted(os.path.join(SRC_DIR, h) for h in os.listdir(SRC_DIR)
                  if h.endswith('.cuh'))


def _target(name, src=None, flags=NVCC_FLAGS, prefix='lib', headers=(),
            stem=None):
    with open(src or os.path.join(SRC_DIR, name + '.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(flags).encode())
    for path in headers:
        with open(path, 'rb') as f:
            digest.update(f.read())
    return os.path.join(
        BUILD_DIR, f'{prefix}{stem or name}-{digest.hexdigest()[:16]}.so')


def _lib_target(name, F, dot_dtype='float32'):
    return _target(name, flags=flags(name, F, dot_dtype),
                   headers=_headers(), stem=_key(name, F, dot_dtype))


def build_all(names=SOURCES, widths=(), bf16_widths=()):
    '''Compile every library whose file is missing, all in parallel: each
    source in `names` outside WIDE_SOURCES, for each width F in `widths`
    the library that runs F of each of them in WIDE_SOURCES and, for each
    width in `bf16_widths`, the bf16 library of each of them in
    BF16_SOURCES.

    Returns {library: (seconds, ptxas report)} for the libraries it
    compiled. Raises RuntimeError with the compiler's output if one fails.'''
    os.makedirs(BUILD_DIR, exist_ok=True)
    libs = [(name, None, 'float32') for name in names
            if name not in WIDE_SOURCES]
    libs += [(name, F, 'float32') for F in widths for name in names
             if name in WIDE_SOURCES]
    libs += [(name, F, 'bfloat16') for F in bf16_widths for name in names
             if name in BF16_SOURCES]
    jobs = {}
    for name, F, dot_dtype in libs:
        key = _key(name, F, dot_dtype)
        so = _lib_target(name, F, dot_dtype)
        if os.path.exists(so) or key in jobs:
            continue
        tmp = f'{so}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *flags(name, F, dot_dtype), '-o', tmp,
               os.path.join(SRC_DIR, name + '.cu')]
        jobs[key] = (so, tmp, time.perf_counter(),
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


def load(name, F=None, dot_dtype='float32'):
    '''The ctypes handle of csrc/<name>.cu, built first if needed; for a
    source of WIDE_SOURCES, of the library that runs feature width F, and
    for one of BF16_SOURCES with dot_dtype 'bfloat16' its bf16 library.
    Raises ValueError, before anything is built, for a width the kernels
    do not take.'''
    _check(name, F, dot_dtype)
    key = _key(name, F, dot_dtype)
    if key not in _LIBS:
        bf16 = dot_dtype == 'bfloat16'
        widths = () if F is None else (F,)
        build_all((name,), () if bf16 else widths, widths if bf16 else ())
        _LIBS[key] = ctypes.CDLL(_lib_target(name, F, dot_dtype))
    return _LIBS[key]


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
