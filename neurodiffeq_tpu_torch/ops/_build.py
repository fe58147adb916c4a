"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

The sources under ``neurodiffeq_tpu_torch/csrc/`` are compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, placed in
``build/kernels/`` at the root of the checkout and named by a hash of the
sources and flags, so an unchanged tree reuses it and a changed one
rebuilds. Importing this module builds nothing; :func:`load_library` does,
on the first call.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIB = None
BUILD_INFO = {}  # 'path', 'seconds' (0.0 when reused), 'log' (nvcc's stderr)

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {  # C entry point -> argument types, as declared in csrc/taylor_mlp.cu
    'taylor_mlp_1h': [_VP, _INT, _INT, _INT, _INT, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                      _VP, _VP, _VP, _VP],
    'taylor_mlp': [_VP, _INT, _INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_VP),
                   ctypes.POINTER(_VP), _INT, _INT, _INT, _INT, _INT, _INT, _VP, _VP, _VP, _VP],
}


def _sources():
    return sorted(list(_CSRC.glob('*.cu')) + list(_CSRC.glob('*.cuh')))


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        candidates.append(found)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of neurodiffeq_tpu_torch cannot be built")


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libndtorch_kernels_{h.hexdigest()[:16]}.so'


def build():
    """Compile the library unless it exists; return its path."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, log='')
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == '.cu']
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, *cu]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, log=proc.stderr)
    return out


def load_library():
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            for suffix in ('_f32', '_f64'):
                fn = getattr(lib, name + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
