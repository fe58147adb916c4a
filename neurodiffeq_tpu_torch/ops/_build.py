"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

The sources under ``neurodiffeq_tpu_torch/csrc/`` are compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, placed in
``build/kernels/`` at the root of the checkout and named by a hash of the
sources and flags, so an unchanged tree reuses it and a changed one
rebuilds. Each source is compiled once per C entry point that it defines
(``-DNDTORCH_ENTRY=1, 2, ...``, the order of ``SOURCE_ENTRIES``), all of
them at once, and the objects are linked. Importing this module builds
nothing; :func:`load_library` does, on the first call.
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
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIB = None
BUILD_INFO = {}  # 'path', 'seconds' (0.0 when reused), 'log' (nvcc's stderr)

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {  # C entry point -> argument types, as the csrc/ sources declare them
    'taylor_mlp_1h': [_VP, _INT, _INT, _INT, _INT, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                      _VP, _VP, _VP, _VP],
    'taylor_mlp': [_VP, _INT, _INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_VP),
                   ctypes.POINTER(_VP), _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VP, _VP, _VP, _VP,
                   _VP],
    'taylor_mlp_streams_staged': [_VP, _INT, _INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_VP),
                                  ctypes.POINTER(_VP), _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VP,
                                  _VP, _VP, _VP, _VP],
    'taylor_mlp_streams': [_VP, _INT, _INT, _INT, ctypes.POINTER(_INT), ctypes.POINTER(_VP),
                           ctypes.POINTER(_VP), _INT, _INT, _INT, _INT, _INT, _INT, _VP, _VP],
    'taylor_mlp_1h_bwd': [_VP, _INT, _INT, _INT, _INT, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                          _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP],
}
# source -> the C entry points it defines, in the order of its NDTORCH_ENTRY = 1, 2, ...
SOURCE_ENTRIES = {
    'taylor_mlp.cu': [name + suffix for name in ('taylor_mlp_1h', 'taylor_mlp', 'taylor_mlp_streams_staged',
                                                 'taylor_mlp_1h_bwd') for suffix in ('_f32', '_f64')],
    'taylor_mlp_streams.cu': ['taylor_mlp_streams_f32', 'taylor_mlp_streams_f64'],
}
ENTRY_POINTS = [entry for entries in SOURCE_ENTRIES.values() for entry in entries]


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
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [(src, entry, f'{tmp}/{src.stem}_{entry}.o') for src in _sources() if src.suffix == '.cu'
                 for entry in range(1, len(SOURCE_ENTRIES[src.name]) + 1)]
        cmds = [[nvcc, *NVCC_FLAGS, f'-DNDTORCH_ENTRY={entry}', '-c', '-o', obj, str(src)]
                for src, entry, obj in units]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for cmd in cmds]
        logs = [p.communicate()[1] for p in procs]  # waits for every compile, failed or not
        for cmd, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{log}")
        link = [nvcc, '-shared', '-o', f'{tmp}/lib.so', *[obj for _, _, obj in units]]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}")
        os.replace(f'{tmp}/lib.so', out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, log=''.join(logs))
    return out


def load_library():
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for entry in ENTRY_POINTS:
            fn = getattr(lib, entry)
            fn.argtypes = _ARGTYPES[entry[:-4]]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
