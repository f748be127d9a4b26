"""Build the package's CUDA sources into a shared library and load it.

``load_library(name)`` compiles ``csrc/<name>.cu`` with ``nvcc`` on first
use into ``_build/`` beside this package (listed in ``.gitignore``) and
loads it with ``ctypes``; ``build_all(names)`` compiles several sources at
once, one ``nvcc`` each.  The library's file name carries a hash of every
source under ``csrc/`` and of the compiler flags, so an edited source is
rebuilt and a stale library is never loaded.  The build needs only
``nvcc`` and the CUDA toolkit's headers -- no PyTorch headers, no network.
A missing ``nvcc`` or a failed build raises with the compiler's output;
there is no fallback.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# after the source: the tensor-core tile encodes its TMA descriptors with the
# driver's cuTensorMapEncodeTiled
LIBS = ('-lcuda',)

_LOADED = {}


def find_nvcc():
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``, the toolkit's standard install prefix)."""
    nvcc = shutil.which('nvcc')
    if nvcc:
        return nvcc
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    nvcc = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.isfile(nvcc):
        return nvcc
    raise RuntimeError('nvcc not found (not on PATH and not under '
                       '$CUDA_HOME/bin): the CUDA kernels cannot be built')


def _source_hash():
    h = hashlib.sha256(' '.join(NVCC_FLAGS + LIBS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, '*'))):
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name):
    return os.path.join(BUILD_DIR, 'lib{0}_{1}.so'.format(name,
                                                          _source_hash()))


def build_all(names):
    """Compile ``csrc/<name>.cu`` for every name that has no up-to-date
    library, one ``nvcc`` per source, all started together; waits for all
    of them (even when one fails) and returns the library paths.  The
    compiler's output (register and shared memory use per kernel) is kept
    beside each library as ``<lib>.log``."""
    jobs = []
    try:
        for name in names:
            lib = library_path(name)
            if os.path.isfile(lib):
                jobs.append((lib, None, None, None))
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            src = os.path.join(CSRC_DIR, name + '.cu')
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, src, *LIBS]
            proc = subprocess.Popen(cmd, cwd=CSRC_DIR, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((lib, proc, tmp, cmd))
    finally:
        failures = []
        for lib, proc, tmp, cmd in jobs:
            if proc is None:
                continue
            out, err = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failures.append('building {0} failed ({1}):\n{2}\n{3}'.format(
                    os.path.basename(lib), ' '.join(cmd), out, err))
                continue
            with open(lib + '.log', 'w') as f:
                f.write(out + err)
            # atomic publish: a concurrent build of the same sources writes
            # the same bytes, and a reader never sees a half-written library
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError('\n'.join(failures))
    return [lib for lib, _, _, _ in jobs]


def load_library(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(build_all([name])[0])
    return _LOADED[name]
