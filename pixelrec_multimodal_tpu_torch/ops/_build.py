# pixelrec_multimodal_tpu_torch/ops/_build.py
"""Build and load the hand-written CUDA kernels in ``ops/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, ``build/kernels/<name>-<hash>.so``
at the root of the checkout, on first use. The hash covers the source and
the compiler flags, so an edited source builds anew and an unchanged one
loads the library already built. Libraries load through ``ctypes``: every
pointer and the stream pass as ``c_void_p``, every integer as ``c_int``.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (on PATH or /usr/local/cuda/bin): '
                           'the CUDA kernels are built on the machine with '
                           'the card')
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, named by its content hash."""
    h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all in parallel
    (one ``nvcc`` each). The compiler's register and spill report goes to
    ``<library>.log``. Raises with the compiler output if a build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names}
    procs = []
    for name, lib in todo.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, proc in procs:
        output, _ = proc.communicate()
        lib.with_suffix('.log').write_bytes(output)
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exited {proc.returncode}\n'
                          f'{output.decode(errors="replace")}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib


def all_sources() -> list:
    """Names of every kernel source in ``csrc``."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))
