# pixelrec_multimodal_tpu_torch/ops/_build.py
"""Build and load the hand-written CUDA kernels in ``ops/csrc``, the
measurement probes in ``probes/csrc`` and any source a caller registers
(``register_source``: the nvJPEG binding of the image tier).

Each ``<dir>/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface,
``build/kernels/<name>-<hash>.so`` at the root of the checkout, on first
use. The hash covers the source, the shared headers (``*.cuh`` of its
directory and of ``ops/csrc``, which every source may include) and the
compiler flags, so an edited source or header builds anew and an unchanged
one loads the library already built. Names are unique across the
directories. A registered source may link libraries of the CUDA toolkit
(``link_flags``), and its link flags are in its hash too. Libraries load through ``ctypes``: every
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
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / 'csrc'
PROBES_CSRC = Path(__file__).resolve().parents[1] / 'probes' / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: Dict[str, ctypes.CDLL] = {}
# Sources outside ops/csrc and probes/csrc: name -> (directory, the
# toolkit libraries it links), set by their callers.
_registered: Dict[str, Tuple[Path, Tuple[str, ...]]] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (on PATH or /usr/local/cuda/bin): '
                           'the CUDA kernels are built on the machine with '
                           'the card')
    return path


def register_source(name: str, directory, libraries: Iterable[str] = ()):
    """Make ``<directory>/<name>.cu`` buildable by name, linked with the
    CUDA toolkit's ``lib<stem>`` for each stem of ``libraries``."""
    _registered[name] = (Path(directory), tuple(libraries))


def _source_dir(name: str) -> Path:
    """``ops/csrc`` for a kernel, ``probes/csrc`` for a probe, the
    registered directory for a registered source."""
    if name in _registered:
        return _registered[name][0]
    return PROBES_CSRC if (PROBES_CSRC / f'{name}.cu').exists() else CSRC


def toolkit_library(stem: str) -> Optional[Path]:
    """The CUDA toolkit's ``lib<stem>.so*`` (under ``$CUDA_HOME`` or
    ``/usr/local/cuda``, in ``lib64`` or ``targets/x86_64-linux/lib``), or
    None."""
    for root in filter(None, (os.environ.get('CUDA_HOME'),
                              '/usr/local/cuda')):
        for sub in ('lib64', 'targets/x86_64-linux/lib'):
            found = sorted((Path(root) / sub).glob(f'lib{stem}.so*'))
            if found:
                return found[0]
    return None


def link_flags(name: str) -> tuple:
    """The toolkit libraries a registered source links, each with its
    directory searched at link and at load time (``-l<stem>`` alone where
    it is not found, and the link then fails); nothing for the kernels and
    the probes."""
    flags = ()
    for stem in _registered.get(name, (None, ()))[1]:
        lib = toolkit_library(stem)
        if lib is None:
            flags += (f'-l{stem}',)
            continue
        d = str(lib.parent)
        flag = (f'-l{stem}' if (lib.parent / f'lib{stem}.so').exists()
                else f'-l:{lib.name}')
        flags += ('-L', d, flag, '-Xlinker', f'-rpath={d}')
    return flags


def library_path(name: str) -> Path:
    """Where ``<dir>/<name>.cu`` builds to, named by the hash of its source,
    of every header it may include (``*.cuh`` of its directory and of
    ``ops/csrc``) and of the compiler flags, so an edited header builds
    anew too."""
    src = _source_dir(name)
    h = hashlib.sha256((src / f'{name}.cu').read_bytes())
    headers = {p.resolve() for d in (src, CSRC) for p in d.glob('*.cuh')}
    for header in sorted(headers, key=lambda p: (p.name, str(p))):
        h.update(header.name.encode() + b'\0' + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS + link_flags(name)).encode())
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
        cmd = [_nvcc(), *NVCC_FLAGS, '-I', str(CSRC), '-o', str(tmp),
               str(_source_dir(name) / f'{name}.cu'), *link_flags(name)]
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
    """The loaded library of ``<dir>/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib


def all_sources() -> list:
    """Names of every kernel source in ``ops/csrc``."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def probe_sources() -> list:
    """Names of every probe source in ``probes/csrc``."""
    return sorted(p.stem for p in PROBES_CSRC.glob('*.cu'))
