"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. Libraries are built at first use into ``build/kernels/`` at the
repository root (listed in ``.gitignore``), named by a digest of their
source, so an edited kernel is never served from a stale build.
:func:`build` starts every requested compile at once and waits for all of
them, so a cold start costs one ``nvcc`` run, not one per kernel.

Every kernel wrapper calls :func:`count` right after a successful launch;
:data:`LAUNCHES` is how a run shows that the serving path went through the
kernels and not through their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
SOURCES = ('flash_decode', 'quantize', 'yoco_vmm')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

#: kernel name -> launches since the last :func:`reset_counts`
LAUNCHES: Dict[str, int] = {'flash_decode_paged': 0, 'flash_chunk_paged': 0,
                            'flash_decode_paged_q8': 0,
                            'flash_decode_contig': 0,
                            'flash_decode_paged_mla': 0,
                            'flash_chunk_paged_mla': 0,
                            'flash_decode_paged_mla_q8': 0,
                            'quantize_rows': 0, 'int8_matmul': 0,
                            'yoco_vmm_int8': 0}
#: source name -> the compiler's report (ptxas registers / shared memory)
BUILD_LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}
_LOCK = threading.Lock()


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin): the '
                           'CUDA kernels cannot be built')
    return path


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for part in sorted(CSRC.glob('*.cuh')) + [CSRC / f'{name}.cu']:
        h.update(part.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}_{h.hexdigest()[:12]}.so'


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current build, all ``nvcc``
    processes running at once. Raises with the compiler's output if any
    compile fails. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f'--- {name}.cu (nvcc exit {proc.returncode})\n{log}')
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return out


def function(lib: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of library ``lib`` (built on first use),
    returning an ``int`` CUDA error code."""
    key = (lib, symbol)
    fn = _FNS.get(key)
    if fn is None:
        with _LOCK:
            if lib not in _LIBS:
                _LIBS[lib] = ctypes.CDLL(str(build([lib])[lib]))
            fn = getattr(_LIBS[lib], symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
            _FNS[key] = fn
    return fn


def check(err: int, lib: str, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = _LIBS[lib].error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f'{what}: CUDA error {err} '
                           f'({msg(err).decode()})')


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors, dtypes=None) -> None:
    """Wrapper-side checks before a launch: every tensor on one CUDA device
    and contiguous; ``dtypes`` (a tuple per tensor, or None) limits types."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError(f'{name}: tensor {i} is on {t.device}; the kernel '
                             f'takes CUDA tensors on one device')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensor {i} is not contiguous')
        if dtypes is not None and dtypes[i] is not None \
                and t.dtype not in dtypes[i]:
            raise TypeError(f'{name}: tensor {i} has dtype {t.dtype}, '
                            f'expected one of {dtypes[i]}')
