"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface under ``distllm_tpu_torch/_build/`` and loaded with
``ctypes``; the host C++ of ``csrc/host/`` (the engine's native scheduler
and block allocator) is built the same way with ``g++``
(:func:`build_host`). The library's file name carries a hash of the source, of the
shared headers (``csrc/*.cuh``) and of the flags, so an edited source or
header rebuilds at its next use and an unchanged one loads at once. Nothing is built when a module is imported: the first call
that launches a kernel builds it. A failed build raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'

# Kernel name -> source file under csrc/.
SOURCES = {
    'ragged_paged_attention': 'ragged_paged_attention.cu',
    'encoder_attention': 'encoder_attention.cu',
    'int8_matmul': 'int8_matmul.cu',
}

NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
    '-Xptxas', '-v',
)

# Host (C++) libraries under csrc/host/, built with g++ (the scheduler and
# the block allocator of the engine).
HOST_SOURCES = {
    'scheduler': 'host/scheduler.cpp',
    'block_allocator': 'host/block_allocator.cpp',
}
GXX_FLAGS = ('-O2', '-shared', '-fPIC', '-std=c++17')

# One lock per kernel: two kernels build at once, one kernel builds once.
_locks = {name: threading.Lock() for name in (*SOURCES, *HOST_SOURCES)}
_lock = threading.Lock()  # guards _loaded
_loaded: dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each kernel built by this process.
build_logs: dict[str, str] = {}
# Host libraries this process built or found: built once a process.
_host_built: dict[str, Path] = {}


def find_nvcc() -> str:
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        candidate = Path('/usr/local/cuda/bin/nvcc')
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            'nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels '
            'of distllm_tpu_torch are built from source at first use'
        )
    return nvcc


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives for the current source."""
    digest = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        digest.update(header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(name: str) -> Path:
    """Build kernel ``name``'s library unless it exists for the current
    source; return its path. Raises with nvcc's output if the build fails."""
    from distllm_tpu_torch.observability.startup import get_compile_watcher

    # One 'kernel_build' start-up phase per call: a cache hit when the
    # library exists for the current source and flags.
    with _locks[name], get_compile_watcher().phase('kernel_build', name) as phase:
        target = library_path(name)
        if target.exists():
            phase['cache_hit'] = True
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f'nvcc failed to build kernel {name!r} '
                f'(exit {proc.returncode}):\n{proc.stdout}'
            )
        os.replace(tmp, target)  # atomic: a reader never sees a partial library
        build_logs[name] = proc.stdout
        return target


def build_host(name: str) -> Path:
    """Build host library ``name`` of :data:`HOST_SOURCES` with ``g++``
    unless it exists for the current source and flags; return its path
    (once a process: later calls return it at once). Raises
    ``RuntimeError`` with the compiler's output if ``g++`` is missing or
    fails (the engine then takes the Python twin)."""
    from distllm_tpu_torch.observability.startup import get_compile_watcher

    built = _host_built.get(name)
    if built is not None:
        return built
    source = CSRC_DIR / HOST_SOURCES[name]
    digest = hashlib.sha256(source.read_bytes())
    digest.update(' '.join(GXX_FLAGS).encode())
    target = BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'
    with _locks[name], get_compile_watcher().phase('kernel_build', name) as phase:
        if target.exists():
            phase['cache_hit'] = True
            _host_built[name] = target
            return target
        gxx = shutil.which('g++')
        if gxx is None:
            raise RuntimeError(f'g++ not found: cannot build the host library {name!r}')
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, str(source), '-o', str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f'g++ failed to build the host library {name!r} '
                f'(exit {proc.returncode}):\n{proc.stdout}'
            )
        os.replace(tmp, target)
        _host_built[name] = target
        return target


def build_all() -> dict[str, Path]:
    """Build every kernel of ``SOURCES`` at once, one ``nvcc`` per source
    in its own thread; raises the first failure after all have ended."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
    return {name: future.result() for name, future in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build(name)
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
    return lib
