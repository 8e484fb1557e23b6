"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with ``nvcc`` into a shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The library lands in ``deepspeed_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, every ``csrc/*.cuh``
header and the flags (``source_digest``), so an edited source or header
rebuilds and an unchanged one loads at once. A missing ``nvcc`` raises:
there is no prebuilt fallback.

The host libraries of the offload paths (``csrc/host/``: the vectorized
Adam and Adagrad, the threaded file I/O) are C++ with the same kind of
plain C interface, built on first use with ``g++`` and the JAX package's
flags (``build_host``):

    g++ -O3 -std=c++17 -shared -fPIC -pthread [-march=native]

``-march=native`` joins when the compiler accepts it. The flags are the JAX
build's so that the two packages' host Adam agree bit for bit on the same
inputs. The libraries land in ``_build/`` too, named by a hash of the
source, the flags and the CPU ``-march=native`` resolves to; a missing
``g++`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

HOST_CSRC = os.path.join(CSRC, "host")
HOST_SOURCES = {"cpu_adam": "cpu_adam.cpp", "cpu_adagrad": "cpu_adagrad.cpp", "aio": "deepspeed_aio.cpp"}
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, Dict] = {}  # name -> {"seconds": .., "ptxas": ..} for builds this process ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels")


def source_digest(name: str, csrc: str = CSRC) -> str:
    """Hash of ``<csrc>/<name>.cu``, every ``<csrc>/*.cuh`` (sorted by name:
    a source may include any of them) and the flags."""
    h = hashlib.sha256()
    paths = [os.path.join(csrc, f"{name}.cu")] + sorted(glob.glob(os.path.join(csrc, "*.cuh")))
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists;
    returns the library's path. ``-Xptxas -v`` output (registers, shared
    memory, spills) is kept in ``build_log[name]``."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}_{source_digest(name)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": proc.stderr.strip()}
    return out


def build_many(names: List[str]) -> List[str]:
    """``build`` each source, all ``nvcc`` processes started together;
    returns the libraries' paths in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build(name))
    return lib


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: cannot build the host libraries of the offload paths")
    return found


_host_flags: List[str] = []
_host_target: List[str] = []


_probe_lock = threading.Lock()


def host_flags() -> List[str]:
    """``HOST_FLAGS`` plus ``-march=native`` when the compiler accepts it
    (probed once a process, as the JAX build probes)."""
    with _probe_lock:
        if not _host_flags:
            probe = subprocess.run([_gxx(), "-march=native", "-E", "-x", "c++", "/dev/null"], capture_output=True)
            _host_flags.extend(HOST_FLAGS + (["-march=native"] if probe.returncode == 0 else []))
    return list(_host_flags)


def host_target() -> str:
    """The CPU that ``-march=native`` resolves to here (part of a host
    library's name: a library built for one CPU must not load on another)."""
    flags = host_flags()
    with _probe_lock:
        if not _host_target:
            out = subprocess.run([_gxx(), *flags, "-Q", "--help=target"], capture_output=True, text=True).stdout
            _host_target.append(" ".join(line.split()[-1] for line in out.splitlines()
                                         if line.strip().startswith("-march=")))
    return _host_target[0]


def build_host(name: str) -> str:
    """Compile ``csrc/host/<source of name>`` unless a library of the same
    source and flags exists; returns its path. Written to a temporary file
    and renamed, so processes building at once never load a torn file."""
    src = os.path.join(HOST_CSRC, HOST_SOURCES[name])
    flags = host_flags()
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read() + b"\0" + " ".join(flags).encode() + b"\0" + host_target().encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_host_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_gxx(), *flags, src, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {os.path.basename(src)}:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    build_log[name] = {"seconds": time.perf_counter() - t0, "flags": flags}
    return out


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``cpu_adam``, ``cpu_adagrad``,
    ``aio``), built on first use."""
    key = f"host:{name}"
    lib = _loaded.get(key)
    if lib is None:
        lib = _loaded[key] = ctypes.CDLL(build_host(name))
    return lib
