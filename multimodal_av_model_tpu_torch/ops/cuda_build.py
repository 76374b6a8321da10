"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``.  The build
happens at first use, into ``build/kernels/`` at the repository root (listed
in ``.gitignore``), or under the directory ``set_build_root`` names
(``runtime/compile_cache.py``); the library's file name carries a hash of its
source, so an edited source is rebuilt and a built one is reused.  Nothing
here runs at import time: this module is imported on machines that have no
CUDA toolkit, where only the plain versions of the kernels run.

Every launch of every kernel goes through a ``Launcher``: the library's
entry point, typed once at the first launch, called on the current stream,
its return code checked and the launch counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_build_root = os.path.dirname(BUILD_DIR)

# Kernel name -> source file under csrc/.
SOURCES = {
    "logmel": "logmel.cu",
    "lip": "lip_preprocess.cu",
    "prefix_beam": "prefix_beam.cu",
    "bilstm": "bilstm.cu",
}

# Shared memory a block can use on the H100 (227 KB).
SMEM_LIMIT = 232_448

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_launchers: list["Launcher"] = []


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
                       "cannot be built")


def set_build_root(path: str) -> None:
    """Build (and look for built) libraries under ``path`` from now on:
    kernels in ``<path>/kernels``, the host ops in ``<path>/hostops``."""
    global _build_root
    _build_root = path


def build_dir(kind: str = "kernels") -> str:
    return os.path.join(_build_root, kind)


def source_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def library_path(name: str) -> str:
    digest = source_digest(os.path.join(CSRC_DIR, SOURCES[name]))
    return os.path.join(build_dir(), f"lib{name}-{digest}.so")


def _nvcc_command(name: str, lib: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", lib, os.path.join(CSRC_DIR, SOURCES[name])]


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet, one
    ``nvcc`` process per source, all started together.  Returns each name's
    compiler log (ptxas register and shared-memory report); raises if any
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        lib = library_path(name)
        if os.path.isfile(lib):
            logs[name] = "(already built)"
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"          # renamed into place when built
        procs[name] = (lib, tmp, subprocess.Popen(
            _nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use and cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


class Launcher:
    """The entry point ``<prefix>_<symbol>`` of kernel ``name``'s library:
    ``argtypes`` are its arguments but the last, the stream; it returns an
    ``int``, the launch's CUDA error.  It is bound and typed at its first
    launch, after ``on_load(lib)`` checks the library, and kept.

    ``launcher(device, counted, *args)`` launches on ``device``'s current
    stream, raises if the launch returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it) and adds 1 to
    ``counted.launches``: the count kept on the kernel's public entry, which
    ``ops.launch_counts`` reads."""

    def __init__(self, name: str, prefix: str, argtypes: list, symbol: str = "launch",
                 on_load=None):
        self.name, self.prefix, self.symbol = name, prefix, f"{prefix}_{symbol}"
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self.on_load = on_load
        self.lib = self.fn = None
        _launchers.append(self)

    def _bind(self):
        lib = load(self.name)
        if self.on_load is not None:
            self.on_load(lib)
        fn = getattr(lib, self.symbol)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        self.lib, self.fn = lib, fn
        return fn

    def __call__(self, device, counted, *args) -> None:
        fn = self.fn if self.fn is not None else self._bind()
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if code != 0:
            err = getattr(self.lib, f"{self.prefix}_error_string")
            err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
            raise RuntimeError(f"{self.prefix} launch failed: CUDA error {code} "
                               f"({err(code).decode()})")
        counted.launches += 1


def rebind(name: str) -> None:
    """Bind kernel ``name``'s launchers again at their next launch, to the
    library ``_libs`` then holds for it (``tools/kernel_phases.py`` puts an
    instrumented build there)."""
    for launcher in _launchers:
        if launcher.name == name:
            launcher.fn = None
