"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface under ``build/bunmpc_tpu_torch/`` (listed in
``.gitignore``) at first use, and loaded with ``ctypes``. Only the sources in
``bunmpc_tpu_torch/csrc/`` go into a build. A library is rebuilt when a source
is newer than it. A build with extra preprocessor defines (the profiling
build, ``-DBK_PROFILE``) goes into a library of its own name.

A kernel whose source holds several instantiations is built once per
instantiation, each selected by a define (K2 over the joint count,
``-DBK_DDP_NJ=<nj>``), so that their nvcc runs go side by side.

``build_host`` compiles the same sources with ``g++`` for the host (the
per-problem math is ``__host__ __device__``): a test-only build that lets the
CPU tests check the kernel math. It is never on the main path.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "bunmpc_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


# Shared memory one thread block may use on sm_90 (H100, H200): 227 KB, above
# 48 KB only as dynamic shared memory after cudaFuncSetAttribute (the
# launchers do it).
SMEM_PER_BLOCK = 232_448


def fit_per_block(kernel: str, bytes_per_problem: int, want: int, what: str) -> int:
    """Problems per block: ``want``, or as many as SMEM_PER_BLOCK holds at
    ``bytes_per_problem`` each. Raises ValueError if not one fits."""
    fit = SMEM_PER_BLOCK // bytes_per_problem
    if fit < 1:
        raise ValueError(
            f"{kernel}: one problem at {what} needs {bytes_per_problem} bytes of shared memory, "
            f"more than the {SMEM_PER_BLOCK} bytes a thread block may use")
    return min(want, fit)


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or PATH."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources():
    return glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))


def lib_path(name: str, defines=()) -> str:
    tag = "".join(f"_{d.lower().replace('=', '')}" for d in defines)
    return os.path.join(BUILD_DIR, f"lib{name}{tag}.so")


def _stale(path: str) -> bool:
    if not os.path.exists(path):
        return True
    t = os.path.getmtime(path)
    return any(os.path.getmtime(s) > t for s in _sources())


def _compile_cmd(name: str, out: str, defines=()):
    return [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build_kernels(kernels, force: bool = False, extra=()) -> dict:
    """Compile every stale library of ``kernels`` (``Kernel`` objects: a
    source and its defines, plus ``extra`` defines), all nvcc processes at
    once; returns {library file name: ptxas report}. Raises with the
    compiler output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for k in kernels:
        defines = tuple(k.defines) + tuple(extra)
        out = lib_path(k.name, defines)
        tag = os.path.basename(out)[3:-3]
        if tag in procs or (not force and not _stale(out)):
            continue
        tmp = os.path.join(BUILD_DIR, f"lib{tag}.{os.getpid()}.tmp.so")
        procs[tag] = (
            tmp, out,
            subprocess.Popen(
                _compile_cmd(k.name, tmp, defines), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
        )
    reports = {}
    failed = []
    for tag, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        reports[tag] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {tag} (rc {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def build_host(name: str, out_dir: str) -> str:
    """Test-only: compile ``csrc/<name>.cu`` with g++ as host C++ (the
    ``__host__ __device__`` per-problem math, float and double entry points)
    into ``out_dir``; returns the library path."""
    out = os.path.join(out_dir, f"lib{name}_host.so")
    cmd = [
        "g++", "-x", "c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", out,
        os.path.join(CSRC, f"{name}.cu"),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return out


class Kernel:
    """One kernel library (built with ``defines``): lazy build + load, and
    the count of launches of its kernel (incremented only where the kernel
    is launched)."""

    def __init__(self, name: str, defines=()):
        self.name = name
        self.defines = tuple(defines)
        self.launches = 0
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build_kernels([self])
            self._lib = ctypes.CDLL(lib_path(self.name, self.defines))
        return self._lib

    def launch(self, symbol: str, args, argtypes) -> None:
        """Call the C launcher ``symbol`` (which returns cudaGetLastError());
        raise if the launch was refused."""
        fn = getattr(self.lib(), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with cudaError {rc}")
        self.launches += 1
