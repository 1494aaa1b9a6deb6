"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point, is compiled by
``nvcc`` for ``sm_90a`` into a shared library at first use, and is loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds, not
minutes. Libraries land in ``build/quorum_tpu_torch/<hash>/`` beside the
package (``build/`` is git-ignored); the directory is keyed by a hash of the
source, the shared headers and the flags, so an edited kernel never loads a
stale library.

Nothing here runs at import: the CPU test suite imports every module on a
machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "quorum_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# The C entry points encode TMA tensor maps with the driver API
# (cuTensorMapEncodeTiled), so the libraries link libcuda.
LINK_FLAGS = ["-lcuda"]
KERNEL_SOURCES = ("flash_prefill", "flash_decode")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _cuda_tool(name: str) -> str:
    """A CUDA toolkit program: on PATH, in $CUDA_HOME/bin (default
    /usr/local/cuda/bin), or the copy Triton's package carries."""
    found = shutil.which(name)
    if found:
        return found
    cands = [Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name]
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        cands.append(Path(spec.submodule_search_locations[0]) / "backends" / "nvidia" / "bin"
                     / name)
    for cand in cands:
        if cand.exists():
            return str(cand)
    raise KernelBuildError(f"{name} not found (PATH, $CUDA_HOME/bin, triton's nvidia/bin)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives: keyed by the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS + LINK_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest / f"lib{name}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Spawn nvcc for one source unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu"), *LINK_FLAGS]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return log


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every named kernel in parallel (one nvcc per source, all
    started together); returns nvcc's ``-Xptxas -v`` report per source
    (empty for a library that was already built)."""
    with _lock:
        jobs = {n: _start_build(n) for n in names}
        return {n: (_finish_build(n, j) if j is not None else "") for n, j in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of ``opcode`` (e.g. ``HGMMA``) the built
    library's machine code holds, from ``cuobjdump -sass``."""
    dump = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum(1 for ln in dump.splitlines() if f" {opcode}." in ln or f" {opcode} " in ln)


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a kernel's entry point
    (a refused launch never runs, and no later synchronize reports it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
