"""Build and bind the port's hand-written CUDA kernels.

Each ``*.cu`` file in this directory is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface and
loaded through ``ctypes``: a build takes seconds, where a source that
includes PyTorch's headers takes minutes. Libraries go to
``build/paddle_tpu_torch/`` at the repository root, named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged
one is reused. Nothing is built at import time: the first launch (or
:func:`build_all`) builds every missing library, one ``nvcc`` process per
source, all started together.

There is no fallback: a missing ``nvcc``, a failed build or a non-zero
CUDA error code raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parents[1] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of the C interface (ptt::DType in common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_build_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


def sources() -> list:
    return sorted(_SRC_DIR.glob("*.cu"))


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(_SRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.
    Returns {stem: compiler output} for the sources built by this call.
    Raises RuntimeError naming each source that failed."""
    with _build_lock:
        todo = [s for s in sources() if not library_path(s).exists()]
        if not todo:
            return {}
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in todo:
            out = library_path(src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_SRC_DIR), "-o", str(tmp),
                   str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            logs[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)    # atomic: readers never see a partial file
        if failed:
            raise RuntimeError("CUDA kernel build failed: "
                               + "\n".join(failed))
        return logs


class Kernel:
    """One C entry point of one kernel library, with its counters.

    ``launches`` counts the kernel's launches; ``recorded`` counts calls
    made while the stream captures a CUDA graph, which launch nothing
    (each replay of the graph launches its kernel nodes);
    ``plain_calls`` counts calls of its plain PyTorch version (the CPU
    path). All are plain integers, so a run can show which path it
    took."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = _SRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]   # + stream
        self._fn = None
        self.launches = 0
        self.recorded = 0
        self.plain_calls = 0

    def reset_counts(self) -> None:
        self.launches = 0
        self.recorded = 0
        self.plain_calls = 0

    def _load(self):
        if self._fn is None:
            path = library_path(self.source)
            if not path.exists():
                build_all()
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Call the entry point on ``device``'s current stream and raise
        if it reports a CUDA error. Counts one launch, or one recorded
        call under a graph capture."""
        fn = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} failed with CUDA error {rc} "
                f"({self.source.name})")
        if capturing:
            self.recorded += 1
        else:
            self.launches += 1


__all__ = ["BUILD_DIR", "DTYPE_CODES", "Kernel", "build_all", "library_path",
           "nvcc_path", "sources"]
