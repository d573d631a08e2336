"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \\
         -shared -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <name>.cu

at first use, into ``build/kernels/`` at the root of the checkout.  The file
name carries a hash of the source and the flags, so an edited source builds
anew.  ``--fmad=false`` is part of the kernels' contract: they must equal
their plain versions bitwise, and a fused multiply-add rounds once where the
plain version rounds twice.

A source may hold several kernels (``delta_push.cu`` holds two); each has
its own C entry point ``<kernel>_launch`` and the source one
``<source>_error_string``.  Each entry point launches on the stream it is
given (PyTorch's current stream) and returns ``cudaGetLastError()``;
``CudaKernel.launch`` raises if that is not 0 and counts the launches that
succeeded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's compiler at first use")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str], ptxas_info: bool = False) -> Dict[str, str]:
    """Compile every named source that is not built yet, starting one nvcc
    per source at once.  Returns the compiler's output per name built;
    raises with that output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_info else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


class CudaKernel:
    """One kernel's C entry point, loaded at first launch, with a plain
    integer count of its successful launches.  ``source`` names the
    ``csrc/<source>.cu`` file that holds it (default: ``name``)."""

    def __init__(self, name: str, argtypes: List, source: str = ""):
        self.name = name
        self.source = source or name
        self.argtypes = argtypes
        self.launches = 0
        self._count_lock = threading.Lock()   # trainer and batcher threads
        self._fn = None
        self._err = None

    def _load(self):
        with _LOCK:
            if self._fn is None:
                build([self.source])
                lib = ctypes.CDLL(str(library_path(self.source)))
                fn = getattr(lib, f"{self.name}_launch")
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.source}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib, self._err, self._fn = lib, err, fn
        return self._fn

    def launch(self, *args) -> None:
        fn = self._fn or self._load()
        code = fn(*args)
        if code != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{code} ({self._err(code).decode()})")
        with self._count_lock:
            self.launches += 1


def stream_args(tensor) -> tuple:
    """(device index, current stream handle) for a CUDA tensor."""
    import torch

    dev = tensor.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream

