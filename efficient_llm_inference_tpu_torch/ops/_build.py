"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `build/cuda/<name>-<hash>.so`
(the hash covers the source, the shared headers `csrc/*.cuh` and the flags,
so an edited source or header rebuilds).
The first `load` builds every source that is missing, one nvcc process per
source, all started together. Sources have a plain C interface and include
no PyTorch header, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
SOURCES = ("quantize_rows", "fused_quant_attention", "gpt2_megastep", "gpt2_megabatch",
           "gpt2_megaverify", "llama_megastep", "megabatch", "megaverify", "megabatch_verify",
           "draft_burst", "dequant", "linear", "paged_attention")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compiles every source whose library is missing, in parallel.

    Returns {name: seconds} for the sources compiled. Raises RuntimeError
    with nvcc's output if any compile fails. The ptxas report (registers,
    shared memory, spills) is kept beside each library as `<name>.log`.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                build_all()
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raises if a kernel entry point of `lib` returned a CUDA error code."""
    if rc != 0:
        fn = lib.elit_cuda_error_string
        fn.restype, fn.argtypes = ctypes.c_char_p, [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} ({fn(rc).decode()}) at launch")
