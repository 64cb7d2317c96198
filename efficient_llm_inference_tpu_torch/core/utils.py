"""Memory accounting and timing (PyTorch port of
efficient_llm_inference_tpu/core/utils.py)."""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


def get_cpu_mem_mb() -> float:
    """Current process resident set size in MB (from /proc)."""
    with open(f"/proc/{os.getpid()}/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / (1024**2)


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def reset_device_peak(device: str = "cuda") -> None:
    """Start a peak-memory window on a CUDA device (no-op on the CPU)."""
    if _is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


def get_device_peak_mb(device: str = "cuda") -> Optional[float]:
    """Peak device memory in MB since the last `reset_device_peak`; None on
    the CPU, which has no device memory to report."""
    if not _is_cuda(device):
        return None
    return torch.cuda.max_memory_allocated(device) / (1024**2)


def tensor_bytes(x) -> int:
    """Memory footprint of a tensor in bytes."""
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def mb(num_bytes: int) -> float:
    """Bytes -> MB."""
    return num_bytes / (1024**2)


def kv_bytes_fp(k, v) -> int:
    """Total bytes of a K/V pair."""
    return tensor_bytes(k) + tensor_bytes(v)


class DeviceTimer:
    """Elapsed seconds of the work enqueued between `start` and `stop`.

    On CUDA it brackets the stream with events and synchronises at `stop`;
    on the CPU, where work is synchronous, it reads the host clock.
    """

    def __init__(self, device: str = "cuda"):
        self.cuda = _is_cuda(device)
        self.elapsed = 0.0

    def start(self) -> "DeviceTimer":
        if self.cuda:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev1 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self.cuda:
            self._ev1.record()
            self._ev1.synchronize()
            self.elapsed = self._ev0.elapsed_time(self._ev1) / 1e3
        else:
            self.elapsed = time.perf_counter() - self._t0
        return self.elapsed
