"""Timing on the device's clock.

CUDA events recorded on the stream around the work, read after a
synchronise, as ``chip_smoke.timed_ms`` takes them; on the CPU (the tests)
the host clock stands in.
"""
from __future__ import annotations

import time

import torch


class DeviceTimer:
    """``start()`` before the work is issued, ``stop()`` after it: the ms
    from issue to completion, with a synchronise in between."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)

    def start(self) -> None:
        if self.cuda:
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._end.record()
            torch.cuda.synchronize()
            return self._start.elapsed_time(self._end)
        return (time.perf_counter() - self._t0) * 1e3
