"""What the card says of itself: its name and power limit, and its SM clock
sampled by ``nvidia-smi`` beside the measured window."""

from __future__ import annotations

import subprocess
from datetime import datetime


def name_and_power_limit(index: int) -> tuple[str, str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = (part.strip() for part in out.strip().split(","))
    return name, limit


class ClockSampler:
    """``nvidia-smi`` printing a timestamp and the SM clock (MHz) once a
    period from ``start()`` until ``stop()``, which ends it, waits for it and
    returns the clocks stamped between ``open()`` and ``close()``.  Each
    query runs a process beside the measured one, so it samples seldom."""

    def __init__(self, index: int, period_ms: int = 5000):
        self.cmd = ["nvidia-smi", "--query-gpu=timestamp,clocks.sm",
                    "--format=csv,noheader,nounits", "-i", str(index), "-lms", str(period_ms)]
        self.proc = None
        self.t_open = self.t_close = None

    def start(self) -> None:
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE, text=True)

    def open(self) -> None:
        self.t_open = datetime.now()

    def close(self) -> None:
        self.t_close = datetime.now()

    def stop(self) -> list[float]:
        if self.proc is None:
            return []
        self.proc.terminate()
        text, _ = self.proc.communicate(timeout=30)
        self.proc = None
        clocks = []
        for line in text.splitlines():
            parts = [s.strip() for s in line.split(",")]
            if len(parts) != 2:
                continue
            try:
                stamp = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
                mhz = float(parts[1])
            except ValueError:
                continue
            if self.t_open and self.t_close and self.t_open <= stamp <= self.t_close:
                clocks.append(mhz)
        return clocks
