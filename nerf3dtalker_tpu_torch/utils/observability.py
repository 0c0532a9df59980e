"""Tracing, meters and the metric log (port of
`nerf3dtalker_tpu/utils/observability.py`):

  * `trace` / `start_trace` / `stop_trace` — a torch.profiler capture (host
    ops, and the device's kernels where there is a card) written as a
    Chrome / Perfetto trace, `<logdir>/trace.json`;
  * `annotate` — a named span in that trace;
  * `AverageMeter` / `Throughput` — the reference's meters
    (base/utilities.py:35-51, arcface utils_callbacks imgs/sec);
  * `MetricLogger` — `metrics.jsonl` lines and, asked for, TensorBoard
    scalars (the reference's SummaryWriter, talker_trainer.py:623).

On the card's machine torch.profiler drops kernels whose mapped timestamps
stray outside a short capture, more as the process ages; every capture is
padded by `PAD_S` seconds of idle device on each side
(`scripts/profiler_window.py` measured 2 s to keep every kernel).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch

PAD_S = 2.0
TRACE_FILE = "trace.json"

_active: Optional[dict] = None   # the one trace in progress, as jax.profiler has


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Profile a region: `with trace('./prof'): step(...)`; the trace goes
    to `<logdir>/trace.json`."""
    if not enabled:
        yield
        return
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


def start_trace(logdir: str) -> None:
    """Begin a profiler capture mid-loop (pair with `stop_trace`; the Trainer
    traces steps 1..N of its first epoch this way)."""
    global _active
    from torch.profiler import ProfilerActivity, profile

    if _active is not None:
        raise RuntimeError("a trace is already in progress")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    prof = profile(activities=activities)
    prof.start()
    if cuda:
        time.sleep(PAD_S)
    _active = {"prof": prof, "logdir": logdir, "cuda": cuda}


def stop_trace() -> str:
    """End the capture and write its trace; returns the file's path."""
    global _active
    if _active is None:
        raise RuntimeError("no trace in progress")
    done, _active = _active, None
    if done["cuda"]:
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    done["prof"].stop()
    os.makedirs(done["logdir"], exist_ok=True)
    path = os.path.join(done["logdir"], TRACE_FILE)
    done["prof"].export_chrome_trace(path)
    return path


def annotate(name: str):
    """A named span in the trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


class AverageMeter:
    """Running average (base/utilities.py:35-51)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Throughput:
    """items/sec with exponential smoothing (arcface CallBackLogging)."""

    def __init__(self, smoothing: float = 0.9):
        self._t = None
        self._rate = 0.0
        self._s = smoothing

    def tick(self, n_items: int) -> float:
        now = time.perf_counter()
        if self._t is not None:
            inst = n_items / max(now - self._t, 1e-9)
            self._rate = self._s * self._rate + (1 - self._s) * inst if self._rate else inst
        self._t = now
        return self._rate


class TensorBoardUnavailable(ImportError):
    """`use_tensorboard` asked for scalars that torch.utils.tensorboard
    cannot write here."""


class MetricLogger:
    """Append-only `metrics.jsonl` under `logdir` and, with
    `use_tensorboard`, the same scalars as TensorBoard events there. A
    missing `tensorboard` package raises `TensorBoardUnavailable` here,
    before anything is logged (the JAX logger drops the scalars silently)."""

    def __init__(self, logdir: str, use_tensorboard: bool = False):
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise TensorBoardUnavailable(
                    f"use_tensorboard (--tensorboard) needs the tensorboard package, which "
                    f"torch.utils.tensorboard cannot import here: {e}") from e
        os.makedirs(logdir, exist_ok=True)
        if use_tensorboard:
            self._tb = SummaryWriter(logdir)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
