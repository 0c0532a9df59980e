"""Does torch.profiler keep a short window's kernels as the process ages?
Every --every seconds of matmul load, profile three 2048^2 matmuls with the
window padded by each of --pads seconds of idle device on both sides, and
print one JSON line: per padding, the kernels the profiler kept and each
one's start minus its launch op's start (ms).

torch.profiler keeps a kernel only if its device timestamp, mapped onto the
host's clock, falls inside the session's window; where that mapping strays,
a short window loses some or all of its kernels. `chip_smoke.py` pads its
sessions by what this measures.

    python -m nerf3dtalker_tpu_torch.scripts.profiler_window --seconds 170
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile


def window(a: torch.Tensor, pad: float):
    """(kernels kept, [kernel start - aten::mm start, ms]) of one session."""
    a @ a
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(3):
            a @ a
        torch.cuda.synchronize()
        time.sleep(pad)
    events = prof.events()
    cpu = sorted(e.time_range.start for e in events if e.name == "aten::mm"
                 and e.device_type == torch.autograd.DeviceType.CPU)
    gpu = sorted(e.time_range.start for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return len(gpu), [round((g - c) / 1e3, 2) for c, g in zip(cpu, gpu)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=170.0)
    ap.add_argument("--every", type=float, default=8.0, help="seconds of load between rows")
    ap.add_argument("--pads", default="0,0.3,2.0")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_window: needs a CUDA device")
    pads = [float(p) for p in args.pads.split(",")]
    a = torch.randn(2048, 2048, device="cuda")
    load = torch.randn(4096, 4096, device="cuda")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        row = {"age_s": round(time.perf_counter() - t0, 1)}
        row.update({f"pad_{p}": window(a, p) for p in pads})
        print(json.dumps(row), flush=True)
        end = time.perf_counter() + args.every
        while time.perf_counter() < end:
            for _ in range(10):
                load @ load
            torch.cuda.synchronize()


if __name__ == "__main__":
    main()
