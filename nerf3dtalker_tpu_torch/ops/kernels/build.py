"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled for
`sm_90a` into `build/kernels/lib<name>-<hash>.so` at the checkout's root
the first time it is used; the hash of the source and of the shared
headers (`csrc/*.cuh`) names the library, so an edited source builds anew
and an unchanged one is loaded as it is.
`build_all` compiles several sources at once, one `nvcc` each. Nothing is
compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The `nvcc` on PATH, else the one under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> List[str]:
    """The names of every kernel source, `csrc/<name>.cu`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Optional[Iterable[str]] = None) -> List[dict]:
    """Compile the kernels `names` (default: every source) that are not
    built yet, one `nvcc` process each, all started at once. Returns one
    record per kernel, in order: name, library, seconds, and the compiler's
    output (`-Xptxas -v` registers and shared memory). Raises if any `nvcc`
    fails, after every one has ended."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            running.append((name, out, None, None, 0.0))
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    records, failed = [], []
    for name, out, tmp, proc, t0 in running:
        if proc is None:
            records.append({"name": name, "library": str(out), "seconds": 0.0, "log": "cached"})
            continue
        log = proc.communicate()[0]
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        records.append({"name": name, "library": str(out), "seconds": secs, "log": log})
    if failed:
        raise RuntimeError("\n".join(failed))
    return records


def build(name: str) -> dict:
    """Compile kernel `name` unless it is built already; its record."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
