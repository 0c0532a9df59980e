"""Training checkpoints of the port: one `torch.save` file per saved step,
`<dir>/ckpt_<step>.pt`, holding the model, audio and optimizer state, the
step, the two configs and the validation metrics (the reference's
`{epoch, net, audio2style, optim_*, para}` dict, talker_trainer.py:913-937).
They are the port's own format: the JAX package's orbax checkpoints do not
load here, nor these there.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def save_checkpoint(ckpt_dir: str, payload: dict, step: int, keep: int = 3) -> str:
    """Write `payload` for `step` under `ckpt_dir` (through a temporary file,
    so an interrupted save leaves the older ones readable) and keep the
    newest `keep` checkpoints. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.pt")
    tmp = path + f".{os.getpid()}.tmp"
    torch.save({**payload, "step": step}, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, f"ckpt_{old:08d}.pt"))
    return path


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint file under `ckpt_dir`, or None."""
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, f"ckpt_{steps[-1]:08d}.pt") if steps else None


def has_checkpoint(ckpt_dir: str) -> bool:
    return latest_checkpoint(ckpt_dir) is not None


def load_checkpoint(ckpt_dir: str, map_location=None) -> dict:
    """The newest checkpoint's payload (tensors on `map_location`)."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return torch.load(path, map_location=map_location, weights_only=True)
