"""Helpers that the loops under ``loops/`` share."""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def derive_seed(seed: int, *parts: int) -> int:
    """A 31-bit seed for one use of the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *parts])
    return int(ss.generate_state(1)[0] & 0x7FFFFFFF)


def from_file(text: str, fn):
    """fn(path) of a scene file holding `text`, in a temporary directory
    that is gone afterwards."""
    with tempfile.TemporaryDirectory(prefix="statbench-") as tmp:
        path = os.path.join(tmp, "scene.pbrt")
        with open(path, "w") as f:
            f.write(text)
        return fn(path)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
