"""Command-line tools of the port (port of statmc_tpu/tools): the
albedo-LUT precompute, bsdftest, imgtool, obj2pbrt and cyhair2pbrt.
Each runs as ``python -m statmc_tpu_torch.tools.<name>``; the two that
compute on tensors run on the card unless given ``--device cpu``."""
from __future__ import annotations

import sys

import torch


def device(prog: str, name: str):
    """torch.device(name), or None after a message on stderr when CUDA is
    asked for and torch finds no CUDA device: the tools never fall back
    to the CPU on their own."""
    if name == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device; pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return None
    return torch.device(name)
