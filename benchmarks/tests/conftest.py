"""The harness's CPU tests: run from the repository's root,
``python -m pytest benchmarks/tests -q``; tests marked gpu skip without a
card (run them on the card with ``-m gpu``)."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

# Small frames for runs on the CPU, where the port runs its kernels' plain
# PyTorch versions.
SMALL = {"film": {"integer xresolution": [16], "integer yresolution": [12]},
         "integrator": {"integer filterradius": [3]}}
