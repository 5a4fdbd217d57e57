# Copied from statmc_tpu/scene/params.py (numpy host code; imports rewritten, behaviour unchanged).
"""Typed parameter dictionaries (the reference's ParamSet,
src/core/paramset.{h,cpp}, reduced to a dict wrapper).

Declarations look like `"float filtersd" [10]` in scene files; we store
them as {name: (type, values)} and provide the same find-one/find-array
lookups the reference integrator-construction code uses.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

_SPECTRUM_TYPES = {"rgb", "color", "spectrum", "xyz", "blackbody"}


class ParamSet:
    def __init__(self) -> None:
        self._items: dict[str, tuple[str, list]] = {}

    def add(self, decl: str, values: Sequence) -> None:
        parts = decl.split()
        if len(parts) != 2:
            raise ValueError(f"bad parameter declaration {decl!r}")
        ptype, name = parts
        self._items[name] = (ptype, list(values))

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def type_of(self, name: str) -> str | None:
        item = self._items.get(name)
        return item[0] if item else None

    def find(self, name: str, default=None):
        item = self._items.get(name)
        return item[1] if item else default

    def find_one(self, name: str, default: Any = None):
        item = self._items.get(name)
        if not item or not item[1]:
            return default
        ptype, vals = item
        if ptype == "bool":
            v = vals[0]
            return v in (True, "true") if isinstance(v, (bool, str)) else bool(v)
        if ptype in _SPECTRUM_TYPES or ptype in ("point", "vector", "normal",
                                                 "point3", "vector3", "point2"):
            k = 2 if ptype == "point2" else 3
            return np.asarray(vals[:k], dtype=np.float32)
        if ptype == "integer":
            return int(vals[0])
        if ptype == "float":
            return float(vals[0])
        return vals[0]

    def find_floats(self, name: str, default=None):
        item = self._items.get(name)
        if not item:
            return default
        return np.asarray(item[1], dtype=np.float32)

    def find_ints(self, name: str, default=None):
        item = self._items.get(name)
        if not item:
            return default
        return np.asarray(item[1], dtype=np.int32)

    def find_strings(self, name: str, default=None):
        item = self._items.get(name)
        if not item:
            return default if default is not None else []
        return [str(v) for v in item[1]]

    def find_spectrum(self, name: str, default=None):
        """Returns a 3-vector RGB or None. blackbody/spd files unsupported -> rgb."""
        item = self._items.get(name)
        if not item:
            return default
        ptype, vals = item
        if ptype in _SPECTRUM_TYPES:
            if ptype == "blackbody":
                # [temperature, scale]: approximate via normalized Planck RGB.
                return _blackbody_rgb(float(vals[0])) * (
                    float(vals[1]) if len(vals) > 1 else 1.0
                )
            return np.asarray(vals[:3], dtype=np.float32)
        if ptype == "float":
            return np.full(3, float(vals[0]), dtype=np.float32)
        return default

    def keys(self):
        return self._items.keys()

    def items(self):
        return self._items.items()

    def __repr__(self) -> str:
        return f"ParamSet({self._items})"


def _blackbody_rgb(temp_k: float) -> np.ndarray:
    """Very small Planckian-locus RGB approximation, normalized to max 1."""
    # Sample Planck's law at the CIE primaries' dominant wavelengths.
    wl = np.array([610.0, 549.0, 468.0]) * 1e-9
    h, c, kb = 6.62607e-34, 2.998e8, 1.38065e-23
    le = (2 * h * c * c) / (wl**5 * (np.exp(h * c / (wl * kb * temp_k)) - 1.0))
    le = le / le.max()
    return le.astype(np.float32)
