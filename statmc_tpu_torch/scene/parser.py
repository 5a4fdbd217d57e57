# Copied from statmc_tpu/scene/parser.py (numpy host code; imports rewritten, behaviour unchanged).
"""pbrt-v3 scene-description parser.

Covers the directive subset used by the reference's scenes/ tree plus the
StatMC extensions: the pbrt-v4-style `Include`
(src/core/parser.cpp:935-940) and the `ExtraParams`
top-level directive (src/core/parser.cpp:918-919, src/core/api.cpp:1433-1441)
that lets a scene override integrator parameters supplied by an included
config.

This is a clean-room Python tokenizer + recursive include expansion; the
graphics-state machine lives in scene/api.py.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Iterator

from .params import ParamSet

_TOKEN_RE = re.compile(
    r"""
    "(?P<str>[^"]*)"          # quoted string
  | \[(?P<lb>)                # left bracket
  | \](?P<rb>)                # right bracket
  | (?P<comment>\#[^\n]*)     # comment
  | (?P<atom>[^\s"\[\]]+)     # bare atom (directive, number, bool)
    """,
    re.VERBOSE,
)

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


@dataclass
class Token:
    kind: str  # 'str' | 'lb' | 'rb' | 'atom'
    value: str
    filename: str = ""
    line: int = 0


def tokenize(text: str, filename: str = "<string>") -> Iterator[Token]:
    line = 1
    pos = 0
    for m in _TOKEN_RE.finditer(text):
        line += text.count("\n", pos, m.start())
        pos = m.start()
        if m.lastgroup == "comment":
            continue
        if m.lastgroup == "str":
            yield Token("str", m.group("str"), filename, line)
        elif m.lastgroup == "atom":
            yield Token("atom", m.group("atom"), filename, line)
        elif m.lastgroup == "lb":
            yield Token("lb", "[", filename, line)
        elif m.lastgroup == "rb":
            yield Token("rb", "]", filename, line)


def _coerce(tok: Token):
    if tok.kind == "str":
        return tok.value
    v = tok.value
    if _NUM_RE.match(v):
        f = float(v)
        return f
    if v == "true":
        return True
    if v == "false":
        return False
    return v


class TokenStream:
    """Token stream with recursive Include expansion."""

    def __init__(self, path: str):
        self._stack: list[Iterator[Token]] = []
        self._push_file(path)

    def _push_file(self, path: str) -> None:
        with open(path, "r") as f:
            text = f.read()
        self._stack.append(tokenize(text, path))
        self._dirs = getattr(self, "_dirs", [])
        self._dirs.append(os.path.dirname(os.path.abspath(path)))

    def __iter__(self):
        return self

    def __next__(self) -> Token:
        while self._stack:
            try:
                tok = next(self._stack[-1])
            except StopIteration:
                self._stack.pop()
                self._dirs.pop()
                continue
            if tok.kind == "atom" and tok.value == "Include":
                inc = next(self._stack[-1])
                if inc.kind != "str":
                    raise SyntaxError(
                        f"{tok.filename}:{tok.line}: Include expects a string"
                    )
                path = inc.value
                if not os.path.isabs(path):
                    path = os.path.join(self._dirs[-1], path)
                self._push_file(path)
                continue
            return tok
        raise StopIteration

    @property
    def current_dir(self) -> str:
        return self._dirs[-1] if self._dirs else "."


# Directives that take (name: str, params: ParamSet).
_NAMED_PARAM_DIRECTIVES = {
    "Integrator", "Sampler", "PixelFilter", "Film", "Camera", "Shape",
    "Material", "AreaLightSource", "LightSource", "Accelerator",
    "NamedMaterial", "MakeNamedMaterial", "MakeNamedMedium", "ExtraParams",
    "ObjectBegin", "ObjectInstance", "CoordinateSystem", "CoordSysTransform",
}
# Directives that take N bare floats.
_FLOAT_ARG_DIRECTIVES = {
    "Translate": 3, "Scale": 3, "Rotate": 4, "LookAt": 9,
    "Transform": 16, "ConcatTransform": 16,
}
_NO_ARG_DIRECTIVES = {
    "WorldBegin", "WorldEnd", "AttributeBegin", "AttributeEnd",
    "TransformBegin", "TransformEnd", "ObjectEnd", "ReverseOrientation",
    "Identity",
}


@dataclass
class Statement:
    directive: str
    name: str | None = None
    params: ParamSet | None = None
    floats: list | None = None
    extra_names: list = field(default_factory=list)
    cwd: str = "."


def parse_statements(path: str) -> Iterator[Statement]:
    """Yield parsed top-level statements from a .pbrt file (with includes)."""
    stream = TokenStream(path)
    it = iter(stream)
    pending: Token | None = None

    def nxt() -> Token | None:
        nonlocal pending
        if pending is not None:
            t, pending = pending, None
            return t
        try:
            return next(it)
        except StopIteration:
            return None

    def peek() -> Token | None:
        nonlocal pending
        if pending is None:
            try:
                pending = next(it)
            except StopIteration:
                return None
        return pending

    while True:
        tok = nxt()
        if tok is None:
            return
        if tok.kind != "atom":
            raise SyntaxError(
                f"{tok.filename}:{tok.line}: expected directive, got {tok.value!r}"
            )
        d = tok.value
        cwd = stream.current_dir
        if d in _NO_ARG_DIRECTIVES:
            yield Statement(d, cwd=cwd)
        elif d in _FLOAT_ARG_DIRECTIVES:
            n = _FLOAT_ARG_DIRECTIVES[d]
            vals = []
            while len(vals) < n:
                t = nxt()
                if t is None:
                    raise SyntaxError(f"EOF inside {d}")
                if t.kind in ("lb", "rb"):
                    continue
                vals.append(float(t.value))
            t = peek()
            if t is not None and t.kind == "rb":
                nxt()  # consume closing bracket of e.g. Transform [ ... ]
            yield Statement(d, floats=vals, cwd=cwd)
        elif d in _NAMED_PARAM_DIRECTIVES or d in (
            "Texture", "MediumInterface",
        ):
            # Gather leading quoted names (parameter declarations always
            # contain a space: "type name" — bare names never do).
            names = []
            while True:
                t = peek()
                if t is not None and t.kind == "str" and " " not in t.value.strip():
                    names.append(nxt().value)
                else:
                    break
            # Texture has 3 names (name, type, class); MediumInterface 1-2.
            ps = ParamSet()
            # Parse "type name" [values] groups.
            while True:
                t = peek()
                if t is None or t.kind != "str":
                    break
                decl = nxt().value
                if " " not in decl.strip():
                    # Not a parameter declaration: belongs to next directive.
                    names.append(decl)
                    continue
                values = []
                t = peek()
                if t is not None and t.kind == "lb":
                    nxt()
                    while True:
                        t = nxt()
                        if t is None:
                            raise SyntaxError("EOF inside parameter list")
                        if t.kind == "rb":
                            break
                        values.append(_coerce(t))
                else:
                    t = nxt()
                    if t is None:
                        raise SyntaxError("EOF after declaration")
                    values.append(_coerce(t))
                ps.add(decl, values)
            yield Statement(
                d,
                name=names[0] if names else None,
                params=ps,
                extra_names=names[1:],
                cwd=cwd,
            )
        else:
            raise SyntaxError(
                f"{tok.filename}:{tok.line}: unknown directive {d!r}"
            )
