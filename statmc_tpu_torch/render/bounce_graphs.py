"""CUDA graphs of the bounce step (render/integrator.py:_bounce_step).

Launched op by op, a bounce step's own tensor code is some 3,100 small
kernels a step, and the host that launches them sets the pace while the
card waits.  That code (integrator._step_ops) runs straight through
between the step's three scene queries, so on the card it runs as four
CUDA graphs, cut at the queries: up to the closest hit (t_max of the
live lanes); emitted light, materials, frame, G-buffer and the NEE
light sample, up to the shadow ray; the light half and the BSDF-NEE
sample, up to the BSDF-MIS ray; the BSDF-MIS half, selective MIS, the
continuation, Russian roulette and the new carry.  The queries run
eagerly between the graphs, through integrator's ``intersect_scene`` and
``occluded_scene``, so the intersection kernels, their counters and
whatever wraps those names see every call with the same arguments.

A key's first step runs each segment once op by op on a twin of the
step (which makes every cached constant, core/math.py:const, and builds
kernel R1 before anything records), captures it, and replays it; every
later step copies its inputs and each query's answer into the graphs'
buffers and replays.  The key: the integrator configuration, the
feedback flag where the configuration reads it, the identity of the
scene, the light distribution and the albedo curves (the graphs read
their tables in place; the cache holds them), and the names, shapes,
dtypes and device of the step's tensors.  A replay runs the same kernels
on the same inputs as the eager step, so each lane's results are the
same bit for bit.

Counters (spans.py, host, always on): ``graph.bounce.capture`` (segments
captured), ``graph.bounce.replay`` (steps replayed) and
``graph.bounce.eager`` (steps run op by op on the card); ``kernel.R1``
counts each draw a replay launches, as the eager step's launches count.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import spans
from ..core import rng as crng
from ..scene import build as sb

# Keys whose graphs stay cached, the most recent last.
MAX_KEYS = 4
_CACHE: OrderedDict = OrderedDict()


def eager_reason(scene, cfg, ld_stream, device) -> str | None:
    """Why a bounce step on `device` runs op by op, or None when it
    replays graphs.  A graph can hold no host synchronisation, no shape
    that varies from step to step and no copy of host data, so these
    steps stay eager:

    - CPU tensors;
    - subsurface scenes: the SSS block gathers its firing lanes
      (integrator._firing_lanes: nonzero) and runs its own probe
      queries;
    - Fourier tables: bsdf._fourier_lanes gathers the Fourier lanes
      (nonzero);
    - the exact lockstep replay and the lockstep table: their draws are
      gathered from streams or table rows that are inputs of every step
      ([P, S, D] rows for the table), dearer to copy in than to launch
      around;
    - volpath with media: its bounce loop (render/volume.py) is its own.

    Every other step replays: the random and LD samplers, fused,
    two-level and kd-tree scenes, textures and hair."""
    if device.type != "cuda":
        return "CPU tensors"
    if cfg.volumetric:
        return "volpath with media"
    if cfg.enable_sss and scene.sss is not None:
        return "subsurface scattering"
    if scene.fourier is not None and (cfg.mat_types is None
                                      or sb.MAT_FOURIER in cfg.mat_types):
        return "Fourier tables"
    if cfg.sampler_mode == crng.MODE_LOCKSTEP_EXACT:
        return "exact lockstep replay"
    if cfg.sampler_mode == crng.MODE_LOCKSTEP and ld_stream is not None:
        return "lockstep table"
    return None


def drive(gen, query):
    """Runs a step generator op by op, answering each query it yields
    with query(request); returns the step's result."""
    answer = None
    while True:
        done, x = _advance(gen, answer)
        if done:
            return x
        answer = query(x)


def replay_step(body, inputs: dict, config_key, pins: tuple, query):
    """One bounce step from the graphs of its key, captured first if the
    key is new.  body(inputs) makes the step's generator; `inputs` holds
    every tensor that changes from step to step (an int step or sample
    index becomes a device tensor here); `pins` are the objects whose
    tensors the graphs read in place."""
    inputs = _as_tensors(inputs)
    key = (config_key, tuple(id(p) for p in pins), _spec(inputs))
    graphs = _CACHE.get(key)
    # A graph records and replays on the current device: make it the
    # step's, which need not be (a renderer loaded on "cuda:1").
    with torch.cuda.device(inputs["carry"]["o"].device):
        if graphs is None:
            graphs = _Graphs(pins)
            out = graphs.capture(body, inputs, query)
            _CACHE[key] = graphs
            while len(_CACHE) > MAX_KEYS:
                _CACHE.popitem(last=False)
        else:
            _CACHE.move_to_end(key)
            out = graphs.replay(inputs, query)
    spans.count("graph.bounce.replay", 1)
    return out


def clear():
    """Drops every cached graph."""
    _CACHE.clear()


class _Graphs:
    """The graphs of one key: the static inputs, each segment's graph,
    the query it ends in (tensors its graph writes), the buffers of each
    query's answer, the carry the last segment writes and the R1
    launches each segment holds."""

    def __init__(self, pins: tuple):
        self.pins = pins
        self.pool = torch.cuda.graph_pool_handle()
        self.inputs, self.graphs, self.r1 = [], [], []
        self.requests, self.answers = [], []
        self.out = None

    def capture(self, body, inputs, query):
        self.inputs = [t.clone() for t in _tensors(inputs)]
        static = _rebuild(inputs, iter(self.inputs))
        twin, gen = body(static), body(static)
        answer = None
        while True:
            _advance(twin, answer)  # op by op: the warm-up
            graph = torch.cuda.CUDAGraph()
            r1 = spans.counted("kernel.R1")
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                done, x = _advance(gen, answer)
            # The draws were recorded, not launched: replays count them.
            r1 = spans.counted("kernel.R1") - r1
            spans.count("kernel.R1", -r1)
            spans.count("graph.bounce.capture", 1)
            self.graphs.append(graph)
            self.r1.append(r1)
            graph.replay()
            spans.count("kernel.R1", r1)
            if done:
                self.out = x
                return _clone(x)
            self.requests.append(x)
            ans = query(x)
            self.answers.append([t.clone() for t in _tensors(ans)])
            answer = _rebuild(ans, iter(self.answers[-1]))

    def replay(self, inputs, query):
        torch._foreach_copy_(self.inputs, _tensors(inputs))
        for k, graph in enumerate(self.graphs):
            if k:
                torch._foreach_copy_(self.answers[k - 1], _tensors(
                    query(self.requests[k - 1])))
            graph.replay()
            spans.count("kernel.R1", self.r1[k])
        return _clone(self.out)


def _advance(gen, value):
    """(True, result) once the generator returns, else (False, the next
    value it yields), after sending it `value`."""
    try:
        return False, gen.send(value)
    except StopIteration as stop:
        return True, stop.value


def _as_tensors(inputs: dict) -> dict:
    """The int step and the int sample index of an LD stream (the
    per-sample driver's) as 0-d int64 tensors on the carry's device."""
    dev = inputs["carry"]["o"].device

    def t(x):
        if torch.is_tensor(x):
            return x
        return torch.full((), int(x), dtype=torch.int64, device=dev)

    out = dict(inputs, step=t(inputs["step"]))
    if out["ld"] is not None:
        out["ld"] = (out["ld"][0], t(out["ld"][1]))
    return out


def _spec(x):
    """A hashable description of a nest of dicts, tuples, None and
    tensors: its names and each tensor's shape, dtype and device."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return tuple((k, _spec(x[k])) for k in sorted(x))
    if isinstance(x, tuple):
        return (type(x),) + tuple(_spec(v) for v in x)
    raise TypeError(f"a bounce step input of type {type(x).__name__}")


def _tensors(x) -> list:
    """The tensors of a nest, in _spec's order (dicts by sorted name)."""
    if x is None:
        return []
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    return [t for v in x for t in _tensors(v)]


def _rebuild(x, it):
    """The nest `x` with its tensors taken in turn from `it`."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return next(it)
    if isinstance(x, dict):
        vals = {k: _rebuild(x[k], it) for k in sorted(x)}
        return {k: vals[k] for k in x}
    vals = [_rebuild(v, it) for v in x]
    return type(x)._make(vals) if hasattr(x, "_fields") else tuple(vals)


def _clone(x):
    return _rebuild(x, (t.clone() for t in _tensors(x)))
