"""The bounce step's CUDA graphs (render/bounce_graphs.py) on the CPU.

On the card a step replays graphs of its own tensor code, cut at its
three scene queries; the graphs cannot be made here, so these tests hold
what decides them and what they rely on:

- the rule that picks graphs or the eager step (eager_reason), one case
  a kind of scene or configuration;
- that the step's segments (integrator._step_ops between its queries)
  run no host synchronisation and copy no host data to the device once
  its constants exist (a dispatch mode watches every op: a CUDA graph
  holds neither), and that the inputs the graphs take (static copies,
  the per-sample driver's int step and LD sample index as device
  tensors) leave every lane's results bit for bit as the eager step's.

The card's tests (tests/test_torch_gpu.py, marked gpu) hold the replayed
step against the eager step bit for bit.  The file imports torch and
the port only.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.core import rng as crng
from statmc_tpu_torch.render import bounce_graphs as BG
from statmc_tpu_torch.render import camera as CAM
from statmc_tpu_torch.render import integrator as INT

W, H = 8, 6
CARD = torch.device("cuda")


def _fourier_text(tmp_path):
    TS.fourier_assets(str(tmp_path), seed=0)
    mats = [TS._FOURIER.format(tmp_path / n) for n in TS.FOURIER_FILES]
    body = TS.staircase_proxy(clutter_mats=[mats[0], None, None, None])
    body += TS._sss_spheres([(mats[1], (4.0, 0.9, -2.8, 0.9))])
    return TS.scene_text(width=W, height=H, spp=1, iterations=1, maxdepth=3,
                         filterradius=2, body=body)


def _hair_text(tmp_path):
    body = TS.staircase_proxy() + TS.hair_tuft(32, (2.6, -3.4), 0.7, 4.4,
                                               1.4, seed=0)
    return TS.scene_text(width=W, height=H, spp=1, iterations=1, maxdepth=3,
                         filterradius=2, body=body)


SCENES = {
    "staircase": lambda d: TS.scene_text(width=W, height=H, spp=1,
                                         iterations=1, maxdepth=3,
                                         filterradius=2),
    "halton": lambda d: TS.scene_text(
        width=W, height=H, spp=1, iterations=1, maxdepth=3,
        filterradius=2).replace('Sampler "random"', 'Sampler "halton"'),
    # n = 96: 19,554 triangles, past the fused cap: the two-level path.
    "terrain": lambda d: TS.terrain_scene_text(width=W, height=H, spp=1,
                                               maxdepth=3, n=96),
    "kdtree": lambda d: TS.kdtree_scene_text(width=W, height=H, spp=1,
                                             iterations=1, maxdepth=3,
                                             filterradius=2),
    "textured": lambda d: TS.textured_scene_text(str(d), width=W, height=H,
                                                 spp=1),
    "hair": _hair_text,
    "sss": lambda d: TS.hair_sss_scene_text(width=W, height=H, spp=1,
                                            iterations=1, maxdepth=3,
                                            curves=8, filterradius=2),
    "fourier": _fourier_text,
    "volpath": lambda d: TS.volpath_scene_text(str(d), width=W, height=H,
                                               spp=1, maxdepth=3, grid=8,
                                               filterradius=2),
}


def setup(tmp_path, scene: str, device="cpu"):
    """The RenderSetup of a small scene of SCENES on `device`."""
    from statmc_tpu_torch.driver import load

    path = tmp_path / "s.pbrt"
    path.write_text(SCENES[scene](tmp_path))
    return load(str(path), device=device).s


def feedback_config(cfg):
    """cfg with ACRR and SMIS on, so that feedback_on and the feedback
    buffers change the step."""
    n = cfg.max_depth + 1
    return cfg._replace(enable_acrr=True, enable_smis=True, n_ls=n, nb_mis=n)


def step_inputs(s, cfg, sample: int = 0, seed: int = 7):
    """A first bounce's carry from the camera, the lanes' keys, feedback
    buffers drawn from `seed` and the LD stream (sample index an int, as
    the per-sample driver passes it): (carry, keys, avg_ls, win_bsdf,
    win_light, ld)."""
    P, dev = s.width * s.height, s.device
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    base = crng.base_key(seed, dev)
    keys = crng.pixel_keys(base, ids, sample)
    ld = (None if cfg.sampler_mode == crng.MODE_RANDOM
          else (crng.pixel_scramble(base, ids), sample))
    u = crng.draw_2d(keys, ld, cfg.sampler_mode, 0, crng.SLOT_CAMERA)
    pxy = torch.stack([(ids % s.width).to(torch.float32),
                       (ids // s.width).to(torch.float32)], -1)
    o, d = CAM.generate_rays(s.cam, pxy + u)
    NL, NB = cfg.n_ls, max(cfg.nb_mis, 1)
    carry = dict(o=o, d=d, **INT._zero_path_carry(P, NL, NB, dev))
    g = torch.Generator().manual_seed(seed)
    avg = (0.5 + torch.rand((P, NL), generator=g)).to(dev)
    # Window rates about SMIS's 1e-3 threshold, so that it disables some.
    wb = (2e-3 * torch.rand((P, NB), generator=g)).to(dev)
    wl = (2e-3 * torch.rand((P, NB), generator=g)).to(dev)
    return carry, keys, avg, wb, wl, ld


def same(a, b) -> bool:
    """Bit for bit, for nests of dicts, tuples and tensors."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(same, a, b))
    if a is None or b is None:
        return a is b
    if a.dtype.is_floating_point:
        bits = torch.int32 if a.dtype == torch.float32 else torch.int64
        a, b = a.view(bits), b.view(bits)
    return a.shape == b.shape and torch.equal(a, b)


class _HostTraffic(TorchDispatchMode):
    """Records the ops a CUDA graph cannot hold: a read back to the host
    (item, bool, nonzero, boolean indexing, ...) and a tensor made from
    host data (torch.tensor, as_tensor of a number or an array)."""

    NAMES = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero",
             "aten.masked_select", "aten.masked_scatter", "aten.unique",
             "aten._unique", "aten.repeat_interleave")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.NAMES):
            self.seen.append(name)
        elif name.startswith(("aten.index.", "aten.index_put")) and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            self.seen.append(name + " (boolean)")
        return func(*args, **(kwargs or {}))


def _query(s):
    def query(req):
        kind, o, d, t_max, kw = req
        if kind == "occluded":
            return INT.occluded_scene(s.scene, o, d, t_max, s.bvh)
        return INT.intersect_scene(s.scene, o, d, t_max, s.bvh, **kw)
    return query


def _graph_input_step(s, cfg, x, feedback_on, watch):
    """The step as the graphs run it: on static copies of its inputs
    (with _as_tensors' conversions), each segment under `watch`."""
    x = BG._as_tensors(x)
    x = BG._rebuild(x, (t.clone() for t in BG._tensors(x)))
    gen = INT._step_ops(s.scene, s.bvh, s.dist, cfg, x["carry"], x["step"],
                        x["keys"], x["avg_ls"], x["win_bsdf"],
                        x["win_light"], feedback_on, s.albedo_luts, x["ld"])
    query, answer = _query(s), None
    while True:
        with watch:
            done, y = BG._advance(gen, answer)
        if done:
            return y
        ans = query(y)
        answer = BG._rebuild(ans, (t.clone() for t in BG._tensors(ans)))


EAGER = {"sss": "subsurface scattering", "fourier": "Fourier tables",
         "volpath": "volpath with media",
         "exact": "exact lockstep replay", "cpu": "CPU tensors"}


@pytest.mark.parametrize("case", ["staircase", "terrain", "kdtree", "sss",
                                  "fourier", "exact", "volpath", "cpu"])
def test_graph_or_eager_rule(case, tmp_path):
    """eager_reason on small scenes loaded on the CPU, asked for the
    card: the staircase, the terrain (two-level) and the kd-tree scene
    replay graphs; subsurface and Fourier scenes, the exact lockstep
    replay's configuration, volpath with media and CPU tensors stay
    eager.  No flag, variable or scene name enters the rule."""
    scene = {"exact": "staircase", "cpu": "staircase"}.get(case, case)
    s = setup(tmp_path, scene)
    cfg = s.icfg
    if case == "exact":
        cfg = cfg._replace(sampler_mode=crng.MODE_LOCKSTEP_EXACT)
    dev = torch.device("cpu") if case == "cpu" else CARD
    assert BG.eager_reason(s.scene, cfg, None, dev) == EAGER.get(case)
    if case == "volpath":
        assert cfg.volumetric and s.scene.fourier is not None


@pytest.mark.parametrize("scene,driver,feedback_on", [
    ("staircase", "wavefront", True),
    ("staircase", "trace", False),
    ("halton", "trace", False),
    ("terrain", "wavefront", False),
    ("kdtree", "trace", True),
    ("textured", "wavefront", False),
    ("hair", "wavefront", False),
])
def test_segments_hold_no_host_traffic(scene, driver, feedback_on,
                                       tmp_path):
    """Every step of a sample on the CPU, eager (_bounce_step) and as the
    graphs run it (static copies of the inputs; the per-sample driver's
    int step and LD sample index as device tensors): bit for bit the
    same carry, and once a step has made the cached constants, no
    segment reads back to the host or makes a tensor from host data."""
    s = setup(tmp_path, scene)
    cfg = feedback_config(s.icfg) if feedback_on else s.icfg
    assert BG.eager_reason(s.scene, cfg, None, CARD) is None
    carry, keys, avg, wb, wl, ld = step_inputs(s, cfg)
    P = carry["o"].shape[0]
    watch = _HostTraffic()
    for k in range(cfg.max_depth + 1):
        step = (k if driver == "trace"
                else torch.full((P,), k, dtype=torch.int32))
        x = dict(carry=carry, step=step, keys=keys, avg_ls=avg,
                 win_bsdf=wb, win_light=wl, ld=ld)
        eager = INT._bounce_step(s.scene, s.bvh, s.dist, cfg, carry, step,
                                 keys, avg, wb, wl, feedback_on,
                                 s.albedo_luts, ld)
        assert same(_graph_input_step(s, cfg, x, feedback_on, watch), eager)
        carry = eager
    assert watch.seen == []
    assert bool(torch.any(carry["path_len"] > 1))


@pytest.mark.parametrize("counters,share", [
    ({"graph.bounce.replay": 30, "graph.bounce.eager": 10}, 75.0),
    ({"graph.bounce.replay": 12, "graph.bounce.capture": 4}, 100.0),
    ({"kernel.R1": 5}, None),
])
def test_graph_share_reader(counters, share):
    """benchmarks/metrics/bounce_graph_share.render.py on the program's
    counters: replayed steps over the steps run on the card; nothing
    where the program has no graph counters (the parent's)."""
    import importlib.util
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(
        "bounce_graph_share", os.path.join(bench, "metrics",
                                           "bounce_graph_share.render.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    snap = {"spans": [{"name": "iteration"}], "counters": counters}
    assert reader.read({"program_spans": snap}) == share
    assert reader.read({"program_spans": None}) is None
