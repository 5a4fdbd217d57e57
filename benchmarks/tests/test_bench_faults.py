"""The comparison has to fail: the control (the reference in bfloat16 in
the program's place) and faults planted in the timed path, each on a CPU
run of the harness at small frames (the look for a card skipped): a state
returned unchanged, half the lanes left out, a hit, a moment or the
filter's output altered, and in the integrator a radiance increment or a
recorded sample altered, a lobe dropped and a draw shifted."""
import pytest
import torch
from conftest import SMALL

from statbench import cells, judge

SEED = 2147483999


def _run(cell, plant=None, monkeypatch=None):
    c = cells.find(cell)
    if plant is not None:
        plant(monkeypatch)
    lp = cells.loop_class(c)(c, SEED, torch.device("cpu"), SMALL)
    lp.warm_up()
    lp.window(0.05)
    lp.release()
    return lp


# -- render cells: the staircase's job, with its denoise -------------------

def _unchanged(mp):
    from statmc_tpu_torch.stats import estimator as E

    mp.setattr(E, "update_states", lambda states, cfg, out, mask=None:
               states)


def _half(mp):
    from statmc_tpu_torch.stats import estimator as E

    upd = E.update_states

    def half(states, cfg, out, mask=None):
        keep = torch.arange(out.ls.shape[0]) % 2 == 0
        return upd(states, cfg, out, keep if mask is None else mask & keep)

    mp.setattr(E, "update_states", half)


def _hit_altered(mp):
    from statmc_tpu_torch.render import integrator as INT

    isect = INT.intersect_scene

    def altered(*a, **kw):
        hit = isect(*a, **kw)
        return hit._replace(t=hit.t * 1.01)

    mp.setattr(INT, "intersect_scene", altered)


def _moment_altered(mp):
    from statmc_tpu_torch.stats import estimator as E

    upd = E.update_states

    def altered(states, cfg, out, mask=None):
        new = upd(states, cfg, out, mask)
        rad = dict(new[E.RADIANCE])
        rad["m2"] = rad["m2"] * 1.01
        new = dict(new)
        new[E.RADIANCE] = rad
        return new

    mp.setattr(E, "update_states", altered)


def _filter_altered(mp):
    from statmc_tpu_torch.denoise.filter import StatDenoiser

    call = StatDenoiser.__call__

    def altered(self, *a, **kw):
        res = call(self, *a, **kw)
        return dict(res, film_mean_f=res["film_mean_f"] * 1.01,
                    film_f=res["film_f"] * 1.01)

    mp.setattr(StatDenoiser, "__call__", altered)


def _radiance_altered(mp):
    """Every bounce's radiance increment 1% high where it is produced."""
    from statmc_tpu_torch.render import integrator as INT

    step = INT._bounce_step

    def altered(scene, bvh, dist, cfg, carry, *a, **kw):
        new = step(scene, bvh, dist, cfg, carry, *a, **kw)
        return dict(new, ls=carry["ls"] + (new["ls"] - carry["ls"]) * 1.01)

    mp.setattr(INT, "_bounce_step", altered)


def _recorded_altered(mp):
    """Each sample's radiance 1% high between its last bounce and the
    moment streams."""
    from statmc_tpu_torch.render import integrator as INT

    out_fn = INT._carry_output

    def altered(cfg, carry):
        out = out_fn(cfg, carry)
        return out._replace(ls=out.ls * 1.01)

    mp.setattr(INT, "_carry_output", altered)


def _lobe_dropped(mp):
    """The substrate's glossy lobe gone (its Schlick term 0)."""
    from statmc_tpu_torch.render import bsdf as B

    mp.setattr(B, "schlick_fresnel", lambda rs, cos_t: rs * 0.0)


def _draw_shifted(mp):
    """Every 2-D draw read at the next step's draw site."""
    from statmc_tpu_torch.core import rng as crng

    draw = crng.draw_2d
    mp.setattr(crng, "draw_2d", lambda keys, ld, mode, bounce, slot:
               draw(keys, ld, mode, bounce + 1, slot))


@pytest.fixture(scope="module")
def render_run():
    return _run("staircase-render-denoise")


def test_render_sound_and_control(render_run):
    assert judge.correct(render_run.check())
    numbers = dict((n, v) for n, v, _ in render_run.check(control=True))
    assert not judge.correct(render_run.check(control=True)), numbers


@pytest.mark.parametrize("plant", [_unchanged, _half, _hit_altered,
                                   _moment_altered, _filter_altered])
def test_render_fault_is_caught(plant, monkeypatch):
    lp = _run("staircase-render-denoise", plant, monkeypatch)
    assert not judge.correct(lp.check())


@pytest.mark.parametrize("plant", [_radiance_altered, _recorded_altered,
                                   _lobe_dropped, _draw_shifted])
def test_radiance_fault_fails_the_path_replay(plant, monkeypatch):
    lp = _run("staircase-render-denoise", plant, monkeypatch)
    numbers = lp.check()
    assert not judge.correct(numbers)
    (share, limit), = [(v, lim) for n, v, lim in numbers
                       if n == "path_mismatch_share"]
    assert share > limit


# -- the denoise cell ------------------------------------------------------

def _wrap_denoiser(mp, change):
    from statmc_tpu_torch.denoise.filter import StatDenoiser

    call = StatDenoiser.__call__

    def planted(self, state, film, gbufs, halo=None):
        return change(call(self, state, film, gbufs, halo), state)

    mp.setattr(StatDenoiser, "__call__", planted)


def _d_unchanged(mp):
    _wrap_denoiser(mp, lambda res, st: dict(
        res, film_mean_f=st["film_mean"], mean_corr=st["mean"]))


def _d_half(mp):
    def half(res, st):
        f = res["film_mean_f"].clone()
        f[:, 1::2] = st["film_mean"][:, 1::2]
        return dict(res, film_mean_f=f)

    _wrap_denoiser(mp, half)


def _d_altered(mp):
    _wrap_denoiser(mp, lambda res, st: dict(
        res, film_mean_f=res["film_mean_f"] * 1.01))


def test_denoise_sound_and_control():
    lp = _run("staircase-denoise-frames")
    assert judge.correct(lp.check())
    assert not judge.correct(lp.check(control=True))


@pytest.mark.parametrize("plant", [_d_unchanged, _d_half, _d_altered])
def test_denoise_fault_is_caught(plant, monkeypatch):
    lp = _run("staircase-denoise-frames", plant, monkeypatch)
    assert not judge.correct(lp.check())
