"""The exact lockstep replay of mirrorbox.pbrt, fourtile.pbrt and
tracked.pbrt against the C++ reference's own PFMs
(tests/fixtures/refparity/), at tests/test_refparity.py's tolerances; a
file of its own because the three replays take over a minute on the CPU
(test_torch_lockstep.py holds the other two scenes)."""
import torch

from test_torch_lockstep import check_reference

torch.set_num_threads(2)


def test_refparity_mirrorbox_rr():
    """Deep specular chains where the conditional Russian-roulette draw
    (statpath.cpp:941-948) fires and shifts every later draw of its
    tile."""
    rep = check_reference("mirrorbox", 7, film_tol=2e-5, mom_tol=5e-5)
    consumed = rep.cursor_end - rep.cursor_start
    assert consumed.max() > consumed.min()  # RR mixed the outcomes


def test_refparity_fourtile_multitile():
    """32x32, four 16x16 tiles: per-tile seeding (baseSeed+1)*(tile+1)
    (src/samplers/random.cpp:52-68), matte and mirror consumption."""
    check_reference("fourtile", 11, film_tol=5e-5, mom_tol=2e-4, WH=32)


def test_refparity_tracked_bounces():
    """trackedbounces 3 with acrr: the per-bounce streams t0-b1 and t0-b2
    match the reference's buffers too."""
    rep = check_reference("tracked", 5, film_tol=2e-4, mom_tol=5e-4,
                          tracked=3)
    assert rep.radiance_b.shape[2] == 3
