"""The port's command line and the reference's workflow around it, against
the JAX package: ``python -m statmc_tpu_torch`` (its file set and output
lines), --denoise from disk (tests/test_driver.py:64-81's tolerance,
rtol 1e-4 / atol 1e-5), PFMs that one package wrote filtered by the
other, checkpoints (tests/test_checkpoint.py in torch: a resumed render
equals an uninterrupted one bit for bit), a render resumed from the JAX
package's state (convert.renderer_state), the statistics block, and the
refusals without a card (--mesh itself: test_torch_mesh_cli.py).
Renders run on the CPU (--device cpu)."""
import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

import statmc_tpu.__main__ as JM
import statmc_tpu.driver as JD
import statmc_tpu_torch.__main__ as TM
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch.io.pfm import read_pfm
from statmc_tpu_torch.testscenes import scene_text

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _world(width=16, height=12):
    """The staircase proxy's Film, camera and world lines."""
    text = scene_text(width=width, height=height, spp=2, iterations=1,
                      maxdepth=3)
    return text[text.index("Film "):]


def _config_block(name, **subst):
    """The Integrator and Sampler blocks of configs/<name>.pbrt, with
    parameters cut to a test's size (maxdepth, iterations, radius)."""
    with open(os.path.join(REPO, "configs", f"{name}.pbrt")) as f:
        text = f.read()
    for key, (old, new) in subst.items():
        assert old in text, key
        text = text.replace(old, new)
    return text


CUTS = dict(maxdepth=('"integer  maxdepth"           [65]',
                      '"integer  maxdepth"           [3]'),
            iterations=('"integer  iterations"         [13]',
                        '"integer  iterations"         [2]'),
            radius=('"integer  filterradius"     [20]',
                    '"integer  filterradius"     [2]'),
            spp=('"integer  pixelsamples"  [ 4 ]',
                 '"integer  pixelsamples"  [ 2 ]'))


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def staircase(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    text = scene_text(width=16, height=12, spp=2, iterations=1, maxdepth=3,
                      denoise=True, filterradius=2,
                      extra_integrator='"string outputregex" [".*"]')
    return _write(tmp, "staircase.pbrt", text), tmp


def test_cli_writes_the_jax_file_set(staircase):
    path, tmp = staircase
    dj, dt = str(tmp / "jax"), str(tmp / "torch")
    _run(JM.main, [path, "--writeimages", "--baseseed", "3", "--outdir", dj])
    text = _run(TM.main, [path, "--writeimages", "--baseseed", "3",
                          "--outdir", dt, "--device", "cpu"])
    names = sorted(os.listdir(dt))
    assert names == sorted(os.listdir(dj))
    assert "staircase-proxy-2-film-f.pfm" in names
    lines = text.splitlines()
    for head in ("Iteration: 1", "SPP: 2", "Rendering time [ns]: ",
                 "CUDA time [ns]: ", "Output time [ns]: ", "Statistics:",
                 "    Camera rays traced 384"):
        assert any(ln.startswith(head) for ln in lines), head
    assert sum(ln.startswith("  wrote ") for ln in lines) == len(names)
    for n in names:
        assert np.isfinite(read_pfm(os.path.join(dt, n))).all(), n


def test_cli_denoise_round_trip(tmp_path):
    """configs/render-for-ours.pbrt's block renders and writes every
    statistic; --denoise with configs/denoise.pbrt's block re-filters
    them.  Its film-f equals the film-f of the same render filtered in
    memory."""
    world = _world()
    render = _write(tmp_path, "render.pbrt",
                    _config_block("render-for-ours", **CUTS) + world)
    denoise = _write(tmp_path, "denoise.pbrt",
                     _config_block("denoise", **CUTS) + world)
    out = str(tmp_path / "out")
    _run(TM.main, [render, "--writeimages", "--outdir", out,
                   "--device", "cpu"])
    assert not any("film-f" in n for n in os.listdir(out))
    text = _run(TM.main, [denoise, "--denoise", "--outdir", out,
                          "--device", "cpu"])
    assert "Iteration: 2" in text
    # In memory: the render's block with the image denoised; ACRR and
    # SMIS are off, so the filter changes no draw.
    mem = _write(tmp_path, "mem.pbrt", _config_block(
        "render-for-ours", **CUTS, denoise=(
            '"bool     denoiseimage"     ["false"]',
            '"bool     denoiseimage"     ["true"]')) + world)
    r = TD.load(mem, device="cpu")
    r.progress = False
    for i in (1, 2):
        r.run_iteration(i)
        disk = read_pfm(os.path.join(
            out, f"staircase-proxy-{r.total_spp(i)}-film-f.pfm"))
        np.testing.assert_allclose(disk, r.film_f.numpy().reshape(
            disk.shape), rtol=1e-4, atol=1e-5)


def test_denoise_from_disk_across_packages(staircase, tmp_path):
    """PFMs the JAX package wrote, filtered from disk by each package:
    equal buffer names, and every filtered buffer at the slice's rule
    (rtol 1e-4 on 98.5% of pixels; tests/test_torch_slice.py)."""
    path, _ = staircase
    rj = JD.load(path, base_seed=3)
    rj.run_iteration(1)
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    rj.write_outputs(a, 1)
    shutil.copytree(a, b)
    rj2 = JD.load(path, base_seed=3)
    rt = TD.load(path, base_seed=3, device="cpu")
    wj = rj2.denoise_from_disk(a, 1)
    wt = rt.denoise_from_disk(b, 1)
    assert sorted(map(os.path.basename, wj)) == sorted(
        map(os.path.basename, wt))
    bj, bt = rj2.buffers(), rt.buffers()
    assert bj.keys() == bt.keys()
    for k in bj:
        x, y = np.asarray(bj[k]), np.asarray(bt[k])
        close = np.isclose(y, x, rtol=1e-4, atol=1e-6)
        close = close.all(-1) if close.ndim == 3 else close
        assert close.mean() >= 0.985, (k, close.mean())


def test_checkpoint_resume_bitexact(tmp_path):
    text = scene_text(width=8, height=8, spp=2, iterations=2, maxdepth=3,
                      denoise=True, filtersd=2.0, filterradius=2)
    p = _write(tmp_path, "s.pbrt", text)
    full = TD.load(p, base_seed=5, device="cpu")
    full.render(iterations=2, verbose=False)

    r_a = TD.load(p, base_seed=5, device="cpu")
    r_a.render(iterations=1, verbose=False)
    ck = str(tmp_path / "ckpt.pt")
    r_a.save_checkpoint(ck, next_iteration=2)
    r_b = TD.load(p, base_seed=5, device="cpu")
    assert r_b.restore_checkpoint(ck) == 2
    r_b.render(iterations=2, verbose=False, start_iteration=2)

    assert torch.equal(r_b.film_mean, full.film_mean)
    assert torch.equal(r_b.film_f, full.film_f)
    assert torch.equal(r_b.ray_total, full.ray_total)
    for k in full.stats:
        assert torch.equal(r_b.stats[k], full.stats[k]), k
    for t, st in full.states.items():
        for k, v in st.items():
            assert torch.equal(r_b.states[t][k], v), (t, k)


def test_resume_from_jax_state(staircase):
    """The JAX package renders iteration 1; the port renders iteration 2
    from its state (convert.renderer_state) and matches the JAX
    package's iteration 2 at the slice's rule."""
    path, _ = staircase
    text = open(path).read().replace('"integer iterations" [1]',
                                     '"integer iterations" [2]')
    p2 = path.replace(".pbrt", "-2it.pbrt")
    open(p2, "w").write(text)
    rj = JD.load(p2, base_seed=3)
    rj.run_iteration(1)
    rt = TD.load(p2, base_seed=3, device="cpu")
    rt.progress = False
    convert.renderer_state(rj, rt)
    lt = rt.run_iteration(2)
    lj = rj.run_iteration(2)
    assert lt["rays_total"] == lj["rays_total"]
    bj, bt = rj.buffers(), rt.buffers()
    assert bj.keys() == bt.keys()
    for k in bj:
        x, y = np.asarray(bj[k]), np.asarray(bt[k])
        if k.endswith("-n"):
            np.testing.assert_array_equal(y, x, err_msg=k)
            continue
        close = np.isclose(y, x, rtol=1e-4, atol=1e-6)
        close = close.all(-1) if close.ndim == 3 else close
        assert close.mean() >= 0.985, (k, close.mean())


def test_print_stats_text(staircase):
    """The statistics block is the JAX package's, line for line, for the
    same counters."""
    path, _ = staircase
    rj = JD.load(path, base_seed=3)
    rt = TD.load(path, base_seed=3, device="cpu")
    counts = dict(n_camera_rays=384.0, zero_paths=41.0, total_paths=384.0,
                  path_len_sum=777.0, path_len_max=3.0)
    rj.stats = {k: np.float32(v) for k, v in counts.items()}
    rt.stats = {k: torch.tensor(v) for k, v in counts.items()}
    a, b = io.StringIO(), io.StringIO()
    rj.print_stats(file=a)
    rt.print_stats(file=b)
    assert b.getvalue() == a.getvalue()
    assert b.getvalue().startswith("Statistics:\n  Integrator\n")


def test_mesh_and_missing_cuda_raise(staircase):
    """Without a card the CLI refuses the default device, and a --mesh on
    cards it does not have (--mesh itself runs: test_torch_mesh_cli.py)."""
    path, tmp = staircase
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
            TM.main([path, "--mesh", "1x2", "--outdir", str(tmp / "x")])
        # The card is the default device; without one the CLI refuses.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TM.main([path, "--outdir", str(tmp / "x")])


def test_cli_profile_writes_a_trace(tmp_path):
    """--profile DIR: a torch.profiler chrome trace of the render loop."""
    p = _write(tmp_path, "s.pbrt", scene_text(width=8, height=6, spp=1,
                                              iterations=1, maxdepth=2,
                                              denoise=False))
    prof = tmp_path / "prof"
    text = _run(TM.main, [p, "--device", "cpu", "--profile", str(prof),
                          "--outdir", str(tmp_path / "out")])
    assert "profiler trace written to" in text
    assert (prof / "trace.json").stat().st_size > 0


def test_cli_streams_buffers_to_a_display_server(tmp_path):
    """--displayserver: the selected buffers reach a tev server (here a
    socket on localhost) as length-prefixed CreateImage (4) and
    UpdateImage (3) packets, each iteration's."""
    import socket
    import struct
    import threading

    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(60)
    received = bytearray()

    def serve():
        conn, _ = srv.accept()
        with conn:
            conn.settimeout(60)
            while chunk := conn.recv(1 << 16):
                received.extend(chunk)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    p = _write(tmp_path, "s.pbrt", scene_text(width=8, height=6, spp=1,
                                              iterations=1, maxdepth=2,
                                              denoise=False))
    port = srv.getsockname()[1]
    _run(TM.main, [p, "--device", "cpu", "--displayserver",
                   f"127.0.0.1:{port}", "--outdir", str(tmp_path / "o")])
    t.join(timeout=60)
    srv.close()
    assert not t.is_alive()
    directives, off = [], 0
    while off < len(received):
        n = struct.unpack_from("<I", received, off)[0]
        directives.append(received[off + 4])
        off += n
    assert off == len(received)
    assert directives[0] == 4 and 3 in directives
