"""The port's textures, image lights and environment maps against the JAX
package: image readers, MIP pyramid and atlas, the noise lattice hash and
every texture kind, the hit's uv footprint, textured materials, the
goniometric / projection / environment-map branches of light sampling,
and a textured staircase with a goniometric light end to end on the fused
path (tests/test_torch_textured_twolevel.py holds the two-level path with
an environment map).

Integer work and host tables are held bit for bit.  Float lookups are
held to rtol 1e-5 / atol 1e-6: the JAX functions run eagerly here (one
XLA program per operation, so no multiply-add is contracted across
operations), and what is left is XLA's own sin, exp, log2, atan2 and
acos, each an ulp off PyTorch's on some inputs.  A MIP level is chosen
by floor(log2(footprint * res)), which can land one level apart on a
lane where the ulp falls on an integer; the blend across levels is
continuous, so such a lane still agrees within the tolerance.
"""
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statmc_tpu.driver as JD
from statmc_tpu.io import exr as JE
from statmc_tpu.io import image as JIM
from statmc_tpu.render import bsdf as JB
from statmc_tpu.render import camera as JC
from statmc_tpu.render import intersect as JX
from statmc_tpu.render import lights as JL
from statmc_tpu.scene import textures as JT
from statmc_tpu.scene.api import parse_scene as j_parse
import statmc_tpu_torch.driver as TD
from statmc_tpu_torch import convert
from statmc_tpu_torch import testscenes as TS
from statmc_tpu_torch.io import exr as TE
from statmc_tpu_torch.io import image as TIM
from statmc_tpu_torch.io.pfm import write_pfm
from statmc_tpu_torch.render import bsdf as TB
from statmc_tpu_torch.render import camera as TC
from statmc_tpu_torch.render import intersect as TX
from statmc_tpu_torch.render import lights as TL
from statmc_tpu_torch.scene import textures as TT

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(port, jax_value, err_msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_value),
                               rtol=RTOL, atol=ATOL, err_msg=err_msg)


def _write_tga(path, img8):
    h, w = img8.shape[:2]
    hdr = bytearray(18)
    hdr[2] = 2  # uncompressed true color
    hdr[12:14] = struct.pack("<H", w)
    hdr[14:16] = struct.pack("<H", h)
    hdr[16] = 24
    hdr[17] = 0x20  # top-left origin
    with open(path, "wb") as f:
        f.write(bytes(hdr) + np.ascontiguousarray(img8[..., ::-1]).tobytes())


def _write_png(path, img8, filt=0):
    """8-bit RGB(A) PNG, every row with filter type `filt` (the readers
    undo None, Sub and Up; bytes here are written unfiltered-equivalent
    for type 0 and delta-coded for Sub/Up)."""
    h, w, c = img8.shape
    rows = img8.reshape(h, w * c).astype(np.int32)
    out = []
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        line = rows[y]
        if filt == 1:
            line = line - np.concatenate([np.zeros(c, np.int32), line[:-c]])
        elif filt == 2:
            line = line - prev
        out.append(bytes([filt]) + (line % 256).astype(np.uint8).tobytes())
        prev = rows[y]

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                           {3: 2, 4: 6}[c], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(out))))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["tga", "png", "png-rgba-sub", "png-up",
                                  "pfm", "exr"])
def test_read_image_bit_equal(kind, tmp_path):
    """read_image of images the test writes: the port's copy returns the
    JAX package's array bit for bit, and the EXR and PNG writers'
    output reads back."""
    rng = np.random.default_rng(len(kind))
    h, w = 7, 9
    img8 = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / ("img." + kind.split("-")[0]))
    if kind == "tga":
        _write_tga(path, img8)
    elif kind == "png":
        _write_png(path, img8)
    elif kind == "png-rgba-sub":
        _write_png(path, np.concatenate(
            [img8, np.full((h, w, 1), 255, np.uint8)], -1), filt=1)
    elif kind == "png-up":
        _write_png(path, img8, filt=2)
    elif kind == "pfm":
        write_pfm(path, rng.random((h, w, 3)).astype(np.float32) * 5)
    else:
        TE.write_exr(path, rng.random((h, w, 3)).astype(np.float32) * 30)
    a, b = TIM.read_image(path), JIM.read_image(path)
    assert a.dtype == b.dtype == np.float32 and a.shape == (h, w, 3)
    np.testing.assert_array_equal(a, b)
    if kind == "exr":
        np.testing.assert_array_equal(a, JE.read_exr(path))
    if kind == "png":
        np.testing.assert_array_equal(
            a, TIM.srgb_to_linear(img8.astype(np.float32) / 255.0))


def _builders(tmp_path):
    """The same texture rows through both packages' builders: two images
    (37x20 and 16x16, so the pyramid has odd levels), every procedural
    kind, and scale/mix rows over children."""
    rng = np.random.default_rng(5)
    paths = []
    for k, (h, w) in enumerate([(20, 37), (16, 16)]):
        p = str(tmp_path / f"t{k}.png")
        TIM.write_png(p, rng.random((h, w, 3)).astype(np.float32))
        paths.append(p)
    out = []
    for mod in (JT, TT):
        b = mod.TextureTableBuilder()
        img = b.add_image(paths[0], 2.0, 3.0)
        b.add_image(paths[1])
        assert b.add_image(paths[0], 2.0, 3.0) == img  # cached
        assert b.add_image(str(tmp_path / "missing.png")) == mod.TEX_NONE
        chk = b.add_checker([0.9, 0.1, 0.2], [0.1, 0.3, 0.8], 3.0, 5.0)
        b.add_constant([0.3, 0.6, 0.9])
        for kind, par in ((mod.KIND_FBM, (5, 0.6, 1, 0)),
                          (mod.KIND_WRINKLED, (7, 0.45, 1, 0)),
                          (mod.KIND_WINDY, (8, 0.5, 1, 0)),
                          (mod.KIND_MARBLE, (6, 0.55, 2.5, 0.35))):
            b.add_noise(kind, *par)
        dots = b.add_dots([0.9, 0.8, 0.1], [0.1, 0.2, 0.3], 4.0, 4.0)
        b.add_uv(2.0, 0.5)
        b.add_bilerp([1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0])
        b.add_scale(img, [0.5, 0.7, 0.9])
        b.add_mix(chk, dots, 0.3)
        b.add_mix(-1, img, 0.6, c0_rgb=[0.2, 0.2, 0.2])
        out.append(b.build())
    return out


def test_mip_pyramid_and_atlas_bit_equal(tmp_path):
    jt, tt = _builders(tmp_path)
    assert tt.has_children == jt.has_children
    assert tt.kinds_static == tuple(jt.kinds_static)
    for f in TT.TextureTable._fields[:-2]:
        np.testing.assert_array_equal(getattr(tt, f),
                                      np.asarray(getattr(jt, f)), f)
    assert int(tt.tex_n_mips[0]) == 5  # 37x20 -> 18x10 -> 9x5 -> 4x2 -> 2x1


def test_hash3_bit_equal():
    """The uint32 lattice hash on int64 lanes, negative and large lattice
    indices included (astype(uint32) wraps them mod 2^32)."""
    rng = np.random.default_rng(0)
    n = 20000
    ix = np.concatenate([rng.integers(-2**31, 2**31 - 1, (3, n)),
                         rng.integers(-40, 40, (3, n))], 1).astype(np.int32)
    ix[:, :4] = [[-2**31, 2**31 - 1, -1, 0]] * 3
    a = TT._hash3(*(torch.as_tensor(x) for x in ix))
    b = JT._hash3(*(jnp.asarray(x) for x in ix))
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(np.unique(a.numpy())) == set(range(16))


def _points(rng, n, scale=6.0):
    p = (rng.standard_normal((n, 3)) * scale).astype(np.float32)
    p[: n // 8] = np.round(p[: n // 8])  # on lattice planes
    return p


def test_noise_functions_match():
    rng = np.random.default_rng(1)
    n = 3000
    p = _points(rng, n)
    omega = rng.uniform(0.3, 0.7, n).astype(np.float32)
    octaves = rng.integers(1, 9, n).astype(np.float32)
    tp, jp = _t(p), jnp.asarray(p)
    _close(TT.noise_p(tp), JT.noise_p(jp), "noise3")
    _close(TT.fbm(tp, _t(omega), _t(octaves)),
           JT.fbm(jp, jnp.asarray(omega), jnp.asarray(octaves)), "fbm")
    _close(TT.turbulence(tp, _t(omega), _t(octaves)),
           JT.turbulence(jp, jnp.asarray(omega), jnp.asarray(octaves)),
           "turbulence")
    _close(TT.fbm(0.1 * tp, 0.5, 3), JT.fbm(0.1 * jp, 0.5, 3), "fbm 3")
    scale = rng.uniform(0.5, 4, n).astype(np.float32)
    var = rng.uniform(0.1, 0.5, n).astype(np.float32)
    _close(TT._marble(tp, _t(octaves), _t(omega), _t(scale), _t(var)),
           JT._marble(jp, jnp.asarray(octaves), jnp.asarray(omega),
                      jnp.asarray(scale), jnp.asarray(var)), "marble")
    uv = np.concatenate([rng.uniform(-20, 20, (n // 2, 2)),
                         rng.uniform(-1e4, 1e4, (n - n // 2, 2))]
                        ).astype(np.float32)
    ins, outs = rng.random((n, 3)), rng.random((n, 3))
    d_t = TT._dots(_t(uv), _t(ins).float(), _t(outs).float())
    d_j = JT._dots(jnp.asarray(uv), jnp.asarray(ins, jnp.float32),
                   jnp.asarray(outs, jnp.float32))
    _close(d_t, d_j, "dots")
    assert 0.05 < (d_t.numpy() == ins.astype(np.float32)).all(-1).mean() < 0.9


def _lanes(rng, n, n_tex):
    """Texture ids (-1 included), uv (negative and large values
    included), world points and footprints for n lanes."""
    tex = rng.integers(-1, n_tex, n).astype(np.int32)
    uv = rng.uniform(-3, 3, (n, 2))
    uv[: n // 6] = rng.uniform(-3e3, 3e3, (n // 6, 2))
    uv[n // 6: n // 5] = np.round(uv[n // 6: n // 5] * 4) / 4  # cell edges
    p = _points(rng, n, 3.0)
    fp = np.exp(rng.uniform(-9, 1, n))
    ax = rng.standard_normal((n, 2, 2)) * np.exp(rng.uniform(-8, -1, (n, 1,
                                                                      1)))
    return (tex, uv.astype(np.float32), p, fp.astype(np.float32),
            ax.astype(np.float32))


@pytest.mark.parametrize("footprint", ["none", "cone", "axes"])
def test_sample_texture_every_kind(footprint, tmp_path):
    """sample_texture over the table of every kind (images, checker,
    constant, fbm, wrinkled, windy, marble, dots, uv, bilerp, scale and
    mix over children), at level 0, with the ray-cone footprint
    (trilinear) and with anisotropic axes (EWA)."""
    jt, tt = _builders(tmp_path)
    tt = tt.to_device("cpu")
    rng = np.random.default_rng(len(footprint))
    tex, uv, p, fp, ax = _lanes(rng, 4000, int(tt.tex_kind.shape[0]))
    kw_t, kw_j = {}, {}
    if footprint == "cone":
        kw_t, kw_j = dict(uv_fp=_t(fp)), dict(uv_fp=jnp.asarray(fp))
    elif footprint == "axes":
        kw_t = dict(uv_fp=_t(fp), uv_axes=_t(ax))
        kw_j = dict(uv_fp=jnp.asarray(fp), uv_axes=jnp.asarray(ax))
    a = TT.sample_texture(tt, _t(tex), _t(uv), _t(p), **kw_t)
    b = JT.sample_texture(jt, jnp.asarray(tex), jnp.asarray(uv),
                          jnp.asarray(p), **kw_j)
    _close(a, b)
    kinds = np.asarray(jt.tex_kind)[np.maximum(tex, 0)]
    assert len(set(kinds[tex >= 0])) == 12


def test_sample_texture_skips_absent_kinds_bitwise(tmp_path):
    """A table's kinds_static decides which kinds are evaluated; the
    table without it (every kind evaluated) gives every lane the same
    value, bit for bit."""
    _, tt = _builders(tmp_path)
    tt = tt.to_device("cpu")
    rng = np.random.default_rng(7)
    tex, uv, p, fp, ax = _lanes(rng, 2000, int(tt.tex_kind.shape[0]))
    # Rows: the two images, the checker, bilerp and the scale of an image.
    tex = np.where(np.isin(tex, [0, 1, 2, 10, 11]), tex, -1).astype(np.int32)
    sub = tt._replace(kinds_static=(TT.KIND_IMAGE, TT.KIND_CHECKER,
                                    TT.KIND_SCALE, TT.KIND_BILERP))
    for kw in ({}, dict(uv_fp=_t(fp)), dict(uv_fp=_t(fp), uv_axes=_t(ax))):
        a = TT.sample_texture(sub, _t(tex), _t(uv), _t(p), **kw)
        b = TT.sample_texture(tt._replace(kinds_static=None), _t(tex),
                              _t(uv), _t(p), **kw)
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def staircase(tmp_path_factory):
    """The textured 24x16 staircase proxy (every texture kind, an
    environment map, a goniometric light; the power light strategy, so
    the JAX package's setup compiles no spatial pass): (path, JAX setup,
    port setup)."""
    d = tmp_path_factory.mktemp("tex")
    path = d / "scene.pbrt"
    path.write_text(TS.textured_scene_text(
        str(d), width=24, height=16, spp=2, iterations=2, maxdepth=4,
        extra_integrator='"string lightsamplestrategy" ["power"]'))
    return (str(path), JD.prepare(j_parse(str(path))),
            TD.prepare(TD.parse_scene(str(path)), device="cpu"))


def test_scene_tables_bit_equal(staircase):
    """prepare() builds the JAX package's tables: the texture table, the
    environment map and its CDF and pdf tables, the image-light rows."""
    _, js, ts = staircase
    cs = convert.scene_tables(js.scene)
    assert ts.scene.env_light_id == cs.env_light_id >= 0
    assert ts.scene.has_textures and ts.scene.has_image_lights
    for f in cs._fields:
        a, b = getattr(cs, f), getattr(ts.scene, f)
        if f == "textures":
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), f)
    assert ts.scene.env_cond_cdf.shape == (32, 64)


def test_env_sample_ids_equal(staircase):
    """The environment map's row and column per lane equal the JAX
    package's searchsorted over the marginal and the gathered row, on
    random draws and on draws equal to (and an ulp either side of) CDF
    values, 0 and the largest float below 1."""
    _, js, ts = staircase
    rng = np.random.default_rng(3)
    cond = np.asarray(js.scene.env_cond_cdf)
    marg = np.asarray(js.scene.env_marginal_cdf)
    n = 6000
    u = rng.random((n, 2)).astype(np.float32)
    r = rng.integers(0, cond.shape[0], n)
    u[: n // 3, 1] = marg[r[: n // 3]]
    u[: n // 3, 0] = cond[r[: n // 3], rng.integers(0, cond.shape[1], n // 3)]
    for k, to in ((n // 3, 0.0), (n // 2, 1.0)):
        u[k: k + n // 6] = np.nextafter(u[k: k + n // 6], np.float32(to))
    u[-2:] = [[0.0, 0.0], [np.nextafter(np.float32(1), 0)] * 2]
    vrow, ucol = TL._env_sample(ts.scene, _t(u))
    He, We = cond.shape
    jv = np.minimum(np.searchsorted(marg, u[:, 1], side="right"), He - 1)
    jc = np.array([np.searchsorted(cond[v], x, side="right")
                   for v, x in zip(jv, u[:, 0])])
    np.testing.assert_array_equal(vrow.numpy(), jv)
    np.testing.assert_array_equal(ucol.numpy(), np.minimum(jc, We - 1))


def _rays(rng, js, n):
    lo = np.asarray(js.scene.tri_p0).min(0)
    hi = np.asarray(js.scene.tri_p0).max(0)
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_uv_axes_and_textured_materials_match(staircase):
    """The hit's anisotropic footprint (triangles, and the isotropic
    fallback on spheres) and gather_materials' textured Kd."""
    _, js, ts = staircase
    rng = np.random.default_rng(4)
    o, d = _rays(rng, js, 3000)
    hj = JX.intersect_scene(js.scene, jnp.asarray(o), jnp.asarray(d),
                            bvh=js.bvh)
    kind, idx = np.asarray(hj.prim_kind), np.asarray(hj.prim_idx)
    ht = TX._assemble_hit(ts.scene, _t(o), _t(d), _t(hj.t), _t(kind),
                          _t(idx))
    assert ht.uv_axes is not None and hj.uv_axes is not None
    assert (kind == TX.PRIM_SPH).sum() > 10 and (kind == TX.PRIM_TRI).sum()
    hit = kind != TX.PRIM_NONE
    _close(ht.uv_axes.numpy()[hit], np.asarray(hj.uv_axes)[hit], "uv_axes")
    _close(ht.uv_density, hj.uv_density, "uv_density")
    cone = np.float32(0.01) + np.float32(0.002) * np.asarray(hj.t)
    mj = JB.gather_materials(js.scene, hj.mat_id, hj.uv, hj.p,
                             uv_fp=cone * hj.uv_density,
                             uv_axes=hj.uv_axes * cone[:, None, None])
    mt = TB.gather_materials(ts.scene, _t(hj.mat_id), _t(hj.uv), _t(hj.p),
                             uv_fp=_t(cone * np.asarray(hj.uv_density)),
                             uv_axes=_t(np.asarray(hj.uv_axes)
                                        * cone[:, None, None]))
    _close(mt.kd, mj.kd, "kd")
    textured = np.asarray(js.scene.mat_kd_tex)[np.asarray(hj.mat_id)] >= 0
    assert textured[hit].mean() > 0.5
    for f in ("mat_type", "ks", "kr", "kt", "eta", "rough_u"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(mj, f)), f)


def test_untextured_gather_materials_unchanged(staircase):
    """Lanes without a texture keep their Kd bit for bit, and on an
    untextured scene gather_materials runs no lookup: its lanes are the
    plain row gather's, whatever uv it is given."""
    _, _, ts = staircase
    rng = np.random.default_rng(6)
    sc = ts.scene
    M = sc.mat_type.shape[0]
    mid = _t(rng.integers(0, M, 2000).astype(np.int32))
    uv = _t(rng.uniform(-2, 2, (2000, 2)).astype(np.float32))
    p = _t(_points(rng, 2000, 3.0))
    fp = _t(np.full(2000, 1e-3, np.float32))
    m = TB.gather_materials(sc, mid, uv, p, uv_fp=fp)
    plain = sc.mat_kd_tex[mid.long()] < 0
    assert plain.any() and (~plain).any()
    assert torch.equal(m.kd[plain], sc.mat_kd[mid.long()][plain])
    bare = sc._replace(has_textures=False)
    a = TB.gather_materials(bare, mid, uv, p, uv_fp=fp)
    b = TB.gather_materials(bare, mid)
    for x, y in zip(a, b):  # hair_h and sss_id: None in this scene
        assert (x is None and y is None) or torch.equal(x, y)
    assert torch.equal(a.kd, sc.mat_kd[mid.long()])


def test_untextured_render_runs_no_texture_code(tmp_path, monkeypatch):
    """An untextured scene's render never reaches a texture lookup, the
    footprint axes or an environment-map branch: every new block of the
    main path sits behind a host gate."""
    from statmc_tpu_torch.testscenes import scene_text

    def refuse(*a, **k):
        raise AssertionError("texture code ran on an untextured scene")

    for mod, name in ((TB, "sample_texture"), (TL, "sample_texture"),
                      (TX, "_footprint_axes"), (TL, "_env_sample"),
                      (TL, "_env_texel")):
        monkeypatch.setattr(mod, name, refuse)
    path = tmp_path / "scene.pbrt"
    path.write_text(scene_text(width=12, height=8, spp=1, iterations=1,
                               maxdepth=3, denoise=True, filterradius=2))
    r = TD.load(str(path), device="cpu")
    assert not (r.s.scene.has_textures or r.s.scene.has_image_lights)
    assert r.s.scene.env_light_id == -1
    r.render(verbose=False)
    assert np.isfinite(r.film_mean.numpy()).all()


def test_image_light_sampling_match(staircase):
    """sample_li, pdf_li and escaped_radiance for the environment map,
    the goniometric light and (the same table with that light's kind
    switched) a projection light."""
    _, js, ts = staircase
    rng = np.random.default_rng(8)
    n = 4000
    kinds = np.asarray(js.scene.light_kind)
    env = int(js.scene.env_light_id)
    gonio = int(np.nonzero(kinds == 6)[0][0])
    lo = np.asarray(js.scene.tri_p0).min(0)
    hi = np.asarray(js.scene.tri_p0).max(0)
    p = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    u2 = rng.random((n, 2)).astype(np.float32)
    lid = np.where(rng.random(n) < 0.5, env, gonio).astype(np.int32)
    for proj in (False, True):
        jsc, tsc = js.scene, ts.scene
        if proj:  # the projection branch, over the same image row
            k = kinds.copy()
            k[gonio] = 7
            par = np.asarray(jsc.light_params).copy()
            par[gonio] = [np.tan(np.radians(25.0)), 1.0]
            jsc = jsc._replace(light_kind=jnp.asarray(k),
                               light_params=jnp.asarray(par))
            tsc = tsc._replace(light_kind=_t(k), light_params=_t(par))
        jl = JL.sample_li(jsc, jnp.asarray(lid), jnp.asarray(p),
                          jnp.zeros((n, 3)), jnp.asarray(u2))
        tl = TL.sample_li(tsc, _t(lid), _t(p), torch.zeros((n, 3)), _t(u2))
        for f in ("wi", "pdf", "li", "p_light", "dist", "is_delta"):
            _close(getattr(tl, f).numpy(), getattr(jl, f), f"{proj} {f}")
        lit = (np.asarray(jl.li) > 0).any(-1)
        assert lit[lid == gonio].mean() > (0.02 if proj else 0.9)
        assert lit[lid == env].all()
    wi = rng.standard_normal((n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    hit = np.zeros((n, 3), np.float32)
    pj = JL.pdf_li(js.scene, jnp.asarray(lid), jnp.asarray(p),
                   jnp.asarray(wi), jnp.asarray(hit), jnp.asarray(hit),
                   jnp.zeros(n, bool))
    pt = TL.pdf_li(ts.scene, _t(lid), _t(p), _t(wi), _t(hit), _t(hit),
                   torch.zeros(n, dtype=torch.bool))
    _close(pt, pj, "pdf_li")
    assert (np.asarray(pj)[lid == env] > 0).all()
    d = rng.standard_normal((n, 3)).astype(np.float32) * 3
    _close(TL.escaped_radiance(ts.scene, _t(d)),
           JL.escaped_radiance(js.scene, jnp.asarray(d)), "escaped")


def hold_to_jax(jax_render, rt, share):
    """rt.render() against the JAX package's (ray totals per iteration,
    buffers): equal ray totals and sample counts, every other buffer
    within rtol 1e-4 on >= share of its pixels; the film finite with
    mean > 0.  Returns the worst share."""
    totals, bj = jax_render
    assert [x["rays_total"] for x in rt.render(verbose=False)] == totals
    bt = rt.buffers()
    assert bj.keys() == bt.keys()
    worst = 1.0
    for k in bj:
        a, b = bj[k], np.asarray(bt[k])
        assert a.shape == b.shape, k
        if k.endswith("-n"):
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        close = np.isclose(b, a, rtol=1e-4, atol=1e-6)
        close = close.all(-1) if close.ndim == 3 else close
        assert close.mean() >= share, (k, close.mean())
        worst = min(worst, close.mean())
    assert np.isfinite(bt["film"]).all() and bt["film"].mean() > 0
    return worst


def jax_camera(monkeypatch, js):
    """Replace the port's camera by the JAX package's compiled
    generate_rays on the same film points."""
    gen_j = jax.jit(lambda p: JC.generate_rays(js.cam, p))

    def generate_rays(cam, p_film):
        return tuple(_t(x) for x in gen_j(jnp.asarray(p_film.numpy())))

    monkeypatch.setattr(TC, "generate_rays", generate_rays)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The JAX package's render of a textured 24x16 staircase (imagemap
    walls and floor, checkerboard steps, uv, bilerp, mix and scale on the
    clutter boxes, a goniometric light, the spatial light strategy):
    (path, JAX setup, (ray totals per iteration, buffers))."""
    d = tmp_path_factory.mktemp("e2e")
    path = d / "scene.pbrt"
    path.write_text(TS.textured_scene_text(
        str(d), width=24, height=16, spp=2, iterations=2, maxdepth=4,
        env=False, clutter=("uv", "bilerp", "mix", "scale")))
    rj = JD.load(str(path))
    totals = [x["rays_total"] for x in rj.render(verbose=False)]
    return str(path), rj.s, (totals, {k: np.asarray(v)
                                      for k, v in rj.buffers().items()})


def test_textured_staircase_end_to_end_jax_camera(rendered, monkeypatch):
    """load(...).render() of the textured staircase in both packages,
    from the JAX package's camera rays: equal ray totals and sample
    counts, every buffer within rtol 1e-4 on >= 98.5% of the pixels."""
    path, js, jax_render = rendered
    jax_camera(monkeypatch, js)
    hold_to_jax(jax_render, TD.load(path, device="cpu"), 0.985)


def test_textured_staircase_end_to_end(rendered):
    """The same render from the port's own camera rays: equal ray totals
    and sample counts, every buffer within rtol 1e-4 on >= 97% of the
    pixels (measured: 97.66% at worst; from the JAX camera 98.96%).  The shortfall from 98.5% is
    the camera's rsqrt ulps (ROADMAP.md section C): on the steps, whose
    risers lie on the spatial light distribution's voxel planes, an ulp
    moves a hit point into the next voxel, and with the goniometric light
    beside the area light that voxel's light choice differs more than on
    the untextured proxy; test_textured_staircase_end_to_end_jax_camera
    is the witness."""
    path, _, jax_render = rendered
    hold_to_jax(jax_render, TD.load(path, device="cpu"), 0.97)


def test_textured_scene_renders_on_the_cpu(tmp_path):
    """A scene with an environment map (mapname), imagemap and procedural
    textures and a goniometric light loads and renders with
    device="cpu", through load() and the command line."""
    from statmc_tpu_torch import __main__ as TM
    from statmc_tpu_torch.io.pfm import read_pfm

    path = tmp_path / "scene.pbrt"
    path.write_text(TS.textured_scene_text(
        str(tmp_path), width=16, height=12, spp=1, iterations=1,
        maxdepth=3, clutter=("fbm", "dots")))
    r = TD.load(str(path), device="cpu")
    assert r.s.scene.env_light_id >= 0 and r.s.scene.has_image_lights
    r.render(verbose=False)
    film = r.film_mean.numpy()
    assert np.isfinite(film).all() and film.mean() > 0
    out = tmp_path / "out"
    TM.main([str(path), "--device", "cpu", "--writeimages", "--outdir",
             str(out)])
    pfms = sorted(p.name for p in out.iterdir())
    assert pfms and all(np.isfinite(read_pfm(str(out / p))).all()
                        for p in pfms)
