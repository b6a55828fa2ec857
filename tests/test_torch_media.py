"""Port vs reference: the media (media.py), the Henyey-Greenstein phase
function, the flight loop's random stream, and the parse of media and
medium interfaces.

- MediumBuilder: the descriptor rows, the density pool and the majorant
  super-grid (its cells, box and resolution) np.array_equal to the
  reference's for volume.pbrt's 24^3 grid, a homogeneous medium beside
  grids of other shapes and boxes, and a grid coarser than the super-grid;
- density_at, medium_index_at, majorant and hg_g at seeded points inside,
  on and outside the boxes: within rtol 1e-5 (the indices equal);
  sigma_at within rtol 1e-5 on >= 99.9% of the values and 1e-4 on all;
  the super-grid's majorant bounds sigma_t at every point of a cell with
  a nonzero majorant (the reference leaves slivers of a grid box's faces
  in majorant-0 cells; ROADMAP.md section 3);
- henyey_greenstein and sample_henyey_greenstein at seeded cosines,
  asymmetries (the isotropic branch included) and uniforms: rtol 1e-5;
- the flight loop's draws (utils/rng.hash_continue from a lane's kept
  prefix, u32_to_float01) bit for bit to the reference's uniform_float,
  and hash_continue to its hash_u32;
- parse_file("scenes/volume.pbrt"): the medium pool and the interface
  triangles and media array for array; the refusals of the media the port
  does not have.
"""
import functools
import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import media as jmed  # noqa: E402
from pbrt_tpu.integrators import volpath as jvol  # noqa: E402
from pbrt_tpu.scene import parser as jparser  # noqa: E402
from pbrt_tpu.utils import color as jcolor  # noqa: E402
from pbrt_tpu.utils import rng as jrng  # noqa: E402
from pbrt_tpu.utils import sampling as jsamp  # noqa: E402
from pbrt_tpu_torch import media  # noqa: E402
from pbrt_tpu_torch.integrators import volpath  # noqa: E402
from pbrt_tpu_torch.scene import parser  # noqa: E402
from pbrt_tpu_torch.utils import color as pcolor  # noqa: E402
from pbrt_tpu_torch.utils import rng  # noqa: E402
from pbrt_tpu_torch.utils import sampling  # noqa: E402

torch.set_num_threads(1)
SCENES = Path(__file__).resolve().parent.parent / "scenes"


def _grid(seed, shape):
    rs = np.random.default_rng(seed)
    g = rs.gamma(0.8, 1.0, shape).astype(np.float32)
    g[rs.uniform(size=shape) < 0.2] = 0.0
    return g


@functools.lru_cache(maxsize=1)
def _volume_density():
    """volume.pbrt's 24^3 density grid (the port's parse)."""
    desc = parser.parse_file(SCENES / "volume.pbrt", device="cpu")
    return desc.scene.media.grid.numpy()[1:].reshape(24, 24, 24)


MEDIA_CASES = {
    "volume": lambda b: b.add_grid(
        _volume_density(), (-1.2,) * 3, (1.2,) * 3,
        sigma_a=(0.2, 0.25, 0.3), sigma_s=(3, 3, 3), g=0.3, scale=2.0),
    "homogeneous and grids": lambda b: (
        b.add_homogeneous(sigma_a=(0.5, 0.1, 0.05), sigma_s=(1, 2, 0.5),
                          g=-0.4, scale=1.5, bounds_lo=(-3, -1, -2),
                          bounds_hi=(2, 2, 1)),
        b.add_grid(_grid(1, (5, 7, 9)), (0.5, -0.8, -1.5), (2.5, 1.0, 0.4),
                   sigma_a=(2.0, 0.2, 0.7), sigma_s=(0.3, 4.0, 1.0), g=0.6),
        b.add_grid(_grid(2, (11, 3, 6)), (-2.0, 0.0, -1.0),
                   (-0.5, 3.0, 2.0), sigma_s=(1.5, 1.5, 1.5))),
    "coarse grid": lambda b: b.add_grid(
        _grid(3, (2, 3, 2)), (-4.0, -1.0, -1.0), (4.0, 1.0, 3.0),
        sigma_a=(0.1, 0.1, 0.1), sigma_s=(0.9, 0.5, 0.2)),
}


def _pools(name):
    bj = jmed.MediumBuilder(jcolor.srgb())
    bp = media.MediumBuilder(pcolor.srgb())
    MEDIA_CASES[name](bj)
    MEDIA_CASES[name](bp)
    return bj.build(), bp.build("cpu")


@pytest.mark.parametrize("name", list(MEDIA_CASES))
def test_majorant_supergrid_matches_reference(name):
    pj, pp = _pools(name)
    for k in ("desc", "grid", "maj_grid", "maj_lo", "maj_hi"):
        np.testing.assert_array_equal(getattr(pp, k).numpy(),
                                      np.asarray(getattr(pj, k)), err_msg=k)
    assert pp.maj_res == tuple(pj.maj_res)
    assert pp.max_majorant == pj.max_majorant
    assert (pp.maj_grid.numpy() > 0).mean() > 0.05


def _points(seed, n, lo, hi):
    rs = np.random.default_rng(seed)
    span = np.asarray(hi) - np.asarray(lo)
    p = rs.uniform(np.asarray(lo) - 0.2 * span, np.asarray(hi) + 0.2 * span,
                   (n, 3)).astype(np.float32)
    p[:16] = np.asarray(lo, np.float32)     # on the low corner
    return p


@pytest.mark.parametrize("name", list(MEDIA_CASES))
def test_lookups_match_reference(name):
    pj, pp = _pools(name)
    n = 4096
    p = _points(7, n, pp.maj_lo.numpy(), pp.maj_hi.numpy())
    lam = np.random.default_rng(8).uniform(360, 830, (n, 4)).astype(
        np.float32)
    idx_p = volpath.medium_index_at(pp, torch.as_tensor(p))
    idx_j = np.asarray(jvol.medium_index_at(pj, jnp.asarray(p)))
    np.testing.assert_array_equal(idx_p.numpy(), idx_j)
    assert (idx_j >= 0).mean() > 0.2
    row_p = media.medium_row(pp, idx_p)
    row_j = jmed.medium_row(pj, jnp.asarray(idx_j))
    np.testing.assert_array_equal(row_p.numpy(), np.asarray(row_j))
    dens_p = media.density_at(pp, row_p, torch.as_tensor(p)).numpy()
    dens_j = np.asarray(jmed.density_at(pj, row_j, jnp.asarray(p)))
    np.testing.assert_allclose(dens_p, dens_j, rtol=1e-5, atol=1e-7)
    sa_p, ss_p = media.sigma_at(pp, row_p, torch.as_tensor(p),
                                torch.as_tensor(lam))
    sa_j, ss_j = jmed.sigma_at(pj, row_j, jnp.asarray(p), jnp.asarray(lam))
    # the sigmoid's and the trilinear weights' roundings: 1e-5 on all but
    # a few lanes, 1e-4 on every lane
    for got, want in ((sa_p, sa_j), (ss_p, ss_j)):
        rel = np.abs(got.numpy() - np.asarray(want)) / np.maximum(
            np.abs(np.asarray(want)), 1e-6)
        assert (rel < 1e-5).mean() >= 0.999 and (rel < 1e-4).all()
    np.testing.assert_array_equal(media.majorant(row_p).numpy(),
                                  np.asarray(jmed.majorant(row_j)))
    np.testing.assert_array_equal(media.hg_g(row_p).numpy(),
                                  np.asarray(jmed.hg_g(row_j)))
    np.testing.assert_array_equal(
        media.le_at(pp, row_p, torch.as_tensor(p), torch.as_tensor(lam))
        .numpy(), np.asarray(jmed.le_at(pj, row_j, jnp.asarray(p),
                                        jnp.asarray(lam))))
    # the majorant bounds sigma_t wherever the medium is
    maj = volpath._maj_lookup(pp, torch.stack([
        torch.clamp(((torch.as_tensor(p) - pp.maj_lo) / (pp.maj_hi
                                                          - pp.maj_lo)
                     * torch.tensor(pp.maj_res, dtype=torch.float32))
                    .floor().long(), min=0)[:, k].clamp(
                        max=pp.maj_res[k] - 1) for k in range(3)], -1))
    st = torch.where(idx_p >= 0, (sa_p + ss_p).amax(-1), 0.0).numpy()
    maj = maj.numpy()
    assert (st[maj > 0] <= maj[maj > 0] * (1 + 1e-5) + 1e-6).all()
    # the reference's holes: a grid box's face sliver in a cell that no
    # resampled voxel centre falls in keeps majorant 0 (ROADMAP.md
    # section 3); each such point lies within a cell of its box's face
    hole = (maj == 0) & (st > 0)
    if hole.any():
        rows = row_p.numpy()[hole]
        cell = ((pp.maj_hi - pp.maj_lo) / torch.tensor(
            pp.maj_res, dtype=torch.float32)).numpy()
        to_face = np.minimum(np.abs(p[hole] - rows[:, 15:18]),
                             np.abs(p[hole] - rows[:, 18:21])).min(-1)
        assert (to_face <= cell.max()).all() and hole.mean() < 0.01


def test_henyey_greenstein_matches_reference():
    rs = np.random.default_rng(12)
    n = 4096
    cos = rs.uniform(-1, 1, n).astype(np.float32)
    g = rs.uniform(-1, 1, n).astype(np.float32)
    g[:64] = rs.uniform(-5e-4, 5e-4, 64)       # the isotropic branch
    g[64:80] = (0.999, -0.999) * 8             # clamped
    u = rs.uniform(size=(n, 2)).astype(np.float32)
    wo = rs.normal(size=(n, 3))
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(
        sampling.henyey_greenstein(torch.as_tensor(cos),
                                   torch.as_tensor(g)).numpy(),
        np.asarray(jsamp.henyey_greenstein(jnp.asarray(cos), jnp.asarray(g))),
        rtol=1e-5)
    wi_p, pdf_p = sampling.sample_henyey_greenstein(
        torch.as_tensor(u), torch.as_tensor(g), torch.as_tensor(wo))
    wi_j, pdf_j = jsamp.sample_henyey_greenstein(jnp.asarray(u),
                                                 jnp.asarray(g),
                                                 jnp.asarray(wo))
    np.testing.assert_allclose(wi_p.numpy(), np.asarray(wi_j), rtol=1e-5,
                               atol=2e-6)
    np.testing.assert_allclose(pdf_p.numpy(), np.asarray(pdf_j), rtol=1e-5)
    # the pdf is the phase function of the sampled direction's cosine
    # (below |g| 0.9: near |g| = 1 the lobe is too sharp for the
    # recomputed cosine's rounding)
    mild = np.abs(g) < 0.9
    cos_s = (wi_p * torch.as_tensor(wo)).sum(-1)
    np.testing.assert_allclose(pdf_p.numpy()[mild], sampling.henyey_greenstein(
        cos_s, torch.as_tensor(g)).numpy()[mild], rtol=2e-3, atol=1e-6)


def test_flight_stream_matches_reference():
    rs = np.random.default_rng(13)
    seed = rs.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    s_t = torch.as_tensor(seed.astype(np.int64))
    h1 = rng.hash_continue(0x9E3779B9, s_t)
    for it in (0, 1, 77, 511):
        for stream in (0x51a7, 0x9bd3, 0x7b55, 0x3d91):
            want = np.asarray(jrng.uniform_float(
                jnp.asarray(seed.astype(np.uint32)), jnp.uint32(it),
                jnp.uint32(stream)))
            np.testing.assert_array_equal(rng.u32_to_float01(
                rng.hash_u32(s_t, it, stream)).numpy(), want)
            np.testing.assert_array_equal(rng.u32_to_float01(
                rng.hash_continue(rng.hash_continue(h1, it), stream))
                .numpy(), want)
    px, py, si = (torch.as_tensor(rs.integers(0, 400, 4096)) for _ in
                  range(3))
    want = np.asarray(jrng.hash_u32(*(jnp.asarray(x.numpy().astype(np.uint32))
                                      for x in (px, py, si)),
                                    jnp.uint32(3), np.uint32(0x6d3a)))
    got = rng.hash_continue(rng.hash_u32(px, py, si), 3, 0x6d3a)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_parse_volume_matches_reference():
    dj = jparser.parse_file(SCENES / "volume.pbrt")
    dp = parser.parse_file(SCENES / "volume.pbrt", device="cpu")
    sj, sp = dj.scene, dp.scene
    assert dp.integrator == dict(name="volpath", max_depth=6)
    assert sp.has_media and sp.has_medium_interfaces and not sp.use_bvh
    assert sp.n_tris == 2 and sp.iface_tris.shape == (12, 10)
    assert not sp.use_iface_bvh and sp.mega is None
    for what, got, want in (
            ("triangles", sp.tri_all, sj.tri_all),
            ("medium rows", sp.media.desc, sj.media.desc),
            ("densities", sp.media.grid, sj.media.grid),
            ("majorants", sp.media.maj_grid, sj.media.maj_grid),
            ("interface triangles", sp.iface_tris, sj.iface_tris),
            ("interface media", sp.iface_med, sj.iface_med),
            ("light rows", sp.lights_packed, sj.lights.packed),
            ("spectra", sp.spectra_pool, sj.spectra_pool)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    assert sp.media.maj_res == (64, 64, 64)
    assert sp.scene_radius == float(sj.scene_radius)
    np.testing.assert_array_equal(sp.iface_med.numpy(), [[0, -1]] * 12)


def test_parse_homogeneous_medium_matches_reference():
    text = b'''WorldBegin
LightSource "infinite"
MakeNamedMedium "fog" "string type" "homogeneous"
  "rgb sigma_a" [0.1 0.2 0.3] "rgb sigma_s" [0.5 0.5 2.5] "float g" [-0.2]
  "float scale" [0.5]
Material "diffuse"
Shape "trianglemesh" "integer indices" [0 1 2]
  "point3 P" [-1 0 -1  1 0 -1  0 0 1]
AttributeBegin
  Material "interface"
  MediumInterface "" "fog"
  Translate 0 1 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point3 P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
AttributeEnd
'''
    dj = jparser.parse_string(text)
    dp = parser.parse_string(text, device="cpu")
    for what, got, want in (
            ("medium rows", dp.scene.media.desc, dj.scene.media.desc),
            ("majorants", dp.scene.media.maj_grid, dj.scene.media.maj_grid),
            ("interface triangles", dp.scene.iface_tris, dj.scene.iface_tris),
            ("interface media", dp.scene.iface_med, dj.scene.iface_med)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    np.testing.assert_array_equal(dp.scene.iface_med.numpy(), [[-1, 0]] * 2)
    assert dp.scene.media.maj_res == (8, 8, 8)


@pytest.mark.parametrize("snippet, msg", [
    (b'MakeNamedMedium "m" "string type" "rgbgrid"', "slice 3 item 13"),
    (b'MakeNamedMedium "m" "string type" "cloud"', "slice 3 item 13"),
    (b'MakeNamedMedium "m" "string type" "nanovdb"', "item 23"),
    (b'Integrator "bdpt"', "slice 5 item 22"),
    (b'Material ""\nMediumInterface "nope" ""\nShape "trianglemesh" '
     b'"integer indices" [0 1 2] "point3 P" [0 0 0 1 0 0 0 1 0]',
     "unknown medium 'nope'"),
])
def test_media_refusals(snippet, msg):
    with pytest.raises(parser.ParseError) as err:
        parser.parse_string(snippet + b"\nWorldBegin\n", device="cpu")
    assert msg in str(err.value), str(err.value)
