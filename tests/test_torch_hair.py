"""Port vs reference: the hair BxDF (pbrt_tpu_torch/bxdfs.py) and the hair
material (pbrt_tpu_torch/materials.py).

- _hair_f_pdf and _hair_sample against the reference's on seeded wo, wi,
  uc, u2 and seeded parameters (sigma_a, beta_m and beta_n from 0.1 to 0.9
  so both branches of Mp run, h, eta): f, pdf and the sampled wi within
  rel 1e-4 (atol 1e-6 for values near 0; float32 transcendentals of torch
  and XLA round an ulp apart, and the hair lobes chain a few dozen).
- The white-furnace property of tests/test_hair.py on the port: with
  sigma_a = 0 the scattered energy integrates to 1 within 0.08.
- The dispatchers over {diffuse, hair} and get_bsdf_params on a pool of
  both against the reference's; on a diffuse-only pool it leaves the hair
  columns unread.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import bxdfs as jbxdfs  # noqa: E402
from pbrt_tpu import materials as jmtl  # noqa: E402
from pbrt_tpu_torch import bxdfs  # noqa: E402
from pbrt_tpu_torch import materials as mtl  # noqa: E402
from pbrt_tpu_torch.utils import color as pcolor  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-4
ATOL = 1e-6


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _params(n, seed, tags=(bxdfs.BXDF_HAIR,)):
    """The same seeded per-lane hair parameters for both packages."""
    rs = np.random.RandomState(seed)
    arrs = dict(sigma_a=rs.uniform(0.0, 3.0, (n, 4)),
                beta_m=rs.uniform(0.1, 0.9, n), beta_n=rs.uniform(0.1, 0.9, n),
                h=rs.uniform(-1, 1, n), eta=rs.uniform(1.4, 1.7, n),
                tag=rs.choice(tags, n))
    arrs = {k: v.astype(np.int32 if k == "tag" else np.float32)
            for k, v in arrs.items()}
    eta4 = np.repeat(arrs["eta"][:, None], 4, axis=1)
    pj = jbxdfs.BSDFParams(
        tag=jnp.asarray(arrs["tag"]), albedo=jnp.asarray(arrs["sigma_a"]),
        alpha_x=jnp.asarray(arrs["beta_m"]),
        alpha_y=jnp.asarray(arrs["beta_n"]), eta=jnp.asarray(eta4),
        k=jnp.zeros((n, 4)), h=jnp.asarray(arrs["h"]),
        tags_present=tuple(tags))
    pt = bxdfs.BSDFParams(
        tag=torch.as_tensor(arrs["tag"]),
        albedo=torch.as_tensor(arrs["sigma_a"]),
        alpha_x=torch.as_tensor(arrs["beta_m"]),
        alpha_y=torch.as_tensor(arrs["beta_n"]), eta=torch.as_tensor(eta4),
        h=torch.as_tensor(arrs["h"]), tags_present=tuple(tags))
    return pj, pt


def _close(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    rel = np.abs(got - want) / np.maximum(np.abs(want), ATOL / RTOL)
    print(f"{what}: worst relative difference {rel.max():.3g} "
          f"(floor {ATOL / RTOL:g})")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def test_hair_f_pdf_matches_reference():
    n = 4096
    pj, pt = _params(n, 0)
    rs = np.random.RandomState(1)
    wo, wi = _unit(rs.normal(size=(n, 3))), _unit(rs.normal(size=(n, 3)))
    fj, pdfj = jbxdfs._hair_f_pdf(pj, jnp.asarray(wo), jnp.asarray(wi))
    f, pdf = bxdfs._hair_f_pdf(pt, torch.as_tensor(wo), torch.as_tensor(wi))
    assert np.all(np.isfinite(f.numpy())) and float(pdf.mean()) > 0
    _close(f, fj, "f")
    _close(pdf, pdfj, "pdf")


def test_hair_sample_matches_reference():
    n = 4096
    pj, pt = _params(n, 2)
    rs = np.random.RandomState(3)
    wo = _unit(rs.normal(size=(n, 3)))
    uc = rs.uniform(0, 1, n).astype(np.float32)
    u2 = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    wij, fj, pdfj = jbxdfs._hair_sample(pj, jnp.asarray(wo), jnp.asarray(uc),
                                        jnp.asarray(u2))
    wi, f, pdf = bxdfs._hair_sample(pt, torch.as_tensor(wo),
                                    torch.as_tensor(uc), torch.as_tensor(u2))
    _close(wi, wij, "wi")
    _close(f, fj, "f")
    _close(pdf, pdfj, "pdf")


@pytest.mark.parametrize("beta", [0.2, 0.4])
def test_hair_white_furnace(beta):
    """sigma_a = 0: the fiber absorbs nothing, so f |cos| integrates to ~1
    over the sphere (tests/test_hair.py, reference hair_test.cpp)."""
    n = 200000
    rng = np.random.default_rng(0)
    p = bxdfs.BSDFParams(
        tag=torch.full((n,), bxdfs.BXDF_HAIR), albedo=torch.zeros((n, 4)),
        alpha_x=torch.full((n,), beta), alpha_y=torch.full((n,), beta),
        eta=torch.full((n, 4), 1.55), h=torch.full((n,), 0.25),
        tags_present=(bxdfs.BXDF_HAIR,))
    wo = torch.as_tensor(_unit(np.tile([[0.35, 0.65, 0.674]], (n, 1))))
    wi = _unit(rng.normal(size=(n, 3)))
    f, _pdf = bxdfs._hair_f_pdf(p, wo, torch.as_tensor(wi))
    est = float((f.numpy().mean(-1) * np.abs(wi[:, 2])).mean() * 4 * np.pi)
    print(f"beta {beta}: furnace estimate {est:.4f}")
    assert abs(est - 1.0) < 0.08, (beta, est)


def test_dispatch_over_diffuse_and_hair_matches_reference():
    n = 2048
    tags = (bxdfs.BXDF_DIFFUSE, bxdfs.BXDF_HAIR)
    pj, pt = _params(n, 4, tags=tags)
    pj = pj.replace(albedo=jnp.clip(pj.albedo, 0, 1))
    pt.albedo = pt.albedo.clamp(0, 1)
    rs = np.random.RandomState(5)
    wo, wi = _unit(rs.normal(size=(n, 3))), _unit(rs.normal(size=(n, 3)))
    uc = rs.uniform(0, 1, n).astype(np.float32)
    u2 = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    args_j = (pj, jnp.asarray(wo), jnp.asarray(wi))
    args = (pt, torch.as_tensor(wo), torch.as_tensor(wi))
    _close(bxdfs.bsdf_f(*args), jbxdfs.bsdf_f(*args_j), "bsdf_f")
    _close(bxdfs.bsdf_pdf(*args), jbxdfs.bsdf_pdf(*args_j), "bsdf_pdf")
    bs_j = jbxdfs.bsdf_sample(pj, jnp.asarray(wo), jnp.asarray(uc),
                              jnp.asarray(u2))
    bs = bxdfs.bsdf_sample(pt, torch.as_tensor(wo), torch.as_tensor(uc),
                           torch.as_tensor(u2))
    for k in ("wi", "f", "pdf"):
        _close(bs[k], bs_j[k], f"bsdf_sample {k}")
    np.testing.assert_array_equal(bs["valid"].numpy(),
                                  np.asarray(bs_j["valid"]))
    pt.tags_present = tags + (5,)
    with pytest.raises(NotImplementedError, match="ROADMAP.md slice 3"):
        bxdfs.bsdf_pdf(*args)


def test_hair_material_matches_reference():
    """add_hair's row and get_bsdf_params on a pool of diffuse and hair
    rows: tag, albedo (sigma_a on hair lanes), alpha, eta and h."""
    jb = jmtl.MaterialBuilder()
    pb = mtl.MaterialBuilder(pcolor.srgb())
    for b in (jb, pb):
        b.add_diffuse((0.7, 0.2, 0.1))
        b.add_hair()
        b.add_hair(sigma_a=(0.8, 2.4, 5.0), beta_m=0.25, beta_n=0.6, eta=1.6)
    pool_j = jb.build()
    pool = pb.packed()
    np.testing.assert_array_equal(pool.view(np.uint8),
                                  np.asarray(pool_j.packed).view(np.uint8))
    assert pb.tags() == pool_j.bxdf_tags_present
    rs = np.random.RandomState(6)
    n = 256
    mat = rs.randint(0, 3, n)
    lam = rs.uniform(360, 830, (n, 4)).astype(np.float32)
    uv = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    bj = jmtl.get_bsdf_params(pool_j, jnp.asarray(mat, jnp.int32),
                              jnp.asarray(lam), jnp.zeros((1, 471)),
                              uv=jnp.asarray(uv))
    bp = mtl.get_bsdf_params(torch.as_tensor(pool), torch.as_tensor(mat),
                             torch.as_tensor(lam), pb.tags(),
                             uv=torch.as_tensor(uv))
    np.testing.assert_array_equal(bp.tag.numpy(), np.asarray(bj.tag))
    for k in ("albedo", "alpha_x", "alpha_y", "eta", "h"):
        np.testing.assert_allclose(getattr(bp, k).numpy(),
                                   np.asarray(getattr(bj, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_diffuse_pool_skips_hair_columns():
    """A pool without hair reads no hair column: albedo as the reference's
    (rel 1e-6), alpha, eta and h left unset."""
    jb = jmtl.MaterialBuilder()
    pb = mtl.MaterialBuilder(pcolor.srgb())
    for b in (jb, pb):
        b.add_diffuse((0.7, 0.2, 0.1))
        b.add_diffuse((0.1, 0.5, 0.9))
    pool_j = jb.build()
    assert pb.tags() == (bxdfs.BXDF_DIFFUSE,)
    rs = np.random.RandomState(8)
    n = 128
    mat = rs.randint(0, 2, n)
    lam = rs.uniform(360, 830, (n, 4)).astype(np.float32)
    uv = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    bj = jmtl.get_bsdf_params(pool_j, jnp.asarray(mat, jnp.int32),
                              jnp.asarray(lam), jnp.zeros((1, 471)),
                              uv=jnp.asarray(uv))
    bp = mtl.get_bsdf_params(torch.as_tensor(pb.packed()),
                             torch.as_tensor(mat), torch.as_tensor(lam),
                             pb.tags(), uv=torch.as_tensor(uv))
    np.testing.assert_allclose(bp.albedo.numpy(), np.asarray(bj.albedo),
                               rtol=1e-6, atol=1e-7)
    assert (bp.alpha_x, bp.alpha_y, bp.eta, bp.h) == (None,) * 4
