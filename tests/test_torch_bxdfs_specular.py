"""Port vs reference: the conductor and the dielectric (pbrt_tpu_torch/
bxdfs.py), their Fresnel and Trowbridge-Reitz functions, the named spectra
and the equal-area sphere maps.

Every input is made from a numpy seed and goes through the reference's
function and the port's; the tolerance is rtol 1e-5, atol 1e-6:
- fr_complex, fr_dielectric and each tr_* function on seeded directions,
  wavelengths' eta and k, and roughness pairs;
- bsdf_f, bsdf_pdf and bsdf_sample of the conductor and the dielectric at
  alpha 0 (specular), 0.283 (envlit's conductor: roughness 0.08 remapped)
  and an anisotropic pair, wo on both sides of the surface (so the
  dielectric's total internal reflection runs), a spectral eta for the
  dielectric's dispersion; the sampled flags (valid, specular,
  transmission, dispersed) equal;
- every name of the named-spectrum table at seeded wavelengths;
- both equal-area maps on seeded points and on the axis and seam
  directions, where the octahedral fold meets signed zeros.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import bxdfs as jbxdfs  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu.utils import vecmath as jvm  # noqa: E402
from pbrt_tpu_torch import bxdfs  # noqa: E402
from pbrt_tpu_torch.utils import spectrum as spc  # noqa: E402
from pbrt_tpu_torch.utils import vecmath as vm  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5
ATOL = 1e-6
N = 2048


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _dirs(rs, n, upper=None):
    """Seeded unit directions; upper True / False puts them above / below
    the surface."""
    w = _unit(rs.normal(size=(n, 3)))
    if upper is not None:
        w[:, 2] = np.abs(w[:, 2]) * (1 if upper else -1)
    return w


ALPHAS = {"smooth": (0.0, 0.0), "envlit": (0.2828427, 0.2828427),
          "anisotropic": (0.1, 0.45)}


def test_fr_complex_matches_reference():
    rs = np.random.RandomState(1)
    cos = rs.uniform(-1, 1, (N, 1)).astype(np.float32)
    eta = rs.uniform(0.1, 3.0, (N, 4)).astype(np.float32)
    k = rs.uniform(0.0, 5.0, (N, 4)).astype(np.float32)
    _close(bxdfs.fr_complex(*map(torch.as_tensor, (cos, eta, k))),
           jbxdfs.fr_complex(*map(jnp.asarray, (cos, eta, k))), "fr_complex")
    cos1 = cos[:, 0]
    eta1 = rs.uniform(1.0, 2.5, N).astype(np.float32)
    _close(bxdfs.fr_dielectric(torch.as_tensor(cos1), torch.as_tensor(eta1)),
           jbxdfs.fr_dielectric(jnp.asarray(cos1), jnp.asarray(eta1)),
           "fr_dielectric")


@pytest.mark.parametrize("fn", ["tr_d", "tr_lambda", "tr_g1", "tr_g",
                                "tr_d_visible", "tr_sample_wm", "tr_pdf",
                                "tr_effectively_smooth",
                                "roughness_to_alpha"])
@pytest.mark.parametrize("alpha", ["envlit", "anisotropic"])
def test_trowbridge_reitz_matches_reference(fn, alpha):
    rs = np.random.RandomState(2)
    w = _dirs(rs, N)
    wm = _dirs(rs, N, upper=True)
    ax = np.full(N, ALPHAS[alpha][0], np.float32) * \
        rs.uniform(0.5, 1.5, N).astype(np.float32)
    ay = np.full(N, ALPHAS[alpha][1], np.float32)
    u = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    args = {"tr_d": (wm, ax, ay), "tr_lambda": (w, ax, ay),
            "tr_g1": (w, ax, ay), "tr_g": (w, wm, ax, ay),
            "tr_d_visible": (w, wm, ax, ay), "tr_sample_wm": (w, u, ax, ay),
            "tr_pdf": (w, wm, ax, ay), "tr_effectively_smooth": (ax, ay),
            "roughness_to_alpha": (ax,)}[fn]
    got = getattr(bxdfs, fn)(*map(torch.as_tensor, args))
    want = getattr(jbxdfs, fn)(*map(jnp.asarray, args))
    if got.dtype == torch.bool:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, fn)


def _params(tag, alpha, n, seed, spectral_eta=False):
    """The same seeded parameters for both packages: a conductor with Au-
    like eta and k, or a dielectric of eta 1.5 (or a dispersive eta)."""
    rs = np.random.RandomState(seed)
    ax = np.full(n, ALPHAS[alpha][0], np.float32)
    ay = np.full(n, ALPHAS[alpha][1], np.float32)
    if tag == bxdfs.BXDF_CONDUCTOR:
        eta = rs.uniform(0.15, 1.5, (n, 4)).astype(np.float32)
        k = rs.uniform(1.5, 4.0, (n, 4)).astype(np.float32)
    else:
        eta = np.full((n, 4), 1.5, np.float32)
        if spectral_eta:
            eta = eta + rs.uniform(0.0, 0.03, (n, 4)).astype(np.float32)
        k = np.ones((n, 4), np.float32)
    alb = np.zeros((n, 4), np.float32)
    tags = np.full(n, tag, np.int32)
    pj = jbxdfs.BSDFParams(tag=jnp.asarray(tags), albedo=jnp.asarray(alb),
                           alpha_x=jnp.asarray(ax), alpha_y=jnp.asarray(ay),
                           eta=jnp.asarray(eta), k=jnp.asarray(k),
                           tags_present=(tag,))
    pt = bxdfs.BSDFParams(tag=torch.as_tensor(tags),
                          albedo=torch.as_tensor(alb),
                          alpha_x=torch.as_tensor(ax),
                          alpha_y=torch.as_tensor(ay),
                          eta=torch.as_tensor(eta), k=torch.as_tensor(k),
                          tags_present=(tag,))
    return pj, pt


CASES = [(tag, alpha, side)
         for tag in (bxdfs.BXDF_CONDUCTOR, bxdfs.BXDF_DIELECTRIC)
         for alpha in ALPHAS for side in ("above", "below")]


@pytest.mark.parametrize("tag, alpha, side", CASES)
def test_bxdf_f_pdf_sample_match_reference(tag, alpha, side):
    """f, pdf and a sample of each lobe; wo below the surface makes the
    dielectric refract out of the denser side, where total internal
    reflection takes the grazing directions."""
    pj, pt = _params(tag, alpha, N, seed=3)
    rs = np.random.RandomState(4)
    wo = _dirs(rs, N, upper=(side == "above"))
    wi = _dirs(rs, N)
    uc = rs.uniform(0, 1, N).astype(np.float32)
    u2 = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    args_j = (pj, jnp.asarray(wo), jnp.asarray(wi))
    args = (pt, torch.as_tensor(wo), torch.as_tensor(wi))
    _close(bxdfs.bsdf_f(*args), jbxdfs.bsdf_f(*args_j), "bsdf_f")
    _close(bxdfs.bsdf_pdf(*args), jbxdfs.bsdf_pdf(*args_j), "bsdf_pdf")
    bs_j = jbxdfs.bsdf_sample(pj, jnp.asarray(wo), jnp.asarray(uc),
                              jnp.asarray(u2))
    bs = bxdfs.bsdf_sample(pt, torch.as_tensor(wo), torch.as_tensor(uc),
                           torch.as_tensor(u2))
    for k in ("valid", "specular", "transmission", "dispersed"):
        np.testing.assert_array_equal(bs[k].numpy(), np.asarray(bs_j[k]),
                                      err_msg=k)
    for k in ("wi", "f", "pdf", "eta_scale"):
        _close(bs[k], bs_j[k], f"bsdf_sample {k}")
    if tag == bxdfs.BXDF_DIELECTRIC and alpha == "smooth":
        # both lobes and, from below, total internal reflection were drawn
        trans = bs["transmission"].numpy()
        assert trans.any() and (~trans).any()
        if side == "below":
            _ok, _wt, _eta = vm.refract(torch.as_tensor(wo),
                                        torch.tensor([0.0, 0.0, 1.0]),
                                        torch.full((N,), 1.5))
            assert (~_ok).any()


@pytest.mark.parametrize("alpha", ["smooth", "envlit"])
def test_dispersive_dielectric_sample_matches_reference(alpha):
    """A spectral eta: a transmission disperses (the secondary wavelengths
    end), a reflection does not."""
    pj, pt = _params(bxdfs.BXDF_DIELECTRIC, alpha, N, seed=5,
                     spectral_eta=True)
    rs = np.random.RandomState(6)
    wo = _dirs(rs, N)
    uc = rs.uniform(0, 1, N).astype(np.float32)
    u2 = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    bs_j = jbxdfs.bsdf_sample(pj, jnp.asarray(wo), jnp.asarray(uc),
                              jnp.asarray(u2))
    bs = bxdfs.bsdf_sample(pt, torch.as_tensor(wo), torch.as_tensor(uc),
                           torch.as_tensor(u2))
    for k in ("valid", "specular", "transmission", "dispersed"):
        np.testing.assert_array_equal(bs[k].numpy(), np.asarray(bs_j[k]),
                                      err_msg=k)
    for k in ("wi", "f", "pdf", "eta_scale"):
        _close(bs[k], bs_j[k], f"bsdf_sample {k}")
    assert bs["dispersed"].any()
    assert torch.equal(bs["dispersed"], bs["transmission"])


def test_mixed_pool_dispatch_matches_reference():
    """Diffuse, conductor and dielectric lanes side by side: each lane takes
    its own tag's lobe."""
    tags = (bxdfs.BXDF_DIFFUSE, bxdfs.BXDF_CONDUCTOR, bxdfs.BXDF_DIELECTRIC)
    rs = np.random.RandomState(7)
    tag = rs.choice(tags, N).astype(np.int32)
    ax = np.where(rs.uniform(size=N) < 0.5, 0.0, 0.3).astype(np.float32)
    eta = rs.uniform(1.2, 1.8, (N, 4)).astype(np.float32)
    k = rs.uniform(1.0, 3.0, (N, 4)).astype(np.float32)
    alb = rs.uniform(0, 1, (N, 4)).astype(np.float32)
    pj = jbxdfs.BSDFParams(tag=jnp.asarray(tag), albedo=jnp.asarray(alb),
                           alpha_x=jnp.asarray(ax), alpha_y=jnp.asarray(ax),
                           eta=jnp.asarray(eta), k=jnp.asarray(k),
                           tags_present=tags)
    pt = bxdfs.BSDFParams(tag=torch.as_tensor(tag),
                          albedo=torch.as_tensor(alb),
                          alpha_x=torch.as_tensor(ax),
                          alpha_y=torch.as_tensor(ax),
                          eta=torch.as_tensor(eta), k=torch.as_tensor(k),
                          tags_present=tags)
    wo, wi = _dirs(rs, N), _dirs(rs, N)
    uc = rs.uniform(0, 1, N).astype(np.float32)
    u2 = rs.uniform(0, 1, (N, 2)).astype(np.float32)
    _close(bxdfs.bsdf_f(pt, torch.as_tensor(wo), torch.as_tensor(wi)),
           jbxdfs.bsdf_f(pj, jnp.asarray(wo), jnp.asarray(wi)), "bsdf_f")
    _close(bxdfs.bsdf_pdf(pt, torch.as_tensor(wo), torch.as_tensor(wi)),
           jbxdfs.bsdf_pdf(pj, jnp.asarray(wo), jnp.asarray(wi)), "bsdf_pdf")
    bs_j = jbxdfs.bsdf_sample(pj, jnp.asarray(wo), jnp.asarray(uc),
                              jnp.asarray(u2))
    bs = bxdfs.bsdf_sample(pt, torch.as_tensor(wo), torch.as_tensor(uc),
                           torch.as_tensor(u2))
    for k in ("valid", "specular", "transmission", "dispersed"):
        np.testing.assert_array_equal(bs[k].numpy(), np.asarray(bs_j[k]),
                                      err_msg=k)
    for k in ("wi", "f", "pdf", "eta_scale"):
        _close(bs[k], bs_j[k], f"bsdf_sample {k}")


@pytest.mark.parametrize("name", sorted(spc._NAME_MAP))
def test_named_spectrum_matches_reference(name):
    rs = np.random.RandomState(sum(map(ord, name)))
    lam = np.concatenate([rs.uniform(spc.LAMBDA_MIN - 20, spc.LAMBDA_MAX + 20,
                                     256), [360.0, 830.0, 555.5]])
    got = spc.get_named_spectrum(name)
    want = jspc.get_named_spectrum(name)
    assert got is not None and want is not None
    np.testing.assert_allclose(got(lam), want(lam), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())


def test_unknown_named_spectrum_is_none():
    assert spc.get_named_spectrum("metal-Unobtainium-eta") is None
    assert jspc.get_named_spectrum("metal-Unobtainium-eta") is None


def test_eval_dense_matches_reference():
    rs = np.random.RandomState(8)
    table = rs.uniform(0, 2, spc.N_CIE).astype(np.float32)
    lam = rs.uniform(340, 850, (N, 4)).astype(np.float32)
    _close(spc.eval_dense(torch.as_tensor(table), torch.as_tensor(lam)),
           jspc.eval_dense(jnp.asarray(table), jnp.asarray(lam)),
           "eval_dense")


def _axis_and_seam_dirs():
    """The six axes with both signed zeros, and directions on the
    octahedron's seams (a zero component, |x| = |y|, z = 0)."""
    out = []
    for axis in range(3):
        for s in (1.0, -1.0):
            for z0 in (0.0, -0.0):
                v = [z0, z0, z0]
                v[axis] = s
                out.append(v)
    r = np.sqrt(0.5)
    for sx in (1, -1):
        for sy in (1, -1):
            out += [[sx * r, sy * r, 0.0], [sx * r, 0.0, sy * r],
                    [0.0, sx * r, sy * r], [sx * 0.6, sy * 0.6,
                                            np.sqrt(1 - 0.72)],
                    [sx * 0.6, sy * 0.6, -np.sqrt(1 - 0.72)]]
    return np.asarray(out, np.float32)


def test_equal_area_sphere_to_square_matches_reference():
    rs = np.random.RandomState(9)
    d = np.concatenate([_dirs(rs, N), _axis_and_seam_dirs()])
    _close(vm.equal_area_sphere_to_square(torch.as_tensor(d)),
           jvm.equal_area_sphere_to_square(jnp.asarray(d)),
           "equal_area_sphere_to_square")


def test_equal_area_square_to_sphere_matches_reference():
    rs = np.random.RandomState(10)
    edges = np.asarray([[u, v] for u in (0.0, 0.25, 0.5, 0.75, 1.0)
                        for v in (0.0, 0.25, 0.5, 0.75, 1.0)], np.float32)
    p = np.concatenate([rs.uniform(0, 1, (N, 2)).astype(np.float32), edges])
    got = vm.equal_area_square_to_sphere(torch.as_tensor(p))
    _close(got, jvm.equal_area_square_to_sphere(jnp.asarray(p)),
           "equal_area_square_to_sphere")
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-5)
    # and back: the two maps are inverses away from the seams
    back = vm.equal_area_sphere_to_square(got[:N])
    np.testing.assert_allclose(back.numpy(), p[:N], atol=1e-4)


def test_reflect_refract_match_reference():
    rs = np.random.RandomState(11)
    wo = _dirs(rs, N)
    n = _dirs(rs, N, upper=True)
    eta = rs.uniform(1.1, 2.0, N).astype(np.float32)
    _close(vm.reflect(torch.as_tensor(wo), torch.as_tensor(n)),
           jvm.reflect(jnp.asarray(wo), jnp.asarray(n)), "reflect")
    ok, wt, e = vm.refract(*map(torch.as_tensor, (wo, n, eta)))
    ok_j, wt_j, e_j = jvm.refract(*map(jnp.asarray, (wo, n, eta)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    _close(wt, wt_j, "refract wt")
    _close(e, e_j, "refract eta")
    assert (~ok.numpy()).any()
