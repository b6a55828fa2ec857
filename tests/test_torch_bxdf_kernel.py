"""The BxDF kernel (csrc/bxdf.cu, wrapper ops/bxdf.py) and its route.

- On the CPU: bxdfs.bsdf_f, bsdf_pdf and bsdf_sample run their plain
  versions for CPU tensors (plain.bxdf counts them, launches.bxdf does
  not); `takes` sends a tag set with the hair lobe to the plain version on
  any device; the wrapper refuses tensors of the wrong dtype, shape,
  contiguity or alignment, and a missing parameter a present tag needs;
  the kernel's float constants are the plain version's.
- On the card (marker cuda): the kernel against the plain version on the
  same CUDA tensors, bit for bit (NaNs as NaNs, zeros with their sign),
  over f, pdf and every output of a sample, on each tag alone and the
  three mixed, one present tag over lanes of other tags, several present
  tags over lanes of an absent one, smooth, rough and anisotropic
  roughness, wo above, below and on the surface, total internal
  reflection, a dispersive eta, uc None, a diffuse-only parameter set and
  N not a multiple of the block; and a cropped killeroo rendered through
  the kernel bit-equal to portbench/refport's plain render on the card.

The file imports no jax: on a machine without it run its card tests with
    python -m pytest tests/test_torch_bxdf_kernel.py --noconftest -q -m cuda
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import bxdfs
from pbrt_tpu_torch.ops import bxdf

ROOT = Path(__file__).resolve().parent.parent
N = 4099          # not a multiple of the kernel's 256-thread block

D, C, E, HAIR = (bxdfs.BXDF_DIFFUSE, bxdfs.BXDF_CONDUCTOR,
                 bxdfs.BXDF_DIELECTRIC, bxdfs.BXDF_HAIR)
# case -> (tags_present, the lanes' tags, parameter set)
CASES = {
    "diffuse": ((D,), (D,), "full"),
    "conductor": ((C,), (C,), "full"),
    "dielectric": ((E,), (E,), "full"),
    "mixed": ((D, C, E), (D, C, E), "full"),
    "one_tag_foreign_lanes": ((E,), (D, C, E), "full"),
    "absent_tag_lanes": ((D, C), (D, C, E), "full"),
    "diffuse_only_params": ((D,), (D, C), "diffuse_only"),
    "total_internal_reflection": ((E,), (E,), "tir"),
}


def _dirs(rs, n):
    v = rs.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def make_case(case, n=N, seed=0, device="cpu"):
    """Seeded inputs of a case: (BSDFParams, wo, wi, uc or None, u2), on
    `device`. Roughness: a quarter smooth (0 or 5e-4), a quarter
    anisotropic, the rest isotropic; eta per lane, half of it dispersive,
    some below 1; wo on both sides, ~10% on the surface (z = 0), a few
    zero and NaN lanes as dead lanes carry; wi random, wo's mirror, -wo or
    on the surface; u2 with exact zeros and halves (the disk's centre)."""
    tags_present, lane_tags, params = CASES[case]
    rs = np.random.RandomState(seed)
    tag = rs.choice(lane_tags, n).astype(np.int32)
    albedo = rs.uniform(0, 1, (n, 4))
    which = rs.randint(0, 4, n)
    ax = rs.uniform(0.01, 0.8, n)
    ay = np.where(which == 1, rs.uniform(0.01, 0.8, n), ax)
    smooth = rs.choice([0.0, 5e-4], n)
    ax = np.where(which == 0, smooth, ax)
    ay = np.where(which == 0, smooth, ay)
    base = rs.choice([0.7, 1.33, 1.5, 2.4], n)[:, None]
    eta = base + np.where(rs.rand(n, 1) < 0.5, 0.0,
                          rs.uniform(0, 0.05, (n, 4)))
    eta = np.where((tag == C)[:, None], rs.uniform(0.15, 1.5, (n, 4)), eta)
    k = rs.uniform(0.0, 4.0, (n, 4))
    wo = _dirs(rs, n)
    wi = _dirs(rs, n)
    if params == "tir":
        # from inside a denser medium at grazing angles, most beyond the
        # critical angle
        wo[:, 2] = -rs.uniform(0.0, 0.6, n)
        wo[:, :2] /= np.linalg.norm(wo[:, :2], axis=1, keepdims=True)
        wo[:, :2] *= np.sqrt(1.0 - wo[:, 2:] ** 2)
        eta = np.full((n, 4), 1.5)
    flat = rs.rand(n) < 0.1
    wo[flat, 2] = 0.0
    pick = rs.randint(0, 10, n)
    wi = np.where((pick == 0)[:, None], wo * [-1, -1, 1], wi)
    wi = np.where((pick == 1)[:, None], -wo, wi)
    wi[pick == 2, 2] = 0.0
    wo[:3] = 0.0
    wo[3:4] = np.nan
    u2 = rs.uniform(0, 1, (n, 2))
    u2[rs.rand(n) < 0.03] = 0.5
    u2[rs.rand(n) < 0.03] = 0.0
    uc = rs.uniform(0, 1, n)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)
    p = bxdfs.BSDFParams(tag=t(tag, torch.int32), albedo=t(albedo),
                         alpha_x=t(ax), alpha_y=t(ay), eta=t(eta), k=t(k),
                         tags_present=tags_present)
    if params == "diffuse_only":
        p.alpha_x = p.alpha_y = p.eta = p.k = None
    uc = t(uc) if E in tags_present else None
    return p, t(wo), t(wi), uc, t(u2)


def same_bits(a, b) -> bool:
    """Equal bit for bit, but any NaN matches any NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    both_nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | both_nan).all())


# --- on the CPU ---

def test_cpu_tensors_take_the_plain_version():
    p, wo, wi, uc, u2 = make_case("mixed", n=64)
    launches, plain = bxdf.counter.launches, bxdf.counter.plain
    f = bxdfs.bsdf_f(p, wo, wi)
    pdf = bxdfs.bsdf_pdf(p, wo, wi)
    s = bxdfs.bsdf_sample(p, wo, uc, u2)
    assert bxdf.counter.launches == launches
    assert bxdf.counter.plain == plain + 3
    assert same_bits(f, bxdfs.bsdf_f_plain(p, wo, wi))
    assert same_bits(pdf, bxdfs.bsdf_pdf_plain(p, wo, wi))
    want = bxdfs.bsdf_sample_plain(p, wo, uc, u2)
    assert all(same_bits(s[k], want[k]) for k in want)


@pytest.mark.parametrize("tags, device, kernel", [
    ((D,), "cuda", True), ((C,), "cuda", True), ((E,), "cuda", True),
    ((D, C, E), "cuda", True), ((D, C, E), "cpu", False),
    ((HAIR,), "cuda", False), ((D, HAIR), "cuda", False),
    ((D, C, E, HAIR), "cuda", False), ((), "cuda", False)])
def test_route_is_the_tag_set_and_the_device(tags, device, kernel):
    assert bxdf.takes(tags, torch.device(device)) is kernel
    assert bxdf.takes(tags, device) is kernel


def test_kernel_tags_are_the_reference_tags():
    assert (bxdf.DIFFUSE, bxdf.CONDUCTOR, bxdf.DIELECTRIC) == (D, C, E)
    src = (ROOT / "pbrt_tpu_torch/csrc/bxdf.cu").read_text()
    for name, want in (("kDiffuse", D), ("kConductor", C),
                       ("kDielectric", E)):
        assert re.search(rf"constexpr int {name} = {want};", src), name


def test_kernel_constants_are_the_plain_float32_constants():
    """PI, PI / 4.0, PI / 2.0 and INV_PI as the plain version's tensor ops
    see them: Python floats cast to float32."""
    from pbrt_tpu_torch.utils.math import INV_PI, PI
    src = (ROOT / "pbrt_tpu_torch/csrc/bxdf.cu").read_text()
    for name, want in (("kPi", PI), ("kPiOver4", PI / 4.0),
                       ("kPiOver2", PI / 2.0), ("kInvPi", INV_PI)):
        m = re.search(rf"constexpr float {name} = ([0-9.e+-]+)f;", src)
        assert m, name
        assert np.float32(float(m.group(1))) == np.float32(want), name


def _bad(case, what):
    """A case's inputs with one of them broken as `what` names."""
    p, wo, wi, uc, u2 = make_case(case, n=64)
    n = wo.shape[0]
    if what == "tag_int64":
        p.tag = p.tag.long()
    elif what == "tag_shape":
        p.tag = p.tag[:, None]
    elif what == "albedo_float64":
        p.albedo = p.albedo.double()
    elif what == "albedo_shape":
        p.albedo = p.albedo[:, :3].contiguous()
    elif what == "albedo_strided":
        p.albedo = torch.cat([p.albedo, p.albedo], dim=1)[:, ::2]
    elif what == "albedo_misaligned":
        p.albedo = torch.zeros(n * 4 + 1)[1:].view(n, 4)
    elif what == "alpha_missing":
        p.alpha_x = None
    elif what == "alpha_shape":
        p.alpha_y = p.alpha_y[: n - 1]
    elif what == "eta_missing":
        p.eta = None
    elif what == "eta_shape":
        p.eta = p.eta[:, 0].contiguous()
    elif what == "k_missing":
        p.k = None
    elif what == "wo_float64":
        wo = wo.double()
    elif what == "wo_strided":
        wo = wo.t().contiguous().t()
    elif what == "wi_shape":
        wi = wi[: n - 1]
    elif what == "uc_missing":
        uc = None
    elif what == "uc_shape":
        uc = uc[:, None]
    elif what == "u2_shape":
        u2 = torch.cat([u2, u2[:, :1]], dim=1)
    elif what == "u2_strided":
        u2 = u2.t().contiguous().t()
    elif what == "u2_misaligned":
        u2 = torch.zeros(n * 2 + 1)[1:].view(n, 2)
    elif what == "hair_tag":
        p.tags_present = (D, HAIR)
    return p, wo, wi, uc, u2


BAD = [("mixed", w, "both") for w in (
    "tag_int64", "tag_shape", "albedo_float64", "albedo_shape",
    "albedo_strided", "albedo_misaligned", "alpha_missing", "alpha_shape",
    "eta_missing", "eta_shape", "wo_float64", "wo_strided", "hair_tag")] + [
    ("conductor", "k_missing", "both"), ("mixed", "wi_shape", "eval"),
    ("dielectric", "uc_missing", "sample"), ("mixed", "uc_shape", "sample"),
    ("mixed", "u2_shape", "sample"), ("mixed", "u2_strided", "sample"),
    ("mixed", "u2_misaligned", "sample")]


@pytest.mark.parametrize("case, what, entry", BAD)
def test_wrapper_refuses_what_the_kernel_does_not_take(case, what, entry):
    p, wo, wi, uc, u2 = _bad(case, what)
    if entry in ("both", "eval"):
        with pytest.raises(ValueError):
            bxdf.eval_args(p, wo, wi)
    if entry in ("both", "sample"):
        with pytest.raises(ValueError):
            bxdf.sample_args(p, wo, uc, u2)


@pytest.mark.parametrize("case", list(CASES))
def test_wrapper_takes_every_case(case):
    """The arguments of both entries, and outputs of bsdf_f's, bsdf_pdf's
    and bsdf_sample's shapes and dtypes, for every case."""
    p, wo, wi, uc, u2 = make_case(case, n=64)
    args, (f, pdf) = bxdf.eval_args(p, wo, wi)
    assert len(args) == 13 and f.shape == (64, 4) and pdf.shape == (64,)
    args, out = bxdf.sample_args(p, wo, uc, u2)
    assert len(args) == 20
    want = bxdfs.bsdf_sample_plain(p, wo, uc, u2)
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    single = args[-1]
    assert single == (p.tags_present[0] if len(p.tags_present) == 1
                      else -1)
    assert args[-2] == sum(1 << t for t in p.tags_present)


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_bit_for_bit(cuda_device, case, seed):
    p, wo, wi, uc, u2 = make_case(case, seed=seed, device=cuda_device)
    before = bxdf.counter.launches
    f = bxdfs.bsdf_f(p, wo, wi)
    pdf = bxdfs.bsdf_pdf(p, wo, wi)
    s = bxdfs.bsdf_sample(p, wo, uc, u2)
    torch.cuda.synchronize()
    assert bxdf.counter.launches == before + 3
    bad = {}
    if not same_bits(f, bxdfs.bsdf_f_plain(p, wo, wi)):
        bad["f"] = True
    if not same_bits(pdf, bxdfs.bsdf_pdf_plain(p, wo, wi)):
        bad["pdf"] = True
    want = bxdfs.bsdf_sample_plain(p, wo, uc, u2)
    assert set(s) == set(want)
    for k in want:
        if not same_bits(s[k], want[k]):
            bad[f"sample {k}"] = True
    assert not bad, f"{case}: kernel != plain in {sorted(bad)}"


@pytest.mark.cuda
def test_kernel_on_no_lanes(cuda_device):
    p, wo, wi, uc, u2 = make_case("mixed", n=0, device=cuda_device)
    assert bxdfs.bsdf_f(p, wo, wi).shape == (0, 4)
    assert bxdfs.bsdf_sample(p, wo, uc, u2)["wi"].shape == (0, 3)


@pytest.mark.cuda
def test_killeroo_crop_matches_the_benchmark_reference(cuda_device):
    """killeroo at 32x32, 4 spp, depth 5 through the program (the BxDF
    kernel, no plain BxDF) and through portbench/refport's plain version,
    both on the card: the same image, bit for bit."""
    import sys
    sys.path.insert(0, str(ROOT))
    from pbrt_tpu_torch import samplers, spans
    from pbrt_tpu_torch.integrators import path, render
    from pbrt_tpu_torch.scene import parser
    from portbench.refport import samplers as ref_samplers
    from portbench.refport.integrators import path as ref_path
    from portbench.refport.integrators import render as ref_render
    from portbench.refport.scene import parser as ref_parser
    scenes = ROOT / "portbench" / "scenes"
    text = (scenes / "killeroo.pbrt").read_text()
    for key, v in (("xresolution", 32), ("yresolution", 32),
                   ("pixelsamples", 4)):
        text = re.sub(rf'"integer {key}" \[\s*\d+\s*\]',
                      f'"integer {key}" [{v}]', text)
    images = []
    for prs, smp, pth, rnd in ((parser, samplers, path, render),
                               (ref_parser, ref_samplers, ref_path,
                                ref_render)):
        desc = prs.parse_string(text, base_dir=str(scenes),
                                device=cuda_device)
        sampler = smp.make_sampler("zsobol", 4, 12345,
                                   full_resolution=(32, 32))
        img, _ = rnd.render(desc.scene, desc.camera, 4, device=cuda_device,
                            sampler=sampler,
                            opts=pth.PathOptions(max_depth=5))
        images.append(np.asarray(img))
        if prs is parser:
            counters = spans.images()[-1]["counters"]
            assert counters.get("launches.bxdf", 0) > 0
            assert "plain.bxdf" not in counters
    assert images[0].shape == (32, 32, 3) and np.isfinite(images[0]).all()
    assert np.array_equal(images[0], images[1])
