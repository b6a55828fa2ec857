"""Port vs reference: the megakernel. The plain version
(pbrt_tpu_torch.ops.megawave.wave_full_plain, reached through the
trace_full wrapper on CPU tensors) against pbrt_tpu.ops.megawave.trace_full
in Pallas interpret mode, with the inputs of the reference's own
test_full_pipeline_matches_render_wave: cornell 16x16, 4 spp, sample index
2, max depth 4. Tolerance: the reference's kernel gate, relative error
< 1e-4 with a 1e-3 floor, per lane. The CUDA kernel is held to this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import filters as jflt  # noqa: E402
from pbrt_tpu import samplers as jsmp  # noqa: E402
from pbrt_tpu.ops import megawave as jmw  # noqa: E402
from pbrt_tpu.utils import spectrum as jspc  # noqa: E402
from pbrt_tpu_torch import filters as flt  # noqa: E402
from pbrt_tpu_torch import samplers as smp  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch.ops import megawave  # noqa: E402
from pbrt_tpu_torch.utils import spectrum as spc  # noqa: E402

from _jax_export import export_cornell  # noqa: E402

torch.set_num_threads(1)
W = H = 16
SPP = 4
MAX_DEPTH = 4
SAMPLE = 2


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3)


@pytest.fixture(scope="module")
def lanes():
    """The reference's lanes and outputs for one 16x16 wave."""
    scene, cam, sampler, _arrays, _meta = export_cornell(W, H, SPP)
    pix = np.arange(W * H)
    px, py = pix % W, pix // W
    si = np.full(W * H, SAMPLE)
    u_lam = jsmp.sample_1d(sampler, jnp.asarray(px), jnp.asarray(py),
                           jnp.asarray(si), 5)
    lam = np.array(jspc.sample_visible_wavelengths(u_lam).lam)
    L, fw = jmw.trace_full(scene, sampler, cam, jflt.make_filter("gaussian"),
                           jnp.asarray(px), jnp.asarray(py), jnp.asarray(si),
                           jnp.asarray(lam), max_depth=MAX_DEPTH, rr_start=1,
                           interpret=True)
    return px, py, si, lam, np.array(L), np.array(fw)


def _port_inputs(lanes, device="cpu"):
    px, py, si, lam, _L, _fw = lanes
    scene, cam = scenes.make_cornell_box(W, H, device=device)
    sampler = smp.make_sampler("zsobol", spp=SPP, full_resolution=(W, H))
    return (scene, sampler, cam, flt.make_filter("gaussian"),
            *(torch.as_tensor(a, device=device) for a in (px, py, si, lam)))


def test_seed_table_and_sobol_columns_match_reference():
    seeds = megawave.seed_table(0, MAX_DEPTH)
    assert seeds.shape == (megawave.n_dims(MAX_DEPTH), 3)
    for d in (0, 5, 17, seeds.shape[0] - 1):
        assert tuple(int(x) for x in seeds[d]) == (
            jmw._hash_u32_host(d, 0, 0x9dbf6d7c), jmw._hash_u32_host(d, 0),
            jmw._hash_u32_host(d, 0, 0x4df5))
    c0, c1 = jmw._sobol_cols01()
    assert tuple(int(x) for x in megawave.sobol_cols01()) == c0 + c1


def test_wavelengths_match_reference(lanes):
    px, py, si, lam, _L, _fw = lanes
    sampler = smp.make_sampler("zsobol", spp=SPP, full_resolution=(W, H))
    u = smp.sample_1d(sampler, *(torch.as_tensor(a) for a in (px, py, si)),
                      5)
    swl = spc.sample_visible_wavelengths(u)
    # same u bit for bit; atanh may round one ulp apart from XLA's
    np.testing.assert_allclose(swl.lam.numpy(), lam, rtol=1e-6)


def test_plain_megakernel_matches_reference(lanes):
    _px, _py, _si, _lam, L_ref, fw_ref = lanes
    before = megawave.counter.launches
    L, fw = megawave.trace_full(*_port_inputs(lanes), max_depth=MAX_DEPTH,
                                rr_start=1)
    assert megawave.counter.launches == before   # CPU: the plain version
    assert L.shape == (W * H, 4) and fw.shape == (W * H,)
    assert np.all(np.isfinite(L.numpy())) and (L_ref > 0).mean() > 0.5
    assert _rel(L.numpy(), L_ref).max() < 1e-4
    assert _rel(fw.numpy(), fw_ref).max() < 1e-4


def test_eligible_full_matches_reference_rule():
    scene, cam = scenes.make_cornell_box(8, 8, device="cpu")
    for spp, ok in ((4, True), (1 << 26, True), (1 << 27, False)):
        sampler = smp.make_sampler("zsobol", spp=spp, full_resolution=(8, 8))
        assert megawave.eligible_full(scene, sampler, cam,
                                      flt.make_filter("gaussian")) is ok

