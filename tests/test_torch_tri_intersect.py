"""Port vs reference: the brute-force triangle test. The plain version
(pbrt_tpu_torch.ops.tri_intersect) against the TPU kernel's body,
pbrt_tpu.ops.pallas_intersect._tri_block_math, called on plain arrays as
its docstring prescribes, for seeded random rays and the camera rays of a
16x16 image, closest and any hit. The CUDA kernel is held to this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import cameras as jcam  # noqa: E402
from pbrt_tpu.ops import pallas_intersect as jpi  # noqa: E402
from pbrt_tpu_torch import scenes  # noqa: E402
from pbrt_tpu_torch.ops import tri_intersect as ti  # noqa: E402

from _jax_export import export_cornell  # noqa: E402

torch.set_num_threads(1)
W = H = 16


@pytest.fixture(scope="module")
def rays():
    """4096 seeded rays from inside and around the box plus the 256 pixel-
    center camera rays; t_max: far for closest hit, seeded for any hit."""
    scene, cam, _smp, arrays, _meta = export_cornell(W, H, spp=4)
    rs = np.random.RandomState(7)
    o = rs.uniform([-50, -50, -900], [600, 600, 600], (4096, 3))
    d = rs.normal(size=(4096, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pix = np.arange(W * H)
    p_film = np.stack([pix % W + 0.5, pix // W + 0.5], -1).astype(np.float32)
    o_c, d_c, _t = jcam.generate_ray(cam, jnp.asarray(p_film),
                                     jnp.zeros((W * H, 2)),
                                     jnp.zeros((W * H,)))
    o = np.concatenate([o, np.asarray(o_c)]).astype(np.float32)
    d = np.concatenate([d, np.asarray(d_c)]).astype(np.float32)
    t_any = rs.uniform(0, 1500, len(o)).astype(np.float32)
    return np.array(arrays["tri_pallas"]), scene.mega.n_tris, o, d, t_any


def _reference(tri, n_real, o, d, t_max, any_hit):
    n_pool = tri.shape[0] // 16
    t, k, b1, b2 = jpi._tri_block_math(
        jnp.asarray(tri), *(jnp.asarray(o[:, c]) for c in range(3)),
        *(jnp.asarray(d[:, c]) for c in range(3)), jnp.asarray(t_max),
        n_pool, n_real, any_hit)
    return (np.asarray(t), np.asarray(k).astype(np.int32), np.asarray(b1),
            np.asarray(b2))


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_matches_reference_block_math(rays, any_hit):
    tri, n_real, o, d, t_any = rays
    t_max = t_any if any_hit else np.full(len(o), 1e30, np.float32)
    t_r, k_r, b1_r, b2_r = _reference(tri, n_real, o, d, t_max, any_hit)
    before = ti.counter.launches
    t, k, b1, b2 = ti.tri_intersect(torch.as_tensor(tri), torch.as_tensor(o),
                                    torch.as_tensor(d),
                                    torch.as_tensor(t_max), n_real, any_hit)
    assert ti.counter.launches == before   # CPU tensors: plain version
    assert k.dtype == torch.int32
    np.testing.assert_array_equal(k.numpy(), k_r)
    assert (k_r >= 0).mean() > 0.2   # the rays do hit the box
    np.testing.assert_allclose(t.numpy(), t_r, rtol=1e-5)
    np.testing.assert_allclose(b1.numpy(), b1_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b2.numpy(), b2_r, rtol=1e-5, atol=1e-6)


def test_pad_triangles_matches_reference():
    scene, _cam = scenes.make_cornell_box(W, H, device="cpu")
    rs = np.random.RandomState(8)
    v = rs.uniform(-5, 5, (7, 10)).astype(np.float32)
    np.testing.assert_array_equal(ti.pad_triangles(v[:, :9]),
                                  np.asarray(jpi.pad_triangles(v)))
    assert scene.tri_pallas.numel() == 32 * 16

