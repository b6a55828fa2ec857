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



def _pool(n_tris, seed):
    """A pool of n_tris triangles and 1,024 seeded rays from its box +-1:
    the 1,280 triangles of a subdivision-3 icosphere (the pool a scene
    built with the default force_bvh hands the kernel), else a seeded soup
    of small triangles in the unit box."""
    rs = np.random.RandomState(seed)
    if n_tris == 1280:
        v, f, _n = scenes.make_sphere_mesh((0.0, 0.0, 0.0), 1.0, subdiv=3)
        tri = v[f].reshape(-1, 9)
    else:
        p0 = rs.uniform(-1, 1, (n_tris, 1, 3))
        tri = (p0 + rs.normal(scale=0.05, size=(n_tris, 3, 3))).reshape(-1, 9)
    assert len(tri) == n_tris
    o = rs.uniform(-2, 2, (1024, 3)).astype(np.float32)
    d = rs.normal(size=(1024, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return tri.astype(np.float32), o, d


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n_tris", [772, 1280, 4096])
def test_plain_matches_reference_kernel_above_768_triangles(n_tris, any_hit):
    """Pools larger than 48 KB of rows, which the reference's kernel takes
    (run here in interpret mode): prim equal, t within rtol 1e-5, the
    barycentrics within atol 5e-5."""
    tri, o, d = _pool(n_tris, n_tris)
    pool = ti.pad_triangles(tri)
    assert pool.size == n_tris * 16
    t_max = np.full(len(o), 1.5 if any_hit else 1e30, np.float32)
    want = jpi.brute_force_intersect(jnp.asarray(pool), jnp.asarray(o),
                                     jnp.asarray(d), jnp.asarray(t_max),
                                     n_real=n_tris, any_hit=any_hit,
                                     interpret=True)
    t, k, b1, b2 = ti.tri_intersect(torch.as_tensor(pool), torch.as_tensor(o),
                                    torch.as_tensor(d),
                                    torch.as_tensor(t_max), n_tris, any_hit)
    hit = np.asarray(want["hit"])
    assert 0.02 < hit.mean() < 0.95
    np.testing.assert_array_equal(k.numpy(), np.asarray(want["prim"]))
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(want["t"])[hit],
                               rtol=1e-5)
    # the barycentric numerators cancel (triangles of size 0.05 seen from
    # a distance of 3: an error of some 60 ulp), and XLA contracts
    # multiply-adds where torch rounds twice: atol 5e-5
    np.testing.assert_allclose(b1.numpy(), np.asarray(want["b1"]), rtol=1e-5,
                               atol=5e-5)
    np.testing.assert_allclose(b2.numpy(), np.asarray(want["b2"]), rtol=1e-5,
                               atol=5e-5)


def test_brute_force_and_bvh_routes_agree_on_1280_triangles():
    """The subdivision-3 icosphere through scene_core.intersect and
    intersect_p on the CPU, built with the default force_bvh (1,280
    triangles: the brute-force pool) and with force_bvh=True (BVH8): the
    same hits. The two routes' lower t bounds differ (1e-6 and 1e-5), which
    no ray from outside the sphere reaches."""
    from pbrt_tpu_torch import scene_core as sc
    brute, _cam = scenes.make_furnace_sphere(subdiv=3, force_bvh=None,
                                             device="cpu")
    tree, _cam = scenes.make_furnace_sphere(subdiv=3, force_bvh=True,
                                            device="cpu")
    assert brute.n_tris == 1280 and brute.tri_pallas is not None
    assert brute.bvh8 is None and tree.bvh8 is not None
    _tri, o, d = _pool(1280, 5)
    # origins outside the unit sphere, half of the rays aimed into it
    keep = np.linalg.norm(o, axis=1) > 1.05
    o, d = o[keep], d[keep]
    aim = -o[::2] + 0.7 * d[::2]
    d[::2] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    far = torch.full((len(o),), 1e30)
    a, b = sc.intersect(brute, o, d, far), sc.intersect(tree, o, d, far)
    hit = a["hit"].numpy()
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_array_equal(hit, b["hit"].numpy())
    np.testing.assert_array_equal(a["prim"].numpy()[hit],
                                  b["prim"].numpy()[hit])
    for k in ("t", "p", "ng", "ns", "uv"):
        np.testing.assert_allclose(a[k].numpy()[hit], b[k].numpy()[hit],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    near = torch.full((len(o),), 2.5)
    np.testing.assert_array_equal(sc.intersect_p(brute, o, d, near).numpy(),
                                  sc.intersect_p(tree, o, d, near).numpy())
