"""Port vs reference: u32 hashing, morton codes, Sobol'/Owen scrambling,
the zsobol sampler and erf^-1 (pbrt_tpu_torch.utils / samplers against
pbrt_tpu), all bit for bit on the same seeded inputs."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pbrt_tpu import samplers as jsmp  # noqa: E402
from pbrt_tpu.ops import megawave as jmw  # noqa: E402
from pbrt_tpu.utils import lowdiscrepancy as jld  # noqa: E402
from pbrt_tpu.utils import math as jmath  # noqa: E402
from pbrt_tpu.utils import rng as jrng  # noqa: E402
from pbrt_tpu_torch import samplers as smp  # noqa: E402
from pbrt_tpu_torch.utils import lowdiscrepancy as ld  # noqa: E402
from pbrt_tpu_torch.utils import math as tmath  # noqa: E402
from pbrt_tpu_torch.utils import rng  # noqa: E402

torch.set_num_threads(1)


def _u32(rs, n):
    return rs.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("words", [(7,), (6, 0), (17, 0, 0x9dbf6d7c),
                                   (40, 3, 0x4df5),
                                   (0xFFFFFFFF, 0x12345678)])
def test_host_hash_matches_reference(words):
    assert rng.hash_u32(*words) == jmw._hash_u32_host(*words)


def test_tensor_hash_matches_reference():
    rs = np.random.RandomState(1)
    a, b, c = _u32(rs, 4096), _u32(rs, 4096), _u32(rs, 4096)
    ref = np.asarray(jrng.hash_u32(a, b, c, np.uint32(0x9dbf6d7c)))
    got = rng.hash_u32(_t(a), _t(b), _t(c), 0x9dbf6d7c).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    np.testing.assert_array_equal(rng.fmix32(_t(a)).numpy(),
                                  np.asarray(jrng.fmix32(a)).astype(np.int64))


def test_morton_matches_reference():
    rs = np.random.RandomState(2)
    x, y = rs.randint(0, 1 << 16, 4096), rs.randint(0, 1 << 16, 4096)
    ref = np.asarray(jrng.encode_morton_2(x.astype(np.uint32),
                                          y.astype(np.uint32)))
    got = rng.encode_morton_2(_t(x), _t(y))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(rng.compact_bits_2(got).numpy(), x)
    np.testing.assert_array_equal(rng.compact_bits_2(got >> 1).numpy(), y)


def test_sobol_and_owen_match_reference():
    rs = np.random.RandomState(3)
    a, s = _u32(rs, 4096), _u32(rs, 4096)
    for dim in (0, 1):
        ref = np.asarray(jld.sobol_sample_u32(a, dim))
        np.testing.assert_array_equal(
            ld.sobol_sample_u32(_t(a), dim).numpy(), ref.astype(np.int64))
    ref = np.asarray(jld.fast_owen_scramble(a, s))
    np.testing.assert_array_equal(
        ld.fast_owen_scramble(_t(a), _t(s)).numpy(), ref.astype(np.int64))
    ref = np.asarray(jld.u32_to_sample(jnp.asarray(a)))
    np.testing.assert_array_equal(ld.u32_to_sample(_t(a)).numpy(), ref)


def test_zsobol_samples_bitexact_dims_0_to_61():
    """sample_1d / sample_2d at every dimension the main path draws, for
    every pixel and sample of a 16x16, 4 spp image."""
    W = H = 16
    spp = 4
    jp = jsmp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    tp = smp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    assert (tp.spp, tp.log2_spp, tp.n_base4_digits) == \
        (jp.spp, jp.log2_spp, jp.n_base4_digits)
    dims = np.arange(62)
    pix = np.arange(W * H)
    g_pix, g_s, g_d = (a.reshape(-1) for a in
                       np.meshgrid(pix, np.arange(spp), dims, indexing="ij"))
    px, py = g_pix % W, g_pix // W
    args_j = [jnp.asarray(v, jnp.int32) for v in (px, py, g_s, g_d)]
    args_t = [torch.as_tensor(v) for v in (px, py, g_s, g_d)]
    np.testing.assert_array_equal(smp.sample_1d(tp, *args_t).numpy(),
                                  np.asarray(jsmp.sample_1d(jp, *args_j)))
    np.testing.assert_array_equal(smp.sample_2d(tp, *args_t).numpy(),
                                  np.asarray(jsmp.sample_2d(jp, *args_j)))


@pytest.mark.parametrize("dim", [0, 5, 61])
def test_zsobol_int_dim_bitexact(dim):
    """A dimension given as a Python int (hashed once on the host) gives
    the reference's samples bit for bit, as a per-lane tensor does."""
    W = H = 16
    spp = 4
    jp = jsmp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    tp = smp.make_sampler("zsobol", spp=spp, full_resolution=(W, H))
    g_pix, g_s = (a.reshape(-1) for a in
                  np.meshgrid(np.arange(W * H), np.arange(spp),
                              indexing="ij"))
    px, py = g_pix % W, g_pix // W
    args_j = [jnp.asarray(v, jnp.int32) for v in (px, py, g_s)]
    args_t = [torch.as_tensor(v) for v in (px, py, g_s)]
    np.testing.assert_array_equal(smp.sample_1d(tp, *args_t, dim).numpy(),
                                  np.asarray(jsmp.sample_1d(jp, *args_j, dim)))
    np.testing.assert_array_equal(smp.sample_2d(tp, *args_t, dim).numpy(),
                                  np.asarray(jsmp.sample_2d(jp, *args_j, dim)))


def test_erf_inv_within_two_ulp():
    """erf_inv is the same Giles polynomial, but torch's and XLA's float32
    log round one ulp apart on about a fifth of the inputs, and the
    polynomial carries that to at most 2 ulp of the result. So the bound
    is 2 ulp, with most values equal."""
    rs = np.random.RandomState(4)
    x = np.concatenate([rs.uniform(-1, 1, 8192),
                        [0.0, 0.5, -0.99999, 0.99999, 0.999999]])
    x = x.astype(np.float32)
    ref = np.asarray(jmath.erf_inv(jnp.asarray(x)))
    got = tmath.erf_inv(torch.as_tensor(x)).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - ref.view(np.int32).astype(np.int64))
    assert ulp.max() <= 2, ulp.max()
    assert (ulp == 0).mean() > 0.9


def test_next_float_matches_reference():
    # normal floats, zeros and infinities (XLA on the CPU flushes denormal
    # inputs to zero, torch does not, so denormals are left out)
    v = np.asarray([0.0, -0.0, 1.0, -1.0, 3.5e-38, -2.5, np.inf, -np.inf,
                    554.0, -1e-30], np.float32)
    for f_t, f_j in ((tmath.next_float_up, jmath.next_float_up),
                     (tmath.next_float_down, jmath.next_float_down)):
        np.testing.assert_array_equal(f_t(torch.as_tensor(v)).numpy(),
                                      np.asarray(f_j(jnp.asarray(v))))
