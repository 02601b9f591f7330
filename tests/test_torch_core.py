"""Port parity, core layer: PCG, seeding, vector math, camera rays.

Each test feeds the same numpy inputs to the JAX package and to
``tpu_path_tracer_torch`` and compares the outputs.  JAX runs op by op
here (outside ``jit``): XLA's CPU compiler contracts ``a*b+c`` into fused
multiply-adds inside a compiled function, which the port does not do, and
op by op both packages round every operation the same way.
"""

import numpy as np
import jax.numpy as jnp
import torch

import tpu_path_tracer as tpt
from tpu_path_tracer.core import rng as jrng, vecmath as jvm
from tpu_path_tracer.integrator import render as jrender

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.core import rng as trng, vecmath as tvm
from tpu_path_tracer_torch.integrator import render as trender


def _states():
    """1e5 random uint32 states plus both ends of the range."""
    r = np.random.default_rng(0)
    rand = r.integers(0, 2 ** 32, 100_000, dtype=np.uint64)
    ends = np.concatenate([np.arange(0, 64, dtype=np.uint64),
                           np.arange(2 ** 32 - 64, 2 ** 32, dtype=np.uint64)])
    return np.concatenate([rand, ends]).astype(np.uint32)


def test_pcg_uniform_bit_exact():
    """Tolerance: none — states and floats equal bit for bit, three steps
    deep, including states next to 0 and 2**32."""
    s = _states()
    js = jnp.asarray(s)
    ts = torch.from_numpy(s.astype(np.int64))
    for _ in range(3):
        js, ju = jrng.uniform(js)
        ts, tu = trng.uniform(ts)
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts.numpy())
        np.testing.assert_array_equal(np.asarray(ju).view(np.uint32),
                                      tu.numpy().view(np.uint32))
    assert ts.dtype == torch.int64 and tu.dtype == torch.float32
    assert int(ts.min()) >= 0 and int(ts.max()) < 2 ** 32


def test_seed_bit_exact():
    pix = np.arange(0, 1 << 20, 97, dtype=np.uint32)
    for frame in (0, 1, 3, 719, 123_456_789):
        ref = np.asarray(jrng.seed(jnp.asarray(pix), jnp.int32(frame)))
        got = trng.seed(torch.from_numpy(pix.astype(np.int64)), frame)
        np.testing.assert_array_equal(ref.astype(np.int64), got.numpy())


def test_sampling_helpers_match():
    """cosine_wrt_z and uniform_in_unit_sphere: same states out, samples
    within 1e-6 (sin/cos/arccos implementations differ in the last ulp)."""
    s = _states()[:4096]
    for jf, tf in ((jrng.cosine_wrt_z, trng.cosine_wrt_z),
                   (jrng.uniform_in_unit_sphere,
                    trng.uniform_in_unit_sphere)):
        js, jd = jf(jnp.asarray(s))
        ts, td = tf(torch.from_numpy(s.astype(np.int64)))
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                      ts.numpy())
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-6)


def test_sqrt_is_correctly_rounded():
    x = np.random.default_rng(1).uniform(0, 4, 100_000).astype(np.float32)
    ref = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(tvm.sqrt(torch.from_numpy(x)).numpy(), ref)


def test_normalize_matches():
    """Tolerance: none — the reciprocal of a correctly rounded root, as
    in the JAX package, on ordinary, tiny and zero vectors."""
    r = np.random.default_rng(2)
    v = np.concatenate([r.normal(size=(5000, 3)),
                        r.normal(size=(100, 3)) * 1e-12,
                        np.zeros((4, 3))]).astype(np.float32)
    ref = np.asarray(jvm.normalize(jnp.asarray(v)))
    got = tvm.normalize(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cross_matches():
    """Within 1e-6: ``jnp.cross`` orders its products differently from the
    written-out form the port and both kernels use."""
    r = np.random.default_rng(3)
    a, b = r.normal(size=(2, 5000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tvm.cross(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jvm.cross(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)


def test_camera_rays_match():
    """Primary rays, plain and stratified jitter: the same advanced states
    and directions within 1e-7."""
    w, h = 16, 8
    cam = tpt.Camera(eye=[0.5, 0.0, 2.5], center=[0, 0, 0])
    pix = np.arange(w * h, dtype=np.uint32)
    jcfg = tpt.RenderConfig(width=w, height=h)
    tcfg = pt.RenderConfig(width=w, height=h)
    js = jrng.seed(jnp.asarray(pix), jnp.int32(5))
    tpix, tpx, tpy = trender.pixel_grid(w, h, "cpu")
    ts = trng.seed(tpix, 5)
    jpx = jnp.asarray(pix % w, jnp.int32)
    jpy = jnp.asarray(pix // w, jnp.int32)
    view = torch.as_tensor(cam.view_matrix)
    for off in (None, (1.0, 0.0)):
        jkw = {} if off is None else dict(
            sub_offset=(jnp.float32(off[0]), jnp.float32(off[1])),
            sub_scale=0.5)
        tkw = {} if off is None else dict(sub_offset=off, sub_scale=0.5)
        js2, jray = jrender.camera_rays(js, jnp.asarray(cam.view_matrix),
                                        jpx, jpy, jcfg, **jkw)
        ts2, tray = trender.camera_rays(ts, view, tpx, tpy, tcfg, **tkw)
        np.testing.assert_array_equal(np.asarray(js2).astype(np.int64),
                                      ts2.numpy())
        np.testing.assert_allclose(tray.dir.numpy(), np.asarray(jray.dir),
                                   rtol=0, atol=1e-7)
        np.testing.assert_array_equal(tray.origin.numpy(),
                                      np.asarray(jray.origin))
