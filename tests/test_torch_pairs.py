"""Port parity, ray-major pair sweeps: the chunk tables, the two sweeps'
plain versions and kernel source, the pair-bin and pair entry points and
their dispatch, against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages.  The
JAX Pallas kernels run in interpret mode, as ``tests/test_pallas.py`` runs
them; ``pack_tris`` runs op by op (``jax.disable_jit``), where it rounds
every operation as the port does.  Tolerances: a plain sweep against the
JAX kernel on the same pair arrays, the same hit rows and t within rtol 1e-4
/ atol 1e-5 (the JAX kernel's matrix products and the port's written-out
sums add the edge products in different orders, and t = tn / den is a
quotient of two sums that cancel: measured up to 1.8e-5 relative, on
grazing rows; the kernel's source is held to the plain version bit for bit
below); an entry point
against the walks, the same hit mask on every live lane, retired lanes -1,
t within rtol 1e-3 / atol 1e-4 (``tests/test_pallas.py:391-393``: the
edge-function form and Möller-Trumbore round differently on grazing hits).

Tests that need an NVIDIA GPU carry the ``cuda`` marker and skip here;
``python3 chip_smoke.py`` runs both kernels against their plain versions on
the card.
"""

import ctypes
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_path_tracer as tpt
import tpu_path_tracer.kernels.pallas.traversal as T
from tpu_path_tracer.kernels import traversal as jtrav
from tpu_path_tracer.scene import procedural as jproc

import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch.core import rng as trng
from tpu_path_tracer_torch.core import vecmath as vm
from tpu_path_tracer_torch.core.types import Ray
from tpu_path_tracer_torch.integrator.render import (path_trace_pixels,
                                                     pixel_grid)
from tpu_path_tracer_torch.kernels import hit, intersect
from tpu_path_tracer_torch.kernels import pair_sweep as ps
from tpu_path_tracer_torch.kernels import traversal
from tpu_path_tracer_torch.utils import profiling

T_MIN = 1e-4                  # tests/test_pallas.py:384
KERNEL_T_TOL = 1e-5           # kernel against its plain version
JAX_KERNEL_RTOL, JAX_KERNEL_ATOL = 1e-4, 1e-5
WALK_RTOL, WALK_ATOL = 1e-3, 1e-4
ENTRY_POINTS = {"pairbin": ps.pairbin_closest_hit,
                "pair": ps.pair_closest_hit}


def _mesh_scene(mesh, copies=1):
    """One white mesh (``copies`` times at the same place) behind a median
    BVH, built by the JAX package and carried to the port through numpy."""
    b = tpt.SceneBuilder()
    white = b.add_material("white", tpt.LAMBERTIAN, [0.7, 0.7, 0.7])
    for _ in range(copies):
        b.add_mesh(mesh, white)
    jscene, meta = b.build(bvh="median")
    tscene = pt.scene_from_numpy(jax.tree.map(np.asarray, jscene), "cpu")
    return jscene, tscene, meta


def _pair_bundle():
    """tests/test_pallas.py:359-378: icosphere 5, 2048 rays, half primaries
    from (0, 0, 3) and half leaving the surface, every fifth retired."""
    k = np.random.default_rng(7)
    n = 2048
    origin = np.tile(np.array([[0.0, 0.0, 3.0]], np.float32), (n, 1))
    half = n // 2
    sph = k.normal(size=(half, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    origin[half:] = (sph * 0.81).astype(np.float32)
    target = k.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.where((np.arange(n) % 5) == 0, -3e38, 1e9).astype(np.float32)
    return 5, origin, d, t0


def _pairbin_bundle():
    """tests/test_pallas.py:409-425: icosphere 4, 4096 bounce-like rays
    (origins on the mesh, random directions), every fifth retired."""
    k = np.random.default_rng(3)
    n = 4096
    op = k.normal(size=(n, 3))
    op /= np.linalg.norm(op, axis=1, keepdims=True)
    origin = (op * 0.81).astype(np.float32)
    d = k.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full((n,), 1e9, np.float32)
    t0[::5] = -3e38
    return 4, origin, d.astype(np.float32), t0


BUNDLES = {"pair": _pair_bundle, "pairbin": _pairbin_bundle}


def _walks(sub, o, d, t0):
    """The scene of a bundle and both packages' skip-link walks on it."""
    jscene, tscene, meta = _mesh_scene(jproc.icosphere(sub, 0.8))
    jt, ji = jtrav.bvh_closest_hit(
        jnp.asarray(o), jnp.asarray(d), jscene.bvh, jscene.triangles, T_MIN,
        jnp.asarray(t0), meta.max_leaf)
    tt, ti = traversal.bvh_closest_hit(
        torch.from_numpy(o), torch.from_numpy(d), tscene.bvh,
        tscene.triangles, T_MIN, torch.from_numpy(t0), meta.max_leaf)
    return jscene, tscene, (np.asarray(jt), np.asarray(ji)), (tt.numpy(),
                                                              ti.numpy())


def _assert_same_hits(got, ref, t0, min_hits):
    """The entry points' contract against a walk."""
    (t_got, i_got), (t_ref, i_ref) = got, ref
    live = t0 > 0
    assert np.all(i_got[~live] == -1)
    np.testing.assert_array_equal((i_got >= 0)[live], (i_ref >= 0)[live])
    hit = (i_ref >= 0) & live
    np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=WALK_RTOL,
                               atol=WALK_ATOL)
    assert hit.sum() > min_hits


# ------------------------------------------------------------ the tables


def test_pack_tris_equals_jax():
    """The chunk tables and boxes against the JAX ``pack_tris`` run op by
    op, bit for bit: each edge's rows 0-5, the t column's rows 0-3, and the
    chunk boxes, on a mesh off the origin whose last chunk is padded."""
    mesh = jproc.icosphere(2, 0.5)
    mesh = type(mesh)(vertices=mesh.vertices + np.float32([0.3, -0.2, 0.1]),
                      normals=mesh.normals)
    jscene, tscene, _ = _mesh_scene(mesh)
    assert jscene.triangles.count == 320           # 3 chunks, 64 padded
    with jax.disable_jit():
        e0, e1, e2, tcol, cmin, cmax = (np.asarray(x) for x in
                                        T.pack_tris(jscene.triangles))
    packed = ps.pack_tris(tscene.triangles)
    table = packed.table.numpy()
    assert table.shape == (3, ps.TABLE_ROWS, ps.TRI_CHUNK)
    for k, e in enumerate((e0, e1, e2)):
        np.testing.assert_array_equal(table[:, 6 * k:6 * k + 6], e[:3, :6],
                                      err_msg=f"e{k}")
    np.testing.assert_array_equal(table[:, 18:22], tcol[:3, :4])
    np.testing.assert_array_equal(packed.cmin.numpy(), cmin)
    np.testing.assert_array_equal(packed.cmax.numpy(), cmax)
    assert not table[2, :, 64:].any()              # the padding columns
    assert np.abs(table[:, 21]).max() > 0


# ------------------------------------------- plain sweeps and JAX kernels


class _Recorder:
    """Stands in for a sweep wrapper: runs it and keeps every call's
    arguments and results."""

    def __init__(self, sweep):
        self.sweep = sweep
        self.calls = []

    def __call__(self, *args):
        out = self.sweep(*args)
        self.calls.append((args, out))
        return out


def _recorded(monkeypatch, route, tscene, o, d, t0):
    """One call of an entry point with its sweep recorded."""
    name = f"{route}_sweep"
    rec = _Recorder(getattr(ps, name))
    monkeypatch.setattr(ps, name, rec)
    ENTRY_POINTS[route](torch.from_numpy(o), torch.from_numpy(d), tscene.bvh,
                        tscene.triangles, T_MIN, torch.from_numpy(t0))
    assert rec.calls
    return rec.calls


def _small_bundle(n=384, seed=11):
    k = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, 3.0]], np.float32), (n, 1))
    sph = k.normal(size=(n // 2, 3))
    sph /= np.linalg.norm(sph, axis=1, keepdims=True)
    o[n // 2:] = (sph * 0.81).astype(np.float32)
    d = k.uniform(-1, 1, (n, 3)).astype(np.float32) * 0.8 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.where(np.arange(n) % 7 == 0, -3e38, 1e9).astype(np.float32)
    return o, d.astype(np.float32), t0


def _jax_layout(jscene, pair_dm, pair_o1, seg_id, dummy):
    """The recorded pair arrays as the JAX kernels take them: padded to the
    grid step's 512 rows with dummy segments, beside the combined table."""
    with jax.disable_jit():
        e0, e1, e2, tcol, cmin, cmax = T.pack_tris(jscene.triangles)
        etab = T._combined_table(e0, e1, e2, tcol)
    rows = pair_dm.shape[0]
    pad = -rows % (T.PAIR_SLOT * T.PAIR_SEGS)
    dm = np.pad(pair_dm.numpy(), ((0, pad), (0, 0)))
    o1 = np.pad(pair_o1.numpy(), ((0, pad), (0, 0)))
    seg = np.pad(seg_id.numpy(), (0, pad // T.PAIR_SLOT),
                 constant_values=dummy)
    return (jnp.asarray(dm), jnp.asarray(o1), jnp.asarray(seg), etab, cmin,
            cmax, rows)


def test_pair_sweep_plain_matches_jax_kernel(monkeypatch):
    """The pair sweep's plain version against the JAX ``_pair_sweep`` kernel
    (interpret mode) on the pair arrays of the first two rounds of a real
    emission: the same rows hit, t within rtol 1e-4 / atol 1e-5."""
    jscene, tscene, _ = _mesh_scene(jproc.icosphere(3, 0.8))
    calls = _recorded(monkeypatch, "pair", tscene, *_small_bundle())
    assert len(calls) >= 2
    n_chunks = jscene.triangles.count // ps.TRI_CHUNK
    for (pair_dm, pair_o1, seg_cid, table, t_min), (t, idx) in calls[:2]:
        dm, o1, seg, etab, _, _, rows = _jax_layout(
            jscene, pair_dm, pair_o1, seg_cid, n_chunks)
        jt, ji = T._pair_sweep(dm, o1, seg, etab, t_min, True)
        jt, ji = np.asarray(jt)[:rows, 0], np.asarray(ji)[:rows, 0]
        hit = idx.numpy() >= 0
        # The JAX kernel marks a row without a hit by t alone (its index
        # row then holds the chunk's first triangle).
        np.testing.assert_array_equal(jt < 1e30, hit)
        np.testing.assert_allclose(t.numpy()[hit], jt[hit],
                                   rtol=JAX_KERNEL_RTOL,
                                   atol=JAX_KERNEL_ATOL)
        assert hit.sum() > 50
        assert (idx.numpy()[hit] == ji[hit]).mean() > 0.99


def test_pairbin_sweep_plain_matches_jax_kernel(monkeypatch):
    """The pair-bin sweep's plain version against the JAX ``_pairbin_sweep``
    kernel (interpret mode) on the pair arrays of a real emission: every
    row's t within rtol 1e-4 / atol 1e-5 (a row that found nothing returns
    its cap in both), the same rows with an index."""
    jscene, tscene, _ = _mesh_scene(jproc.icosphere(3, 0.8))
    (args, (t, idx)), = _recorded(monkeypatch, "pairbin", tscene,
                                  *_small_bundle())
    pair_dm, pair_o1, seg_bid, boxes, table, t_min = args
    n_chunks = jscene.triangles.count // ps.TRI_CHUNK
    n_pb = -(-n_chunks // T.PAIR_G)
    dm, o1, seg, etab, cmin, cmax, rows = _jax_layout(
        jscene, pair_dm, pair_o1, seg_bid, n_pb)
    fill = n_pb * T.PAIR_G - n_chunks
    boxes_flat = jnp.concatenate(
        [jnp.pad(cmin, ((0, fill), (0, 0)), constant_values=1e30),
         jnp.pad(cmax, ((0, fill), (0, 0)), constant_values=1e30)],
        axis=1).reshape(-1)
    np.testing.assert_array_equal(
        boxes.numpy(), np.asarray(boxes_flat).reshape(-1, 6)[:n_chunks])
    jt, ji = T._pairbin_sweep(dm, o1, seg, boxes_flat, etab, t_min, n_pb,
                              True)
    jt, ji = np.asarray(jt)[:rows, 0], np.asarray(ji)[:rows, 0]
    hit = idx.numpy() >= 0
    np.testing.assert_array_equal(ji < 1e30, hit)
    np.testing.assert_allclose(t.numpy(), jt, rtol=JAX_KERNEL_RTOL,
                               atol=JAX_KERNEL_ATOL)
    assert hit.sum() > 50
    assert (idx.numpy()[hit] == ji[hit]).mean() > 0.99


# ------------------------------------------------------ the entry points


@pytest.fixture(scope="module", params=["pair", "pairbin"])
def bundle_case(request):
    """A JAX test bundle with both walks' answers and the JAX entry
    point's (interpret mode; the pair-bin path forced as
    ``tests/test_pallas.py:430`` forces it)."""
    route = request.param
    sub, o, d, t0 = BUNDLES[route]()
    jscene, tscene, jwalk, twalk = _walks(sub, o, d, t0)
    args = (jnp.asarray(o), jnp.asarray(d), jscene.bvh,
            T.pack_tris(jscene.triangles), jnp.asarray(t0))
    kw = dict(t_min=T_MIN, n_tris=int(jscene.triangles.count),
              interpret=True)
    if route == "pair":
        jt, ji = T.pair_closest_hit(*args, **kw)
    else:
        jax.clear_caches()
        before = T.PAIR_DISPATCH_KMAX
        T.PAIR_DISPATCH_KMAX = -1
        try:
            jt, ji = T.tile_closest_hit(*args, **kw)
            jt, ji = np.asarray(jt), np.asarray(ji)
        finally:
            T.PAIR_DISPATCH_KMAX = before
            jax.clear_caches()  # don't leak the forced-dispatch trace
    return route, tscene, (o, d, t0), jwalk, twalk, (np.asarray(jt),
                                                     np.asarray(ji))


def _pairs(call):
    """Pairs a recorded launch served: the rows that carry the 1 of
    ``[o, 1]`` (padding rows are zero)."""
    return int((call[0][1][:, 3] != 0).sum())


def test_entry_point_matches_jax_and_the_walk(bundle_case, monkeypatch):
    """``pair_closest_hit`` and ``pairbin_closest_hit`` on the JAX tests'
    bundles against the JAX entry point and against the port's walk (and
    through it the JAX walk, which it equals): the same hit mask on every
    live lane, retired lanes -1, t within rtol 1e-3 / atol 1e-4."""
    route, tscene, (o, d, t0), jwalk, twalk, jgot = bundle_case
    np.testing.assert_array_equal(twalk[1], jwalk[1])
    rec = _Recorder(getattr(ps, f"{route}_sweep"))
    monkeypatch.setattr(ps, f"{route}_sweep", rec)
    t, i = ENTRY_POINTS[route](
        torch.from_numpy(o), torch.from_numpy(d), tscene.bvh,
        tscene.triangles, T_MIN, torch.from_numpy(t0))
    got = (t.numpy(), i.numpy())
    assert i.dtype == torch.int64
    assert np.all(got[0][got[1] < 0] == np.float32(intersect.INF))
    _assert_same_hits(got, twalk, t0, 300)
    # The JAX entry points leave t untouched on a miss; hold t on the hits.
    _assert_same_hits(got, jgot, t0, 300)
    if route == "pair":     # rounds, each serving fewer rays than the last
        assert len(rec.calls) > 1
        assert _pairs(rec.calls[0]) > _pairs(rec.calls[-1]) > 0
    else:                   # one shot
        assert len(rec.calls) == 1 and _pairs(rec.calls[0]) > 0


def _stacked_plates(layers=24, cells=16):
    """``layers`` small square plates of 2 * cells^2 triangles stacked
    along z, farther apart than they are wide, so the BVH order keeps each
    plate together: a ray along z meets the box of every plate."""
    g = np.linspace(-0.05, 0.05, cells + 1, dtype=np.float32)
    x0, y0 = (a.reshape(-1) for a in np.meshgrid(g[:-1], g[:-1]))
    x1, y1 = (a.reshape(-1) for a in np.meshgrid(g[1:], g[1:]))
    tris = []
    for k in range(layers):
        z = np.full_like(x0, 0.08 * k)
        p00, p10 = np.stack([x0, y0, z], 1), np.stack([x1, y0, z], 1)
        p01, p11 = np.stack([x0, y1, z], 1), np.stack([x1, y1, z], 1)
        tris += [np.stack([p00, p10, p11], 1), np.stack([p00, p11, p01], 1)]
    v = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    nrm = np.tile(np.float32([0, 0, 1]), (v.shape[0], 1))
    return tpt.MeshData(vertices=v, normals=nrm)


def test_pairbin_emits_beyond_the_jax_candidate_budget(monkeypatch):
    """Rays with more candidate bins than the JAX path's ``PAIRBIN_K`` = 16
    (where JAX sends the whole batch to its tile sweep): the port emits
    every candidate and still answers like the walk.  Rays along z from
    below the stack aim past every plate's box but end at the first
    plate; rays from the side graze many."""
    jscene, tscene, meta = _mesh_scene(_stacked_plates())
    k = np.random.default_rng(2)
    n = 512
    o = np.concatenate([
        np.stack([k.uniform(-0.045, 0.045, n // 2),
                  k.uniform(-0.045, 0.045, n // 2),
                  np.full(n // 2, -1.0)], 1),
        np.stack([np.full(n // 2, -1.5), k.uniform(-0.04, 0.04, n // 2),
                  k.uniform(0.0, 1.8, n // 2)], 1)]).astype(np.float32)
    target = np.stack([k.uniform(-0.045, 0.045, n),
                       k.uniform(-0.045, 0.045, n),
                       k.uniform(0.0, 1.9, n)], 1)
    target[:n // 2, :2] = o[:n // 2, :2] + k.normal(0, 0.002, (n // 2, 2))
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t0 = np.full(n, 1e9, np.float32)
    t0[::9] = -3e38
    args = (torch.from_numpy(o), torch.from_numpy(d), tscene.bvh,
            tscene.triangles, T_MIN, torch.from_numpy(t0))
    tw, iw = traversal.bvh_closest_hit(*args, meta.max_leaf)
    rec = _Recorder(ps.pairbin_sweep)
    monkeypatch.setattr(ps, "pairbin_sweep", rec)
    t, i = ps.pairbin_closest_hit(*args)
    packed = ps.pack_tris(tscene.triangles)
    cap = torch.minimum(args[5], ps.scene_diam(args[0], packed.cmin,
                                               packed.cmax))
    bmin, bmax = ps.superchunk_boxes(packed.cmin, packed.cmax, ps.PAIR_G)
    per_ray = (ps.slab_entries(args[0][:, None], ps.inv_dir(args[1])[:, None],
                               cap[:, None], bmin[None], bmax[None])
               < 1e30).sum(dim=1)
    assert int(per_ray.max()) > T.PAIRBIN_K
    assert len(rec.calls) == 1
    assert _pairs(rec.calls[0]) == int(per_ray.sum())
    _assert_same_hits((t.numpy(), i.numpy()), (tw.numpy(), iw.numpy()), t0,
                      200)
    tp, ip = ps.pair_closest_hit(*args)
    _assert_same_hits((tp.numpy(), ip.numpy()), (tw.numpy(), iw.numpy()), t0,
                      200)


def test_no_candidates_is_all_miss():
    """Rays that reach no box, and retired lanes only: both entry points
    return the miss of ``closest_hit`` without a sweep."""
    _, tscene, _ = _mesh_scene(jproc.icosphere(2, 0.8))
    o = torch.tensor([[0.0, 0.0, 3.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t0 = torch.tensor([1e9, -3e38])
    for fn in ENTRY_POINTS.values():
        t, i = fn(o, d, tscene.bvh, tscene.triangles, T_MIN, t0)
        assert i.tolist() == [-1, -1]
        assert t.tolist() == [intersect.INF] * 2


# --------------------------------------------------------------- dispatch


def _mirror_sphere_scene():
    """bench.py:301's mesh scene at subdivision 3, on the CPU."""
    b = pt.SceneBuilder()
    b.add_material("default", pt.LAMBERTIAN, [1, 0, 0])
    white = b.add_material("white", pt.LAMBERTIAN, [0.73, 0.73, 0.73])
    light = b.add_material("light", pt.LAMBERTIAN, [0, 0, 0],
                           emission=[2, 2, 2])
    mirror = b.add_material("mirror", pt.MIRROR, [0.9, 0.9, 0.9])
    b.add_quad([-2, -2, -2], [4, 0, 0], [0, 4, 0], white)
    b.add_quad([-2, 2, -2], [4, 0, 0], [0, 0, 4], light)
    b.add_quad([-2, -2, 2], [4, 0, 0], [0, 0, -4], white)
    b.add_mesh(pt.procedural.icosphere(subdivisions=3, radius=0.8), mirror)
    return b.build(bvh="median", device="cpu")


@pytest.mark.parametrize("route", ["pairbin", "pair"])
def test_pair_dispatch_routes_find_hit(route, monkeypatch):
    """The named pair sweep's entry point in place of
    ``traversal.closest_hit`` (the BVH walk) answers ``find_hit``'s BVH
    search on the same rays: the sweep's wrapper is called, the winners'
    primitive types equal the walk's on every lane and their triangle
    indices on more than 98% of them, and a 16x16 frame (3 bounces, NEE)
    keeps its mean within 1%."""
    scene, meta = _mirror_sphere_scene()
    cfg = pt.RenderConfig(width=16, height=16, max_bounces=3,
                          importance_sampling=True)
    o, d, _ = _small_bundle(256, seed=5)
    ray = Ray(torch.from_numpy(o), torch.from_numpy(d))
    state = trng.seed(torch.arange(256), 1)
    alive = torch.arange(256) % 4 != 0
    view = torch.as_tensor(pt.Camera(eye=[0, 0, 3.2],
                                     center=[0, 0, 0]).view_matrix)
    pix, px, py = pixel_grid(16, 16, "cpu")

    def run():
        _, ptype, pidx, _ = hit.find_hit(state, ray, scene, meta, cfg,
                                         alive=alive)
        _, rad = path_trace_pixels(trng.seed(pix, 3), view, px, py, scene,
                                   meta, cfg)
        return ptype.numpy(), pidx.numpy(), rad.numpy()

    ptype_w, pidx_w, rad_w = run()
    rec = _Recorder(getattr(ps, f"{route}_sweep"))
    monkeypatch.setattr(ps, f"{route}_sweep", rec)
    monkeypatch.setattr(traversal, "closest_hit",
                        getattr(ps, f"{route}_closest_hit"))
    ptype, pidx, rad = run()
    assert rec.calls
    np.testing.assert_array_equal(ptype, ptype_w)
    assert (ptype == hit.TRIANGLE).sum() > 20
    assert (pidx == pidx_w).mean() > 0.98
    assert np.all(ptype[~alive.numpy()] == hit.MISS)
    np.testing.assert_allclose(rad.mean(0), rad_w.mean(0), rtol=1e-2)


def test_sweeps_refuse_other_devices():
    """A tensor that lies neither on the CPU nor on a CUDA device raises;
    nothing falls back to the plain versions."""
    _, tscene, _ = _mesh_scene(jproc.icosphere(2, 0.8))
    packed = ps.pack_tris(tscene.triangles)
    meta_rows = torch.zeros((128, 8), device="meta")
    seg = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="no route for device meta"):
        ps.pair_sweep(meta_rows, meta_rows, seg, packed.table, T_MIN)
    with pytest.raises(ValueError, match="no route for device meta"):
        ps.pairbin_sweep(meta_rows, meta_rows, seg,
                         torch.cat([packed.cmin, packed.cmax], 1),
                         packed.table, T_MIN)


# ---------------------------------------------- the kernels' source on CPU

# csrc/pair_sweep.cu and csrc/pair_emit.cu keep their row code in
# __host__ __device__ functions and, built without nvcc, leave out the
# kernels and add host entry points that run each kernel's blocks and lanes
# in order with the same functions.
def build_host_sweeps(out_dir, csrc_dir):
    """Compile ``csrc_dir``'s pair sources (the sweeps and the emission)
    with g++ as they are; returns the loaded library, or None without
    g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    # -ffp-contract=off: no a*b+c contraction, as nvcc's --fmad=false.
    subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off",
                    "-shared", "-fPIC", "-x", "c++", "-o",
                    str(out_dir / "host_sweeps.so"),
                    str(csrc_dir / "pair_sweep.cu"),
                    str(csrc_dir / "pair_emit.cu")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out_dir / "host_sweeps.so"))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_pair_sweep_host.argtypes = [p, p, p, p, i, i, f, f, p, p]
    lib.tpt_pairbin_sweep_host.argtypes = [p, p, p, p, p, i, i, i, f, p, p]
    lib.tpt_pair_sweep_host.restype = None
    lib.tpt_pairbin_sweep_host.restype = None
    return lib


@pytest.fixture(scope="module")
def host_sweeps(tmp_path_factory):
    csrc = pathlib.Path(ps.__file__).resolve().parent.parent / "csrc"
    lib = build_host_sweeps(tmp_path_factory.mktemp("host_sweeps"), csrc)
    if lib is None:
        pytest.skip("needs a C++ compiler (g++)")
    return lib


def _with_dummy_segment(seg, dummy, *rows):
    """The recorded arrays with one dummy segment appended, whose rows hold
    a live-looking ray that must come back untouched."""
    seg = torch.cat([seg, torch.tensor([dummy], dtype=torch.int32)])
    return (seg,) + tuple(torch.cat([x, x[:ps.TRI_CHUNK]]) for x in rows)


def _host_and_plain(host_sweeps, route, args):
    """One launch's arguments through the kernels' code built for the CPU
    and through the plain version: ((t, idx) of the build, (t, idx) of the
    plain version)."""
    pair_dm, pair_o1, seg = args[:3]
    table, t_min = args[-2:]
    n_chunks = table.shape[0]
    n_bins = -(-n_chunks // ps.PAIR_G)
    n_segs = seg.shape[0]
    t = torch.full((n_segs * ps.TRI_CHUNK,), intersect.INF)
    i = torch.full((n_segs * ps.TRI_CHUNK,), -1, dtype=torch.int32)
    if route == "pair":
        ref = ps.pair_sweep_plain(pair_dm, pair_o1, seg, table, t_min)
        host_sweeps.tpt_pair_sweep_host(
            pair_dm.data_ptr(), pair_o1.data_ptr(), seg.data_ptr(),
            table.data_ptr(), n_segs, n_chunks, t_min, intersect.INF,
            t.data_ptr(), i.data_ptr())
    else:
        boxes = args[3].contiguous()
        ref = ps.pairbin_sweep_plain(pair_dm, pair_o1, seg, boxes, table,
                                     t_min)
        host_sweeps.tpt_pairbin_sweep_host(
            pair_dm.data_ptr(), pair_o1.data_ptr(), seg.data_ptr(),
            boxes.data_ptr(), table.data_ptr(), n_segs, n_bins, n_chunks,
            t_min, t.data_ptr(), i.data_ptr())
    return (t, i), ref


@pytest.mark.parametrize("route", ["pair", "pairbin"])
def test_pair_kernel_source_on_cpu(route, host_sweeps, monkeypatch):
    """The kernels' per-row code, built for the CPU, against the plain
    versions on the pair arrays of a real emission with a dummy segment
    appended: every index and every bit of t.  (A mutation that fails it:
    summing den as s0 + (s1 + s2) in csrc/pair_sweep.cu moves t by an ulp
    on a share of the rows.)"""
    _, tscene, _ = _mesh_scene(jproc.icosphere(4, 0.8))
    o, d, t0 = _small_bundle(1024, seed=13)
    calls = _recorded(monkeypatch, route, tscene, o, d, t0)
    hits = 0
    for args, _ in calls[:3]:
        n_chunks = args[-2].shape[0]
        dummy = n_chunks if route == "pair" else -(-n_chunks // ps.PAIR_G)
        seg, pair_dm, pair_o1 = _with_dummy_segment(args[2], dummy, args[0],
                                                    args[1])
        (t, i), ref = _host_and_plain(host_sweeps, route,
                                      (pair_dm, pair_o1, seg) + args[3:])
        np.testing.assert_array_equal(i.numpy(), ref[1].numpy())
        np.testing.assert_array_equal(t.numpy(), ref[0].numpy())
        hits += int((i[:-ps.TRI_CHUNK] >= 0).sum())
        assert (i[-ps.TRI_CHUNK:] == -1).all()
        assert (t[-ps.TRI_CHUNK:] == intersect.INF).all()
    assert hits > 300


def _rows_of(o, d, bound):
    """Pair rows (pair_dm, pair_o1) of float32 numpy rays, as the emission
    lays them out."""
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    n = o.shape[0]
    return (torch.cat([d, vm.cross(o, d), torch.from_numpy(bound)[:, None],
                       torch.zeros((n, 1))], 1),
            torch.cat([o, torch.ones((n, 1)), torch.zeros((n, 4))], 1))


def _key_chunks(route, key, n_chunks):
    """The chunks a segment of ``key`` reads."""
    if route == "pair":
        return [key]
    return [c for c in range(key * ps.PAIR_G, (key + 1) * ps.PAIR_G)
            if c < n_chunks]


def _tie_share(route, args):
    """Share of the rows with a hit below their bound whose least t over
    their key's chunks is reached by two or more triangles."""
    pair_dm, pair_o1, seg = args[:3]
    table, t_min = args[-2:]
    n_segs = seg.shape[0]
    dm = pair_dm.reshape(n_segs, ps.TRI_CHUNK, 8)
    o1 = pair_o1.reshape(n_segs, ps.TRI_CHUNK, 8)
    tied = hit = 0
    for s in range(n_segs):
        rows = slice(s, s + 1)
        tm = torch.cat([ps._edge_tests(dm[rows], o1[rows], table[c:c + 1],
                                       t_min, dm[rows, :, 6])
                        for c in _key_chunks(route, int(seg[s]),
                                             table.shape[0])], dim=2)
        least = tm.amin(dim=2, keepdim=True)
        has = least[..., 0] < 1e30
        hit += int(has.sum())
        tied += int((has & ((tm == least).sum(dim=2) >= 2)).sum())
    return tied / max(hit, 1)


def _segment_case(case, route, monkeypatch):
    """The launches of one segment case for ``route``: (list of sweep
    arguments, a check of the results of the first)."""
    mesh = jproc.icosphere(3, 0.8)     # 10 chunks: bins of 4, 4 and 2
    _, tscene, _ = _mesh_scene(mesh, copies=2 if case == "tie" else 1)
    if case == "single_row":
        # Rows far above the mesh looking up reach no box; row 57 looks at
        # triangle 261 (chunk 2) from outside.
        tris = tscene.triangles
        centre = ((tris.a[261] + tris.b[261] + tris.c[261]) / 3).numpy()
        o = np.tile(np.float32([0.0, 0.0, 5.0]), (ps.TRI_CHUNK, 1))
        o[:, :2] += np.linspace(-0.5, 0.5, ps.TRI_CHUNK,
                                dtype=np.float32)[:, None]
        d = np.tile(np.float32([0.0, 0.0, 1.0]), (ps.TRI_CHUNK, 1))
        o[57] = 2.0 * centre
        d[57] = -centre / np.linalg.norm(centre)
        pair_dm, pair_o1 = _rows_of(o, d, np.full(ps.TRI_CHUNK, 1e9,
                                                  np.float32))
        packed = ps.pack_tris(tris)
        reach = ps.slab_entries(pair_o1[:, None, :3],
                                ps.inv_dir(pair_dm[:, :3])[:, None],
                                pair_dm[:, None, 6], packed.cmin[None],
                                packed.cmax[None]) < 1e30
        assert reach[:, 2].sum() == 1 and reach[57, 2]
        seg = torch.tensor([2 if route == "pair" else 0], dtype=torch.int32)
        args = (pair_dm, pair_o1, seg)
        if route == "pairbin":
            args += (torch.cat([packed.cmin, packed.cmax], 1),)
        args += (packed.table, T_MIN)

        def check(t, i):
            assert i[57] >= 0 and (i[torch.arange(ps.TRI_CHUNK) != 57]
                                   == -1).all()
        return [args], check
    calls = _recorded(monkeypatch, route, tscene, *_small_bundle(512, 17))
    launches = [args for args, _ in calls[:2]]
    n_chunks = launches[0][-2].shape[0]
    n_keys = n_chunks if route == "pair" else -(-n_chunks // ps.PAIR_G)
    if case == "dummy":
        args = launches[0]
        seg, pair_dm, pair_o1 = _with_dummy_segment(args[2], n_keys,
                                                    args[0], args[1])
        seg, pair_dm, pair_o1 = _with_dummy_segment(seg, -1, pair_dm,
                                                    pair_o1)
        launches = [(pair_dm, pair_o1, seg) + args[3:]]

        def check(t, i):
            tail = slice(-2 * ps.TRI_CHUNK, None)
            assert (i[tail] == -1).all() and (t[tail] == intersect.INF).all()
            assert (i[:-2 * ps.TRI_CHUNK] >= 0).sum() > 50
    elif case == "partial_bin":
        # The keys of the last bin's chunks 8 and 9.
        first = (n_chunks - n_chunks % ps.PAIR_G if route == "pair"
                 else n_keys - 1)
        last = list(range(first, n_keys))
        assert n_chunks % ps.PAIR_G == 2 and len(last) == (
            2 if route == "pair" else 1)
        seg = launches[0][2]

        def check(t, i):
            rows = torch.isin(seg, torch.tensor(last, dtype=torch.int32))
            assert rows.any()
            assert (i.reshape(-1, ps.TRI_CHUNK)[rows] >= 0).sum() > 0
    else:
        assert n_chunks == 20
        assert _tie_share(route, launches[0]) > 0.5

        def check(t, i):
            assert (i >= 0).sum() > 50
    return launches, check


@pytest.mark.parametrize("route", ["pair", "pairbin"])
@pytest.mark.parametrize("case", ["dummy", "partial_bin", "single_row",
                                  "tie"])
def test_pair_kernel_segments_on_cpu(case, route, host_sweeps, monkeypatch):
    """The kernels' code, built for the CPU, against the plain versions on
    the segments the redesign must keep: dummy segments (ids past the last
    key and -1) beside real ones, segments of a partial last bin (10 chunks:
    bins of 4, 4 and 2), a segment in which a single row reaches a chunk
    (the pair-bin vote), and a mesh added twice, where most hits are exact
    ties between two triangles: every index and every bit of t."""
    launches, check = _segment_case(case, route, monkeypatch)
    for n, args in enumerate(launches):
        (t, i), ref = _host_and_plain(host_sweeps, route, args)
        np.testing.assert_array_equal(i.numpy(), ref[1].numpy())
        np.testing.assert_array_equal(t.numpy(), ref[0].numpy())
        if n == 0:
            check(t, i)


def _assert_same_rows(got, ref):
    """Two emissions' rows, row for row: segment keys, the ray of each row,
    and both row arrays bit for bit."""
    np.testing.assert_array_equal(got.seg.numpy(), ref.seg.numpy())
    np.testing.assert_array_equal(got.ray.numpy(), ref.ray.numpy())
    for x, y in ((got.pair_dm, ref.pair_dm), (got.pair_o1, ref.pair_o1)):
        np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                      y.numpy().view(np.uint32))


def _pairbin_emission_args(tscene, o, d, t0):
    """The pair-bin entry point's emission arguments (o, d, cap, bmin,
    bmax) for float32 numpy rays."""
    o, d, tb = ps._rays(*(torch.from_numpy(x) for x in (o, d, t0)))
    packed = ps.pack_tris(tscene.triangles)
    cap = torch.minimum(tb, ps.scene_diam(o, packed.cmin, packed.cmax))
    return (o, d, cap) + ps.superchunk_boxes(packed.cmin, packed.cmax,
                                             ps.PAIR_G)


@pytest.mark.parametrize("case", ["partial_last_bin", "full_bins",
                                  "empty", "partial_last_block"])
def test_pairbin_emission_source_on_cpu(case, host_sweeps):
    """csrc/pair_emit.cu's pair-bin emission built for the CPU (the same
    Python steps as on the card, the host entry points in place of the
    kernels) against the torch emission, row for row: which segment serves
    which bin, the ray of each row and both row arrays bit for bit; then
    the reduction to rays against its plain version on the sweep's rows.
    Icosphere 3 has 10 chunks, so its last bin holds 2; icosphere 4 has 10
    full bins; the empty case's rays reach no box; 300 rays leave the last
    256-ray histogram cell partial."""
    sub = 4 if case == "full_bins" else 3
    _, tscene, _ = _mesh_scene(jproc.icosphere(sub, 0.8))
    n_rays = 300 if case == "partial_last_block" else 512
    o, d, t0 = _small_bundle(n_rays, seed=19)
    if case == "empty":
        o[:] = [0.0, 0.0, 3.0]
        d[:] = [0.0, 0.0, 1.0]
    args = _pairbin_emission_args(tscene, o, d, t0)
    lib = ps._EmitLib(host_sweeps, "_host")
    got = ps._emit_pairbin_on(lib, *args)
    ref = ps.emit_pairbin_plain(*args)
    _assert_same_rows(got, ref)
    if case == "empty":
        assert got.ray.shape[0] == 0
        return
    assert (got.ray >= 0).sum() > n_rays
    assert (got.seg == args[3].shape[0] - 1).any()   # the last bin
    assert (got.pair_o1[got.ray < 0] == 0).all()
    assert (got.pair_o1[got.ray >= 0, 3] == 1).all()
    packed = ps.pack_tris(tscene.triangles)
    t_row, i_row = ps.pairbin_sweep_plain(
        got.pair_dm, got.pair_o1, got.seg,
        torch.cat([packed.cmin, packed.cmax], 1), packed.table, T_MIN)
    tb = torch.from_numpy(t0)
    n = tb.shape[0]
    t_out = torch.empty(n)
    i_out = torch.empty(n, dtype=torch.int64)
    ps._best_on(lib, got, t_row, i_row, n, False, t_best0=tb, t_out=t_out,
                i_out=i_out)
    t_ref, i_ref = ps.pairbin_best_plain(got, t_row, i_row, tb)
    np.testing.assert_array_equal(i_out.numpy(), i_ref.numpy())
    np.testing.assert_array_equal(t_out.numpy(), t_ref.numpy())
    assert (i_ref >= 0).sum() > 100


def test_pair_emission_source_on_cpu(host_sweeps, monkeypatch):
    """csrc/pair_emit.cu's pair-round emission and advance built for the
    CPU against the torch ones, round by round, on the states of a real
    ``pair_closest_hit`` call over icosphere 3 (10 chunks): the rows row
    for row and bit for bit, then the state after the advance (running
    best, index, candidates taken) equal; the last round emits nothing in
    both."""
    hits = _check_pair_emission(host_sweeps, monkeypatch, 512)
    assert hits[0] > 50 and all(h > 0 for h in hits[1:])


def test_pair_emission_partial_block_on_cpu(host_sweeps, monkeypatch):
    """The same with 300 rays: the last 256-ray histogram cell partial."""
    hits = _check_pair_emission(host_sweeps, monkeypatch, 300)
    assert hits[0] > 50


def _check_pair_emission(host_sweeps, monkeypatch, n_rays):
    """The checks of the pair emission tests on ``n_rays`` rays; returns
    the hits found by each swept round's advance."""
    _, tscene, _ = _mesh_scene(jproc.icosphere(3, 0.8))
    o, d, t0 = _small_bundle(n_rays, seed=23)
    rounds = []
    emit, advance = ps.emit_pair, ps.pair_advance

    def recording_emit(*args):
        rows = emit(*args)
        rounds.append([[x.clone() if torch.is_tensor(x) else x
                        for x in args], rows])
        return rows

    def recording_advance(rows, t_row, i_row, *state):
        rounds[-1].append((t_row, i_row))
        advance(rows, t_row, i_row, *state)

    monkeypatch.setattr(ps, "emit_pair", recording_emit)
    monkeypatch.setattr(ps, "pair_advance", recording_advance)
    ps.pair_closest_hit(torch.from_numpy(o), torch.from_numpy(d), tscene.bvh,
                        tscene.triangles, T_MIN, torch.from_numpy(t0))
    assert len(rounds) >= 3 and rounds[-1][1].ray.shape[0] == 0
    lib = ps._EmitLib(host_sweeps, "_host")
    hits = []
    for args, ref, *swept in rounds:
        got = ps._emit_pair_on(lib, *args)
        _assert_same_rows(got, ref)
        if not swept:
            continue
        t_row, i_row = swept[0]
        o_, d_, t_best, taken, counts, start, chunk, entry, _ = args
        plain = [t_best.clone(), torch.full_like(t_best, -1,
                                                 dtype=torch.int64),
                 taken.clone()]
        host = [x.clone() for x in plain]
        ps.pair_advance_plain(ref, t_row, i_row, plain[0], plain[1],
                              plain[2], counts, start, entry)
        ps._best_on(lib, got, t_row, i_row, t_best.shape[0], True,
                    t_out=host[0], i_out=host[1], counts=counts, start=start,
                    entry=entry, taken=host[2])
        for x, y in zip(host, plain):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        hits.append(int((host[1] >= 0).sum()))
    return hits


# ----------------------------------------------------------------- on card


def _rows_on_cpu(rows):
    """The rows of an emission, on the CPU."""
    return ps.PairRows(*(x.cpu() for x in rows))


@pytest.mark.cuda
def test_cuda_pair_sweeps_match_plain_versions(monkeypatch):
    """Both CUDA kernels against their plain versions on the card, on the
    pair arrays of a real emission: the same index on every row, t within
    1e-5, one counted launch per call; the emission's kernels against the
    torch emission row for row and bit for bit; each entry point against
    the same route with the torch emission, every index and every bit of
    t; and a CUDA tensor never takes the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py there)")
    b = pt.SceneBuilder()
    b.add_mesh(pt.procedural.icosphere(4, 0.8),
               b.add_material("w", pt.LAMBERTIAN, [1, 1, 1]))
    scene, _ = b.build(bvh="median", device="cuda")
    o, d, t0 = (torch.from_numpy(x).cuda() for x in _small_bundle(4096, 3))
    for route, plain in (("pair", ps.pair_sweep_plain),
                         ("pairbin", ps.pairbin_sweep_plain)):
        rec = _Recorder(getattr(ps, f"{route}_sweep"))
        monkeypatch.setattr(ps, f"{route}_sweep", rec)
        emitted = []
        emit = getattr(ps, f"emit_{route}")

        def recording_emit(*args, emit=emit):
            emitted.append(([x.clone() if torch.is_tensor(x) else x
                             for x in args], emit(*args)))
            return emitted[-1][1]

        monkeypatch.setattr(ps, f"emit_{route}", recording_emit)
        before = profiling.counts()
        t, i = ENTRY_POINTS[route](o, d, scene.bvh, scene.triangles, T_MIN,
                                   t0)
        torch.cuda.synchronize()
        after = profiling.counts()
        assert sum(after[k] - before[k] for k in (
            "pair_sweep", "pairbin_sweep")) == len(rec.calls)
        for args, (tk, idx) in rec.calls:
            tp, ip = plain(*args)
            np.testing.assert_array_equal(idx.cpu().numpy(),
                                          ip.cpu().numpy())
            np.testing.assert_allclose(tk.cpu().numpy(), tp.cpu().numpy(),
                                       rtol=0, atol=KERNEL_T_TOL)
        for args, rows in emitted:
            ref = getattr(ps, f"emit_{route}_plain")(*args)
            _assert_same_rows(_rows_on_cpu(rows), _rows_on_cpu(ref))
        monkeypatch.setattr(ps, f"emit_{route}", emit)
        for name in ("emit_pairbin", "emit_pair", "pairbin_best",
                     "pair_advance"):
            monkeypatch.setattr(ps, name, getattr(ps, f"{name}_plain"))
        tt, it = ENTRY_POINTS[route](o, d, scene.bvh, scene.triangles,
                                     T_MIN, t0)
        monkeypatch.undo()
        np.testing.assert_array_equal(i.cpu().numpy(), it.cpu().numpy())
        np.testing.assert_array_equal(t.cpu().numpy().view(np.uint32),
                                      tt.cpu().numpy().view(np.uint32))
