"""Closest triangle hit per ray: the BVH walk, its CUDA kernel, and the
dense sweep (``tpu_path_tracer.kernels.traversal``).

:func:`closest_hit` is the wrapper ``kernels.hit.find_hit`` calls for BVH
scenes.  On CUDA tensors it launches ``csrc/traversal.cu``, the port of the
JAX package's Pallas tile sweep (``kernels/pallas/traversal.py``:
``_sweep_round_resident`` and ``_sweep_round``, through
``tile_closest_hit``); on CPU tensors it runs :func:`bvh_closest_hit`, the
kernel's plain version; any other device raises.  There is no fallback.

:func:`bvh_closest_hit` is the stackless skip-link walk over the flattened
DFS-preorder BVH (``accel.bvh``)::

    next = node + 1      if the ray hits the node's box  (descend / advance)
    next = miss[node]    otherwise                       (skip the subtree)

with one int64 node pointer per lane; every lane advances one node per
iteration, finished lanes idle at the ``num_nodes`` sentinel.  The kernel
walks the same nodes in the same order, so ties between triangles at equal
t resolve to the same index.

``PAIR_DISPATCH`` routes :func:`closest_hit` through the ray-major pair
sweeps of ``kernels.pair_sweep`` instead, as the JAX package's
``PAIR_DISPATCH_KMAX`` does; like it, it is off.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import FlatBVH, Triangles
from . import intersect, pair_sweep

# Launches of the CUDA traversal kernel in this process.
LAUNCHES = 0

# The route of closest_hit: None is the BVH walk (csrc/traversal.cu on the
# card); "pairbin" and "pair" send BVH scenes through
# pair_sweep.pairbin_closest_hit and pair_sweep.pair_closest_hit.  A module
# constant that tests and chip_smoke.py set, not an option: the pair sweeps
# are kept as measured alternatives (PERF.md), and the walk stays the route.
PAIR_DISPATCH = None
_PAIR_ROUTES = {"pairbin": pair_sweep.pairbin_closest_hit,
                "pair": pair_sweep.pair_closest_hit}

_INT32_MAX = 2 ** 31 - 1


@torch.no_grad()
def bvh_closest_hit(origin, direction, bvh: FlatBVH, tris: Triangles,
                    t_min: float, t_best0, max_leaf: int, stats=None):
    """Closest triangle along each ray via stackless skip-link traversal.

    Args:
      origin, direction: ``[N, 3]`` ray batch.
      bvh: flattened DFS-preorder BVH.
      tris: triangle SoA, ordered to match ``bvh.prim_start`` ranges.
      t_min: scalar epsilon.
      t_best0: ``[N]`` initial closest-hit bound; a negative bound marks a
        retired lane, whose root box test fails.
      max_leaf: upper bound on a leaf's triangle count (from the builder).
      stats: optional dict; receives the summed ``node_visits`` and
        ``tri_tests`` of all lanes and the walk's ``iterations``.

    Returns:
      (t [N], tri_index [N] int64), t = INF and index -1 on a miss.
    """
    sentinel = bvh.count
    n_tris = tris.count
    inv_dir = 1.0 / direction
    node = torch.zeros(t_best0.shape, dtype=torch.int64, device=origin.device)
    t_best = t_best0.clone()
    idx_best = torch.full_like(node, -1)
    visits = tests = iterations = 0
    while bool((node < sentinel).any()):
        active = node < sentinel
        ni = torch.clamp(node, max=sentinel - 1)
        a_hit = intersect.aabb_hit(origin, inv_dir, bvh.mins[ni],
                                   bvh.maxs[ni], t_min, t_best) & active
        leaf_hit = a_hit & (bvh.right[ni] < 0)
        start = bvh.prim_start[ni]
        count = bvh.prim_count[ni]
        # The leaf's triangles in order (the reference loops prim_count at
        # hitRay.wgsl:61-68); each test is bounded by the running best.
        for j in range(max_leaf):
            tid = torch.clamp(start + j, 0, n_tris - 1)
            valid = leaf_hit & (j < count)
            t, _, _, _ = intersect.triangle_t(
                origin, direction, tris.a[tid], tris.b[tid], tris.c[tid],
                t_min, t_best)
            better = valid & (t < t_best)
            t_best = torch.where(better, t, t_best)
            idx_best = torch.where(better, tid, idx_best)
            if stats is not None:
                tests += valid.sum()
        node = torch.where(active, torch.where(a_hit, node + 1, bvh.miss[ni]),
                           node)
        if stats is not None:
            visits += active.sum()
            iterations += 1
    if stats is not None:
        stats.update(node_visits=int(visits), tri_tests=int(tests),
                     iterations=iterations)
    return torch.where(idx_best >= 0, t_best, intersect.INF), idx_best


def brute_force_closest_hit(origin, direction, tris: Triangles,
                            t_min: float, t_best0):
    """Dense ``[N, T]`` triangle sweep — the reference's commented-out
    cross-check (``hitRay.wgsl:188-221``), used below
    ``BRUTE_FORCE_MAX_TRIS`` triangles.  Returns (t [N], tri_index [N],
    -1 for a miss)."""
    t, _, _, _ = intersect.triangle_t(
        origin[:, None], direction[:, None], tris.a[None], tris.b[None],
        tris.c[None], t_min, t_best0[:, None])
    t_min_v, idx = torch.min(t, dim=1)
    hit = t_min_v < t_best0
    return (torch.where(hit, t_min_v, intersect.INF),
            torch.where(hit, idx, -1))


def pack_bvh(bvh: FlatBVH, tris: Triangles):
    """The kernel's tables: node bounds ``[B, 6]`` f32 (min xyz, max xyz),
    node links ``[B, 3]`` int32 (miss, prim_start, prim_count) and
    triangle corners ``[T, 9]`` f32 (a, b, c), contiguous.  Packed on every
    call: the refit changes the bounds every training step."""
    n_nodes, n_tris = bvh.count, tris.count
    if n_nodes > _INT32_MAX or 2 * n_tris - 1 > _INT32_MAX:
        raise ValueError(f"BVH of {n_nodes} nodes over {n_tris} triangles "
                         f"does not fit the kernel's int32 indices")
    bounds = torch.cat([bvh.mins, bvh.maxs], dim=1)
    links = torch.stack([bvh.miss, bvh.prim_start, bvh.prim_count], dim=1)
    corners = torch.cat([tris.a, tris.b, tris.c], dim=1)
    return (bounds.detach().to(torch.float32).contiguous(),
            links.to(torch.int32).contiguous(),
            corners.detach().to(torch.float32).contiguous())


def _bind(lib):
    fn = lib.tpt_bvh_closest_hit
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, f, f, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(origin, direction, bvh: FlatBVH, tris: Triangles, t_min: float,
            t_best0):
    """Launch ``csrc/traversal.cu`` on the current stream; returns
    (t [N] f32, tri_index [N] int64)."""
    global LAUNCHES
    from . import _build

    device = origin.device
    n = origin.shape[0]
    if n > _INT32_MAX:
        raise ValueError(f"{n} rays do not fit the kernel's int32 indices")
    rays = []
    for name, x, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("t_best0", t_best0, (n,))):
        if x.device != device or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} on {device}, got "
                             f"{list(x.shape)} on {x.device}")
        rays.append(x.detach().to(torch.float32).contiguous())
    bounds, links, corners = pack_bvh(bvh, tris)
    for name, x in (("bvh", bounds), ("triangles", corners)):
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, rays on {device}")
    t_out = torch.empty((n,), dtype=torch.float32, device=device)
    idx_out = torch.empty((n,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _bind(_build.load())(
        *(x.data_ptr() for x in rays), bounds.data_ptr(), links.data_ptr(),
        corners.data_ptr(), n, bvh.count, float(t_min),
        float(intersect.INF), t_out.data_ptr(), idx_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"traversal kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return t_out, idx_out.to(torch.int64)


def closest_hit(origin, direction, bvh: FlatBVH, tris: Triangles,
                t_min: float, t_best0):
    """Closest triangle hit per ray below ``t_best0`` through the BVH;
    returns (t [N], tri_index [N] int64), t = INF and index -1 on a miss.

    CPU tensors run the plain walk (:func:`bvh_closest_hit`); CUDA tensors
    launch the CUDA kernel or raise.  With ``PAIR_DISPATCH`` set, the named
    pair sweep answers instead, under the same rule."""
    if PAIR_DISPATCH is not None:
        return _PAIR_ROUTES[PAIR_DISPATCH](origin, direction, bvh, tris,
                                           t_min, t_best0)
    device = origin.device
    if device.type == "cpu":
        return bvh_closest_hit(origin, direction, bvh, tris, t_min, t_best0,
                               int(bvh.prim_count.max()))
    if device.type != "cuda":
        raise ValueError(f"closest_hit: no route for device {device}")
    return _launch(origin, direction, bvh, tris, t_min, t_best0)
