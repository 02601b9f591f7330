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
iteration, finished lanes idle at the ``num_nodes`` sentinel.  It meets
triangles in ascending index order and keeps the first of equal t.  The
kernel walks the tree in another order, front to back with a stack over
child-pair node rows packed by :func:`pack_bvh`, and breaks ties by index,
so it returns the same triangle and the same t (the argument is in the
kernel's source note).

The ray-major pair sweeps of ``kernels.pair_sweep`` answer the same
question and are kept as measured alternatives (PERF.md); the JAX
package's ``PAIR_DISPATCH_KMAX`` routes to them, off by default, and
:func:`closest_hit` always walks.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import FlatBVH, Triangles
from ..utils import profiling
from . import intersect

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


# csrc/traversal.cu's limits (tpt_bvh_limits): the walk's stack and a
# leaf's most triangles; a leaf reference keeps the first triangle above
# LEAF_BITS bits of count - 1, so triangle indices stay below 2 ** 26.
STACK_DEPTH = 64
LEAF_BITS = 5
LEAF_MAX = 1 << LEAF_BITS
NODE_ROW, TRI_ROW = 16, 12
_QUIET_NAN = 0x7FC00000


def tree_depth(bvh: FlatBVH) -> torch.Tensor:
    """The deepest node's count of ancestors, a 0-d tensor on the BVH's
    device: node i's depth is i less the nodes whose subtree ends by i
    (``miss[j] <= i``), since the nodes before i are its ancestors and the
    nodes of finished subtrees."""
    n = bvh.count
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=bvh.miss.device)
    ended = torch.bincount(bvh.miss, minlength=n + 1)[:n].cumsum(0)
    return (torch.arange(n, device=bvh.miss.device) - ended).max()


def _rows_of(bvh: FlatBVH):
    """Row of each interior node in the node table: 1 + the interior nodes
    before it (row 0 holds the root)."""
    interior = (bvh.right >= 0).to(torch.int64)
    return torch.cumsum(interior, 0) - interior + 1


def _layout(bvh: FlatBVH, tris: Triangles):
    """Check that the tree fits the kernel and return (row of each node,
    count of node rows).  Raises ValueError for a tree deeper than the
    walk's stack, a leaf above ``LEAF_MAX`` triangles, or sizes beyond the
    kernel's int32 indices.

    Both depend only on the topology (``right``, ``miss``,
    ``prim_count``), which the refit keeps, tensors and all, while it
    moves the bounds every step; so they are kept on ``bvh.right`` for
    these tensors as they are, and the tree is read from the device once
    and not on every call."""
    n_nodes, n_tris = bvh.count, tris.count
    if n_tris >= 1 << (31 - LEAF_BITS) or n_nodes >= 1 << 27:
        raise ValueError(f"BVH of {n_nodes} nodes over {n_tris} triangles "
                         f"does not fit the kernel's int32 indices")
    topology = (bvh.miss, bvh.prim_count)
    versions = tuple(x._version for x in (bvh.right, *topology))
    kept = getattr(bvh.right, "_tpt_layout", None)
    if (kept is not None and all(a is b for a, b in zip(kept[0], topology))
            and kept[1] == versions):
        return kept[2]
    # One read of the device: the tree's depth, its largest leaf and its
    # interior nodes.
    zero = torch.zeros((), dtype=torch.int64, device=bvh.miss.device)
    profiling.count("host_syncs")
    depth, leaf, n_inner = torch.stack([
        tree_depth(bvh), bvh.prim_count.max() if n_nodes else zero,
        (bvh.right >= 0).sum()]).tolist()
    if depth > STACK_DEPTH:
        raise ValueError(f"BVH of depth {depth} is deeper than the traversal "
                         f"kernel's stack of {STACK_DEPTH}")
    if leaf > LEAF_MAX:
        raise ValueError(f"a BVH leaf of {leaf} triangles; the traversal "
                         f"kernel takes at most {LEAF_MAX}")
    layout = (_rows_of(bvh), 1 + n_inner)
    bvh.right._tpt_layout = (topology, versions, layout)
    return layout


def pack_bvh_plain(bvh: FlatBVH, tris: Triangles):
    """:func:`pack_bvh`'s plain version, on any device: torch ops, each
    rounded on its own as the packing kernel (built with --fmad=false)
    rounds."""
    row_of, n_rows = _layout(bvh, tris)
    device = bvh.mins.device
    refs = torch.zeros((n_rows, NODE_ROW), dtype=torch.int32, device=device)
    rows = refs.view(torch.float32)
    refs[:, :12] = _QUIET_NAN
    leaf_ref = ~((bvh.prim_start << LEAF_BITS) | (bvh.prim_count - 1))
    ref = torch.where(bvh.right >= 0, row_of, leaf_ref).to(torch.int32)
    first = bvh.prim_lo.to(torch.int32)
    mins, maxs = bvh.mins.detach(), bvh.maxs.detach()

    def put(r, side, c):
        rows[r, 6 * side:6 * side + 3] = mins[c]
        rows[r, 6 * side + 3:6 * side + 6] = maxs[c]
        refs[r, 12 + 2 * side] = first[c]
        refs[r, 13 + 2 * side] = ref[c]

    inner = torch.nonzero(bvh.right >= 0).squeeze(1)
    put(row_of[inner], 0, inner + 1)
    put(row_of[inner], 1, bvh.right[inner])
    if bvh.count:
        root = torch.zeros(1, dtype=torch.int64, device=device)
        put(root, 0, root)
    a, b, c = (x.detach().to(torch.float32) for x in (tris.a, tris.b, tris.c))
    ab, ac = b - a, c - a
    nt = torch.stack([ab[:, 1] * ac[:, 2] - ab[:, 2] * ac[:, 1],
                      ab[:, 2] * ac[:, 0] - ab[:, 0] * ac[:, 2],
                      ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0]], dim=1)
    return rows, torch.cat([a, ab, ac, nt], dim=1)


def pack_bvh(bvh: FlatBVH, tris: Triangles):
    """The kernel's tables: node rows ``[R, 16]`` f32 and triangle rows
    ``[T, 12]`` f32 (see ``csrc/traversal.cu``).  A node row holds both
    children of an interior node: the left box (min xyz, max xyz), the
    right box, and, as int32 bits, each child's first triangle and its
    reference (the child's row, or ``~(first << LEAF_BITS | count - 1)``
    for a leaf); row 0 holds the root beside an empty (NaN) box.  A
    triangle row is a, ab, ac and ab x ac.

    Packed on every call, since the refit changes the bounds every training
    step: on CUDA tensors by ``csrc/traversal.cu``'s packing kernel, on CPU
    tensors by its plain version (:func:`pack_bvh_plain`).  Raises
    ValueError for a tree the kernel cannot take (:func:`_layout`)."""
    from . import _build

    device = bvh.mins.device
    if device.type == "cpu":
        return pack_bvh_plain(bvh, tris)
    if device.type != "cuda":
        raise ValueError(f"pack_bvh: no route for device {device}")
    n_nodes, n_tris = bvh.count, tris.count
    row_of, n_rows = _layout(bvh, tris)
    fields = [bvh.mins.detach().to(torch.float32).contiguous(),
              bvh.maxs.detach().to(torch.float32).contiguous(),
              *(x.to(torch.int64).contiguous() for x in (
                  bvh.right, bvh.prim_start, bvh.prim_count, bvh.prim_lo,
                  row_of))]
    corners = [x.detach().to(torch.float32).contiguous()
               for x in (tris.a, tris.b, tris.c)]
    if any(x.device != device for x in corners):
        raise ValueError(f"triangles on {tris.a.device}, BVH on {device}")
    rows = torch.empty((n_rows, NODE_ROW), dtype=torch.float32,
                       device=device)
    tri_rows = torch.empty((n_tris, TRI_ROW), dtype=torch.float32,
                           device=device)
    lib = _build.load()
    fn = lib.tpt_bvh_pack
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] + [p] * 3 + [i, p, p, p]
        fn.restype = ctypes.c_int
    err = fn(*(x.data_ptr() for x in fields), n_nodes,
             *(x.data_ptr() for x in corners), n_tris, rows.data_ptr(),
             tri_rows.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"BVH packing kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("bvh_pack")
    return rows, tri_rows


def _bind(lib):
    fn = lib.tpt_bvh_closest_hit
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, f, f, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(origin, direction, bvh: FlatBVH, tris: Triangles, t_min: float,
            t_best0):
    """Launch ``csrc/traversal.cu`` on the current stream; returns
    (t [N] f32, tri_index [N] int64).  The packing is the span
    ``traversal.pack`` and the walk's enqueue the span ``traversal.launch``,
    one after the other."""
    from . import _build

    device = origin.device
    n = origin.shape[0]
    if n > _INT32_MAX:
        raise ValueError(f"{n} rays do not fit the kernel's int32 indices")
    for name, x, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("t_best0", t_best0, (n,))):
        if x.device != device or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} on {device}, got "
                             f"{list(x.shape)} on {x.device}")
    if bvh.mins.device != device:
        raise ValueError(f"bvh on {bvh.mins.device}, rays on {device}")
    with profiling.span("traversal.pack"):
        rows, tri_rows = pack_bvh(bvh, tris)
    with profiling.span("traversal.launch"):
        rays = [x.detach().to(torch.float32).contiguous()
                for x in (origin, direction, t_best0)]
        t_out = torch.empty((n,), dtype=torch.float32, device=device)
        idx_out = torch.empty((n,), dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _bind(_build.load())(
            *(x.data_ptr() for x in rays), rows.data_ptr(),
            tri_rows.data_ptr(), n, float(t_min), float(intersect.INF),
            t_out.data_ptr(), idx_out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"traversal kernel launch failed: CUDA error "
                               f"{err}")
        profiling.count("bvh_closest_hit")
        return t_out, idx_out.to(torch.int64)


def closest_hit(origin, direction, bvh: FlatBVH, tris: Triangles,
                t_min: float, t_best0):
    """Closest triangle hit per ray below ``t_best0`` through the BVH;
    returns (t [N], tri_index [N] int64), t = INF and index -1 on a miss.

    CPU tensors run the plain walk (:func:`bvh_closest_hit`); CUDA tensors
    launch the CUDA kernel or raise."""
    device = origin.device
    if device.type == "cpu":
        return bvh_closest_hit(origin, direction, bvh, tris, t_min, t_best0,
                               int(bvh.prim_count.max()))
    if device.type != "cuda":
        raise ValueError(f"closest_hit: no route for device {device}")
    return _launch(origin, direction, bvh, tris, t_min, t_best0)
