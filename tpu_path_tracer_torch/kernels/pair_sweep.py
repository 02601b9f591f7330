"""Ray-major closest hit: the pair sweeps, their CUDA kernels and the
emission that feeds them (``tpu_path_tracer.kernels.pallas.traversal``:
``pair_closest_hit`` and the pair-bin path of ``tile_closest_hit``).

Instead of walking a tree per ray, rays are paired with aligned
128-triangle chunks of the BVH-preorder triangle array (spatially compact,
because the order is the BVH's), the pairs are sorted by chunk, and a kernel
tests every 128-pair segment against one chunk's edge-function table:

* :func:`pairbin_closest_hit`: one shot.  Every ray is paired with every
  bin (``PAIR_G`` consecutive chunks) whose box it can reach; the kernel
  slab-tests each of the bin's chunks against the segment's rows and sweeps
  those some row can still hit (JAX ``_pairbin_path`` / ``_pairbin_sweep``).
* :func:`pair_closest_hit`: rounds.  Every ray gets its candidate chunks
  front to back; each round pairs a live ray with its next ``PAIR_E``
  chunks, sweeps, tightens the ray's bound, and retires the ray once its
  next chunk starts beyond the bound (JAX ``pair_closest_hit`` /
  ``_pair_sweep``).

Both return what ``kernels.traversal.closest_hit`` returns.  The
edge-function form rounds differently from the walk's Möller-Trumbore, so
the two agree on the hit and on t to about 1e-4 relative, not on the index
at a shared edge.

:func:`pair_sweep` and :func:`pairbin_sweep` are the kernel wrappers: on
CUDA tensors they launch ``csrc/pair_sweep.cu`` (and count the launch), on
CPU tensors they run the plain versions :func:`pair_sweep_plain` and
:func:`pairbin_sweep_plain`; any other device raises.  There is no
fallback.  The plain versions write every product as elementwise multiplies
and adds in the kernel's order, so kernel and plain version round alike.

The emission is torch: ``nonzero`` of the candidate matrix, one
``sort`` by chunk or bin, a padded layout by ``bincount`` and ``cumsum``,
scatters back.  What the JAX emission adds for static shapes, gather cost or
VMEM is left out: payload sorts, the cummax layout, the u32 bitmaps and
their bit pops, the ``lax.switch`` size tiers, the Morton and
lead-superchunk sort of the rays, the tile-level candidate lists and the
640-chunk residency limit.  So is the ``PAIRBIN_K`` = 16 candidate budget,
whose overflow sends the whole batch to the tile sweep in JAX: here every
candidate of every ray is emitted, and no ray takes another route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import vecmath as vm
from ..core.types import FlatBVH, Triangles
from .intersect import DET_EPS, INF

TRI_CHUNK = 128    # triangles per chunk, and pair rows per segment
TABLE_ROWS = 22    # e0 (6), e1 (6), e2 (6), -n (3), n.a
PAIR_G = 4         # chunks per pair-bin
PAIR_E = 2         # pairs emitted per live ray per round
# Elements of one [rays, boxes] block of a dense slab pass (32 MB a
# temporary in float32).
DENSE_BLOCK = 1 << 23
# Segments per block of the plain versions' [segments, 128, 128] products.
PLAIN_BLOCK = 256

# Launches of the CUDA kernels in this process.
PAIR_LAUNCHES = 0
PAIRBIN_LAUNCHES = 0

# Inside this module a slab or a triangle test that fails reads _NONE, and
# any entry or t below _BIG is real (INF, the callers' "no hit", is smaller
# than both).
_NONE = 3e38
_BIG = 1e30
_INT32_MAX = 2 ** 31 - 1


class PackedTris(NamedTuple):
    """The sweeps' tables (:func:`pack_tris`)."""
    table: torch.Tensor  # [C, 22, 128] f32, a chunk's triangles in columns
    cmin: torch.Tensor   # [C, 3] f32, box of each chunk's real triangles
    cmax: torch.Tensor   # [C, 3] f32


def pack_tris(tris: Triangles) -> PackedTris:
    """Chunked edge-function tables and per-chunk boxes, with the JAX
    ``pack_tris``' formulas.  Column j of chunk k holds, for triangle
    ``128 k + j`` with corners a, b, c and n = (b - a) x (c - a):

    * rows 0-5, 6-11, 12-17: one edge each, (b, c), (c, a), (a, b), as
      ``p x q`` (dotted with d) and ``q - p`` (dotted with o x d), so the
      product with ``[d, o x d]`` is the edge's signed volume and the three
      sum to ``n . d``;
    * rows 18-20 ``-n``, row 21 ``n . a``: dotted with ``[o, 1]`` the
      unnormalized hit parameter.

    The last chunk is padded with zero columns, which reject themselves
    (den = 0); padding corners count as +-1e30 in the boxes.  Packed on
    every call (vertices move every training step), detached, float32."""
    a, b, c = (x.detach().to(torch.float32) for x in (tris.a, tris.b, tris.c))
    t = a.shape[0]
    n_chunks = -(-max(t, TRI_CHUNK) // TRI_CHUNK)
    pad = n_chunks * TRI_CHUNK - t
    if n_chunks * TRI_CHUNK > _INT32_MAX:
        raise ValueError(f"{t} triangles do not fit the kernels' int32 "
                         f"indices")
    n = vm.cross(b - a, c - a)
    cols = torch.cat([vm.cross(b, c), c - b, vm.cross(c, a), a - c,
                      vm.cross(a, b), b - a, -n, vm.dot(n, a)[:, None]],
                     dim=1)
    table = F.pad(cols, (0, 0, 0, pad)).reshape(n_chunks, TRI_CHUNK,
                                                TABLE_ROWS)
    tmin = torch.minimum(torch.minimum(a, b), c)
    tmax = torch.maximum(torch.maximum(a, b), c)
    cmin = F.pad(tmin, (0, 0, 0, pad), value=_BIG).reshape(
        n_chunks, TRI_CHUNK, 3).amin(dim=1)
    cmax = F.pad(tmax, (0, 0, 0, pad), value=-_BIG).reshape(
        n_chunks, TRI_CHUNK, 3).amax(dim=1)
    return PackedTris(table.transpose(1, 2).contiguous(), cmin, cmax)


def superchunk_size(n_chunks: int) -> int:
    """Chunks per superchunk of the pair path's coarse level: doubles from
    8 until at most 160 superchunks are left."""
    g = 8
    while -(-n_chunks // g) > 160:
        g *= 2
    return g


def superchunk_boxes(cmin, cmax, g: int):
    """Boxes ``[S, 3]`` of groups of ``g`` consecutive chunks; a partial
    last group stays tight."""
    n_chunks = cmin.shape[0]
    s = -(-n_chunks // g)
    pad = s * g - n_chunks
    return (F.pad(cmin, (0, 0, 0, pad), value=_BIG).reshape(s, g, 3)
            .amin(dim=1),
            F.pad(cmax, (0, 0, 0, pad), value=-_BIG).reshape(s, g, 3)
            .amax(dim=1))


def scene_diam(origin, cmin, cmax):
    """The farthest any ray must travel to leave the union of the origins'
    and the scene's box (directions are unit length): a cap on t."""
    lo = torch.minimum(cmin.amin(dim=0), origin.amin(dim=0))
    hi = torch.maximum(cmax.amax(dim=0), origin.amax(dim=0))
    d = hi - lo
    return vm.sqrt(vm.dot(d, d)) * 1.001


def inv_dir(direction):
    """``sign(d) / max(|d|, 1e-12)``: finite, so no slab is NaN."""
    sign = torch.where(direction >= 0.0, 1.0, -1.0)
    return sign / torch.clamp(torch.abs(direction), min=1e-12)


def slab_entries(o, iv, cap, bmin, bmax):
    """Entry distance of rays into boxes, _NONE where a ray misses the box
    or enters it beyond ``cap``.  ``o``, ``iv``, ``bmin``, ``bmax`` broadcast
    over their leading axes (trailing axis xyz), ``cap`` over the same."""
    tlo = thi = None
    for ax in range(3):
        t0 = (bmin[..., ax] - o[..., ax]) * iv[..., ax]
        t1 = (bmax[..., ax] - o[..., ax]) * iv[..., ax]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tlo = lo if tlo is None else torch.maximum(tlo, lo)
        thi = hi if thi is None else torch.minimum(thi, hi)
    ent = torch.clamp(tlo, min=0.0)
    return torch.where((thi >= ent) & (tlo <= cap), ent, _NONE)


# ----------------------------------------------------- plain versions


def _edge_tests(dm, o1, tab, t_min, bound):
    """Every row of each segment against every triangle of the segment's
    chunk.  dm, o1 ``[S, 128, 8]``, tab ``[S, 22, 128]``, bound ``[S, 128]``;
    returns t ``[S, 128 rows, 128 triangles]``, _NONE where rejected.  The
    arithmetic of ``csrc/pair_sweep.cu`` ``edge_test``, in its order."""
    ray = [dm[:, :, k, None] for k in range(6)]
    org = [o1[:, :, k, None] for k in range(3)]

    def volume(k):
        s = ray[0] * tab[:, None, k]
        for i in range(1, 6):
            s = s + ray[i] * tab[:, None, k + i]
        return s

    s0, s1, s2 = volume(0), volume(6), volume(12)
    tn = org[0] * tab[:, None, 18]
    tn = tn + org[1] * tab[:, None, 19]
    tn = tn + org[2] * tab[:, None, 20]
    tn = tn + tab[:, None, 21]
    den = (s0 + s1) + s2
    inv = 1.0 / den
    t = tn * inv
    ok = ((torch.abs(den) >= DET_EPS) & (t >= t_min)
          & (t < bound[:, :, None]) & (s0 * inv >= t_min)
          & (s1 * inv >= t_min) & (s2 * inv >= t_min))
    return torch.where(ok, t, _NONE)


def _least(tm, base):
    """Least t per row of ``[S, 128, 128]`` and, among equal t, the least
    global triangle index (``base [S]`` is each chunk's first); -1 where
    the row hit nothing."""
    t = tm.amin(dim=2)
    gid = base[:, None, None] + torch.arange(TRI_CHUNK, device=tm.device)
    idx = torch.where(tm == t[:, :, None], gid, _INT32_MAX).amin(dim=2)
    return t, torch.where(t < _BIG, idx, -1)


def pair_sweep_plain(pair_dm, pair_o1, seg_cid, table, t_min: float):
    """Plain version of the pair-sweep kernel.  pair_dm ``[P, 8]`` (d,
    o x d, bound, 0), pair_o1 ``[P, 8]`` (o, 1, 0...), seg_cid ``[P/128]``
    (the chunk of each 128-row segment; an id outside ``[0, C)`` marks a
    dummy segment), table ``[C, 22, 128]``.  Returns (t ``[P]`` f32,
    idx ``[P]`` int32): each row's least t below its bound and that
    triangle's global index, INF and -1 where there is none."""
    n_chunks = table.shape[0]
    n_segs = seg_cid.shape[0]
    dm = pair_dm.reshape(n_segs, TRI_CHUNK, 8)
    o1 = pair_o1.reshape(n_segs, TRI_CHUNK, 8)
    t_out = torch.full((n_segs, TRI_CHUNK), INF, dtype=torch.float32,
                       device=pair_dm.device)
    i_out = torch.full((n_segs, TRI_CHUNK), -1, dtype=torch.int64,
                       device=pair_dm.device)
    for s in range(0, n_segs, PLAIN_BLOCK):
        sl = slice(s, s + PLAIN_BLOCK)
        cid = seg_cid[sl].to(torch.int64)
        on = (cid >= 0) & (cid < n_chunks)
        cidc = torch.clamp(cid, 0, n_chunks - 1)
        tm = _edge_tests(dm[sl], o1[sl], table[cidc], t_min, dm[sl, :, 6])
        t, idx = _least(tm, cidc * TRI_CHUNK)
        hit = on[:, None] & (idx >= 0)
        t_out[sl] = torch.where(hit, t, INF)
        i_out[sl] = torch.where(hit, idx, -1)
    return t_out.reshape(-1), i_out.reshape(-1).to(torch.int32)


def pairbin_sweep_plain(pair_dm, pair_o1, seg_bid, boxes, table,
                        t_min: float):
    """Plain version of the pair-bin kernel.  Arrays as in
    :func:`pair_sweep_plain`, with seg_bid ``[P/128]`` the bin of each
    segment (outside ``[0, ceil(C / 4))``: dummy) and boxes ``[C, 6]`` (min
    xyz, max xyz of each chunk).  Each row starts at its bound (column 6);
    for each of the bin's chunks in order, the chunk is swept, by every row
    of the segment, when some row's slab test against the chunk's box
    passes at its running best; a row takes a chunk's least hit when it is
    strictly closer.  Returns (t, idx): the row's closest hit and its index,
    or its bound and -1; INF and -1 in dummy segments."""
    n_chunks = table.shape[0]
    n_bins = -(-n_chunks // PAIR_G)
    n_segs = seg_bid.shape[0]
    dm = pair_dm.reshape(n_segs, TRI_CHUNK, 8)
    o1 = pair_o1.reshape(n_segs, TRI_CHUNK, 8)
    t_out = torch.full((n_segs, TRI_CHUNK), INF, dtype=torch.float32,
                       device=pair_dm.device)
    i_out = torch.full((n_segs, TRI_CHUNK), -1, dtype=torch.int64,
                       device=pair_dm.device)
    for s in range(0, n_segs, PLAIN_BLOCK):
        sl = slice(s, s + PLAIN_BLOCK)
        bid = seg_bid[sl].to(torch.int64)
        on = (bid >= 0) & (bid < n_bins)
        o = o1[sl, :, :3]
        iv = inv_dir(dm[sl, :, :3])
        t_cur = dm[sl, :, 6].clone()
        i_cur = torch.full_like(t_cur, -1, dtype=torch.int64)
        for c in range(PAIR_G):
            cid = bid * PAIR_G + c
            live = on & (cid < n_chunks)
            cidc = torch.clamp(cid, 0, n_chunks - 1)
            box = boxes[cidc][:, None]                       # [S, 1, 6]
            reach = slab_entries(o, iv, t_cur, box[..., :3],
                                 box[..., 3:]) < _BIG
            sweep = live & reach.any(dim=1)
            tm = _edge_tests(dm[sl], o1[sl], table[cidc], t_min, t_cur)
            t, idx = _least(tm, cidc * TRI_CHUNK)
            upd = sweep[:, None] & (idx >= 0) & (t < t_cur)
            t_cur = torch.where(upd, t, t_cur)
            i_cur = torch.where(upd, idx, i_cur)
        t_out[sl] = torch.where(on[:, None], t_cur, INF)
        i_out[sl] = torch.where(on[:, None], i_cur, -1)
    return t_out.reshape(-1), i_out.reshape(-1).to(torch.int32)


# ----------------------------------------------------- kernel wrappers


def _bind(lib):
    pair, pairbin = lib.tpt_pair_sweep, lib.tpt_pairbin_sweep
    if pair.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pair.argtypes = [p, p, p, p, i, i, f, f, p, p, p]
        pairbin.argtypes = [p, p, p, p, p, i, i, i, f, p, p, p]
        pair.restype = pairbin.restype = ctypes.c_int
    return pair, pairbin


def _checked(pair_dm, pair_o1, seg_id, table, boxes=None):
    """The kernels' arguments as contiguous float32 / int32 tensors on one
    CUDA device, with their shapes checked."""
    device = pair_dm.device
    n_segs = seg_id.shape[0]
    rows = n_segs * TRI_CHUNK
    n_chunks = table.shape[0]
    shapes = [("pair_dm", pair_dm, (rows, 8)), ("pair_o1", pair_o1, (rows, 8)),
              ("segment ids", seg_id, (n_segs,)),
              ("table", table, (n_chunks, TABLE_ROWS, TRI_CHUNK))]
    if boxes is not None:
        shapes.append(("boxes", boxes, (n_chunks, 6)))
    out = []
    for name, x, shape in shapes:
        if x.device != device or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} on {device}, got "
                             f"{list(x.shape)} on {x.device}")
        dtype = torch.int32 if name == "segment ids" else torch.float32
        out.append(x.detach().to(dtype).contiguous())
    if rows > _INT32_MAX:
        raise ValueError(f"{rows} pair rows do not fit the kernels' int32 "
                         f"indices")
    return out


def _outputs(n_segs, device):
    """Outputs initialised to "no hit": a dummy segment writes nothing."""
    return (torch.full((n_segs * TRI_CHUNK,), INF, dtype=torch.float32,
                       device=device),
            torch.full((n_segs * TRI_CHUNK,), -1, dtype=torch.int32,
                       device=device))


def pair_sweep(pair_dm, pair_o1, seg_cid, table, t_min: float):
    """The pair sweep (arguments and result as :func:`pair_sweep_plain`):
    CUDA tensors launch ``csrc/pair_sweep.cu`` on the current stream, CPU
    tensors run the plain version, any other device raises."""
    global PAIR_LAUNCHES
    device = pair_dm.device
    if device.type == "cpu":
        return pair_sweep_plain(pair_dm, pair_o1, seg_cid, table, t_min)
    if device.type != "cuda":
        raise ValueError(f"pair_sweep: no route for device {device}")
    from . import _build

    dm, o1, cid, tab = _checked(pair_dm, pair_o1, seg_cid, table)
    t_out, i_out = _outputs(cid.shape[0], device)
    err = _bind(_build.load())[0](
        dm.data_ptr(), o1.data_ptr(), cid.data_ptr(), tab.data_ptr(),
        cid.shape[0], tab.shape[0], float(t_min), float(INF),
        t_out.data_ptr(), i_out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair sweep kernel launch failed: CUDA error "
                           f"{err}")
    PAIR_LAUNCHES += 1
    return t_out, i_out


def pairbin_sweep(pair_dm, pair_o1, seg_bid, boxes, table, t_min: float):
    """The pair-bin sweep (arguments and result as
    :func:`pairbin_sweep_plain`): CUDA tensors launch
    ``csrc/pair_sweep.cu`` on the current stream, CPU tensors run the plain
    version, any other device raises."""
    global PAIRBIN_LAUNCHES
    device = pair_dm.device
    if device.type == "cpu":
        return pairbin_sweep_plain(pair_dm, pair_o1, seg_bid, boxes, table,
                                   t_min)
    if device.type != "cuda":
        raise ValueError(f"pairbin_sweep: no route for device {device}")
    from . import _build

    dm, o1, bid, tab, box = _checked(pair_dm, pair_o1, seg_bid, table, boxes)
    t_out, i_out = _outputs(bid.shape[0], device)
    n_chunks = tab.shape[0]
    err = _bind(_build.load())[1](
        dm.data_ptr(), o1.data_ptr(), bid.data_ptr(), box.data_ptr(),
        tab.data_ptr(), bid.shape[0], -(-n_chunks // PAIR_G), n_chunks,
        float(t_min), t_out.data_ptr(), i_out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pair-bin sweep kernel launch failed: CUDA error "
                           f"{err}")
    PAIRBIN_LAUNCHES += 1
    return t_out, i_out


# ------------------------------------------------------------ emission


def _rays(origin, direction, t_best0):
    n = origin.shape[0]
    out = []
    for name, x, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("t_best0", t_best0, (n,))):
        if x.device != origin.device or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} on "
                             f"{origin.device}, got {list(x.shape)} on "
                             f"{x.device}")
        out.append(x.detach().to(torch.float32).contiguous())
    return out


def _segment_layout(key, n_keys: int):
    """The padded layout of pairs sorted by ``key`` (a chunk or bin id in
    ``[0, n_keys)``, non-decreasing): every key's run is padded to a
    multiple of 128 rows, so each 128-row segment serves one key.  Returns
    (row of each pair ``[pairs]``, key of each segment ``[rows / 128]``
    int32, rows)."""
    counts = torch.bincount(key, minlength=n_keys)
    padded = (counts + (TRI_CHUNK - 1)) // TRI_CHUNK * TRI_CHUNK
    shift = (torch.cumsum(padded, 0) - padded) - (torch.cumsum(counts, 0)
                                                  - counts)
    rows = torch.arange(key.shape[0], device=key.device) + shift[key]
    n_rows = int(padded.sum())
    seg = torch.repeat_interleave(
        torch.arange(n_keys, device=key.device), padded // TRI_CHUNK,
        output_size=n_rows // TRI_CHUNK)
    return rows, seg.to(torch.int32), n_rows


def _pair_rows(o, d, bound, ray, rows, n_rows: int):
    """The kernels' row arrays: pair_dm ``[rows, 8]`` (d, o x d, bound, 0)
    and pair_o1 ``[rows, 8]`` (o, 1, 0...) with pair k (of ray ``ray[k]``)
    at row ``rows[k]``; padding rows are zero, and their bound 0 rejects
    every hit."""
    n = o.shape[0]
    src_dm = torch.cat([d, vm.cross(o, d), bound[:, None],
                        o.new_zeros((n, 1))], dim=1)
    src_o1 = torch.cat([o, o.new_ones((n, 1)), o.new_zeros((n, 4))], dim=1)
    pair_dm = o.new_zeros((n_rows, 8))
    pair_o1 = o.new_zeros((n_rows, 8))
    pair_dm[rows] = src_dm[ray]
    pair_o1[rows] = src_o1[ray]
    return pair_dm, pair_o1


def _best_per_ray(n: int, ray, t, idx):
    """Reduce pair rows to rays: each ray's least t over its rows that hit
    (``idx >= 0``) and, among equal t, the least index; _NONE and -1 for a
    ray none of whose rows hit."""
    idx = idx.to(torch.int64)
    t = torch.where(idx >= 0, t, _NONE)
    t_ray = torch.full((n,), _NONE, dtype=torch.float32,
                       device=t.device).scatter_reduce_(0, ray, t, "amin")
    tied = torch.where((idx >= 0) & (t == t_ray[ray]), idx, _INT32_MAX)
    i_ray = torch.full((n,), _INT32_MAX, dtype=torch.int64,
                       device=t.device).scatter_reduce_(0, ray, tied, "amin")
    return t_ray, torch.where(i_ray < _INT32_MAX, i_ray, -1)


def _all_miss(n: int, device):
    """What ``closest_hit`` returns when no ray hits."""
    return (torch.full((n,), INF, dtype=torch.float32, device=device),
            torch.full((n,), -1, dtype=torch.int64, device=device))


@torch.no_grad()
def pairbin_closest_hit(origin, direction, bvh: FlatBVH, tris: Triangles,
                        t_min: float, t_best0):
    """Closest triangle hit per ray below ``t_best0`` by the single-shot
    pair-bin sweep; the contract of ``kernels.traversal.closest_hit``:
    (t ``[N]``, tri_index ``[N]`` int64), INF and -1 on a miss; a negative
    ``t_best0`` marks a retired lane, which emits no pair.  ``bvh`` is not
    read (the triangle order is already the BVH's); it is taken so that the
    entry points are interchangeable."""
    o, d, tb = _rays(origin, direction, t_best0)
    n = o.shape[0]
    packed = pack_tris(tris)
    n_bins = -(-packed.table.shape[0] // PAIR_G)
    cap = torch.minimum(tb, scene_diam(o, packed.cmin, packed.cmax))
    iv = inv_dir(d)
    bmin, bmax = superchunk_boxes(packed.cmin, packed.cmax, PAIR_G)
    # Every (ray, bin) whose box the ray reaches below its cap: one exact
    # slab pass, blocked over rays.
    ray, bins = [], []
    block = max(1, DENSE_BLOCK // n_bins)
    for s in range(0, n, block):
        e = s + block
        ent = slab_entries(o[s:e, None], iv[s:e, None], cap[s:e, None],
                           bmin[None], bmax[None])
        r, b = torch.nonzero(ent < _BIG, as_tuple=True)
        ray.append(r + s)
        bins.append(b)
    ray, bins = torch.cat(ray), torch.cat(bins)
    t_miss, i_miss = _all_miss(n, o.device)
    if ray.shape[0] == 0:
        return t_miss, i_miss
    bins, order = torch.sort(bins, stable=True)
    ray = ray[order]
    rows, seg_bid, n_rows = _segment_layout(bins, n_bins)
    pair_dm, pair_o1 = _pair_rows(o, d, cap, ray, rows, n_rows)
    boxes = torch.cat([packed.cmin, packed.cmax], dim=1)
    t_row, i_row = pairbin_sweep(pair_dm, pair_o1, seg_bid, boxes,
                                 packed.table, t_min)
    # A row that found nothing returns its cap with no index; the index is
    # what tells it from a hit.
    t_new, i_new = _best_per_ray(n, ray, t_row[rows], i_row[rows])
    win = (i_new >= 0) & (t_new < tb)
    return torch.where(win, t_new, t_miss), torch.where(win, i_new, i_miss)


def _candidate_chunks(o, iv, cap, packed: PackedTris):
    """Every (ray, chunk) whose box the ray reaches below its cap, with the
    entry distance: a dense slab pass over the superchunks, blocked over
    rays, then the chunks of the superchunks reached.  Returns (ray, chunk,
    entry), in no particular order."""
    n_chunks = packed.table.shape[0]
    g = superchunk_size(n_chunks)
    smin, smax = superchunk_boxes(packed.cmin, packed.cmax, g)
    within = torch.arange(g, device=o.device)
    ray, chunk, entry = [], [], []
    block = max(1, DENSE_BLOCK // smin.shape[0])
    for s in range(0, o.shape[0], block):
        e = s + block
        ent = slab_entries(o[s:e, None], iv[s:e, None], cap[s:e, None],
                           smin[None], smax[None])
        r, sc = torch.nonzero(ent < _BIG, as_tuple=True)
        r = r + s
        c = sc[:, None] * g + within[None]
        cc = torch.clamp(c, max=n_chunks - 1)
        ent = slab_entries(o[r, None], iv[r, None], cap[r, None],
                           packed.cmin[cc], packed.cmax[cc])
        keep = (c < n_chunks) & (ent < _BIG)
        ray.append(r[:, None].expand(-1, g)[keep])
        chunk.append(cc[keep])
        entry.append(ent[keep])
    return torch.cat(ray), torch.cat(chunk), torch.cat(entry)


@torch.no_grad()
def pair_closest_hit(origin, direction, bvh: FlatBVH, tris: Triangles,
                     t_min: float, t_best0):
    """Closest triangle hit per ray below ``t_best0`` by rounds of the pair
    sweep; contract and arguments as :func:`pairbin_closest_hit`.  Each
    ray's candidate chunks are ordered front to back by its entry distance
    into their boxes; a round pairs every live ray with its next ``PAIR_E``
    candidates, and a ray is live while it has a candidate whose entry
    distance does not exceed its running best.  Every round costs host
    syncs (the live count and the layout's size)."""
    o, d, tb = _rays(origin, direction, t_best0)
    n = o.shape[0]
    packed = pack_tris(tris)
    n_chunks = packed.table.shape[0]
    cap = torch.minimum(tb, scene_diam(o, packed.cmin, packed.cmax))
    ray, chunk, entry = _candidate_chunks(o, inv_dir(d), cap, packed)
    if ray.shape[0] == 0:
        return _all_miss(n, o.device)
    # Front to back within each ray: by entry, then stably by ray.
    order = torch.argsort(entry, stable=True)
    order = order[torch.argsort(ray[order], stable=True)]
    chunk, entry = chunk[order], entry[order]
    counts = torch.bincount(ray, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    taken = torch.zeros_like(counts)
    t_best = tb.clone()
    i_best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    live = torch.nonzero(counts > 0)[:, 0]
    ahead = torch.arange(PAIR_E, device=o.device)
    while True:
        nxt = torch.clamp(start[live] + taken[live], max=entry.shape[0] - 1)
        live = live[(taken[live] < counts[live])
                    & (entry[nxt] <= t_best[live])]
        if live.shape[0] == 0:
            break
        k = taken[live][:, None] + ahead[None]                   # [L, E]
        ok = k < counts[live][:, None]
        pray = live[:, None].expand(-1, PAIR_E)[ok]
        pchunk = chunk[(start[live][:, None] + k)[ok]]
        pchunk, order = torch.sort(pchunk, stable=True)
        pray = pray[order]
        rows, seg_cid, n_rows = _segment_layout(pchunk, n_chunks)
        pair_dm, pair_o1 = _pair_rows(o, d, t_best, pray, rows, n_rows)
        t_row, i_row = pair_sweep(pair_dm, pair_o1, seg_cid, packed.table,
                                  t_min)
        t_new, i_new = _best_per_ray(n, pray, t_row[rows], i_row[rows])
        win = (i_new >= 0) & (t_new < t_best)
        t_best = torch.where(win, t_new, t_best)
        i_best = torch.where(win, i_new, i_best)
        taken[live] += PAIR_E
    return torch.where(i_best >= 0, t_best, INF), i_best
