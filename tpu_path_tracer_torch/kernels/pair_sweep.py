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

The emission feeds them the same way: :func:`emit_pairbin` and
:func:`emit_pair` (a round) lay out the rows, :func:`pairbin_best` and
:func:`pair_advance` reduce the sweep's rows to rays.  On CUDA tensors they
launch ``csrc/pair_emit.cu`` (histograms of keys per 256 rays, a scan, a
deterministic scatter, a 64-bit ``atomicMin`` per hit; one host sync per
call or round, the row count) and count their calls; on CPU tensors they
run their plain versions, the torch emission: ``nonzero`` of the candidate
matrix, one ``sort`` by chunk or bin, a padded layout by ``bincount`` and
``cumsum``, scatters back.  Both give the same rows, row for row: keys
ascending, rays ascending within a key, each key's run padded to a
multiple of 128 rows with zero rows.  The pair route's candidates
(:func:`_candidate_chunks` and its sorts) stay torch on both devices.
What the JAX emission adds for static shapes, gather cost or VMEM is left
out: payload sorts, the cummax layout, the u32 bitmaps and their bit pops,
the ``lax.switch`` size tiers, the Morton and lead-superchunk sort of the
rays, the tile-level candidate lists and the 640-chunk residency limit.  So
is the ``PAIRBIN_K`` = 16 candidate budget, whose overflow sends the whole
batch to the tile sweep in JAX: here every candidate of every ray is
emitted, and no ray takes another route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core import vecmath as vm
from ..core.types import FlatBVH, Triangles
from ..utils import profiling
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
# Rays per histogram cell of the emission on the card (csrc/pair_emit.cu
# EMIT_BLOCK).
EMIT_BLOCK = 256

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
    arithmetic of ``csrc/pair.cuh`` ``edge_test``, in its order."""
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
    profiling.count("pair_sweep")
    return t_out, i_out


def pairbin_sweep(pair_dm, pair_o1, seg_bid, boxes, table, t_min: float):
    """The pair-bin sweep (arguments and result as
    :func:`pairbin_sweep_plain`): CUDA tensors launch
    ``csrc/pair_sweep.cu`` on the current stream, CPU tensors run the plain
    version, any other device raises."""
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
    profiling.count("pairbin_sweep")
    return t_out, i_out


# ------------------------------------------------------------ emission


class PairRows(NamedTuple):
    """One sweep launch's rows, as the emission lays them out."""
    pair_dm: torch.Tensor  # [rows, 8] f32: d, o x d, bound, 0
    pair_o1: torch.Tensor  # [rows, 8] f32: o, 1, 0...
    seg: torch.Tensor      # [rows / 128] int32: the key of each segment
    ray: torch.Tensor      # [rows] int32: the ray of each row, -1 padding


def _no_rows(device):
    return PairRows(torch.zeros((0, 8), device=device),
                    torch.zeros((0, 8), device=device),
                    torch.zeros((0,), dtype=torch.int32, device=device),
                    torch.zeros((0,), dtype=torch.int32, device=device))


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


def _pair_rows(o, d, bound, ray, key, n_keys: int) -> PairRows:
    """The rows of pairs (``ray[k]``, ``key[k]``), sorted by key and, within
    a key, by ray: pair k at its row of :func:`_segment_layout`; padding rows
    are zero, and their bound 0 rejects every hit."""
    rows, seg, n_rows = _segment_layout(key, n_keys)
    n = o.shape[0]
    src_dm = torch.cat([d, vm.cross(o, d), bound[:, None],
                        o.new_zeros((n, 1))], dim=1)
    src_o1 = torch.cat([o, o.new_ones((n, 1)), o.new_zeros((n, 4))], dim=1)
    pair_dm = o.new_zeros((n_rows, 8))
    pair_o1 = o.new_zeros((n_rows, 8))
    pair_dm[rows] = src_dm[ray]
    pair_o1[rows] = src_o1[ray]
    row_ray = torch.full((n_rows,), -1, dtype=torch.int32, device=o.device)
    row_ray[rows] = ray.to(torch.int32)
    return PairRows(pair_dm, pair_o1, seg, row_ray)


def emit_pairbin_plain(o, d, cap, bmin, bmax) -> PairRows:
    """Plain version of the pair-bin emission: every (ray, bin) whose box
    ``[bmin, bmax]`` the ray reaches below its cap, by one exact slab pass
    blocked over rays, ``nonzero``, a stable sort by bin, and the padded
    layout; each row's bound is its ray's cap."""
    n_bins = bmin.shape[0]
    iv = inv_dir(d)
    ray, bins = [], []
    block = max(1, DENSE_BLOCK // n_bins)
    for s in range(0, o.shape[0], block):
        e = s + block
        ent = slab_entries(o[s:e, None], iv[s:e, None], cap[s:e, None],
                           bmin[None], bmax[None])
        r, b = torch.nonzero(ent < _BIG, as_tuple=True)
        ray.append(r + s)
        bins.append(b)
    ray, bins = torch.cat(ray), torch.cat(bins)
    if ray.shape[0] == 0:
        return _no_rows(o.device)
    bins, order = torch.sort(bins, stable=True)
    return _pair_rows(o, d, cap, ray[order], bins, n_bins)


def _round_live(t_best, taken, counts, start, entry):
    """The rays live this round: a candidate left whose entry distance does
    not exceed the running best."""
    nxt = torch.clamp(start.long() + taken, max=entry.shape[0] - 1)
    return (taken < counts) & (entry[nxt] <= t_best)


def emit_pair_plain(o, d, t_best, taken, counts, start, chunk, entry,
                    n_chunks: int) -> PairRows:
    """Plain version of a pair round's emission: every live ray paired with
    its next ``PAIR_E`` candidates (``chunk[start + taken ...]``, front to
    back), a stable sort by chunk, and the padded layout; each row's bound
    is its ray's running best."""
    live = torch.nonzero(_round_live(t_best, taken, counts, start,
                                     entry))[:, 0]
    if live.shape[0] == 0:
        return _no_rows(o.device)
    k = taken[live].long()[:, None] + torch.arange(PAIR_E, device=o.device)
    ok = k < counts[live][:, None]
    pray = live[:, None].expand(-1, PAIR_E)[ok]
    pchunk = chunk[(start[live].long()[:, None] + k)[ok]].long()
    pchunk, order = torch.sort(pchunk, stable=True)
    return _pair_rows(o, d, t_best, pray[order], pchunk, n_chunks)


def _best_per_ray(n: int, rows: PairRows, t, idx):
    """Reduce pair rows to rays: each ray's least t over its rows that hit
    (``idx >= 0``) and, among equal t, the least index; _NONE and -1 for a
    ray none of whose rows hit."""
    real = rows.ray >= 0
    ray, t, idx = rows.ray[real].long(), t[real], idx[real].to(torch.int64)
    t = torch.where(idx >= 0, t, _NONE)
    t_ray = torch.full((n,), _NONE, dtype=torch.float32,
                       device=t.device).scatter_reduce_(0, ray, t, "amin")
    tied = torch.where((idx >= 0) & (t == t_ray[ray]), idx, _INT32_MAX)
    i_ray = torch.full((n,), _INT32_MAX, dtype=torch.int64,
                       device=t.device).scatter_reduce_(0, ray, tied, "amin")
    return t_ray, torch.where(i_ray < _INT32_MAX, i_ray, -1)


def pairbin_best_plain(rows: PairRows, t_row, i_row, t_best0):
    """Plain version of the pair-bin reduction: each ray's closest hit over
    its rows when it is below ``t_best0``, else INF and -1 (the contract of
    ``closest_hit``).  A row that found nothing returns its cap with no
    index; the index is what tells it from a hit."""
    t_new, i_new = _best_per_ray(t_best0.shape[0], rows, t_row, i_row)
    win = (i_new >= 0) & (t_new < t_best0)
    return (torch.where(win, t_new, INF),
            torch.where(win, i_new, torch.full_like(i_new, -1)))


def pair_advance_plain(rows: PairRows, t_row, i_row, t_best, i_best, taken,
                       counts, start, entry):
    """Plain version of a pair round's reduction, in place: each ray live
    this round takes ``PAIR_E`` more candidates, and its round's closest
    hit when it is below its running best."""
    live = _round_live(t_best, taken, counts, start, entry)
    t_new, i_new = _best_per_ray(t_best.shape[0], rows, t_row, i_row)
    win = (i_new >= 0) & (t_new < t_best)
    t_best.copy_(torch.where(win, t_new, t_best))
    i_best.copy_(torch.where(win, i_new, i_best))
    taken.add_(live.to(taken.dtype) * PAIR_E)


# The emission on the card: csrc/pair_emit.cu.  Each wrapper counts one
# launch, under its own name, per call that launches its kernels.


class _EmitLib:
    """The emission's C entry points of one library: the CUDA ones, or with
    ``suffix="_host"`` the host build's, which take the same arguments."""

    def __init__(self, lib, suffix=""):
        p, i, f, q = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong)
        sig = {"tpt_pairbin_emit": [p, p, p, p, i, i, i] + [p] * 7,
               "tpt_pair_emit": [p] * 8 + [i, i] + [p] * 7,
               "tpt_pair_layout": [p, i, i, p, p, p, p, p],
               "tpt_pair_fill": [p, p, i, i, p, p, p, p, p],
               "tpt_pair_best": [p, p, p, q, p, i, i, p, f] + [p] * 7}
        for name, argtypes in sig.items():
            fn = getattr(lib, name + suffix)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            setattr(self, name[4:], fn)

    @staticmethod
    def check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUDA error {err}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _row_ptrs(rows):
    """The row arrays a scatter writes; none for a count."""
    if rows is None:
        return None, None, None
    return (rows.pair_dm.data_ptr(), rows.pair_o1.data_ptr(),
            rows.ray.data_ptr())


def _stream(device):
    return (torch.cuda.current_stream(device).cuda_stream
            if device.type == "cuda" else None)


def _lay_out(lib: _EmitLib, hist, n_keys: int, n_blocks: int, device,
             scatter):
    """Steps 2-5 of csrc/pair_emit.cu: the scan of ``hist``, the layout,
    the one host sync (rows and pairs, read together), then ``scatter(incl,
    shift, rows)`` and the fill.  Returns the rows, none when no pair."""
    stream = _stream(device)
    incl = torch.cumsum(hist.view(-1), 0, dtype=torch.int32)
    key_start = torch.empty((n_keys + 1,), dtype=torch.int32, device=device)
    shift = torch.empty((n_keys,), dtype=torch.int32, device=device)
    key_count = torch.empty_like(shift)
    sizes = torch.empty((2,), dtype=torch.int64, device=device)
    lib.check(lib.pair_layout(incl.data_ptr(), n_keys, n_blocks,
                              key_start.data_ptr(), shift.data_ptr(),
                              key_count.data_ptr(), sizes.data_ptr(),
                              stream), "pair layout kernel")
    profiling.count("host_syncs")
    n_rows, n_pairs = sizes.tolist()
    if n_pairs == 0:
        return _no_rows(device)
    if n_rows > _INT32_MAX:
        raise ValueError(f"{n_rows} pair rows do not fit the kernels' int32 "
                         f"indices")
    rows = PairRows(torch.empty((n_rows, 8), device=device),
                    torch.empty((n_rows, 8), device=device),
                    torch.empty((n_rows // TRI_CHUNK,), dtype=torch.int32,
                                device=device),
                    torch.empty((n_rows,), dtype=torch.int32, device=device))
    scatter(incl, shift, rows)
    lib.check(lib.pair_fill(key_start.data_ptr(), key_count.data_ptr(),
                            n_keys, rows.seg.shape[0], rows.seg.data_ptr(),
                            rows.pair_dm.data_ptr(), rows.pair_o1.data_ptr(),
                            rows.ray.data_ptr(), stream), "pair fill kernel")
    return rows


def _emit_pairbin_on(lib: _EmitLib, o, d, cap, bmin, bmax) -> PairRows:
    """The pair-bin emission through ``lib``'s entry points (the card's, or
    the host build's on CPU tensors)."""
    device = o.device
    n, n_bins = o.shape[0], bmin.shape[0]
    if n == 0:
        return _no_rows(device)
    if n * n_bins > _INT32_MAX:
        raise ValueError(f"{n} rays x {n_bins} bins do not fit the "
                         f"emission's int32 counts")
    n_blocks = -(-n // EMIT_BLOCK)
    stream = _stream(device)
    boxes = torch.cat([bmin, bmax], dim=1).to(torch.float32).contiguous()
    cap = cap.to(torch.float32).contiguous()
    hist = torch.zeros((n_bins, n_blocks), dtype=torch.int32, device=device)

    def emit(scatter, incl=None, shift=None, rows=None):
        lib.check(lib.pairbin_emit(
            o.data_ptr(), d.data_ptr(), cap.data_ptr(), boxes.data_ptr(), n,
            n_bins, int(scatter), hist.data_ptr(), _ptr(incl), _ptr(shift),
            *_row_ptrs(rows), stream), "pair-bin emission kernel")

    emit(False)
    return _lay_out(lib, hist, n_bins, n_blocks, device,
                    lambda incl, shift, rows: emit(True, incl, shift, rows))


def _emit_pair_on(lib: _EmitLib, o, d, t_best, taken, counts, start, chunk,
                  entry, n_chunks: int) -> PairRows:
    """A pair round's emission through ``lib``'s entry points."""
    device = o.device
    n = o.shape[0]
    if n == 0:
        return _no_rows(device)
    n_blocks = -(-n // EMIT_BLOCK)
    stream = _stream(device)
    hist = torch.zeros((n_chunks, n_blocks), dtype=torch.int32, device=device)
    state = [x.data_ptr() for x in (o, d, t_best, taken, counts, start,
                                    chunk, entry)]

    def emit(scatter, incl=None, shift=None, rows=None):
        lib.check(lib.pair_emit(
            *state, n, int(scatter), hist.data_ptr(), _ptr(incl),
            _ptr(shift), *_row_ptrs(rows), stream), "pair emission kernel")

    emit(False)
    return _lay_out(lib, hist, n_chunks, n_blocks, device,
                    lambda incl, shift, rows: emit(True, incl, shift, rows))


def _best_on(lib: _EmitLib, rows: PairRows, t_row, i_row, n: int, advance,
             t_best0=None, t_out=None, i_out=None, counts=None, start=None,
             entry=None, taken=None):
    """Step 6 through ``lib``'s entry points."""
    device = t_row.device
    best = torch.full((n,), -1, dtype=torch.int64, device=device)
    lib.check(lib.pair_best(
        t_row.data_ptr(), i_row.data_ptr(), rows.ray.data_ptr(),
        rows.ray.shape[0], best.data_ptr(), n, int(advance), _ptr(t_best0),
        INF, t_out.data_ptr(), i_out.data_ptr(), _ptr(counts), _ptr(start),
        _ptr(entry), _ptr(taken), _stream(device)), "pair reduction kernel")


def _on_card(x, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device
    raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no route for device {x.device}")
    return True


def _card_lib():
    from . import _build

    return _EmitLib(_build.load())


def emit_pairbin(o, d, cap, bmin, bmax) -> PairRows:
    """The pair-bin emission (arguments and result as
    :func:`emit_pairbin_plain`; ``o``, ``d``, ``cap`` float32 and
    contiguous): CUDA tensors launch ``csrc/pair_emit.cu``, CPU tensors run
    the plain version, any other device raises."""
    if not _on_card(o, "emit_pairbin"):
        return emit_pairbin_plain(o, d, cap, bmin, bmax)
    rows = _emit_pairbin_on(_card_lib(), o, d, cap, bmin, bmax)
    profiling.count("emit_pairbin")
    return rows


def emit_pair(o, d, t_best, taken, counts, start, chunk, entry,
              n_chunks: int) -> PairRows:
    """A pair round's emission (arguments and result as
    :func:`emit_pair_plain`; taken, counts, start and chunk int32, the rest
    float32, all contiguous): CUDA tensors launch ``csrc/pair_emit.cu``, CPU
    tensors run the plain version, any other device raises."""
    if not _on_card(o, "emit_pair"):
        return emit_pair_plain(o, d, t_best, taken, counts, start, chunk,
                               entry, n_chunks)
    rows = _emit_pair_on(_card_lib(), o, d, t_best, taken, counts, start,
                         chunk, entry, n_chunks)
    profiling.count("emit_pair")
    return rows


def pairbin_best(rows: PairRows, t_row, i_row, t_best0):
    """The pair-bin reduction (as :func:`pairbin_best_plain`): CUDA tensors
    launch ``csrc/pair_emit.cu``, CPU tensors run the plain version."""
    if not _on_card(t_row, "pairbin_best"):
        return pairbin_best_plain(rows, t_row, i_row, t_best0)
    n = t_best0.shape[0]
    t_out = torch.empty((n,), dtype=torch.float32, device=t_row.device)
    i_out = torch.empty((n,), dtype=torch.int64, device=t_row.device)
    _best_on(_card_lib(), rows, t_row, i_row, n, False, t_best0=t_best0,
             t_out=t_out, i_out=i_out)
    profiling.count("pairbin_best")
    return t_out, i_out


def pair_advance(rows: PairRows, t_row, i_row, t_best, i_best, taken, counts,
                 start, entry):
    """A pair round's reduction, in place (as :func:`pair_advance_plain`):
    CUDA tensors launch ``csrc/pair_emit.cu``, CPU tensors run the plain
    version."""
    if not _on_card(t_row, "pair_advance"):
        pair_advance_plain(rows, t_row, i_row, t_best, i_best, taken, counts,
                           start, entry)
        return
    _best_on(_card_lib(), rows, t_row, i_row, t_best.shape[0], True,
             t_out=t_best, i_out=i_best, counts=counts, start=start,
             entry=entry, taken=taken)
    profiling.count("pair_advance")


def _all_miss(n: int, device):
    """What ``closest_hit`` returns when no ray hits."""
    return (torch.full((n,), INF, dtype=torch.float32, device=device),
            torch.full((n,), -1, dtype=torch.int64, device=device))


def _check_t_min(t_min: float, device):
    # The card's reduction orders hits by the bits of t, which order like
    # the values only for t > 0; every hit has t >= t_min.
    if device.type == "cuda" and not t_min > 0:
        raise ValueError(f"t_min must be positive on the card, got {t_min}")


@torch.no_grad()
def pairbin_closest_hit(origin, direction, bvh: FlatBVH, tris: Triangles,
                        t_min: float, t_best0):
    """Closest triangle hit per ray below ``t_best0`` by the single-shot
    pair-bin sweep; the contract of ``kernels.traversal.closest_hit``:
    (t ``[N]``, tri_index ``[N]`` int64), INF and -1 on a miss; a negative
    ``t_best0`` marks a retired lane, which emits no pair.  ``bvh`` is not
    read (the triangle order is already the BVH's); it is taken so that the
    entry points are interchangeable.  On the card: one host sync (the
    emission's row count)."""
    o, d, tb = _rays(origin, direction, t_best0)
    _check_t_min(t_min, o.device)
    packed = pack_tris(tris)
    cap = torch.minimum(tb, scene_diam(o, packed.cmin, packed.cmax))
    bmin, bmax = superchunk_boxes(packed.cmin, packed.cmax, PAIR_G)
    rows = emit_pairbin(o, d, cap, bmin, bmax)
    if rows.ray.shape[0] == 0:
        return _all_miss(o.shape[0], o.device)
    boxes = torch.cat([packed.cmin, packed.cmax], dim=1)
    t_row, i_row = pairbin_sweep(rows.pair_dm, rows.pair_o1, rows.seg, boxes,
                                 packed.table, t_min)
    return pairbin_best(rows, t_row, i_row, tb)


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
    into their boxes (torch, with host syncs); a round pairs every live ray
    with its next ``PAIR_E`` candidates, and a ray is live while it has a
    candidate whose entry distance does not exceed its running best.  On
    the card each round costs one host sync (the emission's row and pair
    counts); the last round finds no pair."""
    o, d, tb = _rays(origin, direction, t_best0)
    _check_t_min(t_min, o.device)
    n = o.shape[0]
    packed = pack_tris(tris)
    n_chunks = packed.table.shape[0]
    cap = torch.minimum(tb, scene_diam(o, packed.cmin, packed.cmax))
    ray, chunk, entry = _candidate_chunks(o, inv_dir(d), cap, packed)
    if ray.shape[0] == 0:
        return _all_miss(n, o.device)
    if ray.shape[0] > _INT32_MAX:
        raise ValueError(f"{ray.shape[0]} candidates do not fit the "
                         f"emission's int32 indices")
    # Front to back within each ray: by entry, then stably by ray.
    order = torch.argsort(entry, stable=True)
    order = order[torch.argsort(ray[order], stable=True)]
    chunk = chunk[order].to(torch.int32)
    entry = entry[order].contiguous()
    counts = torch.bincount(ray, minlength=n)
    start = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    counts = counts.to(torch.int32)
    taken = torch.zeros_like(counts)
    t_best = tb.clone()
    i_best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    while True:
        rows = emit_pair(o, d, t_best, taken, counts, start, chunk, entry,
                         n_chunks)
        if rows.ray.shape[0] == 0:
            break
        t_row, i_row = pair_sweep(rows.pair_dm, rows.pair_o1, rows.seg,
                                  packed.table, t_min)
        pair_advance(rows, t_row, i_row, t_best, i_best, taken, counts,
                     start, entry)
    return torch.where(i_best >= 0, t_best, INF), i_best
