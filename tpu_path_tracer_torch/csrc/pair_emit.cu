// The emission of the pair sweeps on the card (sm_90a): the pair rows that
// pairbin_sweep_kernel and pair_sweep_kernel (pair_sweep.cu) read, and the
// reduction of their results to one closest hit per ray.
//
// Counterpart of the JAX emission, tpu_path_tracer/kernels/pallas/
// traversal.py:1447 _pairbin_path and :1755 pair_closest_hit (XLA ops around
// the TPU kernels), read for what it computes.  The rows are exactly those
// of the torch emission in kernels/pair_sweep.py (the plain version): pairs
// sorted by key (bin or chunk), rays ascending within a key, each key's run
// padded to a multiple of 128 rows, padding rows all zero, a real row
// holding [d, o x d (as vecmath.cross rounds it), bound, 0] and [o, 1, 0,
// 0, 0, 0].  Steps, each a kernel:
//
// 1. count: each block of 256 consecutive rays counts its pairs per key
//    into hist [keys, blocks] (key-major).  Pair-bin: every ray is
//    slab-tested against every bin box below its cap (the boxes staged in
//    shared memory), one ballot a warp and bin, the ballots summed over the
//    block.  Pair: a live ray's next two candidate chunks, with an atomic
//    add each (a sum, so the count is the same in any order).
// 2. an inclusive scan of hist in key-major order (torch.cumsum, outside):
//    for key k and block b it gives the pairs of keys below k plus those
//    of key k in blocks up to b, so a pair's place in the key-sorted, ray-
//    ascending order is that scan minus its block's count plus its rank
//    among the block's rays.  A cell covers 256 rays, not a warp's 32, so
//    the histogram and its scan are an eighth of the size: they grow with
//    keys x rays, and with 2,560 chunks and a million rays a warp's cells
//    would be 335 MB a round.
// 3. layout (one block): per key its pair count, its padded row start and
//    the shift from pair rank to row; the row and pair totals.  The caller
//    reads the totals (its one host sync) to size the rows.
// 4. scatter: step 1 again, each pair writing its row at shift + rank.
//    Ranks within a block: the lower warps' ballots and the own ballot's
//    lower lanes (pair-bin, the ballots kept in shared memory); a
//    comparison with the keys of the block's lower rays, kept in shared
//    memory (pair).
// 5. fill: per 128-row segment its key (a binary search of the row starts)
//    and zeros in its padding rows.
// 6. after the sweep, reduce: one 64-bit atomicMin per row that hit, on
//    (bits of t) << 32 | index, into its ray.  Hits have t >= t_min > 0,
//    so the bits order like the values, and the minimum is the least t and
//    among equal t the least index, in any order of the rows; then
//    finalize (pair-bin: the hit below the ray's bound, or INF and -1) or
//    advance (pair: a ray's best and its candidates taken).
//
// What bounds it: bytes, the rows written (64 B a pair) and the histogram
// (4 B a key and block, written, scanned and read), beside 25 FP32
// operations a slab test, twice per (ray, bin).  Order and layout
// decisions take no floating point, and every value written is a copy or
// one rounding of the plain version's.
//
// Built without nvcc, this file compiles the per-ray and per-key code and
// host entry points that run the steps on the CPU with the same functions
// (the blocks' ballots and ranks as loops over their rays).

#include <string.h>

#include "pair.cuh"

namespace tpt {

constexpr int EMIT_LANES = 32;
constexpr int EMIT_BLOCK = 256;  // rays of a histogram cell, and a block
constexpr int EMIT_WARPS = EMIT_BLOCK / EMIT_LANES;
constexpr int PAIR_E = 2;  // pairs a live ray takes per round (PAIR_E)

// The two arrays of one real pair row.
TPT_HD void write_pair_row(float* dm, float* o1, long long row, float ox,
                           float oy, float oz, float dx, float dy, float dz,
                           float bound) {
  float* a = dm + 8 * row;
  float* b = o1 + 8 * row;
  a[0] = dx;
  a[1] = dy;
  a[2] = dz;
  a[3] = oy * dz - oz * dy;
  a[4] = oz * dx - ox * dz;
  a[5] = ox * dy - oy * dx;
  a[6] = bound;
  a[7] = 0.0f;
  b[0] = ox;
  b[1] = oy;
  b[2] = oz;
  b[3] = 1.0f;
  b[4] = b[5] = b[6] = b[7] = 0.0f;
}

TPT_HD void zero_pair_row(float* dm, float* o1, long long row) {
  for (int k = 0; k < 8; ++k) dm[8 * row + k] = o1[8 * row + k] = 0.0f;
}

// Key k's pairs before it and its own, from the inclusive scan.
TPT_HD void key_pairs(const int* incl, int k, int n_blocks,
                      long long& before, long long& count) {
  before = k > 0 ? incl[(long long)k * n_blocks - 1] : 0;
  count = incl[(long long)(k + 1) * n_blocks - 1] - before;
}

TPT_HD long long padded_rows(long long count) {
  return (count + PAIR_CHUNK - 1) / PAIR_CHUNK * PAIR_CHUNK;
}

// The key whose padded run holds `row`: the last k with key_start[k] <= row.
TPT_HD int key_of_row(const int* key_start, int n_keys, long long row) {
  int lo = 0, hi = n_keys - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (key_start[mid] <= row) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// A ray of the pair route and the keys (chunks) it takes this round: its
// next PAIR_E candidates while it is live, that is while it has a candidate
// left whose entry distance does not exceed its running best.  Returns the
// number of keys.
TPT_HD int round_keys(int r, const float* t_best, const int* taken,
                      const int* counts, const int* start, const int* chunk,
                      const float* entry, int (&keys)[PAIR_E]) {
  keys[0] = keys[1] = -1;
  const int k0 = taken[r];
  if (k0 >= counts[r] || !(entry[start[r] + k0] <= t_best[r])) return 0;
  const int m = counts[r] - k0 < PAIR_E ? counts[r] - k0 : PAIR_E;
  for (int i = 0; i < m; ++i) keys[i] = chunk[start[r] + k0 + i];
  return m;
}

// The packed (t, index) of a hit, ordered like (t, index) for t > 0.
TPT_HD unsigned long long hit_key(float t, int idx) {
  unsigned int bits;
#ifdef __CUDA_ARCH__
  bits = __float_as_uint(t);
#else
  memcpy(&bits, &t, sizeof bits);
#endif
  return ((unsigned long long)bits << 32) | (unsigned int)idx;
}

TPT_HD float key_t(unsigned long long key) {
  const unsigned int bits = (unsigned int)(key >> 32);
#ifdef __CUDA_ARCH__
  return __uint_as_float(bits);
#else
  float t;
  memcpy(&t, &bits, sizeof t);
  return t;
#endif
}

constexpr unsigned long long NO_HIT_KEY = ~0ull;

// Step 3 for one key, on the host and in the layout kernel.
TPT_HD void layout_key(const int* incl, int k, int n_blocks, long long row0,
                       int* key_start, int* shift, int* key_count) {
  long long before, count;
  key_pairs(incl, k, n_blocks, before, count);
  key_start[k] = (int)row0;
  shift[k] = (int)(row0 - before);
  key_count[k] = (int)count;
}

// Step 5 for one row.
TPT_HD void fill_row(const int* key_start, const int* key_count, int key,
                     long long row, float* dm, float* o1, int* row_ray) {
  if (row - key_start[key] >= key_count[key]) {
    zero_pair_row(dm, o1, row);
    row_ray[row] = -1;
  }
}

// Step 6 for one ray of the pair-bin route: its hit below t_best0, or inf
// and -1.
TPT_HD void finalize_ray(const unsigned long long* best,
                         const float* t_best0, int r, float inf,
                         float* t_out, long long* i_out) {
  const unsigned long long key = best[r];
  const float t = key_t(key);
  const bool win = key != NO_HIT_KEY && t < t_best0[r];
  t_out[r] = win ? t : inf;
  i_out[r] = win ? (long long)(unsigned int)key : -1;
}

// Step 6 for one ray of a pair round: a ray live this round (round_keys'
// test, on the state before the round) has taken PAIR_E more candidates,
// and takes its round's hit when it is closer than its running best.
TPT_HD void advance_ray(const unsigned long long* best, const int* counts,
                        const int* start, const float* entry, int r,
                        float* t_best, long long* i_best, int* taken) {
  const int k0 = taken[r];
  if (k0 >= counts[r] || !(entry[start[r] + k0] <= t_best[r])) return;
  taken[r] = k0 + PAIR_E;
  const unsigned long long key = best[r];
  const float t = key_t(key);
  if (key != NO_HIT_KEY && t < t_best[r]) {
    t_best[r] = t;
    i_best[r] = (long long)(unsigned int)key;
  }
}

}  // namespace tpt

// Host entry points, bound with ctypes by the tests: the C entry points
// below, argument for argument (the stream is not read; each returns 0),
// with a block's ballots and ranks as loops over its 256 rays.
extern "C" int tpt_pairbin_emit_host(const float* o, const float* d,
                                     const float* cap, const float* boxes,
                                     int n, int n_bins, int scatter,
                                     int* hist, const int* incl,
                                     const int* shift, float* dm, float* o1,
                                     int* row_ray, void*) {
  using namespace tpt;
  const int n_blocks = (n + EMIT_BLOCK - 1) / EMIT_BLOCK;
  for (int blk = 0; blk < n_blocks; ++blk) {
    for (int b = 0; b < n_bins; ++b) {
      const long long cell = (long long)b * n_blocks + blk;
      long long row = scatter ? shift[b] + (long long)incl[cell] - hist[cell]
                              : 0;
      int count = 0;
      for (int r = blk * EMIT_BLOCK; r < n && r < (blk + 1) * EMIT_BLOCK;
           ++r) {
        const V3 iv = inv_dir3(d[3 * r], d[3 * r + 1], d[3 * r + 2]);
        if (!slab_hit(boxes + 6 * b, o[3 * r], o[3 * r + 1], o[3 * r + 2],
                      iv, cap[r])) {
          continue;
        }
        ++count;
        if (scatter) {
          write_pair_row(dm, o1, row, o[3 * r], o[3 * r + 1], o[3 * r + 2],
                         d[3 * r], d[3 * r + 1], d[3 * r + 2], cap[r]);
          row_ray[row++] = r;
        }
      }
      if (!scatter && count) hist[cell] = count;
    }
  }
  return 0;
}

extern "C" int tpt_pair_emit_host(const float* o, const float* d,
                                  const float* t_best, const int* taken,
                                  const int* counts, const int* start,
                                  const int* chunk, const float* entry, int n,
                                  int scatter, int* hist, const int* incl,
                                  const int* shift, float* dm, float* o1,
                                  int* row_ray, void*) {
  using namespace tpt;
  const int n_blocks = (n + EMIT_BLOCK - 1) / EMIT_BLOCK;
  for (int r = 0; r < n; ++r) {
    int keys[PAIR_E];
    const int m = round_keys(r, t_best, taken, counts, start, chunk, entry,
                             keys);
    const int blk = r / EMIT_BLOCK;
    for (int i = 0; i < m; ++i) {
      const long long cell = (long long)keys[i] * n_blocks + blk;
      if (!scatter) {
        hist[cell] += 1;
        continue;
      }
      // The block's lower rays that take the same key.
      int rank = 0;
      for (int l = blk * EMIT_BLOCK; l < r; ++l) {
        int other[PAIR_E];
        round_keys(l, t_best, taken, counts, start, chunk, entry, other);
        rank += (other[0] == keys[i]) + (other[1] == keys[i]);
      }
      const long long row =
          shift[keys[i]] + (long long)incl[cell] - hist[cell] + rank;
      write_pair_row(dm, o1, row, o[3 * r], o[3 * r + 1], o[3 * r + 2],
                     d[3 * r], d[3 * r + 1], d[3 * r + 2], t_best[r]);
      row_ray[row] = r;
    }
  }
  return 0;
}

extern "C" int tpt_pair_layout_host(const int* incl, int n_keys,
                                    int n_blocks, int* key_start, int* shift,
                                    int* key_count, long long* sizes, void*) {
  using namespace tpt;
  long long row = 0;
  for (int k = 0; k < n_keys; ++k) {
    layout_key(incl, k, n_blocks, row, key_start, shift, key_count);
    row += padded_rows(key_count[k]);
  }
  key_start[n_keys] = (int)row;
  sizes[0] = row;
  sizes[1] = incl[(long long)n_keys * n_blocks - 1];
  return 0;
}

extern "C" int tpt_pair_fill_host(const int* key_start, const int* key_count,
                                  int n_keys, int n_segs, int* seg_id,
                                  float* dm, float* o1, int* row_ray, void*) {
  using namespace tpt;
  for (int s = 0; s < n_segs; ++s) {
    const long long row0 = (long long)s * PAIR_CHUNK;
    const int key = key_of_row(key_start, n_keys, row0);
    seg_id[s] = key;
    for (int k = 0; k < PAIR_CHUNK; ++k) {
      fill_row(key_start, key_count, key, row0 + k, dm, o1, row_ray);
    }
  }
  return 0;
}

extern "C" int tpt_pair_best_host(const float* t_row, const int* i_row,
                                  const int* row_ray, long long n_rows,
                                  unsigned long long* best, int n,
                                  int advance, const float* t_best0,
                                  float inf, float* t_out, long long* i_out,
                                  const int* counts, const int* start,
                                  const float* entry, int* taken, void*) {
  using namespace tpt;
  for (long long row = 0; row < n_rows; ++row) {
    const int ray = row_ray[row], idx = i_row[row];
    if (ray < 0 || idx < 0) continue;
    const unsigned long long key = hit_key(t_row[row], idx);
    if (key < best[ray]) best[ray] = key;
  }
  for (int r = 0; r < n; ++r) {
    if (advance) {
      advance_ray(best, counts, start, entry, r, t_out, i_out, taken);
    } else {
      finalize_ray(best, t_best0, r, inf, t_out, i_out);
    }
  }
  return 0;
}

#ifdef __CUDACC__

namespace {

using namespace tpt;

constexpr int BOX_TILE = 512;     // bin boxes staged at a time (12 KB)
constexpr int LAYOUT_THREADS = 1024;
constexpr int ROW_THREADS = 256;

struct EmitRay {
  float ox, oy, oz, dx, dy, dz, cap;
  V3 iv;
  bool valid;
};

__device__ __forceinline__ EmitRay load_emit_ray(const float* o,
                                                 const float* d,
                                                 const float* cap, int r,
                                                 int n) {
  EmitRay e;
  e.valid = r < n;
  const int q = e.valid ? r : 0;
  e.ox = o[3 * q];
  e.oy = o[3 * q + 1];
  e.oz = o[3 * q + 2];
  e.dx = d[3 * q];
  e.dy = d[3 * q + 1];
  e.dz = d[3 * q + 2];
  e.cap = cap[q];
  e.iv = inv_dir3(e.dx, e.dy, e.dz);
  return e;
}

// Steps 1 and 4 of the pair-bin emission share this loop over the bins;
// `scatter` selects step 4.  Block b holds rays [256 b, 256 b + 256).
template <bool scatter>
__global__ void __launch_bounds__(EMIT_BLOCK)
pairbin_emit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ cap,
                    const float* __restrict__ boxes, int n, int n_bins,
                    int* __restrict__ hist, const int* __restrict__ incl,
                    const int* __restrict__ shift, float* __restrict__ dm,
                    float* __restrict__ o1, int* __restrict__ row_ray) {
  __shared__ float sbox[BOX_TILE * 6];
  __shared__ unsigned sbal[EMIT_WARPS][BOX_TILE];  // a tile's ballots
  const int lane = threadIdx.x % EMIT_LANES, warp = threadIdx.x / EMIT_LANES;
  const int blk = blockIdx.x, n_blocks = gridDim.x;
  const int r = blk * EMIT_BLOCK + threadIdx.x;
  const EmitRay e = load_emit_ray(o, d, cap, r, n);
  const unsigned below = (1u << lane) - 1u;
  for (int b0 = 0; b0 < n_bins; b0 += BOX_TILE) {
    const int tile = min(BOX_TILE, n_bins - b0);
    __syncthreads();  // the last tile's boxes and ballots are read
    for (int i = threadIdx.x; i < tile * 6; i += EMIT_BLOCK) {
      sbox[i] = boxes[(long long)b0 * 6 + i];
    }
    __syncthreads();
    for (int b = 0; b < tile; ++b) {
      const unsigned bal = __ballot_sync(
          0xffffffffu,
          e.valid && slab_hit(sbox + 6 * b, e.ox, e.oy, e.oz, e.iv, e.cap));
      if (lane == 0) sbal[warp][b] = bal;
    }
    __syncthreads();
    if (!scatter) {
      for (int b = threadIdx.x; b < tile; b += EMIT_BLOCK) {
        int count = 0;
#pragma unroll
        for (int w = 0; w < EMIT_WARPS; ++w) count += __popc(sbal[w][b]);
        if (count) hist[(long long)(b0 + b) * n_blocks + blk] = count;
      }
    }
    for (int b = 0; scatter && b < tile; ++b) {
      const unsigned bal = sbal[warp][b];
      if (!((bal >> lane) & 1u)) continue;
      int before = 0, count = 0;  // the lower warps' pairs, the block's
#pragma unroll
      for (int w = 0; w < EMIT_WARPS; ++w) {
        const int c = __popc(sbal[w][b]);
        before += w < warp ? c : 0;
        count += c;
      }
      const long long cell = (long long)(b0 + b) * n_blocks + blk;
      const long long row = shift[b0 + b] + (long long)incl[cell] - count +
                            before + __popc(bal & below);
      write_pair_row(dm, o1, row, e.ox, e.oy, e.oz, e.dx, e.dy, e.dz, e.cap);
      row_ray[row] = r;
    }
  }
}

// Steps 1 and 4 of a pair round.  Block b holds rays [256 b, 256 b + 256).
template <bool scatter>
__global__ void __launch_bounds__(EMIT_BLOCK)
pair_emit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_best,
                 const int* __restrict__ taken,
                 const int* __restrict__ counts,
                 const int* __restrict__ start,
                 const int* __restrict__ chunk,
                 const float* __restrict__ entry, int n,
                 int* __restrict__ hist, const int* __restrict__ incl,
                 const int* __restrict__ shift, float* __restrict__ dm,
                 float* __restrict__ o1, int* __restrict__ row_ray) {
  __shared__ int skeys[EMIT_BLOCK * PAIR_E];  // the block's keys, ray-major
  const int blk = blockIdx.x, n_blocks = gridDim.x;
  const int r = blk * EMIT_BLOCK + threadIdx.x;
  int keys[PAIR_E] = {-1, -1};
  const int m =
      r < n ? round_keys(r, t_best, taken, counts, start, chunk, entry, keys)
            : 0;
  if (!scatter) {
#pragma unroll
    for (int i = 0; i < PAIR_E; ++i) {
      if (i < m) atomicAdd(hist + (long long)keys[i] * n_blocks + blk, 1);
    }
    return;
  }
  const int own = PAIR_E * threadIdx.x;
#pragma unroll
  for (int i = 0; i < PAIR_E; ++i) skeys[own + i] = keys[i];
  if (!__syncthreads_or(m > 0)) return;  // no live ray in the block
  // The block's lower rays that take the same key (a ray's two keys
  // differ, and -1 matches no key taken).
  int rank[PAIR_E] = {0, 0};
  for (int j = 0; j < own; ++j) {
    const int k = skeys[j];
#pragma unroll
    for (int i = 0; i < PAIR_E; ++i) rank[i] += k == keys[i];
  }
#pragma unroll
  for (int i = 0; i < PAIR_E; ++i) {
    if (i >= m) break;
    const long long cell = (long long)keys[i] * n_blocks + blk;
    const long long row =
        shift[keys[i]] + (long long)incl[cell] - hist[cell] + rank[i];
    write_pair_row(dm, o1, row, o[3 * r], o[3 * r + 1], o[3 * r + 2],
                   d[3 * r], d[3 * r + 1], d[3 * r + 2], t_best[r]);
    row_ray[row] = r;
  }
}

__global__ void __launch_bounds__(LAYOUT_THREADS)
pair_layout_kernel(const int* __restrict__ incl, int n_keys, int n_blocks,
                   int* __restrict__ key_start, int* __restrict__ shift,
                   int* __restrict__ key_count,
                   long long* __restrict__ sizes) {
  __shared__ long long warp_sum[LAYOUT_THREADS / EMIT_LANES];
  __shared__ long long carry;
  const int lane = threadIdx.x % EMIT_LANES, warp = threadIdx.x / EMIT_LANES;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int k0 = 0; k0 < n_keys; k0 += LAYOUT_THREADS) {
    const int k = k0 + threadIdx.x;
    long long before = 0, count = 0;
    if (k < n_keys) key_pairs(incl, k, n_blocks, before, count);
    const long long own = padded_rows(count);
    long long x = own;  // inclusive scan of the padded counts
    for (int s = 1; s < EMIT_LANES; s *= 2) {
      const long long y = __shfl_up_sync(0xffffffffu, x, s);
      if (lane >= s) x += y;
    }
    if (lane == EMIT_LANES - 1) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long v = warp_sum[lane];
      for (int s = 1; s < EMIT_LANES; s *= 2) {
        const long long y = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v += y;
      }
      warp_sum[lane] = v;
    }
    __syncthreads();
    const long long row0 = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x -
                           own;
    if (k < n_keys) layout_key(incl, k, n_blocks, row0, key_start, shift,
                               key_count);
    __syncthreads();
    if (threadIdx.x == LAYOUT_THREADS - 1) carry = row0 + own;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    key_start[n_keys] = (int)carry;
    sizes[0] = carry;
    sizes[1] = incl[(long long)n_keys * n_blocks - 1];
  }
}

__global__ void __launch_bounds__(PAIR_CHUNK)
pair_fill_kernel(const int* __restrict__ key_start,
                 const int* __restrict__ key_count, int n_keys,
                 int* __restrict__ seg_id, float* __restrict__ dm,
                 float* __restrict__ o1, int* __restrict__ row_ray) {
  __shared__ int key;
  const long long row0 = (long long)blockIdx.x * PAIR_CHUNK;
  if (threadIdx.x == 0) {
    key = key_of_row(key_start, n_keys, row0);
    seg_id[blockIdx.x] = key;
  }
  __syncthreads();
  fill_row(key_start, key_count, key, row0 + threadIdx.x, dm, o1, row_ray);
}

__global__ void __launch_bounds__(ROW_THREADS)
pair_reduce_kernel(const float* __restrict__ t_row,
                   const int* __restrict__ i_row,
                   const int* __restrict__ row_ray, long long n_rows,
                   unsigned long long* __restrict__ best) {
  const long long row = (long long)blockIdx.x * ROW_THREADS + threadIdx.x;
  if (row >= n_rows) return;
  const int ray = row_ray[row], idx = i_row[row];
  if (ray >= 0 && idx >= 0) atomicMin(best + ray, hit_key(t_row[row], idx));
}

__global__ void __launch_bounds__(ROW_THREADS)
pairbin_finalize_kernel(const unsigned long long* __restrict__ best,
                        const float* __restrict__ t_best0, int n, float inf,
                        float* __restrict__ t_out,
                        long long* __restrict__ i_out) {
  const int r = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (r < n) finalize_ray(best, t_best0, r, inf, t_out, i_out);
}

__global__ void __launch_bounds__(ROW_THREADS)
pair_advance_kernel(const unsigned long long* __restrict__ best,
                    const int* __restrict__ counts,
                    const int* __restrict__ start,
                    const float* __restrict__ entry, int n,
                    float* __restrict__ t_best, long long* __restrict__ i_best,
                    int* __restrict__ taken) {
  const int r = blockIdx.x * ROW_THREADS + threadIdx.x;
  if (r < n) advance_ray(best, counts, start, entry, r, t_best, i_best, taken);
}

int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

// C entry points, bound with ctypes (kernels/pair_sweep.py); each returns
// cudaGetLastError() after its launches.  Rays: o, d [n, 3], cap or t_best
// [n]; hist and incl [keys, ceil(n / 256)] int32; key_start [keys + 1],
// shift and key_count [keys] int32; sizes [2] int64 (rows, pairs); rows:
// dm, o1 [rows, 8], row_ray [rows], seg_id [rows / 128].

// Pair-bin steps 1 (scatter = 0) and 4 (scatter = 1) over bin boxes [n_bins,
// 6].
extern "C" int tpt_pairbin_emit(const float* o, const float* d,
                                const float* cap, const float* boxes, int n,
                                int n_bins, int scatter, int* hist,
                                const int* incl, const int* shift, float* dm,
                                float* o1, int* row_ray, void* stream) {
  const int blocks = blocks_for(n, EMIT_BLOCK);
  if (blocks == 0) return (int)cudaSuccess;
  if (scatter) {
    pairbin_emit_kernel<true><<<blocks, EMIT_BLOCK, 0,
                                (cudaStream_t)stream>>>(
        o, d, cap, boxes, n, n_bins, nullptr, incl, shift, dm, o1, row_ray);
  } else {
    pairbin_emit_kernel<false><<<blocks, EMIT_BLOCK, 0,
                                 (cudaStream_t)stream>>>(
        o, d, cap, boxes, n, n_bins, hist, nullptr, nullptr, nullptr,
        nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

// Pair-round steps 1 (scatter = 0; hist zeroed by the caller) and 4.
extern "C" int tpt_pair_emit(const float* o, const float* d,
                             const float* t_best, const int* taken,
                             const int* counts, const int* start,
                             const int* chunk, const float* entry, int n,
                             int scatter, int* hist, const int* incl,
                             const int* shift, float* dm, float* o1,
                             int* row_ray, void* stream) {
  const int blocks = blocks_for(n, EMIT_BLOCK);
  if (blocks == 0) return (int)cudaSuccess;
  if (scatter) {
    pair_emit_kernel<true><<<blocks, EMIT_BLOCK, 0, (cudaStream_t)stream>>>(
        o, d, t_best, taken, counts, start, chunk, entry, n, hist, incl,
        shift, dm, o1, row_ray);
  } else {
    pair_emit_kernel<false><<<blocks, EMIT_BLOCK, 0,
                              (cudaStream_t)stream>>>(
        o, d, t_best, taken, counts, start, chunk, entry, n, hist, nullptr,
        nullptr, nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int tpt_pair_layout(const int* incl, int n_keys, int n_blocks,
                               int* key_start, int* shift, int* key_count,
                               long long* sizes, void* stream) {
  pair_layout_kernel<<<1, LAYOUT_THREADS, 0, (cudaStream_t)stream>>>(
      incl, n_keys, n_blocks, key_start, shift, key_count, sizes);
  return (int)cudaGetLastError();
}

extern "C" int tpt_pair_fill(const int* key_start, const int* key_count,
                             int n_keys, int n_segs, int* seg_id, float* dm,
                             float* o1, int* row_ray, void* stream) {
  if (n_segs <= 0) return (int)cudaSuccess;
  pair_fill_kernel<<<n_segs, PAIR_CHUNK, 0, (cudaStream_t)stream>>>(
      key_start, key_count, n_keys, seg_id, dm, o1, row_ray);
  return (int)cudaGetLastError();
}

// Step 6: best [n] uint64, set to all ones by the caller, then the rows'
// (t, idx) folded in; then pair-bin's finalize into t_out [n] f32 and i_out
// [n] int64 (advance = 0), or a pair round's advance of t_best, i_best and
// taken in place (advance = 1; t_best0 is then t_best).
extern "C" int tpt_pair_best(const float* t_row, const int* i_row,
                             const int* row_ray, long long n_rows,
                             unsigned long long* best, int n, int advance,
                             const float* t_best0, float inf, float* t_out,
                             long long* i_out, const int* counts,
                             const int* start, const float* entry,
                             int* taken, void* stream) {
  if (n_rows > 0) {
    pair_reduce_kernel<<<blocks_for(n_rows, ROW_THREADS), ROW_THREADS, 0,
                         (cudaStream_t)stream>>>(t_row, i_row, row_ray,
                                                 n_rows, best);
  }
  if (n > 0) {
    if (advance) {
      pair_advance_kernel<<<blocks_for(n, ROW_THREADS), ROW_THREADS, 0,
                            (cudaStream_t)stream>>>(
          best, counts, start, entry, n, t_out, i_out, taken);
    } else {
      pairbin_finalize_kernel<<<blocks_for(n, ROW_THREADS), ROW_THREADS, 0,
                                (cudaStream_t)stream>>>(best, t_best0, n, inf,
                                                        t_out, i_out);
    }
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
