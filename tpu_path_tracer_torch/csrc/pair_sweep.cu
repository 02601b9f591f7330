// The ray-major pair sweeps for Hopper (sm_90a): closest triangle hit per
// (ray, chunk) pair row and per (ray, bin) pair row.
//
// Replaces the TPU kernels tpu_path_tracer/kernels/pallas/traversal.py:1723
// _pair_sweep (body _pair_kernel, :1665) and :1417 _pairbin_sweep (body
// _pairbin_kernel, :1331).  Rays are paired with aligned 128-triangle chunks
// of the BVH-preorder triangle array (pair sweep) or with bins of 4
// consecutive chunks (pair-bin sweep); the pairs are sorted by chunk or bin
// and laid out so that every 128-row segment serves one chunk or one bin
// (kernels/pair_sweep.py does that with torch.sort and scatters, as the JAX
// package does it outside its kernels).  Each row is tested against all 128
// triangles of its chunk in edge-function (Plücker) form:
//
//   s_k = [d, o x d] . e_k   (k = 0, 1, 2: edges (b,c), (c,a), (a,b))
//   tn  = [o, 1] . tcol,   den = s0 + s1 + s2,   t = tn * (1 / den)
//
// accepted when |den| >= DET_EPS, t >= t_min, t < bound and s_k / den >=
// t_min; the row keeps the least t and, among equal t, the least global
// triangle index.  What the TPU bodies add exists only for the TPU and is
// left out: the [128, 8] x [8, 128] MXU contractions with their zero rows
// 6-7, the index planted as a float in a spare table row, the four
// segments per grid step, the VMEM-resident table and its 640-chunk limit.
//
// Design: one block of 128 threads per segment, one thread per pair row.
// The block copies the segment's chunk table (22 rows x 128 triangles,
// 11 KB) into shared memory once with 16-byte loads; each thread keeps its
// ray in registers and loops over the 128 triangles in index order, every
// thread of a warp reading the same shared word (a broadcast, no bank
// conflict).  A sequential loop with a strict `<` against the running best
// gives the least t and the least index among equal t.  The pair-bin kernel
// does this for the bin's four chunks in order: a slab test of each row
// against the chunk's box at the row's running best, a block-wide vote
// (__syncthreads_or) whether any row can still hit the chunk, and only then
// the copy and the sweep; the running best carries over chunks.  A segment
// whose id is the dummy returns at once, so the wrapper allocates outputs
// initialised to "no hit".
//
// What bounds it on this card: FP32 operations.  A row-triangle test is 53
// operations on 22 shared words, against 64 bytes of row in and 8 out per
// 128 tests, so the sweep is compute-bound by two orders of magnitude; the
// products are IEEE-rounded one by one in a fixed order (built with
// --fmad=false, no --use_fast_math) so that the plain version in
// kernels/pair_sweep.py rounds alike.  With FMA contraction the same loop
// would issue about half as many multiplies and adds; that is later work,
// with a tolerance.
//
// Built without nvcc (a plain C++ compiler), this file compiles the per-row
// functions for the CPU and leaves out the kernels and their entry points.

#include "tracer.cuh"

namespace tpt {

constexpr int PAIR_CHUNK = 128;      // triangles per chunk, rows per segment
constexpr int PAIR_TABLE_ROWS = 22;  // e0 (6), e1 (6), e2 (6), -n (3), n.a
constexpr int PAIR_CHUNK_FLOATS = PAIR_TABLE_ROWS * PAIR_CHUNK;
constexpr int PAIR_BIN_CHUNKS = 4;   // chunks per bin (PAIR_G)

// One pair row: pair_dm [P, 8] holds d, o x d, the row's bound and a zero;
// pair_o1 [P, 8] holds o, 1 and zeros.
struct PairRay {
  float dx, dy, dz, mx, my, mz, bound, ox, oy, oz;
};

TPT_HD PairRay load_pair_ray(const float* dm, const float* o1, int row) {
  const float* a = dm + 8 * row;
  const float* b = o1 + 8 * row;
  PairRay r;
  r.dx = a[0]; r.dy = a[1]; r.dz = a[2];
  r.mx = a[3]; r.my = a[4]; r.mz = a[5];
  r.bound = a[6];
  r.ox = b[0]; r.oy = b[1]; r.oz = b[2];
  return r;
}

// [d, o x d] . rows k .. k + 5 of one triangle's column, summed left to
// right.  T points at the triangle's column; table rows are PAIR_CHUNK
// floats apart.
TPT_HD float edge_volume(const float* T, int k, const PairRay& r) {
  float s = r.dx * T[(k + 0) * PAIR_CHUNK];
  s = s + r.dy * T[(k + 1) * PAIR_CHUNK];
  s = s + r.dz * T[(k + 2) * PAIR_CHUNK];
  s = s + r.mx * T[(k + 3) * PAIR_CHUNK];
  s = s + r.my * T[(k + 4) * PAIR_CHUNK];
  s = s + r.mz * T[(k + 5) * PAIR_CHUNK];
  return s;
}

// The test of one row against one triangle: true, with t, when the ray hits
// the triangle at t in [t_min, bound).
TPT_HD bool edge_test(const float* T, const PairRay& r, float t_min,
                      float bound, float& t) {
  const float s0 = edge_volume(T, 0, r);
  const float s1 = edge_volume(T, 6, r);
  const float s2 = edge_volume(T, 12, r);
  float tn = r.ox * T[18 * PAIR_CHUNK];
  tn = tn + r.oy * T[19 * PAIR_CHUNK];
  tn = tn + r.oz * T[20 * PAIR_CHUNK];
  tn = tn + T[21 * PAIR_CHUNK];
  const float den = (s0 + s1) + s2;
  const float inv = 1.0f / den;
  t = tn * inv;
  return fabsf(den) >= DET_EPS && t >= t_min && t < bound &&
         s0 * inv >= t_min && s1 * inv >= t_min && s2 * inv >= t_min;
}

// One row against the 128 triangles of a chunk table, in index order;
// `base` is the chunk's first global triangle index.  Tightens t_best and
// sets idx on every strictly closer hit.
TPT_HD void chunk_sweep(const float* table, int base, const PairRay& r,
                        float t_min, float& t_best, int& idx) {
  for (int j = 0; j < PAIR_CHUNK; ++j) {
    float t;
    if (edge_test(table + j, r, t_min, t_best, t)) {
      t_best = t;
      idx = base + j;
    }
  }
}

// sign(d) / max(|d|, 1e-12) per axis: no infinity, so no NaN slab.
TPT_HD V3 pair_inv_dir(const PairRay& r) {
  return v3((r.dx >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(r.dx), 1e-12f),
            (r.dy >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(r.dy), 1e-12f),
            (r.dz >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(r.dz), 1e-12f));
}

// Slab test of a row against a chunk box (min xyz, max xyz) at the row's
// running best: can the row still hit something in the chunk?
TPT_HD bool chunk_slab_hit(const float* box, const PairRay& r, V3 iv,
                           float t_cur) {
  const float t0x = (box[0] - r.ox) * iv.x, t1x = (box[3] - r.ox) * iv.x;
  const float t0y = (box[1] - r.oy) * iv.y, t1y = (box[4] - r.oy) * iv.y;
  const float t0z = (box[2] - r.oz) * iv.z, t1z = (box[5] - r.oz) * iv.z;
  const float tlo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                          fminf(t0z, t1z));
  const float thi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z));
  return thi >= fmaxf(tlo, 0.0f) && tlo <= t_cur;
}

}  // namespace tpt

#ifdef __CUDACC__

namespace {

using namespace tpt;

// The block's copy of one chunk table into shared memory, 16 bytes a
// thread; the caller synchronizes.
__device__ __forceinline__ void load_chunk(float* sh, const float* table,
                                           int cid) {
  const float4* src = reinterpret_cast<const float4*>(
      table + (size_t)cid * PAIR_CHUNK_FLOATS);
  float4* dst = reinterpret_cast<float4*>(sh);
  for (int i = threadIdx.x; i < PAIR_CHUNK_FLOATS / 4; i += blockDim.x) {
    dst[i] = __ldg(src + i);
  }
}

__global__ void __launch_bounds__(PAIR_CHUNK)
pair_sweep_kernel(const float* __restrict__ dm, const float* __restrict__ o1,
                  const int* __restrict__ seg_cid,
                  const float* __restrict__ table, int n_chunks, float t_min,
                  float inf, float* __restrict__ t_out,
                  int* __restrict__ idx_out) {
  __shared__ __align__(16) float sh[PAIR_CHUNK_FLOATS];
  const int cid = seg_cid[blockIdx.x];
  if (cid < 0 || cid >= n_chunks) return;  // dummy segment
  load_chunk(sh, table, cid);
  __syncthreads();
  const int row = blockIdx.x * PAIR_CHUNK + threadIdx.x;
  const PairRay r = load_pair_ray(dm, o1, row);
  float t = r.bound;
  int idx = -1;
  chunk_sweep(sh, cid * PAIR_CHUNK, r, t_min, t, idx);
  t_out[row] = idx >= 0 ? t : inf;
  idx_out[row] = idx;
}

__global__ void __launch_bounds__(PAIR_CHUNK)
pairbin_sweep_kernel(const float* __restrict__ dm,
                     const float* __restrict__ o1,
                     const int* __restrict__ seg_bid,
                     const float* __restrict__ boxes,
                     const float* __restrict__ table, int n_bins,
                     int n_chunks, float t_min, float* __restrict__ t_out,
                     int* __restrict__ idx_out) {
  __shared__ __align__(16) float sh[PAIR_CHUNK_FLOATS];
  const int bid = seg_bid[blockIdx.x];
  if (bid < 0 || bid >= n_bins) return;  // dummy segment
  const int row = blockIdx.x * PAIR_CHUNK + threadIdx.x;
  const PairRay r = load_pair_ray(dm, o1, row);
  const V3 iv = pair_inv_dir(r);
  float t = r.bound;
  int idx = -1;
  for (int c = 0; c < PAIR_BIN_CHUNKS; ++c) {
    const int cid = bid * PAIR_BIN_CHUNKS + c;
    if (cid >= n_chunks) break;  // the last bin may be partial
    const bool hit = chunk_slab_hit(boxes + 6 * cid, r, iv, t);
    // Also the barrier between the last chunk's sweep and the next copy.
    if (!__syncthreads_or(hit)) continue;
    load_chunk(sh, table, cid);
    __syncthreads();
    chunk_sweep(sh, cid * PAIR_CHUNK, r, t_min, t, idx);
  }
  t_out[row] = t;
  idx_out[row] = idx;
}

}  // namespace

// C entry points, bound with ctypes (kernels/pair_sweep.py).  dm and o1
// [128 * n_segs, 8], seg ids [n_segs], table [n_chunks, 22, 128], boxes
// [n_chunks, 6]; outputs t and idx [128 * n_segs], initialised by the
// caller to "no hit".  Each returns cudaGetLastError() of the launch.
extern "C" int tpt_pair_sweep(const float* dm, const float* o1,
                              const int* seg_cid, const float* table,
                              int n_segs, int n_chunks, float t_min,
                              float inf, float* t_out, int* idx_out,
                              void* stream) {
  if (n_segs <= 0) return (int)cudaSuccess;
  pair_sweep_kernel<<<n_segs, PAIR_CHUNK, 0, (cudaStream_t)stream>>>(
      dm, o1, seg_cid, table, n_chunks, t_min, inf, t_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" int tpt_pairbin_sweep(const float* dm, const float* o1,
                                 const int* seg_bid, const float* boxes,
                                 const float* table, int n_segs, int n_bins,
                                 int n_chunks, float t_min, float* t_out,
                                 int* idx_out, void* stream) {
  if (n_segs <= 0) return (int)cudaSuccess;
  pairbin_sweep_kernel<<<n_segs, PAIR_CHUNK, 0, (cudaStream_t)stream>>>(
      dm, o1, seg_bid, boxes, table, n_bins, n_chunks, t_min, t_out,
      idx_out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
