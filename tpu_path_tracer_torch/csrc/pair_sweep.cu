// The ray-major pair sweeps for Hopper (sm_90a): closest triangle hit per
// (ray, chunk) pair row and per (ray, bin) pair row.
//
// Replaces the TPU kernels tpu_path_tracer/kernels/pallas/traversal.py:1723
// _pair_sweep (body _pair_kernel, :1665) and :1417 _pairbin_sweep (body
// _pairbin_kernel, :1331).  Rays are paired with aligned 128-triangle chunks
// of the BVH-preorder triangle array (pair sweep) or with bins of 4
// consecutive chunks (pair-bin sweep); the pairs are sorted by chunk or bin
// and laid out so that every 128-row segment serves one chunk or one bin
// (pair_emit.cu on the card).  Each row is tested against the triangles of
// its chunk in edge-function (Plücker) form (pair.cuh edge_test):
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
// What bounds them on this card: FP32 issue.  A row-triangle test is 33
// products and sums and 6 sign compares, and 20 operations more (the
// numerator, the division, the acceptance) when its three edge volumes
// share a sign, against 64 bytes of row in and 8 out per 128 tests.  The products are IEEE-rounded
// one by one in a fixed order (--fmad=false, no --use_fast_math, a true
// division) so that the plain versions in kernels/pair_sweep.py round alike.
// The design cuts the instructions around those operations:
//
// * The chunk table is staged in shared memory triangle-major, 24 floats a
//   triangle (pair.cuh stage_offset), so a triangle is six float4 loads
//   that every lane of a warp reads at once (a broadcast), not 22 scalar
//   loads 128 floats apart.
// * edge_test rejects a row whose three edge volumes do not share a strict
//   sign before the numerator and the division: the acceptance needs it, so
//   no result changes, and most tests stop there.
// * One block of 512 threads serves a segment: each row's 128 triangles
//   are split into 4 parts of 32 (thread / 128 picks the part, so each warp
//   holds one part of 32 rows and its lanes read the same triangle at
//   once), and the parts' results are folded in order under the tie rule
//   (least t, then least index), which is what one loop in index order
//   with a strict `<` keeps.  Chains of 32 dependent tests instead of 128,
//   and 64 warps an SM: the launches of the pair route are small (a few
//   hundred segments), and both kernels wait on latency more than on
//   issue.
// * pairbin_sweep_kernel carries each row's running best over the bin's
//   four chunks.  A chunk is swept when some row's slab test at its running
//   best passes: __syncthreads_or over the block, exactly the segment's 128
//   rows (a finer vote would change bits: rounding lets a row hit a
//   triangle whose box its own slab test missed).  The chunk is then copied
//   into the stage as pair_sweep_kernel copies it; a copy of the next chunk
//   overlapped with the sweep (cp.async into a second stage) was measured
//   and saved nothing.
//
// Segments whose id is outside [0, keys) are dummies and return at once;
// the wrapper allocates outputs initialised to "no hit".
//
// Built without nvcc (a plain C++ compiler), this file compiles the row
// code and host entry points that run each kernel's blocks, rows and parts
// in order on the CPU with the same functions (tpt_pair_sweep_host,
// tpt_pairbin_sweep_host), and leaves out the kernels.

#include "pair.cuh"

namespace tpt {

constexpr int PAIR_SPLIT = 4;  // threads per row, each a part of the chunk
constexpr int PAIR_PART = PAIR_CHUNK / PAIR_SPLIT;  // triangles per part
constexpr int SEG_THREADS = PAIR_CHUNK * PAIR_SPLIT;  // a segment's block

// Part `part` of a row: the row against staged triangles [32 part, 32 part
// + 32) of chunk cid, from `bound`.
TPT_HD void sweep_part(const float* stage, int cid, int part,
                       const PairRay& r, float t_min, float bound, float& t,
                       int& idx) {
  sweep_triangles(stage, part * PAIR_PART, (part + 1) * PAIR_PART,
                  cid * PAIR_CHUNK, r, t_min, bound, t, idx);
}

// A chunk table staged by one thread (the host's copy).
inline void stage_chunk_host(float* stage, const float* table, int cid) {
  for (int e = 0; e < PAIR_STAGE_FLOATS; ++e) stage[e] = 0.0f;
  for (int e = 0; e < PAIR_CHUNK_FLOATS; ++e) {
    stage[stage_offset(e)] = table[(long long)cid * PAIR_CHUNK_FLOATS + e];
  }
}

// A row's sweep of chunk cid, the parts one after another and folded in
// order (the host's loop over a block's parts).
inline void sweep_chunk_host(const float* stage, int cid, const PairRay& r,
                             float t_min, float& t, int& idx) {
  const float bound = t;
  for (int part = 0; part < PAIR_SPLIT; ++part) {
    float tp;
    int ip;
    sweep_part(stage, cid, part, r, t_min, bound, tp, ip);
    merge_best(tp, ip, t, idx);
  }
}

}  // namespace tpt

// Host entry points, bound with ctypes by the tests: each kernel's blocks,
// rows and parts run one after another on the CPU.  Arguments as the C
// entry points below.
extern "C" void tpt_pair_sweep_host(const float* dm, const float* o1,
                                    const int* seg_cid, const float* table,
                                    int n_segs, int n_chunks, float t_min,
                                    float inf, float* t_out, int* idx_out) {
  using namespace tpt;
  static float stage[PAIR_STAGE_FLOATS];
  for (int s = 0; s < n_segs; ++s) {
    const int cid = seg_cid[s];
    if (cid < 0 || cid >= n_chunks) continue;
    stage_chunk_host(stage, table, cid);
    for (int k = 0; k < PAIR_CHUNK; ++k) {
      const long long row = (long long)s * PAIR_CHUNK + k;
      const PairRay r = load_pair_ray(dm, o1, row);
      float t = r.bound;
      int idx = -1;
      sweep_chunk_host(stage, cid, r, t_min, t, idx);
      t_out[row] = idx >= 0 ? t : inf;
      idx_out[row] = idx;
    }
  }
}

extern "C" void tpt_pairbin_sweep_host(const float* dm, const float* o1,
                                       const int* seg_bid,
                                       const float* boxes,
                                       const float* table, int n_segs,
                                       int n_bins, int n_chunks, float t_min,
                                       float* t_out, int* idx_out) {
  using namespace tpt;
  static float stage[PAIR_STAGE_FLOATS];
  static PairRay r[PAIR_CHUNK];
  static V3 iv[PAIR_CHUNK];
  static float t[PAIR_CHUNK];
  static int idx[PAIR_CHUNK];
  for (int s = 0; s < n_segs; ++s) {
    const int bid = seg_bid[s];
    if (bid < 0 || bid >= n_bins) continue;
    for (int k = 0; k < PAIR_CHUNK; ++k) {
      r[k] = load_pair_ray(dm, o1, (long long)s * PAIR_CHUNK + k);
      iv[k] = pair_inv_dir(r[k]);
      t[k] = r[k].bound;
      idx[k] = -1;
    }
    for (int c = 0; c < PAIR_BIN_CHUNKS; ++c) {
      const int cid = bid * PAIR_BIN_CHUNKS + c;
      if (cid >= n_chunks) break;  // the last bin may be partial
      bool any = false;
      for (int k = 0; k < PAIR_CHUNK; ++k) {
        any = chunk_slab_hit(boxes + 6 * cid, r[k], iv[k], t[k]) || any;
      }
      if (!any) continue;
      stage_chunk_host(stage, table, cid);
      for (int k = 0; k < PAIR_CHUNK; ++k) {
        sweep_chunk_host(stage, cid, r[k], t_min, t[k], idx[k]);
      }
    }
    for (int k = 0; k < PAIR_CHUNK; ++k) {
      t_out[(long long)s * PAIR_CHUNK + k] = t[k];
      idx_out[(long long)s * PAIR_CHUNK + k] = idx[k];
    }
  }
}

#ifdef __CUDACC__

namespace {

using namespace tpt;

// The block's copy of chunk cid's table into the stage, triangle-major.
// The two padding floats of a staged triangle are loaded with it and never
// used, so they are left unset.
__device__ __forceinline__ void stage_chunk(float* stage, const float* table,
                                            int cid) {
  const float* src = table + (size_t)cid * PAIR_CHUNK_FLOATS;
  for (int e = threadIdx.x; e < PAIR_CHUNK_FLOATS; e += SEG_THREADS) {
    stage[stage_offset(e)] = __ldg(src + e);
  }
}

// This thread's part of a row's sweep of the staged chunk cid, the four
// parts exchanged through shared memory and folded in order into (t, idx)
// by every thread of the row.
__device__ __forceinline__ void sweep_chunk(const float* stage, int cid,
                                            int part, int k,
                                            const PairRay& r, float t_min,
                                            float (*part_t)[PAIR_CHUNK],
                                            int (*part_i)[PAIR_CHUNK],
                                            float& t, int& idx) {
  float tp;
  int ip;
  sweep_part(stage, cid, part, r, t_min, t, tp, ip);
  part_t[part][k] = tp;
  part_i[part][k] = ip;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PAIR_SPLIT; ++q) {
    merge_best(part_t[q][k], part_i[q][k], t, idx);
  }
}

__global__ void __launch_bounds__(SEG_THREADS)
pairbin_sweep_kernel(const float* __restrict__ dm,
                     const float* __restrict__ o1,
                     const int* __restrict__ seg_bid,
                     const float* __restrict__ boxes,
                     const float* __restrict__ table, int n_bins,
                     int n_chunks, float t_min, float* __restrict__ t_out,
                     int* __restrict__ idx_out) {
  __shared__ __align__(16) float stage[PAIR_STAGE_FLOATS];
  __shared__ float part_t[PAIR_SPLIT][PAIR_CHUNK];
  __shared__ int part_i[PAIR_SPLIT][PAIR_CHUNK];
  const int bid = seg_bid[blockIdx.x];
  if (bid < 0 || bid >= n_bins) return;  // dummy segment
  // Part q = threadIdx.x / 128: whole warps, every lane of a warp on the
  // same triangle at once.
  const int part = threadIdx.x / PAIR_CHUNK, k = threadIdx.x % PAIR_CHUNK;
  const long long row = (long long)blockIdx.x * PAIR_CHUNK + k;
  const PairRay r = load_pair_ray(dm, o1, row);
  const V3 iv = pair_inv_dir(r);
  float t = r.bound;
  int idx = -1;
  const int c_end = min((bid + 1) * PAIR_BIN_CHUNKS, n_chunks);
  for (int cid = bid * PAIR_BIN_CHUNKS; cid < c_end; ++cid) {
    // The vote also orders this chunk's copy after the last one's reads.
    if (!__syncthreads_or(chunk_slab_hit(boxes + 6 * cid, r, iv, t))) {
      continue;
    }
    stage_chunk(stage, table, cid);
    __syncthreads();
    sweep_chunk(stage, cid, part, k, r, t_min, part_t, part_i, t, idx);
  }
  if (part == 0) {
    t_out[row] = t;
    idx_out[row] = idx;
  }
}

__global__ void __launch_bounds__(SEG_THREADS)
pair_sweep_kernel(const float* __restrict__ dm, const float* __restrict__ o1,
                  const int* __restrict__ seg_cid,
                  const float* __restrict__ table, int n_chunks, float t_min,
                  float inf, float* __restrict__ t_out,
                  int* __restrict__ idx_out) {
  __shared__ __align__(16) float stage[PAIR_STAGE_FLOATS];
  __shared__ float part_t[PAIR_SPLIT][PAIR_CHUNK];
  __shared__ int part_i[PAIR_SPLIT][PAIR_CHUNK];
  const int cid = seg_cid[blockIdx.x];
  if (cid < 0 || cid >= n_chunks) return;  // dummy segment
  stage_chunk(stage, table, cid);
  __syncthreads();
  const int part = threadIdx.x / PAIR_CHUNK, k = threadIdx.x % PAIR_CHUNK;
  const long long row = (long long)blockIdx.x * PAIR_CHUNK + k;
  const PairRay r = load_pair_ray(dm, o1, row);
  float t = r.bound;
  int idx = -1;
  sweep_chunk(stage, cid, part, k, r, t_min, part_t, part_i, t, idx);
  if (part == 0) {
    t_out[row] = idx >= 0 ? t : inf;
    idx_out[row] = idx;
  }
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
  pair_sweep_kernel<<<n_segs, SEG_THREADS, 0, (cudaStream_t)stream>>>(
      dm, o1, seg_cid, table, n_chunks, t_min, inf, t_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" int tpt_pairbin_sweep(const float* dm, const float* o1,
                                 const int* seg_bid, const float* boxes,
                                 const float* table, int n_segs, int n_bins,
                                 int n_chunks, float t_min, float* t_out,
                                 int* idx_out, void* stream) {
  if (n_segs <= 0) return (int)cudaSuccess;
  pairbin_sweep_kernel<<<n_segs, SEG_THREADS, 0, (cudaStream_t)stream>>>(
      dm, o1, seg_bid, boxes, table, n_bins, n_chunks, t_min, t_out,
      idx_out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
