// What the pair sweeps (pair_sweep.cu) and their emission (pair_emit.cu)
// share: the layout of a pair row, a row's slab test against a box, and
// the per-row test against a chunk's triangles.  Everything here is
// __host__ __device__, so a plain C++ compiler builds it for the CPU too.
//
// A pair row is 16 floats in two arrays: pair_dm [P, 8] holds d, o x d, the
// row's bound and a zero; pair_o1 [P, 8] holds o, 1 and zeros.  Padding
// rows are all zero.  A chunk is 128 consecutive triangles of the
// BVH-preorder triangle array; its table [22, 128] holds, for each triangle,
// three edges as p x q and q - p (rows 0-17), -n (18-20) and n . a (21).

#pragma once

#include "tracer.cuh"

namespace tpt {

constexpr int PAIR_CHUNK = 128;      // triangles per chunk, rows per segment
constexpr int PAIR_TABLE_ROWS = 22;  // e0 (6), e1 (6), e2 (6), -n (3), n.a
constexpr int PAIR_CHUNK_FLOATS = PAIR_TABLE_ROWS * PAIR_CHUNK;
constexpr int PAIR_BIN_CHUNKS = 4;   // chunks per bin (PAIR_G)
// A staged chunk is triangle-major: triangle j's 22 table entries at
// [24 j, 24 j + 22), two zeros after them, so a triangle is six aligned
// float4 loads.
constexpr int PAIR_TRI_STRIDE = 24;
constexpr int PAIR_STAGE_FLOATS = PAIR_CHUNK * PAIR_TRI_STRIDE;

struct PairRay {
  float dx, dy, dz, mx, my, mz, bound, ox, oy, oz;
};

TPT_HD PairRay load_pair_ray(const float* dm, const float* o1, long long row) {
  const float* a = dm + 8 * row;
  const float* b = o1 + 8 * row;
  PairRay r;
  r.dx = a[0]; r.dy = a[1]; r.dz = a[2];
  r.mx = a[3]; r.my = a[4]; r.mz = a[5];
  r.bound = a[6];
  r.ox = b[0]; r.oy = b[1]; r.oz = b[2];
  return r;
}

// sign(d) / max(|d|, 1e-12) per axis (pair_sweep.inv_dir): no infinity, so
// no NaN slab.
TPT_HD V3 inv_dir3(float dx, float dy, float dz) {
  return v3((dx >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dx), 1e-12f),
            (dy >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dy), 1e-12f),
            (dz >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dz), 1e-12f));
}

TPT_HD V3 pair_inv_dir(const PairRay& r) {
  return inv_dir3(r.dx, r.dy, r.dz);
}

// Slab test of a ray (origin o, inverse direction iv) against a box (min
// xyz, max xyz) below `cap`: pair_sweep.slab_entries(...) < _BIG, in its
// order.  The boxes are finite and iv is, so no slab is NaN and fminf /
// fmaxf agree with torch.minimum / maximum.
TPT_HD bool slab_hit(const float* box, float ox, float oy, float oz, V3 iv,
                     float cap) {
  const float t0x = (box[0] - ox) * iv.x, t1x = (box[3] - ox) * iv.x;
  const float t0y = (box[1] - oy) * iv.y, t1y = (box[4] - oy) * iv.y;
  const float t0z = (box[2] - oz) * iv.z, t1z = (box[5] - oz) * iv.z;
  const float tlo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                          fminf(t0z, t1z));
  const float thi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fmaxf(t0z, t1z));
  return thi >= fmaxf(tlo, 0.0f) && tlo <= cap;
}

// Can a row still hit something in a chunk, at its running best?
TPT_HD bool chunk_slab_hit(const float* box, const PairRay& r, V3 iv,
                           float t_cur) {
  return slab_hit(box, r.ox, r.oy, r.oz, iv, t_cur);
}

// [d, o x d] . entries k .. k + 5 of one staged triangle T, summed left to
// right.
TPT_HD float edge_volume(const float* T, int k, const PairRay& r) {
  float s = r.dx * T[k];
  s = s + r.dy * T[k + 1];
  s = s + r.dz * T[k + 2];
  s = s + r.mx * T[k + 3];
  s = s + r.my * T[k + 4];
  s = s + r.mz * T[k + 5];
  return s;
}

// The test of one row against one staged triangle T: true, with t, when the
// ray hits the triangle at t in [t_min, bound).  The arithmetic of
// pair_sweep._edge_tests, in its order, with one shortcut that changes no
// result: s_k / den >= t_min > 0 needs all three volumes nonzero and of
// one sign (NaN fails both), so a row whose volumes are not is rejected
// before the numerator and the division, which most tests never reach.
TPT_HD bool edge_test(const float* T, const PairRay& r, float t_min,
                      float bound, float& t) {
  const float s0 = edge_volume(T, 0, r);
  const float s1 = edge_volume(T, 6, r);
  const float s2 = edge_volume(T, 12, r);
  const bool one_sign = (s0 > 0.0f && s1 > 0.0f && s2 > 0.0f) ||
                        (s0 < 0.0f && s1 < 0.0f && s2 < 0.0f);
  if (t_min > 0.0f && !one_sign) return false;
  float tn = r.ox * T[18];
  tn = tn + r.oy * T[19];
  tn = tn + r.oz * T[20];
  tn = tn + T[21];
  const float den = (s0 + s1) + s2;
  const float inv = 1.0f / den;
  t = tn * inv;
  return fabsf(den) >= DET_EPS && t >= t_min && t < bound &&
         s0 * inv >= t_min && s1 * inv >= t_min && s2 * inv >= t_min;
}

// Where entry e of a chunk table [22, 128] (row e / 128, triangle e % 128)
// lies in the staged, triangle-major copy.
TPT_HD int stage_offset(int e) {
  return (e % PAIR_CHUNK) * PAIR_TRI_STRIDE + e / PAIR_CHUNK;
}

// One staged triangle's 24 floats, in registers on the card.
struct StagedTri {
  float v[PAIR_TRI_STRIDE];
};

TPT_HD void load_staged(const float* stage, int j, StagedTri& c) {
#ifdef __CUDA_ARCH__
  const float4* p =
      reinterpret_cast<const float4*>(stage + j * PAIR_TRI_STRIDE);
#pragma unroll
  for (int q = 0; q < PAIR_TRI_STRIDE / 4; ++q) {
    const float4 x = p[q];
    c.v[4 * q] = x.x;
    c.v[4 * q + 1] = x.y;
    c.v[4 * q + 2] = x.z;
    c.v[4 * q + 3] = x.w;
  }
#else
  for (int k = 0; k < PAIR_TRI_STRIDE; ++k) {
    c.v[k] = stage[j * PAIR_TRI_STRIDE + k];
  }
#endif
}

// One row against staged triangles [j0, j1) in index order, from `bound`;
// `base` is the chunk's first global triangle index.  The row tightens t
// and sets idx on every strictly closer hit, so it keeps the least t and,
// among equal t, the least index; idx stays -1 (and t the bound) when
// nothing is hit.
TPT_HD void sweep_triangles(const float* stage, int j0, int j1, int base,
                            const PairRay& r, float t_min, float bound,
                            float& t, int& idx) {
  t = bound;
  idx = -1;
  for (int j = j0; j < j1; ++j) {
    StagedTri c;
    load_staged(stage, j, c);
    float tt;
    if (edge_test(c.v, r, t_min, t, tt)) {
      t = tt;
      idx = base + j;
    }
  }
}

// Fold a partial result (t, i) of the same row into (t_best, idx): the
// least t, then the least index; i < 0 is no hit.
TPT_HD void merge_best(float t, int i, float& t_best, int& idx) {
  if (i >= 0 && (idx < 0 || t < t_best || (t == t_best && i < idx))) {
    t_best = t;
    idx = i;
  }
}

}  // namespace tpt
