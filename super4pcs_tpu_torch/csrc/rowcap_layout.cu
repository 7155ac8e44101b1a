// K2x: the row-capped capture of the rowcap engine's XLA route, both base
// edges of T trials in one launch.
//
// Replaces an XLA op, not a Pallas kernel: super4pcs_tpu/ops/pairs.py::
// _rowcap_scan_edges (used by extract_pairs_rowcap_layout and
// extract_pairs_rowcap_layout_both), which masks a row block against all
// n columns with ordered_pair_mask, keys every hit column by -rank (rank =
// (col - col_offset) mod n, -inf off the mask) and keeps each row's first
// row_cap keys with jax.lax.approx_max_k (an exact top-k on the CPU). The
// operation is an ordered compaction per row: the first row_cap hit
// columns in the rotated order off, off + 1, ..., n - 1, 0, ..., off - 1,
// and the count of every hit. It needs no top-k and no key plane.
//
// Design (what was kept of the redesign's options, and why):
//
// - Lanes own rows. A block of 4 warps owns 128 rows of one trial t
//   (blockIdx.y, on point set t / per_set), one row a lane, both edges.
//   Every lane of a warp walks the same columns in the same order, so a
//   column is one broadcast shared-memory load (LDS.128) for 32 rows x 2
//   edges, the lane's hits of a group of 32 columns are the bits of a
//   mask, and its rank order is the bit order. No ballot ranks anything: the
//   lane appends its hits to its own row (the first version's ballot,
//   two popcounts and a predicated store per row and chunk are gone).
// - Staged column tiles. The block copies each tile of 512 columns (256
//   with filters) of the set's float4 points into shared memory with
//   cp.async, double-buffered (the next tile is copied while the warps
//   test the current one), so each column comes from device memory once
//   a block, not once a warp.
// - One pair geometry for both edges. A column's value q (d^2, or s =
//   (dx^2 + dy^2) + dz^2 with the angle filter) is computed once and
//   tested against both edges' intervals.
// - The rotated walk over aligned tiles. The walk takes the columns >= off
//   of the tile holding off, then the whole tiles that follow, wrapping
//   past n, and last the columns < off of that first tile, so staging and
//   rejection stay aligned to fixed tiles whatever the offset. A warp
//   lists a part's columns (those the rejection keeps, with it on) in
//   column order in shared memory and tests the list 32 columns at a
//   time, unrolled; a lane's own column never sets a bit.
// - Exact rejection (with tile_reject, and only with the distance band).
//   The rows are walked in 32-point kd cells (perm; any order of the rows
//   gives the same captures), so a warp's rows have a small bounding
//   sphere (spheres; both once per run: kernels/rowcap_layout.py::
//   reject_bounds). Per 32 columns of a staged tile, lane l tests column
//   l against that sphere for both edges (reject_limits below:
//   thresholds on |b - c|^2, once per warp), and a ballot keeps in the
//   list the columns that either edge may hit, so the warp's work follows
//   the candidates: 32 consecutive columns of Q almost always hold one
//   (Q's kd order leaves 256-point leaves unordered inside), which made
//   a sphere per 32 columns, and a loop over their few candidates,
//   slower. The test is conservative: a pair's
//   computed q lies within 9u (|a|^2 + |b|^2) of its true squared
//   distance (u = 2^-24); the limits widen the interval by 64u (M^2 +
//   mag2) (M = |center| + radius, mag2 >= every |b|^2 of the set) and
//   every step by a relative 1e-5. A rejected column holds no hit of the
//   edge, so the output with rejection on equals the output with it off.
// - Count only once a row is full. A lane stores a hit only while its
//   row's count is below row_cap; after that it adds the popcount of its
//   masks. rc is the lane's count, written once at the end. (Writing the
//   hits four at a time, one 16-byte store per full quad of slots, was
//   measured and dropped: no faster at the headline's T = 16, slower at
//   nq = 32768.)
// - The angle path's pre-band. A pair takes __fsqrt_rn, |dist - d| <= eps
//   and the filters only when s lies in [s_lo, s_hi] (pre_band below,
//   widened from the monotonicity of __fsqrt_rn and __fsub_rn so that no
//   passing pair falls outside).
// - Filters on a compacted list. With a filter on, each lane first drops
//   its own in-band candidates that fail the separable color and
//   translation scores (cheap, and most candidates fail them); the warp
//   lists the rest, (edge, row, column), in shared memory (a prefix sum
//   over the lanes' popcounts) and evaluates one a lane (the angle
//   path's exact band, the normal band, the angle); the passing
//   candidates set their bits, which the lanes then emit.
// - No walk without a predicate. Without the distance band and any
//   filter (similarity mode's rowcap engine) every off-diagonal pair is a
//   hit, so rowcap_layout_kernel_closed writes the closed form: cols holds
//   the first row_cap columns of the rotated order with the row skipped,
//   rc = n - 1 on live rows. Both edges have the same table; the wrapper
//   returns it for each.
// - Not kept: 8 rows a warp with lanes owning columns (it needs the
//   ballot ranking this design drops) and a warp-uniform count (the
//   lane's count is its row's).
//
// Bound. Per (trial, row, column): one q (8 fp32 operations: a 3-term
// dot and d^2, or a 3-term difference and its squared norm) and per
// needed edge two compares and a bit, ~15 warp instructions per column
// and 32 rows; a hit costs a few integer operations and one 4-byte
// store. At nq = 8192, T = 16 every pair test takes ~0.3 ms at the
// card's fp32 peak (chip_smoke.py's reckoning: 10 operations a test and
// edge); the rejection leaves a share of them (phase 4c prints it and
// the bound after rejection). The output is E * T * n_pad * (row_cap +
// 1) * 4 bytes (the closed form's: one table for both edges).
//
// Numerics. Every float operation of a pair test is __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, in ops/pairs.py::
// ordered_pair_mask's order (no FMA contraction; built with -fmad=false
// too): d2 = (|a|^2 + |b|^2) - 2 ((ax bx + ay by) + az bz) against
// [lo^2, hi^2]; with the angle filter diff = b - a, dist = sqrt((dx dx +
// dy dy) + dz dz), |dist - d| <= eps, and cos = ((dx/dc s0 + dy/dc s1) +
// dz/dc s2) clamped to [-1, 1], dc = max(dist, 1e-30), acos(cos) <= the
// angle; the normal band min(| |na - nb| - a|, | |na + nb| - a|) <= thr
// unless |na|^2 or |nb|^2 is 0; color and translation as the separable
// scores of kernels/rowcap.py::filter_scores (row + column >= 2). So cols,
// hit and rc equal the plain version (kernels/rowcap_layout.py::
// rowcap_layout_plain) bit for bit, except that acosf may round
// differently from torch.arccos in the last bit: candidates within 1e-6
// rad of the angle gate can differ. The rejection and the pre-band are
// mirrored in torch by kernels/rowcap_layout.py (reject_limits,
// column_reject_plain, pre_band, and the whole walk in
// rowcap_layout_walk), whose CPU tests hold them to the plain version's
// hits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_ROWS = THREADS;  // one row a lane
constexpr int GEO = 8;               // floats of geo per (edge, trial)
constexpr int LIST = 64 * 32;        // candidates of a chunk, at most
constexpr unsigned FULL = 0xffffffffu;
// relative widenings of the rejection test and the pre-band, and the
// error factor 2^-18 = 64u of a pair's q
constexpr float UP = 1.00001f;
constexpr float DN = 0.99999f;
constexpr float ERR = 3.814697265625e-06f;

__device__ __forceinline__ float sum3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(x, y), z);
}

__device__ __forceinline__ float norm_of(float x, float y, float z) {
  return __fsqrt_rn(
      sum3(__fmul_rn(x, x), __fmul_rn(y, y), __fmul_rn(z, z)));
}

// The interval [lo, hi] of s = (dx^2 + dy^2) + dz^2 outside which no pair
// passes |__fsqrt_rn(s) - d| <= eps: a pass gives dist <= d + eps / (1 -
// u) and dist >= d - eps / (1 - u), dist within a relative u of sqrt(s);
// each bound is widened by UP / DN per rounding step (mirrored by
// kernels/rowcap_layout.py::pre_band).
__device__ __forceinline__ void pre_band(float d, float eps, float& lo,
                                         float& hi) {
  const float e_up = __fmul_rn(eps, UP);
  const float xh = __fmul_rn(__fadd_rn(d, e_up), UP);
  hi = __fmul_rn(__fmul_rn(xh, xh), UP);
  const float xl = __fmul_rn(__fsub_rn(d, e_up), DN);
  lo = xl > 0.f ? __fmul_rn(__fmul_rn(xl, xl), DN)
               : __int_as_float((int)0xff800000);  // -inf
}

// The column test of the rejection: per (warp, edge), thresholds on s_b =
// |b - c|^2 (b a column point, c the warp's row sphere center, radius r)
// outside which no row of the sphere gives column b a q in [lo, hi]. A
// pair's q lies within 9u (|a|^2 + |b|^2) of its true squared distance,
// below err = 64u (M^2 + mag2) (M = |c| + r, mag2 >= every |b|^2 of the
// set); s_b within 5u of |b - c|^2 relative; each step is widened by UP /
// DN (mirrored by kernels/rowcap_layout.py::column_reject_plain). A
// column is rejected when s_b > far2 (every row too far) or s_b < near2
// (every row too near). NaN anywhere rejects nothing.
__device__ __forceinline__ void reject_limits(const float4& rs, float mag2,
                                              float lo, float hi,
                                              float& far2, float& near2) {
  const float m = __fadd_rn(norm_of(rs.x, rs.y, rs.z), rs.w);
  const float err = __fmul_rn(ERR, __fadd_rn(__fmul_rn(m, m), mag2));
  const float r_hi = __fmul_rn(__fsqrt_rn(__fadd_rn(hi, err)), UP);
  const float far = __fmul_rn(__fadd_rn(r_hi, rs.w), UP);
  far2 = __fmul_rn(__fmul_rn(far, far), UP);
  const float lo_e = __fsub_rn(lo, err);
  const float r_lo = lo_e > 0.f ? __fmul_rn(__fsqrt_rn(lo_e), DN) : 0.f;
  const float nr = __fmul_rn(__fsub_rn(__fmul_rn(r_lo, DN), rs.w), DN);
  near2 = nr > 0.f ? __fmul_rn(__fmul_rn(nr, nr), DN) : -1.f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float4* pts;      // (G, n) x, y, z, |p|^2
  const float4* nrm;      // (G, n) nx, ny, nz, |n|^2, with normals
  const float* scores;    // (E, T, 2, n) row score, column score
  const float* geo;       // (E, T, GEO)
  const int* offs;        // (T,) column offsets in [0, n)
  const int* perm;        // (G, n) the rows' order (slot s < n walks row
                          // perm[s]), null: rows in order
  const float4* spheres;  // (G, ceil(n / 32)) bounding spheres of the
                          // slots' 32-row groups, null: no rejection
  const float* mag2;      // (G,) a bound of the set's |b|^2
  int n, n_pad, trials, per_set, edges, row_cap;
  int use_normals, use_scores;
  float nthr, athr;
  int* cols;              // (E, T, n_pad, row_cap)
  int* rc;                // (E, T, n_pad)
};

template <bool kFilt>
struct Smem {
  static constexpr int TILE = kFilt ? 256 : 512;  // columns of a tile
  static constexpr int F = kFilt ? 1 : 0;
  float4 pt[2][TILE];
  unsigned short cand[WARPS][TILE + 32];  // a warp's candidate columns
  float4 nrm[2][F ? TILE : 1];
  float sc[2][2][F ? TILE : 1];       // [buffer][edge] column scores
  float4 row_pt[F ? WARPS : 1][32];
  float4 row_nrm[F ? WARPS : 1][32];
  float row_sc[F ? WARPS : 1][2][32];
  unsigned short list[F ? WARPS : 1][F ? LIST : 1];
  unsigned pass[F ? WARPS : 1][2][32];
  float geo[2][GEO];
};

// The part p of trial's walk: its tile and its columns [lo, hi).
__device__ __forceinline__ void part_of(int p, int off, int n, int tile_w,
                                        int& tile, int& lo, int& hi) {
  const int ntiles = (n + tile_w - 1) / tile_w;
  const int t0 = off / tile_w;
  if (p == ntiles) {  // the columns < off of the first tile
    tile = t0;
    lo = t0 * tile_w;
    hi = off;
    return;
  }
  tile = t0 + p;
  if (tile >= ntiles) tile -= ntiles;
  lo = p == 0 ? off : tile * tile_w;
  hi = min(tile * tile_w + tile_w, n);
}

// The band bits of 32 listed columns (staged indices idx) for the row
// point a: bit i of b0 / b1 when column idx[i] is not the lane's own
// (staged index own) and, with the distance band, its q lies in edge
// 0's / edge 1's interval.
template <bool kDist, bool kDirs, bool kE1>
__device__ __forceinline__ void band_bits(const float4* pts,
                                          const unsigned short* idx,
                                          int own, const float4& a,
                                          float lo0, float hi0, float lo1,
                                          float hi1, unsigned& b0,
                                          unsigned& b1) {
  unsigned m0 = 0u, m1 = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int kk = idx[i];
    const bool other = kk != own;
    if (!kDist) {
      if (other) m0 |= 1u << i;
      continue;
    }
    const float4 b = pts[kk];
    float q;
    if (kDirs) {
      const float dx = __fsub_rn(b.x, a.x);
      const float dy = __fsub_rn(b.y, a.y);
      const float dz = __fsub_rn(b.z, a.z);
      q = sum3(__fmul_rn(dx, dx), __fmul_rn(dy, dy), __fmul_rn(dz, dz));
    } else {
      const float dot = sum3(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                             __fmul_rn(a.z, b.z));
      q = __fsub_rn(__fadd_rn(a.w, b.w), __fmul_rn(2.f, dot));
    }
    if (other && q >= lo0 && q <= hi0) m0 |= 1u << i;
    if (kE1 && other && q >= lo1 && q <= hi1) m1 |= 1u << i;
  }
  b0 = m0;
  b1 = kDist ? m1 : (kE1 ? m0 : 0u);
}

// Whether candidate (edge e, row r of the warp, staged column kk) passes
// the exact band (with the angle filter), the normal band and the angle
// (the scores are tested before, by filter_chunk).
template <bool kDist, bool kDirs>
__device__ __forceinline__ bool candidate_pass(const Smem<true>& sm,
                                               const Args& a, int warp,
                                               int buf, int e, int r,
                                               int kk) {
  const float4 ap = sm.row_pt[warp][r];
  const float4 bp = sm.pt[buf][kk];
  const float* g = sm.geo[e];
  float dx = 0.f, dy = 0.f, dz = 0.f, dist = 0.f;
  if (kDirs) {
    dx = __fsub_rn(bp.x, ap.x);
    dy = __fsub_rn(bp.y, ap.y);
    dz = __fsub_rn(bp.z, ap.z);
    dist = norm_of(dx, dy, dz);
    if (kDist && !(fabsf(__fsub_rn(dist, g[2])) <= g[3])) return false;
  }
  if (a.use_normals) {
    const float4 na = sm.row_nrm[warp][r];
    const float4 nb = sm.nrm[buf][kk];
    if (na.w > 0.f && nb.w > 0.f) {
      const float first = norm_of(__fsub_rn(na.x, nb.x),
                                  __fsub_rn(na.y, nb.y),
                                  __fsub_rn(na.z, nb.z));
      const float second = norm_of(__fadd_rn(na.x, nb.x),
                                   __fadd_rn(na.y, nb.y),
                                   __fadd_rn(na.z, nb.z));
      const float nd = fminf(fabsf(__fsub_rn(first, g[4])),
                             fabsf(__fsub_rn(second, g[4])));
      if (!(nd <= a.nthr)) return false;
    }
  }
  if (kDirs) {
    const float dc = fmaxf(dist, 1.0e-30f);
    float c = sum3(__fmul_rn(__fdiv_rn(dx, dc), g[5]),
                   __fmul_rn(__fdiv_rn(dy, dc), g[6]),
                   __fmul_rn(__fdiv_rn(dz, dc), g[7]));
    c = fminf(fmaxf(c, -1.f), 1.f);
    if (!(acosf(c) <= a.athr)) return false;
  }
  return true;
}

// The filters of a group's candidates (the bits of m0 / m1 over the
// warp's lanes; bit k is staged column idx[k]): each lane drops
// its own candidates that fail the scores, then the rest are evaluated
// one a lane from a list in shared memory; m0 / m1 become the passing
// bits. Called by the whole warp.
template <bool kDist, bool kDirs>
__device__ __forceinline__ void filter_chunk(Smem<true>& sm, const Args& a,
                                             int warp, int lane, int buf,
                                             const unsigned short* idx,
                                             unsigned& m0, unsigned& m1) {
  if (a.use_scores) {
    // the separable scores first, by each lane on its own row: cheap, and
    // they drop most candidates before the list
    const float rs0 = sm.row_sc[warp][0][lane], rs1 = sm.row_sc[warp][1][lane];
    for (unsigned mm = m0; mm; mm &= mm - 1u) {
      const int k = __ffs(mm) - 1;
      if (!(__fadd_rn(rs0, sm.sc[buf][0][idx[k]]) >=
            2.f))
        m0 &= ~(1u << k);
    }
    for (unsigned mm = m1; mm; mm &= mm - 1u) {
      const int k = __ffs(mm) - 1;
      if (!(__fadd_rn(rs1, sm.sc[buf][1][idx[k]]) >=
            2.f))
        m1 &= ~(1u << k);
    }
  }
  const int c = __popc(m0) + __popc(m1);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  if (total == 0) return;  // warp-uniform; m0 = m1 = 0
  unsigned short* list = sm.list[warp];
  int pos = incl - c;
  for (unsigned mm = m0; mm; mm &= mm - 1u)
    list[pos++] = (unsigned short)((lane << 5) | (__ffs(mm) - 1));
  for (unsigned mm = m1; mm; mm &= mm - 1u)
    list[pos++] = (unsigned short)(1024 | (lane << 5) | (__ffs(mm) - 1));
  sm.pass[warp][0][lane] = 0u;
  sm.pass[warp][1][lane] = 0u;
  __syncwarp();
  for (int i = lane; i < total; i += 32) {
    const int v = list[i];
    const int e = v >> 10, r = (v >> 5) & 31, k = v & 31;
    if (candidate_pass<kDist, kDirs>(sm, a, warp, buf, e, r, idx[k]))
      atomicOr(&sm.pass[warp][e][r], 1u << k);
  }
  __syncwarp();
  m0 = sm.pass[warp][0][lane];
  m1 = sm.pass[warp][1][lane];
  __syncwarp();  // the next chunk rewrites the list and the bits
}

// Appends the hits m (bit i: column c0 + idx[i]) to the lane's row:
// stored while the row holds fewer than cap, counted always.
__device__ __forceinline__ void emit(unsigned m, int c0,
                                     const unsigned short* idx, int cap,
                                     int& cnt, int* out) {
  if (!m) return;
  const int pc = __popc(m);
  if (cnt < cap) {
    const int nst = min(pc, cap - cnt);
    int* o = out + cnt;
    for (int s = 0; s < nst; ++s) {
      o[s] = c0 + idx[__ffs(m) - 1];
      m &= m - 1u;
    }
  }
  cnt += pc;
}

template <bool kDist, bool kDirs, bool kFilt>
__global__ void __launch_bounds__(THREADS, 4)
rowcap_layout_kernel(const Args a) {
  constexpr int TILE = Smem<kFilt>::TILE;
  __shared__ Smem<kFilt> sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.y, g = t / a.per_set;
  const int n = a.n, cap = a.row_cap, ne = a.edges, n_pad = a.n_pad;
  const int block_slot0 = blockIdx.x * BLOCK_ROWS;
  const int slot0 = block_slot0 + warp * 32;
  const int slot = slot0 + lane;
  const bool live = slot < n;
  const bool warp_live = slot0 < n;  // warp-uniform
  // the lane's row: slot s < n walks row perm[s], a padded slot its own
  const int row = (a.perm != nullptr && live)
                      ? a.perm[(long long)g * n + slot] : slot;
  const float4* pts = a.pts + (long long)g * n;
  const float4* nrm = a.use_normals ? a.nrm + (long long)g * n : nullptr;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool reject = kDist && a.spheres != nullptr;

  // each edge's interval of q: [lo^2, hi^2], or the angle path's
  // pre-band; an absent edge has none
  float lo[2] = {1.f, 1.f}, hi[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e >= ne) continue;
    const float* gp = a.geo + ((long long)e * a.trials + t) * GEO;
    if (kDirs)
      pre_band(gp[2], gp[3], lo[e], hi[e]);
    else {
      lo[e] = gp[0];
      hi[e] = gp[1];
    }
  }
  const float4 ap = live ? pts[row] : zero;
  if constexpr (kFilt) {
    if (threadIdx.x < 2 * GEO) {
      const int e = threadIdx.x / GEO, i = threadIdx.x % GEO;
      sm.geo[e][i] =
          e < ne ? a.geo[((long long)e * a.trials + t) * GEO + i] : 0.f;
    }
    sm.row_pt[warp][lane] = ap;
    sm.row_nrm[warp][lane] = (a.use_normals && live) ? nrm[row] : zero;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      sm.row_sc[warp][e][lane] =
          (a.use_scores && live && e < ne)
              ? a.scores[(((long long)e * a.trials + t) * 2) * n + row]
              : 0.f;
  }
  int cnt[2] = {0, 0};
  int* out[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    out[e] = a.cols + (((long long)e * a.trials + t) * n_pad + row) * cap;
  // the rejection's column limits for the warp's row sphere; without
  // rejection every column is a candidate
  float4 rsph = zero;
  float far2[2] = {0.f, 0.f}, near2[2] = {0.f, 0.f};
  if (reject && warp_live) {
    rsph = a.spheres[(long long)g * ((n + 31) / 32) + slot0 / 32];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (e < ne) reject_limits(rsph, a.mag2[g], lo[e], hi[e], far2[e],
                                near2[e]);
  }

  if (block_slot0 < n) {  // block-uniform
    const int off = a.offs[t];
    const int ntiles = (n + TILE - 1) / TILE;
    const int nparts = ntiles + (off > (off / TILE) * TILE ? 1 : 0);
    auto stage = [&](int p, int buf) {
      int tile, plo, phi;
      part_of(p, off, n, TILE, tile, plo, phi);
      const int c0 = tile * TILE;
      const int cn = min(TILE, n - c0);
      for (int k = threadIdx.x; k < cn; k += THREADS) {
        cp_async16(&sm.pt[buf][k], pts + c0 + k);
        if constexpr (kFilt) {
          if (a.use_normals) cp_async16(&sm.nrm[buf][k], nrm + c0 + k);
          if (a.use_scores)
            for (int e = 0; e < ne; ++e)
              cp_async4(&sm.sc[buf][e][k],
                        a.scores + (((long long)e * a.trials + t) * 2 + 1) *
                                       n + c0 + k);
        }
      }
      cp_async_commit();
    };
    stage(0, 0);
    for (int p = 0; p < nparts; ++p) {
      const int buf = p & 1;
      if (p + 1 < nparts) {
        stage(p + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (warp_live) {
        int tile, plo, phi;
        part_of(p, off, n, TILE, tile, plo, phi);
        const int tbase = tile * TILE;
        const int k_first = (plo - tbase) >> 5;
        const int k_last = (phi - 1 - tbase) >> 5;
        const float4* tp = sm.pt[buf];
        // the candidates: each chunk's columns of the part, less those the
        // rejection drops (lane l tests column l against the warp's row
        // sphere), listed in walk order
        unsigned short* cand = sm.cand[warp];
        int nc = 0;
        for (int k = k_first; k <= k_last; ++k) {
          const int c0 = tbase + 32 * k;
          const int blo = max(plo - c0, 0), bhi = min(phi - c0, 32);
          unsigned cm =
              (bhi >= 32 ? FULL : ((1u << bhi) - 1u)) & (FULL << blo);
          if (reject) {
            const float4 b = tp[32 * k + lane];
            const float dx = __fsub_rn(b.x, rsph.x);
            const float dy = __fsub_rn(b.y, rsph.y);
            const float dz = __fsub_rn(b.z, rsph.z);
            const float sb =
                sum3(__fmul_rn(dx, dx), __fmul_rn(dy, dy), __fmul_rn(dz, dz));
            cm &= __ballot_sync(
                FULL, !(sb > far2[0] || sb < near2[0]) ||
                          (ne > 1 && !(sb > far2[1] || sb < near2[1])));
          }
          if ((cm >> lane) & 1u)
            cand[nc + __popc(cm & ((1u << lane) - 1u))] =
                (unsigned short)(32 * k + lane);
          nc += __popc(cm);
        }
        // 32 columns at a time, the last group padded with column 0 and
        // its bits masked
        if (lane < 32 - (nc & 31)) cand[nc + lane] = 0;
        __syncwarp();
        const int own = live ? row - tbase : -1;
        for (int g0 = 0; g0 < nc; g0 += 32) {
          const unsigned short* idx = cand + g0;
          unsigned m0, m1;
          if (ne > 1)
            band_bits<kDist, kDirs, true>(tp, idx, own, ap, lo[0], hi[0],
                                          lo[1], hi[1], m0, m1);
          else
            band_bits<kDist, kDirs, false>(tp, idx, own, ap, lo[0], hi[0],
                                           lo[1], hi[1], m0, m1);
          const unsigned lim =
              (!live) ? 0u : (nc - g0 >= 32 ? FULL : (1u << (nc - g0)) - 1u);
          m0 &= lim;
          m1 &= lim;
          if constexpr (kFilt)
            filter_chunk<kDist, kDirs>(sm, a, warp, lane, buf, idx, m0, m1);
          emit(m0, tbase, idx, cap, cnt[0], out[0]);
          emit(m1, tbase, idx, cap, cnt[1], out[1]);
        }
        __syncwarp();  // the next part rewrites the list
      }
      __syncthreads();  // the next stage overwrites this buffer
    }
  }
  // rc, and -1 in every slot after a row's hits (coalesced: the warp
  // fills its rows one after another)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e >= ne) continue;
    if (slot < n_pad)
      a.rc[((long long)e * a.trials + t) * n_pad + row] = cnt[e];
    const int kept = min(cnt[e], cap);
    for (int r = 0; r < 32; ++r) {
      const int kr = __shfl_sync(FULL, kept, r);
      const int rr = __shfl_sync(FULL, row, r);
      if (slot0 + r >= n_pad) break;  // warp-uniform
      int* o = a.cols + (((long long)e * a.trials + t) * n_pad + rr) * cap;
      for (int s = kr + lane; s < cap; s += 32) o[s] = -1;
    }
  }
}

// No predicate: every pair (i, j != i) of the live rows is a hit. One
// warp a row writes its first row_cap columns of the rotated order with
// the row's own column skipped, and rc = n - 1; padded rows get -1 and
// 0. Grid (n_pad / 8, T); cols (T, n_pad, row_cap), rc (T, n_pad).
__global__ void __launch_bounds__(256) rowcap_layout_kernel_closed(const Args a) {
  const int t = blockIdx.y;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.n_pad) return;
  const int n = a.n, cap = a.row_cap, off = a.offs[t];
  int* o = a.cols + ((long long)t * a.n_pad + row) * cap;
  if (row >= n) {
    for (int s = lane; s < cap; s += 32) o[s] = -1;
    if (lane == 0) a.rc[(long long)t * a.n_pad + row] = 0;
    return;
  }
  int ki = row - off;  // the row's own rank
  if (ki < 0) ki += n;
  for (int s = lane; s < cap; s += 32) {
    const int k = s < ki ? s : s + 1;
    int j = off + k;
    if (j >= n) j -= n;
    o[s] = k < n ? j : -1;
  }
  if (lane == 0) a.rc[(long long)t * a.n_pad + row] = n - 1;
}

template <bool kDist, bool kDirs, bool kFilt>
void launch(dim3 grid, cudaStream_t stream, const Args& a) {
  rowcap_layout_kernel<kDist, kDirs, kFilt><<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace

// Both (or one: edges = 1) base edges of T = trials captures over G =
// trials / per_set point sets, trial t on set t / per_set, in one launch.
// pts (G, n) float4 [x, y, z, |p|^2]; nrm (G, n) float4 [nx, ny, nz,
// |n|^2] with use_normals, else null; scores (edges, T, 2, n) f32 (row
// score vs base point e0, column score vs e1) with use_scores, else null;
// geo (edges, T, 8) f32 [lo2, hi2, d, eps, nang, s0, s1, s2]; offs (T,)
// i32 in [0, n); perm (G, n) i32, the order in which the rows are
// grouped 32 a warp (null: in order); spheres (G, ceil(n / 32)) float4
// [cx, cy, cz, r], the bounding spheres of those groups, and mag2 (G,)
// f32, a bound of each set's |p|^2 (kernels/rowcap_layout.py::
// reject_bounds), turn the rejection on with use_dist (null: off). use_dist: the distance band (off
// in similarity mode); use_dirs: the angle filter (then the band is |dist
// - d| <= eps) with athr its angle in radians; nthr the normal band's
// threshold. Outputs (written whole, no fill needed): cols (edges, T,
// n_pad, row_cap) i32, each row's first row_cap hit columns in rotated
// order from offs[t], -1 after them; rc (edges, T, n_pad) i32, each row's
// hit count. With no predicate (no band, no filter) one table serves
// every edge: cols (T, n_pad, row_cap) and rc (T, n_pad). Returns
// cudaGetLastError.
extern "C" int rowcap_layout(const void* pts, const void* nrm,
                             const void* scores, const void* geo,
                             const void* offs, const void* perm,
                             const void* spheres, const void* mag2,
                             int n, int n_pad, int trials,
                             int per_set, int edges, int row_cap,
                             int use_dist, int use_dirs, int use_normals,
                             int use_scores, float nthr, float athr,
                             void* cols, void* rc, void* stream) {
  if (n_pad == 0 || trials == 0 || edges == 0) return 0;
  Args a;
  a.pts = (const float4*)pts;
  a.nrm = (const float4*)nrm;
  a.scores = (const float*)scores;
  a.geo = (const float*)geo;
  a.offs = (const int*)offs;
  a.perm = (const int*)perm;
  a.spheres = (const float4*)spheres;
  a.mag2 = (const float*)mag2;
  a.n = n;
  a.n_pad = n_pad;
  a.trials = trials;
  a.per_set = per_set;
  a.edges = edges;
  a.row_cap = row_cap;
  a.use_normals = use_normals;
  a.use_scores = use_scores;
  a.nthr = nthr;
  a.athr = athr;
  a.cols = (int*)cols;
  a.rc = (int*)rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool filt = use_dirs || use_normals || use_scores;
  if (!use_dist && !filt) {
    rowcap_layout_kernel_closed<<<dim3((n_pad + 7) / 8, trials), 256, 0, st>>>(
        a);
    return (int)cudaGetLastError();
  }
  const dim3 grid((n_pad + BLOCK_ROWS - 1) / BLOCK_ROWS, trials);
  if (use_dist) {
    if (use_dirs)
      launch<true, true, true>(grid, st, a);
    else if (filt)
      launch<true, false, true>(grid, st, a);
    else
      launch<true, false, false>(grid, st, a);
  } else if (use_dirs) {
    launch<false, true, true>(grid, st, a);
  } else {
    launch<false, false, true>(grid, st, a);
  }
  return (int)cudaGetLastError();
}
