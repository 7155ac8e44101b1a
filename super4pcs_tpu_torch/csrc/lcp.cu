// K1: LCP min squared distance, out[c, q] = min_p |R_c q + t_c - p|^2,
// in two kernels: lcp_min_d2_tiles_kernel, the brute force's min by an
// exact branch-and-bound over a tiled index of P, and the grid-pruned
// lcp_min_d2_within_kernel of the main path's verify (its note is below
// the first's). Beside them refine_nearest_within_kernel, the refine's
// nearest neighbour within the trim radius, walks the verify's cell
// index (its note is below the verify's).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float row_apply(const float* m, float x,
                                           float y, float z) {
  // ((m0 x + m1 y) + m2 z) + m3
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], x),
                                       __fmul_rn(m[1], y)),
                             __fmul_rn(m[2], z)),
                   m[3]);
}

// lcp_min_d2_tiles_kernel: the brute force's min, by an exact
// branch-and-bound over a tiled index of P.
//
// Replaces three TPU kernels of super4pcs_tpu/kernels/lcp_pallas.py:
// _lcp_min_kernel (K1, through candidate_min_sq_dists), and through one
// null transform (kernels/lcp.py::min_sq_dists) the untransformed
// _min_dist_kernel (K4a, min_sq_dists) and _min_dist_stream_kernel (K4b,
// min_sq_dists_streamed); the streamed-P _lcp_min_stream_kernel (K3) is
// the same function. It serves any caller that needs the min beyond eps.
// No path of the matcher launches it (its verify is the kernel below).
//
// Index (kernels/lcp.py::tile_index, torch ops on P's device). P sorted
// by a 63-bit Morton code over its bounding box, as float4 (x, y, z, 0),
// its tail padded to a multiple of 32 by repeating the last point (a
// duplicate never changes a min and keeps every box tight). Tile k is
// points [32k, 32k + 32), one a lane; group g is tiles [32g, 32g + 32)
// (the last may hold fewer). tbox and gbox hold each tile's and group's
// axis-aligned box as two float4, lo then hi.
//
// Walk. A warp owns 32 consecutive slots of the C * nq (candidate,
// query) pairs, and the slots run over the queries: the matcher's Q is
// kd-ordered, so its lanes are neighbours. Below 1024 queries
// (kernels/lcp.py::CAND_INNER_NQ, which sets cand_inner) 32
// consecutive queries span at least 1/32 of Q, so there the slots run
// over the candidates (a warp holds one query under 32 candidates,
// which lie close together when the candidates agree, as a verify's
// best ones do near a good pose) and the output is written strided.
// The block stages its groups' boxes in shared memory.
// Seeds first, so that every lane holds a real min before any pruning:
// among the groups whose box overlaps the box [a, b] of the warp's
// transformed queries (else the one nearest the centre of [a, b]), each
// lane takes the group whose middle is nearest its query, and within it
// the tile whose middle is nearest; the warp visits the distinct seed
// tiles. Then it walks every group in index order, and each group's
// tiles in order, the seed tiles left out. Lane l tests box l of a run
// of 32 against [a, b] with the warp's largest running min (one coarse
// test a lane, a ballot of candidates); each candidate is tested by
// every lane against its own query and its own running min, and the
// warp descends into a group, or loads a tile, when any lane's test
// passes (__any_sync: the warp stays uniform). A visited tile's 32
// points are loaded once, one coalesced float4 a lane, into the warp's
// slot of shared memory, and every lane tests all 32 with the brute
// force's arithmetic.
//
// Exactness. Per axis the gap of a query t to a box [lo, hi] is
// max(rn(lo - t), rn(t - hi), 0): rn(lo - t) when t < lo, rn(t - hi)
// when t > hi, 0 otherwise. The bound is ((gx gx + gy gy) + gz gz) with
// the same __f*_rn operations as d2. For p in the box, |t - p| >= the
// exact gap; round-to-nearest is monotone and odd, so |rn(t - p)| >= the
// computed gap, and squares and sums of non-negative floats are monotone
// too: every point of the box has a computed d2 >= the bound. For the
// coarse test, rn(lo - b) <= rn(lo - t) and rn(a - hi) <= rn(t - hi) for
// every t in [a, b], so its bound is <= each lane's. A box is skipped
// only when its bound is >= the running min (a skipped point can only
// tie), so the min is the brute force's bit for bit, with no margin.
// A query with a NaN transformed coordinate writes NaN and one with an
// infinite one +inf, as lcp_min_d2_plain does; far finite queries (the
// Q_PAD rows at 1e17, d2 ~1e34) walk as any other, and a d2 that
// overflows gives +inf. P is finite.
//
// Filling the card. One warp per 32 slots, 4 warps a block. When C * nq
// gives fewer than two blocks per SM (K4a: 16384 slots are 128 blocks on
// 132 SMs), the group list is split over blockIdx.y into parts, enough
// for two blocks per SM (K4a: 3 parts, 384 blocks); the wrapper picks
// the number (kernels/lcp.py::tile_parts). Part p takes groups
// p, p + parts, ...: every part then holds groups near every query, so
// its seeds and its running mins are nearly the whole walk's, and the
// parts together do little more work than one walk (a part of
// consecutive groups, far from a query, would search its own region in
// full). Each part folds its min into the output with atomicMin on the
// float's bits (non-negative floats order as int32; a min is
// order-free, so the result is still exact), after the output is filled
// with +inf bits on the stream (cudaMemset cannot write that pattern).
// A part also reads the output before each run of groups and prunes
// against it: a value there is some part's real min. At C * nq =
// 524,288 (the exact stage) the grid is 4096 x 1 blocks, 31 per SM. A
// part stages at most 1024 group boxes (32 KB), so a cloud of more than
// 1024 groups (~1M points) is split at any C * nq.
//
// Bound. Its work depends on the data. chip_smoke.py bounds it by what
// the queries need on the index, whatever walks it
// (kernels/lcp.py::needed_tests): a query cannot rule out a tile whose
// bound is below its min, so it makes 32 pair tests (9 operations each,
// as the brute force's) for each such tile, and one box test (18
// operations) for each other group or tile it rules out. Beside that it
// bounds the work this walk did, the pair and box tests of the counting
// build of this kernel (counts != null). P is read once per visited tile
// from L2 (8.5 MB at Np = 530,895 fits the 50 MB L2), so the bytes do
// not bound it: the pair-test loop does, 9 fp32 operations and one
// shared-memory load a point on every lane. What holds it above the
// queries' need is the warp union: a warp visits a tile when any of its
// 32 queries needs it, so it makes several times the pair tests that its
// queries need alone (needed_tests counts both).
//
// Numerics. Transform and d2 as the within kernel below (__f*_rn, no
// FMA; row_apply), so the min is bit-identical to lcp_min_d2_plain and
// to the plain walk of the same index (kernels/lcp.py::
// lcp_min_d2_tiled_plain).

constexpr int TILE = 32;              // points a tile: one a lane
constexpr int GROUP = 32;             // tiles a group
constexpr int B_THREADS = 128;        // 4 warps a block
constexpr int B_WARPS = B_THREADS / 32;
constexpr int MAX_PART_GROUPS = 1024; // group boxes a block stages: 32 KB
constexpr unsigned FULL = 0xffffffffu;

// max(rn(lo - t), rn(t - hi), 0): the axis gap of t to [lo, hi]
__device__ __forceinline__ float axis_gap(float lo, float hi, float t) {
  return fmaxf(fmaxf(__fsub_rn(lo, t), __fsub_rn(t, hi)), 0.f);
}

__device__ __forceinline__ float sum_sq(float gx, float gy, float gz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// lower bound of the computed d2 of the point t to any point of [lo, hi]
__device__ __forceinline__ float box_bound(float4 lo, float4 hi, float tx,
                                           float ty, float tz) {
  return sum_sq(axis_gap(lo.x, hi.x, tx), axis_gap(lo.y, hi.y, ty),
                axis_gap(lo.z, hi.z, tz));
}

// lower bound of box_bound over every t of the query box [a, b]
__device__ __forceinline__ float box_box_bound(float4 lo, float4 hi,
                                               float3 a, float3 b) {
  return sum_sq(
      fmaxf(fmaxf(__fsub_rn(lo.x, b.x), __fsub_rn(a.x, hi.x)), 0.f),
      fmaxf(fmaxf(__fsub_rn(lo.y, b.y), __fsub_rn(a.y, hi.y)), 0.f),
      fmaxf(fmaxf(__fsub_rn(lo.z, b.z), __fsub_rn(a.z, hi.z)), 0.f));
}

// the seed key: d2 of the point t to the middle of the box [lo, hi]
__device__ __forceinline__ float mid_d2(float4 lo, float4 hi, float tx,
                                        float ty, float tz) {
  return sum_sq(__fsub_rn(tx, __fadd_rn(__fmul_rn(0.5f, lo.x),
                                        __fmul_rn(0.5f, hi.x))),
                __fsub_rn(ty, __fadd_rn(__fmul_rn(0.5f, lo.y),
                                        __fmul_rn(0.5f, hi.y))),
                __fsub_rn(tz, __fadd_rn(__fmul_rn(0.5f, lo.z),
                                        __fmul_rn(0.5f, hi.z))));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the (value, index) of the warp's least value, the lower index on ties
__device__ __forceinline__ int warp_argmin(float v, int i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  return i;
}

__global__ void lcp_min_d2_tiles_fill_kernel(float* __restrict__ out,
                                             long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) out[i] = INFINITY;
}

// One lane's walk state, shared by the visit of a tile.
struct Walk {
  float tx, ty, tz;  // the transformed query
  float best;        // this part's running min
  float ext;         // the output's value (other parts' min), or +inf
  bool live;         // a finite query of this launch
  unsigned long long pairs, boxes;  // the counting build's tallies
  __device__ __forceinline__ float limit() const { return fminf(best, ext); }
};

// Visit tile `tile` (box lo, hi) if any lane's bound is below its limit:
// load its 32 points once and test them all on every lane.
template <bool COUNT>
__device__ __forceinline__ void visit_tile(Walk& w, float4* slot,
                                           const float4* __restrict__ pts,
                                           int tile, float4 lo, float4 hi,
                                           int lane) {
  const bool want =
      w.live && box_bound(lo, hi, w.tx, w.ty, w.tz) < w.limit();
  if (COUNT && w.live) ++w.boxes;
  if (!__any_sync(FULL, want)) return;
  slot[lane] = __ldg(pts + (long long)tile * TILE + lane);
  __syncwarp();
  float best = w.best;
#pragma unroll 8
  for (int j = 0; j < TILE; ++j) {
    const float4 v = slot[j];
    const float dx = __fsub_rn(w.tx, v.x);
    const float dy = __fsub_rn(w.ty, v.y);
    const float dz = __fsub_rn(w.tz, v.z);
    best = fminf(best, sum_sq(dx, dy, dz));
  }
  __syncwarp();
  if (w.live) {
    w.best = best;
    if (COUNT) w.pairs += TILE;
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(B_THREADS)
lcp_min_d2_tiles_kernel(const float* __restrict__ transforms,
                        const float* __restrict__ q,
                        const float4* __restrict__ pts,
                        const float4* __restrict__ tbox,
                        const float4* __restrict__ gbox, float* out,
                        unsigned long long* __restrict__ counts,
                        long long total, int nq, int nc, bool cand_inner,
                        int n_tiles, int n_groups) {
  extern __shared__ float4 sgbox[];  // 2 * ng: lo, hi
  __shared__ float4 stile[B_WARPS][2 * TILE];  // a tile, or 32 boxes
  // this part's groups: part, part + parts, ... (local k is group
  // part + k * parts)
  const int part = blockIdx.y, parts = gridDim.y;
  const int ng = (n_groups - part + parts - 1) / parts;
  for (int i = threadIdx.x; i < 2 * ng; i += B_THREADS)
    sgbox[i] = __ldg(gbox + 2LL * (part + (long long)(i >> 1) * parts) +
                     (i & 1));
  __syncthreads();

  const bool split = parts > 1;
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * B_THREADS + threadIdx.x;
  const bool in_range = s < total;
  long long o = 0;  // the slot's output index c * nq + qi
  Walk w;
  w.tx = w.ty = w.tz = 0.f;
  if (in_range) {
    const long long c = cand_inner ? s % nc : s / nq;
    const long long qi = cand_inner ? s / nc : s % nq;
    o = c * nq + qi;
    const float x = q[3 * qi], y = q[3 * qi + 1], z = q[3 * qi + 2];
    if (transforms != nullptr) {
      const float* m = transforms + 16 * c;
      w.tx = row_apply(m, x, y, z);
      w.ty = row_apply(m + 4, x, y, z);
      w.tz = row_apply(m + 8, x, y, z);
    } else {
      w.tx = x;
      w.ty = y;
      w.tz = z;
    }
  }
  w.live = in_range && isfinite(w.tx) && isfinite(w.ty) && isfinite(w.tz);
  w.best = INFINITY;
  w.ext = INFINITY;
  w.pairs = w.boxes = 0;
  if (in_range && !w.live && blockIdx.y == 0) {
    // the plain version's value: NaN - p is NaN, +-inf - p squares to inf
    out[o] = (isnan(w.tx) || isnan(w.ty) || isnan(w.tz)) ? NAN : INFINITY;
  }
  if (__ballot_sync(FULL, w.live) == 0) return;  // warp-uniform

  // the warp's query box [a, b] and its centre
  float3 a, b;
  a.x = warp_min(w.live ? w.tx : INFINITY);
  a.y = warp_min(w.live ? w.ty : INFINITY);
  a.z = warp_min(w.live ? w.tz : INFINITY);
  b.x = warp_max(w.live ? w.tx : -INFINITY);
  b.y = warp_max(w.live ? w.ty : -INFINITY);
  b.z = warp_max(w.live ? w.tz : -INFINITY);
  const float cx = 0.5f * a.x + 0.5f * b.x, cy = 0.5f * a.y + 0.5f * b.y,
              cz = 0.5f * a.z + 0.5f * b.z;
  if (split && w.live) w.ext = __ldcg(out + o);

  // seed groups: among the part's groups that overlap the warp's box,
  // the one whose middle is nearest each lane's query, else the group
  // nearest the box's centre
  float4* slot = stile[threadIdx.x >> 5];
  float sv = INFINITY, cv = INFINITY;
  int sg = -1, cg = 0x7fffffff;
  for (int base = 0; base < ng; base += 32) {
    const int gi = base + lane;
    bool ov = false;
    if (gi < ng) {
      const float4 lo = sgbox[2 * gi], hi = sgbox[2 * gi + 1];
      ov = box_box_bound(lo, hi, a, b) == 0.f;
      const float v = box_bound(lo, hi, cx, cy, cz);
      if (v < cv || cg == 0x7fffffff) {
        cv = v;
        cg = gi;
      }
      if (COUNT) w.boxes += 2;
    }
    unsigned om = __ballot_sync(FULL, ov);
    while (om) {
      const int g = base + __ffs(om) - 1;
      om &= om - 1;
      if (w.live) {
        const float v = mid_d2(sgbox[2 * g], sgbox[2 * g + 1], w.tx, w.ty,
                               w.tz);
        if (COUNT) ++w.boxes;
        if (v < sv || sg < 0) {
          sv = v;
          sg = g;
        }
      }
    }
  }
  cg = warp_argmin(cv, cg);
  if (__ballot_sync(FULL, sg >= 0) == 0) sg = cg;

  // the tile of its seed group whose middle is nearest each lane's query,
  // one seed group at a time
  int st = -1;
  float tv = INFINITY;
  bool todo = w.live;
  for (unsigned pm; (pm = __ballot_sync(FULL, todo)) != 0;) {
    const int g = __shfl_sync(FULL, sg, __ffs(pm) - 1);
    const int first = (part + g * parts) * GROUP;
    const int nt = min(GROUP, n_tiles - first);
    if (lane < nt) {
      slot[2 * lane] = __ldg(tbox + 2LL * (first + lane));
      slot[2 * lane + 1] = __ldg(tbox + 2LL * (first + lane) + 1);
    }
    __syncwarp();
    if (todo && sg == g) {
      for (int k = 0; k < nt; ++k) {
        const float v = mid_d2(slot[2 * k], slot[2 * k + 1], w.tx, w.ty,
                               w.tz);
        if (v < tv || st < 0) {
          tv = v;
          st = first + k;
        }
      }
      if (COUNT) w.boxes += nt;
      todo = false;
    }
    __syncwarp();
  }

  // visit the distinct seed tiles, in the order of their first lane; lane
  // k keeps the k-th in seed_slot
  int n_seed = 0, seed_slot = -1;
  bool done = !w.live;
  for (unsigned pm; (pm = __ballot_sync(FULL, !done)) != 0;) {
    const int tile = __shfl_sync(FULL, st, __ffs(pm) - 1);
    if (lane == n_seed) seed_slot = tile;
    ++n_seed;
    visit_tile<COUNT>(w, slot, pts, tile, __ldg(tbox + 2LL * tile),
                      __ldg(tbox + 2LL * tile + 1), lane);
    done |= st == tile;
  }

  // every group, and every tile, whose bound is below some lane's limit
  for (int base = 0; base < ng; base += 32) {
    if (split && w.live) w.ext = fminf(w.ext, __ldcg(out + o));
    const float wl = warp_max(w.live ? w.limit() : -INFINITY);
    const int gi = base + lane;
    bool cand = false;
    if (gi < ng) {
      cand = box_box_bound(sgbox[2 * gi], sgbox[2 * gi + 1], a, b) < wl;
      if (COUNT) ++w.boxes;
    }
    unsigned gm = __ballot_sync(FULL, cand);
    while (gm) {
      const int g = base + __ffs(gm) - 1;
      gm &= gm - 1;
      const bool want =
          w.live && box_bound(sgbox[2 * g], sgbox[2 * g + 1], w.tx, w.ty,
                              w.tz) < w.limit();
      if (COUNT && w.live) ++w.boxes;
      if (!__any_sync(FULL, want)) continue;
      const int first = (part + g * parts) * GROUP;
      const int tile = first + lane;
      bool seeded = false;
      for (int k = 0; k < n_seed; ++k)
        seeded |= __shfl_sync(FULL, seed_slot, k) == tile;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      bool tc = false;
      const float tl = warp_max(w.live ? w.limit() : -INFINITY);
      if (tile < n_tiles && !seeded) {
        lo = __ldg(tbox + 2LL * tile);
        hi = __ldg(tbox + 2LL * tile + 1);
        tc = box_box_bound(lo, hi, a, b) < tl;
        if (COUNT) ++w.boxes;
      }
      unsigned tm = __ballot_sync(FULL, tc);
      while (tm) {
        const int j = __ffs(tm) - 1;
        tm &= tm - 1;
        float4 jlo, jhi;
        jlo.x = __shfl_sync(FULL, lo.x, j);
        jlo.y = __shfl_sync(FULL, lo.y, j);
        jlo.z = __shfl_sync(FULL, lo.z, j);
        jhi.x = __shfl_sync(FULL, hi.x, j);
        jhi.y = __shfl_sync(FULL, hi.y, j);
        jhi.z = __shfl_sync(FULL, hi.z, j);
        visit_tile<COUNT>(w, slot, pts, first + j, jlo, jhi, lane);
      }
    }
  }

  if (w.live) {
    if (split)
      atomicMin(reinterpret_cast<int*>(out) + o, __float_as_int(w.best));
    else
      out[o] = w.best;
  }
  if (COUNT) {
    unsigned long long p = w.pairs, x = w.boxes;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p += __shfl_xor_sync(FULL, p, off);
      x += __shfl_xor_sync(FULL, x, off);
    }
    if (lane == 0) {
      atomicAdd(counts, p);
      atomicAdd(counts + 1, x);
    }
  }
}

// lcp_min_d2_within_kernel: the verify of the main path.
//
// Replaces the K1 call of the TPU's verify (super4pcs_tpu/kernels/
// lcp_pallas.py:157-166, lcp_scores_pallas, through
// candidate_min_sq_dists): the initial identity verify, the coarse, mid
// and exact stages of lcp_scores_two_stage and the re-verify after each
// refine. The verify consumes only d2 <= eps^2 (ops/lcp.py), so the
// kernel returns the min where it is <= eps2 and +inf elsewhere, which
// is exact: a point beyond eps never changes a min below eps.
//
// Design. The TPU kept all of P resident in VMEM and computed dense d2
// blocks, because it has no cheap gather. On the H100 P fits in the
// 50 MB L2 (16 bytes a point), so each thread gathers the few points
// near its query instead. The wrapper (kernels/lcp.py::grid_index) sorts
// P by the key of a uniform grid of side L >= eps (float4 points, int32
// keys). One thread owns one (candidate, query) pair, applies its
// transform in registers, and scans the cells from cell(t - e) to
// cell(t + e) per axis, e = eps (1 + 2^-20) + 2^-20 max(|t|_inf, eps):
// per (x, y) column of that box one binary search finds the first key of
// the column's z range, and the points follow in key order. The box is
// computed with the float32 expression that assigned P to cells, so it
// is monotone and conservative; a non-finite t (a NaN transform) or a
// box outside the grid (Q_PAD rows, 1e17) gives +inf. Points and keys
// are read through the read-only cache (__ldg). The matcher's Q is
// kd-ordered, so the threads of a warp walk neighbouring cells.
//
// Pairs axis. Batched registration verifies the candidates of G point
// cloud pairs in one launch (the TPU vmapped the verify over the pairs).
// The wrapper builds each pair's index once per run and concatenates
// them: pair g's points and keys are [offs[g], offs[g + 1]) of pts and
// keys, its grid row g of grid. Every pair has C candidates and nq
// queries; candidate c belongs to pair c / C and searches only its
// pair's range, so each pair's output is the single-pair kernel's.
//
// Bound. The work depends on the data: per query, up to 9-16 binary
// searches over np keys and the points of 27-64 cells of side eps (about
// 10 points on a surface sampled at eps), each a 9-operation d2 test;
// chip_smoke.py counts the pair tests of its inputs. The reads (a few
// hundred bytes a query from L2) and latency of the dependent searches
// bound it, not the fp32 rate.
//
// Numerics. Transform and d2 exactly as lcp_min_d2_tiles_kernel (__f*_rn,
// no FMA), so the result is bit-identical to
// where(lcp_min_d2_plain <= eps2, lcp_min_d2_plain, inf) and to the
// plain walk of the same index (kernels/lcp.py::lcp_min_d2_within_plain).

__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The query box of t at radius eps on the grid [lo_x, lo_y, lo_z, L, nx,
// ny, nz]: the inclusive cell range lo..hi per axis, false where it
// holds no cell (t not finite, or the box outside the grid).
__device__ __forceinline__ bool query_box(const float t[3],
                                          const float* __restrict__ grid,
                                          float eps, int lo[3],
                                          int hi[3]) {
  if (!(isfinite(t[0]) && isfinite(t[1]) && isfinite(t[2]))) return false;
  const float side = grid[3];
  const float tmax = fmaxf(fmaxf(fabsf(t[0]), fabsf(t[1])),
                           fmaxf(fabsf(t[2]), eps));
  const float e = __fadd_rn(__fmul_rn(eps, 1.f + 0x1p-20f),
                            __fmul_rn(0x1p-20f, tmax));
  bool empty = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float top = __fsub_rn(grid[4 + a], 1.f);
    const float flo = floorf(__fdiv_rn(
        __fsub_rn(__fsub_rn(t[a], e), grid[a]), side));
    const float fhi = floorf(__fdiv_rn(
        __fsub_rn(__fadd_rn(t[a], e), grid[a]), side));
    const bool outside = fhi < 0.f || flo > top;
    empty |= outside;
    lo[a] = outside ? 0 : (int)fmaxf(flo, 0.f);
    hi[a] = outside ? 0 : (int)fminf(fhi, top);
  }
  return !empty;
}

// visit(j) for every position j in [p0, p1) of the sorted keys whose
// cell lies in the box lo..hi, in key order: per (x, y) column one
// binary search for the first key of the column's z range.
template <class Visit>
__device__ __forceinline__ void walk_box(const int* __restrict__ keys,
                                         int p0, int p1,
                                         const float* __restrict__ grid,
                                         const int lo[3], const int hi[3],
                                         Visit&& visit) {
  const int ny = (int)grid[5], nz = (int)grid[6];
  int from = p0;  // keys grow with (ix, iy): later columns start later
  for (int ix = lo[0]; ix <= hi[0]; ++ix) {
    for (int iy = lo[1]; iy <= hi[1]; ++iy) {
      const int col = (ix * ny + iy) * nz;
      const int kend = col + hi[2];
      int j = lower_bound(keys, from, p1, col + lo[2]);
      for (; j < p1 && __ldg(keys + j) <= kend; ++j) visit(j);
      from = j;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lcp_min_d2_within_kernel(const float* __restrict__ transforms,
                         const float* __restrict__ q,
                         const float4* __restrict__ pts,
                         const int* __restrict__ keys,
                         const int* __restrict__ offs,
                         const float* __restrict__ grids,
                         float* __restrict__ out, long long total, int nq,
                         int per_pair, float eps, float eps2) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= total) return;
  const long long c = g / nq;
  const long long qi = g - c * nq;
  const int pair = (int)(c / per_pair);
  const float* m = transforms + 16 * c;
  const float* qp = q + 3 * ((long long)pair * nq + qi);
  const float x = qp[0], y = qp[1], z = qp[2];
  const float t[3] = {row_apply(m, x, y, z), row_apply(m + 4, x, y, z),
                      row_apply(m + 8, x, y, z)};
  const float* grid = grids + 7 * pair;
  const int p0 = offs[pair], p1 = offs[pair + 1];
  float best = INFINITY;
  int lo[3], hi[3];
  if (p1 > p0 && query_box(t, grid, eps, lo, hi)) {
    walk_box(keys, p0, p1, grid, lo, hi, [&](int j) {
      const float4 v = __ldg(pts + j);
      best = fminf(best, sum_sq(__fsub_rn(t[0], v.x), __fsub_rn(t[1], v.y),
                                __fsub_rn(t[2], v.z)));
    });
  }
  out[g] = best <= eps2 ? best : INFINITY;
}

// refine_nearest_within_kernel: the nearest neighbour of one ICP
// iteration of the refine (ops/refine.py::refine_transform).
//
// Replaces no Pallas kernel: the JAX package's refine finds neighbours
// with XLA (super4pcs_tpu/ops/refine.py::_nearest), a dense pass over
// all of P under the |t|^2 + |p|^2 - 2 t.p expansion, blocked for the
// TPU's matrix unit; the port's first version did the same with cuBLAS
// and elementwise planes of (nq, 4096) floats in device memory. The
// refine weighs only queries whose d2 is within the trim radius r
// (2 delta max(1, start_factor)), and a query of zero weight adds
// nothing whatever neighbour it got, so the nearest point within r is
// all it needs.
//
// Design. A walk, not a dense pass: the work drops from nq x np pair
// tests to nq x the points of the 27-64 cells of side >= r around each
// query. The verify's cell index of P at radius r (kernels/lcp.py::
// grid_index), its query box (query_box) and its walk (walk_box). One
// thread owns one query, applies the (4, 4) transform in registers and
// keeps the point of least d2 <= r2; ties go to the lower position in
// key order (the walk visits positions in increasing order, and only a
// strictly smaller d2 replaces the best). It writes (x, y, z, d2) of that
// point, or (0, 0, 0, +inf) where no point lies within r (a non-finite
// query, the Q_PAD sentinel rows, an empty box). Returning the point,
// not its index, makes the repeat-padded P of register_batch harmless:
// a duplicate gives the same target.
//
// Bound. As the verify's walk: the L2 reads of the points and keys and
// the latency of the dependent binary searches, not the fp32 rate; one
// launch is one transform, so 8192 threads, 32 blocks of 256.
//
// Numerics. row_apply and sum_sq (__f*_rn, no FMA), so the output is
// bit-identical to the plain walk of the same index (kernels/lcp.py::
// nearest_within_plain).

__global__ void __launch_bounds__(THREADS)
refine_nearest_within_kernel(const float* __restrict__ m,
                             const float* __restrict__ q,
                             const float4* __restrict__ pts,
                             const int* __restrict__ keys,
                             const float* __restrict__ grid,
                             float4* __restrict__ out, int nq, int np,
                             float eps, float eps2) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= nq) return;
  const float x = q[3 * i], y = q[3 * i + 1], z = q[3 * i + 2];
  const float t[3] = {row_apply(m, x, y, z), row_apply(m + 4, x, y, z),
                      row_apply(m + 8, x, y, z)};
  float best = INFINITY;
  int at = -1;
  int lo[3], hi[3];
  if (query_box(t, grid, eps, lo, hi)) {
    walk_box(keys, 0, np, grid, lo, hi, [&](int j) {
      const float4 v = __ldg(pts + j);
      const float d2 = sum_sq(__fsub_rn(t[0], v.x), __fsub_rn(t[1], v.y),
                              __fsub_rn(t[2], v.z));
      if (d2 <= eps2 && d2 < best) {
        best = d2;
        at = j;
      }
    });
  }
  if (at < 0) {
    out[i] = make_float4(0.f, 0.f, 0.f, INFINITY);
  } else {
    const float4 v = __ldg(pts + at);
    out[i] = make_float4(v.x, v.y, v.z, best);
  }
}

}  // namespace

// transforms: (c, 4, 4) f32, or null for the rows of q as they are (c =
// 1); q: (nq, 3) f32; and P's tile index
// (kernels/lcp.py::tile_index): pts (32 n_tiles, 4) f32, tbox (n_tiles,
// 2, 4) f32, gbox (n_groups, 2, 4) f32; out: (c, nq) f32; counts: null,
// or two zeroed uint64 that the counting build adds its pair tests and
// box tests to. All contiguous on the device of `stream`; n_groups >= 1.
// The caller picks the launch (kernels/lcp.py::_launch_tiles): `parts`
// of the group list over blockIdx.y (1 <= parts <= n_groups, at most
// MAX_PART_GROUPS groups a part), and `cand_inner` != 0 for slots over
// the candidates. One launch, after a fill of out when parts > 1.
// Returns cudaGetLastError, or cudaErrorInvalidValue for a launch
// outside those limits.
extern "C" int lcp_min_d2_tiles(const void* transforms, const void* q,
                                const void* pts, const void* tbox,
                                const void* gbox, void* out, void* counts,
                                int c, int nq, int n_tiles, int n_groups,
                                int parts, int cand_inner, void* stream) {
  const long long total = (long long)c * nq;
  if (total == 0) return 0;
  if (n_groups < 1 || n_tiles < 1 || parts < 1 || parts > n_groups ||
      parts > 65535)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (total + B_THREADS - 1) / B_THREADS;
  const int per = (n_groups + parts - 1) / parts;
  if (per > MAX_PART_GROUPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (parts > 1) {
    lcp_min_d2_tiles_fill_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                   st>>>((float*)out, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)blocks, (unsigned)parts);
  const size_t smem = 2 * (size_t)per * sizeof(float4);
  if (counts != nullptr)
    lcp_min_d2_tiles_kernel<true><<<grid, B_THREADS, smem, st>>>(
        (const float*)transforms, (const float*)q, (const float4*)pts,
        (const float4*)tbox, (const float4*)gbox, (float*)out,
        (unsigned long long*)counts, total, nq, c, cand_inner != 0,
        n_tiles, n_groups);
  else
    lcp_min_d2_tiles_kernel<false><<<grid, B_THREADS, smem, st>>>(
        (const float*)transforms, (const float*)q, (const float4*)pts,
        (const float4*)tbox, (const float4*)gbox, (float*)out, nullptr,
        total, nq, c, cand_inner != 0, n_tiles, n_groups);
  return (int)cudaGetLastError();
}

// Pairs axis of G pairs: transforms (G * per_pair, 4, 4) f32 (candidate
// c of pair c / per_pair), q: (G, nq, 3) f32, pts: (N, 4) f32 and keys:
// (N,) i32, each pair's range [offs[g], offs[g + 1]) sorted by key, offs:
// (G + 1,) i32, grids: (G, 7) f32 [lo_x, lo_y, lo_z, L, nx, ny, nz]
// (kernels/lcp.py::build_index), out: (G * per_pair, nq) f32; all
// contiguous on the device of `stream`; eps2 = float32(eps) *
// float32(eps). One launch. Returns cudaGetLastError.
extern "C" int lcp_min_d2_within(const void* transforms, const void* q,
                                 const void* pts, const void* keys,
                                 const void* offs, const void* grids,
                                 void* out, int c, int per_pair, int nq,
                                 float eps, float eps2, void* stream) {
  const long long total = (long long)c * nq;
  if (total == 0) return 0;
  const long long blocks = (total + THREADS - 1) / THREADS;
  lcp_min_d2_within_kernel<<<(unsigned)blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const float*)transforms, (const float*)q, (const float4*)pts,
      (const int*)keys, (const int*)offs, (const float*)grids,
      (float*)out, total, nq, per_pair, eps, eps2);
  return (int)cudaGetLastError();
}

// transform: (4, 4) f32; q: (nq, 3) f32; pts: (np, 4) f32, keys: (np,)
// i32 and grid: (7,) f32, one cloud's cell index (kernels/lcp.py::
// grid_index), np >= 1; out: (nq, 4) f32; all contiguous on the device
// of `stream`; eps2 = float32(eps) * float32(eps). One launch. Returns
// cudaGetLastError.
extern "C" int refine_nearest_within(const void* transform, const void* q,
                                     const void* pts, const void* keys,
                                     const void* grid, void* out, int nq,
                                     int np, float eps, float eps2,
                                     void* stream) {
  if (nq == 0) return 0;
  const int blocks = (nq + THREADS - 1) / THREADS;
  refine_nearest_within_kernel<<<blocks, THREADS, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)transform, (const float*)q, (const float4*)pts,
      (const int*)keys, (const float*)grid, (float4*)out, nq, np, eps,
      eps2);
  return (int)cudaGetLastError();
}
