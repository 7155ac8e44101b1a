// K1: LCP min squared distance, out[c, q] = min_p |R_c q + t_c - p|^2,
// in two kernels: the grid-pruned lcp_min_d2_within_kernel of the main
// path's verify (its note is below the brute force's) and the brute-force
// lcp_min_d2_kernel.
//
// lcp_min_d2_kernel replaces the TPU kernel super4pcs_tpu/kernels/lcp_pallas.py::
// _lcp_min_kernel (K1, launched by candidate_min_sq_dists), and with it
// the streamed-P _lcp_min_stream_kernel (K3) and, through one identity
// transform (kernels/lcp.py::min_sq_dists), the untransformed
// _min_dist_kernel and _min_dist_stream_kernel (K4a, K4b): it serves
// min_sq_dists and any caller that needs the min beyond eps.
//
// Design. One thread owns one (candidate, query) pair of the flattened
// C * nq space, so a block spans several candidates when nq is small
// (the coarse stage has nq = 64) and no thread idles. The thread applies
// its transform in registers, then streams P through shared memory in
// tiles of P_TILE points; every thread of the block reads the same
// float4 per step (a broadcast, no bank conflicts), so any Np works:
// the TPU's split between a VMEM-resident P (up to 300k points) and a
// streamed one has no counterpart here.
//
// Bound. C * nq * Np pair tests of 8 flops each (3 sub, 3 mul, 2 add)
// plus a min, on the CUDA cores, fp32, no tensor cores: compute-bound.
// P is reread once per block from L2 (blocks * Np * 16 bytes), the
// output is C * nq * 4 bytes.
//
// Numerics. d^2 is the sum of squared coordinate differences, never the
// |a|^2 + |b|^2 - 2ab expansion. Every product and sum uses __fmul_rn /
// __fadd_rn in a fixed order, so nothing is contracted into an FMA and
// the result is bit-identical to the plain PyTorch version
// (kernels/lcp.py::lcp_min_d2_plain).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int P_TILE = 1024;

__device__ __forceinline__ float row_apply(const float* m, float x,
                                           float y, float z) {
  // ((m0 x + m1 y) + m2 z) + m3
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], x),
                                       __fmul_rn(m[1], y)),
                             __fmul_rn(m[2], z)),
                   m[3]);
}

__global__ void __launch_bounds__(THREADS)
lcp_min_d2_kernel(const float* __restrict__ transforms,
                  const float* __restrict__ q,
                  const float* __restrict__ p,
                  float* __restrict__ out,
                  long long total, int nq, int np) {
  __shared__ float4 tile[P_TILE];
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = g < total;
  float tx = 0.f, ty = 0.f, tz = 0.f;
  if (live) {
    const long long c = g / nq;
    const long long qi = g - c * nq;
    const float* m = transforms + 16 * c;  // row-major 4x4
    const float x = q[3 * qi], y = q[3 * qi + 1], z = q[3 * qi + 2];
    tx = row_apply(m, x, y, z);
    ty = row_apply(m + 4, x, y, z);
    tz = row_apply(m + 8, x, y, z);
  }
  float best = INFINITY;
  for (int base = 0; base < np; base += P_TILE) {
    const int cnt = min(P_TILE, np - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      const float* pp = p + 3LL * (base + i);
      tile[i] = make_float4(pp[0], pp[1], pp[2], 0.f);
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) {
        const float4 v = tile[j];
        const float dx = __fsub_rn(tx, v.x);
        const float dy = __fsub_rn(ty, v.y);
        const float dz = __fsub_rn(tz, v.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        best = fminf(best, d2);
      }
    }
  }
  if (live) out[g] = best;
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
// Numerics. Transform and d2 exactly as lcp_min_d2_kernel (__f*_rn, no
// FMA), so the result is bit-identical to
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
  if (p1 > p0 && isfinite(t[0]) && isfinite(t[1]) && isfinite(t[2])) {
    const float side = grid[3];
    const float tmax = fmaxf(fmaxf(fabsf(t[0]), fabsf(t[1])),
                             fmaxf(fabsf(t[2]), eps));
    const float e = __fadd_rn(__fmul_rn(eps, 1.f + 0x1p-20f),
                              __fmul_rn(0x1p-20f, tmax));
    int lo[3], hi[3];
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
    if (!empty) {
      const int ny = (int)grid[5], nz = (int)grid[6];
      const float tx = t[0], ty = t[1], tz = t[2];
      int from = p0;  // keys grow with (ix, iy): later columns start later
      for (int ix = lo[0]; ix <= hi[0]; ++ix) {
        for (int iy = lo[1]; iy <= hi[1]; ++iy) {
          const int col = (ix * ny + iy) * nz;
          const int kend = col + hi[2];
          int j = lower_bound(keys, from, p1, col + lo[2]);
          for (; j < p1 && __ldg(keys + j) <= kend; ++j) {
            const float4 v = __ldg(pts + j);
            const float dx = __fsub_rn(tx, v.x);
            const float dy = __fsub_rn(ty, v.y);
            const float dz = __fsub_rn(tz, v.z);
            const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                 __fmul_rn(dy, dy)),
                                       __fmul_rn(dz, dz));
            best = fminf(best, d2);
          }
          from = j;
        }
      }
    }
  }
  out[g] = best <= eps2 ? best : INFINITY;
}

}  // namespace

// transforms: (c, 4, 4) f32, q: (nq, 3) f32, p: (np, 3) f32, out: (c, nq)
// f32; all contiguous on the device of `stream`. Returns cudaGetLastError.
extern "C" int lcp_min_d2(const void* transforms, const void* q,
                          const void* p, void* out, int c, int nq, int np,
                          void* stream) {
  const long long total = (long long)c * nq;
  if (total == 0) return 0;
  const long long blocks = (total + THREADS - 1) / THREADS;
  lcp_min_d2_kernel<<<(unsigned)blocks, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const float*)transforms, (const float*)q, (const float*)p,
      (float*)out, total, nq, np);
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
