// K1: LCP min squared distance, out[c, q] = min_p |R_c q + t_c - p|^2.
//
// Replaces the TPU kernel super4pcs_tpu/kernels/lcp_pallas.py::
// _lcp_min_kernel (K1, launched by candidate_min_sq_dists), and with it
// the streamed-P _lcp_min_stream_kernel (K3) and, through one identity
// transform (kernels/lcp.py::min_sq_dists), the untransformed
// _min_dist_kernel and _min_dist_stream_kernel (K4a, K4b). It is the
// verify step of every registration: the initial identity verify, the
// coarse, mid and exact stages of lcp_scores_two_stage, and the
// re-verify after each refine.
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
