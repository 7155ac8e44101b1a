// K2: row-capped band capture of one base edge, with the pair filters
// and tile-pair rejection.
//
// Replaces the TPU kernel super4pcs_tpu/kernels/rowcap_pallas.py::
// _kernel + _kernel_body (launched by _capture_edge), all of it: the
// band capture (K2), tile-pair rejection (K2c, the use_reject branch
// with _tile_bounds) and the in-kernel pair filters (K2d, the
// use_normals / use_rowcol / use_angle branches). For every ordered
// pair (i, j) of the n (padded to n_pad) Q samples it evaluates the
// distance band lo2 <= d2 <= hi2 with i != j and both points real, then
// the active filters, counts the hits of each row exactly (rc), and
// captures the first seg_q hits of each row in every 512-column segment,
// in column order, into slot seg * seg_q + k of cols[row] (-1 marks an
// empty slot). With emit_hash, slot k of h[row] gets the congruent
// join's spatial hash of the pair's invariant point a + inv * (b - a)
// (0x7fffffff when empty).
//
// Design. Grid (n_pad / 256 row tiles, n_pad / 512 column segments);
// one thread owns one row. The segment's 512 columns are staged in
// shared memory: (x, y, z, |c|^2) as float4, and with filters
// (nx, ny, nz, |n|^2) as float4 and (pos . seg, column score) as float2
// (512 x 40 B = 20 KB). Every thread reads the same column per step (a
// broadcast). The thread walks the columns in order and writes its hits
// straight into its own slots, which gives the (n_pad, row_cap)
// slot-major layout directly (the TPU kernel needed an XLA transpose
// for it). Segment counts are added into rc[row] with an integer
// atomicAdd, so rc must be zeroed by the caller. The filters are
// template parameters (one instantiation per combination); each is
// evaluated only for a pair inside the band, as the band already
// decides most pairs. Tile-pair rejection is block-uniform and comes
// first: the block reads its row tile's and its segment's bounding
// spheres, and when the two cannot meet the band annulus it writes its
// empty slots and returns before staging anything. The test is the TPU
// kernel's, with its conservative slack, so the output is the same
// with rejection on or off.
//
// Bound. Per edge, n_pad^2 band tests of about 10 fp32 operations (dot,
// d2, two compares) on the CUDA cores, minus the rejected tile pairs.
// An in-band pair adds 19 operations for the normal band (a second dot,
// two square roots), 2 for the scores and 5 for the angle (one square
// root): with every filter on, an in-band pair costs about 3.6 band
// tests, and pairs in band are a few percent of all pairs, so the
// filters add little work to a launch. Output per edge is
// n_pad * row_cap * 4 bytes for cols (and again for h on edge 0), plus
// n_pad * 4 for rc. At the headline's shapes (n = 8192) the operations
// take ~7 us at the card's fp32 peak and the output ~3 us at its memory
// rate, against ~0.09 ms measured (H100, chip_smoke.py phase 4): the
// kernel is bound by neither but by latency, each thread walking its
// 512 columns serially in a grid of only 512 blocks. Rejection skips on
// average 19.5% of the tile pairs at nq = 8192 and 50.4% at nq = 32768
// (64 bases x 2 edges of the headline's kd-ordered Q, phase 4a).
//
// Numerics. d2 = (r2 + c2) - 2 * dot with dot = (ax bx + ay by) + az bz,
// the squares summed in the same order; the invariant point is
// a + inv * (b - a) per coordinate, its cell floor(e / cell) with IEEE
// division. The filters: ndot = (nx_i nx_j + ny_i ny_j) + nz_i nz_j,
// dminus/dplus = sqrt(max((n2_i + n2_j) -/+ 2 ndot, 0)), the pair
// passes the normal band when not both |n|^2 > 0 or min(|dminus - a|,
// |dplus - a|) <= thr; the scores pass when rs_i + cs_j >= 2; the angle
// when (bseg_j - aseg_i) >= cmax * sqrt(max(d2, 0)). Every operation is
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn (no FMA
// contraction, built with -fmad=false too), so cols, rc and h are
// bit-identical to the plain PyTorch version
// (kernels/rowcap.py::rowcap_capture_plain). The rejection test need not
// match the TPU's to the bit: its slack makes it conservative. The hash
// multiplies as uint32 (signed overflow is undefined in C++), which is
// the int32 two's-complement wrap of the JAX and PyTorch versions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_TILE = 256;
constexpr int COL_TILE = 512;
constexpr int SENT = 0x7fffffff;
constexpr float PAD = 1.0e18f;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__device__ __forceinline__ uint32_t cell_of(float a, float b, float inv,
                                            float cell) {
  const float e = __fadd_rn(a, __fmul_rn(inv, __fsub_rn(b, a)));
  return (uint32_t)(int)floorf(__fdiv_rn(e, cell));
}

// Whether the row tile (sphere rb) and the column segment (sphere cb)
// cannot hold a pair in the band: the TPU kernel's predicate
// (rowcap_pallas.py:169-180), slack included.
__device__ __forceinline__ bool tile_rejected(const float* rb,
                                              const float* cb, float lo2,
                                              float hi2) {
  const float dx = __fsub_rn(rb[0], cb[0]);
  const float dy = __fsub_rn(rb[1], cb[1]);
  const float dz = __fsub_rn(rb[2], cb[2]);
  const float dc = __fsqrt_rn(sq3(dx, dy, dz));
  const float rsum = __fadd_rn(rb[3], cb[3]);
  const float lo = __fsqrt_rn(fmaxf(lo2, 0.f));
  const float hi = __fsqrt_rn(hi2);
  const float slack =
      __fadd_rn(__fmul_rn(1.0e-5f, __fadd_rn(hi, dc)), 1.0e-12f);
  return __fsub_rn(dc, rsum) > __fadd_rn(hi, slack) ||
         __fadd_rn(dc, rsum) < __fsub_rn(lo, slack);
}

// Launch arguments (null pointers for what is off).
struct Args {
  const float* q;        // (n, 3)
  int n, seg_q, row_cap, emit_hash, use_reject;
  const float* geo;      // [lo2, hi2, inv, cell, nang, nthr, cmax]
  const float* normals;  // (n, 3)
  const float* aux;      // (2, n): pos . seg, |n|^2
  const float* rcscore;  // (2, n): row score, column score
  const float* rowb;     // (n_pad / 256, 4) bounding spheres
  const float* colb;     // (n_pad / 512, 4)
  int* cols;             // (n_pad, row_cap)
  int* rc;               // (n_pad,), zeroed
  int* h;                // (n_pad, row_cap) with emit_hash
};

template <bool kNormals, bool kRowcol, bool kAngle>
__global__ void __launch_bounds__(ROW_TILE)
rowcap_capture_kernel(const Args a) {
  const float* __restrict__ q = a.q;
  const int n = a.n, seg_q = a.seg_q;
  constexpr bool kAux = kRowcol || kAngle;
  __shared__ float4 seg_pts[COL_TILE];
  __shared__ float4 seg_nrm[kNormals ? COL_TILE : 1];
  __shared__ float2 seg_aux[kAux ? COL_TILE : 1];
  const int seg = blockIdx.y;
  const int c0 = seg * COL_TILE;
  const int row = blockIdx.x * ROW_TILE + threadIdx.x;
  int* crow = a.cols + (long long)row * a.row_cap + seg * seg_q;
  int* hrow = a.h + (long long)row * a.row_cap + seg * seg_q;
  const float lo2 = a.geo[0], hi2 = a.geo[1];

  int found = 0;
  // block-uniform: every thread of the block takes the same branch
  if (!(a.use_reject && tile_rejected(a.rowb + 4 * blockIdx.x,
                                      a.colb + 4 * blockIdx.y, lo2,
                                      hi2))) {
    for (int k = threadIdx.x; k < COL_TILE; k += ROW_TILE) {
      const int j = c0 + k;
      const bool real = j < n;
      float x = PAD, y = 0.f, z = 0.f;
      if (real) {
        x = q[3LL * j];
        y = q[3LL * j + 1];
        z = q[3LL * j + 2];
      }
      seg_pts[k] = make_float4(x, y, z, sq3(x, y, z));
      if (kNormals) {
        seg_nrm[k] = real ? make_float4(a.normals[3LL * j],
                                        a.normals[3LL * j + 1],
                                        a.normals[3LL * j + 2],
                                        a.aux[n + j])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (kAux) {
        seg_aux[k] = make_float2(kAngle && real ? a.aux[j] : 0.f,
                                 kRowcol && real ? a.rcscore[n + j] : 0.f);
      }
    }
    __syncthreads();

    if (row < n) {
      const float inv = a.geo[2], cell = a.geo[3];
      const float nang = kNormals ? a.geo[4] : 0.f;
      const float nthr = kNormals ? a.geo[5] : 0.f;
      const float cmax = kAngle ? a.geo[6] : 0.f;
      const float ax = q[3LL * row], ay = q[3LL * row + 1],
                  az = q[3LL * row + 2];
      const float r2 = sq3(ax, ay, az);
      float nx = 0.f, ny = 0.f, nz = 0.f, n2 = 0.f, rs = 0.f, aseg = 0.f;
      if (kNormals) {
        nx = a.normals[3LL * row];
        ny = a.normals[3LL * row + 1];
        nz = a.normals[3LL * row + 2];
        n2 = a.aux[n + row];
      }
      if (kRowcol) rs = a.rcscore[row];
      if (kAngle) aseg = a.aux[row];
      for (int k = 0; k < COL_TILE; ++k) {
        const float4 b = seg_pts[k];
        const float d2 = __fsub_rn(__fadd_rn(r2, b.w),
                                   __fmul_rn(2.f, dot3(ax, ay, az, b.x,
                                                       b.y, b.z)));
        const int j = c0 + k;
        if (!(d2 >= lo2 && d2 <= hi2 && j != row && j < n)) continue;
        if (kNormals) {
          const float4 m = seg_nrm[k];
          if (n2 > 0.f && m.w > 0.f) {
            const float ssum = __fadd_rn(n2, m.w);
            const float two = __fmul_rn(2.f, dot3(nx, ny, nz, m.x, m.y,
                                                  m.z));
            const float dminus = __fsqrt_rn(fmaxf(__fsub_rn(ssum, two),
                                                  0.f));
            const float dplus = __fsqrt_rn(fmaxf(__fadd_rn(ssum, two),
                                                 0.f));
            const float nd = fminf(fabsf(__fsub_rn(dminus, nang)),
                                   fabsf(__fsub_rn(dplus, nang)));
            if (!(nd <= nthr)) continue;
          }
        }
        if (kRowcol && !(__fadd_rn(rs, seg_aux[k].y) >= 2.f)) continue;
        if (kAngle &&
            !(__fsub_rn(seg_aux[k].x, aseg) >=
              __fmul_rn(cmax, __fsqrt_rn(fmaxf(d2, 0.f)))))
          continue;
        if (found < seg_q) {
          crow[found] = j;
          if (a.emit_hash) {
            const uint32_t hv =
                (cell_of(ax, b.x, inv, cell) * 73856093u) ^
                (cell_of(ay, b.y, inv, cell) * 19349669u) ^
                (cell_of(az, b.z, inv, cell) * 83492791u);
            hrow[found] = (int)hv;
          }
        }
        ++found;
      }
      if (found) atomicAdd(a.rc + row, found);
    }
  }
  for (int k = found; k < seg_q; ++k) {
    crow[k] = -1;
    if (a.emit_hash) hrow[k] = SENT;
  }
}

template <bool kNormals, bool kRowcol, bool kAngle>
void launch(dim3 grid, cudaStream_t stream, const Args& a) {
  rowcap_capture_kernel<kNormals, kRowcol, kAngle>
      <<<grid, ROW_TILE, 0, stream>>>(a);
}

}  // namespace

// q: (n, 3) f32; geo: f32 on the device, [lo2, hi2, inv, cell] and, with
// any filter, [nang, nthr, cmax] after them; cols: (n_pad, row_cap) i32;
// rc: (n_pad,) i32, zeroed; h: (n_pad, row_cap) i32 when emit_hash, else
// unused (may be null). Filters (null when off): normals (n, 3) f32 for
// use_normals; aux (2, n) f32, row 0 pos . seg (use_angle), row 1 |n|^2
// (use_normals); rcscore (2, n) f32 for use_rowcol. rowb (n_pad / 256,
// 4) and colb (n_pad / 512, 4) f32 bounding spheres [cx, cy, cz, r] for
// use_reject. n_pad is a multiple of 2048 and row_cap = (n_pad / 512) *
// seg_q. Returns cudaGetLastError.
extern "C" int rowcap_capture(const void* q, int n, int n_pad,
                              const void* geo, int seg_q, int row_cap,
                              int emit_hash, const void* normals,
                              const void* aux, const void* rcscore,
                              int use_normals, int use_rowcol,
                              int use_angle, const void* rowb,
                              const void* colb, int use_reject, void* cols,
                              void* rc, void* h, void* stream) {
  if (n_pad == 0) return 0;
  const dim3 grid(n_pad / ROW_TILE, n_pad / COL_TILE);
  Args a;
  a.q = (const float*)q;
  a.n = n;
  a.seg_q = seg_q;
  a.row_cap = row_cap;
  a.emit_hash = emit_hash;
  a.use_reject = use_reject;
  a.geo = (const float*)geo;
  a.normals = (const float*)normals;
  a.aux = (const float*)aux;
  a.rcscore = (const float*)rcscore;
  a.rowb = (const float*)rowb;
  a.colb = (const float*)colb;
  a.cols = (int*)cols;
  a.rc = (int*)rc;
  a.h = (int*)h;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((use_normals ? 1 : 0) | (use_rowcol ? 2 : 0) |
          (use_angle ? 4 : 0)) {
    case 0: launch<false, false, false>(grid, st, a); break;
    case 1: launch<true, false, false>(grid, st, a); break;
    case 2: launch<false, true, false>(grid, st, a); break;
    case 3: launch<true, true, false>(grid, st, a); break;
    case 4: launch<false, false, true>(grid, st, a); break;
    case 5: launch<true, false, true>(grid, st, a); break;
    case 6: launch<false, true, true>(grid, st, a); break;
    default: launch<true, true, true>(grid, st, a); break;
  }
  return (int)cudaGetLastError();
}
