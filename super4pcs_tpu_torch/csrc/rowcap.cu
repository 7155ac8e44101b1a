// K2: row-capped band capture of one base edge, with the pair filters
// and tile-pair rejection, over a trial axis: T captures in one launch.
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
// Trial axis. The TPU ran one capture per base edge and vmapped it over
// a step's bases (and, in batched registration, over the pairs), which
// adds a grid axis to the pallas_call. Here blockIdx.z is the trial t of
// T = G x B captures (G point sets, B trials each): trial t reads the
// points, normals and tile bounds of its set g = t / B, its own band,
// invariant and filter planes, and writes its own (n_pad, row_cap)
// slice of cols and h and (n_pad,) slice of rc. Each trial's slice is
// the single capture's output bit for bit, and a call is one prep launch
// and one capture launch whatever T is.
//
// Design. Lanes own columns and rows are broadcast. A prep kernel runs
// first, once per call: it fills cols and h with their empty-slot
// sentinels (coalesced, so the capture writes only its hits) and writes
// the padded column planes, (x, y, z, |c|^2) as float4 and, with
// normals, (nx, ny, nz, |n|^2), once per point set, and with the other
// filters (pos . seg, column score, row score, 0), once per trial. A
// block of 8 warps covers 64 rows (8 per warp) of one 256-row tile and
// one 512-column segment of one trial, 2048 blocks per trial at
// n = 8192. Tile-pair
// rejection is block-uniform at the TPU's granularity (256-row tile x
// 512-column segment): a block first reads its row tile's and its
// segment's bounding spheres, and when the two cannot meet the band
// annulus it exits, its slots left empty. Otherwise it stages the
// segment's planes in shared memory with cp.async while it loads its
// rows. Each warp holds its 8 rows in registers and walks the segment in
// 32-column chunks: a lane reads its column once per chunk (one shared
// load feeds 8 band tests) and tests it against the 8 rows, free of
// branches so that the rows' chains interleave. Per row, __ballot_sync
// over the band predicate (then the filters' pass bits) gives the hits
// of the chunk, and __popc(mask & lanemask_lt) each hit's rank in column
// order; added to the row's running count (a warp-uniform register), it
// is the hit's slot, written while below seg_q. This gives the (n_pad,
// row_cap) slot-major layout directly (the TPU kernel needed an XLA
// transpose for it). The filters are template parameters (one
// instantiation per combination) and run only on pairs inside the band:
// a warp compacts its chunk's in-band (row, column) pairs into a list in
// shared memory, so that each lane evaluates one pair of the list (a
// 32-column chunk holds only a few in-band columns per row), and each
// passing pair sets its bit in its row's mask, which then gives the
// ranks. Each row's count in the segment is added into rc[row] with one
// integer atomicAdd, so rc must be zeroed by the caller. The rejection
// test is the TPU kernel's, with its conservative slack, so
// the output is the same with rejection on or off.
//
// Bound. Per edge and trial, n_pad^2 band tests of about 10 fp32 operations (dot,
// d2, two compares) on the CUDA cores, minus the rejected tile pairs.
// An in-band pair adds 19 operations for the normal band (a second dot,
// two square roots), 2 for the scores and 5 for the angle (one square
// root): with every filter on, an in-band pair costs about 3.6 band
// tests, and pairs in band are a few percent of all pairs, so the
// filters add little work to a launch. Output per edge is
// n_pad * row_cap * 4 bytes for cols (and again for h on edge 0), plus
// n_pad * 4 for rc. At the headline's shapes (n = 8192) the operations
// take ~7 us at the card's fp32 peak and the output ~3 us at its memory
// rate. A band test issues about 15 warp instructions per 32 pairs
// (8 fp32, the compares, the ballot and its branch), so the issue rate
// (132 SMs x 4 warp instructions a cycle) bounds the launch at ~30 us
// with nothing rejected.
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

constexpr int ROW_TILE = 256;   // rows of a rejection tile
constexpr int COL_TILE = 512;   // columns of a segment
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int R = 8;            // rows per warp
constexpr int BLOCK_ROWS = WARPS * R;
constexpr int CHUNKS = COL_TILE / 32;
constexpr int SENT = 0x7fffffff;
constexpr float PAD = 1.0e18f;
constexpr unsigned FULL = 0xffffffffu;

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

// d2 of a row point a and a column point b, (|a|^2 + |b|^2) - 2 a.b
__device__ __forceinline__ float pair_d2(const float4& a, const float4& b) {
  return __fsub_rn(__fadd_rn(a.w, b.w),
                   __fmul_rn(2.f, dot3(a.x, a.y, a.z, b.x, b.y, b.z)));
}

__device__ __forceinline__ bool in_band(const float4& a, const float4& b,
                                        float lo2, float hi2) {
  const float d2 = pair_d2(a, b);
  return d2 >= lo2 && d2 <= hi2;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Launch arguments (null pointers for what is off). Per set: q,
// normals, rowb, colb, pts, nrm; per trial: geo, aux, rcscore, ext,
// cols, rc, h.
struct Args {
  const float* q;        // (G, n, 3)
  int n, n_pad, seg_q, row_cap, emit_hash, use_angle, use_reject;
  int per_set;           // B: trials per point set (trial t -> set t / B)
  int geo_stride;        // floats of geo per trial (4, or 7 with filters)
  const float* geo;      // (T, geo_stride) [lo2, hi2, inv, cell, nang,
                         // nthr, cmax]
  const float* normals;  // (G, n, 3)
  const float* aux;      // (T, 2, n): pos . seg, |n|^2
  const float* rcscore;  // (T, 2, n): row score, column score
  const float* rowb;     // (G, n_pad / 256, 4) bounding spheres
  const float* colb;     // (G, n_pad / 512, 4)
  float4* pts;           // (G, n_pad) x, y, z, |c|^2 (prep output)
  float4* nrm;           // (G, n_pad) nx, ny, nz, |n|^2, with normals
  float4* ext;           // (T, n_pad) pos . seg, column score, row
                         // score, 0
  int* cols;             // (T, n_pad, row_cap)
  int* rc;               // (T, n_pad), zeroed
  int* h;                // (T, n_pad, row_cap) with emit_hash
};

// Once per call, grid (n_pad / 256, T): block (x, t) writes the empty
// slots of rows [256 x, 256 x + 256) of trial t (-1 in cols, SENT in h,
// coalesced as int4, so the capture kernel writes only its hits) and the
// padded planes of those columns: trial t's filter plane, and, for the
// first trial of each set, the set's points and normals. A padded point
// (j >= n) sits at (1e18, 0, 0) with zero filter planes, as in the plain
// version.
__global__ void __launch_bounds__(256) rowcap_prep_kernel(const Args a) {
  const int t = blockIdx.y;
  const int g = t / a.per_set;
  const int row0 = blockIdx.x * 256;
  const long long first4 =
      ((long long)t * a.n_pad + row0) * a.row_cap / 4;
  const int slots4 = 64 * a.row_cap;  // 256 rows, row_cap % 4 == 0
  for (int i = threadIdx.x; i < slots4; i += 256) {
    reinterpret_cast<int4*>(a.cols)[first4 + i] = make_int4(-1, -1, -1, -1);
    if (a.emit_hash)
      reinterpret_cast<int4*>(a.h)[first4 + i] =
          make_int4(SENT, SENT, SENT, SENT);
  }
  const int j = row0 + threadIdx.x;
  const bool real = j < a.n;
  const long long pj = (long long)g * a.n_pad + j;  // set plane index
  const long long qj = (long long)g * a.n + j;      // set point index
  const float* aux = a.aux ? a.aux + 2LL * t * a.n : nullptr;
  if (t % a.per_set == 0) {
    float x = PAD, y = 0.f, z = 0.f;
    if (real) {
      x = a.q[3 * qj];
      y = a.q[3 * qj + 1];
      z = a.q[3 * qj + 2];
    }
    a.pts[pj] = make_float4(x, y, z, sq3(x, y, z));
    if (a.nrm) {
      a.nrm[pj] = real ? make_float4(a.normals[3 * qj],
                                     a.normals[3 * qj + 1],
                                     a.normals[3 * qj + 2], aux[a.n + j])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (a.ext) {
    const float* sc = a.rcscore ? a.rcscore + 2LL * t * a.n : nullptr;
    const bool ang = real && a.use_angle;
    const bool has = real && sc;
    a.ext[(long long)t * a.n_pad + j] =
        make_float4(ang ? aux[j] : 0.f, has ? sc[a.n + j] : 0.f,
                    has ? sc[j] : 0.f, 0.f);
  }
}

template <bool kNormals, bool kRowcol, bool kAngle>
__global__ void __launch_bounds__(THREADS)
rowcap_capture_kernel(const Args a) {
  constexpr bool kExt = kRowcol || kAngle;
  constexpr bool kFilters = kNormals || kExt;
  __shared__ float4 seg_pts[COL_TILE];
  __shared__ float4 seg_nrm[kNormals ? COL_TILE : 1];
  __shared__ float2 seg_ext[kExt ? COL_TILE : 1];  // pos . seg, score
  __shared__ float4 row_nrm[kNormals ? BLOCK_ROWS : 1];
  __shared__ float4 row_ext[kExt ? BLOCK_ROWS : 1];
  __shared__ float4 row_pts[kAngle ? BLOCK_ROWS : 1];
  __shared__ unsigned short pairs_s[kFilters ? WARPS : 1][R * 32];
  __shared__ unsigned pass_s[kFilters ? WARPS : 1][R];

  const int n = a.n, n_pad = a.n_pad, seg_q = a.seg_q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const int block_row0 = blockIdx.x * BLOCK_ROWS;
  const int row0 = block_row0 + warp * R;
  const int s = blockIdx.y;
  const int t = blockIdx.z;          // trial
  const int g = t / a.per_set;       // its point set
  const float4* pts = a.pts + (long long)g * n_pad;
  const float4* nrm = kNormals ? a.nrm + (long long)g * n_pad : nullptr;
  const float4* ext = kExt ? a.ext + (long long)t * n_pad : nullptr;
  const float* geo = a.geo + t * a.geo_stride;
  int* cols = a.cols + (long long)t * n_pad * a.row_cap;
  int* hout = a.emit_hash ? a.h + (long long)t * n_pad * a.row_cap
                          : nullptr;
  const int live_rows = n - row0;  // rows r < live_rows are real
  const float lo2 = geo[0], hi2 = geo[1];
  // a rejected tile pair is neither staged nor tested: its slots stay
  // empty and it adds nothing to rc (block-uniform)
  if (a.use_reject &&
      tile_rejected(a.rowb + 4 * ((long long)g * (n_pad / ROW_TILE) +
                                  block_row0 / ROW_TILE),
                    a.colb + 4 * ((long long)g * (n_pad / COL_TILE) + s),
                    lo2, hi2))
    return;
  const int c0 = s * COL_TILE;
  for (int k = threadIdx.x; k < COL_TILE; k += THREADS) {
    cp_async16(&seg_pts[k], pts + c0 + k);
    if (kNormals) cp_async16(&seg_nrm[k], nrm + c0 + k);
    if (kExt) cp_async8(&seg_ext[k], ext + c0 + k);
  }
  cp_async_commit();
  if (kFilters) {
    for (int k = threadIdx.x; k < BLOCK_ROWS; k += THREADS) {
      if (kNormals) row_nrm[k] = nrm[block_row0 + k];
      if (kExt) row_ext[k] = ext[block_row0 + k];
      if (kAngle) row_pts[k] = pts[block_row0 + k];
    }
  }
  float4 rows[R];
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rows[r] = pts[row0 + r];
    cnt[r] = 0;
  }
  const float inv = geo[2], cell = geo[3];
  const float nang = kNormals ? geo[4] : 0.f;
  const float nthr = kNormals ? geo[5] : 0.f;
  const float cmax = kAngle ? geo[6] : 0.f;
  const long long slot0 = (long long)s * seg_q;
  cp_async_wait_all();
  __syncthreads();
  for (int ch = 0; ch < CHUNKS; ++ch) {
    const int k = ch * 32 + lane;
    const int j = c0 + k;
    const float4 b = seg_pts[k];
    const bool col_real = j < n;
    // the band test of the 8 rows, free of branches so that the
    // rows' chains interleave; the hits are handled after
    unsigned band[R];
    unsigned any = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      band[r] = __ballot_sync(FULL, in_band(rows[r], b, lo2, hi2) &&
                                        col_real && j != row0 + r &&
                                        r < live_rows);
      any |= band[r];
    }
    if (!any) continue;  // warp-uniform
    unsigned hit[R];
    if (kFilters) {
      // the filters of the chunk's in-band pairs, compacted into a
      // list of (row, lane) entries so that every lane evaluates
      // one; each passing pair sets its bit in pass[row]
      unsigned short* list = pairs_s[warp];
      unsigned* pass = pass_s[warp];
      int total = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((band[r] >> lane) & 1u)
          list[total + __popc(band[r] & lanemask_lt)] =
              (unsigned short)((r << 5) | lane);
        total += __popc(band[r]);
      }
      if (lane < R) pass[lane] = 0u;
      __syncwarp();
      for (int e = lane; e - lane < total; e += 32) {
        if (e >= total) continue;
        const int v = list[e];
        const int r = v >> 5, l = v & 31;
        const int wr = warp * R + r, kk = ch * 32 + l;
        bool ok = true;
        if (kNormals) {
          const float4 rn = row_nrm[wr];
          const float4 m = seg_nrm[kk];
          if (rn.w > 0.f && m.w > 0.f) {
            const float ssum = __fadd_rn(rn.w, m.w);
            const float two = __fmul_rn(
                2.f, dot3(rn.x, rn.y, rn.z, m.x, m.y, m.z));
            const float dminus =
                __fsqrt_rn(fmaxf(__fsub_rn(ssum, two), 0.f));
            const float dplus =
                __fsqrt_rn(fmaxf(__fadd_rn(ssum, two), 0.f));
            const float nd = fminf(fabsf(__fsub_rn(dminus, nang)),
                                   fabsf(__fsub_rn(dplus, nang)));
            ok = nd <= nthr;
          }
        }
        if (kRowcol && ok)
          ok = __fadd_rn(row_ext[wr].z, seg_ext[kk].y) >= 2.f;
        if (kAngle && ok) {
          const float d2 = pair_d2(row_pts[wr], seg_pts[kk]);
          ok = __fsub_rn(seg_ext[kk].x, row_ext[wr].x) >=
               __fmul_rn(cmax, __fsqrt_rn(fmaxf(d2, 0.f)));
        }
        if (ok) atomicOr(&pass[r], 1u << l);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) hit[r] = pass[r];
      __syncwarp();  // the next chunk rewrites the list and bits
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) hit[r] = band[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const unsigned mask = hit[r];
      if (!mask) continue;  // warp-uniform
      if ((mask >> lane) & 1u) {
        const int slot = cnt[r] + __popc(mask & lanemask_lt);
        if (slot < seg_q) {
          const long long at =
              (long long)(row0 + r) * a.row_cap + slot0 + slot;
          cols[at] = j;
          if (hout) {
            const float4 ra = rows[r];
            const uint32_t hv =
                (cell_of(ra.x, b.x, inv, cell) * 73856093u) ^
                (cell_of(ra.y, b.y, inv, cell) * 19349669u) ^
                (cell_of(ra.z, b.z, inv, cell) * 83492791u);
            hout[at] = (int)hv;
          }
        }
      }
      cnt[r] += __popc(mask);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (cnt[r]) atomicAdd(a.rc + (long long)t * n_pad + row0 + r, cnt[r]);
  }
}

template <bool kNormals, bool kRowcol, bool kAngle>
void launch(dim3 grid, cudaStream_t stream, const Args& a) {
  rowcap_capture_kernel<kNormals, kRowcol, kAngle>
      <<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace

// T = trials captures over G point sets, trials = G * per_set; trial t
// belongs to set t / per_set. q: (G, n, 3) f32; geo: (T, geo_stride) f32
// on the device, per trial [lo2, hi2, inv, cell] and, with any filter
// (geo_stride 7), [nang, nthr, cmax] after them; cols: (T, n_pad,
// row_cap) i32; rc: (T, n_pad) i32, zeroed; h: (T, n_pad, row_cap) i32
// when emit_hash, else unused (may be null). Filters (null when off):
// normals (G, n, 3) f32 for use_normals; aux (T, 2, n) f32, row 0
// pos . seg (use_angle), row 1 |n|^2 (use_normals); rcscore (T, 2, n)
// f32 for use_rowcol. rowb (G, n_pad / 256, 4) and colb (G, n_pad / 512,
// 4) f32 bounding spheres [cx, cy, cz, r] for use_reject. work: 16-byte
// aligned scratch of float4 planes: G * n_pad for the points, G * n_pad
// more with use_normals and T * n_pad more with use_rowcol or use_angle
// (kernels/rowcap.py::rowcap_capture). n_pad is a multiple of 2048 and
// row_cap = (n_pad / 512) * seg_q. One prep launch and one capture launch.
// Returns cudaGetLastError.
extern "C" int rowcap_capture(const void* q, int n, int n_pad, int trials,
                              int per_set, const void* geo, int geo_stride,
                              int seg_q, int row_cap, int emit_hash,
                              const void* normals, const void* aux,
                              const void* rcscore, int use_normals,
                              int use_rowcol, int use_angle,
                              const void* rowb, const void* colb,
                              int use_reject, void* work, void* cols,
                              void* rc, void* h, void* stream) {
  if (n_pad == 0 || trials == 0) return 0;
  const int row_blocks = n_pad / BLOCK_ROWS;
  const int segs = n_pad / COL_TILE;
  const long long sets = trials / per_set;
  const bool ext = use_rowcol || use_angle;
  Args a;
  a.q = (const float*)q;
  a.n = n;
  a.n_pad = n_pad;
  a.seg_q = seg_q;
  a.row_cap = row_cap;
  a.emit_hash = emit_hash;
  a.use_angle = use_angle;
  a.use_reject = use_reject;
  a.per_set = per_set;
  a.geo_stride = geo_stride;
  a.geo = (const float*)geo;
  a.normals = (const float*)normals;
  a.aux = (const float*)aux;
  a.rcscore = use_rowcol ? (const float*)rcscore : nullptr;
  a.rowb = (const float*)rowb;
  a.colb = (const float*)colb;
  a.pts = (float4*)work;
  a.nrm = use_normals ? a.pts + sets * n_pad : nullptr;
  a.ext = ext ? a.pts + sets * n_pad * (use_normals ? 2 : 1) : nullptr;
  a.cols = (int*)cols;
  a.rc = (int*)rc;
  a.h = (int*)h;
  const cudaStream_t st = (cudaStream_t)stream;
  // before the capture, on the same stream
  rowcap_prep_kernel<<<dim3(n_pad / 256, trials), 256, 0, st>>>(a);
  const dim3 grid(row_blocks, segs, trials);
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
