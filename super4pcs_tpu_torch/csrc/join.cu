// KJ: the congruent join's grid search over K2's table hash, for T trials
// in one call, with no sort.
//
// Replaces no TPU kernel: the JAX package's grid join
// (super4pcs_tpu/ops/congruent.py::find_congruent_quads_grid) is XLA ops,
// a sort of each table by cell and a bounded binary search per probe. The
// port's plain version (ops/congruent.py::find_congruent_quads_grid)
// sorts every trial's table in one torch.sort on int64 keys and finds
// each probe's cell with torch.searchsorted. That sort was the busiest
// op of a step on the card: cub sorts all 64 key bits of T x K1 items
// (K1 = 1,310,720 slots a trial at nq 8192), sentinel slots included, to
// answer qb w^3 probes a trial of which probe_budget are kept, each
// taking at most L entries of its cell.
//
// What it computes. For each trial t (set g = t / per_set of pos):
// - sel2: the first qb valid slots of the second table (valid2), in slot
//   order, and n2, their number; query q is pair (s / row_cap, cols2[s])
//   of slot s = sel2[q] (slot 0 past n2), its invariant point
//   e2 = a + inv2 (b - a) and its unit direction (b - a) / |b - a|;
// - the w^3 cells around floor((e2 - r) / cell), k fastest (a thread a
//   probe), each hashed as the table is (int64 products, low 32 bits)
//   and taken by its group (the hash with its low bit cleared). A probe
//   of a valid query whose group is not the sentinel's (0x7ffffffe)
//   gets that group's entry in a per-trial open-addressing table (keys,
//   power of two >= 2 qb w^3 entries, linear probing, atomicCAS
//   inserts);
// - one pass over the table hash counts the slots of every probed
//   group (atomicAdd, one a warp for the lanes that hit one group:
//   neighbouring slots of a row often share a cell); an allocation pass
//   gives each non-empty group a bucket in a (T, K1) slot store, a
//   second pass scatters each hit's slot id into its bucket with an
//   atomic cursor, and a warp per group keeps the bucket's L smallest
//   slot ids, in order (a bitonic sort of each 32-slot chunk merged
//   into the running 32 smallest). These are the first L entries of
//   the group in the plain version's stable sort;
// - the probes whose cell is not empty, in probe order, the first
//   probe_budget of them kept (psel); total_cells and the kept cells'
//   counts give dropped;
// - each kept probe p (a thread) and l < min(L, count): the candidate
//   slot, its invariant-point distance test and cone test; the passes
//   compacted in the plain version's order (flat over (L,
//   probe_budget), l-major), the first cap of them written as quads,
//   count their total;
// - dead output slots repeat the plain version's slot 0: the first
//   entry of the first kept probe's cell, or with no kept probe, the
//   slot at sorted position (#slots whose group is below probe 0's),
//   read from a min over the (group, slot) keys the count pass takes
//   (the max of all keys when that position is past the table).
// Every ordered compaction (sel2, psel, the quads) is a count of flags
// per 4096-flag tile (16 a thread, one 16-byte load), a scan of the
// tiles of each trial in one block, and a write pass that scans each
// tile's per-thread counts.
//
// Bound. What the join needs is the table hash and valid2 read once (5
// bytes a slot) and the quads written once: ~0.04 ms at T 16 and nq
// 8192 at 3.35 TB/s. The kernel reads the table hash twice (count and
// scatter) and writes and reads each hit slot id once in its bucket, at
// most 17 bytes a slot (~0.11 ms); the hash-table lookups (L2 reads) and
// the atomics on the groups' counts and cursors bound it in practice.
//
// Numerics. Every float operation is __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn (built with -fmad=false too), in the plain
// version's association: e = a + inv * (b - a), d2 = (dx dx + dy dy) +
// dz dz, cos = ((dx ux + dy uy) + dz uz) / n1, the clamps at 1e-30 with
// torch.clamp's NaN rule. So quads, valid, count, dropped and
// q_subsampled equal the plain version's bit for bit, whatever the
// batch. Bucket offsets come from atomics and differ run to run; the
// outputs do not.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16;                   // flags a thread of a tile
constexpr int TILE = THREADS * CHUNK;       // flags a compaction tile
constexpr int SLOT_ITEMS = 8;               // table slots a thread
constexpr int EMPTY = -1;                   // empty key: odd, never a group
constexpr int TOP_GROUP = 0x7ffffffe;       // the sentinel hash's group
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;

struct Layout {
  // offsets in bytes into the workspace
  long long ff_begin, keys, minkey, ff_end;
  long long zero_begin, maxkey, cells, kept, over, cnt, btotal, zero_end;
  long long offs, cursor, pslot, bucket, qdata, g0, flags_p, flags_v;
  long long tiles2, tiles_p, tiles_v, total2, total_p, total_v;
  long long sel2, psel, oidx, size;
  int hs_log2, ntiles2, ntiles_p, ntiles_v;
};

long long align(long long x) { return (x + 255) & ~255ll; }

Layout layout(int T, long long k2, int qb, int np, int L, int pb, int cap,
              long long k1) {
  Layout y;
  int lg = 1;
  while ((1ll << lg) < 2ll * qb * np) ++lg;
  const long long hs = 1ll << lg;
  const long long npa = (long long)qb * np;
  const long long nv = (long long)L * pb;
  y.hs_log2 = lg;
  y.ntiles2 = (int)((k2 + TILE - 1) / TILE);
  y.ntiles_p = (int)((npa + TILE - 1) / TILE);
  y.ntiles_v = (int)((nv + TILE - 1) / TILE);
  long long o = 0;
  // filled with 0xff bytes
  y.ff_begin = o;
  y.minkey = o; o = align(o + 8ll * T);
  y.keys = o; o = align(o + 4ll * T * hs);
  y.ff_end = o;
  // zeroed
  y.zero_begin = o;
  y.maxkey = o; o = align(o + 8ll * T);
  y.cells = o; o = align(o + 8ll * T);
  y.kept = o; o = align(o + 8ll * T);
  y.over = o; o = align(o + 8ll * T);
  y.btotal = o; o = align(o + 4ll * T);
  y.cnt = o; o = align(o + 4ll * T * hs);
  y.zero_end = o;
  // written before read
  y.offs = o; o = align(o + 4ll * T * hs);
  y.cursor = o; o = align(o + 4ll * T * hs);
  y.pslot = o; o = align(o + 4ll * T * npa);
  y.bucket = o; o = align(o + 4ll * T * k1);
  y.qdata = o; o = align(o + 32ll * T * qb);
  y.g0 = o; o = align(o + 4ll * T);
  y.flags_p = o; o = align(o + 1ll * T * npa);
  y.flags_v = o; o = align(o + 1ll * T * nv);
  y.tiles2 = o; o = align(o + 4ll * T * y.ntiles2);
  y.tiles_p = o; o = align(o + 4ll * T * y.ntiles_p);
  y.tiles_v = o; o = align(o + 4ll * T * y.ntiles_v);
  y.total2 = o; o = align(o + 4ll * T);
  y.total_p = o; o = align(o + 4ll * T);
  y.total_v = o; o = align(o + 4ll * T);
  y.sel2 = o; o = align(o + 4ll * T * qb);
  y.psel = o; o = align(o + 4ll * T * pb);
  y.oidx = o; o = align(o + 4ll * T * cap);
  y.size = o;
  return y;
}

struct Args {
  const float* pos;          // (G, n, 3)
  int n, per_set;
  const int* cols1;          // (T, k1)
  const int* h1;             // (T, k1)
  long long k1;
  const int* cols2;          // (T, k2)
  const unsigned char* valid2;  // (T, k2) bool
  long long k2;
  const float* geo;          // (T, 4): inv1, inv2, cos_a, 0
  float r, r2, cell, tol;
  int use_cone, row_cap, L, qb, w, np, pb, cap;
  int hs_log2;
  long long hs, npa, nv;
  int ntiles2, ntiles_p, ntiles_v;
  // workspace
  int* keys;
  unsigned long long* minkey;
  unsigned long long* maxkey;
  unsigned long long* cells;
  unsigned long long* kept;
  unsigned long long* over;
  int* cnt;
  int* btotal;
  int* offs;
  int* cursor;
  int* pslot;
  int* bucket;
  float4* qdata;             // (T, qb, 2): (ex, ey, ez, ux), (uy, uz, row, col)
  int* g0;
  unsigned char* flags_p;
  unsigned char* flags_v;
  int* tiles2;
  int* tiles_p;
  int* tiles_v;
  int* total2;
  int* total_p;
  int* total_v;
  int* sel2;
  int* psel;
  int* oidx;
  // outputs
  long long* quads;          // (T, cap, 4)
  unsigned char* valid;      // (T, cap) bool
  long long* count;          // (T,)
  long long* dropped;
  long long* qsub;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  // torch.clamp(x, min=lo): NaN stays NaN
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                              __fmul_rn(z, z)));
}

__device__ __forceinline__ unsigned hash_slot(int g, int shift) {
  return ((unsigned)g * 0x9e3779b1u) >> shift;
}

// The join hash of cell (x, y, z): int64 products, low 32 bits (the
// unsigned product has the same low bits as the signed one).
__device__ __forceinline__ int cell_hash(long long x, long long y,
                                         long long z) {
  const unsigned long long h =
      ((unsigned long long)x * 73856093ull) ^
      ((unsigned long long)y * 19349669ull) ^
      ((unsigned long long)z * 83492791ull);
  return (int)(unsigned)h;
}

__device__ __forceinline__ int lookup(const int* keys, int shift,
                                      unsigned mask, int g) {
  unsigned idx = hash_slot(g, shift);
  while (true) {
    const int k = __ldg(keys + idx);
    if (k == g) return (int)idx;
    if (k == EMPTY) return -1;
    idx = (idx + 1) & mask;
  }
}

// Exclusive prefix sum of v over the block, and the block's total; every
// thread of the block must call it.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[WARPS];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    const int s = warp_sums[i];
    before += i < wid ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

__device__ __forceinline__ void warp_add(unsigned long long* dst,
                                         long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  if ((threadIdx.x & 31) == 0 && v != 0)
    atomicAdd(dst, (unsigned long long)v);
}

// --- ordered compaction: tile counts, tile scan, write ---------------

// The flags of one thread's CHUNK bytes of a tile (nonzero bytes are
// set), as a bit mask: one 16-byte load where the row is 16-byte aligned
// and the chunk lies inside it, else byte by byte.
__device__ __forceinline__ unsigned chunk_flags(const unsigned char* f,
                                                long long len,
                                                long long first, bool vec) {
  if (vec && first + CHUNK <= len) {
    const uint4 v = *reinterpret_cast<const uint4*>(f + first);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        bits |= (((w[k] >> (8 * b)) & 0xffu) != 0 ? 1u : 0u) << (4 * k + b);
    return bits;
  }
  unsigned bits = 0;
  for (int k = 0; k < CHUNK; ++k)
    if (first + k < len && f[first + k] != 0) bits |= 1u << k;
  return bits;
}

__global__ void join_count_tiles_kernel(const unsigned char* flags,
                                        long long len, int ntiles,
                                        int* tiles) {
  const int t = blockIdx.y;
  const unsigned char* f = flags + (long long)t * len;
  const bool vec = ((uintptr_t)f & 15) == 0;
  const long long first = (long long)blockIdx.x * TILE + threadIdx.x * CHUNK;
  int all;
  block_scan(__popc(chunk_flags(f, len, first, vec)), &all);
  if (threadIdx.x == 0) tiles[(long long)t * ntiles + blockIdx.x] = all;
}

// In place: each trial's tile counts become their exclusive prefix sums;
// total[t] gets the sum.
__global__ void join_scan_tiles_kernel(int* tiles, int ntiles, int* total) {
  const int t = blockIdx.x;
  int* c = tiles + (long long)t * ntiles;
  int carry = 0;
  for (int b = 0; b < ntiles; b += THREADS) {
    const int i = b + threadIdx.x;
    const int v = i < ntiles ? c[i] : 0;
    int all;
    const int ex = block_scan(v, &all);
    if (i < ntiles) c[i] = carry + ex;
    carry += all;
  }
  if (threadIdx.x == 0) total[t] = carry;
}

// out[t, k] = the k-th flagged position of trial t, for k < cap.
__global__ void join_compact_write_kernel(const unsigned char* flags,
                                          long long len, int ntiles,
                                          const int* tiles, int cap,
                                          int* out) {
  const int t = blockIdx.y;
  const int off = tiles[(long long)t * ntiles + blockIdx.x];
  if (off >= cap) return;
  const unsigned char* f = flags + (long long)t * len;
  const bool vec = ((uintptr_t)f & 15) == 0;
  const long long first = (long long)blockIdx.x * TILE + threadIdx.x * CHUNK;
  unsigned bits = chunk_flags(f, len, first, vec);
  int all;
  int pos = off + block_scan(__popc(bits), &all);
  int* o = out + (long long)t * cap;
  while (bits && pos < cap) {
    const int k = __ffs(bits) - 1;
    bits &= bits - 1;
    o[pos++] = (int)(first + k);
  }
}

// --- the probes ------------------------------------------------------

// A thread a probe (query q, window cell pi); the window's first thread
// also writes the query's invariant point, direction and pair.
__global__ void join_probe_kernel(Args a) {
  const int t = blockIdx.y;
  const long long at = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (at >= a.npa) return;
  const int q = (int)(at / a.np);
  const int pi = (int)(at - (long long)q * a.np);
  const int n2 = a.total2[t];
  const int s = q < n2 ? a.sel2[(long long)t * a.qb + q] : 0;
  const int row = s / a.row_cap;
  const int col = a.cols2[(long long)t * a.k2 + s];
  const float* p = a.pos + (long long)(t / a.per_set) * a.n * 3;
  const float inv2 = a.geo[t * 4 + 1];
  const float ax = p[row * 3], ay = p[row * 3 + 1], az = p[row * 3 + 2];
  const float bx = p[col * 3], by = p[col * 3 + 1], bz = p[col * 3 + 2];
  const float dx = __fsub_rn(bx, ax), dy = __fsub_rn(by, ay),
              dz = __fsub_rn(bz, az);
  const float ex = __fadd_rn(ax, __fmul_rn(inv2, dx));
  const float ey = __fadd_rn(ay, __fmul_rn(inv2, dy));
  const float ez = __fadd_rn(az, __fmul_rn(inv2, dz));
  if (pi == 0) {
    const float nrm = clamp_min(norm3(dx, dy, dz), 1e-30f);
    float4* qd = a.qdata + ((long long)t * a.qb + q) * 2;
    qd[0] = make_float4(ex, ey, ez, __fdiv_rn(dx, nrm));
    qd[1] = make_float4(__fdiv_rn(dy, nrm), __fdiv_rn(dz, nrm),
                        __int_as_float(row), __int_as_float(col));
  }
  const int w = a.w;
  const int i = pi / (w * w), j = (pi / w) % w, k = pi % w;
  const long long cx =
      (long long)floorf(__fdiv_rn(__fsub_rn(ex, a.r), a.cell)) + i;
  const long long cy =
      (long long)floorf(__fdiv_rn(__fsub_rn(ey, a.r), a.cell)) + j;
  const long long cz =
      (long long)floorf(__fdiv_rn(__fsub_rn(ez, a.r), a.cell)) + k;
  const int g = cell_hash(cx, cy, cz) & ~1;
  if (at == 0) a.g0[t] = g;
  int slot = -1;
  if (q < n2 && g != TOP_GROUP) {
    int* keys = a.keys + (long long)t * a.hs;
    const unsigned mask = (unsigned)(a.hs - 1);
    unsigned idx = hash_slot(g, 32 - a.hs_log2);
    while (true) {
      const int prev = atomicCAS(keys + idx, EMPTY, g);
      if (prev == EMPTY || prev == g) break;
      idx = (idx + 1) & mask;
    }
    slot = (int)idx;
  }
  a.pslot[(long long)t * a.npa + at] = slot;
}

// --- the table: count, allocate, scatter, order ----------------------

// The hash-table entry of table slot s of a trial's hash h (-1 when the
// slot is past the table, in the top group or in no probed group).
__device__ __forceinline__ int slot_entry(const Args& a, const int* h,
                                          const int* keys, long long s,
                                          int* group) {
  *group = s < a.k1 ? __ldg(h + s) & ~1 : TOP_GROUP;
  if (*group == TOP_GROUP) return -1;
  return lookup(keys, 32 - a.hs_log2, (unsigned)(a.hs - 1), *group);
}

__global__ void join_count_kernel(Args a) {
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * THREADS * SLOT_ITEMS;
  const int* h = a.h1 + (long long)t * a.k1;
  const int* keys = a.keys + (long long)t * a.hs;
  int* cnt = a.cnt + (long long)t * a.hs;
  const int g0 = a.g0[t];
  unsigned long long mn = NO_KEY, mx = 0;
  for (int it = 0; it < SLOT_ITEMS; ++it) {
    const long long s = base + it * THREADS + threadIdx.x;
    int g;
    const int idx = slot_entry(a, h, keys, s, &g);
    if (s < a.k1) {
      // the sorted order of the plain version: group (as int32), then
      // slot
      const unsigned long long key =
          ((unsigned long long)((unsigned)g ^ 0x80000000u) << 32) |
          (unsigned long long)s;
      if (g >= g0) mn = min(mn, key);
      mx = max(mx, key);
    }
    // one atomic for the lanes of a warp that hit the same group
    const unsigned peers = __match_any_sync(FULL, idx);
    if (idx >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(cnt + idx, __popc(peers));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mn = min(mn, __shfl_xor_sync(FULL, mn, d));
    mx = max(mx, __shfl_xor_sync(FULL, mx, d));
  }
  __shared__ unsigned long long warp_mn[WARPS], warp_mx[WARPS];
  if (lane == 0) {
    warp_mn[wid] = mn;
    warp_mx[wid] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < WARPS; ++i) {
      mn = min(mn, warp_mn[i]);
      mx = max(mx, warp_mx[i]);
    }
    if (mn < a.minkey[t]) atomicMin(a.minkey + t, mn);
    if (mx > a.maxkey[t]) atomicMax(a.maxkey + t, mx);
  }
}

__global__ void join_alloc_kernel(Args a) {
  const int t = blockIdx.y;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long at = (long long)t * a.hs + e;
  const int c = e < a.hs ? a.cnt[at] : 0;
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  int base = 0;
  if (lane == 31 && x > 0) base = atomicAdd(a.btotal + t, x);
  base = __shfl_sync(FULL, base, 31);
  if (c > 0) {
    a.offs[at] = base + x - c;
    a.cursor[at] = base + x - c;
  }
}

__global__ void join_scatter_kernel(Args a) {
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * THREADS * SLOT_ITEMS;
  const int* h = a.h1 + (long long)t * a.k1;
  const int* keys = a.keys + (long long)t * a.hs;
  int* cursor = a.cursor + (long long)t * a.hs;
  int* bucket = a.bucket + (long long)t * a.k1;
  for (int it = 0; it < SLOT_ITEMS; ++it) {
    const long long s = base + it * THREADS + threadIdx.x;
    int g;
    const int idx = slot_entry(a, h, keys, s, &g);
    // the lanes that hit one group take consecutive places of its bucket
    const unsigned peers = __match_any_sync(FULL, idx);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (idx >= 0 && lane == leader) at = atomicAdd(cursor + idx, __popc(peers));
    at = __shfl_sync(FULL, at, leader);
    if (idx >= 0) bucket[at + __popc(peers & ((1u << lane) - 1u))] = (int)s;
  }
}

__device__ __forceinline__ int warp_sort(int v, int lane) {
  // bitonic sort of one value a lane, ascending over the lanes
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(FULL, v, j);
      const bool up = (lane & k) == 0, low = (lane & j) == 0;
      v = (low == up) ? min(v, o) : max(v, o);
    }
  return v;
}

__device__ __forceinline__ int warp_merge(int v, int lane) {
  // ascending order of a bitonic sequence over the lanes
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const int o = __shfl_xor_sync(FULL, v, j);
    v = (lane & j) == 0 ? min(v, o) : max(v, o);
  }
  return v;
}

// Each bucket's first min(L, count) slots become its smallest slot ids,
// ascending: a warp per bucket keeps the running 32 smallest.
__global__ void join_order_kernel(Args a) {
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = (long long)t * a.hs;
  const int c = e < a.hs ? a.cnt[row + e] : 0;
  unsigned todo = __ballot_sync(FULL, c > 1);
  const long long first = e - lane;
  int* bucket = a.bucket + (long long)t * a.k1;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int ce = __shfl_sync(FULL, c, src);
    const int off = a.offs[row + first + src];
    int best = INT_MAX;
    for (int b = 0; b < ce; b += 32) {
      int v = b + lane < ce ? bucket[off + b + lane] : INT_MAX;
      v = warp_sort(v, lane);
      // the 32 smallest of both, as a bitonic sequence, then in order
      best = warp_merge(min(best, __shfl_sync(FULL, v, 31 - lane)), lane);
    }
    if (lane < min(a.L, ce)) bucket[off + lane] = best;
  }
}

// --- probe selection, validation, output -----------------------------

__global__ void join_probe_flags_kernel(Args a) {
  const int t = blockIdx.y;
  const long long pi = (long long)blockIdx.x * THREADS + threadIdx.x;
  int c = 0;
  if (pi < a.npa) {
    const int slot = a.pslot[(long long)t * a.npa + pi];
    c = slot >= 0 ? a.cnt[(long long)t * a.hs + slot] : 0;
    a.flags_p[(long long)t * a.npa + pi] = c > 0;
  }
  warp_add(a.cells + t, c);
}

// A thread a kept probe p: its candidates l < min(L, count), each flag
// at l * pb + p (l-major, as the plain version's candidate planes).
__global__ void join_validate_kernel(Args a) {
  const int t = blockIdx.y;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int nkept = min(a.total_p[t], a.pb);
  long long kept = 0, over = 0;
  if (p < a.pb) {
    unsigned char* flags = a.flags_v + (long long)t * a.nv + p;
    int c = 0;
    if (p < nkept) {
      const int pi = a.psel[(long long)t * a.pb + p];
      const int slot = a.pslot[(long long)t * a.npa + pi];
      c = a.cnt[(long long)t * a.hs + slot];
      kept = c;
      over = max(c - a.L, 0);
      const int* cand =
          a.bucket + (long long)t * a.k1 + a.offs[(long long)t * a.hs + slot];
      const float4* qd = a.qdata + ((long long)t * a.qb + pi / a.np) * 2;
      const float4 q0 = qd[0], q1 = qd[1];
      const float* p3 = a.pos + (long long)(t / a.per_set) * a.n * 3;
      const int* cols1 = a.cols1 + (long long)t * a.k1;
      const float inv1 = a.geo[t * 4], cos_a = a.geo[t * 4 + 2];
      for (int l = 0; l < min(c, a.L); ++l) {
        const int orid = cand[l];
        const int row = min(orid / a.row_cap, a.n - 1);
        const int col = cols1[orid];
        const float ax = p3[row * 3], ay = p3[row * 3 + 1], az = p3[row * 3 + 2];
        const float bx = p3[col * 3], by = p3[col * 3 + 1], bz = p3[col * 3 + 2];
        const float dx = __fsub_rn(bx, ax), dy = __fsub_rn(by, ay),
                    dz = __fsub_rn(bz, az);
        const float ddx = __fsub_rn(__fadd_rn(ax, __fmul_rn(inv1, dx)), q0.x);
        const float ddy = __fsub_rn(__fadd_rn(ay, __fmul_rn(inv1, dy)), q0.y);
        const float ddz = __fsub_rn(__fadd_rn(az, __fmul_rn(inv1, dz)), q0.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx),
                                             __fmul_rn(ddy, ddy)),
                                   __fmul_rn(ddz, ddz));
        bool ok = d2 <= a.r2;
        if (a.use_cone) {
          const float n1 = clamp_min(norm3(dx, dy, dz), 1e-30f);
          const float cs = __fdiv_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(dx, q0.w), __fmul_rn(dy, q1.x)),
                        __fmul_rn(dz, q1.y)),
              n1);
          ok = ok && fabsf(__fsub_rn(cs, cos_a)) <= a.tol;
        }
        flags[(long long)l * a.pb] = ok;
      }
    }
    for (int l = min(c, a.L); l < a.L; ++l) flags[(long long)l * a.pb] = 0;
  }
  warp_add(a.kept + t, kept);
  warp_add(a.over + t, over);
}

__global__ void join_emit_kernel(Args a) {
  const int t = blockIdx.y;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= a.cap) return;
  const int count = a.total_v[t];
  const int nkept = min(a.total_p[t], a.pb);
  const long long krow = (long long)t * a.k1;
  int orid, q;
  if (j < count || nkept > 0) {
    // a pass, or slot 0's candidate (entry 0 of the first kept probe)
    const int i = j < count ? a.oidx[(long long)t * a.cap + j] : 0;
    const int l = i / a.pb;
    const int pi = a.psel[(long long)t * a.pb + (i - l * a.pb)];
    const int slot = a.pslot[(long long)t * a.npa + pi];
    orid = a.bucket[krow + a.offs[(long long)t * a.hs + slot] + l];
    q = pi / a.np;
  } else {
    const unsigned long long k =
        a.minkey[t] != NO_KEY ? a.minkey[t] : a.maxkey[t];
    orid = (int)(unsigned)(k & 0xffffffffull);
    q = 0;
  }
  const float4 q1 = a.qdata[((long long)t * a.qb + q) * 2 + 1];
  long long* o = a.quads + ((long long)t * a.cap + j) * 4;
  o[0] = orid / a.row_cap;
  o[1] = a.cols1[krow + orid];
  o[2] = __float_as_int(q1.z);
  o[3] = __float_as_int(q1.w);
  a.valid[(long long)t * a.cap + j] = j < count;
  if (j == 0) {
    a.count[t] = count;
    a.dropped[t] = (long long)a.over[t] + (long long)a.cells[t] -
                   (long long)a.kept[t];
    a.qsub[t] = (long long)a.np * max(a.total2[t] - a.qb, 0);
  }
}

int blocks(long long n, long long per) { return (int)((n + per - 1) / per); }

}  // namespace

extern "C" long long grid_join_workspace(int trials, long long k1,
                                         long long k2, int qb, int w,
                                         int L, int pb, int cap) {
  return layout(trials, k2, qb, w * w * w, L, pb, cap, k1).size;
}

#define CHECK_LAUNCH()                          \
  do {                                          \
    const cudaError_t err = cudaGetLastError(); \
    if (err != cudaSuccess) return (int)err;    \
  } while (0)

// One join of T trials. pos (G, n, 3) float32, trial t on set
// t / per_set; cols1, h1 (T, k1) int32; cols2 (T, k2) int32, valid2
// (T, k2) bool; geo (T, 4) float32 (inv1, inv2, cos_a, 0); work of
// grid_join_workspace() bytes; outputs quads (T, cap, 4) int64, valid
// (T, cap) bool, count, dropped, qsub (T,) int64. Returns the first
// launch error (0 when none).
extern "C" int grid_join(const void* pos, int n, int per_set,
                         const void* cols1, const void* h1, long long k1,
                         const void* cols2, const void* valid2,
                         long long k2, const void* geo, float r, float r2,
                         float cell, float tol, int use_cone, int row_cap,
                         int L, int qb, int w, int pb, int cap, int trials,
                         void* work, void* quads, void* valid, void* count,
                         void* dropped, void* qsub, void* stream) {
  if (trials == 0) return 0;
  const int np = w * w * w;
  const Layout y = layout(trials, k2, qb, np, L, pb, cap, k1);
  char* wb = (char*)work;
  Args a;
  a.pos = (const float*)pos;
  a.n = n;
  a.per_set = per_set;
  a.cols1 = (const int*)cols1;
  a.h1 = (const int*)h1;
  a.k1 = k1;
  a.cols2 = (const int*)cols2;
  a.valid2 = (const unsigned char*)valid2;
  a.k2 = k2;
  a.geo = (const float*)geo;
  a.r = r;
  a.r2 = r2;
  a.cell = cell;
  a.tol = tol;
  a.use_cone = use_cone;
  a.row_cap = row_cap;
  a.L = L;
  a.qb = qb;
  a.w = w;
  a.np = np;
  a.pb = pb;
  a.cap = cap;
  a.hs_log2 = y.hs_log2;
  a.hs = 1ll << y.hs_log2;
  a.npa = (long long)qb * np;
  a.nv = (long long)L * pb;
  a.ntiles2 = y.ntiles2;
  a.ntiles_p = y.ntiles_p;
  a.ntiles_v = y.ntiles_v;
  a.keys = (int*)(wb + y.keys);
  a.minkey = (unsigned long long*)(wb + y.minkey);
  a.maxkey = (unsigned long long*)(wb + y.maxkey);
  a.cells = (unsigned long long*)(wb + y.cells);
  a.kept = (unsigned long long*)(wb + y.kept);
  a.over = (unsigned long long*)(wb + y.over);
  a.cnt = (int*)(wb + y.cnt);
  a.btotal = (int*)(wb + y.btotal);
  a.offs = (int*)(wb + y.offs);
  a.cursor = (int*)(wb + y.cursor);
  a.pslot = (int*)(wb + y.pslot);
  a.bucket = (int*)(wb + y.bucket);
  a.qdata = (float4*)(wb + y.qdata);
  a.g0 = (int*)(wb + y.g0);
  a.flags_p = (unsigned char*)(wb + y.flags_p);
  a.flags_v = (unsigned char*)(wb + y.flags_v);
  a.tiles2 = (int*)(wb + y.tiles2);
  a.tiles_p = (int*)(wb + y.tiles_p);
  a.tiles_v = (int*)(wb + y.tiles_v);
  a.total2 = (int*)(wb + y.total2);
  a.total_p = (int*)(wb + y.total_p);
  a.total_v = (int*)(wb + y.total_v);
  a.sel2 = (int*)(wb + y.sel2);
  a.psel = (int*)(wb + y.psel);
  a.oidx = (int*)(wb + y.oidx);
  a.quads = (long long*)quads;
  a.valid = (unsigned char*)valid;
  a.count = (long long*)count;
  a.dropped = (long long*)dropped;
  a.qsub = (long long*)qsub;

  const cudaStream_t st = (cudaStream_t)stream;
  const int T = trials;
  cudaError_t err = cudaMemsetAsync(wb + y.ff_begin, 0xff,
                                    y.ff_end - y.ff_begin, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(wb + y.zero_begin, 0, y.zero_end - y.zero_begin, st);
  if (err != cudaSuccess) return (int)err;

  // sel2: the first qb valid slots of the second table
  join_count_tiles_kernel<<<dim3(y.ntiles2, T), THREADS, 0, st>>>(
      a.valid2, k2, y.ntiles2, a.tiles2);
  CHECK_LAUNCH();
  join_scan_tiles_kernel<<<T, THREADS, 0, st>>>(a.tiles2, y.ntiles2, a.total2);
  CHECK_LAUNCH();
  join_compact_write_kernel<<<dim3(y.ntiles2, T), THREADS, 0, st>>>(
      a.valid2, k2, y.ntiles2, a.tiles2, qb, a.sel2);
  CHECK_LAUNCH();

  join_probe_kernel<<<dim3(blocks(a.npa, THREADS), T), THREADS, 0, st>>>(a);
  CHECK_LAUNCH();
  const dim3 slots(blocks(k1, THREADS * SLOT_ITEMS), T);
  join_count_kernel<<<slots, THREADS, 0, st>>>(a);
  CHECK_LAUNCH();
  const dim3 entries(blocks(a.hs, THREADS), T);
  join_alloc_kernel<<<entries, THREADS, 0, st>>>(a);
  CHECK_LAUNCH();
  join_scatter_kernel<<<slots, THREADS, 0, st>>>(a);
  CHECK_LAUNCH();
  join_order_kernel<<<entries, THREADS, 0, st>>>(a);
  CHECK_LAUNCH();

  // psel: the first pb probes whose cell is not empty
  join_probe_flags_kernel<<<dim3(blocks(a.npa, THREADS), T), THREADS, 0, st>>>(a);
  CHECK_LAUNCH();
  join_count_tiles_kernel<<<dim3(y.ntiles_p, T), THREADS, 0, st>>>(
      a.flags_p, a.npa, y.ntiles_p, a.tiles_p);
  CHECK_LAUNCH();
  join_scan_tiles_kernel<<<T, THREADS, 0, st>>>(a.tiles_p, y.ntiles_p, a.total_p);
  CHECK_LAUNCH();
  join_compact_write_kernel<<<dim3(y.ntiles_p, T), THREADS, 0, st>>>(
      a.flags_p, a.npa, y.ntiles_p, a.tiles_p, pb, a.psel);
  CHECK_LAUNCH();

  // the candidates, then the first cap passes in (L, pb) order
  join_validate_kernel<<<dim3(blocks(pb, THREADS), T), THREADS, 0, st>>>(a);
  CHECK_LAUNCH();
  join_count_tiles_kernel<<<dim3(y.ntiles_v, T), THREADS, 0, st>>>(
      a.flags_v, a.nv, y.ntiles_v, a.tiles_v);
  CHECK_LAUNCH();
  join_scan_tiles_kernel<<<T, THREADS, 0, st>>>(a.tiles_v, y.ntiles_v, a.total_v);
  CHECK_LAUNCH();
  join_compact_write_kernel<<<dim3(y.ntiles_v, T), THREADS, 0, st>>>(
      a.flags_v, a.nv, y.ntiles_v, a.tiles_v, cap, a.oidx);
  CHECK_LAUNCH();
  join_emit_kernel<<<dim3(blocks(cap, THREADS), T), THREADS, 0, st>>>(a);
  CHECK_LAUNCH();
  return 0;
}
