// Sorted-run segment sums for the sort-path GROUP BY.
//
// Replaces: presto_tpu/ops/pallas_scan.py segment_sum_sorted_i64 (and
// segment_count_sorted), whose TPU kernel is _cumsum_kernel under
// _cumsum_tiled: an inclusive int32 prefix sum over [64,128] tiles with a
// VMEM carry across the sequential grid, run once per base-2^w digit plane
// of the int64 values because the TPU backend cannot pass 64-bit arrays
// across pallas_call.
//
// What it computes: with 0 <= starts[0] <= starts[1] <= ... <= n, segment g
// holds rows [starts[g], end_g] with end_g = min(starts[g+1], n) - 1 (n - 1
// for the last segment), and out[g] is the sum of its int64 values mod
// 2^64. Absent segments (starts[g] == n) and empty ones come out 0, except
// that an empty segment starting at row 0 gets values[0]: bit for bit what
// the reference's clamped prefix differences return. Hopper has native
// 64-bit integers, so the values are summed directly in unsigned long long,
// whose wraparound mod 2^64 is defined (signed overflow is not) and gives
// the same bits as the digit-plane sums in any order of addition.
//
// Bound on the H100: memory. The work is one read of the n values (8n
// bytes), of `starts` (4 cap) and one write of the sums (8 cap); the
// additions are nothing against 3.35 TB/s.
//
// Design for Hopper: one launch after one cudaMemsetAsync of the output,
// and no scratch array. Each block takes a tile of 2048 rows:
//   1. its threads issue cp.async copies of 16 bytes that bring the tile
//      into shared memory (zero-filled past n), laid out with 16 bytes of
//      padding every 128 so the scan below reads it without bank conflicts;
//   2. while the copies are in flight, warp 0 finds the segment of the
//      tile's first row by a 32-way search of `starts` (32 probes a round
//      trip, 5 round trips for 2^23 segments);
//   3. the block turns the tile into its inclusive prefix in place (8 rows
//      a thread in registers, warp shuffles across threads);
//   4. one thread per segment that meets the tile takes the difference of
//      two prefix entries. A segment wholly inside the tile gets a plain
//      store; the at most two that cross the tile's edges add their part
//      with a 64-bit atomicAdd (skipped when the part is 0). Integer
//      addition mod 2^64 is associative and commutative, so the result
//      does not depend on the order of the atomics.
// Bytes moved: the bound's, plus the 8 cap of the memset.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // rows a block
constexpr int kPairs = kTile / 2;         // 16-byte copies a tile
constexpr int kPadded = kTile + kTile / 8;
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

// Shared-memory slot of tile row e: 2 slots of padding after every 16.
__device__ __forceinline__ int slot(int e) { return e + 2 * (e >> 4); }

__device__ __forceinline__ u64 warp_inclusive_scan(u64 v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// Exclusive prefix of one value per thread across the block.
__device__ __forceinline__ u64 block_exclusive_scan(u64 v, u64* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const u64 t = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_tot[warp] = t;
  __syncthreads();
  if (warp == 0) {
    u64 w = lane < kThreads / 32 ? warp_tot[lane] : 0ull;
    w = warp_inclusive_scan(w, lane);
    if (lane < kThreads / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  return t - v + (warp > 0 ? warp_tot[warp - 1] : 0ull);
}

// Number of segments g < cap with starts[g] <= x, by one warp: each round
// trip reads 32 probes spread over the open range and keeps the slice
// between the last probe at or below x and the first above it.
__device__ int warp_count_le(const int* __restrict__ starts, int cap,
                             long long x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = cap;  // the count lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const long long q = (long long)lo + (long long)(lane + 1) * step - 1;
    const bool le = q < hi && __ldg(starts + q) <= x;
    const int k = __popc(__ballot_sync(kFull, le));
    const long long top = (long long)lo + (long long)(k + 1) * step - 1;
    lo += k * step;
    hi = top < hi ? (int)top : hi;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const u64* __restrict__ values, long long n,
                   const int* __restrict__ starts, int cap,
                   u64* __restrict__ out) {
  __shared__ __align__(16) u64 buf[kPadded];
  __shared__ u64 warp_tot[kThreads / 32];
  __shared__ int first_seg;
  const long long base = (long long)blockIdx.x * kTile;
  const long long rows_left = n - base;
  const int rows = rows_left < kTile ? (int)rows_left : kTile;

  // 1. the tile, 16 bytes a copy, zero-filled past the last row
#pragma unroll
  for (int r = 0; r < kPairs / kThreads; ++r) {
    const int e = 2 * (r * kThreads + threadIdx.x);
    const int left = rows - e;
    const int bytes = left >= 2 ? 16 : (left == 1 ? 8 : 0);
    const u64* src = bytes ? values + base + e : values;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&buf[slot(e)]);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. the segment of the tile's first row (-1: the row precedes segment 0)
  if (threadIdx.x < 32) {
    const int c = warp_count_le(starts, cap, base);
    if (threadIdx.x == 0) first_seg = c - 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 3. inclusive prefix of the tile, in place
  u64 v[kItems];
  u64 s = 0;
#pragma unroll
  for (int j = 0; j < kItems / 2; ++j) {
    const ulonglong2 x =
        *(const ulonglong2*)&buf[slot(threadIdx.x * kItems + 2 * j)];
    s += x.x;
    v[2 * j] = s;
    s += x.y;
    v[2 * j + 1] = s;
  }
  const u64 excl = block_exclusive_scan(s, warp_tot);
#pragma unroll
  for (int j = 0; j < kItems / 2; ++j)
    *(ulonglong2*)&buf[slot(threadIdx.x * kItems + 2 * j)] =
        make_ulonglong2(v[2 * j] + excl, v[2 * j + 1] + excl);
  __syncthreads();

  // 4. segments meeting the tile: whole ones stored, edge ones added
  const int g0 = first_seg;
  if (blockIdx.x == 0) {
    // segments before g0 are empty at row 0; the reference gives values[0]
    for (int g = threadIdx.x; g < g0; g += kThreads) out[g] = buf[slot(0)];
  }
  const long long last = base + rows - 1;
  for (int gb = g0 > 0 ? g0 : 0;; gb += kThreads) {
    const int g = gb + threadIdx.x;
    bool meets = false;
    if (g < cap) {
      const long long st = __ldg(starts + g);
      if (st <= last) {
        meets = true;
        long long end = n;
        if (g + 1 < cap) {
          const long long nx = __ldg(starts + g + 1);
          end = nx < n ? nx : n;
        }
        --end;
        const long long a = st > base ? st : base;
        const long long b = end < last ? end : last;
        if (a <= b) {
          const u64 part = buf[slot((int)(b - base))] -
                           (a > base ? buf[slot((int)(a - 1 - base))] : 0ull);
          if (st >= base && end <= last)
            out[g] = part;
          else if (part != 0ull)
            atomicAdd(out + g, part);
        }
      }
    }
    if (!__syncthreads_or(meets)) break;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`: a memset of the cap sums, then one kernel.
// `values` must be 16-byte aligned (ops/scan.py ensures it).
int segment_sum_sorted_i64(const void* values, long long n,
                           const void* starts, int cap, void* out,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || cap <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(u64) * (size_t)cap, st);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kTile - 1) / kTile;
  segment_sum_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      (const u64*)values, n, (const int*)starts, cap, (u64*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
