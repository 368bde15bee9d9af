// Sorted-run segment sums for the sort-path GROUP BY.
//
// Replaces: presto_tpu/ops/pallas_scan.py segment_sum_sorted_i64 (and
// segment_count_sorted), whose TPU kernel is _cumsum_kernel under
// _cumsum_tiled: an inclusive int32 prefix sum over [64,128] tiles with a
// VMEM carry across the sequential grid, run once per base-2^w digit plane
// of the int64 values because the TPU backend cannot pass 64-bit arrays
// across pallas_call.
//
// What it computes: for each segment g of `cap`,
//   out[g] = P(end_g) - (start_g <= 0 ? 0 : P(clamp(start_g - 1)))  mod 2^64
// where P is the inclusive prefix sum of the int64 values, end_g =
// clamp(starts[g+1] - 1) (n - 1 for the last segment) and clamp is into
// [0, n-1]. That is bit for bit what the digit-plane algorithm returns:
// Hopper has native 64-bit integers, so the values are scanned directly in
// unsigned long long arithmetic, whose wraparound mod 2^64 is defined
// (signed overflow is not) and gives the same bits as the JAX sums.
//
// Bound on the H100: memory. The work is one read of the n values (8n
// bytes), one read of `starts` (4 cap) and one write of the sums (8 cap);
// the additions are nothing against 3.35 TB/s. This design also writes
// and re-reads an 8n-byte per-tile prefix, so it moves about three times
// the bound's bytes.
//
// Design: blocks run in no order on Hopper, so the TPU's sequential grid
// carry has no counterpart. Three launches instead:
//   1. tile_scan: each block scans one tile of 2048 values (coalesced
//      loads through shared memory, 8 values per thread, warp shuffles)
//      into a tile-local prefix and writes the tile's total;
//   2. scan_tile_totals: one block turns the tile totals into exclusive
//      tile offsets (4096 tiles at n = 2^23);
//   3. segment_diff: one thread per segment reads its two boundary
//      prefixes as local prefix + tile offset and writes the difference.
// No add-back pass is needed because only 2 cap prefixes are ever read.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ u64 warp_inclusive_scan(u64 v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    u64 y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// Inclusive scan of one value per thread across the block; returns the
// thread's inclusive prefix and stores the block total in *total.
__device__ __forceinline__ u64 block_inclusive_scan(u64 v, u64* warp_tot,
                                                    u64* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  u64 t = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_tot[warp] = t;
  __syncthreads();
  if (warp == 0) {
    u64 w = lane < nwarps ? warp_tot[lane] : 0ull;
    w = warp_inclusive_scan(w, lane);
    if (lane < nwarps) warp_tot[lane] = w;
  }
  __syncthreads();
  u64 incl = t + (warp > 0 ? warp_tot[warp - 1] : 0ull);
  *total = warp_tot[nwarps - 1];
  __syncthreads();
  return incl;
}

__global__ void __launch_bounds__(kThreads)
tile_scan(const u64* __restrict__ x, long long n, u64* __restrict__ local,
          u64* __restrict__ tile_tot) {
  __shared__ u64 buf[kTile];
  __shared__ u64 warp_tot[kThreads / 32];
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    long long idx = base + i * kThreads + threadIdx.x;
    buf[i * kThreads + threadIdx.x] = idx < n ? x[idx] : 0ull;
  }
  __syncthreads();
  u64 v[kItems];
  u64 s = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    s += buf[threadIdx.x * kItems + i];
    v[i] = s;
  }
  u64 total;
  const u64 excl = block_inclusive_scan(s, warp_tot, &total) - s;
#pragma unroll
  for (int i = 0; i < kItems; ++i) buf[threadIdx.x * kItems + i] = v[i] + excl;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    long long idx = base + i * kThreads + threadIdx.x;
    if (idx < n) local[idx] = buf[i * kThreads + threadIdx.x];
  }
  if (threadIdx.x == 0) tile_tot[blockIdx.x] = total;
}

// In-place exclusive scan of the tile totals by one block.
__global__ void scan_tile_totals(u64* __restrict__ tot, int ntiles) {
  __shared__ u64 warp_tot[32];
  u64 carry = 0;
  for (int start = 0; start < ntiles; start += blockDim.x) {
    const int i = start + threadIdx.x;
    const u64 v = i < ntiles ? tot[i] : 0ull;
    u64 chunk;
    const u64 incl = block_inclusive_scan(v, warp_tot, &chunk);
    if (i < ntiles) tot[i] = carry + incl - v;
    carry += chunk;
  }
}

__device__ __forceinline__ long long clamp_row(long long i, long long n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__global__ void segment_diff(const u64* __restrict__ local,
                             const u64* __restrict__ tile_off,
                             const int* __restrict__ starts, long long n,
                             int cap, long long* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= cap) return;
  const long long s = starts[g];
  const long long e =
      clamp_row(g + 1 < cap ? (long long)starts[g + 1] - 1 : n - 1, n);
  const long long p = clamp_row(s - 1, n);
  const u64 hi = local[e] + tile_off[e / kTile];
  const u64 lo = s <= 0 ? 0ull : local[p] + tile_off[p / kTile];
  out[g] = (long long)(hi - lo);
}

}  // namespace

extern "C" {

// Scratch sizes the caller allocates: `local` holds n u64, `tiles` holds
// scan_tile_count(n) u64.
long long scan_tile_count(long long n) { return (n + kTile - 1) / kTile; }

int segment_sum_sorted_i64(const void* values, long long n,
                           const void* starts, int cap, void* out,
                           void* local, void* tiles, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long ntiles = scan_tile_count(n);
  if (n <= 0 || cap <= 0) return (int)cudaGetLastError();
  tile_scan<<<(unsigned)ntiles, kThreads, 0, st>>>(
      (const u64*)values, n, (u64*)local, (u64*)tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tile_totals<<<1, 1024, 0, st>>>((u64*)tiles, (int)ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_diff<<<(cap + 255) / 256, 256, 0, st>>>(
      (const u64*)local, (const u64*)tiles, (const int*)starts, n, cap,
      (long long*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
