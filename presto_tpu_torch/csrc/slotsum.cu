// Slot sums for the dense GROUP BY: out[s] = sum of x[i] over the lanes i
// with gid[i] == s, for s in [0, slots).
//
// Replaces no Pallas kernel: presto_tpu's dense path reduces with XLA's
// scatter-add. The port first reduced with one `index_add_` per
// aggregate, whose atomic adds serialize when the live lanes fall on a
// few slots: TPC-H Q1 has 13 slots of which 4 are live, so every lane of
// a 2^23-lane batch added into one of 4 addresses, 10 ms a float64 and
// 5 ms an int64 reduction on the H100 where this kernel takes 0.055.
//
// Inputs: `gid` is 1-D int64 in [0, slots) (lanes outside are dropped);
// `x` is 1-D float64, int64 or bool (bool is summed as a count of
// trues); 1 <= slots <= 4097, the dense path's 4096 key slots and its
// slot of dead lanes. The sums land in `out` (float64 for float64,
// int64 otherwise). Int64 sums wrap mod 2^64 (summed in unsigned long
// long, whose wraparound is defined), so they are bit for bit those of
// `index_add_` in any order; float64 sums differ from it by order only.
//
// Bound on the H100: memory. A float64 or int64 sum reads 16 bytes a
// lane (8 of gid, 8 of x), so 2^23 lanes take at least 40 us at
// 3.35 TB/s; a count reads 9 bytes a lane, at least 23 us.
//
// Design for Hopper: block-privatized, with no atomics on values, and
// the same bits from run to run. Each block walks a grid-stride loop
// over 16-byte vectors of x (2 lanes of float64 or int64, 16 of bool)
// and the gid vectors under them, about 2 blocks per SM:
//   - slots <= 32: each thread keeps one accumulator per slot in
//     registers (SMAX, the slot count rounded up to a power of two, is a
//     template parameter) and adds each lane by an unrolled
//     compare-and-add over the SMAX slots (a compare and a predicated
//     add, in PTX): no register is indexed by a runtime value, which
//     would put the accumulators in local memory. Counts accumulate in
//     32 bits a thread. The block then reduces each
//     slot by warp shuffles and across its 8 warps in warp order;
//   - 33 to 4097 slots: each warp keeps its own copy of the slots in
//     shared memory (up to 8 warps a block, fewer where 8 copies of
//     many slots would not leave room for 2 blocks an SM). A warp takes
//     one lane a thread at a time: `__match_any_sync` groups the lanes
//     of one slot, the lowest of them adds the others' values in lane
//     order and stores the slot. A copy has one writer, so no atomics;
//     the block sums its warps' copies in warp order.
// Each block writes its partial sums to `partials` ([blocks, slots], in
// scratch the wrapper allocates). Up to 32 slots the last block to
// finish (an atomic ticket after __threadfence) sums them into `out`, so
// the sums take one launch with no atomics on values; above 32 a second
// kernel sums them, 32 slots a block, since one block reading
// [264, 4097] partials took longer than the whole pass. Both sum each
// slot's partials in a fixed order (rows spread over 8 warps, then the
// warps in order). Bytes moved: the bound's, plus blocks x slots x 8
// twice for the partials (27 KB at Q1's 13 slots).
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 4097;
constexpr int kRegSlots = 32;     // above this, per-warp copies in shared
constexpr int kRegThreads = 256;  // threads of the register kernel
constexpr int kMaxWarps = 8;      // warps of the shared-memory kernel
// shared memory a block of the shared-memory kernel may take, so that
// two fit in an SM's 227 KB
constexpr int kSmemBudget = 113 * 1024;
constexpr int kTicketBytes = 16;  // the ticket, ahead of the partials

// The element types. `Lane` holds one lane of x as the sum takes it,
// `Part` a thread's running sum, `Acc` the block's and the output's.
struct F64 {
  typedef double Lane;
  typedef double Part;
  typedef double Acc;
  static constexpr int kLanes = 2;  // lanes a 16-byte vector
  static constexpr int kUnits = 4;  // vectors a thread loads at once
  __device__ __forceinline__ static void load(const void* x, long long vec,
                                              Lane* v) {
    const double2 d = __ldg(static_cast<const double2*>(x) + vec);
    v[0] = d.x;
    v[1] = d.y;
  }
  __device__ __forceinline__ static Lane one(const void* x, long long i) {
    return __ldg(static_cast<const double*>(x) + i);
  }
};

struct I64 {
  typedef u64 Lane;
  typedef u64 Part;
  typedef u64 Acc;
  static constexpr int kLanes = 2;
  static constexpr int kUnits = 4;
  __device__ __forceinline__ static void load(const void* x, long long vec,
                                              Lane* v) {
    const longlong2 d = __ldg(static_cast<const longlong2*>(x) + vec);
    v[0] = static_cast<u64>(d.x);
    v[1] = static_cast<u64>(d.y);
  }
  __device__ __forceinline__ static Lane one(const void* x, long long i) {
    return static_cast<u64>(__ldg(static_cast<const long long*>(x) + i));
  }
};

// bool: one byte a lane, 0 or 1
struct Bool {
  typedef unsigned Lane;
  typedef unsigned Part;
  typedef u64 Acc;
  static constexpr int kLanes = 16;
  static constexpr int kUnits = 1;
  __device__ __forceinline__ static void load(const void* x, long long vec,
                                              Lane* v) {
    const uint4 d = __ldg(static_cast<const uint4*>(x) + vec);
    const unsigned w[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b) v[4 * k + b] = (w[k] >> (8 * b)) & 0xffu;
  }
  __device__ __forceinline__ static Lane one(const void* x, long long i) {
    return __ldg(static_cast<const unsigned char*>(x) + i);
  }
};

// The gid and x lanes of the vectors this thread takes in one step:
// vector base + u * stride for u < kUnits; lanes of vectors at or past
// nvec get gid -1, which no slot matches.
template <typename T>
__device__ __forceinline__ void load_step(
    const long long* __restrict__ gid, const void* __restrict__ x,
    long long nvec, long long base, int stride,
    int (&g)[T::kUnits][T::kLanes],
    typename T::Lane (&v)[T::kUnits][T::kLanes]) {
#pragma unroll
  for (int u = 0; u < T::kUnits; ++u) {
    const long long vec = base + static_cast<long long>(u) * stride;
    if (vec < nvec) {
      T::load(x, vec, v[u]);
#pragma unroll
      for (int p = 0; p < T::kLanes / 2; ++p) {
        const longlong2 q =
            __ldg(reinterpret_cast<const longlong2*>(gid) +
                  vec * (T::kLanes / 2) + p);
        g[u][2 * p] = static_cast<int>(q.x);
        g[u][2 * p + 1] = static_cast<int>(q.y);
      }
    } else {
#pragma unroll
      for (int l = 0; l < T::kLanes; ++l) {
        g[u][l] = -1;
        v[u][l] = 0;
      }
    }
  }
}

// acc += v where g == s: a compare and a predicated add. Written in PTX
// because the compiler, given the unrolled C++ form, may merge the
// SMAX compares into one store at acc[g], a runtime register index that
// puts the accumulators in local memory.
__device__ __forceinline__ void add_if(double& acc, int g, int s, double v) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
      "@p add.f64 %0, %0, %3;\n\t}"
      : "+d"(acc)
      : "r"(g), "r"(s), "d"(v));
}
__device__ __forceinline__ void add_if(u64& acc, int g, int s, u64 v) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
      "@p add.u64 %0, %0, %3;\n\t}"
      : "+l"(acc)
      : "r"(g), "r"(s), "l"(v));
}
__device__ __forceinline__ void add_if(unsigned& acc, int g, int s,
                                       unsigned v) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
      "@p add.u32 %0, %0, %3;\n\t}"
      : "+r"(acc)
      : "r"(g), "r"(s), "r"(v));
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Sums slots [base, base + 32) of the [rows, slots] partials into `out`
// in a fixed order: lane l takes slot base + l, warp w the rows w,
// w + warps, ...; then warp 0 adds the warps' sums in warp order. Every
// thread of the block (at most kMaxWarps warps) calls this.
template <typename Acc>
__device__ __forceinline__ void merge_rows(const Acc* partials, int rows,
                                           int slots, int base,
                                           Acc* __restrict__ out) {
  __shared__ Acc part[kMaxWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int s = base + lane;
  Acc t = 0;
  if (s < slots) {
#pragma unroll 4
    for (int b = warp; b < rows; b += warps)
      t += __ldcg(partials + static_cast<long long>(b) * slots + s);
  }
  part[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && s < slots) {
    Acc r = 0;
    for (int w = 0; w < warps; ++w) r += part[w][lane];
    out[s] = r;
  }
}

// The last block to arrive sums the blocks' partials (at most 32 slots).
// Every thread calls this after the block's partials are written.
template <typename Acc>
__device__ __forceinline__ void finish(const Acc* partials,
                                       unsigned* ticket, int slots,
                                       Acc* __restrict__ out) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x - 1 ? 1 : 0;
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge_rows(partials, static_cast<int>(gridDim.x), slots, 0, out);
}

template <typename T, int SMAX>
__global__ void __launch_bounds__(kRegThreads, 2)
slot_sum_regs(const long long* __restrict__ gid, const void* __restrict__ x,
              long long n, int slots, typename T::Acc* partials,
              unsigned* ticket, typename T::Acc* __restrict__ out) {
  typedef typename T::Part Part;
  typedef typename T::Acc Acc;
  Part acc[SMAX];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) acc[s] = 0;
  const long long nvec = n / T::kLanes;
  const long long span = static_cast<long long>(kRegThreads) * T::kUnits;
  for (long long base = blockIdx.x * span + threadIdx.x; base < nvec;
       base += gridDim.x * span) {
    int g[T::kUnits][T::kLanes];
    typename T::Lane v[T::kUnits][T::kLanes];
    load_step<T>(gid, x, nvec, base, kRegThreads, g, v);
#pragma unroll
    for (int u = 0; u < T::kUnits; ++u)
#pragma unroll
      for (int l = 0; l < T::kLanes; ++l)
#pragma unroll
        for (int s = 0; s < SMAX; ++s) add_if(acc[s], g[u][l], s, v[u][l]);
  }
  // the ragged tail, fewer lanes than a vector, in block 0
  const long long tail = nvec * T::kLanes + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) {
    const int gt = static_cast<int>(gid[tail]);
    const typename T::Lane vt = T::one(x, tail);
#pragma unroll
    for (int s = 0; s < SMAX; ++s) add_if(acc[s], gt, s, vt);
  }
  __shared__ Acc warp_part[kRegThreads / 32][SMAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    const Acc w = warp_sum(static_cast<Acc>(acc[s]));
    if (lane == 0) warp_part[warp][s] = w;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    Acc t = 0;
#pragma unroll
    for (int w = 0; w < kRegThreads / 32; ++w) t += warp_part[w][s];
    partials[static_cast<long long>(blockIdx.x) * slots + s] = t;
  }
  finish(partials, ticket, slots, out);
}

// One lane a thread into the warp's own copy of the slots: the lanes of
// one slot are summed by their lowest lane in lane order, which stores
// the slot. Every lane of the warp calls this.
template <typename Acc>
__device__ __forceinline__ void warp_add(Acc* mine, int g, Acc v, int slots,
                                         int lane) {
  const bool ok = static_cast<unsigned>(g) < static_cast<unsigned>(slots);
  if (!ok) g = -1;
  const unsigned peers = __match_any_sync(kFull, g);
  const int leader = __ffs(peers) - 1;
  unsigned rest = __ballot_sync(kFull, lane != leader);
  Acc sum = v;
  while (rest) {
    const int j = __ffs(rest) - 1;
    rest &= rest - 1;
    const Acc y = __shfl_sync(kFull, v, j);
    if (lane == leader && ((peers >> j) & 1u)) sum += y;
  }
  if (lane == leader && ok) mine[g] += sum;
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
slot_sum_smem(const long long* __restrict__ gid, const void* __restrict__ x,
              long long n, int slots, typename T::Acc* __restrict__ partials) {
  typedef typename T::Acc Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* copies = reinterpret_cast<Acc*>(smem);
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < warps * slots; i += blockDim.x) copies[i] = 0;
  __syncthreads();
  Acc* mine = copies + warp * slots;
  const long long nvec = n / T::kLanes;
  const long long span = static_cast<long long>(blockDim.x) * T::kUnits;
  // the loop's bound is the block's first vector, so a warp's lanes
  // stay together through the warp-wide steps
  for (long long first = blockIdx.x * span; first < nvec;
       first += gridDim.x * span) {
    int g[T::kUnits][T::kLanes];
    typename T::Lane v[T::kUnits][T::kLanes];
    load_step<T>(gid, x, nvec, first + threadIdx.x, blockDim.x, g, v);
#pragma unroll
    for (int u = 0; u < T::kUnits; ++u)
#pragma unroll
      for (int l = 0; l < T::kLanes; ++l)
        warp_add(mine, g[u][l], static_cast<Acc>(v[u][l]), slots, lane);
  }
  // the ragged tail, fewer lanes than a vector, in warp 0 of block 0
  if (blockIdx.x == 0 && warp == 0) {
    const long long tail = nvec * T::kLanes + lane;
    const bool in = tail < n;
    warp_add(mine, in ? static_cast<int>(gid[tail]) : -1,
             in ? static_cast<Acc>(T::one(x, tail)) : Acc(0), slots, lane);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    Acc t = 0;
    for (int w = 0; w < warps; ++w) t += copies[w * slots + s];
    partials[static_cast<long long>(blockIdx.x) * slots + s] = t;
  }
}

// The shared-memory kernel's partials, 32 slots a block.
template <typename Acc>
__global__ void __launch_bounds__(kMaxWarps * 32)
slot_sum_merge(const Acc* __restrict__ partials, int rows, int slots,
               Acc* __restrict__ out) {
  merge_rows(partials, rows, slots, static_cast<int>(blockIdx.x) * 32, out);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

int grid_for(long long nvec, long long per_block, int max_blocks) {
  const long long want = ceil_div(nvec, per_block);
  if (want < 1) return 1;
  return want < max_blocks ? static_cast<int>(want) : max_blocks;
}

template <typename T, int SMAX>
void launch_regs(int blocks, cudaStream_t st, const long long* gid,
                 const void* x, long long n, int slots,
                 typename T::Acc* partials, unsigned* ticket,
                 typename T::Acc* out) {
  slot_sum_regs<T, SMAX><<<blocks, kRegThreads, 0, st>>>(
      gid, x, n, slots, partials, ticket, out);
}

template <typename T>
cudaError_t launch(const void* gid_v, const void* x, long long n, int slots,
                   void* out_v, void* scratch, int max_blocks,
                   cudaStream_t st) {
  typedef typename T::Acc Acc;
  const long long* gid = static_cast<const long long*>(gid_v);
  unsigned* ticket = static_cast<unsigned*>(scratch);
  Acc* partials = reinterpret_cast<Acc*>(static_cast<char*>(scratch) +
                                         kTicketBytes);
  Acc* out = static_cast<Acc*>(out_v);
  const long long nvec = n / T::kLanes;
  if (slots <= kRegSlots) {
    const cudaError_t err = cudaMemsetAsync(scratch, 0, kTicketBytes, st);
    if (err != cudaSuccess) return err;
    const int blocks =
        grid_for(nvec, static_cast<long long>(kRegThreads) * T::kUnits,
                 max_blocks);
    if (slots <= 1)
      launch_regs<T, 1>(blocks, st, gid, x, n, slots, partials, ticket, out);
    else if (slots <= 2)
      launch_regs<T, 2>(blocks, st, gid, x, n, slots, partials, ticket, out);
    else if (slots <= 4)
      launch_regs<T, 4>(blocks, st, gid, x, n, slots, partials, ticket, out);
    else if (slots <= 8)
      launch_regs<T, 8>(blocks, st, gid, x, n, slots, partials, ticket, out);
    else if (slots <= 16)
      launch_regs<T, 16>(blocks, st, gid, x, n, slots, partials, ticket,
                         out);
    else
      launch_regs<T, 32>(blocks, st, gid, x, n, slots, partials, ticket,
                         out);
    return cudaGetLastError();
  }
  int warps = kSmemBudget / (slots * static_cast<int>(sizeof(Acc)));
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int threads = 32 * warps;
  const size_t smem = static_cast<size_t>(warps) * slots * sizeof(Acc);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slot_sum_smem<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = grid_for(
      nvec, static_cast<long long>(threads) * T::kUnits, max_blocks);
  slot_sum_smem<T><<<blocks, threads, smem, st>>>(gid, x, n, slots,
                                                  partials);
  slot_sum_merge<Acc><<<static_cast<unsigned>(ceil_div(slots, 32)),
                        kMaxWarps * 32, 0, st>>>(partials, blocks, slots,
                                                 out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Slot sums of `x` (kind 0: float64, 1: int64, 2: bool) over `gid`, both
// n lanes and 16-byte aligned, into `out` (slots entries: float64 for
// kind 0, int64 otherwise). `scratch` holds 16 + max_blocks * slots * 8
// bytes (ops/slotsum.py sizes it); the launch uses at most `max_blocks`
// blocks. Launches on `stream`: up to 32 slots a 16-byte memset and one
// kernel, above that two kernels.
int slot_sum(int kind, const void* gid, const void* x, long long n,
             int slots, void* out, void* scratch, int max_blocks,
             void* stream) {
  if (slots < 1 || slots > kMaxSlots || n < 0 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case 0:
      err = launch<F64>(gid, x, n, slots, out, scratch, max_blocks, st);
      break;
    case 1:
      err = launch<I64>(gid, x, n, slots, out, scratch, max_blocks, st);
      break;
    case 2:
      err = launch<Bool>(gid, x, n, slots, out, scratch, max_blocks, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
