// Direct-address join probe: slot lookup, match count, validity and every
// payload column gathered in one pass over the probe lanes.
//
// Replaces: presto_tpu/ops/pallas_join.py _direct_probe_call, whose TPU
// kernel comes from _probe_kernel_factory: [8,128] tiles of probe slot
// codes resolved against VMEM-resident lo/cnt tables, one packed validity
// bit-plane and the payload split into int32 planes (_decompose /
// _reassemble), because no 64-bit array may cross pallas_call there.
//
// What it computes, per probe lane i (code -1 = no lookup):
//   cnt[i]  = code >= 0 ? cnt_table[code] : 0
//   hit     = cnt[i] > 0 and the build has rows; pos = lo_table[code] (the
//             first build row of the key's run in sorted build order)
//   vb[i]   = hit ? vbits[pos] : 0          (bit c = payload column c valid)
//   out_c[i] = hit ? payload_c[pos] : 0     for every payload column c
//
// Bound on the H100: memory. Every lane writes its count, validity word
// and payload row (49 bytes a lane at Q3's shape, 3/4 of the bound's
// bytes); live lanes add two table reads and matched lanes a gathered
// build row. The gathers are random where the probe keys are: the build
// payload and tables Q3 touches at TPC-H SF1 (~45 MB) only just fit the
// 50 MB L2, so every gather that misses costs a DRAM burst for its 1-16
// bytes. Where the keys come clustered, as lineitem's order keys do, the
// gathers hit L2 and the writes set the time.
//
// Design for Hopper:
// - The launch's arguments, payload descriptors included, travel by value
//   in the kernel's parameter space (__grid_constant__ ProbeArgs, at most
//   31 columns): no host-to-device copy per call, and the descriptors are
//   read as uniform constant loads, not from a device array per lane.
// - Each thread takes 4 consecutive lanes: one 16-byte load of codes, then
//   the lo and cnt entries of all 4 lanes at once (8 independent loads:
//   one round trip where a lane used to take two).
// - Every gather of the block's lanes is issued before any store: the
//   validity words into registers, the payload rows as cp.async copies of
//   4, 8 or 16 bytes straight into a shared-memory staging tile laid out
//   [column][lane] (unmatched lanes zero-fill their slot without reading
//   device memory), 1-byte columns as byte loads packed into the tile.
//   One wait, one barrier, then the block writes each column's contiguous
//   slice from the tile with 16-byte stores, a warp covering 512
//   consecutive bytes (one store instruction per 16 bytes, whatever the
//   column's width). Columns are staged in passes of at most
//   kStageLaneBytes bytes a lane: one pass for a payload of up to 48
//   bytes a row (Q3's is 41).
// - The streamed data, codes in and every output, is read and written
//   evict-first (ld/st .cs), so that the 400 MB of outputs at Q3's shape do
//   not push the tables and build payload out of L2 while they are being
//   gathered.
// - A warp with no matched lane skips every gather and zero-fills its
//   slots.
// Validity stays one int32 bit-plane of at most 31 columns per launch; the
// Python wrapper launches once per group of 31 payload columns, so a join
// has no column limit.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 31;
constexpr int kThreads = 256;
constexpr int kLanesPerThread = 4;
constexpr int kLanes = kThreads * kLanesPerThread;  // lanes a block
constexpr int kStageLaneBytes = 48;  // staging tile = 48 KB a block at most
constexpr unsigned kFull = 0xffffffffu;

struct ColDesc {
  const void* src;
  void* dst;
  long long width;  // bytes per element: 1, 4, 8 or 16
};

// The launch's arguments, passed by value. ops/probe.py mirrors this
// layout as a ctypes Structure; tests/test_torch_probe.py holds the two
// against the constants asserted here.
struct ProbeArgs {
  const int* codes;
  long long n;
  const int* lo_table;
  const int* cnt_table;
  const int* vbits;
  long long n_build;
  int* cnt_out;
  int* vb_out;
  int ncols;
  ColDesc cols[kMaxCols];
};

static_assert(sizeof(ColDesc) == 24, "ColDesc layout");
static_assert(sizeof(ProbeArgs) == 816, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, codes) == 0, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, n) == 8, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, lo_table) == 16, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, cnt_table) == 24, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, vbits) == 32, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, n_build) == 40, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, cnt_out) == 48, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, vb_out) == 56, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, ncols) == 64, "ProbeArgs layout");
static_assert(offsetof(ProbeArgs, cols) == 72, "ProbeArgs layout");

// Columns [c0, return value) form one staging pass; *bytes is their width
// sum, the pass's staging bytes a lane.
__host__ __device__ inline int pass_end(const ProbeArgs& a, int c0,
                                        int* bytes) {
  int c1 = c0, b = 0;
  while (c1 < a.ncols && b + (int)a.cols[c1].width <= kStageLaneBytes)
    b += (int)a.cols[c1++].width;
  *bytes = b;
  return c1;
}

// Asynchronous copy of W bytes from device to shared memory; with `pred`
// false the slot is zero-filled and device memory is not read.
template <int W>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = pred ? W : 0;
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(W), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Gathers column `d` of the thread's 4 lanes into its staging slot.
template <int W>
__device__ __forceinline__ void gather4(unsigned char* slot,
                                        const ColDesc& d,
                                        const long long* pos,
                                        const bool* hit) {
  const unsigned char* src = (const unsigned char*)d.src;
  if constexpr (W == 1) {
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k)
      if (hit[k]) packed |= (uint32_t)__ldg(src + pos[k]) << (8 * k);
    *(uint32_t*)slot = packed;
  } else {
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k)
      cp_async<W>(slot + k * W, hit[k] ? src + pos[k] * W : src, hit[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
direct_probe_kernel(const __grid_constant__ ProbeArgs a) {
  extern __shared__ __align__(16) unsigned char stage[];
  const long long base = (long long)blockIdx.x * kLanes;
  const long long l0 = base + (long long)threadIdx.x * kLanesPerThread;
  const bool full = l0 + kLanesPerThread <= a.n;
  int code[kLanesPerThread];
  if (full) {
    const int4 c = __ldcs((const int4*)(a.codes + l0));
    code[0] = c.x; code[1] = c.y; code[2] = c.z; code[3] = c.w;
  } else {
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k)
      code[k] = l0 + k < a.n ? __ldcs(a.codes + l0 + k) : -1;
  }
  int cnt[kLanesPerThread], lo[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    const bool live = code[k] >= 0;
    cnt[k] = live ? __ldg(a.cnt_table + code[k]) : 0;
    lo[k] = live ? __ldg(a.lo_table + code[k]) : 0;
  }
  bool hit[kLanesPerThread], any = false;
  long long pos[kLanesPerThread];
  int vb[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) {
    hit[k] = cnt[k] > 0 && a.n_build > 0;
    pos[k] = hit[k] ? lo[k] : 0;
    any |= hit[k];
  }
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k)
    vb[k] = hit[k] ? __ldg(a.vbits + pos[k]) : 0;
  const bool warp_hits = __any_sync(kFull, any);
  const long long left = a.n - base;
  const int lanes = left < kLanes ? (int)left : kLanes;

  for (int c0 = 0; c0 < a.ncols;) {
    int lane_bytes;
    const int c1 = pass_end(a, c0, &lane_bytes);
    // every gather of the pass into the tile; a warp without a match
    // zero-fills its slots instead
    int off = 0;
    for (int c = c0; c < c1; ++c) {
      const ColDesc& d = a.cols[c];
      const int w = (int)d.width;
      unsigned char* slot =
          stage + off * kLanes + threadIdx.x * kLanesPerThread * w;
      if (warp_hits) {
        switch (w) {
          case 1: gather4<1>(slot, d, pos, hit); break;
          case 4: gather4<4>(slot, d, pos, hit); break;
          case 8: gather4<8>(slot, d, pos, hit); break;
          default: gather4<16>(slot, d, pos, hit);
        }
      } else {
        for (int j = 0; j < kLanesPerThread * w; j += 4)
          *(uint32_t*)(slot + j) = 0u;
      }
      off += w;
    }
    if (warp_hits) cp_async_wait_all();
    __syncthreads();
    // the block writes each column's slice of `lanes` elements: 16 bytes a
    // thread, consecutive threads on consecutive addresses, evict-first
    off = 0;
    for (int c = c0; c < c1; ++c) {
      const ColDesc& d = a.cols[c];
      const int w = (int)d.width;
      const unsigned char* tile = stage + off * kLanes;
      unsigned char* dst = (unsigned char*)d.dst + base * w;
      const int bytes = lanes * w;
      const int vecs = bytes / 16;
      for (int i = threadIdx.x; i < vecs; i += kThreads)
        __stcs((uint4*)dst + i, ((const uint4*)tile)[i]);
      for (int i = vecs * 16 + threadIdx.x; i < bytes; i += kThreads)
        dst[i] = tile[i];
      off += w;
    }
    c0 = c1;
    // the next pass lays the tile out anew
    if (c0 < a.ncols) __syncthreads();
  }

  if (full) {
    __stcs((int4*)(a.cnt_out + l0), make_int4(cnt[0], cnt[1], cnt[2], cnt[3]));
    __stcs((int4*)(a.vb_out + l0), make_int4(vb[0], vb[1], vb[2], vb[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      if (l0 + k < a.n) {
        a.cnt_out[l0 + k] = cnt[k];
        a.vb_out[l0 + k] = vb[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// `host_args` points at a ProbeArgs in host memory; its bytes are copied
// into the launch. The codes, the payload columns and every output must
// start on a 16-byte boundary, and every payload width be 1, 4, 8 or 16
// (ops/probe.py ensures both). (A void pointer: a parameter of a type
// local to this file would hide the symbol.)
int direct_probe(const void* host_args, void* stream) {
  const ProbeArgs* args = (const ProbeArgs*)host_args;
  if (args->ncols < 0 || args->ncols > kMaxCols)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < args->ncols; ++c) {
    const long long w = args->cols[c].width;
    if (w != 1 && w != 4 && w != 8 && w != 16)
      return (int)cudaErrorInvalidValue;
  }
  if (args->n <= 0) return (int)cudaGetLastError();
  int smem = 0;
  for (int c0 = 0, bytes = 0; c0 < args->ncols;) {
    c0 = pass_end(*args, c0, &bytes);
    smem = bytes * kLanes > smem ? bytes * kLanes : smem;
  }
  const long long blocks = (args->n + kLanes - 1) / kLanes;
  direct_probe_kernel<<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
