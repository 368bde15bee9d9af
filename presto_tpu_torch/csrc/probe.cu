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
//   hit     = cnt[i] > 0, pos = lo_table[code] (the first build row of the
//             key's run in sorted build order)
//   vb[i]   = hit ? vbits[pos] : 0          (bit c = payload column c valid)
//   out_c[i] = hit ? payload_c[pos] : 0     for every payload column c
//
// Bound on the H100: memory, and latency of dependent random reads. Per
// lane it reads a 4-byte code, then on live lanes two 4-byte table entries
// and then the payload row (a chain of two dependent gathers), and writes
// the outputs. The lookup tables (8 bytes a slot: 48 MB for the 6 M-slot
// orders table of TPC-H SF1) and the build payload are read through the
// 50 MB L2 cache.
//
// Design: one thread per probe lane does the whole chain, so there is no
// intermediate array in device memory and each lane's code is read once.
// Hopper loads 1, 4, 8 and 16 bytes natively, so each payload column is
// gathered at its own width from a small device array of (source,
// destination, width) descriptors: no 64-bit or int128 plane split, and no
// VMEM budget gate, since nothing has to be resident on chip. Consecutive
// threads write consecutive output elements, so stores coalesce; the
// gathers are as scattered as the probe keys. Validity stays one int32
// bit-plane of at most 31 columns per launch; the Python wrapper launches
// once per group of 31 payload columns, so a join has no column limit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ColDesc {
  const void* src;
  void* dst;
  long long width;  // bytes per element: 1, 4, 8 or 16
};

__global__ void direct_probe_kernel(const int* __restrict__ codes,
                                    long long n,
                                    const int* __restrict__ lo_table,
                                    const int* __restrict__ cnt_table,
                                    const int* __restrict__ vbits,
                                    const ColDesc* __restrict__ cols,
                                    int ncols, int* __restrict__ cnt_out,
                                    int* __restrict__ vb_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int code = codes[i];
  int cnt = 0;
  long long pos = 0;
  if (code >= 0) {
    cnt = cnt_table[code];
    if (cnt > 0) pos = lo_table[code];
  }
  const bool hit = cnt > 0;
  cnt_out[i] = cnt;
  vb_out[i] = hit ? vbits[pos] : 0;
  for (int c = 0; c < ncols; ++c) {
    const ColDesc d = cols[c];
    switch (d.width) {
      case 1:
        ((uint8_t*)d.dst)[i] = hit ? ((const uint8_t*)d.src)[pos] : 0;
        break;
      case 4:
        ((uint32_t*)d.dst)[i] = hit ? ((const uint32_t*)d.src)[pos] : 0u;
        break;
      case 8:
        ((unsigned long long*)d.dst)[i] =
            hit ? ((const unsigned long long*)d.src)[pos] : 0ull;
        break;
      default: {  // 16: an int128 value as two 64-bit limbs
        ulonglong2 v = make_ulonglong2(0ull, 0ull);
        if (hit) v = ((const ulonglong2*)d.src)[pos];
        ((ulonglong2*)d.dst)[i] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// `cols` is a device array of ncols (src, dst, width) descriptors laid out
// as three int64 each.
int direct_probe(const void* codes, long long n, const void* lo_table,
                 const void* cnt_table, const void* vbits, const void* cols,
                 int ncols, void* cnt_out, void* vb_out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  direct_probe_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)codes, n, (const int*)lo_table, (const int*)cnt_table,
      (const int*)vbits, (const ColDesc*)cols, ncols, (int*)cnt_out,
      (int*)vb_out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
