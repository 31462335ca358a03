// K2: fused grouped aggregation over dense group codes, for sm_90a.
//
// Replaces arrow_tpu/kernels/groupagg.py::_kernel (the pallas_call in
// _grouped_aggregate_impl) together with its helpers in
// kernels/groupminmax.py (_block_extreme, _merge, encode_order_planes)
// and the wrappers in kernels/segagg.py.  On the TPU the sums rode the
// MXU as 8-bit bf16 limb matmuls against a (rows x groups) one-hot with
// i32 carry planes, and min/max ran lexicographically over (hi, lo) i32
// order planes, because Mosaic is a 32-bit ISA.  Hopper has native
// 64-bit integers, so a SUM is a wrapping u64 atomicAdd (exact in any
// order, mod 2^64) and MIN/MAX are u64 atomicMin/atomicMax on 64-bit
// order keys.
//
// Bound: bytes of device memory.  Each row is read once (codes, then
// each slot's validity byte and value); the per-row work is a few
// shared-memory atomics.  The design keeps all per-group accumulators
// of a block in shared memory (G <= 1024 groups x 16 B per slot), walks
// the rows grid-stride with one block per resident slot, and merges
// each block's accumulators into global memory with atomics once at
// the end, so global atomic traffic is per block, not per row.
//
// Contract (matches the reference):
//   - rows whose code is outside [0, G) are skipped;
//   - sum slot: wrapping i64 SUM of the sign- or zero-extended value and
//     COUNT of valid rows; null rows add nothing; a slot with a null
//     value pointer only counts;
//   - min/max slot: MIN and MAX order keys over valid rows.  Keys:
//     signed ints bits ^ (1 << 63); unsigned as they are; f16/f32 the
//     IEEE totalOrder map on the f32 bits in the high word (f16 widens
//     exactly, NaN quieted as XLA's convert does); f64 the 64-bit map.
//   - the wrapper sets the global identities: 0 for sums and counts,
//     UINT64_MAX for min keys, 0 for max keys.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 64;
constexpr unsigned long long kSign = 1ull << 63;

enum Cls : long long { kUnsigned = 0, kSigned = 1, kFloat = 2 };

// One aggregate slot; the wrapper packs these as int64 quadruples.
struct SlotDesc {
  const void* values;                        // null: count-only slot
  const uint8_t* valid;                      // null: all rows valid
  long long width;                           // bytes: 1, 2, 4 or 8
  long long cls;                             // Cls
};

__device__ __forceinline__ unsigned long long load_bits(const void* p,
                                                        long long i,
                                                        long long width) {
  switch (width) {
    case 1: return static_cast<const uint8_t*>(p)[i];
    case 2: return static_cast<const uint16_t*>(p)[i];
    case 4: return static_cast<const uint32_t*>(p)[i];
    default: return static_cast<const uint64_t*>(p)[i];
  }
}

__device__ __forceinline__ unsigned long long extend(unsigned long long b,
                                                     long long width,
                                                     long long cls) {
  if (cls != kSigned || width == 8) return b;
  const int shift = 64 - 8 * (int)width;
  return (unsigned long long)((long long)(b << shift) >> shift);
}

// f16 bits -> f32 bits, exact; NaN gets the quiet bit like XLA's convert.
__device__ __forceinline__ uint32_t f16_to_f32_bits(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  const uint32_t exp = (h >> 10) & 0x1Fu;
  const uint32_t man = h & 0x3FFu;
  if (exp == 0x1Fu)
    return sign | 0x7F800000u | (man << 13) | (man ? 0x00400000u : 0u);
  if (exp == 0) {
    if (man == 0) return sign;
    const int p = 31 - __clz(man);           // leading bit, 0..9
    return sign | ((uint32_t)(p + 103) << 23) | ((man << (23 - p)) & 0x7FFFFFu);
  }
  return sign | ((exp + 112u) << 23) | (man << 13);
}

__device__ __forceinline__ unsigned long long order_key(unsigned long long b,
                                                        long long width,
                                                        long long cls) {
  if (cls == kUnsigned) return b;
  if (cls == kSigned) return extend(b, width, cls) ^ kSign;
  if (width == 8) return (b & kSign) ? ~b : (b | kSign);
  const uint32_t f = width == 2 ? f16_to_f32_bits((uint32_t)b) : (uint32_t)b;
  const uint32_t k = (f & 0x80000000u) ? ~f : (f | 0x80000000u);
  return (unsigned long long)k << 32;
}

__global__ void __launch_bounds__(kThreads)
groupagg_kernel(const int32_t* __restrict__ codes, long long n,
                int G, const SlotDesc* __restrict__ slots,
                int n_sum, int n_mm,
                unsigned long long* __restrict__ g_sum,
                unsigned long long* __restrict__ g_cnt,
                unsigned long long* __restrict__ g_min,
                unsigned long long* __restrict__ g_max) {
  extern __shared__ unsigned long long acc[];
  __shared__ SlotDesc s_slots[kMaxSlots];
  unsigned long long* s_sum = acc;
  unsigned long long* s_cnt = s_sum + (size_t)n_sum * G;
  unsigned long long* s_min = s_cnt + (size_t)n_sum * G;
  unsigned long long* s_max = s_min + (size_t)n_mm * G;

  for (int s = threadIdx.x; s < n_sum + n_mm; s += blockDim.x)
    s_slots[s] = slots[s];
  for (int j = threadIdx.x; j < 2 * n_sum * G; j += blockDim.x) s_sum[j] = 0;
  for (int j = threadIdx.x; j < n_mm * G; j += blockDim.x) {
    s_min[j] = ~0ull;
    s_max[j] = 0;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = codes[i];
    if ((unsigned)c >= (unsigned)G) continue;
    for (int s = 0; s < n_sum; ++s) {
      const SlotDesc& d = s_slots[s];
      if (d.valid && !d.valid[i]) continue;
      if (d.values)
        atomicAdd(&s_sum[s * G + c],
                  extend(load_bits(d.values, i, d.width), d.width, d.cls));
      atomicAdd(&s_cnt[s * G + c], 1ull);
    }
    for (int m = 0; m < n_mm; ++m) {
      const SlotDesc& d = s_slots[n_sum + m];
      if (d.valid && !d.valid[i]) continue;
      const unsigned long long key =
          order_key(load_bits(d.values, i, d.width), d.width, d.cls);
      atomicMin(&s_min[m * G + c], key);
      atomicMax(&s_max[m * G + c], key);
    }
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n_sum * G; j += blockDim.x) {
    if (s_sum[j]) atomicAdd(&g_sum[j], s_sum[j]);
    if (s_cnt[j]) atomicAdd(&g_cnt[j], s_cnt[j]);
  }
  for (int j = threadIdx.x; j < n_mm * G; j += blockDim.x) {
    if (s_min[j] != ~0ull) atomicMin(&g_min[j], s_min[j]);
    if (s_max[j] != 0) atomicMax(&g_max[j], s_max[j]);
  }
}

}  // namespace

extern "C" {

int atp_groupagg_max_slots() { return kMaxSlots; }

// codes: n int32; slots: n_sum + n_mm SlotDesc in device memory (sum
// slots first); g_sum, g_cnt: n_sum * G u64; g_min, g_max: n_mm * G u64,
// all preset to their identities.  Launches on `stream` of `device`;
// returns cudaGetLastError() (or the error of a set-up call).
int atp_groupagg(int device, const void* codes, long long n, int G,
                 const void* slots, int n_sum, int n_mm, void* g_sum,
                 void* g_cnt, void* g_min, void* g_max, void* stream) {
  const size_t smem = sizeof(unsigned long long) * 2 * (size_t)G *
                      (size_t)(n_sum + n_mm);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(groupagg_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, groupagg_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  const long long want = (n + kThreads - 1) / kThreads;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (want < grid) grid = want > 0 ? want : 1;
  groupagg_kernel<<<(unsigned)grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), n, G,
      static_cast<const SlotDesc*>(slots), n_sum, n_mm,
      static_cast<unsigned long long*>(g_sum),
      static_cast<unsigned long long*>(g_cnt),
      static_cast<unsigned long long*>(g_min),
      static_cast<unsigned long long*>(g_max));
  return (int)cudaGetLastError();
}

}  // extern "C"
