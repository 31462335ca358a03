// K2: fused grouped aggregation over dense group codes, for sm_90a.
//
// Replaces arrow_tpu/kernels/groupagg.py::_kernel (the pallas_call in
// _grouped_aggregate_impl) together with its helpers in
// kernels/groupminmax.py (_block_extreme, _merge, encode_order_planes)
// and the wrappers in kernels/segagg.py.  On the TPU the sums rode the
// MXU as 8-bit bf16 limb matmuls against a (rows x groups) one-hot with
// i32 carry planes, and min/max ran lexicographically over (hi, lo) i32
// order planes, because Mosaic is a 32-bit ISA.  Here a SUM wraps mod
// 2^64 and MIN/MAX are taken on order keys, with shared-memory atomics.
//
// Bound: bytes of device memory.  Each row's key and each slot's value
// and validity byte are read once; the per-row work is a few
// shared-memory operations.  The design:
//   - Codes come straight from the key column at its own width (1, 2, 4
//     or 8 bytes): code = key - base (mod 2^64); a null key takes the last
//     code G - 1; codes outside [0, G) are dropped.  No digit pass runs
//     before the kernel.
//   - A block walks tiles of kTile rows.  Each thread holds kRows rows in
//     registers, kChunks chunks of 4 consecutive rows, each loaded as one
//     vector (16 bytes at most) per input.
//   - Slots are walked outside the rows: one switch per slot and tile
//     picks a handler compiled for the slot's width and class.
//   - Accumulators live in shared memory, G entries per array.  Counts
//     are u32 (the launch keeps a block's rows below 2^32).  A sum is a
//     u32 low word whose atomicAdd returns the old value, so the carry
//     into a u32 high word is exact mod 2^64.  Min/max keys are u32 for
//     types of 4 bytes or fewer and u64 above; a row issues the atomic
//     only when its key improves the value it reads first, so once a
//     group's extreme has settled a row costs a shared load.
//   - One shared COUNT of in-range rows serves every slot without
//     validity.
//   - When the accumulators are small (G x slots), each warp group gets
//     its own copy, so hot groups do not serialise a block.
//   - Each block merges its accumulators into u64 global memory with
//     atomics once, at the end.
// In the SASS (cuobjdump, sm_90a) the u32 atomics are native ATOMS.ADD,
// ATOMS.POPC.INC, ATOMS.MIN and ATOMS.MAX; the u64 min/max are
// ATOMS.CAST.SPIN.64 compare-and-swap loops, which the filter keeps rare.
//
// Contract (matches the reference):
//   - sum slot: wrapping i64 SUM of the sign- or zero-extended value over
//     valid rows, and optionally their COUNT; a slot with a null value
//     pointer only counts;
//   - min/max slot: MIN and MAX order keys over valid rows.  Keys:
//     signed ints bits ^ (1 << 63); unsigned as they are; f16/f32 the
//     IEEE totalOrder map on the f32 bits in the high word (f16 widens
//     exactly, NaN quieted as XLA's convert does); f64 the 64-bit map.
//   - the wrapper sets the global identities: 0 for sums and counts,
//     UINT64_MAX for min keys, 0 for max keys.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 2;                   // chunks of 4 rows a thread
constexpr int kRows = 4 * kChunks;           // rows a thread holds
constexpr int kChunkRows = 4 * kThreads;     // rows of one chunk of a block
constexpr int kTile = kRows * kThreads;      // 2,048 rows
constexpr int kMaxSlots = 64;
constexpr int kMaxCopies = 8;                // one per warp of the block
constexpr int kCopyBudget = 48 * 1024;       // bytes of shared memory
constexpr int kSmemLimit = 227 * 1024;
constexpr unsigned long long kSign = 1ull << 63;

enum Cls : int { kUnsigned = 0, kSigned = 1, kFloat = 2 };
enum Kind : int { kSum = 0, kMinMax = 1 };

// One aggregate slot.  `acc` and `cnt` are u32-word offsets inside one
// copy of the accumulators; `out_a` / `out_b` are u64 offsets of the
// global results (sum and count, or min and max keys), -1 for none.
struct Slot {
  const void* values;                        // null: count-only slot
  const uint8_t* valid;                      // null: all rows valid
  int kind, width, cls;
  int acc, cnt;
  int out_a, out_b;
};

struct Params {
  const void* key;
  const uint8_t* key_valid;                  // null: no null keys
  unsigned long long* out;
  long long base, n, cnt_all_out;
  int key_width, key_signed, G, nslots, copies, copy_words, cnt_all;
  int aligned;                               // every input takes vectors
  Slot slots[kMaxSlots];
};

// ---- loads: 4 consecutive rows from `row` (a multiple of 4) -------------

template <int W>
__device__ __forceinline__ void load4(const void* p, long long row,
                                      bool vec, long long n,
                                      unsigned long long (&v)[4]) {
  if (vec) {
    if constexpr (W == 8) {
      const uint4* q = reinterpret_cast<const uint4*>(
          static_cast<const uint64_t*>(p) + row);
      const uint4 a = __ldg(q), b = __ldg(q + 1);
      v[0] = a.x | (unsigned long long)a.y << 32;
      v[1] = a.z | (unsigned long long)a.w << 32;
      v[2] = b.x | (unsigned long long)b.y << 32;
      v[3] = b.z | (unsigned long long)b.w << 32;
    } else if constexpr (W == 4) {
      const uint4 a =
          __ldg(reinterpret_cast<const uint4*>(
              static_cast<const uint32_t*>(p) + row));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else if constexpr (W == 2) {
      const uint2 a =
          __ldg(reinterpret_cast<const uint2*>(
              static_cast<const uint16_t*>(p) + row));
      v[0] = a.x & 0xFFFFu; v[1] = a.x >> 16;
      v[2] = a.y & 0xFFFFu; v[3] = a.y >> 16;
    } else {
      const unsigned a = __ldg(reinterpret_cast<const unsigned*>(
          static_cast<const uint8_t*>(p) + row));
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (a >> (8 * j)) & 0xFFu;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = 0;
    if (row + j < n) {
      if constexpr (W == 8) v[j] = static_cast<const uint64_t*>(p)[row + j];
      if constexpr (W == 4) v[j] = static_cast<const uint32_t*>(p)[row + j];
      if constexpr (W == 2) v[j] = static_cast<const uint16_t*>(p)[row + j];
      if constexpr (W == 1) v[j] = static_cast<const uint8_t*>(p)[row + j];
    }
  }
}

// Validity bytes of 4 rows, byte j for row + j (1 where there is none).
__device__ __forceinline__ unsigned load_valid4(const uint8_t* p,
                                                long long row, bool vec,
                                                long long n) {
  if (p == nullptr) return 0x01010101u;
  if (vec) return __ldg(reinterpret_cast<const unsigned*>(p + row));
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (row + j < n && p[row + j]) v |= 1u << (8 * j);
  return v;
}

template <int W, bool SIGNED>
__device__ __forceinline__ unsigned long long extend(unsigned long long b) {
  if constexpr (!SIGNED || W == 8) {
    return b;
  } else {
    constexpr int shift = 64 - 8 * W;
    return (unsigned long long)((long long)(b << shift) >> shift);
  }
}

__device__ __forceinline__ long long chunk_row(const long long row0, int q) {
  return row0 + (long long)q * kChunkRows;
}

template <int W, bool SIGNED>
__device__ __forceinline__ void load_codes(const Params& p, long long row0,
                                           bool vec, int (&code)[kRows]) {
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const long long row = chunk_row(row0, q);
    unsigned long long k[4];
    load4<W>(p.key, row, vec, p.n, k);
    const unsigned valid = load_valid4(p.key_valid, row, vec, p.n);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned long long d =
          extend<W, SIGNED>(k[j]) - (unsigned long long)p.base;
      int c = d < (unsigned long long)p.G ? (int)d : -1;
      if (!((valid >> (8 * j)) & 0xFFu)) c = p.G - 1;
      code[4 * q + j] = row + j < p.n ? c : -1;
    }
  }
}

// ---- order keys ----------------------------------------------------------

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
    return sign | ((uint32_t)(p + 103) << 23) |
           ((man << (23 - p)) & 0x7FFFFFu);
  }
  return sign | ((exp + 112u) << 23) | (man << 13);
}

// 32-bit order key of a value of 4 bytes or fewer.
template <int W, int CLS>
__device__ __forceinline__ uint32_t key32(unsigned long long b) {
  if constexpr (CLS == kUnsigned) {
    return (uint32_t)b;
  } else if constexpr (CLS == kSigned) {
    return (uint32_t)extend<W, true>(b) ^ 0x80000000u;
  } else {
    const uint32_t f = W == 2 ? f16_to_f32_bits((uint32_t)b) : (uint32_t)b;
    return (f & 0x80000000u) ? ~f : (f | 0x80000000u);
  }
}

// The u64 order key (the reference's) of a 32-bit one.
__device__ __forceinline__ unsigned long long widen_key(uint32_t k,
                                                        int cls) {
  if (cls == kUnsigned) return k;
  if (cls == kSigned)
    return (unsigned long long)(long long)(int32_t)(k ^ 0x80000000u) ^ kSign;
  return (unsigned long long)k << 32;
}

template <int CLS>
__device__ __forceinline__ unsigned long long key64(unsigned long long b) {
  if constexpr (CLS == kUnsigned) return b;
  if constexpr (CLS == kSigned) return b ^ kSign;
  return (b & kSign) ? ~b : (b | kSign);
}

// ---- slot handlers -------------------------------------------------------

template <int W, bool SIGNED>
__device__ __forceinline__ void sum_slot(const Params& p, const Slot& d,
                                         uint32_t* acc, long long row0,
                                         bool vec, const int (&code)[kRows]) {
  uint32_t* lo = acc + d.acc;
  uint32_t* hi = lo + p.G;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const long long row = chunk_row(row0, q);
    const unsigned valid = load_valid4(d.valid, row, vec, p.n);
    unsigned long long v[4] = {0, 0, 0, 0};
    if (d.values != nullptr) load4<W>(d.values, row, vec, p.n, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = code[4 * q + j];
      if (c < 0 || !((valid >> (8 * j)) & 0xFFu)) continue;
      if (d.values != nullptr) {
        const unsigned long long x = extend<W, SIGNED>(v[j]);
        const uint32_t xl = (uint32_t)x;
        const uint32_t old = atomicAdd(lo + c, xl);
        const uint32_t carry = old + xl < old ? 1u : 0u;
        const uint32_t xh = (uint32_t)(x >> 32) + carry;
        if (xh) atomicAdd(hi + c, xh);
      }
      if (d.cnt >= 0) atomicAdd(acc + d.cnt + c, 1u);
    }
  }
}

// A row issues an atomic only where its key improves the extreme it
// reads first; once a group's extreme has settled, a row costs a load.
template <int W, int CLS>
__device__ __forceinline__ void minmax_slot(const Params& p, const Slot& d,
                                            uint32_t* acc, long long row0,
                                            bool vec,
                                            const int (&code)[kRows]) {
  using Key = typename std::conditional<W == 8, unsigned long long,
                                        uint32_t>::type;
  Key* mn = reinterpret_cast<Key*>(acc + d.acc);
  Key* mx = mn + p.G;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const long long row = chunk_row(row0, q);
    const unsigned valid = load_valid4(d.valid, row, vec, p.n);
    unsigned long long v[4];
    load4<W>(d.values, row, vec, p.n, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = code[4 * q + j];
      if (c < 0 || !((valid >> (8 * j)) & 0xFFu)) continue;
      Key k;
      if constexpr (W == 8)
        k = key64<CLS>(v[j]);
      else
        k = key32<W, CLS>(v[j]);
      if (k < *reinterpret_cast<volatile Key*>(mn + c)) atomicMin(mn + c, k);
      if (k > *reinterpret_cast<volatile Key*>(mx + c)) atomicMax(mx + c, k);
    }
  }
}

template <int W>
__device__ __forceinline__ void minmax_dispatch(const Params& p,
                                                const Slot& d, uint32_t* acc,
                                                long long row0, bool vec,
                                                const int (&code)[kRows]) {
  if (d.cls == kSigned) {
    minmax_slot<W, kSigned>(p, d, acc, row0, vec, code);
  } else if (d.cls == kFloat && W >= 2) {
    minmax_slot<W, kFloat>(p, d, acc, row0, vec, code);
  } else {
    minmax_slot<W, kUnsigned>(p, d, acc, row0, vec, code);
  }
}

template <int W>
__device__ __forceinline__ void sum_dispatch(const Params& p, const Slot& d,
                                             uint32_t* acc, long long row0,
                                             bool vec,
                                             const int (&code)[kRows]) {
  if (d.cls == kSigned)
    sum_slot<W, true>(p, d, acc, row0, vec, code);
  else
    sum_slot<W, false>(p, d, acc, row0, vec, code);
}

__device__ __forceinline__ void run_slot(const Params& p, const Slot& d,
                                         uint32_t* acc, long long row0,
                                         bool vec, const int (&code)[kRows]) {
  if (d.kind == kSum) {
    switch (d.width) {
      case 1: sum_dispatch<1>(p, d, acc, row0, vec, code); break;
      case 2: sum_dispatch<2>(p, d, acc, row0, vec, code); break;
      case 4: sum_dispatch<4>(p, d, acc, row0, vec, code); break;
      default: sum_dispatch<8>(p, d, acc, row0, vec, code); break;
    }
  } else {
    switch (d.width) {
      case 1: minmax_dispatch<1>(p, d, acc, row0, vec, code); break;
      case 2: minmax_dispatch<2>(p, d, acc, row0, vec, code); break;
      case 4: minmax_dispatch<4>(p, d, acc, row0, vec, code); break;
      default: minmax_dispatch<8>(p, d, acc, row0, vec, code); break;
    }
  }
}

__device__ __forceinline__ void load_key(const Params& p, long long row0,
                                         bool vec, int (&code)[kRows]) {
  const bool s = p.key_signed;
  switch (p.key_width) {
    case 1:
      s ? load_codes<1, true>(p, row0, vec, code)
        : load_codes<1, false>(p, row0, vec, code);
      break;
    case 2:
      s ? load_codes<2, true>(p, row0, vec, code)
        : load_codes<2, false>(p, row0, vec, code);
      break;
    case 4:
      s ? load_codes<4, true>(p, row0, vec, code)
        : load_codes<4, false>(p, row0, vec, code);
      break;
    default:
      load_codes<8, false>(p, row0, vec, code);
      break;
  }
}

// ---- the kernel ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
groupagg_kernel(const Params p) {
  extern __shared__ unsigned long long smem64[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem64);
  const int G = p.G;
  const int words = p.copies * p.copy_words;
  for (int w = threadIdx.x; w < words; w += kThreads) smem[w] = 0;
  __syncthreads();
  for (int s = 0; s < p.nslots; ++s) {       // min identities: all ones
    const Slot d = p.slots[s];
    if (d.kind != kMinMax) continue;
    const int span = d.width == 8 ? 2 * G : G;
    for (int w = threadIdx.x; w < p.copies * span; w += kThreads)
      smem[(w / span) * p.copy_words + d.acc + w % span] = ~0u;
  }
  __syncthreads();

  uint32_t* acc = smem + ((threadIdx.x >> 5) % p.copies) * p.copy_words;
  const long long ntiles = (p.n + kTile - 1) / kTile;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row0 = t * kTile + 4LL * threadIdx.x;
    const bool vec = p.aligned && (t + 1) * kTile <= p.n;
    int code[kRows];
    load_key(p, row0, vec, code);
    if (p.cnt_all >= 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (code[r] >= 0) atomicAdd(acc + p.cnt_all + code[r], 1u);
    }
    for (int s = 0; s < p.nslots; ++s) {
      const Slot d = p.slots[s];
      run_slot(p, d, acc, row0, vec, code);
    }
  }
  __syncthreads();

  // merge the copies, then the block, into the global results
  const int cw = p.copy_words;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    if (p.cnt_all >= 0) {
      unsigned long long c = 0;
      for (int k = 0; k < p.copies; ++k) c += smem[k * cw + p.cnt_all + g];
      if (c) atomicAdd(p.out + p.cnt_all_out + g, c);
    }
    for (int s = 0; s < p.nslots; ++s) {
      const Slot d = p.slots[s];
      if (d.kind == kSum) {
        if (d.values != nullptr) {
          unsigned long long sum = 0;
          for (int k = 0; k < p.copies; ++k) {
            const uint32_t* a = smem + k * cw + d.acc;
            sum += (unsigned long long)a[G + g] << 32 | a[g];
          }
          if (sum) atomicAdd(p.out + d.out_a + g, sum);
        }
        if (d.cnt >= 0) {
          unsigned long long c = 0;
          for (int k = 0; k < p.copies; ++k) c += smem[k * cw + d.cnt + g];
          if (c) atomicAdd(p.out + d.out_b + g, c);
        }
      } else if (d.width == 8) {
        unsigned long long mn = ~0ull, mx = 0;
        for (int k = 0; k < p.copies; ++k) {
          const auto* a = reinterpret_cast<const unsigned long long*>(
              smem + k * cw + d.acc);
          mn = min(mn, a[g]);
          mx = max(mx, a[G + g]);
        }
        if (mn <= mx) {                      // the group has a valid row
          atomicMin(p.out + d.out_a + g, mn);
          atomicMax(p.out + d.out_b + g, mx);
        }
      } else {
        uint32_t mn = ~0u, mx = 0;
        for (int k = 0; k < p.copies; ++k) {
          const uint32_t* a = smem + k * cw + d.acc;
          mn = min(mn, a[g]);
          mx = max(mx, a[G + g]);
        }
        if (mn <= mx) {
          atomicMin(p.out + d.out_a + g, widen_key(mn, d.cls));
          atomicMax(p.out + d.out_b + g, widen_key(mx, d.cls));
        }
      }
    }
  }
}

// Whether 4 rows of `width` bytes from any row that is a multiple of 4
// load as one vector (null pointers load nothing).
bool vector_ready(const void* p, int width) {
  const uintptr_t bytes = width >= 4 ? 16 : 4 * (uintptr_t)width;
  return bytes == 0 || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

int atp_groupagg_max_slots() { return kMaxSlots; }

int atp_groupagg_smem_limit() { return kSmemLimit; }

// key: n values of key_width bytes (signed or not), key_valid: n bool or
// null; a row's code is key - base (mod 2^64), G - 1 for a null key.
// slots: nslots rows of 7 int64 in HOST memory, read before this
// returns: (values, valid, kind, width, cls, out_a, out_b) -- a sum slot
// (kind 0) puts its sum at out_a (-1: count only) and its count of valid
// rows at out_b (-1: none); a min/max slot (kind 1) its keys at out_a and
// out_b.  cnt_all_out: where the count of in-range rows goes, -1 for
// none.  out: u64 results, preset to their identities; offsets are in
// u64 units, each a run of G.  Launches on `stream` of `device`; returns
// cudaGetLastError() (or the error of a set-up call).
int atp_groupagg(int device, const void* key, const void* key_valid,
                 long long base, int key_width, int key_signed, long long n,
                 int G, const long long* slots, int nslots,
                 long long cnt_all_out, void* out, void* stream) {
  if (G <= 0 || nslots < 0 || nslots > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.key = key;
  p.key_valid = static_cast<const uint8_t*>(key_valid);
  p.out = static_cast<unsigned long long*>(out);
  p.base = base;
  p.n = n;
  p.key_width = key_width;
  p.key_signed = key_signed;
  p.G = G;
  p.nslots = nslots;
  p.cnt_all_out = cnt_all_out;
  bool aligned = vector_ready(key, key_width) && vector_ready(key_valid, 1);
  // u64 arrays first (min/max of 8-byte keys), so every one is 8-aligned
  int words = 0;
  for (int s = 0; s < nslots; ++s) {
    const long long* r = slots + 7 * s;
    Slot& d = p.slots[s];
    d.values = reinterpret_cast<const void*>(r[0]);
    d.valid = reinterpret_cast<const uint8_t*>(r[1]);
    d.kind = (int)r[2];
    d.width = (int)r[3];
    d.cls = (int)r[4];
    d.out_a = (int)r[5];
    d.out_b = (int)r[6];
    d.cnt = -1;
    aligned = aligned && vector_ready(d.values, d.width) &&
              vector_ready(d.valid, 1);
    if (d.kind == kMinMax && d.width == 8) {
      d.acc = words;
      words += 4 * G;
    }
  }
  if (cnt_all_out >= 0) {
    p.cnt_all = words;
    words += G;
  } else {
    p.cnt_all = -1;
  }
  for (int s = 0; s < nslots; ++s) {
    Slot& d = p.slots[s];
    if (d.kind == kMinMax) {
      if (d.width != 8) {
        d.acc = words;
        words += 2 * G;
      }
    } else {
      if (d.values != nullptr) {
        d.acc = words;
        words += 2 * G;
      }
      if (d.out_b >= 0) {
        d.cnt = words;
        words += G;
      }
    }
  }
  words += words & 1;                        // copies stay 8-aligned
  const long long copy_bytes = 4LL * words;
  if (copy_bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  int copies = 1;
  while (copies < kMaxCopies && 2 * copies * copy_bytes <= kCopyBudget)
    copies *= 2;
  p.copies = copies;
  p.copy_words = words;
  p.aligned = aligned;
  const size_t smem = (size_t)(copies * copy_bytes > 0 ? copies * copy_bytes
                                                       : 8);

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
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
  const long long ntiles = (n + kTile - 1) / kTile;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  // u32 counts stay exact: no block takes 2^31 rows or more
  const long long least = (ntiles * kTile >> 31) + 1;
  if (grid < least) grid = least;
  if (grid > ntiles) grid = ntiles;
  groupagg_kernel<<<(unsigned)grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
