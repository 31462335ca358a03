// K1: order-preserving stream compaction of a batch of columns by one
// keep mask, for sm_90a.
//
// Replaces arrow_tpu/kernels/compact.py::_kernel (the pallas_call in
// _compact_impl).  That kernel built each 256-row permutation as a
// triangular prefix-sum matmul on the MXU, moved the data as exact bf16
// byte limbs of u32 planes, and carried its running write offset in
// SMEM from one sequential grid step to the next.  Hopper blocks run in
// no order, so the offset becomes a cross-block scan, and the data moves
// at its native width (1, 2, 4 or 8 bytes), f64 and f16 included.
//
// Bound: bytes of device memory.  The mask is read once, each kept row
// of each column is read once and written once, and the optional
// positions output (the kept rows' indices) is computed, never read.
// There is no arithmetic to speak of.  One kernel, one pass:
//   - A tile is kParts parts of kThreads x kItems rows.  Each thread owns
//     kItems consecutive rows of each part and loads their mask bytes as
//     16-byte vectors, every part's at once; it counts its kept rows
//     with __popcll on the packed bits.
//   - One block scan (warp shuffles, one barrier) of the parts' counts,
//     packed as 16-bit fields, gives each thread its offset in each part.
//   - The tile's global offset comes from a decoupled look-back over tile
//     status words in global memory (flag and count in one 64-bit word),
//     by all the block's threads, 256 predecessors a round.  Tiles are
//     taken in launch order from an atomic ticket, so every predecessor
//     a tile waits on has already started: no deadlock.
//   - Part by part, each thread writes its kept rows' part indices, in
//     row order, into shared memory; after a barrier thread j moves the
//     part's kept rows j, j + kThreads, ... of every column.  Writes are
//     contiguous, reads ascend, and a row's value is read only when the
//     row is kept.
//   - The last tile writes the int64 count.
// A block's life is a chain of latencies (ticket, mask, scan, look-back,
// then a dependent load per kept row); four parts a tile spread that
// chain over 65,536 rows.
// Output order equals input order.  Writes at or past `cap` are dropped,
// so a cap below the true count can never write out of bounds; the
// wrapper compares the count with the cap and raises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 64;                   // rows per thread per part
constexpr int kPartRows = kThreads * kItems; // 16,384 rows a part
constexpr int kParts = 4;                    // parts per tile
constexpr int kTile = kParts * kPartRows;    // 65,536 rows
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 64;
constexpr unsigned kFull = 0xffffffffu;

// Tile status word: a flag in the top two bits, a kept count below.
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's count
constexpr unsigned long long kPrefix = 2ull << 62;     // count through it
constexpr unsigned long long kCountBits = (1ull << 62) - 1;

// One column of the batch.
struct ColDesc {
  const void* in;
  void* out;
  long long width;                           // bytes: 1, 2, 4 or 8
};

// The batch, passed by value as kernel parameters.
struct Batch {
  ColDesc cols[kMaxCols];
  void* positions;                           // null: no positions output
  int ncols;
  int pos_width;                             // 4 (int32) or 8 (int64)
};

// Bit i of the result is set when byte i of `w` is nonzero (i < 4).
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned hi = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return ((hi >> 7) * 0x00204081u) >> 21 & 0xFu;
}

// Exclusive scan over the block of kWords u64 per thread, each word
// holding 16-bit part counts side by side (a part's count fits:
// kPartRows at most); `total` gets the block's sums.  One barrier.
constexpr int kWords = (kParts + 3) / 4;

__device__ __forceinline__ void block_exclusive_scan(
    const unsigned long long (&v)[kWords],
    unsigned long long (*s_warp)[kWords], unsigned long long (&before)[kWords],
    unsigned long long (&total)[kWords]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long x[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    x[k] = v[k];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, x[k], o);
      if (lane >= o) x[k] += y;
    }
    if (lane == 31) s_warp[warp][k] = x[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    before[k] = 0;
    total[k] = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned long long t = s_warp[w][k];
      before[k] += w < warp ? t : 0;
      total[k] += t;
    }
    before[k] += x[k] - v[k];
  }
}

__device__ __forceinline__ long long field(
    const unsigned long long (&w)[kWords], int part) {
  return (long long)((w[part / 4] >> (16 * (part % 4))) & 0xFFFF);
}

// Decoupled look-back by the whole block: the kept rows of every tile
// before `tile`.  Each round, thread i reads the status of tile - 1 - i
// (waiting while it is unset), 256 tiles a round, until a round holds a
// prefix; the counts are summed up to the nearest one.  One barrier a
// round: each warp posts (holds a prefix, sum up to its first prefix or
// of all its lanes) into a buffer that alternates between rounds.
struct LookBack {
  long long sum[2][kWarps];
  int prefix[2][kWarps];
};

__device__ __forceinline__ long long look_back(
    const volatile unsigned long long* status, long long tile,
    LookBack& lb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long before = 0;
  for (int round = 0;; ++round) {
    const long long idx = tile - 1 - (long long)round * kThreads -
                          threadIdx.x;
    unsigned long long s;
    while (((s = idx >= 0 ? status[idx] : kPrefix) >> 62) == 0)
      __nanosleep(32);                       // before tile 0: prefix 0
    const unsigned prefix = __ballot_sync(kFull, (s >> 62) == 2);
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    long long v = lane <= stop ? (long long)(s & kCountBits) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    const int buf = round & 1;
    if (lane == 0) {
      lb.sum[buf][warp] = v;
      lb.prefix[buf][warp] = prefix != 0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += lb.sum[buf][w];
      if (lb.prefix[buf][w]) return before;
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_kept(const ColDesc& d,
                                          const uint16_t* s_idx,
                                          long long row0, int kept) {
  const T* in = static_cast<const T*>(d.in) + row0;
  T* out = static_cast<T*>(d.out);
#pragma unroll 4
  for (int j = threadIdx.x; j < kept; j += kThreads)
    out[j] = __ldg(in + s_idx[j]);
}

template <typename T>
__device__ __forceinline__ void write_positions(void* positions,
                                                const uint16_t* s_idx,
                                                long long row0, int kept) {
  T* out = static_cast<T*>(positions);
  for (int j = threadIdx.x; j < kept; j += kThreads)
    out[j] = static_cast<T>(row0 + s_idx[j]);
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ keep, long long n, int aligned,
               const Batch b, long long cap,
               unsigned long long* __restrict__ status,
               unsigned long long* __restrict__ ticket,
               long long* __restrict__ count, long long ntiles) {
  __shared__ uint16_t s_idx[kPartRows];      // kept rows' part indices
  __shared__ unsigned long long s_warp[kWarps][kWords];
  __shared__ LookBack s_lb;
  __shared__ long long s_tile;
  if (threadIdx.x == 0) s_tile = (long long)atomicAdd(ticket, 1ull);
  __syncthreads();
  const long long tile = s_tile;
  const long long row0 = tile * kTile;

  // this thread's kept rows of each part as a bit mask, bit i for row
  // first + i; every part's mask bytes are in flight at once
  unsigned long long mask[kParts];
  if (aligned && row0 + kTile <= n) {
    uint4 v[kParts][kItems / 16];
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const uint4* p = reinterpret_cast<const uint4*>(
          keep + row0 + part * kPartRows + threadIdx.x * kItems);
#pragma unroll
      for (int h = 0; h < kItems / 16; ++h) v[part][h] = p[h];
    }
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      mask[part] = 0;
#pragma unroll
      for (int h = 0; h < kItems / 16; ++h)
        mask[part] |= (unsigned long long)(nonzero_bytes(v[part][h].x) |
                                           nonzero_bytes(v[part][h].y) << 4 |
                                           nonzero_bytes(v[part][h].z) << 8 |
                                           nonzero_bytes(v[part][h].w) << 12)
                      << (16 * h);
    }
  } else {
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const long long first = row0 + part * kPartRows + threadIdx.x * kItems;
      mask[part] = 0;
      for (int i = 0; i < kItems; ++i)
        if (first + i < n && keep[first + i]) mask[part] |= 1ull << i;
    }
  }

  unsigned long long counts[kWords] = {};
#pragma unroll
  for (int part = 0; part < kParts; ++part)
    counts[part / 4] |= (unsigned long long)__popcll(mask[part])
                        << (16 * (part % 4));
  unsigned long long at_parts[kWords], part_totals[kWords];
  block_exclusive_scan(counts, s_warp, at_parts, part_totals);
  long long total = 0;
#pragma unroll
  for (int part = 0; part < kParts; ++part) total += field(part_totals, part);

  // publish this tile's count, then find the count before it
  volatile unsigned long long* st = status;
  long long offset = 0;
  if (tile == 0) {
    if (threadIdx.x == 0) st[0] = kPrefix | (unsigned long long)total;
  } else {
    if (threadIdx.x == 0) st[tile] = kAggregate | (unsigned long long)total;
    offset = look_back(status, tile, s_lb);
    if (threadIdx.x == 0)
      st[tile] = kPrefix | (unsigned long long)(offset + total);
  }
  if (threadIdx.x == 0 && tile == ntiles - 1) *count = offset + total;

#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    int at = (int)field(at_parts, part);
    for (unsigned long long m = mask[part]; m; m &= m - 1)
      s_idx[at++] = (uint16_t)(threadIdx.x * kItems + __ffsll(m) - 1);
    __syncthreads();                         // s_idx published
    const long long part_row0 = row0 + part * kPartRows;
    const long long part_total = field(part_totals, part);
    const int kept = offset >= cap ? 0
        : (int)(part_total < cap - offset ? part_total : cap - offset);
    for (int c = 0; c < b.ncols; ++c) {
      ColDesc d = b.cols[c];
      switch (d.width) {
        case 1:
          d.out = static_cast<uint8_t*>(d.out) + offset;
          copy_kept<uint8_t>(d, s_idx, part_row0, kept);
          break;
        case 2:
          d.out = static_cast<uint16_t*>(d.out) + offset;
          copy_kept<uint16_t>(d, s_idx, part_row0, kept);
          break;
        case 4:
          d.out = static_cast<uint32_t*>(d.out) + offset;
          copy_kept<uint32_t>(d, s_idx, part_row0, kept);
          break;
        default:
          d.out = static_cast<uint64_t*>(d.out) + offset;
          copy_kept<uint64_t>(d, s_idx, part_row0, kept);
          break;
      }
    }
    if (b.positions != nullptr) {
      if (b.pos_width == 4)
        write_positions<int32_t>(
            static_cast<int32_t*>(b.positions) + offset, s_idx, part_row0,
            kept);
      else
        write_positions<long long>(
            static_cast<long long*>(b.positions) + offset, s_idx,
            part_row0, kept);
    }
    offset += part_total;
    if (part + 1 < kParts) __syncthreads();  // s_idx reused
  }
}

}  // namespace

extern "C" {

int atp_compact_tile_rows() { return kTile; }

int atp_compact_max_cols() { return kMaxCols; }

// keep: n bytes (0 or not); cols: ncols (in, out, width) int64 triples in
// HOST memory, read before this returns; positions: cap int32 or int64
// (pos_width 4 or 8), or null; scratch: ceil(n / kTile) + 2 int64 in
// device memory (tile status words, the ticket, then the count, which
// this writes).  Launches on `stream` of `device`; returns
// cudaGetLastError() (or the error of a set-up call).
int atp_compact(int device, const void* keep, long long n,
                const long long* cols, int ncols, long long cap,
                void* positions, int pos_width, void* scratch,
                void* stream) {
  if (ncols < 0 || ncols > kMaxCols) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (n + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned long long*>(scratch);
  err = cudaMemsetAsync(words, 0, sizeof(long long) * (size_t)(ntiles + 2),
                        s);
  if (err != cudaSuccess || ntiles == 0) return (int)err;
  Batch b{};
  int aligned = reinterpret_cast<uintptr_t>(keep) % 16 == 0;
  for (int c = 0; c < ncols; ++c) {
    b.cols[c].in = reinterpret_cast<const void*>(cols[3 * c]);
    b.cols[c].out = reinterpret_cast<void*>(cols[3 * c + 1]);
    b.cols[c].width = cols[3 * c + 2];
  }
  b.ncols = ncols;
  b.positions = positions;
  b.pos_width = pos_width;
  compact_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(keep), n, aligned, b, cap, words,
      words + ntiles, reinterpret_cast<long long*>(words + ntiles + 1),
      ntiles);
  return (int)cudaGetLastError();
}

const char* atp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
