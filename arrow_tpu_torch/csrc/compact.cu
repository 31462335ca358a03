// K1: order-preserving stream compaction of a batch of columns by one
// keep mask, for sm_90a.
//
// Replaces arrow_tpu/kernels/compact.py::_kernel (the pallas_call in
// _compact_impl).  That kernel built each 256-row permutation as a
// triangular prefix-sum matmul on the MXU, moved the data as exact bf16
// byte limbs of u32 planes, and carried its running write offset in
// SMEM from one sequential grid step to the next.  Hopper blocks run in
// no order, so the offset becomes a real cross-block scan, and the data
// moves at its native width (1, 2, 4 or 8 bytes), f64 and f16 included.
//
// Bound: bytes of device memory.  Every kept row is read once and
// written once per column, and the keep mask is read twice; there is no
// arithmetic to speak of.  The design keeps the passes to three small
// kernels on one stream:
//   1. count_tiles:   kept rows per tile of kTile rows (block reduce);
//   2. scan_tiles:    one block scans the tile counts (cub::BlockScan,
//                     looping over the tiles) into tile offsets and
//                     writes the total count (int64);
//   3. scatter_tiles: each tile ranks its rows with warp ballots and
//                     popc, and writes every column at offset + rank.
// Output order equals input order.  Writes at or past `cap` are
// dropped, so a cap below the true count can never write out of bounds;
// the wrapper compares the count with the cap and raises.
// Later work: decoupled look-back to fuse the passes, 16-byte loads.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                   // rows per thread per tile
constexpr int kTile = kThreads * kItems;     // 4096 rows
constexpr int kScanThreads = 512;
constexpr int kMaxCols = 64;

// One column of the batch; the wrapper packs these as int64 triples.
struct ColDesc {
  const void* in;
  void* out;
  long long width;                           // bytes: 1, 2, 4 or 8
};

__global__ void __launch_bounds__(kThreads)
count_tiles(const uint8_t* __restrict__ keep, long long n,
            long long* __restrict__ tile_counts) {
  const long long base = (long long)blockIdx.x * kTile;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    c += (i < n && keep[i]) ? 1 : 0;
  }
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int total = Reduce(tmp).Sum(c);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
scan_tiles(const long long* __restrict__ tile_counts,
           long long ntiles,
           long long* __restrict__ tile_offsets,
           long long* __restrict__ count) {
  using Scan = cub::BlockScan<long long, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < ntiles; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const long long v = i < ntiles ? tile_counts[i] : 0;
    long long excl, chunk_total;
    Scan(tmp).ExclusiveSum(v, excl, chunk_total);
    if (i < ntiles) tile_offsets[i] = carry + excl;
    __syncthreads();                         // carry read, tmp reused
    if (threadIdx.x == 0) carry += chunk_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = carry;
}

__device__ __forceinline__ void copy_row(const ColDesc& c, long long src,
                                         long long dst) {
  switch (c.width) {
    case 1:
      static_cast<uint8_t*>(c.out)[dst] =
          static_cast<const uint8_t*>(c.in)[src];
      break;
    case 2:
      static_cast<uint16_t*>(c.out)[dst] =
          static_cast<const uint16_t*>(c.in)[src];
      break;
    case 4:
      static_cast<uint32_t*>(c.out)[dst] =
          static_cast<const uint32_t*>(c.in)[src];
      break;
    default:
      static_cast<uint64_t*>(c.out)[dst] =
          static_cast<const uint64_t*>(c.in)[src];
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_tiles(const uint8_t* __restrict__ keep, long long n,
              const ColDesc* __restrict__ cols, int ncols,
              const long long* __restrict__ tile_offsets,
              long long cap) {
  constexpr int kWarps = kThreads / 32;
  __shared__ ColDesc s_cols[kMaxCols];
  __shared__ int warp_total[kWarps];
  for (int c = threadIdx.x; c < ncols; c += kThreads) s_cols[c] = cols[c];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kTile;
  long long out = tile_offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    const bool kept = i < n && keep[i];
    const unsigned ballot = __ballot_sync(0xffffffffu, kept);
    const int rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();                         // also publishes s_cols
    int before = 0, round_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_total[w];
      before += w < warp ? t : 0;
      round_total += t;
    }
    const long long pos = out + before + rank;
    if (kept && pos < cap) {
      for (int c = 0; c < ncols; ++c) copy_row(s_cols[c], i, pos);
    }
    out += round_total;
    __syncthreads();                         // warp_total reused
  }
}

}  // namespace

extern "C" {

int atp_compact_tile_rows() { return kTile; }

int atp_compact_max_cols() { return kMaxCols; }

// keep: n bytes (0/1); cols: ncols ColDesc in device memory;
// tile_counts, tile_offsets: max(1, ceil(n / kTile)) int64 each;
// count: one int64.  Launches on `stream` of `device`; returns
// cudaGetLastError().
int atp_compact(int device, const void* keep, long long n, const void* cols,
                int ncols, long long cap, void* tile_counts,
                void* tile_offsets, void* count, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const uint8_t*>(keep);
  auto* tc = static_cast<long long*>(tile_counts);
  auto* to = static_cast<long long*>(tile_offsets);
  count_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(k, n, tc);
  scan_tiles<<<1, kScanThreads, 0, s>>>(tc, ntiles, to,
                                        static_cast<long long*>(count));
  scatter_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(
      k, n, static_cast<const ColDesc*>(cols), ncols, to, cap);
  return (int)cudaGetLastError();
}

const char* atp_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
