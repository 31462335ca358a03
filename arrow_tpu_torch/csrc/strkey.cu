// K3: one sort key of every string row, the key of one pass of the device
// dictionary encode (arrow_tpu_torch/ops/strings.py), for sm_90a.
//
// Replaces no TPU kernel: the reference interns a string column on the
// host (arrow_tpu/ops/strings.py dictionary_encode), and so did the port
// before this kernel.  The encode ranks the rows in byte order by sort
// refinement, 7 bytes a pass, and pass k needs every row's key k: bytes
// [7k, 7k + 7) of the row, big-endian, zero past the row's end, in bits
// 4-59, and in bits 0-3 how many of the row's bytes from 7k on remain,
// 0 to 7, or 8 for more than 7.  So a signed int64 sort of the keys
// orders the rows by those bytes as unsigned and puts a row that ends in
// them before a longer row with the same bytes ("ab" before "ab\0"), and
// a key whose count is under 8 ends its row.  Later passes visit the rows
// in the order the earlier ones left (the row list), so the key lands
// where the sort wants it.
//
// Bound: bytes of device memory.  Each row reads its row id (with a row
// list), its two offsets and at most 7 of its bytes, and writes one
// int64: no arithmetic to speak of.  One thread a row; the row list and
// the output are read and written in order, the offsets and the bytes
// are gathers (a row's 7 bytes share one or two 32-byte sectors, so the
// byte loads after the first hit L1).  A pass of the encode sorts twice
// after this kernel, so the kernel is a small part of a pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytes = 7;          // bytes of a row a key holds

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    strkey_kernel(const Off* __restrict__ offsets,
                  const uint8_t* __restrict__ data, long long n,
                  long long skip, const long long* __restrict__ rows,
                  long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long r = rows != nullptr ? rows[i] : i;
  const long long start = (long long)offsets[r] + skip;
  const long long left = (long long)offsets[r + 1] - start;
  unsigned long long w = 0;
  if (left >= kBytes) {
#pragma unroll
    for (int b = 0; b < kBytes; ++b) w = (w << 8) | data[start + b];
  } else {
#pragma unroll
    for (int b = 0; b < kBytes; ++b)
      w = (w << 8) | (b < left ? data[start + b] : 0u);
  }
  const long long remain = left > kBytes ? kBytes + 1 : (left > 0 ? left : 0);
  out[i] = (long long)((w << 4) | (unsigned long long)remain);
}

}  // namespace

extern "C" {

// offsets: n + 1 int32 (off_width 4) or int64 (8); data: the bytes; k:
// the key (bytes 7k .. 7k + 6 of each row); rows: n int64 row ids or
// null (row i); out: n int64.  Launches on `stream` of `device`; returns
// cudaGetLastError() (or the error of a set-up call).
int atp_strkey(int device, const void* offsets, int off_width,
               const void* data, long long n, long long k, const void* rows,
               void* out, void* stream) {
  if (off_width != 4 && off_width != 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || n == 0) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const auto* bytes = static_cast<const uint8_t*>(data);
  const auto* ids = static_cast<const long long*>(rows);
  auto* keys = static_cast<long long*>(out);
  if (off_width == 4)
    strkey_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(offsets), bytes, n, kBytes * k, ids,
        keys);
  else
    strkey_kernel<long long><<<blocks, kThreads, 0, s>>>(
        static_cast<const long long*>(offsets), bytes, n, kBytes * k, ids,
        keys);
  return (int)cudaGetLastError();
}

}  // extern "C"
