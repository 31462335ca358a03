// K3: the ranking of a string column by sort refinement, the device
// dictionary encode's loop (arrow_tpu_torch/ops/strings.py), for sm_90a:
// every pass and every drop of finished rows in one call.
//
// Replaces no TPU kernel: the reference interns a string column on the
// host (arrow_tpu/ops/strings.py dictionary_encode).  The encode ranks
// the rows in byte order, 7 bytes a pass, and pass k needs every row's
// key k: bytes [7k, 7k + 7) of the row, big-endian, zero past the row's
// end, in bits 4-59, and in bits 0-3 how many of the row's bytes from 7k
// on remain, 0 to 7, or 8 for more than 7.  So the keys compare as the
// rows' bytes, unsigned, and a row that ends in them sorts before a
// longer row with the same bytes ("ab" before "ab\0"); a key whose count
// is under 8 ends its row.
//
// The routine's state is a list of the rows still refined, grouped, with
// each row's group named by its sorted position (the rows before the
// group in byte order), which is ascending along the list, and each
// row's offset (the rows dropped before it: its position less its index
// in the list, the same for all of a group).  Pass k:
//   - key_kernel: each row's sort key, its group's position above key k
//     shifted to bits 4-63 (RowKey), and on the first pass the row list;
//   - one stable cub radix sort of the (key, row) pairs over the bits in
//     use: the group's position, then the key, so each group's rows order
//     by key and the groups stay where they were;
//   - step_kernel: where a new group starts (the key or the group
//     differs from the row before), as the start's position (its index
//     plus its offset), and a max scan (cub) that hands it down the group:
//     every row's new group position;
//   - at passes 1, 2, 4, ... while at least as many passes remain, and at
//     the last: place_kernel gives every row its group's position (the
//     rows finished here keep it), and drop_kernel packs the rows left
//     (not alone in their group, not ended) by an exclusive sum (cub),
//     writing the count, and whether a group left holds more than kSmall
//     rows, into the caller's pinned host words, which the host reads
//     after a sync of the caller's stream.
// Groups only split, so once a drop finds none of more than kSmall rows,
// the later passes take small_kernel in place of the sort, the step
// kernel and the scan: a thread a group sorts its rows in place.  A text
// column's rows are then mostly in groups of their own copies, which no
// drop removes until they end (Q10's c_comment: 17 passes).
// The drops make the work follow the bytes that still tell rows apart;
// the rows-left reads are the only syncs.  Nothing is allocated: the
// scratch is one block the caller takes from its allocator, sized by
// atp_strrank_scratch (56 bytes a row with int32 ids, and cub's
// temporaries).  Row ids and positions are int32 below 2^31 rows, int64
// from there.
//
// Bound: the sort while groups are large.  Each sorted pass sorts 60
// bits of key and the bits of the largest position (81 at 1.1M rows: 11
// digit passes of 8 bits over 16 bytes a row); the key build reads at
// most 7 bytes a row and its two offsets, gathers that mostly hit one
// 32-byte sector; a small pass is the key build and one read and write
// of each row's key, id and position.  The host makes about 20 launches
// a sorted pass (the sort's own included), 2 a small one, and no Python
// or torch op.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cub/cub.cuh>
#include <cuda/std/tuple>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytes = 7;          // bytes of a row a key holds
constexpr int kSmall = 64;         // rows of a group a thread sorts
constexpr size_t kAlign = 256;

// A row's sort key in a pass: its group's position, then key k << 4 in
// hi:lo.  Bits are counted from lo's lowest, so the sort's bits are
// [4, 64 + bits of the largest position).
template <typename G>
struct RowKey {
  G group;
  uint32_t hi, lo;
};

template <typename G>
struct Split {
  __host__ __device__ ::cuda::std::tuple<G&, uint32_t&, uint32_t&>
  operator()(RowKey<G>& k) const {
    return {k.group, k.hi, k.lo};
  }
};

template <typename I>
struct Max {
  __host__ __device__ I operator()(I a, I b) const { return a < b ? b : a; }
};

template <typename G>
__device__ bool differs(const RowKey<G>& a, const RowKey<G>& b) {
  return a.group != b.group || a.hi != b.hi || a.lo != b.lo;
}

__device__ long long thread_row() {
  return (long long)blockIdx.x * kThreads + threadIdx.x;
}

unsigned blocks(long long m) {
  return (unsigned)((m + kThreads - 1) / kThreads);
}

// Key k of each listed row (of row i on the first pass, when `rows` is
// null; the row list is then written, 0 .. m - 1) under its group's
// position (0 when `group` is null).
template <typename Off, typename I>
__global__ void __launch_bounds__(kThreads)
    key_kernel(const Off* __restrict__ offsets,
               const uint8_t* __restrict__ data, I m, long long skip,
               const I* __restrict__ rows, I* __restrict__ first_rows,
               const I* __restrict__ group,
               RowKey<std::make_unsigned_t<I>>* __restrict__ keys) {
  if (thread_row() >= m) return;
  const I i = (I)thread_row();
  I r = i;
  if (rows != nullptr)
    r = rows[i];
  else
    first_rows[i] = i;
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
  const unsigned long long remain =
      left > kBytes ? kBytes + 1 : (left > 0 ? left : 0);
  const unsigned long long key = ((w << 4) | remain) << 4;
  keys[i] = {group == nullptr ? 0 : (std::make_unsigned_t<I>)group[i],
             (uint32_t)(key >> 32), (uint32_t)key};
}

template <typename G>
__device__ bool ended(const RowKey<G>& k) {
  return ((k.lo >> 4) & 15) <= kBytes;
}

// Where a group starts in the sorted list, its position (index plus
// offset), else 0; with `keep`, whether the row goes on (not alone in its
// group and not ended), and `large` set when a group that goes on holds
// more than kSmall rows.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    step_kernel(const RowKey<std::make_unsigned_t<I>>* __restrict__ keys,
                I m, const I* __restrict__ off, I* __restrict__ start,
                I* __restrict__ keep, int* __restrict__ large) {
  if (thread_row() >= m) return;
  const I i = (I)thread_row();
  const auto k = keys[i];
  const bool step = i == 0 || differs(keys[i - 1], k);
  start[i] = step ? i + (off == nullptr ? 0 : off[i]) : 0;
  if (keep == nullptr) return;
  const bool alone = step && (i + 1 == m || differs(k, keys[i + 1]));
  keep[i] = !(alone || ended(k));
  if (step && keep[i]) {
    I j = i + 1;
    while (j < m && j - i <= kSmall && !differs(k, keys[j])) ++j;
    if (j - i > kSmall) atomicOr(large, 1);
  }
}

// One pass over groups of at most kSmall rows, a thread a group, in
// place of the sort, the step kernel and the scan: the group's rows
// ordered by key (an insertion sort in place), each row's new group
// position (the group's, plus where its new group starts in it) and,
// with `keep`, whether the row goes on.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    small_kernel(RowKey<std::make_unsigned_t<I>>* keys, I* rows, I m,
                 I* __restrict__ group, I* __restrict__ keep) {
  if (thread_row() >= m) return;
  const I i = (I)thread_row();
  const auto g = keys[i].group;
  if (i > 0 && keys[i - 1].group == g) return;
  I e = i + 1;
  while (e < m && keys[e].group == g) ++e;
  for (I a = i + 1; a < e; ++a) {
    const auto k = keys[a];
    const I r = rows[a];
    I b = a;
    for (; b > i && (keys[b - 1].hi > k.hi ||
                     (keys[b - 1].hi == k.hi && keys[b - 1].lo > k.lo));
         --b) {
      keys[b] = keys[b - 1];
      rows[b] = rows[b - 1];
    }
    keys[b] = k;
    rows[b] = r;
  }
  for (I a = i, s = i; a < e; ++a) {
    if (a > i && differs(keys[a - 1], keys[a])) s = a;
    group[a] = (I)g + (s - i);
    if (keep != nullptr) {
      const bool alone = s == a && (a + 1 == e || differs(keys[a],
                                                          keys[a + 1]));
      keep[a] = !(alone || ended(keys[a]));
    }
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    place_kernel(const I* __restrict__ rows, const I* __restrict__ group,
                 I m, I* __restrict__ at) {
  if (thread_row() >= m) return;
  const I i = (I)thread_row();
  at[rows[i]] = group[i];
}

// Packs the kept rows (their row ids, group positions and offsets) to
// their places `idx` (an exclusive sum of `keep`); the last row writes
// the count and the `large` flag to `left`, two host words mapped into
// the device's space.  A store, not a device-to-host copy: every such
// copy a query makes sits in a `readback` span of the Python side
// (utils/trace.py::to_host), which a copy inside this call cannot, so
// the syncs at the drops are counted by the `strings.encode` span's
// `drops`, not as readbacks.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    drop_kernel(I m, const I* __restrict__ keep, const I* __restrict__ idx,
                const I* __restrict__ rows, const I* __restrict__ group,
                const I* __restrict__ off, I* __restrict__ rows_out,
                I* __restrict__ group_out, I* __restrict__ off_out,
                const int* __restrict__ large, long long* left) {
  if (thread_row() >= m) return;
  const I i = (I)thread_row();
  const I j = idx[i];
  if (keep[i]) {
    rows_out[j] = rows[i];
    group_out[j] = group[i];
    off_out[j] = (off == nullptr ? 0 : off[i]) + i - j;
  }
  if (i == m - 1) {
    left[0] = (long long)(j + keep[i]);
    left[1] = *large;
  }
}

size_t up(size_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

// The scratch of n rows: offsets of each buffer in one block.
template <typename I>
struct Layout {
  size_t keys[2], rows[2], start, group, off[2], keep, idx, large, temp,
      temp_bytes, total;
};

int bits_of(long long x) {
  int b = 0;
  while (x > 0) ++b, x >>= 1;
  return b;
}

template <typename I>
cudaError_t plan(long long n, Layout<I>* out) {
  using G = std::make_unsigned_t<I>;
  Layout<I> l;
  size_t at = 0;
  auto take = [&](size_t bytes) { const size_t o = at; at += up(bytes); return o; };
  for (int b = 0; b < 2; ++b) l.keys[b] = take(n * sizeof(RowKey<G>));
  for (int b = 0; b < 2; ++b) l.rows[b] = take(n * sizeof(I));
  l.start = take(n * sizeof(I));
  l.group = take(n * sizeof(I));
  for (int b = 0; b < 2; ++b) l.off[b] = take(n * sizeof(I));
  l.keep = take(n * sizeof(I));
  l.idx = take(n * sizeof(I));
  l.large = take(sizeof(int));
  size_t sort = 0, scan = 0, sum = 0;
  cub::DoubleBuffer<RowKey<G>> keys(nullptr, nullptr);
  cub::DoubleBuffer<I> rows(nullptr, nullptr);
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, sort, keys, rows, (I)n, Split<G>{}, 4,
      64 + bits_of(n - 1));
  if (err != cudaSuccess) return err;
  err = cub::DeviceScan::InclusiveScan(nullptr, scan, (const I*)nullptr,
                                       (I*)nullptr, Max<I>{}, (I)n);
  if (err != cudaSuccess) return err;
  err = cub::DeviceScan::ExclusiveSum(nullptr, sum, (const I*)nullptr,
                                      (I*)nullptr, (I)n);
  if (err != cudaSuccess) return err;
  l.temp_bytes = std::max(sort, std::max(scan, sum));
  l.temp = take(l.temp_bytes);
  l.total = at;
  *out = l;
  return cudaSuccess;
}

#define ATP_TRY(call)                                  \
  do {                                                 \
    const cudaError_t e_ = (call);                     \
    if (e_ != cudaSuccess) return e_;                  \
  } while (0)

template <typename Off, typename I>
cudaError_t rank(const Off* offsets, const uint8_t* data, long long n,
                 long long passes, I* at, uint8_t* scratch,
                 long long scratch_bytes, long long* left_host,
                 long long* out, cudaStream_t s) {
  using G = std::make_unsigned_t<I>;
  out[0] = out[1] = 0;
  if (n == 0) return cudaSuccess;
  if (passes == 0)             // every row empty: one group at 0
    return cudaMemsetAsync(at, 0, n * sizeof(I), s);
  Layout<I> l{};
  ATP_TRY(plan<I>(n, &l));
  if ((long long)l.total > scratch_bytes) return cudaErrorInvalidValue;
  long long* left = nullptr;
  ATP_TRY(cudaHostGetDevicePointer((void**)&left, left_host, 0));
  auto buf = [&](size_t o) { return (void*)(scratch + o); };
  cub::DoubleBuffer<RowKey<G>> keys((RowKey<G>*)buf(l.keys[0]),
                                    (RowKey<G>*)buf(l.keys[1]));
  cub::DoubleBuffer<I> rows((I*)buf(l.rows[0]), (I*)buf(l.rows[1]));
  I* start = (I*)buf(l.start);
  I* group = (I*)buf(l.group);
  I* offs[2] = {(I*)buf(l.off[0]), (I*)buf(l.off[1])};
  I* keep = (I*)buf(l.keep);
  I* idx = (I*)buf(l.idx);
  int* large = (int*)buf(l.large);
  void* temp = buf(l.temp);
  const int end_bit = 64 + bits_of(n - 1);
  I m = (I)n;
  const I* gin = nullptr;      // each row's group position (null: 0)
  const I* off = nullptr;      // each row's offset (null: 0)
  int spare = 0;               // offs[spare] takes the next drop's offsets
  bool small = false;          // every group holds at most kSmall rows
  long long done = 0, drops = 0;
  for (long long k = 0; k < passes; ++k) {
    key_kernel<Off, I><<<blocks(m), kThreads, 0, s>>>(
        offsets, data, m, kBytes * k, k == 0 ? nullptr : rows.Current(),
        k == 0 ? rows.Current() : nullptr, gin, keys.Current());
    ATP_TRY(cudaGetLastError());
    done = k + 1;
    // drop finished rows after passes 1, 2, 4, ... while at least as many
    // passes remain
    const bool drop = !(done & (done - 1)) && 2 * done <= passes;
    if (small) {
      small_kernel<I><<<blocks(m), kThreads, 0, s>>>(
          keys.Current(), rows.Current(), m, group, drop ? keep : nullptr);
      ATP_TRY(cudaGetLastError());
    } else {
      size_t temp_bytes = l.temp_bytes;
      ATP_TRY(cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys, rows,
                                              m, Split<G>{}, 4,
                                              k == 0 ? 64 : end_bit, s));
      if (drop) ATP_TRY(cudaMemsetAsync(large, 0, sizeof(int), s));
      step_kernel<I><<<blocks(m), kThreads, 0, s>>>(
          keys.Current(), m, off, start, drop ? keep : nullptr, large);
      ATP_TRY(cudaGetLastError());
      temp_bytes = l.temp_bytes;
      ATP_TRY(cub::DeviceScan::InclusiveScan(temp, temp_bytes, start, group,
                                             Max<I>{}, m, s));
    }
    gin = group;
    if (done < passes && !drop) continue;
    place_kernel<I><<<blocks(m), kThreads, 0, s>>>(rows.Current(), group,
                                                   m, at);
    ATP_TRY(cudaGetLastError());
    if (!drop) break;
    size_t temp_bytes = l.temp_bytes;
    ATP_TRY(cub::DeviceScan::ExclusiveSum(temp, temp_bytes, keep, idx, m, s));
    drop_kernel<I><<<blocks(m), kThreads, 0, s>>>(
        m, keep, idx, rows.Current(), group, off, rows.Alternate(), start,
        offs[spare], large, left);
    ATP_TRY(cudaGetLastError());
    ++drops;
    ATP_TRY(cudaStreamSynchronize(s));
    m = (I)((volatile long long*)left_host)[0];
    // groups only split from here on
    small = small || ((volatile long long*)left_host)[1] == 0;
    if (m == 0) break;
    rows.selector ^= 1;
    gin = start;
    off = offs[spare];
    spare ^= 1;
  }
  out[0] = done;
  out[1] = drops;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The scratch bytes atp_strrank needs for n rows, in *bytes.  Returns a
// CUDA error (cub's size queries read the device).
int atp_strrank_scratch(int device, long long n, long long* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0) return (int)cudaErrorInvalidValue;
  size_t total = 0;
  if (n < (1ll << 31)) {
    Layout<int32_t> l{};
    err = plan<int32_t>(n, &l);
    total = l.total;
  } else {
    Layout<long long> l{};
    err = plan<long long>(n, &l);
    total = l.total;
  }
  *bytes = (long long)total;
  return (int)err;
}

// offsets: n + 1 int32 (off_width 4) or int64 (8); data: the bytes;
// passes: the longest row's bytes over 7, rounded up; at: n int32 (n <
// 2^31) or int64, each row's sorted position on return; scratch:
// scratch_bytes of device memory (atp_strrank_scratch); left: two int64
// of pinned host memory; out: two host int64, the passes run and the
// drops made.  Runs on `stream` of `device` and syncs it after each drop;
// returns a CUDA error.
int atp_strrank(int device, const void* offsets, int off_width,
                const void* data, long long n, long long passes, void* at,
                void* scratch, long long scratch_bytes, void* left,
                long long* out, void* stream) {
  if (off_width != 4 && off_width != 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bytes = static_cast<const uint8_t*>(data);
  auto* scr = static_cast<uint8_t*>(scratch);
  auto* word = static_cast<long long*>(left);
  const bool wide = n >= (1ll << 31);
  if (off_width == 4)
    err = wide ? rank(static_cast<const int32_t*>(offsets), bytes, n, passes,
                      static_cast<long long*>(at), scr, scratch_bytes, word,
                      out, s)
               : rank(static_cast<const int32_t*>(offsets), bytes, n, passes,
                      static_cast<int32_t*>(at), scr, scratch_bytes, word,
                      out, s);
  else
    err = wide ? rank(static_cast<const long long*>(offsets), bytes, n,
                      passes, static_cast<long long*>(at), scr, scratch_bytes,
                      word, out, s)
               : rank(static_cast<const long long*>(offsets), bytes, n,
                      passes, static_cast<int32_t*>(at), scr, scratch_bytes,
                      word, out, s);
  return (int)err;
}

}  // extern "C"
