// Bounded gossip-inbox build for Hopper (sm_90a).
//
// Replaces the TPU kernel corrosion_tpu/ops/inbox_pallas.py
// (build_inbox_pallas, body _kernel), and computes what
// corrosion_tpu/ops/swim.py::build_inbox_grouped computes: G packets, each
// with one destination dst[g] in [0, n) and m messages (subj, key, ok,
// each [G, m]), become [n, slots] int32 inboxes (subj, empty = n; key,
// empty = 0). Each destination receives its first `slots` valid messages
// in group-major arrival order; masked messages and overflow are dropped.
//
// What bounds it on this card: bytes. At the dense tick's shapes (n =
// 10,000, G = 20,000, m = 5, slots = 8) it reads dst (80 KB), subj and
// key (800 KB) and ok (100 KB) and writes the two outputs (640 KB): about
// 1.6 MB, some 0.5 us at 3.35 TB/s, so launch latency dominates.
//
// Design. The TPU kernel walks the packets one by one with fill counters
// in SMEM; on a GPU that walk is one thread. Here the order is rebuilt in
// parallel instead:
//   1. count_packets: a per-destination histogram of the packets that
//      carry at least one valid message (atomicAdd);
//   2. scan_counts: an exclusive scan of the histogram in one block;
//   3. fill_csr: each such packet claims a slot in its destination's
//      segment (atomicAdd on a cursor), so a segment holds its packet ids
//      in arbitrary order;
//   4. write_rows: one thread per destination takes its packet ids in
//      ascending order (repeated minimum above the last id taken) and
//      fills its own [slots] row. Every taken packet adds at least one
//      message, so a row needs at most `slots` passes over its segment.
// Each output row has exactly one writer, so the output needs no atomics,
// and ascending packet ids reproduce the stable group-major order exactly.
// The TPU kernel's VMEM/SMEM budgets do not apply: the planes live in
// device memory. Packets whose destination lies outside [0, n) are
// dropped, as the grouped sort's out-of-range scatter drops them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool packet_counts(const int* dst, const uint8_t* ok,
                                              int g, int m, int n, int* d_out) {
  int d = dst[g];
  if (d < 0 || d >= n) return false;
  const uint8_t* row = ok + (long long)g * m;
  for (int k = 0; k < m; ++k) {
    if (row[k]) {
      *d_out = d;
      return true;
    }
  }
  return false;
}

__global__ void count_packets(const int* dst, const uint8_t* ok, int G, int m,
                              int n, int* hist) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  int d;
  if (g < G && packet_counts(dst, ok, g, m, n, &d)) atomicAdd(&hist[d], 1);
}

// off[0..n] = exclusive scan of hist[0..n), cursor[0..n) = off[0..n).
__global__ void scan_counts(const int* hist, int n, int* off, int* cursor) {
  __shared__ int part[kScanThreads];
  int tid = threadIdx.x;
  int per = (n + kScanThreads - 1) / kScanThreads;
  int lo = min(n, tid * per);
  int hi = min(n, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += hist[i];
  part[tid] = own;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {  // inclusive Hillis-Steele
    int v = tid >= o ? part[tid - o] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - own;
  for (int i = lo; i < hi; ++i) {
    off[i] = run;
    cursor[i] = run;
    run += hist[i];
  }
  if (tid == kScanThreads - 1) off[n] = part[tid];
}

__global__ void fill_csr(const int* dst, const uint8_t* ok, int G, int m, int n,
                         int* cursor, int* csr) {
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  int d;
  if (g < G && packet_counts(dst, ok, g, m, n, &d)) {
    csr[atomicAdd(&cursor[d], 1)] = g;
  }
}

__global__ void write_rows(const int* off, const int* csr, const int* subj,
                           const int* key, const uint8_t* ok, int m, int n,
                           int slots, int* out_subj, int* out_key) {
  int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  int* os = out_subj + (long long)d * slots;
  int* ok_row = out_key + (long long)d * slots;
  int lo = off[d], hi = off[d + 1];
  int col = 0;
  int last = -1;
  while (col < slots) {
    int next = INT_MAX;  // the smallest packet id above `last`
    for (int i = lo; i < hi; ++i) {
      int g = csr[i];
      if (g > last && g < next) next = g;
    }
    if (next == INT_MAX) break;
    last = next;
    long long base = (long long)next * m;
    for (int k = 0; k < m && col < slots; ++k) {
      if (ok[base + k]) {
        os[col] = min(subj[base + k], n);
        ok_row[col] = max(key[base + k], 0);
        ++col;
      }
    }
  }
  for (; col < slots; ++col) {
    os[col] = n;
    ok_row[col] = 0;
  }
}

}  // namespace

// scratch: 3 * n + 1 + G int32 (histogram, offsets, cursors, CSR ids).
// Returns the CUDA error code of the first failing step, 0 on success.
extern "C" int inbox_build(const int* dst, const int* subj, const int* key,
                           const uint8_t* ok, int* out_subj, int* out_key,
                           int* scratch, int G, int m, int n, int slots,
                           cudaStream_t stream) {
  if (n <= 0 || slots <= 0 || m < 0 || G < 0) return (int)cudaErrorInvalidValue;
  int* hist = scratch;
  int* off = hist + n;
  int* cursor = off + n + 1;
  int* csr = cursor + n;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)n, stream);
  if (err != cudaSuccess) return (int)err;
  int gblocks = (G + kThreads - 1) / kThreads;
  if (G > 0) {
    count_packets<<<gblocks, kThreads, 0, stream>>>(dst, ok, G, m, n, hist);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  scan_counts<<<1, kScanThreads, 0, stream>>>(hist, n, off, cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (G > 0) {
    fill_csr<<<gblocks, kThreads, 0, stream>>>(dst, ok, G, m, n, cursor, csr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  write_rows<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      off, csr, subj, key, ok, m, n, slots, out_subj, out_key);
  return (int)cudaGetLastError();
}
