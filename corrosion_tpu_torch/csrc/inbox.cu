// Bounded gossip-inbox build for Hopper (sm_90a).
//
// Replaces the TPU kernel corrosion_tpu/ops/inbox_pallas.py
// (build_inbox_pallas, body _kernel), and computes what
// corrosion_tpu/ops/swim.py::build_inbox_grouped computes: G packets, each
// with one destination dst[g] in [0, n) and m messages (subj, key, ok,
// each [G, m]), become [n, slots] int32 inboxes (subj, empty = n; key,
// empty = 0). Each destination receives its first `slots` valid messages
// in group-major arrival order; masked messages and overflow are dropped.
// Subj is clamped to at most n and key to at least 0, as the reference's
// scatter-min into n and scatter-max into 0 do. Packets whose destination
// lies outside [0, n) are dropped, as the grouped sort's out-of-range
// scatter drops them.
//
// What bounds it on this card: bytes. It must read dst (4G B) and ok (Gm
// B), subj and key only of the messages that land in a cell (8 B each, at
// most min(Gm, n * slots) of them), and write the two outputs (8n * slots
// B). At the dense tick's shapes (n = 10,000, G = 20,000, m = 5, slots = 8)
// that is about 1.3 MB, some 0.4 us at 3.35 TB/s, so a call costs what one
// launch costs; at n = 10^6 it is about 210 MB and the bytes set the time.
//
// Design: one launch, all working state in shared memory, no memset, no
// global scratch, no global atomics.
//
// * Smallest ids. Every packet that carries at least one valid message
//   adds at least one message to its destination's row, so a row is
//   filled from at most `slots` packets: the `slots` smallest such packet
//   ids for that destination, in ascending order. Each destination needs
//   only a sorted list of `slots` values, not a histogram, a scan or a
//   CSR. A list entry is g * (m + 1) + (valid messages of g): the packed
//   values order as the ids do, and carry the count the row needs later.
// * Each CTA owns a contiguous range of R destinations and keeps their
//   lists in dynamic shared memory (R * slots * 4 B, beside 8 KB of warp
//   queues). R is the smaller of ceil(n / SMs), so that the grid fills the
//   card wherever n allows, and what fits in the 227 KB a block may opt
//   into. At n = 10^6, slots = 16 the lists need three waves of CTAs.
// * Phase A, insert. The CTAs of a thread-block cluster split one sweep
//   over the packets between them (coalesced loads of dst, kUnroll loads
//   in flight per thread). Each warp queues the packets whose destination
//   lies in the cluster's range in a 32-entry queue in shared memory and,
//   when it is full, inserts all of them at once, one per lane: most
//   packets belong to other clusters, and inserting each where it was
//   found would stall the whole warp on one lane's chain of remote
//   accesses. An insert counts the packet's valid messages, then puts its
//   value into the owner's list through distributed shared memory with an
//   atomicMin cascade:
//       for j: old = atomicMin(&s[j], v); if (old == EMPTY) break;
//              v = max(old, v);
//   Why the lists end sorted and hold the `slots` smallest values: each
//   atomicMin on slot j leaves the smaller of (held, offered) there and
//   carries the larger on to slot j + 1 (EMPTY is larger than every value
//   and ends the carry). So the values offered to slot j + 1 are exactly
//   the values offered to slot j less the least of them, and slot j ends
//   up holding the least value offered to it. By induction slot j holds
//   the (j+1)-th smallest value inserted into the list, whatever the order
//   the atomics run in; values carried past the last slot are dropped.
//   A plain read of the last slot first lets a packet skip all atomics
//   once it cannot enter: slot values only ever go down, so a read value
//   below g * (m + 1) means the final list holds `slots` smaller ids.
// * Phase B1, columns. After a cluster barrier (the last point at which
//   any CTA touches another's shared memory, so no second barrier is
//   needed before a CTA exits), one thread per destination rewrites its
//   list in place, from shared memory alone: column c becomes
//   g * (m + 1) + i, "the i-th valid message of packet g". A forward pass
//   sums the counts; a backward pass writes each packet's columns. Packet
//   j's columns start at >= j (every earlier packet adds at least one), so
//   writing from the last packet back never overwrites an entry not yet
//   read. Columns past the last message keep EMPTY.
// * Phase B2, write rows. After a block barrier, consecutive threads take
//   consecutive cells of the block's [R, slots] range, kCellsPerThread at
//   a time: each finds its message in its packet's ok row, gathers subj
//   and key (or writes n and 0 for EMPTY), and the writes of a warp are
//   one contiguous stretch of both outputs. Each output cell has exactly
//   one writer.
// Two earlier versions were slower on the card at n = 10^6: one that wrote
// row by row, one thread per row, spent most of its time in the scattered
// stores; one that inserted each packet where the sweep found it stalled
// every warp on its inserts. What is left is the sweep (each cluster
// reads all of dst from L2, once per wave of CTAs) and B2's random
// gathers of ok, subj and key.
//
// Cluster size. With one CTA per range every CTA would read all of dst,
// CTAs * 4G B from L2, which grows as n * G at large n. Clusters of
// kCluster CTAs read it once per cluster instead. The choice is fixed
// here; it was measured by `python -m corrosion_tpu_torch.inbox_bench`
// against a build of this file with kCluster = 1.
// Device ms per call (torch.profiler, mean of 20 calls), two runs each,
// timed in the order 8, 1, 1, 8 on one NVIDIA H100 80GB HBM3, 700.00 W,
// by `inbox_bench`:
//   shape (n, G, m, slots)          cluster 1          cluster 8
//   10,000 / 20,000 / 5 / 8         0.01235 / 0.01240  0.01277 / 0.01283
//   100,000 / 200,000 / 5 / 8       0.05545 / 0.05538  0.04033 / 0.04067
//   1,000,000 / 2,000,000 / 5 / 16  1.5120 / 1.5160    0.5814 / 0.5832
// Size 8 costs 0.4 us (3 %) at the slice's shape and saves 27 % at n =
// 10^5 and 62 % at n = 10^6, so it is the one fixed choice.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // dst loads in flight per thread in the sweep
constexpr int kCellsPerThread = 4;  // output cells in flight per thread
constexpr int kCluster = 8;  // CTAs per thread-block cluster
constexpr int kEmpty = INT_MAX;  // above every packed value (G * (m + 1) < INT_MAX)
constexpr int kQueueBytes = kWarps * 2 * 32 * 4;  // per warp: 32 (g, d)

__device__ __forceinline__ int valid_count(const uint8_t* row, int m) {
  int c = 0;
  for (int k = 0; k < m; ++k) c += row[k] != 0;
  return c;
}

// Puts packet g (destination d, in the cluster's range [clo, ...)) into its
// owner's list as g * (m + 1) + (its valid count), if it carries a valid
// message and can still enter. The packed values order as the ids do.
__device__ __forceinline__ void insert(cg::cluster_group& cluster, int* lists,
                                       const uint8_t* ok, int g, int d,
                                       long long clo, int R, int m,
                                       int slots) {
  const int rel = (int)(d - clo);
  const int owner = rel / R;
  int* list = cluster.map_shared_rank(lists, owner) + (rel - owner * R) * slots;
  int v = g * (m + 1);
  if (*(volatile int*)(list + slots - 1) < v) return;
  const int count = valid_count(ok + (long long)g * m, m);
  if (count == 0) return;
  v += count;
  for (int j = 0; j < slots; ++j) {
    const int old = atomicMin(list + j, v);
    if (old == kEmpty) break;
    v = max(old, v);
  }
}

__global__ void __launch_bounds__(kThreads)
    inbox_kernel(const int* __restrict__ dst, const int* __restrict__ subj,
                 const int* __restrict__ key, const uint8_t* __restrict__ ok,
                 int* __restrict__ out_subj, int* __restrict__ out_key, int G,
                 int m, int n, int slots, int R) {
  extern __shared__ int smem[];
  int* lists = smem;  // [R][slots]: packet ids, then message indices
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* queue_g = smem + R * slots + warp * 64;  // this warp's queue
  int* queue_d = queue_g + 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int i = threadIdx.x; i < R * slots; i += kThreads) lists[i] = kEmpty;
  cluster.sync();  // every list of the cluster is empty before any insert

  // Phase A: the cluster's destinations are [clo, chi); CTA `owner` of
  // the cluster holds [clo + owner * R, clo + (owner + 1) * R). A round
  // covers csize * kThreads * kUnroll packets; warp w of CTA `rank` takes
  // kUnroll runs of 32 consecutive ones.
  const long long clo = (long long)(blockIdx.x - rank) * R;
  const long long chi = min((long long)n, clo + (long long)csize * R);
  const long long round = (long long)csize * kThreads * kUnroll;
  const long long first = ((long long)rank * kThreads + warp * 32) * kUnroll;
  int queued = 0;  // the same in every lane of the warp
  for (long long base = first; base < G; base += round) {
    int d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = base + u * 32 + lane;
      d[u] = g < G ? dst[g] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool hit = d[u] >= clo && d[u] < chi;
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (queued + __popc(hits) > 32) {
        __syncwarp();
        if (lane < queued)
          insert(cluster, lists, ok, queue_g[lane], queue_d[lane], clo, R, m,
                 slots);
        queued = 0;
        __syncwarp();
      }
      if (hit) {
        const int at = queued + __popc(hits & ((1u << lane) - 1));
        queue_g[at] = (int)(base + u * 32 + lane);
        queue_d[at] = d[u];
      }
      queued += __popc(hits);
    }
  }
  __syncwarp();
  if (lane < queued)
    insert(cluster, lists, ok, queue_g[lane], queue_d[lane], clo, R, m, slots);
  cluster.sync();

  // Phase B1: one thread per owned destination rewrites its list, in
  // shared memory only, as its row's columns: column c of packet g's
  // messages becomes g * (m + 1) + i, the i-th valid message of g.
  const long long lo = (long long)blockIdx.x * R;
  const int rows = (int)max(0LL, min((long long)R, n - lo));
  const int stride_g = m + 1;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    int* list = lists + r * slots;
    int packets = 0, total = 0;
    for (; packets < slots && list[packets] != kEmpty; ++packets)
      total += list[packets] % stride_g;
    int end = total;  // one past packet j's last column
    for (int j = packets - 1; j >= 0; --j) {
      const int g = list[j] / stride_g;
      const int count = list[j] - g * stride_g;
      int col = end - count;
      end = col;
      for (int i = 0; i < count && col < slots; ++i) list[col++] = g * stride_g + i;
    }
  }
  __syncthreads();

  // Phase B2: consecutive threads write consecutive cells of the block's
  // rows [lo, lo + rows) of both outputs; each finds its message (the
  // i-th true of its packet's ok row) and gathers its subj and key.
  int* os = out_subj + lo * slots;
  int* okey = out_key + lo * slots;
  const int cells = rows * slots;
  for (int e0 = threadIdx.x; e0 < cells; e0 += kThreads * kCellsPerThread) {
    int sv[kCellsPerThread], kv[kCellsPerThread];
#pragma unroll
    for (int u = 0; u < kCellsPerThread; ++u) {
      const int e = e0 + u * kThreads;
      const int v = e < cells ? lists[e] : kEmpty;
      sv[u] = n;
      kv[u] = 0;
      if (v != kEmpty) {
        const int g = v / stride_g;
        int i = v - g * stride_g;
        const long long base = (long long)g * m;
        int k_msg = 0;  // the i-th true of the ok row; no early exit, so
        for (int k = 0; k < m; ++k) {  // the row's loads issue together
          const bool t = ok[base + k];
          if (t && i == 0) k_msg = k;
          i -= t;
        }
        sv[u] = min(subj[base + k_msg], n);
        kv[u] = max(key[base + k_msg], 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kCellsPerThread; ++u) {
      const int e = e0 + u * kThreads;
      if (e < cells) {
        os[e] = sv[u];
        okey[e] = kv[u];
      }
    }
  }
}

int g_sms = 0;         // SMs of the card, read at the first call
int g_smem_limit = 0;  // dynamic shared memory a block may opt into

cudaError_t init_once() {
  if (g_sms) return cudaSuccess;
  int dev, sms, smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        inbox_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  g_smem_limit = smem;
  g_sms = sms;
  return cudaSuccess;
}

}  // namespace

// One launch on `stream`. Returns the CUDA error code of the launch (or of
// the first-call setup), 0 on success; cudaErrorInvalidValue for shapes
// the kernel does not take (G * (m + 1) >= INT_MAX, or one destination's list of
// `slots` ids and the warps' queues larger than a block's shared memory).
extern "C" int inbox_build(const int* dst, const int* subj, const int* key,
                           const uint8_t* ok, int* out_subj, int* out_key,
                           int G, int m, int n, int slots,
                           cudaStream_t stream) {
  if (n <= 0 || slots <= 0 || m < 0 || G < 0 ||
      (long long)G * (m + 1) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = init_once();
  if (err != cudaSuccess) return (int)err;
  const long long row_bytes = 4LL * slots;
  const long long list_bytes = g_smem_limit - kQueueBytes;
  if (row_bytes > list_bytes) return (int)cudaErrorInvalidValue;
  const int r_fit = (int)(list_bytes / row_bytes);
  const int per_sm = (int)(((long long)n + g_sms - 1) / g_sms);
  const int R = max(1, min(r_fit, per_sm));
  const int ranges = (n + R - 1) / R;
  const int blocks = (ranges + kCluster - 1) / kCluster * kCluster;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)(R * row_bytes + kQueueBytes);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, inbox_kernel, dst, subj, key, ok,
                                 out_subj, out_key, G, m, n, slots, R);
}
