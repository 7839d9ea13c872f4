// Fixed-order segment sums over a sorted index, for Hopper.
//
// Answers to the JAX package's fused scatter-adds: orb_slam_cuda_tpu/
// solvers/bundle_adjust.py:189-219 (`.at[ci].add` and `.at[pi].add` of the
// gradient bc, bp, the block diagonals Hcc, Hpp and the CG matvec's yc,
// yp) and orb_slam_cuda_tpu/solvers/pose_graph.py:94-112 (the essential
// graph's), which XLA fuses on the TPU. The port's plain version is
// ops/segsum.py::segsum_plain, `torch.segment_reduce` over the same index.
//
// In: vals (E, K) float32, contiguous (K is the product of the addends'
// trailing dims: 1, 3, 6, 7, 9, 36 or 49 at the call sites); order (E,)
// int64, the index's stable sort permutation; offsets (n+1) int64, segment
// s holding order[offsets[s] .. offsets[s+1]). Slots that the index leaves
// out lie past offsets[n] and are never read. Out: out (n, K) float32.
//
// For each segment s and column k one thread computes
//   acc = +0.0f; for j in [offsets[s], offsets[s+1]): acc = acc + vals[order[j]][k]
// with `__fadd_rn` (round to nearest, never contracted), one add after the
// other in index order: the order of `segment_reduce` on the card and of
// `index_add_` on the CPU, so each sum keeps their bits, and a run repeats
// bit for bit. A tree or a warp's shuffles would round in another order;
// atomics in none.
//
// Bound: the bytes are the valid addends read once (K floats and one
// index each), the offsets and the output: tens to hundreds of KB at the
// bundle adjustment's shapes, well under a microsecond at 3.35 TB/s. The
// kernel is latency: the longest valid segment's chain of dependent adds
// and the loads it waits on. Hence: threads laid out over (segment,
// column), so that the K lanes of one segment read a row's K floats
// together and order[j] is one broadcast load (for K <= 3 one warp covers
// many segments); the addends loaded BATCH at a time with no predicate, all
// in flight before the first is added and the next batch's indices read
// meanwhile, so a batch costs about one load's latency and BATCH adds
// (loads predicated on the segment's end were waited on one by one: ~85 ns
// an addend on the card, against ~18 ns in whole batches of 64); the
// padded slots, which held tens of thousands of zero addends in one
// segment, skipped by the index. No atomics, no host sync, one launch on
// the caller's stream, so the call runs inside captured CUDA graphs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BATCH = 64;

__global__ void __launch_bounds__(THREADS)
    segsum_kernel(const float* __restrict__ vals, const int64_t* __restrict__ order,
                  const int64_t* __restrict__ offsets, int64_t n, int k, float* __restrict__ out) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (gid >= n * k) return;
  const int64_t s = gid / k;
  const int col = static_cast<int>(gid - s * k);
  const int64_t lo = __ldg(offsets + s), hi = __ldg(offsets + s + 1);
  const float* base = vals + col;
  float acc = 0.0f;
  int64_t j = lo;
  if (j + BATCH <= hi) {
    // Whole batches, no predicate: the batch's rows are read while the
    // previous batch's addends are added, and its BATCH addends are all in
    // flight before the first of them is added.
    int row[BATCH];  // E < 2^31 (the wrapper checks): half the registers of int64
#pragma unroll
    for (int u = 0; u < BATCH; ++u) row[u] = static_cast<int>(__ldg(order + j + u));
    for (;;) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) v[u] = __ldg(base + static_cast<int64_t>(row[u]) * k);
      j += BATCH;
      const bool more = j + BATCH <= hi;
      if (more) {
#pragma unroll
        for (int u = 0; u < BATCH; ++u) row[u] = static_cast<int>(__ldg(order + j + u));
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) acc = __fadd_rn(acc, v[u]);
      if (!more) break;
    }
  }
  for (; j < hi; ++j) acc = __fadd_rn(acc, __ldg(base + __ldg(order + j) * k));
  out[gid] = acc;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when n * k == 0: nothing
// to launch).
extern "C" int segsum(const void* vals, const void* order, const void* offsets, int64_t n, int k, void* out,
                      void* stream) {
  if (n < 0 || k < 0 || !offsets || !out) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = n * k;
  if (threads == 0) return 0;
  const int64_t blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  segsum_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int64_t*>(order), static_cast<const int64_t*>(offsets), n,
      k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
