// Fixed-order segment sums over a sorted index, for Hopper.
//
// Answers to the JAX package's fused scatter-adds: orb_slam_cuda_tpu/
// solvers/bundle_adjust.py:189-219 (`.at[ci].add` and `.at[pi].add` of the
// gradient bc, bp, the block diagonals Hcc, Hpp and the CG matvec's yc,
// yp) and orb_slam_cuda_tpu/solvers/pose_graph.py:94-112 (the essential
// graph's), which XLA fuses on the TPU. The port's plain version is
// ops/segsum.py::segsum_plain, `torch.segment_reduce` over the same index.
//
// In: vals (E, K) float32, contiguous, its base 4-byte aligned (K is the
// product of the addends' trailing dims: 1, 3, 6, 7, 9, 36 or 49 at the
// call sites); order (E,) int64, the index's stable sort permutation;
// offsets (n+1) int64, segment s holding order[offsets[s] .. offsets[s+1]).
// Slots that the index leaves out lie past offsets[n] and are never read.
// Out: out (n, K) float32.
//
// For each segment s and column k the sum is
//   acc = +0.0f; for j in [offsets[s], offsets[s+1]): acc = acc + vals[order[j]][k]
// with `__fadd_rn` (round to nearest, never contracted), one add after the
// other in index order: the order of `segment_reduce` on the card and of
// `index_add_` on the CPU, so each sum keeps their bits, and a run repeats
// bit for bit. A tree or a warp's shuffles would round in another order;
// atomics in none. Both kernels below compute exactly that sum.
//
// Bound: the bytes are the valid addends read once (K floats and one index
// each), the offsets and the output: tens to hundreds of KB at the bundle
// adjustment's shapes, well under a microsecond at 3.35 TB/s. The work is
// latency: the longest segment's chain of dependent adds (4.06 cycles each
// on the card, ~1.5 us for the local BA's 746-addend camera chain at 1,980
// MHz) and the loads that chain would wait on. Two kernels, one launch a
// call either way:
//
// - segsum_block_kernel, for few, long segments (the camera sums: 24 or
//   128 segments of up to ~750 addends): a block of 128 threads a segment,
//   compiled for each width K of the call sites. Warps 1-3 copy the
//   segment's rows, a tile of T rows at a time, into a ring of three tiles
//   in shared memory with `cp.async`: neighbouring threads copy
//   neighbouring 16 bytes of a row where K and the base allow, else 8 or 4
//   (any 4-byte aligned base works). The tile's indices come through the
//   same copies two tiles ahead of its rows, and a producer reads four of
//   them before it issues their copies. Thread j < (K + 1) / 2 of warp 0
//   adds columns 2j and 2j + 1, each in index order into its own sum,
//   reading 16 rows ahead of the adds from shared memory at immediate
//   offsets (K is a constant), while the ring fills the next two tiles.
//   Hopper's TMA copies boxes of a tensor and cannot gather rows by an
//   index on sm_90, hence `cp.async`. Measured on the card (clock64 stamps
//   in a copy of this source): the first tile lands ~2,300 cycles after
//   the block starts (the offsets, the indices and the rows: three
//   dependent reads); the adds then take ~7-10 cycles a row, not 4; at K =
//   36 the copies, ~1,300 cycles a 96-row tile (~10 bytes a cycle into one
//   SM), set the pace instead.
// - segsum_rows_kernel, for many short segments (the point sums, <= ~24
//   addends; the essential graph's vertex sums; the BoW rows; the map's
//   sums): a thread a (segment, column), its addends loaded 8 at a time,
//   all in flight before the first is added and the next 8 indices read
//   meanwhile; the last batch's indices clamped to the segment's last
//   slot, so no load waits on a predicate (loads predicated on the
//   segment's end were waited on one by one: ~85 ns an addend on the card)
//   and the clamped addends are never added. A long segment costs it one
//   load latency every 8 addends, so the solvers and the map's point
//   normals leave their padded slots out of the index
//   (`segment_index(n, idx, valid)`).
//
// The rule (`segsum`), from n and K alone, nothing read back: the block
// kernel for the camera sums' widths (K = 1, 6, 36) over at most
// BLOCK_MAX_SEGMENTS segments (a bundle adjustment's cameras), else the
// rows kernel. Set by tests/torch_segsum_ab.py on an NVIDIA H100 80GB HBM3
// at 700.00 W (PERF.md §6): at the local BA's camera sums
// (746-addend chains) the block kernel 0.0081 ms (Hcc) and 0.0062 (bc)
// against the rows kernel's 0.041 and 0.042; at the point sums (<= 5
// addends) the rows kernel 0.0030 (local Hpp) and 0.0053 (global Hpp)
// against 0.0074 and 0.040; at an essential graph's Hd (256 vertices, <= 16
// addends) the rows kernel 0.0034 against 0.0037.
//
// No atomics, no host sync, one launch on the caller's stream, so the call
// runs inside captured CUDA graphs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// segsum_block_kernel
constexpr int BLOCK_THREADS = 128;
constexpr int PRODUCER0 = 32;                       // threads 0..(K-1)/2 add, warps 1.. copy
constexpr int COPY_AHEAD = 4;                       // indices a producer reads before their copies
constexpr int PRODUCERS = BLOCK_THREADS - PRODUCER0;
constexpr int STAGES = 3;                           // tiles in the ring
constexpr int INDEX_SLOTS = 2 * STAGES - 2;         // tiles of indices
constexpr int TILE_FLOATS = 3456;                   // a tile's rows x K floats at most
constexpr int TILE_ROWS = 256;                      // a tile's rows at most
constexpr int ADD_AHEAD = 16;                       // rows an adder reads ahead; T is a multiple
constexpr int64_t BLOCK_MAX_SEGMENTS = 512;

// segsum_rows_kernel
constexpr int ROWS_THREADS = 128;
constexpr int ROWS_BATCH = 8;

// Rows a tile holds at width k: 256 for K <= 13, 96 at K = 36, 64 at K =
// 49. tests/torch_segsum_cases.py::block_tile_rows mirrors it.
__host__ __device__ constexpr int tile_rows(int k) {
  return (TILE_FLOATS / k < TILE_ROWS ? TILE_FLOATS / k : TILE_ROWS) / ADD_AHEAD * ADD_AHEAD;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One adder's two columns (col[0], col[1]) of `rows` rows of a tile in
// shared memory (row stride K), each added in row order into its own sum:
// two chains in one thread, so that each waits only on its own adds while
// the other's run. K is known here, so every load's address is one base
// and an immediate offset (one 8-byte load a row for the pair where K is
// even). The loads run a batch of ADD_AHEAD rows ahead of the adds, two
// batches a turn so that no register is copied, and unpredicated: the last
// batch reads up to ADD_AHEAD rows past the tile, into the next tile or the
// ring's pad, and adds only the tile's rows. Where K is odd, the last
// adder's second chain reads the next row's first column and is not kept.
template <int K>
__device__ __forceinline__ float2 load_pair(const float* col, int row) {
  if constexpr (K % 2 == 0) {
    return *reinterpret_cast<const float2*>(col + row * K);
  } else {
    return make_float2(col[row * K], col[row * K + 1]);
  }
}

__device__ __forceinline__ void add_pair(float2& acc, float2 v) {
  acc.x = __fadd_rn(acc.x, v.x);
  acc.y = __fadd_rn(acc.y, v.y);
}

template <int K>
__device__ __forceinline__ void add_tile(const float* col, int rows, float2& acc) {
  float2 v[ADD_AHEAD], w[ADD_AHEAD];
#pragma unroll
  for (int u = 0; u < ADD_AHEAD; ++u) v[u] = load_pair<K>(col, u);
  int r = 0;
  for (; r + 2 * ADD_AHEAD <= rows; r += 2 * ADD_AHEAD) {
#pragma unroll
    for (int u = 0; u < ADD_AHEAD; ++u) w[u] = load_pair<K>(col, r + ADD_AHEAD + u);
#pragma unroll
    for (int u = 0; u < ADD_AHEAD; ++u) add_pair(acc, v[u]);
#pragma unroll
    for (int u = 0; u < ADD_AHEAD; ++u) v[u] = load_pair<K>(col, r + 2 * ADD_AHEAD + u);
#pragma unroll
    for (int u = 0; u < ADD_AHEAD; ++u) add_pair(acc, w[u]);
  }
  if (r + ADD_AHEAD <= rows) {
#pragma unroll
    for (int u = 0; u < ADD_AHEAD; ++u) w[u] = load_pair<K>(col, r + ADD_AHEAD + u);
#pragma unroll
    for (int u = 0; u < ADD_AHEAD; ++u) add_pair(acc, v[u]);
#pragma unroll
    for (int u = 0; u < ADD_AHEAD; ++u) v[u] = w[u];
    r += ADD_AHEAD;
  }
  if (r < rows) {
#pragma unroll
    for (int u = 0; u < ADD_AHEAD; ++u) {
      if (u < rows - r) add_pair(acc, v[u]);
    }
  }
}

// One block a segment, K floats an addend, VEC floats a copy (4, 2 or 1):
// K % VEC == 0 and the base of vals aligned to 4 * VEC bytes.
template <int K, int VEC>
__global__ void __launch_bounds__(BLOCK_THREADS)
    segsum_block_kernel(const float* __restrict__ vals, const int64_t* __restrict__ order,
                        const int64_t* __restrict__ offsets, float* __restrict__ out) {
  constexpr int T = tile_rows(K);
  constexpr int KV = K / VEC;
  constexpr int ADDERS = (K + 1) / 2;
  __shared__ __align__(16) float ring[STAGES * T * K + (ADD_AHEAD + 1) * K];  // + the pad add_tile reads into
  __shared__ __align__(16) int64_t rows_ring[INDEX_SLOTS][T];
  const int64_t s = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t lo = __ldg(offsets + s), len = __ldg(offsets + s + 1) - lo;
  const int64_t tiles = (len + T - 1) / T;
  const bool producer = tid >= PRODUCER0;
  const int p = tid - PRODUCER0;

  auto rows_of = [&](int64_t t) { return static_cast<int>(len - t * T < T ? len - t * T : T); };
  // Tile t's indices into rows_ring[t % INDEX_SLOTS].
  auto copy_indices = [&](int64_t t) {
    if (!producer || t >= tiles) return;
    const int rows = rows_of(t);
    int64_t* dst = rows_ring[t % INDEX_SLOTS];
    const int64_t* src = order + lo + t * T;
    for (int i = p; i < rows; i += PRODUCERS) cp_async<8>(dst + i, src + i);
  };
  // Tile t's rows into its slot of the ring: a producer's vectors f = p,
  // p + PRODUCERS, ... of the tile's rows x KV (neighbouring threads copy
  // neighbouring bytes of a row), COPY_AHEAD indices read (clamped into the
  // tile) before their copies are issued.
  auto copy_rows = [&](int64_t t) {
    if (!producer || t >= tiles) return;
    const int vecs = rows_of(t) * KV;
    const int64_t* idx = rows_ring[t % INDEX_SLOTS];
    float* dst = ring + t % STAGES * T * K;
    for (int f0 = p; f0 < vecs; f0 += COPY_AHEAD * PRODUCERS) {
      const float* src[COPY_AHEAD];
#pragma unroll
      for (int c = 0; c < COPY_AHEAD; ++c) {
        const int f = f0 + c * PRODUCERS, row = f / KV < T ? f / KV : T - 1;
        src[c] = vals + idx[row] * K + (f - row * KV) * VEC;
      }
#pragma unroll
      for (int c = 0; c < COPY_AHEAD; ++c) {
        const int f = f0 + c * PRODUCERS;
        if (f < vecs) cp_async<4 * VEC>(dst + f * VEC, src[c]);
      }
    }
  };

  // Copy group G holds tile G's rows and tile G + STAGES - 1's indices
  // (INDEX_SLOTS slots of indices: a slot is written a barrier after its
  // last read); the indices of tiles 0 .. STAGES - 2 come first, in a
  // group waited on at once. The first turn issues groups 1 and 2 only
  // after tile 0 has landed, so that the adds start one copy after the
  // indices.
  for (int t = 0; t < STAGES - 1; ++t) copy_indices(t);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  copy_rows(0);
  copy_indices(STAGES - 1);
  cp_async_commit();
  float2 acc = make_float2(0.0f, 0.0f);
  for (int64_t t = 0; t < tiles; ++t) {
    if (t == 0) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<STAGES - 2>();  // this thread's copies of group t have landed
    }
    __syncthreads();  // everyone's; and tile t - 1 is added, its slot free
    for (int64_t g = t == 0 ? 1 : t + STAGES - 1; g <= t + STAGES - 1; ++g) {
      copy_rows(g);
      copy_indices(g + STAGES - 1);
      cp_async_commit();
    }
    if (tid < ADDERS) add_tile<K>(ring + t % STAGES * T * K + 2 * tid, rows_of(t), acc);
  }
  cp_async_wait<0>();
  if (tid < ADDERS) {
    out[s * K + 2 * tid] = acc.x;
    if (2 * tid + 1 < K) out[s * K + 2 * tid + 1] = acc.y;
  }
}

// One thread a (segment, column).
__global__ void __launch_bounds__(ROWS_THREADS)
    segsum_rows_kernel(const float* __restrict__ vals, const int64_t* __restrict__ order,
                       const int64_t* __restrict__ offsets, int64_t n, int k, float* __restrict__ out) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * ROWS_THREADS + threadIdx.x;
  if (gid >= n * k) return;
  const int64_t s = gid / k;
  const int col = static_cast<int>(gid - s * k);
  const int64_t lo = __ldg(offsets + s), hi = __ldg(offsets + s + 1);
  const float* base = vals + col;
  float acc = 0.0f;
  if (hi > lo) {
    const int64_t last = hi - 1;
    int row[ROWS_BATCH];  // E < 2^31 (the wrapper checks)
#pragma unroll
    for (int u = 0; u < ROWS_BATCH; ++u) row[u] = static_cast<int>(__ldg(order + (lo + u < last ? lo + u : last)));
    for (int64_t j = lo;;) {
      float v[ROWS_BATCH];
#pragma unroll
      for (int u = 0; u < ROWS_BATCH; ++u) v[u] = __ldg(base + static_cast<int64_t>(row[u]) * k);
      const int64_t left = hi - j;
      j += ROWS_BATCH;
      const bool more = j < hi;
      if (more) {
#pragma unroll
        for (int u = 0; u < ROWS_BATCH; ++u) row[u] = static_cast<int>(__ldg(order + (j + u < last ? j + u : last)));
      }
#pragma unroll
      for (int u = 0; u < ROWS_BATCH; ++u) acc = u < left ? __fadd_rn(acc, v[u]) : acc;
      if (!more) break;
    }
  }
  out[gid] = acc;
}

bool bad_args(int64_t n, int k, const void* offsets, const void* out) { return n < 0 || k < 0 || !offsets || !out; }

bool block_width(int k) { return k == 1 || k == 3 || k == 6 || k == 7 || k == 9 || k == 36 || k == 49; }

template <int K>
int launch_block(const void* vals, const void* order, const void* offsets, int64_t n, void* out, void* stream) {
  const auto base = reinterpret_cast<uintptr_t>(vals);
  const auto v = static_cast<const float*>(vals);
  const auto o = static_cast<const int64_t*>(order);
  const auto off = static_cast<const int64_t*>(offsets);
  const auto dst = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n));
  if constexpr (K % 4 == 0) {
    if (base % 16 == 0) {
      segsum_block_kernel<K, 4><<<grid, BLOCK_THREADS, 0, st>>>(v, o, off, dst);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if constexpr (K % 2 == 0) {
    if (base % 8 == 0) {
      segsum_block_kernel<K, 2><<<grid, BLOCK_THREADS, 0, st>>>(v, o, off, dst);
      return static_cast<int>(cudaGetLastError());
    }
  }
  segsum_block_kernel<K, 1><<<grid, BLOCK_THREADS, 0, st>>>(v, o, off, dst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch (0 when n * k ==
// 0: nothing to launch).

// The block kernel, at the call sites' widths K = 1, 3, 6, 7, 9, 36, 49.
extern "C" int segsum_block(const void* vals, const void* order, const void* offsets, int64_t n, int k, void* out,
                            void* stream) {
  if (bad_args(n, k, offsets, out)) return static_cast<int>(cudaErrorInvalidValue);
  if (n * k == 0) return 0;
  if (n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (k) {
    case 1: return launch_block<1>(vals, order, offsets, n, out, stream);
    case 3: return launch_block<3>(vals, order, offsets, n, out, stream);
    case 6: return launch_block<6>(vals, order, offsets, n, out, stream);
    case 7: return launch_block<7>(vals, order, offsets, n, out, stream);
    case 9: return launch_block<9>(vals, order, offsets, n, out, stream);
    case 36: return launch_block<36>(vals, order, offsets, n, out, stream);
    case 49: return launch_block<49>(vals, order, offsets, n, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int segsum_rows(const void* vals, const void* order, const void* offsets, int64_t n, int k, void* out,
                           void* stream) {
  if (bad_args(n, k, offsets, out)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = n * k;
  if (threads == 0) return 0;
  const int64_t blocks = (threads + ROWS_THREADS - 1) / ROWS_THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  segsum_rows_kernel<<<static_cast<unsigned>(blocks), ROWS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int64_t*>(order), static_cast<const int64_t*>(offsets), n,
      k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// 1 where `segsum` launches the block kernel at (n, k), 0 where the rows
// kernel.
extern "C" int segsum_uses_block(int64_t n, int k) {
  return n <= BLOCK_MAX_SEGMENTS && (k == 1 || k == 6 || k == 36) ? 1 : 0;
}

// The block kernel's rows a tile at width k (0 where it does not take k).
extern "C" int segsum_tile_rows(int k) { return block_width(k) ? tile_rows(k) : 0; }

extern "C" int segsum(const void* vals, const void* order, const void* offsets, int64_t n, int k, void* out,
                      void* stream) {
  return segsum_uses_block(n, k) ? segsum_block(vals, order, offsets, n, k, out, stream)
                                 : segsum_rows(vals, order, offsets, n, k, out, stream);
}
