// FAST-9 corners of a whole image pyramid in one launch, for Hopper.
//
// Answers to orb_slam_cuda_tpu/ops/pallas_fast.py::fast_score_pallas (body
// _fast_kernel), the one TPU Pallas kernel of the reference, and to the
// plain ops the reference runs on its two outputs
// (frontend/extractor.py::_extract_impl: nms3x3 twice,
// two_threshold_cell_select, the border mask of _select_spatial_topk).
// Two entry points share one arithmetic through a compile-time switch:
//
//   fast_corners_pyramid  (RAW = false) per level: the FAST-9 score, kept
//     above each of two thresholds 3 px inside the image; 3x3 non-maximum
//     suppression of each thresholded map; per 32x32 cell the high map
//     where the cell holds any high corner, else the low map; zero outside
//     the keypoint border. One float map per level is written, nothing else.
//   fast_score_pair       (RAW = true) one level, the two thresholded maps
//     before suppression: the Pallas kernel's own function.
//
// Every step is a float subtraction, min, max, negation or compare, in any
// order the same bits, so both equal their plain torch versions
// (frontend/fast.py) bit for bit.
//
// Bound, at the 8 levels of a 1241x376 frame (376x1241 ... 105x346,
// 1,444,097 pixels): the fused function must read 4 B and write 4 B a
// pixel, 11.55 MB, 3.4 us at 3.35 TB/s. Computed densely it needs about
// 192 float operations a pixel (16 differences, 2 x (64 + 15) sliding and
// final min/max, 8 neighbour maxes, the compares), 0.28 Gop, 4.1 us at
// 67 TFLOP/s: bound by operations, by a little. With the quick test below
// the operations depend on the image (about 21 a pixel, and the 176 of the
// full score on the few per cent of pixels that pass), and the bytes bind.
// The raw pair writes 8 B a pixel (17.33 MB, 5.2 us) and is bound by bytes
// either way.
//
// What the design does about it:
//  - One launch for all levels. The launch carries a table of levels by
//    value; the grid is 1-D over all 32x32 tiles (1,497 at the shapes
//    above) and a block finds its level from the prefix of tile counts, so
//    the small levels ride in the same waves as level 0 instead of each
//    starting and draining the card alone.
//  - A tile is one cell of the two-threshold choice (cells are anchored at
//    (0,0) and ragged at the right and bottom edges), so the cell's vote is
//    one __syncthreads_or and never leaves the block.
//  - The block stages its tile plus a 4-px halo (3 for the circle, 1 for
//    the neighbours' scores) in shared memory with edge-clamped loads,
//    computes the score once on 34x34 pixels into shared memory, and
//    thresholds, suppresses, votes and masks from there: 4 B read and 4 B
//    written a pixel, where the two raw maps cost 8 B written and several
//    re-reads by the plain ops.
//  - A quick test first: the 4 compass pixels of the circle bound the score
//    from above, and a pixel whose bound does not pass the lower threshold
//    gets score 0, which every later step treats as it would the true
//    value. The pixels that pass (a few per cent of a natural image, all of
//    a noise image) are queued in shared memory and scored densely over the
//    threads, so a warp does not idle on its one corner.
//  - The 9-arc minimum over the 16 starts is a sliding minimum (windows of
//    2, 4, 8, then 9: 64 mins, not 128), and the dark polarity's min(-d) is
//    -max(d), so one set of 16 differences serves both polarities.
//  - Thresholding commutes with the max over neighbours (x > t ? x : 0 is
//    monotone for t >= 0), so one 8-neighbour max serves both thresholds.
//  - Loads are 4-byte and coalesced along rows (40 consecutive floats a
//    row): at width 1241 a row starts on no 8- or 16-byte boundary, and the
//    tile's first column (32k - 4) shifts with the row, so wider loads would
//    need a per-row realignment that the 6.4 KB tile does not repay. TMA
//    needs 16-byte-aligned row strides, which these images do not have, and
//    clusters have nothing to share across a tile this small; neither is
//    used.

#include <cuda_runtime.h>

namespace {

constexpr int CELL = 32;        // tile edge = cell of the two-threshold choice
constexpr int R = 3;            // circle radius, and the masked image border
constexpr int NT = 256;         // threads a block
constexpr int MAX_LEVELS = 16;

struct Level {
  const float* img;
  float* out;     // fused: the final map; raw: the high-threshold map
  float* out_lo;  // raw only: the low-threshold map
  int h, w;
  int tiles_x;
  int first_tile;  // prefix sum of tile counts
};

struct Table {
  Level lv[MAX_LEVELS];
  int n;
};

// The 16 differences circle-minus-centre at the pixel `p` points to (row
// stride `stride`), clockwise from 12 o'clock.
__device__ __forceinline__ void circle_diffs(const float* p, int stride,
                                             float (&d)[16]) {
  const float c = p[0];
#define TAP(k, dy, dx) d[k] = p[(dy) * stride + (dx)] - c;
  TAP(0, -3, 0) TAP(1, -3, 1) TAP(2, -2, 2) TAP(3, -1, 3)
  TAP(4, 0, 3) TAP(5, 1, 3) TAP(6, 2, 2) TAP(7, 3, 1)
  TAP(8, 3, 0) TAP(9, 3, -1) TAP(10, 2, -2) TAP(11, 1, -3)
  TAP(12, 0, -3) TAP(13, -1, -3) TAP(14, -2, -2) TAP(15, -3, -1)
#undef TAP
}

// An upper bound of the score from the 4 compass pixels of the circle (12,
// 3, 6 and 9 o'clock): an arc of 9 holds two neighbouring compass pixels, so
// a bright arc's minimum is at most the largest min of such a pair, and a
// dark arc's at most minus the smallest max.
__device__ __forceinline__ float score_upper_bound(const float* p, int stride) {
  const float c = p[0];
  const float n = p[-R * stride] - c;
  const float e = p[R] - c;
  const float s = p[R * stride] - c;
  const float w = p[-R] - c;
  const float bright = fmaxf(fmaxf(fminf(n, e), fminf(e, s)),
                             fmaxf(fminf(s, w), fminf(w, n)));
  const float dark = fminf(fminf(fmaxf(n, e), fmaxf(e, s)),
                           fminf(fmaxf(s, w), fmaxf(w, n)));
  return fmaxf(bright, -dark);
}

// FAST-9 score: over both polarities, the max over the 16 arc starts of the
// min margin along 9 contiguous circle pixels.
__device__ __forceinline__ float arc9_score(const float (&d)[16]) {
  float mn[16], mx[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // windows of 2
    mn[i] = fminf(d[i], d[(i + 1) & 15]);
    mx[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
  float mn4[16], mx4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // windows of 4
    mn4[i] = fminf(mn[i], mn[(i + 2) & 15]);
    mx4[i] = fmaxf(mx[i], mx[(i + 2) & 15]);
  }
  float bright = __int_as_float(0xff800000);  // max over starts of min over arc
  float dark = __int_as_float(0x7f800000);    // min over starts of max over arc
#pragma unroll
  for (int i = 0; i < 16; ++i) {  // windows of 8, then 9
    const float a = fminf(fminf(mn4[i], mn4[(i + 4) & 15]), d[(i + 8) & 15]);
    const float b = fmaxf(fmaxf(mx4[i], mx4[(i + 4) & 15]), d[(i + 8) & 15]);
    bright = fmaxf(bright, a);
    dark = fminf(dark, b);
  }
  return fmaxf(bright, -dark);
}

__device__ __forceinline__ float above(float v, float th) {
  return v > th ? v : 0.0f;
}

template <bool RAW>
__global__ void __launch_bounds__(NT)
fast_kernel(const __grid_constant__ Table tab, float th_hi, float th_lo,
            int border) {
  constexpr int HALO = RAW ? 0 : 1;      // score halo for the NMS neighbours
  constexpr int SW = CELL + 2 * HALO;    // score tile edge
  constexpr int IW = SW + 2 * R;         // image tile edge
  __shared__ float img_s[IW * IW];
  __shared__ float sc_s[SW * SW];
  __shared__ unsigned short cand[SW * SW];  // pixels that pass the quick test
  __shared__ int n_cand;

  const int b = blockIdx.x;
  int l = 0;
  for (int i = 1; i < tab.n; ++i) {
    if (b >= tab.lv[i].first_tile) l = i;
  }
  const Level& lv = tab.lv[l];
  const int h = lv.h;
  const int w = lv.w;
  const int t = b - lv.first_tile;
  const int tile_y = t / lv.tiles_x;
  const int x0 = (t - tile_y * lv.tiles_x) * CELL;
  const int y0 = tile_y * CELL;
  const float* __restrict__ img = lv.img;

  if (threadIdx.x == 0) n_cand = 0;
  for (int i = threadIdx.x; i < IW * IW; i += NT) {
    const int r = i / IW;
    const int c = i - r * IW;
    const int gy = min(max(y0 + r - (R + HALO), 0), h - 1);
    const int gx = min(max(x0 + c - (R + HALO), 0), w - 1);
    img_s[i] = img[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  // Quick test on every pixel of the score tile. A score that cannot pass
  // the lower threshold is written as 0, which every later step treats as
  // it would the true value; the others queue for the full score. The
  // score is 0 where the circle leaves the image (that covers every pixel
  // outside the image too, so a missing neighbour never suppresses).
  const float th_min = fminf(th_hi, th_lo);
  for (int i = threadIdx.x; i < SW * SW; i += NT) {
    const int r = i / SW;
    const int c = i - r * SW;
    const int y = y0 + r - HALO;
    const int x = x0 + c - HALO;
    sc_s[i] = 0.0f;
    if (y >= R && y < h - R && x >= R && x < w - R) {
      if (score_upper_bound(&img_s[(r + R) * IW + c + R], IW) > th_min) {
        cand[atomicAdd(&n_cand, 1)] = i;
      }
    }
  }
  __syncthreads();
  // Full score of the queued pixels, dense over the threads.
  for (int j = threadIdx.x; j < n_cand; j += NT) {
    const int i = cand[j];
    const int r = i / SW;
    float d[16];
    circle_diffs(&img_s[(r + R) * IW + (i - r * SW) + R], IW, d);
    sc_s[i] = arc9_score(d);
  }
  __syncthreads();

  constexpr int PER = CELL * CELL / NT;
  if constexpr (RAW) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      const int y = y0 + i / CELL;
      const int x = x0 + i % CELL;
      if (y >= h || x >= w) continue;
      const size_t o = static_cast<size_t>(y) * w + x;
      lv.out[o] = above(sc_s[i], th_hi);
      lv.out_lo[o] = above(sc_s[i], th_lo);
    }
  } else {
    float keep_hi[PER], keep_lo[PER];
    bool vote = false;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      const float* q = &sc_s[(i / CELL + HALO) * SW + (i % CELL) + HALO];
      const float v = q[0];
      float m = fmaxf(fmaxf(q[-SW - 1], q[-SW]), fmaxf(q[-SW + 1], q[-1]));
      m = fmaxf(m, fmaxf(fmaxf(q[1], q[SW - 1]), fmaxf(q[SW], q[SW + 1])));
      const float vh = above(v, th_hi);
      const float vl = above(v, th_lo);
      keep_hi[k] = vh >= above(m, th_hi) ? vh : 0.0f;
      keep_lo[k] = vl >= above(m, th_lo) ? vl : 0.0f;
      vote = vote || keep_hi[k] > 0.0f;
    }
    // The cell's vote counts corners in the border too: it is taken before
    // the border is zeroed, as the plain composition does.
    const bool cell_has_hi = __syncthreads_or(vote);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      const int y = y0 + i / CELL;
      const int x = x0 + i % CELL;
      if (y >= h || x >= w) continue;
      const bool inside = y >= border && y < h - border && x >= border && x < w - border;
      const float s = cell_has_hi ? keep_hi[k] : keep_lo[k];
      lv.out[static_cast<size_t>(y) * w + x] = inside ? s : 0.0f;
    }
  }
}

int fill_table(Table* tab, const void* const* imgs, void* const* outs,
               void* const* outs_lo, const int* hs, const int* ws, int n) {
  if (n <= 0 || n > MAX_LEVELS) return -1;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (hs[i] <= 0 || ws[i] <= 0 || !imgs[i] || !outs[i]) return -1;
    Level& lv = tab->lv[i];
    lv.img = static_cast<const float*>(imgs[i]);
    lv.out = static_cast<float*>(outs[i]);
    lv.out_lo = outs_lo ? static_cast<float*>(outs_lo[i]) : nullptr;
    lv.h = hs[i];
    lv.w = ws[i];
    lv.tiles_x = (ws[i] + CELL - 1) / CELL;
    lv.first_tile = tiles;
    tiles += lv.tiles_x * ((hs[i] + CELL - 1) / CELL);
  }
  tab->n = n;
  return tiles;
}

}  // namespace

// One launch over `n` levels (n <= 16). imgs/outs: device pointers of the
// contiguous float32 levels and their score maps; hs/ws: their shapes. All
// four arrays live on the host. Returns the cudaError of the launch.
extern "C" int fast_corners_pyramid(const void* const* imgs, void* const* outs,
                                    const int* hs, const int* ws, int n,
                                    float th_hi, float th_lo, int border,
                                    cudaStream_t s) {
  Table tab;
  const int tiles = fill_table(&tab, imgs, outs, nullptr, hs, ws, n);
  if (tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fast_kernel<false><<<tiles, NT, 0, s>>>(tab, th_hi, th_lo, border);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fast_score_pair(const float* img, float* hi, float* lo, int h,
                               int w, float th_hi, float th_lo,
                               cudaStream_t s) {
  Table tab;
  const void* imgs[1] = {img};
  void* outs[1] = {hi};
  void* outs_lo[1] = {lo};
  const int tiles = fill_table(&tab, imgs, outs, outs_lo, &h, &w, 1);
  if (tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fast_kernel<true><<<tiles, NT, 0, s>>>(tab, th_hi, th_lo, 0);
  return static_cast<int>(cudaGetLastError());
}
