// Dense FAST-9 corner scores for two thresholds in one pass, for Hopper.
//
// Replaces orb_slam_cuda_tpu/ops/pallas_fast.py::_fast_kernel (the TPU
// Pallas kernel behind fast_score_pallas). Per pixel: the 16 differences
// circle-minus-centre on the radius-3 Bresenham circle, for both
// polarities the max over the 16 start positions of the min over 9
// contiguous differences, the larger of the two, kept where it is above
// the threshold and the pixel is 3 px inside the image. Only float
// subtraction, min, max and compares: the result equals the plain torch
// version (frontend/fast.py::fast_score) bit for bit.
//
// Bound: about 4 bytes read and 8 bytes written per pixel with ~300
// flops of min/max, so the kernel is memory-bound (1241x376 moves ~5.6 MB).
// Each 32x8 block stages its tile plus a 3-px halo (38x14 floats) in
// shared memory with edge-clamped loads, so each input pixel is read from
// device memory ~1.3 times instead of 17 (centre + 16 circle taps); the 16
// differences live in registers and both thresholded outputs are written
// from the one score. The TPU version's 128-lane width padding, 8-row DMA
// halo and lane rotations have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int R = 3;
constexpr int TW = BX + 2 * R;
constexpr int TH = BY + 2 * R;

__global__ void fast_score_pair_kernel(const float* __restrict__ img,
                                       float* __restrict__ hi,
                                       float* __restrict__ lo,
                                       int h, int w, float th_hi, float th_lo) {
  __shared__ float tile[TH][TW];
  const int x0 = blockIdx.x * BX;
  const int y0 = blockIdx.y * BY;
  for (int i = threadIdx.y * BX + threadIdx.x; i < TH * TW; i += BX * BY) {
    const int ty = i / TW;
    const int tx = i - ty * TW;
    const int gy = min(max(y0 + ty - R, 0), h - 1);
    const int gx = min(max(x0 + tx - R, 0), w - 1);
    tile[ty][tx] = img[gy * w + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const int ly = threadIdx.y + R;
  const int lx = threadIdx.x + R;
  const float c = tile[ly][lx];

  float d[16];
#define TAP(k, dy, dx) d[k] = tile[ly + (dy)][lx + (dx)] - c;
  TAP(0, -3, 0) TAP(1, -3, 1) TAP(2, -2, 2) TAP(3, -1, 3)
  TAP(4, 0, 3) TAP(5, 1, 3) TAP(6, 2, 2) TAP(7, 3, 1)
  TAP(8, 3, 0) TAP(9, 3, -1) TAP(10, 2, -2) TAP(11, 1, -3)
  TAP(12, 0, -3) TAP(13, -1, -3) TAP(14, -2, -2) TAP(15, -3, -1)
#undef TAP

  const float neg_inf = __int_as_float(0xff800000);
  float best_b = neg_inf;
  float best_d = neg_inf;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mb = d[s];
    float md = -d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(s + j) & 15];
      mb = fminf(mb, v);
      md = fminf(md, -v);
    }
    best_b = fmaxf(best_b, mb);
    best_d = fmaxf(best_d, md);
  }
  const float score = fmaxf(best_b, best_d);
  const bool interior = (y >= R) && (y < h - R) && (x >= R) && (x < w - R);
  const int o = y * w + x;
  hi[o] = (interior && score > th_hi) ? score : 0.0f;
  lo[o] = (interior && score > th_lo) ? score : 0.0f;
}

}  // namespace

extern "C" int fast_score_pair(const float* img, float* hi, float* lo, int h,
                               int w, float th_hi, float th_lo,
                               cudaStream_t s) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(BX, BY);
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  fast_score_pair_kernel<<<grid, block, 0, s>>>(img, hi, lo, h, w, th_hi,
                                                th_lo);
  return static_cast<int>(cudaGetLastError());
}
