// Kernel K1: fused SSIM + L1 reprojection-loss map, forward.
//
// Replaces the Pallas TPU kernel deep_visual_slam_tpu/ops/pallas/
// photometric_pallas.py (_kernel5:41, launched by _forward_bands:83 through
// pl.pallas_call at :109) and computes exactly
// deep_visual_slam_tpu/ops/photometric.py:reprojection_loss:60:
//
//   per pixel and channel: reflect-pad 1; 3x3 box means, variances and
//   covariance of pred and target; SSIM loss clip((1 - n/d)/2, 0, 1) with
//   C1 = 0.01^2, C2 = 0.03^2; out = a * mean_c(SSIM) + (1-a) * mean_c(|t-p|)
//
//   pred, target: [B, H, W, C] fp32 NHWC, contiguous  ->  out: [B, H, W, 1] fp32
//
// Bound: memory. Each input is read once (C*4 bytes a pixel) and the output
// written once (4 bytes a pixel); the arithmetic is 105 fp32 operations per
// channel-pixel plus 5 per pixel. At B=16 x 480 x 640 x 3 that is
// 2 * 59.0 MB in and 19.7 MB out, 137.6 MB: ~41 us at an H100 SXM's
// 3.35 TB/s, against ~23 us for 1.57 GFLOP at its 67 TFLOP/s of fp32.
// chip_smoke.py measures the kernel against this bound (PERF.md).
//
// Design: one thread per output pixel, a 32x8 block of pixels, one grid z
// slice per image. The thread reads its 3x3 neighbourhood straight from the
// NHWC inputs; the reflect padding is index arithmetic (no padded copy, no
// band stacking as on the TPU), and the 9x re-reads of neighbouring pixels
// are served by L1/L2. The five box sums are kept in registers, one channel
// at a time; C is a runtime argument. The taps are summed in the plain
// PyTorch version's order (row-major over the 3x3 window) and the file is
// built with -fmad=false, so each product and sum rounds as there.

#include <cuda_runtime.h>

namespace {

// The JAX and PyTorch versions take these as double-precision Python
// constants rounded to fp32 where they are used.
constexpr float kC1 = static_cast<float>(0.01 * 0.01);
constexpr float kC2 = static_cast<float>(0.03 * 0.03);

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__global__ void reprojection_loss_kernel(const float* __restrict__ pred,
                                         const float* __restrict__ target,
                                         float* __restrict__ out, int H, int W,
                                         int C, float alpha, float beta) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t image = static_cast<size_t>(blockIdx.z) * H * W;
  const float* p = pred + image * C;
  const float* t = target + image * C;

  size_t tap[9];  // pixel offsets of the reflect-padded 3x3 window
  for (int i = 0; i < 3; ++i) {
    const size_t row = static_cast<size_t>(reflect(y + i - 1, H)) * W;
    for (int j = 0; j < 3; ++j) {
      tap[i * 3 + j] = (row + reflect(x + j - 1, W)) * C;
    }
  }

  float ssim_sum = 0.0f;
  float l1_sum = 0.0f;
  for (int c = 0; c < C; ++c) {
    float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float a = p[tap[k] + c];
      const float b = t[tap[k] + c];
      sx += a;
      sy += b;
      sxx += a * a;
      syy += b * b;
      sxy += a * b;
    }
    const float mu_x = sx / 9.0f;
    const float mu_y = sy / 9.0f;
    const float sigma_x = sxx / 9.0f - mu_x * mu_x;
    const float sigma_y = syy / 9.0f - mu_y * mu_y;
    const float sigma_xy = sxy / 9.0f - mu_x * mu_y;
    const float n = (2.0f * mu_x * mu_y + kC1) * (2.0f * sigma_xy + kC2);
    const float d = (mu_x * mu_x + mu_y * mu_y + kC1) * (sigma_x + sigma_y + kC2);
    ssim_sum += fminf(fmaxf((1.0f - n / d) * 0.5f, 0.0f), 1.0f);
    l1_sum += fabsf(t[tap[4] + c] - p[tap[4] + c]);
  }
  out[image + static_cast<size_t>(y) * W + x] =
      alpha * (ssim_sum / C) + beta * (l1_sum / C);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// beta = 1 - alpha, rounded by the caller as the plain version rounds it.
extern "C" int reprojection_loss_forward(const float* pred, const float* target,
                                         float* out, int B, int H, int W, int C,
                                         float alpha, float beta, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
  reprojection_loss_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      pred, target, out, H, W, C, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
