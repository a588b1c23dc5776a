// Kernel K1: fused SSIM + L1 reprojection-loss map, forward and backward.
//
// The forward replaces the Pallas TPU kernel deep_visual_slam_tpu/ops/pallas/
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
//
// The backward replaces the custom_vjp backward of the same Pallas kernel
// (photometric_pallas.py:_bwd:136, which recomputes the VJP of the XLA
// formula) and gives dL/dpred from g = dL/dout [B, H, W] (dL/dtarget is the
// same launch with pred and target swapped: SSIM and |t - p| are symmetric).
// Two passes, deterministic, no atomics:
//
//   A (one thread per output pixel p): the window sums as in the forward,
//     then the chain rule through clamp, n/d, the moments and the means down
//     to three coefficients per channel, the gradient of L with respect to
//     p's window sums Sx, Sxx and Sxy, written to a scratch [3, C, B, H, W]:
//     planes, so that a warp's 32 neighbouring pixels store and load 128
//     contiguous bytes (an interleaved [B, H, W, C, 3] spreads each warp
//     store over 1152 bytes).
//   B (one thread per input pixel q): a gather over the 3x3 neighbours p,
//     dx_q = sum_(p, k): reflect(p + k) = q [gSx(p) + 2 x_q gSxx(p)
//     + y_q gSxy(p)] - beta / C * g_q * sign(y_q - x_q).
//
// The reflect padding makes the gather more than the plain neighbourhood: at
// rows (columns) 0 and n-1 a pixel appears twice in its neighbour's window
// (row 0's window reads row 1 through taps -1 and +1), so each neighbour p
// counts with its multiplicity, m = 1 + [p = 0, q = 1] + [p = n-1, q = n-2]
// per axis. The clamp passes the gradient on its closed interval [0, 1], as
// torch.clamp's backward does (the all-zero image sits on the bound 0).
//
// Bound: memory. pred, target and g are read once and dL/dpred written once:
// at B=16 x 480 x 640 x 3 that is 2 * 59.0 + 19.7 + 59.0 = 196.6 MB, ~59 us
// at 3.35 TB/s; the ~3 GFLOP of fp32 arithmetic takes ~45 us at 67 TFLOP/s.
// This simple design moves more: the scratch (3 floats a channel-pixel) is
// written by A and read back by B, and both passes re-read neighbours
// through L1/L2. A shared-memory tile that keeps the coefficients on chip is
// the faster design, left to a later change.

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

// Pass A of the backward: coef[k, c, p] = (dL/dSx, dL/dSxx, dL/dSxy)[k] of
// pixel p's window sums in channel c, for dL/dout = g, pred = x, target = y.
__global__ void reprojection_grad_coef_kernel(const float* __restrict__ pred,
                                              const float* __restrict__ target,
                                              const float* __restrict__ g,
                                              float* __restrict__ coef, int H,
                                              int W, int C, float alpha) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t image = static_cast<size_t>(blockIdx.z) * H * W;
  const size_t pixel = image + static_cast<size_t>(y) * W + x;
  const float* p = pred + image * C;
  const float* t = target + image * C;
  const float g_ssim = g[pixel] * alpha / C;  // dL/dSSIM_c before the clamp

  size_t tap[9];
  for (int i = 0; i < 3; ++i) {
    const size_t row = static_cast<size_t>(reflect(y + i - 1, H)) * W;
    for (int j = 0; j < 3; ++j) {
      tap[i * 3 + j] = (row + reflect(x + j - 1, W)) * C;
    }
  }

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
    const float a1 = 2.0f * mu_x * mu_y + kC1;
    const float a2 = 2.0f * sigma_xy + kC2;
    const float b1 = mu_x * mu_x + mu_y * mu_y + kC1;
    const float b2 = sigma_x + sigma_y + kC2;
    const float n = a1 * a2;
    const float d = b1 * b2;
    const float u = (1.0f - n / d) * 0.5f;
    const float g_u = (u >= 0.0f && u <= 1.0f) ? g_ssim : 0.0f;
    // u = (1 - n/d) / 2: du/dn = -1/(2d), du/dd = n/(2d^2).
    const float g_n = -0.5f * g_u / d;
    const float g_d = 0.5f * g_u * (n / d) / d;
    const float g_sigma_x = g_d * b1;        // through b2
    const float g_sigma_xy = 2.0f * g_n * a1;  // through a2
    // mu_x enters a1, b1, sigma_x (-mu_x^2) and sigma_xy (-mu_x mu_y).
    const float g_mu_x = 2.0f * mu_y * (g_n * a2) + 2.0f * mu_x * (g_d * b2) -
                         2.0f * mu_x * g_sigma_x - mu_y * g_sigma_xy;
    const size_t plane = static_cast<size_t>(gridDim.z) * H * W;  // B*H*W
    float* out = coef + static_cast<size_t>(c) * plane + pixel;
    out[0] = g_mu_x / 9.0f;
    out[C * plane] = g_sigma_x / 9.0f;
    out[2 * C * plane] = g_sigma_xy / 9.0f;
  }
}

// How many taps of neighbour p's reflect-padded window land on q, along one
// axis of length n, for |p - q| <= 1 and p inside [0, n).
__device__ __forceinline__ float multiplicity(int p, int q, int n) {
  return 1.0f + ((p == 0 && q == 1) ? 1.0f : 0.0f) +
         ((p == n - 1 && q == n - 2) ? 1.0f : 0.0f);
}

// Pass B of the backward: the gather of the coefficients onto each input
// pixel q, plus the L1 term.
__global__ void reprojection_grad_gather_kernel(const float* __restrict__ pred,
                                                const float* __restrict__ target,
                                                const float* __restrict__ g,
                                                const float* __restrict__ coef,
                                                float* __restrict__ grad, int H,
                                                int W, int C, float beta) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t image = static_cast<size_t>(blockIdx.z) * H * W;
  const size_t pixel = image + static_cast<size_t>(y) * W + x;
  const float g_l1 = g[pixel] * beta / C;
  const size_t plane = static_cast<size_t>(gridDim.z) * H * W;  // B*H*W

  for (int c = 0; c < C; ++c) {
    float s_x = 0.0f, s_xx = 0.0f, s_xy = 0.0f;
    for (int i = -1; i <= 1; ++i) {
      const int py = y + i;
      if (py < 0 || py >= H) continue;
      const float wy = multiplicity(py, y, H);
      for (int j = -1; j <= 1; ++j) {
        const int px = x + j;
        if (px < 0 || px >= W) continue;
        const float w = wy * multiplicity(px, x, W);
        const float* k = coef + static_cast<size_t>(c) * plane + image +
                         static_cast<size_t>(py) * W + px;
        s_x += w * k[0];
        s_xx += w * k[C * plane];
        s_xy += w * k[2 * C * plane];
      }
    }
    const float xq = pred[pixel * C + c];
    const float yq = target[pixel * C + c];
    const float diff = yq - xq;
    const float sign = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
    grad[pixel * C + c] = s_x + 2.0f * xq * s_xx + yq * s_xy - g_l1 * sign;
  }
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

// dL/dpred of the map above: g [B, H, W] (contiguous), pred and target
// [B, H, W, C]; coef is the caller's scratch of 3*C*B*H*W floats; grad
// [B, H, W, C] is written. Launches both passes on `stream` and returns the
// first cudaGetLastError() that is not 0 (0 on success).
extern "C" int reprojection_loss_backward(const float* pred, const float* target,
                                          const float* g, float* coef,
                                          float* grad, int B, int H, int W,
                                          int C, float alpha, float beta,
                                          void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  reprojection_grad_coef_kernel<<<grid, block, 0, s>>>(pred, target, g, coef,
                                                       H, W, C, alpha);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reprojection_grad_gather_kernel<<<grid, block, 0, s>>>(pred, target, g, coef,
                                                         grad, H, W, C, beta);
  return static_cast<int>(cudaGetLastError());
}
