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
// The backward replaces the custom_vjp backward of the same Pallas kernel
// (photometric_pallas.py:_bwd:136, which recomputes the VJP of the XLA
// formula) and gives dL/dpred from g = dL/dout [B, H, W] (dL/dtarget is the
// same launch with pred and target swapped: SSIM and |t - p| are symmetric).
//
// Bounds: memory. The forward reads pred and target once and writes the map
// once: at B=16 x 480 x 640 x 3 that is 137.6 MB, ~41 us at an H100 SXM's
// 3.35 TB/s (its 1.57 GFLOP of fp32 take ~23 us at 67 TFLOP/s). The backward
// reads pred, target and g and writes dL/dpred: 196.6 MB, ~59 us (~3 GFLOP,
// ~45 us). chip_smoke.py measures both kernels against these bounds. On the
// card both are held back by instruction issue instead: the window sums
// alone are 45 fp32 additions a channel-pixel, and the backward computes
// them for 1.2x the pixels, besides the chain rule and the gather
// (sass_report.py counts the instructions; PERF.md has the numbers).
//
// Design. Both kernels give a block one TW x TH = 32 x 16 tile of output
// pixels of one image (grid: tiles of W, tiles of H, B). 32 columns make a
// warp's row of the tile; 16 rows keep the halo's extra loads at
// (TW+2)(TH+2)/(TW*TH) = 1.2x in the forward and (TW+4)(TH+4)/(TW*TH) = 1.4x
// in the backward while a block's shared memory stays small enough for
// several blocks an SM. The block first copies its tile of pred and target,
// with a halo, into shared memory: a row of the tile is contiguous in NHWC,
// so consecutive threads read consecutive floats, and the reflect padding is
// applied as the tile is filled (index arithmetic only where a row reaches
// past the image's edge; most tiles lie inside the image and skip it).
// Every value then comes from device memory about once, not 9 times through
// L1. Shared memory keeps the NHWC order, with pred and target interleaved
// as (pred, target) pairs: one 64-bit load gives a tap of both, and a stride
// of C = 3 pairs between neighbouring threads is free of bank conflicts. A
// thread issues all its loads of the fill before its first store, so that
// they are in flight together.
//
// Forward: a 32 x 4 block; each thread computes R = 4 vertically neighbouring
// outputs. It reads each of the 6 x 3 tap values of its column strip from
// shared memory once, forms x^2, y^2 and xy once per value, and adds them to
// the box sums of every output whose window holds the value. Shared memory:
// 18 x 34 x C pairs, 14.7 KB at C = 3.
//
// Backward, one fused pass with no scratch in device memory: a 32 x 8 block
// loads pred and target with a 2-pixel halo and g with a 1-pixel halo. Per
// channel it then computes, for every pixel p of the tile plus a 1-pixel
// halo that lies inside the image, the window statistics and the gradient of
// L with respect to p's window sums Sx, Sxx and Sxy (0 outside the image),
// into shared memory as one 16-byte vector a pixel: 204 threads take 3
// vertically neighbouring p each of the 34 x 18 region. After one
// __syncthreads() each thread gathers them onto 2 output pixels q,
//
//   dx_q = sum_(p, k): reflect(p + k) = q [gSx(p) + 2 x_q gSxx(p)
//          + y_q gSxy(p)] - beta / C * g_q * sign(y_q - x_q),
//
// taking each neighbour row's weighted sum over its 3 columns, then the
// weighted sum of the 3 rows, and the block writes dL/dpred once, from a
// shared-memory tile, by contiguous rows. Each coefficient is computed once
// per tile that needs it, (TW+2)(TH+2)/(TW*TH) = 1.2x the pixels. Shared memory: 20 x 36 x C pairs
// (pred, target), 18 x 34 x 4 floats (coefficients of one channel), 18 x 34
// (g) and 16 x 32 x C (the output tile), 34.8 KB at C = 3: 6 blocks of 256
// threads fit an SM's 228 KB, and the registers, capped at 48, allow 5.
// Above 48 KB (C > 4) the launch opts in to more; the caller checks C <= 16.
//
// The reflect padding makes the gather more than the plain neighbourhood: at
// rows (columns) 0 and n-1 a pixel appears twice in its neighbour's window
// (row 0's window reads row 1 through taps -1 and +1), so each neighbour p
// counts with its multiplicity, m = 1 + [p = 0, q = 1] + [p = n-1, q = n-2]
// per axis, at the image's edges only, never at a tile's. The clamp passes
// the gradient on its closed interval [0, 1], as torch.clamp's backward does
// (the all-zero image sits on the bound 0). A halo entry 2 pixels outside the
// image (or past a ragged tile's edge) is read clamped into the image: only
// pixels p outside the image, whose coefficients are 0, would use it.
//
// Rounding. The taps are summed in the plain PyTorch version's order
// (row-major over the 3x3 window), the file is built with -fmad=false, and
// each product is rounded once where it is formed, so the box sums round as
// there. The means multiply by 1/9 in fp32, as PyTorch's CUDA division of a
// tensor by a Python scalar does (a * (1/b)), and the channel means by 1/C,
// as its CUDA mean does; n / d is a true division. The
// backward rounds the window sums, the SSIM terms and n / d (hence the
// clamp's mask) as the forward does; past them, where the plain autograd
// takes its sums in other orders anyway, it uses fused multiply-adds, a
// fast division and the chain rule in its shortest form.

#include <cuda_runtime.h>

namespace {

// The JAX and PyTorch versions take these as double-precision Python
// constants rounded to fp32 where they are used.
constexpr float kC1 = static_cast<float>(0.01 * 0.01);
constexpr float kC2 = static_cast<float>(0.03 * 0.03);
constexpr float kInv9 = 1.0f / 9.0f;

constexpr int kTW = 32;        // output tile of a block: columns
constexpr int kTH = 16;        // and rows
constexpr int kFwdRows = 4;    // forward: output rows of a thread
constexpr int kBwdRows = 2;    // backward: output rows a thread gathers
constexpr int kCoefRows = 3;   // backward: coefficient rows of a thread
constexpr int kFwdThreads = kTW * kTH / kFwdRows;  // 128
constexpr int kBwdThreads = kTW * kTH / kBwdRows;  // 256

// kC: the channel count where it is known at compile time (3, RGB, the one
// the port uses), so that the channel and fill loops unroll; 0 takes C at
// run time.
template <int kC>
__device__ __forceinline__ int channels(int C) {
  return kC > 0 ? kC : C;
}

// Image index of padded index i: the reflection for i in [-1, n]; beyond it
// (read only for pixels outside the image) clamped into [0, n).
__device__ __forceinline__ int fill_index(int i, int n) {
  const int r = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(r, 0), n - 1);
}

template <int kC, int kRows, int kCols, int kWarps, bool kInterior>
__device__ __forceinline__ void copy_rows(float2* tile,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b, int y0,
                                          int x0, int halo, int H, int W,
                                          int C) {
  constexpr int kRowSteps = (kRows + kWarps - 1) / kWarps;
  constexpr int kLaneSteps = (kCols * (kC > 0 ? kC : 1) + 31) / 32;
  const int nc = channels<kC>(C);
  const int row_len = kCols * nc;
  const int first = (x0 - halo) * nc;  // the tile's first element in a row
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.y * blockDim.x + threadIdx.x) / 32;
  // All loads first, then all stores: a thread's loads are in flight
  // together. A row or element past the tile's end is loaded from a valid
  // address and not stored.
  float va[kRowSteps][kLaneSteps], vb[kRowSteps][kLaneSteps];
#pragma unroll
  for (int k = 0; k < kRowSteps; ++k) {
    const int r = min(warp + k * kWarps, kRows - 1);
    const int iy = kInterior ? y0 - halo + r : fill_index(y0 - halo + r, H);
    const size_t row = static_cast<size_t>(iy) * W * nc;
#pragma unroll
    for (int m = 0; m < kLaneSteps; ++m) {
      const int e = min(lane + 32 * m, row_len - 1);
      int off = first + e;
      if (!kInterior && (off < 0 || off >= W * nc)) {
        const int j = e / nc;
        off = fill_index(x0 - halo + j, W) * nc + (e - j * nc);
      }
      va[k][m] = a[row + off];
      vb[k][m] = b[row + off];
    }
  }
#pragma unroll
  for (int k = 0; k < kRowSteps; ++k) {
    const int r = warp + k * kWarps;
#pragma unroll
    for (int m = 0; m < kLaneSteps; ++m) {
      const int e = lane + 32 * m;
      if (r < kRows && e < row_len) {
        tile[r * row_len + e] = make_float2(va[k][m], vb[k][m]);
      }
    }
  }
}

// Copies the kRows x kCols pixels x C channels tile whose top left pixel is
// (y0 - halo, x0 - halo) of the NHWC images `a` and `b` into `tile` as
// (a, b) pairs, reflect-padded. Each warp copies whole rows of the tile, 32
// consecutive floats a load. A tile that lies inside the image (most of
// them) skips the reflection. C unknown at compile time takes a loop.
template <int kC, int kRows, int kCols, int kWarps>
__device__ __forceinline__ void load_tile(float2* tile,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b, int y0,
                                          int x0, int halo, int H, int W,
                                          int C) {
  if constexpr (kC == 0) {
    const int row_len = kCols * C;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int idx = tid; idx < kRows * row_len; idx += 32 * kWarps) {
      const int r = idx / row_len, e = idx - r * row_len, j = e / C;
      const size_t off =
          (static_cast<size_t>(fill_index(y0 - halo + r, H)) * W +
           fill_index(x0 - halo + j, W)) * C + (e - j * C);
      tile[idx] = make_float2(a[off], b[off]);
    }
  } else {
    if (y0 >= halo && y0 - halo + kRows <= H && x0 >= halo &&
        x0 - halo + kCols <= W) {
      copy_rows<kC, kRows, kCols, kWarps, true>(tile, a, b, y0, x0, halo, H, W, C);
    } else {
      copy_rows<kC, kRows, kCols, kWarps, false>(tile, a, b, y0, x0, halo, H, W, C);
    }
  }
}

struct Window {
  float sx = 0.0f, sy = 0.0f, sxx = 0.0f, syy = 0.0f, sxy = 0.0f;

  __device__ __forceinline__ void add(float2 v, float aa, float bb, float ab) {
    sx += v.x;
    sy += v.y;
    sxx += aa;
    syy += bb;
    sxy += ab;
  }
};

// Adds the tap values of rows 0 .. kOut + 1 of a column strip 3 wide
// (pairs from `tile`, which holds kCols pixels x C channels a row, starting
// at pair `at` of the strip's first row) to the windows of kOut vertically
// neighbouring pixels: row i feeds the windows r with 0 <= i - r <= 2. Rows
// and columns ascending keep each window's taps in row-major order; x^2,
// y^2 and xy are formed once per value.
template <int kOut, int kCols>
__device__ __forceinline__ void strip_windows(Window (&w)[kOut],
                                              const float2* tile, int at,
                                              int nc) {
#pragma unroll
  for (int i = 0; i < kOut + 2; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float2 v = tile[at + (i * kCols + j) * nc];
      const float aa = v.x * v.x, bb = v.y * v.y, ab = v.x * v.y;
#pragma unroll
      for (int r = 0; r < kOut; ++r) {
        if (i - r >= 0 && i - r <= 2) w[r].add(v, aa, bb, ab);
      }
    }
  }
}

// The SSIM terms of one window, in the plain version's order of operations.
struct Ssim {
  float mu_x, mu_y, sigma_x, sigma_y, sigma_xy, a1, a2, b1, b2, n, d;

  __device__ __forceinline__ explicit Ssim(const Window& w) {
    mu_x = w.sx * kInv9;
    mu_y = w.sy * kInv9;
    sigma_x = w.sxx * kInv9 - mu_x * mu_x;
    sigma_y = w.syy * kInv9 - mu_y * mu_y;
    sigma_xy = w.sxy * kInv9 - mu_x * mu_y;
    a1 = 2.0f * mu_x * mu_y + kC1;
    a2 = 2.0f * sigma_xy + kC2;
    b1 = mu_x * mu_x + mu_y * mu_y + kC1;
    b2 = sigma_x + sigma_y + kC2;
    n = a1 * a2;
    d = b1 * b2;
  }
};

template <int kC>
__global__ void __launch_bounds__(kFwdThreads)
    reprojection_loss_kernel(const float* __restrict__ pred,
                             const float* __restrict__ target,
                             float* __restrict__ out, int H, int W, int C,
                             float alpha, float beta) {
  constexpr int kRows = kTH + 2, kCols = kTW + 2;  // the tile and its halo
  extern __shared__ float2 tile[];                 // (pred, target) pairs
  const int nc = channels<kC>(C);
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const size_t image = static_cast<size_t>(blockIdx.z) * H * W;
  load_tile<kC, kRows, kCols, kFwdThreads / 32>(
      tile, pred + image * nc, target + image * nc, y0, x0, 1, H, W, nc);
  __syncthreads();

  const int tx = threadIdx.x, r0 = threadIdx.y * kFwdRows;
  float ssim_sum[kFwdRows], l1_sum[kFwdRows];
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) ssim_sum[r] = l1_sum[r] = 0.0f;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    Window w[kFwdRows];
    strip_windows<kFwdRows, kCols>(w, tile, (r0 * kCols + tx) * nc + c, nc);
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
      const Ssim s(w[r]);
      ssim_sum[r] += fminf(fmaxf((1.0f - s.n / s.d) * 0.5f, 0.0f), 1.0f);
      const float2 v = tile[((r0 + r + 1) * kCols + tx + 1) * nc + c];
      l1_sum[r] += fabsf(v.y - v.x);
    }
  }
  // The channel means multiply by 1/C, as PyTorch's CUDA mean does.
  const float inv_c = 1.0f / nc;
  const int x = x0 + tx;
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) {
    const int y = y0 + r0 + r;
    if (x < W && y < H) {
      out[image + static_cast<size_t>(y) * W + x] =
          alpha * (ssim_sum[r] * inv_c) + beta * (l1_sum[r] * inv_c);
    }
  }
}

// 5 blocks an SM cap the registers at 48, at the price of a 32-byte spill
// (a few local loads a channel); uncapped the compiler takes 71 and 3
// blocks fit an SM, which ran slower on the H100.
template <int kC>
__global__ void __launch_bounds__(kBwdThreads, 5)
    reprojection_grad_kernel(const float* __restrict__ pred,
                             const float* __restrict__ target,
                             const float* __restrict__ g, long long g_stride,
                             float* __restrict__ grad, int H, int W, int C,
                             float alpha, float beta) {
  constexpr int kRows = kTH + 4, kCols = kTW + 4;    // pred, target: halo 2
  constexpr int kRowsK = kTH + 2, kColsK = kTW + 2;  // coefficients, g: halo 1
  constexpr int kPlane = kRowsK * kColsK;
  constexpr int kItems = kRowsK / kCoefRows * kColsK;  // 204
  static_assert(kRowsK % kCoefRows == 0, "coefficient rows split evenly");
  extern __shared__ float4 smem[];
  const int nc = channels<kC>(C);
  // K: (dL/dSx, dL/dSxx, dL/dSxy, unused) of one channel at each pixel of
  // the halo-1 region; then the (pred, target) pairs; g at the halo-1
  // region; dL/dpred of the tile, [kTH, kTW, C].
  float4* K = smem;
  float2* tile = reinterpret_cast<float2*>(K + kPlane);
  float* G = reinterpret_cast<float*>(tile + kRows * kCols * nc);
  float* O = G + kPlane;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const size_t image = static_cast<size_t>(blockIdx.z) * H * W;
  const int tid = threadIdx.y * kTW + threadIdx.x;
  load_tile<kC, kRows, kCols, kBwdThreads / 32>(
      tile, pred + image * nc, target + image * nc, y0, x0, 2, H, W, nc);
  constexpr int kGSteps = (kPlane + kBwdThreads - 1) / kBwdThreads;
  float gv[kGSteps];
#pragma unroll
  for (int k = 0; k < kGSteps; ++k) {  // loads first, from clamped pixels
    const int idx = tid + k * kBwdThreads;
    const int py = y0 - 1 + idx / kColsK, px = x0 - 1 + idx % kColsK;
    const size_t pixel = image + static_cast<size_t>(min(max(py, 0), H - 1)) * W +
                         min(max(px, 0), W - 1);
    gv[k] = g[pixel * g_stride];
    if (py < 0 || py >= H || px < 0 || px >= W) gv[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kGSteps; ++k) {
    if (tid + k * kBwdThreads < kPlane) G[tid + k * kBwdThreads] = gv[k];
  }
  __syncthreads();

  // This thread's coefficient pixels: rows kr0 .. kr0 + 2 of column kj of
  // the halo-1 region, whose windows span tile rows kr0 .. kr0 + 4; the
  // factor of dL/dSSIM_c before the clamp, 0 outside the image, which sets
  // the pixel's coefficients to 0.
  const bool coef_thread = tid < kItems;
  const int kj = tid % kColsK, kr0 = tid / kColsK * kCoefRows;
  float g_ssim[kCoefRows];
#pragma unroll
  for (int r = 0; r < kCoefRows; ++r) {
    g_ssim[r] = coef_thread ? G[(kr0 + r) * kColsK + kj] * alpha / nc : 0.0f;
  }
  // Its gather: output rows q0, q0 + 1 of column tx; their neighbours p
  // are rows q0 .. q0 + 3 and columns tx .. tx + 2 of the halo-1 region.
  const int tx = threadIdx.x, q0 = threadIdx.y * kBwdRows;
  // The reflect padding's multiplicities: a neighbour counts twice where
  // it is row (column) 0 and q is 1, or n-1 and q is n-2, else once.
  const int qx = x0 + tx;
  const float w_left = qx == 1 ? 2.0f : 1.0f, w_right = qx == W - 2 ? 2.0f : 1.0f;
  float w_up[kBwdRows], w_down[kBwdRows], g_l1[kBwdRows];
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    const int qy = y0 + q0 + r;
    w_up[r] = qy == 1 ? 2.0f : 1.0f;
    w_down[r] = qy == H - 2 ? 2.0f : 1.0f;
  }
#pragma unroll
  for (int r = 0; r < kBwdRows; ++r) {
    g_l1[r] = G[(q0 + r + 1) * kColsK + tx + 1] * beta / nc;
  }

#pragma unroll
  for (int c = 0; c < nc; ++c) {
    if (coef_thread) {
      Window w[kCoefRows];
      strip_windows<kCoefRows, kCols>(w, tile, (kr0 * kCols + kj) * nc + c, nc);
#pragma unroll
      for (int r = 0; r < kCoefRows; ++r) {
        const Ssim s(w[r]);
        const float ratio = s.n / s.d;
        const float u = (1.0f - ratio) * 0.5f;
        const float g_u = (u >= 0.0f && u <= 1.0f) ? g_ssim[r] : 0.0f;
        // u = (1 - n/d) / 2: du/dn = -1/(2d), du/dd = n/(2d^2); h9 carries
        // the 1/9 of the means, 2 ulp is plenty for a gradient.
        const float h9 = __fdividef(g_u * (0.5f * kInv9), s.d);
        const float g_n2 = -2.0f * h9;  // 2 dL/dn / 9
        const float g_d = h9 * ratio;   // dL/dd / 9
        // sigma_x enters b2, sigma_xy a2; mu_x enters a1, b1, and through
        // -mu_x^2 and -mu_x mu_y the sigmas: dL/dmu_x = 2 mu_y dL/dn
        // (a2 - a1) + 2 mu_x dL/dd (b2 - b1).
        K[(kr0 + r) * kColsK + kj] = make_float4(
            fmaf(s.mu_y * g_n2, s.a2 - s.a1, 2.0f * s.mu_x * g_d * (s.b2 - s.b1)),
            g_d * s.b1, g_n2 * s.a1, 0.0f);
      }
    }
    __syncthreads();

    // Separably: each neighbour row's weighted sum over its 3 columns,
    // then each output's weighted sum over its 3 rows.
    float4 h[kBwdRows + 2];
#pragma unroll
    for (int i = 0; i < kBwdRows + 2; ++i) {
      const float4* k = K + (q0 + i) * kColsK + tx;
      const float4 l = k[0], m = k[1], r = k[2];
      h[i] = make_float4(fmaf(w_right, r.x, fmaf(w_left, l.x, m.x)),
                         fmaf(w_right, r.y, fmaf(w_left, l.y, m.y)),
                         fmaf(w_right, r.z, fmaf(w_left, l.z, m.z)), 0.0f);
    }
    float s_x[kBwdRows], s_xx[kBwdRows], s_xy[kBwdRows];
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float4 u = h[r], m = h[r + 1], d = h[r + 2];
      s_x[r] = fmaf(w_down[r], d.x, fmaf(w_up[r], u.x, m.x));
      s_xx[r] = fmaf(w_down[r], d.y, fmaf(w_up[r], u.y, m.y));
      s_xy[r] = fmaf(w_down[r], d.z, fmaf(w_up[r], u.z, m.z));
    }
#pragma unroll
    for (int r = 0; r < kBwdRows; ++r) {
      const float2 v = tile[((q0 + r + 2) * kCols + tx + 2) * nc + c];
      const float diff = v.y - v.x;
      const float sign = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
      O[((q0 + r) * kTW + tx) * nc + c] =
          s_x[r] + 2.0f * v.x * s_xx[r] + v.y * s_xy[r] - g_l1[r] * sign;
    }
    __syncthreads();  // K is rewritten by the next channel; O is read below
  }

  // Each warp writes whole rows of the tile, 32 consecutive floats a store.
  const int row_len = kTW * nc, lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int k = 0; k < kTH / (kBwdThreads / 32); ++k) {
    const int r = warp + k * (kBwdThreads / 32);
    const int y = y0 + r;
    float* row = grad + (image + static_cast<size_t>(y) * W) * nc + x0 * nc;
#pragma unroll
    for (int m = 0; m < (row_len + 31) / 32; ++m) {
      const int e = lane + 32 * m;
      if (y < H && e < row_len && x0 * nc + e < W * nc) row[e] = O[r * row_len + e];
    }
  }
}

// Launches `kernel` with `smem` bytes of dynamic shared memory, opting in
// above the 48 KB a launch gets without asking.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

dim3 tiles(int B, int H, int W) {
  return dim3((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// beta = 1 - alpha, rounded by the caller as the plain version rounds it.
extern "C" int reprojection_loss_forward(const float* pred, const float* target,
                                         float* out, int B, int H, int W, int C,
                                         float alpha, float beta, void* stream) {
  const dim3 block(kTW, kTH / kFwdRows);
  const size_t smem = (kTH + 2) * (kTW + 2) * C * sizeof(float2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = C == 3 ? &reprojection_loss_kernel<3>
                            : &reprojection_loss_kernel<0>;
  return static_cast<int>(launch(kernel, tiles(B, H, W), block, smem, s, pred,
                                 target, out, H, W, C, alpha, beta));
}

// dL/dpred of the map above, in one launch: g = dL/dout [B, H, W], pixel i
// at g[i * g_stride] (any stride uniform over B*H*W, 0 included); pred and
// target [B, H, W, C]; grad [B, H, W, C] is written. Returns the CUDA error
// code (0 on success).
extern "C" int reprojection_loss_backward(const float* pred, const float* target,
                                          const float* g, long long g_stride,
                                          float* grad, int B, int H, int W,
                                          int C, float alpha, float beta,
                                          void* stream) {
  const dim3 block(kTW, kTH / kBwdRows);
  const size_t plane = (kTH + 2) * (kTW + 2);
  const size_t smem = plane * (sizeof(float4) + sizeof(float)) +
                      (kTH + 4) * (kTW + 4) * C * sizeof(float2) +
                      kTH * kTW * C * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = C == 3 ? &reprojection_grad_kernel<3>
                            : &reprojection_grad_kernel<0>;
  return static_cast<int>(launch(kernel, tiles(B, H, W), block, smem, s, pred,
                                 target, g, g_stride, grad, H, W, C, alpha,
                                 beta));
}
