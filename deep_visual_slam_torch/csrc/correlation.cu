// Kernel K2: RAFT's on-demand windowed correlation lookup, forward only.
//
// It computes deep_visual_slam_tpu/ops/pallas/correlation.py:_lookup_lazy:111
// (XLA in the JAX package, which reaches no pallas_call; the reference runs
// its own CUDA extension, alt_cuda_corr, for it):
//
//   for each pixel p of fmap1 [B, H1, W1, D] fp32, each level l of the pooled
//   fmap2 levels [B, H_l, W_l, D] fp32 and each offset (dx, dy) of the
//   (2r+1)^2 window in x-major order (flat tap i*(2r+1) + j has dx = i - r,
//   dy = j - r):
//     out[p, l*(2r+1)^2 + tap] =
//       <fmap1[p], bilinear(f2_l, coords[p] / 2^l + (dx, dy))> / sqrt(D)
//   with align_corners and zero padding; out [B, H1, W1, L*(2r+1)^2] fp32.
//   On a level 1 pixel wide (high) every tap of that axis samples index 0,
//   as the JAX package's max(w - 1, 1) normalisation and align_corners give.
//
// Design. The lookup is linear in fmap2, and within a level every tap of a
// window shares the centroid's fractional weights (fx, fy): the 4 corners
// of tap (i, j) are the integer-grid pixels (x0 + i + {0,1}, y0 + j + {0,1}),
// x0 = floor(cx) - r. So a warp takes one (pixel, level), dots fmap1 with
// the (2r+2)^2 integer-grid pixels of fmap2 once (64 dots for r = 3, not 196
// bilinear gathers) and blends 4 dots per tap. A grid pixel outside the
// level contributes 0 (zero padding); floorf, not an integer cast, takes
// the floor of negative coordinates.
//
// Within a warp the 32 lanes split the D channels: at D = 128 (256) a lane
// holds 4 (8) of fmap1's values in registers and reads a grid pixel's row of
// fmap2 as one (two) 16-byte loads, so the warp reads the 512-byte row in
// one instruction (other D, or rows not 16-byte aligned, take a scalar form:
// channel lane + 32 k). A grid pixel outside the level is read at a clamped
// index and its dot zeroed, with no branch, so that the loads of a group of
// grid pixels are all in flight together. The dots go 16 at a time: a lane
// accumulates its partial sums of 16 grid pixels, then a reduce-scatter
// over the lane bits 8, 4, 2, 1 and one exchange with the other half-warp
// (16 shuffles, against 5 a dot for a butterfly per dot) leave lane L the
// whole dot of grid pixel L % 16. The dots go to shared memory and the lanes
// blend the taps from there, writing the (2r+1)^2 outputs of the level
// contiguously. A block is 8 warps: 8 neighbouring pixels of one level; the
// registers are capped so that 5 blocks share an SM, 40 warps to hide the
// loads' latency.
//
// Bounds. Each input read once and the output written once: at SmallRAFT's
// 480x640 (B = 16, 60x80 fmaps, D = 128, r = 3, 4 levels) that is 91.5 MB of
// fmaps, 0.6 MB of coords and 60.2 MB of output, ~45 us at 3.35 TB/s. The
// integer-grid form does 2D flops for each in-range grid pixel of a window
// and 7 a tap for the blend: up to 5.1 GFLOP of fp32 there, ~76 us at 67
// TFLOP/s, so the operations bound it. This form reads each window's fmap2
// rows through the cache once a pixel (up to 10 GB of L1/L2 traffic there),
// which sets its pace: staging a tile's windows in shared memory, or a
// product of a tile of pixels with the union of their windows, is the next
// form to try (PERF.md).
//
// Rounding. The dots are fp32 fused multiply-adds in another order than the
// plain version's sum, and the blend comes after the dot instead of before:
// the kernel agrees with the plain version to a few ulp of the dots' size.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 8;  // D <= 256 channels: 8 a lane
constexpr int kWarps = 8;      // pixels (warps) a block
constexpr int kGroup = 16;     // grid pixels a warp dots at a time

struct Levels {
  const float* f2[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// The lane's channels of the D-vector at ``row`` into a[]: kVec = 0 takes
// channel lane + 32 k (k < 8; 0 at and past D), kVec = 1 or 2 the float4s
// lane + 32 j (j < kVec; D = 128 kVec). fmap1's and fmap2's rows go through
// it alike, so their values pair up lane by lane.
template <int kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ row, float* a,
                                         int lane, int D) {
  if constexpr (kVec == 0) {
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = lane + 32 * k;
      a[k] = c < D ? __ldg(row + c) : 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row) + lane + 32 * j);
      a[4 * j] = v.x;
      a[4 * j + 1] = v.y;
      a[4 * j + 2] = v.z;
      a[4 * j + 3] = v.w;
    }
  }
}

template <int kVec>
__device__ __forceinline__ float partial_dot(const float* __restrict__ row,
                                             const float* a, int lane, int D) {
  float v[kMaxChunks];
  load_row<kVec>(row, v, lane, D);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < (kVec == 0 ? kMaxChunks : 4 * kVec); ++k) s = fmaf(a[k], v[k], s);
  return s;
}

// One step of the warp's reduce-scatter over acc[0 .. 2H): a lane keeps the
// half that its lane bit H selects and adds its partner's partial sums of
// that half into acc[0 .. H).
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float* acc, int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? acc[i] : acc[i + H];
    const float keep = upper ? acc[i + H] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

template <int R, int kVec>
__global__ void __launch_bounds__(kWarps * 32, 5)
    corr_lookup_kernel(const float* __restrict__ fmap1,
                       const float* __restrict__ coords,
                       float* __restrict__ out, const Levels levels,
                       int num_levels, int HW1, int D, long long num_pixels,
                       float scale) {
  constexpr int kSide = 2 * R + 2;  // integer grid of a window, a side
  constexpr int kDots = kSide * kSide;
  constexpr int kGroups = (kDots + kGroup - 1) / kGroup;
  constexpr int kWin = 2 * R + 1;
  constexpr int kTaps = kWin * kWin;
  __shared__ float dots[kWarps][kGroups * kGroup];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pix = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (pix >= num_pixels) return;  // the whole warp; no block barrier follows
  // This block's level, selected without indexing the parameter array by
  // a run-time value (which would copy it to local memory).
  const int level = blockIdx.y;
  const float* f2 = levels.f2[0];
  int hl = levels.h[0], wl = levels.w[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l == level) {
      f2 = levels.f2[l];
      hl = levels.h[l];
      wl = levels.w[l];
    }
  }
  f2 += pix / HW1 * hl * wl * D;

  float a[kMaxChunks];
  load_row<kVec>(fmap1 + pix * D, a, lane, D);

  // The centroid at this level (a division by a power of 2, exact), its
  // floor and fractional part per axis; a 1-pixel axis puts every tap on 0.
  const float div = static_cast<float>(1 << level);
  const float cx = coords[2 * pix] / div;
  const float cy = coords[2 * pix + 1] / div;
  int x0 = 0, y0 = 0;
  float fx = 0.0f, fy = 0.0f;
  if (wl > 1) {
    const float fl = floorf(cx);
    fx = cx - fl;
    x0 = static_cast<int>(fminf(fmaxf(fl, -1.0e6f), 1.0e6f)) - R;
  }
  if (hl > 1) {
    const float fl = floorf(cy);
    fy = cy - fl;
    y0 = static_cast<int>(fminf(fmaxf(fl, -1.0e6f), 1.0e6f)) - R;
  }

  // Per axis, each grid line's offset into the level, clamped into it, and
  // whether it lies inside: every grid pixel's row is read at the clamped
  // offset and its dot zeroed when it lies outside. No branch, so the loads
  // of all 32 grid pixels of a group can be in flight together.
  int col_off[kSide], row_off[kSide];
  bool col_in[kSide], row_in[kSide];
#pragma unroll
  for (int i = 0; i < kSide; ++i) {
    const int xi = wl > 1 ? x0 + i : 0;
    const int yi = hl > 1 ? y0 + i : 0;
    col_in[i] = xi >= 0 && xi < wl;
    row_in[i] = yi >= 0 && yi < hl;
    col_off[i] = min(max(xi, 0), wl - 1) * D;
    row_off[i] = min(max(yi, 0), hl - 1) * wl * D;
  }

#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    float acc[kGroup];
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      const int q = g * kGroup + p;
      float s = 0.0f;
      if (q < kDots) {
        const int gy = q / kSide, gx = q % kSide;
        s = partial_dot<kVec>(f2 + row_off[gy] + col_off[gx], a, lane, D);
        s = row_in[gy] && col_in[gx] ? s : 0.0f;
      }
      acc[p] = s;
    }
    // After 4 steps acc[0] of lane L is its half-warp's sum for grid pixel
    // g*16 + L % 16; the other half-warp's sum completes the dot.
    reduce_scatter_step<8>(acc, lane);
    reduce_scatter_step<4>(acc, lane);
    reduce_scatter_step<2>(acc, lane);
    reduce_scatter_step<1>(acc, lane);
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 16);
    if (lane < kGroup) dots[warp][g * kGroup + lane] = acc[0] * scale;
  }
  __syncwarp();

  const float* s = dots[warp];
  float* o = out + (pix * num_levels + level) * kTaps;
  for (int t = lane; t < kTaps; t += 32) {
    const int i = t / kWin;  // dx = i - R: the grid column
    const int j = t % kWin;  // dy = j - R: the grid row
    const float* r0 = s + j * kSide + i;
    const float* r1 = r0 + kSide;
    o[t] = (1.0f - fy) * ((1.0f - fx) * r0[0] + fx * r0[1]) +
           fy * ((1.0f - fx) * r1[0] + fx * r1[1]);
  }
}

template <int R, int kVec>
cudaError_t launch(const float* fmap1, const float* coords, float* out,
                   const Levels& levels, int num_levels, int HW1, int D,
                   long long num_pixels, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((num_pixels + kWarps - 1) / kWarps),
                  num_levels);
  corr_lookup_kernel<R, kVec><<<grid, kWarps * 32, 0, stream>>>(
      fmap1, coords, out, levels, num_levels, HW1, D, num_pixels, scale);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_radius(const float* fmap1, const float* coords, float* out,
                          const Levels& levels, int num_levels, int HW1, int D,
                          long long n, float scale, cudaStream_t s, bool vec) {
  if (vec && D == 128) return launch<R, 1>(fmap1, coords, out, levels, num_levels, HW1, D, n, scale, s);
  if (vec && D == 256) return launch<R, 2>(fmap1, coords, out, levels, num_levels, HW1, D, n, scale, s);
  return launch<R, 0>(fmap1, coords, out, levels, num_levels, HW1, D, n, scale, s);
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

// out [B, H1, W1, num_levels * (2 radius + 1)^2] from fmap1 [B, H1, W1, D],
// coords [B, H1, W1, 2] and the levels level_ptrs[l] [B, level_hw[2l],
// level_hw[2l+1], D], all fp32 and contiguous on the device; level_ptrs and
// level_hw are host arrays. Returns the CUDA error code (0 on success).
extern "C" int corr_lookup_forward(const float* fmap1, const float* coords,
                                   float* out, const long long* level_ptrs,
                                   const int* level_hw, int num_levels, int B,
                                   int H1, int W1, int D, int radius,
                                   float scale, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || D < 1 ||
      D > 32 * kMaxChunks || B < 1 || H1 < 1 || W1 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels levels{};
  bool vec = aligned16(fmap1);  // float4 rows: D = 128 or 256, 16-byte aligned
  for (int l = 0; l < num_levels; ++l) {
    levels.f2[l] = reinterpret_cast<const float*>(level_ptrs[l]);
    levels.h[l] = level_hw[2 * l];
    levels.w[l] = level_hw[2 * l + 1];
    vec = vec && aligned16(levels.f2[l]);
  }
  const int HW1 = H1 * W1;
  const long long n = static_cast<long long>(B) * HW1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (radius) {  // SmallRAFT's window and RAFT's
    case 3: err = launch_radius<3>(fmap1, coords, out, levels, num_levels, HW1, D, n, scale, s, vec); break;
    case 4: err = launch_radius<4>(fmap1, coords, out, levels, num_levels, HW1, D, n, scale, s, vec); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
