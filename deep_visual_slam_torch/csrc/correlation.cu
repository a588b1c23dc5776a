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
// The lookup is linear in fmap2, and within a level every tap of a window
// shares the centroid's fractional weights (fx, fy): the 4 corners of tap
// (i, j) are the integer-grid pixels (x0 + i + {0,1}, y0 + j + {0,1}),
// x0 = floor(cx) - r. So a window needs the dots of fmap1 with its (2r+2)^2
// integer-grid pixels of fmap2 (64 for r = 3), and 4 of them blend a tap. A
// grid pixel outside the level contributes 0 (zero padding); floorf, not an
// integer cast, takes the floor of negative coordinates.
//
// What bounds it. Each input read once and the output written once: at
// SmallRAFT's 480x640 (B = 16, 60x80 fmaps, D = 128, r = 3, 4 levels) 91.5 MB
// of fmaps, 0.6 MB of coords and 60.2 MB of output, ~45 us at 3.35 TB/s. The
// dots of each window's in-range grid pixels (2D flops each) and 7 flops a
// tap for the blend are up to 5.1 GFLOP, ~76 us at the 67 TFLOP/s of fp32
// FMA: the operations bound it (chip_smoke.py's k2_work counts this work
// whatever computes it). The first form (one warp a pixel, kept below as
// the per-pixel form) read each window's 64 fmap2 rows from L1/L2 once a
// pixel: ~10 GB of loads a call, each value feeding one FMA, plus a
// reduce-scatter of 64 shuffles a (pixel, level). Load wavefronts and
// instruction issue, not cache misses, set its pace (0.69-0.78 ms on an H100
// whatever the windows' overlap).
//
// The tiled form. A block (16 warps) takes a tile of 8x8 neighbouring query
// pixels at one level of one image. Its prologue reduces the tile's window
// origins to the union box of their integer grids, U = bw x bh pixels
// (RAFT's targets are smooth: ~15x15 at level 0, ~8x8 at level 3 for r =
// 3). When the box fits (U <= kMaxU), the block stages the box's fmap2 rows
// and the tile's fmap1 rows in shared memory, 32 channels a stage, two
// stages in flight by cp.async (its zero fill is the lookup's zero
// padding), and computes the dots as a product [64 queries, D] x [D, U] on
// the tensor cores (mma.sync m16n8k8, TF32): one staged value feeds up to
// 64 (fmap2) or U (fmap1) multiply-adds instead of one. A warp takes 2 of
// the 4 m-tiles (16 queries) and every 8th n-tile (8 box pixels); an
// (m-tile, n-tile) pair that no query of the m-tile reads is skipped (~30%
// of them at level 0 on a smooth flow, by count). A tile's levels are
// neighbouring blocks. The product lands in shared memory (scaled by
// 1/sqrt(D)) and each query blends its taps from its own (2r+2)^2 entries
// with its (fx, fy), as the per-pixel form does, a warp a query. A tile
// whose box does not fit (motion boundaries, large random targets) runs the
// per-pixel form inside the same launch, a warp a pixel; so do rows not
// 16-byte aligned and D other than 128 or 256, in a kernel of the per-pixel
// form alone.
//
// What bounds the tiled form now (scripts/k2_ablation.py takes each part
// out in turn): the instructions of the product loop, where per k-step of 8
// channels a warp loads and splits 16 values for 18-24 products, and a
// block's fixed work (prologue, barriers, the product's store, the blend);
// the staged loads cost little. Two blocks share an SM (64 registers a
// thread, 94 KB of shared memory a block). The product computes 2-3x the
// dots the windows need (a box row of 15 pixels serves an m-tile's 2 query
// rows). The per-pixel form inside it runs with the L1 cache that the two
// blocks' shared memory leaves (~60 KB an SM).
//
// Rounding. Plain TF32 keeps 10 bits of mantissa: ~5e-4 absolute on
// correlations up to ~5, over the 1e-4 the lookup is held to. So each value
// is split into a TF32 head (its low 13 bits cleared) and the remainder
// (exact in fp32, which the tensor cores read as TF32 in turn), and three
// products are summed in fp32 (head x head + head x tail + tail x head;
// tail x tail and the tail's own truncation, ~2^-20 of a product, are
// dropped): a few ulp of an fp32 dot. The tensor cores' rate for these
// instructions counts each as 2 x 16 x 8 x 8 operations, three a product
// term; chip_smoke.py still reads K2's bound from the fp32 work of the
// function itself (k2_work), whatever computes it.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 8;  // D <= 256 channels: 8 a lane
constexpr int kWarps = 8;      // warps a block of the per-pixel form
constexpr int kThreads = kWarps * 32;
constexpr int kTiledWarps = 16;  // warps a block of the tiled form
constexpr int kTiledThreads = kTiledWarps * 32;
constexpr int kGroup = 16;       // grid pixels a warp dots at a time (per-pixel form)

// The tiled form's shapes.
constexpr int kTile = 8;            // a tile is kTile x kTile query pixels
constexpr int kQ = kTile * kTile;   // 64 queries: 4 m-tiles of 16
constexpr int kChunk = 32;          // channels a stage
constexpr int kStride = kChunk + 4; // floats a staged row: conflict-free fragment reads

// The largest union box a tile stages (pixels), and the blocks an SM holds
// (the registers and shared memory allow): the 8 window origins of a tile's
// row span 7 or 8 columns under a smooth flow, so a level-0 box is up to
// 16x16 at r = 3 and 18x18 at r = 4.
template <int R> struct Box;
template <> struct Box<3> { static constexpr int kMaxU = 256, kBlocks = 2; };
template <> struct Box<4> { static constexpr int kMaxU = 324, kBlocks = 1; };
// Staged fmap2 rows a stage: kMaxU rounded up to the n-tiles' 8.
template <int R>
__host__ __device__ constexpr int box_rows() {
  return (Box<R>::kMaxU + 7) / 8 * 8;
}

struct Levels {
  const float* f2[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// This block's level, selected without indexing the parameter array by a
// run-time value (which would copy it to local memory).
__device__ __forceinline__ void select_level(const Levels& levels, int level,
                                             const float*& f2, int& hl, int& wl) {
  f2 = levels.f2[0];
  hl = levels.h[0];
  wl = levels.w[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l == level) {
      f2 = levels.f2[l];
      hl = levels.h[l];
      wl = levels.w[l];
    }
  }
}

// A query's window origin and fractional weights at this level (a division
// by a power of 2, exact); a 1-pixel axis puts every tap on 0.
__device__ __forceinline__ void window_origin(float cx, float cy, int hl, int wl,
                                              int& x0, int& y0, float& fx,
                                              float& fy, int R) {
  x0 = 0;
  y0 = 0;
  fx = 0.0f;
  fy = 0.0f;
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
}

// ------------------------------------------------------ the per-pixel form
//
// A warp takes one (pixel, level). The 32 lanes split the D channels: at
// D = 128 (256) a lane holds 4 (8) of fmap1's values in registers and reads a
// grid pixel's row of fmap2 as one (two) 16-byte loads (other D, or rows not
// 16-byte aligned, take a scalar form: channel lane + 32 k). A grid pixel
// outside the level is read at a clamped index and its dot zeroed, with no
// branch, so that the loads of a group of grid pixels are all in flight
// together. The dots go 16 at a time: a lane accumulates its partial sums of
// 16 grid pixels, then a reduce-scatter over the lane bits 8, 4, 2, 1 and one
// exchange with the other half-warp leave lane L the whole dot of grid pixel
// L % 16. The dots go to shared memory and the lanes blend the taps from
// there, writing the (2r+1)^2 outputs of the level contiguously.

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

template <int R>
__host__ __device__ constexpr int dots_per_warp() {
  return ((2 * R + 2) * (2 * R + 2) + kGroup - 1) / kGroup * kGroup;
}

// The whole lookup of pixel ``pix`` at one level by one warp; ``f2`` is the
// level's base, ``dots`` the warp's dots_per_warp<R>() floats of shared
// memory.
template <int R, int kVec>
__device__ __forceinline__ void lookup_pixel(const float* __restrict__ fmap1,
                                             const float* __restrict__ coords,
                                             float* __restrict__ out,
                                             const float* f2, int hl, int wl,
                                             int level, int num_levels, int HW1,
                                             int D, long long pix, float scale,
                                             float* dots, int lane) {
  constexpr int kSide = 2 * R + 2;  // integer grid of a window, a side
  constexpr int kDots = kSide * kSide;
  constexpr int kGroups = (kDots + kGroup - 1) / kGroup;
  constexpr int kWin = 2 * R + 1;
  constexpr int kTaps = kWin * kWin;
  f2 += pix / HW1 * hl * wl * D;

  float a[kMaxChunks];
  load_row<kVec>(fmap1 + pix * D, a, lane, D);

  const float div = static_cast<float>(1 << level);
  int x0, y0;
  float fx, fy;
  window_origin(coords[2 * pix] / div, coords[2 * pix + 1] / div, hl, wl, x0, y0,
                fx, fy, R);

  // Per axis, each grid line's offset into the level, clamped into it, and
  // whether it lies inside: every grid pixel's row is read at the clamped
  // offset and its dot zeroed when it lies outside.
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
    if (lane < kGroup) dots[g * kGroup + lane] = acc[0] * scale;
  }
  __syncwarp();

  float* o = out + (pix * num_levels + level) * kTaps;
  for (int t = lane; t < kTaps; t += 32) {
    const int i = t / kWin;  // dx = i - R: the grid column
    const int j = t % kWin;  // dy = j - R: the grid row
    const float* r0 = dots + j * kSide + i;
    const float* r1 = r0 + kSide;
    o[t] = (1.0f - fy) * ((1.0f - fx) * r0[0] + fx * r0[1]) +
           fy * ((1.0f - fx) * r1[0] + fx * r1[1]);
  }
  __syncwarp();  // the dots are read before the warp's next pixel writes them
}

// A block is 8 warps: 8 neighbouring pixels of one level; the registers are
// capped so that 5 blocks share an SM, 40 warps to hide the loads' latency.
// Rows not 16-byte aligned, or D other than 128 and 256: the scalar loads.
template <int R>
__global__ void __launch_bounds__(kThreads, 5)
    corr_lookup_kernel(const float* __restrict__ fmap1,
                       const float* __restrict__ coords,
                       float* __restrict__ out, const Levels levels,
                       int num_levels, int HW1, int D, long long num_pixels,
                       float scale) {
  __shared__ float dots[kWarps][dots_per_warp<R>()];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pix = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (pix >= num_pixels) return;  // the whole warp; no block barrier follows
  const float* f2;
  int hl, wl;
  select_level(levels, blockIdx.y, f2, hl, wl);
  lookup_pixel<R, 0>(fmap1, coords, out, f2, hl, wl, blockIdx.y, num_levels, HW1, D,
                     pix, scale, dots[warp], lane);
}

// ---------------------------------------------------------- the tiled form

// 16 bytes from global to shared memory, asynchronously; zeros when !in.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x as a TF32 head (x with its low 13 bits cleared) and the remainder x -
// head, exact in fp32, which the tensor cores read as TF32 in turn.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one m16n8k8 tile: a row-major 16x8, b 8x8 (k by n), TF32.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int R>
__host__ __device__ constexpr int tiled_smem_bytes() {
  return 2 * (box_rows<R>() + kQ) * kStride * static_cast<int>(sizeof(float));
}

// grid (B * tiles_y * tiles_x * num_levels: a tile's levels are neighbouring
// blocks, so the later ones find its fmap1 rows in L2), kTiledThreads
// threads, and tiled_smem_bytes<R>() of dynamic shared memory: two stages of
// [box_rows<R>() + kQ][kStride] floats (the box's fmap2 rows, then the
// tile's fmap1 rows), which the product [kQ][U rounded up to 8] reuses once
// the stages are read; the per-pixel form takes its dots from the same
// space. An image's level holds fewer than 2^31 floats (the caller checks).
template <int R, int kD>
__global__ void __launch_bounds__(kTiledThreads, Box<R>::kBlocks)
    corr_lookup_tiled_kernel(const float* __restrict__ fmap1,
                             const float* __restrict__ coords,
                             float* __restrict__ out, const Levels levels,
                             int num_levels, int H1, int W1, int tiles_x,
                             int tiles_per_image, float scale) {
  constexpr int kSide = 2 * R + 2;
  constexpr int kWin = 2 * R + 1;
  constexpr int kTaps = kWin * kWin;
  constexpr int kMaxU = Box<R>::kMaxU;
  constexpr int kRows = box_rows<R>();
  constexpr int kNT = (kRows / 8 + 7) / 8;  // n-tiles a warp, at most
  constexpr int kChunks = kD / kChunk;
  constexpr int kStage = (kRows + kQ) * kStride;  // floats a stage
  constexpr int kSegs = kChunk / 4;               // 16-byte copies a staged row
  static_assert(2 * kNT <= 32, "the warp's (m-tile, n-tile) mask is 32 bits");
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_x0[kQ], s_y0[kQ];
  __shared__ float s_fx[kQ], s_fy[kQ];
  __shared__ int s_box[2][4];
  __shared__ int s_u[4][2];        // per m-tile, the box pixels its queries read
  __shared__ int s_row2[kRows];    // a box pixel's row in the image's level, -1 outside
  __shared__ int s_row1[kQ];       // a query's row in the image's fmap1, -1 outside

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int level = blockIdx.x % num_levels;
  const int b = blockIdx.x / num_levels / tiles_per_image;
  const int tile = blockIdx.x / num_levels - b * tiles_per_image;
  const int ty0 = tile / tiles_x * kTile, tx0 = tile % tiles_x * kTile;
  const float* f2;
  int hl, wl;
  select_level(levels, level, f2, hl, wl);

  // Prologue: a thread a query, then the union box of the valid queries'
  // integer grids (query 0, the tile's corner, is always in the image).
  int x0 = 0, y0 = 0;
  bool valid = false;
  if (tid < kQ) {
    const int y1 = ty0 + tid / kTile, x1 = tx0 + tid % kTile;
    valid = y1 < H1 && x1 < W1;
    float fx = 0.0f, fy = 0.0f;
    if (valid) {
      const long long pix = (static_cast<long long>(b) * H1 + y1) * W1 + x1;
      const float div = static_cast<float>(1 << level);
      window_origin(coords[2 * pix] / div, coords[2 * pix + 1] / div, hl, wl, x0, y0,
                    fx, fy, R);
    }
    s_x0[tid] = x0;
    s_y0[tid] = y0;
    s_fx[tid] = fx;
    s_fy[tid] = fy;
    s_row1[tid] = valid ? y1 * W1 + x1 : -1;
  }
  if (warp < kQ / 32) {
    const int mnx = __reduce_min_sync(0xffffffffu, valid ? x0 : INT_MAX);
    const int mxx = __reduce_max_sync(0xffffffffu, valid ? x0 : INT_MIN);
    const int mny = __reduce_min_sync(0xffffffffu, valid ? y0 : INT_MAX);
    const int mxy = __reduce_max_sync(0xffffffffu, valid ? y0 : INT_MIN);
    if (lane == 0) {
      s_box[warp][0] = mnx;
      s_box[warp][1] = mxx;
      s_box[warp][2] = mny;
      s_box[warp][3] = mxy;
    }
  }
  __syncthreads();
  // The box: origin (bx0, by0), bw x bh pixels; a 1-pixel axis is 1 wide.
  const int sx = wl > 1 ? 1 : 0, sy = hl > 1 ? 1 : 0;
  const int bx0 = sx ? min(s_box[0][0], s_box[1][0]) : 0;
  const int by0 = sy ? min(s_box[0][2], s_box[1][2]) : 0;
  const int bw = sx ? max(s_box[0][1], s_box[1][1]) - bx0 + kSide : 1;
  const int bh = sy ? max(s_box[0][3], s_box[1][3]) - by0 + kSide : 1;

  if (bw > kMaxU || bh > kMaxU || bw * bh > kMaxU) {
    // The box does not fit: the per-pixel form, a warp a pixel.
    float* dots = smem + warp * dots_per_warp<R>();
    for (int q = warp; q < kQ; q += kTiledWarps) {
      const int y1 = ty0 + q / kTile, x1 = tx0 + q % kTile;
      if (y1 >= H1 || x1 >= W1) continue;
      const long long pix = (static_cast<long long>(b) * H1 + y1) * W1 + x1;
      lookup_pixel<R, kD / 128>(fmap1, coords, out, f2, hl, wl, level, num_levels,
                                H1 * W1, kD, pix, scale, dots, lane);
    }
    return;
  }

  const int U = bw * bh;
  const int n_tiles = (U + 7) / 8;
  // Per box pixel, its row in this image's level (-1 outside: zero fill);
  // per m-tile (16 queries), the range of box pixels its queries' grids
  // cover (box pixel (r, c) is r * bw + c): the n-tiles outside it feed no
  // output of the m-tile and are skipped.
  for (int u = tid; u < U; u += kTiledThreads) {
    const int by = u / bw, bx = u - by * bw;
    const int gy = by0 + by, gx = bx0 + bx;
    s_row2[u] = gx >= 0 && gx < wl && gy >= 0 && gy < hl ? gy * wl + gx : -1;
  }
  if (warp < kQ / 32) {
    const int r0 = (y0 - by0) * sy, c0 = (x0 - bx0) * sx;
    int lo = valid ? r0 * bw + c0 : INT_MAX;
    int hi = valid ? (r0 + (sy ? kSide : 1) - 1) * bw + c0 + (sx ? kSide : 1) : 0;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if ((lane & 15) == 0) {
      s_u[tid / 16][0] = lo;
      s_u[tid / 16][1] = hi;
    }
  }
  __syncthreads();
  // Warp w takes m-tiles 2 (w / 8) and 2 (w / 8) + 1 and n-tiles w % 8 + 8 j;
  // bit mm * kNT + j: its n-tile j feeds its m-tile mm.
  const int m0 = 2 * (warp / 8), wn = warp % 8;
  unsigned need = 0;
#pragma unroll
  for (int mm = 0; mm < 2; ++mm) {
    const int nlo = s_u[m0 + mm][0] / 8, nhi = (s_u[m0 + mm][1] + 7) / 8;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int nt = wn + 8 * j;
      if (nt < n_tiles && nt >= nlo && nt < nhi) need |= 1u << (mm * kNT + j);
    }
  }

  const float* f2b = f2 + static_cast<long long>(b) * hl * wl * kD;
  const float* f1b = fmap1 + static_cast<long long>(b) * H1 * W1 * kD;
  // Stage ``ch`` of 32 channels: the box's fmap2 rows (zeros outside the
  // level) and the tile's fmap1 rows (zeros outside the image), 16 bytes a
  // copy. Box pixels past U are left as they are: no output reads them.
  auto load_chunk = [&](int ch, float* st) {
    float* s2 = st;
    float* s1 = st + kRows * kStride;
    for (int i = tid; i < U * kSegs; i += kTiledThreads) {
      const int u = i / kSegs, seg = i % kSegs;
      const int row = s_row2[u];
      cp_async16(s2 + u * kStride + seg * 4,
                 f2b + (row < 0 ? 0 : row) * kD + ch * kChunk + seg * 4, row >= 0);
    }
    for (int i = tid; i < kQ * kSegs; i += kTiledThreads) {
      const int q = i / kSegs, seg = i % kSegs;
      const int row = s_row1[q];
      cp_async16(s1 + q * kStride + seg * 4,
                 f1b + (row < 0 ? 0 : row) * kD + ch * kChunk + seg * 4, row >= 0);
    }
    cp_async_commit();
  };

  // The product on the tensor cores. Fragments (m16n8k8, TF32): lane =
  // 4 g + t reads A rows g and g + 8 at columns t and t + 4, B row (channel)
  // t and t + 4 at column (box pixel) g, and holds C rows g and g + 8 at
  // columns 2t, 2t+1. The three products of a split go to an accumulator
  // with the other m-tile's in between.
  const int g = lane >> 2, t4 = lane & 3;
  float acc[2][kNT][4];
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mm][j][e] = 0.0f;

  load_chunk(0, smem);
  for (int ch = 0; ch < kChunks; ++ch) {
    if (ch + 1 < kChunks) {
      load_chunk(ch + 1, smem + ((ch + 1) & 1) * kStage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s2 = smem + (ch & 1) * kStage;
    const float* s1 = s2 + (kRows + m0 * 16 + g) * kStride + t4;
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const float* p = s1 + mm * 16 * kStride + k0;
        split_tf32(p[0], ahi[mm][0], alo[mm][0]);
        split_tf32(p[8 * kStride], ahi[mm][1], alo[mm][1]);
        split_tf32(p[4], ahi[mm][2], alo[mm][2]);
        split_tf32(p[8 * kStride + 4], ahi[mm][3], alo[mm][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const unsigned mine = need >> j & (1u | 1u << kNT);  // bits 0 and kNT
        if (mine == 0) continue;
        const float* p = s2 + ((wn + 8 * j) * 8 + g) * kStride + k0 + t4;
        uint32_t bhi[2], blo[2];
        split_tf32(p[0], bhi[0], blo[0]);
        split_tf32(p[4], bhi[1], blo[1]);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          if (mine >> (mm * kNT) & 1) mma_tf32(acc[mm][j], alo[mm], bhi);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          if (mine >> (mm * kNT) & 1) mma_tf32(acc[mm][j], ahi[mm], blo);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          if (mine >> (mm * kNT) & 1) mma_tf32(acc[mm][j], ahi[mm], bhi);
      }
    }
    __syncthreads();  // the stage is read before the next chunk refills it
  }

  // The product [kQ][Up] over the stages, scaled by 1/sqrt(D); the entries
  // of skipped (m-tile, n-tile) pairs are never read.
  const int Up = n_tiles * 8;
  float* P = smem;
#pragma unroll
  for (int mm = 0; mm < 2; ++mm) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (need >> (mm * kNT + j) & 1) {
        float* p = P + ((m0 + mm) * 16 + g) * Up + (wn + 8 * j) * 8 + 2 * t4;
        p[0] = acc[mm][j][0] * scale;
        p[1] = acc[mm][j][1] * scale;
        p[8 * Up] = acc[mm][j][2] * scale;
        p[8 * Up + 1] = acc[mm][j][3] * scale;
      }
    }
  }
  __syncthreads();

  // A warp a query at a time, a lane a tap (two for the taps past 32): each
  // query blends its taps from its own grid of the box, as the per-pixel
  // form blends its dots, and writes them contiguously.
  constexpr int kPerLane = (kTaps + 31) / 32;
  int ti[kPerLane], tj[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int tap = lane + 32 * k;
    ti[k] = tap / kWin;  // dx = i - R: the grid column
    tj[k] = tap % kWin;  // dy = j - R: the grid row
  }
  for (int q = warp; q < kQ; q += kTiledWarps) {
    const int row = s_row1[q];
    if (row < 0) continue;
    const float* p = P + q * Up + (s_y0[q] - by0) * sy * bw + (s_x0[q] - bx0) * sx;
    const float fx = s_fx[q], fy = s_fy[q];
    float* o = out + ((static_cast<long long>(b) * H1 * W1 + row) * num_levels + level) * kTaps;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int tap = lane + 32 * k;
      if (tap < kTaps) {
        const float* r0 = p + tj[k] * sy * bw + ti[k] * sx;
        const float* r1 = r0 + sy * bw;
        o[tap] = (1.0f - fy) * ((1.0f - fx) * r0[0] + fx * r0[sx]) +
                 fy * ((1.0f - fx) * r1[0] + fx * r1[sx]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch

template <int R>
cudaError_t launch_per_pixel(const float* fmap1, const float* coords, float* out,
                             const Levels& levels, int num_levels, int HW1, int D,
                             long long num_pixels, float scale, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((num_pixels + kWarps - 1) / kWarps), num_levels);
  corr_lookup_kernel<R><<<grid, kThreads, 0, stream>>>(
      fmap1, coords, out, levels, num_levels, HW1, D, num_pixels, scale);
  return cudaGetLastError();
}

template <int R, int kD>
cudaError_t launch_tiled(const float* fmap1, const float* coords, float* out,
                         const Levels& levels, int num_levels, int B, int H1, int W1,
                         float scale, cudaStream_t stream) {
  constexpr int kSmem = tiled_smem_bytes<R>();
  // Above 48 KB of dynamic shared memory only after this opt-in (for the
  // current device).
  const cudaError_t opt_in = cudaFuncSetAttribute(
      corr_lookup_tiled_kernel<R, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  const int tiles_x = (W1 + kTile - 1) / kTile;
  const int tiles_per_image = tiles_x * ((H1 + kTile - 1) / kTile);
  const dim3 grid(static_cast<unsigned>(B) * tiles_per_image * num_levels);
  corr_lookup_tiled_kernel<R, kD><<<grid, kTiledThreads, kSmem, stream>>>(
      fmap1, coords, out, levels, num_levels, H1, W1, tiles_x, tiles_per_image, scale);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_radius(const float* fmap1, const float* coords, float* out,
                          const Levels& levels, int num_levels, int B, int H1, int W1,
                          int D, float scale, cudaStream_t s, bool vec) {
  if (vec && D == 128) return launch_tiled<R, 128>(fmap1, coords, out, levels, num_levels, B, H1, W1, scale, s);
  if (vec && D == 256) return launch_tiled<R, 256>(fmap1, coords, out, levels, num_levels, B, H1, W1, scale, s);
  const long long n = static_cast<long long>(B) * H1 * W1;
  return launch_per_pixel<R>(fmap1, coords, out, levels, num_levels, H1 * W1, D, n, scale, s);
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

// out [B, H1, W1, num_levels * (2 radius + 1)^2] from fmap1 [B, H1, W1, D],
// coords [B, H1, W1, 2] and the levels level_ptrs[l] [B, level_hw[2l],
// level_hw[2l+1], D], all fp32 and contiguous on the device; level_ptrs and
// level_hw are host arrays. One launch: the tiled form for D = 128 or 256
// with 16-byte aligned rows (and an image's maps under 2^31 floats), else
// the per-pixel form. Returns the CUDA error
// code (0 on success), also that of the shared-memory opt-in.
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
  // The tiled form: 16-byte aligned rows, and an image's fmap1 and levels
  // indexed by 32-bit offsets.
  constexpr long long kMaxOffset = 1LL << 31;
  bool vec = aligned16(fmap1) && static_cast<long long>(H1) * W1 * D < kMaxOffset;
  for (int l = 0; l < num_levels; ++l) {
    levels.f2[l] = reinterpret_cast<const float*>(level_ptrs[l]);
    levels.h[l] = level_hw[2 * l];
    levels.w[l] = level_hw[2 * l + 1];
    vec = vec && aligned16(levels.f2[l]) &&
          static_cast<long long>(levels.h[l]) * levels.w[l] * D < kMaxOffset;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (radius) {  // SmallRAFT's window and RAFT's
    case 3: err = launch_radius<3>(fmap1, coords, out, levels, num_levels, B, H1, W1, D, scale, s, vec); break;
    case 4: err = launch_radius<4>(fmap1, coords, out, levels, num_levels, B, H1, W1, D, scale, s, vec); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
