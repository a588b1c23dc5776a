// Kernel K3: the reflect-padded input of each 3x3 conv of DepthNet's
// decoder, written in one pass together with the elementwise work that
// produces it, and its gradient in one gather pass.
//
// It replaces no Pallas kernel: in deep_visual_slam_tpu/models/depthnet.py
// XLA fuses jnp.pad (mode="reflect") into the ELU, the nearest 2x upsample
// and the skip concatenation around it. In PyTorch each of those is a pass
// of its own, forward and backward, and F.pad first copies a channels-last
// input contiguous. One forward launch computes, for y [B, C1, h, w] and an
// optional skip [B, C2, H, W] (H = h << up, W = w << up, e and up in {0, 1}):
//
//   P = reflect_pad_1(cat(up2^up(elu^e(y)), skip))   [B, C1 + C2, H + 2, W + 2]
//
// The decoder calls two forms: pad_elu (up = 0, no skip; e = 1 on an
// upconv_i_1 output, e = 0 on the encoder's last feature) and pad_up_cat
// (e = up = 1, with the skip, none at the last level). The backward launch
// writes dy and dskip from dP: each of their elements sums, in fp32, the
// padded positions that reflect onto it (1 to 4, and each of them over the
// 2x2 block the upsample copied it to), multiplies by the ELU's derivative
// read back from P's interior (elu(y) + 1 where it is not positive: alpha is
// 1), and rounds once. Every output element is written by one thread: no
// atomics.
//
// Types: fp32 and bf16 (T); every tensor of a launch has the same type. The
// ELU is computed in fp32 (expm1f below 0, as PyTorch's CUDA ELU) and
// rounded once. y and skip are read, dy and dskip written, through their
// strides: the encoder's features are channels-last, the convs' outputs
// NCHW. P and dP are NCHW contiguous, the layout F.pad gave the convs.
//
// Bound: memory. At B = 64 and 480x640 in bf16 a decoder's 11 forward
// launches read y and the skips once (2.4 GB) and write P (3.4 GB): 1.8 ms
// at an H100 SXM's 3.35 TB/s. The 11 backward launches read dP (3.4 GB),
// P once per element of y (for the ELU's derivative), and write dy and
// dskip: 7.4 GB, 2.2 ms. chip_smoke.py times both against these bounds.
//
// Design. A block takes one source row i of one part (y or skip) of one
// image, for ct channels (a power of two, at most 64, as many as fit 48 KB
// of shared memory). The kernels are bound by the bytes in flight: every
// read from device memory is an aligned 16-byte vector, and each thread
// issues kUnroll of them before it uses any (read_runs). The forward reads
// the block's source rows into shared memory in the source's own layout (a
// channel's row where the columns are innermost, NCHW; a pixel's channels,
// scattered into the channels' rows, where those are, channels-last),
// applying the ELU once per source element. Then each warp writes whole
// rows of P: every padded row whose reflection, after the upsample, is
// source row i (1 or 2 of them, and one more at an edge). So every element
// of y and skip is read once and P is written once, by contiguous rows of
// W + 2; a row of P starts anywhere (1284 bytes at W = 640 in bf16), and
// the stores run along it, which the card merges into full sectors. The
// backward reverses it: the block copies those rows of dP, and with the
// ELU P's first interior copy of row i, into shared memory as they lie;
// each thread then gathers its source elements' padded rows and columns
// from there, in fp32, and writes them in the source's own layout. The
// grid gives a block to every (part, channel group, source row) and image:
// at the smallest level (512 x 15 x 20, ct = 64) that is 120 blocks an
// image, 7,680 at B = 64 for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = 48 * 1024;  // a block's shared memory, at most
constexpr int kUnroll = 4;             // 16-byte loads a thread keeps in flight
constexpr int kMaxGroupLog2 = 6;       // ct <= 64

// A [B, C, rows, cols] tensor read or written through its strides
// (in elements).
struct Strided {
  void* ptr;
  long long sb, sc, sh, sw;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The N elements of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
  T e[N];
  __device__ __forceinline__ explicit Vec(const uint4& v) { memcpy(e, &v, 16); }
  __device__ __forceinline__ uint4 bits() const {
    uint4 v;
    memcpy(&v, e, 16);
    return v;
  }
};

// y (or skip) as P holds it: through the ELU where `elu` (in fp32, expm1f
// below 0 as PyTorch's CUDA ELU), rounded to T once.
template <typename T>
__device__ __forceinline__ T activate(T v, int elu) {
  const float f = to_float(v);
  return elu && !(f > 0.f) ? from_float<T>(expm1f(f)) : v;
}

// Offset in elements of p from the 16-byte boundary at or below it.
template <typename T>
__device__ __forceinline__ int phase(const T* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) /
         static_cast<int>(sizeof(T));
}

// Interior index of padded index t + 1 in [0, n + 2): reflect(-1) = 1,
// reflect(n) = n - 2.
__device__ __forceinline__ int reflect(int t, int n) {
  return t < 0 ? -t : (t >= n ? 2 * (n - 1) - t : t);
}

// The padded rows in [0, n + 2) whose reflection, shifted right by up, is
// source row i, in order: row 0 where it reflects onto i (lo), the 1 << up
// interior ones from `first`, row n + 1 where it reflects onto i; `count`
// of them, at most 4 (n = 2 with up = 1).
struct Padded {
  int first, lo, count;
  __device__ __forceinline__ Padded(int i, int n, int up)
      : first((i << up) + 1),
        lo((1 >> up) == i),
        count(((1 >> up) == i) + (1 << up) + (((n - 2) >> up) == i)) {}
  __device__ __forceinline__ int row(int s, int up, int n) const {
    s -= lo;
    return s < 0 ? 0 : (s < (1 << up) ? first + s : n + 1);
  }
};

// What one block takes: `nc` channels from `c0` of y or skip (`src`), which
// are channels `pc0`.. of P, at source row i of a part `ws` wide.
struct Part {
  Strided src;
  int c0, nc, pc0, i, ws, up, elu;
};

__device__ __forceinline__ Part block_part(const Strided& y,
                                           const Strided& skip, int C1,
                                           int C2, int h, int w, int up,
                                           int elu, int ct) {
  Part p;
  const int H = h << up;
  const int y_blocks = (C1 + ct - 1) / ct * h;
  int id = blockIdx.x;
  if (id < y_blocks) {
    const int g = id / h;
    p.src = y;
    p.i = id - g * h;
    p.c0 = g * ct;
    p.nc = min(ct, C1 - p.c0);
    p.pc0 = p.c0;
    p.ws = w;
    p.up = up;
    p.elu = elu;
  } else {
    id -= y_blocks;
    const int g = id / H;
    p.src = skip;
    p.i = id - g * H;
    p.c0 = g * ct;
    p.nc = min(ct, C2 - p.c0);
    p.pc0 = C1 + p.c0;
    p.ws = w << up;
    p.up = 0;
    p.elu = 0;
  }
  return p;
}

// Vectors a run of `len` elements can touch, at any alignment.
__host__ __device__ __forceinline__ int run_vectors(int len, int N) {
  return (len + 2 * N - 2) / N;
}

// Pitch in elements of a block's shared-memory rows for runs of `len`: a
// whole number of vectors, and an odd one, so that neighbouring rows start
// in other banks.
__host__ __device__ __forceinline__ int row_pitch(int len, int N) {
  return N * (run_vectors(len, N) | 1);
}

// Reads `runs` runs of `len` elements by aligned 16-byte vectors, the
// block's threads each with kUnroll loads in flight before the first use.
// Run r starts at run_ptr(r), at any alignment; put(r, vec, ph, bits) takes
// the run's vector `vec`, whose element k is the run's element
// vec * N + k - ph. A vector is read whole where it reaches past its run:
// the 16-byte block around a tensor's first or last element lies on the
// same page.
template <typename T, typename RunPtr, typename Put>
__device__ __forceinline__ void read_runs(int runs, int len, RunPtr run_ptr,
                                          Put put) {
  constexpr int N = Vec<T>::N;
  const int nv = run_vectors(len, N);
  const int total = runs * nv;
  for (int f0 = threadIdx.x; f0 < total; f0 += kThreads * kUnroll) {
    uint4 v[kUnroll];
    int run[kUnroll], vec[kUnroll], ph[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int f = f0 + u * kThreads;
      run[u] = -1;
      if (f < total) {
        const int r = f / nv;
        const T* p = run_ptr(r);
        vec[u] = f - r * nv;
        ph[u] = phase(p);
        if (vec[u] * N < ph[u] + len) {
          v[u] = reinterpret_cast<const uint4*>(p - ph[u])[vec[u]];
          run[u] = r;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (run[u] >= 0) put(run[u], vec[u], ph[u], v[u]);
  }
}

// The most padded rows a source row gathers, Padded's largest count: 1 << up,
// one more at an edge, and one more where both edge rows reflect onto the
// same source row (H = 3 without the upsample, H = 2 with it).
__host__ __device__ __forceinline__ int max_rows(int H, int up) {
  return (1 << up) + 1 + ((1 >> up) == ((H - 2) >> up));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decoder_pad_fwd_kernel(Strided y, Strided skip, T* __restrict__ P,
                           int C1, int C2, int h, int w, int up, int elu,
                           int lct) {
  // [ct][sp]: each channel's source row, through the ELU, as P holds it.
  // Element x of channel c is at tile[c * sp + ph(c) + x].
  extern __shared__ uint4 smem_fwd[];
  T* tile = reinterpret_cast<T*>(smem_fwd);
  constexpr int N = Vec<T>::N;
  const int ct = 1 << lct;
  const Part p = block_part(y, skip, C1, C2, h, w, up, elu, ct);
  const int b = blockIdx.y;
  const int H = h << up, W = w << up, Wp = W + 2;
  const int sp = row_pitch(W, N);
  const T* src = static_cast<const T*>(p.src.ptr) + b * p.src.sb +
                 p.c0 * p.src.sc + p.i * p.src.sh;
  const Strided& s = p.src;
  // Columns innermost (NCHW): each channel's row is a run, copied as it
  // lies. Otherwise channels innermost (channels-last): each pixel's
  // channels are a run, scattered into the channels' rows.
  const bool by_rows = s.sw == 1;
  if (by_rows) {
    read_runs<T>(p.nc, p.ws, [&](int c) { return src + c * s.sc; },
                 [&](int c, int vec, int, uint4 bits) {
                   Vec<T> v(bits);
#pragma unroll
                   for (int k = 0; k < N; ++k) v.e[k] = activate(v.e[k], p.elu);
                   reinterpret_cast<uint4*>(tile + c * sp)[vec] = v.bits();
                 });
  } else if (s.sc == 1) {
    read_runs<T>(p.ws, p.nc, [&](int x) { return src + x * s.sw; },
                 [&](int x, int vec, int ph, uint4 bits) {
                   const Vec<T> v(bits);
#pragma unroll
                   for (int k = 0; k < N; ++k) {
                     const int c = vec * N + k - ph;
                     if (c >= 0 && c < p.nc)
                       tile[c * sp + x] = activate(v.e[k], p.elu);
                   }
                 });
  } else {  // any other strides: element by element
    for (int e = threadIdx.x; e < p.nc * p.ws; e += kThreads) {
      const int c = e / p.ws, x = e - c * p.ws;
      tile[c * sp + x] = activate(src[c * s.sc + x * s.sw], p.elu);
    }
  }
  __syncthreads();

  // Each warp writes whole rows of P, one channel at a time: every padded
  // row whose reflection is source row i.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Padded rows(p.i, H, p.up);
  const long long plane = static_cast<long long>(H + 2) * Wp;
  T* out = P + (static_cast<long long>(b) * (C1 + C2) + p.pc0) * plane;
  for (int c = warp; c < p.nc; c += kWarps) {
    const T* t = tile + c * sp + (by_rows ? phase(src + c * s.sc) : 0);
    for (int k = 0; k < rows.count; ++k) {
      T* row = out + c * plane + static_cast<long long>(rows.row(k, p.up, H)) * Wp;
      for (int q = lane; q < Wp; q += 32) row[q] = t[reflect(q - 1, W) >> p.up];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decoder_pad_bwd_kernel(const T* __restrict__ dP, const T* __restrict__ P,
                           Strided dy, Strided dskip, int C1, int C2, int h,
                           int w, int up, int elu, int lct) {
  // [slot][ct][sp]: slots 0..count-1 the padded rows of dP that reflect onto
  // source row i, slot `count` (with the ELU) P's first interior copy of
  // it, each as it lies; then [slot][ct] ints, where in sm each run starts:
  // element q of slot s, channel c is sm[at[s * ct + c] + q].
  extern __shared__ uint4 smem_bwd[];
  T* sm = reinterpret_cast<T*>(smem_bwd);
  constexpr int N = Vec<T>::N;
  const int ct = 1 << lct;
  const Part p = block_part(dy, dskip, C1, C2, h, w, up, elu, ct);
  const int b = blockIdx.y;
  const int H = h << up, W = w << up, Wp = W + 2;
  const int sp = row_pitch(Wp, N);
  const Padded rows(p.i, H, p.up);
  const int slots = rows.count + p.elu;
  int* at = reinterpret_cast<int*>(sm + (max_rows(H, up) + elu) * ct * sp);
  const long long plane = static_cast<long long>(H + 2) * Wp;
  const long long first = (static_cast<long long>(b) * (C1 + C2) + p.pc0) * plane;
  const auto run_ptr = [&](int r) {  // run r: slot r / nc, channel r % nc
    const int s = r / p.nc, c = r - s * p.nc;
    const int row = s < rows.count ? rows.row(s, p.up, H) : rows.first;
    return (s < rows.count ? dP : P) + first + c * plane + static_cast<long long>(row) * Wp;
  };
  read_runs<T>(slots * p.nc, Wp, run_ptr, [&](int r, int vec, int, uint4 bits) {
    const int s = r / p.nc, c = r - s * p.nc;
    reinterpret_cast<uint4*>(sm + (s * ct + c) * sp)[vec] = bits;
  });
  for (int r = threadIdx.x; r < slots * p.nc; r += kThreads) {
    const int s = r / p.nc, c = r - s * p.nc;
    at[s * ct + c] = (s * ct + c) * sp + phase(run_ptr(r));
  }
  __syncthreads();

  // Source column j gathers padded columns (j << up) + 1 (and + 2 with the
  // upsample), and the edge column that reflects onto it; the sum over the
  // slots is taken in fp32 and rounded once.
  const int left = 1 >> p.up, right = (W - 2) >> p.up;
  T* dst = static_cast<T*>(p.src.ptr) + b * p.src.sb + p.c0 * p.src.sc +
           p.i * p.src.sh;
  const auto put = [&](int c, int j) {
    const int q = (j << p.up) + 1;
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s >= rows.count) break;
      const T* g = sm + at[s * ct + c];
      acc += to_float(g[q]);
      if (p.up) acc += to_float(g[q + 1]);
      if (j == left) acc += to_float(g[0]);
      if (j == right) acc += to_float(g[W + 1]);
    }
    if (p.elu) {
      const float e = to_float(sm[at[rows.count * ct + c] + q]);
      if (!(e > 0.f)) acc *= e + 1.f;
    }
    dst[c * p.src.sc + j * p.src.sw] = from_float<T>(acc);
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (p.src.sc < p.src.sw) {  // channels innermost: lanes along a pixel's
    for (int e = threadIdx.x; e < (p.ws << lct); e += kThreads) {
      const int c = e & (ct - 1);
      if (c < p.nc) put(c, e >> lct);
    }
  } else {  // columns innermost: lanes along a row
    for (int c = warp; c < p.nc; c += kWarps)
      for (int j = lane; j < p.ws; j += 32) put(c, j);
  }
}


// log2 of the channels a block takes: the largest power of two ct <= 64
// whose shared memory fits kSmemBytes, and no larger than the wider part
// needs.
template <typename Bytes>
int group_log2(int C1, int C2, Bytes bytes) {
  int l = 0;
  while (l < kMaxGroupLog2 && bytes(2 << l) <= kSmemBytes && (1 << l) < max(C1, C2))
    ++l;
  return l;
}

size_t fwd_smem(int ct, int W, int elem) {
  return static_cast<size_t>(ct) * row_pitch(W, 16 / elem) * elem;
}

size_t bwd_smem(int ct, int H, int W, int up, int elu, int elem) {
  const size_t runs = static_cast<size_t>(max_rows(H, up) + elu) * ct;
  return runs * (row_pitch(W + 2, 16 / elem) * elem + sizeof(int));
}

Strided strided(const void* ptr, long long sb, long long sc, long long sh,
                long long sw) {
  return Strided{const_cast<void*>(ptr), sb, sc, sh, sw};
}

dim3 grid(int B, int C1, int C2, int h, int w, int up, int lct) {
  const int ct = 1 << lct;
  return dim3((C1 + ct - 1) / ct * h + (C2 + ct - 1) / ct * (h << up), B);
}

}  // namespace

// P [B, C1 + C2, H + 2, W + 2] (NCHW, contiguous) from y [B, C1, h, w] and
// skip [B, C2, H, W] (C2 = 0: none), each given with its strides; bf16 = 1
// for bfloat16, 0 for float32. Launches on `stream` and returns the CUDA
// error code (0 on success).
extern "C" int decoder_pad_forward(int bf16, const void* y, long long ysb,
                                   long long ysc, long long ysh,
                                   long long ysw, const void* skip,
                                   long long ssb, long long ssc,
                                   long long ssh, long long ssw, void* P,
                                   int B, int C1, int C2, int h, int w,
                                   int up, int elu, void* stream) {
  const int W = w << up, elem = bf16 ? 2 : 4;
  const int lct = group_log2(C1, C2, [&](int ct) { return fwd_smem(ct, W, elem); });
  const size_t smem = fwd_smem(1 << lct, W, elem);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strided ys = strided(y, ysb, ysc, ysh, ysw);
  const Strided ss = strided(skip, ssb, ssc, ssh, ssw);
  const dim3 g = grid(B, C1, C2, h, w, up, lct);
  if (bf16)
    decoder_pad_fwd_kernel<__nv_bfloat16><<<g, kThreads, smem, s>>>(
        ys, ss, static_cast<__nv_bfloat16*>(P), C1, C2, h, w, up, elu, lct);
  else
    decoder_pad_fwd_kernel<float><<<g, kThreads, smem, s>>>(
        ys, ss, static_cast<float*>(P), C1, C2, h, w, up, elu, lct);
  return static_cast<int>(cudaGetLastError());
}

// dy and dskip, written through their strides, from dP (the shape of P,
// NCHW contiguous) and, with elu = 1, P itself (else it may be null).
extern "C" int decoder_pad_backward(int bf16, const void* dP, const void* P,
                                    void* dy, long long ysb, long long ysc,
                                    long long ysh, long long ysw, void* dskip,
                                    long long ssb, long long ssc,
                                    long long ssh, long long ssw, int B,
                                    int C1, int C2, int h, int w, int up,
                                    int elu, void* stream) {
  const int H = h << up, W = w << up, elem = bf16 ? 2 : 4;
  const int lct = group_log2(C1, C2, [&](int ct) { return bwd_smem(ct, H, W, up, elu, elem); });
  const size_t smem = bwd_smem(1 << lct, H, W, up, elu, elem);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strided ys = strided(dy, ysb, ysc, ysh, ysw);
  const Strided ss = strided(dskip, ssb, ssc, ssh, ssw);
  const dim3 g = grid(B, C1, C2, h, w, up, lct);
  if (bf16)
    decoder_pad_bwd_kernel<__nv_bfloat16><<<g, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(dP),
        static_cast<const __nv_bfloat16*>(P), ys, ss, C1, C2, h, w, up, elu,
        lct);
  else
    decoder_pad_bwd_kernel<float><<<g, kThreads, smem, s>>>(
        static_cast<const float*>(dP), static_cast<const float*>(P), ys, ss,
        C1, C2, h, w, up, elu, lct);
  return static_cast<int>(cudaGetLastError());
}
