// Fused modulated-conv synthesis level for Hopper (sm_90a).
//
// Replaces the TPU kernel gagan_tpu/ops/pallas_modconv.py::_kernel (launched
// by _fused_forward).  Per sample n and output channel o, stride 1, zero pad 1:
//
//   y = clamp(g * lrelu_a(sum_{i,ky,kx} T[n,ky*3+kx,o,i] * x[n,i,h+ky-1,w+kx-1]
//                         + noise[n,h,w] + b[o]), +-clamp)
//   T[n,t,o,i] = to_x_dtype((W[o,i,t] * s[n,i]) * dcoef[n,o])   (fp32 fold)
//
// The fold rounds where the Pallas kernel rounds (pallas_modconv.py:142-145),
// so this kernel and its plain PyTorch version agree up to summation order.
//
// What bounds it here: at the FFHQ-1024 levels it serves (b128.conv1,
// N x 256 x 128 x 128 and b256.conv1, N x 128 x 256 x 256, bf16) one image is
// 19.3 GFLOP over 16.8 / 33.5 MB of x + y, about 576 FLOP per byte: above the
// H100's bf16 ridge (~295), so the level is bound by tensor-core operations,
// not by HBM as on the TPU the Pallas kernel was written for.
//
// Design (a simple first version; wgmma / TMA / pipelining are later work):
//  * fold_taps_kernel folds modulation and demodulation into the 9 taps once
//    per (n, o) into a scratch [N, 9, C_out, C_in] in x's dtype;
//  * modconv_kernel is an implicit GEMM per sample, M = C_out, N = pixels,
//    K = 9 * C_in.  A block owns 128 output channels x a 4 x 32 pixel tile
//    and walks C_in in chunks of 16: the chunk's taps and the (4+2) x (32+2)
//    halo of x go to shared memory channel-innermost, zero outside the image
//    (the row/column masks of the Pallas kernel become zero-filled halo
//    cells), then 9 shifted products accumulate in fp32 registers;
//  * bf16 uses mma.sync m16n8k16 (8 warps, 64 x 32 outputs each); fp32 uses
//    FFMA (each thread 8 x 8 outputs), so fp32 stays fp32;
//  * the epilogue adds noise and bias, applies the scaled leaky ReLU and the
//    clamp in fp32, and writes y once in x's dtype.
// Ragged edges (H, W, C_out not multiples of the tile) are masked; C_in must
// be a multiple of 16 (one K chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128;             // output channels per block
constexpr int TH = 4;               // output rows per block
constexpr int TW = 32;              // output columns per block
constexpr int BK = 16;              // input channels per K chunk
constexpr int HALO_W = TW + 2;
constexpr int HALO = (TH + 2) * HALO_W;

// Shared-memory row strides (elements).  bf16: 24 halves = 12 words, so the
// 8 rows a fragment load touches fall in distinct banks.  fp32: taps are read
// as broadcasts (16, keeps 16-byte rows); the halo stride of 17 words puts 16
// neighbouring pixels in distinct banks.
template <typename T> struct Smem;
template <> struct Smem<__nv_bfloat16> {
  static constexpr int A_LD = 24;
  static constexpr int X_LD = 24;
};
template <> struct Smem<float> {
  static constexpr int A_LD = 16;
  static constexpr int X_LD = 17;
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (9 * BM * Smem<T>::A_LD + HALO * Smem<T>::X_LD);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void fold_taps_kernel(const float* __restrict__ w,       // [O,I,3,3]
                                 const float* __restrict__ styles,  // [N,I]
                                 const float* __restrict__ dcoefs,  // [N,O]
                                 T* __restrict__ taps,              // [N,9,O,I]
                                 int N, int C_out, int C_in) {
  const long long total = (long long)N * 9 * C_out * C_in;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(idx % C_in);
    long long r = idx / C_in;
    const int o = (int)(r % C_out);
    r /= C_out;
    const int t = (int)(r % 9);
    const int n = (int)(r / 9);
    float v = w[((long long)o * C_in + i) * 9 + t] * styles[(long long)n * C_in + i];
    v = v * dcoefs[(long long)n * C_out + o];
    taps[idx] = from_float<T>(v);
  }
}

// Taps of one K chunk: [9][BM][BK] -> A_s rows (tap*BM + o), 16-byte copies.
template <typename T>
__device__ __forceinline__ void stage_taps(T* A_s, const T* __restrict__ tn,
                                           int o0, int c0, int C_out,
                                           int C_in) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = BK / VEC;
  for (int v = threadIdx.x; v < 9 * BM * VPR; v += kThreads) {
    const int col = (v % VPR) * VEC;
    const int row = v / VPR;
    const int o = row % BM;
    const int t = row / BM;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (o0 + o < C_out)
      val = *reinterpret_cast<const uint4*>(
          tn + ((long long)t * C_out + o0 + o) * C_in + c0 + col);
    *reinterpret_cast<uint4*>(A_s + row * Smem<T>::A_LD + col) = val;
  }
}

// Halo of x for one K chunk, channel-innermost: X_s[pix][ci], zero outside
// the image.
__device__ __forceinline__ void stage_x(__nv_bfloat16* X_s,
                                        const __nv_bfloat16* __restrict__ xn,
                                        int c0, int h0, int w0, int H, int W) {
  const long long plane = (long long)H * W;
  for (int v = threadIdx.x; v < (BK / 2) * HALO; v += kThreads) {
    const int pix = v % HALO;
    const int pr = v / HALO;
    const int hh = h0 - 1 + pix / HALO_W;
    const int ww = w0 - 1 + pix % HALO_W;
    __nv_bfloat162 pair;
    pair.x = __float2bfloat16_rn(0.f);
    pair.y = pair.x;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
      const __nv_bfloat16* p = xn + (c0 + 2 * pr) * plane + (long long)hh * W + ww;
      pair.x = p[0];
      pair.y = p[plane];
    }
    *reinterpret_cast<__nv_bfloat162*>(X_s + pix * Smem<__nv_bfloat16>::X_LD +
                                       2 * pr) = pair;
  }
}

__device__ __forceinline__ void stage_x(float* X_s,
                                        const float* __restrict__ xn, int c0,
                                        int h0, int w0, int H, int W) {
  const long long plane = (long long)H * W;
  for (int v = threadIdx.x; v < BK * HALO; v += kThreads) {
    const int pix = v % HALO;
    const int ci = v / HALO;
    const int hh = h0 - 1 + pix / HALO_W;
    const int ww = w0 - 1 + pix % HALO_W;
    float val = 0.f;
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      val = xn[(c0 + ci) * plane + (long long)hh * W + ww];
    X_s[pix * Smem<float>::X_LD + ci] = val;
  }
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Epilogue {
  const float* noise;  // [H, W] of this sample, or nullptr
  const float* bias;   // [C_out]
  float act_gain, act_slope, clamp;
  int has_clamp;

  __device__ __forceinline__ float operator()(float v, int o, int h, int w,
                                              int W) const {
    if (noise != nullptr) v = v + noise[(long long)h * W + w];
    v = v + bias[o];
    v = act_gain * (fmaxf(v, 0.f) + act_slope * fminf(v, 0.f));
    if (has_clamp) v = v < -clamp ? -clamp : (v > clamp ? clamp : v);
    return v;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
modconv_kernel(const T* __restrict__ x,        // [N, C_in, H, W]
               const T* __restrict__ taps,     // [N, 9, C_out, C_in]
               T* __restrict__ y,              // [N, C_out, H, W]
               Epilogue ep, const float* __restrict__ noise,
               int C_in, int C_out, int H, int W, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A_s = reinterpret_cast<T*>(smem_raw);
  T* X_s = A_s + 9 * BM * Smem<T>::A_LD;

  const int n = blockIdx.z;
  const int o0 = blockIdx.y * BM;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const long long plane = (long long)H * W;
  const T* xn = x + (long long)n * C_in * plane;
  const T* tn = taps + (long long)n * 9 * C_out * C_in;
  T* yn = y + (long long)n * C_out * plane;
  if (noise != nullptr) ep.noise = noise + n * plane;

  if constexpr (sizeof(T) == 2) {
    // mma.sync path.  Warp (wm, wr): output channels wm*64 .. +64, output
    // row wr of the tile; fragment element owners follow the PTX layout of
    // m16n8k16 (g = lane / 4, t = lane % 4).
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 64;
    const int wr = warp >> 1;
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

    for (int c0 = 0; c0 < C_in; c0 += BK) {
      stage_taps<T>(A_s, tn, o0, c0, C_out, C_in);
      stage_x(X_s, xn, c0, h0, w0, H, W);
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const T* ap = A_s + (tap * BM + wm + mi * 16 + g) * Smem<T>::A_LD + 2 * t;
          a[mi][0] = lds32(ap);
          a[mi][1] = lds32(ap + 8 * Smem<T>::A_LD);
          a[mi][2] = lds32(ap + 8);
          a[mi][3] = lds32(ap + 8 * Smem<T>::A_LD + 8);
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const T* bp = X_s + ((wr + dy) * HALO_W + nj * 8 + g + dx) * Smem<T>::X_LD + 2 * t;
          b[nj][0] = lds32(bp);
          b[nj][1] = lds32(bp + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], a[mi], b[nj]);
      }
      __syncthreads();
    }

    const int h = h0 + wr;
    if (h < H) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int o = o0 + wm + mi * 16 + g + hi * 8;
          if (o >= C_out) continue;
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int w = w0 + nj * 8 + 2 * t + e;
              if (w < W)
                yn[o * plane + (long long)h * W + w] =
                    from_float<T>(ep(acc[mi][nj][hi * 2 + e], o, h, w, W));
            }
        }
    }
  } else {
    // FFMA path.  Thread (ty, tx): output channels ty + 16j, pixels
    // tx + 16k of the 4 x 32 tile (row k / 2, column tx + 16 (k % 2)).
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    float acc[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

    for (int c0 = 0; c0 < C_in; c0 += BK) {
      stage_taps<T>(A_s, tn, o0, c0, C_out, C_in);
      stage_x(X_s, xn, c0, h0, w0, H, W);
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
#pragma unroll 4
        for (int ci = 0; ci < BK; ++ci) {
          float a[8], b[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            a[j] = A_s[(tap * BM + ty + 16 * j) * Smem<T>::A_LD + ci];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            b[k] = X_s[(((k >> 1) + dy) * HALO_W + tx + 16 * (k & 1) + dx) *
                           Smem<T>::X_LD + ci];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(a[j], b[k], acc[j][k]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + ty + 16 * j;
      if (o >= C_out) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int h = h0 + (k >> 1);
        const int w = w0 + tx + 16 * (k & 1);
        if (h < H && w < W)
          yn[o * plane + (long long)h * W + w] =
              from_float<T>(ep(acc[j][k], o, h, w, W));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* w, const float* styles,
           const float* dcoefs, const float* noise, const float* bias,
           void* taps, void* y, int N, int C_in, int C_out, int H, int W,
           float act_gain, float act_slope, float clamp, int has_clamp,
           cudaStream_t stream) {
  const long long total = (long long)N * 9 * C_out * C_in;
  const int fold_blocks = (int)((total + kThreads - 1) / kThreads < 65536
                                    ? (total + kThreads - 1) / kThreads
                                    : 65536);
  fold_taps_kernel<T><<<fold_blocks, kThreads, 0, stream>>>(
      w, styles, dcoefs, static_cast<T*>(taps), N, C_out, C_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes<T>();
  err = cudaFuncSetAttribute(modconv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (C_out + BM - 1) / BM, N);
  Epilogue ep{nullptr, bias, act_gain, act_slope, clamp, has_clamp};
  modconv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(taps),
      static_cast<T*>(y), ep, noise, C_in, C_out, H, W, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// noise may be null.  Returns the CUDA error code of the launches (0 = ok).
extern "C" int gagan_fused_modconv3x3(
    int dtype, const void* x, const float* w, const float* styles,
    const float* dcoefs, const float* noise, const float* bias, void* taps,
    void* y, int N, int C_in, int C_out, int H, int W, float act_gain,
    float act_slope, float clamp, int has_clamp, void* stream) {
  if (C_in % BK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, styles, dcoefs, noise, bias, taps, y, N, C_in,
                         C_out, H, W, act_gain, act_slope, clamp, has_clamp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, styles, dcoefs, noise, bias, taps, y, N,
                                 C_in, C_out, H, W, act_gain, act_slope, clamp,
                                 has_clamp, s);
  return (int)cudaErrorInvalidValue;
}
