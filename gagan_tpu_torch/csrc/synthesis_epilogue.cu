// The synthesis layers' epilogue in one pass, for Hopper (sm_90a).
//
// Per element of a modulated convolution's output c [N, C, H, W] (NCHW,
// contiguous, bf16 or fp32), before demodulation:
//
//   y[n,o,h,w] = clamp(gain * lrelu_alpha(c[n,o,h,w] * d[n,o]
//                                         + noise[n',o / (C/P),h,w] + b[o]),
//                      -clamp, +clamp)
//
// d [N, C] are the demodulation coefficients and b [C] the bias, both fp32;
// noise [1 or N, P, H, W] is in c's dtype and optional, n' = 0 when its
// first dimension is 1 (broadcast over the batch); P = 1 for an unpacked
// layer, 4 for the 2x2-packed tail, whose channel o reads plane o / (C/4)
// (ops/packed.py's cell-major order).
//
// It replaces no TPU kernel.  The JAX package leaves this chain to XLA,
// which fuses it into one pass; eager PyTorch runs it as separate
// full-size passes (the demodulation multiply, the noise add, the bias
// add, the lrelu's compare, multiply and select, the gain multiply, the
// clamp), about 17 bytes moved for every byte of c.  The work is a few
// flops an element, so the kernel is bound by bytes: at least c read once
// and y written once.  The design does that and nothing more:
//  * 16-byte loads and stores (8 bf16 or 4 fp32 elements a thread and
//    vector), four vectors a thread in flight before any is used;
//  * c and y with streaming hints (evict first), so that the noise planes,
//    shared by the batch and read by every channel of a cell, stay in L2;
//  * one block row (blockIdx.y) per (n, o) plane: d[n,o] and b[o] are
//    loaded once a block and kept in registers;
//  * small planes (the 4^2 - 32^2 layers) take blocks of fewer threads, so
//    that threads are not left idle.
// A plane whose H*W is not a multiple of the vector, or a pointer that is
// not 16-byte aligned, takes the same kernel one element a thread.
//
// The arithmetic is fp32 in registers, in the composed ops' order and
// without contraction into fused multiply-adds (__fmul_rn, __fadd_rn), and
// the result is rounded once, to c's dtype, at the store: in fp32 the
// kernel gives the composed ops' bits, in bf16 the fp32 result rounded
// once.  alpha and gain arrive already rounded to c's dtype, as the JAX
// semantics round a Python scalar (ops/bias_act.py::_scalar).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;            // vectors a thread loads before using
constexpr int kMaxGridY = 65535;

// Storage types: fp32 as float, bf16 as its 16 bits.
template <bool BF16>
struct Elem;

template <>
struct Elem<false> {
  using S = float;
  static __device__ __forceinline__ float load(S s) { return s; }
  static __device__ __forceinline__ S store(float v) { return v; }
};

template <>
struct Elem<true> {
  using S = uint16_t;
  static __device__ __forceinline__ float load(S s) {
    return __uint_as_float(static_cast<uint32_t>(s) << 16);
  }
  static __device__ __forceinline__ S store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Vec {
  S v[VEC];
};

// Streaming load / store (evict first) of a 16-byte vector; a plain access
// otherwise.
template <typename S, int VEC>
__device__ __forceinline__ Vec<S, VEC> load_stream(const S* p) {
  Vec<S, VEC> r;
  if constexpr (sizeof(r) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
    r = *reinterpret_cast<const Vec<S, VEC>*>(p);
  }
  return r;
}

template <typename S, int VEC>
__device__ __forceinline__ Vec<S, VEC> load_cached(const S* p) {
  Vec<S, VEC> r;
  if constexpr (sizeof(r) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
    r = *reinterpret_cast<const Vec<S, VEC>*>(p);
  }
  return r;
}

template <typename S, int VEC>
__device__ __forceinline__ void store_stream(S* p, const Vec<S, VEC>& r) {
  if constexpr (sizeof(r) == 16) {
    uint4 u;
    memcpy(&u, &r, 16);
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
    *reinterpret_cast<Vec<S, VEC>*>(p) = r;
  }
}

struct Params {
  const void* c;
  const float* d;
  const float* b;
  const void* noise;            // null: no noise
  void* y;
  long long planes;             // N * C
  int channels;                 // C
  long long hw;                 // H * W
  int group;                    // C / P: channels that read one noise plane
  long long noise_batch_stride; // 0 (broadcast) or P * H * W
  float alpha, gain, clamp;
  int has_clamp;
};

template <bool BF16, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
synthesis_epilogue_kernel(Params p) {
  using E = Elem<BF16>;
  using S = typename E::S;
  using V = Vec<S, VEC>;
  const long long nvec = p.hw / VEC;                 // vectors a plane
  const long long chunk = (long long)blockDim.x * kUnroll;
  const S* c = static_cast<const S*>(p.c);
  const S* noise = static_cast<const S*>(p.noise);
  S* y = static_cast<S*>(p.y);

  for (long long plane = blockIdx.y; plane < p.planes; plane += gridDim.y) {
    const long long n = plane / p.channels;
    const int o = static_cast<int>(plane % p.channels);
    const float dn = p.d[plane];                     // d is [N, C]
    const float bo = p.b[o];
    const S* cp = c + plane * p.hw;
    S* yp = y + plane * p.hw;
    const S* np = noise == nullptr
                      ? nullptr
                      : noise + n * p.noise_batch_stride
                            + (long long)(o / p.group) * p.hw;
    for (long long base = (long long)blockIdx.x * chunk; base < nvec;
         base += (long long)gridDim.x * chunk) {
      V cv[kUnroll], nv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (long long)u * blockDim.x + threadIdx.x;
        if (i < nvec) {
          cv[u] = load_stream<S, VEC>(cp + i * VEC);
          if (np != nullptr) nv[u] = load_cached<S, VEC>(np + i * VEC);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (long long)u * blockDim.x + threadIdx.x;
        if (i >= nvec) continue;
        V out;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          float v = __fmul_rn(E::load(cv[u].v[k]), dn);
          if (np != nullptr) v = __fadd_rn(v, E::load(nv[u].v[k]));
          v = __fadd_rn(v, bo);
          v = v >= 0.0f ? v : __fmul_rn(v, p.alpha);
          v = __fmul_rn(v, p.gain);
          if (p.has_clamp) v = v < -p.clamp ? -p.clamp
                                            : (v > p.clamp ? p.clamp : v);
          out.v[k] = E::store(v);
        }
        store_stream<S, VEC>(yp + i * VEC, out);
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <bool BF16, int VEC>
int launch(const Params& p, cudaStream_t stream) {
  const long long nvec = p.hw / VEC;
  // Threads a block: enough for the plane's vectors at kUnroll a thread,
  // whole warps, at most kMaxThreads.
  long long want = (nvec + kUnroll - 1) / kUnroll;
  want = ((want + 31) / 32) * 32;
  const int threads = static_cast<int>(want < 32 ? 32
                                       : want > kMaxThreads ? kMaxThreads
                                                            : want);
  const long long chunk = (long long)threads * kUnroll;
  const long long gx = (nvec + chunk - 1) / chunk;
  const long long gy = p.planes < kMaxGridY ? p.planes : kMaxGridY;
  synthesis_epilogue_kernel<BF16, VEC>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), threads,
         0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const Params& p, cudaStream_t stream) {
  constexpr int kVec = BF16 ? 8 : 4;                 // 16 bytes
  if (p.hw % kVec == 0 && aligned16(p.c) && aligned16(p.y)
      && aligned16(p.noise))
    return launch<BF16, kVec>(p, stream);
  return launch<BF16, 1>(p, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns the launch's CUDA error (0: none).
extern "C" int gagan_synthesis_epilogue(
    int dtype, const void* c, const float* d, const float* b,
    const void* noise, void* y, long long planes, int channels, long long hw,
    int noise_planes, long long noise_batch_stride, float alpha, float gain,
    float clamp, int has_clamp, void* stream) {
  if (planes <= 0 || hw <= 0) return 0;
  if (channels <= 0 || noise_planes <= 0 || channels % noise_planes != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{c, d, b, noise, y, planes, channels, hw,
                 channels / noise_planes, noise_batch_stride, alpha, gain,
                 clamp, has_clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<false>(p, s);
  if (dtype == 1) return dispatch<true>(p, s);
  return (int)cudaErrorInvalidValue;
}
