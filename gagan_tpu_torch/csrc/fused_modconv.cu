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
// N x 256 x 128 x 128 and b256.conv1, N x 128 x 256 x 256) one image is
// 19.3 GFLOP over x + y of 16.8 / 33.5 MB in bf16 and 33.5 / 67.1 MB in
// fp32: 1150 / 576 FLOP per byte in bf16, above the H100's bf16 ridge
// (~295), and 576 / 288 in fp32, far above its fp32 ridge (~20: 67 TFLOP/s
// of FFMA over 3.35 TB/s).  So each route is bound by operations, not by
// HBM as on the TPU the Pallas kernel was written for.  Inside the SM the
// next limits are the stream from L2 into shared memory (every pixel tile
// reads its sample's taps again, and x with a row halo) and, for FFMA, the
// dispatch slots and shared-memory wavefronts that feed it.
//
// Two launches, each behind its own C entry point so that they can be timed
// apart:
//  1. fold_taps_kernel folds modulation and demodulation into the 9 taps
//     into a scratch in x's dtype: bf16 [N, 9, C_out, C_in] (the TMA map's
//     K-major rows), fp32 [N, 9, C_in, C_out] (output channels innermost,
//     so that a thread reads its taps as 16-byte vectors).  One thread per
//     (n, o, i), the innermost index fastest so that its 9 stores coalesce,
//     reads w's 9 taps (36 contiguous bytes) once.  Folding inside every
//     block instead would repeat the fold once per pixel tile.
//  2. bf16: modconv_bf16_kernel; fp32: modconv_fp32_kernel.  Both below.
//
// modconv_fp32_kernel, an FFMA implicit GEMM per sample (fp32 stays fp32:
// no TF32, no tensor cores).  The H100 dispatches one warp instruction a clock
// on each of an SM's 4 schedulers and retires 4 warp-FFMA a clock, so
// every instruction that is not an FFMA costs an FFMA slot, and the SM
// serves one 128-byte shared-memory wavefront a clock.  The design keeps
// both small beside the FFMA:
//  * Tile: a block owns 128 output channels x 4 x 64 pixels and walks C_in
//    in chunks of 8.  Each block streams its sample's taps from L2 once, so
//    256 pixels a tile bring 151 MB an image at b128.conv1 (a 4 x 32 tile:
//    302 MB).  256 threads; a thread owns 8 channels x 16 contiguous
//    pixels of one row (128 fp32 accumulators).  Warp w: channel half
//    w % 2 and column run w / 2; lane l: channel group l % 8 (channels
//    4 (l % 8) + 0..3 and + 32 of the half) and row l / 8.
//  * Sliding window: per (input channel, dy) a thread loads its 16 pixels
//    plus the two halo pixels once (4 LDS.128 + 2 LDS.32) and reuses them
//    from registers for dx = 0, 1, 2; per dx it loads its 8 taps as 2
//    LDS.128.  So per (channel, dy): 384 FFMA for 12 LDS, 32 FFMA per
//    load instruction (8 x 8 scattered pixels read as scalars: 4).
//  * Wavefronts: a tap LDS.128 reads 8 distinct 16-byte vectors that the
//    warp's 4 rows share (128 contiguous bytes: 1 wavefront); an x LDS.128
//    reads 4 rows whose starts lie 8 banks apart (XS = 72 floats: 1
//    wavefront); an LDS.32 reads 4 words (1).  12 wavefronts per 384
//    warp-FFMA: 32 FFMA a wavefront, the shared-memory pipe busy an eighth
//    of the time.
//  * Code: the dy steps stay a rolled loop of 404 instructions (384 FFMA,
//    12 LDS, 8 of loop and address: 95% FFMA), unrolled over the chunk's 8
//    channels.  A body that small stays in the instruction cache; unrolling
//    dy too (1,200 instructions a channel) ran a few percent slower.
//  * A ring of 3 stages (49.5 KB each: taps [8][9][128] and x [8][6][72],
//    columns w0 - 4 .. w0 + 68) filled by 16-byte cp.async with zero-fill,
//    two chunks ahead of the FFMA, one __syncthreads a chunk.  x's span
//    starts 16-byte aligned since W % 4 == 0 and tiles start at multiples
//    of 64, so zero-fill is per whole vector (outside the image, ragged H
//    and W); C_out is a multiple of 4 (whole tap vectors, zero past C_out)
//    and C_in of 8 (whole chunks).
//  * Epilogue: the accumulators go to a [128][4][72] tile in the drained
//    ring (bank-even 16-byte stores), then each half-warp adds noise (16-
//    byte loads) and bias, applies the scaled leaky ReLU and the clamp in
//    fp32 and writes 256 contiguous bytes of one output row with 16-byte
//    stores, clipped at the ragged edge.
//  * One block of 8 warps an SM (152 KB of shared memory, up to 255
//    registers a thread): each scheduler interleaves 2 warps, each with
//    128 independent accumulator chains.
//  * What is left between it and the FFMA peak: the 5% of dispatch slots
//    that are not FFMA, the last partial wave of blocks (1024 blocks on
//    132 SMs at b128.conv1 are 7.76 waves), and stalls that the SASS does
//    not show (register-bank conflicts of the FFMA operands are a likely
//    part), with only 2 warps a scheduler to cover them: 8 x 16
//    accumulators leave no registers for more warps.
//
// modconv_bf16_kernel, an implicit GEMM per sample on wgmma:
//  * A block owns 128 output channels x a 4 x 64 pixel tile: M = 128 (two
//    consumer warpgroups, m64 each), N = 256 (wgmma m64n256k16, fp32
//    accumulators), K = 9 * C_in walked as (64-channel chunk, dx, dy).
//  * A producer warpgroup fills a ring of 2 stages, each guarded by a full
//    and an empty mbarrier.  A stage is one (chunk, dx): the x slabs for
//    that column shift and the tap tiles of dy = 0, 1, 2.
//  * A = taps, K-major, loaded by TMA: a 2-D tensor map over the scratch
//    seen as [N * 9 * C_out, C_in], box 64 channels x 128 rows, 128-byte
//    swizzle, 16 KB a tap, counted by expect_tx.  The k16 steps advance the
//    descriptor by 32 bytes.  Channels past C_in read as zeros.
//  * B = x, MN-major (wgmma's transpose bit): each of the tile's 4 + 2 input
//    rows is an 8 KB slab [64 ch][64 px], a stack of the canonical 128-byte
//    MN-major atoms (8 ch x 64 px, 1 KB).  Descriptor: SBO = 1 KB (next 8
//    channels), LBO = 8 KB (next 64 pixels, the next row).
//  * The 3 x 3 shifts: the row shift (dy) is a descriptor offset of dy
//    slabs, with no data moved.  The column shift (dx) has to be moved: it
//    cannot be expressed in a swizzled operand, and a TMA box whose
//    innermost start is not 16-byte aligned faults on this card (an illegal
//    instruction, found with a probe of single boxes), so a one-pixel shift
//    cannot be a TMA load either.  Instead the 128 producer threads build
//    the slabs, taking the stages of a chunk in the order dx = 1, 0, 2:
//    the dx = 1 slabs are copied in with 16-byte cp.async (aligned,
//    zero-filled outside the image and past C_in: the padding), the two
//    8-pixel halo vectors of each line go to registers, and the dx = 0 and
//    dx = 2 slabs are funnel-shifted by one bf16 out of the dx = 1 slabs in
//    shared memory (dx = 0 into the other buffer, dx = 2 in place once the
//    dx = 1 stage is released).  x crosses from L2 once per chunk, and the
//    shifted stages cost no global round trip.  Stores are 16-byte and
//    conflict free in the swizzled layout; fence.proxy.async precedes each
//    arrive on the full barrier.
//  * Shared memory: 2 stages x (6 x 8 KB + 3 x 16 KB) = 192 KB, plus 1 KB of
//    alignment slack and the barriers: 197,664 of the 232,448 bytes a block
//    may take, one block per SM.  A third stage does not fit; 2-row tiles
//    (80 KB a stage) would read 1.7x the bytes per product.
//  * Registers: 384 threads are launched with 168 each; setmaxnreg moves
//    them to 176 for the consumers (128 accumulators) and 152 for the
//    producer.
//  * Consumers keep one wgmma group in flight (wait_group 1) and release the
//    previous stage as soon as its group has retired.
//  * Epilogue: noise and bias added to the fp32 accumulators, the scaled
//    leaky ReLU and the clamp, one rounding to bf16; the tile is staged in
//    the drained ring in the y map's 128-byte-swizzled layout (bank-conflict
//    free 4-byte stores) and written by TMA stores (aligned boxes), which
//    clip the ragged edge.
//  * Not done: clusters of 2 with TMA multicast of the taps (halves the A
//    stream from L2), a persistent grid that overlaps one tile's epilogue
//    with the next tile's loads.
// bf16 needs W % 8 == 0 (16-byte TMA strides), C_in % 8 == 0 and
// C_out % 128 == 0; fp32 needs W % 4 == 0, C_in % 8 == 0, C_out % 4 == 0
// and 16-byte aligned x, noise, taps and y.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// taps = T((w * s) * d): bf16 [N, 9, C_out, C_in], fp32 [N, 9, C_in, C_out].
template <typename T>
__global__ void fold_taps_kernel(const float* __restrict__ w,       // [O,I,3,3]
                                 const float* __restrict__ styles,  // [N,I]
                                 const float* __restrict__ dcoefs,  // [N,O]
                                 T* __restrict__ taps,
                                 int N, int C_out, int C_in) {
  constexpr bool kOInner = sizeof(T) == 4;
  const long long plane = (long long)C_out * C_in;
  const long long total = (long long)N * plane;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(idx / plane);
    const long long at = idx - n * plane;  // (o, i) within a tap's plane
    const int outer = (int)(at / (kOInner ? C_out : C_in));
    const int inner = (int)(at - (long long)outer * (kOInner ? C_out : C_in));
    const int o = kOInner ? inner : outer;
    const int i = kOInner ? outer : inner;
    const float s = styles[(long long)n * C_in + i];
    const float d = dcoefs[(long long)n * C_out + o];
    const float* wp = w + ((long long)o * C_in + i) * 9;
    T* tp = taps + n * 9 * plane + at;
#pragma unroll
    for (int t = 0; t < 9; ++t) tp[t * plane] = from_float<T>((wp[t] * s) * d);
  }
}

struct Epilogue {
  const float* bias;  // [C_out]
  float act_gain, act_slope, clamp;
  int has_clamp;

  __device__ __forceinline__ float act(float v) const {
    v = act_gain * (fmaxf(v, 0.f) + act_slope * fminf(v, 0.f));
    if (has_clamp) v = v < -clamp ? -clamp : (v > clamp ? clamp : v);
    return v;
  }
};

// ---------------------------------------------------------------------------
// fp32: FFMA implicit GEMM with a sliding register window (see the note at
// the top).
namespace fp32 {

constexpr int BM = 128;   // output channels per block
constexpr int TH = 4;     // output rows per block
constexpr int TW = 64;    // output columns per block
constexpr int BK = 8;     // input channels per K chunk
constexpr int RUN = 16;   // contiguous pixels of one row a thread owns
constexpr int kStages = 3;
// A stage: taps [BK][9][BM] (channels innermost), then x [BK][TH + 2][XS]
// holding columns w0 - 4 .. w0 + TW + 4.  XS = 72 = 8 (mod 32): the four
// rows that a warp reads start 8 banks apart.
constexpr int XS = TW + 8;
constexpr int XPLANE = (TH + 2) * XS;
constexpr int kTapFloats = BK * 9 * BM;
constexpr int kStageFloats = kTapFloats + BK * XPLANE;
// Epilogue tile [BM slots][TH][YS] in the drained ring.  A thread's 8
// channels go to slots 8 apart (slot_of below), so that the 8 channel groups
// of a warp take consecutive slots; OS = 73 16-byte units puts their 16-byte
// stores, with the rows' 18-unit offsets, evenly on the banks.
constexpr int YS = TW + 8;
constexpr int OS = TH * YS + 4;
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;

static_assert(BM == 128 && TH == 4 && BK == 8 && TW == 64 && RUN == 16 &&
                  kThreads == 256,
              "thread map: warps 2 channel halves x 4 column runs, lanes 8 "
              "channel groups x 4 rows; the copies' index maps");
static_assert(XS % 32 == 8, "x rows 8 banks apart");
static_assert(BM * OS <= kStages * kStageFloats, "epilogue tile fits the ring");
static_assert(kSmemBytes <= 232448, "more shared memory than a block may take");

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One K chunk into a stage, 16-byte copies zero-filled outside the image and
// past C_out.  Taps [9][C_in][C_out] of the sample -> [ci][tap][o]: a warp
// copies one (ci, tap) row of 128 channels at a time.  x rows h0 - 1 ..
// h0 + TH of each channel -> [ci][row][XS]: the 64 columns of the tile as
// 16 vectors a line, then the 4 columns on either side.
__device__ __forceinline__ void load_chunk(uint32_t stage,
                                           const float* __restrict__ xn,
                                           const float* __restrict__ tn,
                                           int c0, int o0, int h0, int w0,
                                           int C_in, int C_out, int H, int W) {
  const int tid = threadIdx.x, lane = tid % 32;
  const int o = o0 + 4 * lane;
  for (int row = tid / 32; row < BK * 9; row += kThreads / 32) {
    const int ci = row / 9, tap = row - 9 * ci;
    const bool valid = o < C_out;
    const float* src =
        valid ? tn + ((long long)tap * C_in + c0 + ci) * C_out + o : tn;
    cp_async16(stage + 16u * (row * 32 + lane), src, valid);
  }
  constexpr int kLines = BK * (TH + 2);  // line = row * BK + ci
  constexpr int kMid = kLines * TW / 4;
  static_assert(kMid % kThreads == 0 && 2 * kLines <= kThreads,
                "whole x copies a thread");
#pragma unroll
  for (int k = 0; k < kMid / kThreads; ++k) {
    const int v = tid + k * kThreads;
    const int col = v % (TW / 4), ci = v / (TW / 4) % BK;
    const int row = v / (TW / 4) / BK;
    const int hh = h0 - 1 + row, ww = w0 + 4 * col;
    const bool valid = hh >= 0 && hh < H && ww < W;
    const float* src =
        valid ? xn + ((long long)(c0 + ci) * H + hh) * W + ww : xn;
    cp_async16(stage + 4u * (kTapFloats + ci * XPLANE + row * XS + 4 + 4 * col),
               src, valid);
  }
  if (tid < 2 * kLines) {
    const int side = tid % 2, ci = tid / 2 % BK, row = tid / 2 / BK;
    const int hh = h0 - 1 + row, ww = side ? w0 + TW : w0 - 4;
    const bool valid = hh >= 0 && hh < H && ww >= 0 && ww < W;
    const float* src =
        valid ? xn + ((long long)(c0 + ci) * H + hh) * W + ww : xn;
    cp_async16(
        stage + 4u * (kTapFloats + ci * XPLANE + row * XS + side * (TW + 4)),
        src, valid);
  }
}

// Slot of the epilogue tile for local channel o (its inverse in the kernel).
__device__ __forceinline__ int slot_of(int o) {
  return (o & ~31) | ((o & 3) << 3) | ((o >> 2) & 7);
}

}  // namespace fp32

__global__ void __launch_bounds__(kThreads, 1)
modconv_fp32_kernel(const float* __restrict__ x,     // [N, C_in, H, W]
                    const float* __restrict__ taps,  // [N, 9, C_in, C_out]
                    float* __restrict__ y,           // [N, C_out, H, W]
                    Epilogue ep, const float* __restrict__ noise,
                    int C_in, int C_out, int H, int W, int tiles_w) {
  using namespace fp32;
  extern __shared__ __align__(16) float smem_f[];
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_f));

  const int n = blockIdx.z;
  const int o0 = blockIdx.y * BM;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const long long plane = (long long)H * W;
  const float* xn = x + (long long)n * C_in * plane;
  const float* tn = taps + (long long)n * 9 * C_in * C_out;
  float* yn = y + (long long)n * C_out * plane;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp & 1, run = warp >> 1;  // channel half, column run
  const int grp = lane & 7, r = lane >> 3;     // channel group, row
  // This thread's taps: local channels 64 half + 4 grp + (0..3, 32..35).
  const float* a_s = smem_f + 64 * half + 4 * grp;
  // Its x window: row r (+ dy), columns RUN run - 1 .. RUN run + RUN.
  const float* x_s = smem_f + kTapFloats + r * XS + RUN * run + 3;

  float acc[8][RUN];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int p = 0; p < RUN; ++p) acc[j][p] = 0.f;

  const int n_chunks = C_in / BK;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_chunks)
      load_chunk(smem_s + 4u * k * kStageFloats, xn, tn, k * BK, o0, h0, w0,
                 C_in, C_out, H, W);
    cp_async_commit();
  }
  int s_use = 0, s_fill = kStages - 1;
  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<kStages - 2>();  // chunk k has landed (this thread's copies)
    __syncthreads();               // ... all threads'; chunk k - 1 is consumed
    if (k + kStages - 1 < n_chunks)
      load_chunk(smem_s + 4u * s_fill * kStageFloats, xn, tn,
                 (k + kStages - 1) * BK, o0, h0, w0, C_in, C_out, H, W);
    cp_async_commit();
    const float* as = a_s + s_use * kStageFloats;
    const float* xs = x_s + s_use * kStageFloats;
#pragma unroll
    for (int ci = 0; ci < BK; ++ci) {
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        const float* xr = xs + ci * XPLANE + dy * XS;
        float xv[RUN + 2];
        xv[0] = xr[0];
#pragma unroll
        for (int q = 0; q < RUN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(xr + 1 + 4 * q);
          xv[1 + 4 * q] = v.x;
          xv[2 + 4 * q] = v.y;
          xv[3 + 4 * q] = v.z;
          xv[4 + 4 * q] = v.w;
        }
        xv[RUN + 1] = xr[RUN + 1];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* ar = as + (ci * 9 + dy * 3 + dx) * BM;
          const float4 t0 = *reinterpret_cast<const float4*>(ar);
          const float4 t1 = *reinterpret_cast<const float4*>(ar + 32);
          const float t[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int p = 0; p < RUN; ++p)
              acc[j][p] = fmaf(t[j], xv[p + dx], acc[j][p]);
        }
      }
    }
    s_use = s_use == kStages - 1 ? 0 : s_use + 1;
    s_fill = s_fill == kStages - 1 ? 0 : s_fill + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: it becomes the epilogue tile

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int slot = slot_of(64 * half + 32 * (j / 4) + 4 * grp + j % 4);
    float* row = smem_f + slot * OS + r * YS + RUN * run;
#pragma unroll
    for (int q = 0; q < RUN / 4; ++q)
      *reinterpret_cast<float4*>(row + 4 * q) =
          make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                      acc[j][4 * q + 3]);
  }
  __syncthreads();

  // Half-warp per output row: 16 x 16 bytes of one (channel, row).
  const float* nz = noise != nullptr ? noise + n * plane : nullptr;
  constexpr int kVecs = TW / 4;
#pragma unroll 4
  for (int v = threadIdx.x; v < BM * TH * kVecs; v += kThreads) {
    const int line = v / kVecs;  // slot * TH + row
    const int vec = v - kVecs * line;
    const int slot = line / TH, rr = line - TH * slot;
    const int o = o0 + ((slot & ~31) | ((slot & 7) << 2) | ((slot >> 3) & 3));
    const int h = h0 + rr, w = w0 + 4 * vec;
    if (o >= C_out || h >= H || w >= W) continue;
    float4 val =
        *reinterpret_cast<const float4*>(smem_f + slot * OS + rr * YS + 4 * vec);
    if (nz != nullptr) {
      const float4 nv =
          *reinterpret_cast<const float4*>(nz + (long long)h * W + w);
      val.x += nv.x;
      val.y += nv.y;
      val.z += nv.z;
      val.w += nv.w;
    }
    const float b = ep.bias[o];
    val.x = ep.act(val.x + b);
    val.y = ep.act(val.y + b);
    val.z = ep.act(val.z + b);
    val.w = ep.act(val.w + b);
    *reinterpret_cast<float4*>(yn + (long long)o * plane + (long long)h * W +
                               w) = val;
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised (see the note at the top).
namespace tc {

constexpr int BM = 128;                    // output channels per block
constexpr int TH = 4;                      // output rows per block
constexpr int TW = 64;                     // output columns per block
constexpr int BK = 64;                     // input channels per chunk
constexpr int kStages = 2;
constexpr int kXRows = TH + 2;
constexpr int kSlab = BK * TW * 2;         // one input row: [64 ch][64 px]
constexpr int kXBytes = kXRows * kSlab;    // 48 KB
constexpr int kTapBytes = BM * BK * 2;     // one tap: [128 o][64 i], 16 KB
constexpr int kStageBytes = kXBytes + 3 * kTapBytes;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 4 * 8;
constexpr int kConsumerWarps = 8;          // two warpgroups
constexpr int kThreadsTc = 32 * kConsumerWarps + 128;  // + a producer WG
// Registers a thread after setmaxnreg; the sum stays the 168 x 384 the
// launch allocates.
constexpr int kConsumerRegs = 176;
constexpr int kProducerRegs = 152;
// Descriptor strides (bytes).  A, K-major: SBO = 8 rows of 128 B.  B,
// MN-major: SBO = 8 channels of 128 B, LBO = one slab (the next 64 pixels).
constexpr uint32_t kASbo = 1024;
constexpr uint32_t kBSbo = 1024;
constexpr uint32_t kBLbo = kSlab;
// A wait on a barrier that lasts this many cycles (several seconds) means
// the pipeline is broken: trap, so that the launch fails instead of hanging.
constexpr long long kWaitTrapCycles = 1LL << 34;

static_assert(256 * kConsumerRegs + 128 * kProducerRegs <= 168 * kThreadsTc,
              "register split exceeds the launch's allocation");
static_assert(kSmemBytes <= 232448, "more shared memory than a block may take");
static_assert(2 * 64 * TH * TW * 2 <= kStageBytes, "epilogue tile fits a stage");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitTrapCycles) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t funnel(uint32_t lo, uint32_t hi) {
  return __funnelshift_r(lo, hi, 16);  // bf16 elements 1..2 of (lo, hi)
}

// The x slabs of a stage: line L = slab row * 64 + c of a stage holds 64
// pixels of channel c0 + c, input row h0 - 1 + L / 64, as 8 16-byte chunks,
// chunk j stored at chunk j ^ (c % 8) of the line (the 128-byte swizzle a
// TMA load would apply).  Producer thread pt owns lines pt, pt + 128 and
// pt + 256 (one channel, three rows) in every stage.
constexpr int kLines = kXRows * BK / 128;

__device__ __forceinline__ unsigned char* x_line(unsigned char* xs, int pt,
                                                 int l) {
  return xs + (pt + 128 * l) * 128;
}

// Column shift 1 (pixels w0 .. w0 + 63): 16-byte cp.async copies straight
// into the swizzled lines, zero-filled outside the image and past C_in;
// the 8 pixels on either side of each line go to registers for the other
// two shifts.
__device__ __forceinline__ void load_x(unsigned char* xs, int pt,
                                       const __nv_bfloat16* __restrict__ xn,
                                       int c0, int h0, int w0, int C_in,
                                       int H, int W, uint4 (&left)[kLines],
                                       uint4 (&right)[kLines]) {
  const int c = pt % BK;
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    const int h = h0 - 1 + (pt + 128 * l) / BK;
    const bool valid = h >= 0 && h < H && c0 + c < C_in;
    const __nv_bfloat16* row =
        valid ? xn + ((long long)(c0 + c) * H + h) * W : xn;
    const uint32_t dst = smem_u32(x_line(xs, pt, l));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int px = w0 + 8 * j;
      const bool in = valid && px < W;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst + (j ^ (c & 7)) * 16),
                   "l"(in ? row + px : xn), "r"(in ? 16 : 0)
                   : "memory");
    }
    left[l] = right[l] = make_uint4(0u, 0u, 0u, 0u);
    if (valid && w0 >= 8)
      left[l] = __ldg(reinterpret_cast<const uint4*>(row + w0 - 8));
    if (valid && w0 + TW < W)
      right[l] = __ldg(reinterpret_cast<const uint4*>(row + w0 + TW));
  }
}

// Column shift DX = 0 or 2 from the shift-1 lines in src (dst may be src):
// out[p] = in[p - 1] with in[-1] from left, or out[p] = in[p + 1] with
// in[64] from right.
template <int DX>
__device__ __forceinline__ void shift_x(unsigned char* dst,
                                        const unsigned char* src, int pt,
                                        const uint4 (&halo)[kLines]) {
  const int sw = pt % BK % 8;
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    uint4 v[10];  // v[1..8]: the line's chunks; v[0] / v[9]: the halo
    v[0] = v[9] = halo[l];
    const unsigned char* in = src + (pt + 128 * l) * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j + 1] = *reinterpret_cast<const uint4*>(in + (j ^ sw) * 16);
    unsigned char* out = x_line(dst, pt, l);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint4 o;
      if (DX == 0) {  // pixels 8j - 1 .. 8j + 6
        o.x = funnel(v[j].w, v[j + 1].x);
        o.y = funnel(v[j + 1].x, v[j + 1].y);
        o.z = funnel(v[j + 1].y, v[j + 1].z);
        o.w = funnel(v[j + 1].z, v[j + 1].w);
      } else {        // pixels 8j + 1 .. 8j + 8
        o.x = funnel(v[j + 1].x, v[j + 1].y);
        o.y = funnel(v[j + 1].y, v[j + 1].z);
        o.z = funnel(v[j + 1].z, v[j + 1].w);
        o.w = funnel(v[j + 1].w, v[j + 2].x);
      }
      *reinterpret_cast<uint4*>(out + (j ^ sw) * 16) = o;
    }
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the async
// wgmma boundaries.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] (K-major) * B[16 x 256] (MN-major), bf16 -> fp32.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

}  // namespace tc

__global__ void __launch_bounds__(tc::kThreadsTc, 1)
modconv_bf16_kernel(const __nv_bfloat16* __restrict__ x,        // [N,C_in,H,W]
                    __grid_constant__ const CUtensorMap t_map,  // (C_in, N*9*C_out)
                    __grid_constant__ const CUtensorMap y_map,  // (W,H,C_out,N)
                    Epilogue ep, const float* __restrict__ noise, int C_in,
                    int C_out, int H, int W, int tiles_w) {
  using namespace tc;
  extern __shared__ unsigned char smem_raw[];
  // Stage buffers start on a 1 KB boundary: the swizzle pattern and the
  // descriptors' base offset of 0 assume it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int n = blockIdx.z;
  const int o0 = blockIdx.y * BM;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int n_iter = (C_in + BK - 1) / BK * 3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 128 + 1);  // producer threads + the expect_tx
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producer warpgroup.  Per 64-channel chunk, three stages in the order
    // dx = 1, 0, 2: the dx = 1 slabs are copied in (stage it, buffer s);
    // the dx = 0 slabs are shifted out of them into the other buffer
    // (stage it + 1) while the consumers work on stage it; the dx = 2 slabs
    // are shifted in place once stage it is released (stage it + 2, buffer
    // s again).  So x crosses from L2 once per chunk, not once per stage.
    // One thread issues the tap loads (TMA) of each stage.
    static_assert(kStages == 2 && kLines == 3, "ring of 2, 3 lines a thread");
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = threadIdx.x - 32 * kConsumerWarps;
    const __nv_bfloat16* xn = x + (long long)n * C_in * H * W;
    auto acquire = [&](int it, int dx) {  // stage it's buffer, empty
      const int s = it % kStages;
      mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
      if (pt == 0) {
        const uint32_t ts = base + s * kStageBytes + kXBytes;
        mbar_expect_tx(full(s), 3 * kTapBytes);
        for (int dy = 0; dy < 3; ++dy)
          tma_load_2d(ts + dy * kTapBytes, &t_map, full(s), (it / 3) * BK,
                      (n * 9 + dy * 3 + dx) * C_out + o0);
      }
      return smem + s * kStageBytes;
    };
    auto publish = [&](int it) {  // x of stage it written by this thread
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full(it % kStages));
    };
    for (int it = 0; it < n_iter; it += 3) {
      uint4 left[kLines], right[kLines];
      unsigned char* xs = acquire(it, 1);
      load_x(xs, pt, xn, (it / 3) * BK, h0, w0, C_in, H, W, left, right);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      publish(it);
      shift_x<0>(acquire(it + 1, 0), xs, pt, left);
      publish(it + 1);
      shift_x<2>(acquire(it + 2, 2), xs, pt, right);
      publish(it + 2);
    }
    return;
  }

  // Consumers: warpgroup wg computes output channels o0 + 64 wg .. + 64.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    __syncwarp();
    const uint32_t xs = base + s * kStageBytes;
    const uint32_t ts = xs + kXBytes + wg * (64 * BK * 2);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(
            acc, make_desc(ts + dy * kTapBytes + kk * 32, 16, kASbo),
            make_desc(xs + dy * kSlab + kk * 16 * 128, kBLbo, kBSbo));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue.  Accumulator i = 4j + e of thread (warp wi, lane l) is output
  // channel 16 wi + l/4 (+8 for e >= 2) and tile column 8 j + 2 (l%4)
  // (+1 for odd e), that is tile row j / 8, pixel 8 (j % 8) + 2 (l%4).
  named_bar_sync(1, 32 * kConsumerWarps);  // both warpgroups are off the ring
  const int wi = warp % 4;
  const int c_lo = 16 * wi + lane / 4;    // and c_lo + 8
  const int o_lo = o0 + 64 * wg + c_lo;
  const float b_lo = ep.bias[o_lo], b_hi = ep.bias[o_lo + 8];
  const float* nz = noise != nullptr ? noise + (long long)n * H * W : nullptr;
  // Staging tile of this warpgroup: [TH rows][64 ch][64 px] bf16, each
  // 128-byte line's 16-byte chunks swizzled by the line's index mod 8.
  unsigned char* stg = smem + wg * (64 * TH * TW * 2);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = j / 8, px = 8 * (j % 8) + 2 * (lane % 4);
    const int h = h0 + r, w = w0 + px;
    float2 nv = make_float2(0.f, 0.f);
    if (nz != nullptr && h < H && w < W)
      nv = *reinterpret_cast<const float2*>(nz + (long long)h * W + w);
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16_rn(ep.act(acc[4 * j + 0] + nv.x + b_lo));
    lo.y = __float2bfloat16_rn(ep.act(acc[4 * j + 1] + nv.y + b_lo));
    hi.x = __float2bfloat16_rn(ep.act(acc[4 * j + 2] + nv.x + b_hi));
    hi.y = __float2bfloat16_rn(ep.act(acc[4 * j + 3] + nv.y + b_hi));
    const int chunk = ((j % 8) ^ (c_lo % 8)) * 16 + 4 * (lane % 4);
    unsigned char* line = stg + (r * 64 + c_lo) * 128 + chunk;
    *reinterpret_cast<__nv_bfloat162*>(line) = lo;
    *reinterpret_cast<__nv_bfloat162*>(line + 8 * 128) = hi;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_bar_sync(2 + wg, 128);
  if (threadIdx.x % 128 == 0) {
    for (int r = 0; r < TH && h0 + r < H; ++r)
      tma_store_4d(&y_map, smem_u32(stg) + r * 64 * 128, w0, h0 + r,
                   o0 + 64 * wg, n);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Host side.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, which the CUDA runtime
// has already loaded; looking it up keeps the build free of -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 tensor map with 128-byte swizzle; dims innermost first, strides in
// bytes for dims 1.., out-of-bounds elements read as zero.
int encode_map(CUtensorMap* map, const void* ptr, int rank,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_fold(const float* w, const float* styles, const float* dcoefs,
                void* taps, int N, int C_out, int C_in, cudaStream_t stream) {
  const long long total = (long long)N * C_out * C_in;
  const long long blocks = (total + kThreads - 1) / kThreads;
  fold_taps_kernel<T><<<(int)(blocks < 65536 ? blocks : 65536), kThreads, 0,
                        stream>>>(w, styles, dcoefs, static_cast<T*>(taps), N,
                                  C_out, C_in);
  return (int)cudaGetLastError();
}

int launch_fp32(const float* x, const float* taps, const float* noise,
                const float* bias, float* y, int N, int C_in, int C_out, int H,
                int W, Epilogue ep, cudaStream_t stream) {
  using namespace fp32;
  if (C_in % BK != 0 || C_out % 4 != 0 || W % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(taps) |
       reinterpret_cast<uintptr_t>(noise) | reinterpret_cast<uintptr_t>(y)) &
      15)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      modconv_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, (C_out + BM - 1) / BM, N);
  modconv_fp32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      x, taps, y, ep, noise, C_in, C_out, H, W, tiles_w);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* taps, const float* noise, void* y,
                int N, int C_in, int C_out, int H, int W, Epilogue ep,
                cudaStream_t stream) {
  using namespace tc;
  if (W % 8 != 0 || C_in % 8 != 0 || C_out % BM != 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t e = 2;  // bytes per element
  CUtensorMap t_map, y_map;
  const cuuint64_t t_dims[2] = {(cuuint64_t)C_in, (cuuint64_t)N * 9 * C_out};
  const cuuint64_t t_strides[1] = {e * C_in};
  const cuuint32_t t_box[2] = {BK, BM};
  int err = encode_map(&t_map, taps, 2, t_dims, t_strides, t_box);
  if (err != 0) return err;
  const cuuint64_t y_dims[4] = {(cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)C_out, (cuuint64_t)N};
  const cuuint64_t y_strides[3] = {e * W, e * W * H, e * W * H * C_out};
  const cuuint32_t y_box[4] = {TW, 1, 64, 1};  // one row of 64 channels
  err = encode_map(&y_map, y, 4, y_dims, y_strides, y_box);
  if (err != 0) return err;

  cudaError_t cerr = cudaFuncSetAttribute(
      modconv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, C_out / BM, N);
  modconv_bf16_kernel<<<grid, kThreadsTc, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), t_map, y_map, ep, noise, C_in,
      C_out, H, W, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// noise may be null.  Each returns the CUDA error code of its launches
// (0 = ok).

// Launch 1: taps [N, 9, C_out, C_in] in x's dtype from w, styles, dcoefs.
extern "C" int gagan_fused_modconv3x3_fold(int dtype, const float* w,
                                           const float* styles,
                                           const float* dcoefs, void* taps,
                                           int N, int C_in, int C_out,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fold<float>(w, styles, dcoefs, taps, N, C_out, C_in, s);
  if (dtype == 1)
    return launch_fold<__nv_bfloat16>(w, styles, dcoefs, taps, N, C_out, C_in,
                                      s);
  return (int)cudaErrorInvalidValue;
}

// Launch 2: y from x and the folded taps.
extern "C" int gagan_fused_modconv3x3_conv(
    int dtype, const void* x, const void* taps, const float* noise,
    const float* bias, void* y, int N, int C_in, int C_out, int H, int W,
    float act_gain, float act_slope, float clamp, int has_clamp,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue ep{bias, act_gain, act_slope, clamp, has_clamp};
  if (dtype == 0)
    return launch_fp32(static_cast<const float*>(x),
                       static_cast<const float*>(taps), noise, bias,
                       static_cast<float*>(y), N, C_in, C_out, H, W, ep, s);
  if (dtype == 1)
    return launch_bf16(x, taps, noise, y, N, C_in, C_out, H, W, ep, s);
  return (int)cudaErrorInvalidValue;
}

// Both launches in turn (taps is the caller's scratch).
extern "C" int gagan_fused_modconv3x3(
    int dtype, const void* x, const float* w, const float* styles,
    const float* dcoefs, const float* noise, const float* bias, void* taps,
    void* y, int N, int C_in, int C_out, int H, int W, float act_gain,
    float act_slope, float clamp, int has_clamp, void* stream) {
  const int err = gagan_fused_modconv3x3_fold(dtype, w, styles, dcoefs, taps,
                                              N, C_in, C_out, stream);
  if (err != 0) return err;
  return gagan_fused_modconv3x3_conv(dtype, x, taps, noise, bias, y, N, C_in,
                                     C_out, H, W, act_gain, act_slope, clamp,
                                     has_clamp, stream);
}

// Dynamic shared memory of the conv kernel of a dtype, in bytes.
extern "C" int gagan_fused_modconv3x3_smem_bytes(int dtype) {
  return dtype == 1 ? tc::kSmemBytes : (int)fp32::kSmemBytes;
}
