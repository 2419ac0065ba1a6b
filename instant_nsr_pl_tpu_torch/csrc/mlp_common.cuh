// Shared device-side forward of the packed bf16 ReLU MLP, and the launch
// helpers of the grid-stride kernels.
//
// Replaces kernel_mlp_fwd of instant_nsr_pl_tpu/ops/mlp_pallas_common.py:74-96,
// the MLP chain both fused TPU forward kernels end in, for the fused radiance
// forward (csrc/sh_mlp_fwd.cu K3); the fused density forward (csrc/cp_mlp_fwd.cu
// K1) runs the same chain on the tensor cores. One thread evaluates
// the whole chain for one sample with its activations in registers; the packed
// weights (ops/mlp_common.py pack_mlp: (sum d_in, Wmax) bf16, zero columns
// beyond each layer's d_out) are widened to f32 in shared memory once per
// block, and every thread of a warp reads the same weight row (a broadcast, no
// bank conflict).
//
// Forward rounding points are the TPU kernel's: each layer's input is rounded
// to bf16, the products are exact in f32 (bf16 x bf16) and accumulate in f32,
// the f32 bias is added after the sum, ReLU is applied and hidden activations
// are rounded to bf16 before the next layer. The last layer stays f32. In
// training mode the hidden activations are also stored as the (NH, W, N) bf16
// residual `hsave`.
//
// The backward of the chain (kernel_mlp_bwd) runs on the tensor cores in
// mma_common.cuh, as do the CP Jacobian backward kernels' products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace insr {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__host__ __device__ constexpr int round_up4(int x) { return (x + 3) / 4 * 4; }

// Widen `count` packed bf16 values to f32 shared memory (block-cooperative).
__device__ __forceinline__ void load_bf16_to_shared(
    const __nv_bfloat16* __restrict__ src, int count, float* dst) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    dst[i] = __bfloat162float(src[i]);
  }
}

__device__ __forceinline__ void load_f32_to_shared(
    const float* __restrict__ src, int count, float* dst) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// z[j] = sum_i x[i] * w[i][j] + b[j] for j < NOUT, with w rows WMAX wide.
// NOUT is a multiple of 4 (columns past a layer's d_out are zero in the pack).
template <int NIN, int NOUT, int WMAX>
__device__ __forceinline__ void dense(const float* __restrict__ w,
                                      const float* __restrict__ b,
                                      const float (&x)[NIN], float (&z)[NOUT]) {
  static_assert(NOUT % 4 == 0 && NOUT <= WMAX && WMAX % 4 == 0, "layout");
#pragma unroll
  for (int j = 0; j < NOUT; ++j) z[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < NIN; ++i) {
    const float xi = x[i];
    const float4* row = reinterpret_cast<const float4*>(w + i * WMAX);
#pragma unroll
    for (int j4 = 0; j4 < NOUT / 4; ++j4) {
      const float4 wv = row[j4];
      z[4 * j4 + 0] = fmaf(wv.x, xi, z[4 * j4 + 0]);
      z[4 * j4 + 1] = fmaf(wv.y, xi, z[4 * j4 + 1]);
      z[4 * j4 + 2] = fmaf(wv.z, xi, z[4 * j4 + 2]);
      z[4 * j4 + 3] = fmaf(wv.w, xi, z[4 * j4 + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NOUT; ++j) z[j] = z[j] + b[j];
}

// Store hidden layer l of sample i to the (NH, W, n) bf16 residual: neighbouring
// threads hold neighbouring samples, so each store is coalesced across a warp.
template <int W>
__device__ __forceinline__ void store_hidden(__nv_bfloat16* __restrict__ hsave,
                                             int l, long long n, long long i,
                                             const float (&h)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) {
    hsave[(static_cast<long long>(l) * W + j) * n + i] = __float2bfloat16_rn(h[j]);
  }
}

// The whole chain: x0 (DIN, f32) -> out (OUT4 = round_up4(d_out) columns).
// w: packed (DIN + NH * W, W) f32 in shared memory; b: (NH + 1, W) f32.
// hsave: the (NH, W, n) bf16 residual of training mode, or nullptr.
template <int DIN, int W, int NH, int OUT4>
__device__ __forceinline__ void mlp_forward(const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            const float (&x0)[DIN],
                                            float (&out)[OUT4],
                                            __nv_bfloat16* __restrict__ hsave,
                                            long long n, long long i) {
  static_assert(NH >= 1, "the fused chain has at least one hidden layer");
  float h[W];
  {
    float xin[DIN];
#pragma unroll
    for (int k = 0; k < DIN; ++k) xin[k] = bf16_round(x0[k]);
    float z[W];
    dense<DIN, W, W>(w, b, xin, z);
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = bf16_round(fmaxf(z[j], 0.0f));
  }
  if (hsave != nullptr) store_hidden<W>(hsave, 0, n, i, h);
#pragma unroll
  for (int l = 1; l < NH; ++l) {
    float z[W];
    dense<W, W, W>(w + (DIN + (l - 1) * W) * W, b + l * W, h, z);
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = bf16_round(fmaxf(z[j], 0.0f));
    if (hsave != nullptr) store_hidden<W>(hsave, l, n, i, h);
  }
  dense<W, OUT4, W>(w + (DIN + (NH - 1) * W) * W, b + NH * W, h, out);
}

// Store the first D of OUT4 values to a row-major (N, D) f32 output.
template <int D, int OUT4>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&v)[OUT4]) {
  if constexpr (D % 4 == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int j4 = 0; j4 < D / 4; ++j4) {
      d4[j4] = make_float4(v[4 * j4], v[4 * j4 + 1], v[4 * j4 + 2],
                           v[4 * j4 + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) dst[j] = v[j];
  }
}

// Grid of a grid-stride launch: enough blocks to fill every SM a few times.
inline int grid_for(long long n, int block) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long need = (n + block - 1) / block;
  long long cap = 8LL * sms;
  return static_cast<int>(need < cap ? (need > 0 ? need : 1) : cap);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// per-kernel limit first where it exceeds the default 48 KB.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long n, int block, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n > 0) {
    kernel<<<grid_for(n, block), block, smem, stream>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr
