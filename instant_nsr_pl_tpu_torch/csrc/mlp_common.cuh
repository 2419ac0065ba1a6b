// bf16 rounding, shared through cp_common.cuh, and the launch helpers of the
// grid-stride kernel K7 (csrc/cp_product_jac_fwd.cu).
//
// The packed bf16 ReLU MLP (ops/mlp_common.py pack_mlp: (sum d_in, Wmax) bf16,
// zero columns beyond each layer's d_out) runs on the tensor cores in every
// kernel that holds it: the forwards csrc/cp_mlp_fwd.cu (K1/K13) and
// csrc/sh_mlp_fwd.cu (K3), the backwards on csrc/mma_common.cuh (K2/K14, K4).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace insr {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
