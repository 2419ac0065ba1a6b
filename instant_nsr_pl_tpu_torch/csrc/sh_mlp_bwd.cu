// Fused SH-encode -> concat -> bf16 ReLU MLP backward (the NeRF radiance head).
//
// Replaces: instant_nsr_pl_tpu/ops/sh_mlp_pallas.py _sh_mlp_bwd -> _bwd_kernel
// (pallas_call at :252). Gradients of the packed MLP weights and biases and
// of the features; the directions get none, by the op's contract
// (sh_mlp_pallas.py:11-17: they are functions of the rays only).
//
// What it computes, per sample: the MLP input x0 = [features | zero padding to
// FPAD | SH(dirs)] again (SH recomputed in f32 from the raw unit direction, as
// the TPU backward does), then the MLP backward of mlp_common.cuh from the
// forward's hsave (NH, W, N) bf16 residual (csrc/sh_mlp_fwd.cu training mode)
// and dout (N, D) f32: dW += bf16(a) x bf16(g), db += g, and the input
// cotangent W @ bf16(g), of which the first n_feat rows are d features (N,
// n_feat) f32. The host (ops/sh_mlp.py) drops the padding rows of dW and
// undoes the first layer's [features | extras | SH] row order.
//
// Cross-sample sums: dW and db are summed per 128-sample tile in shared
// memory into a per-block accumulator and flushed with one atomicAdd per
// element and block (mlp_common.cuh), where the TPU accumulated across its
// sequential grid. d features are per sample: no atomics.
//
// What bounds it on an H100: memory. The function must read features (64 B),
// directions (12 B), hsave (256 B) and dout (12 B) and write d features (64 B)
// per sample at the bench shape, about 0.03 ms at 3.35 TB/s for 262,144
// samples. This first version is latency-bound instead: one block of 128
// threads per SM (~150 KB of shared memory), CUDA-core FMAs for the per-sample
// chain and the tile reductions. Tensor-core tile reductions are the next
// step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only, so the SH polynomials round as the plain PyTorch version does).

#include "mlp_common.cuh"
#include "sh_common.cuh"

namespace insr {

template <int FPAD, int DEG, int W, int NH>
struct ShBwdSmem {
  static constexpr int DIN = FPAD + DEG * DEG;
  static constexpr int ROWS = DIN + NH * W;
  using TS = TileStage<DIN, W>;
  // w_s, stage, dw_acc, db_acc
  static constexpr int FLOATS = ROWS * W + TS::FLOATS + ROWS * W + (NH + 1) * W;
};

template <int FPAD, int DEG, int W, int NH, int D>
__global__ void __launch_bounds__(kBwdTile)
    sh_mlp_bwd_kernel(const float* __restrict__ feat, int n_feat,
                      const float* __restrict__ dirs, long long n,
                      const __nv_bfloat16* __restrict__ hsave,
                      const float* __restrict__ dout,
                      const __nv_bfloat16* __restrict__ ws,
                      float* __restrict__ dws, float* __restrict__ dbs,
                      float* __restrict__ dfeat) {
  using L = ShBwdSmem<FPAD, DEG, W, NH>;
  constexpr int DIN = L::DIN;
  constexpr int ROWS = L::ROWS;
  static_assert(W % 4 == 0 && D <= W, "layout");

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* stage = w_s + ROWS * W;
  float* dw_acc = stage + L::TS::FLOATS;
  float* db_acc = dw_acc + ROWS * W;
  load_bf16_to_shared(ws, ROWS * W, w_s);
  for (int k = threadIdx.x; k < ROWS * W + (NH + 1) * W; k += blockDim.x) {
    dw_acc[k] = 0.0f;
  }
  __syncthreads();

  const long long ntiles = (n + kBwdTile - 1) / kBwdTile;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long idx = tile * kBwdTile + threadIdx.x;
    const bool active = idx < n;
    const long long i = active ? idx : n - 1;  // a valid address for idle lanes

    float x0[DIN];
    const float* fr = feat + i * n_feat;
#pragma unroll
    for (int k = 0; k < FPAD; ++k) x0[k] = k < n_feat ? fr[k] : 0.0f;
    sh_basis<DEG>(dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], x0 + FPAD);

    float g[W];
#pragma unroll
    for (int j = 0; j < W; ++j) g[j] = (active && j < D) ? dout[i * D + j] : 0.0f;
    float dx0[DIN];
    mlp_backward_tile<DIN, W, NH>(w_s, stage, dw_acc, db_acc, x0, hsave, n, i,
                                  active, g, dx0);
    if (active) {
      float* dr = dfeat + i * n_feat;
#pragma unroll
      for (int k = 0; k < FPAD; ++k) {
        if (k < n_feat) dr[k] = dx0[k];
      }
    }
  }

  __syncthreads();
  flush_acc(dw_acc, ROWS * W, dws);
  flush_acc(db_acc, (NH + 1) * W, dbs);
}

template <int FPAD, int DEG, int W, int NH, int D>
int launch_sh_bwd(const float* feat, int n_feat, const float* dirs, long long n,
                  const void* hsave, const float* dout, const void* ws, float* dws,
                  float* dbs, float* dfeat, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ShBwdSmem<FPAD, DEG, W, NH>::FLOATS;
  return launch_tiles(sh_mlp_bwd_kernel<FPAD, DEG, W, NH, D>, n, smem, stream, feat,
                      n_feat, dirs, n, static_cast<const __nv_bfloat16*>(hsave), dout,
                      static_cast<const __nv_bfloat16*>(ws), dws, dbs, dfeat);
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape (the Python wrapper lists the supported ones). dws and
// dbs must be zeroed by the caller (the kernel adds into them); dfeat is
// written in full.
extern "C" int sh_mlp_bwd(const float* feat, int n_feat, int fpad, const float* dirs,
                          long long n, int degree, const void* hsave,
                          const float* dout, const void* ws, float* dws, float* dbs,
                          float* dfeat, int w, int n_hidden, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_feat < 0 || n_feat > fpad) return -1;
#define INSR_SH_BWD_CASE(FPAD_, DEG_, W_, NH_, D_)                             \
  if (fpad == FPAD_ && degree == DEG_ && w == W_ && n_hidden == NH_ &&         \
      d == D_)                                                                 \
    return insr::launch_sh_bwd<FPAD_, DEG_, W_, NH_, D_>(                      \
        feat, n_feat, dirs, n, hsave, dout, ws, dws, dbs, dfeat, st);
  INSR_SH_BWD_CASE(16, 4, 64, 2, 3)  // the bench NeRF radiance head
  INSR_SH_BWD_CASE(16, 4, 32, 2, 3)  // the small test models
  INSR_SH_BWD_CASE(24, 4, 32, 2, 3)  // 16 features + 3 extras
#undef INSR_SH_BWD_CASE
  return -1;
}
