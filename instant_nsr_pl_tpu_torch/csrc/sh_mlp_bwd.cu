// Fused SH-encode -> concat -> bf16 ReLU MLP backward (the NeRF radiance head).
//
// Replaces: instant_nsr_pl_tpu/ops/sh_mlp_pallas.py _sh_mlp_bwd -> _bwd_kernel
// (pallas_call at :252). Gradients of the packed MLP weights and biases and
// of the features; the directions get none, by the op's contract
// (sh_mlp_pallas.py:11-17: they are functions of the rays only).
//
// What it computes, per sample: the MLP input x0 = [features | zero padding to
// FPAD | SH(dirs)] again (SH recomputed in f32 from the raw unit direction, as
// the TPU backward does), then the MLP backward of mma_common.cuh from the
// forward's hsave (NH, W, N) bf16 residual (csrc/sh_mlp_fwd.cu training mode)
// and dout (N, D) f32: dW += bf16(a) x bf16(g), db += g, and the input
// cotangent W @ bf16(g), of which the first n_feat rows are d features (N,
// n_feat) f32. The host (ops/sh_mlp.py) drops the padding rows of dW and
// undoes the first layer's [features | extras | SH] row order.
//
// What bounds it on an H100: memory. The function must read features (64 B),
// directions (12 B), hsave (256 B) and dout (12 B) and write d features (64 B)
// per sample at the bench shape, about 0.03 ms at 3.35 TB/s for 262,144
// samples; its ~33k bf16-operand flops per sample are 0.02 ms of tensor-core
// time.
//
// Design: persistent blocks of 8 warps walk tiles of 64 samples. Every
// product runs on the tensor cores (mma.sync m16n8k16, mma_common.cuh): the
// 3-column output layer is an 8-column dW and a 16-deep G_in product, the
// feature cotangent only the m-tiles that hold features. The packed weights
// stay bf16 in shared memory; the next tile's hsave rows arrive with cp.async
// while this tile's products run; dW and db stay in registers across tiles and
// are summed over blocks by a second pass in block order, so they are the same
// from run to run. About 72 KB of shared memory per block, two blocks (16
// warps) per SM by registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only, so the SH polynomials round as the plain PyTorch version does).

#include "mma_common.cuh"
#include "sh_common.cuh"

namespace insr {

template <int FPAD, int DEG, int W, int NH, int D>
struct ShBwd {
  using S = MlpShape<FPAD + DEG * DEG, W, NH, D>;
  static constexpr int MT0 = (FPAD + 15) / 16;  // layer-0 m-tiles holding features
  static constexpr int LDF = FPAD + 1;          // f32 row stride of the d-feature stage
  // shared memory, in bf16 elements: weights, two hsave stages, x0, dout^T
  static constexpr int WT = S::ROWS * S::LDW;
  static constexpr int H = NH * W * kLdT;
  static constexpr int X0 = S::DINP * kLdT;
  static constexpr int GO = S::DP16 * kLdT;
  static constexpr size_t BYTES = 2 * (WT + 2 * H + X0 + GO) + 4 * kT * LDF;
  static constexpr int COUNT = S::ROWS * W + (NH + 1) * W;  // partial sums per block
  static_assert(4 * (kWarps * NH * W + kThreads * 4) <= 2 * 2 * H, "reduction fits hsave");
};

template <int FPAD, int DEG, int W, int NH, int D>
__global__ void __launch_bounds__(kThreads, 2)
    sh_mlp_bwd_kernel(const float* __restrict__ feat, int n_feat,
                      const float* __restrict__ dirs, long long n,
                      const __nv_bfloat16* __restrict__ hsave,
                      const float* __restrict__ dout,
                      const __nv_bfloat16* __restrict__ ws, float* __restrict__ dfeat,
                      float* __restrict__ part) {
  using K = ShBwd<FPAD, DEG, W, NH, D>;
  using S = typename K::S;
  constexpr int NSH = DEG * DEG;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* hbuf = wt + K::WT;
  __nv_bfloat16* x0 = hbuf + 2 * K::H;
  __nv_bfloat16* gout = x0 + K::X0;
  float* dfs = reinterpret_cast<float*>(gout + K::GO);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  load_weights<W>(wt, ws, S::ROWS);
  fill_shared(x0, K::X0 + K::GO, zero);  // padding rows of x0 and dout^T stay zero

  float dw[S::NFW][4];
  float db[NH][W / 16][2];
  float dbo[(D + 3) / 4];
#pragma unroll
  for (int f = 0; f < S::NFW; ++f) dw[f][0] = dw[f][1] = dw[f][2] = dw[f][3] = 0.0f;
#pragma unroll
  for (int l = 0; l < NH; ++l) {
#pragma unroll
    for (int mt = 0; mt < W / 16; ++mt) db[l][mt][0] = db[l][mt][1] = 0.0f;
  }
#pragma unroll
  for (int jj = 0; jj < (D + 3) / 4; ++jj) dbo[jj] = 0.0f;

  auto same_row = [](int r) { return r; };
  const long long ntiles = (n + kT - 1) / kT;
  if (blockIdx.x < ntiles) load_tile_rows(hbuf, hsave, n, blockIdx.x * kT, NH * W, same_row);
  cp_async_commit();
  int stage = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, stage ^= 1) {
    const long long s0 = tile * kT;
    const long long next = tile + gridDim.x;
    if (next < ntiles) {
      load_tile_rows(hbuf + (stage ^ 1) * K::H, hsave, n, next * kT, NH * W, same_row);
    }
    cp_async_commit();
    {  // this tile's x0 = [features | 0 | SH] and bf16(dout)^T, 4 threads per sample
      const int s = threadIdx.x >> 2, q = threadIdx.x & 3;
      const long long i = s0 + s;
      const bool active = i < n;
      for (int k = q; k < n_feat; k += 4) {
        x0[k * kLdT + s] = __float2bfloat16_rn(active ? feat[i * n_feat + k] : 0.0f);
      }
      float sh[NSH];
      if (active) {
        sh_basis<DEG>(dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], sh);
      } else {
#pragma unroll
        for (int k = 0; k < NSH; ++k) sh[k] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < NSH; ++k) {
        if ((k & 3) == q) x0[(FPAD + k) * kLdT + s] = __float2bfloat16_rn(sh[k]);
      }
#pragma unroll
      for (int jj = 0; jj < (D + 3) / 4; ++jj) {
        const int j = q + 4 * jj;
        if (j < D) {
          const float v = active ? dout[i * D + j] : 0.0f;
          gout[j * kLdT + s] = __float2bfloat16_rn(v);
          dbo[jj] += v;
        }
      }
    }
    cp_async_wait<1>();  // this tile's hsave has landed; the next one may be in flight
    __syncthreads();
    mlp_backward_tile<S, K::MT0>(
        wt, x0, hbuf + stage * K::H, gout, dw, db, [&](int mt, const float(&g)[4]) {
          const int row = mt * 16 + (lane >> 2), col = warp * 8 + (lane & 3) * 2;
          if (row < FPAD) {
            dfs[col * K::LDF + row] = g[0];
            dfs[(col + 1) * K::LDF + row] = g[1];
          }
          if (row + 8 < FPAD) {
            dfs[col * K::LDF + row + 8] = g[2];
            dfs[(col + 1) * K::LDF + row + 8] = g[3];
          }
        });
    __syncthreads();
    // the tile's d-feature rows are contiguous in the (N, n_feat) output
    const int nv = static_cast<int>(n - s0 < kT ? n - s0 : kT);
    for (int q = threadIdx.x; q < nv * n_feat; q += kThreads) {
      dfeat[s0 * n_feat + q] = dfs[(q / n_feat) * K::LDF + q % n_feat];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store_mlp_partials<S>(part + static_cast<long long>(blockIdx.x) * K::COUNT,
                        reinterpret_cast<float*>(hbuf), dw, db, dbo);
}

template <int FPAD, int DEG, int W, int NH, int D>
int sh_bwd(const float* feat, int n_feat, const float* dirs, long long n, const void* hsave,
           const float* dout, const void* ws, float* dfeat, float* part, int part_blocks,
           float* out, int* info, cudaStream_t stream) {
  using K = ShBwd<FPAD, DEG, W, NH, D>;
  auto kernel = sh_mlp_bwd_kernel<FPAD, DEG, W, NH, D>;
  int rc = plan_persistent(reinterpret_cast<const void*>(kernel), K::BYTES, n, info);
  info[3] = K::COUNT;
  if (rc != 0 || part == nullptr) return rc;  // a plan query
  if (n <= 0 || info[0] > part_blocks) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<info[0], kThreads, K::BYTES, stream>>>(
      feat, n_feat, dirs, n, static_cast<const __nv_bfloat16*>(hsave), dout,
      static_cast<const __nv_bfloat16*>(ws), dfeat, part);
  sum_partials<<<(K::COUNT + kSumCols - 1) / kSumCols, 256, 0, stream>>>(part, info[0],
                                                                        K::COUNT, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// With part == nullptr: a plan query, filling info = {grid, blocks per SM,
// shared-memory bytes per block, partial sums per block}; the caller then
// allocates part (grid x partial sums, f32) and out (partial sums, f32) and
// calls again. out receives dW (rows, W) then db (NH + 1, W) f32; dfeat (N,
// n_feat) f32 is written in full. Returns cudaGetLastError() after the
// launches, or -1 when no instantiation matches the shape (the Python wrapper
// lists the supported ones).
extern "C" int sh_mlp_bwd(const float* feat, int n_feat, int fpad, const float* dirs,
                          long long n, int degree, const void* hsave, const float* dout,
                          const void* ws, float* dfeat, float* part, int part_blocks,
                          float* out, int* info, int w, int n_hidden, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_feat < 0 || n_feat > fpad) return -1;
#define INSR_SH_BWD_CASE(FPAD_, DEG_, W_, NH_, D_)                             \
  if (fpad == FPAD_ && degree == DEG_ && w == W_ && n_hidden == NH_ &&         \
      d == D_)                                                                 \
    return insr::sh_bwd<FPAD_, DEG_, W_, NH_, D_>(feat, n_feat, dirs, n, hsave, dout, ws, \
                                                  dfeat, part, part_blocks, out, info, st);
  INSR_SH_BWD_CASE(16, 4, 64, 2, 3)  // the bench NeRF radiance head
  INSR_SH_BWD_CASE(16, 4, 32, 2, 3)  // the small test models
  INSR_SH_BWD_CASE(24, 4, 32, 2, 3)  // 16 features + 3 extras
#undef INSR_SH_BWD_CASE
  return -1;
}
