// Fused CP-encode -> basis -> bf16 ReLU MLP backward (the NeRF density head).
//
// Replaces: instant_nsr_pl_tpu/ops/cp_mlp_pallas.py _cp_mlp_bwd -> _bwd_kernel
// (pallas_call at :353). Gradients of the line tables, the bases and the
// packed MLP weights and biases; no position cotangent, by the op's contract
// (cp_mlp_pallas.py:24-30: the density inputs are march outputs, never
// functions of parameters).
//
// What it computes, from the forward's residuals (csrc/cp_mlp_fwd.cu training
// mode: vsave (3, S*C, N) bf16, hsave (NH, W, N) bf16) and dout (N, D) f32,
// at the TPU kernel's rounding points:
//   prod_s = (v_x * v_y) * v_z from the bf16 v          (f32)
//   enc = B @ bf16(prod)                                 (f32, recomputed)
//   the MLP backward of mlp_common.cuh -> dW, db, d_enc  (f32)
//   dbasis_s[c][j] += bf16(prod_s[c]) * bf16(d_enc[s*F + j])
//   d_prod_s[c] = sum_j B_s[c][j] * bf16(d_enc[s*F + j])
//   d_v_a = d_prod * (product of the other two axes' v)
//   dL_{s,a}[i0][c] += w0 * bf16(d_v_a),  dL_{s,a}[i0 + 1][c] += w1 * bf16(d_v_a)
// with i0, w0, w1 the forward's tent coordinates of x (cp_common.cuh). Every product is of two
// bf16 values, so exact in f32, and sums are f32, as on the TPU; only their
// order differs. The TPU computes the line-table scatter as a dense
// bf16(d_v) x tent^T matmul; the tent has two non-zeros per sample, so the
// scatter of the two weighted rows is the same sum.
//
// Cross-sample sums: the TPU kernel accumulates every parameter gradient in
// VMEM across its sequential grid. Here blocks run in no order. dW, db and
// dbasis are summed per 128-sample tile with shared-memory reductions into a
// per-block f32 accumulator (mlp_common.cuh), flushed with one atomicAdd per
// element and block. The line-table gradient is a scatter into rows chosen by
// the data: each sample adds its two weighted rows per scale and axis straight
// to the (3, R_s, C) f32 output with 16-byte vector atomics (C/4 per row).
// Atomics make the summation order change from run to run: results agree
// with the plain version to f32 rounding of the sums, not to the bit.
//
// What bounds it on an H100: memory. The function must read x (12 B), the
// residuals (768 + 128 B at the bench shape) and dout (64 B) per sample, about
// 0.08 ms at 3.35 TB/s for 262,144 samples, and does ~40k bf16-operand flops
// per sample. This first version is latency-bound instead: one block of 128
// threads per SM (~130 KB of shared memory each), CUDA-core FMAs for the tile
// reductions and up to 5 x 10^7 vector atomics for the line tables (192 per
// sample). At bench.py --encoding cp_big (C = 128, three scales) the dbasis
// tile is staged and reduced 64 components at a time (a stage row holds
// max(E, W) + 1 floats) and a block takes 174 KB. Tensor-core tile reductions (the dW and dbasis sums are bf16 x bf16
// -> f32 products, the mma.sync contract) and a shared-memory pre-reduction of
// the coarse tables are the next steps.
//
// Stacked scales (K14): the same kernel, instantiated with STACKED = true,
// replaces cp_mlp_pallas.py _cp_mlp_stacked_bwd -> _bwd_kernel_stacked
// (pallas_call at :603). The line-table gradient goes to the one (3, R_max,
// S*C) f32 fine table: one tent per axis at R_max, and each sample adds its two
// S*C-wide rows per axis (the TPU's dense bf16(d_v) x tent^T product over the
// stacked components). d basis stays the (S, C, F) diagonal blocks of the TPU's
// (E, S*C) block-diagonal gradient. ops/cp_stacked.py maps the fine gradient
// back to each coarse scale (d coarse = U^T d fine, outside the kernel, as the
// JAX package does). For the coarse scale this replaces K2's 128-row table,
// on which every sample's atomics land, with the 2049-row fine grid.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only).

#include "cp_common.cuh"

namespace insr {

constexpr int kMaxGradScales = 4;

// Per scale: the gradient table's row 0 at the scale's component 0, and the
// resolution; per-scale tables are (3, R_s, C) f32, STACKED ones a single
// (3, R_max, S*C) f32 table with ptr[s] at its column s*C.
struct GradTables {
  float* ptr[kMaxGradScales];
  int res[kMaxGradScales];
};

template <int C, int F, int S, int W, int NH, int D>
struct CpBwdSmem {
  static constexpr int E = S * F;
  static constexpr int ROWS = E + NH * W;
  using TS = TileStage<E, W>;
  // w_s, basis_s, stage, dw_acc, db_acc, dbasis_acc
  static constexpr int FLOATS =
      ROWS * W + S * C * F + TS::FLOATS + ROWS * W + (NH + 1) * W + S * C * F;
};

template <int C, int F, int S, int W, int NH, int D, bool STACKED>
__global__ void __launch_bounds__(kBwdTile)
    cp_mlp_bwd_kernel(const float* __restrict__ x, long long n,
                      const __nv_bfloat16* __restrict__ vsave,
                      const __nv_bfloat16* __restrict__ hsave,
                      const float* __restrict__ dout,
                      const __nv_bfloat16* __restrict__ basis,
                      const __nv_bfloat16* __restrict__ ws, GradTables dlines,
                      float* __restrict__ dbasis, float* __restrict__ dws,
                      float* __restrict__ dbs) {
  using L = CpBwdSmem<C, F, S, W, NH, D>;
  constexpr int E = L::E;
  constexpr int ROWS = L::ROWS;
  using TS = typename L::TS;
  constexpr int LD = STACKED ? S * C : C;  // row stride of a gradient table
  // dbasis is reduced over component tiles of CT rows: one tile holds C < LDA
  // components (C = 64 at W = 64), C = 128 (cp_big) takes two
  constexpr int CT = C < TS::LDA ? C : 64;
  static_assert(C % 4 == 0 && F % 4 == 0 && W % 4 == 0 && D <= W, "layout");
  static_assert(C % CT == 0 && CT < TS::LDA && F < TS::LDG, "the dbasis tile fits the stage");

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* basis_s = w_s + ROWS * W;  // (S, C, F)
  float* stage = basis_s + S * C * F;
  float* dw_acc = stage + TS::FLOATS;
  float* db_acc = dw_acc + ROWS * W;
  float* dbasis_acc = db_acc + (NH + 1) * W;
  load_bf16_to_shared(ws, ROWS * W, w_s);
  load_bf16_to_shared(basis, S * C * F, basis_s);
  for (int k = threadIdx.x; k < ROWS * W + (NH + 1) * W + S * C * F; k += blockDim.x) {
    dw_acc[k] = 0.0f;
  }
  __syncthreads();

  float* arow = stage + threadIdx.x * TS::LDA;
  float* grow = stage + kBwdTile * TS::LDA + threadIdx.x * TS::LDG;
  const long long ntiles = (n + kBwdTile - 1) / kBwdTile;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long idx = tile * kBwdTile + threadIdx.x;
    const bool active = idx < n;
    const long long i = active ? idx : n - 1;  // a valid address for idle lanes

    // the saved interpolations: prod_s[c] = bf16((v_x * v_y) * v_z)
    auto prod_at = [&](int s, int c) {
      const float vx = __bfloat162float(vsave[(static_cast<long long>(0 * S + s) * C + c) * n + i]);
      const float vy = __bfloat162float(vsave[(static_cast<long long>(1 * S + s) * C + c) * n + i]);
      const float vz = __bfloat162float(vsave[(static_cast<long long>(2 * S + s) * C + c) * n + i]);
      return bf16_round((vx * vy) * vz);
    };

    // enc = B @ bf16(prod), recomputed from the residuals
    float enc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) enc[e] = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float prod = prod_at(s, c);
        const float4* brow = reinterpret_cast<const float4*>(basis_s + (s * C + c) * F);
#pragma unroll
        for (int j4 = 0; j4 < F / 4; ++j4) {
          const float4 bv = brow[j4];
          float* e4 = enc + s * F + 4 * j4;
          e4[0] = fmaf(bv.x, prod, e4[0]);
          e4[1] = fmaf(bv.y, prod, e4[1]);
          e4[2] = fmaf(bv.z, prod, e4[2]);
          e4[3] = fmaf(bv.w, prod, e4[3]);
        }
      }
    }

    // the MLP chain: dW, db and d enc
    float g[W];
#pragma unroll
    for (int j = 0; j < W; ++j) g[j] = (active && j < D) ? dout[i * D + j] : 0.0f;
    float d_enc[E];
    mlp_backward_tile<E, W, NH>(w_s, stage, dw_acc, db_acc, enc, hsave, n, i,
                                active, g, d_enc);
#pragma unroll
    for (int e = 0; e < E; ++e) d_enc[e] = bf16_round(d_enc[e]);

    // dbasis_s += bf16(prod_s)^T bf16(d_enc_s) over the tile, CT components
    // at a time
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll 1
      for (int c0 = 0; c0 < C; c0 += CT) {
        __syncthreads();  // the previous reduction has finished reading
#pragma unroll 4
        for (int c = 0; c < CT; ++c) arow[c] = active ? prod_at(s, c0 + c) : 0.0f;
#pragma unroll
        for (int j = 0; j < F; ++j) grow[j] = d_enc[s * F + j];
        __syncthreads();
        reduce_tile<CT, F, TS::LDA, TS::LDG>(stage, stage + kBwdTile * TS::LDA,
                                             dbasis_acc + (s * C + c0) * F, nullptr);
      }
    }

    // line tables: scatter the two tent-weighted rows per scale and axis
    if (active) {
      const float u[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
      Tent t[3];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = dlines.res[s];
        // stacked scales share the fine grid: one tent per axis for all of them
        if (!STACKED || s == 0) {
#pragma unroll
          for (int a = 0; a < 3; ++a) t[a] = tent(u[a], r);
        }
        float* row0[3];
        float w0[3], w1[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          w0[a] = t[a].w0;
          w1[a] = t[a].w1;
          row0[a] = dlines.ptr[s] + (static_cast<long long>(a) * r + t[a].i0) * LD;
        }
#pragma unroll 2
        for (int c4 = 0; c4 < C / 4; ++c4) {
          float dv[3][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = 4 * c4 + q;
            const float4* brow = reinterpret_cast<const float4*>(basis_s + (s * C + c) * F);
            float dp = 0.0f;
#pragma unroll
            for (int j4 = 0; j4 < F / 4; ++j4) {
              const float4 bv = brow[j4];
              const float* de = d_enc + s * F + 4 * j4;
              dp = fmaf(bv.x, de[0], dp);
              dp = fmaf(bv.y, de[1], dp);
              dp = fmaf(bv.z, de[2], dp);
              dp = fmaf(bv.w, de[3], dp);
            }
            float v[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              v[a] = __bfloat162float(vsave[(static_cast<long long>(a * S + s) * C + c) * n + i]);
            }
            dv[0][q] = bf16_round(dp * (v[1] * v[2]));
            dv[1][q] = bf16_round(dp * (v[0] * v[2]));
            dv[2][q] = bf16_round(dp * (v[0] * v[1]));
          }
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            float* dst = row0[a] + 4 * c4;
            if (w0[a] != 0.0f) {
              atomic_add4(dst, w0[a] * dv[a][0], w0[a] * dv[a][1], w0[a] * dv[a][2],
                          w0[a] * dv[a][3]);
            }
            if (w1[a] != 0.0f) {
              atomic_add4(dst + LD, w1[a] * dv[a][0], w1[a] * dv[a][1], w1[a] * dv[a][2],
                          w1[a] * dv[a][3]);
            }
          }
        }
      }
    }
  }

  __syncthreads();
  flush_acc(dw_acc, ROWS * W, dws);
  flush_acc(db_acc, (NH + 1) * W, dbs);
  flush_acc(dbasis_acc, S * C * F, dbasis);
}

template <int C, int F, int S, int W, int NH, int D, bool STACKED>
int launch_cp_bwd(const float* x, long long n, const void* vsave, const void* hsave,
                  const float* dout, const void* basis, const void* ws,
                  const GradTables& dlines, float* dbasis, float* dws, float* dbs,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * CpBwdSmem<C, F, S, W, NH, D>::FLOATS;
  return launch_tiles(cp_mlp_bwd_kernel<C, F, S, W, NH, D, STACKED>, n, smem, stream, x, n,
                      static_cast<const __nv_bfloat16*>(vsave),
                      static_cast<const __nv_bfloat16*>(hsave), dout,
                      static_cast<const __nv_bfloat16*>(basis),
                      static_cast<const __nv_bfloat16*>(ws), dlines, dbasis, dws, dbs);
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape (the Python wrapper lists the supported ones). The
// gradient outputs (dline tables, dbasis, dws, dbs) must be zeroed by the
// caller: the kernel adds into them.
extern "C" int cp_mlp_bwd(const float* x, long long n, const void* vsave,
                          const void* hsave, const float* dout, const void* basis,
                          const void* ws, void* const* dline_ptrs, const int* res,
                          int n_scales, float* dbasis, float* dws, float* dbs, int c,
                          int f, int w, int n_hidden, int d, void* stream) {
  insr::GradTables dlines{};
  if (n_scales < 1 || n_scales > insr::kMaxGradScales) return -1;
  for (int s = 0; s < n_scales; ++s) {
    dlines.ptr[s] = static_cast<float*>(dline_ptrs[s]);
    dlines.res[s] = res[s];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_CP_BWD_CASE(C_, F_, S_, W_, NH_, D_)                              \
  if (c == C_ && f == F_ && n_scales == S_ && w == W_ && n_hidden == NH_ &&    \
      d == D_)                                                                 \
    return insr::launch_cp_bwd<C_, F_, S_, W_, NH_, D_, false>(                \
        x, n, vsave, hsave, dout, basis, ws, dlines, dbasis, dws, dbs, st);
  INSR_CP_BWD_CASE(64, 16, 2, 64, 1, 16)   // the bench NeRF density head
  INSR_CP_BWD_CASE(128, 16, 3, 64, 1, 16)  // the same head on bench.py --encoding cp_big
  INSR_CP_BWD_CASE(16, 8, 2, 32, 1, 16)   // the small test model
  INSR_CP_BWD_CASE(16, 8, 2, 32, 2, 16)
#undef INSR_CP_BWD_CASE
  return -1;
}

// K14, the stacked-scales backward: `dlines` is the (3, R_max, S*C) f32 fine
// gradient table (zeroed by the caller), r = R_max; otherwise as cp_mlp_bwd.
extern "C" int cp_mlp_stacked_bwd(const float* x, long long n, const void* vsave,
                                  const void* hsave, const float* dout, const void* basis,
                                  const void* ws, float* dlines, int r, int n_scales,
                                  float* dbasis, float* dws, float* dbs, int c, int f,
                                  int w, int n_hidden, int d, void* stream) {
  insr::GradTables tables{};
  if (n_scales < 1 || n_scales > insr::kMaxGradScales || r < 2) return -1;
  for (int s = 0; s < n_scales; ++s) {
    tables.ptr[s] = dlines + s * c;
    tables.res[s] = r;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_CPS_BWD_CASE(C_, F_, S_, W_, NH_, D_)                             \
  if (c == C_ && f == F_ && n_scales == S_ && w == W_ && n_hidden == NH_ &&    \
      d == D_)                                                                 \
    return insr::launch_cp_bwd<C_, F_, S_, W_, NH_, D_, true>(                 \
        x, n, vsave, hsave, dout, basis, ws, tables, dbasis, dws, dbs, st);
  INSR_CPS_BWD_CASE(64, 16, 2, 64, 1, 16)  // the bench NeRF density head, cp_stacked
  INSR_CPS_BWD_CASE(16, 8, 2, 32, 1, 16)   // the small test model
  INSR_CPS_BWD_CASE(16, 8, 2, 32, 2, 16)
#undef INSR_CPS_BWD_CASE
  return -1;
}
