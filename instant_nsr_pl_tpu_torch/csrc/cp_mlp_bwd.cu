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
//   prod_s = (v_x * v_y) * v_z from the bf16 v          (f32, CUDA cores)
//   enc_s = bf16(prod_s) B_s                             (f32, recomputed)
//   the MLP backward of mma_common.cuh -> dW, db, d_enc  (f32)
//   dbasis_s += bf16(prod_s)^T bf16(d_enc_s)
//   d_prod_s = bf16(d_enc_s) B_s^T
//   d_v_a = bf16(d_prod * (product of the other two axes' v))   (CUDA cores)
//   dL_{s,a}[i0] += w0 * d_v_a,  dL_{s,a}[i0 + 1] += w1 * d_v_a
// with i0, w0, w1 the forward's tent coordinates of x (cp_common.cuh; a zero
// weight adds nothing). The TPU computes the line-table scatter as a dense
// bf16(d_v) x tent^T matmul; the tent has two non-zeros per sample, so the
// scatter of the two weighted rows is the same sum.
//
// What bounds it on an H100: memory. The function must read x (12 B), the
// residuals (768 + 128 B at the bench shape) and dout (64 B) per sample and
// write the line-table gradients, about 0.08 ms at 3.35 TB/s for 262,144
// samples; its ~40k bf16-operand flops per sample are 0.02 ms of tensor-core
// time.
//
// Design: persistent blocks of 8 warps walk tiles of 64 samples. Every
// product (enc, the MLP chain, dbasis, d_prod) runs on the tensor cores
// (mma.sync m16n8k16, mma_common.cuh) from bf16 tiles in shared memory:
// pass 1 rebuilds bf16(prod_s) and enc scale by scale, the MLP backward gives
// d_enc, pass 2 rebuilds bf16(prod_s) and takes dbasis_s and d_prod_s. The
// vsave rows of one scale arrive per step with cp.async, double-buffered
// across the 2S steps of a tile and on into the next tile's, so each load
// overlaps the previous step's products; with two scales (the bench heads)
// pass 2 finds them still staged and vsave is read once. dW, db and dbasis
// stay in registers across tiles and are summed over blocks by a second pass
// in block order: the same from run to run. The line-table gradient is
// staged as bf16 d_v rows [axis][sample][component] and scattered row-wise: a
// group of C/4 lanes adds one C-float row with 16-byte atomics (a warp
// instruction covers two rows at C = 64, one at C = 128, where a thread per
// sample would touch 32). Each group walks a run of the tile's samples of one
// axis in order with a window of two rows, so contributions to the same row (a
// ray's neighbouring samples, above all on the coarse table) are summed before
// they go to L2; on ray-ordered samples this beats a scatter of every sample
// in parallel (tools/bwd_bench.py --cuts). Any order of samples gives the same
// sums to f32 rounding; the atomics make the line tables' summation order
// change from run to run.
//
// Stacked scales (K14): the same kernel, instantiated with STACKED = true,
// replaces cp_mlp_pallas.py _cp_mlp_stacked_bwd -> _bwd_kernel_stacked
// (pallas_call at :603). The line-table gradient goes to the one (3, R_max,
// S*C) f32 fine table: one tent per axis at R_max, each scale's C-wide part of
// the S*C-wide rows (the TPU's dense bf16(d_v) x tent^T product over the
// stacked components). d basis stays the (S, C, F) diagonal blocks of the TPU's
// (E, S*C) block-diagonal gradient. ops/cp_stacked.py maps the fine gradient
// back to each coarse scale (d coarse = U^T d fine, outside the kernel, as the
// JAX package does).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only).

#include "cp_common.cuh"
#include "mma_common.cuh"

namespace insr {

constexpr int kMaxGradScales = 4;

// Per scale: the gradient table's row 0 at the scale's component 0, and the
// resolution; per-scale tables are (3, R_s, C) f32, STACKED ones a single
// (3, R_max, S*C) f32 table with ptr[s] at its column s*C.
struct GradTables {
  float* ptr[kMaxGradScales];
  int res[kMaxGradScales];
};

template <int C, int F, int NS, int W, int NH, int D>
struct CpBwd {
  static constexpr int E = NS * F;
  using S = MlpShape<E, W, NH, D>;
  static constexpr int FP = 16;        // rows of one scale's d_enc^T (F padded to 16)
  static constexpr int LDB = 24;       // row stride of the basis (F padded to 16, + 8)
  static constexpr int LDC = C + 8;    // row stride of the d_v stage [axis][sample][c]
  // shared memory, in bf16 elements
  static constexpr int WT = S::ROWS * S::LDW;
  static constexpr int BS = NS * C * LDB;
  static constexpr int H = NH * W * kLdT;
  static constexpr int V = (3 * C * kLdT > 3 * kT * LDC ? 3 * C * kLdT : 3 * kT * LDC);
  static constexpr int P = C * kLdT;
  static constexpr int X0 = S::DINP * kLdT;
  static constexpr int GO = S::DP16 * kLdT;
  static constexpr int DE = NS * FP * kLdT;
  static constexpr size_t BYTES =
      2 * (WT + BS + H + 2 * V + P + X0 + GO + DE) + 4 * (3 * 3 * kT + 3 * kT);
  static constexpr int MINB = BYTES <= 113 * 1024 ? 2 : 1;  // blocks per SM the registers allow
  // the line-gradient scatter: groups of C/4 lanes, each walking runs of SEG
  // samples (3 * kT / SEG runs per scale and tile: 12 for the 16 groups at
  // C = 64, 6 for the 8 at C = 128)
  static constexpr int GL = C / 4;
  static constexpr int NG = kThreads / GL;
  static constexpr int SEG = GL < 8 ? 8 : GL;
  // dbasis fragments: (C/16) x (F/8) per scale, numbered across scales
  static constexpr int NBF = NS * (C / 16) * (F / 8);
  static constexpr int NBW = (NBF + kWarps - 1) / kWarps;
  static constexpr int COUNT = S::ROWS * W + (NH + 1) * W + NS * C * F;
  static_assert(C % 16 == 0 && F % 8 == 0 && F <= 16 && GL <= 32 && 32 % GL == 0, "layout");
  static_assert(4 * (kWarps * NH * W + kThreads * 4) <= 2 * V, "reduction fits the v stage");
};

template <int C, int F, int NS, int W, int NH, int D, bool STACKED>
__global__ void __launch_bounds__(kThreads, (CpBwd<C, F, NS, W, NH, D>::MINB))
    cp_mlp_bwd_kernel(const float* __restrict__ x, long long n,
                      const __nv_bfloat16* __restrict__ vsave,
                      const __nv_bfloat16* __restrict__ hsave,
                      const float* __restrict__ dout,
                      const __nv_bfloat16* __restrict__ basis,
                      const __nv_bfloat16* __restrict__ ws, GradTables dlines,
                      float* __restrict__ part) {
  using K = CpBwd<C, F, NS, W, NH, D>;
  using S = typename K::S;
  constexpr int LD = STACKED ? NS * C : C;  // row stride of a gradient table
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* bs = wt + K::WT;
  __nv_bfloat16* hb = bs + K::BS;
  __nv_bfloat16* vbuf = hb + K::H;
  __nv_bfloat16* pb = vbuf + 2 * K::V;
  __nv_bfloat16* x0 = pb + K::P;
  __nv_bfloat16* gout = x0 + K::X0;
  __nv_bfloat16* de = gout + K::GO;
  float* tw0 = reinterpret_cast<float*>(de + K::DE);  // [axis][sample] tent weights
  float* tw1 = tw0 + 3 * kT;
  int* ti0 = reinterpret_cast<int*>(tw1 + 3 * kT);    // [axis][sample] first row
  float* xs = reinterpret_cast<float*>(ti0 + 3 * kT); // [sample][3]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_in = lane >> 2, c_in = (lane & 3) * 2;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  load_weights<W>(wt, ws, S::ROWS);
  for (int q = threadIdx.x; q < K::BS; q += kThreads) {
    const int row = q / K::LDB, col = q % K::LDB;
    bs[q] = col < F ? basis[row * F + col] : zero;
  }
  fill_shared(x0, K::X0 + K::GO + K::DE, zero);  // padding rows stay zero

  float dw[S::NFW][4];
  float db[NH][W / 16][2];
  float dbo[(D + 3) / 4];
  float dba[K::NBW][4];
#pragma unroll
  for (int f = 0; f < S::NFW; ++f) dw[f][0] = dw[f][1] = dw[f][2] = dw[f][3] = 0.0f;
#pragma unroll
  for (int f = 0; f < K::NBW; ++f) dba[f][0] = dba[f][1] = dba[f][2] = dba[f][3] = 0.0f;
#pragma unroll
  for (int l = 0; l < NH; ++l) {
#pragma unroll
    for (int mt = 0; mt < W / 16; ++mt) db[l][mt][0] = db[l][mt][1] = 0.0f;
  }
#pragma unroll
  for (int jj = 0; jj < (D + 3) / 4; ++jj) dbo[jj] = 0.0f;

  const long long ntiles = (n + kT - 1) / kT;
  // step k of a tile (0 <= k < 2 NS) works on scale k % NS of pass k / NS from
  // v stage k & 1; its vsave rows (and, at step 0, the tile's hsave) are
  // loaded one step ahead. With two scales, stage s still holds scale s's
  // rows when pass 2 comes to it: only pass 1 loads.
  constexpr bool kReuse = NS == 2;
  auto issue = [&](long long tl, int k) {
    if (tl < ntiles && !(kReuse && k >= NS)) {
      const int s = k % NS;
      load_tile_rows(vbuf + (k & 1) * K::V, vsave, n, tl * kT, 3 * C,
                     [s](int r) { return ((r / C) * NS + s) * C + r % C; });
      if (k == 0) load_tile_rows(hb, hsave, n, tl * kT, NH * W, [](int r) { return r; });
    }
    cp_async_commit();
  };
  issue(blockIdx.x, 0);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long s0 = tile * kT;
    const int nv = static_cast<int>(n - s0 < kT ? n - s0 : kT);
    static_for<0, 2 * NS>([&](auto kc) {
      constexpr int k = decltype(kc)::value;
      constexpr int s = k % NS;
      issue(k + 1 < 2 * NS ? tile : tile + gridDim.x, (k + 1) % (2 * NS));
      if constexpr (k == 0) {  // positions and bf16(dout)^T of this tile
        for (int q = threadIdx.x; q < 3 * kT; q += kThreads) {
          xs[q] = q < 3 * nv ? x[3 * s0 + q] : 0.0f;
        }
        const int t = threadIdx.x >> 2, qd = threadIdx.x & 3;
#pragma unroll
        for (int jj = 0; jj < (D + 3) / 4; ++jj) {
          const int j = qd + 4 * jj;
          if (j < D) {
            const float v = t < nv ? dout[(s0 + t) * D + j] : 0.0f;
            gout[j * kLdT + t] = __float2bfloat16_rn(v);
            dbo[jj] += v;
          }
        }
      }
      cp_async_wait<1>();  // this step's rows have landed; the next step's may be in flight
      __syncthreads();
      const __nv_bfloat16* vb = vbuf + (k & 1) * K::V;
      // bf16(prod_s) = bf16((v_x * v_y) * v_z), [component][sample]
      for (int q = threadIdx.x; q < C * kT / 2; q += kThreads) {
        const int c = q / (kT / 2), t = 2 * (q % (kT / 2));
        const uint32_t vx = *reinterpret_cast<const uint32_t*>(vb + (0 * C + c) * kLdT + t);
        const uint32_t vy = *reinterpret_cast<const uint32_t*>(vb + (1 * C + c) * kLdT + t);
        const uint32_t vz = *reinterpret_cast<const uint32_t*>(vb + (2 * C + c) * kLdT + t);
        *reinterpret_cast<uint32_t*>(pb + c * kLdT + t) =
            pack_bf16x2((bf16x2_lo(vx) * bf16x2_lo(vy)) * bf16x2_lo(vz),
                        (bf16x2_hi(vx) * bf16x2_hi(vy)) * bf16x2_hi(vz));
      }
      if constexpr (k >= NS) {  // pass 2: this scale's tent coordinates
        const int r = dlines.res[s];
        for (int q = threadIdx.x; q < 3 * kT; q += kThreads) {
          const int a = q / kT, t = q % kT;
          const Tent tt = tent(xs[3 * t + a], r);
          ti0[q] = tt.i0;
          tw0[q] = t < nv ? tt.w0 : 0.0f;
          tw1[q] = t < nv ? tt.w1 : 0.0f;
        }
      }
      __syncthreads();
      if constexpr (k < NS) {
        // pass 1: enc_s^T = B_s^T bf16(prod_s)^T, rows s*F.. of x0
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k0 = 0; k0 < C; k0 += 16) {
          uint32_t af[4], bf[2];
          load_a_t(af, bs + s * C * K::LDB, K::LDB, k0, 0, lane);
          load_b_t(bf, pb, kLdT, k0, warp * 8, lane);
          mma_bf16(acc, af, bf);
        }
        const int t = warp * 8 + c_in;
        if (r_in < F) {
          *reinterpret_cast<uint32_t*>(x0 + (s * F + r_in) * kLdT + t) =
              pack_bf16x2(acc[0], acc[1]);
        }
        if (r_in + 8 < F) {
          *reinterpret_cast<uint32_t*>(x0 + (s * F + r_in + 8) * kLdT + t) =
              pack_bf16x2(acc[2], acc[3]);
        }
        if constexpr (k == NS - 1) {
          __syncthreads();  // enc of every scale is staged
          // the MLP backward; layer 0's cotangent is bf16(d_enc)^T, per-scale rows of de
          mlp_backward_tile<S, K::E / 16>(
              wt, x0, hb, gout, dw, db, [&](int mt, const float(&g)[4]) {
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const int e = mt * 16 + r_in + 8 * half;
                  *reinterpret_cast<uint32_t*>(de + ((e / F) * K::FP + e % F) * kLdT + t) =
                      pack_bf16x2(g[2 * half], g[2 * half + 1]);
                }
              });
        }
      } else {
        const __nv_bfloat16* des = de + s * K::FP * kLdT;
        // dbasis_s += bf16(prod_s) bf16(d_enc_s), this warp's fragments
#pragma unroll
        for (int q = 0; q < (C / 16) * (F / 8); ++q) {
          constexpr int kOff = s * (C / 16) * (F / 8);
          if ((kOff + q) % kWarps != warp) continue;
          const int m0 = (q / (F / 8)) * 16, n0 = (q % (F / 8)) * 8;
#pragma unroll
          for (int k0 = 0; k0 < kT; k0 += 16) {
            uint32_t af[4], bf[2];
            load_a(af, pb, kLdT, m0, k0, lane);
            load_b(bf, des, kLdT, n0, k0, lane);
            mma_bf16(dba[(kOff + q) / kWarps], af, bf);
          }
        }
        // d_prod_s^T = B_s bf16(d_enc_s)^T for this warp's 8 samples, then
        // d_v for the three axes, as bf16 pairs of neighbouring samples
        uint32_t dv[C / 16][2][3];
        {
          uint32_t bf[2];
          load_b_t(bf, des, kLdT, 0, warp * 8, lane);
#pragma unroll
          for (int mt = 0; mt < C / 16; ++mt) {
            float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            uint32_t af[4];
            load_a(af, bs + s * C * K::LDB, K::LDB, mt * 16, 0, lane);
            mma_bf16(dp, af, bf);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int c = mt * 16 + r_in + 8 * half, t = warp * 8 + c_in;
              const uint32_t vx = *reinterpret_cast<const uint32_t*>(vb + (0 * C + c) * kLdT + t);
              const uint32_t vy = *reinterpret_cast<const uint32_t*>(vb + (1 * C + c) * kLdT + t);
              const uint32_t vz = *reinterpret_cast<const uint32_t*>(vb + (2 * C + c) * kLdT + t);
              const float p0 = dp[2 * half], p1 = dp[2 * half + 1];
              dv[mt][half][0] = pack_bf16x2(p0 * (bf16x2_lo(vy) * bf16x2_lo(vz)),
                                            p1 * (bf16x2_hi(vy) * bf16x2_hi(vz)));
              dv[mt][half][1] = pack_bf16x2(p0 * (bf16x2_lo(vx) * bf16x2_lo(vz)),
                                            p1 * (bf16x2_hi(vx) * bf16x2_hi(vz)));
              dv[mt][half][2] = pack_bf16x2(p0 * (bf16x2_lo(vx) * bf16x2_lo(vy)),
                                            p1 * (bf16x2_hi(vx) * bf16x2_hi(vy)));
            }
          }
        }
        __syncthreads();  // every warp has read this stage's v and prod
        // stage d_v over the v rows as [axis][sample][component]
        __nv_bfloat16* dvs = vbuf + (k & 1) * K::V;
#pragma unroll
        for (int mt = 0; mt < C / 16; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = mt * 16 + r_in + 8 * half, t = warp * 8 + c_in;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const uint32_t p = dv[mt][half][a];
              dvs[(a * kT + t) * K::LDC + c] = __ushort_as_bfloat16(static_cast<unsigned short>(p));
              dvs[(a * kT + t + 1) * K::LDC + c] =
                  __ushort_as_bfloat16(static_cast<unsigned short>(p >> 16));
            }
          }
        }
        __syncthreads();
        // the scatter: group g walks run u of SEG samples of one axis in
        // order, one 16-byte column slice per lane, with a window of two rows:
        // contributions to the same row (a ray's neighbouring samples, above
        // all on the coarse table) are summed before they go to L2
        const int grp = threadIdx.x / K::GL, ql = threadIdx.x % K::GL;
        const int res = dlines.res[s];
        for (int u = grp; u < 3 * (kT / K::SEG); u += K::NG) {
          const int a = u / (kT / K::SEG);
          const int t_begin = (u % (kT / K::SEG)) * K::SEG;
          const int t_end = t_begin + K::SEG < nv ? t_begin + K::SEG : nv;
          float* tab = dlines.ptr[s] + static_cast<long long>(a) * res * LD + 4 * ql;
          int row = -2;
          bool h0 = false, h1 = false;
          float a0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int t = t_begin; t < t_end; ++t) {
            const int i0 = ti0[a * kT + t];
            const float w0 = tw0[a * kT + t], w1 = tw1[a * kT + t];
            const uint2 raw = *reinterpret_cast<const uint2*>(dvs + (a * kT + t) * K::LDC + 4 * ql);
            const float d[4] = {bf16x2_lo(raw.x), bf16x2_hi(raw.x), bf16x2_lo(raw.y),
                                bf16x2_hi(raw.y)};
            if (i0 != row) {
              if (i0 == row + 1) {  // row leaves the window, row + 1 becomes its first row
                if (h0) atomic_add4(tab + static_cast<long long>(row) * LD, a0[0], a0[1], a0[2], a0[3]);
#pragma unroll
                for (int j = 0; j < 4; ++j) { a0[j] = a1[j]; a1[j] = 0.0f; }
                h0 = h1;
                h1 = false;
              } else if (i0 == row - 1) {  // row + 1 leaves, row becomes the second
                if (h1) atomic_add4(tab + static_cast<long long>(row + 1) * LD, a1[0], a1[1], a1[2], a1[3]);
#pragma unroll
                for (int j = 0; j < 4; ++j) { a1[j] = a0[j]; a0[j] = 0.0f; }
                h1 = h0;
                h0 = false;
              } else {
                if (h0) atomic_add4(tab + static_cast<long long>(row) * LD, a0[0], a0[1], a0[2], a0[3]);
                if (h1) atomic_add4(tab + static_cast<long long>(row + 1) * LD, a1[0], a1[1], a1[2], a1[3]);
#pragma unroll
                for (int j = 0; j < 4; ++j) a0[j] = a1[j] = 0.0f;
                h0 = h1 = false;
              }
              row = i0;
            }
            if (w0 != 0.0f) {
#pragma unroll
              for (int j = 0; j < 4; ++j) a0[j] += w0 * d[j];
              h0 = true;
            }
            if (w1 != 0.0f) {
#pragma unroll
              for (int j = 0; j < 4; ++j) a1[j] += w1 * d[j];
              h1 = true;
            }
          }
          if (h0) atomic_add4(tab + static_cast<long long>(row) * LD, a0[0], a0[1], a0[2], a0[3]);
          if (h1) atomic_add4(tab + static_cast<long long>(row + 1) * LD, a1[0], a1[1], a1[2], a1[3]);
        }
      }
      __syncthreads();  // this step's stages may be overwritten
    });
  }
  cp_async_wait<0>();
  __syncthreads();
  float* out = part + static_cast<long long>(blockIdx.x) * K::COUNT;
  store_mlp_partials<S>(out, reinterpret_cast<float*>(vbuf), dw, db, dbo);
  float* dbasis = out + S::ROWS * W + (NH + 1) * W;
#pragma unroll
  for (int g = 0; g < K::NBF; ++g) {
    if (g % kWarps != warp) continue;
    const int s = g / ((C / 16) * (F / 8)), q = g % ((C / 16) * (F / 8));
    const int col = (q % (F / 8)) * 8 + c_in;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = (q / (F / 8)) * 16 + r_in + 8 * half;
      dbasis[(s * C + c) * F + col] = dba[g / kWarps][2 * half];
      dbasis[(s * C + c) * F + col + 1] = dba[g / kWarps][2 * half + 1];
    }
  }
}

template <int C, int F, int NS, int W, int NH, int D, bool STACKED>
int cp_bwd(const float* x, long long n, const void* vsave, const void* hsave, const float* dout,
           const void* basis, const void* ws, const GradTables& dlines, float* part,
           int part_blocks, float* out, int* info, cudaStream_t stream) {
  using K = CpBwd<C, F, NS, W, NH, D>;
  auto kernel = cp_mlp_bwd_kernel<C, F, NS, W, NH, D, STACKED>;
  int rc = plan_persistent(reinterpret_cast<const void*>(kernel), K::BYTES, n, info);
  info[3] = K::COUNT;
  if (rc != 0 || part == nullptr) return rc;  // a plan query
  if (n <= 0 || info[0] > part_blocks) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<info[0], kThreads, K::BYTES, stream>>>(
      x, n, static_cast<const __nv_bfloat16*>(vsave), static_cast<const __nv_bfloat16*>(hsave),
      dout, static_cast<const __nv_bfloat16*>(basis), static_cast<const __nv_bfloat16*>(ws),
      dlines, part);
  sum_partials<<<(K::COUNT + kSumCols - 1) / kSumCols, 256, 0, stream>>>(part, info[0],
                                                                        K::COUNT, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// With part == nullptr: a plan query, filling info = {grid, blocks per SM,
// shared-memory bytes per block, partial sums per block}; the caller then
// allocates part (grid x partial sums, f32) and out (partial sums, f32) and
// calls again. out receives dW (rows, W), db (NH + 1, W) and dbasis (S, C, F)
// f32, in that order. The line-table gradients must be zeroed by the caller:
// the kernel adds into them. Returns cudaGetLastError() after the launches,
// or -1 when no instantiation matches the shape (the Python wrapper lists the
// supported ones).
extern "C" int cp_mlp_bwd(const float* x, long long n, const void* vsave,
                          const void* hsave, const float* dout, const void* basis,
                          const void* ws, void* const* dline_ptrs, const int* res,
                          int n_scales, float* part, int part_blocks, float* out, int* info,
                          int c, int f, int w, int n_hidden, int d, void* stream) {
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
    return insr::cp_bwd<C_, F_, S_, W_, NH_, D_, false>(                       \
        x, n, vsave, hsave, dout, basis, ws, dlines, part, part_blocks, out, info, st);
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
                                  float* part, int part_blocks, float* out, int* info, int c,
                                  int f, int w, int n_hidden, int d, void* stream) {
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
    return insr::cp_bwd<C_, F_, S_, W_, NH_, D_, true>(                        \
        x, n, vsave, hsave, dout, basis, ws, tables, part, part_blocks, out, info, st);
  INSR_CPS_BWD_CASE(64, 16, 2, 64, 1, 16)  // the bench NeRF density head, cp_stacked
  INSR_CPS_BWD_CASE(16, 8, 2, 32, 1, 16)   // the small test model
  INSR_CPS_BWD_CASE(16, 8, 2, 32, 2, 16)
#undef INSR_CPS_BWD_CASE
  return -1;
}
