// Backward of the fused CP product + Jacobian + basis projection (K10):
// (d enc (F, N), d jac (3, F, N)) -> (d lines (3, R, C), d u (3, N), d B (C, F)),
// and of the raw CP product + Jacobian without a basis (K8, below).
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py _cp_jacb_bwd -> _jacb_bwd_kernel
// (pallas_call at :676). It reads the forward's bf16 residuals vsave and
// gdsave (3, C, N) (csrc/cp_jac_basis_fwd.cu training mode), never the tables,
// and follows the TPU kernel's rounding points. Per sample, with s_a = (R - 1)
// * d clip(u_a)/du_a, other_a = product of the other two axes' v, and (b, c)
// the other two axes of a:
//   prod = v_x * other_x,  jpre_a = (gd_a * s_a) * other_a  (recomputed, f32)
//   [dP | dJ_x | dJ_y | dJ_z] = B [bf16(d enc) | bf16(d jac_x..z)]  (f32 sums)
//   dB += bf16(prod) bf16(d enc)^T + sum_a bf16(jpre_a) bf16(d jac_a)^T
//   gs_a   = (dJ_a * gd_a) * s_a
//   d v_a  = dP * other_a + gs_b * v_c + gs_c * v_b
//   d gd_a = (dJ_a * s_a) * other_a
//   d u_a  = (sum_C d v_a * gd_a) * s_a                   (the f32 d v)
//   dL_a[i0]     += w0 * bf16(d v_a) - bf16(d gd_a)
//   dL_a[i0 + 1] += w1 * bf16(d v_a) + bf16(d gd_a)
// The two products are the TPU's `unproj` and `outerT` (cp_pallas.py:556-577),
// bf16 x bf16 with f32 sums; the last two lines are its dense bf16(d v) x
// tent^T + bf16(d gd) x diff-hot^T matmuls restricted to their two non-zero
// rows.
//
// What bounds it on an H100: HBM. Per sample it reads u (12 B), vsave and
// gdsave (768 B at C = 64), d enc and d jac (256 B at F = 16) and writes d u
// (12 B): 1,048 B, 82 us at 3.35 TB/s for 262,144 samples. Its 8k bf16
// multiply-adds per sample are 4 us of tensor-core time, its ~2.5k f32
// operations 10 us on the CUDA cores. Beyond the bytes, what costs is the
// line-table scatter: 2 rows x 3 axes x C/4 16-byte atomics per sample.
//
// Design (tensor cores, csrc/mma_common.cuh): persistent blocks of 8 warps
// walk tiles of 64 consecutive samples; a tile is worked in steps of CT =
// min(C, 32) components of one scale. Per step:
// 1. the step's vsave and gdsave rows arrive with cp.async as bf16 [row][sample]
//    tiles (at a scale's first step also bf16(d enc), bf16(d jac) as
//    [row][sample], F padded to 16 with zero rows; at the tile's first step
//    the tent coordinates);
// 2. warp w owns samples 8w..8w+7: [dP | dJ] = B_s [d enc | d jac] as four
//    m16n8k16 products per 16 components (K = 16), then the elementwise terms
//    in f32 in the order above; bf16(prod), bf16(jpre) go to a [row][sample]
//    tile, d v and d gd stay in registers as bf16 pairs, d v * gd sums into
//    d u;
// 3. d v and d gd are staged over the residual rows as [axis][sample][component];
//    d B_s += [prod; jpre] [d enc; d jac]^T (K = 4 x 64 samples) on this warp's
//    16x8 fragments, which stay in registers over every tile the block walks;
// 4. the scatter: a group of CT/4 lanes adds one CT-float row with 16-byte
//    atomics, walking a run of the tile's (axis, sample) rows in order with a
//    window of two rows, so contributions to the same row (a ray's
//    neighbouring samples, above all on the coarse table) are summed before
//    they go to L2, as csrc/cp_mlp_bwd.cu does; one run per group splits the
//    tile's 3 x 64 rows evenly.
// d B is summed over blocks in block order by mma_common.cuh's sum_partials:
// the same from run to run. The line tables' summation order changes from
// run to run (atomics), so they agree with the plain version to f32 rounding
// of the sums. 63-66 KB of shared memory and 128 registers a thread, two
// blocks of 8 warps per SM.
//
// Stacked scales (K12): the kernel is written for S scales sharing one (3, R,
// S*C) table, with an (S, C, F) basis, cotangents d enc (S*F, N) and d jac
// (3, S*F, N), residuals (3, S*C, N), and outputs d lines (3, R, S*C), d u
// (3, N) and d B (S, C, F). K10 is its S = 1 instantiation. With S = 2 it
// replaces cp_pallas.py _cp_jacs_bwd -> _jacs_bwd_kernel (pallas_call at :952):
// one tent per axis at R_max; the scales are worked one after the other into
// their own (C, F) block of d B (the diagonal blocks of the TPU's (E, S*C)
// d B^T); d u sums over all S*C components; each scale's steps scatter their
// columns of the S*C-wide rows of the one fine gradient table, which
// ops/cp_stacked.py maps back to each coarse scale (U^T d fine). At S*C = 128,
// F = 16 the function moves 2,072 B per sample (0.16 ms at 3.35 TB/s for
// 262,144 samples).
//
// Raw products (K8, the F = 0 instantiation): (d prod (C, N), d jac (3, C, N))
// -> (d lines (3, R, C), d u (3, N)). It replaces cp_pallas.py
// _cp_product_jac_bwd -> _jac_bwd_kernel (pallas_call at :464), the backward
// of the NeuS SDF encoding with n_features: 0, reading the residuals of
// csrc/cp_product_jac_fwd.cu (K7). The function is the one above without the
// basis: dP and dJ_a are the f32 cotangents as given, and there is no d B.
// What bounds it: HBM. Per sample it reads u (12 B), vsave and gdsave (12 B x
// C), d prod (4 B x C) and d jac (12 B x C) and writes d u (12 B): 1,816 B at
// C = 64, 0.142 ms at 3.35 TB/s for 262,144 samples, plus the (3, R, C) f32
// table gradient once. Sample by sample, the scatter would be 2 rows x 3
// axes x C/4 16-byte atomics per sample into tables that stay in L2: 25 M a
// launch at C = 64, 0.4-0.5 ms at the ~50-70 G sector updates/s of the L2's
// atomic unit, three times the bytes bound. Here step 1 also brings the
// step's f32 d prod and d jac rows in with cp.async as [row][sample] tiles
// (the bf16 cotangent tile, the products and the d B fragments drop out), and
// the scatter is step 4's: a ray's neighbouring samples, which hit the same
// rows above all on the coarse R = 128 table, are summed in registers before
// they reach L2. d u sums over the components in another order than the
// plain version (lanes, then steps): it agrees to f32 rounding. 40-71 KB of
// shared memory at C = 16-128, two blocks of 8 warps per SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "cp_common.cuh"
#include "mma_common.cuh"

namespace insr {

// F = 0 is K8 (csrc header above): no basis, so no [dP | dJ] and no d B
// products, and the f32 cotangents d prod (C, N), d jac (3, C, N) come in C
// wide instead of bf16 ones F wide.
template <int C, int F, int S>
struct JacBwd {
  static constexpr bool RAW = F == 0;
  // components per step: 32 holds the step's d v / d gd in 24 registers a
  // thread; with 64 (48 registers) the 128 registers of two blocks per SM
  // spilled up to 296 bytes and K12 ran 20% slower (tools/bwd_bench.py)
  static constexpr int CT = C < 32 ? C : 32;
  static constexpr int NH = C / CT;           // steps per scale
  static constexpr int STEPS = S * NH;
  static constexpr int FP = 16;               // rows of a cotangent tile (F padded to 16)
  static constexpr int NT = F / 8;            // d B n-tiles (8 features each)
  static constexpr int LDB = 24;              // row stride of the basis (F padded to 16, + 8)
  static constexpr int LDD = CT + 8;          // row stride of the d v / d gd stage
  // shared memory, in bf16 elements
  static constexpr int BS = RAW ? 0 : S * C * LDB;
  static constexpr int VG = 6 * CT * kLdT;         // the step's vsave, gdsave [row][sample]
  static constexpr int DS = 2 * 3 * kT * LDD;      // bf16 d v, d gd [kind][axis][sample][c]
  static constexpr int ST = VG > DS ? VG : DS;     // one region: DS overwrites VG
  static constexpr int AT = RAW ? 0 : 4 * CT * kLdT;  // bf16 prod, jpre_x..z [q][c][sample]
  static constexpr int DE = RAW ? 0 : 4 * FP * kLdT;  // bf16 d enc, d jac_x..z [q][f][sample]
  static constexpr int CF = RAW ? 4 * CT * kLdT : 0;  // f32 dP, dJ_x..z [q][c][sample] (K8)
  static constexpr size_t BYTES = 2 * (BS + ST + AT + DE) + 4 * CF + 4 * 4 * 3 * kT;  // + tents
  static constexpr int MINB = BYTES <= 113 * 1024 ? 2 : 1;
  static constexpr int DPT = 4 * F * kT / kThreads;  // bf16 cotangent values each thread stages
  // the scatter: groups of CT/4 lanes, each walking one run of RUN (axis,
  // sample) rows of the tile in order (every group busy: longer runs, which
  // merge more, left groups idle and ran 2-5% slower; tools/bwd_bench.py)
  static constexpr int GL = CT / 4;
  static constexpr int NG = kThreads / GL;
  static constexpr int RUN = 3 * kT / NG;
  // d B fragments: (CT/16) x NT per step, numbered across the steps; warp g %
  // kWarps owns fragment g in register slot g / kWarps
  static constexpr int FPS = (CT / 16) * NT;
  static constexpr int NBF = STEPS * FPS;
  static constexpr int NBW = NBF > 0 ? (NBF + kWarps - 1) / kWarps : 1;
  static constexpr int COUNT = S * C * F;
  static_assert(C % CT == 0 && CT % 16 == 0 && F % 8 == 0 && F <= FP, "layout");
  static_assert(GL <= 32 && 32 % GL == 0 && (3 * kT) % NG == 0, "scatter groups");
  static_assert((4 * F * kT) % kThreads == 0, "whole cotangent rows per thread");
};

template <int C, int F, int S>
__global__ void __launch_bounds__(kThreads, (JacBwd<C, F, S>::MINB))
    cp_jac_basis_bwd_kernel(const float* __restrict__ u3, long long n, int r,
                            const __nv_bfloat16* __restrict__ vsave,
                            const __nv_bfloat16* __restrict__ gdsave,
                            const float* __restrict__ denc, const float* __restrict__ djac,
                            const __nv_bfloat16* __restrict__ basis,
                            float* __restrict__ dlines, float* __restrict__ du,
                            float* __restrict__ part) {
  using K = JacBwd<C, F, S>;
  constexpr int CT = K::CT;
  constexpr int LD = S * C;  // row stride of the gradient table
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* st = bs + K::BS;  // residual rows, then d v / d gd
  __nv_bfloat16* at = st + K::ST;
  __nv_bfloat16* de = at + K::AT;
  float* cf = reinterpret_cast<float*>(de + K::DE);  // K8's f32 cotangent rows
  int* ti0 = reinterpret_cast<int*>(cf + K::CF);  // [axis][sample] tent coordinates
  float* tw0 = reinterpret_cast<float*>(ti0 + 3 * kT);
  float* tw1 = tw0 + 3 * kT;
  float* tsc = tw1 + 3 * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_in = lane >> 2, c_in = (lane & 3) * 2;
  const int t = warp * 8 + c_in;  // this thread's first sample of the tile (and t + 1)
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  if constexpr (!K::RAW) {
    for (int q = threadIdx.x; q < K::BS; q += kThreads) {
      const int row = q / K::LDB, col = q % K::LDB;
      bs[q] = col < F ? basis[row * F + col] : zero;
    }
    fill_shared(de, K::DE, zero);  // rows F..15 of each cotangent stay zero
  }

  float dba[K::NBW][4];
#pragma unroll
  for (int g = 0; g < K::NBW; ++g) dba[g][0] = dba[g][1] = dba[g][2] = dba[g][3] = 0.0f;

  const long long ntiles = (n + kT - 1) / kT;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long s0 = tile * kT;
    const int nv = static_cast<int>(n - s0 < kT ? n - s0 : kT);
    float acc_u[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
    static_for<0, K::STEPS>([&](auto kc) {
      constexpr int k = decltype(kc)::value;
      constexpr int s = k / K::NH, h = k % K::NH;
      constexpr int c0 = s * C + h * CT;  // the step's first component of the S*C
      // 1. the step's residual rows (3 axes of v, then of gd), asynchronously
      const auto row_of = [=](int row) { return (row / CT) * LD + c0 + row % CT; };
      load_tile_rows(st, vsave, n, s0, 3 * CT, row_of);
      load_tile_rows(st + 3 * CT * kLdT, gdsave, n, s0, 3 * CT, row_of);
      if constexpr (K::RAW) {  // and the step's f32 d prod, d jac_x..z rows
        load_tile_rows(cf, denc, n, s0, CT, [=](int row) { return c0 + row; });
        load_tile_rows(cf + CT * kLdT, djac, n, s0, 3 * CT, row_of);
      }
      cp_async_commit();
      if constexpr (k == 0) {
        for (int q = threadIdx.x; q < 3 * kT; q += kThreads) {
          const int a = q / kT, tq = q % kT;
          const Tent tt = tent(u3[a * n + s0 + (tq < nv ? tq : nv - 1)], r);
          ti0[q] = tt.i0;
          tw0[q] = tt.w0;
          tw1[q] = tt.w1;
          tsc[q] = tq < nv ? tt.s : 0.0f;
        }
      }
      if constexpr (h == 0 && !K::RAW) {
        // this scale's bf16 cotangents, [q][f][sample]: every load of the
        // thread in flight at once, not one round trip per value
        float val[K::DPT];
#pragma unroll
        for (int i = 0; i < K::DPT; ++i) {
          const int q = threadIdx.x + i * kThreads;
          const int qq = q / (F * kT), f = (q / kT) % F, tq = q % kT;
          const float* src = qq == 0 ? denc + static_cast<long long>(s * F + f) * n
                                     : djac + static_cast<long long>((qq - 1) * S * F + s * F + f) * n;
          val[i] = tq < nv ? src[s0 + tq] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < K::DPT; ++i) {
          const int q = threadIdx.x + i * kThreads;
          const int qq = q / (F * kT), f = (q / kT) % F, tq = q % kT;
          de[(qq * K::FP + f) * kLdT + tq] = __float2bfloat16_rn(val[i]);
        }
      }
      cp_async_wait<0>();
      __syncthreads();

      // 2. this warp's 8 samples: [dP | dJ] on the tensor cores, then f32
      float sa[3][2];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        sa[a][0] = tsc[a * kT + t];
        sa[a][1] = tsc[a * kT + t + 1];
      }
      uint32_t bq[4][2];
      if constexpr (!K::RAW) {
#pragma unroll
        for (int q = 0; q < 4; ++q) load_b_t(bq[q], de + q * K::FP * kLdT, kLdT, 0, warp * 8, lane);
      }
      uint32_t dvp[CT / 16][2][3], dgp[CT / 16][2][3];  // bf16 pairs of samples t, t + 1
#pragma unroll
      for (int mt = 0; mt < CT / 16; ++mt) {
        float dq[4][4];
        if constexpr (K::RAW) {  // K8: the f32 cotangents as given
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float2 v = *reinterpret_cast<const float2*>(
                  cf + (q * CT + mt * 16 + r_in + 8 * half) * kLdT + t);
              dq[q][2 * half] = v.x;
              dq[q][2 * half + 1] = v.y;
            }
          }
        } else {
          uint32_t af[4];
          load_a(af, bs + c0 * K::LDB, K::LDB, mt * 16, 0, lane);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dq[q][0] = dq[q][1] = dq[q][2] = dq[q][3] = 0.0f;
            mma_bf16(dq[q], af, bq[q]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = mt * 16 + r_in + 8 * half;
          uint32_t vr[3], gr[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            vr[a] = *reinterpret_cast<const uint32_t*>(st + (a * CT + c) * kLdT + t);
            gr[a] = *reinterpret_cast<const uint32_t*>(st + ((3 + a) * CT + c) * kLdT + t);
          }
          float pr[2], jp[3][2], dv[3][2], dg[3][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v[3], gd[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              v[a] = j ? bf16x2_hi(vr[a]) : bf16x2_lo(vr[a]);
              gd[a] = j ? bf16x2_hi(gr[a]) : bf16x2_lo(gr[a]);
            }
            const float other[3] = {v[1] * v[2], v[0] * v[2], v[0] * v[1]};
            pr[j] = v[0] * other[0];
            const float dp = dq[0][2 * half + j];
            float dJ[3], gs[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              dJ[a] = dq[1 + a][2 * half + j];
              jp[a][j] = (gd[a] * sa[a][j]) * other[a];
              gs[a] = (dJ[a] * gd[a]) * sa[a][j];
            }
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const int b1 = a == 0 ? 1 : 0;
              const int b2 = a == 2 ? 1 : 2;
              dv[a][j] = (dp * other[a] + gs[b1] * v[b2]) + gs[b2] * v[b1];
              dg[a][j] = (dJ[a] * sa[a][j]) * other[a];
              acc_u[a][j] = acc_u[a][j] + dv[a][j] * gd[a];
            }
          }
          if constexpr (!K::RAW) {
            *reinterpret_cast<uint32_t*>(at + c * kLdT + t) = pack_bf16x2(pr[0], pr[1]);
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              *reinterpret_cast<uint32_t*>(at + ((1 + a) * CT + c) * kLdT + t) =
                  pack_bf16x2(jp[a][0], jp[a][1]);
            }
          }
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            dvp[mt][half][a] = pack_bf16x2(dv[a][0], dv[a][1]);
            dgp[mt][half][a] = pack_bf16x2(dg[a][0], dg[a][1]);
          }
        }
      }
      if constexpr (k == K::STEPS - 1) {  // d u of this warp's samples: sum over the lanes' rows
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v = acc_u[a][j];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (r_in == 0 && t + j < nv) du[a * n + s0 + t + j] = v * sa[a][j];
          }
        }
      }
      __syncthreads();  // every warp has read the residual rows

      // 3. d v, d gd over the residual rows as [kind][axis][sample][component]
#pragma unroll
      for (int mt = 0; mt < CT / 16; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = mt * 16 + r_in + 8 * half;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int kind = 0; kind < 2; ++kind) {
              const uint32_t p = kind == 0 ? dvp[mt][half][a] : dgp[mt][half][a];
              __nv_bfloat16* row = st + ((kind * 3 + a) * kT + t) * K::LDD + c;
              row[0] = __ushort_as_bfloat16(static_cast<unsigned short>(p));
              row[K::LDD] = __ushort_as_bfloat16(static_cast<unsigned short>(p >> 16));
            }
          }
        }
      }
      // d B_s += [prod; jpre] [d enc; d jac]^T for this warp's fragments (none in K8)
#pragma unroll
      for (int q = 0; q < K::FPS; ++q) {
        constexpr int kOff = k * K::FPS;
        if ((kOff + q) % kWarps != warp) continue;
        const int m0 = (q / K::NT) * 16, n0 = (q % K::NT) * 8;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
#pragma unroll
          for (int k0 = 0; k0 < kT; k0 += 16) {
            uint32_t af[4], bf[2];
            load_a(af, at + qq * CT * kLdT, kLdT, m0, k0, lane);
            load_b(bf, de + qq * K::FP * kLdT, kLdT, n0, k0, lane);
            mma_bf16(dba[(kOff + q) / kWarps], af, bf);
          }
        }
      }
      __syncthreads();  // d v and d gd are staged

      // 4. the scatter: group g walks run g of RUN (axis, sample) rows in
      // order, one 16-byte column slice per lane, with a window of two rows
      const int grp = threadIdx.x / K::GL, ql = threadIdx.x % K::GL;
      {
        int a = -1, row = -2;
        float* tab = nullptr;
        float a0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int q = grp * K::RUN; q < (grp + 1) * K::RUN; ++q) {
          const int tq = q % kT;
          if (q / kT != a) {  // the run enters the next axis: empty the window
            if (row >= 0) {
              atomic_add4(tab + static_cast<long long>(row) * LD, a0[0], a0[1], a0[2], a0[3]);
              atomic_add4(tab + static_cast<long long>(row + 1) * LD, a1[0], a1[1], a1[2], a1[3]);
            }
            a = q / kT;
            row = -2;
            tab = dlines + static_cast<long long>(a) * r * LD + c0 + 4 * ql;
          }
          if (tq >= nv) continue;
          const int i0 = ti0[q];
          const float w0 = tw0[q], w1 = tw1[q];
          const uint2 rv = *reinterpret_cast<const uint2*>(st + q * K::LDD + 4 * ql);
          const uint2 rg = *reinterpret_cast<const uint2*>(st + (3 * kT + q) * K::LDD + 4 * ql);
          const float d[4] = {bf16x2_lo(rv.x), bf16x2_hi(rv.x), bf16x2_lo(rv.y), bf16x2_hi(rv.y)};
          const float g[4] = {bf16x2_lo(rg.x), bf16x2_hi(rg.x), bf16x2_lo(rg.y), bf16x2_hi(rg.y)};
          if (i0 != row) {
            if (i0 == row + 1) {  // row leaves the window, row + 1 becomes its first row
              atomic_add4(tab + static_cast<long long>(row) * LD, a0[0], a0[1], a0[2], a0[3]);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) { a0[jj] = a1[jj]; a1[jj] = 0.0f; }
            } else if (i0 == row - 1) {  // row + 1 leaves, row becomes the second
              atomic_add4(tab + static_cast<long long>(row + 1) * LD, a1[0], a1[1], a1[2], a1[3]);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) { a1[jj] = a0[jj]; a0[jj] = 0.0f; }
            } else {
              if (row >= 0) {
                atomic_add4(tab + static_cast<long long>(row) * LD, a0[0], a0[1], a0[2], a0[3]);
                atomic_add4(tab + static_cast<long long>(row + 1) * LD, a1[0], a1[1], a1[2], a1[3]);
              }
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) a0[jj] = a1[jj] = 0.0f;
            }
            row = i0;
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            a0[jj] += w0 * d[jj] - g[jj];
            a1[jj] += w1 * d[jj] + g[jj];
          }
        }
        if (row >= 0) {
          atomic_add4(tab + static_cast<long long>(row) * LD, a0[0], a0[1], a0[2], a0[3]);
          atomic_add4(tab + static_cast<long long>(row + 1) * LD, a1[0], a1[1], a1[2], a1[3]);
        }
      }
      __syncthreads();  // the stages may be overwritten
    });
  }

  if constexpr (K::RAW) return;  // K8 has no d B
  // this block's d B fragments, in a fixed order, to its partial row
  float* out = part + static_cast<long long>(blockIdx.x) * K::COUNT;
#pragma unroll
  for (int g = 0; g < K::NBF; ++g) {
    if (g % kWarps != warp) continue;
    const int k = g / K::FPS, q = g % K::FPS;
    const int c_row = (k / K::NH) * C + (k % K::NH) * CT + (q / K::NT) * 16;
    const int col = (q % K::NT) * 8 + c_in;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c_row + r_in + 8 * half;
      out[c * F + col] = dba[g / kWarps][2 * half];
      out[c * F + col + 1] = dba[g / kWarps][2 * half + 1];
    }
  }
}

template <int C, int F, int S>
int jac_basis_bwd(const float* u3, long long n, int r, const void* vsave, const void* gdsave,
                  const float* denc, const float* djac, const void* basis, float* dlines,
                  float* du, float* part, int part_blocks, float* out, int* info,
                  cudaStream_t stream) {
  using K = JacBwd<C, F, S>;
  auto kernel = cp_jac_basis_bwd_kernel<C, F, S>;
  int rc = plan_persistent(reinterpret_cast<const void*>(kernel), K::BYTES, n, info);
  info[3] = K::COUNT;
  if (rc != 0 || part == nullptr) return rc;  // a plan query
  if (n <= 0 || info[0] > part_blocks) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<info[0], kThreads, K::BYTES, stream>>>(
      u3, n, r, static_cast<const __nv_bfloat16*>(vsave),
      static_cast<const __nv_bfloat16*>(gdsave), denc, djac,
      static_cast<const __nv_bfloat16*>(basis), dlines, du, part);
  sum_partials<<<(K::COUNT + kSumCols - 1) / kSumCols, 256, 0, stream>>>(part, info[0],
                                                                        K::COUNT, out);
  return static_cast<int>(cudaGetLastError());
}

// K8: the F = 0 instantiation, without d B, so one launch and no partials.
// info (3 ints) receives the launch plan: grid, blocks per SM, shared bytes.
template <int C>
int product_jac_bwd(const float* u3, long long n, int r, const void* vsave, const void* gdsave,
                    const float* dprod, const float* djac, float* dlines, float* du, int* info,
                    cudaStream_t stream) {
  using K = JacBwd<C, 0, 1>;
  auto kernel = cp_jac_basis_bwd_kernel<C, 0, 1>;
  const int rc = plan_persistent(reinterpret_cast<const void*>(kernel), K::BYTES, n, info);
  if (rc != 0) return rc;
  if (n > 0) {
    kernel<<<info[0], kThreads, K::BYTES, stream>>>(
        u3, n, r, static_cast<const __nv_bfloat16*>(vsave),
        static_cast<const __nv_bfloat16*>(gdsave), dprod, djac, nullptr, dlines, du, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// K8, the raw products' backward: dprod (C, N) and djac (3, C, N) f32, the
// residuals of cp_product_jac_fwd (csrc/cp_product_jac_fwd.cu); dlines (3, R,
// C) zeroed by the caller (the kernel adds into it), du written. Returns
// cudaGetLastError() after the launch, or -1 when no instantiation matches.
extern "C" int cp_product_jac_bwd(const float* u3, long long n, int r, int c,
                                  const void* vsave, const void* gdsave, const float* dprod,
                                  const float* djac, float* dlines, float* du, int* info,
                                  void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_PJ_BWD_CASE(C_)                                                               \
  if (c == C_)                                                                             \
    return insr::product_jac_bwd<C_>(u3, n, r, vsave, gdsave, dprod, djac, dlines, du, info, st);
  INSR_PJ_BWD_CASE(128)  // the raw products at bench.py --encoding cp_big's C
  INSR_PJ_BWD_CASE(64)   // the raw-product NeuS SDF encoding
  INSR_PJ_BWD_CASE(16)   // the small test model
#undef INSR_PJ_BWD_CASE
  return -1;
}

// With part == nullptr: a plan query, filling info = {grid, blocks per SM,
// shared-memory bytes per block, partial sums per block}; the caller then
// allocates part (grid x partial sums, f32) and out (the (C, F) f32 d B) and
// calls again. dlines must be zeroed by the caller: the kernel adds into it;
// du is written. Returns cudaGetLastError() after the launches, or -1 when no
// instantiation matches the shape.
extern "C" int cp_jac_basis_bwd(const float* u3, long long n, int r, int c, int f,
                                const void* vsave, const void* gdsave, const float* denc,
                                const float* djac, const void* basis, float* dlines,
                                float* du, float* part, int part_blocks, float* out,
                                int* info, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_JACB_BWD_CASE(C_, F_)                                                    \
  if (c == C_ && f == F_)                                                             \
    return insr::jac_basis_bwd<C_, F_, 1>(u3, n, r, vsave, gdsave, denc, djac, basis, \
                                          dlines, du, part, part_blocks, out, info, st);
  INSR_JACB_BWD_CASE(128, 16)  // the bench NeuS SDF encoding at bench.py --encoding cp_big
  INSR_JACB_BWD_CASE(64, 16)   // the bench NeuS SDF encoding
  INSR_JACB_BWD_CASE(16, 8)    // the small test model
#undef INSR_JACB_BWD_CASE
  return -1;
}

// K12, the stacked-scales backward: r = R_max; dlines is the (3, R_max, S*C)
// f32 fine gradient table, zeroed by the caller, and out the (S, C, F) d B;
// the other operands as cp_jac_stacked_fwd writes and reads them, the plan
// query as cp_jac_basis_bwd.
extern "C" int cp_jac_stacked_bwd(const float* u3, long long n, int r, int c, int f,
                                  int n_scales, const void* vsave, const void* gdsave,
                                  const float* denc, const float* djac, const void* basis,
                                  float* dlines, float* du, float* part, int part_blocks,
                                  float* out, int* info, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_JACS_BWD_CASE(C_, F_, S_)                                                \
  if (c == C_ && f == F_ && n_scales == S_)                                           \
    return insr::jac_basis_bwd<C_, F_, S_>(u3, n, r, vsave, gdsave, denc, djac, basis, \
                                           dlines, du, part, part_blocks, out, info, st);
  INSR_JACS_BWD_CASE(64, 16, 2)  // the bench NeuS SDF encoding, cp_stacked
  INSR_JACS_BWD_CASE(16, 8, 2)   // the small test model
#undef INSR_JACS_BWD_CASE
  return -1;
}
