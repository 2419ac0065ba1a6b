// Tensor-core building blocks of the fused backward kernels (csrc/sh_mlp_bwd.cu
// K4, csrc/cp_mlp_bwd.cu K2/K14), and their shared bf16 ReLU MLP backward.
//
// Replaces kernel_mlp_bwd of instant_nsr_pl_tpu/ops/mlp_pallas_common.py:98-141
// (the MLP chain both fused TPU backward kernels end in) on Hopper's tensor
// cores. Every product of that chain is bf16 x bf16 with f32 accumulation,
// which is the contract of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.
//
// Layout. A block of kWarps warps walks tiles of kT consecutive samples. Each
// tile operand lives in shared memory as bf16 rows of samples, [feature][sample]
// with a row stride of kLdT (kT + 8, so the 8 rows of an ldmatrix hit 8 distinct
// bank quads): the (NH, W, N) `hsave` residual is copied row by row, the first
// layer's input and the output cotangent are written in the same layout. The
// packed weights ((sum d_in, Wmax) bf16, ops/mlp_common.py pack_mlp) are kept as
// bf16 with a row stride of W + 8. Per layer l, from the last to the first:
//   dW_l += bf16(A_l)^T bf16(G_l)        M = d_in, N = d_out, K = the tile's samples
//   G_in^T = W_l bf16(G_l)^T             M = d_in, N = samples, K = d_out (f32)
//   G_{l-1} = G_in * (A_l > 0)           f32; db_{l-1} += its column sums, and
//                                        bf16(G_{l-1}) overwrites A_l's rows in place
// the rounding points of kernel_mlp_bwd: db sums the unrounded f32 cotangent on
// the CUDA cores, every product rounds its operands to bf16. Reduction rows are
// padded to 16 and output columns to 8 (16 where they are the mma's k) inside
// the kernel with zero rows, never to the full width: a 3-column output layer
// is an 8-column dW and a 16-deep G_in product. Host layouts are unchanged.
//
// Cross-sample sums: each warp owns a fixed set of 16x8 dW fragments and keeps
// them in registers over every tile its block walks; db partials also stay in
// registers. At the end a block writes its partial sums, in a fixed order, to
// its row of a (blocks, elements) f32 scratch, and sum_partials adds the rows
// in block order: the result is the same from run to run (no atomics).
//
// What bounds it on an H100: the chain's products are ~2 x 16k bf16-operand
// flops per sample, 0.01 ms for 262,144 samples at the tensor cores' rate,
// while its users read 128-256 B of residual per sample; the block barriers
// between layers and the latency of the staging are what is left. Two blocks
// of 8 warps per SM (128 registers a thread, 70-110 KB of shared memory)
// keep one block's products running while the other stages its tile.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace insr {

constexpr int kT = 64;          // samples per tile
constexpr int kWarps = 8;       // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kLdT = kT + 8;    // row stride (bf16) of a [feature][sample] tile
static_assert(kT / 8 == kWarps, "warp w owns the tile's n-tile w in the G_in products");

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// fn(std::integral_constant<int, k>{}) for k = B .. E - 1: loop steps whose
// index is a compile-time constant (register-resident fragment slots).
template <int B, int E, typename Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
  if constexpr (B < E) {
    fn(std::integral_constant<int, B>{});
    static_for<B + 1, E>(fn);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a * b, a 16x16 (row), b 16x8 (col), c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment loads. `lane` is the thread's lane; ld is the row stride in bf16.
// A (16x16) from row-major [m][k] storage at (m0, k0).
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const __nv_bfloat16* base, int ld,
                                       int m0, int k0, int lane) {
  const int j = lane >> 3, i = lane & 7;
  ldsm_x4(r, base + (m0 + (j & 1) * 8 + i) * ld + k0 + (j >> 1) * 8);
}
// A (16x16) from its transpose stored row-major, [k][m], at (k0, m0).
__device__ __forceinline__ void load_a_t(uint32_t (&r)[4], const __nv_bfloat16* base, int ld,
                                         int k0, int m0, int lane) {
  const int j = lane >> 3, i = lane & 7;
  ldsm_x4_trans(r, base + (k0 + (j >> 1) * 8 + i) * ld + m0 + (j & 1) * 8);
}
// B (16x8, k x n) from [n][k] storage at (n0, k0).
__device__ __forceinline__ void load_b(uint32_t (&r)[2], const __nv_bfloat16* base, int ld,
                                       int n0, int k0, int lane) {
  const int j = (lane >> 3) & 1, i = lane & 7;
  ldsm_x2(r, base + (n0 + i) * ld + k0 + j * 8);
}
// B (16x8, k x n) from [k][n] storage at (k0, n0).
__device__ __forceinline__ void load_b_t(uint32_t (&r)[2], const __nv_bfloat16* base, int ld,
                                         int k0, int n0, int lane) {
  const int j = (lane >> 3) & 1, i = lane & 7;
  ldsm_x2_trans(r, base + (k0 + j * 8 + i) * ld + n0);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16x2_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16x2_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// ---------------------------------------------------------------------------
// global -> shared tile copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` rows of a (rows, n) bf16 array's samples [s0, s0 + kT) into a
// [row][sample] tile (stride kLdT); row r of the tile is source row
// row_of(r). Samples past n become zeros. With n a multiple of 8 every 16-byte
// chunk is aligned and the copy is asynchronous (commit and wait on the
// caller's side); otherwise it is done with plain loads, already complete.
template <typename RowOf>
__device__ __forceinline__ void load_tile_rows(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                               long long n, long long s0, int rows,
                                               RowOf row_of) {
  constexpr int kChunks = kT / 8;
  if ((n & 7) == 0) {
    for (int q = threadIdx.x; q < rows * kChunks; q += kThreads) {
      const int r = q / kChunks, ch = q % kChunks;
      const long long s = s0 + ch * 8;
      const bool in = s < n;
      const __nv_bfloat16* g = src + (in ? static_cast<long long>(row_of(r)) * n + s : 0);
      cp_async16(tile + r * kLdT + ch * 8, g, in ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int q = threadIdx.x; q < rows * kT; q += kThreads) {
      const int r = q / kT, c = q % kT;
      const long long s = s0 + c;
      tile[r * kLdT + c] = s < n ? src[static_cast<long long>(row_of(r)) * n + s] : zero;
    }
  }
}

// Packed (rows, W) bf16 weights into shared memory with row stride W + 8.
template <int W>
__device__ __forceinline__ void load_weights(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             int rows) {
  static_assert(W % 8 == 0, "16-byte rows");
  constexpr int kChunks = W / 8;
  for (int q = threadIdx.x; q < rows * kChunks; q += kThreads) {
    const int r = q / kChunks, ch = q % kChunks;
    *reinterpret_cast<uint4*>(dst + r * (W + 8) + ch * 8) =
        *reinterpret_cast<const uint4*>(src + r * W + ch * 8);
  }
}

template <typename T>
__device__ __forceinline__ void fill_shared(T* dst, int count, T v) {
  for (int q = threadIdx.x; q < count; q += kThreads) dst[q] = v;
}

// ---------------------------------------------------------------------------
// the MLP backward of one tile
// ---------------------------------------------------------------------------

// The packed chain DIN -> W (x NH hidden layers) -> DOUT. Layer l's dW is an
// (MT_l x NT_l) grid of 16x8 fragments, numbered across layers; warp w owns the
// fragments g with g % kWarps == w, in register slot g / kWarps.
template <int DIN, int W_, int NH, int DOUT_>
struct MlpShape {
  static_assert(W_ % 16 == 0 && DOUT_ <= W_ && NH >= 1, "layout");
  static constexpr int W = W_;
  static constexpr int NHID = NH;
  static constexpr int DOUT = DOUT_;
  static constexpr int DINP = round_up(DIN, 16);  // layer 0's reduction rows
  static constexpr int DP8 = round_up(DOUT_, 8);   // output columns as the mma's n
  static constexpr int DP16 = round_up(DOUT_, 16); // ... and as its k
  static constexpr int ROWS = DIN + NH * W;       // rows of the packed weights
  static constexpr int LDW = W + 8;
  __host__ __device__ static constexpr int mt(int l) { return (l == 0 ? DINP : W_) / 16; }
  __host__ __device__ static constexpr int nt(int l) { return (l == NH ? DP8 : W) / 8; }
  __host__ __device__ static constexpr int frags(int l) { return mt(l) * nt(l); }
  __host__ __device__ static constexpr int frag_off(int l) {
    return l == 0 ? 0 : frag_off(l - 1) + frags(l - 1);
  }
  __host__ __device__ static constexpr int row_off(int l) { return l == 0 ? 0 : DIN + (l - 1) * W; }
  static constexpr int NF = frag_off(NH) + frags(NH);
  static constexpr int NFW = (NF + kWarps - 1) / kWarps;  // dW slots per warp
};

// dW_l += A^T G over one tile for the fragments this warp owns: A is the
// layer input as a [row][sample] tile (M = rows), G the cotangent as a
// [column][sample] tile (N = columns); K runs over the kT samples.
template <class S, int L>
__device__ __forceinline__ void accumulate_dw(float (&dw)[S::NFW][4], const __nv_bfloat16* a,
                                              const __nv_bfloat16* g, int warp, int lane) {
  constexpr int NT = S::nt(L);
#pragma unroll
  for (int q = 0; q < S::frags(L); ++q) {
    constexpr int kOff = S::frag_off(L);
    if ((kOff + q) % kWarps != warp) continue;
    const int m0 = (q / NT) * 16, n0 = (q % NT) * 8;
#pragma unroll
    for (int k0 = 0; k0 < kT; k0 += 16) {
      uint32_t af[4], bf[2];
      load_a(af, a, kLdT, m0, k0, lane);
      load_b(bf, g, kLdT, n0, k0, lane);
      mma_bf16(dw[(kOff + q) / kWarps], af, bf);
    }
  }
}

// G_in^T = W_L G^T for the first MT m-tiles (16 input rows each) of layer L
// and this warp's n-tile (8 samples): gin[mt] is a 16x8 f32 fragment with
// rows (input features) mt*16 + lane/4 (+8) and samples warp*8 + 2*(lane%4)
// (+1). KD is the reduction depth (the layer's output columns, padded to 16).
template <class S, int L, int MT, int KD>
__device__ __forceinline__ void input_cotangent(float (&gin)[MT][4], const __nv_bfloat16* wt,
                                                const __nv_bfloat16* g, int warp, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    gin[mt][0] = gin[mt][1] = gin[mt][2] = gin[mt][3] = 0.0f;
  }
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    uint32_t bf[2];
    load_b_t(bf, g, kLdT, k0, warp * 8, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t af[4];
      load_a(af, wt + S::row_off(L) * S::LDW, S::LDW, mt * 16, k0, lane);
      mma_bf16(gin[mt], af, bf);
    }
  }
}

// Hidden/output layer L of the backward (L >= 1), then the layers below it:
// dW_L, G_in = W_L G_L, the mask by h_{L-1} > 0 with db_{L-1} of the f32
// values, and bf16(G_{L-1}) written over h_{L-1}'s rows.
template <class S, int L>
__device__ __forceinline__ void backward_layer(const __nv_bfloat16* wt, __nv_bfloat16* h,
                                               const __nv_bfloat16* gout, float (&dw)[S::NFW][4],
                                               float (&db)[S::NHID][S::W / 16][2], int warp,
                                               int lane) {
  constexpr int W = S::W;
  __nv_bfloat16* a = h + (L - 1) * W * kLdT;
  const __nv_bfloat16* g = L == S::NHID ? gout : h + L * W * kLdT;
  float gin[W / 16][4];
  accumulate_dw<S, L>(dw, a, g, warp, lane);
  input_cotangent<S, L, W / 16, (L == S::NHID ? S::DP16 : W)>(gin, wt, g, warp, lane);
  __syncthreads();  // every warp has read A_L and G_L
  const int r_in = lane >> 2, c_in = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < W / 16; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t* p = reinterpret_cast<uint32_t*>(a + (mt * 16 + r_in + 8 * half) * kLdT +
                                                warp * 8 + c_in);
      const uint32_t act = *p;
      const float g0 = bf16x2_lo(act) > 0.0f ? gin[mt][2 * half] : 0.0f;
      const float g1 = bf16x2_hi(act) > 0.0f ? gin[mt][2 * half + 1] : 0.0f;
      db[L - 1][mt][half] += g0 + g1;
      *p = pack_bf16x2(g0, g1);
    }
  }
  __syncthreads();  // G_{L-1} is staged
  if constexpr (L > 1) backward_layer<S, L - 1>(wt, h, gout, dw, db, warp, lane);
}

// The whole chain's backward for one tile. Shared-memory operands:
//   wt   packed weights, (ROWS, W + 8) bf16;
//   x0   layer 0's input, DINP rows of the tile (rows past DIN zero);
//   h    the tile's hidden activations, NH * W rows; overwritten in place by
//        the hidden layers' bf16 cotangents;
//   gout bf16(dout)^T, DP16 rows (rows past DOUT zero).
// dw / db accumulate this warp's dW fragments and this thread's db partials
// of the hidden layers (db[l][mt][half]: rows mt*16 + lane/4 + 8*half, over
// this thread's samples). out0(mt, frag) receives layer 0's input cotangent
// fragments (f32, unmasked) for the first MT0 m-tiles; the caller
// synchronises before reading what it stored or reusing x0 and h.
template <class S, int MT0, typename Out0>
__device__ __forceinline__ void mlp_backward_tile(const __nv_bfloat16* wt,
                                                  const __nv_bfloat16* x0, __nv_bfloat16* h,
                                                  const __nv_bfloat16* gout,
                                                  float (&dw)[S::NFW][4],
                                                  float (&db)[S::NHID][S::W / 16][2],
                                                  Out0 out0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  backward_layer<S, S::NHID>(wt, h, gout, dw, db, warp, lane);
  accumulate_dw<S, 0>(dw, x0, h, warp, lane);
  float gin[MT0][4];
  input_cotangent<S, 0, MT0, S::W>(gin, wt, h, warp, lane);
#pragma unroll
  for (int mt = 0; mt < MT0; ++mt) out0(mt, gin[mt]);
}

// ---------------------------------------------------------------------------
// block partial sums and their reduction
// ---------------------------------------------------------------------------

// Write this warp's dW fragments of layers 0..L to a block's partial row
// (`out`: the packed (ROWS, W) layout); rows past layer 0's DIN are padding.
template <class S, int L>
__device__ __forceinline__ void store_dw(float* __restrict__ out, const float (&dw)[S::NFW][4],
                                         int warp, int lane) {
  if constexpr (L > 0) store_dw<S, L - 1>(out, dw, warp, lane);
  constexpr int NT = S::nt(L);
  constexpr int kRows = L == 0 ? S::ROWS - S::NHID * S::W : S::W;  // layer L's d_in
#pragma unroll
  for (int q = 0; q < S::frags(L); ++q) {
    constexpr int kOff = S::frag_off(L);
    if ((kOff + q) % kWarps != warp) continue;
    const float(&c)[4] = dw[(kOff + q) / kWarps];
    const int col = (q % NT) * 8 + (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = (q / NT) * 16 + (lane >> 2) + 8 * half;
      if (row < kRows) {
        float* dst = out + (S::row_off(L) + row) * S::W + col;
        dst[0] = c[2 * half];
        dst[1] = c[2 * half + 1];
      }
    }
  }
}

// The MLP's part of a block's partial row: dW (ROWS, W), then db (NH + 1, W).
// red: kWarps * NH * W + kThreads * 4 floats of shared memory, free to use.
// dbo[jj]: this thread's sums of dout column (threadIdx.x & 3) + 4 * jj over
// the samples (threadIdx.x >> 2) of every tile.
template <class S>
__device__ __forceinline__ void store_mlp_partials(float* __restrict__ out, float* red,
                                                   const float (&dw)[S::NFW][4],
                                                   const float (&db)[S::NHID][S::W / 16][2],
                                                   const float (&dbo)[(S::DOUT + 3) / 4]) {
  constexpr int W = S::W, NH = S::NHID;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  store_dw<S, NH>(out, dw, warp, lane);
  // the output layer's columns past DP8 have no fragment: zero
  for (int q = threadIdx.x; q < W * (W - S::DP8); q += kThreads) {
    out[(S::row_off(NH) + q / (W - S::DP8)) * W + S::DP8 + q % (W - S::DP8)] = 0.0f;
  }
  float* red_h = red;                          // [warp][layer][row]
  float* red_o = red + kWarps * NH * W;        // [thread][jj]
#pragma unroll
  for (int l = 0; l < NH; ++l) {
#pragma unroll
    for (int mt = 0; mt < W / 16; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = db[l][mt][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0) red_h[(warp * NH + l) * W + mt * 16 + (lane >> 2) + 8 * half] = v;
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < (S::DOUT + 3) / 4; ++jj) red_o[threadIdx.x * 4 + jj] = dbo[jj];
  __syncthreads();
  float* db_out = out + S::ROWS * W;
  for (int q = threadIdx.x; q < (NH + 1) * W; q += kThreads) {
    const int l = q / W, j = q % W;
    float v = 0.0f;
    if (l < NH) {
      for (int w = 0; w < kWarps; ++w) v += red_h[(w * NH + l) * W + j];
    } else if (j < S::DOUT) {
      for (int s = 0; s < kT; ++s) v += red_o[(s * 4 + (j & 3)) * 4 + j / 4];
    }
    db_out[q] = v;
  }
}

// out[e] = sum over b < blocks of part[b][e], the same sum on every run: a
// block takes 32 elements; its 8 warps each add a fixed eighth of the blocks
// in block order, and the eight partial sums are added in warp order.
constexpr int kSumCols = 32;
__global__ void __launch_bounds__(256) sum_partials(const float* __restrict__ part, int blocks,
                                                    int count, float* __restrict__ out) {
  __shared__ float chunk[8][kSumCols];
  const int col = threadIdx.x % kSumCols, w = threadIdx.x / kSumCols;
  const int e = blockIdx.x * kSumCols + col;
  const int b0 = blocks * w / 8, b1 = blocks * (w + 1) / 8;
  float s = 0.0f;
  if (e < count) {
    int b = b0;
    for (; b + 8 <= b1; b += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = part[static_cast<long long>(b + k) * count + e];
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
    for (; b < b1; ++b) s += part[static_cast<long long>(b) * count + e];
  }
  chunk[w][col] = s;
  __syncthreads();
  if (w == 0 && e < count) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += chunk[k][col];
    out[e] = t;
  }
}

// Launch plan of a persistent backward kernel: blocks per SM from the
// occupancy calculator at `smem` bytes (queried once per kernel and device,
// with the shared-memory attribute set), the grid (SMs x blocks per SM, at
// most one block per tile). info = {grid, blocks per SM, smem bytes}. The
// cache has internal linkage: each library keeps its own.
struct PlanEntry {
  const void* kernel;
  int dev, per_sm, sms;
};
static PlanEntry plan_cache[64];
static int plan_count = 0;

static int plan_persistent(const void* kernel, size_t smem, long long n, int* info) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const PlanEntry* plan = nullptr;
  for (int i = 0; i < plan_count; ++i) {
    if (plan_cache[i].kernel == kernel && plan_cache[i].dev == dev) plan = &plan_cache[i];
  }
  PlanEntry fresh{kernel, dev, 0, 0};
  if (plan == nullptr) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fresh.per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fresh.per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount, dev);
    if (plan_count < 64) plan_cache[plan_count++] = fresh;
    plan = &fresh;
  }
  const long long tiles = (n + kT - 1) / kT;
  const long long cap = static_cast<long long>(plan->sms) * plan->per_sm;
  info[0] = static_cast<int>(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
  info[1] = plan->per_sm;
  info[2] = static_cast<int>(smem);
  return 0;
}

}  // namespace insr
