// VM2: the Vector-Matrix encoding's table gradients, and its position
// gradient on request.
//
// Replaces: instant_nsr_pl_tpu/ops/vm.py _vm_fast_bwd (:176-237), XLA, not
// Pallas: per scale and plane it forms the (4N, C) plane updates w_p * (g *
// lf) and the (2N, C) line updates w_l * (g * pf) and sums them into dense
// gradients with the two-sort segment sum of ops/segment.py:28, because the
// TPU serialises scatter-adds; the position gradient goes through the
// interpolation weights.
//
// What bounds it on an H100: the compulsory bytes are x (12 B) and ct (384 B
// at the VM NeRF's width) per sample, each table row the samples touch read
// once, and the whole gradient written once (64 MB): 0.07 ms for 262,144
// uniform samples at 3.35 TB/s. But every update is a read-modify-write of
// scattered gradient rows in L2: 36 rows of 64 bytes per sample at C = 16,
// before any merge.
//
// Design: a lane group of C / 4 lanes (vm_common.cuh) walks a run of kVMRun
// consecutive samples on one plane j = 3 s + k; a warp holds 32 / (C / 4)
// groups on consecutive runs, and warps run sample tile first, plane second.
// For each sample the group recomputes the taps and the features pf, lf (the
// same float order as VM1; the six rows' loads in flight at once), forms the 4
// plane updates w_p * (g * lf) and the 2 line updates w_l * (g * pf) of its
// float4 of components, and passes them through a merge window: a tap whose
// row is one of the previous sample's rows takes over that row's running sum,
// and a previous row that no tap takes over is added to the gradient with one
// float4 atomic a lane. So
// - a warp atomic adds 32 / (C / 4) whole rows, whole 32-byte sectors;
// - along a ray, samples that stay in a cell or step to a neighbouring one
//   share rows (a 512-cell is about one step of the VM NeRF, a 256-cell
//   two): each shared row is added once per run instead of once per sample
//   (tools/bwd_bench.py --merge-stats counts it; vm_window_merge there is a
//   plain emulation of the window).
// The entry point zeroes the gradients (one buffer for all tables) on the
// stream before the kernel, so the zeroing is part of the call. With dx
// requested, each group also forms its plane's terms of d x_a, d x_b (through
// the bilinear weights) and d x_c (through the linear one), each masked to 0
// < x < 1, summed over the group's lanes in a fixed tree, into a (J, N, 3)
// scratch; a second pass sums them per sample in plane order, as the JAX
// backward accumulates them (no atomics, so d x is the same in every run).
//
// Atomics make the summation order of a gradient row change from run to run,
// so the gradients agree with the plain version's index_add_ to float32
// rounding of the sums (chip_smoke.py holds them within 1e-5 x max|ref| per
// table against a float64 sum), not to the bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "vm_common.cuh"

namespace insr {

// Consecutive samples a lane group walks on its plane (the merge window's run).
constexpr int kVMRun = 16;
constexpr int kNoRow = -1;  // an idle sample's tap

__device__ __forceinline__ float dot4(float4 u, float4 v) {
  float s = u.x * v.x;
  s = s + u.y * v.y;
  s = s + u.z * v.z;
  return s + u.w * v.w;
}

// Add v at component q of row `row` of the (rows, C) gradient: one float4
// atomic; a group's lanes together add the whole row.
__device__ __forceinline__ void add_row4(float* __restrict__ dtable, int row, int C, int q,
                                         float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dtable + static_cast<long long>(row) * C + q), v);
}

// One sample's step of the merge window over its T taps (rows, updates):
// each tap on a row of the previous sample's taps takes over that row's
// running sum; a previous row no tap takes over is added to the gradient.
// The group's lanes hold the same rows, so they add whole rows together.
template <int T>
__device__ __forceinline__ void merge_window(const int (&rows)[T], float4 (&upd)[T],
                                             int (&prev)[T], float4 (&acc)[T],
                                             float* __restrict__ dtable, int C, int q) {
  bool kept[T];
#pragma unroll
  for (int m = 0; m < T; ++m) kept[m] = false;
#pragma unroll
  for (int k = 0; k < T; ++k) {
#pragma unroll
    for (int m = 0; m < T; ++m) {
      if (rows[k] == prev[m]) {
        upd[k] = add4(upd[k], acc[m]);
        kept[m] = true;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < T; ++m) {
    if (!kept[m] && prev[m] != kNoRow) add_row4(dtable, prev[m], C, q, acc[m]);
    prev[m] = rows[m];
    acc[m] = upd[m];
  }
}

// The end of a run: every row still in the window is added.
template <int T>
__device__ __forceinline__ void flush_window(const int (&prev)[T], const float4 (&acc)[T],
                                             float* __restrict__ dtable, int C, int q) {
#pragma unroll
  for (int m = 0; m < T; ++m) {
    if (prev[m] != kNoRow) add_row4(dtable, prev[m], C, q, acc[m]);
  }
}

// DX: with the position gradient's terms (a second instantiation, so the
// table gradients alone keep their registers)
template <int C, bool DX>
__global__ void __launch_bounds__(kVMBlock)
    vm_bwd_kernel(const float* __restrict__ x, long long n, const float* __restrict__ ct,
                  VMTables tables, VMTables grads, int J, int line_res,
                  float* __restrict__ dx_part) {
  constexpr int L = VMLanes<C>::kLanes, G = VMLanes<C>::kGroups;
  const long long task = static_cast<long long>(blockIdx.x) * (kVMBlock / 32) + (threadIdx.x >> 5);
  const long long tile = task / J * (G * kVMRun);
  const int j = static_cast<int>(task % J);
  if (tile >= n) return;
  const int lane = threadIdx.x & 31;
  const int g = lane / L, q = (lane % L) * 4;
  const int res = tables.plane_res[j];
  const float* plane = tables.plane[j];
  const float* line = tables.line[j];
  float* dplane = const_cast<float*>(grads.plane[j]);
  float* dline = const_cast<float*>(grads.line[j]);
  const long long first = tile + g * kVMRun;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int pprev[4] = {kNoRow, kNoRow, kNoRow, kNoRow}, lprev[2] = {kNoRow, kNoRow};
  float4 pacc[4] = {zero, zero, zero, zero}, lacc[2] = {zero, zero};
#pragma unroll 1
  for (int s = 0; s < kVMRun; ++s) {
    // past the end a group reads the last sample and adds nothing
    const long long i = first + s;
    const bool live = i < n;
    const long long ii = live ? i : n - 1;
    const float xs[3] = {x[3 * ii], x[3 * ii + 1], x[3 * ii + 2]};
    const VMTaps t = vm_taps(xs, j % 3, res, line_res);
    float4 prow[4], lrow[2], pf, lf;
    vm_rows(plane, line, t, C, q, prow, lrow);
    const float4 gv = ld4(ct + ii * J * C + j * C + q);
    vm_features(t, prow, lrow, pf, lf);
    const float4 gl = mul4(gv, lf), gp = mul4(gv, pf);
    int prows[4], lrows[2];
    float4 pupd[4], lupd[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      prows[k] = live ? t.prow[k] : kNoRow;
      pupd[k] = live ? scale4(gl, t.pw[k]) : zero;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      lrows[m] = live ? t.lrow0 + m : kNoRow;
      lupd[m] = live ? scale4(gp, t.lw[m]) : zero;
    }
    if constexpr (DX) {
      float gp_tap[4], gl_tap[2];
#pragma unroll
      for (int k = 0; k < 4; ++k) gp_tap[k] = dot4(prow[k], gl);
      gl_tap[0] = dot4(lrow[0], gp);
      gl_tap[1] = dot4(lrow[1], gp);
      // the sums over the group's lanes, a fixed tree: every lane of the
      // group gets the same bits
#pragma unroll
      for (int off = 1; off < L; off *= 2) {
#pragma unroll
        for (int k = 0; k < 4; ++k) gp_tap[k] += __shfl_xor_sync(0xffffffffu, gp_tap[k], off);
        gl_tap[0] += __shfl_xor_sync(0xffffffffu, gl_tap[0], off);
        gl_tap[1] += __shfl_xor_sync(0xffffffffu, gl_tap[1], off);
      }
      if (live && q == 0) {
        const float sp = static_cast<float>(res - 1), sl = static_cast<float>(line_res - 1);
        const float ua = 1.0f - t.wa, ub = 1.0f - t.wb;
        // taps (ia0 ib0, ia0 ib1, ia1 ib0, ia1 ib1): d w / d wa, d w / d wb
        const float dwa[4] = {-ub * sp, -t.wb * sp, ub * sp, t.wb * sp};
        const float dwb[4] = {-ua * sp, ua * sp, -t.wa * sp, t.wa * sp};
        float ta = dwa[0] * gp_tap[0], tb = dwb[0] * gp_tap[0];
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          ta = ta + dwa[k] * gp_tap[k];
          tb = tb + dwb[k] * gp_tap[k];
        }
        const float tc = (-sl) * gl_tap[0] + sl * gl_tap[1];
        const float xa = vm_pick(xs, t.a), xb = vm_pick(xs, t.b), xc = vm_pick(xs, t.c);
        const float in_a = xa > 0.0f && xa < 1.0f ? 1.0f : 0.0f;
        const float in_b = xb > 0.0f && xb < 1.0f ? 1.0f : 0.0f;
        const float in_c = xc > 0.0f && xc < 1.0f ? 1.0f : 0.0f;
        float* d = dx_part + (static_cast<long long>(j) * n + i) * 3;
        d[t.a] = ta * in_a;
        d[t.b] = tb * in_b;
        d[t.c] = tc * in_c;
      }
    }
    merge_window<4>(prows, pupd, pprev, pacc, dplane, C, q);
    merge_window<2>(lrows, lupd, lprev, lacc, dline, C, q);
  }
  flush_window<4>(pprev, pacc, dplane, C, q);
  flush_window<2>(lprev, lacc, dline, C, q);
}

// d x = the planes' terms summed in plane order from 0, whatever the
// schedule that wrote them: the same bits from run to run.
__global__ void vm_dx_sum_kernel(const float* __restrict__ dx_part, long long n, int J,
                                 float* __restrict__ dx) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= 3 * n) return;
  float acc = 0.0f;
  for (int j = 0; j < J; ++j) acc = acc + dx_part[j * 3 * n + e];
  dx[e] = acc;
}

template <int C>
int launch_vm_bwd(const float* x, long long n, const float* ct, const VMTables& tables,
                  const VMTables& grads, int J, int line_res, float* dx, float* dx_part,
                  cudaStream_t stream) {
  constexpr long long kTile = VMLanes<C>::kGroups * kVMRun;
  const long long tasks = (n + kTile - 1) / kTile * J;
  const unsigned blocks = static_cast<unsigned>((tasks + kVMBlock / 32 - 1) / (kVMBlock / 32));
  if (dx == nullptr) {
    vm_bwd_kernel<C, false><<<blocks, kVMBlock, 0, stream>>>(x, n, ct, tables, grads, J,
                                                             line_res, nullptr);
  } else {
    vm_bwd_kernel<C, true><<<blocks, kVMBlock, 0, stream>>>(x, n, ct, tables, grads, J,
                                                            line_res, dx_part);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    vm_dx_sum_kernel<<<static_cast<unsigned>((3 * n + 255) / 256), 256, 0, stream>>>(dx_part, n,
                                                                                     J, dx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Zeroes `grad_bytes` bytes at `grad_base` (the one buffer that holds every
// table's gradient) on the stream, then launches the kernel; returns
// cudaGetLastError(), or -1 when no instantiation matches (C not in {4, 8,
// 16, 32}, or J not a multiple of 3 in [3, 12]) or d x is asked for without
// its scratch. ct (n, J * C) float32; `tables` the J planes and lines,
// `grads` their gradients (inside grad_base); dx nullptr or (n, 3) float32,
// overwritten, and then dx_part a (J, n, 3) float32 scratch for the planes'
// terms.
extern "C" int vm_bwd(const float* x, long long n, const float* ct,
                      const insr::VMTables* tables, const insr::VMTables* grads, int J, int c,
                      int line_res, float* grad_base, long long grad_bytes, float* dx,
                      float* dx_part, void* stream) {
  if (J < 3 || J > insr::kVMMaxJ || J % 3 != 0) return -1;
  if (c != 4 && c != 8 && c != 16 && c != 32) return -1;
  if (dx != nullptr && dx_part == nullptr) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(grad_base, 0, static_cast<size_t>(grad_bytes), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch (c) {
    case 4: return insr::launch_vm_bwd<4>(x, n, ct, *tables, *grads, J, line_res, dx, dx_part, st);
    case 8: return insr::launch_vm_bwd<8>(x, n, ct, *tables, *grads, J, line_res, dx, dx_part, st);
    case 16:
      return insr::launch_vm_bwd<16>(x, n, ct, *tables, *grads, J, line_res, dx, dx_part, st);
    default:
      return insr::launch_vm_bwd<32>(x, n, ct, *tables, *grads, J, line_res, dx, dx_part, st);
  }
}
