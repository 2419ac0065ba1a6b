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
// Design: a thread takes one sample and one plane j = 3 s + k (block: 32
// samples x J planes, warp j on plane j, as VM1). It recomputes the taps and
// the plane and line features pf, lf (the same float order as VM1), and adds
// each tap's update to its gradient row as float4 atomics: 4 plane rows and
// 2 line rows of C floats. The entry point zeroes the gradients (one buffer
// for all tables) on the stream before the kernel, so the zeroing is part of
// the call. With dx requested, each thread also sums its plane's terms of
// d x_a, d x_b (through the bilinear weights) and d x_c (through the linear
// one), each masked to 0 < x < 1; the block's warps leave them in shared
// memory and warp 0 sums them per sample in plane order, as the JAX backward
// accumulates them (no atomics, so d x is the same in every run).
//
// Atomics make the summation order of a gradient row change from run to run,
// so the gradients agree with the plain version's index_add_ to float32
// rounding of the sums (chip_smoke.py holds them within 1e-5 x max|ref| per
// table against a float64 sum), not to the bit.
//
// What bounds it on an H100: the compulsory bytes are x (12 B) and ct (384 B
// at the VM NeRF's width) per sample, each table row the samples touch read
// once, and the whole gradient written once (64 MB): 0.07 ms for 262,144
// uniform samples at 3.35 TB/s. The updates are 36 rows x C / 4 float4
// atomics per sample (37.7 M at N = 262,144, C = 16), each a read-modify-
// write of 16 bytes in L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "vm_common.cuh"

namespace insr {

__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ float dot4(float4 u, float4 v) {
  float s = u.x * v.x;
  s = s + u.y * v.y;
  s = s + u.z * v.z;
  return s + u.w * v.w;
}

template <int C>
__global__ void vm_bwd_kernel(const float* __restrict__ x, long long n,
                              const float* __restrict__ ct, VMTables tables, VMTables grads,
                              int J, int line_res, float* __restrict__ dx) {
  __shared__ float part[kVMMaxJ][32][3];
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool live = i < n;
  float term[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const float xs[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
    const int res = tables.plane_res[j];
    const VMTaps t = vm_taps(xs, j % 3, res, line_res);
    const float* plane = tables.plane[j];
    const float* line = tables.line[j];
    float* dplane = const_cast<float*>(grads.plane[j]);
    float* dline = const_cast<float*>(grads.line[j]);
    const float* g_row = ct + i * J * C + j * C;
    float gp_tap[4] = {0.0f, 0.0f, 0.0f, 0.0f}, gl_tap[2] = {0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < C; q += 4) {
      float4 prow[4], lrow[2], pf, lf;
      vm_features(plane, line, t, C, q, prow, lrow, pf, lf);
      const float4 g = ld4(g_row + q);
      const float4 gl = mul4(g, lf), gp = mul4(g, pf);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        atomic_add4(dplane + static_cast<long long>(t.prow[k]) * C + q, scale4(gl, t.pw[k]));
      atomic_add4(dline + static_cast<long long>(t.lrow0) * C + q, scale4(gp, t.lw[0]));
      atomic_add4(dline + static_cast<long long>(t.lrow0 + 1) * C + q, scale4(gp, t.lw[1]));
      if (dx != nullptr) {
#pragma unroll
        for (int k = 0; k < 4; ++k) gp_tap[k] = gp_tap[k] + dot4(prow[k], gl);
        gl_tap[0] = gl_tap[0] + dot4(lrow[0], gp);
        gl_tap[1] = gl_tap[1] + dot4(lrow[1], gp);
      }
    }
    if (dx != nullptr) {
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
      const float in_a = xs[t.a] > 0.0f && xs[t.a] < 1.0f ? 1.0f : 0.0f;
      const float in_b = xs[t.b] > 0.0f && xs[t.b] < 1.0f ? 1.0f : 0.0f;
      const float in_c = xs[t.c] > 0.0f && xs[t.c] < 1.0f ? 1.0f : 0.0f;
      term[t.a] = ta * in_a;
      term[t.b] = tb * in_b;
      term[t.c] = tc * in_c;
    }
  }
  if (dx == nullptr) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) part[j][lane][d] = term[d];
  __syncthreads();
  if (j == 0 && live) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float s = 0.0f;
      for (int p = 0; p < J; ++p) s = s + part[p][lane][d];
      dx[3 * i + d] = s;
    }
  }
}

template <int C>
int launch_vm_bwd(const float* x, long long n, const float* ct, const VMTables& tables,
                  const VMTables& grads, int J, int line_res, float* dx, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
  vm_bwd_kernel<C><<<blocks, 32 * J, 0, stream>>>(x, n, ct, tables, grads, J, line_res, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Zeroes `grad_bytes` bytes at `grad_base` (the one buffer that holds every
// table's gradient) on the stream, then launches the kernel; returns
// cudaGetLastError(), or -1 when no instantiation matches (C not in {4, 8,
// 16, 32}, or J not a multiple of 3 in [3, 12]). ct (n, J * C) float32;
// `tables` the J planes and lines, `grads` their gradients (inside
// grad_base); dx nullptr or (n, 3) float32.
extern "C" int vm_bwd(const float* x, long long n, const float* ct,
                      const insr::VMTables* tables, const insr::VMTables* grads, int J, int c,
                      int line_res, float* grad_base, long long grad_bytes, float* dx,
                      void* stream) {
  if (J < 3 || J > insr::kVMMaxJ || J % 3 != 0) return -1;
  if (c != 4 && c != 8 && c != 16 && c != 32) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(grad_base, 0, static_cast<size_t>(grad_bytes), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch (c) {
    case 4: return insr::launch_vm_bwd<4>(x, n, ct, *tables, *grads, J, line_res, dx, st);
    case 8: return insr::launch_vm_bwd<8>(x, n, ct, *tables, *grads, J, line_res, dx, st);
    case 16: return insr::launch_vm_bwd<16>(x, n, ct, *tables, *grads, J, line_res, dx, st);
    default: return insr::launch_vm_bwd<32>(x, n, ct, *tables, *grads, J, line_res, dx, st);
  }
}
