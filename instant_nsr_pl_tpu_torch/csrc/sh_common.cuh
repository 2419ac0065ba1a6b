// The real spherical-harmonics basis of degree 1..4 in f32, shared by the
// fused radiance forward (csrc/sh_mlp_fwd.cu) and backward (csrc/sh_mlp_bwd.cu).
//
// Replaces _kernel_sh of instant_nsr_pl_tpu/ops/sh_mlp_pallas.py:73-103: the
// constants of ops/sh.py and the same expressions, evaluated on the raw unit
// direction (x, y, z).
#pragma once

namespace insr {

template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* o) {
  o[0] = 0.28209479177387814f;
  if constexpr (DEG > 1) {
    o[1] = -0.4886025119029199f * y;
    o[2] = 0.4886025119029199f * z;
    o[3] = -0.4886025119029199f * x;
  }
  if constexpr (DEG > 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    o[4] = 1.0925484305920792f * xy;
    o[5] = -1.0925484305920792f * yz;
    o[6] = 0.31539156525252005f * ((2.0f * zz - xx) - yy);
    o[7] = -1.0925484305920792f * xz;
    o[8] = 0.5462742152960396f * (xx - yy);
    if constexpr (DEG > 3) {
      o[9] = (-0.5900435899266435f * y) * (3.0f * xx - yy);
      o[10] = (2.890611442640554f * xy) * z;
      o[11] = (-0.4570457994644658f * y) * ((4.0f * zz - xx) - yy);
      o[12] = (0.3731763325901154f * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      o[13] = (-0.4570457994644658f * x) * ((4.0f * zz - xx) - yy);
      o[14] = (1.445305721320277f * z) * (xx - yy);
      o[15] = (-0.5900435899266435f * x) * (xx - 3.0f * yy);
    }
  }
}

}  // namespace insr
