// x / c with the reciprocal r = 1 / c hoisted: one product and one residual
// correction by fma (Markstein), for flash_attention.cu's softcap.
//
// Checked bit for bit against IEEE division over every float32 x with |x|
// in [2^-100, 2^100] (tools/check_division.cu): for the softcaps of the
// configs (50 and 30), which chip_smoke.py sweeps on every run, and for 118
// other divisors in [2^-20, 2^20] that the tool sweeps when run with no
// arguments (0 mismatches on an H100).  Other divisors are not proven: for
// them the correction leaves the quotient at most one ulp from x / c.  The
// sign is copied so that x = -0 gives -0.
#pragma once

__device__ __forceinline__ float div_by(float x, float c, float r) {
  const float q0 = x * r;
  const float q1 = fmaf(fmaf(-c, q0, x), r, q0);
  return copysignf(q1, x);
}
