// Device helpers shared by the streaming tile kernels (the opaque solve B1/B5
// in solve_tiled.cu, the ordered kernels B3/B4 in ordered_blend.cu and
// ordered_peel.cu, the flat solve B2 in reduce_flat.cu): 16-byte
// asynchronous copies into a shared-memory ring, and the exact test of an
// edge function against a box of pixel centres that their row scans use.
//
// Numerics: plane values are fl(fl(a*px + b*py) + c), explicit
// round-to-nearest operations in the reference's order (the library is also
// built with --fmad=false and without flush-to-zero).

#pragma once

#include <cuda_runtime.h>

namespace ck_tile {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The top-left rule as one comparison: e > threshold(tl) is
// e > 0 || (tl && e == 0), because e > -denorm_min <=> e >= 0 (the library
// is built without flush-to-zero). threshold(true) also turns a clip
// plane's d >= 0 into d > threshold.
__device__ __forceinline__ float threshold(bool top_left) {
  return top_left ? __int_as_float(0x80000001) : 0.f;
}

// fl(fl(a*px + b*py) + c) on a 1 x N block of pixel centres in one row.
template <int N>
__device__ __forceinline__ void plane_block(float a, float b, float c,
                                            const float (&px)[N], float py,
                                            float (&out)[N]) {
  const float by = __fmul_rn(b, py);
#pragma unroll
  for (int k = 0; k < N; ++k)
    out[k] = __fadd_rn(__fadd_rn(__fmul_rn(a, px[k]), by), c);
}

// The centre of pixel row (or column) `i` of a frame whose first row is
// global row `row0`: fl(fl(i + 0.5) + row0), the plain versions' order. A
// band of a frame (raster at a row offset) evaluates every plane at these
// global centres, so its pixels equal the same rows of the whole frame; at
// row0 = 0 it is i + 0.5.
__device__ __forceinline__ float centre(int i, float row0) {
  return __fadd_rn(__fadd_rn(static_cast<float>(i), 0.5f), row0);
}

// Whether fl(fl(a*px + b*py) + c) reaches the edge's threshold anywhere on
// the pixel centres of [xmin, xmax] x [ymin, ymax]. Rounded products and
// sums are monotone in px and in py, so the greatest value over the box is
// the value at the corner the signs of a and b pick, computed with the
// reference's own operations: the test is exact (a NaN or an inf - inf at
// that corner means no pixel of the box passes either).
__device__ __forceinline__ bool edge_reaches(float a, float b, float c,
                                             bool top_left, float xmin,
                                             float xmax, float ymin,
                                             float ymax) {
  const float e = __fadd_rn(__fadd_rn(__fmul_rn(a, a >= 0.f ? xmax : xmin),
                                      __fmul_rn(b, b >= 0.f ? ymax : ymin)),
                            c);
  return e > threshold(top_left);
}

}  // namespace ck_tile
