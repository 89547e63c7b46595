// Ordered alpha blend, phase B (kernel B3) for Hopper (sm_90a).
//
// Replaces: ckrenderengine_tpu/raster/pallas_ordered.py `_blend_kernel`
// (entry `ordered_blend_tiled_pallas`, phase A `_ordered_phase_a`), the
// Pallas TPU kernel that folds each pixel's draw-ordered blend steps into an
// affine map while the tile's rows stream through VMEM.
//
// What it computes: every blend the transparent path uses is affine in the
// destination colour, out = a*dst + b (alpha-over a = 1 - sa, b = src*sa;
// replace a = 0, b = src; an uncovered or discarded fragment is the
// identity). For each screen tile the CTA walks the tile's range
// [start, start + count) of the draw-ordered row stream; for each covering
// fragment (ordered_common.cuh `covers`) it interpolates colour and
// specular, applies fog, saturates, runs the alpha test, and folds the step
// after the carry: A <- a*A, B <- a*B + b per channel. The frame then takes
// fb' = A*fb + B. All four A channels are equal (a is one number per
// fragment), so one A is carried and written four times.
//
// What bounds it on the card: per (pixel, row) pair ~90 flops plus one
// IEEE division, against ~220 bytes of row read once per tile from device
// memory and broadcast from shared memory to the tile's pixels. It is
// arithmetic- and latency-bound (one thread per pixel, 64 registers at 1024
// threads); a transparent frame streams a few hundred rows per tile.
//
// Design: one CTA per screen tile and one thread per pixel (tile 16 or 32,
// tile^2 threads). kchunk rows at a time are staged in dynamic shared
// memory by plain cooperative loads; every thread evaluates every staged
// row with the 5-float carry in registers, and writes its (8, H_pad, W_pad)
// output planes directly. What existed only for Mosaic is gone: the 8-row
// alignment of tile ranges, the 128-lane row padding, the (8, npix)
// sublane carry and the two-slot DMA juggling. cp.async/TMA double
// buffering is later work.
//
// Numerics: explicit round-to-nearest operations in the reference's order
// (no contraction; built with --fmad=false), so A and B equal the plain
// torch version (raster/cuda_ordered.py blend_phase_b_plain) bit for bit.

#include "ordered_common.cuh"

namespace {

using namespace ck_ordered;

__device__ __forceinline__ float interp(const float* r, int k, float w0,
                                        float w1, float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], w0), __fmul_rn(r[k], w1)),
                   __fmul_rn(r[2 * k], w2));
}

__global__ void __launch_bounds__(1024) ordered_blend_kernel(
    const float* __restrict__ rows, int ncol, int n_planes,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ params, const float* __restrict__ zplane,
    float* __restrict__ out, int tile, int tiles_x, int pitch, int plane_size,
    int kchunk) {
  extern __shared__ float sh[];
  int pix;
  const Pixel p = tile_pixel(params, zplane, tile, tiles_x, pitch, pix);
  const float fog_r = params[6];
  const float fog_g = params[7];
  const float fog_b = params[8];
  float ca = 1.f;
  float cb[4] = {0.f, 0.f, 0.f, 0.f};

  const int start = starts[blockIdx.x];
  const int count = counts[blockIdx.x];
  for (int c0 = 0; c0 < count; c0 += kchunk) {
    const int n = min(kchunk, count - c0);
    stage(sh, rows, ncol, start + c0, n);
    for (int r = 0; r < n; ++r) {
      const float* row = sh + r * ncol;
      float e0, e1, e2;
      if (!covers(row, n_planes, p, e0, e1, e2)) continue;
      const float esum = __fadd_rn(__fadd_rn(e0, e1), e2);
      const float inv_esum =
          __fdiv_rn(1.f, fabsf(esum) < 1e-30f ? 1e-30f : esum);
      const int bits = static_cast<int>(row[kBits]);
      const bool persp = (bits & 8) != 0;
      const float ivs = row[kIvs];
      const float w0 = persp ? __fmul_rn(e0, inv_esum)
                             : __fmul_rn(__fmul_rn(e0, row[kWs]), ivs);
      const float w1 = persp ? __fmul_rn(e1, inv_esum)
                             : __fmul_rn(__fmul_rn(e1, row[kWs + 1]), ivs);
      const float w2 = persp ? __fmul_rn(e2, inv_esum)
                             : __fmul_rn(__fmul_rn(e2, row[kWs + 2]), ivs);
      float src[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) src[c] = interp(row + kCol + c, 4, w0, w1, w2);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        src[c] = __fadd_rn(src[c], interp(row + kSpc + c, 3, w0, w1, w2));
      if ((bits & 2) != 0) {
        const float f = clamp01(interp(row + kFog, 1, w0, w1, w2));
        const float g = __fsub_rn(1.f, f);
        src[0] = __fadd_rn(__fmul_rn(src[0], f), __fmul_rn(fog_r, g));
        src[1] = __fadd_rn(__fmul_rn(src[1], f), __fmul_rn(fog_g, g));
        src[2] = __fadd_rn(__fmul_rn(src[2], f), __fmul_rn(fog_b, g));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) src[c] = clamp01(src[c]);
      const float sa = src[3];
      if ((bits & 16) != 0 &&
          !compare(static_cast<int>(row[kAf]), sa, row[kAref]))
        continue;
      const bool blend_on = (bits & 1) != 0;
      const float a = blend_on ? __fsub_rn(1.f, sa) : 0.f;
      ca = __fmul_rn(a, ca);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        cb[c] = __fadd_rn(__fmul_rn(a, cb[c]),
                          blend_on ? __fmul_rn(src[c], sa) : src[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[c * plane_size + pix] = ca;
    out[(4 + c) * plane_size + pix] = cb[c];
  }
}

}  // namespace

extern "C" int ck_ordered_blend(const float* rows, int ncol, int n_planes,
                                const int* starts, const int* counts,
                                const float* params, const float* zplane,
                                float* out, int tile, int tiles_x,
                                int tiles_y, int kchunk, void* stream) {
  const int pitch = tiles_x * tile;
  const int plane_size = pitch * tiles_y * tile;
  size_t smem;
  cudaError_t err = prepare(ordered_blend_kernel, kchunk, ncol, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered_blend_kernel<<<tiles_x * tiles_y, tile * tile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      rows, ncol, n_planes, starts, counts, params, zplane, out, tile, tiles_x,
      pitch, plane_size, kchunk);
  return static_cast<int>(cudaGetLastError());
}
