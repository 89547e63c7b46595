// Textured ordered peel, phase B (kernel B4) for Hopper (sm_90a).
//
// Replaces: ckrenderengine_tpu/raster/pallas_ordered.py `_peel_kernel`
// (run by `_peel_phase_b`, entries `ordered_peel_tiled_pallas` and
// `ordered_peel_iterate`), the Pallas TPU kernel that records draw-ordered
// fragment layers while the tile's rows stream through VMEM.
//
// What it computes: textured transparency cannot fold into an affine map
// before the texel is sampled, so the kernel peels instead. For each pixel
// it walks the tile's draw-ordered rows and numbers the covering fragments
// (ordered_common.cuh `covers`: B3's coverage without the alpha test, which
// needs the texel). Fragments numbered skip .. skip+K-1 are recorded as
// (draw id, raw e0, e1, e2); the count of covering fragments and an
// overflow flag (a fragment numbered skip+K or later exists) are written
// too. The frame shades and blends the K layers (frame._composite_peeled)
// and, while any pixel overflows, runs another round with skip += K.
//
// What bounds it on the card: per (pixel, row) pair ~40 flops of coverage
// and a few selects, against ~220 bytes of row read once per tile and
// broadcast from shared memory. The 4 x 4-word layer carry plus count and
// flag stay in registers (the K-slot writes are unrolled compares, so no
// local-memory array).
//
// Design: the CTA shape and staging of B3 (one CTA per tile, one thread per
// pixel, kchunk rows staged in dynamic shared memory by cooperative loads).
// Outputs are written straight into (K, H_pad, W_pad) ids (-1 = none),
// (K, 3, H_pad, W_pad) edge values and (H_pad, W_pad) count and flag
// planes. The Mosaic-only 8-row alignment, lane padding and the
// (8*K, npix) sublane output blocks are gone.
//
// Numerics: coverage and edge values are B3's explicit round-to-nearest
// operations, so ids, edge values, counts and flags equal the plain torch
// version (raster/cuda_ordered.py peel_phase_b_plain) exactly.

#include "ordered_common.cuh"

namespace {

using namespace ck_ordered;

constexpr int kLayers = 4;

__global__ void __launch_bounds__(1024) ordered_peel_kernel(
    const float* __restrict__ rows, int ncol, int n_planes,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ params, int skip,
    const float* __restrict__ zplane, int* __restrict__ lids,
    float* __restrict__ les, int* __restrict__ cnt_out,
    int* __restrict__ ovf_out, int tile, int tiles_x, int pitch,
    int plane_size, int kchunk) {
  extern __shared__ float sh[];
  int pix;
  const Pixel p = tile_pixel(params, zplane, tile, tiles_x, pitch, pix);
  int lid[kLayers];
  float l0[kLayers], l1[kLayers], l2[kLayers];
#pragma unroll
  for (int s = 0; s < kLayers; ++s) {
    lid[s] = -1;
    l0[s] = l1[s] = l2[s] = 0.f;
  }
  int cnt = 0;
  int ovf = 0;

  const int start = starts[blockIdx.x];
  const int count = counts[blockIdx.x];
  for (int c0 = 0; c0 < count; c0 += kchunk) {
    const int n = min(kchunk, count - c0);
    stage(sh, rows, ncol, start + c0, n);
    for (int r = 0; r < n; ++r) {
      const float* row = sh + r * ncol;
      float e0, e1, e2;
      if (!covers(row, n_planes, p, e0, e1, e2)) continue;
      if (cnt >= skip + kLayers) ovf = 1;
      const int id = static_cast<int>(row[kId]);
#pragma unroll
      for (int s = 0; s < kLayers; ++s) {
        if (cnt == skip + s) {
          lid[s] = id;
          l0[s] = e0;
          l1[s] = e1;
          l2[s] = e2;
        }
      }
      ++cnt;
    }
  }
#pragma unroll
  for (int s = 0; s < kLayers; ++s) {
    lids[s * plane_size + pix] = lid[s];
    les[(3 * s) * plane_size + pix] = l0[s];
    les[(3 * s + 1) * plane_size + pix] = l1[s];
    les[(3 * s + 2) * plane_size + pix] = l2[s];
  }
  cnt_out[pix] = cnt;
  ovf_out[pix] = ovf;
}

}  // namespace

extern "C" int ck_ordered_peel(const float* rows, int ncol, int n_planes,
                               const int* starts, const int* counts,
                               const float* params, int skip,
                               const float* zplane, int* lids, float* les,
                               int* cnt, int* ovf, int tile, int tiles_x,
                               int tiles_y, int kchunk, void* stream) {
  const int pitch = tiles_x * tile;
  const int plane_size = pitch * tiles_y * tile;
  size_t smem;
  cudaError_t err = prepare(ordered_peel_kernel, kchunk, ncol, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered_peel_kernel<<<tiles_x * tiles_y, tile * tile, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, ncol, n_planes, starts, counts, params, skip, zplane, lids, les,
      cnt, ovf, tile, tiles_x, pitch, plane_size, kchunk);
  return static_cast<int>(cudaGetLastError());
}
