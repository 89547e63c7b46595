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
// (ordered_common.cuh `cover_block`: B3's coverage without the alpha test,
// which needs the texel). Fragments numbered skip .. skip+K-1 are recorded
// as (draw id, raw e0, e1, e2); the count of covering fragments (all of
// them, also those after the K slots are full) and an overflow flag (a
// fragment numbered skip+K or later exists) are written too. The frame
// shades and blends the K layers (frame._composite_peeled) and, while any
// pixel overflows, runs another round with skip += K.
//
// What bounds it on the card: bytes. At alpha_tex50k (1024x768) the tiles
// stream 53,533 live rows of which the kernel reads the 28-float head
// (6.0 MB), read the 3.1 MB opaque depth plane and write 18 planes
// (56.6 MB): 65.7 MB, 0.0196 ms at 3.35 TB/s; the 3.0 M of 54.8 M (pixel,
// row) pairs that pass rect and edges need ~15 operations each,
// 0.0013 ms. The stores are most of the bytes. The kernel before this
// design (one CTA per tile, a thread per pixel, whole rows staged
// synchronously, every row on every pixel) ran 0.2388 ms per round.
//
// Design: B3's (ordered_common.cuh `walk`: a 4-deep ring of 32-row
// chunks filled by cp.async, a CTA per 16x16 sub-tile, the exact strip
// scan, survivors in draw order, one `__any_sync` before esum and depth),
// except that
//  * only the head of each row is copied (head/4 16-byte pieces a row at a
//    stride of the row pitch: 28 of 60 floats without a clip plane); colour,
//    specular, fog, alpha test and w never leave device memory, and the
//    smaller ring fits 7 CTAs per SM;
//  * the carry is 18 words a pixel (4 ids, 12 edge values, the count and
//    the flag), so a thread holds a 1 x 2 block (128 threads, a warp a 16x4
//    strip); the K-slot writes are unrolled compares, so the carry stays in
//    registers (72, no spills).
//
// Tried on the card and dropped (first-frame shapes of alpha_tex50k, 46,244
// rows, skip 0, the kernel's own time under torch.profiler, NVIDIA H100
// 80GB HBM3, 700 W; the kept design 0.0566 ms): 1 x 1 blocks, 0.0614 ms;
// 1 x 4 blocks, 0.0801 ms (127 registers); one 256-thread CTA per 32x32
// tile sharing one ring (1 x 4 blocks), 0.0921 ms, 512 threads with 1 x 2
// blocks, 0.0889 ms; 3 stages, the same; 64-row chunks (4 or 2 stages),
// 0.0548 ms, 3% faster, not taken so that both kernels keep one ring
// shape (B3 loses 2x with 64-row chunks at 4 stages).
//
// Numerics: coverage and edge values are B3's explicit round-to-nearest
// operations, so ids, edge values, counts and flags equal the plain torch
// version (raster/cuda_ordered.py peel_phase_b_plain) exactly.

#include "ordered_common.cuh"

namespace {

using namespace ck_ordered;

constexpr int kLayers = 4;  // raster/cuda_ordered.py K_LAYERS
constexpr int kBW = 2;      // pixels per thread: a 1 x kBW block
constexpr int kThreads = kSub * kSub / kBW;

__global__ void __launch_bounds__(kThreads) ordered_peel_kernel(
    const float* __restrict__ rows, int rpitch, int head, int n_planes,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ params, int skip,
    const float* __restrict__ zplane, int* __restrict__ lids,
    float* __restrict__ les, int* __restrict__ cnt_out,
    int* __restrict__ ovf_out, int tile, int tiles_x, int pitch,
    int plane_size, int kchunk) {
  extern __shared__ float4 ring4[];
  const Block<kBW> b =
      block_of<kBW>(params, zplane, tile, tiles_x, pitch);
  const int start = __ldg(starts + b.tile);
  const int count = __ldg(counts + b.tile);
  int lid[kLayers][kBW];
  float l0[kLayers][kBW], l1[kLayers][kBW], l2[kLayers][kBW];
  int cnt[kBW], ovf[kBW];
#pragma unroll
  for (int k = 0; k < kBW; ++k) {
#pragma unroll
    for (int s = 0; s < kLayers; ++s) {
      lid[s][k] = -1;
      l0[s][k] = l1[s][k] = l2[s][k] = 0.f;
    }
    cnt[k] = 0;
    ovf[k] = 0;
  }

  walk<kThreads>(
      reinterpret_cast<float*>(ring4), rows, rpitch, head, n_planes, start,
      count, kchunk, b, [&](const float* rows32, unsigned todo) {
        each_survivor(
            rows32, head, todo, n_planes, b,
            [&](const float* row, const bool (&cov)[kBW],
                const float (&e0)[kBW], const float (&e1)[kBW],
                const float (&e2)[kBW]) {
              const int id = __float2int_rz(row[kId]);
#pragma unroll
              for (int k = 0; k < kBW; ++k) {
                if (!cov[k]) continue;
                if (cnt[k] >= skip + kLayers) ovf[k] = 1;
#pragma unroll
                for (int s = 0; s < kLayers; ++s) {
                  if (cnt[k] == skip + s) {
                    lid[s][k] = id;
                    l0[s][k] = e0[k];
                    l1[s][k] = e1[k];
                    l2[s][k] = e2[k];
                  }
                }
                ++cnt[k];
              }
            });
      });

  const size_t ps = static_cast<size_t>(plane_size);
#pragma unroll
  for (int s = 0; s < kLayers; ++s) {
    store_block<kBW>(lids + s * ps + b.pix, lid[s]);
    store_block<kBW>(les + (3 * s) * ps + b.pix, l0[s]);
    store_block<kBW>(les + (3 * s + 1) * ps + b.pix, l1[s]);
    store_block<kBW>(les + (3 * s + 2) * ps + b.pix, l2[s]);
  }
  store_block<kBW>(cnt_out + b.pix, cnt);
  store_block<kBW>(ovf_out + b.pix, ovf);
}

}  // namespace

// `rows` is the (n, rpitch) ordered stream, 16-byte aligned, rpitch =
// head_width(n_planes) + kTail; only the heads are read. Outputs: lids
// (K, H_pad, W_pad), les (K, 3, H_pad, W_pad), cnt and ovf (H_pad, W_pad).
extern "C" int ck_ordered_peel(const float* rows, int rpitch, int n_planes,
                               const int* starts, const int* counts,
                               const float* params, int skip,
                               const float* zplane, int* lids, float* les,
                               int* cnt, int* ovf, int tile, int tiles_x,
                               int tiles_y, int kchunk, void* stream) {
  Launch g;
  const int head = head_width(n_planes);
  if (!geometry(kBW, rpitch, head, n_planes, tile, tiles_x, tiles_y, kchunk,
                &g) ||
      (reinterpret_cast<size_t>(rows) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ordered_peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered_peel_kernel<<<g.grid, g.block, g.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, rpitch, head, n_planes, starts, counts, params, skip, zplane,
      lids, les, cnt, ovf, tile, tiles_x, g.pitch, g.plane_size, kchunk);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at a launch's shapes; a negative CUDA error code
// when the shapes are not taken.
extern "C" int ck_ordered_peel_occupancy(int n_planes, int tile,
                                         int kchunk) {
  Launch g;
  const int head = head_width(n_planes);
  if (!geometry(kBW, head + kTail, head, n_planes, tile, 1, 1, kchunk, &g))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      ordered_peel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ordered_peel_kernel, static_cast<int>(g.block.x), g.smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
