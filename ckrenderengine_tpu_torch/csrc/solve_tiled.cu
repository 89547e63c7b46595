// Tile-binned opaque depth solve, phase B (kernels B1 and B5) for Hopper
// (sm_90a).
//
// Replaces: ckrenderengine_tpu/raster/pallas_tiled.py `_solve_kernel` (with
// its helpers `_group_eval` and `_merge`; entry
// `depth_reduce_tiled_pallas`), the Pallas TPU kernel that streams each
// screen tile's contiguous range of packed triangle rows through VMEM; and,
// as the FETCH instantiation (B5), the same kernel's fused winner-row fetch
// (`sh_w > 0`, `sh_pack = 2`).
//
// What it computes: for each screen tile, a streaming argmin over (1) the
// tile's own range [start, start + count) of the binned row stream, then
// (2) two leftover segments that EVERY tile streams: the unbounded/global
// class and the slab overflow. Coverage needs all of: three edge functions
// under the top-left rule, esum > 0, 0 <= depth <= 1, the per-triangle rect,
// every user clip plane, and the valid bit; the viewport scissor and the
// framebuffer bounds mask the tile's result at the end, exactly as the
// Pallas kernel does. The lower depth wins and an exact tie goes to the
// larger triangle id (= the later draw). With WANT_E the winner's raw edge
// values e0/e1/e2 are exported too (the quantized shade consumes them).
//
// With FETCH (B5) each pixel also receives the quantized shade row of its
// final winner: rows[:, y, x] = shade_tbl[id[y, x], :], int32 words moved
// bit for bit, 0 where the id is -1 (uncovered, or outside the scissor). The
// TPU kernel ships those words through the binned stream as u16 halves and
// pulls each chunk winner's row with a one-hot matrix product, because it
// has no cheap per-pixel gather; a GPU thread loads a row by index. So the
// solve loop is B1's, no shade column rides the stream, and the fetch is an
// epilogue: after the scissor each thread reads its winner's Wq words from
// the row-major (T, Wq) table with 16-byte loads (neighbouring pixels mostly
// share a winner, so the loads hit cache) and stores them channel-major into
// (Wq, H_pad, W_pad), each store coalesced across the warp's 32 pixels of a
// tile row. The words are only ever `int`: packed u8 bytes alias NaN and
// denormal float patterns. B5 is bound by bytes: the output planes
// (Wq * 4 bytes per pixel) dwarf the solve's traffic.
//
// What bounds it on the card: arithmetic and shared-memory bandwidth. Each
// (pixel, row) pair costs ~40 flops; at 1024x768 a frame streams a few
// hundred rows per tile over 768 tiles. Rows are read from device memory
// once per tile that bins them (~100 bytes each), which is small next to the
// per-pixel work.
//
// Design: one CTA per screen tile, one thread per pixel of the tile (1024
// threads for 32x32 tiles). The CTA stages kchunk rows at a time in dynamic
// shared memory with plain cooperative loads, then every thread evaluates
// every staged row (a shared-memory broadcast). The (depth, id) carry and,
// under WANT_E, the winner's e0/e1/e2 stay in registers for the whole
// stream, and the tile writes its pixels straight into the (H_pad, W_pad)
// output planes. What existed only for Mosaic is gone: the 8-row DMA
// alignment with its shift prefetch and masked over-read, the 128-lane row
// padding, the (8, npix) sublane outputs and the two-chunks-per-step slot
// juggling. cp.async/TMA double buffering is left for later work.
//
// Numerics: edge, esum, depth and clip-plane values use explicit
// round-to-nearest multiplies and adds in the reference's order of
// operations (no FMA contraction; the library is also built with
// --fmad=false), so winners, depths and e-values equal the plain torch
// version bit for bit.

#include <cuda_runtime.h>

namespace {

// Packed-row column layout (raster/tiled.py _C_*).
constexpr int kZ = 9;
constexpr int kIvs = 12;
constexpr int kEp = 13;
constexpr int kSs = 16;
constexpr int kFl = 17;
constexpr int kRect = 18;
constexpr int kId = 22;
constexpr int kNcol = 23;

__device__ __forceinline__ float plane3(const float* r, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)), r[2]);
}

template <bool WANT_E, bool FETCH>
__global__ void __launch_bounds__(1024) solve_tiled_kernel(
    const float* __restrict__ rows, int ncol, int n_planes,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ leftn, int gbase, int sbase,
    const float* __restrict__ viewport, float fwidth, float fheight,
    const float* __restrict__ init_d, float* __restrict__ out_d,
    int* __restrict__ out_i, float* __restrict__ out_e,
    const int* __restrict__ shade_tbl, int sh_w, int n_tris,
    int* __restrict__ out_rows, int tile, int tiles_x, int pitch,
    int plane_size, int kchunk) {
  extern __shared__ float sh[];
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  const int tx = t - ty * tiles_x;
  const int lx = threadIdx.x % tile;
  const int ly = threadIdx.x / tile;
  const int gx = tx * tile + lx;
  const int gy = ty * tile + ly;
  const float px = static_cast<float>(gx) + 0.5f;
  const float py = static_cast<float>(gy) + 0.5f;
  const int pix = gy * pitch + gx;

  const float init = init_d[pix];
  float bd = init;
  int bi = -1;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f;

  const int seg_start[3] = {starts[t], gbase, sbase};
  const int seg_count[3] = {counts[t], leftn[0], leftn[1]};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int start = seg_start[s];
    const int count = seg_count[s];
    for (int c0 = 0; c0 < count; c0 += kchunk) {
      const int n = min(kchunk, count - c0);
      __syncthreads();
      const float* src = rows + static_cast<size_t>(start + c0) * ncol;
      for (int i = threadIdx.x; i < n * ncol; i += blockDim.x) sh[i] = src[i];
      __syncthreads();
      for (int r = 0; r < n; ++r) {
        const float* row = sh + r * ncol;
        const float e0 = plane3(row + 0, px, py);
        const float e1 = plane3(row + 3, px, py);
        const float e2 = plane3(row + 6, px, py);
        const int fl = static_cast<int>(row[kFl]);
        bool cov = (e0 > 0.f || ((fl & 1) != 0 && e0 == 0.f)) &&
                   (e1 > 0.f || ((fl & 2) != 0 && e1 == 0.f)) &&
                   (e2 > 0.f || ((fl & 4) != 0 && e2 == 0.f));
        const float esum = __fmul_rn(plane3(row + kEp, px, py), row[kSs]);
        const float depth = __fmul_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(e0, row[kZ]),
                                __fmul_rn(e1, row[kZ + 1])),
                      __fmul_rn(e2, row[kZ + 2])),
            row[kIvs]);
        cov = cov && esum > 0.f && depth >= 0.f && depth <= 1.f &&
              px >= row[kRect] && py >= row[kRect + 1] &&
              px < row[kRect + 2] && py < row[kRect + 3] && (fl & 8) != 0;
        for (int p = 0; p < n_planes && cov; ++p)
          cov = plane3(row + kNcol + 3 * p, px, py) >= 0.f;
        if (!cov) continue;
        const int id = static_cast<int>(row[kId]);
        if (depth < bd || (depth == bd && id > bi)) {
          bd = depth;
          bi = id;
          if (WANT_E) {
            b0 = e0;
            b1 = e1;
            b2 = e2;
          }
        }
      }
    }
  }

  const float vx0 = viewport[0];
  const float vy0 = viewport[1];
  const bool scissor = px >= vx0 && px < __fadd_rn(vx0, viewport[2]) &&
                       py >= vy0 && py < __fadd_rn(vy0, viewport[3]) &&
                       px < fwidth && py < fheight;
  out_d[pix] = scissor ? bd : init;
  out_i[pix] = scissor ? bi : -1;
  if (WANT_E) {
    out_e[pix] = scissor ? b0 : 0.f;
    out_e[plane_size + pix] = scissor ? b1 : 0.f;
    out_e[2 * plane_size + pix] = scissor ? b2 : 0.f;
  }
  if (FETCH) {
    // Winner ids are < n_tris by construction; the bound keeps a corrupt
    // stream from reading outside the table.
    const int id = scissor ? bi : -1;
    const bool hit = id >= 0 && id < n_tris;
    const int4* src = reinterpret_cast<const int4*>(
        shade_tbl + static_cast<size_t>(hit ? id : 0) * sh_w);
    int* dst = out_rows + pix;
    for (int c = 0; c < sh_w; c += 4) {
      int4 v = make_int4(0, 0, 0, 0);
      if (hit) v = __ldg(src + (c >> 2));
      dst[static_cast<size_t>(c) * plane_size] = v.x;
      dst[static_cast<size_t>(c + 1) * plane_size] = v.y;
      dst[static_cast<size_t>(c + 2) * plane_size] = v.z;
      dst[static_cast<size_t>(c + 3) * plane_size] = v.w;
    }
  }
}

template <bool WANT_E, bool FETCH>
cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                   const float* rows, int ncol, int n_planes,
                   const int* starts, const int* counts, const int* leftn,
                   int gbase, int sbase, const float* viewport, int width,
                   int height, const float* init_d, float* out_d, int* out_i,
                   float* out_e, const int* shade_tbl, int sh_w, int n_tris,
                   int* out_rows, int tile, int tiles_x, int pitch,
                   int plane_size, int kchunk) {
  cudaError_t err = cudaFuncSetAttribute(
      solve_tiled_kernel<WANT_E, FETCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  solve_tiled_kernel<WANT_E, FETCH><<<grid, block, smem, s>>>(
      rows, ncol, n_planes, starts, counts, leftn, gbase, sbase, viewport,
      static_cast<float>(width), static_cast<float>(height), init_d, out_d,
      out_i, out_e, shade_tbl, sh_w, n_tris, out_rows, tile, tiles_x, pitch,
      plane_size, kchunk);
  return cudaGetLastError();
}

}  // namespace

// `out_e` null: no e-planes. `shade_tbl` null: B1; else B5, which fetches
// the (n_tris, sh_w) int32 table's winner rows into `out_rows`
// (sh_w, H_pad, W_pad); sh_w must be a multiple of 4 and the table 16-byte
// aligned.
extern "C" int ck_solve_tiled(
    const float* rows, int ncol, int n_planes, const int* starts,
    const int* counts, const int* leftn, int gbase, int sbase,
    const float* viewport, int width, int height, const float* init_d,
    float* out_d, int* out_i, float* out_e, const int* shade_tbl, int sh_w,
    int n_tris, int* out_rows, int tile, int tiles_x, int tiles_y,
    int kchunk, void* stream) {
  const int pitch = tiles_x * tile;
  const int plane_size = pitch * tiles_y * tile;
  const size_t smem = static_cast<size_t>(kchunk) * ncol * sizeof(float);
  const dim3 grid(tiles_x * tiles_y);
  const dim3 block(tile * tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_e = out_e != nullptr;
  const bool fetch = shade_tbl != nullptr;
  if (fetch && ((sh_w & 3) != 0 || out_rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define CK_SOLVE_ARGS                                                        \
  grid, block, smem, s, rows, ncol, n_planes, starts, counts, leftn, gbase,  \
      sbase, viewport, width, height, init_d, out_d, out_i, out_e,           \
      shade_tbl, sh_w, n_tris, out_rows, tile, tiles_x, pitch, plane_size,   \
      kchunk
  cudaError_t err;
  if (fetch)
    err = want_e ? launch<true, true>(CK_SOLVE_ARGS)
                 : launch<false, true>(CK_SOLVE_ARGS);
  else
    err = want_e ? launch<true, false>(CK_SOLVE_ARGS)
                 : launch<false, false>(CK_SOLVE_ARGS);
#undef CK_SOLVE_ARGS
  return static_cast<int>(err);
}
