// Flat opaque depth solve (kernel B2) for Hopper (sm_90a).
//
// Replaces: ckrenderengine_tpu/raster/pallas_reduce.py `_kernel` (entry
// `depth_reduce_pallas`), the Pallas TPU kernel that keeps the (H, W)
// depth/id carry in VMEM while the grid walks 16-triangle chunks.
//
// What it computes: for every pixel, the argmin over ALL T packed triangle
// rows (pack_rows layout, 32 floats per row) of the triangle depth, with the
// reference's LESSEQUAL rule — rows stream in draw order and a covered
// triangle whose depth is <= the carried depth replaces it, so exact ties go
// to the later draw. Coverage: three edge functions under the top-left fill
// rule, esum > 0, 0 <= depth <= 1, the viewport scissor, the valid bit and
// the per-triangle rect (no user clip planes: the frame routes those to the
// tiled solve).
//
// What bounds it on the card: bytes, by the repo's roofline count (chip_smoke
// `roofline`): at config 1 (12 triangles, 256x256) the rows, the planes it
// writes and nothing else, 0.54 MB, 0.00016 ms at 3.35 TB/s; the few pairs
// that pass rect and edges cost less. At that size the launch itself is the
// kernel's time (0.0255 ms on an NVIDIA H100 80GB HBM3 at 700 W). This
// kernel still evaluates every row on every pixel (~30 operations per
// pixel-row, T*H*W in all), which a larger flat frame (up to t*H*W = 2^26)
// would feel.
//
// Design: one thread per pixel, the (depth, id) carry in registers for the
// whole stream (the TPU kernel's VMEM-resident carry). Rows are staged
// through shared memory in chunks of kChunk rows by plain cooperative
// loads; every thread of the block then reads the same row (a shared-memory
// broadcast, no bank conflicts). The frame sends B2 only small frames
// (t*H*W <= 2^26), so nothing is tiled or binned.
//
// Numerics: each edge, esum and depth value is computed with explicit
// round-to-nearest multiplies and adds in the reference's order of
// operations (no FMA contraction), so results equal the plain torch version
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 32;       // floats per packed row (pack_rows layout)
constexpr int kChunk = 128;    // rows staged per shared-memory chunk
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float plane3(const float* r, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)), r[2]);
}

__global__ void reduce_flat_kernel(const float* __restrict__ rows, int t,
                                   const float* __restrict__ view5,
                                   float* __restrict__ best_d,
                                   int* __restrict__ best_i,
                                   int height, int width) {
  __shared__ float sh[kChunk * kRow];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int nthreads = kBlockX * kBlockY;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float vx0 = view5[0];
  const float vy0 = view5[1];
  const bool scissor = px >= vx0 && px < __fadd_rn(vx0, view5[2]) &&
                       py >= vy0 && py < __fadd_rn(vy0, view5[3]);
  float bd = view5[4];
  int bi = -1;

  for (int c0 = 0; c0 < t; c0 += kChunk) {
    const int n = min(kChunk, t - c0);
    __syncthreads();
    const float* src = rows + static_cast<size_t>(c0) * kRow;
    for (int i = tid; i < n * kRow; i += nthreads) sh[i] = src[i];
    __syncthreads();
    if (!scissor) continue;
    for (int r = 0; r < n; ++r) {
      const float* row = sh + r * kRow;
      const float e0 = plane3(row + 0, px, py);
      const float e1 = plane3(row + 3, px, py);
      const float e2 = plane3(row + 6, px, py);
      bool cov = (e0 > 0.f || (e0 == 0.f && row[9] > 0.f)) &&
                 (e1 > 0.f || (e1 == 0.f && row[10] > 0.f)) &&
                 (e2 > 0.f || (e2 == 0.f && row[11] > 0.f));
      const float depth = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(e0, row[12]), __fmul_rn(e1, row[13])),
                    __fmul_rn(e2, row[14])),
          row[15]);
      const float esum = __fmul_rn(plane3(row + 16, px, py), row[19]);
      cov = cov && esum > 0.f && depth >= 0.f && depth <= 1.f &&
            row[20] > 0.f && px >= row[21] && py >= row[22] &&
            px < row[23] && py < row[24];
      if (cov && depth <= bd) {
        bd = depth;
        bi = static_cast<int>(row[25]);
      }
    }
  }
  if (x < width && y < height) {
    best_d[y * width + x] = bd;
    best_i[y * width + x] = bi;
  }
}

}  // namespace

extern "C" int ck_reduce_flat(const float* rows, int t, const float* view5,
                              float* best_d, int* best_i, int height,
                              int width, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  reduce_flat_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, t, view5, best_d, best_i, height, width);
  return static_cast<int>(cudaGetLastError());
}
