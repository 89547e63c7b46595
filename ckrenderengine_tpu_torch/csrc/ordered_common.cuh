// Shared by the ordered kernels B3 (ordered_blend.cu) and B4
// (ordered_peel.cu): the ordered-row column layout of
// raster/cuda_ordered.py (_OC_*) and the per-pixel coverage of one
// draw-ordered row.
//
// Numerics: every edge, esum, depth and clip-plane value is an explicit
// round-to-nearest multiply or add in the reference's order of operations
// (the library also builds with --fmad=false), so coverage and the raw edge
// values equal the plain torch versions bit for bit.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace ck_ordered {

constexpr int kZ = 9;       // corner clip z (3)
constexpr int kIvs = 12;    // signed inverse determinant
constexpr int kEp = 13;     // esum plane (3)
constexpr int kSs = 16;     // sign s
constexpr int kFl = 17;     // top-left bits 1|2|4, valid bit 8
constexpr int kRect = 18;   // per-triangle scissor (4)
constexpr int kCol = 22;    // corner RGBA x3, corner-major
constexpr int kSpc = 34;    // corner spec RGB x3
constexpr int kFog = 43;    // corner fog factors
constexpr int kBits = 46;   // blend | fog<<1 | colorwrite<<2 | persp<<3 | at<<4
constexpr int kZf = 47;     // z compare func
constexpr int kAf = 48;     // alpha compare func
constexpr int kAref = 49;   // alpha ref
constexpr int kWs = 50;     // corner w (3)
constexpr int kId = 53;     // draw index
constexpr int kNcol = 54;   // + 3 per user clip plane

// D3D compare codes (raster/types.py VXCMP).
constexpr int kNever = 1;
constexpr int kLess = 2;
constexpr int kEqual = 3;
constexpr int kLessEqual = 4;
constexpr int kGreater = 5;
constexpr int kNotEqual = 6;
constexpr int kGreaterEqual = 7;

__device__ __forceinline__ float plane3(const float* r, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)), r[2]);
}

// D3D compare of incoming a against stored b; ALWAYS and unknown codes pass.
__device__ __forceinline__ bool compare(int func, float a, float b) {
  switch (func) {
    case kNever: return false;
    case kLess: return a < b;
    case kEqual: return a == b;
    case kLessEqual: return a <= b;
    case kGreater: return a > b;
    case kNotEqual: return a != b;
    case kGreaterEqual: return a >= b;
    default: return true;
  }
}

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

struct Pixel {
  float px, py;   // pixel centre
  float zb;       // opaque depth
  int zbits;      // its bit pattern
  bool scissor;   // viewport and framebuffer bounds
};

// Coverage of `row` at pixel p: the three edges under the top-left rule,
// esum > 0, 0 <= depth <= 1, the per-triangle rect, every user clip plane,
// the valid bit, the scissor, the z test against the opaque plane (the
// 2-ULP bit window on the equality-inclusive compares, in wrapping int32
// arithmetic like the reference) and colorwrite. No alpha test. Writes the
// raw edge values.
__device__ __forceinline__ bool covers(const float* row, int n_planes,
                                       const Pixel& p, float& e0, float& e1,
                                       float& e2) {
  e0 = plane3(row + 0, p.px, p.py);
  e1 = plane3(row + 3, p.px, p.py);
  e2 = plane3(row + 6, p.px, p.py);
  const int fl = static_cast<int>(row[kFl]);
  bool cov = (e0 > 0.f || ((fl & 1) != 0 && e0 == 0.f)) &&
             (e1 > 0.f || ((fl & 2) != 0 && e1 == 0.f)) &&
             (e2 > 0.f || ((fl & 4) != 0 && e2 == 0.f));
  const float esum_p = __fmul_rn(plane3(row + kEp, p.px, p.py), row[kSs]);
  const float depth = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(e0, row[kZ]), __fmul_rn(e1, row[kZ + 1])),
                __fmul_rn(e2, row[kZ + 2])),
      row[kIvs]);
  cov = cov && esum_p > 0.f && depth >= 0.f && depth <= 1.f &&
        p.px >= row[kRect] && p.py >= row[kRect + 1] &&
        p.px < row[kRect + 2] && p.py < row[kRect + 3] && (fl & 8) != 0 &&
        p.scissor;
  for (int q = 0; q < n_planes && cov; ++q)
    cov = plane3(row + kNcol + 3 * q, p.px, p.py) >= 0.f;
  if (!cov) return false;
  const int zf = static_cast<int>(row[kZf]);
  const int d = static_cast<int>(static_cast<unsigned>(__float_as_int(depth)) -
                                 static_cast<unsigned>(p.zbits));
  const bool near = (d >= -2 && d <= 2) || d == INT_MIN;
  const bool eq_incl = zf == kLessEqual || zf == kEqual || zf == kGreaterEqual;
  if (!(compare(zf, depth, p.zb) || (eq_incl && near))) return false;
  return (static_cast<int>(row[kBits]) & 4) != 0;
}

// The tile's pixel of this thread and its fixed per-pixel state.
__device__ __forceinline__ Pixel tile_pixel(const float* params,
                                            const float* zplane, int tile,
                                            int tiles_x, int pitch, int& pix) {
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  const int tx = t - ty * tiles_x;
  const int gx = tx * tile + static_cast<int>(threadIdx.x) % tile;
  const int gy = ty * tile + static_cast<int>(threadIdx.x) / tile;
  pix = gy * pitch + gx;
  Pixel p;
  p.px = static_cast<float>(gx) + 0.5f;
  p.py = static_cast<float>(gy) + 0.5f;
  p.zb = zplane[pix];
  p.zbits = __float_as_int(p.zb);
  const float vx0 = params[0];
  const float vy0 = params[1];
  p.scissor = p.px >= vx0 && p.px < __fadd_rn(vx0, params[2]) &&
              p.py >= vy0 && p.py < __fadd_rn(vy0, params[3]) &&
              p.px < params[4] && p.py < params[5];
  return p;
}

// Stage rows [start + c0, start + c0 + n) into shared memory.
__device__ __forceinline__ void stage(float* sh, const float* rows, int ncol,
                                      int first, int n) {
  __syncthreads();
  const float* src = rows + static_cast<size_t>(first) * ncol;
  for (int i = threadIdx.x; i < n * ncol; i += blockDim.x) sh[i] = src[i];
  __syncthreads();
}

// Set the kernel's dynamic shared memory limit and launch geometry.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, int kchunk, int ncol,
                           size_t* smem) {
  *smem = static_cast<size_t>(kchunk) * ncol * sizeof(float);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace ck_ordered
