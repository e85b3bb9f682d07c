// FPN level-routed RoIAlign (pyramid crop-and-resize), 2D bilinear + 3D
// trilinear, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medicaldetectiontoolkit_tpu/ops/
// roi_align_pallas.py::pyramid_roi_align_pallas (launch _pyramid_call, body
// _pyramid_kernel_factory). Same contract: every RoI reads only from its
// assigned pyramid level; the per-axis (idx0, idx1, lerp) rows on that
// level's grid come from the wrapper, computed by the same PyTorch helper as
// the plain version (ops/roi_align.py::_level_axis_indices), so both see the
// same indices and weights.
//
// A level index outside [0, n_levels) yields zeros, as the plain version's
// masked sum over the levels does (JAX's P6 override can produce one).
//
// Design: one thread per output element of (R, C, ch, cw, (cz)), the layout
// the classifier and mask convs take, in a grid-stride loop. A thread reads
// its RoI's level, batch element and axis rows, gathers the 4 (2D) or 8 (3D)
// corners straight from that level's channel-first map (a pointer, extents
// and element strides per level, passed by value as a __grid_constant__
// struct: no stacked or channels-last copy of the pyramid), converts bf16 and
// f16 on load, and lerps y, then x, then z: the association of the plain
// version (ops/roi_align.py, roi_align.py:89-95 and :110-127 in JAX). Built
// with -fmad=false, each a*(1-l) + b*l rounds as PyTorch's separate mul,
// mul and add do, so the output is bit-identical to the plain version.
// Neighbouring threads take neighbouring z (then x) cells of one channel, so
// a warp's loads fall on a few short runs of one map row.
//
// What bounds it: device-memory traffic. At the classify-all shape (600 RoIs
// per call, crop 7x7x3, 36 channels) it writes 18 MB and reads at most 8
// corners per output, most of them from L2 because the corners of
// neighbouring cells overlap; the plain version instead materialises
// (R, ch, W_l, Z_l, C) row tensors for every level (about 1.2 GB each at P2
// per 600 RoIs). Each thread decomposes its output index with 32-bit
// divisions and loads its RoI's 11 index and weight values itself; one block
// per RoI with those rows in shared memory is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// one pyramid level as the wrapper passes it (ctypes mirror in
// ops/roi_align_cuda.py::_Level)
struct Level {
  const void* data;
  long long sb, sc, sy, sx, sz;  // element strides of (B, C, H, W, (Z))
};

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr long long kMaxOutputs = 1LL << 30;  // 32-bit indexing with room for the grid stride

struct Levels {
  Level l[kMaxLevels];
};

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float load(const __half* p, long long i) { return __half2float(p[i]); }

__device__ __forceinline__ float lerp(float a, float b, float w) { return a * (1.0f - w) + b * w; }

template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads) pyramid_roi_align_kernel(
    const __grid_constant__ Levels lv, const int* __restrict__ level_idx, const int* __restrict__ box_idx,
    const int* __restrict__ y0, const int* __restrict__ y1, const float* __restrict__ ly,
    const int* __restrict__ x0, const int* __restrict__ x1, const float* __restrict__ lx,
    const int* __restrict__ z0, const int* __restrict__ z1, const float* __restrict__ lz,
    int n_levels, int n_rois, int channels, int ch, int cw, int cz, float* __restrict__ out) {
  // 32-bit index arithmetic: the launcher caps the output below 2**30
  // elements (64-bit division is emulated in many instructions)
  const int total = n_rois * channels * ch * cw * cz;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    int t = i;
    const int oz = t % cz;
    t /= cz;
    const int ox = t % cw;
    t /= cw;
    const int oy = t % ch;
    t /= ch;
    const int c = t % channels;
    const int r = t / channels;

    const int level = level_idx[r];
    if (level < 0 || level >= n_levels) {  // no level: zeros, as the plain version's masked sum
      out[i] = 0.0f;
      continue;
    }
    const Level& L = lv.l[level];
    const T* base = static_cast<const T*>(L.data) + box_idx[r] * L.sb + static_cast<long long>(c) * L.sc;
    const int ry = r * ch + oy;
    const int rx = r * cw + ox;
    const long long oy0 = y0[ry] * L.sy, oy1 = y1[ry] * L.sy;
    const long long ox0 = x0[rx] * L.sx, ox1 = x1[rx] * L.sx;
    const float wy = ly[ry], wx = lx[rx];
    if (DIM == 2) {
      const float c0 = lerp(load(base, oy0 + ox0), load(base, oy1 + ox0), wy);
      const float c1 = lerp(load(base, oy0 + ox1), load(base, oy1 + ox1), wy);
      out[i] = lerp(c0, c1, wx);
    } else {
      const int rz = r * cz + oz;
      const long long oz0 = z0[rz] * L.sz, oz1 = z1[rz] * L.sz;
      const float wz = lz[rz];
      float col[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long long zo = k ? oz1 : oz0;
        const float c0 = lerp(load(base, oy0 + ox0 + zo), load(base, oy1 + ox0 + zo), wy);
        const float c1 = lerp(load(base, oy0 + ox1 + zo), load(base, oy1 + ox1 + zo), wy);
        col[k] = lerp(c0, c1, wx);
      }
      out[i] = lerp(col[0], col[1], wz);
    }
  }
}

template <typename T>
cudaError_t launch(const Levels& lv, int n_levels, int dim, const int* level_idx, const int* box_idx, const int* y0,
                   const int* y1, const float* ly, const int* x0, const int* x1, const float* lx,
                   const int* z0, const int* z1, const float* lz, int n_rois, int channels, int ch, int cw,
                   int cz, float* out, cudaStream_t s) {
  const long long total = static_cast<long long>(n_rois) * channels * ch * cw * cz;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132LL * 64 ? want : 132LL * 64);
  if (dim == 2) {
    pyramid_roi_align_kernel<T, 2><<<blocks, kThreads, 0, s>>>(
        lv, level_idx, box_idx, y0, y1, ly, x0, x1, lx, z0, z1, lz, n_levels, n_rois, channels, ch, cw, 1, out);
  } else {
    pyramid_roi_align_kernel<T, 3><<<blocks, kThreads, 0, s>>>(
        lv, level_idx, box_idx, y0, y1, ly, x0, x1, lx, z0, z1, lz, n_levels, n_rois, channels, ch, cw, cz, out);
  }
  return cudaGetLastError();
}

}  // namespace

// levels: host array of n_levels Level descriptors; dtype 0 float32,
// 1 bfloat16, 2 float16. z0/z1/lz are ignored (may be null) in 2D.
extern "C" int mdt_roi_align_launch(const Level* levels, int n_levels, int dtype, int dim,
                                    const int* level_idx, const int* box_idx, const int* y0, const int* y1,
                                    const float* ly, const int* x0, const int* x1, const float* lx,
                                    const int* z0, const int* z1, const float* lz, int n_rois, int channels,
                                    int ch, int cw, int cz, float* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || (dim != 2 && dim != 3) || n_rois < 1 || channels < 1 ||
      ch < 1 || cw < 1 || cz < 1 ||
      static_cast<long long>(n_rois) * channels * ch * cw * cz >= kMaxOutputs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  for (int k = 0; k < n_levels; ++k) lv.l[k] = levels[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(lv, n_levels, dim, level_idx, box_idx, y0, y1, ly, x0, x1, lx, z0, z1, lz, n_rois, channels,
                          ch, cw, cz, out, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(lv, n_levels, dim, level_idx, box_idx, y0, y1, ly, x0, x1, lx, z0, z1, lz, n_rois,
                                  channels, ch, cw, cz, out, s);
      break;
    case 2:
      err = launch<__half>(lv, n_levels, dim, level_idx, box_idx, y0, y1, ly, x0, x1, lx, z0, z1, lz, n_rois, channels,
                           ch, cw, cz, out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mdt_roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
