// FPN level-routed RoIAlign (pyramid crop-and-resize), 2D bilinear + 3D
// trilinear, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medicaldetectiontoolkit_tpu/ops/
// roi_align_pallas.py::pyramid_roi_align_pallas (launch _pyramid_call, body
// _pyramid_kernel_factory). Same contract: every RoI reads only from its
// assigned pyramid level, and the function includes the per-axis
// (idx0, idx1, lerp) rows on that level's grid (_level_axis_indices there,
// ops/roi_align.py::_level_axis_indices in the port). The kernel takes the
// boxes, the level and batch indices and each level's extents, and computes
// the rows itself, in the float32 steps of ops/roi_align.py::_axis_coords and
// _lerp_weights:
//   scale = ((hi - lo) * S) * (1 / crop);
//   coord = ((lo * S + i * scale) + scale * 0.5) - 0.5, or for crop 1
//   (0.5 * (lo + hi)) * S; clamped to [0, S - 1];
//   idx0 = floor(coord), lerp = coord - idx0, idx1 = min(idx0 + 1, S - 1).
// The product with the float32 reciprocal of crop, and not a division, is
// what PyTorch computes on the card: ATen's CUDA true division of a tensor by
// a Python number multiplies by the number's reciprocal (div_true_kernel_cuda,
// "compute a * reciprocal(b)"), while the CPU, and JAX, divide. For crop 7 the
// two differ in the last bit for about half of all float32 inputs; the kernel
// is held bit for bit against the plain version on the card, so it copies the
// card's form (tools/time_roi_align.py probes it: on an H100 with torch
// 2.11, every float32 value where the two forms differ came out as the
// product; its division-adversarial cases are bit-identical). Every step is
// an explicit _rn intrinsic and the build passes -fmad=false: no
// multiply-add is contracted.
//
// A level index outside [0, n_levels) yields zeros, as the plain version's
// masked sum over the levels does (JAX's P6 override can produce one).
//
// Design: one block of 256 threads per RoI, in a loop over the RoIs with 4
// blocks on each of the 132 SMs; each RoI fetches the next one's level,
// batch element and box while it works.
//  1. Warp a computes axis a's rows, one lane per output cell, and reduces
//     the smallest idx0 and the largest idx1 of the axis. If that range holds
//     at most 2 * crop indices, the axis's slab slots are the range;
//     otherwise they are the 2 * crop corner indices themselves. A table maps
//     each slot to its in-plane element offset (index * stride).
//  2. The block copies the RoI's slab, slots_y x slots_x x slots_z per
//     channel, for as many channels as fit in 40 KB of shared memory (all 36
//     at the LIDC shapes), from the channel-first map (read in place through
//     its strides, any layout), converting bf16 and f16 to float32. Threads
//     walk the slab in slot order with z fastest, kLoadBatch loads in flight
//     each before their stores, so a warp's loads fall on a few map rows and
//     each line of the map is fetched once per block.
//  3. A thread per output column (c, oy, ox) loads its y and x rows once and
//     evaluates the column's cz outputs from the slab, each as
//     lerp_z(lerp_x(lerp_y(corners))): for each z corner, y at the two x
//     corners, then x; then z. That is the plain version's association
//     (ops/roi_align.py, roi_align.py:89-95 and :110-127 in JAX) on the same
//     operands, so the output is bit-identical. The z loop is unrolled for
//     cz = 3 (the classifier's crop). A column's outputs are contiguous in
//     out and a warp's 32 columns one contiguous run, written float by
//     float (a 16-byte store would need 4 outputs of one column).
// The slab and column walks advance by fixed strides with carries: no
// division per element.
//
// What bounds it (NVIDIA H100, 700 W; tools/time_roi_align.py): the
// evaluation, 8 shared loads and 21 float operations per output, then the
// slab copy's gather (runs of 12-24 bytes scattered over device memory) and
// the three barriers per RoI: 0.022 ms at 600 RoIs to (7,7,3) x 36, 0.107
// at 4,000, about 4 times the bound. The whole-card bound is the float32
// output written once (12.7 MB per 600-RoI call: 3.8 us at 3.35 TB/s) plus
// the map voxels the corners touch. The previous design (one thread per
// output, rows from global memory, 0.047 and 0.285 ms) was, by a count of
// its accesses, bound by L1 lookups: a warp's 32 outputs span about 11 map
// rows, and each of its 8 corner loads touched as many lines.
//
// The same source holds K2's backward (pyramid_roi_align_bwd_kernel below):
// the scatter-add into the maps that JAX takes from the VJP of the plain
// form (roi_align_pallas.py:269-285), with float32 atomics, so its sums are
// not deterministic in their last bits.
//
// Limits (the wrapper checks them): each crop axis at most kMaxCrop; the
// slab of one channel at its largest (2 crop slots per axis, the innermost
// padded to an odd count) at most kSlabFloats; each level's largest in-plane
// offset below 2^31; the output below kMaxOutputs elements.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// one pyramid level as the wrapper passes it (ctypes mirror in
// ops/roi_align_cuda.py::_Level)
struct Level {
  const void* data;
  long long sb, sc;  // element strides of B and C
  int size[3];       // extents (H, W, (Z)); Z = 1 in 2D
  int stride[3];     // element strides of (H, W, (Z)); 0 where the extent is 1
};

// one level of the backward's float32 gradient buffer (ctypes mirror in
// ops/roi_align_cuda.py::_BwdLevel); outside the unnamed namespace, as
// Level, so that the extern "C" entry points that take them are exported
struct BwdLevel {
  long long offset;  // first element of the level's gradient in the buffer
  int size[3];       // extents (H, W, (Z)); Z = 1 in 2D
};

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kSms = 132;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxCrop = 64;
constexpr int kSlabFloats = 10240;  // 40 KB of dynamic shared memory
constexpr int kLoadBatch = 8;       // slab loads in flight per thread
constexpr long long kMaxOutputs = 1LL << 30;  // 32-bit output indices

struct Levels {
  Level l[kMaxLevels];
};

__device__ __forceinline__ float load(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float load(const __half* p, long long i) { return __half2float(p[i]); }

// cell i of n on an axis of extent S: floor and +1-clamped indices and the
// lerp weight, in the float32 steps of the note above
__device__ __forceinline__ void axis_row(float lo, float hi, int n, int i, int S, int& i0, int& i1, float& w) {
  const float Sf = static_cast<float>(S);
  float coord;
  if (n > 1) {
    const float scale = __fmul_rn(__fmul_rn(__fsub_rn(hi, lo), Sf), __frcp_rn(static_cast<float>(n)));
    coord = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(lo, Sf), __fmul_rn(static_cast<float>(i), scale)), __fmul_rn(scale, 0.5f)),
        0.5f);
  } else {
    coord = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(lo, hi)), Sf);
  }
  coord = fminf(fmaxf(coord, 0.0f), Sf - 1.0f);
  const float f = floorf(coord);
  i0 = static_cast<int>(f);
  i1 = min(i0 + 1, S - 1);
  w = __fsub_rn(coord, f);
}

// a * (1 - w) + b * w as PyTorch's separate multiplies and add round it
__device__ __forceinline__ float lerp(float a, float b, int4 e) {
  return __fadd_rn(__fmul_rn(a, __int_as_float(e.w)), __fmul_rn(b, __int_as_float(e.z)));
}

// a position in a walk over (c, y, x, z), z fastest, and a fixed stride
// decomposed in the same radix; advance() adds the stride with carries
struct Walk {
  int c, y, x, z;
};

__device__ __forceinline__ Walk decompose(int i, int ny, int nx, int nz) {
  Walk w;
  w.z = i % nz;
  i /= nz;
  w.x = i % nx;
  i /= nx;
  w.y = i % ny;
  w.c = i / ny;
  return w;
}

__device__ __forceinline__ void advance(Walk& w, const Walk& d, int ny, int nx, int nz) {
  w.z += d.z;
  int k = w.z >= nz;
  w.z -= k ? nz : 0;
  w.x += d.x + k;
  k = w.x >= nx;
  w.x -= k ? nx : 0;
  w.y += d.y + k;
  k = w.y >= ny;
  w.y -= k ? ny : 0;
  w.c += d.c + k;
}

// CZ: the z crop as a compile-time count (3), or 0 for cz at run time
template <typename T, int DIM, int CZ>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) pyramid_roi_align_kernel(
    const __grid_constant__ Levels lv, const float* __restrict__ boxes, const int* __restrict__ box_idx,
    const int* __restrict__ level_idx, int n_levels, int n_rois, int channels, int ch, int cw, int cz,
    float* __restrict__ out) {
  extern __shared__ float slab[];
  // per axis and output cell: slab offsets of idx0 and idx1, lerp, 1 - lerp
  __shared__ int4 rows[3][kMaxCrop];
  __shared__ int table[3][2 * kMaxCrop];  // slab slot -> in-plane element offset
  __shared__ int n_slots[3];

  const int crop[3] = {ch, cw, cz};
  const int P = ch * cw * cz;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the output walk over columns (c, oy, ox): kThreads columns apart
  const Walk col_start = decompose(tid, ch, cw, 1);
  const Walk col_step = decompose(kThreads, ch, cw, 1);
  // the block's first RoI's level, batch element and (warps < DIM) box
  // edges; each RoI then fetches the next one's while it works
  const int ax_lo = warp == 2 ? 4 : warp, ax_hi = warp == 2 ? 5 : warp + 2;
  int next_level = 0, next_b = 0;
  float next_lo = 0.0f, next_hi = 0.0f;
  if (blockIdx.x < n_rois) {
    next_level = level_idx[blockIdx.x];
    next_b = box_idx[blockIdx.x];
    if (warp < DIM) {
      next_lo = boxes[blockIdx.x * 2 * DIM + ax_lo];
      next_hi = boxes[blockIdx.x * 2 * DIM + ax_hi];
    }
  }

  for (int r = blockIdx.x; r < n_rois; r += gridDim.x) {
    const int level = next_level, b = next_b;
    const float lo = next_lo, hi = next_hi;
    if (r + gridDim.x < n_rois) {
      const int rn = r + gridDim.x;
      next_level = level_idx[rn];
      next_b = box_idx[rn];
      if (warp < DIM) {
        next_lo = boxes[rn * 2 * DIM + ax_lo];
        next_hi = boxes[rn * 2 * DIM + ax_hi];
      }
    }
    float* const out_r = out + r * channels * P;
    if (level < 0 || level >= n_levels) {  // no level: zeros, as the plain version's masked sum
      for (int j = tid; j < channels * P; j += kThreads) out_r[j] = 0.0f;
      continue;
    }
    const Level& L = lv.l[level];

    // 1. rows: warp a computes axis a (columns (y1, x1, y2, x2, z1, z2))
    if (warp < DIM) {
      const int a = warp, n = crop[a], S = L.size[a];
      int lo_idx = INT_MAX, hi_idx = INT_MIN;
      for (int i = lane; i < n; i += 32) {
        int i0, i1;
        float w;
        axis_row(lo, hi, n, i, S, i0, i1, w);
        rows[a][i] = make_int4(i0, i1, __float_as_int(w), __float_as_int(__fsub_rn(1.0f, w)));
        lo_idx = min(lo_idx, i0);
        hi_idx = max(hi_idx, i1);
      }
      lo_idx = __reduce_min_sync(0xffffffffu, lo_idx);
      hi_idx = __reduce_max_sync(0xffffffffu, hi_idx);
      const bool range = hi_idx - lo_idx + 1 <= 2 * n;
      const int stride = L.stride[a];
      for (int i = lane; i < n; i += 32) {  // the lane's own cells: no barrier needed
        int4 e = rows[a][i];
        if (range) {
          e.x -= lo_idx;
          e.y -= lo_idx;
        } else {
          table[a][2 * i] = e.x * stride;
          table[a][2 * i + 1] = e.y * stride;
          e.x = 2 * i;
          e.y = 2 * i + 1;
        }
        rows[a][i] = e;
      }
      if (range) {
        for (int s = lane; s <= hi_idx - lo_idx; s += 32) table[a][s] = (lo_idx + s) * stride;
      }
      if (lane == 0) n_slots[a] = range ? hi_idx - lo_idx + 1 : 2 * n;
    }
    __syncthreads();

    // slab layout (c, y slot, x slot, z slot); the innermost count padded to
    // an odd number, so that neighbouring outer slots fall on other banks
    const int ny = n_slots[0];
    const int nx = n_slots[1];
    const int nz = DIM == 3 ? n_slots[2] : 1;
    const int x_pitch = DIM == 3 ? (nz | 1) : 1;
    const int y_pitch = DIM == 3 ? nx * x_pitch : (nx | 1);
    const int c_pitch = ny * y_pitch;
    const int group = min(channels, kSlabFloats / c_pitch);
    // row slots -> slab offsets (read after the slab barrier below)
    if (tid < ch + cw + (DIM == 3 ? cz : 0)) {
      const int a = tid < ch ? 0 : (tid < ch + cw ? 1 : 2);
      const int i = tid - (a == 0 ? 0 : (a == 1 ? ch : ch + cw));
      const int pitch = a == 0 ? y_pitch : (a == 1 ? x_pitch : 1);
      rows[a][i].x *= pitch;
      rows[a][i].y *= pitch;
    }
    const T* const map = static_cast<const T*>(L.data) + b * L.sb;
    const Walk load_step = decompose(kThreads, ny, nx, nz);

    for (int c0 = 0; c0 < channels; c0 += group) {
      const int g = min(group, channels - c0);
      // 2. the slab of channels c0 .. c0 + g - 1, kLoadBatch loads in flight
      // per thread before their stores
      for (Walk s = decompose(tid, ny, nx, nz); s.c < g;) {
        float v[kLoadBatch];
        int dst[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          dst[u] = -1;
          if (s.c < g) {
            const long long off = (c0 + s.c) * L.sc + table[0][s.y] + table[1][s.x] + (DIM == 3 ? table[2][s.z] : 0);
            v[u] = load(map, off);
            dst[u] = s.c * c_pitch + s.y * y_pitch + s.x * x_pitch + s.z;
          }
          advance(s, load_step, ny, nx, nz);
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          if (dst[u] >= 0) slab[dst[u]] = v[u];
        }
      }
      __syncthreads();

      // 3. outputs c0 * P .. (c0 + g) * P of the RoI: a thread per column
      // (c, oy, ox), its cz outputs along z. Column j's outputs are
      // out_g[j * cz .. j * cz + cz), so a warp writes one contiguous run
      float* const out_g = out_r + c0 * P;
      Walk o = col_start;
      for (int j = tid; j < g * ch * cw; j += kThreads, advance(o, col_step, ch, cw, 1)) {
        const int4 ey = rows[0][o.y], ex = rows[1][o.x];
        const float* sl = slab + o.c * c_pitch;
        const int a00 = ey.x + ex.x, a10 = ey.y + ex.x, a01 = ey.x + ex.y, a11 = ey.y + ex.y;
        if (DIM == 2) {
          out_g[j] = lerp(lerp(sl[a00], sl[a10], ey), lerp(sl[a01], sl[a11], ey), ex);
          continue;
        }
        float* const col_out = out_g + j * cz;
#pragma unroll 4
        for (int oz = 0; oz < (CZ ? CZ : cz); ++oz) {
          const int4 ez = rows[2][oz];  // one address for the whole warp
          const float* z0 = sl + ez.x;
          const float* z1 = sl + ez.y;
          const float col0 = lerp(lerp(z0[a00], z0[a10], ey), lerp(z0[a01], z0[a11], ey), ex);
          const float col1 = lerp(lerp(z1[a00], z1[a10], ey), lerp(z1[a01], z1[a11], ey), ex);
          col_out[oz] = lerp(col0, col1, ez);
        }
      }
      __syncthreads();  // the slab and rows are read no more
    }
  }
}

template <typename T>
cudaError_t launch(const Levels& lv, int n_levels, int dim, const float* boxes, const int* box_idx,
                   const int* level_idx, int n_rois, int channels, int ch, int cw, int cz, float* out,
                   cudaStream_t s) {
  const int blocks = n_rois < kSms * kBlocksPerSm ? n_rois : kSms * kBlocksPerSm;
  const size_t smem = kSlabFloats * sizeof(float);
  if (dim == 2) {
    pyramid_roi_align_kernel<T, 2, 1><<<blocks, kThreads, smem, s>>>(lv, boxes, box_idx, level_idx, n_levels,
                                                                     n_rois, channels, ch, cw, 1, out);
  } else if (cz == 3) {
    pyramid_roi_align_kernel<T, 3, 3><<<blocks, kThreads, smem, s>>>(lv, boxes, box_idx, level_idx, n_levels,
                                                                     n_rois, channels, ch, cw, cz, out);
  } else {
    pyramid_roi_align_kernel<T, 3, 0><<<blocks, kThreads, smem, s>>>(lv, boxes, box_idx, level_idx, n_levels,
                                                                     n_rois, channels, ch, cw, cz, out);
  }
  return cudaGetLastError();
}

// The backward (K2's gradient to the maps): one thread per element of
// grad_out (R, C, *crop). The thread recomputes its cell's rows on the RoI's
// level with axis_row, as the forward does, and atomically adds g times the
// product of its lerp weights into each of the 2^DIM corners of the level's
// float32 gradient (B, C, H, W, (Z)), contiguous. The weights multiply in
// the order of the plain version's pullback: g * (1 - wz) or g * wz first,
// then the x weight, then the y weight. A level index outside
// [0, n_levels) adds nothing.
struct BwdLevels {
  BwdLevel l[kMaxLevels];
};

constexpr int kBwdThreads = 256;

template <int DIM>
__global__ void __launch_bounds__(kBwdThreads) pyramid_roi_align_bwd_kernel(
    const __grid_constant__ BwdLevels lv, const float* __restrict__ boxes, const int* __restrict__ box_idx,
    const int* __restrict__ level_idx, int n_levels, int n_elems, int channels, int ch, int cw, int cz,
    const float* __restrict__ grad_out, float* __restrict__ grad_maps) {
  const int e = blockIdx.x * kBwdThreads + threadIdx.x;
  if (e >= n_elems) return;
  // (r, c, oy, ox, oz), oz fastest
  int rest = e;
  const int oz = DIM == 3 ? rest % cz : 0;
  if (DIM == 3) rest /= cz;
  const int ox = rest % cw;
  rest /= cw;
  const int oy = rest % ch;
  rest /= ch;
  const int c = rest % channels;
  const int r = rest / channels;
  const int level = __ldg(level_idx + r);
  if (level < 0 || level >= n_levels) return;
  const float g = __ldg(grad_out + e);
  const BwdLevel& L = lv.l[level];
  const float* box = boxes + r * 2 * DIM;
  int y0, y1, x0, x1, z0 = 0, z1 = 0;
  float wy, wx, wz = 0.0f;
  axis_row(__ldg(box + 0), __ldg(box + 2), ch, oy, L.size[0], y0, y1, wy);
  axis_row(__ldg(box + 1), __ldg(box + 3), cw, ox, L.size[1], x0, x1, wx);
  if (DIM == 3) axis_row(__ldg(box + 4), __ldg(box + 5), cz, oz, L.size[2], z0, z1, wz);
  const int nz = L.size[2];
  const long long plane = static_cast<long long>(L.size[0]) * L.size[1] * nz;
  float* const base = grad_maps + L.offset + (static_cast<long long>(__ldg(box_idx + r)) * channels + c) * plane;
  const int ry0 = y0 * L.size[1], ry1 = y1 * L.size[1];
  const float vy[2] = {__fsub_rn(1.0f, wy), wy};
  const float vx[2] = {__fsub_rn(1.0f, wx), wx};
  const int ry[2] = {ry0, ry1};
  const int rx[2] = {x0, x1};
  if (DIM == 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float gx = __fmul_rn(g, vx[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) atomicAdd(base + ry[i] + rx[j], __fmul_rn(gx, vy[i]));
    }
    return;
  }
  const float vz[2] = {__fsub_rn(1.0f, wz), wz};
  const int rz[2] = {z0, z1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float gz = __fmul_rn(g, vz[k]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float gzx = __fmul_rn(gz, vx[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        atomicAdd(base + static_cast<long long>(ry[i] + rx[j]) * nz + rz[k], __fmul_rn(gzx, vy[i]));
      }
    }
  }
}

}  // namespace

// levels: host array of n_levels Level descriptors; dtype 0 float32,
// 1 bfloat16, 2 float16; boxes (n_rois, 2 * dim) float32; box_idx and
// level_idx (n_rois,) int32; out (n_rois, channels, ch, cw, (cz)) float32.
// cz is ignored in 2D.
extern "C" int mdt_roi_align_launch(const Level* levels, int n_levels, int dtype, int dim, const float* boxes,
                                    const int* box_idx, const int* level_idx, int n_rois, int channels, int ch,
                                    int cw, int cz, float* out, void* stream) {
  if (dim == 2) cz = 1;
  const long long slab = 2LL * ch * (dim == 3 ? 2LL * cw * (2 * cz + 1) : 2 * cw + 1);
  if (n_levels < 1 || n_levels > kMaxLevels || (dim != 2 && dim != 3) || n_rois < 1 || channels < 1 || ch < 1 ||
      cw < 1 || cz < 1 || ch > kMaxCrop || cw > kMaxCrop || cz > kMaxCrop || slab > kSlabFloats ||
      static_cast<long long>(n_rois) * channels * ch * cw * cz >= kMaxOutputs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  for (int k = 0; k < n_levels; ++k) lv.l[k] = levels[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(lv, n_levels, dim, boxes, box_idx, level_idx, n_rois, channels, ch, cw, cz, out, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(lv, n_levels, dim, boxes, box_idx, level_idx, n_rois, channels, ch, cw, cz, out, s);
      break;
    case 2:
      err = launch<__half>(lv, n_levels, dim, boxes, box_idx, level_idx, n_rois, channels, ch, cw, cz, out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* mdt_roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The backward. levels: host array of n_levels BwdLevel descriptors into
// grad_maps, a float32 buffer of grad_elems elements that this call zeroes
// and then fills; boxes, box_idx, level_idx as the forward's; grad_out
// (n_rois, channels, ch, cw, (cz)) float32, contiguous. cz is ignored in 2D.
extern "C" int mdt_roi_align_bwd_launch(const BwdLevel* levels, int n_levels, int dim, const float* boxes,
                                        const int* box_idx, const int* level_idx, int n_rois, int channels, int ch,
                                        int cw, int cz, const float* grad_out, float* grad_maps,
                                        long long grad_elems, void* stream) {
  if (dim == 2) cz = 1;
  const long long n_elems = static_cast<long long>(n_rois) * channels * ch * cw * cz;
  if (n_levels < 1 || n_levels > kMaxLevels || (dim != 2 && dim != 3) || n_rois < 0 || channels < 1 || ch < 1 ||
      cw < 1 || cz < 1 || grad_elems < 1 || n_elems >= kMaxOutputs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdLevels lv = {};
  for (int k = 0; k < n_levels; ++k) lv.l[k] = levels[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(grad_maps, 0, grad_elems * sizeof(float), s);
  if (err != cudaSuccess || n_elems == 0) return static_cast<int>(err);
  const int blocks = static_cast<int>((n_elems + kBwdThreads - 1) / kBwdThreads);
  const int n = static_cast<int>(n_elems);
  if (dim == 2) {
    pyramid_roi_align_bwd_kernel<2><<<blocks, kBwdThreads, 0, s>>>(lv, boxes, box_idx, level_idx, n_levels, n,
                                                                   channels, ch, cw, 1, grad_out, grad_maps);
  } else {
    pyramid_roi_align_bwd_kernel<3><<<blocks, kBwdThreads, 0, s>>>(lv, boxes, box_idx, level_idx, n_levels, n,
                                                                   channels, ch, cw, cz, grad_out, grad_maps);
  }
  return static_cast<int>(cudaGetLastError());
}
