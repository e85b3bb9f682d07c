// Batched fixed-shape greedy NMS (2D + 3D) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medicaldetectiontoolkit_tpu/ops/nms_pallas.py
// ::nms_pallas (kernel body _nms_kernel_factory). Same contract: one lane per
// (batch element x class) problem; each lane runs max_output select-and-
// suppress steps: argmax of the active scores (ties -> lower index), then one
// IoU row against the winner with the +pixel_offset convention, suppressing
// where IoU > thresh (strict); the winner itself is always killed. Invalid
// slots carry -inf. An exhausted lane emits idx -1 / mask 0.
//
// Design: one CTA of kThreads threads per lane. The lane's active scores live
// in a global scratch row (L2-resident: 200 KB at N = 50,000). Each step is
//   1. per-thread (max score, lowest index) over a strided share of N,
//   2. warp-shuffle + shared-memory reduction comparing (score desc, idx asc),
//   3. the winner's box broadcast through shared memory,
//   4. one fused pass: IoU against the winner, -inf into the scratch row for
//      suppressed boxes, and the surviving (score, idx) maximum for step 1 of
//      the next iteration.
// Coordinates are SoA (lane, 2*dim, N), so every pass is coalesced; a lane
// stride of 0 lets all lanes share one broadcast box/score array.
//
// Numerics: IoU is computed in the float32 operation order of
// ops/nms.py:34-47 and nms_pallas.py:45-59 (inter = 1 * max(seg, 0) per axis
// y, x, z; areas as products of (hi - lo + off); union = area_w + area - inter;
// iou = union > 0 ? inter / union : 0). Build with -fmad=false and without
// --use_fast_math so no multiply-add is contracted and division is IEEE: the
// keep lists are then bit-identical to the plain PyTorch version.
//
// What bounds it: at the retina_unet LIDC shape (16 lanes x 50,000
// candidates, 30 steps) only 16 of the H100's 132 SMs hold a lane, and each
// step is a latency-bound N-wide reduction followed by a block barrier.
// Splitting a lane across a thread-block cluster (distributed shared memory
// for the reduction), or the reference CUDA NMS's 64-box bitmask tiles, is
// later work.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float s, int i, float best_s, int best_i) {
  return s > best_s || (s == best_s && i < best_i);
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// (lo, hi) coordinate rows of axis ax in the (y1, x1, y2, x2, z1, z2) layout
__device__ __forceinline__ int lo_row(int ax) { return ax == 0 ? 0 : ax == 1 ? 1 : 4; }
__device__ __forceinline__ int hi_row(int ax) { return ax == 0 ? 2 : ax == 1 ? 3 : 5; }

template <int DIM>
__global__ void __launch_bounds__(kThreads) nms_kernel(
    const float* __restrict__ coords, long long coords_lane_stride,
    const float* __restrict__ scores, long long scores_lane_stride,
    const unsigned char* __restrict__ valid, long long valid_lane_stride,
    float* __restrict__ active_all, int n, int max_output, float thresh, float off,
    int* __restrict__ out_idx, unsigned char* __restrict__ out_mask) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const float* c = coords + lane * coords_lane_stride;
  const float* sc = scores + lane * scores_lane_stride;
  const unsigned char* v = valid ? valid + lane * valid_lane_stride : nullptr;
  float* active = active_all + static_cast<long long>(lane) * n;
  int* oidx = out_idx + static_cast<long long>(lane) * max_output;
  unsigned char* omask = out_mask + static_cast<long long>(lane) * max_output;

  __shared__ float red_s[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float win_box[2 * DIM];
  __shared__ float win_s;
  __shared__ int win_i;

  const float neg_inf = -CUDART_INF_F;
  float best_s = neg_inf;
  int best_i = INT_MAX;
  for (int j = tid; j < n; j += kThreads) {
    float s = sc[j];
    if (v != nullptr && !v[j]) s = neg_inf;
    active[j] = s;
    if (better(s, j, best_s, best_i)) {
      best_s = s;
      best_i = j;
    }
  }

  int t = 0;
  for (; t < max_output; ++t) {
    warp_argmax(best_s, best_i);
    if (wl == 0) {
      red_s[warp] = best_s;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      float s = red_s[wl];
      int i = red_i[wl];
      warp_argmax(s, i);
      if (wl == 0) {
        const bool ok = s > neg_inf;
        win_s = s;
        win_i = i;
        oidx[t] = ok ? i : -1;
        omask[t] = ok ? 1 : 0;
        if (ok) {
#pragma unroll
          for (int k = 0; k < 2 * DIM; ++k) win_box[k] = c[static_cast<long long>(k) * n + i];
        }
      }
    }
    __syncthreads();
    // block-uniform: every thread reads the same shared winner
    if (!(win_s > neg_inf)) break;
    const int wi = win_i;
    float wlo[DIM], whi[DIM];
    float area_w = 1.0f;
#pragma unroll
    for (int ax = 0; ax < DIM; ++ax) {
      wlo[ax] = win_box[lo_row(ax)];
      whi[ax] = win_box[hi_row(ax)];
      area_w = area_w * (whi[ax] - wlo[ax] + off);
    }

    best_s = neg_inf;
    best_i = INT_MAX;
    for (int j = tid; j < n; j += kThreads) {
      const float s = active[j];
      if (!(s > neg_inf)) continue;
      bool kill = j == wi;
      if (!kill) {
        float inter = 1.0f;
        float area = 1.0f;
#pragma unroll
        for (int ax = 0; ax < DIM; ++ax) {
          const float lo = c[static_cast<long long>(lo_row(ax)) * n + j];
          const float hi = c[static_cast<long long>(hi_row(ax)) * n + j];
          const float seg = fminf(whi[ax], hi) - fmaxf(wlo[ax], lo) + off;
          inter = inter * fmaxf(seg, 0.0f);
          area = area * (hi - lo + off);
        }
        const float uni = area_w + area - inter;
        const float iou = uni > 0.0f ? inter / uni : 0.0f;
        kill = iou > thresh;
      }
      if (kill) {
        active[j] = neg_inf;
      } else if (better(s, j, best_s, best_i)) {
        best_s = s;
        best_i = j;
      }
    }
  }
  // slots after an exhausted lane (slot t itself was written above)
  for (int k = t + tid; k < max_output; k += kThreads) {
    oidx[k] = -1;
    omask[k] = 0;
  }
}

}  // namespace

extern "C" int mdt_nms_launch(const float* coords, long long coords_lane_stride,
                              const float* scores, long long scores_lane_stride,
                              const unsigned char* valid, long long valid_lane_stride,
                              float* active, int lanes, int n, int dim, int max_output,
                              float thresh, float pixel_offset, int* out_idx,
                              unsigned char* out_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    nms_kernel<2><<<lanes, kThreads, 0, s>>>(coords, coords_lane_stride, scores, scores_lane_stride,
                                             valid, valid_lane_stride, active, n, max_output, thresh,
                                             pixel_offset, out_idx, out_mask);
  } else if (dim == 3) {
    nms_kernel<3><<<lanes, kThreads, 0, s>>>(coords, coords_lane_stride, scores, scores_lane_stride,
                                             valid, valid_lane_stride, active, n, max_output, thresh,
                                             pixel_offset, out_idx, out_mask);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
