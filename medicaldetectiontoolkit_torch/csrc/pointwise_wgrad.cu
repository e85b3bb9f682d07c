// Weight gradient of the stride-1 1x1x1 3D convolutions of the FPN and heads
// for Hopper (sm_90a): kernel K6.
//
// K6 replaces no TPU kernel: the JAX package leaves these convolutions to
// XLA. It was added because cuDNN's float32 weight gradient of the 1x1x1
// convolutions (wgrad2d_grouped_direct_kernel and its kin) held about 366 ms
// of a 1,023 ms 3D Retina U-Net training step at LIDC width and about 95 of
// Mask R-CNN's, where x, dy and dw read and written once take 1.7 and 0.8 ms
// at 3.35 TB/s: about 0.5% of the bytes' bound.
//
// Function: dw[m, c] = sum over b and v of dy[b, m, v] * x[b, c, v], with x
// (B, cin, V) and dy (B, cout, V) channel-first and the V voxels contiguous:
// a product of a (cout x B*V) and a (B*V x cin) matrix, reduced over the
// long B*V axis. float32 FFMA with float32 sums: no tensor cores, no TF32.
//
// What bounds it on the H100: bytes. Its operations per byte,
// cout * cin / (2 * (cout + cin)), are 1 to 15 at the LIDC shapes, below the
// card's float32 ridge of 20 (67 TFLOP/s over 3.35 TB/s), so the design
// streams x and dy once at the memory rate and keeps the FMAs off the way.
//
// Design. The partial pass (pointwise_wgrad_partial_kernel): a block owns a
// tile of dw, tm x tc warps, each warp kR x kR entries (rows m0 + kR * mg +
// i, columns c0 + kR * cg + j); one tile holds all of dw where it fits, so x
// and dy are read once. The B*V voxels, flattened, are cut into stages of kVt
// = 128 and the stages into S slices, one run of stages per block. Each stage
// of the tile's dy and x rows is copied into shared memory by cp.async (16
// bytes where V divides by 4, else 4), through a ring of kStages buffers: the
// next kStages - 1 stages are in flight while the block sums one. Every lane
// of a warp owns the same kR x kR entries and its own 4 voxels of the stage:
// it reads kR dy and kR x vectors of 4 (a warp's 32 lanes read one row's 512
// contiguous bytes: no bank conflict) for kR * kR * 4 FMAs, so each of its
// 36 float32 accumulators sums 4 products a stage, at most 4 * 1,024 in a
// run (the plan's MAX_RUN). At the end of its run the warp sums its 32 lanes
// by a butterfly of shuffles and writes its entries to the slice's partial
// of dw (no atomics: every entry has one owner). The reduce pass
// (pointwise_wgrad_reduce_kernel) sums the S partials of each entry in slice
// order; with one slice the partial pass writes dw itself. S is fixed for a
// card and shape, and every sum is taken in a fixed order, so dw is
// bit-identical run to run. Tiles and S come from the wrapper's plan
// (ops/pointwise_wgrad_cuda.py::plan).
//
// What it admits: float32 x and dy, contiguous (and 16-byte aligned where V
// divides by 4 for the vector path), fewer than 2^31 - 128 voxels in all, any
// channel counts (rows past cout or cin are zero rows in shared memory, and
// entries past them are not written). Built with -fmad=false like the other
// kernels; the sums use explicit __fmaf_rn and add in another order than
// cuDNN and the plain version (ops/pointwise_wgrad.py), so dw agrees with
// them to float32 rounding, not bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kR = 6;
constexpr int kVt = 128;
constexpr int kStages = 4;
constexpr int kMaxWarps = 24;
constexpr int kReduceThreads = 256;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take on sm_90

// the shapes and the plan of one launch (ops/pointwise_wgrad_cuda.py::plan)
struct Geo {
  int B, C, V, M;           // operands: x (B, C, V), dy (B, M, V)
  int tm, tc, slices, vec;  // plan
  int ntm, ntc, n_stages;   // derived
  long long N;              // B * V
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// an asynchronous copy of N (16 or 4) bytes into shared memory, zeros where
// !valid (the source is not read then)
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? N : 0;
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Stage s (voxels s * kVt ...) of the tile into buf: the tile's rows_m dy
// rows at rows 0.., its rows_c x rows at rows tm * kR..; warp w copies rows
// w, w + warps, ..., lane l the voxels s * kVt + 4 l .. + 3 of each, zeros
// past the last voxel.
template <int Q>
__device__ __forceinline__ void stage(const float* __restrict__ x, const float* __restrict__ dy, float* buf,
                                      const Geo& g, int s, int m0, int rows_m, int c0, int rows_c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int rows = rows_m + rows_c, xrow = g.tm * kR - rows_m;
  const long long n0 = static_cast<long long>(s) * kVt + 4 * lane;
  if (Q == 4) {
    // V divides by 4: the lane's 4 voxels lie in one image, 16-byte aligned
    const bool valid = n0 < g.N;
    const long long b = valid ? n0 / g.V : 0, v = valid ? n0 - b * g.V : 0;
    for (int r = warp; r < rows; r += warps) {
      const bool is_dy = r < rows_m;
      const float* src = is_dy ? dy + (b * g.M + m0 + r) * g.V + v : x + (b * g.C + c0 + r - rows_m) * g.V + v;
      cp_async<16>(buf + (is_dy ? r : xrow + r) * kVt + 4 * lane, valid ? src : x, valid);
    }
  } else {
    long long b[4], v[4];
    bool valid[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      valid[e] = n0 + e < g.N;
      b[e] = valid[e] ? (n0 + e) / g.V : 0;
      v[e] = valid[e] ? n0 + e - b[e] * g.V : 0;
    }
    for (int r = warp; r < rows; r += warps) {
      const bool is_dy = r < rows_m;
      float* dst = buf + (is_dy ? r : xrow + r) * kVt + 4 * lane;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* src =
            is_dy ? dy + (b[e] * g.M + m0 + r) * g.V + v[e] : x + (b[e] * g.C + c0 + r - rows_m) * g.V + v[e];
        cp_async<4>(dst + e, valid[e] ? src : x, valid[e]);
      }
    }
  }
}

// The partial pass: block (tile, slice) sums its slice's stages into one
// partial of its tile of dw. blockIdx.x = tile (ntm tiles along cout
// fastest), blockIdx.y = slice; warp = cg * tm + mg.
template <int Q>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    pointwise_wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                                   float* __restrict__ out, const Geo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int buf_words = (g.tm + g.tc) * kR * kVt;
  const int m0 = blockIdx.x % g.ntm * g.tm * kR, c0 = blockIdx.x / g.ntm * g.tc * kR;
  const int rows_m = min(g.tm * kR, g.M - m0), rows_c = min(g.tc * kR, g.C - c0);
  const int slice = blockIdx.y;
  // slice s takes stages [s * n / S, (s + 1) * n / S): runs of equal length to 1
  const int s_begin = static_cast<int>(static_cast<long long>(slice) * g.n_stages / g.slices);
  const int s_end = static_cast<int>(static_cast<long long>(slice + 1) * g.n_stages / g.slices);

  // rows past cout and past cin in the tile stay zero in every buffer
  for (int st = 0; st < kStages; ++st) {
    float* b = smem + st * buf_words;
    for (int i = threadIdx.x; i < (g.tm * kR - rows_m) * kVt; i += blockDim.x) b[rows_m * kVt + i] = 0.0f;
    for (int i = threadIdx.x; i < (g.tc * kR - rows_c) * kVt; i += blockDim.x)
      b[(g.tm * kR + rows_c) * kVt + i] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (s_begin + k < s_end) stage<Q>(x, dy, smem + k * buf_words, g, s_begin + k, m0, rows_m, c0, rows_c);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mg = warp % g.tm, cg = warp / g.tm;
  float acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.0f;

  const int drow = mg * kR * kVt, xrow = (g.tm + cg) * kR * kVt;
  for (int s = s_begin, it = 0; s < s_end; ++s, ++it) {
    cp_async_wait<kStages - 2>();  // this stage's copies have landed; later ones may not
    __syncthreads();               // ... every thread's, and the buffer read last iteration is free
    if (s + kStages - 1 < s_end)
      stage<Q>(x, dy, smem + (it + kStages - 1) % kStages * buf_words, g, s + kStages - 1, m0, rows_m, c0, rows_c);
    cp_async_commit();
    const float* cur = smem + it % kStages * buf_words + 4 * lane;
    float4 d[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) d[i] = *reinterpret_cast<const float4*>(cur + drow + i * kVt);
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(cur + xrow + j * kVt);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        acc[i][j] = __fmaf_rn(d[i].x, xv.x, acc[i][j]);
        acc[i][j] = __fmaf_rn(d[i].y, xv.y, acc[i][j]);
        acc[i][j] = __fmaf_rn(d[i].z, xv.z, acc[i][j]);
        acc[i][j] = __fmaf_rn(d[i].w, xv.w, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  // the warp's 32 lanes summed by a butterfly: every lane ends with the same
  // total (a + b and b + a are one float)
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j)
#pragma unroll
      for (int off = 16; off; off >>= 1) acc[i][j] = acc[i][j] + __shfl_xor_sync(0xffffffffu, acc[i][j], off);

  float* o = out + static_cast<long long>(slice) * g.M * g.C;
#pragma unroll
  for (int e = 0; e < kR * kR; ++e) {
    const int m = m0 + mg * kR + e / kR, c = c0 + cg * kR + e % kR;
    if (lane == (e & 31) && m < g.M && c < g.C) o[static_cast<long long>(m) * g.C + c] = acc[e / kR][e % kR];
  }
}

// The reduce pass: dw[e] = partial[0][e] + partial[1][e] + ... in slice order.
__global__ void __launch_bounds__(kReduceThreads)
    pointwise_wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int slices,
                                  long long mn) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < mn;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = partial[e];
    for (int s = 1; s < slices; ++s) sum = sum + partial[s * mn + e];
    dw[e] = sum;
  }
}

// the shapes and plan of a launch, checked and completed; false where the
// kernel does not take them
bool make_geo(const int* shape, const int* plan, Geo* out) {
  Geo g;
  g.B = shape[0], g.C = shape[1], g.V = shape[2], g.M = shape[3];
  g.tm = plan[0], g.tc = plan[1], g.slices = plan[2], g.vec = plan[3];
  if (g.B < 1 || g.C < 1 || g.V < 1 || g.M < 1 || g.tm < 1 || g.tc < 1 || g.tm * g.tc > kMaxWarps ||
      g.slices < 1 || g.slices > 65535 || (g.vec != 0 && g.vec != 1) || (g.vec && g.V % 4))
    return false;
  g.N = static_cast<long long>(g.B) * g.V;
  if (g.N > (1LL << 31) - 1 - kVt || kStages * (g.tm + g.tc) * kR * kVt * 4 > kSmemMax) return false;
  g.n_stages = static_cast<int>((g.N + kVt - 1) / kVt);
  g.ntm = cdiv(cdiv(g.M, kR), g.tm), g.ntc = cdiv(cdiv(g.C, kR), g.tc);
  if (g.slices > g.n_stages) return false;
  *out = g;
  return true;
}

template <int Q>
cudaError_t launch_partial(const float* x, const float* dy, float* out, const Geo& g, cudaStream_t st) {
  auto kernel = pointwise_wgrad_partial_kernel<Q>;
  const int smem = kStages * (g.tm + g.tc) * kR * kVt * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.ntm * g.ntc, g.slices), g.tm * g.tc * 32, smem, st>>>(x, dy, out, g);
  return cudaGetLastError();
}

}  // namespace

// K6. x float32 (B, cin, V), dy float32 (B, cout, V), both contiguous (and
// 16-byte aligned where plan[3], vec, is 1); partial float32 scratch
// (slices, cout * cin), unused with one slice; dw float32 (cout, cin).
// shape: B, cin, V, cout; plan: tm, tc, slices, vec
// (ops/pointwise_wgrad_cuda.py::plan). Enqueues the passes on `stream`.
extern "C" int mdt_pointwise_wgrad_launch(const float* x, const float* dy, float* partial, float* dw,
                                          const int* shape, const int* plan, void* stream) {
  Geo g;
  if (!make_geo(shape, plan, &g)) return static_cast<int>(cudaErrorInvalidValue);
  if (g.vec && (reinterpret_cast<std::uintptr_t>(x) % 16 || reinterpret_cast<std::uintptr_t>(dy) % 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long mn = static_cast<long long>(g.M) * g.C;
  if (mn * g.slices >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = g.slices > 1 ? partial : dw;
  cudaError_t err = g.vec ? launch_partial<4>(x, dy, out, g, st) : launch_partial<1>(x, dy, out, g, st);
  if (err != cudaSuccess || g.slices == 1) return static_cast<int>(err);
  const long long blocks = (mn + kReduceThreads - 1) / kReduceThreads;
  pointwise_wgrad_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kReduceThreads, 0, st>>>(
      partial, dw, g.slices, mn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mdt_pointwise_wgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
