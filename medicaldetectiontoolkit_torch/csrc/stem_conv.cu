// Tiny-cin 3D stem convolution for Hopper (sm_90a): forward (K3) and weight
// gradient (K4).
//
// Replace the Pallas TPU kernels medicaldetectiontoolkit_tpu/ops/
// stem_conv_pallas.py::_stem_pallas_fwd (K3) and ::_stem_pallas_wgrad (K4).
// Same function: a 3D conv with SAME padding (pad k//2, output
// ceil(Y/sy) x ceil(X/sx) x Z), stride (sy, sx, 1), cin <= 2 input channels,
// float32 accumulation; K3 casts the sum to the compute dtype and then adds
// the bias in that dtype (stem_conv_pallas.py:196, _banded_ref :117-120);
// K4 gives dw = sum over (b, yo, xo, z) of x_pad * g in float32.
//
// What is not carried over: the TPU design folds z into a banded GEMM weight
// (Z/k times the work) and pre-gathers 49 tap copies of the input, only to
// meet Mosaic's 128-lane rules. Here both kernels are direct:
//
// K3: one thread per (b, yo, xo) and 4 consecutive z outputs, all cout
// channels in float32 registers (cout padded to CMAX, a multiple of 4). The
// whole filter sits in shared memory as float32 [cin][ky][kx][kz][CMAX], so
// each kz step reads CMAX/4 broadcast float4s and does 4 * CMAX FMAs; the x
// strip of 4 + k - 1 values per (ci, ky, kx) is loaded once into registers
// and reused by every kz. x is read channel-first (B, cin, Y, X, Z) in place,
// neighbouring threads on neighbouring z; the output is written (B, cout, Yo,
// Xo, Z). bf16 inputs are converted on load.
//
// K4: the reduction (2.1 M positions per microbatch of 2 at the Retina U-Net
// conv0) is split into chunks of (b, yo, xt columns of xo). A persistent
// grid of G = min(chunks, blocks per SM x SMs) blocks walks them: block i
// takes chunks i, i + G, i + 2G, ... in that order. For each chunk it stages
// the g tile (cout x xt x Z) and the x tile (cin x k rows x the columns the
// tile reads x Z + 2p) in shared memory as float32, 4 z values per load
// (16 or 8 bytes when the rows allow) and 4 loads in flight per thread. A
// job is (ci, ky, column j) and two output channels below k 7 (one at k 7):
// it keeps all k x k (kx, kz) sums of each channel in registers and walks z
// with a ring of k x values per kx, so each z step reads k x values and one
// g value per channel for k^2 FMAs per channel. The xt columns of a job sit
// on neighbouring lanes and are summed by a fixed shuffle tree; lane j = 0
// adds the sums into the block's own partial row of dw in device memory (it
// stays in L2; each slot belongs to one thread, so no atomics). A second
// launch, one warp per output, sums the G rows: each lane the rows lane,
// lane + 32, ... in order, then a fixed shuffle tree. Blocks are sized to
// the jobs: at most 256 threads, each taking ceil(jobs / 256) jobs, in the
// fewest warps that do (conv0: 216 jobs, 224 threads). G is fixed for a
// card and shape, so two runs give bit-identical dw.
//
// What bounds them on the H100: K3 at the LIDC C1 stem (batch 8, k 7, cout
// 18) is about 26 GFLOP, 0.39 ms at 67 TFLOP/s of float32 FMA; at conv0 (k 3,
// batch 2) it writes 151 MB of float32 for 2 GFLOP, so device memory bounds
// it (45 us at 3.35 TB/s). K4 does the same operations as K3 on the same
// inputs and reads 151 MB of g at conv0. Its partial pass (0.17 ms at conv0
// on an H100 at 700 W, against that 0.048 ms) is bound by latency: a
// block's warps wait at the barrier while its tiles load (nothing overlaps
// the next chunk's copy with the sums), and few blocks share an SM to hide
// it: 3 at conv0 and 2 at k 7, limited by registers (79 x 224 threads at
// k 3; 128 x 256 at k 7, where ptxas spills 8 bytes), not by shared memory.
// The sums take some 1.4 instructions per FMA (counted from the source).
// The reduce reads G rows of about
// cout x cin x k^3 floats from L2 (G / 32 loads per lane). Built with
// -fmad=false like the other kernels; the sums use explicit __fmaf_rn, so
// they are not bit-identical to the plain PyTorch versions
// (ops/stem_conv.py), which sum the taps in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFwdThreads = 128;
constexpr int kZT = 4;  // z outputs per K3 thread
constexpr int kWgThreads = 256;
constexpr int kReduceThreads = 128;
constexpr int kStage = 4;  // K4's staging loads in flight per thread
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take on sm_90

struct Shape {
  int B, cin, Y, X, Z, cout, sy, sx, Yo, Xo;
};

// K4's tile rows hold Z rounded up to 4 values (staged 4 at a time); a g
// row's stride is 1 mod 32 and an x row's (zero-padded by k / 2 at both
// ends) odd, so that a warp's rows fall on different banks
__host__ __device__ __forceinline__ int wgrad_gstride(int Z) {
  const int z4 = (Z + 3) / 4 * 4;
  return z4 + ((1 - z4) % 32 + 32) % 32;
}
__host__ __device__ __forceinline__ int wgrad_xstride(int Z, int k) { return ((Z + 3) / 4 * 4 + 2 * (k / 2)) | 1; }
// K4's output channels per job, co and co + ceil(cout / CO): two below k 7
// (their accumulators would not fit beside k 7's window)
__host__ __device__ constexpr int wgrad_co(int k) { return k < 7 ? 2 : 1; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// float32 sum -> compute dtype -> + bias in the compute dtype
__device__ __forceinline__ float finish(float acc, float bias) { return acc + bias; }
__device__ __forceinline__ __nv_bfloat16 finish(float acc, __nv_bfloat16 bias) {
  return __float2bfloat16(__bfloat162float(__float2bfloat16(acc)) + __bfloat162float(bias));
}

// a / d for 0 <= a < 2^22 and d > 0, inv = 1 / d in float32: the float
// quotient is one off at most, and is corrected; *rem = a % d
__device__ __forceinline__ int div_small(int a, int d, float inv, int* rem) {
  int q = __float2int_rz(__int2float_rn(a) * inv);
  int r = a - q * d;
  if (r < 0) {
    --q;
    r += d;
  } else if (r >= d) {
    ++q;
    r -= d;
  }
  *rem = r;
  return q;
}

// v = the 4 values at p as float32: one 16- or 8-byte load when vec (p
// aligned to 4 values, all 4 in the row), else the n < 4 that are
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float v[4]) {
  if (vec) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? __ldg(p + e) : 0.0f;
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec, float v[4]) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? __bfloat162float(p[e]) : 0.0f;
  }
}

template <typename T, int K, int CMAX>
__global__ void __launch_bounds__(kFwdThreads) stem_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                                              const T* __restrict__ bias, T* __restrict__ out,
                                                              const Shape s) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [cin][K][K][K][CMAX]
  const int n_taps = s.cin * K * K * K;
  for (int i = threadIdx.x; i < n_taps * CMAX; i += blockDim.x) {
    const int co = i % CMAX, tap = i / CMAX;
    ws[i] = co < s.cout ? to_f32(w[co * n_taps + tap]) : 0.0f;  // w is (cout, cin, K, K, K)
  }
  __syncthreads();

  constexpr int P = K / 2;
  const int nzb = (s.Z + kZT - 1) / kZT;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(s.B) * s.Yo * s.Xo * nzb) return;
  const int zb = static_cast<int>(t % nzb);
  long long r = t / nzb;
  const int xo = static_cast<int>(r % s.Xo);
  r /= s.Xo;
  const int yo = static_cast<int>(r % s.Yo);
  const int b = static_cast<int>(r / s.Yo);
  const int z0 = zb * kZT;

  float acc[kZT][CMAX];
#pragma unroll
  for (int zt = 0; zt < kZT; ++zt)
#pragma unroll
    for (int co = 0; co < CMAX; ++co) acc[zt][co] = 0.0f;

  const int yi0 = yo * s.sy - P, xi0 = xo * s.sx - P;
  for (int ci = 0; ci < s.cin; ++ci) {
    const T* xc = x + (static_cast<long long>(b) * s.cin + ci) * s.Y * s.X * s.Z;
    for (int ky = 0; ky < K; ++ky) {
      const int yi = yi0 + ky;
      if (yi < 0 || yi >= s.Y) continue;  // zero padding adds nothing
      for (int kx = 0; kx < K; ++kx) {
        const int xi = xi0 + kx;
        if (xi < 0 || xi >= s.X) continue;
        const T* row = xc + (static_cast<long long>(yi) * s.X + xi) * s.Z;
        float strip[kZT + K - 1];
#pragma unroll
        for (int i = 0; i < kZT + K - 1; ++i) {
          const int zi = z0 - P + i;
          strip[i] = (zi >= 0 && zi < s.Z) ? to_f32(row[zi]) : 0.0f;
        }
        const float4* wt = reinterpret_cast<const float4*>(ws + ((ci * K + ky) * K + kx) * K * CMAX);
#pragma unroll
        for (int kz = 0; kz < K; ++kz) {
#pragma unroll
          for (int c4 = 0; c4 < CMAX / 4; ++c4) {
            const float4 wv = wt[kz * (CMAX / 4) + c4];
#pragma unroll
            for (int zt = 0; zt < kZT; ++zt) {
              const float xv = strip[zt + kz];
              acc[zt][4 * c4 + 0] = __fmaf_rn(xv, wv.x, acc[zt][4 * c4 + 0]);
              acc[zt][4 * c4 + 1] = __fmaf_rn(xv, wv.y, acc[zt][4 * c4 + 1]);
              acc[zt][4 * c4 + 2] = __fmaf_rn(xv, wv.z, acc[zt][4 * c4 + 2]);
              acc[zt][4 * c4 + 3] = __fmaf_rn(xv, wv.w, acc[zt][4 * c4 + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int co = 0; co < CMAX; ++co) {
    if (co >= s.cout) break;
    const T bv = bias[co];
    T* o = out + (((static_cast<long long>(b) * s.cout + co) * s.Yo + yo) * s.Xo + xo) * s.Z + z0;
#pragma unroll
    for (int zt = 0; zt < kZT; ++zt)
      if (z0 + zt < s.Z) o[zt] = finish(acc[zt][co], bv);
  }
}

// K4, first pass: block i sums chunks i, i + G, ... (chunk: b, yo, xt
// columns of xo) of dw (cout, cin, K, K, K) into its row partials[i]. A job
// is (ci, ky, channels cp and cp + ncp, column j): all K x K (kx, kz) sums of
// that column, K x loads and CO g loads per z for CO x K^2 FMAs; the xt
// columns of a job sit on neighbouring lanes and are summed by a fixed
// shuffle tree. At most 128 registers (2 blocks of 256 per SM), so that k 7
// keeps 2 blocks per SM.
template <typename T, int K>
__global__ void __launch_bounds__(kWgThreads, 2) stem_wgrad_partial_kernel(const T* __restrict__ x,
                                                                       const T* __restrict__ g,
                                                                       float* __restrict__ partials, const Shape s,
                                                                       int xt, bool vec) {
  extern __shared__ float smem[];
  constexpr int P = K / 2;
  const int W = s.sx * (xt - 1) + K;  // x columns the tile reads
  const int XS = wgrad_xstride(s.Z, K);
  const int GS = wgrad_gstride(s.Z);
  constexpr int CO = wgrad_co(K);
  const int ncp = (s.cout + CO - 1) / CO;  // a job's channels: cp, cp + ncp, ...
  float* gs = smem;                         // [ncp * CO][xt][GS], zero past cout
  float* xs = smem + ncp * CO * xt * GS;  // [cin][K][W][XS]

  const int n_xt = (s.Xo + xt - 1) / xt;
  const int n_chunks = s.B * s.Yo * n_xt;
  const int n_jobs = s.cin * K * ncp * xt;
  float* part = partials + static_cast<long long>(blockIdx.x) * s.cout * s.cin * K * K * K;
  const int nq = (s.Z + 3) / 4;  // items of 4 z values per row
  const int g_rows = ncp * CO * xt, x_rows = s.cin * K * W;
  const int n_items = (g_rows + x_rows) * nq;
  const int x_off = g_rows * GS;
  const int lxt = __ffs(xt) - 1;  // xt is a power of two
  const float inv_nq = 1.0f / nq, inv_w = 1.0f / W;
  for (int i = threadIdx.x; i < x_rows * XS; i += blockDim.x) xs[i] = 0.0f;  // z padding, kept by every chunk
  __syncthreads();  // the zeros land before any warp stages the first chunk over them
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const bool first = chunk == static_cast<int>(blockIdx.x);
    const int xo0 = (chunk % n_xt) * xt;
    const int row = chunk / n_xt;
    const int yo = row % s.Yo, b = row / s.Yo;

    // stage the tiles: items of 4 z values of one row, kStage loads in
    // flight per thread before any store
    const int y0 = yo * s.sy - P, x0 = xo0 * s.sx - P;
    for (int base = threadIdx.x; base < n_items; base += kStage * blockDim.x) {
      float v[kStage][4];
      int dst[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int item = base + u * blockDim.x;
        dst[u] = -1;
        if (item >= n_items) continue;
        int q;
        int r = div_small(item, nq, inv_nq, &q);  // the item's row; its z values from 4q (zeros past Z)
        const int z = 4 * q;
        const T* src = nullptr;
        if (r < g_rows) {  // g row (co, j)
          const int xo = xo0 + (r & (xt - 1));
          dst[u] = r * GS + z;
          if (xo < s.Xo && (r >> lxt) < s.cout)
            src = g + (((static_cast<long long>(b) * s.cout + (r >> lxt)) * s.Yo + yo) * s.Xo + xo) * s.Z + z;
        } else {  // x row (ci, ky, c)
          r -= g_rows;
          int c;
          const int cky = div_small(r, W, inv_w, &c);
          const int yi = y0 + cky % K, xi = x0 + c;
          dst[u] = x_off + r * XS + P + z;
          if (yi >= 0 && yi < s.Y && xi >= 0 && xi < s.X)
            src = x + (((static_cast<long long>(b) * s.cin + cky / K) * s.Y + yi) * s.X + xi) * s.Z + z;
        }
        if (src) {
          load4(src, s.Z - z, vec, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][e] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (dst[u] >= 0)
#pragma unroll
          for (int e = 0; e < 4; ++e) smem[dst[u] + e] = v[u][e];
    }
    __syncthreads();

    // every lane runs every round: the shuffles below take the whole warp
    for (int base = 0; base < n_jobs; base += blockDim.x) {
      const int job = base + threadIdx.x;
      const int j = job % xt;  // neighbouring lanes: the columns of one (ci, ky, cp)
      int r = job / xt;
      const int cp = r % ncp;
      r /= ncp;
      const int ky = r % K, ci = r / K;
      float acc[CO][K][K];  // [channel][kx][kz]
#pragma unroll
      for (int h = 0; h < CO; ++h)
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
#pragma unroll
          for (int kz = 0; kz < K; ++kz) acc[h][kx][kz] = 0.0f;
      if (job < n_jobs) {
        const float* xr = xs + ((ci * K + ky) * W + s.sx * j) * XS;  // column kx at xr + kx * XS
        const float* gr = gs + (cp * xt + j) * GS;                    // channel h at gr + h * ncp * xt * GS
        float ring[K][K];  // ring[kx][(z + kz) % K] = x of column kx at padded z + kz
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
#pragma unroll
          for (int i = 0; i < K - 1; ++i) ring[kx][i] = xr[kx * XS + i];
        for (int z0 = 0; z0 < s.Z; z0 += K) {
#pragma unroll
          for (int u = 0; u < K; ++u) {
            const int z = z0 + u;
            if (z < s.Z) {
              float gv[CO];
#pragma unroll
              for (int h = 0; h < CO; ++h) gv[h] = gr[h * ncp * xt * GS + z];
#pragma unroll
              for (int kx = 0; kx < K; ++kx) ring[kx][(u + K - 1) % K] = xr[kx * XS + z + K - 1];
#pragma unroll
              for (int h = 0; h < CO; ++h)
#pragma unroll
                for (int kx = 0; kx < K; ++kx)
#pragma unroll
                  for (int kz = 0; kz < K; ++kz)
                    acc[h][kx][kz] = __fmaf_rn(ring[kx][(u + kz) % K], gv[h], acc[h][kx][kz]);
            }
          }
        }
      }
      for (int off = xt / 2; off > 0; off /= 2)  // column j += column j + off
#pragma unroll
        for (int h = 0; h < CO; ++h)
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
#pragma unroll
            for (int kz = 0; kz < K; ++kz)
              acc[h][kx][kz] += __shfl_down_sync(0xffffffffu, acc[h][kx][kz], off, xt);
#pragma unroll
      for (int h = 0; h < CO; ++h) {
        const int co = cp + h * ncp;
        if (job >= n_jobs || j != 0 || co >= s.cout) continue;
        float* o = part + ((co * s.cin + ci) * K + ky) * K * K;
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
#pragma unroll
          for (int kz = 0; kz < K; ++kz)
            o[kx * K + kz] = first ? acc[h][kx][kz] : o[kx * K + kz] + acc[h][kx][kz];
      }
    }
    __syncthreads();  // the tiles are read; the next chunk may overwrite them
  }
}

// K4, second pass: one warp per output o; dw[o] = the G rows summed, lane l
// taking rows l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void __launch_bounds__(kReduceThreads) stem_wgrad_reduce_kernel(const float* __restrict__ partials,
                                                                          float* __restrict__ dw, int n_rows,
                                                                          int n_out) {
  const int o = blockIdx.x * (kReduceThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (o >= n_out) return;  // the whole warp
  float sum = 0.0f;
  for (int r = lane; r < n_rows; r += 32) sum += partials[static_cast<long long>(r) * n_out + o];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) dw[o] = sum;
}

int fwd_smem(int cin, int k, int cmax) { return cin * k * k * k * cmax * 4; }

int wgrad_smem(const Shape& s, int k, int xt) {
  const int co = wgrad_co(k);
  return ((s.cout + co - 1) / co * co * xt * wgrad_gstride(s.Z) +
          s.cin * k * (s.sx * (xt - 1) + k) * wgrad_xstride(s.Z, k)) * 4;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
                           : cudaSuccess;
}

template <typename T, int K, int CMAX>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* out, const Shape& s, cudaStream_t st) {
  const int smem = fwd_smem(s.cin, K, CMAX);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(stem_fwd_kernel<T, K, CMAX>, smem);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(s.B) * s.Yo * s.Xo * ((s.Z + kZT - 1) / kZT);
  const long long blocks = (total + kFwdThreads - 1) / kFwdThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  stem_fwd_kernel<T, K, CMAX><<<static_cast<unsigned>(blocks), kFwdThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(out), s);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_fwd_c(const void* x, const void* w, const void* b, void* out, const Shape& s, cudaStream_t st) {
  if (s.cout <= 8) return launch_fwd<T, K, 8>(x, w, b, out, s, st);
  if (s.cout <= 16) return launch_fwd<T, K, 16>(x, w, b, out, s, st);
  if (s.cout <= 24) return launch_fwd<T, K, 24>(x, w, b, out, s, st);
  return launch_fwd<T, K, 32>(x, w, b, out, s, st);
}

template <typename T>
cudaError_t launch_fwd_k(int k, const void* x, const void* w, const void* b, void* out, const Shape& s,
                         cudaStream_t st) {
  switch (k) {
    case 3: return launch_fwd_c<T, 3>(x, w, b, out, s, st);
    case 5: return launch_fwd_c<T, 5>(x, w, b, out, s, st);
    case 7: return launch_fwd_c<T, 7>(x, w, b, out, s, st);
    default: return cudaErrorInvalidValue;
  }
}

int wgrad_threads(int cin, int k, int cout, int xt) {
  const int n_jobs = cin * k * ((cout + wgrad_co(k) - 1) / wgrad_co(k)) * xt;
  const int rounds = (n_jobs + kWgThreads - 1) / kWgThreads;  // jobs per thread, at most
  return 32 * ((n_jobs + 32 * rounds - 1) / (32 * rounds));  // the fewest warps for that
}

// Blocks of the partial pass that fit on the card at once: blocks per SM
// (occupancy for its block size and shared memory) x SMs.
template <typename T, int K>
cudaError_t wgrad_capacity(const Shape& s, int xt, int* capacity) {
  const int smem = wgrad_smem(s, K, xt);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(stem_wgrad_partial_kernel<T, K>, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_wgrad_partial_kernel<T, K>,
                                                      wgrad_threads(s.cin, K, s.cout, xt), smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *capacity = per_sm * sms;
  return cudaSuccess;
}

template <typename T, int K>
cudaError_t launch_wgrad(const void* x, const void* g, float* partials, float* dw, const Shape& s, int xt, int grid,
                         cudaStream_t st) {
  const int smem = wgrad_smem(s, K, xt);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(stem_wgrad_partial_kernel<T, K>, smem);
  if (err != cudaSuccess) return err;
  // whole 4-value loads: rows of a multiple of 4 values, aligned tensors
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0; };
  const bool vec = s.Z % 4 == 0 && aligned(x) && aligned(g);
  stem_wgrad_partial_kernel<T, K><<<grid, wgrad_threads(s.cin, K, s.cout, xt), smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partials, s, xt, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = s.cout * s.cin * K * K * K;
  constexpr int per_block = kReduceThreads / 32;
  stem_wgrad_reduce_kernel<<<(n_out + per_block - 1) / per_block, kReduceThreads, 0, st>>>(partials, dw, grid,
                                                                                           n_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad_k(int k, const void* x, const void* g, float* partials, float* dw, const Shape& s, int xt,
                           int grid, cudaStream_t st) {
  switch (k) {
    case 3: return launch_wgrad<T, 3>(x, g, partials, dw, s, xt, grid, st);
    case 5: return launch_wgrad<T, 5>(x, g, partials, dw, s, xt, grid, st);
    case 7: return launch_wgrad<T, 7>(x, g, partials, dw, s, xt, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t wgrad_capacity_k(int k, const Shape& s, int xt, int* capacity) {
  switch (k) {
    case 3: return wgrad_capacity<T, 3>(s, xt, capacity);
    case 5: return wgrad_capacity<T, 5>(s, xt, capacity);
    case 7: return wgrad_capacity<T, 7>(s, xt, capacity);
    default: return cudaErrorInvalidValue;
  }
}

bool make_shape(int B, int cin, int Y, int X, int Z, int cout, int sy, int sx, Shape* s) {
  if (B < 1 || cin < 1 || Y < 1 || X < 1 || Z < 1 || cout < 1 || cout > 32 || sy < 1 || sy > 2 || sx < 1 ||
      sx > 2)
    return false;
  *s = Shape{B, cin, Y, X, Z, cout, sy, sx, (Y + sy - 1) / sy, (X + sx - 1) / sx};
  return true;
}

}  // namespace

// K3. x (B, cin, Y, X, Z), w (cout, cin, k, k, k), b (cout,) and out (B, cout,
// ceil(Y/sy), ceil(X/sx), Z), all contiguous, of one dtype: 0 float32,
// 1 bfloat16. k in {3, 5, 7}, cout <= 32.
extern "C" int mdt_stem_fwd_launch(const void* x, const void* w, const void* b, void* out, int dtype, int B, int cin,
                                   int Y, int X, int Z, int cout, int k, int sy, int sx, void* stream) {
  Shape s;
  if (!make_shape(B, cin, Y, X, Z, cout, sy, sx, &s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch_fwd_k<float>(k, x, w, b, out, s, st)
                    : dtype == 1 ? launch_fwd_k<__nv_bfloat16>(k, x, w, b, out, s, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// K4. x as K3, g (B, cout, Yo, Xo, Z) of x's dtype, partials float32
// (grid, cout * cin * k^3) scratch, dw float32 (cout, cin, k, k, k); grid
// from 1 to the number of chunks, B * Yo * ceil(Xo / xt) (the wrapper takes
// the smaller of that and mdt_stem_wgrad_capacity).
extern "C" int mdt_stem_wgrad_launch(const void* x, const void* g, float* partials, float* dw, int dtype, int B,
                                     int cin, int Y, int X, int Z, int cout, int k, int sy, int sx, int xt, int grid,
                                     void* stream) {
  Shape s;
  if (!make_shape(B, cin, Y, X, Z, cout, sy, sx, &s) || xt < 1 || xt > 32 || (xt & (xt - 1)) || grid < 1 ||
      grid > static_cast<long long>(B) * s.Yo * ((s.Xo + xt - 1) / xt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch_wgrad_k<float>(k, x, g, partials, dw, s, xt, grid, st)
                    : dtype == 1 ? launch_wgrad_k<__nv_bfloat16>(k, x, g, partials, dw, s, xt, grid, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// K4's partial-pass blocks resident at once on the current device (blocks
// per SM x SMs) for this dtype, cin, Z, cout, k, sx and xt; a negative
// CUDA error code on failure.
extern "C" int mdt_stem_wgrad_capacity(int dtype, int cin, int Z, int cout, int k, int sx, int xt) {
  Shape s{1, cin, 1, 1, Z, cout, 1, sx, 1, 1};
  int capacity = 0;
  cudaError_t err = cin < 1 || Z < 1 || cout < 1 || cout > 32 || sx < 1 || sx > 2 || xt < 1 ? cudaErrorInvalidValue
                    : dtype == 0 ? wgrad_capacity_k<float>(k, s, xt, &capacity)
                    : dtype == 1 ? wgrad_capacity_k<__nv_bfloat16>(k, s, xt, &capacity)
                                 : cudaErrorInvalidValue;
  return err == cudaSuccess ? capacity : -static_cast<int>(err);
}

extern "C" int mdt_stem_fwd_smem(int cin, int k, int cout) {
  return fwd_smem(cin, k, cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 24 ? 24 : 32);
}

extern "C" int mdt_stem_wgrad_smem(int cin, int X, int Z, int cout, int k, int sx, int xt) {
  Shape s{1, cin, 1, X, Z, cout, 1, sx, 1, 1};
  return wgrad_smem(s, k, xt);
}

extern "C" const char* mdt_stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
