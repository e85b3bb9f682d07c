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
// conv0) is split into chunks of (b, yo, xt columns of xo). A block stages
// its chunk's g tile (cout x xt x Z) and x tile (cin x k rows x the columns
// the tile reads x Z + 2p) in shared memory as float32, then each thread
// takes jobs (ci, ky, kx, co) and sums k taps along z with a sliding window
// of k x values in registers: two shared loads per k FMAs. Each block writes
// its partial dw to a float32 buffer; a second launch sums the partials in
// chunk order. No atomics: two runs give bit-identical dw.
//
// What bounds them on the H100: K3 at the LIDC C1 stem (batch 8, k 7, cout
// 18) is about 26 GFLOP, 0.39 ms at 67 TFLOP/s of float32 FMA; at conv0 (k 3,
// batch 2) it writes 151 MB of float32 for 2 GFLOP, so device memory bounds
// it (45 us at 3.35 TB/s). K4 does the same operations as K3 on the same
// inputs. Built with -fmad=false like the other kernels; the sums use
// explicit __fmaf_rn, so they are not bit-identical to the plain PyTorch
// versions (ops/stem_conv.py), which sum the taps in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 128;
constexpr int kZT = 4;  // z outputs per K3 thread
constexpr int kWgThreads = 256;
constexpr int kReduceThreads = 128;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take on sm_90

struct Shape {
  int B, cin, Y, X, Z, cout, sy, sx, Yo, Xo;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// float32 sum -> compute dtype -> + bias in the compute dtype
__device__ __forceinline__ float finish(float acc, float bias) { return acc + bias; }
__device__ __forceinline__ __nv_bfloat16 finish(float acc, __nv_bfloat16 bias) {
  return __float2bfloat16(__bfloat162float(__float2bfloat16(acc)) + __bfloat162float(bias));
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

// K4, first pass: one block per chunk (b, yo, xt columns of xo), its partial
// dw (cout, cin, K, K, K) into partials[chunk].
template <typename T, int K>
__global__ void __launch_bounds__(kWgThreads) stem_wgrad_partial_kernel(const T* __restrict__ x,
                                                                       const T* __restrict__ g,
                                                                       float* __restrict__ partials, const Shape s,
                                                                       int xt) {
  extern __shared__ float smem[];
  constexpr int P = K / 2;
  const int W = s.sx * (xt - 1) + K;  // x columns the tile reads
  const int ZP = s.Z + 2 * P;
  const int gstride = xt * s.Z + 1;  // +1: the co rows of one warp fall on different banks
  float* gs = smem;                   // [cout][xt][Z]
  float* xs = smem + s.cout * gstride;  // [cin][K][W][ZP]

  const int n_xt = (s.Xo + xt - 1) / xt;
  const int chunk = blockIdx.x;
  const int xo0 = (chunk % n_xt) * xt;
  const int row = chunk / n_xt;
  const int yo = row % s.Yo, b = row / s.Yo;

  for (int i = threadIdx.x; i < s.cout * xt * s.Z; i += blockDim.x) {
    const int z = i % s.Z;
    const int r = i / s.Z;
    const int j = r % xt, co = r / xt;
    const int xo = xo0 + j;
    gs[co * gstride + j * s.Z + z] =
        xo < s.Xo ? to_f32(g[(((static_cast<long long>(b) * s.cout + co) * s.Yo + yo) * s.Xo + xo) * s.Z + z]) : 0.0f;
  }
  const int y0 = yo * s.sy - P, x0 = xo0 * s.sx - P;
  for (int i = threadIdx.x; i < s.cin * K * W * ZP; i += blockDim.x) {
    const int zp = i % ZP;
    int r = i / ZP;
    const int c = r % W;
    r /= W;
    const int ky = r % K, ci = r / K;
    const int yi = y0 + ky, xi = x0 + c, zi = zp - P;
    xs[i] = (yi >= 0 && yi < s.Y && xi >= 0 && xi < s.X && zi >= 0 && zi < s.Z)
                ? to_f32(x[(((static_cast<long long>(b) * s.cin + ci) * s.Y + yi) * s.X + xi) * s.Z + zi])
                : 0.0f;
  }
  __syncthreads();

  const int n_jobs = s.cin * K * K * s.cout;
  float* part = partials + static_cast<long long>(chunk) * s.cout * s.cin * K * K * K;
  for (int job = threadIdx.x; job < n_jobs; job += blockDim.x) {
    const int co = job % s.cout;  // neighbouring threads: other co, same taps
    int r = job / s.cout;
    const int kx = r % K;
    r /= K;
    const int ky = r % K, ci = r / K;
    float acc[K];
#pragma unroll
    for (int kz = 0; kz < K; ++kz) acc[kz] = 0.0f;
    for (int j = 0; j < xt; ++j) {
      const float* xr = xs + ((ci * K + ky) * W + s.sx * j + kx) * ZP;  // padded z row
      const float* gr = gs + co * gstride + j * s.Z;
      float win[K];  // win[kz] = xr[z + kz]
#pragma unroll
      for (int i = 0; i < K - 1; ++i) win[i] = xr[i];
      for (int z = 0; z < s.Z; ++z) {
        win[K - 1] = xr[z + K - 1];
        const float gv = gr[z];
#pragma unroll
        for (int kz = 0; kz < K; ++kz) acc[kz] = __fmaf_rn(win[kz], gv, acc[kz]);
#pragma unroll
        for (int i = 0; i < K - 1; ++i) win[i] = win[i + 1];
      }
    }
    float* o = part + (((co * s.cin + ci) * K + ky) * K + kx) * K;
#pragma unroll
    for (int kz = 0; kz < K; ++kz) o[kz] = acc[kz];
  }
}

// K4, second pass: dw[o] = sum of the partials in chunk order.
__global__ void __launch_bounds__(kReduceThreads) stem_wgrad_reduce_kernel(const float* __restrict__ partials,
                                                                          float* __restrict__ dw, int n_chunks,
                                                                          int n_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float sum = 0.0f;
  for (int c = 0; c < n_chunks; ++c) sum += partials[static_cast<long long>(c) * n_out + o];
  dw[o] = sum;
}

int fwd_smem(int cin, int k, int cmax) { return cin * k * k * k * cmax * 4; }

int wgrad_smem(const Shape& s, int k, int xt) {
  return (s.cout * (xt * s.Z + 1) + s.cin * k * (s.sx * (xt - 1) + k) * (s.Z + 2 * (k / 2))) * 4;
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

template <typename T, int K>
cudaError_t launch_wgrad(const void* x, const void* g, float* partials, float* dw, const Shape& s, int xt,
                         cudaStream_t st) {
  const int smem = wgrad_smem(s, K, xt);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(stem_wgrad_partial_kernel<T, K>, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = s.B * s.Yo * ((s.Xo + xt - 1) / xt);
  stem_wgrad_partial_kernel<T, K><<<n_chunks, kWgThreads, smem, st>>>(static_cast<const T*>(x),
                                                                      static_cast<const T*>(g), partials, s, xt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = s.cout * s.cin * K * K * K;
  stem_wgrad_reduce_kernel<<<(n_out + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, st>>>(
      partials, dw, n_chunks, n_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad_k(int k, const void* x, const void* g, float* partials, float* dw, const Shape& s, int xt,
                           cudaStream_t st) {
  switch (k) {
    case 3: return launch_wgrad<T, 3>(x, g, partials, dw, s, xt, st);
    case 5: return launch_wgrad<T, 5>(x, g, partials, dw, s, xt, st);
    case 7: return launch_wgrad<T, 7>(x, g, partials, dw, s, xt, st);
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
// (B * Yo * ceil(Xo / xt), cout * cin * k^3) scratch, dw float32 (cout, cin,
// k, k, k).
extern "C" int mdt_stem_wgrad_launch(const void* x, const void* g, float* partials, float* dw, int dtype, int B,
                                     int cin, int Y, int X, int Z, int cout, int k, int sy, int sx, int xt,
                                     void* stream) {
  Shape s;
  if (!make_shape(B, cin, Y, X, Z, cout, sy, sx, &s) || xt < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch_wgrad_k<float>(k, x, g, partials, dw, s, xt, st)
                    : dtype == 1 ? launch_wgrad_k<__nv_bfloat16>(k, x, g, partials, dw, s, xt, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
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
