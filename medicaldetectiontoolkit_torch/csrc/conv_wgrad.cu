// Weight gradient of the 3D convolutions of the FPN and heads for Hopper
// (sm_90a): kernel K5.
//
// K5 replaces no TPU kernel: the JAX package leaves these convolutions to
// XLA. It was added because cuDNN's float32 weight gradients
// (wgrad2d_grouped_direct_kernel and its kin) held about 997 ms of a 1,471 ms
// 3D Retina U-Net training step at LIDC width (68% of the device time) and
// about 190 of 253 ms of a Mask R-CNN step (75%), for the 2.46 TFLOP a step
// that the forward also does: some 2.5 TFLOP/s, 3.7% of the card's float32
// rate, where cuDNN's forward of the same convolutions runs at about 26.
//
// Function: dw[co, ci, ky, kx, kz] = sum over b and the output voxels o of
// dy[b, co, o] * x[b, ci, s * o + k - p], zero outside the input: an
// implicit GEMM of M = cout rows, N = cin * ky * kx * kz columns and a
// reduction K over the batch's output voxels. Channel-first tensors, z
// contiguous: x (B, cin, Y, X, Z), dy (B, cout, Yo, Xo, Zo). Stride (sy, sx,
// 1), sy and sx at most 2 (the port's gate sends only stride-1 convs,
// ops/conv_wgrad.py::admits), padding at most kernel - 1 per axis, no
// dilation, one group. float32 FFMA with float32 sums: no tensor cores, no
// TF32.
//
// What bounds it on the H100: operations, 2 x cout x cin x taps x voxels at
// 67 TFLOP/s (the 62 convolutions it takes in a LIDC Retina U-Net step do
// 1.95 TFLOP, 29 ms at that rate; their x, dy and dw once take about 8 ms at
// 3.35 TB/s). Measured there: 18-30 TFLOP/s at the six largest shapes
// (PERF.md).
//
// Design. The partial pass (conv3d_wgrad_partial_kernel): a block owns a
// tile of dw (every output channel, CT groups of 4 input channels, KYT rows
// of ky, every kx and kz) and one of S slices of the reduction. A slice is a
// run of chunks; a chunk is nb batch elements x ny x nx x nz output voxels.
// For each chunk the block stages in shared memory, by cp.async (16 bytes
// where z rows are whole aligned groups of 4, else 4), the chunk's dy (every
// channel, [co][voxel]) and the haloed window of x its taps read ([ci][b][y]
// [x][z], zeros outside the input), two buffers deep: the next chunk's copy
// is in flight while the block sums the current one. Each thread owns TM
// output channels (co = slot + MS * i) x 4 input channels (ci = group + CT
// * j) x KZT consecutive kz taps of one (ky, kx): TM x 4 x KZT float32
// accumulators (96 at TM 8, KZT 3; 112 at TM 4, KZT 7). It walks every
// voxel of the chunk, z fastest, keeping the x values of its KZT taps in a
// ring of registers: each z step reads TM dy values and 4 new x values from
// shared memory for TM x 4 x KZT FMAs. Row pitches are 4 mod 8 words, so
// the 8 channel slots a warp reads at one voxel fall on 8 bank quads. When
// its slice is done each thread writes its sums to the slice's partial dw
// (no atomics: every entry has one owner). The reduce pass
// (conv3d_wgrad_reduce_kernel) sums the S partials of each entry in slice
// order. S is fixed for a card and shape, and every sum is taken in a fixed
// order, so dw is bit-identical run to run. Tiles, chunks and S come from
// the wrapper's plan (ops/conv_wgrad_cuda.py::plan): the partial scratch is
// at most 16 MB, the grid about one block per SM.
//
// What it admits: float32 x and dy, contiguous and 16-byte aligned for the
// vector path (4-byte copies otherwise), fewer than 2^31 elements each,
// kernels of any size (kz in groups of KZT = 3, or 7 for kz 7; taps past kz
// are summed on zeros and not written), any channel counts (channels past
// cout or cin are zero rows). Built with -fmad=false like the other
// kernels; the sums use explicit __fmaf_rn and add in another order than
// cuDNN and the plain version (ops/conv_wgrad.py), so dw agrees with them to
// float32 rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 384;
constexpr int kReduceThreads = 256;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take on sm_90

// the shapes and the plan of one launch (ops/conv_wgrad_cuda.py::plan)
struct Geo {
  int B, C, Y, X, Z, M, KY, KX, KZ, sy, sx, py, px, pz;  // operands
  int Yo, Xo, Zo;
  int tm, kzt, kzg, ms, ct, kyt, n_ci, n_ky, nb, ny, nx, nz, vec, slices;  // plan
  int wy, wx, wzp, zoff, pdy, pxc, nbc, nyc, nxc, nzc, n_chunks, threads;  // derived
};

// the smallest pitch of at least n words that is 4 mod 8: 8 consecutive rows
// start on 8 different bank quads
__host__ __device__ __forceinline__ int row_pitch(int n) {
  const int p = (n + 3) / 4 * 4;
  return (p / 4) % 2 ? p : p + 4;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// the words of one buffer: dy [ms * tm rows][pdy], then x [4 * ct rows][pxc]
__host__ __device__ __forceinline__ long long buf_words(const Geo& g) {
  return static_cast<long long>(g.ms) * g.tm * g.pdy + 4LL * g.ct * g.pxc;
}

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

// a mixed-radix counter over (q, c, r, b, h), q fastest: the copies of a
// staging pass; a thread starts at its index and steps by the block's
// threads, adding with carries instead of dividing
struct Digits {
  int q, c, r, b, h;
};
__device__ __forceinline__ Digits split(int u, int nq, int nc, int nr, int nbb) {
  Digits d;
  d.q = u % nq, u /= nq;
  d.c = u % nc, u /= nc;
  d.r = u % nr, u /= nr;
  d.b = u % nbb, d.h = u / nbb;
  return d;
}
__device__ __forceinline__ void advance(Digits& d, const Digits& s, int nq, int nc, int nr, int nbb) {
  int carry;
  d.q += s.q, carry = d.q >= nq, d.q -= carry ? nq : 0;
  d.c += s.c + carry, carry = d.c >= nc, d.c -= carry ? nc : 0;
  d.r += s.r + carry, carry = d.r >= nr, d.r -= carry ? nr : 0;
  d.b += s.b + carry, carry = d.b >= nbb, d.b -= carry ? nbb : 0;
  d.h += s.h + carry;
}

// Stage chunk `chunk` of tile (ci tile `cit`, ky tile `kyi`) into buf: dy's
// rows (co, b, y, x) of nz values, then x's window rows (ci, b, wy, wx) of
// wzp values, Q values per copy, zeros outside the tensors
template <int Q>
__device__ __forceinline__ void stage(const float* __restrict__ x, const float* __restrict__ dy, float* buf,
                                      const Geo& g, int chunk, int cit, int kyi) {
  int r = chunk;
  const int oz0 = r % g.nzc * g.nz;
  r /= g.nzc;
  const int ox0 = r % g.nxc * g.nx;
  r /= g.nxc;
  const int oy0 = r % g.nyc * g.ny, b0 = r / g.nyc * g.nb;
  const int T = blockDim.x;

  // dy: digits (q: z / Q, c: x, r: y, b: batch, h: co)
  {
    const int nq = g.nz / Q, total = g.M * g.nb * g.ny * g.nx * nq;
    Digits d = split(threadIdx.x, nq, g.nx, g.ny, g.nb);
    const Digits s = split(T, nq, g.nx, g.ny, g.nb);
    for (int u = threadIdx.x; u < total; u += T, advance(d, s, nq, g.nx, g.ny, g.nb)) {
      const int b = b0 + d.b, oy = oy0 + d.r, ox = ox0 + d.c, oz = oz0 + d.q * Q;
      const bool valid = b < g.B && oy < g.Yo && ox < g.Xo && oz < g.Zo;
      const float* src =
          valid ? dy + ((((static_cast<long long>(b) * g.M + d.h) * g.Yo + oy) * g.Xo + ox) * g.Zo + oz) : dy;
      float* dst = buf + d.h * g.pdy + ((d.b * g.ny + d.r) * g.nx + d.c) * g.nz + d.q * Q;
      cp_async<4 * Q>(dst, src, valid);
    }
  }
  // x: the window's rows of the tile's real input channels
  {
    const int ch0 = cit * 4 * g.ct, chr = min(4 * g.ct, g.C - ch0);
    const int iy0 = oy0 * g.sy - g.py + kyi * g.kyt, ix0 = ox0 * g.sx - g.px, iz0 = oz0 - g.pz - g.zoff;
    const int nq = g.wzp / Q, total = chr * g.nb * g.wy * g.wx * nq;
    float* xs = buf + g.ms * g.tm * g.pdy;
    Digits d = split(threadIdx.x, nq, g.wx, g.wy, g.nb);
    const Digits s = split(T, nq, g.wx, g.wy, g.nb);
    for (int u = threadIdx.x; u < total; u += T, advance(d, s, nq, g.wx, g.wy, g.nb)) {
      const int b = b0 + d.b, iy = iy0 + d.r, ix = ix0 + d.c, iz = iz0 + d.q * Q;
      const bool valid = b < g.B && iy >= 0 && iy < g.Y && ix >= 0 && ix < g.X && iz >= 0 && iz < g.Z;
      const float* src =
          valid ? x + ((((static_cast<long long>(b) * g.C + ch0 + d.h) * g.Y + iy) * g.X + ix) * g.Z + iz) : x;
      float* dst = xs + d.h * g.pxc + ((d.b * g.wy + d.r) * g.wx + d.c) * g.wzp + d.q * Q;
      cp_async<4 * Q>(dst, src, valid);
    }
  }
}

// The partial pass: block (tile, slice) sums its slice's chunks into one
// partial of its tile of dw. blockIdx.x = ci tile * n_ky + ky tile,
// blockIdx.y = slice. A thread's outputs: co = ms + MS * i (i < TM),
// ci = ch0 + cg + CT * j (j < 4), ky = ky0 + kyl, kx, kz = KZT * kzg + t.
template <int TM, int KZT, int Q>
__global__ void __launch_bounds__(kMaxThreads, 1)
    conv3d_wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                                float* __restrict__ partial, const Geo g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long words = buf_words(g);
  const int cit = blockIdx.x / g.n_ky, kyi = blockIdx.x % g.n_ky, slice = blockIdx.y;
  // slice s takes chunks [s * n / S, (s + 1) * n / S): runs of equal length to 1
  const int c_begin = static_cast<int>(static_cast<long long>(slice) * g.n_chunks / g.slices);
  const int c_end = static_cast<int>(static_cast<long long>(slice + 1) * g.n_chunks / g.slices);

  // rows past cout and past the tile's real input channels stay zero
  {
    const int chr = min(4 * g.ct, g.C - cit * 4 * g.ct);
    for (int buf = 0; buf < 2; ++buf) {
      float* b = smem + buf * words;
      for (int i = threadIdx.x; i < (g.ms * TM - g.M) * g.pdy; i += blockDim.x) b[g.M * g.pdy + i] = 0.0f;
      float* xs = b + g.ms * TM * g.pdy;
      for (int i = threadIdx.x; i < (4 * g.ct - chr) * g.pxc; i += blockDim.x) xs[chr * g.pxc + i] = 0.0f;
    }
  }
  if (c_begin < c_end) stage<Q>(x, dy, smem, g, c_begin, cit, kyi);
  cp_async_commit();

  // this thread's place in the tile
  int t = threadIdx.x;
  const int ms = t % g.ms;
  t /= g.ms;
  const int cg = t % g.ct;
  t /= g.ct;
  const int kx = t % g.KX;
  t /= g.KX;
  const int kyl = t % g.kyt, kzg = t / g.kyt;
  const bool active = kzg < g.kzg;

  float acc[KZT][TM][4];
#pragma unroll
  for (int a = 0; a < KZT; ++a)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[a][i][j] = 0.0f;

  const int dstep = g.ms * g.pdy, xstep = g.ct * g.pxc;
  for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
    const float* cur = smem + (it & 1) * words;
    if (c + 1 < c_end) {
      stage<Q>(x, dy, smem + ((it + 1) & 1) * words, g, c + 1, cit, kyi);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's copies have landed, the next chunk's may not
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* dys = cur + ms * g.pdy;
      const float* xs = cur + g.ms * TM * g.pdy + cg * g.pxc + g.zoff + kzg * KZT;
      for (int bb = 0; bb < g.nb; ++bb)
        for (int y = 0; y < g.ny; ++y)
          for (int xx = 0; xx < g.nx; ++xx) {
            const float* dp = dys + ((bb * g.ny + y) * g.nx + xx) * g.nz;
            const float* xp = xs + ((bb * g.wy + y * g.sy + kyl) * g.wx + xx * g.sx + kx) * g.wzp;
            float ring[KZT][4];
#pragma unroll
            for (int a = 0; a < KZT - 1; ++a)
#pragma unroll
              for (int j = 0; j < 4; ++j) ring[a][j] = xp[a + j * xstep];
            for (int oz = 0; oz < g.nz; oz += KZT) {
#pragma unroll
              for (int u = 0; u < KZT; ++u) {
                if (oz + u < g.nz) {
                  float d[TM];
#pragma unroll
                  for (int i = 0; i < TM; ++i) d[i] = dp[oz + u + i * dstep];
#pragma unroll
                  for (int j = 0; j < 4; ++j) ring[(u + KZT - 1) % KZT][j] = xp[oz + u + KZT - 1 + j * xstep];
#pragma unroll
                  for (int a = 0; a < KZT; ++a)
#pragma unroll
                    for (int i = 0; i < TM; ++i)
#pragma unroll
                      for (int j = 0; j < 4; ++j)
                        acc[a][i][j] = __fmaf_rn(d[i], ring[(u + a) % KZT][j], acc[a][i][j]);
                }
              }
            }
          }
    }
    __syncthreads();  // the next iteration stages into this buffer
  }

  if (!active) return;
  const int ky = kyi * g.kyt + kyl;
  if (ky >= g.KY) return;
  const int ch0 = cit * 4 * g.ct;
  const long long mn = static_cast<long long>(g.M) * g.C * g.KY * g.KX * g.KZ;
  float* out = partial + slice * mn;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int co = ms + g.ms * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ch0 + cg + g.ct * j;
      if (co < g.M && ci < g.C) {
        float* o = out + ((static_cast<long long>(co) * g.C + ci) * g.KY + ky) * g.KX * g.KZ + kx * g.KZ;
#pragma unroll
        for (int a = 0; a < KZT; ++a)
          if (kzg * KZT + a < g.KZ) o[kzg * KZT + a] = acc[a][i][j];
      }
    }
  }
}

// The reduce pass: dw[e] = partial[0][e] + partial[1][e] + ... in slice order.
__global__ void __launch_bounds__(kReduceThreads)
    conv3d_wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int slices, long long mn) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < mn;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = partial[e];
    int s = 1;
    for (; s + 4 <= slices; s += 4) {
      const float a = partial[s * mn + e], b = partial[(s + 1) * mn + e], c = partial[(s + 2) * mn + e],
                  d = partial[(s + 3) * mn + e];
      sum = sum + a;
      sum = sum + b;
      sum = sum + c;
      sum = sum + d;
    }
    for (; s < slices; ++s) sum = sum + partial[s * mn + e];
    dw[e] = sum;
  }
}

// the shapes and plan of a launch, checked and completed; false where the
// kernel does not take them
bool make_geo(const int* shape, const int* plan, Geo* out) {
  Geo g;
  g.B = shape[0], g.C = shape[1], g.Y = shape[2], g.X = shape[3], g.Z = shape[4], g.M = shape[5];
  g.KY = shape[6], g.KX = shape[7], g.KZ = shape[8], g.sy = shape[9], g.sx = shape[10];
  g.py = shape[11], g.px = shape[12], g.pz = shape[13];
  g.tm = plan[0], g.kzt = plan[1], g.kzg = plan[2], g.ms = plan[3], g.ct = plan[4], g.kyt = plan[5];
  g.n_ci = plan[6], g.n_ky = plan[7], g.nb = plan[8], g.ny = plan[9], g.nx = plan[10], g.nz = plan[11];
  g.vec = plan[12], g.slices = plan[13];
  if (g.B < 1 || g.C < 1 || g.M < 1 || g.KY < 1 || g.KX < 1 || g.KZ < 1 || g.sy < 1 || g.sy > 2 || g.sx < 1 ||
      g.sx > 2 || g.py < 0 || g.py >= g.KY || g.px < 0 || g.px >= g.KX || g.pz < 0 || g.pz >= g.KZ)
    return false;
  g.Yo = (g.Y + 2 * g.py - g.KY) / g.sy + 1, g.Xo = (g.X + 2 * g.px - g.KX) / g.sx + 1;
  g.Zo = g.Z + 2 * g.pz - g.KZ + 1;
  if (g.Y + 2 * g.py < g.KY || g.X + 2 * g.px < g.KX || g.Zo < 1) return false;
  if (!((g.tm == 8 && g.kzt == 3) || (g.tm == 4 && (g.kzt == 3 || g.kzt == 7))) || g.kzg * g.kzt < g.KZ ||
      g.ms * g.tm < g.M || g.ct < 1 || g.n_ci * 4 * g.ct < g.C || g.kyt < 1 ||
      g.n_ky * g.kyt < g.KY || g.nb < 1 || g.ny < 1 || g.nx < 1 || g.nz < 1 || g.slices < 1 ||
      (g.vec != 0 && g.vec != 1))
    return false;
  if (g.vec && (g.Z % 4 || g.Zo % 4 || g.nz % 4)) return false;
  const int q = g.vec ? 4 : 1;
  g.wy = (g.ny - 1) * g.sy + g.kyt, g.wx = (g.nx - 1) * g.sx + g.KX;
  g.zoff = g.vec ? (4 - g.pz % 4) % 4 : 0;
  g.wzp = (g.zoff + g.nz + g.kzg * g.kzt - 1 + q - 1) / q * q;
  g.pdy = row_pitch(g.nb * g.ny * g.nx * g.nz), g.pxc = row_pitch(g.nb * g.wy * g.wx * g.wzp);
  g.nbc = cdiv(g.B, g.nb), g.nyc = cdiv(g.Yo, g.ny), g.nxc = cdiv(g.Xo, g.nx), g.nzc = cdiv(g.Zo, g.nz);
  const long long chunks = static_cast<long long>(g.nbc) * g.nyc * g.nxc * g.nzc;
  const long long threads = static_cast<long long>(g.ms) * g.ct * g.kyt * g.KX * g.kzg;
  if (chunks >= (1LL << 31) || g.slices > chunks || threads > kMaxThreads || 2 * buf_words(g) * 4 > kSmemMax)
    return false;
  g.n_chunks = static_cast<int>(chunks), g.threads = static_cast<int>((threads + 31) / 32 * 32);
  *out = g;
  return true;
}

template <int TM, int KZT, int Q>
cudaError_t launch_partial(const float* x, const float* dy, float* partial, const Geo& g, cudaStream_t st) {
  auto kernel = conv3d_wgrad_partial_kernel<TM, KZT, Q>;
  const int smem = static_cast<int>(2 * buf_words(g) * 4);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.n_ci * g.n_ky, g.slices), g.threads, smem, st>>>(x, dy, partial, g);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch_q(const float* x, const float* dy, float* partial, const Geo& g, cudaStream_t st) {
  if (g.tm == 8) return launch_partial<8, 3, Q>(x, dy, partial, g, st);
  if (g.kzt == 3) return launch_partial<4, 3, Q>(x, dy, partial, g, st);
  return launch_partial<4, 7, Q>(x, dy, partial, g, st);
}

}  // namespace

// K5. x float32 (B, cin, Y, X, Z), dy float32 (B, cout, Yo, Xo, Zo), both
// contiguous (and 16-byte aligned where plan[12], vec, is 1); partial float32
// scratch (slices, cout * cin * ky * kx * kz); dw float32 (cout, cin, ky,
// kx, kz). shape: B, cin, Y, X, Z, cout, ky, kx, kz, sy, sx, py, px, pz;
// plan: tm, kzt, kzg, ms, ct, kyt, n_ci, n_ky, nb, ny, nx, nz, vec, slices
// (ops/conv_wgrad_cuda.py::plan). Enqueues both passes on `stream`.
extern "C" int mdt_conv_wgrad_launch(const float* x, const float* dy, float* partial, float* dw, const int* shape,
                                     const int* plan, void* stream) {
  Geo g;
  if (!make_geo(shape, plan, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const long long mn = static_cast<long long>(g.M) * g.C * g.KY * g.KX * g.KZ;
  if (mn * g.slices >= (1LL << 31) ||
      static_cast<long long>(g.B) * g.C * g.Y * g.X * g.Z >= (1LL << 31) ||
      static_cast<long long>(g.B) * g.M * g.Yo * g.Xo * g.Zo >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = g.vec ? launch_q<4>(x, dy, partial, g, st) : launch_q<1>(x, dy, partial, g, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (mn + kReduceThreads - 1) / kReduceThreads;
  conv3d_wgrad_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), kReduceThreads, 0, st>>>(
      partial, dw, g.slices, mn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mdt_conv_wgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
