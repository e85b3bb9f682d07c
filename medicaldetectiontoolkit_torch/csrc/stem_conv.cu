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
// K3: the outputs are cut into tiles (one b, ty rows of yo, tx columns of
// xo, zt blocks of 4 z values, every channel; conv0 and the C1 stem: 2 x 8 x
// 16, 256 threads). A persistent grid of G = min(tiles, blocks per SM x
// SMs) blocks walks them: block i takes tiles i, i + G, ... It stages the
// filter once (float32 [cin][ky][kx][kz][CO rounded up to 4], read in w's
// order so that the loads are coalesced) and each tile's zero-padded input
// ((ty - 1) * sy + k rows x (tx - 1) * sx + k columns x 4 * zt + 8 z values
// per cin, in x's dtype) in shared memory, by 16-byte (float32) or 8-byte
// (bf16) cp.async per group of 4 values, zeros for the padding. With two
// tile buffers (where two blocks of them still fit on an SM) the next
// tile's copy is in flight while the block sums the current one. The tap
// loop reads only shared memory, with no bounds test: per (ci, ky, kx) 3
// aligned groups of 4 x values, per kz CO / 4 broadcast float4s (and a
// float2 when CO = 18) of the filter for 4 x CO FMAs. Each thread sums 4
// consecutive z outputs of exactly CO channels in float32 registers: CO =
// 18 for every 3D stem of the repo, else the next multiple of 8. It writes
// each channel's 4 values as one 16- or 8-byte store; lanes run along z then
// xo, so a warp's store covers contiguous bytes of one (b, co, yo) plane
// (scalar stores where Z % 4 != 0). The tiles, buffers and shared memory
// come from the wrapper's plan (ops/stem_conv_cuda.py::fwd_plan).
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
// it (48 us at 3.35 TB/s). Measured on an H100 at 700 W, K3 takes 0.082 ms
// at conv0 (f32 and bf16) and 0.595 ms at C1 f32: the sums run at about 65%
// of the FMA pipe's issue rate (conv0 without its stores takes 0.065 ms; a
// third of the shared loads of the filter moves it by 2%), and at conv0 the
// stores alone take 0.063 ms in f32; the two overlap in part. 125 / 121
// registers (k 3 / k 7) leave 2 blocks of 256 threads per SM. The sums are
// on CUDA cores in bf16 too: a tensor-core version rounds its float32 sums
// otherwise, and the training A/B against cuDNN's stem then leaves its
// tolerance (PERF.md). K4 does the same operations as K3 on the same
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

constexpr int kFwdThreads = 256;
constexpr int kZT = 4;  // z outputs per K3 thread
constexpr int kWgThreads = 256;
constexpr int kReduceThreads = 128;
constexpr int kStage = 4;  // K4's staging loads in flight per thread
constexpr int kWStage = 16;  // K3's filter loads in flight per thread
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

// K3's tile: one b, ty rows of yo, tx columns of xo and zt blocks of 4 z
// values, for every channel; thread t takes z block t % zt of column
// (t / zt) % tx of row t / (zt * tx). Tiles are numbered with z tiles
// fastest, then xo, yo and b. The staged input of a tile is cin x fwd_rows x
// fwd_cols rows of 4 * fwd_nq(zt) values in x's dtype, zero where the input
// is padding: value j of a row holds input z = 4 * zb0 - 4 + j (zb0 the
// tile's first z block), so a thread's 4 + k - 1 inputs lie in the 3
// aligned groups of 4 from value 4 * (its z block - zb0). A row holds an
// odd number of groups, so that rows sx apart fall on other banks. The
// filter sits before it as float32 [cin][k][k][k][fwd_cs(CO)], then nbuf
// tile buffers.
__host__ __device__ __forceinline__ int fwd_rows(int ty, int sy, int k) { return (ty - 1) * sy + k; }
__host__ __device__ __forceinline__ int fwd_cols(int tx, int sx, int k) { return (tx - 1) * sx + k; }
__host__ __device__ __forceinline__ int fwd_nq(int zt) { return (zt + 2) | 1; }
__host__ __device__ constexpr int fwd_cs(int co) { return (co + 3) / 4 * 4; }
// channels K3 accumulates for cout: 18 exactly (every 3D stem of the
// repo), else the next multiple of 8
constexpr int fwd_co(int cout) { return cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 18 ? 18 : cout <= 24 ? 24 : 32; }

// 4 values as one store of 16 (float32) or 8 (bf16) bytes, to device or
// shared memory; and 4 values read back as float32
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat16 v[4]) {
  __nv_bfloat162 lo, hi;
  lo.x = v[0], lo.y = v[1], hi.x = v[2], hi.y = v[3];
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat16 h[4] = {__float2bfloat16(v[0]), __float2bfloat16(v[1]), __float2bfloat16(v[2]),
                              __float2bfloat16(v[3])};
  store4(p, h);
}
__device__ __forceinline__ void read4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void read4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// an asynchronous copy of one group of 4 values (16 or 8 bytes) into shared
// memory, the groups a thread issued since its last commit made one group
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

struct FwdTiles {
  int zt, tx, ty, rows, cols, nq, n_zt, n_xt, n_yt, n_tiles;
};

// Stage tile `tile`'s input into xs: a group of 4 values per item, by
// cp.async where the group is whole and aligned (vec), else loaded,
// converted and stored; zeros for the padding
template <typename T, int K>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, T* xs, const Shape& s, const FwdTiles& t,
                                           int tile, bool vec) {
  constexpr int P = K / 2;
  const int zb0 = tile % t.n_zt * t.zt;
  int r = tile / t.n_zt;
  const int x0 = r % t.n_xt * t.tx * s.sx - P;
  r /= t.n_xt;
  const int y0 = r % t.n_yt * t.ty * s.sy - P, b = r / t.n_yt;
  const int z0 = kZT * zb0 - 4;
  const int n_items = s.cin * t.rows * t.cols * t.nq;
  const float inv_nq = 1.0f / t.nq, inv_cols = 1.0f / t.cols, inv_rows = 1.0f / t.rows;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    int q, c, ry;
    const int rc = div_small(item, t.nq, inv_nq, &q);
    const int cr = div_small(rc, t.cols, inv_cols, &c);
    const int ci = div_small(cr, t.rows, inv_rows, &ry);
    const int yi = y0 + ry, xi = x0 + c, z = z0 + 4 * q;
    T* dst = xs + 4 * item;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (yi >= 0 && yi < s.Y && xi >= 0 && xi < s.X && z >= 0 && z < s.Z) {
      const T* src = x + (((static_cast<long long>(b) * s.cin + ci) * s.Y + yi) * s.X + xi) * s.Z + z;
      if (vec) {
        cp_async<4 * sizeof(T)>(dst, src);
        continue;
      }
      load4(src, s.Z - z, false, v);
    }
    store4(dst, v);
  }
}

// K3: a persistent grid; block i takes tiles i, i + G, i + 2G, ... It stages
// the filter once, and each tile's input in one of nbuf buffers: with two,
// the next tile's copy is in flight while the block sums the current one.
// Each thread sums 4 z outputs x CO channels in float32 registers and
// writes each channel's 4 values as one store. vec_in: x's rows are whole
// aligned groups of 4 (Z % 4 == 0, x aligned); vec_out: the same for out.
template <typename T, int K, int CO>
__global__ void __launch_bounds__(kFwdThreads) stem_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                                              const T* __restrict__ bias, T* __restrict__ out,
                                                              const Shape s, const FwdTiles t, int nbuf, bool vec_in,
                                                              bool vec_out) {
  static_assert(CO % 2 == 0, "the filter is read in float4s and one float2");
  constexpr int P = K / 2, CS = fwd_cs(CO);
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [cin][K][K][K][CS]
  const int n_taps = s.cin * K * K * K;
  T* xs = reinterpret_cast<T*>(ws + n_taps * CS);  // nbuf x [cin][rows][cols][4 nq]
  const int tile_len = s.cin * t.rows * t.cols * 4 * t.nq;

  int tile = blockIdx.x;
  if (tile < t.n_tiles) stage_tile<T, K>(x, xs, s, t, tile, vec_in);
  cp_async_commit();

  // the filter, read in w's order (co, tap) so that a warp's loads are
  // coalesced, kWStage in flight per thread; zeros past cout
  const int n_w = s.cout * n_taps;
  const float inv_taps = 1.0f / n_taps;
  for (int base = threadIdx.x; base < n_w; base += kWStage * blockDim.x) {
    float v[kWStage];
#pragma unroll
    for (int u = 0; u < kWStage; ++u) {
      const int i = base + u * blockDim.x;
      v[u] = i < n_w ? to_f32(w[i]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kWStage; ++u) {
      const int i = base + u * blockDim.x;
      int tap;
      const int co = div_small(i, n_taps, inv_taps, &tap);
      if (i < n_w) ws[tap * CS + co] = v[u];
    }
  }
  for (int i = threadIdx.x; i < n_taps * (CS - s.cout); i += blockDim.x) {
    int c;
    const int tap = div_small(i, CS - s.cout, 1.0f / (CS - s.cout), &c);
    ws[tap * CS + s.cout + c] = 0.0f;
  }

  const int zl = threadIdx.x % t.zt, xl = threadIdx.x / t.zt % t.tx, yl = threadIdx.x / t.zt / t.tx;
  const int nzb = (s.Z + kZT - 1) / kZT;
  const long long plane = static_cast<long long>(s.Yo) * s.Xo * s.Z;
  for (int it = 0; tile < t.n_tiles; ++it, tile += gridDim.x) {
    const T* cur = xs + (nbuf == 2 ? it & 1 : 0) * tile_len;
    const int next = tile + gridDim.x;
    if (nbuf == 2) {
      if (next < t.n_tiles) stage_tile<T, K>(x, xs + ((it + 1) & 1) * tile_len, s, t, next, vec_in);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies have landed, the next tile's may not
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int zb = tile % t.n_zt * t.zt + zl;
    int r = tile / t.n_zt;
    const int xo = r % t.n_xt * t.tx + xl;
    r /= t.n_xt;
    const int yo = r % t.n_yt * t.ty + yl, b = r / t.n_yt;
    if (yl < t.ty && yo < s.Yo && xo < s.Xo && zb < nzb) {
      float acc[kZT][CO];
#pragma unroll
      for (int zt4 = 0; zt4 < kZT; ++zt4)
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[zt4][co] = 0.0f;

      for (int ci = 0; ci < s.cin; ++ci) {
        for (int ky = 0; ky < K; ++ky) {
          // column kx of this (ci, ky): 3 groups of 4 from xr + kx * 4 nq
          const T* xr = cur + (((ci * t.rows + yl * s.sy + ky) * t.cols + xl * s.sx) * t.nq + zl) * 4;
          const float* wk = ws + (ci * K + ky) * K * K * CS;
          for (int kx = 0; kx < K; ++kx) {
            float q12[12];  // q12[4 - P + i] = input z = 4 * zb - P + i
            read4(xr + kx * 4 * t.nq, q12);
            read4(xr + kx * 4 * t.nq + 4, q12 + 4);
            read4(xr + kx * 4 * t.nq + 8, q12 + 8);
            const float* wt = wk + kx * K * CS;
#pragma unroll
            for (int kz = 0; kz < K; ++kz) {
              float wv[CO];
#pragma unroll
              for (int c4 = 0; c4 < CO / 4; ++c4) {
                const float4 f = reinterpret_cast<const float4*>(wt + kz * CS)[c4];
                wv[4 * c4] = f.x, wv[4 * c4 + 1] = f.y, wv[4 * c4 + 2] = f.z, wv[4 * c4 + 3] = f.w;
              }
              if (CO % 4) {
                const float2 f = *reinterpret_cast<const float2*>(wt + kz * CS + CO / 4 * 4);
                wv[CO - 2] = f.x, wv[CO - 1] = f.y;
              }
#pragma unroll
              for (int zt4 = 0; zt4 < kZT; ++zt4) {
                const float xv = q12[4 - P + zt4 + kz];
#pragma unroll
                for (int co = 0; co < CO; ++co) acc[zt4][co] = __fmaf_rn(xv, wv[co], acc[zt4][co]);
              }
            }
          }
        }
      }

      const int z = kZT * zb;
      const bool whole = vec_out && z + kZT <= s.Z;
      T* o = out + ((static_cast<long long>(b) * s.cout * s.Yo + yo) * s.Xo + xo) * s.Z + z;
#pragma unroll
      for (int co = 0; co < CO; ++co) {
        if (co >= s.cout) break;
        const T bv = bias[co];
        T v[kZT];
#pragma unroll
        for (int zt4 = 0; zt4 < kZT; ++zt4) v[zt4] = finish(acc[zt4][co], bv);
        if (whole) {
          store4(o + co * plane, v);
        } else {
#pragma unroll
          for (int zt4 = 0; zt4 < kZT; ++zt4)
            if (z + zt4 < s.Z) o[co * plane + zt4] = v[zt4];
        }
      }
    }
    __syncthreads();  // the tile is read; its buffer may be staged again
    if (nbuf == 1 && next < t.n_tiles) {
      stage_tile<T, K>(x, xs, s, t, next, vec_in);
      cp_async_commit();
    }
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

FwdTiles fwd_tiles(const Shape& s, int k, int zt, int tx, int ty) {
  FwdTiles t{zt, tx, ty, fwd_rows(ty, s.sy, k), fwd_cols(tx, s.sx, k), fwd_nq(zt), 0, 0, 0, 0};
  t.n_zt = ((s.Z + kZT - 1) / kZT + zt - 1) / zt;
  t.n_xt = (s.Xo + tx - 1) / tx;
  t.n_yt = (s.Yo + ty - 1) / ty;
  const long long n = static_cast<long long>(s.B) * t.n_yt * t.n_xt * t.n_zt;
  t.n_tiles = n < (1LL << 31) ? static_cast<int>(n) : -1;
  return t;
}

long long fwd_smem(const Shape& s, int k, int item, const FwdTiles& t, int nbuf) {
  return (static_cast<long long>(s.cin) * k * k * k * fwd_cs(fwd_co(s.cout)) * 4 +
          static_cast<long long>(nbuf) * s.cin * t.rows * t.cols * 4 * t.nq * item);
}

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

template <typename T, int K, int CO>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* out, const Shape& s, int zt, int tx,
                       int ty, int nbuf, int grid, cudaStream_t st) {
  const FwdTiles t = fwd_tiles(s, K, zt, tx, ty);
  const long long smem = fwd_smem(s, K, sizeof(T), t, nbuf);
  if (smem > kSmemMax || t.n_tiles < 1 || grid < 1 || grid > t.n_tiles) return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % (kZT * sizeof(T)) == 0; };
  const bool vec = s.Z % kZT == 0;
  stem_fwd_kernel<T, K, CO><<<grid, (zt * tx * ty + 31) / 32 * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(out), s, t,
      nbuf, vec && aligned(x), vec && aligned(out));
  return cudaGetLastError();
}

// K3's blocks resident on the current device at once (blocks per SM x SMs)
// for a block of `threads` and `smem` bytes, after allowing the instance the
// most dynamic shared memory a block has
template <typename T, int K, int CO>
cudaError_t fwd_capacity(int threads, int smem, int* capacity) {
  auto kernel = stem_fwd_kernel<T, K, CO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *capacity = per_sm * sms;
  return cudaSuccess;
}

// K3's instance for (dtype, k, cout): its launch, or (capacity != nullptr)
// its occupancy query
struct FwdCall {
  const void *x, *w, *b;
  void* out;
  Shape s;
  int zt, tx, ty, nbuf, grid;
  cudaStream_t st;
  int threads, smem;
  int* capacity;
};

template <typename T, int K, int CO>
cudaError_t fwd_op(const FwdCall& c) {
  if (c.capacity) return fwd_capacity<T, K, CO>(c.threads, c.smem, c.capacity);
  return launch_fwd<T, K, CO>(c.x, c.w, c.b, c.out, c.s, c.zt, c.tx, c.ty, c.nbuf, c.grid, c.st);
}

template <typename T, int K>
cudaError_t fwd_c(const FwdCall& c) {
  switch (fwd_co(c.s.cout)) {
    case 8: return fwd_op<T, K, 8>(c);
    case 16: return fwd_op<T, K, 16>(c);
    case 18: return fwd_op<T, K, 18>(c);
    case 24: return fwd_op<T, K, 24>(c);
    default: return fwd_op<T, K, 32>(c);
  }
}

template <typename T>
cudaError_t fwd_k(int k, const FwdCall& c) {
  switch (k) {
    case 3: return fwd_c<T, 3>(c);
    case 5: return fwd_c<T, 5>(c);
    case 7: return fwd_c<T, 7>(c);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t fwd_dtype(int dtype, int k, const FwdCall& c) {
  return dtype == 0 ? fwd_k<float>(k, c) : dtype == 1 ? fwd_k<__nv_bfloat16>(k, c) : cudaErrorInvalidValue;
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
// 1 bfloat16. k in {3, 5, 7}, cout <= 32; tiles of zt z blocks, tx xo
// columns and ty yo rows (zt * tx * ty <= kFwdThreads), nbuf (1 or 2) tile
// buffers and a grid of 1 to the number of tiles blocks, as the wrapper's
// plan gives them. mdt_stem_fwd_capacity must have run on the device for
// this dtype, k and cout: the launch sets no function attribute.
extern "C" int mdt_stem_fwd_launch(const void* x, const void* w, const void* b, void* out, int dtype, int B, int cin,
                                   int Y, int X, int Z, int cout, int k, int sy, int sx, int zt, int tx, int ty,
                                   int nbuf, int grid, void* stream) {
  Shape s;
  if (!make_shape(B, cin, Y, X, Z, cout, sy, sx, &s) || zt < 1 || tx < 1 || ty < 1 ||
      zt * tx * ty > kFwdThreads || nbuf < 1 || nbuf > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdCall c{x, w, b, out, s, zt, tx, ty, nbuf, grid, static_cast<cudaStream_t>(stream), 0, 0, nullptr};
  return static_cast<int>(fwd_dtype(dtype, k, c));
}

// K3's blocks resident at once on the current device (blocks per SM x SMs)
// for this dtype, k and cout, `threads` per block and `smem` bytes of
// dynamic shared memory; the instance is allowed the most shared memory a
// block has first. A negative CUDA error code on failure.
extern "C" int mdt_stem_fwd_capacity(int dtype, int k, int cout, int threads, int smem) {
  Shape s{1, 1, 1, 1, 1, cout, 1, 1, 1, 1};
  int capacity = 0;
  FwdCall c{nullptr, nullptr, nullptr, nullptr, s, 1, 1, 1, 1, 1, nullptr, threads, smem, &capacity};
  const cudaError_t err = cout < 1 || cout > 32 || threads < 1 || threads > kFwdThreads || smem < 0 ||
                                  smem > kSmemMax
                              ? cudaErrorInvalidValue
                              : fwd_dtype(dtype, k, c);
  return err == cudaSuccess ? capacity : -static_cast<int>(err);
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

// K3's dynamic shared memory in bytes: the filter and nbuf staged input
// tiles of zt z blocks, tx xo columns and ty yo rows, of `item` bytes a value.
extern "C" long long mdt_stem_fwd_smem(int cin, int cout, int k, int sy, int sx, int zt, int tx, int ty, int item,
                                       int nbuf) {
  Shape s{1, cin, 1, 1, 1, cout, sy, sx, 1, 1};
  return fwd_smem(s, k, item, fwd_tiles(s, k, zt, tx, ty), nbuf);
}

extern "C" int mdt_stem_wgrad_smem(int cin, int X, int Z, int cout, int k, int sx, int xt) {
  Shape s{1, cin, 1, X, Z, cout, 1, sx, 1, 1};
  return wgrad_smem(s, k, xt);
}

extern "C" const char* mdt_stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
