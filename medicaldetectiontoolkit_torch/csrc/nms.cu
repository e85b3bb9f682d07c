// Batched fixed-shape greedy NMS (2D + 3D) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medicaldetectiontoolkit_tpu/ops/nms_pallas.py
// ::nms_pallas (kernel body _nms_kernel_factory). Same contract: one lane per
// (batch element x class) problem; greedy selection in descending score order
// (ties -> lower index), each kept box suppressing every later box whose IoU
// with it, with the +pixel_offset convention, is > thresh (strict); at most
// max_output boxes kept; idx -1 / mask 0 after the last kept box.
//
// Design: one CTA of kThreads threads per lane, in three parts.
//   1. Compaction. One pass over the lane's N entries in index order keeps
//      those with valid set and a score above -inf (warp ballots, a block
//      prefix per chunk of kChunk entries) and stores their score and
//      original index. The lane's store is SoA, 36 B per 3D entry
//      (coordinates, area, score, index), in dynamic shared memory: about
//      6,000 entries in the 227 KB a block can use; positions beyond that go
//      to a per-lane global scratch the wrapper allocates. A broadcast lane
//      (lane stride 0) thus works on its own candidates only: ~3,100 of
//      Retina U-Net's 50,000, ~500 of Mask R-CNN's 8,000. Coordinates are
//      gathered later, only for the candidates a part below reaches.
//   2. Sorted lanes (the compacted scores do not increase with position, as
//      after the callers' top_k): greedy NMS by argmax is then a walk in
//      position order. The argmax of the active scores is always the first
//      active entry (a later entry's score is no larger, and ties go to the
//      lower index), so a candidate is kept exactly when no box kept before
//      it suppresses it; no argmax is needed. The walk goes in tiles: the
//      first as wide as the keep slots left (rounded up to 32), each next
//      one twice as wide, up to kTile. Each column's box is gathered and
//      tested against the boxes kept so far; the survivors' rows of a tile x
//      tile suppression bitmask come one IoU per lane and a warp ballot per
//      word; one warp resolves the tile in order, keeping a run of candidates
//      whose rows suppress nothing in one step. Kept boxes are copied to the
//      front of the store (slot <= position, so nothing unread is
//      overwritten). The walk stops at max_output kept.
//   3. Unsorted lanes (Mask R-CNN's class-wise refinement): max_output
//      argmax-and-suppress steps as in the TPU kernel, over the compacted
//      candidates' gathered boxes, by about one warp per 64 candidates (up to
//      kRegMax candidates, two per thread held in registers); one named
//      barrier per step, the argmax a pair of warp reductions (redux.sync) on
//      an order-preserving key.
//   A lane whose candidates all fit in shared memory runs parts 2 and 3 on a
//   store type with no global path compiled in (see Store).
//
// Numerics: IoU is computed in the float32 operation order of
// ops/nms.py:21-44 and nms_pallas.py:45-59 (inter = 1 * max(seg, 0) per axis
// y, x, z; areas as products of (hi - lo + off); union = area_w + area - inter;
// iou = union > 0 ? inter / union : 0), always with the earlier kept box as
// the winner. iou > thresh is decided by one product where inter is more than
// 1e-5 relatively away from thresh * union (the rounding of both sides is
// below 1.2e-7), and by the IEEE division otherwise, so the decision is the
// division's. Build with -fmad=false and without --use_fast_math so no
// multiply-add is contracted: the keep lists are then bit-identical to the
// plain PyTorch version.
//
// What bounds it: the least work is the compaction's read of the lane's
// scores and valid flags (5 B per entry) and the boxes of the candidates the
// greedy result reaches, and the IoU pairs of that result (a kept box
// against every box kept before it, a dropped one against at least one): at
// the main paths' shapes well under a microsecond of the card's memory or
// float32 time. What remains is latency on one SM per lane (16 or 8 of the
// 132 at the main paths' shapes): the compaction's chunks (a global load
// and two barriers each), per tile a box gather and four barriers, or per
// unsorted step one barrier and four warp reductions; at Mask R-CNN's
// proposals also the ~125,000 IoU pairs of a lane's 500 kept boxes, on one
// SM's share of the float32 rate. Splitting a lane across a thread-block
// cluster (distributed shared memory) is the next step; it is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

// the lane's store (see Store below)
extern __shared__ float4 dyn_smem[];

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // compaction: entries per thread per chunk
constexpr int kChunk = kThreads * kItems;  // compaction: entries per chunk
constexpr int kTile = 256;                 // sorted walk: widest tile
constexpr int kPhases = kThreads / kTile;  // sorted walk: warps per 32-column word
constexpr int kWords = kTile / 32;         // suppression-row words per candidate
constexpr int kRegMax = 2 * kThreads;      // unsorted lanes: candidates held in registers
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == 32, "the block prefix and the argmax reduce one value per warp in one warp");
static_assert(kWords <= 32 && kThreads % kTile == 0 && kTile % 32 == 0, "tile layout");

// (lo, hi) coordinate rows of axis ax in the (y1, x1, y2, x2, z1, z2) layout
__device__ __forceinline__ int lo_row(int ax) { return ax == 0 ? 0 : ax == 1 ? 1 : 4; }
__device__ __forceinline__ int hi_row(int ax) { return ax == 0 ? 2 : ax == 1 ? 3 : 5; }

// float order as unsigned order (-0 taken as +0, so equal scores tie)
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A lane's compacted entries, SoA: rows 0 .. 2*DIM-1 the coordinates, then
// the area, the score and the original index. Positions below cap live in
// dynamic shared memory, the rest in the lane's global scratch. With
// kShared, every position used is below cap and no global path is compiled:
// a shared load beside a predicated-off global one waits as long as the
// global one would.
template <int DIM, bool kShared = false>
struct Store {
  static constexpr int kArea = 2 * DIM;
  static constexpr int kScore = 2 * DIM + 1;
  static constexpr int kIndex = 2 * DIM + 2;
  static constexpr int kRows = 2 * DIM + 3;
  float* smem;
  int cap;
  float* global;
  long long global_len;

  __device__ __forceinline__ float load(int row, int p) const {
    if constexpr (kShared) return smem[row * cap + p];
    return p < cap ? smem[row * cap + p] : global[row * global_len + (p - cap)];
  }
  __device__ __forceinline__ void store(int row, int p, float x) const {
    if (kShared || p < cap) {
      smem[row * cap + p] = x;
    } else {
      global[row * global_len + (p - cap)] = x;
    }
  }
  __device__ __forceinline__ int load_index(int p) const {
    if constexpr (kShared) return reinterpret_cast<const int*>(smem)[kIndex * cap + p];
    return p < cap ? reinterpret_cast<const int*>(smem)[kIndex * cap + p]
                   : reinterpret_cast<const int*>(global)[kIndex * global_len + (p - cap)];
  }
  __device__ __forceinline__ void store_index(int p, int j) const {
    if (kShared || p < cap) {
      reinterpret_cast<int*>(smem)[kIndex * cap + p] = j;
    } else {
      reinterpret_cast<int*>(global)[kIndex * global_len + (p - cap)] = j;
    }
  }
};

template <int DIM>
struct Box {
  float lo[DIM], hi[DIM], area;
};

template <int DIM, bool SH>
__device__ __forceinline__ Box<DIM> load_box(const Store<DIM, SH>& st, int p) {
  Box<DIM> b;
#pragma unroll
  for (int ax = 0; ax < DIM; ++ax) {
    b.lo[ax] = st.load(lo_row(ax), p);
    b.hi[ax] = st.load(hi_row(ax), p);
  }
  b.area = st.load(Store<DIM>::kArea, p);
  return b;
}

// box of original index j from the SoA input rows, its area in the plain
// version's operation order
template <int DIM>
__device__ __forceinline__ Box<DIM> gather_box(const float* __restrict__ c, int n, int j, float off) {
  Box<DIM> b;
  b.area = 1.0f;
#pragma unroll
  for (int ax = 0; ax < DIM; ++ax) {
    b.lo[ax] = c[static_cast<long long>(lo_row(ax)) * n + j];
    b.hi[ax] = c[static_cast<long long>(hi_row(ax)) * n + j];
    b.area = b.area * (b.hi[ax] - b.lo[ax] + off);
  }
  return b;
}

template <int DIM, bool SH>
__device__ __forceinline__ void store_box(const Store<DIM, SH>& st, int p, const Box<DIM>& b) {
#pragma unroll
  for (int ax = 0; ax < DIM; ++ax) {
    st.store(lo_row(ax), p, b.lo[ax]);
    st.store(hi_row(ax), p, b.hi[ax]);
  }
  st.store(Store<DIM>::kArea, p, b.area);
}

// IoU(w, b) > thresh with w the winner, in the plain version's operation
// order; the division only where one product cannot decide
template <int DIM>
__device__ __forceinline__ bool suppresses(const Box<DIM>& w, const Box<DIM>& b, float off, float thresh) {
  float inter = 1.0f;
#pragma unroll
  for (int ax = 0; ax < DIM; ++ax) {
    const float seg = fminf(w.hi[ax], b.hi[ax]) - fmaxf(w.lo[ax], b.lo[ax]) + off;
    inter = inter * fmaxf(seg, 0.0f);
  }
  const float uni = w.area + b.area - inter;
  if (!(uni > 0.0f)) return 0.0f > thresh;
  const float p = thresh * uni;
  if (p > 1e-30f && p < 1e30f) {
    if (inter > p * 1.00001f) return true;
    if (inter < p * 0.99999f) return false;
  }
  return inter / uni > thresh;
}

// Part 1: compact the lane's entries with valid set and a score above -inf,
// in index order: score and original index into st. Returns their count
// (the same in every thread).
template <int DIM>
__device__ int compact(const float* __restrict__ sc, const unsigned char* __restrict__ v, int n, const Store<DIM>& st,
                       int* s_cnt, int* s_off, int* s_total) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const unsigned below = (1u << wl) - 1u;
  int m = 0;
  for (int base = 0; base < n; base += kChunk) {
    float s[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = base + k * kThreads + tid;
      s[k] = -CUDART_INF_F;
      if (j < n) {
        const float x = sc[j];
        s[k] = (v == nullptr || v[j]) ? x : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned keep = __ballot_sync(kFull, s[k] > -CUDART_INF_F);
      if (wl == 0) s_cnt[k * kWarps + warp] = __popc(keep);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive prefix of the counts in (item, warp) order = index order;
      // lane wl owns counts wl * kItems .. wl * kItems + kItems - 1
      int local[kItems];
      int sum = 0;
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        local[q] = s_cnt[wl * kItems + q];
        sum += local[q];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (wl >= d) incl += o;
      }
      int run = incl - sum;
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        s_off[wl * kItems + q] = run;
        run += local[q];
      }
      if (wl == 31) *s_total = incl;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned keep = __ballot_sync(kFull, s[k] > -CUDART_INF_F);
      if ((keep >> wl) & 1u) {
        const int p = m + s_off[k * kWarps + warp] + __popc(keep & below);
        st.store(Store<DIM>::kScore, p, s[k]);
        st.store_index(p, base + k * kThreads + tid);
      }
    }
    m += *s_total;
  }
  __syncthreads();
  return m;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Part 2: the walk in position order of a sorted lane of m candidates.
// Thread tid takes tile column j = 32 * (warp / kPhases) + lane and phase
// warp % kPhases, so the warps of one 32-column word sit on the SM's four
// schedulers, and every loop below runs the same trip count in all lanes of
// a warp. Returns the number of kept boxes, written to oidx / omask.
template <int DIM, bool SH>
__device__ int sorted_walk(const float* __restrict__ c, int n, const Store<DIM, SH>& st, int m, int max_output,
                           float thresh, float off, int* oidx, unsigned char* omask, unsigned* s_rows,
                           unsigned (*s_deadw)[kWords], unsigned* s_anyw, int* s_keep, int* s_nk) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int w = warp / kPhases;  // this warp's word of the tile
  const int phase = warp % kPhases;
  const int j = 32 * w + wl;     // this thread's column
  int kept = 0;
  int tile = 16;
  for (int p0 = 0; p0 < m && kept < max_output; p0 += tile) {
    tile = min(kTile, max(2 * tile, (max_output - kept + 31) & ~31));
    const int cnt = min(tile, m - p0);
    const int words = (cnt + 31) >> 5;
    // a. gather each column's box (phase 0 puts it in the store, for the
    //    rows), then test it against the boxes kept so far (slots 0 ..
    //    kept-1), the kPhases warps of a word taking every kPhases-th one
    const bool in = j < cnt;
    bool dead = !in;
    Box<DIM> b;
    if (in) {
      b = gather_box<DIM>(c, n, st.load_index(p0 + j), off);
      if (phase == 0) store_box(st, p0 + j, b);
    }
    if (32 * w < cnt) {
      for (int k = phase; k < kept; k += kPhases) {
        if (!dead && suppresses(load_box(st, k), b, off, thresh)) dead = true;
        if (__all_sync(kFull, dead)) break;
      }
    }
    const unsigned dw = __ballot_sync(kFull, dead);
    if (wl == 0) s_deadw[phase][w] = dw;
    if (tid < kWords) s_anyw[tid] = 0;
    __syncthreads();
    // b. the rows: bit j of row i when candidate i (alive) suppresses j > i;
    //    one IoU per lane and a ballot per (i, word)
    if (32 * w < cnt) {
      unsigned dead_w = 0;
#pragma unroll
      for (int q = 0; q < kPhases; ++q) dead_w |= s_deadw[q][w];
      const bool dead_j = (dead_w >> wl) & 1u;
      for (int i = phase; i < min(cnt, 32 * w + 32); i += kPhases) {
        unsigned dead_i = 0;
#pragma unroll
        for (int q = 0; q < kPhases; ++q) dead_i |= s_deadw[q][i >> 5];
        if ((dead_i >> (i & 31)) & 1u) continue;
        const Box<DIM> bi = load_box(st, p0 + i);
        const unsigned row = __ballot_sync(kFull, !dead_j && j > i && suppresses(bi, b, off, thresh));
        if (wl == 0) {
          s_rows[i * kWords + w] = row;
          if (row) atomicOr(&s_anyw[i >> 5], 1u << (i & 31));
        }
      }
    }
    __syncthreads();
    // c. warp 0 resolves the tile in order (every lane the same values): the
    //    first candidate neither dead nor suppressed by a box kept earlier in
    //    the tile is kept; a run of open candidates whose rows suppress
    //    nothing is kept in one step
    if (warp == 0) {
      unsigned removed[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        removed[q] = ~0u;  // words past the tile: no candidates
        if (q < words) {
          removed[q] = 0u;
#pragma unroll
          for (int ph = 0; ph < kPhases; ++ph) removed[q] |= s_deadw[ph][q];
        }
      }
      int nk = 0;
      const int budget = max_output - kept;
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const unsigned nonzero = s_anyw[q];
        unsigned open = ~removed[q];
        while (open != 0u && nk < budget) {
          const unsigned hot = open & nonzero;
          const unsigned first_hot = hot & (0u - hot);
          const unsigned run = hot ? open & (first_hot - 1u) : open;
          if (run) {
            const int rank = __popc(run & ((1u << wl) - 1u));
            if (((run >> wl) & 1u) && nk + rank < budget) s_keep[nk + rank] = 32 * q + wl;
            nk = min(budget, nk + __popc(run));
            open &= ~run;
          } else {
            const int i = 32 * q + __ffs(first_hot) - 1;
            if (wl == 0) s_keep[nk] = i;
            ++nk;
            const unsigned* row = s_rows + i * kWords;
            open &= ~(row[q] | first_hot);
#pragma unroll
            for (int r = q + 1; r < kWords; ++r) {
              if (r < words) removed[r] |= row[r];
            }
          }
        }
      }
      if (wl == 0) *s_nk = nk;
    }
    __syncthreads();
    // d. the kept boxes to slots kept .. kept+nk-1 (read all, then write:
    //    a slot may be another kept box's position) and to the output
    const int nk = *s_nk;
    const bool mine = tid < nk;
    Box<DIM> kb;
    int orig = 0;
    if (mine) {
      const int p = p0 + s_keep[tid];
      kb = load_box(st, p);
      orig = st.load_index(p);
    }
    __syncthreads();
    if (mine) {
      const int slot = kept + tid;
      store_box(st, slot, kb);
      oidx[slot] = orig;
      omask[slot] = 1;
    }
    kept += nk;
    __syncthreads();
  }
  return kept;
}

// Part 3: max_output argmax-and-suppress steps over an unsorted lane whose
// boxes are in the store, by the first nw warps of the block (barrier 1).
// Returns the number of kept boxes, written to oidx / omask.
template <int DIM, bool SH>
__device__ int argmax_walk(const Store<DIM, SH>& st, int m, int nw, int max_output, float thresh, float off, int* oidx,
                           unsigned char* omask, unsigned (*red_k)[kWarps], unsigned (*red_p)[kWarps]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int threads = 32 * nw;
  // best (key, position) of this thread's candidates; key 0: none (every
  // compacted score is above -inf, so its key is above 0)
  unsigned bk = 0, bp = ~0u;
  for (int p = tid; p < m; p += threads) {
    const unsigned k = order_key(st.load(Store<DIM>::kScore, p));
    if (k > bk) {  // positions rise: a tie keeps the lower one
      bk = k;
      bp = p;
    }
  }
  int t = 0;
  for (; t < max_output; ++t) {
    unsigned wk = __reduce_max_sync(kFull, bk);
    unsigned wp = __reduce_min_sync(kFull, bk == wk ? bp : ~0u);
    if (wl == 0) {
      red_k[t & 1][warp] = wk;
      red_p[t & 1][warp] = wp;
    }
    named_barrier(1, threads);
    // every warp reduces the per-warp maxima itself: the same winner in
    // every thread, and no second barrier (the arrays are double-buffered)
    const unsigned k = wl < nw ? red_k[t & 1][wl] : 0u;
    wk = __reduce_max_sync(kFull, k);
    wp = __reduce_min_sync(kFull, k == wk && wl < nw ? red_p[t & 1][wl] : ~0u);
    if (wk == 0) break;
    const int win = static_cast<int>(wp);
    const Box<DIM> w = load_box(st, win);
    if (tid == 0) {
      oidx[t] = st.load_index(win);
      omask[t] = 1;
    }
    bk = 0;
    bp = ~0u;
    for (int p = tid; p < m; p += threads) {
      const float s = st.load(Store<DIM>::kScore, p);
      if (!(s > -CUDART_INF_F)) continue;
      if (p == win || suppresses(w, load_box(st, p), off, thresh)) {
        st.store(Store<DIM>::kScore, p, -CUDART_INF_F);
      } else if (order_key(s) > bk) {
        bk = order_key(s);
        bp = p;
      }
    }
  }
  return t;
}

// Part 3, for a lane of at most kRegMax candidates: the same steps with
// each thread's (at most two) candidates in registers, so that a step is the
// reductions, one load of the winner's box and two IoUs side by side.
template <int DIM, bool SH>
__device__ int argmax_walk_regs(const Store<DIM, SH>& st, int m, int nw, int max_output, float thresh, float off,
                                int* oidx, unsigned char* omask, unsigned (*red_k)[kWarps],
                                unsigned (*red_p)[kWarps]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int threads = 32 * nw;
  const int pa = tid, pb = tid + threads;  // this thread's positions, pa < pb
  Box<DIM> ba, bb;
  unsigned ka = 0, kb = 0;  // order keys; 0: none or suppressed
  if (pa < m) {
    ba = load_box(st, pa);
    ka = order_key(st.load(Store<DIM>::kScore, pa));
  }
  if (pb < m) {
    bb = load_box(st, pb);
    kb = order_key(st.load(Store<DIM>::kScore, pb));
  }
  int t = 0;
  for (; t < max_output; ++t) {
    const unsigned bk = ka >= kb ? ka : kb;  // a tie keeps the lower position
    const unsigned bp = ka >= kb ? pa : pb;
    unsigned wk = __reduce_max_sync(kFull, bk);
    unsigned wp = __reduce_min_sync(kFull, bk == wk ? bp : ~0u);
    if (wl == 0) {
      red_k[t & 1][warp] = wk;
      red_p[t & 1][warp] = wp;
    }
    named_barrier(1, threads);
    const unsigned k = wl < nw ? red_k[t & 1][wl] : 0u;
    wk = __reduce_max_sync(kFull, k);
    wp = __reduce_min_sync(kFull, k == wk && wl < nw ? red_p[t & 1][wl] : ~0u);
    if (wk == 0) break;
    const int win = static_cast<int>(wp);
    const Box<DIM> w = load_box(st, win);
    if (tid == 0) {
      oidx[t] = st.load_index(win);
      omask[t] = 1;
    }
    if (ka != 0 && (pa == win || suppresses(w, ba, off, thresh))) ka = 0;
    if (kb != 0 && (pb == win || suppresses(w, bb, off, thresh))) kb = 0;
  }
  return t;
}

// After the compaction: the sorted walk or the argmax steps over the lane's
// m candidates; returns the number kept (the same in every thread).
template <int DIM, bool SH>
__device__ int walk_lane(const float* __restrict__ c, int n, const Store<DIM, SH>& st, int m, int max_output,
                      float thresh, float off, int* oidx, unsigned char* omask, unsigned* s_rows,
                      unsigned (*s_deadw)[kWords], unsigned* s_anyw, int* s_keep, int* s_nk,
                      unsigned (*red_k)[kWarps], unsigned (*red_p)[kWarps]) {
  const int tid = threadIdx.x;
  int unsorted = 0;
  for (int p = tid + 1; p < m; p += kThreads) {
    unsorted |= st.load(Store<DIM>::kScore, p) > st.load(Store<DIM>::kScore, p - 1);
  }
  int kept = 0;
  if (__syncthreads_or(unsorted)) {
    for (int p = tid; p < m; p += kThreads) store_box(st, p, gather_box<DIM>(c, n, st.load_index(p), off));
    __syncthreads();
    // about two candidates per thread: fewer warps issue each step's
    // reductions, and the step's barrier waits for fewer
    const int nw = min(kWarps, max(4, (m + 63) / 64));
    if ((tid >> 5) < nw) {
      kept = m <= kRegMax ? argmax_walk_regs<DIM>(st, m, nw, max_output, thresh, off, oidx, omask, red_k, red_p)
                          : argmax_walk<DIM>(st, m, nw, max_output, thresh, off, oidx, omask, red_k, red_p);
    }
    if (tid == 0) *s_nk = kept;
    __syncthreads();
    kept = *s_nk;
  } else {
    kept = sorted_walk<DIM>(c, n, st, m, max_output, thresh, off, oidx, omask, s_rows, s_deadw, s_anyw, s_keep,
                            s_nk);
  }
  return kept;
}

template <int DIM>
__global__ void __launch_bounds__(kThreads) nms_kernel(
    const float* __restrict__ coords, long long coords_lane_stride,
    const float* __restrict__ scores, long long scores_lane_stride,
    const unsigned char* __restrict__ valid, long long valid_lane_stride,
    float* __restrict__ scratch, int n, int cap, int max_output, float thresh, float off,
    int* __restrict__ out_idx, unsigned char* __restrict__ out_mask) {
  __shared__ int s_cnt[kItems * kWarps];
  __shared__ int s_off[kItems * kWarps];
  __shared__ int s_total;
  __shared__ unsigned s_rows[kTile * kWords];
  __shared__ unsigned s_deadw[kPhases][kWords];
  __shared__ unsigned s_anyw[kWords];
  __shared__ int s_keep[kTile];
  __shared__ int s_nk;
  __shared__ unsigned red_k[2][kWarps];
  __shared__ unsigned red_p[2][kWarps];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const long long global_len = n - cap;
  const Store<DIM> st{reinterpret_cast<float*>(dyn_smem), cap,
                      scratch + static_cast<long long>(lane) * Store<DIM>::kRows * global_len, global_len};
  const float* c = coords + lane * coords_lane_stride;
  int* oidx = out_idx + static_cast<long long>(lane) * max_output;
  unsigned char* omask = out_mask + static_cast<long long>(lane) * max_output;

  const int m = compact<DIM>(scores + lane * scores_lane_stride, valid ? valid + lane * valid_lane_stride : nullptr,
                             n, st, s_cnt, s_off, &s_total);
  const int kept = m <= cap ? walk_lane<DIM>(c, n, Store<DIM, true>{st.smem, cap, nullptr, 0}, m, max_output, thresh,
                                          off, oidx, omask, s_rows, s_deadw, s_anyw, s_keep, &s_nk, red_k, red_p)
                            : walk_lane<DIM>(c, n, st, m, max_output, thresh, off, oidx, omask, s_rows, s_deadw, s_anyw,
                                          s_keep, &s_nk, red_k, red_p);
  for (int k = kept + tid; k < max_output; k += kThreads) {
    oidx[k] = -1;
    omask[k] = 0;
  }
}


// Entries of one lane that fit in the dynamic shared memory a block can use
// on the current device; grants the kernel that much (the 48 KB a block gets
// without the attribute hold static and dynamic together).
template <int DIM>
int capacity() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, nms_kernel<DIM>);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int row_bytes = Store<DIM>::kRows * static_cast<int>(sizeof(float));
  const int cap = (optin - static_cast<int>(attr.sharedSizeBytes)) / row_bytes;
  err = cudaFuncSetAttribute(nms_kernel<DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize, cap * row_bytes);
  return err == cudaSuccess ? cap : -static_cast<int>(err);
}

template <int DIM>
int launch(const float* coords, long long coords_lane_stride, const float* scores, long long scores_lane_stride,
           const unsigned char* valid, long long valid_lane_stride, float* scratch, int lanes, int n, int cap,
           int max_output, float thresh, float off, int* out_idx, unsigned char* out_mask, cudaStream_t s) {
  const int smem_entries = n < cap ? n : cap;
  const int dyn = smem_entries * Store<DIM>::kRows * static_cast<int>(sizeof(float));
  nms_kernel<DIM><<<lanes, kThreads, dyn, s>>>(coords, coords_lane_stride, scores, scores_lane_stride, valid,
                                               valid_lane_stride, scratch, n, smem_entries, max_output, thresh, off,
                                               out_idx, out_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entries of one lane that fit in the dynamic shared memory a block of the
// dim-D kernel can use on the current device; a lane's entries beyond it go
// to the global scratch. Call it once per device before the first launch
// there: it grants the kernel that shared memory. Negative: minus a CUDA
// error code.
extern "C" int mdt_nms_capacity(int dim) {
  if (dim == 2) return capacity<2>();
  if (dim == 3) return capacity<3>();
  return -static_cast<int>(cudaErrorInvalidValue);
}

// scratch: lanes x (2*dim + 3) x max(n - cap, 0) floats, or null when n <= cap
extern "C" int mdt_nms_launch(const float* coords, long long coords_lane_stride,
                              const float* scores, long long scores_lane_stride,
                              const unsigned char* valid, long long valid_lane_stride,
                              float* scratch, int lanes, int n, int cap, int dim, int max_output,
                              float thresh, float pixel_offset, int* out_idx,
                              unsigned char* out_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dim == 2) {
    return launch<2>(coords, coords_lane_stride, scores, scores_lane_stride, valid, valid_lane_stride, scratch,
                     lanes, n, cap, max_output, thresh, pixel_offset, out_idx, out_mask, s);
  }
  if (dim == 3) {
    return launch<3>(coords, coords_lane_stride, scores, scores_lane_stride, valid, valid_lane_stride, scratch,
                     lanes, n, cap, max_output, thresh, pixel_offset, out_idx, out_mask, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mdt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
