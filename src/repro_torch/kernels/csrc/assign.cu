// Effective-distance assignment sweep for Hopper (sm_90a), with optional
// fused per-cluster moments. One source, two kernel entry points:
//
//   repro_assign_argmin  — idx / best / second for every point
//   repro_assign_reduce  — the same, plus one [d+2, k_pad] moment partial
//                          per block (rows 0..d-1 sum w*p, row d sum w,
//                          row d+1 sum w*best), summed by the caller
//
// Replaces the TPU kernels of the JAX package:
//   src/repro/kernels/assign_kernel.py: _assign_kernel, _assign_kernel_db
//     (assign_argmin_pallas) and _assign_moments_kernel,
//     _assign_moments_kernel_db (assign_reduce_pallas);
//   src/repro/kernels/triton_assign.py: _triton_kernel
//     (triton_assign_pallas) and _triton_moments_kernel
//     (triton_assign_reduce_pallas).
// The sorted ("cuda") and flat ("cuda_flat") configurations differ only in
// what the Python wrapper does around the launch (center sort and un-sort)
// and in the point-tile size; the arithmetic is this one kernel.
//
// What it computes, per point p and real center c < k_real:
//   sq  = (|p|^2 + |c|^2) - 2 * (p . c)      (the reference's expansion)
//   eff = max(sq, 0) * inv2[c]
//   idx = lowest c attaining min eff, best = that min,
//   second = min eff over every other c (+inf when k_real == 1).
// Centers at or past k_real (the _FAR padding rows) are never read. With
// bf16 precision only the operands of p . c are rounded to bfloat16;
// products and every sum stay float32.
//
// Point layout. Row i of `points` (and of `weights`) is the point whose
// outputs live at position order[i] (order == nullptr: position i). The
// solver hands over its points once per solve in Hilbert order
// (ops.point_layout), so a tile of consecutive rows covers a small box of
// space, and the kernel scatters idx/best/second through the order. The
// wrapper gathers the weights into row order with one PyTorch call before
// the launch: on the card that is ~0.04 ms at the main shape, against
// ~0.37 ms for the same gather inside this kernel, where it competes with
// the scattered stores (tools/assign_variants.py tune base gatherk).
//
// What bounds it on the H100. Computing every pair is ~2d + 7 float32
// operations per (point, center) pair: 0.83 ms at the main shape (n = 2^22,
// k = 1024, d = 3) at the 67 TFLOP/s CUDA-core peak, and an issue floor
// near 2 ms for the ~14-instruction update chain. So the kernel computes
// few pairs (d = 2 and 3):
//   * per point tile it takes the tile's bounding box (a block reduction
//     of the points it holds in registers) and bounds, for every center,
//     the eff the update would compute for any point of the box:
//     lb_c <= eff <= ub_c, both widened by a rounding slack (below);
//   * T = the second smallest ub_c bounds every point's final second: each
//     point's eff to the two centers attaining it is at most T;
//   * a center with lb_c > T cannot be any point's best or second, and
//     removing a value strictly above the second smallest of a multiset
//     changes neither its minimum, the lowest index attaining it, nor its
//     second smallest value. The update therefore runs unchanged over the
//     surviving centers, in increasing index, and gives the same idx /
//     best / second bit for bit as over all of them. On a Hilbert-ordered
//     layout ~2% of the pairs survive at the main shape; on random order
//     every tile box is the whole domain and nothing is skipped.
// The slack. The update's sq differs from the true |p - c|^2 by at most
// 5u(|p|^2 + |c|^2) + 8u sum_j |p_j||c_j| (u = 2^-24: the fmaf chains of
// |p|^2, |c|^2 and p.c, the sum and the final fmaf), and in bf16 by another
// (2^-6 + 2^-15) sum_j |p_j||c_j|: rounding both operands of p_j c_j to
// bfloat16 (unit 2^-8) moves the product by up to (2^-7 + 2^-16)|p_j||c_j|,
// and sq takes p.c twice. The kernel bounds |p|^2 and |p_j| over the box
// and takes
//   slack = 2^-20 (|p|^2max + |c|^2 + 2 M) [+ 2^-5 M in bf16],
//   M = sum_j max(|lo_j|, |hi_j|) |c_j|,
// over three times the float32 error and 1.99 times the bf16 one (the
// worst case of both roundings is pinned by tests/test_torch_prune.py);
// the box distances are shrunk (lb) or grown
// (ub) by 2^-18 for their own rounding. A NaN bound keeps its center and
// is left out of T (T from any subset of the centers is still an upper
// bound). At 1e9-scale coordinates the slack grows with them and the
// pruning stays exact. Pruning can be switched off (`prune` = 0) for the
// checks that hold the pruned kernel bit-equal to the unpruned one.
//
// The rest of the design: survivors are compacted (warp ballots, in index
// order) into shared memory with |c|^2 and inv2, so all threads of a warp
// read the same center (broadcasts); every thread keeps PPT points in
// registers (coordinates, |p|^2 and the running best / second / idx), so
// one center read feeds PPT evaluations; the update is branch-free. The
// kernel counts the pairs it computes (one 64-bit integer atomic per
// block, so the count is exact and deterministic).
//
// Moments without float atomics, in parallel. Blocks run in no order, so
// each block walks a fixed, strided set of point tiles and owns one
// partial. Inside a tile, each warp groups its lanes by label
// (__match_any_sync) and sums each group of more than one lane with a fixed
// xor tree over all 32 lanes (non-members add 0); each group leader
// writes one record (label, d + 2 sums) in lane order. Column c of the
// partial belongs to thread c % THREADS alone, which adds the tile's
// records in (warp, point slice, lane) order. The order of every sum is
// fixed by the launch shape and the data, and the result is bit-identical
// from run to run. In a Hilbert-ordered tile a warp's 32 consecutive
// points carry one or two labels, so the tile leaves a few dozen records.
// The partial lives in shared memory when it fits and in the block's own
// slice of the output otherwise.
//
// Other dimensions (d not 2 or 3) take a plain kernel: no pruning, centers
// staged in tiles, the serial label scan for the moments.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 1024;                // centers staged per chunk (d = 2, 3)
constexpr int ROUNDS = CH / THREADS;    // ballot rounds per warp and chunk
constexpr size_t SMEM_CAP = 160 * 1024;   // partials above this stay global
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float SLACK_REL = 0x1p-20f;   // float32 rounding of the update
constexpr float BF16_REL = 0x1p-5f;     // bf16 operands of p . c
constexpr float SHRINK = 0x1p-18f;      // rounding of the bounds themselves

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The scattered outputs are written with an L2 "evict last" policy: each
// 32-byte sector of idx/best/second takes eight writes at random times in
// the sweep, and the longer it stays in L2 the fewer partial sectors go
// to memory (the main shape's argmin-only sweep: 0.37 against 0.46 ms
// with plain stores, tools/assign_variants.py tune).
__device__ __forceinline__ unsigned long long keep_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void st_keep(float* a, float v,
                                        unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(a), "f"(v), "l"(pol) : "memory");
}

__device__ __forceinline__ void st_keep(int* a, int v,
                                        unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.s32 [%0], %1, %2;"
               :: "l"(a), "r"(v), "l"(pol) : "memory");
}

// Bounds, over every point of the box [lo, hi] (whose |p|^2 is at most
// pmax), of the eff the update computes for center c: *lb <= eff <= *ub.
template <int D, bool BF16>
__device__ __forceinline__ void eff_bounds(const float (&c)[D], float iv,
                                           const float (&lo)[D],
                                           const float (&hi)[D], float pmax,
                                           float* lb, float* ub) {
  float g2 = 0.f, f2 = 0.f, cn = 0.f, m = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float gap = fmaxf(fmaxf(lo[j] - c[j], c[j] - hi[j]), 0.f);
    const float far = fmaxf(fabsf(c[j] - lo[j]), fabsf(hi[j] - c[j]));
    g2 = fmaf(gap, gap, g2);
    f2 = fmaf(far, far, f2);
    cn = fmaf(c[j], c[j], cn);
    m = fmaf(fmaxf(fabsf(lo[j]), fabsf(hi[j])), fabsf(c[j]), m);
  }
  float slack = SLACK_REL * (pmax + cn + 2.f * m);
  if (BF16) slack = fmaf(BF16_REL, m, slack);
  *lb = (g2 * (1.f - SHRINK) - slack) * iv * (1.f - SHRINK);
  *ub = (f2 * (1.f + SHRINK) + slack) * iv * (1.f + SHRINK);
}

// (a1 <= a2) and (b1 <= b2) -> the two smallest of the four, in order
__device__ __forceinline__ void merge2(float& a1, float& a2, float b1,
                                       float b2) {
  const float lo = fminf(a1, b1);
  a2 = fminf(fmaxf(a1, b1), fminf(a2, b2));
  a1 = lo;
}

// The pruned sweep for d = 2, 3. Shared memory: the staged survivors
// ([D][CH] coordinates, [CH] |c|^2, [CH] inv2, [CH] indices), the block
// reductions, with moments the tile's records ([TILE] labels, [D+2][TILE]
// sums) and the partial when it fits.
template <int D, int PPT, bool MOMENTS, bool BF16>
__global__ void __launch_bounds__(THREADS)
assign_pruned(const float* __restrict__ points, const int* __restrict__ order,
              const float* __restrict__ centers,
              const float* __restrict__ inv2,
              const float* __restrict__ weights, int n, int k_pad,
              int k_real, int prune, int partial_in_smem,
              int* __restrict__ idx_out, float* __restrict__ best_out,
              float* __restrict__ second_out, float* __restrict__ partials,
              unsigned long long* __restrict__ pairs) {
  constexpr int TILE = THREADS * PPT;
  constexpr int ROWS = D + 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* c_s = smem;
  float* cn_s = c_s + D * CH;
  float* iv_s = cn_s + CH;
  int* sid_s = reinterpret_cast<int*>(iv_s + CH);
  float* red_s = reinterpret_cast<float*>(sid_s + CH);   // [WARPS][2D]
  int* cnt_s = reinterpret_cast<int*>(red_s + WARPS * 2 * D);
  int* rlab_s = cnt_s + WARPS;
  float* rval_s = reinterpret_cast<float*>(rlab_s + TILE);
  float* acc = nullptr;
  if (MOMENTS) {
    acc = partial_in_smem
              ? rval_s + ROWS * TILE
              : partials + static_cast<size_t>(blockIdx.x) * ROWS * k_pad;
    for (int c = tid; c < k_pad; c += THREADS)
      for (int r = 0; r < ROWS; ++r) acc[r * k_pad + c] = 0.f;
  }
  unsigned long long my_pairs = 0;

  const int n_tiles = (n + TILE - 1) / TILE;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int base = t * TILE;
    __syncthreads();  // the previous tile's shared memory has been read
    float px[PPT][D], pd[PPT][D];
    float pn[PPT], best[PPT], second[PPT], wq[PPT];
    int bi[PPT], pid[PPT], g[PPT];
    float lo[D], hi[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      lo[j] = inf_f();
      hi[j] = -inf_f();
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      pid[q] = base + q * THREADS + tid;
      const bool ok = pid[q] < n;
      const float* row = points + static_cast<size_t>(ok ? pid[q] : 0) * D;
      // points, order and weights are read once: streaming loads leave L2
      // to the scattered outputs
      g[q] = ok ? (order ? __ldcs(order + pid[q]) : pid[q]) : -1;
      if (MOMENTS) wq[q] = ok ? __ldcs(weights + pid[q]) : 0.f;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float v = __ldcs(row + j);
        s = fmaf(v, v, s);
        px[q][j] = v;
        pd[q][j] = BF16 ? to_bf16(v) : v;
        if (ok) {
          lo[j] = fminf(lo[j], v);
          hi[j] = fmaxf(hi[j], v);
        }
      }
      pn[q] = s;
      best[q] = inf_f();
      second[q] = inf_f();
      bi[q] = -1;
    }

    // the tile's bounding box (min and max are exact in any order)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      for (int o = 16; o > 0; o >>= 1) {
        lo[j] = fminf(lo[j], __shfl_xor_sync(FULL, lo[j], o));
        hi[j] = fmaxf(hi[j], __shfl_xor_sync(FULL, hi[j], o));
      }
      if (lane == 0) {
        red_s[warp * 2 * D + j] = lo[j];
        red_s[warp * 2 * D + D + j] = hi[j];
      }
    }
    __syncthreads();
    float pmax = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      for (int w = 0; w < WARPS; ++w) {
        lo[j] = fminf(lo[j], red_s[w * 2 * D + j]);
        hi[j] = fmaxf(hi[j], red_s[w * 2 * D + D + j]);
      }
      pmax += fmaxf(lo[j] * lo[j], hi[j] * hi[j]);
    }

    // T: the second smallest upper bound over the real centers
    float T = inf_f();
    if (prune) {
      float m1 = inf_f(), m2 = inf_f();
      for (int c = tid; c < k_real; c += THREADS) {
        float cc[D];
#pragma unroll
        for (int j = 0; j < D; ++j) cc[j] = centers[c * D + j];
        float lb, ub;
        eff_bounds<D, BF16>(cc, inv2[c], lo, hi, pmax, &lb, &ub);
        if (!(ub <= inf_f())) ub = inf_f();   // NaN: left out of T
        merge2(m1, m2, ub, inf_f());
      }
      for (int o = 16; o > 0; o >>= 1)
        merge2(m1, m2, __shfl_xor_sync(FULL, m1, o),
               __shfl_xor_sync(FULL, m2, o));
      __syncthreads();   // every thread has read the box partials
      if (lane == 0) {
        red_s[warp * 2] = m1;
        red_s[warp * 2 + 1] = m2;
      }
      __syncthreads();
      m1 = red_s[0];
      m2 = red_s[1];
      for (int w = 1; w < WARPS; ++w)
        merge2(m1, m2, red_s[w * 2], red_s[w * 2 + 1]);
      T = m2;
    }

    int computed = 0;
    for (int c0 = 0; c0 < k_real; c0 += CH) {
      // survivors of this chunk, compacted in increasing index: warp w
      // tests centers c0 + w*CH/WARPS + r*32 + lane
      unsigned keep[ROUNDS];
      float cc[ROUNDS][D], ivr[ROUNDS];
      int mine = 0;
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int c = c0 + warp * (CH / WARPS) + r * 32 + lane;
        bool kept = c < k_real;
        ivr[r] = 0.f;
        if (kept) {
#pragma unroll
          for (int j = 0; j < D; ++j) cc[r][j] = centers[c * D + j];
          ivr[r] = inv2[c];
          if (prune) {
            float lb, ub;
            eff_bounds<D, BF16>(cc[r], ivr[r], lo, hi, pmax, &lb, &ub);
            kept = !(lb > T);
          }
        }
        keep[r] = __ballot_sync(FULL, kept);
        mine += __popc(keep[r]);
      }
      __syncthreads();   // T's partials and the last chunk have been read
      if (lane == 0) cnt_s[warp] = mine;
      __syncthreads();
      int off = 0, total = 0;
      for (int w = 0; w < WARPS; ++w) {
        const int m = cnt_s[w];
        off += w < warp ? m : 0;
        total += m;
      }
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        if ((keep[r] >> lane) & 1u) {
          const int pos = off + __popc(keep[r] & ((1u << lane) - 1u));
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < D; ++j) {
            s = fmaf(cc[r][j], cc[r][j], s);
            c_s[j * CH + pos] = BF16 ? to_bf16(cc[r][j]) : cc[r][j];
          }
          cn_s[pos] = s;
          iv_s[pos] = ivr[r];
          sid_s[pos] = c0 + warp * (CH / WARPS) + r * 32 + lane;
        }
        off += __popc(keep[r]);
      }
      __syncthreads();
      computed += total;
      for (int s = 0; s < total; ++s) {
        const float cn = cn_s[s];
        const float iv = iv_s[s];
        const int ci = sid_s[s];
        float cd[D];
#pragma unroll
        for (int j = 0; j < D; ++j) cd[j] = c_s[j * CH + s];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < D; ++j) dot = fmaf(pd[q][j], cd[j], dot);
          // 2 * dot is exact, so the fma rounds once, like the reference
          const float sq = fmaf(-2.f, dot, pn[q] + cn);
          const float e = fmaxf(sq, 0.f) * iv;
          const bool lt = e < best[q];
          second[q] = lt ? best[q] : fminf(second[q], e);
          bi[q] = lt ? ci : bi[q];
          best[q] = lt ? e : best[q];
        }
      }
    }
    if (tid == 0)
      my_pairs += static_cast<unsigned long long>(computed) *
                  static_cast<unsigned long long>(min(TILE, n - base));

    const unsigned long long keep = keep_policy();
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      if (g[q] >= 0) {
        st_keep(idx_out + g[q], bi[q], keep);
        st_keep(best_out + g[q], best[q], keep);
        st_keep(second_out + g[q], second[q], keep);
      }
    }
    if (MOMENTS) {
      const int rbase = warp * 32 * PPT;
      int nrec = 0;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int lab = g[q] >= 0 ? bi[q] : -1;
        const float w = wq[q];
        float v[ROWS];
#pragma unroll
        for (int j = 0; j < D; ++j) v[j] = w * px[q][j];
        v[D] = w;
        v[D + 1] = w * best[q];
        const unsigned grp = __match_any_sync(FULL, lab);
        const bool lead = lab >= 0 && __ffs(grp) - 1 == lane;
        // groups of more than one lane: one fixed xor tree each
        unsigned todo = __ballot_sync(FULL, lead && __popc(grp) > 1);
        while (todo) {
          const int src = __ffs(todo) - 1;
          const unsigned members = __shfl_sync(FULL, grp, src);
          const bool in = (members >> lane) & 1u;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            float x = in ? v[r] : 0.f;
            for (int o = 16; o > 0; o >>= 1)
              x += __shfl_xor_sync(FULL, x, o);
            if (lane == src) v[r] = x;
          }
          todo &= todo - 1;
        }
        const unsigned leads = __ballot_sync(FULL, lead);
        if (lead) {
          const int pos = rbase + nrec + __popc(leads & ((1u << lane) - 1u));
          rlab_s[pos] = lab;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) rval_s[r * TILE + pos] = v[r];
        }
        nrec += __popc(leads);
      }
      __syncthreads();   // every thread has read cnt_s of the last chunk
      if (lane == 0) cnt_s[warp] = nrec;
      __syncthreads();
      // thread `tid` owns the columns c with c % THREADS == tid and adds
      // the records in order: no two threads touch a column
      for (int w = 0; w < WARPS; ++w) {
        const int m = cnt_s[w];
#pragma unroll 4
        for (int i = 0; i < m; ++i) {
          const int rec = w * 32 * PPT + i;
          const int c = rlab_s[rec];
          if ((c & (THREADS - 1)) == tid) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r * k_pad + c] += rval_s[r * TILE + rec];
          }
        }
      }
    }
  }

  if (pairs && tid == 0 && my_pairs) atomicAdd(pairs, my_pairs);
  if (MOMENTS && partial_in_smem) {
    __syncthreads();
    float* out = partials + static_cast<size_t>(blockIdx.x) * ROWS * k_pad;
    for (int c = tid; c < k_pad; c += THREADS)
      for (int r = 0; r < ROWS; ++r) out[r * k_pad + c] = acc[r * k_pad + c];
  }
}

// The plain sweep for any other d: every center, staged in tiles of ct;
// moments by a serial scan of the tile's labels. Shared memory: [d][ct]
// center coordinates, [ct] |c|^2, [ct] inv2; with moments also [tile]
// labels, [tile] best, and the partial when it fits.
template <int PPT, bool MOMENTS, bool BF16>
__global__ void __launch_bounds__(THREADS)
assign_any_d(const float* __restrict__ points, const int* __restrict__ order,
             const float* __restrict__ centers,
             const float* __restrict__ inv2,
             const float* __restrict__ weights, int n, int d, int k_pad,
             int k_real, int ct, int partial_in_smem,
             int* __restrict__ idx_out, float* __restrict__ best_out,
             float* __restrict__ second_out, float* __restrict__ partials,
             unsigned long long* __restrict__ pairs) {
  constexpr int TILE = THREADS * PPT;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* c_s = smem;
  float* cn_s = c_s + static_cast<size_t>(d) * ct;
  float* iv_s = cn_s + ct;
  int* lab_s = reinterpret_cast<int*>(iv_s + ct);
  float* best_s = reinterpret_cast<float*>(lab_s + TILE);
  float* acc = nullptr;
  const size_t rows = static_cast<size_t>(d) + 2;
  if (MOMENTS) {
    acc = partial_in_smem
              ? best_s + TILE
              : partials + static_cast<size_t>(blockIdx.x) * rows * k_pad;
    for (int c = tid; c < k_pad; c += THREADS)
      for (size_t r = 0; r < rows; ++r) acc[r * k_pad + c] = 0.f;
  }
  unsigned long long my_pairs = 0;

  const int n_tiles = (n + TILE - 1) / TILE;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int base = t * TILE;
    float pn[PPT], best[PPT], second[PPT];
    int bi[PPT], pid[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      pid[q] = base + q * THREADS + tid;
      const bool ok = pid[q] < n;
      const float* row = points + static_cast<size_t>(ok ? pid[q] : 0) * d;
      float s = 0.f;
      for (int j = 0; j < d; ++j) {
        const float v = ok ? row[j] : 0.f;
        s = fmaf(v, v, s);
      }
      pn[q] = s;
      best[q] = inf_f();
      second[q] = inf_f();
      bi[q] = -1;
    }

    for (int c0 = 0; c0 < k_real; c0 += ct) {
      const int cnt = min(ct, k_real - c0);
      __syncthreads();  // the previous center tile has been consumed
      for (int e = tid; e < cnt * d; e += THREADS) {
        const int c = e / d, j = e - (e / d) * d;
        const float v = centers[static_cast<size_t>(c0 + c) * d + j];
        c_s[static_cast<size_t>(j) * ct + c] = BF16 ? to_bf16(v) : v;
      }
      for (int c = tid; c < cnt; c += THREADS) {
        const float* row = centers + static_cast<size_t>(c0 + c) * d;
        float s = 0.f;
        for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
        cn_s[c] = s;
        iv_s[c] = inv2[c0 + c];
      }
      __syncthreads();
      for (int c = 0; c < cnt; ++c) {
        const float cn = cn_s[c];
        const float iv = iv_s[c];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          float dot = 0.f;
          const float* row =
              points + static_cast<size_t>(pid[q] < n ? pid[q] : 0) * d;
          for (int j = 0; j < d; ++j) {
            const float v = BF16 ? to_bf16(row[j]) : row[j];
            dot = fmaf(v, c_s[static_cast<size_t>(j) * ct + c], dot);
          }
          const float sq = fmaf(-2.f, dot, pn[q] + cn);
          const float e = fmaxf(sq, 0.f) * iv;
          const bool lt = e < best[q];
          second[q] = lt ? best[q] : fminf(second[q], e);
          bi[q] = lt ? c0 + c : bi[q];
          best[q] = lt ? e : best[q];
        }
      }
    }
    if (tid == 0)
      my_pairs += static_cast<unsigned long long>(k_real) *
                  static_cast<unsigned long long>(min(TILE, n - base));

#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      if (pid[q] < n) {
        const int g = order ? order[pid[q]] : pid[q];
        idx_out[g] = bi[q];
        best_out[g] = best[q];
        second_out[g] = second[q];
      }
      if (MOMENTS) {
        lab_s[q * THREADS + tid] = pid[q] < n ? bi[q] : -1;
        best_s[q * THREADS + tid] = best[q];
      }
    }
    if (MOMENTS) {
      __syncthreads();
      // thread `tid` owns the columns c with c % THREADS == tid and adds
      // the tile's points in point order: no two threads touch a column
      for (int i = 0; i < TILE; ++i) {
        const int c = lab_s[i];
        if (c >= 0 && c % THREADS == tid) {
          const int r = base + i;
          const float w = weights[r];
          const float* row = points + static_cast<size_t>(r) * d;
          for (int j = 0; j < d; ++j)
            acc[static_cast<size_t>(j) * k_pad + c] += w * row[j];
          acc[static_cast<size_t>(d) * k_pad + c] += w;
          acc[(static_cast<size_t>(d) + 1) * k_pad + c] += w * best_s[i];
        }
      }
      __syncthreads();  // labels of this tile are read before the next
    }
  }

  if (pairs && tid == 0 && my_pairs) atomicAdd(pairs, my_pairs);
  if (MOMENTS && partial_in_smem) {
    float* out = partials + static_cast<size_t>(blockIdx.x) * rows * k_pad;
    for (int c = tid; c < k_pad; c += THREADS)
      for (size_t r = 0; r < rows; ++r)
        out[r * k_pad + c] = acc[r * k_pad + c];
  }
}

struct Args {
  const float* points;
  const int* order;
  const float* centers;
  const float* inv2;
  const float* weights;
  int n, d, k_pad, k_real, ppt, bf16, n_blocks, prune;
  int* idx;
  float* best;
  float* second;
  float* partials;
  unsigned long long* pairs;
  cudaStream_t stream;
  int* occupancy;  // non-null: report resident blocks per SM, no launch
};

// Raise the block's dynamic shared memory limit to the opt-in maximum,
// once per instance and device (a permission only: occupancy follows each
// launch's own size).
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem,
                       std::atomic<bool> (&raised)[MAX_DEVICES]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && raised[dev].load()) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) raised[dev].store(true);
  return cudaSuccess;
}

// bytes of the moment partial, and whether it is kept in shared memory
// next to `smem` bytes of everything else
size_t partial_bytes(const Args& a, size_t smem, int* in_smem) {
  const size_t part = (static_cast<size_t>(a.d) + 2) * a.k_pad * sizeof(float);
  *in_smem = smem + part <= SMEM_CAP;
  return *in_smem ? part : 0;
}

template <int D, int PPT, bool MOMENTS, bool BF16>
cudaError_t launch_pruned(const Args& a) {
  constexpr int TILE = THREADS * PPT;
  size_t smem = (static_cast<size_t>(D) + 3) * CH * sizeof(float) +
                (WARPS * 2 * D + WARPS) * sizeof(float);
  int in_smem = 0;
  if (MOMENTS) {
    smem += static_cast<size_t>(TILE) * (D + 3) * sizeof(float);
    smem += partial_bytes(a, smem, &in_smem);
  }
  auto kern = assign_pruned<D, PPT, MOMENTS, BF16>;
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t err = allow_smem(kern, smem, raised);
  if (err != cudaSuccess) return err;
  if (a.occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern,
                                                         THREADS, smem);
  kern<<<a.n_blocks, THREADS, smem, a.stream>>>(
      a.points, a.order, a.centers, a.inv2, a.weights, a.n, a.k_pad,
      a.k_real, a.prune, in_smem, a.idx, a.best, a.second, a.partials,
      a.pairs);
  return cudaGetLastError();
}

template <int PPT, bool MOMENTS, bool BF16>
cudaError_t launch_any_d(const Args& a) {
  const int ct = a.d <= 16 ? 128 : 32;
  const int tile = THREADS * PPT;
  size_t smem = static_cast<size_t>(ct) * (a.d + 2) * sizeof(float);
  int in_smem = 0;
  if (MOMENTS) {
    smem += static_cast<size_t>(tile) * (sizeof(int) + sizeof(float));
    smem += partial_bytes(a, smem, &in_smem);
  }
  auto kern = assign_any_d<PPT, MOMENTS, BF16>;
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t err = allow_smem(kern, smem, raised);
  if (err != cudaSuccess) return err;
  if (a.occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern,
                                                         THREADS, smem);
  kern<<<a.n_blocks, THREADS, smem, a.stream>>>(
      a.points, a.order, a.centers, a.inv2, a.weights, a.n, a.d, a.k_pad,
      a.k_real, ct, in_smem, a.idx, a.best, a.second, a.partials, a.pairs);
  return cudaGetLastError();
}

template <int PPT, bool MOMENTS, bool BF16>
cudaError_t by_dim(const Args& a) {
  switch (a.d) {
    case 2: return launch_pruned<2, PPT, MOMENTS, BF16>(a);
    case 3: return launch_pruned<3, PPT, MOMENTS, BF16>(a);
    default: return launch_any_d<PPT, MOMENTS, BF16>(a);
  }
}

template <bool MOMENTS, bool BF16>
cudaError_t by_ppt(const Args& a) {
  switch (a.ppt) {
    case 1: return by_dim<1, MOMENTS, BF16>(a);
    case 2: return by_dim<2, MOMENTS, BF16>(a);
    case 4: return by_dim<4, MOMENTS, BF16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool MOMENTS>
int dispatch(const Args& a) {
  if (a.d < 1 || a.k_pad < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!a.occupancy) {
    if (a.n < 0 || a.k_real < 1 || a.k_real > a.k_pad || a.n_blocks < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    if (a.n == 0) return static_cast<int>(cudaSuccess);
  }
  const cudaError_t err =
      a.bf16 ? by_ppt<MOMENTS, true>(a) : by_ppt<MOMENTS, false>(a);
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* repro_error_name(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of the given configuration that fit on one SM at once; the
// caller sizes the grid to fill the card in a single wave.
extern "C" int repro_assign_occupancy(int d, int k_pad, int ppt, int bf16,
                                      int moments, int* blocks_per_sm) {
  Args a{};
  a.d = d;
  a.k_pad = a.k_real = k_pad;
  a.ppt = ppt;
  a.bf16 = bf16;
  a.n_blocks = 1;
  a.occupancy = blocks_per_sm;
  return moments ? dispatch<true>(a) : dispatch<false>(a);
}

// `order` may be null (row i is position i); `pairs` may be null (no
// count); `prune` = 0 computes every pair (the checks' reference).
extern "C" int repro_assign_argmin(const float* points, const int* order,
                                   const float* centers, const float* inv2,
                                   int n, int d, int k_pad, int k_real,
                                   int ppt, int bf16, int n_blocks,
                                   int prune, int* idx, float* best,
                                   float* second, void* pairs, void* stream) {
  Args a{};
  a.points = points;
  a.order = order;
  a.centers = centers;
  a.inv2 = inv2;
  a.n = n;
  a.d = d;
  a.k_pad = k_pad;
  a.k_real = k_real;
  a.ppt = ppt;
  a.bf16 = bf16;
  a.n_blocks = n_blocks;
  a.prune = prune;
  a.idx = idx;
  a.best = best;
  a.second = second;
  a.pairs = static_cast<unsigned long long*>(pairs);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(a);
}

extern "C" int repro_assign_reduce(const float* points, const int* order,
                                   const float* centers, const float* inv2,
                                   const float* weights, int n, int d,
                                   int k_pad, int k_real, int ppt, int bf16,
                                   int n_blocks, int prune, int* idx,
                                   float* best, float* second,
                                   float* partials, void* pairs,
                                   void* stream) {
  Args a{};
  a.points = points;
  a.order = order;
  a.centers = centers;
  a.inv2 = inv2;
  a.weights = weights;
  a.n = n;
  a.d = d;
  a.k_pad = k_pad;
  a.k_real = k_real;
  a.ppt = ppt;
  a.bf16 = bf16;
  a.n_blocks = n_blocks;
  a.prune = prune;
  a.idx = idx;
  a.best = best;
  a.second = second;
  a.partials = partials;
  a.pairs = static_cast<unsigned long long*>(pairs);
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(a);
}
