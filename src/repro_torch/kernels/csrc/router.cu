// Balanced-k-means MoE router for Hopper (sm_90a): the top-k experts of
// every token by effective squared distance to the expert centroids.
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/moe_router_kernel.py: _router_kernel (wrapper
//   router_topk_pallas, called by ops.router_topk). On the model path it
//   takes the place of models/moe.py router_logits + jax.lax.top_k for the
//   balanced_kmeans router.
//
// What it computes, for token t and expert e:
//   sq  = (|x_t|^2 + |c_e|^2) - 2 * (x_t . c_e)   (all sums in float32)
//   eff = max(sq, 0), scaled in one of three modes:
//     unit      no scale (a null pointer);
//     multiply  eff * inv2[e], inv2 = 1 / influence^2 given: the TPU
//               kernel's contract and ops.router_topk's;
//     divide    eff / (influence[e] * influence[e]), squared with __fmul_rn
//               and divided with __fdiv_rn: the reference model's
//               jnp.maximum(sq, 0) / (influence * influence) bit for bit
//               for the same sq (models/moe.py router_logits), so the
//               model path picks the reference's experts at any influence.
//   At influence 1 the three agree bit for bit (v * 1 == v / 1 == v). The
//   build has no --use_fast_math, so __fdiv_rn is IEEE division.
// and the top_k smallest eff of each token, ascending, the lower expert
// index first on ties, NaN after every number (the order of a stable
// sort). Every selection ranks each candidate by counting the candidates
// before it in that total order: ranks are distinct, the result does not
// depend on which thread runs first, and no float atomics are used, so the
// same inputs give the same bits on every run. x is read in its own
// storage type (bfloat16 or float32); the upcast to float32 is exact.
//
// What bounds it on the H100, and the two forms the entry point picks by T:
//   * Decode (T <= SMALL_T; serving runs T = 4, 32 launches a step): at
//     granite's widths (E = 40, D = 1536) it reads 245,760 bytes of
//     centroids and 12 KB of tokens, 0.08 us at 3.35 TB/s, and does
//     0.49 MFLOP. The floor is a launch plus one DRAM round trip (a few
//     microseconds), not the bytes. The split form spreads the E x D work
//     over E blocks, one expert each over the full D for all T tokens
//     (fixed-order warp and block sums give x.c, |c|^2 and |x|^2), so each
//     SM reads 6 KB; each block writes its column of eff [T, E] to a
//     scratch buffer, and the last block to finish (__threadfence, then an
//     atomic ticket that it resets to 0) ranks the rows. The ticket is
//     the wrapper's, one per (device, stream): launches on one stream run
//     one after another, so the ticket is back at 0 before the next launch
//     reads it. Design (b), one block a token over all of E x D (the
//     centroids from L2 after the first block), took 4-5 times as long
//     (tools/router_variants.py tune split token, PERF.md).
//   * Prefill (T = 4096): 2 T E D = 0.50 GFLOP, 7.5 us at the 67 TFLOP/s
//     float32 rate, against 12.6 MB of bfloat16 tokens (3.8 us): bound by
//     operations, on the CUDA cores (the float32 contract would need a
//     three-way bfloat16 split of the centroids on the tensor cores). The
//     tiled form: a 256-thread block takes 32 tokens and walks expert
//     tiles of exactly 8 x RE experts (RE = ceil(E / 8) up to 8: 40 at
//     granite, no padded lanes) and D in chunks of 128, staged by cp.async
//     through a ring of three chunks (two where three do not fit in
//     shared memory), so that loads overlap the multiply-adds.
//     Eight warps split the chunk into D slices (TH = 1: eight slices of
//     16 columns; TH = 2: two token halves x four slices); a lane holds an
//     RT-token x RE-expert register tile (8 x 5 at granite) and reads RT +
//     RE float4 values from shared memory for 4 RT RE multiply-adds,
//     without bank conflicts (rows padded to 132 floats; 4 token rows and
//     8 expert rows a warp). The slices are summed in a fixed order at
//     the end of a tile. |c|^2 is computed once a call by a small
//     kernel launched before it with programmatic dependent launch, so the
//     tiled kernel starts at once and waits for it (griddepcontrol.wait)
//     only where it first reads |c|^2; |x|^2 comes from the staged token
//     chunks of the first expert tile, 16 values a thread. The top-k
//     merge ranks the running list and the tile's candidates with 8
//     threads a token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int KMAX = 32;          // largest top_k
enum Mode { UNIT = 0, MULTIPLY = 1, DIVIDE = 2 };

// decode form
constexpr int SMALL_T = 32;       // tokens at or below which it is taken
constexpr int SMALL_TE = 12288;   // T * E floats the merge stages (48 KB)
constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_VPT = 8;        // D values of c a thread holds a pass

// tiled form
constexpr int TT_THREADS = 256;
constexpr int BT = 32;            // tokens a block
constexpr int DC = 128;           // D a chunk
constexpr int TH = 1;             // token groups of warps: 1 or 2
constexpr int KS = 8 / TH;        // D slices of a chunk (warps along D)
constexpr int RT = BT / (4 * TH); // tokens a thread
constexpr int SL = DC / KS;       // columns of a D slice
constexpr int XS = DC + 4;        // row stride of the float32 tiles
constexpr int XR = DC + 8;        // row stride of the raw bfloat16 chunk
constexpr int NORM_WARPS = 8;     // experts a block of the |c|^2 kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same, fixed-order sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// eff of one (token, expert) from its sums, in the mode's scale
__device__ __forceinline__ float effective(float xn, float cn, float dot,
                                           const float* __restrict__ scale,
                                           int mode, int e) {
  const float sq = __fsub_rn(__fadd_rn(xn, cn), __fmul_rn(2.0f, dot));
  const float v = sq < 0.0f ? 0.0f : sq;     // max(sq, 0), NaN kept
  if (mode == MULTIPLY) return __fmul_rn(v, scale[e]);
  if (mode == DIVIDE) {
    const float i = scale[e];
    return __fdiv_rn(v, __fmul_rn(i, i));
  }
  return v;
}

// the total order of the selection: does (va, ia) come before (vb, ib)?
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return nb && (!na || ia < ib);
  return va < vb || (va == vb && ia < ib);
}

// The top_k of rows [T][E] of eff in shared memory (row t is token t0 + t):
// each (token, expert) is ranked within its row by all threads.
__device__ void merge_rows(const float* eff_s, int T, int E, int top_k,
                           int t0, int* __restrict__ idx_out,
                           float* __restrict__ eff_out) {
  const int n = E;   // experts the merge reads
  for (int i = threadIdx.x; i < T * n; i += blockDim.x) {
    const int t = i / n, e = i % n;
    const float* row = eff_s + t * E;
    const float v = row[e];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += before(row[j], j, v, e);
    if (rank < top_k) {
      const size_t o = static_cast<size_t>(t0 + t) * top_k + rank;
      idx_out[o] = e;
      eff_out[o] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// decode form (a): experts split across blocks, one launch
// ---------------------------------------------------------------------------

template <typename XT>
__global__ void __launch_bounds__(DEC_THREADS)
router_decode_split(const XT* __restrict__ x, const float* __restrict__ c,
                    const float* __restrict__ scale, int mode, int T, int E,
                    int D, int top_k, float* __restrict__ scratch,
                    unsigned* __restrict__ ticket, int* __restrict__ idx_out,
                    float* __restrict__ eff_out) {
  extern __shared__ float merge_s[];        // [T][E]: the last block's
  __shared__ float red[DEC_WARPS][2 * SMALL_T + 1];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int e = blockIdx.x;
  const float* ce = c + static_cast<size_t>(e) * D;

  // this thread's share of x_t . c_e and |x_t|^2 for every token, and of
  // |c_e|^2, over D values tid, tid + 256, ...
  float dot[SMALL_T], xn[SMALL_T], cn = 0.0f;
#pragma unroll
  for (int t = 0; t < SMALL_T; ++t) dot[t] = xn[t] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += DEC_THREADS * DEC_VPT) {
    float cv[DEC_VPT];
#pragma unroll
    for (int v = 0; v < DEC_VPT; ++v) {
      const int d = d0 + v * DEC_THREADS + tid;
      cv[v] = d < D ? ce[d] : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < DEC_VPT; ++v) cn = fmaf(cv[v], cv[v], cn);
#pragma unroll
    for (int t = 0; t < SMALL_T; ++t) {
      if (t < T) {
        const XT* xt = x + static_cast<size_t>(t) * D;
#pragma unroll
        for (int v = 0; v < DEC_VPT; ++v) {
          const int d = d0 + v * DEC_THREADS + tid;
          const float xv = d < D ? to_f32(xt[d]) : 0.0f;
          dot[t] = fmaf(xv, cv[v], dot[t]);
          xn[t] = fmaf(xv, xv, xn[t]);
        }
      }
    }
  }
  cn = warp_sum(cn);
  if (lane == 0) red[warp][2 * SMALL_T] = cn;
#pragma unroll
  for (int t = 0; t < SMALL_T; ++t) {
    if (t < T) {
      const float a = warp_sum(dot[t]), b = warp_sum(xn[t]);
      if (lane == 0) {
        red[warp][t] = a;
        red[warp][SMALL_T + t] = b;
      }
    }
  }
  __syncthreads();
  if (tid < T) {
    float ds = 0.0f, xs = 0.0f, cs = 0.0f;
    for (int w = 0; w < DEC_WARPS; ++w) {
      ds += red[w][tid];
      xs += red[w][SMALL_T + tid];
      cs += red[w][2 * SMALL_T];
    }
    scratch[static_cast<size_t>(tid) * E + e] =
        effective(xs, cs, ds, scale, mode, e);
    __threadfence();   // the column is visible before the ticket is taken
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: every column has landed; rank the rows
  __threadfence();
  for (int i = tid; i < T * E; i += DEC_THREADS) merge_s[i] = __ldcg(scratch + i);
  __syncthreads();
  merge_rows(merge_s, T, E, top_k, 0, idx_out, eff_out);
  if (tid == 0) *ticket = 0u;   // ready for the next launch on this stream
}

// ---------------------------------------------------------------------------
// tiled form
// ---------------------------------------------------------------------------

// |c_e|^2 of every expert, once a call: a warp an expert
__global__ void __launch_bounds__(NORM_WARPS * 32)
router_center_norms(const float* __restrict__ c, int E, int D,
                    float* __restrict__ cn) {
  // the tiled kernel may start now; it waits for this grid where it first
  // reads cn
  asm volatile("griddepcontrol.launch_dependents;");
  const int e = blockIdx.x * NORM_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= E) return;
  const float* ce = c + static_cast<size_t>(e) * D;
  float s = 0.0f;
#pragma unroll 8
  for (int d = lane; d < D; d += 32) s = fmaf(ce[d], ce[d], s);
  s = warp_sum(s);
  if (lane == 0) cn[e] = s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename XT, int RE>
struct Tiled {
  static constexpr int BE = 8 * RE;        // experts a tile
  static constexpr int CW = KMAX + BE;     // candidates a token, at most
  static constexpr bool RAW = !std::is_same<XT, float>::value;
  // shared memory in floats for a ring of `st` chunks: the float32 token
  // tile (one, converted from the raw bfloat16 ring; or a ring slot for
  // each chunk of float32 tokens), the centroid ring, the D-slice sums,
  // the candidates, the running top-k, |x|^2, |c|^2, the raw token ring
  static constexpr int floats(int st) {
    return (RAW ? 1 : st) * BT * XS + st * BE * XS + KS * BT * BE +
           2 * BT * CW + 2 * BT * KMAX + BT + BE +
           (RAW ? st * BT * XR / 2 : 0);
  }
  // three chunks in the ring where they fit in a block's 227 KB, else two
  static constexpr int STAGES = 4 * floats(3) <= 232448 ? 3 : 2;
  static constexpr int X_OFF = 0;
  static constexpr int C_OFF = X_OFF + (RAW ? 1 : STAGES) * BT * XS;
  static constexpr int RED_OFF = C_OFF + STAGES * BE * XS;
  static constexpr int CV_OFF = RED_OFF + KS * BT * BE;
  static constexpr int CI_OFF = CV_OFF + BT * CW;
  static constexpr int TV_OFF = CI_OFF + BT * CW;
  static constexpr int TI_OFF = TV_OFF + BT * KMAX;
  static constexpr int XN_OFF = TI_OFF + BT * KMAX;
  static constexpr int CN_OFF = XN_OFF + BT;
  static constexpr int RAW_OFF = CN_OFF + BE;
  static constexpr size_t BYTES = sizeof(float) * floats(STAGES);
  static_assert(BYTES <= 232448, "tiled router: shared memory");
};

// Stage chunk q (expert tile q / n_ch, D chunk q % n_ch) into ring slot s:
// the centroid rows by cp.async, the token rows by cp.async as stored
// (float32 into the slot's float tile, bfloat16 into the raw ring). Rows
// and columns past T, E and D are zero. Without 16-byte alignment (vec_x,
// vec_c false) the same copies are made with synchronous loads.
template <typename XT, int RE>
__device__ __forceinline__ void stage_chunk(
    float* sm, int s, int q, int n_ch, const XT* __restrict__ x,
    const float* __restrict__ c, int t0, int T, int E, int D, bool vec_x,
    bool vec_c) {
  using L = Tiled<XT, RE>;
  const int tid = threadIdx.x;
  const int e0 = (q / n_ch) * L::BE, d0 = (q % n_ch) * DC;
  float* cs = sm + L::C_OFF + s * L::BE * XS;
  if (vec_c) {
#pragma unroll
    for (int u = 0; u < RE; ++u) {
      const int v = tid + u * TT_THREADS;          // BE rows x 32 float4
      const int r = v / 32, col = d0 + (v % 32) * 4;
      const bool ok = e0 + r < E && col < D;
      cp_async16(cs + r * XS + (v % 32) * 4,
                 ok ? c + static_cast<size_t>(e0 + r) * D + col : c, ok);
    }
  } else {
    for (int i = tid; i < L::BE * DC; i += TT_THREADS) {
      const int r = i / DC, col = d0 + i % DC;
      cs[r * XS + i % DC] = (e0 + r < E && col < D)
          ? c[static_cast<size_t>(e0 + r) * D + col] : 0.0f;
    }
  }
  // the token rows: [BT][XR] bfloat16 or [BT][XS] float32, row stride LD
  XT* xd = L::RAW
      ? reinterpret_cast<XT*>(sm + L::RAW_OFF) + s * BT * XR
      : reinterpret_cast<XT*>(sm + L::X_OFF + s * BT * XS);
  constexpr int LD = L::RAW ? XR : XS;
  constexpr int PER = 16 / sizeof(XT);            // elements a 16-byte copy
  if (vec_x) {
    constexpr int ROW_V = DC / PER;
#pragma unroll
    for (int u = 0; u < BT * ROW_V / TT_THREADS; ++u) {
      const int v = tid + u * TT_THREADS;
      const int r = v / ROW_V, col = d0 + (v % ROW_V) * PER;
      const bool ok = t0 + r < T && col < D;
      cp_async16(xd + r * LD + (v % ROW_V) * PER,
                 ok ? x + static_cast<size_t>(t0 + r) * D + col : x, ok);
    }
  } else {
    for (int i = tid; i < BT * DC; i += TT_THREADS) {
      const int r = i / DC, col = d0 + i % DC;
      xd[r * LD + i % DC] = (t0 + r < T && col < D)
          ? x[static_cast<size_t>(t0 + r) * D + col] : XT{};
    }
  }
}

template <typename XT, int RE>
__global__ void __launch_bounds__(TT_THREADS)
router_tiled(const XT* __restrict__ x, const float* __restrict__ c,
             const float* __restrict__ scale, int mode, int T, int E, int D,
             int top_k, const float* __restrict__ cnorm, int vec_x_,
             int vec_c_, int* __restrict__ idx_out,
             float* __restrict__ eff_out) {
  using L = Tiled<XT, RE>;
  constexpr int BE = L::BE, CW = L::CW;
  extern __shared__ __align__(16) float sm[];
  float* red = sm + L::RED_OFF;
  float* cand_v = sm + L::CV_OFF;
  int* cand_i = reinterpret_cast<int*>(sm + L::CI_OFF);
  float* top_v = sm + L::TV_OFF;
  int* top_i = reinterpret_cast<int*>(sm + L::TI_OFF);
  float* xn_s = sm + L::XN_OFF;
  float* cn_s = sm + L::CN_OFF;
  const bool vec_x = vec_x_ != 0, vec_c = vec_c_ != 0;
  constexpr int ST = L::STAGES;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * BT;
  const int th = warp % TH, ks = warp / TH;  // token group, D slice
  const int tg = lane & 3, eg = lane >> 2;   // lane's tokens, experts
  // this thread's tokens xrow + 4i (i < RT), experts eg + 8j (j < RE)
  const int xrow = th * (BT / TH) + tg;
  // its share of the bfloat16 conversion and of |x|^2: token tid / 8,
  // columns (tid % 8) * 4 + 32u (u < 4), so that 8 neighbouring lanes
  // touch 8 neighbouring 16-byte words
  const int nrow = tid / 8, ncol = (tid % 8) * 4;

  const int n_ch = (D + DC - 1) / DC;
  const int n_tiles = (E + BE - 1) / BE;
  const int n_q = n_tiles * n_ch;

  float acc[RT][RE];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RE; ++j) acc[i][j] = 0.0f;
  float xnp = 0.0f;

  // a ring of ST chunks: ST - 1 in flight while one is used
#pragma unroll
  for (int p = 0; p < ST - 1; ++p) {
    if (p < n_q)
      stage_chunk<XT, RE>(sm, p, p, n_ch, x, c, t0, T, E, D, vec_x, vec_c);
    cp_async_commit();
  }
  for (int q = 0; q < n_q; ++q) {
    const int s = q % ST, tile = q / n_ch, ch = q % n_ch;
    // the slot of chunk q - 1, free since the end of the last iteration
    if (q + ST - 1 < n_q)
      stage_chunk<XT, RE>(sm, (q + ST - 1) % ST, q + ST - 1, n_ch, x, c, t0,
                          T, E, D, vec_x, vec_c);
    cp_async_commit();
    cp_async_wait<ST - 1>();   // chunk q has landed (this thread's copies)
    __syncthreads();           // ... and every thread's
    float* xs = sm + L::X_OFF + (L::RAW ? 0 : s * BT * XS);
    const float* cs = sm + L::C_OFF + s * BE * XS;
    if (L::RAW) {
      // bfloat16 -> float32 once a chunk, 16 values a thread
      const __nv_bfloat16* raw = reinterpret_cast<const __nv_bfloat16*>(
          sm + L::RAW_OFF) + s * BT * XR + nrow * XR + ncol;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(raw + 32 * u));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(raw + 32 * u + 2));
        *reinterpret_cast<float4*>(xs + nrow * XS + ncol + 32 * u) =
            make_float4(a.x, a.y, b.x, b.y);
      }
      __syncthreads();
    }
    if (tile == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v =
            *reinterpret_cast<const float4*>(xs + nrow * XS + ncol + 32 * u);
        xnp = fmaf(v.x, v.x, xnp);
        xnp = fmaf(v.y, v.y, xnp);
        xnp = fmaf(v.z, v.z, xnp);
        xnp = fmaf(v.w, v.w, xnp);
      }
    }
    {
      const float* xp = xs + xrow * XS + ks * SL;
      const float* cp = cs + eg * XS + ks * SL;
#pragma unroll
      for (int st = 0; st < SL; st += 4) {
        float4 xv[RT], cv[RE];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xp + 4 * i * XS + st);
#pragma unroll
        for (int j = 0; j < RE; ++j)
          cv[j] = *reinterpret_cast<const float4*>(cp + 8 * j * XS + st);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RE; ++j) {
            acc[i][j] = fmaf(xv[i].x, cv[j].x, acc[i][j]);
            acc[i][j] = fmaf(xv[i].y, cv[j].y, acc[i][j]);
            acc[i][j] = fmaf(xv[i].z, cv[j].z, acc[i][j]);
            acc[i][j] = fmaf(xv[i].w, cv[j].w, acc[i][j]);
          }
      }
    }
    if (ch == n_ch - 1) {
      // the tile's sums: D slices in order, then eff, then the merge
      const int e0 = tile * BE;
      if (tile == 0) {
        xnp += __shfl_xor_sync(0xffffffffu, xnp, 1);
        xnp += __shfl_xor_sync(0xffffffffu, xnp, 2);
        xnp += __shfl_xor_sync(0xffffffffu, xnp, 4);
        if (tid % 8 == 0) xn_s[nrow] = xnp;
        // |c|^2 comes from the kernel launched before this one
        asm volatile("griddepcontrol.wait;" ::: "memory");
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RE; ++j) {
          red[(ks * BT + xrow + 4 * i) * BE + eg + 8 * j] = acc[i][j];
          acc[i][j] = 0.0f;
        }
      for (int i = tid; i < BE; i += TT_THREADS)
        cn_s[i] = e0 + i < E ? cnorm[e0 + i] : 0.0f;
      __syncthreads();
      const int n_run = min(top_k, e0);   // kept from the earlier tiles
      const int n_tile = min(BE, E - e0);  // experts of this tile merged
      const int n_cand = n_run + n_tile;
      for (int i = tid; i < BT * BE; i += TT_THREADS) {
        const int r = i / BE, el = i % BE;
        if (el < n_tile) {
          float dot = red[r * BE + el];
#pragma unroll
          for (int k = 1; k < KS; ++k) dot += red[(k * BT + r) * BE + el];
          cand_v[r * CW + n_run + el] =
              effective(xn_s[r], cn_s[el], dot, scale, mode, e0 + el);
          cand_i[r * CW + n_run + el] = e0 + el;
        }
      }
      for (int i = tid; i < BT * n_run; i += TT_THREADS) {
        const int r = i / n_run, k = i % n_run;
        cand_v[r * CW + k] = top_v[r * KMAX + k];
        cand_i[r * CW + k] = top_i[r * KMAX + k];
      }
      __syncthreads();
      {
        const int r = tid / 8;            // 8 threads a token
        const float* rv = cand_v + r * CW;
        const int* ri = cand_i + r * CW;
        for (int k = tid % 8; k < n_cand; k += 8) {
          const float v = rv[k];
          const int id = ri[k];
          int rank = 0;
          for (int j = 0; j < n_cand; ++j) rank += before(rv[j], ri[j], v, id);
          if (rank < top_k) {
            top_v[r * KMAX + rank] = v;
            top_i[r * KMAX + rank] = id;
          }
        }
      }
    }
    __syncthreads();   // slot s and the merge lists are free again
  }
  for (int i = tid; i < BT * top_k; i += TT_THREADS) {
    const int r = i / top_k, k = i % top_k;
    if (t0 + r < T) {
      const size_t o = static_cast<size_t>(t0 + r) * top_k + k;
      idx_out[o] = top_i[r * KMAX + k];
      eff_out[o] = top_v[r * KMAX + k];
    }
  }
}

template <typename XT, int RE>
int launch_tiled_re(const XT* x, const float* c, const float* scale,
                    int mode, int T, int E, int D, int top_k, int* idx,
                    float* eff, float* scratch, cudaStream_t st) {
  using L = Tiled<XT, RE>;
  cudaError_t err = cudaFuncSetAttribute(
      router_tiled<XT, RE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  router_center_norms<<<(E + NORM_WARPS - 1) / NORM_WARPS, NORM_WARPS * 32,
                        0, st>>>(c, E, D, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_x = D % (16 / sizeof(XT)) == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_c = D % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + BT - 1) / BT);
  cfg.blockDim = dim3(TT_THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cn = scratch;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, router_tiled<XT, RE>, x, c, scale, mode, T, E, D, top_k, cn,
      vec_x, vec_c, idx, eff));
}

template <typename XT>
int launch(const XT* x, const float* c, const float* scale, int mode, int T,
           int E, int D, int top_k, int* idx, float* eff, float* scratch,
           unsigned* ticket, cudaStream_t st) {
  if (T <= SMALL_T && T * E <= SMALL_TE) {
    router_decode_split<XT><<<E, DEC_THREADS, T * E * sizeof(float), st>>>(
        x, c, scale, mode, T, E, D, top_k, scratch, ticket, idx, eff);
    return static_cast<int>(cudaGetLastError());
  }
  // expert tiles of 8 x RE: E itself up to 64 (granite's 40: RE = 5)
  switch (E >= 64 ? 8 : (E + 7) / 8) {
    case 1: return launch_tiled_re<XT, 1>(x, c, scale, mode, T, E, D, top_k, idx, eff, scratch, st);
    case 2: return launch_tiled_re<XT, 2>(x, c, scale, mode, T, E, D, top_k, idx, eff, scratch, st);
    case 3: return launch_tiled_re<XT, 3>(x, c, scale, mode, T, E, D, top_k, idx, eff, scratch, st);
    case 4: return launch_tiled_re<XT, 4>(x, c, scale, mode, T, E, D, top_k, idx, eff, scratch, st);
    case 5: return launch_tiled_re<XT, 5>(x, c, scale, mode, T, E, D, top_k, idx, eff, scratch, st);
    case 6: return launch_tiled_re<XT, 6>(x, c, scale, mode, T, E, D, top_k, idx, eff, scratch, st);
    case 7: return launch_tiled_re<XT, 7>(x, c, scale, mode, T, E, D, top_k, idx, eff, scratch, st);
    default: return launch_tiled_re<XT, 8>(x, c, scale, mode, T, E, D, top_k, idx, eff, scratch, st);
  }
}

}  // namespace

extern "C" const char* repro_error_name(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: [T, D] (bfloat16 if bf16 != 0, else float32), centroids: [E, D]
// float32, scale: [E] float32 (inv2 for mode 1, influence for mode 2, null
// for mode 0), all contiguous. idx: [T, top_k] int32, eff: [T, top_k]
// float32. scratch: T * E float32 (at least E) and ticket: one unsigned
// that is 0 between launches, both the caller's, one ticket a stream.
// Returns the launches' cudaGetLastError().
extern "C" int repro_router_topk(const void* x, const float* centroids,
                                 const float* scale, int mode, int bf16,
                                 int T, int E, int D, int top_k, int* idx,
                                 float* eff, float* scratch,
                                 unsigned* ticket, void* stream) {
  if (T < 0 || D < 1 || E < 1 || top_k < 1 || top_k > KMAX || top_k > E ||
      mode < UNIT || mode > DIVIDE || (mode != UNIT && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), centroids, scale,
                  mode, T, E, D, top_k, idx, eff, scratch, ticket, st);
  return launch(static_cast<const float*>(x), centroids, scale, mode, T, E,
                D, top_k, idx, eff, scratch, ticket, st);
}
