// Causal flash attention, forward, float32, on the CUDA cores (sm_90a).
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention.py: _flash_kernel (wrapper
//   flash_attention_pallas) for float32 inputs: the model's prefill when
//   its activations are float32 (cfg.dtype = "float32"). bfloat16 inputs
//   go to the tensor-core kernel of flash_attention_tc.cu; float32 stays
//   here because TF32 tensor cores would lose the 2e-5 agreement the
//   float32 checks hold.
//
// What it computes, for batch b, query head h (key/value head h / G with
// G = H / KV) and query position i:
//   s_j   = (q_i . k_j) * scale for keys j <= i; with a softcap c,
//           s_j = tanh(s_j / c) * c; keys above the diagonal are -1e30;
//   out_i = sum_j softmax(s)_j v_j.
// It is an online softmax over key tiles with m, l and O in float32, m
// starting at NEG_INF = -1e30 and l clamped at 1e-30, as in the TPU
// kernel. Scores are kept in base 2: q is scaled by scale * log2(e) as it
// is staged (by scale / c with a softcap, whose tanh is then multiplied by
// c * log2(e)), and p and alpha are exp2 of differences, which is the same
// softmax. q, k and v are read through strides, so the model's [B, S, H,
// dh] layout needs no transposed copy; the 16-byte reads need 16-byte
// aligned bases and batch/seq/head strides that are multiples of 4 floats
// (the wrapper checks both). Keys and queries past S (a ragged last tile)
// read as zero; such keys lie above the diagonal of every real query and
// such queries are not stored.
//
// What bounds it on the H100: operations. One granite layer at S = 4096
// (24 query heads, dh 64) is 4 dh H S(S+1)/2 ~ 51.6 GFLOP; at the CUDA
// cores' float32 rate (67 TFLOP/s) its floor is 0.77 ms, against 33.6 MB
// of inputs and outputs (0.01 ms of HBM time). The design keeps the FMA
// units fed from registers:
//   * register tiles: a warp is 4 row groups x 8 column groups of lanes; a
//     thread holds RM query rows x BK/8 keys of S and RM rows x dh/8
//     columns of O (8 x 8 and 8 x 8 at dh <= 64, 8 warps over 256 queries
//     and 64-key tiles: 8 warps an SM, where two blocks of 4 warps over
//     128 queries would not fit one SM's shared memory). The shared
//     operands are laid out for 16-byte reads, as a CUDA-core SGEMM's are:
//     Q^T [dh][BQ] (staged once a block), K^T [dh][BK], V [BK][dh] and
//     each warp's own P^T [BK][rows] (its 16-byte chunks XOR-swizzled by
//     key, so the transposed stores of P hit distinct banks). Each value
//     read from shared memory feeds RM or BK/8 multiply-adds: 8 at
//     dh <= 64, where one scalar load fed two;
//   * softmax inside a warp: row max through shuffles over the 8 lanes
//     that share a row; m in registers, l as per-lane partial sums
//     (scaled by the same alpha) reduced once at the end. A warp writes
//     its P slice and reads it back after a __syncwarp;
//   * two K/V slots: tile kt+1's V goes in by 16-byte cp.async.cg at the
//     start of tile kt; its K is read by 16-byte loads into registers
//     during tile kt's PV product (S is dead then, so the registers are
//     free) and stored transposed after it, each thread keeping one key
//     and one address. One block-wide barrier a tile;
//   * causality: a block loops over key tiles up to its last real query
//     only; a warp skips a tile, or on a diagonal tile a key sub-block
//     (8 KV keys), that lies wholly above its rows (warp-uniform
//     branches), and masks only on tiles that cross its diagonal. Blocks
//     take the query tiles longest first across all heads (blockIdx.y).
// dh 96 and 128 take 4 rows a thread (128 queries a block), dh 256 two
// rows over 32-key tiles (64 queries), so that O, the K registers and the
// operands fit in 255 registers and the tiles in 227 KB of shared memory;
// registers and spills per instance are what `nvcc -Xptxas -v` prints at
// the build (chip_smoke.py's build phase logs them; PERF.md records them).
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
constexpr size_t MAX_SMEM = 232448;   // a block's shared memory on sm_90

struct Strides {            // in elements; the head dim has stride 1
  long long b, s, h;
};

// The block shape of each head-dim instance. A warp's lanes are 4 row
// groups (rg) x 8 column groups (cg), lane = 8 rg + cg. Thread (rg, cg)
// holds rows (i / RV) 4 RV + rg RV + i % RV of its warp's WQ rows, keys
// (j / KV) 8 KV + cg KV + j % KV of a tile and columns (n / DV) 8 DV +
// cg DV + n % DV of O.
template <int DH>
struct Tile {
  static constexpr int NW = 8;                                   // warps
  static constexpr int RM = DH <= 64 ? 8 : (DH <= 128 ? 4 : 2);  // rows a thread
  static constexpr int BK = DH <= 128 ? 64 : 32;                 // keys a tile
  static constexpr int UNROLL = 8;          // of the d and the key loops
  static constexpr int THREADS = 32 * NW;
  static constexpr int WQ = 4 * RM;     // query rows a warp
  static constexpr int BQ = NW * WQ;    // query rows a block
  static constexpr int KN = BK / 8;     // keys a thread
  static constexpr int DN = DH / 8;     // columns of O a thread
  // floats in one shared-memory access: rows, keys, columns
  static constexpr int RV = RM < 4 ? RM : 4;
  static constexpr int KV = KN < 4 ? KN : 4;
  static constexpr int DV = DN < 4 ? DN : 4;
  static constexpr int KG = KN / KV;    // key sub-blocks of 8 KV keys
  static constexpr int NCH = WQ / RV;   // RV-float chunks of a P^T row
  // shared memory in floats: Q^T, K^T and V slots, each warp's P^T
  static constexpr int Q_F = DH * BQ;
  static constexpr int K_F = DH * BK;
  static constexpr int V_F = BK * DH;
  static constexpr int P_F = BK * WQ;
  static constexpr size_t SMEM =
      sizeof(float) * (Q_F + 2 * K_F + 2 * V_F + NW * P_F);
  static_assert(BK % 32 == 0 && KN % KV == 0 && RM % RV == 0 &&
                    DN % DV == 0 && (NCH & (NCH - 1)) == 0,
                "unsupported tile shape");
  static_assert(SMEM <= MAX_SMEM, "tile does not fit in shared memory");
};

template <int N>
__device__ __forceinline__ void ld_vec(float* r, const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x; r[1] = x.y;
  } else {
    r[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float* r) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

// 16 bytes global -> shared, zero-filled when bytes is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Q^T [DH][BQ] of query rows q0.., times qscale (rows past S are zero)
template <int DH>
__device__ __forceinline__ void stage_q(float* q_s, const float* qb,
                                        long long ss, int q0, int S,
                                        float qscale) {
  using T = Tile<DH>;
  constexpr int N = T::BQ * DH / 4;
#pragma unroll 4
  for (int it = 0; it < (N + T::THREADS - 1) / T::THREADS; ++it) {
    const int idx = threadIdx.x + it * T::THREADS;
    if (N % T::THREADS != 0 && idx >= N) break;
    const int r = idx % T::BQ, c = idx / T::BQ, pos = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < S) x = __ldg(reinterpret_cast<const float4*>(qb + pos * ss) + c);
    q_s[(4 * c + 0) * T::BQ + r] = x.x * qscale;
    q_s[(4 * c + 1) * T::BQ + r] = x.y * qscale;
    q_s[(4 * c + 2) * T::BQ + r] = x.z * qscale;
    q_s[(4 * c + 3) * T::BQ + r] = x.w * qscale;
  }
}

// One key tile of K in registers, 16 bytes a load. A thread keeps one key
// (consecutive lanes take consecutive keys, so the transposed stores hit
// consecutive banks) and steps over its chunks: one address, constant
// offsets, so the staging holds few registers beside the accumulators.
template <int DH>
struct KRegs {
  static_assert(Tile<DH>::THREADS % Tile<DH>::BK == 0, "K staging");
  static constexpr int C = DH / 4;                                 // chunks
  static constexpr int STEP = Tile<DH>::THREADS / Tile<DH>::BK;    // a pass
  static constexpr int PER = (C + STEP - 1) / STEP;
  float4 r[PER];
};

template <int DH>
__device__ __forceinline__ void load_k(KRegs<DH>& kr, const float* kb,
                                       long long ss, int k0, int S) {
  using T = Tile<DH>;
  using R = KRegs<DH>;
  const int c0 = threadIdx.x / T::BK, pos = k0 + threadIdx.x % T::BK;
  const float* src = kb + pos * ss + 4 * c0;
#pragma unroll
  for (int it = 0; it < R::PER; ++it) {
    kr.r[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((R::C % R::STEP == 0 || c0 + it * R::STEP < R::C) && pos < S)
      kr.r[it] = __ldg(reinterpret_cast<const float4*>(src) + it * R::STEP);
  }
}

template <int DH>
__device__ __forceinline__ void store_k(float* k_s, const KRegs<DH>& kr) {
  using T = Tile<DH>;
  using R = KRegs<DH>;
  const int c0 = threadIdx.x / T::BK;
  float* dst = k_s + 4 * c0 * T::BK + threadIdx.x % T::BK;
#pragma unroll
  for (int it = 0; it < R::PER; ++it) {
    if (R::C % R::STEP != 0 && c0 + it * R::STEP >= R::C) break;
    float* d = dst + 4 * it * R::STEP * T::BK;
    d[0 * T::BK] = kr.r[it].x;
    d[1 * T::BK] = kr.r[it].y;
    d[2 * T::BK] = kr.r[it].z;
    d[3 * T::BK] = kr.r[it].w;
  }
}

// V [BK][DH] of keys k0.. by cp.async (keys past S zero-filled). A thread
// keeps one 16-byte column chunk and steps over rows with a running
// source pointer.
template <int DH>
__device__ __forceinline__ void copy_v(float* v_s, const float* vb,
                                        long long ss, int k0, int S) {
  using T = Tile<DH>;
  constexpr int C = DH / 4;
  constexpr int STEP = T::THREADS / C;          // rows a pass
  constexpr int PER = (T::BK + STEP - 1) / STEP;
  static_assert(STEP >= 1, "V staging");
  const int c = threadIdx.x % C, r0 = threadIdx.x / C;
  if (T::THREADS % C != 0 && r0 >= STEP) return;
  const float* src = vb + (k0 + r0) * ss + 4 * c;
  float* dst = v_s + r0 * DH + 4 * c;
#pragma unroll
  for (int it = 0; it < PER; ++it) {
    const int r = r0 + it * STEP;
    if (T::BK % STEP != 0 && r >= T::BK) break;
    const bool in = k0 + r < S;
    cp_async16(dst + it * STEP * DH, in ? src : vb, in ? 16 : 0);
    src += STEP * ss;
  }
}

// S = Q K^T of one key tile for the warp's rows, the online softmax, P^T
// into the warp's slice and O rescaled. DIAG: the tile crosses the warp's
// diagonal, so keys above it are masked and only the first n_sub key
// sub-blocks are computed.
template <int DH, bool DIAG>
__device__ __forceinline__ void scores(
    const float* q_s, const float* k_s, float* p_s,
    float (&m)[Tile<DH>::RM], float (&l)[Tile<DH>::RM],
    float (&o)[Tile<DH>::RM][Tile<DH>::DN], int warp, int rg, int cg, int k0,
    int w0, int n_sub, float cap_l2) {
  using T = Tile<DH>;
  float s[T::RM][T::KN];
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int j = 0; j < T::KN; ++j) s[i][j] = 0.0f;
  const float* qw = q_s + warp * T::WQ + rg * T::RV;
  const float* kc = k_s + cg * T::KV;
  if constexpr (!DIAG) {
#pragma unroll(T::UNROLL)
    for (int d = 0; d < DH; ++d) {
      float qf[T::RM], kf[T::KN];
#pragma unroll
      for (int g = 0; g < T::RM / T::RV; ++g)
        ld_vec<T::RV>(qf + g * T::RV, qw + d * T::BQ + g * 4 * T::RV);
#pragma unroll
      for (int jg = 0; jg < T::KG; ++jg)
        ld_vec<T::KV>(kf + jg * T::KV, kc + d * T::BK + jg * 8 * T::KV);
#pragma unroll
      for (int i = 0; i < T::RM; ++i)
#pragma unroll
        for (int j = 0; j < T::KN; ++j) s[i][j] = fmaf(qf[i], kf[j], s[i][j]);
    }
  } else {
#pragma unroll
    for (int jg = 0; jg < T::KG; ++jg) {
      if (jg >= n_sub) break;   // warp-uniform: the sub-block is above it
#pragma unroll(T::UNROLL)
      for (int d = 0; d < DH; ++d) {
        float qf[T::RM], kf[T::KV];
#pragma unroll
        for (int g = 0; g < T::RM / T::RV; ++g)
          ld_vec<T::RV>(qf + g * T::RV, qw + d * T::BQ + g * 4 * T::RV);
        ld_vec<T::KV>(kf, kc + d * T::BK + jg * 8 * T::KV);
#pragma unroll
        for (int i = 0; i < T::RM; ++i)
#pragma unroll
          for (int j = 0; j < T::KV; ++j)
            s[i][jg * T::KV + j] = fmaf(qf[i], kf[j], s[i][jg * T::KV + j]);
      }
    }
  }
  if (cap_l2 > 0.0f) {
#pragma unroll
    for (int i = 0; i < T::RM; ++i)
#pragma unroll
      for (int j = 0; j < T::KN; ++j) s[i][j] = tanhf(s[i][j]) * cap_l2;
  }
  if constexpr (DIAG) {
#pragma unroll
    for (int i = 0; i < T::RM; ++i) {
      const int row =
          w0 + (i / T::RV) * 4 * T::RV + rg * T::RV + i % T::RV;
#pragma unroll
      for (int j = 0; j < T::KN; ++j) {
        const int key =
            k0 + (j / T::KV) * 8 * T::KV + cg * T::KV + j % T::KV;
        if (key > row) s[i][j] = NEG_INF;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    float mx = s[i][0];
#pragma unroll
    for (int j = 1; j < T::KN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = exp2f(m[i] - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < T::KN; ++j) {
      s[i][j] = exp2f(s[i][j] - m_new);
      rs += s[i][j];
    }
    l[i] = l[i] * alpha + rs;
    m[i] = m_new;
#pragma unroll
    for (int n = 0; n < T::DN; ++n) o[i][n] *= alpha;
  }
  // P^T [key][row]: row chunk (g 4 + rg) of key j at chunk index XOR
  // (key / KV) mod NCH, so the 8 lanes of a row group write 8 banks
#pragma unroll
  for (int j = 0; j < T::KN; ++j) {
    const int key = (j / T::KV) * 8 * T::KV + cg * T::KV + j % T::KV;
    const int x = (key / T::KV) & (T::NCH - 1);
#pragma unroll
    for (int g = 0; g < T::RM / T::RV; ++g) {
      float r[T::RV];
#pragma unroll
      for (int e = 0; e < T::RV; ++e) r[e] = s[g * T::RV + e][j];
      st_vec<T::RV>(p_s + key * T::WQ + ((g * 4 + rg) ^ x) * T::RV, r);
    }
  }
}

// O += P V over the tile's first n_keys keys (all BK unless DIAG)
template <int DH, bool DIAG>
__device__ __forceinline__ void pv(float (&o)[Tile<DH>::RM][Tile<DH>::DN],
                                   const float* p_s, const float* v_s,
                                   int rg, int cg, int n_sub) {
  using T = Tile<DH>;
  const int n_keys = DIAG ? n_sub * 8 * T::KV : T::BK;
  const float* vc = v_s + cg * T::DV;
#pragma unroll(T::UNROLL)
  for (int c = 0; c < n_keys; ++c) {
    const int x = (c / T::KV) & (T::NCH - 1);
    float pf[T::RM], vf[T::DN];
#pragma unroll
    for (int g = 0; g < T::RM / T::RV; ++g)
      ld_vec<T::RV>(pf + g * T::RV, p_s + c * T::WQ + ((g * 4 + rg) ^ x) * T::RV);
#pragma unroll
    for (int dg = 0; dg < T::DN / T::DV; ++dg)
      ld_vec<T::DV>(vf + dg * T::DV, vc + c * DH + dg * 8 * T::DV);
#pragma unroll
    for (int i = 0; i < T::RM; ++i)
#pragma unroll
      for (int n = 0; n < T::DN; ++n) o[i][n] = fmaf(pf[i], vf[n], o[i][n]);
  }
}

template <int DH>
__global__ void __launch_bounds__(Tile<DH>::THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int H, int G, Strides qs, Strides ks, Strides vs, Strides os,
                 float qscale, float cap_l2) {
  using T = Tile<DH>;
  extern __shared__ float4 smem4[];
  float* const q_s = reinterpret_cast<float*>(smem4);
  float* const k_s = q_s + T::Q_F;
  float* const v_s = k_s + 2 * T::K_F;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  float* const p_s = v_s + 2 * T::V_F + warp * T::P_F;

  const int n_qt = (S + T::BQ - 1) / T::BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kvh = h / G;
  const int q0 = qt * T::BQ;
  const int w0 = q0 + warp * T::WQ;                  // the warp's first row
  const int w_last = w0 < S ? min(w0 + T::WQ, S) - 1 : -1;  // last real one
  const int n_kt = (min(q0 + T::BQ, S) + T::BK - 1) / T::BK;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  stage_q<DH>(q_s, qb, qs.s, q0, S, qscale);
  copy_v<DH>(v_s, vb, vs.s, 0, S);
  {
    KRegs<DH> kr;
    load_k<DH>(kr, kb, ks.s, 0, S);
    store_k<DH>(k_s, kr);
  }
  cp_async_wait_all();
  __syncthreads();

  float m[T::RM], l[T::RM], o[T::RM][T::DN];
#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < T::DN; ++n) o[i][n] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int slot = kt & 1;
    const int k0 = kt * T::BK;
    const bool more = kt + 1 < n_kt;
    if (more)
      copy_v<DH>(v_s + (slot ^ 1) * T::V_F, vb, vs.s, k0 + T::BK, S);
    const bool live = k0 <= w_last;   // warp-uniform
    const bool diag = k0 + T::BK - 1 > w0;
    const int n_sub =
        diag && live ? min(T::KG, (w_last - k0) / (8 * T::KV) + 1) : T::KG;
    const float* kt_s = k_s + slot * T::K_F;
    if (live) {
      if (diag)
        scores<DH, true>(q_s, kt_s, p_s, m, l, o, warp, rg, cg, k0, w0, n_sub,
                         cap_l2);
      else
        scores<DH, false>(q_s, kt_s, p_s, m, l, o, warp, rg, cg, k0, w0,
                          n_sub, cap_l2);
    }
    KRegs<DH> kr;
    if (more) load_k<DH>(kr, kb, ks.s, k0 + T::BK, S);
    if (live) {
      __syncwarp();   // the warp's P^T slice is written
      const float* vt_s = v_s + slot * T::V_F;
      if (diag)
        pv<DH, true>(o, p_s, vt_s, rg, cg, n_sub);
      else
        pv<DH, false>(o, p_s, vt_s, rg, cg, n_sub);
    }
    if (more) store_k<DH>(k_s + (slot ^ 1) * T::K_F, kr);
    cp_async_wait_all();
    __syncthreads();   // tile kt+1's K and V are in; tile kt's are free
  }

  if (w_last < 0) return;   // the warp holds no real query
#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      li += __shfl_xor_sync(FULL, li, off);
    li = fmaxf(li, 1e-30f);
    const int row = w0 + (i / T::RV) * 4 * T::RV + rg * T::RV + i % T::RV;
    if (row >= S) continue;
    float* dst = out + b * os.b + row * os.s + h * os.h + cg * T::DV;
#pragma unroll
    for (int dg = 0; dg < T::DN / T::DV; ++dg) {
      float r[T::DV];
#pragma unroll
      for (int e = 0; e < T::DV; ++e) r[e] = o[i][dg * T::DV + e] / li;
      st_vec<T::DV>(dst + dg * 8 * T::DV, r);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, float softcap,
                   cudaStream_t stream) {
  using T = Tile<DH>;
  auto kern = flash_fwd_kernel<DH>;
  constexpr size_t smem = T::SMEM;
  if (smem > 48 * 1024) {
    // raised once per instance and device
    static std::atomic<bool> raised[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES || !raised[dev].load()) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (dev < MAX_DEVICES) raised[dev].store(true);
    }
  }
  const int n_qt = (S + T::BQ - 1) / T::BQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, n_qt);
  const float qscale = softcap > 0.0f ? scale / softcap : scale * LOG2E;
  const float cap_l2 = softcap > 0.0f ? softcap * LOG2E : 0.0f;
  kern<<<grid, T::THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, H / KV,
      qs, ks, vs, os, qscale, cap_l2);
  return cudaGetLastError();
}

cudaError_t dispatch(int dh, const void* q, const void* k, const void* v,
                     void* out, int B, int S, int H, int KV, Strides qs,
                     Strides ks, Strides vs, Strides os, float scale,
                     float softcap, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                        softcap, stream);
    case 32:
      return launch<32>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                        softcap, stream);
    case 64:
      return launch<64>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                        softcap, stream);
    case 96:
      return launch<96>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                        softcap, stream);
    case 128:
      return launch<128>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                         softcap, stream);
    case 256:
      return launch<256>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                         softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" const char* repro_error_name(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/k/v/out: float32 [B, S, heads, dh] through element strides (batch,
// seq, head); the head dim is contiguous, the bases 16-byte aligned and
// the strides multiples of 4. Returns the launch's cudaGetLastError().
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int KV, int dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, float softcap, void* stream) {
  if (B < 0 || S < 0 || H < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const long long strides[] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  for (long long st : strides)
    if (st % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  return static_cast<int>(dispatch(dh, q, k, v, out, B, S, H, KV, qs, ks, vs,
                                   os, scale, softcap,
                                   static_cast<cudaStream_t>(stream)));
}
