// Causal flash attention, forward, float32, on the CUDA cores (sm_90a).
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention.py: _flash_kernel (wrapper
//   flash_attention_pallas) for float32 inputs. bfloat16 inputs, the
//   model's prefill among them, go to the tensor-core kernel of
//   flash_attention_tc.cu; float32 stays here because TF32 tensor cores
//   would lose the 2e-5 agreement the float32 checks hold.
//
// What it computes, for batch b, query head h (key/value head h / G with
// G = H / KV) and query position i:
//   s_j   = (q_i . k_j) * scale for keys j <= i; with a softcap c,
//           s_j = tanh(s_j / c) * c; keys above the diagonal are -1e30;
//   out_i = sum_j softmax(s)_j v_j.
// It is an online softmax over key tiles with m, l and acc in float32, m
// starting at NEG_INF = -1e30 and l clamped at 1e-30, as in the TPU kernel.
// q, k and v are read through strides, so the model's [B, S, H, dh] layout
// needs no transposed copy. Keys and queries past S (a ragged last tile)
// read as zero; such keys lie above the diagonal of every real query.
//
// What bounds it on the H100: operations. One granite layer at S = 4096
// (24 query heads, dh 64) is 4 dh H S(S+1)/2 ~ 51.6 GFLOP; at the CUDA
// cores' float32 rate (67 TFLOP/s) its floor is 0.77 ms. The design:
//   * one block of 256 threads per (b * H + h, 64-query tile); it loops
//     over 64-key tiles up to the diagonal only, so the tiles above it are
//     never loaded (the TPU kernel's pl.when skip). The last query tiles,
//     which have the most key tiles, are scheduled first;
//   * the query tile and each key and value tile are staged in shared
//     memory (rows padded by one float against bank conflicts); each
//     thread keeps a 4 x 4 block of scores and a 4 x dh/16 block of the
//     output accumulator in registers, so a value read from shared memory
//     feeds four multiply-adds;
//   * row maxima and row sums are reduced with warp shuffles over the 16
//     threads that share a row; m and l never leave registers.
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int THREADS = 256;   // 16 x 16: ty owns 4 query rows, tx columns
constexpr int BQ = 64;         // queries a block
constexpr int BK = 64;         // keys a tile
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

struct Strides {            // in elements; the head dim has stride 1
  long long b, s, h;
};

// Shared memory: q [BQ][DH+1], k [BK][DH+1], v [BK][DH], p [BQ][BK+1].
template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ) * (DH + 1) +
                          static_cast<size_t>(BK) * (DH + 1) +
                          static_cast<size_t>(BK) * DH +
                          static_cast<size_t>(BQ) * (BK + 1));
}

__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      Strides st, int b, int head, int row0,
                                      int rows, int S, int dh) {
  for (int idx = threadIdx.x; idx < rows * dh; idx += THREADS) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    const int pos = row0 + r;
    float v = 0.0f;
    if (pos < S)
      v = src[b * st.b + pos * st.s + head * st.h + d];
    dst[r * ld + d] = v;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int H,
                 int G, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, float softcap) {
  constexpr int QLD = DH + 1;
  constexpr int KLD = DH + 1;
  constexpr int PLD = BK + 1;
  constexpr int NJ = DH / 16;   // output columns a thread owns
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QLD;
  float* v_s = k_s + BK * KLD;
  float* p_s = v_s + BK * DH;

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  stage(q_s, QLD, q, qs, b, h, q0, BQ, S, DH);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // key tiles 0..qt: the last one holds the diagonal (BQ == BK)
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's k, v and p are consumed
    stage(k_s, KLD, k, ks, b, kvh, k0, BK, S, DH);
    stage(v_s, DH, v, vs, b, kvh, k0, BK, S, DH);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * KLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        x = (k0 + tx + 16 * j <= qpos) ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty * 4 + i) * PLD + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // p complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * PLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = v_s[c * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* row = out + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = acc[i][j] / li;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, float softcap,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<DH>;
  constexpr size_t smem = smem_bytes<DH>();
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
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, H / KV,
      qs, ks, vs, os, scale, softcap);
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

}  // namespace

extern "C" const char* repro_error_name(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/k/v/out: float32 [B, S, heads, dh] through element strides (batch,
// seq, head); the head dim is contiguous. Returns the launch's
// cudaGetLastError().
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int KV, int dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, float softcap, void* stream) {
  if (B < 0 || S < 0 || H < 1 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  return static_cast<int>(dispatch(dh, q, k, v, out, B, S, H, KV, qs, ks, vs,
                                   os, scale, softcap,
                                   static_cast<cudaStream_t>(stream)));
}
