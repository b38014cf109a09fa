// Balanced-k-means MoE router for Hopper (sm_90a): the top-k experts of
// every token by effective squared distance to the expert centroids.
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/moe_router_kernel.py: _router_kernel (wrapper
//   router_topk_pallas, called by ops.router_topk). On the model path it
//   takes the place of models/moe.py router_logits + jax.lax.top_k for the
//   balanced_kmeans router.
//
// What it computes, for token t and real expert e < e_real:
//   sq  = (|x_t|^2 + |c_e|^2) - 2 * (x_t . c_e)   (all sums in float32)
//   eff = max(sq, 0) * inv2[e]
// and the top_k smallest eff of each token, ascending, the lower expert
// index first on ties. Experts at or past e_real (the rest of the last
// expert tile, or rows a caller padded) are held at FAR = 1e30 and never
// read. The running list starts
// at FAR and a candidate enters it only when strictly smaller than its
// last entry, so a padded expert never displaces a real one, and of two
// equal candidates the one met first (the lower index) stays in front.
// x is read in its own storage type (bfloat16 or float32); the upcast to
// float32 is exact, so no float32 copy of x is made.
//
// Hazard: the kernel multiplies by inv2 = 1 / influence^2; the reference
// model divides by influence^2 (models/moe.py:64). The two agree bit for
// bit only where influence is 1, which holds on the serving paths
// (decode_step and prefill pass no influence). Training with adapted
// influence must account for the last-bit difference.
//
// What bounds it on the H100: operations. At granite's prefill (T = 4096
// tokens, E = 40 experts, D = 1536) it does 2 T E D ~ 0.50 GFLOP, 7.5 us
// at the 67 TFLOP/s float32 rate, and reads ~12.6 MB of bfloat16 tokens,
// 3.8 us at 3.35 TB/s. At decode (T = 4) the 245,760 bytes of centroids
// and the launch dominate. The design:
//   * the centroid matrix (40 x 1536 x 4 bytes) is larger than one block's
//     shared memory, so a block of 256 threads takes 32 tokens and walks
//     expert tiles of 64 and, inside each, D in chunks of 64, staging the
//     token chunk and the centroid chunk in shared memory as float32;
//   * each thread accumulates a 2-token x 4-expert block of dot products in
//     registers (six shared-memory reads feed eight multiply-adds); |x|^2
//     and |c|^2 are summed by 32 and 64 threads from the same chunks;
//   * after each expert tile, one thread per token merges the tile's 64
//     effective distances into its running top-k in shared memory by
//     insertion, in expert order.
// Splitting E and D across blocks for the small decode batches, and the
// tensor cores, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BT = 32;       // tokens a block
constexpr int BE = 64;       // experts a tile
constexpr int DC = 64;       // D a chunk
constexpr int KMAX = 32;     // largest top_k
constexpr float FAR = 1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
router_topk_kernel(const T* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ inv2, int T_, int E, int D,
                   int e_real, int top_k, int* __restrict__ idx_out,
                   float* __restrict__ eff_out) {
  __shared__ float x_s[BT][DC + 1];
  __shared__ float c_s[BE][DC + 1];
  __shared__ float e_s[BT][BE + 1];
  __shared__ float xn_s[BT];
  __shared__ float cn_s[BE];
  __shared__ float top_eff[BT][KMAX + 1];
  __shared__ int top_idx[BT][KMAX + 1];

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT;
  const int tt = tid / 16;   // tokens 2 tt, 2 tt + 1
  const int te = tid % 16;   // experts te + 16 j, j < 4

  if (tid < BT)
    for (int i = 0; i < top_k; ++i) {
      top_eff[tid][i] = FAR;
      top_idx[tid][i] = -1;
    }

  for (int e0 = 0; e0 < e_real; e0 += BE) {
    float dot[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dot[i][j] = 0.0f;
    float norm = 0.0f;   // |x|^2 (tid < BT) or |c|^2 (BT <= tid < BT + BE)

    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();   // the previous chunk (and merge) is consumed
      for (int i = tid; i < BT * DC; i += THREADS) {
        const int r = i / DC, d = i % DC;
        const int t = t0 + r, dd = d0 + d;
        x_s[r][d] = (t < T_ && dd < D)
                        ? load_f32(x + static_cast<size_t>(t) * D + dd)
                        : 0.0f;
      }
      for (int i = tid; i < BE * DC; i += THREADS) {
        const int r = i / DC, d = i % DC;
        const int e = e0 + r, dd = d0 + d;
        c_s[r][d] = (e < e_real && dd < D)
                        ? c[static_cast<size_t>(e) * D + dd]
                        : 0.0f;
      }
      __syncthreads();
      if (tid < BT) {
#pragma unroll 8
        for (int d = 0; d < DC; ++d) norm = fmaf(x_s[tid][d], x_s[tid][d], norm);
      } else if (tid < BT + BE) {
        const int r = tid - BT;
#pragma unroll 8
        for (int d = 0; d < DC; ++d) norm = fmaf(c_s[r][d], c_s[r][d], norm);
      }
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        const float x0 = x_s[2 * tt][d];
        const float x1 = x_s[2 * tt + 1][d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float cv = c_s[te + 16 * j][d];
          dot[0][j] = fmaf(x0, cv, dot[0][j]);
          dot[1][j] = fmaf(x1, cv, dot[1][j]);
        }
      }
    }
    if (tid < BT)
      xn_s[tid] = norm;
    else if (tid < BT + BE)
      cn_s[tid - BT] = norm;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * tt + i;
        const int ce = te + 16 * j;
        const int e = e0 + ce;
        float eff = FAR;
        if (e < e_real) {
          const float sq = (xn_s[r] + cn_s[ce]) - 2.0f * dot[i][j];
          eff = fmaxf(sq, 0.0f) * inv2[e];
        }
        e_s[r][ce] = eff;
      }
    __syncthreads();

    if (tid < BT) {
      const int n = min(BE, e_real - e0);
      for (int ce = 0; ce < n; ++ce) {
        const float v = e_s[tid][ce];
        if (!(v < top_eff[tid][top_k - 1])) continue;
        int p = top_k - 1;
        while (p > 0 && v < top_eff[tid][p - 1]) {
          top_eff[tid][p] = top_eff[tid][p - 1];
          top_idx[tid][p] = top_idx[tid][p - 1];
          --p;
        }
        top_eff[tid][p] = v;
        top_idx[tid][p] = e0 + ce;
      }
    }
  }

  __syncthreads();
  if (tid < BT && t0 + tid < T_) {
    const size_t base = static_cast<size_t>(t0 + tid) * top_k;
    for (int i = 0; i < top_k; ++i) {
      idx_out[base + i] = top_idx[tid][i];
      eff_out[base + i] = top_eff[tid][i];
    }
  }
}

}  // namespace

extern "C" const char* repro_error_name(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: [T, D] (bfloat16 if bf16 != 0, else float32), centroids: [E, D] and
// inv2: [E] float32, all contiguous; experts e >= e_real are padding.
// idx: [T, top_k] int32, eff: [T, top_k] float32. Returns the launch's
// cudaGetLastError().
extern "C" int repro_router_topk(const void* x, const float* centroids,
                                 const float* inv2, int bf16, int T, int E,
                                 int D, int e_real, int top_k, int* idx,
                                 float* eff, void* stream) {
  if (T < 0 || D < 1 || e_real < 1 || e_real > E || top_k < 1 ||
      top_k > KMAX || top_k > e_real)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((T + BT - 1) / BT);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    router_topk_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), centroids, inv2, T, E, D,
        e_real, top_k, idx, eff);
  else
    router_topk_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), centroids, inv2, T, E, D, e_real,
        top_k, idx, eff);
  return static_cast<int>(cudaGetLastError());
}
