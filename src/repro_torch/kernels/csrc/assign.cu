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
// Centers at or past k_real (the _FAR padding rows) are never read: the
// center loop stops at k_real, so their overflowing distance math never
// runs. With bf16 precision only the operands of p . c are rounded to
// bfloat16; products and every sum stay float32.
//
// What bounds it on the H100: operations. At the main shape (n = 2^22,
// k = 1024, d = 3) a sweep is ~2*d + 7 float32 operations per (point,
// center) pair, ~56 GFLOP, against ~117 MB of inputs and outputs: about
// 0.8 ms at the 67 TFLOP/s CUDA-core float32 peak and 35 us of HBM time.
// The design does three things about it:
//   * every block stages a tile of centers (coordinates transposed, |c|^2,
//     inv2) in shared memory; all threads of a warp read the same center,
//     so the reads are broadcasts;
//   * every thread keeps PPT points in registers (coordinates, |p|^2 and
//     the running best / second / idx), so one center read from shared
//     memory feeds PPT distance evaluations;
//   * the running update is branch-free (two compares, three selects).
// No tensor cores, no TMA, no cp.async pipeline and no tile pruning (the
// TPU kernel's bbox skip prunes nothing at the main shape, where the
// points are randomly permuted); those are later work.
//
// Moments without float atomics: on the TPU the moment block is revisited
// across a sequential grid. Here blocks run in no order, so each block
// walks a fixed, strided set of point tiles and owns one partial. Inside
// a block, column c of the partial belongs to thread c % THREADS alone,
// which scans the tile's labels in point order and adds the points it
// owns. The order of every sum is therefore fixed by the launch shape,
// and the result is bit-identical from run to run. The partial lives in
// shared memory when it fits and in the block's own slice of the output
// otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr size_t SMEM_CAP = 160 * 1024;   // partials above this stay global
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Shared memory: [d][ct] center coordinates, [ct] |c|^2, [ct] inv2; with
// moments also [tile] labels, [tile] best, and the partial when it fits.
template <int D, int PPT, bool MOMENTS, bool BF16>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const float* __restrict__ points,
              const float* __restrict__ centers,
              const float* __restrict__ inv2,
              const float* __restrict__ weights,
              int n, int d_rt, int k_pad, int k_real, int ct,
              int partial_in_smem,
              int* __restrict__ idx_out, float* __restrict__ best_out,
              float* __restrict__ second_out, float* __restrict__ partials) {
  constexpr int TILE = THREADS * PPT;
  constexpr int DR = D > 0 ? D : 1;
  const int d = D > 0 ? D : d_rt;
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

  const int n_tiles = (n + TILE - 1) / TILE;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int base = t * TILE;
    float p[PPT][DR];
    float pn[PPT], best[PPT], second[PPT];
    int bi[PPT], pid[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      pid[q] = base + q * THREADS + tid;
      const bool ok = pid[q] < n;
      const float* row = points + static_cast<size_t>(ok ? pid[q] : 0) * d;
      float s = 0.f;
      if (D > 0) {
#pragma unroll
        for (int j = 0; j < DR; ++j) {
          const float v = ok ? row[j] : 0.f;
          s = fmaf(v, v, s);
          p[q][j] = BF16 ? to_bf16(v) : v;
        }
      } else {
        for (int j = 0; j < d; ++j) {
          const float v = ok ? row[j] : 0.f;
          s = fmaf(v, v, s);
        }
      }
      pn[q] = s;
      best[q] = __int_as_float(0x7f800000);
      second[q] = __int_as_float(0x7f800000);
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
        float cc[DR];
        if (D > 0) {
#pragma unroll
          for (int j = 0; j < DR; ++j) cc[j] = c_s[j * ct + c];
        }
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          float dot = 0.f;
          if (D > 0) {
#pragma unroll
            for (int j = 0; j < DR; ++j) dot = fmaf(p[q][j], cc[j], dot);
          } else {
            const float* row =
                points + static_cast<size_t>(pid[q] < n ? pid[q] : 0) * d;
            for (int j = 0; j < d; ++j) {
              const float v = BF16 ? to_bf16(row[j]) : row[j];
              dot = fmaf(v, c_s[static_cast<size_t>(j) * ct + c], dot);
            }
          }
          // 2 * dot is exact, so the fma rounds once, like the reference
          const float sq = fmaf(-2.f, dot, pn[q] + cn);
          const float e = fmaxf(sq, 0.f) * iv;
          const bool lt = e < best[q];
          second[q] = lt ? best[q] : fminf(second[q], e);
          bi[q] = lt ? c0 + c : bi[q];
          best[q] = lt ? e : best[q];
        }
      }
    }

#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      if (pid[q] < n) {
        idx_out[pid[q]] = bi[q];
        best_out[pid[q]] = best[q];
        second_out[pid[q]] = second[q];
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
          const int g = base + i;
          const float w = weights[g];
          const float* row = points + static_cast<size_t>(g) * d;
          for (int j = 0; j < d; ++j)
            acc[static_cast<size_t>(j) * k_pad + c] += w * row[j];
          acc[static_cast<size_t>(d) * k_pad + c] += w;
          acc[(static_cast<size_t>(d) + 1) * k_pad + c] += w * best_s[i];
        }
      }
      __syncthreads();  // labels of this tile are read before the next
    }
  }

  if (MOMENTS && partial_in_smem) {
    float* out = partials + static_cast<size_t>(blockIdx.x) * rows * k_pad;
    for (int c = tid; c < k_pad; c += THREADS)
      for (size_t r = 0; r < rows; ++r)
        out[r * k_pad + c] = acc[r * k_pad + c];
  }
}

struct Args {
  const float* points;
  const float* centers;
  const float* inv2;
  const float* weights;
  int n, d, k_pad, k_real, ppt, bf16, n_blocks;
  int* idx;
  float* best;
  float* second;
  float* partials;
  cudaStream_t stream;
  int* occupancy;  // non-null: report resident blocks per SM, no launch
};

template <int D, int PPT, bool MOMENTS, bool BF16>
cudaError_t launch(const Args& a) {
  const int ct = a.d <= 16 ? 128 : 32;
  const int tile = THREADS * PPT;
  size_t smem = static_cast<size_t>(ct) * (a.d + 2) * sizeof(float);
  int in_smem = 0;
  if (MOMENTS) {
    smem += static_cast<size_t>(tile) * (sizeof(int) + sizeof(float));
    const size_t part =
        (static_cast<size_t>(a.d) + 2) * a.k_pad * sizeof(float);
    if (smem + part <= SMEM_CAP) {
      smem += part;
      in_smem = 1;
    }
  }
  auto kern = assign_kernel<D, PPT, MOMENTS, BF16>;
  if (smem > 48 * 1024) {
    // raised once per instance and device, to the block's opt-in maximum
    // (a permission only: occupancy follows each launch's own size)
    static std::atomic<bool> raised[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES || !raised[dev].load()) {
      int optin = 0;
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err != cudaSuccess) return err;
      if (dev < MAX_DEVICES) raised[dev].store(true);
    }
  }
  if (a.occupancy)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.occupancy, kern,
                                                         THREADS, smem);
  kern<<<a.n_blocks, THREADS, smem, a.stream>>>(
      a.points, a.centers, a.inv2, a.weights, a.n, a.d, a.k_pad, a.k_real,
      ct, in_smem, a.idx, a.best, a.second, a.partials);
  return cudaGetLastError();
}

template <int D, bool MOMENTS, bool BF16>
cudaError_t by_ppt(const Args& a) {
  switch (a.ppt) {
    case 1: return launch<D, 1, MOMENTS, BF16>(a);
    case 2: return launch<D, 2, MOMENTS, BF16>(a);
    case 4: return launch<D, 4, MOMENTS, BF16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool MOMENTS, bool BF16>
cudaError_t by_dim(const Args& a) {
  switch (a.d) {
    case 2: return by_ppt<2, MOMENTS, BF16>(a);
    case 3: return by_ppt<3, MOMENTS, BF16>(a);
    default: return by_ppt<0, MOMENTS, BF16>(a);
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
      a.bf16 ? by_dim<MOMENTS, true>(a) : by_dim<MOMENTS, false>(a);
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
  const Args a{nullptr, nullptr, nullptr, nullptr, 0, d, k_pad, k_pad, ppt,
               bf16, 1, nullptr, nullptr, nullptr, nullptr, nullptr,
               blocks_per_sm};
  return moments ? dispatch<true>(a) : dispatch<false>(a);
}

extern "C" int repro_assign_argmin(const float* points, const float* centers,
                                   const float* inv2, int n, int d,
                                   int k_pad, int k_real, int ppt, int bf16,
                                   int n_blocks, int* idx, float* best,
                                   float* second, void* stream) {
  const Args a{points, centers, inv2, nullptr, n, d, k_pad, k_real, ppt,
               bf16, n_blocks, idx, best, second, nullptr,
               static_cast<cudaStream_t>(stream), nullptr};
  return dispatch<false>(a);
}

extern "C" int repro_assign_reduce(const float* points, const float* centers,
                                   const float* inv2, const float* weights,
                                   int n, int d, int k_pad, int k_real,
                                   int ppt, int bf16, int n_blocks, int* idx,
                                   float* best, float* second,
                                   float* partials, void* stream) {
  const Args a{points, centers, inv2, weights, n, d, k_pad, k_real, ppt,
               bf16, n_blocks, idx, best, second, partials,
               static_cast<cudaStream_t>(stream), nullptr};
  return dispatch<true>(a);
}
