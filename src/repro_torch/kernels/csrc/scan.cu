// Inclusive prefix sum of float64 values in index order, for the weighted
// SFC bootstrap (paper Alg. 2 line 7 with node weights: centers at equal
// steps of cumulative weight along the Hilbert order).
//
// Replaces a host step of the JAX package, not a TPU kernel:
//   src/repro/core/sfc.py: sfc_initial_centers, np.cumsum at line 221.
//
// What it computes: out[i] = (((w[0] + w[1]) + w[2]) + ...) + w[i], every
// addition rounded to float64 in index order, which is numpy's cumsum bit
// for bit. The weighted picks are a searchsorted into these sums, so the
// same bits give the same initial centers as the host bootstrap, and the
// same bits on every run. A parallel scan adds in another order (and
// PyTorch's float scan on the card in an order that can change from run
// to run): its sums can differ in the last bit and move a pick that lands
// on a boundary.
//
// What bounds it on the H100: the chain of n dependent float64 additions,
// one after another, not the 16 n bytes it moves. The design keeps
// global memory out of that chain. Two warps share double-buffered
// shared memory: while lane 0 of warp 0 adds chunk c out of one buffer,
// warp 1 writes the sums of chunk c - 1 from the other buffer and loads
// chunk c + 1 into it, with coalesced accesses. A faster exact scan is
// later work (a parallel one cannot keep numpy's rounding).
#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int CHUNK = 2048;   // doubles a buffer: 2 x 16 KB of shared

__global__ void __launch_bounds__(2 * WARP)
prefix_sum_kernel(const double* __restrict__ w, double* __restrict__ out,
                  long long n) {
  __shared__ double buf[2][CHUNK];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  auto count = [n](long long c) {
    const long long left = n - c * CHUNK;
    return static_cast<int>(left < CHUNK ? left : CHUNK);
  };
  if (warp == 1)
    for (int i = lane; i < count(0); i += WARP) buf[0][i] = w[i];
  __syncthreads();
  double carry = 0.0;   // lane 0 of warp 0: the running sum
  // step c: warp 0 adds chunk c; warp 1 stores chunk c - 1, then loads
  // chunk c + 1 into the buffer it has just emptied
  for (long long c = 0; c <= chunks; ++c) {
    if (warp == 0) {
      if (lane == 0 && c < chunks) {
        double* b = buf[c & 1];
        const int cnt = count(c);
        double s = carry;
#pragma unroll 8
        for (int i = 0; i < cnt; ++i) {
          s += b[i];
          b[i] = s;
        }
        carry = s;
      }
    } else {
      double* b = buf[(c + 1) & 1];
      if (c >= 1) {
        const long long base = (c - 1) * CHUNK;
        for (int i = lane; i < count(c - 1); i += WARP) out[base + i] = b[i];
      }
      if (c + 1 < chunks) {
        const long long base = (c + 1) * CHUNK;
        for (int i = lane; i < count(c + 1); i += WARP) b[i] = w[base + i];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" const char* repro_error_name(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int repro_prefix_sum_f64(const double* w, double* out,
                                    long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  prefix_sum_kernel<<<1, 2 * WARP, 0, static_cast<cudaStream_t>(stream)>>>(
      w, out, n);
  return static_cast<int>(cudaGetLastError());
}
