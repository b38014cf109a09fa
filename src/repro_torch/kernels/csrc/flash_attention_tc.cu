// Causal flash attention, forward, bf16, on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention.py: _flash_kernel (wrapper
//   flash_attention_pallas). It takes every bfloat16 call of
//   ops.flash_attention on the card, which the model's prefill makes once
//   a layer at S >= FLASH_S_MIN; float32 calls go to the CUDA-core kernel
//   of flash_attention.cu.
//
// What it computes, for batch b, query head h (key/value head h / G with
// G = H / KV) and query position i:
//   s_j   = (q_i . k_j) * scale for keys j <= i; with a softcap c,
//           s_j = tanh(s_j / c) * c; keys above the diagonal are -1e30;
//   out_i = sum_j softmax(s)_j v_j, rounded once to bfloat16.
// Online softmax over key tiles, m and l in float32 registers (in the
// base-2 domain: scores are multiplied by scale * log2 e inside exp2's
// multiply-add, which is the same softmax), m starting at -1e30, the
// output divided by max(l, 1e-30) at the end. QK^T accumulates in
// float32. P is rounded to bfloat16 for the PV product (as the model's
// own dense path below FLASH_S_MIN rounds its softmax to the working type
// before PV); l sums the float32 p, before that rounding. Keys and queries
// past S (a ragged last tile) are read as zero by the copy engine; such
// keys lie above the diagonal of every real query and such queries are
// not stored, so nothing is padded or copied.
//
// What bounds it on the H100: operations. One granite layer at S = 4096
// (24 query heads, 8 key/value heads, dh 64) is 4 dh H S(S+1)/2 = 51.6
// GFLOP against 33.6 MB of inputs and outputs: 0.0521 ms at the tensor
// cores' 989 TFLOP/s in bf16, 0.0100 ms of HBM time. Beside it, each
// score takes one exp2 on the special-function units (16 a clock per SM):
// at dh 64 that is ~0.05 ms too, so the softmax has to run while the
// tensor cores work. The design:
//   * a block takes 64 query rows per consumer warpgroup (wgmma's M): two
//     warpgroups (128 rows of one (b, h)) for dh <= 128, one for dh = 256,
//     plus one producer warp. Blocks walk the query tiles longest first;
//     each warpgroup loops over the key tiles (BK = 128 keys for dh <= 64,
//     64 above) up to its own diagonal only: tiles above it are never
//     loaded, and only the diagonal tile is masked;
//   * staging: the copy engine (TMA) loads tiles through one tensor map
//     per input over the [B, S, heads, dh] layout with its real strides
//     (so the model's projections are read as they are), into shared
//     memory in the swizzled layout the wgmma descriptors read (128-byte
//     swizzle, 64-byte for dh 32 and 96, 32-byte for dh 16; a row wider
//     than its swizzle as column chunks of the swizzle's width: 64 columns
//     at dh 128 and 256, three of 32 at dh 96). Q goes in once; K and V
//     go into a ring of STAGES
//     slots with "full" and "empty" mbarriers. The producer warp keeps up
//     to STAGES tiles in flight while the warpgroups compute;
//   * compute: S = Q K^T is wgmma m64n{BK}k16 with both operands in
//     shared memory (K-major); the softcap and the diagonal mask are
//     applied in registers; row max and row sum stay in registers, reduced
//     with two shuffles over the four threads that share a row; P is
//     converted to bf16 in registers, where the accumulator layout of S is
//     already the register-A layout of the next product, and O += P V is
//     wgmma m64n{dh}k16 with A from registers and V from shared memory
//     (MN-major). O is rescaled by alpha in registers and stored once;
//   * overlap: a warpgroup issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}
//     together and runs the softmax of S_j while the PV product is on the
//     tensor cores; at dh <= 64 the two warpgroups also take turns to
//     issue (named barriers), so one's products run during the other's
//     softmax.
// Register budget: O is dh/2 floats a thread (128 at dh 256), S BK/2 and
// P BK/4. A block of two consumer warpgroups and the producer warp builds
// with at most 168 registers a thread (65,536 over 384 threads: the warp
// is allocated as a warpgroup; above that ptxas spills). dh 256
// therefore runs one consumer warpgroup, 64-key tiles and a 2-slot ring
// (160 KB of shared memory); dh 96 and 128 two warpgroups, 64-key tiles
// and 3 slots (dh 96's PV product is wgmma m64n96k16, 48 accumulators a
// thread); dh <= 64 two warpgroups, 128-key tiles and 4 slots. Registers
// and spills per instance are what `nvcc -Xptxas -v` prints at the build
// (chip_smoke.py's build phase logs them; PERF.md records them).
// Not done here (later work): register reallocation between producer and
// consumers (setmaxnreg), a TMA store of O, and GQA blocks that share one
// K/V tile across the G query heads.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;

template <int DH>
struct Tc {
  // swizzle bytes: the widest of 128, 64 and 32 that divides a row (dh 96
  // is 192 bytes: three 64-byte chunks)
  static constexpr int SW = DH * 2 % 128 == 0 ? 128 : (DH * 2 % 64 == 0 ? 64
                                                                        : 32);
  static constexpr int NCH = DH * 2 / SW;   // column chunks of a row
  static constexpr int BK = DH <= 64 ? 128 : 64;   // keys a tile
  static constexpr int NWG = DH <= 128 ? 2 : 1;   // consumer warpgroups
  static constexpr int STAGES = DH <= 64 ? 4 : (DH <= 128 ? 3 : 2);  // ring
  static constexpr int THREADS = NWG * 128 + 32;  // + the producer warp
  static constexpr int BQ = 64 * NWG;             // query rows a block
  // the two warpgroups take turns on the tensor cores (each issues its
  // products while the other runs its softmax); they then need equal key
  // tile counts, which BK = 2 x 64 rows gives
  static constexpr bool PINGPONG = NWG == 2 && BK == 128;
  static constexpr uint32_t Q_CHUNK = 64 * SW;    // 64 rows x one chunk
  static constexpr uint32_t KV_CHUNK = BK * SW;   // BK rows x one chunk
  static constexpr uint32_t Q_TILE = 64 * DH * 2;
  static constexpr uint32_t KV_TILE = BK * DH * 2;
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t K_OFF = NWG * Q_TILE;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_TILE;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]; + 1 KB so the
  // tiles can start on a 1024-byte boundary (the 128-byte swizzle's atom)
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  static_assert(SMEM <= 232448, "shared memory of one block");
  // the block's warpgroups reach at most this many more key tiles than its
  // first one; the ring must hold them, or the producer waits for a slot
  // that a warpgroup never reads
  static_assert((64 * (NWG - 1) + BK - 1) / BK <= STAGES - 1,
                "ring too short for the block's diagonal");
};

// ---------------------------------------------------------------------------
// PTX helpers: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of `bar` has completed. A wait
// that lasts more than ~2^32 cycles (seconds) traps: a barrier that can
// never complete fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// One box of a 4-D tensor map (dh, head, seq, batch) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Named barriers 1 and 2: warpgroup w waits on 1 + w for its turn to
// issue, and hands the turn to the other with an arrive on that one's.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warp are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching accumulator registers across the
// asynchronous wgmma (it sees the asm outputs as ready at issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// A tile of Q or K as wgmma reads it along dh (K-major): k-step kk
// covers dh columns 16kk..16kk+15, 32 bytes into the row's chunk; 8-row
// groups lie 8 * SW bytes apart, chunks `chunk` bytes.
template <int DH>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, uint32_t chunk,
                                                int kk) {
  using C = Tc<DH>;
  const uint32_t off = (kk * 32 / C::SW) * chunk + (kk * 32) % C::SW;
  return make_desc(tile + off, 16, 8 * C::SW, C::LAYOUT);
}

// A key tile of V as the B operand of P V (MN-major, dh contiguous):
// k-step kk covers keys 16kk..16kk+15, i.e. two 8-row groups of 8 * SW
// bytes; dh chunks (the N direction) lie KV_CHUNK bytes apart.
template <int DH>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  using C = Tc<DH>;
  return make_desc(tile + kk * 16 * C::SW, C::KV_CHUNK, 8 * C::SW, C::LAYOUT);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T: m64n{N}k16, A (Q) and B (K) from shared memory, both
// K-major; `accumulate` 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate);

// O += P V: m64n{N}k16, A (P, bf16) from registers, B (V) from shared
// memory, MN-major. The accumulator and register-A layouts are PTX's
// (wgmma .m64nNk16 fragments): thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 and that + 8, columns 8c + 2 (t % 4) + {0, 1}.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                        const uint32_t (&a)[4],
                                        uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// O *= alpha, row by row (a0 for the thread's first row, a1 its second).
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float a0, float a1) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    o[4 * c] *= a0;
    o[4 * c + 1] *= a0;
    o[4 * c + 2] *= a1;
    o[4 * c + 3] *= a1;
  }
}

// 2^x on the special-function unit (flushing results below 2^-126 to 0,
// which P and l do not see).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key tile of BK keys of the online softmax, in place: s holds the
// raw scores q.k of the tile on entry and p = exp2(x - m_new) on return,
// where x is the score in the base-2 domain: x = s * scale * log2 e, or
// with a softcap x = tanh(s * scale / c) * c * log2 e; keys above the
// diagonal are -1e30. s[4c + e] is row (e < 2 ? r0 : r1), key j * BK + 8c
// + cq + (e & 1). Updates the running max m and sum l (of the float32 p)
// of both rows and returns the factors a0, a1 by which O must be rescaled.
// Without a softcap the row max is taken on the raw scores (scale > 0)
// and the scale is folded into the exponent's multiply-add.
template <int BK>
__device__ __forceinline__ void online_softmax(
    float (&s)[BK / 2], int j, int diag, int r0, int r1, int cq, bool capped,
    float s_in, float s_out, float& m0, float& m1, float& l0, float& l1,
    float& a0, float& a1) {
  float sc = s_in;
  if (capped) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = tanhf(s[i] * s_in) * s_out;
    sc = 1.0f;
  }
  if (j == diag) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = j * BK + 8 * (i >> 2) + cq + (i & 1);
      if (key > ((i & 2) ? r1 : r0)) s[i] = NEG_INF;
    }
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < BK / 2; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * sc), mn1 = fmaxf(m1, mx1 * sc);
  a0 = fast_exp2(m0 - mn0);
  a1 = fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 2; i += 4) {
    s[i] = fast_exp2(fmaf(s[i], sc, -mn0));
    s[i + 1] = fast_exp2(fmaf(s[i + 1], sc, -mn0));
    s[i + 2] = fast_exp2(fmaf(s[i + 2], sc, -mn1));
    s[i + 3] = fast_exp2(fmaf(s[i + 3], sc, -mn1));
    rs0 += s[i] + s[i + 1];
    rs1 += s[i + 2] + s[i + 3];
  }
  l0 = l0 * a0 + rs0;
  l1 = l1 * a1 + rs1;
}

// P rounded to bf16 pairs in the register-A layout of P V: p[kk] is the
// k-step over keys 16kk .. 16kk + 15 (the accumulator layout of S is
// already that layout, so no value moves between threads).
template <int BK>
__device__ __forceinline__ void to_bf16(const float (&s)[BK / 2],
                                        uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i)
    p[i >> 2][i & 3] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// ---------------------------------------------------------------------------
// The kernel: grid (query tiles of BQ, B * H); query tiles longest first
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(Tc<DH>::THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int S, int H, int G,
                long long o_sb, long long o_ss, long long o_sh, float scale,
                float softcap) {
  using C = Tc<DH>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + C::BAR_OFF;
  const uint32_t k_full = q_full + 8;              // + 8 * stage
  const uint32_t v_full = k_full + 8 * C::STAGES;
  const uint32_t empty = v_full + 8 * C::STAGES;

  const int n_qt = (S + C::BQ - 1) / C::BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;
  const int q0 = qt * C::BQ;
  // warpgroups with query rows below S; the others (a ragged last query
  // tile) have nothing to compute and leave at once
  const int live = min(C::NWG, (S - q0 + 63) / 64);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::NWG) {
    // producer warp: one thread issues every copy
    if (threadIdx.x != C::NWG * 128) return;
    mbar_expect_tx(q_full, live * C::Q_TILE);
    for (int w = 0; w < live; ++w)
      for (int c = 0; c < C::NCH; ++c)
        tma_load(base + C::Q_OFF + w * C::Q_TILE + c * C::Q_CHUNK, &tm_q,
                 q_full, c * C::SW / 2, h, q0 + 64 * w, b);
    // the key tiles the block's last live warpgroup needs, up to its
    // diagonal
    const int n_load = (q0 + 64 * (live - 1)) / BK + 1;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_load; ++j) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t kb = k_full + 8 * stage, vb = v_full + 8 * stage;
      mbar_expect_tx(kb, C::KV_TILE);
      for (int c = 0; c < C::NCH; ++c)
        tma_load(base + C::K_OFF + stage * C::KV_TILE + c * C::KV_CHUNK,
                 &tm_k, kb, c * C::SW / 2, kvh, j * BK, b);
      mbar_expect_tx(vb, C::KV_TILE);
      for (int c = 0; c < C::NCH; ++c)
        tma_load(base + C::V_OFF + stage * C::KV_TILE + c * C::KV_CHUNK,
                 &tm_v, vb, c * C::SW / 2, kvh, j * BK, b);
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows qrow0 .. qrow0 + 63, key tiles 0 ..
  // diag (the one on its diagonal)
  if (wg >= live) return;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int qrow0 = q0 + 64 * wg;
  const int diag = qrow0 / BK;
  const int n_tiles = diag + 1;
  const int r0 = qrow0 + 16 * (t >> 5) + (lane >> 2);
  const int r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const uint32_t q_tile = base + C::Q_OFF + wg * C::Q_TILE;
  const bool capped = softcap > 0.0f;
  // scores in the base-2 domain: x * scale * log2(e), or with a softcap
  // tanh(x * scale / c) * c * log2(e)
  const float s_in = capped ? scale / softcap : scale * LOG2E;
  const float s_out = softcap * LOG2E;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f, a0, a1;
  float s[BK / 2];
  uint32_t p[BK / 16][4];

  // S = Q K^T of key tile `st`'s slot (wgmma.fence before it covers the
  // registers written since the last product: P and the rescaled O)
  auto issue_qk = [&](int st) {
    const uint32_t k_tile = base + C::K_OFF + st * C::KV_TILE;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss<BK>(s, kmajor_desc<DH>(q_tile, C::Q_CHUNK, kk),
                   kmajor_desc<DH>(k_tile, C::KV_CHUNK, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of the tile in slot `st`
  auto issue_pv = [&](int st) {
    const uint32_t v_tile = base + C::V_OFF + st * C::KV_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DH>(o, p[kk], mnmajor_desc<DH>(v_tile, kk));
    wgmma_commit();
  };

  // with two live warpgroups of equal tile counts they take turns: the
  // second lets the first issue first
  const bool turns = C::PINGPONG && live == 2;
  if (turns && wg == 1) turn_pass(wg);

  // key tile 0: S, then its softmax (O is still 0: no rescale)
  mbar_wait(q_full, 0);
  mbar_wait(k_full, 0);
  if (turns) turn_wait(wg);
  wgmma_fence();
  issue_qk(0);
  if (turns) turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(s);
  online_softmax<BK>(s, 0, diag, r0, r1, cq, capped, s_in, s_out, m0, m1, l0,
                     l1, a0, a1);
  to_bf16<BK>(s, p);

  // key tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} go to the tensor
  // cores together; the softmax of S_j runs while the PV product does
  int prev = 0;                 // slot and phase of tile j - 1
  uint32_t prev_phase = 0;
  int stage = 1;                // slot and phase of tile j
  uint32_t phase = 0;
  for (int j = 1; j < n_tiles; ++j) {
    mbar_wait(k_full + 8 * stage, phase);
    mbar_wait(v_full + 8 * prev, prev_phase);
    if (turns) turn_wait(wg);
    wgmma_fence();
    issue_qk(stage);
    issue_pv(prev);
    if (turns) turn_pass(wg);
    wgmma_wait<1>();            // S_j is in; P_{j-1} V_{j-1} may run on
    fence_regs(s);
    online_softmax<BK>(s, j, diag, r0, r1, cq, capped, s_in, s_out, m0, m1,
                       l0, l1, a0, a1);
    wgmma_wait<0>();
    fence_regs(o);
    if (t == 0) mbar_arrive(empty + 8 * prev);   // slot j - 1 is read
    rescale(o, a0, a1);
    to_bf16<BK>(s, p);
    prev = stage;
    prev_phase = phase;
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  // the last tile's O += P V
  mbar_wait(v_full + 8 * prev, prev_phase);
  if (turns) turn_wait(wg);
  wgmma_fence();
  issue_pv(prev);
  if (turns) turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(o);
  if (t == 0) mbar_arrive(empty + 8 * prev);
  // the second warpgroup's last pass is the first's to take
  if (turns && wg == 0) turn_wait(wg);

  // l over the four threads of a row, then one bf16 store of O / l
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* row0 = out + b * o_sb + static_cast<long long>(r0) * o_ss +
                        h * o_sh + cq;
  __nv_bfloat16* row1 = row0 + 8 * o_ss;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(row0 + 8 * c) =
          __floats2bfloat162_rn(o[4 * c] / d0, o[4 * c + 1] / d0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(row1 + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2] / d1, o[4 * c + 3] / d1);
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps (the driver's encoder, reached through the runtime
// so the library needs no -lcuda) and the launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

struct Strides {            // in elements; the head dim has stride 1
  long long b, s, h;
};

// Tensor map over x [B, S, heads, DH] (bf16) read in boxes of `rows` rows
// of one head and one swizzle chunk of columns; out-of-range rows read
// zero.
template <int DH>
bool encode(CUtensorMap* map, const void* x, int B, int S, int heads,
            Strides st, int rows) {
  using C = Tc<DH>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {C::SW / 2, 1, static_cast<cuuint32_t>(rows),
                            1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                  : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, float softcap,
                   cudaStream_t stream) {
  using C = Tc<DH>;
  CUtensorMap tq, tk, tv;
  if (!encode<DH>(&tq, q, B, S, H, qs, 64) ||
      !encode<DH>(&tk, k, B, S, KV, ks, C::BK) ||
      !encode<DH>(&tv, v, B, S, KV, vs, C::BK))
    return cudaErrorInvalidValue;
  auto kern = flash_tc_kernel<DH>;
  // raised once per instance and device
  static std::atomic<bool> raised[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !raised[dev].load()) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM));
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) raised[dev].store(true);
  }
  const dim3 grid((S + C::BQ - 1) / C::BQ, B * H);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv,
                                               static_cast<__nv_bfloat16*>(out),
                                               S, H, H / KV, os.b, os.s, os.h,
                                               scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_name(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/k/v/out: bfloat16 [B, S, heads, dh] through element strides (batch,
// seq, head); the head dim is contiguous. q, k and v start on 16-byte
// boundaries and their strides are multiples of 8 elements (the copy
// engine's rule; the wrapper checks both). Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or layout the
// kernel does not take.
extern "C" int repro_flash_attention_tc_fwd(
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 16:
      err = launch<16>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                       softcap, st);
      break;
    case 32:
      err = launch<32>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                       softcap, st);
      break;
    case 64:
      err = launch<64>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                       softcap, st);
      break;
    case 96:
      err = launch<96>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                       softcap, st);
      break;
    case 128:
      err = launch<128>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                        softcap, st);
      break;
    case 256:
      err = launch<256>(q, k, v, out, B, S, H, KV, qs, ks, vs, os, scale,
                        softcap, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
