// The Mamba-2 SSD chunk scan of training and prefill, forward and backward,
// for NVIDIA Hopper (sm_90a), in bf16: `wgmma` fed by TMA, a producer warp
// for each of two consumer warpgroups.
//
// Replaces no Pallas kernel: the reference computes the scan in XLA,
// `ssm_apply` (src/repro/models/ssm.py:93-141).  Per batch b, chunk c and
// head h (group g = h / (nh / G)), with cum the in-chunk inclusive cumsum of
// dt * A:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . H_c
//   H_{c+1} = exp(cum_{Q-1}) H_c + sum_j exp(cum_{Q-1} - cum_j) dt_j B_j x_j^T
// with H_0 = 0.  ssd_chunk_scan.cu holds the same functions on `mma.sync`
// (the `mma` route: fp32, and bf16 shapes outside this file's contract);
// the wrapper's planner (kernels/ssd_scan.py, `route`) sends every other
// bf16 call here.
//
// Bound on this card: the bytes in the forward (about 106 MB of x, B, C, dt
// and y against 19.6 GFLOP a mamba2-780m layer at B 4 x S 2048), the
// operations in forward + backward.  What the design does about it:
// * C B^T depends on the group only (ssm.py:110).  One launch computes it
//   once per (b, c, group), rounded to bf16 as the reference rounds it, into
//   a (Q, Q) scratch of each (b, c, group) (4.2 MB at the shape above, in the
//   50 MB L2); every head's scan and backward read their 64 x 64 blocks of
//   it by TMA instead of a product over N.  The backward's own launch
//   writes C B^T and (C B^T)^T, freed when the backward returns.
// * Every product runs on `wgmma` from shared memory (or from registers
//   for an operand that is itself computed: the decay-weighted scores, dS,
//   the decay-scaled x), every tile arrives by TMA (4-D maps of x, dy, B, C,
//   read where they lie; 3-D maps of the scratch) into 64-column boxes with
//   the 128-byte swizzle, completing on `mbarrier`s.  A block is a producer
//   warpgroup (`setmaxnreg` leaves it 40 registers) and two consumer
//   warpgroups (232).  The chunk states, the scan and dC give each
//   consumer a job of its own (a 64-row tile) fed by a producer warp of its
//   own through rings of stages; the scan, dx / dB and dC are persistent
//   and release a job's fixed tiles as soon as they are read, so that the
//   next job's loads run under this one's products; the scan computes the
//   next key block's scores while this block's product runs.
// * dx / dB splits a job between its two consumers, dx on one and dB on
//   the other, each computing M^T = x dy^T itself: one accumulator of up to
//   64 x 128 a warpgroup, no spill at N = hp = 128.
// * The state enters the products as a bf16 operand: the state pass writes
//   a bf16 copy of the state entering each chunk beside the fp32 one (which
//   the backward keeps reading), and a tile takes it by TMA (16 KB at N 128
//   x hp 64) instead of restaging 32 KB of fp32 and converting it.  The
//   passes load a chunk's elements 4 a thread with the next chunk's loads
//   in flight.
// * The backward sums dB and dC over a band of a group's heads inside the
//   block: a job walks the band's heads for one 64-row tile and keeps one
//   fp32 accumulator of dB (or dC) for all of them.  A band's slab is
//   written once; a fixed-order pass sums the bands (no floating atomics:
//   two runs, and CUDA-graph replays, give the same bits).
// * The decays are exp2 of log2(e)-scaled cum differences.  Off the causal
//   diagonal a 64 x 64 tile's decays are a row factor times a column
//   factor taken against a position of the block between them, both at
//   most 1 (`load_head`): two exp2 a row and a block instead of one an
//   element; never exp(cum_i) * exp(-cum_j), which overflows.
//
// Launches: forward 4 (C B^T; chunk states and cum; the state pass; the
// scan), backward 7 (C B^T and its transpose; G_c = C^T (exp(cum) dy); the
// reverse state pass; dx with dB's band sums; dC's band sums; ddt; the sum
// of the bands and dA).
//
// Contract (checked by the Python wrapper and again here): bf16 x, B, C;
// Q a multiple of 64 up to 256 dividing S; N and hp 64 or 128; G dividing
// nh; the band dividing nh / G; 16-byte aligned pointers and strides.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int kMaxQ = 256;
constexpr int kBox = 64 * 128;    // a 64 x 64 bf16 box, 128-byte swizzle
constexpr int kLine = kMaxQ * 128;  // a 64-column box over a chunk's rows
constexpr int kSmemMax = 232448;
constexpr int kPassThreads = 256;
constexpr int kPassPer = 4;       // state elements a pass thread carries
constexpr int kSlice = kPassThreads * kPassPer;
constexpr int kPart = 32 * kPassPer;   // state elements of a `dcl` partial
constexpr float kLog2e = 1.4426950408889634f;

enum Error { kErrArgs = -1, kErrEncoder = -2, kErrEncode = -3 };
// planted faults, for the smoke check only: chunk 1's carried state
// dropped; the intra-chunk mask's diagonal dropped
enum Plant { kPlantState = 1, kPlantDiag = 2 };

struct Params {
  const float* dt;   // (b, S, nh)
  const float* A;    // (nh,)
  bf16* y;           // (b, S, nh, hp)
  float* cum;        // (b, nc, nh, Q)
  float* state;      // (b, nc, nh, N, hp): chunk summaries, then H_c
  bf16* hbf;         // the same in bf16 (H_c)
  bf16* dbf;         // D_c in bf16 (backward)
  bf16* cb;          // (b, nc, G, Q, Q): C_i . B_j at [i][j] (j-block <= i's)
  bf16* cbt;         // (b, nc, G, Q, Q): B_j . C_i at [j][i] (i-block >= j's)
  float* dstate;     // (b, nc, nh, N, hp): G_c, then D_c
  float* dcl;        // (b, nc, nh, slices): <D_c, H_c> partials, a warp's each
  float* rows;       // (4, b, nc, nh, Q): qsum, e, psum, yd
  float* dbs;        // (b, S, G, nb, N): dB's band sums
  float* dcs;        // (b, S, G, nb, N): dC's band sums
  float* dAp;        // (b, nc, nh)
  bf16* dx;
  float* ddt;
  float* dA;
  bf16* dB;
  bf16* dC;
  int Bsz, S, nh, hp, G, N, Q, nc, hpg, T, band, nb, slices, plant, cbz;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// the 128-byte swizzle repeats every 1024 bytes: boxes start on it
__device__ __forceinline__ unsigned char* align1024(unsigned char* ptr) {
  return ptr + ((1024 - (smem_u32(ptr) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from reading or writing an accumulator across a
// `wgmma` that is still in flight
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (each in 16-byte units).
// K-major: rows of 128 bytes (64 bf16 along K), 8-row atoms `sbo` apart,
// `lbo` unused; a k16 step is 32 bytes along the row.  MN-major: 128-byte
// lines of 64 bf16 along M or N, one a K row; 8-row atoms along K `sbo`
// apart, 64-wide chunks along M or N `lbo` apart; a k16 step is 16 lines.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, fp32, 32 registers a thread) (+)= A (64 x 16) B (16 x 64),
// both in shared memory; TA / TB: A / B MN-major (1) or K-major (0); D is
// overwritten when scale_d is 0
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 in registers, the mma.m16n8k16 A
// layout a warp) B (16 x 64 in shared memory; TB: MN-major (1) or
// K-major (0))
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// D (64 x 128, fp32, 64 registers a thread) (+)= A (64 x 16) B (16 x 128),
// both in shared memory; TA / TB: A / B MN-major (1) or K-major (0); D is
// overwritten when scale_d is 0
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 in registers, the mma.m16n8k16 A
// layout a warp) B (16 x 128 in shared memory; TB: MN-major (1) or
// K-major (0))
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "SS tile width");
  if constexpr (N == 64)
    wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
  else
    wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "RS tile width");
  if constexpr (N == 64)
    wgmma_rs_n64<TB>(d, a, db);
  else
    wgmma_rs_n128<TB>(d, a, db);
}

// D (64 x N) = A B^T over STEPS k16 steps: A (64 rows) and B (N rows) both
// K-major, in 64-column boxes `abox` and `bbox` bytes apart
template <int N, int STEPS>
__device__ __forceinline__ void gemm_kk(float* d, uint32_t a, int abox,
                                        uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_ss<N, 0, 0>(
        d, sw128_desc(a + (kk >> 2) * abox + (kk & 3) * 32, 16, 1024),
        sw128_desc(b + (kk >> 2) * bbox + (kk & 3) * 32, 16, 1024), kk > 0);
}

// D (64 x N) = A B: A K-major as above, B MN-major (its K rows 128-byte
// lines of 64 columns, the 64-column chunks `bbox` bytes apart)
template <int N, int STEPS>
__device__ __forceinline__ void gemm_kn(float* d, uint32_t a, int abox,
                                        uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_ss<N, 0, 1>(
        d, sw128_desc(a + (kk >> 2) * abox + (kk & 3) * 32, 16, 1024),
        sw128_desc(b + kk * 2048, bbox, 1024), kk > 0);
}

// D (64 x N) += A B over `steps` k16 steps, both MN-major: A's K rows are
// 128-byte lines of its 64 rows, B as in gemm_kn
template <int N>
__device__ __forceinline__ void gemm_nn(float* d, uint32_t a, uint32_t b,
                                        int bbox, int steps) {
  for (int kk = 0; kk < steps; ++kk)
    wgmma_ss<N, 1, 1>(d, sw128_desc(a + kk * 2048, kLine, 1024),
                      sw128_desc(b + kk * 2048, bbox, 1024), 1);
}

// D (64 x N) += A B over STEPS k16 steps, A the bf16 fragments `a`, B
// MN-major (as in gemm_kn)
template <int N, int STEPS>
__device__ __forceinline__ void gemm_rn(float* d, const uint32_t (*a)[4],
                                        uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_rs<N, 1>(d, a[kk], sw128_desc(b + kk * 2048, bbox, 1024));
}

// the same with B K-major (its N rows in 64-column boxes `bbox` apart)
template <int N, int STEPS>
__device__ __forceinline__ void gemm_rk(float* d, const uint32_t (*a)[4],
                                        uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_rs<N, 0>(d, a[kk],
                   sw128_desc(b + (kk >> 2) * bbox + (kk & 3) * 32, 16, 1024));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Accumulator element i of a consumer thread (warp wl of its warpgroup,
// lane): row 16 wl + lane / 4 + 8 ((i >> 1) & 1) of the 64, column
// 8 (i >> 2) + 2 (lane % 4) + (i & 1).

// columns (c, c + 1) of row r of a 64-row operand in 64-column boxes
// `box` bytes apart, 128-byte swizzle, as floats
__device__ __forceinline__ float2 ld_pair(const unsigned char* base, int box,
                                          int r, int c) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
      base + (c >> 6) * box + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
      ((c & 7) << 1));
  return __bfloat1622float2(v);
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The producer warpgroup keeps 40 registers (its job loops spill at 24),
// the consumers 232: 128 x 40 + 256 x 232 <= 65536
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// a consumer warp is done with a stage
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// the 128 threads of consumer warpgroup wg (named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// a ring's position
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The barriers of the two consumer warpgroups of a block: a job's fixed
// tiles (full, empty), its per-head stage (full, empty), and its ring of
// kRing stages.
constexpr int kRing = 2;
struct Bars {
  uint64_t fix[2], fix_empty[2];
  uint64_t head_full[2], head_empty[2];
  uint64_t full[2][kRing], empty[2][kRing];
  uint64_t piece[2][kMaxQ / 64];   // the chunk states' 64-row pieces
};

__device__ __forceinline__ void init_bars(Bars& b) {
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(&b.fix[w], 1);
      mbar_init(&b.fix_empty[w], 4);
      mbar_init(&b.head_full[w], 1);
      mbar_init(&b.head_empty[w], 4);   // a consumer warpgroup's 4 warps
      for (int s = 0; s < kRing; ++s) {
        mbar_init(&b.full[w][s], 1);
        mbar_init(&b.empty[w][s], 4);
      }
      for (int s = 0; s < kMaxQ / 64; ++s) mbar_init(&b.piece[w][s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A tile job of the scan and the backward: (b, c, group, band or head,
// 64-row tile t), the tiles with the most blocks to walk first.
struct Job {
  int b, c, gi, band, h, t;
};

// tile-major, heaviest first: `rev` when the work grows with t
__device__ __forceinline__ Job band_job(int id, const Params& p, bool rev) {
  const int per = p.Bsz * p.nc * p.G * p.nb;
  Job j;
  const int ts = id / per;
  int r = id - ts * per;
  j.t = rev ? p.T - 1 - ts : ts;
  j.band = r % p.nb;
  r /= p.nb;
  j.gi = r % p.G;
  r /= p.G;
  j.c = r % p.nc;
  j.b = r / p.nc;
  j.h = j.gi * p.hpg + j.band * p.band;
  return j;
}

__device__ __forceinline__ long long item_of(int b, int c, int h,
                                            const Params& p) {
  return (static_cast<long long>(b) * p.nc + c) * p.nh + h;
}

__device__ __forceinline__ long long gitem_of(int b, int c, int gi,
                                             const Params& p) {
  return (static_cast<long long>(b) * p.nc + c) * p.G + gi;
}

// A head's in-chunk cumsum (log2(e)-scaled) and dt into shared memory, by
// the 128 threads of its consumer warpgroup (ct its thread), with each
// position's decay factor within its 64-row block (`fs`):
// * kDecayCols (the scan, dC: position q a key j): exp2(cl_last - cl_j) dt_j,
//   cl_last its block's last position's;
// * kDecayRows (dx / dB: position q a query i): exp2(cl_i - cl_first).
// Off the causal diagonal every query i of a key block's rows follows every
// key j of it, and cum falls along the chunk (dt A < 0), so
// exp2(cl_i - cl_j) = exp2(cl_i - cl_ref) exp2(cl_ref - cl_j) with the
// block's reference position between them: both factors are at most 1
// (no overflow; one underflows only where the product does).  A tile then
// needs two exp2 a row and a block instead of one an element.
enum Decay { kDecayCols = 0, kDecayRows = 1 };

__device__ __forceinline__ void load_head(const Params& p, int b, int c, int h,
                                          float* cl, float* dts, float* fs,
                                          Decay mode, int ct) {
  const long long item = item_of(b, c, h, p);
  const float* cum = p.cum + item * p.Q;
  for (int i = ct; i < p.Q; i += 128) {
    const float ci = cum[i] * kLog2e;
    const float d =
        p.dt[(static_cast<long long>(b) * p.S + c * p.Q + i) * p.nh + h];
    cl[i] = ci;
    dts[i] = d;
    fs[i] = mode == kDecayCols ? exp2f(cum[i | 63] * kLog2e - ci) * d
                               : exp2f(ci - cum[i & ~63] * kLog2e);
  }
}

// load_head in two halves, so that a head's loads are in flight while the
// last head computes: a thread's kMaxQ / 128 positions in registers
struct HeadRegs {
  float cum[kMaxQ / 128], ref[kMaxQ / 128], dt[kMaxQ / 128];
};

__device__ __forceinline__ void fetch_head(const Params& p, int b, int c,
                                           int h, Decay mode, int ct,
                                           HeadRegs& r) {
  const float* cum = p.cum + item_of(b, c, h, p) * p.Q;
#pragma unroll
  for (int k = 0; k < kMaxQ / 128; ++k) {
    const int i = ct + 128 * k;
    if (i < p.Q) {
      r.cum[k] = cum[i];
      r.ref[k] = cum[mode == kDecayCols ? i | 63 : i & ~63];
      r.dt[k] = p.dt[(static_cast<long long>(b) * p.S + c * p.Q + i) * p.nh +
                     h];
    }
  }
}

__device__ __forceinline__ void store_head(const HeadRegs& r, int Q,
                                           float* cl, float* dts, float* fs,
                                           Decay mode, int ct) {
#pragma unroll
  for (int k = 0; k < kMaxQ / 128; ++k) {
    const int i = ct + 128 * k;
    if (i < Q) {
      const float ci = r.cum[k] * kLog2e;
      cl[i] = ci;
      dts[i] = r.dt[k];
      fs[i] = mode == kDecayCols ? exp2f(r.ref[k] * kLog2e - ci) * r.dt[k]
                                 : exp2f(ci - r.ref[k] * kLog2e);
    }
  }
}

// Accumulator pair (e, e + 1) of a 64 x 64 tile (e even), rounded to bf16
// into its slot of the A fragments of the next product: k16 step e / 8 is
// accumulator values 8 (e / 8) .. 8 (e / 8) + 7, two a register
__device__ __forceinline__ void put_pair(uint32_t (*a)[4], int e, float lo,
                                         float hi) {
  a[e >> 3][(e & 7) >> 1] = pack_bf16(lo, hi);
}

// The scan's W = (C B^T) o L o dt of key block kb for the thread's rows
// rl, rl + 8 of tile t, as bf16 fragments: off the diagonal by the block
// factors, on it (kb == t) by an exp2 an element under the causal mask
// (its diagonal dropped under the planted fault)
__device__ __forceinline__ void scan_frags(const unsigned char* cbs,
                                           const float* cl, const float* dts,
                                           const float* fs, int kb, int t,
                                           int rl, int tq, bool diag,
                                           uint32_t (*wa)[4]) {
  const int i_lo = 64 * t + rl;
  const float c_lo = cl[i_lo], c_hi = cl[i_lo + 8];
  if (kb < t) {
    const float ref = cl[64 * kb + 63];
    const float r_lo = exp2f(c_lo - ref), r_hi = exp2f(c_hi - ref);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int hh = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * tq;
      const float2 v = ld_pair(cbs, kBox, rl + 8 * hh, col);
      const float r = hh ? r_hi : r_lo;
      const float* f = fs + 64 * kb + col;
      put_pair(wa, e, v.x * r * f[0], v.y * r * f[1]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int hh = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * tq;
      const float2 v = ld_pair(cbs, kBox, rl + 8 * hh, col);
      const int ig = i_lo + 8 * hh, jg = 64 * kb + col;
      const float ci = hh ? c_hi : c_lo;
      const bool ok0 = jg < ig || (diag && jg == ig);
      const bool ok1 = jg + 1 < ig || (diag && jg + 1 == ig);
      put_pair(wa, e, ok0 ? v.x * exp2f(ci - cl[jg]) * dts[jg] : 0.f,
               ok1 ? v.y * exp2f(ci - cl[jg + 1]) * dts[jg + 1] : 0.f);
    }
  }
}

// --- C B^T -------------------------------------------------------------------

// A job (z, t, b, c, g): z 0, rows i of tile t of C B^T over the j-blocks up
// to t, into cb; z 1, rows j of tile t of B C^T over the i-blocks from t,
// into cbt.  The whole 64 x 64 blocks are written (the diagonal's masked
// half included): the readers mask.
template <int NP>
struct CbShape {
  static constexpr int kTile = NP / 64 * kBox;             // 64 rows x NP
  static constexpr int kWg = (1 + kMaxQ / 64) * kTile;
  static constexpr int kSmem = 2 * kWg + 1024;
  static_assert(kSmem <= kSmemMax - 1024, "C B^T's tiles");
};

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    cb_kernel(const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ CUtensorMap cmap, const Params p) {
  using S = CbShape<NP>;
  __shared__ __align__(8) Bars bars;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_bars(bars);
  const int per = p.Bsz * p.nc * p.G;
  const int w = warp < 4 ? warp : (warp >> 2) - 1;
  const int id = blockIdx.x * 2 + w;
  const bool has = w < 2 && id < p.cbz * p.T * per;
  int z = 0, t = 0, b = 0, c = 0, gi = 0;
  if (has) {
    z = id / (p.T * per);
    int r = id - z * p.T * per;
    t = r / per;
    r -= t * per;
    gi = r % p.G;
    r /= p.G;
    c = r % p.nc;
    b = r / p.nc;
  }
  const int lo = z ? t : 0, hi = z ? p.T : t + 1;
  unsigned char* ws = smem + (w & 1) * S::kWg;
  if (warp < 4) {
    producer_regs();
    if (has && lane == 0) {
      const CUtensorMap* xm = z ? &bmap : &cmap;
      const CUtensorMap* ym = z ? &cmap : &bmap;
      const int s0 = c * p.Q;
      uint64_t* bar = &bars.fix[w];
      mbar_expect_tx(bar, (1 + hi - lo) * S::kTile);
#pragma unroll
      for (int k = 0; k < NP / 64; ++k)
        tma_4d(ws + k * kBox, xm, bar, 64 * k, s0 + 64 * t, gi, b);
      for (int kb = lo; kb < hi; ++kb)
#pragma unroll
        for (int k = 0; k < NP / 64; ++k)
          tma_4d(ws + (1 + kb - lo) * S::kTile + k * kBox, ym, bar, 64 * k,
                 s0 + 64 * kb, gi, b);
    }
    return;
  }
  consumer_regs();
  if (!has) return;
  const int wl = (threadIdx.x & 127) >> 5, g = lane >> 2, tq = lane & 3;
  mbar_wait(&bars.fix[w], 0);
  const uint32_t xa = smem_u32(ws);
  bf16* out = (z ? p.cbt : p.cb) + gitem_of(b, c, gi, p) * p.Q * p.Q;
  const int row0 = 64 * t + 16 * wl + g;
  for (int kb = lo; kb < hi; ++kb) {
    float s[32];
    fence_regs<32>(s);
    wgmma_fence();
    gemm_kk<64, NP / 16>(s, xa, kBox, xa + (1 + kb - lo) * S::kTile, kBox);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      store2(out + (row0 + 8 * ((i >> 1) & 1)) * p.Q + 64 * kb + 8 * (i >> 2) +
                 2 * tq,
             s[i], s[i + 1]);
  }
}

// --- chunk states ------------------------------------------------------------

// A job (b, c, h, m): rows 64 m .. 64 m + 63 of the chunk's N x hp summary.
// Forward: cum (a warp scan; written by the m = 0 job) and
// states = B^T ((exp(cum_L - cum) dt) * x); backward (BWD):
// G_c = C^T (exp(cum) * dy).  B^T (C^T) is the MN-major A operand straight
// from its TMA box; x (dy) arrives whole and is scaled row by row in place.
template <int HP>
struct StateShape {
  static constexpr int kX = kLine;               // a 64-column box of B (C)
  static constexpr int kV = HP / 64 * kLine;     // x (dy)
  static constexpr int kWg = kX + kV;
  static constexpr int kSmem = 2 * kWg + 1024;
  static_assert(kSmem <= kSmemMax - 8192, "the chunk states' tiles");
};

template <int NP, int HP, bool BWD>
__global__ void __launch_bounds__(kThreads, 1)
    state_kernel(const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap bmap, const Params p) {
  using S = StateShape<HP>;
  __shared__ __align__(8) Bars bars;
  __shared__ float s_cum[2][kMaxQ];
  __shared__ float s_w[2][kMaxQ];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_bars(bars);
  constexpr int MT = NP / 64;
  const int w = warp < 4 ? warp : (warp >> 2) - 1;
  const int id = blockIdx.x * 2 + w;
  const bool has = w < 2 && id < p.Bsz * p.nc * p.nh * MT;
  const int m = id % MT, item = id / MT;
  const int h = item % p.nh, c = (item / p.nh) % p.nc, b = item / (p.nh * p.nc);
  const int gi = h / p.hpg, s0 = c * p.Q;
  unsigned char* ws = smem + (w & 1) * S::kWg;
  unsigned char* vs = ws + S::kX;
  if (warp < 4) {
    producer_regs();
    if (has && lane == 0) {
      // a 64-row piece at a time, each on its own barrier
      for (int jb = 0; jb < p.T; ++jb) {
        uint64_t* bar = &bars.piece[w][jb];
        mbar_expect_tx(bar, kBox * (1 + HP / 64));
        tma_4d(ws + jb * kBox, &bmap, bar, 64 * m, s0 + 64 * jb, gi, b);
#pragma unroll
        for (int k = 0; k < HP / 64; ++k)
          tma_4d(vs + k * kLine + jb * kBox, &vmap, bar, 64 * k, s0 + 64 * jb,
                 h, b);
      }
    }
    return;
  }
  consumer_regs();
  if (!has) return;
  const int ct = threadIdx.x & 127, wl = ct >> 5, g = lane >> 2, tq = lane & 3;
  float* cum_s = s_cum[w];
  float* w_s = s_w[w];
  for (int i = ct; i < p.Q; i += 128) {
    w_s[i] = p.dt[(static_cast<long long>(b) * p.S + s0 + i) * p.nh + h];
    if (BWD) cum_s[i] = p.cum[static_cast<long long>(item) * p.Q + i];
  }
  wg_sync(w);
  if (!BWD && wl == 0) {
    // inclusive cumsum of dt * A: each lane a run of `per` positions, then
    // the lanes' totals scanned
    const float a = p.A[h];
    const int per = (p.Q + 31) / 32, i0 = lane * per;
    float run = 0.f;
    float v[kMaxQ / 32];
#pragma unroll
    for (int k = 0; k < kMaxQ / 32; ++k) {
      if (k < per && i0 + k < p.Q) run += w_s[i0 + k] * a;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < kMaxQ / 32; ++k) {
      if (k < per && i0 + k < p.Q) {
        cum_s[i0 + k] = v[k] + excl;
        if (m == 0)
          p.cum[static_cast<long long>(item) * p.Q + i0 + k] = v[k] + excl;
      }
    }
  }
  wg_sync(w);
  // each row's weight: exp(cum_L - cum_j) dt_j, or exp(cum_j)
  const float cum_last = cum_s[p.Q - 1];
  for (int i = ct; i < p.Q; i += 128)
    w_s[i] = BWD ? exp2f(cum_s[i] * kLog2e)
                 : exp2f((cum_last - cum_s[i]) * kLog2e) * w_s[i];
  wg_sync(w);
  // each piece as it lands: x (dy) scaled row by row in place (the
  // swizzle permutes 16-byte chunks within a row only), then its four k16
  // steps issued while the next piece is scaled
  float acc[HP / 2];
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) acc[i] = 0.f;
  for (int jb = 0; jb < p.T; ++jb) {
    mbar_wait(&bars.piece[w][jb], 0);
    for (int q = ct; q < HP / 64 * 512; q += 128) {
      const int k = q >> 9, rr = (q & 511) + jb * 512;
      uint4* ptr = reinterpret_cast<uint4*>(vs + k * kLine + rr * 16);
      uint4 v = *ptr;
      const float wr = w_s[rr >> 3];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(e[u]);
        e[u] = __floats2bfloat162_rn(f.x * wr, f.y * wr);
      }
      *ptr = v;
    }
    fence_proxy_async();
    wg_sync(w);
    fence_regs<HP / 2>(acc);
    wgmma_fence();
    gemm_nn<HP>(acc, smem_u32(ws) + jb * kBox, smem_u32(vs) + jb * kBox,
                kLine, 4);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<HP / 2>(acc);
  float* out = (BWD ? p.dstate : p.state) +
               static_cast<long long>(item) * p.N * p.hp;
#pragma unroll
  for (int k = 0; k < HP / 8; ++k)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      store2(out + (64 * m + 16 * wl + g + 8 * hh) * p.hp + 8 * k + 2 * tq,
             acc[4 * k + 2 * hh], acc[4 * k + 2 * hh + 1]);
}

__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// state_pass: per (b, h) and slice of kSlice state elements, 4 a thread,
// the recurrence over the chunks; each chunk's summary is replaced by the
// state that enters it (H_c; H_0 = 0), and its bf16 copy written.  The
// next chunk's summary and decay are loaded before this chunk's stores:
// one chunk's loads always in flight.
__global__ void __launch_bounds__(kPassThreads)
    state_pass_kernel(const Params p) {
  const int h = blockIdx.y % p.nh, b = blockIdx.y / p.nh;
  const int size = p.N * p.hp;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * kPassPer;
  if (e >= size) return;
  const long long item0 = item_of(b, 0, h, p);
  const long long step = static_cast<long long>(p.nh) * size;
  float* st = p.state + item0 * size + e;
  bf16* sb = p.hbf + item0 * size + e;
  const float* cl = p.cum + item0 * p.Q + p.Q - 1;
  const long long cstep = static_cast<long long>(p.nh) * p.Q;
  float4 hs = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = *reinterpret_cast<const float4*>(st);
  float decay = expf(cl[0]);
  for (int c = 0; c < p.nc; ++c) {
    float4 sn = s;
    float dn = decay;
    if (c + 1 < p.nc) {
      sn = *reinterpret_cast<const float4*>(st + step);
      dn = expf(cl[(c + 1) * cstep]);
    }
    const bool drop = (p.plant & kPlantState) && c == 1;
    const float4 hc = drop ? make_float4(0.f, 0.f, 0.f, 0.f) : hs;
    *reinterpret_cast<float4*>(st) = hc;
    store4(sb, hc);
    hs = fma4(decay, hs, s);
    s = sn;
    decay = dn;
    st += step;
    sb += step;
  }
}

// --- the scan ----------------------------------------------------------------

// A job (b, c, h, 64-row tile t): y_i = exp(cum_i) C_i H_c + sum_{j <= i}
// (C B^T)_ij exp(cum_i - cum_j) dt_j x_j over the causal 64-key blocks.
// C_i and H_c (bf16) arrive once; the C B^T block and x_j of each key block
// through a ring.
template <int NP, int HP>
struct ScanShape {
  static constexpr int kC = NP / 64 * kBox;
  static constexpr int kH = HP / 64 * NP * 128;
  static constexpr int kX = HP / 64 * kBox;
  static constexpr int kStage = kBox + kX;
  static constexpr int kWg = kC + kH + kRing * kStage;
  static constexpr int kSmem = 2 * kWg + 1024;
  static_assert(kSmem <= kSmemMax - 8192, "the scan's stages");
};

template <int NP, int HP>
__global__ void __launch_bounds__(kThreads, 1)
    scan_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap cmap,
                const __grid_constant__ CUtensorMap hmap,
                const __grid_constant__ CUtensorMap cbmap, const Params p) {
  using S = ScanShape<NP, HP>;
  __shared__ __align__(8) Bars bars;
  __shared__ float s_cl[2][kMaxQ];
  __shared__ float s_dt[2][kMaxQ];
  __shared__ float s_f[2][kMaxQ];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_bars(bars);
  const int per = p.Bsz * p.nc * p.nh;
  const int njobs = p.T * per;
  const int w = warp < 4 ? warp : (warp >> 2) - 1;
  unsigned char* ws = smem + (w & 1) * S::kWg;
  unsigned char* ring0 = ws + S::kC + S::kH;
  // a job (b, c, h, t), the longest rows first; each warpgroup walks the
  // jobs id, id + 2 gridDim.x, ...
  auto decode = [&](int id, int& b, int& c, int& h, int& t) {
    const int ts = id / per, r = id - ts * per;
    t = p.T - 1 - ts;
    h = r % p.nh;
    c = (r / p.nh) % p.nc;
    b = r / (p.nh * p.nc);
  };
  if (warp < 4) {
    producer_regs();
    if (w < 2 && lane == 0) {
      Ring ring;
      uint32_t fphase = 0;
      for (int id = blockIdx.x * 2 + w; id < njobs; id += 2 * gridDim.x) {
        int b, c, h, t;
        decode(id, b, c, h, t);
        const int gi = h / p.hpg, s0 = c * p.Q;
        // C_i and H_c: free once y = C_i H_c is done
        mbar_wait(&bars.fix_empty[w], fphase ^ 1);
        fphase ^= 1;
        uint64_t* fix = &bars.fix[w];
        mbar_expect_tx(fix, S::kC + S::kH);
#pragma unroll
        for (int k = 0; k < NP / 64; ++k)
          tma_4d(ws + k * kBox, &cmap, fix, 64 * k, s0 + 64 * t, gi, b);
#pragma unroll
        for (int k = 0; k < HP / 64; ++k)
          tma_3d(ws + S::kC + k * NP * 128, &hmap, fix, 64 * k, 0,
                 static_cast<int>(item_of(b, c, h, p)));
        const int gitem = static_cast<int>(gitem_of(b, c, gi, p));
        for (int kb = 0; kb <= t; ++kb) {
          mbar_wait(&bars.empty[w][ring.stage], ring.phase ^ 1);
          uint64_t* full = &bars.full[w][ring.stage];
          unsigned char* st = ring0 + ring.stage * S::kStage;
          mbar_expect_tx(full, S::kStage);
          tma_3d(st, &cbmap, full, 64 * kb, 64 * t, gitem);
#pragma unroll
          for (int k = 0; k < HP / 64; ++k)
            tma_4d(st + kBox + k * kBox, &xmap, full, 64 * k, s0 + 64 * kb, h,
                   b);
          ring.next(kRing);
        }
      }
    }
    return;
  }
  consumer_regs();
  const int ct = threadIdx.x & 127, wl = ct >> 5, g = lane >> 2, tq = lane & 3;
  float* cl = s_cl[w];
  float* dts = s_dt[w];
  float* fs = s_f[w];
  const int rl = 16 * wl + g;                 // rows rl and rl + 8 of the tile
  const bool diag = (p.plant & kPlantDiag) == 0;
  Ring ring;
  uint32_t fphase = 0;
  for (int id = blockIdx.x * 2 + w; id < njobs; id += 2 * gridDim.x) {
    int b, c, h, t;
    decode(id, b, c, h, t);
    wg_sync(w);                  // the last job's cum and dt are read
    load_head(p, b, c, h, cl, dts, fs, kDecayCols, ct);
    wg_sync(w);
    const int i_lo = 64 * t + rl, i_hi = i_lo + 8;
    float y[HP / 2];
    mbar_wait(&bars.fix[w], fphase);
    fphase ^= 1;
    fence_regs<HP / 2>(y);
    wgmma_fence();
    gemm_kn<HP, NP / 16>(y, smem_u32(ws), kBox, smem_u32(ws + S::kC),
                         NP * 128);
    wgmma_commit();
    // key block 0's W while y_off's products run
    uint32_t wa[4][4];
    mbar_wait(&bars.full[w][ring.stage], ring.phase);
    scan_frags(ring0 + ring.stage * S::kStage, cl, dts, fs, 0, t, rl, tq,
               diag, wa);
    wgmma_wait<0>();
    fence_regs<HP / 2>(y);
    release(&bars.fix_empty[w], lane);
    {
      const float e_lo = exp2f(cl[i_lo]), e_hi = exp2f(cl[i_hi]);
#pragma unroll
      for (int k = 0; k < HP / 8; ++k) {
        y[4 * k] *= e_lo;
        y[4 * k + 1] *= e_lo;
        y[4 * k + 2] *= e_hi;
        y[4 * k + 3] *= e_hi;
      }
    }
    // y += W x_j for each key block; the next block's W is computed while
    // this block's products run
    for (int kb = 0; kb <= t; ++kb) {
      const int stage = ring.stage;
      fence_regs<HP / 2>(y);
      wgmma_fence();
      gemm_rn<HP, 4>(y, wa, smem_u32(ring0 + stage * S::kStage + kBox), kBox);
      wgmma_commit();
      ring.next(kRing);
      uint32_t wn[4][4];
      if (kb < t) {
        mbar_wait(&bars.full[w][ring.stage], ring.phase);
        scan_frags(ring0 + ring.stage * S::kStage, cl, dts, fs, kb + 1, t,
                   rl, tq, diag, wn);
      }
      wgmma_wait<0>();
      fence_regs<HP / 2>(y);
      release(&bars.empty[w][stage], lane);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) wa[k][q] = wn[k][q];
    }
    bf16* out = p.y + (static_cast<long long>(b) * p.S + c * p.Q) * p.nh *
                          p.hp +
                static_cast<long long>(h) * p.hp;
    const long long rs = static_cast<long long>(p.nh) * p.hp;
#pragma unroll
    for (int k = 0; k < HP / 8; ++k) {
      store2(out + i_lo * rs + 8 * k + 2 * tq, y[4 * k], y[4 * k + 1]);
      store2(out + i_hi * rs + 8 * k + 2 * tq, y[4 * k + 2], y[4 * k + 3]);
    }
  }
}

// --- backward ----------------------------------------------------------------

// The reverse state pass: per (b, h) and slice of kSlice elements, 4 a
// thread, D_c = dH_{c+1} (written over G_c), dH_c = G_c + exp(cum_L)
// dH_{c+1}, bf16 copies of D_c and H_c for the products, and each warp's
// part of <D_c, H_c> (times exp(cum_L): the chunk decay's gradient) in
// `dcl`, summed in a fixed order by dt_kernel.  The previous chunk's loads
// are in flight while this chunk's stores go out.
__global__ void __launch_bounds__(kPassThreads)
    state_pass_bwd_kernel(const Params p) {
  const int h = blockIdx.y % p.nh, b = blockIdx.y / p.nh;
  const int size = p.N * p.hp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * kPassPer;
  const bool in = e < size;
  const long long last = item_of(b, p.nc - 1, h, p);
  const long long step = static_cast<long long>(p.nh) * size;
  const long long off = last * size + (in ? e : 0);
  float* ds = p.dstate + off;
  const float* hsp = p.state + off;
  bf16* db = p.dbf + off;
  bf16* hb = p.hbf + off;
  const float* cl = p.cum + last * p.Q + p.Q - 1;
  const long long cstep = static_cast<long long>(p.nh) * p.Q;
  const int part_of = blockIdx.x * (kPassThreads / 32) + warp;
  float4 dh = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 g = in ? *reinterpret_cast<const float4*>(ds) : dh;
  float4 hv = in ? *reinterpret_cast<const float4*>(hsp) : dh;
  float decay = expf(cl[0]);
  for (int c = p.nc - 1; c >= 0; --c) {
    float4 gn = g, hn = hv;
    float dn = decay;
    if (c > 0) {
      if (in) {
        gn = *reinterpret_cast<const float4*>(ds - step);
        hn = *reinterpret_cast<const float4*>(hsp - step);
      }
      dn = expf(cl[-(p.nc - c) * cstep]);
    }
    if (in) {
      *reinterpret_cast<float4*>(ds) = dh;
      store4(db, dh);
      store4(hb, hv);
    }
    float part = in ? dh.x * hv.x + dh.y * hv.y + dh.z * hv.z + dh.w * hv.w
                    : 0.f;
    part = warp_sum(part);
    if (lane == 0)
      p.dcl[(last - static_cast<long long>(p.nc - 1 - c) * p.nh) * p.slices +
            part_of] = decay * part;
    dh = fma4(decay, dh, g);
    g = gn;
    hv = hn;
    decay = dn;
    ds -= step;
    hsp -= step;
    db -= step;
    hb -= step;
  }
}

// The tiles of a backward job: the fixed 64-row tile (B_j, or C_i), the
// head's stage (x_j and D, or dy_i and H), and a ring of the other rows'
// stages (dy_i, C_i and the (C B^T)^T block; or x_j, B_j and the C B^T
// block).  At hp 128 the ring is one stage deep (shared memory).
template <int NP, int HP>
struct BwdShape {
  static constexpr int kF = NP / 64 * kBox;
  static constexpr int kR = HP / 64 * kBox;
  static constexpr int kS = HP / 64 * NP * 128;
  static constexpr int kHead = kR + kS;
  static constexpr int kStage = kR + kF + kBox;
  static constexpr int kStages = HP > 64 ? 1 : 2;
  static constexpr int kWg = kF + kHead + kStages * kStage;
  static constexpr int kSmem = 2 * kWg + 1024;
  static_assert(kSmem <= kSmemMax - 8192, "the backward's stages");
};

// dx and dB: a job (b, c, g, band, 64-row tile t of j) a block, over the
// band's heads and, for each, the i-blocks from t.  Consumer warpgroup 0
// computes
//   dx_j = sum_{i >= j} W^T_ji dy_i + decay_j dt_j (B_j D),
// with qsum_j = sum_i (C B^T)_ij L_ij M_ij and e_j = decay_j x_j . (B_j D)
// for ddt; warpgroup 1
//   dB_j = sum over the band's heads of sum_{i >= j} (M o L o dt)^T_ji C_i
//          + (decay dt x_j) D^T,
// one fp32 accumulator for the band, written once as its slab
// (W = (C B^T) o L o dt, M = dy x^T).  Each computes M^T = x_j dy_i^T
// itself: split so, neither holds more than one 64-row accumulator
// beside M^T (at N = hp = 128 both on one warpgroup spill).  The stages
// (dy_i, C_i, the (C B^T)^T block) are shared: a ring as deep as shared
// memory allows, each stage released by both warpgroups.  The head's
// tiles (x_j, D) come in two stages and its cum and dt a head ahead in
// registers, so that the next head's loads run under this one's products.
template <int NP, int HP>
struct DxShape {
  static constexpr int kF = NP / 64 * kBox;          // B_j
  static constexpr int kR = HP / 64 * kBox;          // x_j; dy_i
  static constexpr int kS = HP / 64 * NP * 128;      // D
  static constexpr int kHead = kR + kS;
  static constexpr int kStage = kR + kF + kBox;      // dy_i, C_i, CB^T
  static constexpr int kFree = kSmemMax - 8192 - 1024 - kF - 2 * kHead;
  static constexpr int kStages = kFree / kStage < 4 ? kFree / kStage : 4;
  static constexpr int kSmem = kF + 2 * kHead + kStages * kStage + 1024;
  static_assert(kStages >= 2, "the dx / dB stages");
};

// The shared memory and barriers of a dx / dB block
struct DxSmem {
  unsigned char* bs;     // B_j
  unsigned char* hd;     // two head stages: x_j, then D
  unsigned char* ring0;  // the stages
  uint64_t* fix;
  uint64_t* fix_empty;
  uint64_t* head_full;   // [2]
  uint64_t* head_empty;  // [2]
  uint64_t* full;
  uint64_t* empty;
  float* cl;
  float* dts;
  float* fs;
};

// A consumer warpgroup of dx / dB: ROLE 0 dx (and qsum, e), ROLE 1 dB
template <int NP, int HP, int ROLE>
__device__ __forceinline__ void dxdb_role(const Params& p, const DxSmem& m,
                                          int lane) {
  using S = DxShape<NP, HP>;
  constexpr int kSt = S::kStages;
  constexpr int kAcc = (ROLE == 0 ? HP : NP) / 2;
  const int ct = threadIdx.x & 127, wl = ct >> 5, g = lane >> 2, tq = lane & 3;
  const int rl = 16 * wl + g;               // rows rl and rl + 8 of the tile
  const long long per = static_cast<long long>(p.Bsz) * p.nc * p.nh * p.Q;
  const int njobs = p.T * p.Bsz * p.nc * p.G * p.nb;
  const float* cl = m.cl;
  const float* dts = m.dts;
  const float* fs = m.fs;
  Ring ring, hring;
  uint32_t fphase = 0;
  HeadRegs next;
  if (blockIdx.x < njobs) {
    const Job j0 = band_job(blockIdx.x, p, false);
    fetch_head(p, j0.b, j0.c, j0.h, kDecayRows, ct, next);
  }
  for (int id = blockIdx.x; id < njobs; id += gridDim.x) {
    const Job j = band_job(id, p, false);
    const int s0 = j.c * p.Q, t = j.t;
    const int j_lo = 64 * t + rl, j_hi = j_lo + 8;
    float acc[kAcc];
    if (ROLE == 0) {
      mbar_wait(m.fix, fphase);
      fphase ^= 1;
    } else {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    }
    for (int kh = 0; kh < p.band; ++kh) {
      const int h = j.h + kh;
      wg_sync(ROLE);             // the last head's cum and dt are read
      store_head(next, p.Q, m.cl, m.dts, m.fs, kDecayRows, ct);
      wg_sync(ROLE);
      // the next head's cum and dt (this job's, or the next job's first)
      if (kh + 1 < p.band) {
        fetch_head(p, j.b, j.c, h + 1, kDecayRows, ct, next);
      } else if (id + gridDim.x < njobs) {
        const Job jn = band_job(id + gridDim.x, p, false);
        fetch_head(p, jn.b, jn.c, jn.h, kDecayRows, ct, next);
      }
      const unsigned char* hd = m.hd + hring.stage * S::kHead;
      mbar_wait(&m.head_full[hring.stage], hring.phase);
      const float cl_lo = cl[j_lo], cl_hi = cl[j_hi];
      const float dt_lo = dts[j_lo], dt_hi = dts[j_hi];
      const float dec_lo = exp2f(cl[p.Q - 1] - cl_lo);
      const float dec_hi = exp2f(cl[p.Q - 1] - cl_hi);
      const float w_lo = dec_lo * dt_lo, w_hi = dec_hi * dt_hi;
      if (ROLE == 0) {
        // B_j D into dx, e_j = decay_j x_j . (B_j D), dx = decay dt (B_j D)
        fence_regs<kAcc>(acc);
        wgmma_fence();
        gemm_kn<HP, NP / 16>(acc, smem_u32(m.bs), kBox,
                             smem_u32(hd + S::kR), NP * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kAcc>(acc);
        float e_lo = 0.f, e_hi = 0.f;
#pragma unroll
        for (int k = 0; k < HP / 8; ++k) {
          const float2 a = ld_pair(hd, kBox, rl, 8 * k + 2 * tq);
          const float2 bb = ld_pair(hd, kBox, rl + 8, 8 * k + 2 * tq);
          e_lo = fmaf(a.x, acc[4 * k], fmaf(a.y, acc[4 * k + 1], e_lo));
          e_hi = fmaf(bb.x, acc[4 * k + 2], fmaf(bb.y, acc[4 * k + 3], e_hi));
        }
        e_lo = quad_sum(e_lo) * dec_lo;
        e_hi = quad_sum(e_hi) * dec_hi;
        if (tq == 0) {
          float* rq = p.rows + per + item_of(j.b, j.c, h, p) * p.Q;
          rq[j_lo] = e_lo;
          rq[j_hi] = e_hi;
        }
#pragma unroll
        for (int k = 0; k < HP / 8; ++k) {
          acc[4 * k] *= w_lo;
          acc[4 * k + 1] *= w_lo;
          acc[4 * k + 2] *= w_hi;
          acc[4 * k + 3] *= w_hi;
        }
      } else {
        // dB += (decay dt x_j) D^T, the scaled x_j as register fragments
        uint32_t xf[HP / 16][4];
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk) {
          const int c0 = 16 * kk + 2 * tq;
          const float2 a0 = ld_pair(hd, kBox, rl, c0);
          const float2 a1 = ld_pair(hd, kBox, rl + 8, c0);
          const float2 a2 = ld_pair(hd, kBox, rl, c0 + 8);
          const float2 a3 = ld_pair(hd, kBox, rl + 8, c0 + 8);
          xf[kk][0] = pack_bf16(a0.x * w_lo, a0.y * w_lo);
          xf[kk][1] = pack_bf16(a1.x * w_hi, a1.y * w_hi);
          xf[kk][2] = pack_bf16(a2.x * w_lo, a2.y * w_lo);
          xf[kk][3] = pack_bf16(a3.x * w_hi, a3.y * w_hi);
        }
        fence_regs<kAcc>(acc);
        wgmma_fence();
        gemm_rk<NP, HP / 16>(acc, xf, smem_u32(hd + S::kR), NP * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kAcc>(acc);
      }
      float qs_lo = 0.f, qs_hi = 0.f;
      for (int i = t; i < p.T; ++i) {
        mbar_wait(&m.full[ring.stage], ring.phase);
        const unsigned char* st = m.ring0 + ring.stage * S::kStage;
        float mt[32];
        fence_regs<32>(mt);
        wgmma_fence();
        gemm_kk<64, HP / 16>(mt, smem_u32(hd), kBox, smem_u32(st), kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(mt);
        // L^T by the block factors off the diagonal (i > t), by an exp2 an
        // element under the mask i >= j on it
        const unsigned char* cbs = st + S::kR + S::kF;
        const bool off = i > t;
        const float ref = cl[64 * i];
        const float r_lo = exp2f(ref - cl_lo), r_hi = exp2f(ref - cl_hi);
        uint32_t fr[4][4];
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int hh = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * tq;
          const int jg = hh ? j_hi : j_lo, ig = 64 * i + col;
          const float cj = hh ? cl_hi : cl_lo, dj = hh ? dt_hi : dt_lo;
          const float r = hh ? r_hi : r_lo;
          const float l0 = off ? r * fs[ig]
                               : (ig >= jg ? exp2f(cl[ig] - cj) : 0.f);
          const float l1 = off ? r * fs[ig + 1]
                               : (ig + 1 >= jg ? exp2f(cl[ig + 1] - cj) : 0.f);
          if (ROLE == 0) {
            // W^T = (C B^T)^T o L^T o dt_j, and qsum
            const float2 v = ld_pair(cbs, kBox, rl + 8 * hh, col);
            const float c0 = v.x * l0, c1 = v.y * l1;
            const float q = fmaf(c0, mt[e], c1 * mt[e + 1]);
            if (hh)
              qs_hi += q;
            else
              qs_lo += q;
            put_pair(fr, e, c0 * dj, c1 * dj);
          } else {
            // (M o L o dt)^T
            put_pair(fr, e, mt[e] * l0 * dj, mt[e + 1] * l1 * dj);
          }
        }
        // dx += W^T dy_i, or dB += (M o L o dt)^T C_i
        fence_regs<kAcc>(acc);
        wgmma_fence();
        gemm_rn<ROLE == 0 ? HP : NP, 4>(
            acc, fr, smem_u32(st + (ROLE == 0 ? 0 : S::kR)), kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kAcc>(acc);
        release(&m.empty[ring.stage], lane);
        ring.next(kSt);
      }
      release(&m.head_empty[hring.stage], lane);
      hring.next(2);
      if (ROLE == 0) {
        qs_lo = quad_sum(qs_lo);
        qs_hi = quad_sum(qs_hi);
        const long long rs = static_cast<long long>(p.nh) * p.hp;
        bf16* dxo = p.dx + (static_cast<long long>(j.b) * p.S + s0) * rs +
                    static_cast<long long>(h) * p.hp;
#pragma unroll
        for (int k = 0; k < HP / 8; ++k) {
          store2(dxo + j_lo * rs + 8 * k + 2 * tq, acc[4 * k], acc[4 * k + 1]);
          store2(dxo + j_hi * rs + 8 * k + 2 * tq, acc[4 * k + 2],
                 acc[4 * k + 3]);
        }
        if (tq == 0) {
          float* rq = p.rows + item_of(j.b, j.c, h, p) * p.Q;
          rq[j_lo] = qs_lo;
          rq[j_hi] = qs_hi;
        }
      }
    }
    if (ROLE == 0) {
      release(m.fix_empty, lane);
    } else {
      const long long rn = static_cast<long long>(p.G) * p.nb * p.N;
      float* dbo = p.dbs + (static_cast<long long>(j.b) * p.S + s0) * rn +
                   (static_cast<long long>(j.gi) * p.nb + j.band) * p.N;
#pragma unroll
      for (int k = 0; k < NP / 8; ++k) {
        store2(dbo + j_lo * rn + 8 * k + 2 * tq, acc[4 * k], acc[4 * k + 1]);
        store2(dbo + j_hi * rn + 8 * k + 2 * tq, acc[4 * k + 2],
               acc[4 * k + 3]);
      }
    }
  }
}

template <int NP, int HP>
__global__ void __launch_bounds__(kThreads, 1)
    dxdb_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap cmap,
                const __grid_constant__ CUtensorMap dymap,
                const __grid_constant__ CUtensorMap dmap,
                const __grid_constant__ CUtensorMap cbtmap, const Params p) {
  using S = DxShape<NP, HP>;
  constexpr int kSt = S::kStages;
  __shared__ __align__(8) uint64_t fix, fix_empty, head_full[2], head_empty[2];
  __shared__ __align__(8) uint64_t full[kSt], empty[kSt];
  __shared__ float s_cl[2][kMaxQ];
  __shared__ float s_dt[2][kMaxQ];
  __shared__ float s_f[2][kMaxQ];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* bs = smem;
  unsigned char* hd0 = smem + S::kF;
  unsigned char* ring0 = hd0 + 2 * S::kHead;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(&fix, 1);
    mbar_init(&fix_empty, 4);                   // warpgroup 0's warps
    for (int s = 0; s < 2; ++s) {
      mbar_init(&head_full[s], 1);
      mbar_init(&head_empty[s], 8);             // both warpgroups' warps
    }
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int njobs = p.T * p.Bsz * p.nc * p.G * p.nb;
  if (warp < 4) {
    producer_regs();
    if (warp == 0 && lane == 0) {
      Ring ring, hring;
      uint32_t fphase = 0;
      for (int id = blockIdx.x; id < njobs; id += gridDim.x) {
        const Job j = band_job(id, p, false);   // the most i-blocks first
        const int s0 = j.c * p.Q, t = j.t;
        mbar_wait(&fix_empty, fphase ^ 1);
        fphase ^= 1;
        mbar_expect_tx(&fix, S::kF);
#pragma unroll
        for (int k = 0; k < NP / 64; ++k)
          tma_4d(bs + k * kBox, &bmap, &fix, 64 * k, s0 + 64 * t, j.gi, j.b);
        const int gitem = static_cast<int>(gitem_of(j.b, j.c, j.gi, p));
        for (int kh = 0; kh < p.band; ++kh) {
          const int h = j.h + kh;
          mbar_wait(&head_empty[hring.stage], hring.phase ^ 1);
          uint64_t* hf = &head_full[hring.stage];
          unsigned char* hd = hd0 + hring.stage * S::kHead;
          mbar_expect_tx(hf, S::kHead);
#pragma unroll
          for (int k = 0; k < HP / 64; ++k) {
            tma_4d(hd + k * kBox, &xmap, hf, 64 * k, s0 + 64 * t, h, j.b);
            tma_3d(hd + S::kR + k * NP * 128, &dmap, hf, 64 * k, 0,
                   static_cast<int>(item_of(j.b, j.c, h, p)));
          }
          hring.next(2);
          for (int i = t; i < p.T; ++i) {
            mbar_wait(&empty[ring.stage], ring.phase ^ 1);
            uint64_t* bar = &full[ring.stage];
            unsigned char* st = ring0 + ring.stage * S::kStage;
            mbar_expect_tx(bar, S::kStage);
#pragma unroll
            for (int k = 0; k < HP / 64; ++k)
              tma_4d(st + k * kBox, &dymap, bar, 64 * k, s0 + 64 * i, h, j.b);
#pragma unroll
            for (int k = 0; k < NP / 64; ++k)
              tma_4d(st + S::kR + k * kBox, &cmap, bar, 64 * k, s0 + 64 * i,
                     j.gi, j.b);
            tma_3d(st + S::kR + S::kF, &cbtmap, bar, 64 * i, 64 * t, gitem);
            ring.next(kSt);
          }
        }
      }
    }
    return;
  }
  consumer_regs();
  const int wg = (warp >> 2) - 1;               // 0: dx, 1: dB
  const DxSmem m = {bs, hd0, ring0, &fix, &fix_empty, head_full, head_empty,
                    full, empty, s_cl[wg], s_dt[wg], s_f[wg]};
  if (wg == 0)
    dxdb_role<NP, HP, 0>(p, m, lane);
  else
    dxdb_role<NP, HP, 1>(p, m, lane);
}

// dC: a job (b, c, g, band, 64-row tile t of i) walks the band's heads;
// for each, dC_i += exp(cum_i) dy_i H^T + sum_{j <= i} (M o L o dt)_ij B_j,
// and psum_i = sum_j (C B^T)_ij L_ij dt_j M_ij and yd_i = y_off_i . dy_i
// for ddt.  One fp32 accumulator for the band, written once.
template <int NP, int HP>
__global__ void __launch_bounds__(kThreads, 1)
    dc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap dymap,
              const __grid_constant__ CUtensorMap hmap,
              const __grid_constant__ CUtensorMap cbmap, const Params p) {
  using S = BwdShape<NP, HP>;
  __shared__ __align__(8) Bars bars;
  __shared__ float s_cl[2][kMaxQ];
  __shared__ float s_dt[2][kMaxQ];
  __shared__ float s_f[2][kMaxQ];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  init_bars(bars);
  const int w = warp < 4 ? warp : (warp >> 2) - 1;
  const int njobs = p.T * p.Bsz * p.nc * p.G * p.nb;
  unsigned char* ws = smem + (w & 1) * S::kWg;  // C_i
  unsigned char* hd = ws + S::kF;               // dy_i, then H
  unsigned char* ring0 = hd + S::kHead;
  if (warp < 4) {
    producer_regs();
    if (w < 2 && lane == 0) {
      Ring ring;
      uint32_t hphase = 0, fphase = 0;
      for (int id = blockIdx.x * 2 + w; id < njobs; id += 2 * gridDim.x) {
        const Job j = band_job(id, p, true);
        const int s0 = j.c * p.Q, t = j.t;
        mbar_wait(&bars.fix_empty[w], fphase ^ 1);
        fphase ^= 1;
        uint64_t* fix = &bars.fix[w];
        mbar_expect_tx(fix, S::kF);
#pragma unroll
        for (int k = 0; k < NP / 64; ++k)
          tma_4d(ws + k * kBox, &cmap, fix, 64 * k, s0 + 64 * t, j.gi, j.b);
        const int gitem = static_cast<int>(gitem_of(j.b, j.c, j.gi, p));
        for (int kh = 0; kh < p.band; ++kh) {
          const int h = j.h + kh;
          mbar_wait(&bars.head_empty[w], hphase ^ 1);
          uint64_t* hf = &bars.head_full[w];
          mbar_expect_tx(hf, S::kHead);
#pragma unroll
          for (int k = 0; k < HP / 64; ++k) {
            tma_4d(hd + k * kBox, &dymap, hf, 64 * k, s0 + 64 * t, h, j.b);
            tma_3d(hd + S::kR + k * NP * 128, &hmap, hf, 64 * k, 0,
                   static_cast<int>(item_of(j.b, j.c, h, p)));
          }
          for (int jb = 0; jb <= t; ++jb) {
            mbar_wait(&bars.empty[w][ring.stage], ring.phase ^ 1);
            uint64_t* full = &bars.full[w][ring.stage];
            unsigned char* st = ring0 + ring.stage * S::kStage;
            mbar_expect_tx(full, S::kStage);
#pragma unroll
            for (int k = 0; k < HP / 64; ++k)
              tma_4d(st + k * kBox, &xmap, full, 64 * k, s0 + 64 * jb, h, j.b);
#pragma unroll
            for (int k = 0; k < NP / 64; ++k)
              tma_4d(st + S::kR + k * kBox, &bmap, full, 64 * k, s0 + 64 * jb,
                     j.gi, j.b);
            tma_3d(st + S::kR + S::kF, &cbmap, full, 64 * jb, 64 * t, gitem);
            ring.next(S::kStages);
          }
          hphase ^= 1;
        }
      }
    }
    return;
  }
  consumer_regs();
  const int ct = threadIdx.x & 127, wl = ct >> 5, g = lane >> 2, tq = lane & 3;
  float* cl = s_cl[w];
  float* dts = s_dt[w];
  float* fs = s_f[w];
  const int rl = 16 * wl + g;
  const long long per = static_cast<long long>(p.Bsz) * p.nc * p.nh * p.Q;
  Ring ring;
  uint32_t hphase = 0, fphase = 0;
  for (int id = blockIdx.x * 2 + w; id < njobs; id += 2 * gridDim.x) {
    const Job j = band_job(id, p, true);
    const int s0 = j.c * p.Q, t = j.t;
    const int i_lo = 64 * t + rl, i_hi = i_lo + 8;
    float dc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) dc[i] = 0.f;
    mbar_wait(&bars.fix[w], fphase);
    fphase ^= 1;
    for (int kh = 0; kh < p.band; ++kh) {
      const int h = j.h + kh;
      wg_sync(w);
      load_head(p, j.b, j.c, h, cl, dts, fs, kDecayCols, ct);
      wg_sync(w);
      const float cl_lo = cl[i_lo], cl_hi = cl[i_hi];
      mbar_wait(&bars.head_full[w], hphase);
      float yd_lo = 0.f, yd_hi = 0.f;
      {
        // dy_i H^T: yd_i = exp(cum_i) C_i . (dy_i H^T), and
        // dC += exp(cum_i) dy_i H^T
        float ta[NP / 2];
        fence_regs<NP / 2>(ta);
        wgmma_fence();
        gemm_kk<NP, HP / 16>(ta, smem_u32(hd), kBox, smem_u32(hd + S::kR),
                             NP * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NP / 2>(ta);
        const float e_lo = exp2f(cl_lo), e_hi = exp2f(cl_hi);
#pragma unroll
        for (int k = 0; k < NP / 8; ++k) {
          const float2 a = ld_pair(ws, kBox, rl, 8 * k + 2 * tq);
          const float2 bb = ld_pair(ws, kBox, rl + 8, 8 * k + 2 * tq);
          yd_lo = fmaf(a.x, ta[4 * k], fmaf(a.y, ta[4 * k + 1], yd_lo));
          yd_hi = fmaf(bb.x, ta[4 * k + 2], fmaf(bb.y, ta[4 * k + 3], yd_hi));
          dc[4 * k] = fmaf(e_lo, ta[4 * k], dc[4 * k]);
          dc[4 * k + 1] = fmaf(e_lo, ta[4 * k + 1], dc[4 * k + 1]);
          dc[4 * k + 2] = fmaf(e_hi, ta[4 * k + 2], dc[4 * k + 2]);
          dc[4 * k + 3] = fmaf(e_hi, ta[4 * k + 3], dc[4 * k + 3]);
        }
        yd_lo = quad_sum(yd_lo) * e_lo;
        yd_hi = quad_sum(yd_hi) * e_hi;
      }
      float ps_lo = 0.f, ps_hi = 0.f;
      for (int jb = 0; jb <= t; ++jb) {
        mbar_wait(&bars.full[w][ring.stage], ring.phase);
        const unsigned char* st = ring0 + ring.stage * S::kStage;
        float m[32];
        fence_regs<32>(m);
        wgmma_fence();
        gemm_kk<64, HP / 16>(m, smem_u32(hd), kBox, smem_u32(st), kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(m);
        // dS = M o L o dt, packed as computed; L dt by the block factors
        // off the diagonal (jb < t)
        uint32_t df[4][4];
        const unsigned char* cbs = st + S::kR + S::kF;
        if (jb < t) {
          const float ref = cl[64 * jb + 63];
          const float r_lo = exp2f(cl_lo - ref), r_hi = exp2f(cl_hi - ref);
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int hh = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * tq;
            const float2 v = ld_pair(cbs, kBox, rl + 8 * hh, col);
            const float r = hh ? r_hi : r_lo;
            const float d0 = m[e] * r * fs[64 * jb + col];
            const float d1 = m[e + 1] * r * fs[64 * jb + col + 1];
            const float q = fmaf(v.x, d0, v.y * d1);
            if (hh)
              ps_hi += q;
            else
              ps_lo += q;
            put_pair(df, e, d0, d1);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 32; e += 2) {
            const int hh = (e >> 1) & 1, col = 8 * (e >> 2) + 2 * tq;
            const float2 v = ld_pair(cbs, kBox, rl + 8 * hh, col);
            const int ig = hh ? i_hi : i_lo, jg = 64 * jb + col;
            const float ci = hh ? cl_hi : cl_lo;
            const float d0 =
                jg <= ig ? m[e] * exp2f(ci - cl[jg]) * dts[jg] : 0.f;
            const float d1 = jg + 1 <= ig
                                 ? m[e + 1] * exp2f(ci - cl[jg + 1]) *
                                       dts[jg + 1]
                                 : 0.f;
            const float q = fmaf(v.x, d0, v.y * d1);
            if (hh)
              ps_hi += q;
            else
              ps_lo += q;
            put_pair(df, e, d0, d1);
          }
        }
        // dC += dS B_j
        fence_regs<NP / 2>(dc);
        wgmma_fence();
        gemm_rn<NP, 4>(dc, df, smem_u32(st + S::kR), kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NP / 2>(dc);
        release(&bars.empty[w][ring.stage], lane);
        ring.next(S::kStages);
      }
      release(&bars.head_empty[w], lane);
      hphase ^= 1;
      ps_lo = quad_sum(ps_lo);
      ps_hi = quad_sum(ps_hi);
      if (tq == 0) {
        float* rq = p.rows + 2 * per + item_of(j.b, j.c, h, p) * p.Q;
        rq[i_lo] = ps_lo;
        rq[i_hi] = ps_hi;
        rq[per + i_lo] = yd_lo;
        rq[per + i_hi] = yd_hi;
      }
    }
    release(&bars.fix_empty[w], lane);
    const long long rn = static_cast<long long>(p.G) * p.nb * p.N;
    float* dco = p.dcs + (static_cast<long long>(j.b) * p.S + s0) * rn +
                 (static_cast<long long>(j.gi) * p.nb + j.band) * p.N;
#pragma unroll
    for (int k = 0; k < NP / 8; ++k) {
      store2(dco + i_lo * rn + 8 * k + 2 * tq, dc[4 * k], dc[4 * k + 1]);
      store2(dco + i_hi * rn + 8 * k + 2 * tq, dc[4 * k + 2], dc[4 * k + 3]);
    }
  }
}

// d(cum) -> ddt and dA's partial: a warp per (b, c, h).
//   dcum_i = psum_i + yd_i - dt_i (qsum_i + e_i)
//            + [i = Q-1] (sum_j dt_j e_j + sum of the dcl slices)
//   da_k = sum_{i >= k} dcum_i,  ddt_k = qsum_k + e_k + A da_k,
//   dA's partial = sum_k dt_k da_k.
__global__ void __launch_bounds__(128) dt_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long item =
      static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(p.Bsz) * p.nc * p.nh) return;
  const int h = static_cast<int>(item % p.nh);
  const int c = static_cast<int>((item / p.nh) % p.nc);
  const int b = static_cast<int>(item / (static_cast<long long>(p.nh) * p.nc));
  const long long per = static_cast<long long>(p.Bsz) * p.nc * p.nh * p.Q;
  const float* qsum = p.rows + item * p.Q;
  const float* ev = qsum + per;
  const float* psum = qsum + 2 * per;
  const float* yd = qsum + 3 * per;
  const float* dtc =
      p.dt + (static_cast<long long>(b) * p.S + c * p.Q) * p.nh + h;
  const int q_per = (p.Q + 31) / 32, i0 = lane * q_per;
  float dc[kMaxQ / 32], dtv[kMaxQ / 32];
  float se = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int i = i0 + k;
    dc[k] = 0.f;
    dtv[k] = 0.f;
    if (k < q_per && i < p.Q) {
      dtv[k] = dtc[static_cast<long long>(i) * p.nh];
      dc[k] = psum[i] + yd[i] - dtv[k] * (qsum[i] + ev[i]);
      se = fmaf(dtv[k], ev[i], se);
    }
  }
  se = warp_sum(se);
  float dcl = 0.f;
  for (int s = 0; s < p.slices; ++s) dcl += p.dcl[item * p.slices + s];
  // reverse inclusive cumsum: within the lane, then over the later lanes
  float run = 0.f;
#pragma unroll
  for (int k = kMaxQ / 32 - 1; k >= 0; --k) {
    const int i = i0 + k;
    if (k < q_per && i < p.Q) {
      if (i == p.Q - 1) dc[k] += se + dcl;
      run += dc[k];
      dc[k] = run;
    }
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += n;
  }
  const float later = incl - run;
  const float a = p.A[h];
  float da_part = 0.f;
  float* ddt = p.ddt + (static_cast<long long>(b) * p.S + c * p.Q) * p.nh + h;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    const int i = i0 + k;
    if (k < q_per && i < p.Q) {
      const float da = dc[k] + later;
      ddt[static_cast<long long>(i) * p.nh] = qsum[i] + ev[i] + a * da;
      da_part = fmaf(dtv[k], da, da_part);
    }
  }
  da_part = warp_sum(da_part);
  if (lane == 0) p.dAp[item] = da_part;
}

// dB and dC: each group's band slabs summed in band order, in bf16; dA
// summed over (b, c).
__global__ void __launch_bounds__(kPassThreads) reduce_kernel(const Params p) {
  const long long per = static_cast<long long>(p.Bsz) * p.S * p.G * p.N;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (idx < 2 * per) {
    const bool is_c = idx >= per;
    const long long e = is_c ? idx - per : idx;
    const long long row = e / p.N;                 // (b, s, g)
    const int n = static_cast<int>(e - row * p.N);
    const float* src = (is_c ? p.dcs : p.dbs) + row * p.nb * p.N + n;
    float acc = 0.f;
    for (int k = 0; k < p.nb; ++k) acc += src[static_cast<long long>(k) * p.N];
    (is_c ? p.dC : p.dB)[e] = __float2bfloat16_rn(acc);
  } else if (idx < 2 * per + p.nh) {
    const int h = static_cast<int>(idx - 2 * per);
    float acc = 0.f;
    for (long long bc = 0; bc < static_cast<long long>(p.Bsz) * p.nc; ++bc)
      acc += p.dAp[bc * p.nh + h];
    p.dA[h] = acc;
  }
}

// --- launch ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver's tensor-map encoder, reached through the runtime so that
// the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first), `strides` in
// elements for dims 1..; boxes of 64 columns x `rows` rows with the
// 128-byte swizzle.  A dim of size 1 (stride 0 from the wrapper) gets the
// largest stride: its coordinate is always 0.
int encode(CUtensorMap* map, int rank, const void* base, const long long* dims,
           const long long* strides, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrEncoder;
  cuuint64_t gd[5], gs[4];
  cuuint32_t box[5], es[5];
  long long widest = 16;
  for (int i = 0; i + 1 < rank; ++i) widest = std::max(widest, strides[i] * 2);
  for (int i = 0; i < rank; ++i) {
    gd[i] = static_cast<cuuint64_t>(dims[i]);
    box[i] = i == 0 ? 64 : i == 1 ? rows : 1;
    es[i] = 1;
  }
  for (int i = 0; i + 1 < rank; ++i)
    gs[i] = static_cast<cuuint64_t>(strides[i] > 0 ? strides[i] * 2 : widest);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        static_cast<cuuint32_t>(rank), const_cast<void*>(base),
                        gd, gs, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// x or dy (cols = hp, over heads) and B or C (cols = N, over groups):
// (cols, S, heads, b) from the wrapper's strides s = (batch, row, head)
int encode_rows(CUtensorMap* map, const void* base, const long long* s,
                int cols, int heads, const Params& p) {
  const long long dims[4] = {cols, p.S, heads, p.Bsz};
  const long long st[3] = {s[1], s[2], s[0]};
  return encode(map, 4, base, dims, st, 64);
}

// the bf16 states (hp, N, b * nc * nh), N-row boxes
int encode_state(CUtensorMap* map, const void* base, const Params& p) {
  const long long dims[3] = {p.hp, p.N,
                             static_cast<long long>(p.Bsz) * p.nc * p.nh};
  const long long st[2] = {p.hp, static_cast<long long>(p.N) * p.hp};
  return encode(map, 3, base, dims, st, p.N);
}

// C B^T or its transpose (Q, Q, b * nc * G)
int encode_cb(CUtensorMap* map, const void* base, const Params& p) {
  const long long dims[3] = {p.Q, p.Q,
                             static_cast<long long>(p.Bsz) * p.nc * p.G};
  const long long st[2] = {p.Q, static_cast<long long>(p.Q) * p.Q};
  return encode(map, 3, base, dims, st, 64);
}

template <typename K, typename... Args>
int launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
           const Args&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

struct Inputs {
  const void* x;
  const void* B;
  const void* C;
  const void* dy;
  const long long* strides;   // x (3), B (3), C (3), dy (3)
};

// The blocks of a persistent kernel (scan, dx / dB, dC): every slot the
// card holds at once, or one a pair of jobs where there are fewer.
template <typename K>
int persistent_blocks(K kernel, int smem, int jobs, int per_block = 2) {
  int dev = 0, sms = 1, per = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) == cudaSuccess)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads,
                                                  smem);
  return std::max(1,
                  std::min(cdiv(jobs, per_block), sms * std::max(per, 1)));
}

// the launches a call makes, by bit (a probe times each alone)
int g_only = -1;

bool on(int k) { return (g_only >> k) & 1; }

template <int NP, int HP>
int run_fwd(const Inputs& in, Params p, cudaStream_t st) {
  CUtensorMap xm, bm, cm, hm, cbm;
  int e = encode_rows(&xm, in.x, in.strides, p.hp, p.nh, p);
  if (!e) e = encode_rows(&bm, in.B, in.strides + 3, p.N, p.G, p);
  if (!e) e = encode_rows(&cm, in.C, in.strides + 6, p.N, p.G, p);
  if (!e) e = encode_state(&hm, p.hbf, p);
  if (!e) e = encode_cb(&cbm, p.cb, p);
  p.cbz = 1;
  const int gjobs = p.T * p.Bsz * p.nc * p.G;
  if (!e && on(0))
    e = launch(cb_kernel<NP>, dim3(cdiv(gjobs, 2)), kThreads,
               CbShape<NP>::kSmem, st, bm, cm, p);
  if (!e && on(1))
    e = launch(state_kernel<NP, HP, false>,
               dim3(cdiv(p.Bsz * p.nc * p.nh * (NP / 64), 2)), kThreads,
               StateShape<HP>::kSmem, st, xm, bm, p);
  if (!e && on(2))
    e = launch(state_pass_kernel, dim3(cdiv(p.N * p.hp, kSlice), p.Bsz * p.nh),
               kPassThreads, 0, st, p);
  if (!e && on(3))
    e = launch(scan_kernel<NP, HP>,
               dim3(persistent_blocks(scan_kernel<NP, HP>,
                                      ScanShape<NP, HP>::kSmem,
                                      p.T * p.Bsz * p.nc * p.nh)),
               kThreads, ScanShape<NP, HP>::kSmem, st, xm, cm, hm, cbm, p);
  return e;
}

template <int NP, int HP>
int run_bwd(const Inputs& in, Params p, cudaStream_t st) {
  CUtensorMap xm, bm, cm, dym, hm, dm, cbm, cbtm;
  int e = encode_rows(&xm, in.x, in.strides, p.hp, p.nh, p);
  if (!e) e = encode_rows(&bm, in.B, in.strides + 3, p.N, p.G, p);
  if (!e) e = encode_rows(&cm, in.C, in.strides + 6, p.N, p.G, p);
  if (!e) e = encode_rows(&dym, in.dy, in.strides + 9, p.hp, p.nh, p);
  if (!e) e = encode_state(&hm, p.hbf, p);
  if (!e) e = encode_state(&dm, p.dbf, p);
  if (!e) e = encode_cb(&cbm, p.cb, p);
  if (!e) e = encode_cb(&cbtm, p.cbt, p);
  p.cbz = 2;
  const int gjobs = 2 * p.T * p.Bsz * p.nc * p.G;
  const int bjobs = p.T * p.Bsz * p.nc * p.G * p.nb;
  const int items = p.Bsz * p.nc * p.nh;
  const long long total = 2LL * p.Bsz * p.S * p.G * p.N + p.nh;
  if (!e && on(0))
    e = launch(cb_kernel<NP>, dim3(cdiv(gjobs, 2)), kThreads,
               CbShape<NP>::kSmem, st, bm, cm, p);
  if (!e && on(1))
    e = launch(state_kernel<NP, HP, true>,
               dim3(cdiv(p.Bsz * p.nc * p.nh * (NP / 64), 2)), kThreads,
               StateShape<HP>::kSmem, st, dym, cm, p);
  if (!e && on(2))
    e = launch(state_pass_bwd_kernel,
               dim3(cdiv(p.N * p.hp, kSlice), p.Bsz * p.nh), kPassThreads, 0,
               st, p);
  constexpr int kDxSmem = DxShape<NP, HP>::kSmem;
  constexpr int kBwdSmem = BwdShape<NP, HP>::kSmem;
  if (!e && on(3))
    e = launch(dxdb_kernel<NP, HP>,
               dim3(persistent_blocks(dxdb_kernel<NP, HP>, kDxSmem, bjobs, 1)),
               kThreads, kDxSmem, st, xm, bm, cm, dym, dm, cbtm, p);
  if (!e && on(4))
    e = launch(dc_kernel<NP, HP>,
               dim3(persistent_blocks(dc_kernel<NP, HP>, kBwdSmem, bjobs)),
               kThreads, kBwdSmem, st, xm, bm, cm, dym, hm, cbm, p);
  if (!e && on(5)) e = launch(dt_kernel, dim3(cdiv(items, 4)), 128, 0, st, p);
  if (!e && on(6))
    e = launch(reduce_kernel,
               dim3(static_cast<unsigned>((total + kPassThreads - 1) /
                                          kPassThreads)),
               kPassThreads, 0, st, p);
  return e;
}

template <int NP, int HP>
int run(bool fwd, const Inputs& in, const Params& p, cudaStream_t st) {
  return fwd ? run_fwd<NP, HP>(in, p, st) : run_bwd<NP, HP>(in, p, st);
}

int dispatch(bool fwd, const Inputs& in, const Params& p, cudaStream_t st) {
  if (p.N == 64 && p.hp == 64) return run<64, 64>(fwd, in, p, st);
  if (p.N == 64) return run<64, 128>(fwd, in, p, st);
  if (p.hp == 64) return run<128, 64>(fwd, in, p, st);
  return run<128, 128>(fwd, in, p, st);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Fills p's shape; false when the arguments break the contract.
bool setup(Params& p, const Inputs& in, int Bsz, int S, int nh, int hp, int G,
           int N, int Q, int band, bool bwd) {
  if (Bsz < 1 || S < 1 || nh < 1 || G < 1 || nh % G || Q < 64 || Q > kMaxQ ||
      Q % 64 || S % Q || (N != 64 && N != 128) || (hp != 64 && hp != 128) ||
      static_cast<long long>(Bsz) * nh > 65535 || band < 1 || (nh / G) % band)
    return false;
  for (int i = 0; i < (bwd ? 12 : 9); ++i)
    if (in.strides[i] < 0 || in.strides[i] % 8) return false;
  if (!aligned16(in.x) || !aligned16(in.B) || !aligned16(in.C) ||
      (bwd && !aligned16(in.dy)))
    return false;
  p.Bsz = Bsz;
  p.S = S;
  p.nh = nh;
  p.hp = hp;
  p.G = G;
  p.N = N;
  p.Q = Q;
  p.nc = S / Q;
  p.hpg = nh / G;
  p.T = Q / 64;
  p.band = band;
  p.nb = p.hpg / band;
  p.slices = N * hp / kPart;
  // job and item counts in int, the states' map in 32-bit coordinates
  return static_cast<long long>(Bsz) * p.nc * nh * p.T <= 0x3fffffffLL;
}

}  // namespace

extern "C" {

// Forward on `stream`: bf16 x (b, S, nh, hp), B and C (b, S, G, N) as in the
// header, dt (b, S, nh) and A (nh,) fp32; y (b, S, nh, hp) contiguous bf16;
// cum (b, S/Q, nh, Q) and state (b, S/Q, nh, N, hp) fp32, contiguous: the
// backward reads both (state holds the state entering each chunk).
// Scratch: hbf (b, S/Q, nh, N, hp) and cb (b, S/Q, G, Q, Q) bf16.  `plant`:
// 0, or the smoke check's planted faults.  Four launches.  Returns 0, a
// CUDA error code, or a negative code of its own.
int ssd_sm90_fwd(const void* x, const void* B, const void* C, const void* dt,
                 const void* A, void* y, void* cum, void* state, void* hbf,
                 void* cb, const long long* strides, int Bsz, int S, int nh,
                 int hp, int G, int N, int Q, int plant, void* stream) {
  Params p = {};
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.y = static_cast<bf16*>(y);
  p.cum = static_cast<float*>(cum);
  p.state = static_cast<float*>(state);
  p.hbf = static_cast<bf16*>(hbf);
  p.cb = static_cast<bf16*>(cb);
  p.plant = plant;
  const Inputs in = {x, B, C, nullptr, strides};
  if (!setup(p, in, Bsz, S, nh, hp, G, N, Q, 1, false) || !aligned16(y) ||
      !aligned16(state) || !aligned16(hbf) || !aligned16(cb))
    return kErrArgs;
  return dispatch(true, in, p, static_cast<cudaStream_t>(stream));
}

// Backward on `stream`: from the forward's inputs, cum and state and y's
// gradient dy (strided like x), dx (b, S, nh, hp), dB and dC (b, S, G, N)
// contiguous bf16, ddt (b, S, nh) and dA (nh,) fp32.  Scratch: dstate
// (b, S/Q, nh, N, hp) fp32, dcl (b, S/Q, nh, N hp / 128), rows
// (4, b, S/Q, nh, Q), hbf and dbf (b, S/Q, nh, N, hp) bf16, cb and cbt
// (b, S/Q, G, Q, Q) bf16, dbs and dcs (b, S, G, nh / G / band, N) fp32, dAp
// (b, S/Q, nh).  `band`: the heads a backward job sums dB and dC over.
// Seven launches.
int ssd_sm90_bwd(const void* x, const void* B, const void* C, const void* dt,
                 const void* A, const void* dy, const void* cum,
                 const void* state, void* dstate, void* dcl, void* rows,
                 void* hbf, void* dbf, void* cb, void* cbt, void* dbs,
                 void* dcs, void* dAp, void* dx, void* ddt, void* dA, void* dB,
                 void* dC, const long long* strides, int Bsz, int S, int nh,
                 int hp, int G, int N, int Q, int band, void* stream) {
  Params p = {};
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.cum = static_cast<float*>(const_cast<void*>(cum));
  p.state = static_cast<float*>(const_cast<void*>(state));
  p.dstate = static_cast<float*>(dstate);
  p.dcl = static_cast<float*>(dcl);
  p.rows = static_cast<float*>(rows);
  p.hbf = static_cast<bf16*>(hbf);
  p.dbf = static_cast<bf16*>(dbf);
  p.cb = static_cast<bf16*>(cb);
  p.cbt = static_cast<bf16*>(cbt);
  p.dbs = static_cast<float*>(dbs);
  p.dcs = static_cast<float*>(dcs);
  p.dAp = static_cast<float*>(dAp);
  p.dx = static_cast<bf16*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dB = static_cast<bf16*>(dB);
  p.dC = static_cast<bf16*>(dC);
  const Inputs in = {x, B, C, dy, strides};
  if (!setup(p, in, Bsz, S, nh, hp, G, N, Q, band, true) || !aligned16(dx) ||
      !aligned16(dstate) || !aligned16(state) || !aligned16(hbf) ||
      !aligned16(dbf) || !aligned16(cb) || !aligned16(cbt) ||
      !aligned16(dbs) || !aligned16(dcs))
    return kErrArgs;
  return dispatch(false, in, p, static_cast<cudaStream_t>(stream));
}

// Restricts the next calls to the launches whose bits `mask` sets (-1:
// all, the default): a probe times each launch alone.
void ssd_sm90_only(int mask) { g_only = mask; }

const char* ssd_sm90_error_string(int code) {
  if (code == kErrArgs) return "arguments outside the kernel's contract";
  if (code == kErrEncoder)
    return "the driver's cuTensorMapEncodeTiled is not available";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused a map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
