// Masked softmax attention on the GQA layout, forward and backward, for
// NVIDIA Hopper (sm_90a), in bf16: `wgmma` fed by TMA, with a producer warp
// and two consumer warpgroups.  The attention core of training and prefill.
//
// Replaces no Pallas kernel: the reference computes this core in XLA,
// `_gqa_scores_ctx` (src/repro/models/layers.py:117) up to
// FLASH_THRESHOLD keys and `flash_attention` (:130, a `lax.scan` over KV
// blocks inside a scan over Q blocks) above, with the mask of `_mask_fn`
// (:194: causal `ki <= qi`, the sliding window `ki > qi - win`, query
// positions offset by `q_pos0`).  q (B, Sq, KV, G, D), k (B, Sk, KV, D),
// v (B, Sk, KV, Dv) -> O (B, Sq, KV, G, Dv), scale 1/sqrt(D).
// flash_attention.cu holds the same functions on `mma.sync` (the `mma`
// route: fp32 inputs, and the yardstick); the wrapper's planner
// (kernels/flash_attention.py, `route`) sends every bf16 call here.
//
// Bound on this card: the operations, at the bf16 tensor cores' 989e12/s.
// A block of 128 query rows does 2 * 128 * 128 * (D + Dv) operations for
// each 128-key tile it reads (128 a byte of K and V at D 128), far above
// the 295 operations a byte where HBM would be the limit.  Only `wgmma`
// reaches the tensor cores' full rate, and it needs its operands in
// shared memory in its own swizzled layout, issued by a warpgroup that is
// not also computing addresses.  So:
//
// * Every tile is copied by TMA (`cp.async.bulk.tensor`, 4-D k and v, 5-D
//   q and dO, read where they lie: the strides of the wrapper's contract
//   are multiples of 16 bytes, and MLA's strided v needs no copy) into
//   64-column boxes with the 128-byte swizzle, completing on `mbarrier`s.
//   Columns past D (danube's D 120) and rows past Sq or Sk arrive as
//   zeros; keys past Sk are still masked (zeros are not -inf).
// * A block is one producer warpgroup (one warp issues the copies;
//   `setmaxnreg` gives its registers away) and two consumer warpgroups of
//   64 rows each, raised to 240 registers.  The producer keeps rings of
//   tiles in flight; a consumer releases a tile when the products that
//   read it are done.  The two consumer warpgroups take turns to issue
//   their products (named barriers 1 and 2), so that one's elementwise
//   work runs while the other's products do.
// * Forward: a block takes 128 query rows of one (b, kv head, query head).
//   Q is loaded once; K and V tiles of 128 keys stream through rings of
//   their own, 2 deep (at D 192 / Dv 128, MLA: 208 KB), since a K tile is
//   free once S = Q K^T is done and its V tile only a tile later.
//   S = Q K^T runs on `wgmma` with both operands in shared memory,
//   K-major; the online softmax keeps fp32 row statistics in registers in
//   the log2 domain, and runs while the previous tile's O += P V is in
//   flight; P is rounded to bf16 (as the reference rounds its
//   probabilities) and becomes the register A operand of O += P V, V read
//   MN-major through the descriptor (no transposing copy).  The key tiles
//   walked are kv_range's (the causal and window skip); only tiles that
//   the mask cuts are masked element by element; blocks run heaviest
//   first.  O in bf16 and the fp32 log-sum-exp (B, KV, G, Sq), as the
//   `mma` route writes them.
// * Backward: delta = rowsum(dO * O) (one warp a row).  dK and dV: a block
//   takes 128 keys of one (b, kv head) (64 a consumer warpgroup), keeps K
//   and V resident and dK and dV in fp32 registers (at D 128: 128 a
//   thread), while the producer streams Q and dO tiles of 64 rows (32 at
//   D 192), with their lse and delta, over every query head of the KV
//   head and every Q tile of q_range.  S^T = K Q^T and dP^T = V dO^T run
//   from shared memory; P^T and dS^T = P^T (dP^T - delta) in registers;
//   dV += P^T dO and dK += dS^T Q with the bf16 P^T and dS^T as the
//   register A operand.  dQ: a block of 128 rows of one (b, kv,
//   g) keeps Q and dO resident, streams 64-key tiles of K and V,
//   recomputes S and dP and accumulates dQ += dS K, the next tile's S and
//   dP issued with this tile's dQ product.  No floating atomics: two runs
//   give the same bits.
// * Measured on an H100 80GB HBM3 at 700 W (PERF.md;
//   scripts/flash_attention_probe.py times the choices above set the
//   other way): the turns of the two warpgroups pay; a third K / V stage
//   in the forward and, in dK/dV, dP^T awaited apart or dV issued before
//   dS^T is computed do not; dQ needs its third stage.  A loop issues its
//   products unconditionally (ptxas serialises `wgmma` issued on a
//   branch: the first tile and the last product are peeled off).  dK/dV
//   does not overlap the next tile's products with this tile's, which
//   needs 64 more registers than a consumer thread has (it spilled and
//   was slower), nor does dQ take 128-key tiles (it spilled too).
// * A row that no key may see gets O = 0 and lse = -inf.
//
// Contract (checked by the Python wrapper and again here): bf16, D and Dv
// multiples of 8, D <= 128 and Dv <= 128 or D <= 192 and Dv <= 128,
// 16-byte aligned pointers and strides, window >= 0 (0: none),
// B * KV * G <= 65535.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

typedef __nv_bfloat16 bf16;

// The blocks (kernels/flash_attention.py, SM90_BLOCKS, must match).
constexpr int kFwdBQ = 128;      // forward: query rows of a block
constexpr int kFwdBK = 128;      // forward: keys of a stage
constexpr int kFwdStages = 2;    // forward: K and V tiles in flight
constexpr int kBwdBK = 128;      // dK, dV: keys of a block
constexpr int kBwdBQ = 64;       // dK, dV: query rows of a stage
constexpr int kBwdBQWide = 32;   // the same at head dim 192
constexpr int kBwdStages = 3;    // dK, dV: Q and dO tiles in flight
constexpr int kDqBQ = 128;       // dQ: query rows of a block
constexpr int kDqBK = 64;        // dQ: keys of a stage
constexpr int kDqStages = 3;     // dQ: K and V tiles in flight
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kSmemMax = 232448;  // a block's opt-in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Error { kErrArgs = -1, kErrEncoder = -2, kErrEncode = -3 };

struct Params {
  const void* o;      // the forward's output (delta)
  const void* dout;   // its gradient (delta)
  void* out;          // O (forward)
  float* lse;         // (B, KV, G, Sq)
  float* delta;       // (B, KV, G, Sq), backward
  void* dq;
  void* dk;
  void* dv;
  long long do_sb, do_ss, do_sh, do_sg;   // dO's strides in elements
  int B, Sq, Sk, KV, G, D, Dv;
  int causal, window, q_pos0;
  float scale, scale_log2;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The key tiles [lo, hi) of `bk` keys that the `bq` query rows from q0
// visit: those holding a key that some row may see.  Mirrors
// kv_block_range in kernels/flash_attention.py.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int bq,
                                         int bk, int& lo, int& hi) {
  const long long p0 = static_cast<long long>(p.q_pos0) + q0;
  const long long p1 = static_cast<long long>(p.q_pos0) + min(q0 + bq, p.Sq) -
                       1;
  long long kmin = 0, kmax = p.Sk - 1;
  if (p.window > 0) kmin = max(kmin, p0 - p.window + 1);
  if (p.causal) kmax = min(kmax, p1);
  if (kmin > kmax) {
    lo = hi = 0;
    return;
  }
  lo = static_cast<int>(kmin / bk);
  hi = static_cast<int>(kmax / bk) + 1;
}

// The query tiles [lo, hi) of `bq` rows that visit the `bk` keys from k0
// (q_block_range).
__device__ __forceinline__ void q_range(const Params& p, int k0, int bk,
                                        int bq, int& lo, int& hi) {
  const long long k1 = min(k0 + bk, p.Sk) - 1;
  long long rmin = 0, rmax = p.Sq - 1;
  if (p.causal) rmin = max(rmin, static_cast<long long>(k0) - p.q_pos0);
  if (p.window > 0) rmax = min(rmax, k1 + p.window - 1 - p.q_pos0);
  if (rmin > rmax) {
    lo = hi = 0;
    return;
  }
  lo = static_cast<int>(rmin / bq);
  hi = static_cast<int>(rmax / bq) + 1;
}

// may query position `pos` see key `key`?  (_mask_fn, and keys past Sk)
__device__ __forceinline__ bool visible(const Params& p, long long pos,
                                        int key) {
  return key < p.Sk && (!p.causal || key <= pos) &&
         (p.window == 0 || key > pos - p.window);
}

// does any (row, key) pair of the rows at positions [pq0, pq1] and the nk
// keys from kb0 fall outside the mask (keys past Sk included)?  Only such
// tiles are masked element by element.
__device__ __forceinline__ bool edge_block(const Params& p, int kb0, int nk,
                                           long long pq0, long long pq1) {
  return kb0 + nk > p.Sk || (p.causal && kb0 + nk - 1 > pq0) ||
         (p.window > 0 && kb0 <= pq1 - p.window);
}

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

__device__ __forceinline__ void tma_5d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_u32(bar))
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

// D (64 x 32, fp32, 16 registers a thread) (+)= A (64 x 16) B (16 x 32),
// both K-major in shared memory; D is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32, 32 registers a thread) (+)= A (64 x 16) B (16 x 64),
// both K-major in shared memory; D is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32, 64 registers a thread) (+)= A (64 x 16) B (16 x 128),
// both K-major in shared memory; D is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32, 32 registers a thread) += A (64 x 16, bf16 in
// registers, the mma.m16n8k16 A layout a warp) B (16 x 64, MN-major in
// shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 128, fp32, 64 registers a thread) += A (64 x 16, bf16 in
// registers, the mma.m16n8k16 A layout a warp) B (16 x 128, MN-major in
// shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// D (64 x 192, fp32, 96 registers a thread) += A (64 x 16, bf16 in
// registers, the mma.m16n8k16 A layout a warp) B (16 x 192, MN-major in
// shared memory)
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95},"
      " {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "SS tile width");
  if constexpr (N == 32)
    wgmma_ss_n32(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 192, "RS tile width");
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n192(d, a, db);
}

// D (64 x N) (+)= A B over `steps` k16 steps, A (64 rows) and B (N rows)
// K-major in boxes of 64 columns, `abox` and `bbox` bytes apart
template <int N, int STEPS>
__device__ __forceinline__ void gemm_ss(float* d, uint32_t a, int abox,
                                        uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_ss<N>(d, sw128_desc(a + (kk >> 2) * abox + (kk & 3) * 32, 16, 1024),
                sw128_desc(b + (kk >> 2) * bbox + (kk & 3) * 32, 16, 1024),
                kk > 0);
}

// D (64 x N) += A B over STEPS k16 steps, A the bf16 fragments `a`, B
// MN-major: K rows of 64-column boxes `bbox` bytes apart
template <int N, int STEPS>
__device__ __forceinline__ void gemm_rs(float* d, const uint32_t (*a)[4],
                                        uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_rs<N>(d, a[kk], sw128_desc(b + kk * 2048, bbox, 1024));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The accumulator (64 x 16 STEPS, fp32) as the A fragments of the next
// product, rounded to bf16: k16 step kk is accumulator values 8 kk .. 8 kk + 7
template <int STEPS>
__device__ __forceinline__ void to_frags(const float* acc, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// a row's value over its quad (the 4 lanes that share it)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The two consumer warpgroups' turns to issue their products: named
// barriers 1 (warpgroup 0's turn) and 2 (warpgroup 1's), 256 threads each.
// `take_turn` waits for this warpgroup's turn, `pass_turn` gives the
// other its turn.
__device__ __forceinline__ void take_turn(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

// The online softmax of a forward score tile, in place: the mask where
// the tile is an edge tile, each row's new running max m (log2 units) and
// its correction factor alpha, P = exp2(S scale_log2 - m) and P's partial
// row sums ls (this thread's columns)
template <int BK>
__device__ __forceinline__ void softmax_tile(const Params& p, float* s,
                                             float* m, float* alpha,
                                             float* ls, bool edge,
                                             long long pos0, int kb0, int t) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (!visible(p, pos0 + ((i >> 1) & 1) * 8,
                   kb0 + 8 * (i >> 2) + 2 * t + (i & 1)))
        s[i] = -INFINITY;
  }
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c)
      mx = fmaxf(mx, fmaxf(s[4 * c + 2 * h], s[4 * c + 2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(mx) * p.scale_log2);
    base[h] = mn == -INFINITY ? 0.f : mn;
    alpha[h] = exp2f(m[h] - base[h]);
    m[h] = mn;
    ls[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = exp2f(fmaf(s[i], p.scale_log2, -base[h]));
    ls[h] += s[i];
  }
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// a consumer warp is done with a stage
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Accumulator element i of a consumer thread: row 16 wl + lane / 4 +
// 8 ((i >> 1) & 1) of its warpgroup's 64, column 8 (i >> 2) + 2 (lane % 4)
// + (i & 1).

// --- forward -----------------------------------------------------------------

template <int DP, int DVP>
struct FwdShape {
  static constexpr int kQBox = kFwdBQ * 128;      // a 64-column box of Q
  static constexpr int kKBox = kFwdBK * 128;      // of a K or V tile
  static constexpr int kQBytes = DP / 64 * kQBox;
  static constexpr int kKBytes = DP / 64 * kKBox;
  static constexpr int kVBytes = DVP / 64 * kKBox;
  static constexpr int kSmem =
      kQBytes + kFwdStages * (kKBytes + kVBytes) + 1024;
  static_assert(kSmem + 128 <= kSmemMax, "the forward's stages");
};

template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const Params p) {
  using S = FwdShape<DP, DVP>;
  // K and V tiles in rings of their own: a K tile is free once S = Q K^T
  // is done, its V tile only once P V is, a tile later
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full_k[kFwdStages], empty_k[kFwdStages];
  __shared__ __align__(8) uint64_t full_v[kFwdStages], empty_v[kFwdStages];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sK = sQ + S::kQBytes;
  unsigned char* sV = sK + kFwdStages * S::kKBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int bh = blockIdx.y;
  const int g = bh % p.G, kv = (bh / p.G) % p.KV, b = bh / (p.G * p.KV);
  const int q0 = qb * kFwdBQ;
  int lo, hi;
  kv_range(p, q0, kFwdBQ, kFwdBK, lo, hi);
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);   // the 8 consumer warps
      mbar_init(&empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    producer_regs();
    if (threadIdx.x == 0 && lo < hi) {
      mbar_expect_tx(&bar_q, S::kQBytes);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        tma_5d(sQ + c * S::kQBox, &qmap, &bar_q, 64 * c, q0, g, kv, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = lo; j < hi; ++j) {
        mbar_wait(&empty_k[stage], phase ^ 1);
        mbar_expect_tx(&full_k[stage], S::kKBytes);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_4d(sK + stage * S::kKBytes + c * S::kKBox, &kmap,
                 &full_k[stage], 64 * c, j * kFwdBK, kv, b);
        mbar_wait(&empty_v[stage], phase ^ 1);
        mbar_expect_tx(&full_v[stage], S::kVBytes);
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          tma_4d(sV + stage * S::kVBytes + c * S::kKBox, &vmap,
                 &full_v[stage], 64 * c, j * kFwdBK, kv, b);
        if (++stage == kFwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  consumer_regs();
  const int wg = (warp >> 2) - 1;                 // rows 64 wg .. 64 wg + 63
  const int wl = warp & 3, t = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * wl + (lane >> 2);   // and r0 + 8
  const long long pos0 = static_cast<long long>(p.q_pos0) + r0;
  const long long pq0 = static_cast<long long>(p.q_pos0) + q0 + 64 * wg;
  const long long pq1 = pq0 + 63;
  const uint32_t qa = smem_u32(sQ) + wg * 64 * 128;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // log2 units
  float o[DVP / 2];
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) o[i] = 0.f;
  // The two warpgroups take turns to issue their products (warpgroup 0
  // first), so that one's softmax runs while the other's products do;
  // within a warpgroup the softmax of tile j runs while tile j - 1's P V
  // is in flight (P of j - 1 kept in `pa`).  The first tile and the last
  // P V are peeled off, so that the loop issues its products
  // unconditionally (ptxas serialises `wgmma` issued on a branch).
  if (lo < hi) {
    mbar_wait(&bar_q, 0);
    if (wg == 1) pass_turn(1);
    uint32_t pa[kFwdBK / 16][4];
    float s[kFwdBK / 2], alpha[2], ls[2];
    int stage = 0, prev = 0;        // prev: the stage of P's V tile
    uint32_t phase = 0, pphase = 0;
    mbar_wait(&full_k[0], 0);
    fence_regs<kFwdBK / 2>(s);
    take_turn(wg);
    wgmma_fence();
    gemm_ss<kFwdBK, DP / 16>(s, qa, S::kQBox, smem_u32(sK), S::kKBox);
    wgmma_commit();
    if (wg == 0 || lo + 1 < hi) pass_turn(wg);
    wgmma_wait<0>();
    fence_regs<kFwdBK / 2>(s);
    release(&empty_k[0], lane);
    softmax_tile<kFwdBK>(p, s, m, alpha, ls,
                         edge_block(p, lo * kFwdBK, kFwdBK, pq0, pq1), pos0,
                         lo * kFwdBK, t);
    l[0] = ls[0];
    l[1] = ls[1];
    to_frags<kFwdBK / 16>(s, pa);
    for (int j = lo + 1; j < hi; ++j) {
      prev = stage;
      pphase = phase;
      if (++stage == kFwdStages) {
        stage = 0;
        phase ^= 1;
      }
      mbar_wait(&full_k[stage], phase);
      mbar_wait(&full_v[prev], pphase);
      fence_regs<kFwdBK / 2>(s);
      fence_regs<DVP / 2>(o);
      take_turn(wg);
      wgmma_fence();
      gemm_ss<kFwdBK, DP / 16>(s, qa, S::kQBox,
                               smem_u32(sK + stage * S::kKBytes), S::kKBox);
      wgmma_commit();
      gemm_rs<DVP, kFwdBK / 16>(o, pa, smem_u32(sV + prev * S::kVBytes),
                                S::kKBox);
      wgmma_commit();
      if (wg == 0 || j + 1 < hi) pass_turn(wg);
      wgmma_wait<1>();
      fence_regs<kFwdBK / 2>(s);
      release(&empty_k[stage], lane);
      softmax_tile<kFwdBK>(p, s, m, alpha, ls,
                           edge_block(p, j * kFwdBK, kFwdBK, pq0, pq1), pos0,
                           j * kFwdBK, t);
      // tile j - 1's P V is done: its V tile is free, O may be rescaled
      wgmma_wait<0>();
      fence_regs<DVP / 2>(o);
      release(&empty_v[prev], lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = l[h] * alpha[h] + ls[h];
#pragma unroll
        for (int c = 0; c < DVP / 8; ++c) {
          o[4 * c + 2 * h] *= alpha[h];
          o[4 * c + 2 * h + 1] *= alpha[h];
        }
      }
      to_frags<kFwdBK / 16>(s, pa);
    }
    mbar_wait(&full_v[stage], phase);
    fence_regs<DVP / 2>(o);
    wgmma_fence();
    gemm_rs<DVP, kFwdBK / 16>(o, pa, smem_u32(sV + stage * S::kVBytes),
                              S::kKBox);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DVP / 2>(o);
    release(&empty_v[stage], lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    const int row = r0 + 8 * h;
    if (row >= p.Sq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    bf16* out = static_cast<bf16*>(p.out) +
                ((static_cast<long long>(b) * p.Sq + row) * p.KV + kv) * p.G *
                    p.Dv +
                static_cast<long long>(g) * p.Dv;
#pragma unroll
    for (int c = 0; c < DVP / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < p.Dv)
        store2(out + col, o[4 * c + 2 * h] * inv, o[4 * c + 2 * h + 1] * inv);
    }
    if (t == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + row] =
          sum > 0.f ? (m[h] + log2f(sum)) * kLn2 : -INFINITY;
  }
}

// --- backward ----------------------------------------------------------------

// delta = rowsum(dO * O) in fp32, one warp a row (b, s, kv, g)
__global__ void __launch_bounds__(128) delta_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (r >= static_cast<long long>(p.B) * p.Sq * p.KV * p.G) return;
  const int g = static_cast<int>(r % p.G);
  const int kv = static_cast<int>((r / p.G) % p.KV);
  const int s = static_cast<int>((r / (p.G * p.KV)) % p.Sq);
  const int b = static_cast<int>(r / (static_cast<long long>(p.G) * p.KV *
                                      p.Sq));
  const bf16* o = static_cast<const bf16*>(p.o) + r * p.Dv;
  const bf16* d = static_cast<const bf16*>(p.dout) + b * p.do_sb +
                  s * p.do_ss + kv * p.do_sh + g * p.do_sg;
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32)
    acc = fmaf(__bfloat162float(d[c]), __bfloat162float(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0)
    p.delta[((static_cast<long long>(b) * p.KV + kv) * p.G + g) * p.Sq + s] =
        acc;
}

template <int DP, int DVP>
struct DkdvShape {
  static constexpr int kBQ = DP > 128 ? kBwdBQWide : kBwdBQ;
  static constexpr int kKBox = kBwdBK * 128;      // a 64-column box of K, V
  static constexpr int kKBytes = DP / 64 * kKBox;
  static constexpr int kVBytes = DVP / 64 * kKBox;
  static constexpr int kQBox = kBQ * 128;         // of a Q or dO tile
  static constexpr int kQBytes = DP / 64 * kQBox;
  static constexpr int kOBytes = DVP / 64 * kQBox;
  static constexpr int kStage = kQBytes + kOBytes;
  static constexpr int kSmem = kKBytes + kVBytes + kBwdStages * kStage + 1024;
  static_assert(kSmem + 2048 <= kSmemMax, "the dK/dV stages");
};

// dK and dV of 128 keys of one (b, kv head), over every Q tile that sees
// them and every query head of the KV head.  Consumer warpgroup wg owns
// keys 64 wg .. 64 wg + 63; the producer warp stages Q, dO and each row's
// lse (log2 units; +inf for rows past Sq or seeing no key, so P = 0) and
// delta.
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap, const Params p) {
  using S = DkdvShape<DP, DVP>;
  constexpr int BQ = S::kBQ;
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t full[kBwdStages];
  __shared__ __align__(8) uint64_t empty[kBwdStages];
  __shared__ float s_lse[kBwdStages][BQ];
  __shared__ float s_del[kBwdStages][BQ];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + S::kKBytes;
  unsigned char* sQO = sV + S::kVBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv = blockIdx.y % p.KV, b = blockIdx.y / p.KV;
  const int k0 = blockIdx.x * kBwdBK;
  int lo, hi;
  q_range(p, k0, kBwdBK, BQ, lo, hi);
  const int nq = hi - lo, n_it = p.G * nq;
  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's lanes
      mbar_init(&empty[s], 8);   // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    producer_regs();
    if (warp == 0 && n_it > 0) {
      if (lane == 0) {
        mbar_expect_tx(&bar_kv, S::kKBytes + S::kVBytes);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_4d(sK + c * S::kKBox, &kmap, &bar_kv, 64 * c, k0, kv, b);
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          tma_4d(sV + c * S::kKBox, &vmap, &bar_kv, 64 * c, k0, kv, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_it; ++it) {
        const int gi = it / nq, q0 = (lo + it % nq) * BQ;
        mbar_wait(&empty[stage], phase ^ 1);
        const long long base =
            ((static_cast<long long>(b) * p.KV + kv) * p.G + gi) * p.Sq;
        for (int r = lane; r < BQ; r += 32) {
          const int row = q0 + r;
          float lse2 = INFINITY, dl = 0.f;
          if (row < p.Sq) {
            const float x = p.lse[base + row];
            lse2 = x == -INFINITY ? INFINITY : x * kLog2e;
            dl = p.delta[base + row];
          }
          s_lse[stage][r] = lse2;
          s_del[stage][r] = dl;
        }
        uint64_t* bar = &full[stage];
        if (lane == 0) {
          mbar_expect_tx(bar, S::kStage);
          unsigned char* st = sQO + stage * S::kStage;
#pragma unroll
          for (int c = 0; c < DP / 64; ++c)
            tma_5d(st + c * S::kQBox, &qmap, bar, 64 * c, q0, gi, kv, b);
#pragma unroll
          for (int c = 0; c < DVP / 64; ++c)
            tma_5d(st + S::kQBytes + c * S::kQBox, &domap, bar, 64 * c, q0,
                   gi, kv, b);
        } else {
          mbar_arrive(bar);
        }
        if (++stage == kBwdStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  consumer_regs();
  const int wg = (warp >> 2) - 1;
  const int wl = warp & 3, t = lane & 3;
  const int kr = k0 + 64 * wg + 16 * wl + (lane >> 2);   // keys kr, kr + 8
  const int kw0 = k0 + 64 * wg;                          // the warpgroup's
  const uint32_t ka = smem_u32(sK) + wg * 64 * 128;
  const uint32_t va = smem_u32(sV) + wg * 64 * 128;
  float dk[DP / 2], dv[DVP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DVP / 2; ++i) dv[i] = 0.f;
  // Each tile: S^T and dP^T; P^T and dS^T; dV += P^T dO and dK += dS^T Q.
  // The two warpgroups take turns to issue each of their products, so
  // that one's elementwise work runs while the other's products do.
  if (n_it > 0) {
    mbar_wait(&bar_kv, 0);
    if (wg == 1) pass_turn(1);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_it; ++it) {
    mbar_wait(&full[stage], phase);
    const uint32_t qs = smem_u32(sQO + stage * S::kStage);
    const uint32_t os = qs + S::kQBytes;
    float st[BQ / 2], dpt[BQ / 2];
    fence_regs<BQ / 2>(st);
    fence_regs<BQ / 2>(dpt);
    take_turn(wg);
    wgmma_fence();
    gemm_ss<BQ, DP / 16>(st, ka, S::kKBox, qs, S::kQBox);
    gemm_ss<BQ, DVP / 16>(dpt, va, S::kKBox, os, S::kQBox);
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait<0>();
    fence_regs<BQ / 2>(st);
    fence_regs<BQ / 2>(dpt);
    const int q0 = (lo + it % nq) * BQ;
    const long long pq0 = static_cast<long long>(p.q_pos0) + q0;
    const bool edge = edge_block(p, kw0, 64, pq0, pq0 + BQ - 1);
    const float* lse2 = s_lse[stage];
    const float* dl = s_del[stage];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);   // query row of the tile
      const bool ok = !edge || visible(p, pq0 + c, kr + ((i >> 1) & 1) * 8);
      const float pt = ok ? exp2f(fmaf(st[i], p.scale_log2, -lse2[c])) : 0.f;
      st[i] = pt;
      dpt[i] = pt * (dpt[i] - dl[c]);
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_frags<BQ / 16>(st, pa);
    to_frags<BQ / 16>(dpt, da);
    fence_regs<DVP / 2>(dv);
    fence_regs<DP / 2>(dk);
    take_turn(wg);
    wgmma_fence();
    gemm_rs<DVP, BQ / 16>(dv, pa, os, S::kQBox);
    gemm_rs<DP, BQ / 16>(dk, da, qs, S::kQBox);
    wgmma_commit();
    if (wg == 0 || it + 1 < n_it) pass_turn(wg);
    wgmma_wait<0>();
    fence_regs<DVP / 2>(dv);
    fence_regs<DP / 2>(dk);
    release(&empty[stage], lane);
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr + 8 * h;
    if (key >= p.Sk) continue;
    const long long row = (static_cast<long long>(b) * p.Sk + key) * p.KV + kv;
    bf16* dkr = static_cast<bf16*>(p.dk) + row * p.D;
    bf16* dvr = static_cast<bf16*>(p.dv) + row * p.Dv;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < p.D)
        store2(dkr + col, dk[4 * c + 2 * h] * p.scale,
               dk[4 * c + 2 * h + 1] * p.scale);
    }
#pragma unroll
    for (int c = 0; c < DVP / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < p.Dv) store2(dvr + col, dv[4 * c + 2 * h], dv[4 * c + 2 * h + 1]);
    }
  }
}

template <int DP, int DVP>
struct DqShape {
  static constexpr int kQBox = kDqBQ * 128;       // a 64-column box of Q, dO
  static constexpr int kQBytes = DP / 64 * kQBox;
  static constexpr int kOBytes = DVP / 64 * kQBox;
  static constexpr int kKBox = kDqBK * 128;       // of a K or V tile
  static constexpr int kKBytes = DP / 64 * kKBox;
  static constexpr int kVBytes = DVP / 64 * kKBox;
  static constexpr int kStage = kKBytes + kVBytes;
  static constexpr int kSmem = kQBytes + kOBytes + kDqStages * kStage + 1024;
  static_assert(kSmem + 64 <= kSmemMax, "the dQ stages");
};

// A dQ tile's dS = P (dP - delta), P = exp(S - lse), in place of dP: the
// thread's rows (positions pos0, pos0 + 8; its warpgroup's [pq0, pq1])
// against the kDqBK keys from kb0
__device__ __forceinline__ void dq_tile(const Params& p, const float* s,
                                        float* dp, const float* lse2,
                                        const float* dl, int kb0,
                                        long long pos0, long long pq0,
                                        long long pq1, int t) {
  const bool edge = edge_block(p, kb0, kDqBK, pq0, pq1);
#pragma unroll
  for (int i = 0; i < kDqBK / 2; ++i) {
    const int h = (i >> 1) & 1;
    const bool ok =
        !edge || visible(p, pos0 + 8 * h, kb0 + 8 * (i >> 2) + 2 * t + (i & 1));
    const float pv = ok ? exp2f(fmaf(s[i], p.scale_log2, -lse2[h])) : 0.f;
    dp[i] = pv * (dp[i] - dl[h]);
  }
}

// dQ of 128 rows of one (b, kv, g), over the key tiles they see: S and dP
// recomputed, dQ += dS K.
template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap domap, const Params p) {
  using S = DqShape<DP, DVP>;
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full[kDqStages];
  __shared__ __align__(8) uint64_t empty[kDqStages];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sO = sQ + S::kQBytes;
  unsigned char* sKV = sO + S::kOBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int g = bh % p.G, kv = (bh / p.G) % p.KV, b = bh / (p.G * p.KV);
  const int q0 = qb * kDqBQ;
  int lo, hi;
  kv_range(p, q0, kDqBQ, kDqBK, lo, hi);
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    producer_regs();
    if (threadIdx.x == 0 && lo < hi) {
      mbar_expect_tx(&bar_q, S::kQBytes + S::kOBytes);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        tma_5d(sQ + c * S::kQBox, &qmap, &bar_q, 64 * c, q0, g, kv, b);
#pragma unroll
      for (int c = 0; c < DVP / 64; ++c)
        tma_5d(sO + c * S::kQBox, &domap, &bar_q, 64 * c, q0, g, kv, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = lo; j < hi; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint64_t* bar = &full[stage];
        mbar_expect_tx(bar, S::kStage);
        unsigned char* st = sKV + stage * S::kStage;
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          tma_4d(st + c * S::kKBox, &kmap, bar, 64 * c, j * kDqBK, kv, b);
#pragma unroll
        for (int c = 0; c < DVP / 64; ++c)
          tma_4d(st + S::kKBytes + c * S::kKBox, &vmap, bar, 64 * c,
                 j * kDqBK, kv, b);
        if (++stage == kDqStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  consumer_regs();
  const int wg = (warp >> 2) - 1;
  const int wl = warp & 3, t = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * wl + (lane >> 2);
  const long long pos0 = static_cast<long long>(p.q_pos0) + r0;
  const long long pq0 = static_cast<long long>(p.q_pos0) + q0 + 64 * wg;
  const long long pq1 = pq0 + 63;
  const uint32_t qa = smem_u32(sQ) + wg * 64 * 128;
  const uint32_t oa = smem_u32(sO) + wg * 64 * 128;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse2[h] = INFINITY;
    dl[h] = 0.f;
    if (row < p.Sq) {
      const float x = p.lse[static_cast<long long>(bh) * p.Sq + row];
      lse2[h] = x == -INFINITY ? INFINITY : x * kLog2e;
      dl[h] = p.delta[static_cast<long long>(bh) * p.Sq + row];
    }
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  // Software-pipelined: key tile j's S and dP are issued with
  // tile j - 1's dQ product, and its elementwise work runs while that is
  // in flight (tile j - 1's bf16 dS kept in da).
  if (lo < hi) {
    mbar_wait(&bar_q, 0);
    if (wg == 1) pass_turn(1);
    float s[kDqBK / 2], dp[kDqBK / 2];
    uint32_t da[kDqBK / 16][4];
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(&full[0], 0);
    fence_regs<kDqBK / 2>(s);
    fence_regs<kDqBK / 2>(dp);
    take_turn(wg);
    wgmma_fence();
    gemm_ss<kDqBK, DP / 16>(s, qa, S::kQBox, smem_u32(sKV), S::kKBox);
    gemm_ss<kDqBK, DVP / 16>(dp, oa, S::kQBox, smem_u32(sKV) + S::kKBytes,
                             S::kKBox);
    wgmma_commit();
    if (wg == 0 || lo + 1 < hi) pass_turn(wg);
    wgmma_wait<0>();
    fence_regs<kDqBK / 2>(s);
    fence_regs<kDqBK / 2>(dp);
    dq_tile(p, s, dp, lse2, dl, lo * kDqBK, pos0, pq0, pq1, t);
    to_frags<kDqBK / 16>(dp, da);
    for (int j = lo + 1; j < hi; ++j) {
      const int prev = stage;
      if (++stage == kDqStages) {
        stage = 0;
        phase ^= 1;
      }
      const uint32_t kp = smem_u32(sKV + prev * S::kStage);
      const uint32_t ks = smem_u32(sKV + stage * S::kStage);
      fence_regs<kDqBK / 2>(s);
      fence_regs<kDqBK / 2>(dp);
      fence_regs<DP / 2>(dq);
      mbar_wait(&full[stage], phase);
      take_turn(wg);
      wgmma_fence();
      gemm_ss<kDqBK, DP / 16>(s, qa, S::kQBox, ks, S::kKBox);
      gemm_ss<kDqBK, DVP / 16>(dp, oa, S::kQBox, ks + S::kKBytes, S::kKBox);
      wgmma_commit();
      gemm_rs<DP, kDqBK / 16>(dq, da, kp, S::kKBox);
      wgmma_commit();
      if (wg == 0 || j + 1 < hi) pass_turn(wg);
      wgmma_wait<1>();
      fence_regs<kDqBK / 2>(s);
      fence_regs<kDqBK / 2>(dp);
      dq_tile(p, s, dp, lse2, dl, j * kDqBK, pos0, pq0, pq1, t);
      wgmma_wait<0>();
      fence_regs<DP / 2>(dq);
      release(&empty[prev], lane);
      to_frags<kDqBK / 16>(dp, da);
    }
    fence_regs<DP / 2>(dq);
    wgmma_fence();
    gemm_rs<DP, kDqBK / 16>(dq, da, smem_u32(sKV + stage * S::kStage),
                            S::kKBox);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dq);
    release(&empty[stage], lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= p.Sq) continue;
    bf16* out = static_cast<bf16*>(p.dq) +
                ((static_cast<long long>(b) * p.Sq + row) * p.KV + kv) * p.G *
                    p.D +
                static_cast<long long>(g) * p.D;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < p.D)
        store2(out + col, dq[4 * c + 2 * h] * p.scale,
               dq[4 * c + 2 * h + 1] * p.scale);
    }
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

// A bf16 tensor map of `rank` dimensions (innermost first: the head dim,
// then rows, then heads and batch), `strides` in elements for dims 1..;
// boxes of 64 columns x `rows` rows with the 128-byte swizzle, filled with
// zeros past the tensor.  A dim of size 1 (stride 0 from the wrapper) gets
// the largest stride: its coordinate is always 0.
int encode(CUtensorMap* map, int rank, const void* base, const int* dims,
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

// The maps of q (or dO: strides s = batch, row, kv head, query head) and
// of k (or v: batch, row, head), as (D, Sq, G, KV, B) and (D, Sk, KV, B).
int encode_q(CUtensorMap* map, const void* base, const long long* s, int d,
             const Params& p, int rows) {
  const int dims[5] = {d, p.Sq, p.G, p.KV, p.B};
  const long long st[4] = {s[1], s[3], s[2], s[0]};
  return encode(map, 5, base, dims, st, rows);
}

int encode_k(CUtensorMap* map, const void* base, const long long* s, int d,
             const Params& p, int rows) {
  const int dims[4] = {d, p.Sk, p.KV, p.B};
  const long long st[3] = {s[1], s[2], s[0]};
  return encode(map, 4, base, dims, st, rows);
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
  const void* q;
  const void* k;
  const void* v;
  const long long* strides;   // q (4), k (3), v (3), dO (4)
};

template <int DP, int DVP>
int run_fwd(const Inputs& in, const Params& p, cudaStream_t st) {
  using S = FwdShape<DP, DVP>;
  CUtensorMap qm, km, vm;
  int e = encode_q(&qm, in.q, in.strides, p.D, p, kFwdBQ);
  if (!e) e = encode_k(&km, in.k, in.strides + 4, p.D, p, kFwdBK);
  if (!e) e = encode_k(&vm, in.v, in.strides + 7, p.Dv, p, kFwdBK);
  if (e) return e;
  return launch(fwd_kernel<DP, DVP>,
                dim3(cdiv(p.Sq, kFwdBQ), p.B * p.KV * p.G), kThreads,
                S::kSmem, st, qm, km, vm, p);
}

template <int DP, int DVP>
int run_bwd(const Inputs& in, const void* dout, const Params& p,
            cudaStream_t st) {
  using K = DkdvShape<DP, DVP>;
  using Q = DqShape<DP, DVP>;
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.KV * p.G;
  int e = launch(delta_kernel, dim3(static_cast<unsigned>((rows + 3) / 4)),
                 128, 0, st, p);
  if (e) return e;
  CUtensorMap qm, km, vm, om;
  e = encode_q(&qm, in.q, in.strides, p.D, p, K::kBQ);
  if (!e) e = encode_k(&km, in.k, in.strides + 4, p.D, p, kBwdBK);
  if (!e) e = encode_k(&vm, in.v, in.strides + 7, p.Dv, p, kBwdBK);
  if (!e) e = encode_q(&om, dout, in.strides + 10, p.Dv, p, K::kBQ);
  if (e) return e;
  e = launch(dkdv_kernel<DP, DVP>, dim3(cdiv(p.Sk, kBwdBK), p.B * p.KV),
             kThreads, K::kSmem, st, qm, km, vm, om, p);
  if (e) return e;
  e = encode_q(&qm, in.q, in.strides, p.D, p, kDqBQ);
  if (!e) e = encode_k(&km, in.k, in.strides + 4, p.D, p, kDqBK);
  if (!e) e = encode_k(&vm, in.v, in.strides + 7, p.Dv, p, kDqBK);
  if (!e) e = encode_q(&om, dout, in.strides + 10, p.Dv, p, kDqBQ);
  if (e) return e;
  return launch(dq_kernel<DP, DVP>,
                dim3(cdiv(p.Sq, kDqBQ), p.B * p.KV * p.G), kThreads, Q::kSmem,
                st, qm, km, vm, om, p);
}

// the padded head dims: 64 or 128 for both, or 192 with Dv <= 128 (MLA)
int padded(int D, int Dv) {
  if (D <= 64 && Dv <= 64) return 64;
  if (D <= 128 && Dv <= 128) return 128;
  if (D <= 192 && Dv <= 128) return 192;
  return 0;
}

int dispatch(bool fwd, const Inputs& in, const void* dout, const Params& p,
             cudaStream_t st) {
  switch (padded(p.D, p.Dv)) {
    case 64:
      return fwd ? run_fwd<64, 64>(in, p, st) : run_bwd<64, 64>(in, dout, p, st);
    case 128:
      return fwd ? run_fwd<128, 128>(in, p, st)
                 : run_bwd<128, 128>(in, dout, p, st);
    case 192:
      return fwd ? run_fwd<192, 128>(in, p, st)
                 : run_bwd<192, 128>(in, dout, p, st);
    default:
      return kErrArgs;
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Fills p from the arguments; false when they break the contract.
bool setup(Params& p, const Inputs& in, int B, int Sq, int Sk, int KV, int G,
           int D, int Dv, int causal, int window, int q_pos0, bool bwd) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || G < 1 || D < 1 || Dv < 1 ||
      window < 0 || padded(D, Dv) == 0 || D % 8 || Dv % 8 ||
      static_cast<long long>(B) * KV * G > 65535)
    return false;
  for (int i = 0; i < (bwd ? 14 : 10); ++i)
    if (in.strides[i] < 0 || in.strides[i] % 8) return false;
  if (!aligned16(in.q) || !aligned16(in.k) || !aligned16(in.v)) return false;
  p.do_sb = bwd ? in.strides[10] : 0;
  p.do_ss = bwd ? in.strides[11] : 0;
  p.do_sh = bwd ? in.strides[12] : 0;
  p.do_sg = bwd ? in.strides[13] : 0;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.KV = KV;
  p.G = G;
  p.D = D;
  p.Dv = Dv;
  p.causal = causal != 0;
  p.window = window;
  p.q_pos0 = q_pos0;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  p.scale_log2 = p.scale * kLog2e;
  return true;
}

}  // namespace

extern "C" {

// Forward on `stream`: bf16 q, k, v as in the header, out (B, Sq, KV, G,
// Dv) contiguous bf16, lse (B, KV, G, Sq) fp32.  One launch.  Returns 0, a
// CUDA error code, or a negative code of its own.
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* strides,
                             int B, int Sq, int Sk, int KV, int G, int D,
                             int Dv, int causal, int window, int q_pos0,
                             void* stream) {
  Params p = {};
  p.out = out;
  p.lse = static_cast<float*>(lse);
  const Inputs in = {q, k, v, strides};
  if (!setup(p, in, B, Sq, Sk, KV, G, D, Dv, causal, window, q_pos0, false) ||
      !aligned16(out))
    return kErrArgs;
  return dispatch(true, in, nullptr, p, static_cast<cudaStream_t>(stream));
}

// Backward on `stream`: from bf16 q, k, v, the forward's out and lse and
// the gradient dout (strided like q), dq (B, Sq, KV, G, D), dk (B, Sk, KV,
// D) and dv (B, Sk, KV, Dv), contiguous; `delta` is (B, KV, G, Sq) fp32
// scratch.  Three launches: delta, dK and dV, dQ.
int flash_attention_sm90_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq, void* dk,
                             void* dv, const long long* strides, int B,
                             int Sq, int Sk, int KV, int G, int D, int Dv,
                             int causal, int window, int q_pos0,
                             void* stream) {
  Params p = {};
  p.o = out;
  p.dout = dout;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  const Inputs in = {q, k, v, strides};
  if (!setup(p, in, B, Sq, Sk, KV, G, D, Dv, causal, window, q_pos0, true) ||
      !aligned16(out) || !aligned16(dout) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv))
    return kErrArgs;
  return dispatch(false, in, dout, p, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_sm90_error_string(int code) {
  if (code == kErrArgs) return "arguments outside the kernel's contract";
  if (code == kErrEncoder)
    return "the driver's cuTensorMapEncodeTiled is not available";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused a map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
