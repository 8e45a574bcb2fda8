// Grouped expert GEMM (`ragged_dot`) for NVIDIA Hopper (sm_90a), redesigned
// for the shapes expert-parallel MoE launches it with: `wgmma` fed by TMA
// over a persistent grid for training buffers, and a weight-streaming route
// for decode buffers.
//
// Replaces `lax.ragged_dot` in src/repro/models/moe_ep.py:114-116 (XLA
// compute, not a Pallas kernel) and the two products its transpose rule
// gives, for bf16 operands with K and N multiples of 8 and 16-byte aligned
// rows (the strides a TMA tensor map needs).  With x (M, K), w (G, K, N) and
// group_sizes (G,) int32, the rows of x are cut into consecutive groups,
// group g owning group_sizes[g] rows:
//
//     fwd:  y[rows of g]  = x[rows of g] @ w[g]              (M, N)
//     dx:   dx[rows of g] = dy[rows of g] @ w[g]^T           (M, K)
//     dw:   dw[g]         = x[rows of g]^T @ dy[rows of g]   (G, K, N)
//
// Rows past sum(group_sizes) come out zero in y and dx, the dw of an empty
// group is written as zeros, negative sizes count as 0 and a sum past M is
// cut at M: every output element is written, so the wrapper allocates with
// torch.empty.  fp32 accumulation, the output rounded once to bf16.  fp32
// and unaligned operands stay on grouped_gemm.cu (the `tile` route); the
// wrapper's planner (kernels/grouped_gemm.py, `route`) picks the route.
//
// Bound on this card.  Training (olmoe: 65,536 hits in a buffer of 81,920
// rows, ~1,000 rows a group): 2*hits*K*N operations at the bf16 tensor
// cores' 989e12/s.  Decode (a few dozen rows, a row or two a group): the
// touched experts' weights, read once, at 3.35e12 B/s.
//
// Design (each choice measured on an H100 80GB HBM3 at 700 W; PERF.md).
// * Group offsets on the device, no host sync: each block scans the group
//   sizes once into shared memory (one warp: row offsets, and each group's
//   first row tile), then walks the work items blockIdx.x + i * gridDim.x
//   up to the count it computed.  The grid is one block an SM.  Items run
//   group by group, so the items in flight share a group's weights in L2;
//   within a group (fwd, dx) column tile by column tile, the group's row
//   tiles side by side (deepseek-v3's ~130-row groups: their two row tiles
//   read each weight tile once from HBM, 10-17% faster than row-major).
//   The work list is bounded on the host by ceil(M / BM) + G row-tile slots
//   times the column tiles; there is no global work counter, so nothing
//   needs resetting and a captured graph replays as it is.  Items past the
//   groups' tiles (fwd, dx: the rows past the sum) and an empty group's dw
//   tiles have no reduction and store zeros.
// * `wgmma` route (training buffers, every dx and dw).  An item is a
//   128 x 256 output tile.  One producer thread keeps a ring of 3 stages of
//   64-deep K tiles (48 KB a stage) in flight by TMA with the 128-byte
//   swizzle, completing on `mbarrier`s; two consumer warpgroups each run
//   `wgmma.m64n256k16` (bf16 in, fp32 accumulate) on 64 of the rows, one
//   batch in flight, and release a stage when the batch that read it is
//   done.  `setmaxnreg` moves registers from the producer warpgroup to the
//   consumers.  128 x 256 tiles stage (1/128 + 1/256) bytes of operand an
//   operation; 128 x 128 tiles were 7-14% slower.
// * The epilogue was the bottleneck: bf16 pairs stored from registers (8
//   rows of 16 bytes a warp instruction) cost 0.13-0.27 ms of a 0.51-0.65 ms
//   product at olmoe's training buffer.  Each warpgroup now stages its
//   64 x 256 outputs in shared memory as the output's 64 x 64 boxes with the
//   128-byte swizzle (no bank conflict), and one thread stores them by TMA
//   and moves on: the copy drains while the next item's loads and products
//   run.  The boxes clip at M, K and N.  A tile whose rows run past its
//   group's end is copied row by row instead (16 bytes a thread, coalesced),
//   the next group's rows left alone.
// * No transposing copy: `wgmma` reads bf16 operands K-major or MN-major
//   through the descriptor.  fwd reads x K-major and w[g] MN-major from a
//   3-D tensor map over (G, K, N); dx reads dy K-major and w[g]^T K-major as
//   w lies; dw reads x^T MN-major and dy MN-major from the row-major
//   buffers.  The 3-D map keeps a box from reading past w[g]: rows past K
//   are zeros, not the next expert's.
// * Ragged rows (fwd, dx): a box starts at the group's row row_lo + j*128,
//   at element granularity.  It may run into the next group's rows: those
//   products are computed and never stored.  TMA fills rows past M, and K or
//   N past the tensor, with zeros.
// * Ragged reduction (dw): a group's K steps start at its first row, so only
//   its last step can hold another group's rows.  On that step the
//   consumers zero the out-of-group rows of both operands in shared memory
//   (a row of a 128-byte-swizzled box is one 128-byte line, whatever the
//   swizzle), then `fence.proxy.async.shared::cta` and a barrier of the two
//   warpgroups before `wgmma` reads them.  Zeroing both operands keeps a
//   non-finite value in a neighbouring group out of the sum.
// * `stream` route (fwd at decode buffers, M up to the wrapper's
//   threshold).  The product reads each touched expert's weights once, so
//   the design spreads those bytes evenly over the SMs and keeps 64-128 KB
//   in flight on each: a unit is (8 rows of a group, 32 or 64 output
//   columns), the whole reduction streamed by TMA in stages 128 deep
//   through a ring of 8, one block an SM.  The operands are swapped on
//   `mma.sync.m16n8k16`: the weight strip's columns on the MMA's rows, the
//   group's 8 rows on its n, the 8 k16 steps of a stage split over 4
//   consumer warps and summed in shared memory at the unit's end.  Units
//   of 32 columns keep olmoe's 28 touched experts at 896 units, 6.8 an SM,
//   close to whole waves (64 columns: 3.4 an SM, 18% slower); but they read
//   w in 64-byte runs, and where every block gets 6 or more 64-column units
//   (deepseek-v3, jamba) the 128-byte runs of 64 columns are 4-14% faster.
//   The blocks make that choice from the unit count they compute.  Narrow
//   strips and not a K split, so there are no partial sums to combine.  A
//   group with more than 8 rows takes a unit a chunk of 8; a chunk's 8-row
//   box may run into the next group, whose outputs are not stored.  dx at
//   decode shapes stays on the wgmma route, which was faster at each.
// * Launch: on the caller's stream, nothing allocated (the wrapper gives
//   the output), the tensor maps built on the host from the pointers (no
//   device read), cudaGetLastError() returned.  The driver's tensor-map
//   encoder is reached through cudaGetDriverEntryPoint (no -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };
enum Route { kWgmma = 0, kStream = 1 };

constexpr int kMaxGroups = 1024;
// the wgmma route: an item is a kBM x kBN output tile, a stage kBK deep
constexpr int kBM = 128;
constexpr int kBN = 256;        // 128 or 256
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kWgThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kBox = 8192;        // one 64 x 64 bf16 box (128-byte rows)
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBytes = 64 * kBN * 2;   // a warpgroup's 64 output rows
constexpr int kWgSmem = kStages * kStageBytes + 2 * kOutBytes + 1024;
// the stream route: a unit is kSRows rows of a group x kSCols or
// 2 * kSCols columns (one or two boxes of w a stage), a stage kSBK deep
constexpr int kSRows = 8;
constexpr int kSCols = 32;
constexpr int kSBK = 128;
constexpr int kSStages = 8;
constexpr int kSThreads = 160;    // producer warp + 4 consumer warps
constexpr int kSWide = 6;         // wide units when each block gets this many
constexpr int kSWBytes = kSCols * kSBK * 2;
constexpr int kSXBytes = kSRows * kSBK * 2;
constexpr int kSStageBytes = (2 * kSWBytes + kSXBytes + 1023) / 1024 * 1024;
constexpr int kSSmem = kSStages * kSStageBytes + 1024;

constexpr int kErrArgs = -1;
constexpr int kErrEncoder = -2;
constexpr int kErrEncode = -3;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// named barrier 1 over the consumer threads
template <int kCount>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCount) : "memory");
}

// named barrier 2 + wg over the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (each in 16-byte units).
// K-major: rows of 128 bytes (64 bf16 along K), 8-row atoms `sbo` apart,
// `lbo` unused.  MN-major: 128-byte lines of 64 bf16 along M or N, one a K
// row; 8-row atoms along K `sbo` apart, 64-wide chunks along M or N `lbo`
// apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 256, fp32, 128 registers a thread) += A (64 x 16) B (16 x 256),
// A and B from shared memory; TA, TB: 1 where the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
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
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n"
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
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// the same with B 16 x 128 (64 registers a thread)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                           uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// one k16 step of a 64 x kBN tile
template <int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da,
                                           uint64_t db) {
  if constexpr (kBN == 256)
    wgmma_n256<TA, TB>(d, da, db);
  else
    wgmma_n128<TA, TB>(d, da, db);
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp (lane `lane`) scans the group sizes: s_off[g] is group g's
// first row (cut at `rows`; sizes below 0 count as 0), s_off[G] the end of
// the last; s_tile[g] the first of group g's row tiles of kTile rows,
// s_tile[G] the tiles of all groups.
template <int kTile>
__device__ __forceinline__ void scan_groups(const int* __restrict__ gs, int G,
                                            int rows, int lane, int* s_off,
                                            int* s_tile) {
  const int per = (G + 31) / 32;
  const int lo = min(lane * per, G), hi = min(lo + per, G);
  long long sum = 0;
  for (int g = lo; g < hi; ++g) sum += max(gs[g], 0);
  long long incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  long long off = incl - sum;
  int tiles = 0;
  for (int g = lo; g < hi; ++g) {
    const int a = static_cast<int>(min(off, static_cast<long long>(rows)));
    off += max(gs[g], 0);
    const int b = static_cast<int>(min(off, static_cast<long long>(rows)));
    s_off[g] = a;
    s_tile[g] = tiles;
    tiles += (b - a + kTile - 1) / kTile;
  }
  int tincl = tiles;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, tincl, o);
    if (lane >= o) tincl += t;
  }
  const int tbase = tincl - tiles;
  for (int g = lo; g < hi; ++g) s_tile[g] += tbase;
  if (lane == 31) {
    s_off[G] = static_cast<int>(min(incl, static_cast<long long>(rows)));
    s_tile[G] = tincl;
  }
}

// A work item.  fwd, dx: output rows [r0, min(r0 + BM, r_end)) of group g
// (g = -1: rows past the groups' sum, r_end = M, stored as zeros), columns
// from c0, `steps` reduction stages.  dw: rows [r0, r0 + BM) of dw[g] over
// K, columns from c0, the reduction over the buffer's rows [lo, hi).
struct Item {
  int g, r0, r_end, c0, lo, hi, steps;
};

// the i-th item of a row-ragged product: group g's items are
// [s_tile[g] * nct, s_tile[g + 1] * nct), column tile-major (the row tiles
// of one column tile run side by side and share its weights in L2); then
// the tiles past the groups' sum, row tile-major
template <int kTile>
__device__ __forceinline__ Item row_item(int i, int nct, int bn, int steps,
                                         const int* s_off, const int* s_tile,
                                         int G, int M) {
  Item it;
  const int slot = i / nct;
  it.c0 = (i - slot * nct) * bn;
  it.lo = it.hi = 0;
  const int tiles = s_tile[G];
  if (slot >= tiles) {
    it.g = -1;
    it.r0 = s_off[G] + (slot - tiles) * kTile;
    it.r_end = M;
    it.steps = 0;
    return it;
  }
  // the last g with s_tile[g] <= slot: the non-empty group owning the slot
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_tile[mid] <= slot) lo = mid;
    else hi = mid - 1;
  }
  // within the group: column tile, then row tile
  const int local = i - s_tile[lo] * nct, nt = s_tile[lo + 1] - s_tile[lo];
  it.g = lo;
  it.c0 = (local / nt) * bn;
  it.r0 = s_off[lo] + (local % nt) * kTile;
  it.r_end = s_off[lo + 1];
  it.steps = steps;
  return it;
}

// the i-th item of dw: group i / (nkt * nnt), then the K tile, then the
// N tile
__device__ __forceinline__ Item dw_item(int i, int nkt, int nnt,
                                        const int* s_off) {
  Item it;
  const int per = nkt * nnt;
  it.g = i / per;
  const int rem = i - it.g * per;
  it.r0 = (rem / nnt) * kBM;
  it.c0 = (rem % nnt) * kBN;
  it.lo = s_off[it.g];
  it.hi = s_off[it.g + 1];
  it.r_end = 0;
  it.steps = cdiv(it.hi - it.lo, kBK);
  return it;
}

struct Params {
  void* c;        // fwd: y (M, N); dx: dx (M, K); dw: dw (G, K, N)
  const int* gs;  // (G,) int32
  int G, M, K, N;
};

// dw's last step: zero rows [nv, kBK) of every box of the stage (the two
// of x^T, the kBN / 64 of dy); thread t of the 256 consumers
__device__ __forceinline__ void zero_tail_rows(unsigned char* stage, int nv,
                                               int t) {
  const int per_box = (kBK - nv) * 8;   // 16-byte chunks a box
  const int total = per_box * (kStageBytes / kBox);
  for (int i = t; i < total; i += 256) {
    const int b = i / per_box, r = i - b * per_box;
    *reinterpret_cast<uint4*>(stage + b * kBox + (nv + r / 8) * 128 +
                              (r % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
}

// The wgmma route: a persistent block walks its items.  Warpgroup 0 is the
// producer (one thread issues the TMA copies), warpgroups 1 and 2 the
// consumers (rows 0-63 and 64-127 of an item).
template <int MODE>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap, const Params p) {
  __shared__ int s_off[kMaxGroups + 1];
  __shared__ int s_tile[kMaxGroups + 1];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) scan_groups<kBM>(p.gs, p.G, p.M, lane, s_off, s_tile);
  __syncthreads();

  const int ncols = MODE == kDx ? p.K : p.N;
  const int ksteps = cdiv(MODE == kFwd ? p.K : p.N, kBK);
  const int nct = cdiv(ncols, kBN);
  const int nkt = cdiv(p.K, kBM);
  const int total = MODE == kDw
                        ? p.G * nkt * nct
                        : (s_tile[p.G] + cdiv(p.M - s_off[p.G], kBM)) * nct;
  auto item = [&](int i) {
    return MODE == kDw ? dw_item(i, nkt, nct, s_off)
                       : row_item<kBM>(i, nct, kBN, ksteps, s_off, s_tile,
                                       p.G, p.M);
  };

  if (warp < 4) {
    // producer warpgroup: give registers to the consumers; one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const Item it = item(i);
        for (int s = 0; s < it.steps; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint64_t* bar = &full[stage];
          mbar_expect_tx(bar, kStageBytes);
          unsigned char* sa = smem + stage * kStageBytes;
          unsigned char* sb = sa + kABytes;
          const int k0 = s * kBK;
          if (MODE == kFwd) {
            // x rows [r0, r0 + 128) x K [k0, k0 + 64); w[g] K rows
            // [k0, k0 + 64) in 64-column boxes
            tma_2d(sa, &amap, bar, k0, it.r0);
#pragma unroll
            for (int c = 0; c < kBN / 64; ++c)
              tma_3d(sb + c * kBox, &bmap, bar, it.c0 + 64 * c, k0, it.g);
          } else if (MODE == kDx) {
            // dy rows x N [k0, k0 + 64); w[g] rows [c0, c0 + 256) (its K)
            // x N [k0, k0 + 64)
            tma_2d(sa, &amap, bar, k0, it.r0);
            tma_3d(sb, &bmap, bar, k0, it.c0, it.g);
          } else {
            // buffer rows [lo + k0, lo + k0 + 64) of x (K [r0, r0 + 128) in
            // two boxes) and of dy (N [c0, c0 + 256) in four)
            const int r = it.lo + k0;
            tma_2d(sa, &amap, bar, it.r0, r);
            tma_2d(sa + kBox, &amap, bar, it.r0 + 64, r);
#pragma unroll
            for (int c = 0; c < kBN / 64; ++c)
              tma_2d(sb + c * kBox, &bmap, bar, it.c0 + 64 * c, r);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = (warp >> 2) - 1;              // 0: rows 0-63, 1: 64-127
    const int wl = warp & 3;                     // warp in its warpgroup
    const int ct = threadIdx.x - 128;            // consumer thread, 0-255
    int stage = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const Item it = item(i);
      __syncwarp();
      float acc[kBN / 2];
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) acc[j] = 0.f;
      int prev = -1;
      for (int s = 0; s < it.steps; ++s) {
        mbar_wait(&full[stage], phase);
        __syncwarp();
        unsigned char* sa = smem + stage * kStageBytes;
        if (MODE == kDw) {
          const int nv = it.hi - (it.lo + s * kBK);
          if (nv < kBK) {
            zero_tail_rows(sa, nv, ct);
            fence_proxy_async();
            consumers_sync<256>();
          }
        }
        // fwd, dx: this warpgroup's 64 rows of the 128-row box; dw: its box
        const uint32_t a0 = smem_u32(sa) + wg * kBox;
        const uint32_t b0 = smem_u32(sa + kABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          if (MODE == kFwd)
            wgmma_tile<0, 1>(acc, sw128_desc(a0 + kk * 32, 16, 1024),
                             sw128_desc(b0 + kk * 2048, kBox, 1024));
          else if (MODE == kDx)
            wgmma_tile<0, 0>(acc, sw128_desc(a0 + kk * 32, 16, 1024),
                             sw128_desc(b0 + kk * 32, 16, 1024));
          else
            wgmma_tile<1, 1>(acc, sw128_desc(a0 + kk * 2048, kBox, 1024),
                             sw128_desc(b0 + kk * 2048, kBox, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) fence_operand(acc[j]);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      // the epilogue: acc[4j + 2h + e] is (row 16 wl + lane / 4 + 8 h,
      // column 8 j + 2 (lane % 4) + e) of this warpgroup's 64 x 256.  It is
      // staged in shared memory as the output's 64 x 64 boxes with the
      // 128-byte swizzle (a warp's stores meet no bank conflict), then one
      // thread stores it by TMA and the warpgroup goes on to its next item
      // while the copy drains.  The boxes clip at M, K and N; a tile whose
      // rows run past its group's end (fwd, dx) is copied row by row
      // instead, 16 bytes a thread, the rows past the group left alone.
      const int wt = threadIdx.x & 127;   // thread in its warpgroup
      unsigned char* out_s = smem + kStages * kStageBytes + wg * kOutBytes;
      if (wt == 0) bulk_wait_read();     // the last item's copy has read it
      warpgroup_sync(wg);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wl + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              out_s + (j >> 3) * kBox + r * 128 +
              (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3)) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
      fence_proxy_async();
      warpgroup_sync(wg);
      const int row0 = it.r0 + 64 * wg;
      if (MODE == kDw) {
        if (wt == 0) {
#pragma unroll
          for (int c = 0; c < kBN / 64; ++c)
            tma_store_3d(&cmap, out_s + c * kBox, it.c0 + 64 * c, row0, it.g);
          bulk_commit();
        }
      } else if (row0 + 64 <= it.r_end || it.g < 0) {
        if (wt == 0) {
#pragma unroll
          for (int c = 0; c < kBN / 64; ++c)
            tma_store_2d(&cmap, out_s + c * kBox, it.c0 + 64 * c, row0);
          bulk_commit();
        }
      } else {
        bf16* C = static_cast<bf16*>(p.c);
        for (int q = wt; q < 64 * (kBN / 8); q += 128) {
          const int r = q / (kBN / 8), cc = q % (kBN / 8);
          const int row = row0 + r, col = it.c0 + 8 * cc;
          if (row < it.r_end && col < ncols)
            *reinterpret_cast<uint4*>(C + static_cast<long long>(row) * ncols +
                                      col) =
                *reinterpret_cast<const uint4*>(
                    out_s + (cc >> 3) * kBox + r * 128 +
                    (((cc & 7) ^ (r & 7)) << 4));
        }
      }
    }
    if ((threadIdx.x & 127) == 0) bulk_wait();
  }
}

// The stream route's units (fwd) of kSC columns: warp 0 is the producer
// (one thread), warps 1-4 the consumers.
template <int kSC>
__device__ __forceinline__ void stream_units(
    const CUtensorMap* wmap, const CUtensorMap* xmap, const Params& p,
    unsigned char* smem, uint64_t* full, uint64_t* empty, float* part,
    const int* s_off, const int* s_tile, int total) {
  constexpr int kBoxes = kSC / kSCols;   // boxes of w a stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nst = cdiv(p.N, kSC);
  const int ksteps = cdiv(p.K, kSBK);
  if (warp == 0) {
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const Item it = row_item<kSRows>(i, nst, kSC, ksteps, s_off, s_tile,
                                         p.G, p.M);
        for (int s = 0; s < it.steps; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint64_t* bar = &full[stage];
          mbar_expect_tx(bar, kBoxes * kSWBytes + kSXBytes);
          unsigned char* sw = smem + stage * kSStageBytes;
          const int k0 = s * kSBK;
          // w[g] K rows [k0, k0 + 128) x kSC columns, 32 a box
#pragma unroll
          for (int b = 0; b < kBoxes; ++b)
            tma_3d(sw + b * kSWBytes, wmap, bar, it.c0 + kSCols * b, k0,
                   it.g);
          // x: 8 rows from r0 x K [k0, k0 + 128)
          tma_2d(sw + 2 * kSWBytes, xmap, bar, k0, it.r0);
          if (++stage == kSStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  const int cw = warp - 1;            // consumer warp, 0-3
  const int ct = threadIdx.x - 32;    // consumer thread, 0-127
  const int rr = lane & 7, j = lane >> 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const Item it = row_item<kSRows>(i, nst, kSC, ksteps, s_off, s_tile, p.G,
                                     p.M);
    float acc[kSC / 16][4];
#pragma unroll
    for (int mi = 0; mi < kSC / 16; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][e] = 0.f;
    for (int s = 0; s < it.steps; ++s) {
      mbar_wait(&full[stage], phase);
      __syncwarp();
      const bf16* sw =
          reinterpret_cast<const bf16*>(smem + stage * kSStageBytes);
      const bf16* sx = sw + kSWBytes;   // after two boxes of w
#pragma unroll
      for (int t = 0; t < kSBK / 64; ++t) {
        const int ks = (cw + 4 * t) * 16;   // this warp's k16 steps
        unsigned b[2];
        // x rows (the MMA's n) x k, k-contiguous: b0 k 0-7, b1 k 8-15
        ldsm_x2(b, sx + rr * kSBK + ks + 8 * (j & 1));
#pragma unroll
        for (int mi = 0; mi < kSC / 16; ++mi) {
          unsigned a[4];
          // w stored [k][32 columns] a box: the transposed load
          ldsm_x4_t(a, sw + (mi >> 1) * (kSWBytes / 2) +
                           (ks + rr + 8 * (j >> 1)) * kSCols +
                           (mi & 1) * 16 + 8 * (j & 1));
          mma_bf16(acc[mi], a, b);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kSStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // acc[mi][e] is (column 16 mi + lane / 4 + 8 (e / 2), row
    // 2 (lane % 4) + e % 2) of the unit: the four warps' partial sums
    // meet in shared memory
#pragma unroll
    for (int mi = 0; mi < kSC / 16; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[cw * kSRows * kSC + (2 * (lane & 3) + (e & 1)) * kSC + 16 * mi +
             (lane >> 2) + 8 * (e >> 1)] = acc[mi][e];
    consumers_sync<128>();
    bf16* C = static_cast<bf16*>(p.c);
    const int r_hi = min(it.r0 + kSRows, it.r_end);
    constexpr int kPart = kSRows * kSC;
    for (int e = ct; e < kPart; e += 128) {
      const int row = it.r0 + e / kSC, col = it.c0 + e % kSC;
      if (row < r_hi && col < p.N)
        C[static_cast<long long>(row) * p.N + col] = __float2bfloat16(
            part[e] + part[kPart + e] + part[2 * kPart + e] +
            part[3 * kPart + e]);
    }
    consumers_sync<128>();
  }
}

// The stream route (fwd): a persistent block walks its units, 32 columns
// wide, or 64 (two boxes of w a stage, 128 contiguous bytes a row of w)
// where every block gets kSWide or more units of 64: the blocks compute
// the same count and so make the same choice.
__global__ void __launch_bounds__(kSThreads)
    stream_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap, const Params p) {
  __shared__ int s_off[kMaxGroups + 1];
  __shared__ int s_tile[kMaxGroups + 1];
  __shared__ __align__(8) uint64_t full[kSStages];
  __shared__ __align__(8) uint64_t empty[kSStages];
  __shared__ float part[4 * kSRows * 2 * kSCols];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // the 4 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) scan_groups<kSRows>(p.gs, p.G, p.M, lane, s_off, s_tile);
  __syncthreads();

  const int slots = s_tile[p.G] + cdiv(p.M - s_off[p.G], kSRows);
  const int wide = slots * cdiv(p.N, 2 * kSCols);
  if (wide >= kSWide * static_cast<int>(gridDim.x))
    stream_units<2 * kSCols>(&wmap, &xmap, p, smem, full, empty, part, s_off,
                             s_tile, wide);
  else
    stream_units<kSCols>(&wmap, &xmap, p, smem, full, empty, part, s_off,
                         s_tile, slots * cdiv(p.N, kSCols));
}

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

// A bf16 tensor map of `rank` dimensions (innermost first), rows `pitch`
// elements apart (and, for rank 3, planes `plane` elements apart).  Boxes
// past the tensor are filled with zeros.
int encode(CUtensorMap* map, int rank, const void* base, long long d0,
           long long d1, long long d2, long long pitch, long long plane,
           int b0, int b1, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch) * 2,
                                 static_cast<cuuint64_t>(plane) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

int sm_count(int dev) {
  static std::atomic<int> cached[64];
  if (dev >= 0 && dev < 64) {
    const int n = cached[dev].load();
    if (n > 0) return n;
  }
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n < 1)
    n = 1;
  if (dev >= 0 && dev < 64) cached[dev].store(n);
  return n;
}

// Set a kernel's dynamic shared-memory limit once a device, then launch
// it with `args`.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int smem, int grid, int dev,
           cudaStream_t stream, std::atomic<uint64_t>* ready,
           const Args&... args) {
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready->load() & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    ready->fetch_or(bit);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one grouped product on `stream`: mode 0 (fwd: a = x (M, K),
// b = w (G, K, N), c = y (M, N)), 1 (dx: a = dy (M, N), b = w, c = dx
// (M, K)) or 2 (dw: a = x (M, K), b = dy (M, N), c = dw (G, K, N)); route
// 0 (wgmma) or 1 (stream; fwd only); bf16 operands, contiguous and
// 16-byte aligned, K and N multiples of 8; group_sizes (G,) int32 on the
// device.  Returns 0, a CUDA error code after the launch, or a negative
// code of its own (grouped_gemm_sm90_error_string).
int grouped_gemm_sm90_launch(int mode, int route, const void* a,
                             const void* b, void* c, const void* group_sizes,
                             int G, int M, int K, int N, void* stream) {
  if (mode < kFwd || mode > kDw || route < kWgmma || route > kStream ||
      (route == kStream && mode != kFwd) || G < 1 || G > kMaxGroups ||
      M < 1 || K < 8 || N < 8 || K % 8 || N % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16 ||
      static_cast<long long>(cdiv(M, kSRows) + G) * cdiv(std::max(K, N), kSCols) >
          0x7fffffffLL)
    return kErrArgs;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int sms = sm_count(dev);
  Params p;
  p.c = c;
  p.gs = static_cast<const int*>(group_sizes);
  p.G = G;
  p.M = M;
  p.K = K;
  p.N = N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long kn = static_cast<long long>(K) * N;
  CUtensorMap m0, m1;
  int err;
  if (route == kStream) {
    static std::atomic<uint64_t> ready{0};
    // w[g]: 32 columns x 128 rows of K a box; x: 8 rows x 128 of K
    err = encode(&m0, 3, b, N, K, G, N, kn, kSCols, kSBK,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!err)
      err = encode(&m1, 2, a, K, M, 1, K, 0, kSBK, kSRows,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
    const long long units =
        static_cast<long long>(cdiv(M, kSRows) + G) * cdiv(N, kSCols);
    const int grid = static_cast<int>(std::min(units, static_cast<long long>(sms)));
    return launch(stream_kernel, kSThreads, kSSmem, grid, dev, st, &ready, m0,
                  m1, p);
  }
  static std::atomic<uint64_t> ready[3];
  CUtensorMap m2;
  long long items;
  if (mode == kFwd) {
    // x: 64 of K x 128 rows; w[g]: 64 of N x 64 of K, kBN / 64 boxes
    err = encode(&m0, 2, a, K, M, 1, K, 0, 64, kBM,
                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err)
      err = encode(&m1, 3, b, N, K, G, N, kn, 64, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    // y: 64 of N x 64 rows
    if (!err)
      err = encode(&m2, 2, c, N, M, 1, N, 0, 64, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    items = static_cast<long long>(cdiv(M, kBM) + G) * cdiv(N, kBN);
  } else if (mode == kDx) {
    // dy: 64 of N x 128 rows; w[g]: 64 of N x kBN rows of K
    err = encode(&m0, 2, a, N, M, 1, N, 0, 64, kBM,
                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err)
      err = encode(&m1, 3, b, N, K, G, N, kn, 64, kBN,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    // dx: 64 of K x 64 rows
    if (!err)
      err = encode(&m2, 2, c, K, M, 1, K, 0, 64, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    items = static_cast<long long>(cdiv(M, kBM) + G) * cdiv(K, kBN);
  } else {
    // x: 64 of K x 64 rows, two boxes; dy: 64 of N x 64 rows, kBN / 64
    err = encode(&m0, 2, a, K, M, 1, K, 0, 64, 64,
                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (!err)
      err = encode(&m1, 2, b, N, M, 1, N, 0, 64, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    // dw[g]: 64 of N x 64 of K
    if (!err)
      err = encode(&m2, 3, c, N, K, G, N, kn, 64, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
    items = static_cast<long long>(G) * cdiv(K, kBM) * cdiv(N, kBN);
  }
  if (err) return err;
  if (items > 0x7fffffffLL) return kErrArgs;
  const int grid = static_cast<int>(std::min(items, static_cast<long long>(sms)));
  if (mode == kFwd)
    return launch(wgmma_kernel<kFwd>, kWgThreads, kWgSmem, grid, dev, st,
                  &ready[0], m0, m1, m2, p);
  if (mode == kDx)
    return launch(wgmma_kernel<kDx>, kWgThreads, kWgSmem, grid, dev, st,
                  &ready[1], m0, m1, m2, p);
  return launch(wgmma_kernel<kDw>, kWgThreads, kWgSmem, grid, dev, st,
                &ready[2], m0, m1, m2, p);
}

const char* grouped_gemm_sm90_error_string(int code) {
  if (code == kErrArgs) return "arguments outside the kernel's contract";
  if (code == kErrEncoder)
    return "the driver's cuTensorMapEncodeTiled is not available";
  if (code == kErrEncode) return "cuTensorMapEncodeTiled refused a map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
