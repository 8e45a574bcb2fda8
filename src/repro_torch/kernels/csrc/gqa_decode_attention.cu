// GQA decode attention over a (ring-buffered, optionally INT8) KV cache,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA-lowered core of `attention_decode`
// (src/repro/models/layers.py:319-325: scores, the ring-valid mask,
// softmax, probabilities times V), with `_kv_load`'s INT8 dequantization
// (:278) fused into the loads.  One query token per sequence attends to
// (B, S, KV, D) caches; the G = H / KV query heads of a KV head share its
// cache rows.  Scores and the online softmax run in fp32; the
// probabilities are rounded to the compute dtype before P.V, as the
// reference rounds its softmax output.
//
// Bound on this card: the cache.  A call reads every valid slot's K and V
// row once (2 * D * elem bytes) against 4 * G * D operations a slot: some
// 6 operations a byte in bf16, far below the 295 at which the tensor cores
// would bound it, so the kernel is bound by its bytes at 3.35 TB/s.
//
// Design.
// * One launch per call.  The grid is (B * KV, splits); the wrapper picks
//   the splits from the slots to read and the SM count: about one
//   balanced wave of one block per SM (each block pays a fixed start and
//   a combine, so fewer, longer blocks win).  With one split a
//   block writes the output itself.  With several, each block writes its
//   (m, l, acc) partial for the G real rows, fences, and draws a ticket
//   from a per-(b, kv) int32 counter with `atomicAdd`; the block that
//   draws the last ticket combines the partials, writes the output and
//   puts the counter back to 0.  No memset precedes the launch, so a
//   captured CUDA graph replays it as it is.  The wrapper allocates the
//   counters once per device, at a fixed size and outside any capture, and
//   never moves them, so a graph's pointer to them stays valid.  They are
//   shared by every call on a device: calls that use them must run in
//   order on one stream.
// * Staging: one producer warp keeps a ring of 32 KB stages in flight with
//   TMA (`cp.async.bulk.tensor`) completing on `mbarrier`s; four consumer
//   warps compute, each on its own 16-slot tiles of every stage (warp w
//   takes tiles w, w + 4, ..., so that a short call keeps all four busy).
//   A bf16 cache, whose copies bound it, takes two stages, so that three
//   blocks fit an SM; the other kinds, whose math weighs more, take three
//   (two blocks an SM), which measured faster for INT8.  The producer sets
//   up the mbarriers and issues its first copies while the consumers load
//   q.  The slots per stage follow from the bytes: a
//   stage holds 32 KB of K and V rows (64 slots of a bf16 D = 128 row, 128
//   of an INT8 one), so an INT8 cache keeps as many bytes in flight as a
//   bf16 one.  TMA and not one `cp.async.bulk` per slot row: one
//   instruction moves a whole stage of a 128-byte column box, the tensor
//   map's bounds stop the reads at the last slot to read (slots past it
//   arrive as zeros), and its 128-byte swizzle lets the consumers read
//   the rows without bank conflicts.  The map views a cache as
//   (B, s_end, KV * D): every row stride is a multiple of 16 bytes for
//   D = 128 and 120 in bf16 and INT8.  TMA reads from 16-byte aligned
//   columns only, so a head's boxes start at the 16-byte unit that holds
//   its first column (an odd INT8 head of D = 120 starts 8 bytes into
//   it) and a row is staged in whole 128-byte boxes: D = 120 moves 8
//   more bytes a row (the neighbour's, or zeros past the last head).
//   Columns past the head are never loaded into registers.
// * The math on the tensor cores, `mma.sync.m16n8k16` bf16 with fp32
//   accumulation, with the operands swapped so that the slots are the 16
//   rows and the G <= 8 query heads the 8 columns: scores^T = K q^T and
//   ctx^T = V^T P^T.  Padding G to 8 columns, not 16 rows, halves the idle
//   lanes; `movmatrix` turns the probabilities' accumulator into the B
//   operand of the second product.  Each consumer thread loads its
//   fragments straight from the swizzled stage, 4 columns of a row at a
//   time, in an order of the head dimension that both products' operands
//   share, so neither `ldmatrix` nor a transposing load of 8-bit data is
//   needed.  FMA on the CUDA cores would also stay under the bytes at bf16,
//   but its cross-lane reductions and shared-memory traffic per slot come
//   near the bytes' time; the MMAs take a few cycles a slot.  The operand
//   loads take no branch (columns past D load column 0 and are zeroed after
//   the load), so that the compiler issues a tile's loads ahead of its
//   MMAs: with a branch around each load, every case ran slower on an
//   H100 (PERF.md §6).
// * INT8 caches are read as int8 (half the bytes) and dequantized in
//   registers by the reference's exact 1/64 to bf16 (a byte permute and
//   an FMA a value, on the 2^23 float's mantissa): most of an INT8 call's
//   math (PERF.md §6).
// * float32 queries (a reduced configuration's compute dtype) run the same
//   ring with fp32 FMA on the CUDA cores, every product in fp32.
// * A block's end: each warp's (m, l) goes through shared memory, each warp
//   scales its acc to the block's max and stores it (8-byte stores in rows
//   padded against bank conflicts), and thread t adds the warps' row t of
//   each head and divides by the head's sum once.
// * Only min(S, pos + 1) slots are read; a slot's validity (its absolute
//   position within [pos - window, pos] for ring position `slot`) is the
//   reference's test, turned by the host into two index thresholds.
//
// Contract (checked by the Python wrapper and again here): q (B, KV, G, D)
// and the caches (B, S, KV, D) contiguous, 1 <= G <= 8, D <= 128 a
// multiple of 4, KV * D * elem a multiple of 16 bytes, 16-byte aligned
// caches; `chunk` a multiple of the slots per stage and no split empty;
// 2 * nsp * G + 16 floats within the ring (the last block's combine).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;                     // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;   // + one producer warp
constexpr int kStageBytes = 32768;
constexpr int kBox = 128;                     // bytes of a row per TMA box
constexpr int kGMax = 8;
constexpr int kDMax = 128;
// the consumers' partials in shared memory (the ring, once it is done):
// each warp's acc scaled to the block's max, by head-dimension row of
// kRow floats (the 8 query heads and 2 of padding, so that the warps'
// 8-byte stores meet no bank conflict); each warp's m[8] and l[8]; the
// block's max[8] and sum[8]
constexpr int kRow = kGMax + 2;
constexpr int kSm = kWarps * kDMax * kRow, kSl = kSm + kWarps * kGMax;
constexpr int kBig = kSl + kWarps * kGMax, kDen = kBig + kGMax;

// cache and query kinds
enum Kind { kBf16 = 0, kInt8 = 1, kF32 = 2, kInt8F32 = 3 };

// stages of the ring by kind: two for a bf16 cache (three blocks an SM),
// three for the others (two blocks an SM); the shared memory of a block
constexpr int stages_of(int kind) { return kind == kBf16 ? 2 : 3; }
constexpr int smem_of(int stages) { return stages * kStageBytes + 1024; }

struct Params {
  const void* q;
  void* out;
  float* ws;           // [B*KV][nsp][G*(D+2)] partials (nsp > 1)
  int* counters;       // [B*KV] tickets (nsp > 1), 0 between launches
  int slot;            // pos % S; ring index idx is valid when it is
  int lo1, lo2;        // above lo1 (idx <= slot) or lo2 (idx > slot)
  int S, KV, G, D, s_end, chunk, nsp, block_s, slabs, elem;
  float scale_log2;    // 1/sqrt(D) * log2(e)
};

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

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
}

// barrier 2: the consumers wait (sync) until the producer has set up the
// mbarriers (arrive), and the producer goes on to its first copies
__device__ __forceinline__ void setup_arrive() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void setup_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// byte offset of 16-byte chunk `c` of row `r` in a box written by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B (the box 1024-byte aligned)
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBox + ((c ^ (r & 7)) << 4);
}

// byte `b` of staged row `r`: a row is cut into 128-byte boxes, each box a
// swizzled block of `rows` rows
__device__ __forceinline__ const unsigned char* at(const unsigned char* base,
                                                   int rows, int r, int b) {
  return base + (b >> 7) * rows * kBox + swz(r, (b >> 4) & 7) + (b & 15);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// byte k of an int8 word (pre-XORed with 0x80808080) times 1/64, exactly:
// 0x4B0000xx is 2^23 + xx as a float
__device__ __forceinline__ float i8f(uint32_t ux, int k) {
  return fmaf(__uint_as_float(__byte_perm(ux, 0x4B000000u, 0x7540 | k)),
              0.015625f, -131074.0f);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// The ring test of the reference (layers.py:313-318) for ring index idx,
// as two thresholds from the host (gqa_decode_attention_launch).
struct Ring {
  int slot, lo1, lo2;
  __device__ Ring(const Params& p) : slot(p.slot), lo1(p.lo1), lo2(p.lo2) {}
  __device__ __forceinline__ bool valid(int idx) const {
    return idx > (idx <= slot ? lo1 : lo2);
  }
};

__device__ __forceinline__ float weight(float m, float big) {
  return m == -INFINITY ? 0.f : exp2f(m - big);
}

// Once the warps have put their m and l into the partials: the block's max
// of query head c; its max and sum into the partials.
__device__ __forceinline__ float head_max(const float* part, int c) {
  float big = part[kSm + c];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) big = fmaxf(big, part[kSm + w * kGMax + c]);
  return big;
}

__device__ __forceinline__ void head_sum(float* part, int c) {
  const float big = head_max(part, c);
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    den = fmaf(weight(part[kSm + w * kGMax + c], big),
               part[kSl + w * kGMax + c], den);
  part[kBig + c] = big;
  part[kDen + c] = den;
}

// The first of the 4 columns that k-step i gives thread j (lane % 4) of
// the score product's operands.  INT8: the 16-column chunk i, 4 bytes a
// thread; bf16: chunks i and i + 4 of a 64-column box, 8 bytes a thread,
// so that the 16 lanes of one 8-byte load read 16 distinct bank pairs.
template <bool kI8>
__device__ __forceinline__ int qcol(int i, int j) {
  return kI8 ? 16 * i + 4 * j
             : (i >> 2) * 64 + 8 * ((i & 3) + 4 * (j >> 1)) + 4 * (j & 1);
}

// The tensor-core consumer: bf16 q, a bf16 (kI8 false) or INT8 cache, rows
// staged in kSlabs 128-byte boxes.  Warp w takes the 16-slot tiles w,
// w + kWarps, ... of every stage (so that the slots of a short call spread
// over all the warps).  Thread (gq, j) =
// (lane / 4, lane % 4) of the fragments.  The head dimension is read in an
// order of its own: k-step i, thread j holds columns qcol(i, j) .. + 3 of q
// and of its two K rows; pair p (32 columns, two 16-row tiles of ctx^T),
// thread gq holds columns 32 p + 4 gq .. + 3 of its four V rows.
template <bool kI8, int kSlabs, int kStages>
__device__ void consume_mma(const Params& p, unsigned char* ring,
                            uint64_t* full, uint64_t* empty, int bk,
                            int s_lo, int s_hi, int n_iter, float* part) {
  constexpr int kBlockS = 128 / kSlabs;          // slots per stage
  constexpr int kTiles = kBlockS / (16 * kWarps);
  constexpr int kKSteps = kI8 ? 8 : 4 * kSlabs;  // 16 columns each
  constexpr int kPairs = kI8 ? 4 : 2 * kSlabs;   // 32 columns each
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, j = lane & 3;
  const Ring ring_of(p);
  constexpr int kElem = kI8 ? 1 : 2;
  // the head's first byte in its staged row (the box starts 16-byte aligned)
  const int off = ((bk % p.KV) * p.D * kElem) & 15;

  // q^T as B fragments, zero past G and D
  uint32_t qf[kKSteps][2];
  {
    const uint16_t* q = static_cast<const uint16_t*>(p.q) +
                        (static_cast<long long>(bk) * p.G + gq) * p.D;
#pragma unroll
    for (int i = 0; i < kKSteps; ++i) {
      const int d0 = qcol<kI8>(i, j);
      uint32_t h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = (gq < p.G && d0 + e < p.D) ? q[d0 + e] : 0u;
      qf[i][0] = h[0] | (h[1] << 16);
      qf[i][1] = h[2] | (h[3] << 16);
    }
  }

  float m[2] = {-INFINITY, -INFINITY};   // columns 2j, 2j+1, log2 domain
  float l[2] = {0.f, 0.f};               // this thread's share of the sums
  float acc[kPairs][2][4];
#pragma unroll
  for (int pp = 0; pp < kPairs; ++pp)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pp][t][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const unsigned char* ks = ring + st * kStageBytes;
    const unsigned char* vs = ks + kSlabs * kBlockS * kBox;
    const int row0 = warp * 16;   // tile t from row row0 + 64 t
    const int idx0 = s_lo + it * kBlockS + row0;

    float sc[kTiles][4];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (idx0 + t * kWarps * 16 >= s_hi) {   // past the split's end
        sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = -INFINITY;
        continue;
      }
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const int r = row0 + t * kWarps * 16 + gq;
#pragma unroll
      for (int i = 0; i < kKSteps; ++i) {
        uint32_t a0, a1, a2, a3;
        const int d0 = qcol<kI8>(i, j);
        // rows r and r + 8, columns d0 .. d0 + 3; past D: zeros (no branch,
        // so that every k-step's loads issue ahead of the MMAs)
        const bool in = d0 < p.D;
        {
          const unsigned char* src =
              at(ks, kBlockS, r, off + (in ? d0 : 0) * kElem);
          if (kI8) {
            const uint32_t u = *reinterpret_cast<const uint32_t*>(src) ^
                               0x80808080u;
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                                   src + 8 * kBox) ^
                               0x80808080u;
            a0 = pack_bf16(i8f(u, 0), i8f(u, 1));
            a2 = pack_bf16(i8f(u, 2), i8f(u, 3));
            a1 = pack_bf16(i8f(w, 0), i8f(w, 1));
            a3 = pack_bf16(i8f(w, 2), i8f(w, 3));
          } else {
            const uint2 u = *reinterpret_cast<const uint2*>(src);
            const uint2 w = *reinterpret_cast<const uint2*>(src + 8 * kBox);
            a0 = u.x;
            a2 = u.y;
            a1 = w.x;
            a3 = w.y;
          }
        }
        if (!in) a0 = a1 = a2 = a3 = 0;
        mma_bf16(c, a0, a1, a2, a3, qf[i][0], qf[i][1]);
      }
      const int idx = idx0 + t * kWarps * 16 + gq;
      const bool ok0 = idx < s_hi && ring_of.valid(idx);
      const bool ok1 = idx + 8 < s_hi && ring_of.valid(idx + 8);
      sc[t][0] = ok0 ? c[0] * p.scale_log2 : -INFINITY;
      sc[t][1] = ok0 ? c[1] * p.scale_log2 : -INFINITY;
      sc[t][2] = ok1 ? c[2] * p.scale_log2 : -INFINITY;
      sc[t][3] = ok1 ? c[3] * p.scale_log2 : -INFINITY;
    }

    // online softmax by column (query head): the max over the warp's slots
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[t][0], sc[t][2]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[t][1], sc[t][3]));
    }
#pragma unroll
    for (int s = 4; s < 32; s <<= 1) {
      mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], s));
      mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], s));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      base[e] = mx[e] == -INFINITY ? 0.f : mx[e];
      alpha[e] = exp2f(m[e] - base[e]);
      m[e] = mx[e];
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int pp = 0; pp < kPairs; ++pp)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        acc[pp][t][0] *= alpha[0];
        acc[pp][t][1] *= alpha[1];
        acc[pp][t][2] *= alpha[0];
        acc[pp][t][3] *= alpha[1];
      }

#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (idx0 + t * kWarps * 16 >= s_hi) continue;
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] = exp2f(sc[t][e] - base[e & 1]);
        l[e & 1] += pr[e];
      }
      // P^T as the B operand: rows 2j, 2j+1 (+8) of the tile, column gq
      const uint32_t b0 = movmatrix_t(pack_bf16(pr[0], pr[1]));
      const uint32_t b1 = movmatrix_t(pack_bf16(pr[2], pr[3]));
      const int r = row0 + t * kWarps * 16 + 2 * j;
#pragma unroll
      for (int pp = 0; pp < kPairs; ++pp) {
        uint32_t a[2][4];
        const int d = 32 * pp + 4 * gq;   // columns d .. d + 3
        const bool in = d < p.D;           // past D: zeros, as above
        const int b = off + (in ? d : 0) * kElem;
        if (kI8) {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = r + (e & 1) + 8 * (e >> 1);
            w[e] = *reinterpret_cast<const uint32_t*>(at(vs, kBlockS, rr, b)) ^
                   0x80808080u;
          }
          // tile t2, rows gq / gq + 8 of ctx^T = columns 4 gq + 2 t2 + h
#pragma unroll
          for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = 2 * t2 + h;
              a[t2][h] = pack_bf16(i8f(w[0], col), i8f(w[1], col));
              a[t2][h + 2] = pack_bf16(i8f(w[2], col), i8f(w[3], col));
            }
        } else {
          uint2 w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = r + (e & 1) + 8 * (e >> 1);
            w[e] = *reinterpret_cast<const uint2*>(at(vs, kBlockS, rr, b));
          }
          // .x holds columns (4 gq, 4 gq + 1), .y (4 gq + 2, 4 gq + 3)
          a[0][0] = __byte_perm(w[0].x, w[1].x, 0x5410);
          a[0][1] = __byte_perm(w[0].x, w[1].x, 0x7632);
          a[0][2] = __byte_perm(w[2].x, w[3].x, 0x5410);
          a[0][3] = __byte_perm(w[2].x, w[3].x, 0x7632);
          a[1][0] = __byte_perm(w[0].y, w[1].y, 0x5410);
          a[1][1] = __byte_perm(w[0].y, w[1].y, 0x7632);
          a[1][2] = __byte_perm(w[2].y, w[3].y, 0x5410);
          a[1][3] = __byte_perm(w[2].y, w[3].y, 0x7632);
        }
        if (!in)
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e >> 2][e & 3] = 0;
        mma_bf16(acc[pp][0], a[0][0], a[0][1], a[0][2], a[0][3], b0, b1);
        mma_bf16(acc[pp][1], a[1][0], a[1][1], a[1][2], a[1][3], b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the warp's partial: the column sums over its 8 row groups
#pragma unroll
  for (int s = 4; s < 32; s <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], s);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], s);
  }
  consumers_sync();   // every warp is done with the ring
  if (gq == 0) {
    part[kSm + warp * kGMax + 2 * j] = m[0];
    part[kSm + warp * kGMax + 2 * j + 1] = m[1];
    part[kSl + warp * kGMax + 2 * j] = l[0];
    part[kSl + warp * kGMax + 2 * j + 1] = l[1];
  }
  consumers_sync();
  const float w0 = weight(m[0], head_max(part, 2 * j));
  const float w1 = weight(m[1], head_max(part, 2 * j + 1));
  if (warp == 0 && gq == 0) {
    head_sum(part, 2 * j);
    head_sum(part, 2 * j + 1);
  }
  float* pacc = part + warp * kDMax * kRow;
#pragma unroll
  for (int pp = 0; pp < kPairs; ++pp)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 32 * pp + 4 * gq + 2 * t + h;
        *reinterpret_cast<float2*>(pacc + d * kRow + 2 * j) =
            make_float2(acc[pp][t][2 * h] * w0, acc[pp][t][2 * h + 1] * w1);
      }
}

// The fp32 consumer: float32 q, a float32 (kI8 false) or INT8 cache.  Warp
// w takes slots w, w + 4, ... of every stage; lane owns columns lane + 32 c.
template <bool kI8, int kStages>
__device__ void consume_fma(const Params& p, unsigned char* ring,
                            uint64_t* full, uint64_t* empty, int bk,
                            int s_lo, int s_hi, int n_iter, float* part) {
  constexpr int kElem = kI8 ? 1 : 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int off = ((bk % p.KV) * p.D * kElem) & 15;   // as consume_mma
  const Ring ring_of(p);
  float qv[kGMax][4];
  const float* q = static_cast<const float*>(p.q) +
                   static_cast<long long>(bk) * p.G * p.D;
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = lane + 32 * c;
      qv[g][c] = (g < p.G && d < p.D) ? q[g * p.D + d] : 0.f;
    }
  float m[kGMax], l[kGMax], acc[kGMax][4];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;
  }
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const unsigned char* ks = ring + st * kStageBytes;
    const unsigned char* vs = ks + p.slabs * p.block_s * kBox;
    for (int r = warp; r < p.block_s; r += kWarps) {
      const int idx = s_lo + it * p.block_s + r;
      if (idx >= s_hi || !ring_of.valid(idx)) continue;
      float kd[4], vd[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = lane + 32 * c;
        kd[c] = vd[c] = 0.f;
        if (d < p.D) {
          const unsigned char* kp = at(ks, p.block_s, r, off + d * kElem);
          const unsigned char* vp = at(vs, p.block_s, r, off + d * kElem);
          if (kI8) {
            kd[c] = static_cast<float>(*reinterpret_cast<const int8_t*>(kp)) *
                    0.015625f;
            vd[c] = static_cast<float>(*reinterpret_cast<const int8_t*>(vp)) *
                    0.015625f;
          } else {
            kd[c] = *reinterpret_cast<const float*>(kp);
            vd[c] = *reinterpret_cast<const float*>(vp);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) s = fmaf(qv[g][c], kd[c], s);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        const float t = s * p.scale_log2;
        const float mn = fmaxf(m[g], t);
        const float al = exp2f(m[g] - mn), pe = exp2f(t - mn);
        m[g] = mn;
        l[g] = l[g] * al + pe;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[g][c] = fmaf(pe, vd[c], acc[g][c] * al);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  consumers_sync();   // every warp is done with the ring
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      part[kSm + warp * kGMax + g] = m[g];
      part[kSl + warp * kGMax + g] = l[g];
    }
  consumers_sync();
  float wt[kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
    wt[g] = weight(m[g], head_max(part, g));
  if (warp == 0 && lane < kGMax) head_sum(part, lane);
  float* pacc = part + warp * kDMax * kRow;
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      pacc[(lane + 32 * c) * kRow + g] = acc[g][c] * wt[g];
}


template <typename Out>
__device__ __forceinline__ void store(void* out, long long i, float x) {
  if constexpr (sizeof(Out) == 2)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

template <int kKind, int kSlabs, int kStages = stages_of(kKind)>
__global__ void __launch_bounds__(kThreads, kStages == 2 ? 3 : 2)
    gqa_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const Params p) {
  using Out = typename std::conditional<kKind == kBf16 || kKind == kInt8,
                                        __nv_bfloat16, float>::type;
  extern __shared__ unsigned char smem_raw[];
  // the ring at a 1024-byte boundary of the shared window (the swizzle's)
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int last;

  const int bk = blockIdx.x, sp = blockIdx.y;
  const int s_lo = sp * p.chunk;
  const int s_hi = min(s_lo + p.chunk, p.s_end);
  const int n_iter = (s_hi - s_lo + p.block_s - 1) / p.block_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kWarps) {   // the producer: one thread issues every copy
    if (lane == 0) {
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    setup_arrive();
    if (lane == 0) {
      // each box starts at the 16-byte unit that holds the head's first
      // column: TMA reads only from 16-byte aligned columns
      const int b = bk / p.KV, first = (bk % p.KV) * p.D * p.elem;
      const int col0 = (first & ~15) / p.elem, box_el = kBox / p.elem;
      const uint32_t bytes = 2u * p.slabs * p.block_s * kBox;
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], bytes);
        unsigned char* ks = ring + st * kStageBytes;
        unsigned char* vs = ks + p.slabs * p.block_s * kBox;
        const int s0 = s_lo + it * p.block_s;
        for (int sl = 0; sl < p.slabs; ++sl) {
          tma_load_3d(ks + sl * p.block_s * kBox, &kmap, &full[st],
                      col0 + sl * box_el, s0, b);
          tma_load_3d(vs + sl * p.block_s * kBox, &vmap, &full[st],
                      col0 + sl * box_el, s0, b);
        }
      }
    }
    return;
  }

  setup_sync();
  float* part = reinterpret_cast<float*>(ring);
  if constexpr (kKind == kBf16)
    consume_mma<false, kSlabs, kStages>(p, ring, full, empty, bk, s_lo, s_hi,
                                        n_iter, part);
  else if constexpr (kKind == kInt8)
    consume_mma<true, kSlabs, kStages>(p, ring, full, empty, bk, s_lo, s_hi,
                                       n_iter, part);
  else
    consume_fma<kKind == kInt8F32, kStages>(p, ring, full, empty, bk, s_lo,
                                            s_hi, n_iter, part);
  consumers_sync();

  // the block's (m, l, acc): the warps' scaled partials added; thread t
  // takes row t of the head dimension (D <= 128 consumer threads)
  const int gd = p.G * p.D;
  const int t = threadIdx.x;
  const long long part_floats = static_cast<long long>(p.G) * (p.D + 2);
  float* ws = p.nsp == 1 ? nullptr
                         : p.ws + (static_cast<long long>(bk) * p.nsp + sp) *
                                      part_floats;
  // every head's row t, in bounds whatever G and D: the loads issue together
  float sums[kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; g += 2) {
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 x =
          *reinterpret_cast<const float2*>(part + (w * kDMax + t) * kRow + g);
      sum.x += x.x;
      sum.y += x.y;
    }
    sums[g] = sum.x;
    sums[g + 1] = sum.y;
  }
  if (t < p.D) {
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g < p.G) {
        const int e = g * p.D + t;
        if (p.nsp == 1) {
          store<Out>(p.out, static_cast<long long>(bk) * gd + e,
                     __fdividef(sums[g], part[kDen + g]));
        } else {
          ws[2 * p.G + e] = sums[g];
          if (t == 0) {
            ws[g] = part[kBig + g];
            ws[p.G + g] = part[kDen + g];
          }
        }
      }
    }
  }
  if (p.nsp == 1) return;

  // several splits: the block that draws the last ticket combines them
  __threadfence();
  consumers_sync();
  if (t == 0) {
    const int ticket = atomicAdd(&p.counters[bk], 1);
    last = ticket == p.nsp - 1;
    if (last) p.counters[bk] = 0;   // every block of this (b, kv) has drawn
  }
  consumers_sync();
  if (!last) return;
  __threadfence();
  // The splits' m and l into shared memory (the warps' partials are done
  // with), each split's weight and the denominators from there; then every
  // thread's outputs, their loads from L2 issued together rather than one
  // round trip per split and output.
  const float* all = p.ws + static_cast<long long>(bk) * p.nsp * part_floats;
  const int ng = p.nsp * p.G;
  float* wgt = part;             // [nsp][G]: m, then the split's weight
  float* lsum = part + ng;       // [nsp][G]: l
  float* big = lsum + ng;        // [G]
  float* den = big + kGMax;      // [G]
  for (int i = t; i < ng; i += kWarps * 32) {
    const int s = i / p.G, g = i - s * p.G;
    wgt[i] = __ldcg(all + s * part_floats + g);
    lsum[i] = __ldcg(all + s * part_floats + p.G + g);
  }
  consumers_sync();
  if (t < p.G) {
    float b = -INFINITY;
    for (int s = 0; s < p.nsp; ++s) b = fmaxf(b, wgt[s * p.G + t]);
    big[t] = b;
  }
  consumers_sync();
  for (int i = t; i < ng; i += kWarps * 32)
    wgt[i] = weight(wgt[i], big[i % p.G]);
  consumers_sync();
  if (t < p.G) {
    float d = 0.f;
    for (int s = 0; s < p.nsp; ++s)
      d = fmaf(wgt[s * p.G + t], lsum[s * p.G + t], d);
    den[t] = d;
  }
  consumers_sync();
  constexpr int kPer = kGMax * kDMax / (kWarps * 32);   // outputs a thread
  float num[kPer];
  int head[kPer];                // the query head of each output
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    num[k] = 0.f;
    head[k] = (t + k * kWarps * 32) / p.D;
  }
#pragma unroll 4
  for (int s = 0; s < p.nsp; ++s) {
    const float* acc = all + s * part_floats + 2 * p.G;
    const float* w = wgt + s * p.G;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = t + k * kWarps * 32;
      if (e < gd) num[k] = fmaf(w[head[k]], __ldcg(acc + e), num[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = t + k * kWarps * 32;
    if (e < gd)
      store<Out>(p.out, static_cast<long long>(bk) * gd + e,
                 __fdividef(num[k], den[head[k]]));
  }
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

// errors of our own, beside CUDA's codes
constexpr int kErrArgs = -1;
constexpr int kErrEncoder = -2;
constexpr int kErrEncode = -3;

template <int kKind, int kSlabs>
int launch(const CUtensorMap& km, const CUtensorMap& vm, const Params& p,
           int bkv, cudaStream_t stream) {
  // the shared-memory limit is a per-device attribute: set once per device
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load() & bit)) {
    e = cudaFuncSetAttribute(gqa_decode_kernel<kKind, kSlabs>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_of(stages_of(kKind)));
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  gqa_decode_kernel<kKind, kSlabs>
      <<<dim3(bkv, p.nsp), kThreads, smem_of(stages_of(kKind)), stream>>>(
          km, vm, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one call on `stream`: q (B, KV, G, D) in bf16 (kind 0: bf16
// cache, 1: INT8) or float32 (2: float32 cache, 3: INT8), the caches
// (B, S, KV, D), out like q; `ws` (B*KV*nsp*G*(D+2) floats) and `counters`
// (B*KV int32, zero) are used when nsp > 1.  Slots [0, s_end) are read, in
// nsp splits of `chunk`.  Returns 0, a CUDA error code after the launch,
// or a negative code of its own (gqa_decode_attention_error_string).
int gqa_decode_attention_launch(const void* q, const void* k, const void* v,
                                void* out, void* ws, void* counters, int B,
                                int S, int KV, int G, int D, int kind,
                                long long pos, int has_window,
                                long long window, int s_end, int chunk,
                                int nsp, void* stream) {
  if (kind < 0 || kind > 3 || B < 1 || S < 1 || KV < 1 || G < 1 ||
      G > kGMax || D < 1 || D > kDMax || pos < 0 || s_end < 1 || s_end > S ||
      nsp < 1 || chunk < 1)
    return kErrArgs;
  const int elem = kind == kBf16 ? 2 : kind == kF32 ? 4 : 1;
  // a head's columns start up to 15 bytes into their first box
  int lead = 0;
  for (int h = 0; h < KV; ++h) lead = max(lead, (h * D * elem) & 15);
  const int slabs = (lead + D * elem + kBox - 1) / kBox;
  const int block_s = (128 / slabs) / 8 * 8;
  const long long row = static_cast<long long>(KV) * D * elem;
  if (D % 4 || row % 16 || (kind < kF32 && slabs > 2) ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 || chunk % block_s ||
      static_cast<long long>(nsp - 1) * chunk >= s_end ||
      static_cast<long long>(nsp) * chunk < s_end ||
      (nsp > 1 && (ws == nullptr || counters == nullptr)) ||
      2 * nsp * G + 2 * kGMax > stages_of(kind) * kStageBytes / 4)
    return kErrArgs;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrEncoder;
  const CUtensorMapDataType dtype =
      kind == kBf16   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : kind == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  // (B, s_end, KV * D) innermost first: slots from s_end on read as zeros
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(KV) * D,
                              static_cast<cuuint64_t>(s_end),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row),
                                 static_cast<cuuint64_t>(row) * S};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox / elem),
                             static_cast<cuuint32_t>(block_s), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUtensorMap km, vm;
  for (int t = 0; t < 2; ++t) {
    const CUresult r = encode(
        t ? &vm : &km, dtype, 3, const_cast<void*>(t ? v : k), dims, strides,
        box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kErrEncode;
  }
  Params p;
  p.q = q;
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  // Ring index idx holds absolute position wraps + idx (idx <= slot) or
  // wraps - S + idx (idx > slot), wraps = pos - slot.  The first is never
  // past pos and never negative: it is valid when idx > slot - window.
  // The second exists once the ring has wrapped (pos >= S) and is valid when
  // idx > slot + S - window.  Clamped to [-1, S], the thresholds fit an int.
  const long long slot = pos % S;
  const long long w = has_window ? window : 2LL * S + 1;
  const long long lo1 = slot - w;
  const long long lo2 = pos < S ? S : slot + S - w;
  p.slot = static_cast<int>(slot);
  p.lo1 = static_cast<int>(lo1 < -1 ? -1 : lo1 > S ? S : lo1);
  p.lo2 = static_cast<int>(lo2 < slot ? slot : lo2 > S ? S : lo2);
  p.S = S;
  p.KV = KV;
  p.G = G;
  p.D = D;
  p.s_end = s_end;
  p.chunk = chunk;
  p.nsp = nsp;
  p.block_s = block_s;
  p.slabs = slabs;
  p.elem = elem;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const int bkv = B * KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBf16:
      return slabs == 1 ? launch<kBf16, 1>(km, vm, p, bkv, st)
                        : launch<kBf16, 2>(km, vm, p, bkv, st);
    case kInt8:
      return slabs == 1 ? launch<kInt8, 1>(km, vm, p, bkv, st)
                        : launch<kInt8, 2>(km, vm, p, bkv, st);
    case kF32:
      return launch<kF32, 0>(km, vm, p, bkv, st);
    default:
      return launch<kInt8F32, 0>(km, vm, p, bkv, st);
  }
}

const char* gqa_decode_attention_error_string(int code) {
  switch (code) {
    case kErrArgs:
      return "arguments outside the kernel's contract";
    case kErrEncoder:
      return "the driver has no cuTensorMapEncodeTiled";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused the cache's tensor map";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
