// Masked softmax attention on the GQA layout, forward and backward, for
// NVIDIA Hopper (sm_90a): the attention core of training and prefill.
//
// Replaces no Pallas kernel: the reference computes this core in XLA,
// `_gqa_scores_ctx` (src/repro/models/layers.py:117) up to
// FLASH_THRESHOLD keys and `flash_attention` (:130, a `lax.scan` over KV
// blocks inside a scan over Q blocks) above, with the mask of `_mask_fn`
// (:194: causal `ki <= qi`, the sliding window `ki > qi - win`, query
// positions offset by `q_pos0`).  q (B, Sq, KV, G, D), k (B, Sk, KV, D),
// v (B, Sk, KV, Dv) -> O (B, Sq, KV, G, Dv), scale 1/sqrt(D).
//
// Bound on this card: the operations.  A block of 64 query rows does
// 2 * 64 * 64 * (D + Dv) operations per 64 keys it reads (about 64 a byte
// of K and V at D = 128), and a long sequence reads each key once per Q
// block, so the kernel sits far above the 295 operations a byte where the
// bf16 tensor cores, and not HBM, are the limit.  The design keeps every
// score and probability in registers (nothing of size Sq x Sk reaches
// memory) and runs both products of each step on the tensor cores.
//
// This source is the `mma` route: fp32 inputs, and bf16 only when asked
// for as the yardstick.  bf16 runs on flash_attention_sm90.cu (`wgmma` fed
// by TMA, warp-specialised); the wrapper's planner (`route`) picks.
//
// Design (FlashAttention-2's, on `mma.sync`):
// * Forward: a block takes the query rows of one (b, kv head, query head)
//   in four warps: in bf16 up to D 128, 128 rows, 32 a warp, so that each
//   K and V fragment a warp loads feeds two row tiles (FlashAttention-2's
//   shape); otherwise 64 rows, 16 a warp.  It walks the 64-key blocks
//   that the mask leaves non-empty for its rows (kv_range: the causal and
//   window skip; a skipped block adds exactly 0), K and V staged by
//   `cp.async` in a two-stage ring; only the blocks that the mask cuts
//   (edge_block) are masked element by element.  S = Q K^T and O += P V
//   run on `mma.sync.m16n8k16` (bf16 in, fp32 accumulate), fragments
//   loaded by `ldmatrix` (`.trans` for the right-hand operand of P V); P
//   goes from the accumulator to the next product's A operand in
//   registers.  The online softmax keeps fp32 running max and sum in the
//   log2 domain; P is rounded to bf16 before P V, as the reference
//   rounds its probabilities.  O is written in the input dtype and the
//   fp32 log-sum-exp (B, KV, G, Sq) for the backward.  Blocks are
//   launched heaviest first (the last Q blocks of a causal sequence).
// * Backward: delta = rowsum(dO * O) first (one warp a row).  Then a
//   block per (b, kv head, 64-key block) accumulates dK and dV in
//   registers over every Q block that sees its keys (q_range) and over
//   all G query heads of its KV head, so GQA needs no atomics; Q and dO
//   are staged, K and V stay resident.  A separate block per (b, kv, g,
//   Q block) accumulates dQ over its key blocks.  No floating atomics:
//   two runs give the same bits.
// * Strided inputs: q, k, v, O's gradient read where they lie (the last
//   dimension contiguous; every other stride a multiple of 16 bytes), so
//   MLA's v (a slice of a wider row) needs no copy.  Outputs are
//   contiguous, in the layout `.reshape(b, s, h * hd)` reads.
// * Head dims are padded in shared memory to 64, 128 or (D 192, Dv 128,
//   MLA) 192: columns past D arrive as zeros and add nothing (danube's
//   D = 120).  Rows past Sq or Sk arrive as zeros (`cp.async` zero fill).
// * float32 inputs run the same kernels with each product's fragments
//   computed by FMA on the CUDA cores in full fp32 (not TF32), in the
//   `mma.sync` accumulator layout, so that the masking, softmax and
//   stores are shared.
// * A row that no key may see gets O = 0 and lse = -inf.
//
// Contract (checked by the Python wrapper and again here): bf16 or fp32,
// D and Dv multiples of 16 bytes, D <= 128 and Dv <= 128 or D <= 192 and
// Dv <= 128, 16-byte aligned pointers and strides, window >= 0 (0: none),
// B * KV * G <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;                 // query rows of a block
constexpr int kBK = 64;                 // keys of a block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemMax = 232448;        // a block's opt-in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Dtype { kBf16 = 0, kF32 = 1 };
enum Error { kErrArgs = -1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // the forward's output (backward)
  const void* dout;   // its gradient (backward)
  void* out;          // O (forward)
  float* lse;         // (B, KV, G, Sq)
  float* delta;       // (B, KV, G, Sq), backward
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh, q_sg;     // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, do_sg;
  int B, Sq, Sk, KV, G, D, Dv;
  int causal, window, q_pos0;
  float scale, scale_log2;
};

// The KV blocks [lo, hi) that Q block qb (of bq rows) visits: those
// holding a key that some row of the block may see.  Mirrors
// kv_block_range in kernels/flash_attention.py.
__device__ __forceinline__ void kv_range(const Params& p, int qb, int bq,
                                         int& lo, int& hi) {
  const long long p0 = static_cast<long long>(p.q_pos0) + qb * bq;
  const long long p1 = static_cast<long long>(p.q_pos0) +
                       min(qb * bq + bq, p.Sq) - 1;
  long long kmin = 0, kmax = p.Sk - 1;
  if (p.window > 0) kmin = max(kmin, p0 - p.window + 1);
  if (p.causal) kmax = min(kmax, p1);
  if (kmin > kmax) {
    lo = hi = 0;
    return;
  }
  lo = static_cast<int>(kmin / kBK);
  hi = static_cast<int>(kmax / kBK) + 1;
}

// The Q blocks [lo, hi) that visit KV block kb (q_block_range).
__device__ __forceinline__ void q_range(const Params& p, int kb, int& lo,
                                        int& hi) {
  const long long k0 = static_cast<long long>(kb) * kBK;
  const long long k1 = min(kb * kBK + kBK, p.Sk) - 1;
  long long rmin = 0, rmax = p.Sq - 1;
  if (p.causal) rmin = max(rmin, k0 - p.q_pos0);
  if (p.window > 0) rmax = min(rmax, k1 + p.window - 1 - p.q_pos0);
  if (rmin > rmax) {
    lo = hi = 0;
    return;
  }
  lo = static_cast<int>(rmin / kBQ);
  hi = static_cast<int>(rmax / kBQ) + 1;
}

// may query position `pos` see key `key`?  (_mask_fn, and keys past Sk)
__device__ __forceinline__ bool visible(const Params& p, long long pos,
                                        int key) {
  return key < p.Sk && (!p.causal || key <= pos) &&
         (p.window == 0 || key > pos - p.window);
}

// does any (row, key) pair of the rows at positions [pq0, pq1] and keys
// [kb0, kb0 + kBK) fall outside the mask (keys past Sk included)?  Only
// such blocks are masked element by element.
__device__ __forceinline__ bool edge_block(const Params& p, int kb0,
                                           long long pq0, long long pq1) {
  return kb0 + kBK > p.Sk || (p.causal && kb0 + kBK - 1 > pq0) ||
         (p.window > 0 && kb0 <= pq1 - p.window);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3,
                                          const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// the backward's staging: two stages of `staged` elements where they fit
// beside `fixed` elements and `extra` bytes a stage, else one (fp32 at
// D 192)
constexpr int stages_for(int elem, int fixed, int staged, int extra) {
  return elem * (fixed + 2 * staged) + 2 * extra <= kSmemMax ? 2 : 1;
}

// Shared-memory tiles of 64 rows, padded by 16 bytes a row (ldmatrix's 8
// rows then fall in distinct banks).
template <typename T, int DP, int DVP>
struct Shapes {
  static constexpr int kPad = 16 / static_cast<int>(sizeof(T));
  static constexpr int LDQ = DP + kPad;          // Q and K rows
  static constexpr int LDV = DVP + kPad;         // V and dO rows
  static constexpr int kQ = kBQ * LDQ, kK = kBK * LDQ;
  static constexpr int kV = kBK * LDV, kO = kBQ * LDV;
  static constexpr int kE = sizeof(T);
  // forward: kMT row tiles of 16 a warp (bf16 up to D 128: two, so that
  // each K and V fragment feeds both), kBQF = 64 kMT query rows a block,
  // Q resident, K and V in two stages
  static constexpr int kMT = sizeof(T) == 2 && DP <= 128 ? 2 : 1;
  static constexpr int kBQF = kBQ * kMT;
  static constexpr int kQF = kBQF * LDQ;
  static constexpr int kFwdSmem = kE * (kQF + 2 * (kK + kV));
  static_assert(kFwdSmem <= kSmemMax, "the forward's two stages");
  // dq: Q and dO resident, K and V staged
  static constexpr int kDqStages = stages_for(kE, kQ + kO, kK + kV, 0);
  static constexpr int kDqSmem = kE * (kQ + kO + kDqStages * (kK + kV));
  // dkdv: K and V resident, Q and dO staged with each row's lse and delta
  static constexpr int kRows = 2 * kBQ * 4;
  static constexpr int kDkdvStages = stages_for(kE, kK + kV, kQ + kO, kRows);
  static constexpr int kDkdvSmem =
      kE * (kK + kV + kDkdvStages * (kQ + kO)) + kDkdvStages * kRows;
};

__device__ __forceinline__ void zero_smem(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
}

// Stage ROWS rows of `cols` elements (a multiple of 16 bytes) from `src`
// (row stride `stride`) into `dst` (row stride LD); rows from `valid` on
// arrive as zeros.  Columns past `cols` are left as they are (zero).
template <typename T, int LD, int ROWS = 64>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int valid,
                                          int cols) {
  constexpr int kE16 = 16 / static_cast<int>(sizeof(T));
  const int chunks = cols / kE16;
  for (int i = threadIdx.x; i < ROWS * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c * kE16, ok ? src + r * stride + c * kE16 : src,
               ok ? 16 : 0);
  }
}

// C[16 MT x 8 NT] += A[16 MT x KP] B[8 NT x KP]^T, A and B row-major in
// shared memory; C in the warp's mma.m16n8k16 accumulator layout, tile
// (mt, n) at acc[mt * NT + n] (thread (g, t) = (lane / 4, lane % 4) holds
// rows g and g + 8, columns 2t and 2t + 1 of each 16 x 8 tile).  Each B
// fragment feeds the MT row tiles.
template <int NT, int KP, int LDA, int LDB, int MT = 1>
__device__ __forceinline__ void gemm_nt(float (*acc)[4],
                                        const __nv_bfloat16* A,
                                        const __nv_bfloat16* B, int lane) {
  static_assert(NT % 2 == 0 && KP % 16 == 0, "tile");
  const __nv_bfloat16* a = A + (lane & 15) * LDA + (lane >> 4) * 8;
  const __nv_bfloat16* b =
      B + ((lane & 7) + (lane >> 4) * 8) * LDB + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KP / 16; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
              a + mt * 16 * LDA + ks * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3, b + np * 16 * LDB + ks * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt * NT + 2 * np], af[mt][0], af[mt][1], af[mt][2],
                 af[mt][3], b0, b1);
        mma_bf16(acc[mt * NT + 2 * np + 1], af[mt][0], af[mt][1], af[mt][2],
                 af[mt][3], b2, b3);
      }
    }
  }
}

// The same in fp32 by FMA, each thread computing its own accumulator
// elements.
template <int NT, int KP, int LDA, int LDB, int MT = 1>
__device__ __forceinline__ void gemm_nt(float (*acc)[4], const float* A,
                                        const float* B, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* b = B + 2 * t * LDB;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll 2
  for (int k = 0; k < KP; k += 4) {
    const float* a0 = A + (mt * 16 + g) * LDA;
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a0 + 8 * LDA + k);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 y0 = *reinterpret_cast<const float4*>(b + n * 8 * LDB + k);
      const float4 y1 =
          *reinterpret_cast<const float4*>(b + (n * 8 + 1) * LDB + k);
      float* c = acc[mt * NT + n];
      c[0] = fmaf(x0.w, y0.w, fmaf(x0.z, y0.z, fmaf(x0.y, y0.y,
                                                    fmaf(x0.x, y0.x, c[0]))));
      c[1] = fmaf(x0.w, y1.w, fmaf(x0.z, y1.z, fmaf(x0.y, y1.y,
                                                    fmaf(x0.x, y1.x, c[1]))));
      c[2] = fmaf(x1.w, y0.w, fmaf(x1.z, y0.z, fmaf(x1.y, y0.y,
                                                    fmaf(x1.x, y0.x, c[2]))));
      c[3] = fmaf(x1.w, y1.w, fmaf(x1.z, y1.z, fmaf(x1.y, y1.y,
                                                    fmaf(x1.x, y1.x, c[3]))));
    }
  }
}

// C[16 MT x 8 NT] += P[16 MT x 8 KT] B[8 KT x 8 NT]: P in registers in
// the accumulator layout (tile (mt, kt) at P[mt * KT + kt]; rounded to
// bf16 here), B row-major in shared memory; C at acc[mt * NT + n].
template <int NT, int KT, int LDB, int MT = 1>
__device__ __forceinline__ void gemm_rn(float (*acc)[4], float (*P)[4],
                                        const __nv_bfloat16* B, int lane) {
  static_assert(NT % 2 == 0 && KT % 2 == 0, "tile");
  const __nv_bfloat16* b =
      B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KT / 2; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p0 = P[mt * KT + 2 * ks];
      const float* p1 = P[mt * KT + 2 * ks + 1];
      af[mt][0] = pack_bf16(p0[0], p0[1]);
      af[mt][1] = pack_bf16(p0[2], p0[3]);
      af[mt][2] = pack_bf16(p1[0], p1[1]);
      af[mt][3] = pack_bf16(p1[2], p1[3]);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3, b + ks * 16 * LDB + np * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt * NT + 2 * np], af[mt][0], af[mt][1], af[mt][2],
                 af[mt][3], b0, b1);
        mma_bf16(acc[mt * NT + 2 * np + 1], af[mt][0], af[mt][1], af[mt][2],
                 af[mt][3], b2, b3);
      }
    }
  }
}

// The same in fp32: each P element is fetched from the lane that holds it.
template <int NT, int KT, int LDB, int MT = 1>
__device__ __forceinline__ void gemm_rn(float (*acc)[4], float (*P)[4],
                                        const float* B, int lane) {
  const int t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* pk = P[mt * KT + kt];
      const float p0 = __shfl_sync(0xffffffffu, pk[j & 1], quad | (j >> 1));
      const float p1 =
          __shfl_sync(0xffffffffu, pk[2 + (j & 1)], quad | (j >> 1));
      const float* row = B + (kt * 8 + j) * LDB + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(row + n * 8);
        float* c = acc[mt * NT + n];
        c[0] = fmaf(p0, y.x, c[0]);
        c[1] = fmaf(p0, y.y, c[1]);
        c[2] = fmaf(p1, y.x, c[2]);
        c[3] = fmaf(p1, y.y, c[3]);
      }
    }
}

template <int N>
__device__ __forceinline__ void zero(float (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
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

// --- forward -----------------------------------------------------------------

template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  using S = Shapes<T, DP, DVP>;
  constexpr int MT = S::kMT, BQ = S::kBQF;
  constexpr int NO = DVP / 8;                      // O's column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + S::kQF;
  T* sV = sK + 2 * S::kK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qb = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int bh = blockIdx.y;
  const int g = bh % p.G, kv = (bh / p.G) % p.KV, b = bh / (p.G * p.KV);
  const int q0 = qb * BQ;
  int lo, hi;
  kv_range(p, qb, BQ, lo, hi);
  zero_smem(smem, S::kFwdSmem);
  __syncthreads();
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_sh;
  auto issue = [&](int j, int st) {
    const int k0 = j * kBK;
    load_rows<T, S::LDQ>(sK + st * S::kK, kg + k0 * p.k_ss, p.k_ss,
                         p.Sk - k0, p.D);
    load_rows<T, S::LDV>(sV + st * S::kV, vg + k0 * p.v_ss, p.v_ss,
                         p.Sk - k0, p.Dv);
  };
  load_rows<T, S::LDQ, BQ>(sQ,
                           static_cast<const T*>(p.q) + b * p.q_sb +
                               q0 * p.q_ss + kv * p.q_sh + g * p.q_sg,
                           p.q_ss, p.Sq - q0, p.D);
  if (lo < hi) issue(lo, 0);
  cp_commit();

  // the warp's rows: r0 + 16 mt and r0 + 16 mt + 8
  const int r0 = q0 + warp * 16 * MT + (lane >> 2);
  const long long pos0 = static_cast<long long>(p.q_pos0) + r0;
  const long long pq0 = static_cast<long long>(p.q_pos0) + q0;
  const long long pq1 = pq0 + BQ - 1;
  float m[MT][2], l[MT][2];                         // log2 units
  float acc[MT * NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  zero<MT * NO>(acc);
  for (int j = lo; j < hi; ++j) {
    const int st = (j - lo) & 1;
    if (j + 1 < hi) issue(j + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    float s[MT * 8][4];
    zero<MT * 8>(s);
    gemm_nt<8, DP, S::LDQ, S::LDQ, MT>(s, sQ + warp * 16 * MT * S::LDQ,
                                       sK + st * S::kK, lane);
    const int kb0 = j * kBK;
    if (edge_block(p, kb0, pq0, pq1)) {
      const int key0 = kb0 + 2 * (lane & 3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(p, pos0 + mt * 16 + (e >> 1) * 8,
                         key0 + n * 8 + (e & 1)))
              s[mt * 8 + n][e] = -INFINITY;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt * 8 + n][0], s[mt * 8 + n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt * 8 + n][2], s[mt * 8 + n][3]));
      }
      float base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[mt][h], quad_max(mx[h]) * p.scale_log2);
        base[h] = mn == -INFINITY ? 0.f : mn;
        const float alpha = exp2f(m[mt][h] - base[h]);
        m[mt][h] = mn;
        l[mt][h] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[mt * NO + n][2 * h] *= alpha;
          acc[mt * NO + n][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s[mt * 8 + n][e];
          x = exp2f(fmaf(x, p.scale_log2, -base[e >> 1]));
          l[mt][e >> 1] += x;
        }
    }
    gemm_rn<NO, 8, S::LDV, MT>(acc, s, sV + st * S::kV, lane);
    __syncthreads();
  }
  cp_wait<0>();

  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = quad_sum(l[mt][h]);
      const int row = r0 + 16 * mt + 8 * h;
      if (row >= p.Sq) continue;
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      T* o = static_cast<T*>(p.out) +
             ((static_cast<long long>(b) * p.Sq + row) * p.KV + kv) * p.G *
                 p.Dv +
             static_cast<long long>(g) * p.Dv;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.Dv)
          store2(o + col, acc[mt * NO + n][2 * h] * inv,
                 acc[mt * NO + n][2 * h + 1] * inv);
      }
      if (t == 0)
        p.lse[static_cast<long long>(bh) * p.Sq + row] =
            sum > 0.f ? (m[mt][h] + log2f(sum)) * kLn2 : -INFINITY;
    }
}

// --- backward ----------------------------------------------------------------

// delta = rowsum(dO * O) in fp32, one warp a row (b, s, kv, g)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_delta_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= static_cast<long long>(p.B) * p.Sq * p.KV * p.G) return;
  const int g = static_cast<int>(r % p.G);
  const int kv = static_cast<int>((r / p.G) % p.KV);
  const int s = static_cast<int>((r / (p.G * p.KV)) % p.Sq);
  const int b = static_cast<int>(r / (static_cast<long long>(p.G) * p.KV *
                                      p.Sq));
  const T* o = static_cast<const T*>(p.o) + r * p.Dv;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + s * p.do_ss +
               kv * p.do_sh + g * p.do_sg;
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32) acc = fmaf(to_f(d[c]), to_f(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0)
    p.delta[((static_cast<long long>(b) * p.KV + kv) * p.G + g) * p.Sq + s] =
        acc;
}

// dK and dV of one 64-key block of one (b, kv head), over every Q block
// that sees it and every query head of the KV head.  Warp w owns keys
// 16 w .. 16 w + 15; a Q block is taken in two halves of 32 rows.
template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(kThreads)
    flash_dkdv_kernel(const Params p) {
  using S = Shapes<T, DP, DVP>;
  constexpr int kSt = S::kDkdvStages;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + S::kK;
  T* sQ = sV + S::kV;                              // kSt stages
  T* sO = sQ + kSt * S::kQ;                        // dO, kSt stages
  float* sL = reinterpret_cast<float*>(sO + kSt * S::kO);  // [kSt][kBQ]
  float* sD = sL + kSt * kBQ;                      // [kSt][kBQ]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kb = blockIdx.x;
  const int kv = blockIdx.y % p.KV, b = blockIdx.y / p.KV;
  const int k0 = kb * kBK;
  int lo, hi;
  q_range(p, kb, lo, hi);
  const int nq = hi - lo, n_it = p.G * nq;
  zero_smem(smem, S::kDkdvSmem);
  __syncthreads();
  load_rows<T, S::LDQ>(sK,
                       static_cast<const T*>(p.k) + b * p.k_sb + k0 * p.k_ss +
                           kv * p.k_sh,
                       p.k_ss, p.Sk - k0, p.D);
  load_rows<T, S::LDV>(sV,
                       static_cast<const T*>(p.v) + b * p.v_sb + k0 * p.v_ss +
                           kv * p.v_sh,
                       p.v_ss, p.Sk - k0, p.Dv);
  auto issue = [&](int it, int st) {
    const int gi = it / nq, q0 = (lo + it % nq) * kBQ;
    load_rows<T, S::LDQ>(sQ + st * S::kQ,
                         static_cast<const T*>(p.q) + b * p.q_sb +
                             q0 * p.q_ss + kv * p.q_sh + gi * p.q_sg,
                         p.q_ss, p.Sq - q0, p.D);
    load_rows<T, S::LDV>(sO + st * S::kO,
                         static_cast<const T*>(p.dout) + b * p.do_sb +
                             q0 * p.do_ss + kv * p.do_sh + gi * p.do_sg,
                         p.do_ss, p.Sq - q0, p.Dv);
    const long long base =
        ((static_cast<long long>(b) * p.KV + kv) * p.G + gi) * p.Sq;
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const int row = q0 + r;
      float lse2 = INFINITY, dl = 0.f;      // rows past Sq: P = 0
      if (row < p.Sq) {
        const float x = p.lse[base + row];
        lse2 = x == -INFINITY ? INFINITY : x * kLog2e;
        dl = p.delta[base + row];
      }
      sL[st * kBQ + r] = lse2;
      sD[st * kBQ + r] = dl;
    }
  };
  if (n_it > 0) issue(0, 0);
  cp_commit();

  const int t = lane & 3;
  const int kr = k0 + warp * 16 + (lane >> 2);    // keys kr and kr + 8
  float dk[DP / 8][4], dv[DVP / 8][4];
  zero<DP / 8>(dk);
  zero<DVP / 8>(dv);
  for (int it = 0; it < n_it; ++it) {
    const int st = kSt == 2 ? it & 1 : 0;
    if (kSt == 2) {
      if (it + 1 < n_it) issue(it + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int q0 = (lo + it % nq) * kBQ;
    const long long pq0 = static_cast<long long>(p.q_pos0) + q0;
    // rows past Sq need no mask: their lse2 is +inf, so P = 0
    const bool edge = edge_block(p, k0, pq0, pq0 + kBQ - 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const T* sQh = sQ + st * S::kQ + half * 32 * S::LDQ;
      const T* sOh = sO + st * S::kO + half * 32 * S::LDV;
      const float* lse2 = sL + st * kBQ + half * 32;
      const float* dl = sD + st * kBQ + half * 32;
      // P^T (16 keys x 32 rows)
      float pt[4][4];
      zero<4>(pt);
      gemm_nt<4, DP, S::LDQ, S::LDQ>(pt, sK + warp * 16 * S::LDQ, sQh, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const bool ok = !edge || visible(p, pq0 + half * 32 + c,
                                           kr + (e >> 1) * 8);
          pt[n][e] = ok ? exp2f(fmaf(pt[n][e], p.scale_log2, -lse2[c]))
                        : 0.f;
        }
      gemm_rn<DVP / 8, 4, S::LDV>(dv, pt, sOh, lane);
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
      float ds[4][4];
      zero<4>(ds);
      gemm_nt<4, DVP, S::LDV, S::LDV>(ds, sV + warp * 16 * S::LDV, sOh, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = pt[n][e] * (ds[n][e] - dl[n * 8 + 2 * t + (e & 1)]);
      gemm_rn<DP / 8, 4, S::LDQ>(dk, ds, sQh, lane);
    }
    __syncthreads();
    if (kSt == 1 && it + 1 < n_it) {
      issue(it + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr + 8 * h;
    if (key >= p.Sk) continue;
    const long long row = (static_cast<long long>(b) * p.Sk + key) * p.KV + kv;
    T* dkr = static_cast<T*>(p.dk) + row * p.D;
    T* dvr = static_cast<T*>(p.dv) + row * p.Dv;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D)
        store2(dkr + col, dk[n][2 * h] * p.scale, dk[n][2 * h + 1] * p.scale);
    }
#pragma unroll
    for (int n = 0; n < DVP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.Dv) store2(dvr + col, dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// dQ of one Q block of one (b, kv, g), over the key blocks it sees.
template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  using S = Shapes<T, DP, DVP>;
  constexpr int kSt = S::kDqStages;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + S::kQ;                              // dO
  T* sK = sO + S::kO;
  T* sV = sK + kSt * S::kK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int g = bh % p.G, kv = (bh / p.G) % p.KV, b = bh / (p.G * p.KV);
  const int q0 = qb * kBQ;
  int lo, hi;
  kv_range(p, qb, kBQ, lo, hi);
  zero_smem(smem, S::kDqSmem);
  __syncthreads();
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_sh;
  auto issue = [&](int j, int st) {
    const int k0 = j * kBK;
    load_rows<T, S::LDQ>(sK + st * S::kK, kg + k0 * p.k_ss, p.k_ss,
                         p.Sk - k0, p.D);
    load_rows<T, S::LDV>(sV + st * S::kV, vg + k0 * p.v_ss, p.v_ss,
                         p.Sk - k0, p.Dv);
  };
  load_rows<T, S::LDQ>(sQ,
                       static_cast<const T*>(p.q) + b * p.q_sb +
                           q0 * p.q_ss + kv * p.q_sh + g * p.q_sg,
                       p.q_ss, p.Sq - q0, p.D);
  load_rows<T, S::LDV>(sO,
                       static_cast<const T*>(p.dout) + b * p.do_sb +
                           q0 * p.do_ss + kv * p.do_sh + g * p.do_sg,
                       p.do_ss, p.Sq - q0, p.Dv);
  if (lo < hi) issue(lo, 0);
  cp_commit();

  const int t = lane & 3;
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const long long pos0 = static_cast<long long>(p.q_pos0) + r0;
  const long long pq0 = static_cast<long long>(p.q_pos0) + q0;
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
  float dq[DP / 8][4];
  zero<DP / 8>(dq);
  for (int j = lo; j < hi; ++j) {
    const int st = kSt == 2 ? (j - lo) & 1 : 0;
    if (kSt == 2) {
      if (j + 1 < hi) issue(j + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[8][4];
    zero<8>(s);
    gemm_nt<8, DP, S::LDQ, S::LDQ>(s, sQ + warp * 16 * S::LDQ,
                                   sK + st * S::kK, lane);
    const int kb0 = j * kBK;
    const bool edge = edge_block(p, kb0, pq0, pq0 + kBQ - 1);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = !edge || visible(p, pos0 + (e >> 1) * 8,
                                   kb0 + 2 * t + n * 8 + (e & 1))
                      ? exp2f(fmaf(s[n][e], p.scale_log2, -lse2[e >> 1]))
                      : 0.f;
    float ds[8][4];
    zero<8>(ds);
    gemm_nt<8, DVP, S::LDV, S::LDV>(ds, sO + warp * 16 * S::LDV,
                                    sV + st * S::kV, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = s[n][e] * (ds[n][e] - dl[e >> 1]);
    gemm_rn<DP / 8, 8, S::LDQ>(dq, ds, sK + st * S::kK, lane);
    __syncthreads();
    if (kSt == 1 && j + 1 < hi) {
      issue(j + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= p.Sq) continue;
    T* o = static_cast<T*>(p.dq) +
           ((static_cast<long long>(b) * p.Sq + row) * p.KV + kv) * p.G *
               p.D +
           static_cast<long long>(g) * p.D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.D)
        store2(o + col, dq[n][2 * h] * p.scale, dq[n][2 * h + 1] * p.scale);
    }
  }
}

// --- launch ------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename K>
int launch(K kernel, dim3 grid, int smem, const Params& p,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP, int DVP>
int run_fwd(const Params& p, cudaStream_t st) {
  using S = Shapes<T, DP, DVP>;
  return launch(flash_fwd_kernel<T, DP, DVP>,
                dim3(cdiv(p.Sq, S::kBQF), p.B * p.KV * p.G), S::kFwdSmem, p,
                st);
}

template <typename T, int DP, int DVP>
int run_bwd(const Params& p, cudaStream_t st) {
  using S = Shapes<T, DP, DVP>;
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.KV * p.G;
  int e = launch(flash_delta_kernel<T>,
                 dim3(static_cast<unsigned>((rows + kWarps - 1) / kWarps)), 0,
                 p, st);
  if (e) return e;
  e = launch(flash_dkdv_kernel<T, DP, DVP>,
             dim3(cdiv(p.Sk, kBK), p.B * p.KV), S::kDkdvSmem, p, st);
  if (e) return e;
  return launch(flash_dq_kernel<T, DP, DVP>,
                dim3(cdiv(p.Sq, kBQ), p.B * p.KV * p.G), S::kDqSmem, p, st);
}

// the padded head dims: 64 or 128 for both, or 192 with Dv <= 128 (MLA)
int padded(int D, int Dv) {
  if (D <= 64 && Dv <= 64) return 64;
  if (D <= 128 && Dv <= 128) return 128;
  if (D <= 192 && Dv <= 128) return 192;
  return 0;
}

template <typename T>
int dispatch(bool fwd, const Params& p, cudaStream_t st) {
  switch (padded(p.D, p.Dv)) {
    case 64:
      return fwd ? run_fwd<T, 64, 64>(p, st) : run_bwd<T, 64, 64>(p, st);
    case 128:
      return fwd ? run_fwd<T, 128, 128>(p, st) : run_bwd<T, 128, 128>(p, st);
    case 192:
      return fwd ? run_fwd<T, 192, 128>(p, st) : run_bwd<T, 192, 128>(p, st);
    default:
      return kErrArgs;
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Fills p from the arguments; false when they break the contract.
// strides: q (batch, row, kv head, query head), k (3), v (3), dO (4).
bool setup(Params& p, int dtype, const long long* strides, int B, int Sq,
           int Sk, int KV, int G, int D, int Dv, int causal, int window,
           int q_pos0, bool bwd) {
  if (dtype != kBf16 && dtype != kF32) return false;
  const int elem = dtype == kBf16 ? 2 : 4;
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || G < 1 || D < 1 || Dv < 1 ||
      window < 0 || padded(D, Dv) == 0 || (D * elem) % 16 ||
      (Dv * elem) % 16 || static_cast<long long>(B) * KV * G > 65535)
    return false;
  for (int i = 0; i < (bwd ? 14 : 10); ++i)
    if ((strides[i] * elem) % 16) return false;
  if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v)) return false;
  if (bwd && (!aligned16(p.o) || !aligned16(p.dout))) return false;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.q_sg = strides[3];
  p.k_sb = strides[4];
  p.k_ss = strides[5];
  p.k_sh = strides[6];
  p.v_sb = strides[7];
  p.v_ss = strides[8];
  p.v_sh = strides[9];
  p.do_sb = bwd ? strides[10] : 0;
  p.do_ss = bwd ? strides[11] : 0;
  p.do_sh = bwd ? strides[12] : 0;
  p.do_sg = bwd ? strides[13] : 0;
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

// Forward on `stream`: q, k, v as in the header (dtype 0 bf16, 1 fp32),
// out (B, Sq, KV, G, Dv) contiguous in their dtype, lse (B, KV, G, Sq)
// fp32.  One launch.  Returns 0, a CUDA error code, or kErrArgs.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* out, void* lse,
                        const long long* strides, int B, int Sq, int Sk,
                        int KV, int G, int D, int Dv, int causal, int window,
                        int q_pos0, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  if (!setup(p, dtype, strides, B, Sq, Sk, KV, G, D, Dv, causal, window,
             q_pos0, false) ||
      !aligned16(out))
    return kErrArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kBf16 ? dispatch<__nv_bfloat16>(true, p, st)
                        : dispatch<float>(true, p, st);
}

// Backward on `stream`: from q, k, v, the forward's out and lse and the
// gradient dout (strided like q), dq (B, Sq, KV, G, D), dk (B, Sk, KV, D)
// and dv (B, Sk, KV, Dv), contiguous; `delta` is (B, KV, G, Sq) fp32
// scratch.  Three launches: delta, dK and dV, dQ.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* out, const void* dout,
                        const void* lse, void* delta, void* dq, void* dk,
                        void* dv, const long long* strides, int B, int Sq,
                        int Sk, int KV, int G, int D, int Dv, int causal,
                        int window, int q_pos0, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.dout = dout;
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  if (!setup(p, dtype, strides, B, Sq, Sk, KV, G, D, Dv, causal, window,
             q_pos0, true) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return kErrArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kBf16 ? dispatch<__nv_bfloat16>(false, p, st)
                        : dispatch<float>(false, p, st);
}

const char* flash_attention_error_string(int code) {
  if (code == kErrArgs) return "arguments outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
