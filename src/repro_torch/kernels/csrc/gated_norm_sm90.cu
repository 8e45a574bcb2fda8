// Mamba-2's gated output norm, forward and backward, for NVIDIA Hopper
// (sm_90a), in bf16: rows streamed by bulk TMA copies into a ring of
// shared-memory stages, a row wider than a block's ring budget split over a
// thread-block cluster.
//
// Replaces no Pallas kernel: the reference computes the gate and the norm in
// XLA, the tail of `ssm_apply` (src/repro/models/ssm.py:140-143).  A row of
// d = heads * hp columns:
//   v   = y + x * D[head]          (optional: decode's y has its skip already)
//   g   = v * silu(z)
//   out = g * rsqrt(mean(g^2) + eps) * w
// rounded to bf16 where the reference rounds (x * D, v, silu(z), g and the
// output; `gate_pair`), the norm in fp32.  Backward, with
// r = rsqrt(mean(g^2) + eps):
//   dg = r (dout w) - g r^3 mean(dout w g),   dy = dg silu(z),
//   dz = dg v silu'(z),   dx = dy D,   dw = sum_rows dout g r,
//   dD[h] = sum_rows sum_(columns of h) dy x.
// csrc/gated_norm.py (Triton, the `triton` route) holds the same functions
// for fp32 and for operands this file does not take; the wrapper's router
// (kernels/gated_norm_sm90.py, `route`) sends every bf16 call whose rows
// are 16-byte aligned here.
//
// Bound on this card: bytes.  The forward reads y, x, z and writes the
// output (8 bytes an element in bf16), the backward reads dout, y, x, z and
// writes dy, dx, dz (14 bytes), against about 11 and 30 fp32 operations an
// element (on an H100 the backward at mamba2-780m's width is held by that
// arithmetic more than by its bytes: PERF.md).  What the design does:
// * A persistent grid, two blocks an SM, each block (or cluster) walking
//   rows c, c + n, c + 2n, ...  One producer thread keeps the next rows'
//   operands arriving: one `cp.async.bulk` copy of each operand's row (from
//   its own base and row strides: z and x are read where they lie, views of
//   wider rows) into a ring of at least three stages, completing on the
//   stage's `mbarrier`.  The copies cost the consumers no registers and no
//   instructions, and a row's loads never wait on the last row's stores.
// * Eight consumer warps hold 16-byte vectors of the row, VPT a thread over
//   the row's true width (no padding of 48 heads to 64); w and D are read
//   once a block, into registers.  A row takes two passes over its stage:
//   pass 1 computes g and the row's sums (sum g^2; backward also sum dout w
//   g), the forward writing g (exact in bf16) over y's slot; pass 2 reads
//   the stage again, shared memory and not global, for the output (16-byte
//   stores) or the gradients.  No barrier of the block a row: each warp
//   publishes its sums (shuffles, then a shared-memory slot and an
//   `mbarrier` arrive), and pass 1 of the next row runs before this row's
//   sums are awaited, so the warps drift freely and the sums' latency hides
//   under real work.
// * The backward keeps its dw and dD partials in fp32 registers across all
//   of a block's rows and writes one partial row at its end; the wrapper
//   sums the partials in a fixed order (csrc/causal_conv.py's
//   `colsum_kernel`).  No atomics: two runs, and CUDA-graph replays, give the
//   same bits.
// * A row whose staged operands pass a block's ring budget (jamba's 16384
//   columns: 32 KB an operand, 128 KB a backward stage) runs on a cluster of
//   2 or 4 blocks, each loading a head-aligned share of every row of the
//   cluster, so the row is read from HBM once.  Each warp publishes its
//   row sums into every block of the cluster through distributed shared
//   memory (`mapa`, then `st.async` completing on the target block's
//   `mbarrier`): no fence, so no wait on the warp's own global stores.
//
// Launches: one forward, one backward (the wrapper's sum of the partials is
// a second).  Contract (checked by the Python wrapper and again here): bf16
// y, z, x and dout; w and D bf16 or fp32; hp a multiple of 8; 16-byte
// aligned bases and row strides; the launch shape from the wrapper's
// planner (kernels/gated_norm_sm90.py, `plan`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxStages = 8;
constexpr int kWarps = 8;        // consumer warps a block
constexpr int kCons = kWarps * 32;
constexpr int kThreads = kCons + 32;  // and the producer warp
constexpr int kMaxCluster = 4;
constexpr int kMaxVpt = 4;       // 16-byte vectors a consumer thread holds
constexpr int kVec = 8;          // columns a vector
constexpr int kMaxOps = 4;       // y, z, x, dout
constexpr int kSumBufs = 4;      // rows whose sums may be in flight
// the shared-memory header: the barriers (full and empty a stage; the
// warps' sums a buffer, alone and in a cluster), the warps' sums (kSumBufs
// x warps pairs), the cluster's (kSumBufs x cluster x warps pairs), dD's
// per-vector partials; the ring after it (kernels/gated_norm.py's
// SM90_HEADER must match)
constexpr int kLocOff = 256;
constexpr int kClOff = kLocOff + kSumBufs * kWarps * 2 * 4;
constexpr int kVaccOff = kClOff + kSumBufs * kMaxCluster * kWarps * 2 * 4;
constexpr int kRingOff = kVaccOff + kCons * kMaxVpt * 4;

enum Error { kErrArgs = -1, kErrSmem = -2, kErrConfig = -3 };

struct Params {
  const bf16* in[kMaxOps];  // y, z, then x (with the skip), then dout
  long long sb[kMaxOps];    // each operand's batch stride (elements)
  long long ss[kMaxOps];    // and sequence stride
  const void* w;            // (d,), bf16 or fp32
  const void* D;            // (heads,), bf16 or fp32
  bf16* out;                // (R, d): the output, or dy (backward)
  bf16* dz;                 // (R, d) (backward)
  bf16* dx;                 // (R, d) (backward, with the skip)
  float* part;              // (clusters, d + heads) (backward)
  float eps;
  int R, S, d, heads, hp, share, nvec, nops, stages, cs, skip, w_f32, d_f32;
  uint32_t op_bytes;        // an operand's slot in a stage (128-byte units)
  uint32_t stage_bytes;     // a stage: nops slots
  uint32_t tx_bytes;        // the bytes a stage's copies bring
};

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

// the wait of a barrier that other blocks of the cluster arrive on: acquire
// at cluster scope, so their stores before the arrive are seen
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one bulk copy (no tensor map) of `bytes` (a multiple of 16) from global
// memory into this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// `a`'s address in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(a)), "r"(rank));
  return r;
}

// an asynchronous store of (a, b) into another block's shared memory (a
// `mapa` address), completing 8 bytes of the transaction count of that
// block's barrier `bar` (a `mapa` address): whoever observes the barrier's
// phase complete sees the store, with no fence on this side
__device__ __forceinline__ void cluster_store2_async(uint32_t addr, float a,
                                                     float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// barrier 1: the consumer warps among themselves
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCons) : "memory");
}

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack8(const uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint4 lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void stg16(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// w's 8 values at columns col .. col + 7, in fp32
__device__ __forceinline__ void load_w8(const Params& p, int col, float* f) {
  if (p.w_f32) {
    const float4* src = reinterpret_cast<const float4*>(
        static_cast<const float*>(p.w) + col);
    const float4 a = src[0], b = src[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    unpack8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.w) +
                                            col),
            f);
  }
}

// D[h] rounded to bf16, as the reference casts it to the compute dtype
__device__ __forceinline__ float load_d(const Params& p, int h) {
  return p.d_f32 ? rnd(static_cast<const float*>(p.D)[h])
                 : __bfloat162float(static_cast<const bf16*>(p.D)[h]);
}

typedef __nv_bfloat162 bf2;

// pair e (columns 2e, 2e + 1) of a 16-byte vector of 8 bf16 values
__device__ __forceinline__ bf2 pair(const uint4& u, int e) {
  return reinterpret_cast<const bf2*>(&u)[e];
}

__device__ __forceinline__ void set_pair(uint4& u, int e, bf2 v) {
  reinterpret_cast<bf2*>(&u)[e] = v;
}

// a * b and a + b of bf16 pairs, each rounded once to nearest even; the
// explicit `.rn` keeps ptxas from fusing a product and a sum into one FMA
// (PTX lets it fuse them without a rounding modifier, as `__hmul2` and
// `__hadd2` issue them: the skip's x D + y then rounds once, not twice)
__device__ __forceinline__ bf2 mul_rn(bf2 a, bf2 b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(d)
      : "r"(*reinterpret_cast<const uint32_t*>(&a)),
        "r"(*reinterpret_cast<const uint32_t*>(&b)));
  return *reinterpret_cast<const bf2*>(&d);
}

__device__ __forceinline__ bf2 add_rn(bf2 a, bf2 b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(d)
      : "r"(*reinterpret_cast<const uint32_t*>(&a)),
        "r"(*reinterpret_cast<const uint32_t*>(&b)));
  return *reinterpret_cast<const bf2*>(&d);
}

// The gate's roundings of one pair of columns, as the reference rounds them
// (ssm.py:140-142): v = y + x D (x D and the sum each rounded), s = silu(z)
// rounded, g = v s rounded.  Each bf16 operation (`mul_rn`, `add_rn`: one
// rounding to nearest even, no contraction) gives the bits of the fp32
// operation rounded as the reference rounds it: a product of two bf16
// values is exact in fp32, and where fp32 cannot hold a sum of two exactly
// the smaller is far below half the larger's bf16 ulp, so both round to
// the larger.  Two columns an instruction: on an H100 the backward was
// bound by its arithmetic (without its stores it ran at 47% of the bound
// of its loads alone).  Also sig = sigmoid(z) and z in fp32 (the
// backward's silu' is sig (1 + z (1 - sig))).
struct Pair {
  bf2 v, s, g;
  float2 z, sig;
};

__device__ __forceinline__ Pair gate_pair(bf2 y, bf2 z, bf2 x, bf2 dd,
                                          bool skip) {
  Pair q;
  q.v = skip ? add_rn(y, mul_rn(x, dd)) : y;
  q.z = __bfloat1622float2(z);
  q.sig.x = __fdividef(1.f, 1.f + __expf(-q.z.x));
  q.sig.y = __fdividef(1.f, 1.f + __expf(-q.z.y));
  q.s = __floats2bfloat162_rn(__fmul_rn(q.z.x, q.sig.x),
                              __fmul_rn(q.z.y, q.sig.y));
  q.g = mul_rn(q.v, q.s);
  return q;
}

// The shared-memory state a block's threads share.
struct Shared {
  uint64_t* full;    // a stage's operands have arrived
  uint64_t* empty;   // a stage's consumer warps are done with it
  uint64_t* lbar;    // a buffer's warps have published their sums (cs 1)
  uint64_t* xbar;    // a buffer's cluster warps have published theirs
  float* loc;        // (kSumBufs, kWarps, 2): the warps' sums (cs 1)
  float* cl;         // (kSumBufs, kMaxCluster, kWarps, 2): the cluster's
  float* vacc;       // (nvec,): dD's per-vector partials (backward)
  unsigned char* ring;
};

// A row's sums (sum a, sum c) without a barrier of the block: each warp's
// pair, reduced by shuffles, goes by its lane 0 into slot `warp` of buffer
// k % kSumBufs.  A block alone (cs 1) stores it and arrives on the buffer's
// barrier (`lbar`, a warp's arrival each).  In a cluster the lane stores it
// into slot (rank, warp) of every block by `st.async`, each completing 8
// bytes of that block's barrier (`xbar`), whose one arrival a row is warp
// 0's, with the bytes the cluster's warps send (no release fence waits on
// the lane's global stores: on an H100 a release arrive took jamba's
// forward from 0.20 to 0.33 ms).  Every reader adds the slots in the same
// order, so every block of a cluster gets the same bits.  A warp publishes
// row k + 1 before it awaits row k's sums, so a row k + 4 store reaches a
// block only after that block's warps have published row k + 2, hence read
// row k's sums and seen its barrier's phase complete: four buffers suffice.
template <bool kTwo>
__device__ __forceinline__ void publish(float a, float c, const Shared& sh,
                                        int k, int cs, int rank, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xFFFFFFFFu, a, o);
    if (kTwo) c += __shfl_xor_sync(0xFFFFFFFFu, c, o);
  }
  if (tid & 31) return;
  const int buf = k % kSumBufs, warp = tid >> 5;
  if (cs == 1) {
    float* slot = sh.loc + (buf * kWarps + warp) * 2;
    slot[0] = a;
    slot[1] = c;
    mbar_arrive(&sh.lbar[buf]);
    return;
  }
  if (warp == 0) mbar_expect_tx(&sh.xbar[buf], cs * kWarps * 8);
  float* slot = sh.cl + ((buf * kMaxCluster + rank) * kWarps + warp) * 2;
  for (int q = 0; q < cs; ++q)
    cluster_store2_async(cluster_addr(slot, q), a, c,
                         cluster_addr(&sh.xbar[buf], q));
}

__device__ __forceinline__ float2 row_sums(const Shared& sh, int k, int cs) {
  const int buf = k % kSumBufs;
  const uint32_t parity = (k / kSumBufs) & 1;
  const float* slot;
  if (cs == 1) {
    mbar_wait(&sh.lbar[buf], parity);
    slot = sh.loc + buf * kWarps * 2;
  } else {
    mbar_wait_cluster(&sh.xbar[buf], parity);
    slot = sh.cl + buf * kMaxCluster * kWarps * 2;
  }
  float A = 0.f, C = 0.f;
  for (int q = 0; q < cs * kWarps; ++q) {
    A += slot[2 * q];
    C += slot[2 * q + 1];
  }
  return make_float2(A, C);
}

// The producer thread: each of the block's rows, the block's share of every
// operand, into the ring.
__device__ __forceinline__ void produce(const Params& p, const Shared& sh,
                                        int cid, int ncl, int rank) {
  const long long col0 = static_cast<long long>(rank) * p.share;
  const uint32_t bytes = static_cast<uint32_t>(p.share) * 2;
  int s = 0;
  uint32_t ph = 0;
  for (int row = cid; row < p.R; row += ncl) {
    mbar_wait(&sh.empty[s], ph ^ 1);
    mbar_expect_tx(&sh.full[s], p.tx_bytes);
    const long long b = row / p.S, t = row - b * p.S;
    unsigned char* dst = sh.ring + static_cast<size_t>(s) * p.stage_bytes;
    for (int o = 0; o < p.nops; ++o)
      bulk_load(dst + o * p.op_bytes,
                p.in[o] + b * p.sb[o] + t * p.ss[o] + col0, bytes,
                &sh.full[s]);
    if (++s == p.stages) {
      s = 0;
      ph ^= 1;
    }
  }
}

// A consumer thread's share of the row: its vectors j = tid + i * kCons
// (i < VPT, j < nvec), w and round(D) at their columns, and (backward) its
// dw and dD partials.
template <int VPT, bool BWD>
struct Lanes {
  float w[VPT][8], dd[VPT];
  bf2 dd2[VPT];
  float accw[BWD ? VPT : 1][8], accd[VPT];
};

// pass 1 of row k (stage `st`): g and the row's partial sums, published; the
// forward writes g (bf16, exact: it is rounded) over y's slot for pass 2
template <int VPT, bool BWD>
__device__ __forceinline__ void pass1(const Params& p,
                                      const Lanes<VPT, BWD>& l,
                                      unsigned char* st, const Shared& sh,
                                      int k, int rank, int tid) {
  const uint32_t op = p.op_bytes;
  const bool skip = p.skip;
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + i * kCons;
    if (j < p.nvec) {
      const uint4 y = lds16(st + j * 16), z = lds16(st + op + j * 16);
      uint4 x = y, o = y, g;
      if (skip) x = lds16(st + 2 * op + j * 16);
      if (BWD) o = lds16(st + (p.nops - 1) * op + j * 16);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Pair q = gate_pair(pair(y, e), pair(z, e), pair(x, e),
                                 l.dd2[i], skip);
        const float2 gf = __bfloat1622float2(q.g);
        a = fmaf(gf.x, gf.x, a);
        a = fmaf(gf.y, gf.y, a);
        if (BWD) {
          const float2 of = __bfloat1622float2(pair(o, e));
          c = fmaf(__fmul_rn(of.x, l.w[i][2 * e]), gf.x, c);
          c = fmaf(__fmul_rn(of.y, l.w[i][2 * e + 1]), gf.y, c);
        } else {
          set_pair(g, e, q.g);
        }
      }
      if (!BWD) *reinterpret_cast<uint4*>(st + j * 16) = g;
    }
  }
  publish<BWD>(a, c, sh, k, p.cs, rank, tid);
}

// pass 2 of row `row` (stage `st`) from its sums: the output, or the
// gradients and the partials
template <int VPT, bool BWD>
__device__ __forceinline__ void pass2(const Params& p, Lanes<VPT, BWD>& l,
                                      const unsigned char* st, int row,
                                      float2 tot, int col_base, int tid) {
  const uint32_t op = p.op_bytes;
  const bool skip = p.skip;
  const float fd = static_cast<float>(p.d);
  const float r = rsqrtf(__fdiv_rn(tot.x, fd) + p.eps);
  const float coef = BWD ? __fdiv_rn(r * r * r * tot.y, fd) : 0.f;
  const long long orow = static_cast<long long>(row) * p.d + col_base;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + i * kCons;
    if (j >= p.nvec) continue;
    if (!BWD) {
      const uint4 g = lds16(st + j * 16);
      uint4 out;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 gf = __bfloat1622float2(pair(g, e));
        const float o0 = __fmul_rn(__fmul_rn(gf.x, r), l.w[i][2 * e]);
        const float o1 = __fmul_rn(__fmul_rn(gf.y, r), l.w[i][2 * e + 1]);
        set_pair(out, e, __floats2bfloat162_rn(o0, o1));
      }
      stg16(p.out + orow + j * 8, out);
    } else {
      const uint4 y = lds16(st + j * 16), z = lds16(st + op + j * 16),
                  o = lds16(st + (p.nops - 1) * op + j * 16);
      uint4 x = y, dy, dz, dx;
      if (skip) x = lds16(st + 2 * op + j * 16);
      float hd = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Pair q = gate_pair(pair(y, e), pair(z, e), pair(x, e),
                                 l.dd2[i], skip);
        const float2 vf = __bfloat1622float2(q.v),
                     sf = __bfloat1622float2(q.s),
                     gf = __bfloat1622float2(q.g),
                     of = __bfloat1622float2(pair(o, e));
        const float vv[2] = {vf.x, vf.y}, ss[2] = {sf.x, sf.y},
                    gg[2] = {gf.x, gf.y}, oo[2] = {of.x, of.y},
                    zz[2] = {q.z.x, q.z.y}, sg[2] = {q.sig.x, q.sig.y};
        float ddy[2], ddz[2], ddx[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dg = r * (oo[h] * l.w[i][2 * e + h]) - gg[h] * coef;
          ddy[h] = dg * ss[h];
          ddz[h] = dg * vv[h] * sg[h] * (1.f + zz[h] * (1.f - sg[h]));
          ddx[h] = ddy[h] * l.dd[i];
          l.accw[BWD ? i : 0][2 * e + h] += oo[h] * (gg[h] * r);
        }
        if (skip) {
          const float2 xf = __bfloat1622float2(pair(x, e));
          hd += ddy[0] * xf.x;
          hd += ddy[1] * xf.y;
        }
        set_pair(dy, e, __floats2bfloat162_rn(ddy[0], ddy[1]));
        set_pair(dz, e, __floats2bfloat162_rn(ddz[0], ddz[1]));
        set_pair(dx, e, __floats2bfloat162_rn(ddx[0], ddx[1]));
      }
      l.accd[i] += hd;
      stg16(p.out + orow + j * 8, dy);
      stg16(p.dz + orow + j * 8, dz);
      if (skip) stg16(p.dx + orow + j * 8, dx);
    }
  }
}

template <int VPT, bool BWD>
__global__ void __launch_bounds__(kThreads, 2)
    gate_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Shared sh;
  sh.full = reinterpret_cast<uint64_t*>(smem);
  sh.empty = sh.full + kMaxStages;
  sh.lbar = sh.empty + kMaxStages;
  sh.xbar = sh.lbar + kSumBufs;
  sh.loc = reinterpret_cast<float*>(smem + kLocOff);
  sh.cl = reinterpret_cast<float*>(smem + kClOff);
  sh.vacc = reinterpret_cast<float*>(smem + kVaccOff);
  sh.ring = smem + kRingOff;
  const int tid = threadIdx.x;
  const int cs = p.cs;
  const int rank = cs > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int cid = blockIdx.x / cs;
  const int ncl = gridDim.x / cs;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], kWarps);
    }
    for (int b = 0; b < kSumBufs; ++b) {
      mbar_init(&sh.lbar[b], kWarps);
      mbar_init(&sh.xbar[b], 1);
    }
    fence_mbarrier_init();
  }
  // every block's barriers are set before any peer arrives on them
  if (cs > 1)
    cluster_sync();
  else
    __syncthreads();

  if (tid >= kCons) {
    if (tid == kCons) produce(p, sh, cid, ncl, rank);
  } else {
    const int col_base = rank * p.share;
    Lanes<VPT, BWD> l;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = tid + i * kCons;
      const bool on = j < p.nvec;
      if (on) load_w8(p, col_base + j * 8, l.w[i]);
      l.dd[i] = on && p.skip ? load_d(p, (col_base + j * 8) / p.hp) : 0.f;
      l.dd2[i] = __float2bfloat162_rn(l.dd[i]);
      l.accd[i] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (!on) l.w[i][e] = 0.f;
        l.accw[BWD ? i : 0][e] = 0.f;
      }
    }
    // row k's stage (s, ph); pass 1 of row k + 1 runs before row k's sums
    // are awaited, so the sums' latency (a cluster's exchange among them)
    // hides under it
    int s = 0, k = 0;
    uint32_t ph = 0;
    if (cid < p.R) {
      mbar_wait(&sh.full[0], 0);
      pass1<VPT, BWD>(p, l, sh.ring, sh, 0, rank, tid);
    }
    for (int row = cid; row < p.R; row += ncl, ++k) {
      const int s1 = s + 1 == p.stages ? 0 : s + 1;
      const uint32_t ph1 = s1 == 0 ? ph ^ 1 : ph;
      if (row + ncl < p.R) {
        mbar_wait(&sh.full[s1], ph1);
        pass1<VPT, BWD>(p, l,
                        sh.ring + static_cast<size_t>(s1) * p.stage_bytes, sh,
                        k + 1, rank, tid);
      }
      const float2 tot = row_sums(sh, k, cs);
      pass2<VPT, BWD>(p, l, sh.ring + static_cast<size_t>(s) * p.stage_bytes,
                      row, tot, col_base, tid);
      // a warp releases the stage once all its lanes have read it
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&sh.empty[s]);
      s = s1;
      ph = ph1;
    }
    if (BWD) {
      // the block's partial row: dw at its columns, dD at its heads
      float* prow = p.part + static_cast<long long>(cid) * (p.d + p.heads);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int j = tid + i * kCons;
        if (j < p.nvec) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            prow[col_base + j * 8 + e] = l.accw[BWD ? i : 0][e];
          sh.vacc[j] = l.accd[i];
        }
      }
      consumers_sync();
      const int hpr = p.heads / cs, vph = p.hp / kVec;
      for (int h = tid; h < hpr; h += kCons) {
        float sum = 0.f;
        for (int q = 0; q < vph; ++q) sum += sh.vacc[h * vph + q];
        prow[p.d + rank * hpr + h] = sum;
      }
    }
  }
  // no block leaves while a peer may still write its shared memory
  if (cs > 1) cluster_sync();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Fills `p`'s shape from the call's and checks the contract; returns the
// shared memory a block takes, or a negative error.
int setup(Params& p, const void* y, const void* z, const void* x,
          const void* dout, const void* w, const void* D,
          const long long* strides, int R, int S, int d, int heads, int skip,
          int w_f32, int d_f32, int cs, int stages, int blocks, int vpt) {
  if (!y || !z || !w || R < 1 || S < 1 || R % S || d < 8 || heads < 1 ||
      d % heads || (d / heads) % 8 || (skip && (!x || !D)) ||
      !(cs == 1 || cs == 2 || cs == 4) || heads % cs || stages < 2 ||
      stages > kMaxStages || blocks < cs || blocks % cs || vpt < 1 ||
      vpt > kMaxVpt || !aligned16(w))
    return kErrArgs;
  const void* ins[kMaxOps] = {y, z, x, dout};
  int n = 0;
  for (int o = 0; o < kMaxOps; ++o) {
    if (o == 2 && !skip) continue;
    if (o == 3 && !dout) continue;
    if (!ins[o] || !aligned16(ins[o])) return kErrArgs;
    const long long sb = strides[2 * o], ss = strides[2 * o + 1];
    if ((R > S && (sb * 2) % 16) || (S > 1 && (ss * 2) % 16)) return kErrArgs;
    p.in[n] = static_cast<const bf16*>(ins[o]);
    p.sb[n] = sb;
    p.ss[n] = ss;
    ++n;
  }
  p.w = w;
  p.D = D;
  p.R = R;
  p.S = S;
  p.d = d;
  p.heads = heads;
  p.hp = d / heads;
  p.share = d / cs;
  p.nvec = p.share / kVec;
  p.nops = n;
  p.stages = stages;
  p.cs = cs;
  p.skip = skip;
  p.w_f32 = w_f32;
  p.d_f32 = d_f32;
  if (p.nvec > kCons * vpt) return kErrConfig;
  p.op_bytes = static_cast<uint32_t>(cdiv(p.share * 2, 128) * 128);
  p.stage_bytes = p.op_bytes * n;
  p.tx_bytes = static_cast<uint32_t>(p.share) * 2 * n;
  return kRingOff + stages * static_cast<int>(p.stage_bytes);
}

cudaLaunchConfig_t config(int blocks, int cs, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The shared-memory limit a block of `kernel` may opt in to, set once per
// device, so that no attribute is set while a CUDA graph is captured; 0 or
// an error.
template <int VPT, bool BWD>
int prepare(int* limit) {
  auto kernel = gate_kernel<VPT, BWD>;
  static std::atomic<uint64_t> ready{0};
  static int dyn_max[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return kErrArgs;
  const uint64_t bit = uint64_t{1} << dev;
  if (!(ready.load() & bit)) {
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    dyn_max[dev] = optin - static_cast<int>(fa.sharedSizeBytes);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn_max[dev]);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  *limit = dyn_max[dev];
  return 0;
}

template <int VPT, bool BWD>
int launch_one(const Params& p, int blocks, int smem, cudaStream_t stream) {
  int limit = 0;
  int e = prepare<VPT, BWD>(&limit);
  if (e) return e;
  if (smem > limit) return kErrSmem;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(blocks, p.cs, smem, stream, attr);
  e = cudaLaunchKernelEx(&cfg, gate_kernel<VPT, BWD>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int VPT, bool BWD>
int occupancy(int cs, int smem) {
  int limit = 0;
  int e = prepare<VPT, BWD>(&limit);
  if (e) return e > 0 ? -1000 - e : e;
  if (smem > limit) return kErrSmem;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cs, cs, smem, nullptr, attr);
  int n = 0;
  const cudaError_t ce =
      cudaOccupancyMaxActiveClusters(&n, gate_kernel<VPT, BWD>, &cfg);
  return ce == cudaSuccess ? n : -1000 - static_cast<int>(ce);
}

template <bool BWD>
int dispatch(const Params& p, int vpt, int blocks, int smem,
             cudaStream_t stream) {
  switch (vpt) {
    case 1: return launch_one<1, BWD>(p, blocks, smem, stream);
    case 2: return launch_one<2, BWD>(p, blocks, smem, stream);
    case 3: return launch_one<3, BWD>(p, blocks, smem, stream);
    case 4: return launch_one<4, BWD>(p, blocks, smem, stream);
  }
  return kErrConfig;
}

template <bool BWD>
int max_clusters(int vpt, int cs, int smem) {
  switch (vpt) {
    case 1: return occupancy<1, BWD>(cs, smem);
    case 2: return occupancy<2, BWD>(cs, smem);
    case 3: return occupancy<3, BWD>(cs, smem);
    case 4: return occupancy<4, BWD>(cs, smem);
  }
  return kErrConfig;
}

}  // namespace

extern "C" {

// Forward on `stream`: bf16 y, z and (with `skip`) x, each (B, S, d) with
// its batch and sequence strides in `strides` (elements: y's two, z's, x's),
// the last dim contiguous; w (d,) and D (heads,) bf16 or fp32 (`w_f32`,
// `d_f32`); out (B, S, d) contiguous bf16.  R = B * S rows.  The launch
// shape (cluster size, stages, blocks, vectors a consumer thread) from the
// wrapper's planner.  One launch.  Returns 0, a CUDA error code, or a
// negative code of its own.
int gate_sm90_fwd(const void* y, const void* z, const void* x, const void* D,
                  const void* w, void* out, const long long* strides, int R,
                  int S, int d, int heads, float eps, int skip, int w_f32,
                  int d_f32, int cluster, int stages, int blocks, int vpt,
                  void* stream) {
  Params p = {};
  const int smem = setup(p, y, z, x, nullptr, w, D, strides, R, S, d, heads,
                         skip, w_f32, d_f32, cluster, stages, blocks, vpt);
  if (smem < 0) return smem;
  if (!out || !aligned16(out)) return kErrArgs;
  p.out = static_cast<bf16*>(out);
  p.eps = eps;
  return dispatch<false>(p, vpt, blocks, smem,
                         static_cast<cudaStream_t>(stream));
}

// Backward on `stream`: the forward's operands and dout (B, S, d) bf16
// (its strides after x's in `strides`); dy, dz and (with `skip`) dx (B, S,
// d) contiguous bf16; part (blocks / cluster, d + heads) fp32, each cluster's
// sums of dout g r (dw) over its rows and of dy x over each head's columns
// (dD), which the wrapper sums in a fixed order.  One launch.
int gate_sm90_bwd(const void* y, const void* z, const void* x, const void* D,
                  const void* w, const void* dout, void* dy, void* dz,
                  void* dx, void* part, const long long* strides, int R,
                  int S, int d, int heads, float eps, int skip, int w_f32,
                  int d_f32, int cluster, int stages, int blocks, int vpt,
                  void* stream) {
  Params p = {};
  if (!dout) return kErrArgs;
  const int smem = setup(p, y, z, x, dout, w, D, strides, R, S, d, heads,
                         skip, w_f32, d_f32, cluster, stages, blocks, vpt);
  if (smem < 0) return smem;
  if (!dy || !dz || !part || !aligned16(dy) || !aligned16(dz) ||
      (skip && (!dx || !aligned16(dx))))
    return kErrArgs;
  p.out = static_cast<bf16*>(dy);
  p.dz = static_cast<bf16*>(dz);
  p.dx = static_cast<bf16*>(dx);
  p.part = static_cast<float*>(part);
  p.eps = eps;
  return dispatch<true>(p, vpt, blocks, smem,
                        static_cast<cudaStream_t>(stream));
}

// The clusters of `cluster` blocks that can be resident at once for the
// forward (`bwd` 0) or backward kernel of `vpt` with `smem` bytes of shared
// memory a block, on the current device: the planner's cap on a persistent
// grid.  Returns the count, or a negative error (a CUDA error e as
// -1000 - e).
int gate_sm90_max_clusters(int bwd, int vpt, int cluster, int smem) {
  return bwd ? max_clusters<true>(vpt, cluster, smem)
             : max_clusters<false>(vpt, cluster, smem);
}

const char* gate_sm90_error_string(int err) {
  switch (err) {
    case kErrArgs:
      return "gated norm (sm90): bad arguments (shape, alignment or launch "
             "shape)";
    case kErrSmem:
      return "gated norm (sm90): the ring does not fit the shared memory";
    case kErrConfig:
      return "gated norm (sm90): no kernel for this many vectors a thread";
  }
  if (err <= -1000)
    return cudaGetErrorString(static_cast<cudaError_t>(-1000 - err));
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
