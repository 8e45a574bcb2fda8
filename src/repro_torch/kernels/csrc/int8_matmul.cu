// Direct INT8 GEMM at decode shapes for NVIDIA Hopper (sm_90a): a few rows
// of activations against an int8 weight matrix that is read once.
//
// Replaces the XLA dot behind `int8_matmul` (src/repro/kernels/ops.py:80,
// `mvm_ref`) for M <= 16:
//
//     out[m, n] = sum_k  x[m, k] * w[k, n]
//
// `(M,K) int8 @ (K,N) int8 -> (M,N) int32`, wrapping modulo 2^32 as the
// reference's int32 arithmetic does: bit-identical to `cim_mvm`.  The
// wrapper's planner (kernels/int8_matmul.py) sends every other shape to the
// bit-serial source's one-pass tiles (`int8_matmul_launch` in
// bitserial_mvm.cu).
//
// Bound on this card: w's bytes.  A call reads K*N bytes of w for 2*M*K*N
// operations, 8 a byte at M = 4 against the ~590 a byte at which the int8
// tensor cores (1979e12/s over 3.35e12 B/s) would bound it; x and the
// output add M/N and 4*M/K of w's bytes.  The least time is w's bytes at
// 3.35e12 B/s, and the design keeps w's copies streaming at that rate with
// nothing else on the critical path.
//
// Design.
// * The grid is (N strips, K slices): a strip is 128 columns, a slice a
//   whole number of 128-row stages.  The wrapper plans it to one wave
//   (every block resident at once, one an SM at most) wherever x's slice
//   fits, so each block streams a long K run and no block waits for
//   another to leave its SM.
// * TMA ring: one producer thread keeps 4 stages of 128 rows x 128 columns
//   of w (16 KB) in flight with `cp.async.bulk.tensor` from a tensor map
//   over (K, N) (one box a stage, the 128-byte swizzle), completing on
//   `mbarrier`s; 4 consumer warps each take 32 columns of every stage.
//   The tensor map's bounds zero-fill the rows past K, and columns past N.
//   It needs w's row stride (N bytes) to be a multiple of 16; the planner
//   routes other N away.
// * x staged once: before the first stage of w, the producer copies the
//   block's slice of x (M rows of k_per_slice bytes) with one bulk copy a
//   row (`cp.async.bulk`), so that x is not queued behind w's copies; the
//   consumers then reorder it in shared memory into the byte order the
//   MMA's B operand wants (below), one 8-byte load a k-step.  Rows of x
//   that are not 16-byte aligned (K not a multiple of 16) are loaded by
//   the consumers a byte at a time instead.
// * The math on the tensor cores, `mma.sync.m16n8k32.s8.s8.s32` with w as
//   the A operand: 16 columns of w on the MMA's rows, the M <= 16 rows of x
//   on its 8 columns (two MMAs past 8).  A lane loads, for its 4 adjacent
//   columns, 8 rows of the stage (4-byte loads; with the swizzle a warp's
//   loads meet no bank conflict) and turns the two 4x4 byte blocks into
//   K-contiguous words with `__byte_perm`, in registers: no shared-memory
//   round trip.  A sum over K may take its terms in any order, so the
//   K-order of the A fragments (rows q, q+4, q+8, q+12 of a 32-row step in
//   one word) is what x's staged order follows.  `__dp4a` would issue about
//   four times the MMA's instructions at M = 4 and sixteen at M = 16.
// * Split-K combined inside the one launch, with no memset and no
//   workspace: the K slices of a strip are one thread-block cluster.  Each
//   slice stores its int32 partial of 4-column chunk c into a slot of the
//   shared memory of slice c % slices (`st.shared::cluster`), the cluster
//   barrier (release, then acquire) orders the stores, and each slice adds
//   the slots of its chunks and writes them out.  A first phase of the
//   cluster barrier guards the stores: every thread arrives (relaxed) as
//   its block starts, and a consumer waits on it only before its first
//   store to another block, so no store reaches a block that has not
//   started; the wait overlaps the K loop.  int32 addition wraps
//   modulo 2^32 in any order, so the sum is bit-exact.  A ticket over
//   partials in global memory (one fence, one atomic and one more round
//   trip to L2 after the last block's loop) and atomic adds into one
//   leader's shared memory (serialised at that SM) were measured slower on
//   an H100 (PERF.md).  Nothing persists between launches, so a captured
//   CUDA graph replays as it is.
// * The kernel launches on the caller's stream, allocates nothing (the
//   wrapper gives the output) and returns cudaGetLastError().
//
// Contract (checked by the Python wrapper and again here): 1 <= M <= 16,
// N a multiple of 16, K >= 1, x, w and out contiguous and 16-byte aligned,
// k_per_slice a positive multiple of 128 with M * k_per_slice <= kXMax, at
// most kMaxSlices slices.

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kBox = 128;       // w columns (bytes) in one TMA box
constexpr int kStep = 32;       // K rows of one MMA step
constexpr int kXMax = 65536;    // bytes of x a block stages
constexpr int kMaxSlices = 16;  // K slices of a strip: a cluster's blocks

struct Params {
  const int8_t* x;
  int32_t* out;
  int M, N, K;
  int k_per_slice;
  int slices;          // the K slices of a strip: one cluster
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// one bulk copy (no tensor map) of `bytes` (a multiple of 16) from global
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the cluster barrier, split into its arrive and its wait
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// `a`'s address in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(a)), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_store(uint32_t addr, uint32_t a,
                                              uint32_t b, uint32_t c,
                                              uint32_t d) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// barrier 1: the consumer warps among themselves
template <int kCount>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCount) : "memory");
}

// barrier 2: the consumers wait (sync) until the producer has set up the
// mbarriers (arrive)
template <int kCount>
__device__ __forceinline__ void setup_arrive() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(kCount) : "memory");
}

template <int kCount>
__device__ __forceinline__ void setup_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kCount) : "memory");
}

// d += a (s8, 16x32 row) * b (s8, 32x8 col), int32 accumulate, wrapping
__device__ __forceinline__ void mma_s8s8(uint32_t (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4x4 byte transpose: byte t of word c of the result is byte c of r[t]
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* c) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

constexpr int kRows = 128;         // K rows of w a stage: one TMA box
constexpr int kStages = 4;         // stages in the ring
constexpr int kConsumers = 4;      // consumer warps, 32 columns each
constexpr int kThreads = (kConsumers + 1) * 32;   // + the producer warp
constexpr int kStageBytes = kRows * kBox;         // a strip is kBox columns
constexpr int kRing = kStages * kStageBytes;
constexpr int kChunks = kBox / 4;  // 4-column chunks of a strip

// shared memory: the ring at a 1024-byte boundary (the swizzle's); x
// staged [step][m][32 bytes] (M * k_per_slice bytes); x as copied,
// [m][k_per_slice]; the partials this block sums, [slice][m][chunk][4]
// int32 (at most M * (kChunks + kMaxSlices) * 16 bytes)
int smem_bytes(int m, int k_per_slice) {
  return 1024 + kRing + 2 * m * k_per_slice + m * (kChunks + kMaxSlices) * 16;
}

template <int MG>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                              const Params p) {
  constexpr int kSteps = kRows / kStep;   // MMA steps a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xs = ring + kRing;
  unsigned char* xr = xs + p.M * p.k_per_slice;
  unsigned char* parts = xr + p.M * p.k_per_slice;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ __align__(8) uint64_t xbar;

  // the cluster is the strip's K slices: rank = slice
  const int strip = blockIdx.x, slice = blockIdx.y;
  const int n_lo = strip * kBox;
  const int k_lo = slice * p.k_per_slice;
  const int k_hi = min(k_lo + p.k_per_slice, p.K);
  const int n_iter = (k_hi - k_lo + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = threadIdx.x;
  const bool split = p.slices > 1;
  // x's rows are 16-byte aligned: one bulk copy a row
  const bool x_bulk = p.K % 16 == 0;
  // the cluster barrier's first phase: this block has started (waited on
  // before any store to another block's shared memory)
  if (split) cluster_arrive_relaxed();

  if (warp == kConsumers) {   // the producer: one thread issues every copy
    if (lane == 0) {
      prefetch_map(&wmap);
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumers);
      }
      mbar_init(&xbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (x_bulk) {
        const uint32_t bytes = k_hi - k_lo;
        mbar_expect_tx(&xbar, p.M * bytes);
        for (int m = 0; m < p.M; ++m)
          bulk_load(xr + m * p.k_per_slice,
                    p.x + static_cast<long long>(m) * p.K + k_lo, bytes,
                    &xbar);
      }
    }
    __syncwarp();
    setup_arrive<kThreads>();
    if (lane == 0) {
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], kStageBytes);
        tma_load_2d(ring + st * kStageBytes, &wmap, &full[st], n_lo,
                    k_lo + it * kRows);
      }
    }
    if (split) {   // both phases: nothing of ours to wait for
      cluster_wait();
      cluster_arrive_relaxed();
    }
    return;
  }

  // x's slice, zero past K, into xs: [step][m][32 bytes], lane q's two B
  // words side by side at byte 8q (word 2q: k = q + 4t of the step, byte t;
  // word 2q + 1: k = 16 + q + 4t)
  const int steps = n_iter * kSteps;
  const int x_len = k_hi - k_lo;
  if (!x_bulk) {
    // rows not 16-byte aligned: byte loads, before the copies of w crowd
    // the memory system
    for (int u = t; u < steps * p.M; u += kConsumers * 32) {
      const int ks = u / p.M, m = u - ks * p.M;
      const int8_t* src = p.x + static_cast<long long>(m) * p.K + k_lo;
      unsigned char* row = xr + m * p.k_per_slice + ks * kStep;
#pragma unroll
      for (int b = 0; b < kStep; ++b) {
        const int k = ks * kStep + b;
        row[b] = k < x_len ? static_cast<unsigned char>(__ldg(src + k)) : 0;
      }
    }
  }
  setup_sync<kThreads>();
  if (x_bulk) mbar_wait(&xbar, 0);
  else consumers_sync<kConsumers * 32>();
  for (int u = t; u < steps * p.M; u += kConsumers * 32) {
    const int ks = u / p.M, m = u - ks * p.M;
    const uint4* src =
        reinterpret_cast<const uint4*>(xr + m * p.k_per_slice + ks * kStep);
    uint32_t s[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ks * kStep + 16 * h < x_len) v = src[h];
      s[4 * h] = v.x;
      s[4 * h + 1] = v.y;
      s[4 * h + 2] = v.z;
      s[4 * h + 3] = v.w;
    }
    uint32_t c[4], d[4];
    transpose4(s, c);
    transpose4(s + 4, d);
    uint4* dst = reinterpret_cast<uint4*>(xs + (ks * p.M + m) * kStep);
    dst[0] = make_uint4(c[0], d[0], c[1], d[1]);
    dst[1] = make_uint4(c[2], d[2], c[3], d[3]);
  }
  consumers_sync<kConsumers * 32>();

  // lane (g, q) of warp w: columns 4 * (g & 3) .. + 3 of the stage's
  // 16-byte chunk w + 4 * (g >> 2), rows q + 4i of each step
  const int g = lane >> 2, q = lane & 3;
  const int chunk = warp + 4 * (g >> 2);
  // the swizzle puts chunk c of row r at c ^ (r & 7); r & 7 is q or q + 4
  const int off0 = ((chunk ^ q) << 4) + 4 * (g & 3);
  const int off1 = ((chunk ^ (q + 4)) << 4) + 4 * (g & 3);
  uint32_t acc[MG][2][4];
#pragma unroll
  for (int mg = 0; mg < MG; ++mg)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mg][h][e] = 0u;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    const unsigned char* bx = ring + st * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = kk * kStep + q + 4 * i;
        r[i] = *reinterpret_cast<const uint32_t*>(bx + row * kBox +
                                                  ((i & 1) ? off1 : off0));
      }
      uint32_t b[MG][2];
      const unsigned char* xk =
          xs + (it * kSteps + kk) * p.M * kStep + 8 * q;
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) {
        const int m = g + 8 * mg;
        uint2 v = make_uint2(0u, 0u);
        if (m < p.M) v = *reinterpret_cast<const uint2*>(xk + m * kStep);
        b[mg][0] = v.x;
        b[mg][1] = v.y;
      }
      // column c's words: K rows q + 4t (lo) and 16 + q + 4t (hi)
      uint32_t lo[4], hi[4];
      transpose4(r, lo);
      transpose4(r + 4, hi);
      const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};   // columns 0, 1
      const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};   // columns 2, 3
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) {
        mma_s8s8(acc[mg][0], a0, b[mg]);
        mma_s8s8(acc[mg][1], a1, b[mg]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the lane's outputs: rows m = 8 mg + 2q + h, columns n0 .. n0 + 3
  // (acc[mg][c / 2][2 (c % 2) + h] for column n0 + c)
  const int n0 = n_lo + chunk * 16 + 4 * (g & 3);
  if (split) {
    // reduce-scatter over the cluster: 4-column chunk c of the strip is
    // summed by slice c % slices, which receives each slice's partial of
    // it in its own slot (int32 addition wraps modulo 2^32 in any order)
    const int per = (kChunks + p.slices - 1) / p.slices;
    const int c = (n0 - n_lo) >> 2;
    const uint32_t dst = cluster_addr(parts, c % p.slices) +
                         (slice * p.M * per + c / p.slices) * 16;
    cluster_wait();   // every block of the cluster has started
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * mg + 2 * q + h;
        if (m < p.M)
          cluster_store(dst + m * per * 16, acc[mg][0][h], acc[mg][0][2 + h],
                        acc[mg][1][h], acc[mg][1][2 + h]);
      }
    cluster_arrive_release();
    cluster_wait();   // every slice's partials have landed
    for (int u = t; u < p.M * per; u += kConsumers * 32) {
      const int m = u / per, i = u - m * per;
      const int cc = i * p.slices + slice;
      const int n = n_lo + 4 * cc;
      if (cc >= kChunks || n >= p.N) continue;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      for (int s = 0; s < p.slices; ++s) {
        const uint4 o = *reinterpret_cast<const uint4*>(
            parts + ((s * p.M + m) * per + i) * 16);
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      *reinterpret_cast<uint4*>(p.out + static_cast<long long>(m) * p.N + n) =
          v;
    }
    return;
  }
  if (n0 >= p.N) return;
#pragma unroll
  for (int mg = 0; mg < MG; ++mg)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * mg + 2 * q + h;
      if (m < p.M)
        *reinterpret_cast<uint4*>(p.out + static_cast<long long>(m) * p.N +
                                  n0) =
            make_uint4(acc[mg][0][h], acc[mg][0][2 + h], acc[mg][1][h],
                       acc[mg][1][2 + h]);
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
constexpr int kErrSmem = -4;

template <int MG>
int launch(const CUtensorMap& map, const Params& p, int strips,
           cudaStream_t stream) {
  auto kernel = int8_matmul_stream_kernel<MG>;
  // the shared-memory limit (what the device lets a block opt in to, less
  // the kernel's static barriers) and clusters of more than 8 blocks are
  // per-device attributes: set once per device
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
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    dyn_max[dev] = optin - static_cast<int>(fa.sharedSizeBytes);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn_max[dev]);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  const int smem = smem_bytes(p.M, p.k_per_slice);
  if (smem > dyn_max[dev]) return kErrSmem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips, p.slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches `(M,K) int8 @ (K,N) int8 -> (M,N) int32` on `stream` with
// strips of 128 columns and K slices of k_per_slice rows (a multiple of 128,
// at most kMaxSlices slices: one cluster a strip).
// Returns 0, a CUDA error code after the launch, or a negative code of its
// own (int8_matmul_stream_error_string).
int int8_matmul_stream_launch(const void* x, const void* w, void* out, int M,
                              int N, int K, int k_per_slice, void* stream) {
  if (M < 1 || M > 16 || N < 16 || N % 16 || K < 1 || k_per_slice < 1 ||
      k_per_slice % kRows ||
      static_cast<long long>(M) * k_per_slice > kXMax ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return kErrArgs;
  const int strips = (N + kBox - 1) / kBox;
  const long long slices = (static_cast<long long>(K) + k_per_slice - 1) /
                           k_per_slice;
  if (slices > kMaxSlices) return kErrArgs;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrEncoder;
  // w as (K, N) innermost first: rows from K on and columns from N on read
  // as zeros
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBox),
                             static_cast<cuuint32_t>(kRows)};
  const cuuint32_t estr[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.out = static_cast<int32_t*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_per_slice = k_per_slice;
  p.slices = static_cast<int>(slices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return M <= 8 ? launch<1>(map, p, strips, st) : launch<2>(map, p, strips, st);
}

const char* int8_matmul_stream_error_string(int code) {
  switch (code) {
    case kErrArgs:
      return "arguments outside the kernel's contract";
    case kErrEncoder:
      return "the driver has no cuTensorMapEncodeTiled";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused w's tensor map";
    case kErrSmem:
      return "the block's shared memory is over the device's limit";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
