// Bit-serial digital-CIM MVM for NVIDIA Hopper (sm_90a), on the int8
// tensor cores.
//
// Replaces the Pallas TPU kernel `bitserial_mvm_kernel`
// (src/repro/kernels/bitserial_mvm.py:45, launched by
// `bitserial_mvm_pallas`).  It computes
//
//     out[m, n] = sum_b  s_b * 2^b * sum_k  bit_b(uint8(x[m, k])) * w[k, n]
//
// for b < act_bits, with s_b = -1 for the MSB plane when `is_signed`, else
// +1: `(M,K) int8 @ (K,N) int8 -> (M,N) int32` as a digital CIM macro does
// it, one activation bit-plane at a time with shift-add accumulation,
// exact modulo 2^32.
//
// Bound on this card.  The function is one int8 GEMM: 2*M*K*N operations
// on M*K + K*N + 4*M*N bytes.  At 1979e12 int8 tensor-core operations/s
// and 3.35e12 B/s every GEMM of the main path is bound by its bytes (the
// int32 output dominates).  The bit-serial design does act_bits times the
// function's operations; at the tensor-core peak that stays within 2x of
// the bytes bound summed over the main path, so the planes run on the
// tensor cores and the grid is sized to fill the card.
//
// Design.
// * Plane products on the tensor cores: `mma.sync.m16n8k32` with int8
//   operands.  Each warp loads its raw activation fragments once per K
//   step (`ldmatrix`) and peels plane b in registers, keeping bit b at its
//   place value: `a & (0x01010101 << b)` is 2^b * bit_b as a u8 operand.
//   The signed MSB plane enters as -2^b * bit_b, an s8 operand made by
//   `((a >> b) & 0x01010101) * (0x100 - 2^b)` (no carries: bytes are 0/1).
//   The shift of shift-add thus rides on the 1-bit operand, and every
//   plane product accumulates into one int32 accumulator inside the MMA:
//   no second accumulator set and no per-plane shifts of partial sums.
//   The integer MMA without `.satfinite` wraps modulo 2^32, as the
//   reference's int32 arithmetic does.
// * Staging: a ring of 4 shared-memory slots of 64-deep K steps filled
//   by 16-byte `cp.async` copies, three steps in flight while the MMAs of
//   the current one run.  Ragged edges need no padding copy.  An operand
//   whose rows are 16-byte aligned (x: K a multiple of 16; w: N a
//   multiple of 16) is copied in whole chunks, zero-filled past its
//   edges.  An unaligned row is copied as the aligned window around it,
//   zero-filled past the tensor's end; a fix-up pass then realigns each
//   word with a funnel shift and zeroes what lies past M, N or the K
//   slice.  Each operand's case is a template flag, chosen at launch.
//   w is `(K,N)` N-contiguous but the B operand wants K-contiguous
//   columns: the fix-up pass transposes 4x4 byte blocks with
//   `__byte_perm` into a `[n][k]` tile.  Rows are padded to 80 bytes, so
//   `ldmatrix` reads without bank conflicts.
// * Filling the card: the wrapper picks the (bm, bn) tile and the K slice
//   per block from (M, N, K) and the SM count; K slices of one tile run in
//   separate blocks (split-K) and combine with `atomicAdd` into an output
//   the launcher zeroes first (`cudaMemsetAsync` on the same stream).
//   int32 addition modulo 2^32 is associative, so the sum is bit-exact in
//   any order, with one kernel launch and no workspace or second pass.
//   A block's K loop is a chain of latency-bound steps with few warps per
//   SM, so the chooser splits K to about three resident blocks per SM.
// * No padding copies: the kernel masks ragged M, N and K itself.
//
// The direct INT8 GEMM `int8_matmul` (replacing the XLA dot of
// src/repro/kernels/ops.py:80, `mvm_ref`) is the same kernel with one
// pass instead of the planes (template flag kDirect): the raw s8
// fragments go to `mma.sync.m16n8k32.s8.s8.s32` once per K step, with the
// same staging, masking and split-K.  Both compute the same int32 sum
// modulo 2^32, so the two are bit-identical.
//
// Contract (checked by the Python wrapper): (bm, bn) one of the tiles
// instantiated below, k_per_split a positive multiple of 64, x, w and out
// contiguous row-major.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;            // K bytes per pipeline step
constexpr int kPitch = kBK + 16;   // shared row pitch in bytes
constexpr int kStages = 4;         // ring of copies in flight

struct Params {
  const int8_t* x;
  const int8_t* w;
  int32_t* out;
  int M, N, K;
  int k_per_split;
  int act_bits;
  int is_signed;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (u8, 16x32 row) * b (s8, 32x8 col), int32 accumulate
__device__ __forceinline__ void mma_u8s8(uint32_t (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (s8) * b (s8)
__device__ __forceinline__ void mma_s8s8(uint32_t (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Word of row bytes [4q, 4q+4) of a staged window whose row starts `o`
// bytes into `row` (a 16-byte aligned copy of global memory): two aligned
// words joined by a funnel shift.
__device__ __forceinline__ uint32_t realign(const uint8_t* row, int o,
                                            int q) {
  const uint32_t* wd = reinterpret_cast<const uint32_t*>(row);
  const int w0 = (o >> 2) + q;
  return __funnelshift_r(wd[w0], wd[w0 + 1], (o & 3) * 8);
}

// keep the low `valid` bytes of v (all when valid >= 4, none when <= 0)
__device__ __forceinline__ uint32_t keep_bytes(uint32_t v, int valid) {
  if (valid >= 4) return v;
  if (valid <= 0) return 0u;
  return v & ((1u << (8 * valid)) - 1u);
}

template <int BM, int BN>
struct Layout {
  static constexpr int kBPitch = BN + 16;   // raw w rows: BN bytes + slack
  static constexpr int kARaw = BM * kPitch;  // bytes per stage
  static constexpr int kBRaw = kBK * kBPitch;
  static constexpr int kBytes =
      kStages * (kARaw + kBRaw) + BM * kPitch + BN * kPitch;
};

// kAlignX: K a multiple of 16 and x 16-byte aligned; kAlignW: N a multiple
// of 16 and w 16-byte aligned.  Then every 16-byte chunk of that operand's
// tile lies wholly inside it or wholly past its edge, and is copied
// straight or zero-filled: no realignment or masking in the fix-up pass.
// kDirect: one s8 x s8 product per K step (int8_matmul) in place of the
// act_bits plane products.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool kAlignX,
          bool kAlignW, bool kDirect>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
bitserial_mma_kernel(const Params p) {
  using L = Layout<BM, BN>;
  constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int kBBlocks = (kBK / 4) * (BN / 4) / kThreads;  // per thread
  constexpr int kAChunks = BM * (kBK / 16), kBChunks = kBK * (BN / 16);
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  static_assert((kBK / 4) * (BN / 4) % kThreads == 0, "w transpose");
  static_assert(kBChunks % kThreads == 0, "w chunks");

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const ARaw = smem;                          // [S][BM][kPitch]
  uint8_t* const BRaw = ARaw + kStages * L::kARaw;     // [S][kBK][kBPitch]
  uint8_t* const At = BRaw + kStages * L::kBRaw;       // [BM][kPitch]
  uint8_t* const Bt = At + BM * kPitch;                // [BN][kPitch]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * p.k_per_split;
  const int ke = min(p.K, kb + p.k_per_split);
  const int nk = (ke - kb + kBK - 1) / kBK;
  const uintptr_t x_end =
      reinterpret_cast<uintptr_t>(p.x + static_cast<int64_t>(p.M) * p.K);
  const uintptr_t w_end =
      reinterpret_cast<uintptr_t>(p.w + static_cast<int64_t>(p.K) * p.N);
  // x rows 16-byte aligned: copied straight into the MMA tile
  const bool a_direct =
      kAlignX || ((p.K % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(p.x) % 16 == 0));

  // copy step t's x and w windows into ring slot t % kStages
  auto issue = [&](int t) {
    const int k0 = kb + t * kBK;
    uint8_t* const a_dst = ARaw + (t % kStages) * L::kARaw;
    uint8_t* const b_dst = BRaw + (t % kStages) * L::kBRaw;
    if (kAlignX) {
      // whole chunks, zero-filled past M and the K slice (ke is a
      // multiple of 16)
#pragma unroll
      for (int s = 0; s < (kAChunks + kThreads - 1) / kThreads; ++s) {
        const int c = tid + s * kThreads;
        if (kAChunks % kThreads && c >= kAChunks) break;
        const int r = c / (kBK / 16), q = c % (kBK / 16);
        const int64_t gm = m0 + r;
        const bool ok = gm < p.M && k0 + 16 * q < ke;
        cp_async16(a_dst + r * kPitch + 16 * q,
                   ok ? p.x + gm * p.K + k0 + 16 * q : p.x, ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < BM * (kPitch / 16); c += kThreads) {
        const int r = c / (kPitch / 16), q = c % (kPitch / 16);
        const int64_t gm = m0 + r;
        uint8_t* const dst = a_dst + r * kPitch + 16 * q;
        if (a_direct) {
          // zero fill past M and K: the MMAs read this slot as it is
          const bool ok = gm < p.M && k0 + 16 * q < ke;
          if (q < kBK / 16)
            cp_async16(dst, ok ? p.x + gm * p.K + k0 + 16 * q : p.x,
                       ok ? 16 : 0);
        } else if (gm < p.M) {
          // the 16-byte aligned window around the row's bytes [k0, ke)
          const uintptr_t base =
              reinterpret_cast<uintptr_t>(p.x + gm * p.K + k0);
          const uintptr_t a = (base & ~uintptr_t(15)) + 16 * q;
          if (a < base + min(kBK, ke - k0))
            cp_async16(dst, reinterpret_cast<const void*>(a),
                       x_end - a < 16 ? static_cast<int>(x_end - a) : 16);
        }
      }
    }
    if (kAlignW) {
      // whole chunks, zero-filled past N and the K slice
#pragma unroll
      for (int s = 0; s < kBChunks / kThreads; ++s) {
        const int c = tid + s * kThreads;
        const int r = c / (BN / 16), q = c % (BN / 16);
        const int gk = k0 + r, gn = n0 + 16 * q;
        const bool ok = gk < ke && gn < p.N;
        cp_async16(b_dst + r * L::kBPitch + 16 * q,
                   ok ? p.w + static_cast<int64_t>(gk) * p.N + gn : p.w,
                   ok ? 16 : 0);
      }
    } else {
      for (int c = tid; c < kBK * (L::kBPitch / 16); c += kThreads) {
        const int r = c / (L::kBPitch / 16), q = c % (L::kBPitch / 16);
        const int gk = k0 + r;
        if (gk >= ke || n0 >= p.N) continue;
        const uintptr_t base = reinterpret_cast<uintptr_t>(
            p.w + static_cast<int64_t>(gk) * p.N + n0);
        const uintptr_t a = (base & ~uintptr_t(15)) + 16 * q;
        if (a < base + min(BN, p.N - n0))
          cp_async16(b_dst + r * L::kBPitch + 16 * q,
                     reinterpret_cast<const void*>(a),
                     w_end - a < 16 ? static_cast<int>(w_end - a) : 16);
      }
    }
  };

  // step t's windows -> MMA-ready tiles: x realigned and masked (unless
  // copied straight), w realigned, masked and transposed to [n][k]
  auto fixup = [&](int t) {
    const int k0 = kb + t * kBK;
    if (!a_direct) {
      const uint8_t* const src = ARaw + (t % kStages) * L::kARaw;
      for (int u = tid; u < BM * (kBK / 4); u += kThreads) {
        const int r = u / (kBK / 4), q = u % (kBK / 4);
        const int64_t gm = m0 + r;
        uint32_t v = 0u;
        if (gm < p.M && k0 + 4 * q < ke) {
          const int o = static_cast<int>(
              reinterpret_cast<uintptr_t>(p.x + gm * p.K + k0) & 15);
          v = keep_bytes(realign(src + r * kPitch, o, q), ke - k0 - 4 * q);
        }
        *reinterpret_cast<uint32_t*>(At + r * kPitch + 4 * q) = v;
      }
    }
    const uint8_t* const src = BRaw + (t % kStages) * L::kBRaw;
#pragma unroll
    for (int s = 0; s < kBBlocks; ++s) {
      const int u = tid + s * kThreads;
      const int i = (u % 4) + 4 * (u / BN);           // K quad
      const int j = (u / 4) % (BN / 4);               // N quad
      const int valid = p.N - n0 - 4 * j;             // columns left
      uint32_t rw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = 4 * i + r;
        rw[r] = 0u;
        if (kAlignW) {
          rw[r] = *reinterpret_cast<const uint32_t*>(src + kr * L::kBPitch +
                                                     4 * j);
        } else if (k0 + kr < ke && valid > 0) {
          const int o = static_cast<int>(
              reinterpret_cast<uintptr_t>(
                  p.w + static_cast<int64_t>(k0 + kr) * p.N + n0) & 15);
          rw[r] = keep_bytes(realign(src + kr * L::kBPitch, o, j), valid);
        }
      }
      // rows r0..r3 hold columns 4j..4j+3 of K rows 4i..4i+3; column c's
      // four K bytes become one word
      const uint32_t lo01 = __byte_perm(rw[0], rw[1], 0x5140);
      const uint32_t lo23 = __byte_perm(rw[2], rw[3], 0x5140);
      const uint32_t hi01 = __byte_perm(rw[0], rw[1], 0x7362);
      const uint32_t hi23 = __byte_perm(rw[2], rw[3], 0x7362);
      uint8_t* const col = Bt + (4 * j) * kPitch + 4 * i;
      *reinterpret_cast<uint32_t*>(col) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(col + kPitch) =
          __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(col + 2 * kPitch) =
          __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(col + 3 * kPitch) =
          __byte_perm(hi01, hi23, 0x7632);
    }
  };

  uint32_t acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0u;

  const int msb = p.act_bits - 1;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();
  }

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();   // step t has landed (this thread's)
    __syncthreads();                // ... everyone's; step t-1 is done
    if (t + kStages - 1 < nk) issue(t + kStages - 1);
    cp_async_commit();
    fixup(t);
    __syncthreads();

    const uint8_t* const Ab =
        a_direct ? ARaw + (t % kStages) * L::kARaw : At;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], Ab + (wm * WM + mi * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * kPitch +
                                kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Bt + (wn * WN + ni * 8 + (lane & 7) +
                             (lane >> 4) * 8) * kPitch +
                           kk * 32 + ((lane >> 3) & 1) * 16);
        bf[ni][0] = r[0];
        bf[ni][1] = r[1];
        bf[ni + 1][0] = r[2];
        bf[ni + 1][1] = r[3];
      }
      if constexpr (kDirect) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_s8s8(acc[mi][ni], af[mi], bf[ni]);
        continue;
      }
      for (int b = 0; b < p.act_bits; ++b) {
        if (p.is_signed && b == msb) {
          // -2^b * bit_b, an s8 operand
          const uint32_t neg = 0x100u - (1u << b);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            uint32_t pa[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pa[e] = ((af[mi][e] >> b) & 0x01010101u) * neg;
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) mma_s8s8(acc[mi][ni], pa, bf[ni]);
          }
        } else {
          // 2^b * bit_b, a u8 operand
          const uint32_t mask = 0x01010101u << b;
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            uint32_t pa[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[e] = af[mi][e] & mask;
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) mma_u8s8(acc[mi][ni], pa, bf[ni]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: fragment (mi, ni) holds rows g and g+8, columns 2c and 2c+1
  const bool split = p.k_per_split < p.K;
  const bool pairs = (p.N % 2 == 0);
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + wm * WM + mi * 16 + g + 8 * h;
      if (row >= p.M) continue;
      int32_t* orow = p.out + row * p.N;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn * WN + ni * 8 + c2;
        const int32_t v0 = static_cast<int32_t>(acc[mi][ni][2 * h]);
        const int32_t v1 = static_cast<int32_t>(acc[mi][ni][2 * h + 1]);
        if (split) {
          if (col < p.N) atomicAdd(orow + col, v0);
          if (col + 1 < p.N) atomicAdd(orow + col + 1, v1);
        } else if (pairs && col + 1 < p.N) {
          *reinterpret_cast<int2*>(orow + col) = make_int2(v0, v1);
        } else {
          if (col < p.N) orow[col] = v0;
          if (col + 1 < p.N) orow[col + 1] = v1;
        }
      }
    }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool kAlignX,
          bool kAlignW, bool kDirect>
cudaError_t launch_as(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = Layout<BM, BN>::kBytes;
  auto kernel = bitserial_mma_kernel<BM, BN, WARPS_M, WARPS_N, kAlignX,
                                     kAlignW, kDirect>;
  // above 48 KB a block's shared memory must be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN,
                  (p.K + p.k_per_split - 1) / p.k_per_split);
  kernel<<<grid, 32 * WARPS_M * WARPS_N, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool kDirect>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const bool align_x =
      p.K % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  const bool align_w =
      p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  // x unaligned with w aligned is the first conv of a CNN (K = kh·kw·C_in
  // with C_in = 3); x aligned with w unaligned runs on the general path
  if (align_x && align_w)
    return launch_as<BM, BN, WARPS_M, WARPS_N, true, true, kDirect>(p,
                                                                     stream);
  if (align_w)
    return launch_as<BM, BN, WARPS_M, WARPS_N, false, true, kDirect>(p,
                                                                      stream);
  return launch_as<BM, BN, WARPS_M, WARPS_N, false, false, kDirect>(p,
                                                                     stream);
}

// zero the output first when K is split (K slices add into it
// atomically), then launch the (bm, bn) tile
template <bool kDirect>
cudaError_t launch_tile(const Params& p, int bm, int bn, cudaStream_t s) {
  if (p.k_per_split <= 0 || p.k_per_split % kBK) return cudaErrorInvalidValue;
  if (p.k_per_split < p.K) {
    const cudaError_t e = cudaMemsetAsync(
        p.out, 0, sizeof(int32_t) * static_cast<size_t>(p.M) * p.N, s);
    if (e != cudaSuccess) return e;
  }
  if (bm == 128 && bn == 128) return launch<128, 128, 2, 4, kDirect>(p, s);
  if (bm == 128 && bn == 64) return launch<128, 64, 2, 2, kDirect>(p, s);
  if (bm == 64 && bn == 64) return launch<64, 64, 2, 2, kDirect>(p, s);
  if (bm == 16 && bn == 64) return launch<16, 64, 1, 4, kDirect>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a tile that is not instantiated
// here.
// The tiles must match `TILES` in kernels/bitserial_mvm.py.
int bitserial_mvm_launch(const void* x, const void* w, void* out, int M,
                         int N, int K, int bm, int bn, int k_per_split,
                         int act_bits, int is_signed, void* stream) {
  const Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                 static_cast<int32_t*>(out), M, N, K, k_per_split, act_bits,
                 is_signed};
  return launch_tile<false>(p, bm, bn, static_cast<cudaStream_t>(stream));
}

// The direct GEMM: `(M,K) int8 @ (K,N) int8 -> (M,N) int32` in one pass,
// on the same tiles and split-K.
int int8_matmul_launch(const void* x, const void* w, void* out, int M, int N,
                       int K, int bm, int bn, int k_per_split, void* stream) {
  const Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                 static_cast<int32_t*>(out), M, N, K, k_per_split, 8, 1};
  return launch_tile<true>(p, bm, bn, static_cast<cudaStream_t>(stream));
}

const char* bitserial_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
