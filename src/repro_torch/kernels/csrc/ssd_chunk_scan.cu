// The Mamba-2 SSD chunk scan of training and prefill, forward and backward,
// for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes the scan in XLA,
// `ssm_apply` (src/repro/models/ssm.py:93-141): per chunk of Q positions
// the dual quadratic form over (Q, Q) decay-masked scores (:110-119), the
// chunk's summary state (:121-126), the inter-chunk recurrence as a
// `lax.scan` (:128-135) and the state's readout (:137-138).  Per batch b,
// chunk c and head h (group g = h / (nh / G)), with cum the in-chunk
// inclusive cumsum of dt * A:
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . H_c
//   H_{c+1} = exp(cum_{Q-1}) H_c + sum_j exp(cum_{Q-1} - cum_j) dt_j B_j x_j^T
// with H_0 = 0 and no final state returned.  x (b, S, nh, hp), B and C
// (b, S, G, N) in the compute dtype, read where they lie (the last dim
// contiguous; x, B and C are views of the conv output); dt (b, S, nh)
// and A (nh,) fp32; y (b, S, nh, hp) contiguous.
//
// Bound on this card: the bytes.  The forward does about 19.6 GFLOP a
// mamba2-780m layer at B 4 x S 2048 against about 106 MB of x, B, C, dt
// and y (0.020 against 0.032 ms).  The design keeps the (Q, Q) scores out
// of device memory: each 16 x 64 tile of C_i B_j^T exp(cum_i - cum_j) dt_j
// is computed in registers and goes straight, rounded to bf16 as the
// reference rounds its scores, into the product with x_j.  The carried
// state, cum and every decay stay fp32 (the reference carries h in bf16);
// the state enters the tensor-core products as a bf16 operand.
//
// The `mma` route (fp32, bf16 shapes outside ssd_chunk_scan_sm90.cu's
// contract, and that route's yardstick).  Launches:
// * forward (3): chunk_state, a block per (b, c, h): cum by a warp scan,
//   states = B^T ((exp(cum_L - cum) dt) * x) (N x hp, fp32) over the
//   chunk's Q rows in 64-row steps; state_pass, a block per (b, h, slice of
//   N * hp): the recurrence over the chunks, the state entering each chunk
//   written over that chunk's summary; chunk_scan, a block per (b, c, h,
//   64-row tile): y_off = exp(cum_i) C_i H_c, then the causal 64-key blocks
//   of the dual form.
// * backward (6): dstate, per (b, c, h): G_c = C^T (exp(cum) * dy); the
//   reverse state pass, per (b, h, slice): D_c = dH_{c+1}, dH_c = G_c +
//   exp(cum_L) dH_{c+1}, and each chunk decay's gradient <D_c, H_c> as a
//   partial sum a slice; dx and dB, a block per (b, c, h, 64-row tile of
//   j) over the i >= j in 32-row blocks (dx = W^T dy + decay dt (B D),
//   dB = (M o L o dt)^T C + decay dt (x D^T), M = dy x^T); dC, a block per
//   (b, c, h, 64-row tile of i) over the j <= i (dC = (M o L o dt) B +
//   exp(cum) (dy H^T)); with them the row sums d(cum) needs; a warp per
//   (b, c, h) turns d(cum) into ddt and dA's partial by a reverse cumsum;
//   a last pass sums dB and dC over a group's heads and dA over (b, c).
//   dB and dC are per head in fp32 until that pass: no floating atomics,
//   so two runs, and CUDA-graph replays, give the same bits.
// * Products on `mma.sync.m16n8k16` (bf16 in, fp32 accumulate), fragments
//   by `ldmatrix` from shared memory padded by 16 bytes a row; a product's
//   left operand that is itself a product (the scores, dS) goes from the
//   accumulator to the next product's A fragments in registers.  fp32
//   inputs run the same kernels with each product by FMA in full fp32
//   (never TF32), in the same accumulator layout.
// * N and hp are padded in shared memory to 64 or 128 (zeros add nothing);
//   rows past Q arrive as zeros and are not stored.
//
// Contract (checked by the Python wrapper and again here): bf16 or fp32 x,
// B, C alike; Q a multiple of 16 up to 256 dividing S; N and hp multiples of
// 16 up to 128; G dividing nh; 16-byte aligned pointers and strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;        // rows of a tile (scan, dx / dB, dC)
constexpr int kFwdCols = 64;     // the forward scan's key block
constexpr int kBwdCols = 32;     // the backward's inner block
constexpr int kStateRows = 64;   // chunk_state's rows a step
constexpr int kPassThreads = 256;
constexpr int kPassPer = 4;      // state elements a thread carries
constexpr int kSlice = kPassThreads * kPassPer;
constexpr int kMaxQ = 256;
constexpr int kSmemMax = 232448;

enum Dtype { kBf16 = 0, kF32 = 1 };
enum Error { kErrArgs = -1 };
// planted faults, for the smoke check only: chunk 1's carried state
// dropped; the intra-chunk mask's diagonal dropped
enum Plant { kPlantState = 1, kPlantDiag = 2 };

struct Params {
  const void* x;
  const void* B;
  const void* C;
  const float* dt;
  const float* A;
  const void* dy;
  void* y;
  float* cum;      // (b, nc, nh, Q)
  float* state;    // (b, nc, nh, N, hp): chunk summaries, then H_c
  float* dstate;   // (b, nc, nh, N, hp): G_c, then D_c
  float* dcl;      // (b, nc, nh, slices): <D_c, H_c> partials
  float* rows;     // (4, b, nc, nh, Q): qsum, e, psum, yd
  float* dBp;      // (b, S, nh, N) per-head dB
  float* dCp;      // (b, S, nh, N) per-head dC
  float* dAp;      // (b, nc, nh)
  void* dx;
  float* ddt;
  float* dA;
  void* dB;
  void* dC;
  long long x_sb, x_ss, x_sh;       // strides in elements
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dy_sb, dy_ss, dy_sh;
  int Bsz, S, nh, hp, G, N, Q, nc, hpg, slices, plant;
};

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

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
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

template <int N>
__device__ __forceinline__ void zero(float (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// --- warp products -----------------------------------------------------------
// Accumulators in the mma.m16n8k16 layout: a warp's 16 rows, tile n (8
// columns) at acc[n]; thread (g, t) = (lane / 4, lane % 4) holds rows g and
// g + 8, columns 2t and 2t + 1 of each tile.

// NT: C[16 x 8 NT] += A[16 x K] B[8 NT x K]^T, A and B row-major.
template <int NT, int K, int LDA, int LDB>
__device__ __forceinline__ void gemm_nt(float (*acc)[4],
                                        const __nv_bfloat16* A,
                                        const __nv_bfloat16* B, int lane) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "tile");
  const __nv_bfloat16* a = A + (lane & 15) * LDA + (lane >> 4) * 8;
  const __nv_bfloat16* b =
      B + ((lane & 7) + (lane >> 4) * 8) * LDB + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(a0, a1, a2, a3, a + ks * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3, b + np * 16 * LDB + ks * 16);
      mma_bf16(acc[2 * np], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

template <int NT, int K, int LDA, int LDB>
__device__ __forceinline__ void gemm_nt(float (*acc)[4], const float* A,
                                        const float* B, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * LDA;
  const float* b = B + 2 * t * LDB;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a0 + 8 * LDA + k);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 y0 = *reinterpret_cast<const float4*>(b + n * 8 * LDB + k);
      const float4 y1 =
          *reinterpret_cast<const float4*>(b + (n * 8 + 1) * LDB + k);
      float* c = acc[n];
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

// NN: C[16 x 8 NT] += A[16 x K] B[K x 8 NT], A and B row-major.
template <int NT, int K, int LDA, int LDB>
__device__ __forceinline__ void gemm_nn(float (*acc)[4],
                                        const __nv_bfloat16* A,
                                        const __nv_bfloat16* B, int lane) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "tile");
  const __nv_bfloat16* a = A + (lane & 15) * LDA + (lane >> 4) * 8;
  const __nv_bfloat16* b =
      B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(a0, a1, a2, a3, a + ks * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3, b + ks * 16 * LDB + np * 16);
      mma_bf16(acc[2 * np], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

template <int NT, int K, int LDA, int LDB>
__device__ __forceinline__ void gemm_nn(float (*acc)[4], const float* A,
                                        const float* B, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = A + g * LDA;
  const float* b = B + 2 * t;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float p0 = a0[k], p1 = a0[8 * LDA + k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(b + k * LDB + n * 8);
      float* c = acc[n];
      c[0] = fmaf(p0, y.x, c[0]);
      c[1] = fmaf(p0, y.y, c[1]);
      c[2] = fmaf(p1, y.x, c[2]);
      c[3] = fmaf(p1, y.y, c[3]);
    }
  }
}

// RN: C[16 x 8 NT] += P[16 x 8 KT] B[8 KT x 8 NT]: P in registers in the
// accumulator layout (rounded to bf16 here), B row-major.
template <int NT, int KT, int LDB>
__device__ __forceinline__ void gemm_rn(float (*acc)[4], float (*P)[4],
                                        const __nv_bfloat16* B, int lane) {
  static_assert(NT % 2 == 0 && KT % 2 == 0, "tile");
  const __nv_bfloat16* b =
      B + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KT / 2; ++ks) {
    const float* p0 = P[2 * ks];
    const float* p1 = P[2 * ks + 1];
    const uint32_t a0 = pack_bf16(p0[0], p0[1]);
    const uint32_t a1 = pack_bf16(p0[2], p0[3]);
    const uint32_t a2 = pack_bf16(p1[0], p1[1]);
    const uint32_t a3 = pack_bf16(p1[2], p1[3]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3, b + ks * 16 * LDB + np * 16);
      mma_bf16(acc[2 * np], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// The same in fp32: each P element is fetched from the lane that holds it.
template <int NT, int KT, int LDB>
__device__ __forceinline__ void gemm_rn(float (*acc)[4], float (*P)[4],
                                        const float* B, int lane) {
  const int t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* pk = P[kt];
      const float p0 = __shfl_sync(0xffffffffu, pk[j & 1], quad | (j >> 1));
      const float p1 =
          __shfl_sync(0xffffffffu, pk[2 + (j & 1)], quad | (j >> 1));
      const float* row = B + (kt * 8 + j) * LDB + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(row + n * 8);
        float* c = acc[n];
        c[0] = fmaf(p0, y.x, c[0]);
        c[1] = fmaf(p0, y.y, c[1]);
        c[2] = fmaf(p1, y.x, c[2]);
        c[3] = fmaf(p1, y.y, c[3]);
      }
    }
}

// --- staging -----------------------------------------------------------------

// ROWS rows of `cols` elements (a multiple of 16 bytes) from `src` (row
// stride `stride`) into `dst` (row stride LD, COLS columns): rows from
// `valid` on and columns from `cols` on arrive as zeros.
template <typename T, int LD, int ROWS, int COLS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long stride, int valid,
                                           int cols) {
  constexpr int kE16 = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = COLS / kE16;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i - r * kChunks) * kE16;
    const bool ok = r < valid && c < cols;
    cp_async16(dst + r * LD + c, ok ? src + r * stride + c : src,
               ok ? 16 : 0);
  }
}

// An fp32 (rows x cols) row-major matrix into `dst` (ROWS x COLS, row
// stride LD) as T, zeros past it.
template <typename T, int LD, int ROWS, int COLS>
__device__ __forceinline__ void stage_f32(T* dst, const float* src, int rows,
                                          int cols) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += blockDim.x) {
    const int r = i / COLS, c = i - r * COLS;
    dst[r * LD + c] =
        from_f<T>(r < rows && c < cols ? src[r * cols + c] : 0.f);
  }
}

template <typename T>
struct Pad {
  static constexpr int kPad = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ long long item_of(int b, int c, int h,
                                            const Params& p) {
  return (static_cast<long long>(b) * p.nc + c) * p.nh + h;
}

// --- forward -----------------------------------------------------------------

// chunk_state: per (b, c, h), a block of NP / 16 warps.  Forward: cum (the
// in-chunk cumsum of dt * A, a warp scan), written out, and the chunk's
// summary B^T ((exp(cum_L - cum) dt) * x) into `state`.  Backward (BWD):
// G_c = C^T (exp(cum) * dy) into `dstate`.
template <typename T, int NP, int HP, bool BWD>
struct StateShapes {
  static constexpr int kPad = Pad<T>::kPad;
  static constexpr int LDT = kStateRows + kPad;   // B^T rows
  static constexpr int LDX = HP + kPad;
  static constexpr int kSmem =
      static_cast<int>(sizeof(T)) * (NP * LDT + kStateRows * LDX) +
      2 * kMaxQ * 4;
};

template <typename T, int NP, int HP, bool BWD>
__global__ void __launch_bounds__(NP * 2)
    ssd_chunk_state_kernel(const Params p) {
  using S = StateShapes<T, NP, HP, BWD>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bt = reinterpret_cast<T*>(smem);
  T* wx = bt + NP * S::LDT;
  float* cum_s = reinterpret_cast<float*>(wx + kStateRows * S::LDX);
  float* dt_s = cum_s + kMaxQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x % p.nh;
  const int c = (blockIdx.x / p.nh) % p.nc;
  const int b = blockIdx.x / (p.nh * p.nc);
  const long long item = item_of(b, c, h, p);
  const int s0 = c * p.Q;
  const int gi = h / p.hpg;

  for (int i = threadIdx.x; i < p.Q; i += blockDim.x)
    dt_s[i] = p.dt[(static_cast<long long>(b) * p.S + s0 + i) * p.nh + h];
  if (BWD) {
    for (int i = threadIdx.x; i < p.Q; i += blockDim.x)
      cum_s[i] = p.cum[item * p.Q + i];
  }
  __syncthreads();
  if (!BWD && warp == 0) {
    // inclusive cumsum of dt * A: each lane a run of `per` positions, then
    // the lanes' totals scanned
    const float a = p.A[h];
    const int per = (p.Q + 31) / 32, i0 = lane * per;
    float run = 0.f;
    float v[kMaxQ / 32];
#pragma unroll
    for (int k = 0; k < kMaxQ / 32; ++k) {
      if (k < per && i0 + k < p.Q) run += dt_s[i0 + k] * a;
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
        p.cum[item * p.Q + i0 + k] = v[k] + excl;
      }
    }
  }
  __syncthreads();

  const T* bsrc = static_cast<const T*>(BWD ? p.C : p.B) +
                  b * (BWD ? p.c_sb : p.b_sb) + gi * (BWD ? p.c_sg : p.b_sg);
  const long long bss = BWD ? p.c_ss : p.b_ss;
  const T* xsrc = static_cast<const T*>(BWD ? p.dy : p.x) +
                  b * (BWD ? p.dy_sb : p.x_sb) + h * (BWD ? p.dy_sh : p.x_sh);
  const long long xss = BWD ? p.dy_ss : p.x_ss;
  const float cum_last = cum_s[p.Q - 1];
  float acc[HP / 8][4];
  zero<HP / 8>(acc);
  for (int j0 = 0; j0 < p.Q; j0 += kStateRows) {
    // B^T (or C^T) transposed into shared memory; the weighted x (or dy)
    for (int i = threadIdx.x; i < kStateRows * NP; i += blockDim.x) {
      const int jj = i / NP, n = i - jj * NP, j = j0 + jj;
      bt[n * S::LDT + jj] = (j < p.Q && n < p.N)
                                ? bsrc[static_cast<long long>(s0 + j) * bss + n]
                                : from_f<T>(0.f);
    }
    for (int i = threadIdx.x; i < kStateRows * HP; i += blockDim.x) {
      const int jj = i / HP, col = i - jj * HP, j = j0 + jj;
      float v = 0.f;
      if (j < p.Q && col < p.hp) {
        const float w = BWD ? expf(cum_s[j])
                            : expf(cum_last - cum_s[j]) * dt_s[j];
        v = to_f(xsrc[static_cast<long long>(s0 + j) * xss + col]) * w;
      }
      wx[jj * S::LDX + col] = from_f<T>(v);
    }
    __syncthreads();
    gemm_nn<HP / 8, kStateRows, S::LDT, S::LDX>(acc, bt + warp * 16 * S::LDT,
                                                wx, lane);
    __syncthreads();
  }
  float* out = (BWD ? p.dstate : p.state) + item * p.N * p.hp;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= p.hp) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = warp * 16 + g + 8 * hh;
      if (row < p.N)
        store2(out + row * p.hp + col, acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
}

// state_pass: per (b, h) and slice of the N * hp state elements, the
// recurrence over the chunks; each chunk's summary is replaced by the state
// that enters it (H_c; H_0 = 0).
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(const Params p) {
  const int h = blockIdx.y % p.nh, b = blockIdx.y / p.nh;
  const int size = p.N * p.hp;
  float hs[kPassPer];
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) hs[k] = 0.f;
  for (int c = 0; c < p.nc; ++c) {
    const long long item = item_of(b, c, h, p);
    const float decay = expf(p.cum[item * p.Q + p.Q - 1]);
    float* st = p.state + item * size;
    const bool drop = (p.plant & kPlantState) && c == 1;
#pragma unroll
    for (int k = 0; k < kPassPer; ++k) {
      const int e = blockIdx.x * kSlice + k * kPassThreads + threadIdx.x;
      if (e < size) {
        const float s = st[e];
        st[e] = drop ? 0.f : hs[k];
        hs[k] = fmaf(decay, hs[k], s);
      }
    }
  }
}

// chunk_scan: per (b, c, h, 64-row tile), four warps of 16 rows:
// y_i = exp(cum_i) C_i H_c + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j)
// dt_j x_j, the causal key blocks of 64.
template <typename T, int NP, int HP>
struct ScanShapes {
  static constexpr int kPad = Pad<T>::kPad;
  static constexpr int LDN = NP + kPad;
  static constexpr int LDH = HP + kPad;
  static constexpr int kSmem =
      static_cast<int>(sizeof(T)) *
          (kRows * LDN + NP * LDH + kFwdCols * LDN + kFwdCols * LDH) +
      2 * kMaxQ * 4;
  static_assert(kSmem <= kSmemMax, "chunk_scan's shared memory");
};

template <typename T, int NP, int HP>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_scan_kernel(const Params p) {
  using S = ScanShapes<T, NP, HP>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);
  T* hs = cs + kRows * S::LDN;
  T* bs = hs + NP * S::LDH;
  T* xs = bs + kFwdCols * S::LDN;
  float* cum_s = reinterpret_cast<float*>(xs + kFwdCols * S::LDH);
  float* dt_s = cum_s + kMaxQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (p.Q + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % p.nh;
  const int c = blockIdx.x / (tiles * p.nh);
  const int b = blockIdx.y;
  const long long item = item_of(b, c, h, p);
  const int s0 = c * p.Q, r0 = tile * kRows, gi = h / p.hpg;

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                s0 * p.x_ss;
  const T* bg = static_cast<const T*>(p.B) + b * p.b_sb + gi * p.b_sg +
                s0 * p.b_ss;
  const T* cg = static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg +
                s0 * p.c_ss;
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads) {
    cum_s[i] = i < p.Q ? p.cum[item * p.Q + i] : 0.f;
    dt_s[i] = i < p.Q
                  ? p.dt[(static_cast<long long>(b) * p.S + s0 + i) * p.nh + h]
                  : 0.f;
  }
  stage_rows<T, S::LDN, kRows, NP>(cs, cg + r0 * p.c_ss, p.c_ss, p.Q - r0,
                                    p.N);
  stage_f32<T, S::LDH, NP, HP>(hs, p.state + item * p.N * p.hp, p.N, p.hp);
  cp_wait_all();
  __syncthreads();

  const int wr0 = r0 + warp * 16;           // the warp's first row
  const bool active = wr0 < p.Q;
  const int i_lo = wr0 + g, i_hi = wr0 + g + 8;
  const float cum_lo = cum_s[i_lo], cum_hi = cum_s[i_hi];
  float y[HP / 8][4];
  zero<HP / 8>(y);
  if (active) {
    gemm_nn<HP / 8, NP, S::LDN, S::LDH>(y, cs + warp * 16 * S::LDN, hs, lane);
    const float e_lo = expf(cum_lo), e_hi = expf(cum_hi);
#pragma unroll
    for (int n = 0; n < HP / 8; ++n) {
      y[n][0] *= e_lo;
      y[n][1] *= e_lo;
      y[n][2] *= e_hi;
      y[n][3] *= e_hi;
    }
  }
  const bool diag = (p.plant & kPlantDiag) == 0;
  const int j_end = min(r0 + kRows, p.Q);
  for (int j0 = 0; j0 < j_end; j0 += kFwdCols) {
    __syncthreads();
    stage_rows<T, S::LDN, kFwdCols, NP>(bs, bg + j0 * p.b_ss, p.b_ss,
                                         p.Q - j0, p.N);
    stage_rows<T, S::LDH, kFwdCols, HP>(xs, xg + j0 * p.x_ss, p.x_ss,
                                         p.Q - j0, p.hp);
    cp_wait_all();
    __syncthreads();
    if (!active || j0 > wr0 + 15) continue;
    float s[kFwdCols / 8][4];
    zero<kFwdCols / 8>(s);
    gemm_nt<kFwdCols / 8, NP, S::LDN, S::LDN>(s, cs + warp * 16 * S::LDN, bs,
                                              lane);
#pragma unroll
    for (int n = 0; n < kFwdCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i_lo : i_hi;
        const int j = j0 + n * 8 + 2 * t + (e & 1);
        const bool ok = i < p.Q && (j < i || (diag && j == i));
        s[n][e] = ok ? s[n][e] * expf((e < 2 ? cum_lo : cum_hi) - cum_s[j]) *
                           dt_s[j]
                     : 0.f;
      }
    }
    gemm_rn<HP / 8, kFwdCols / 8, S::LDH>(y, s, xs, lane);
  }
  if (!active) return;
  T* out = static_cast<T*>(p.y) +
           (static_cast<long long>(b) * p.S + s0) * p.nh * p.hp + h * p.hp;
  const long long rs = static_cast<long long>(p.nh) * p.hp;
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= p.hp) continue;
    if (i_lo < p.Q) store2(out + i_lo * rs + col, y[n][0], y[n][1]);
    if (i_hi < p.Q) store2(out + i_hi * rs + col, y[n][2], y[n][3]);
  }
}

// --- backward ----------------------------------------------------------------

// The reverse state pass: per (b, h) and slice, D_c = dH_{c+1} (written over
// G_c), dH_c = G_c + exp(cum_L) dH_{c+1}, and the slice's part of
// <D_c, H_c> (times exp(cum_L): the chunk decay's gradient) in `dcl`.
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_bwd_kernel(const Params p) {
  __shared__ float red[kPassThreads / 32];
  const int h = blockIdx.y % p.nh, b = blockIdx.y / p.nh;
  const int size = p.N * p.hp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dh[kPassPer];
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) dh[k] = 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    const long long item = item_of(b, c, h, p);
    const float decay = expf(p.cum[item * p.Q + p.Q - 1]);
    float* ds = p.dstate + item * size;
    const float* hst = p.state + item * size;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kPassPer; ++k) {
      const int e = blockIdx.x * kSlice + k * kPassThreads + threadIdx.x;
      if (e < size) {
        const float gc = ds[e];
        ds[e] = dh[k];
        part = fmaf(dh[k], hst[e], part);
        dh[k] = fmaf(decay, dh[k], gc);
      }
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < kPassThreads / 32; ++w) tot += red[w];
      p.dcl[item * p.slices + blockIdx.x] = decay * tot;
    }
    __syncthreads();
  }
}

// Shared memory of the dx / dB and dC kernels: a 64-row tile of two
// operands (x and B, or dy and C), the chunk's D_c or H_c, a 32-row block of
// the other two, cum and dt.
template <typename T, int NP, int HP>
struct BwdShapes {
  static constexpr int kPad = Pad<T>::kPad;
  static constexpr int LDN = NP + kPad;
  static constexpr int LDH = HP + kPad;
  static constexpr int kSmem =
      static_cast<int>(sizeof(T)) *
          (kRows * (LDH + LDN) + NP * LDH + kBwdCols * (LDH + LDN)) +
      2 * kMaxQ * 4;
  static_assert(kSmem <= kSmemMax, "the backward's shared memory");
};

// dx and dB (per head): per (b, c, h, 64-row tile of j), the i >= j in
// blocks of 32.  Also qsum_j = sum_i (C_i . B_j) L_ij M_ij and
// e_j = exp(cum_L - cum_j) B_j . (D x_j) for ddt.
template <typename T, int NP, int HP>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dx_kernel(const Params p) {
  using S = BwdShapes<T, NP, HP>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* bs = xs + kRows * S::LDH;
  T* ds = bs + kRows * S::LDN;
  T* dys = ds + NP * S::LDH;
  T* cs = dys + kBwdCols * S::LDH;
  float* cum_s = reinterpret_cast<float*>(cs + kBwdCols * S::LDN);
  float* dt_s = cum_s + kMaxQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (p.Q + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % p.nh;
  const int c = blockIdx.x / (tiles * p.nh);
  const int b = blockIdx.y;
  const long long item = item_of(b, c, h, p);
  const int s0 = c * p.Q, r0 = tile * kRows, gi = h / p.hpg;

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                s0 * p.x_ss;
  const T* bg = static_cast<const T*>(p.B) + b * p.b_sb + gi * p.b_sg +
                s0 * p.b_ss;
  const T* cg = static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg +
                s0 * p.c_ss;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh +
                 s0 * p.dy_ss;
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads) {
    cum_s[i] = i < p.Q ? p.cum[item * p.Q + i] : 0.f;
    dt_s[i] = i < p.Q
                  ? p.dt[(static_cast<long long>(b) * p.S + s0 + i) * p.nh + h]
                  : 0.f;
  }
  stage_rows<T, S::LDH, kRows, HP>(xs, xg + r0 * p.x_ss, p.x_ss, p.Q - r0,
                                    p.hp);
  stage_rows<T, S::LDN, kRows, NP>(bs, bg + r0 * p.b_ss, p.b_ss, p.Q - r0,
                                    p.N);
  stage_f32<T, S::LDH, NP, HP>(ds, p.dstate + item * p.N * p.hp, p.N, p.hp);
  cp_wait_all();
  __syncthreads();

  const int wr0 = r0 + warp * 16;
  const bool active = wr0 < p.Q;
  const int j_lo = wr0 + g, j_hi = wr0 + g + 8;
  const float cum_lo = cum_s[j_lo], cum_hi = cum_s[j_hi];
  const float dt_lo = dt_s[j_lo], dt_hi = dt_s[j_hi];
  const float cum_last = cum_s[p.Q - 1];
  float dx[HP / 8][4], db[NP / 8][4];
  zero<HP / 8>(dx);
  zero<NP / 8>(db);
  float qs_lo = 0.f, qs_hi = 0.f, e_lo = 0.f, e_hi = 0.f;
  if (active) {
    // the state's part: BD = B D into dx, e_j = decay_j (x_j . BD_j), then
    // dx = decay dt BD; xD = x D^T into dB, dB = decay dt xD
    gemm_nn<HP / 8, NP, S::LDN, S::LDH>(dx, bs + warp * 16 * S::LDN, ds,
                                        lane);
#pragma unroll
    for (int n = 0; n < HP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      const T* xl = xs + (warp * 16 + g) * S::LDH + col;
      e_lo = fmaf(to_f(xl[0]), dx[n][0], fmaf(to_f(xl[1]), dx[n][1], e_lo));
      e_hi = fmaf(to_f(xl[8 * S::LDH]), dx[n][2],
                  fmaf(to_f(xl[8 * S::LDH + 1]), dx[n][3], e_hi));
    }
    const float dec_lo = j_lo < p.Q ? expf(cum_last - cum_lo) : 0.f;
    const float dec_hi = j_hi < p.Q ? expf(cum_last - cum_hi) : 0.f;
    e_lo = quad_sum(e_lo) * dec_lo;
    e_hi = quad_sum(e_hi) * dec_hi;
    const float w_lo = dec_lo * dt_lo, w_hi = dec_hi * dt_hi;
#pragma unroll
    for (int n = 0; n < HP / 8; ++n) {
      dx[n][0] *= w_lo;
      dx[n][1] *= w_lo;
      dx[n][2] *= w_hi;
      dx[n][3] *= w_hi;
    }
    gemm_nt<NP / 8, HP, S::LDH, S::LDH>(db, xs + warp * 16 * S::LDH, ds,
                                        lane);
#pragma unroll
    for (int n = 0; n < NP / 8; ++n) {
      db[n][0] *= w_lo;
      db[n][1] *= w_lo;
      db[n][2] *= w_hi;
      db[n][3] *= w_hi;
    }
  }
  for (int i0 = r0; i0 < p.Q; i0 += kBwdCols) {
    __syncthreads();
    stage_rows<T, S::LDH, kBwdCols, HP>(dys, dyg + i0 * p.dy_ss, p.dy_ss,
                                         p.Q - i0, p.hp);
    stage_rows<T, S::LDN, kBwdCols, NP>(cs, cg + i0 * p.c_ss, p.c_ss,
                                         p.Q - i0, p.N);
    cp_wait_all();
    __syncthreads();
    if (!active || i0 + kBwdCols - 1 < wr0) continue;
    float mt[kBwdCols / 8][4], wt[kBwdCols / 8][4];
    zero<kBwdCols / 8>(mt);
    zero<kBwdCols / 8>(wt);
    gemm_nt<kBwdCols / 8, HP, S::LDH, S::LDH>(mt, xs + warp * 16 * S::LDH,
                                              dys, lane);
    gemm_nt<kBwdCols / 8, NP, S::LDN, S::LDN>(wt, bs + warp * 16 * S::LDN,
                                              cs, lane);
#pragma unroll
    for (int n = 0; n < kBwdCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e < 2 ? j_lo : j_hi;
        const int i = i0 + n * 8 + 2 * t + (e & 1);
        const bool ok = i >= j && i < p.Q && j < p.Q;
        const float lv =
            ok ? expf(cum_s[i] - (e < 2 ? cum_lo : cum_hi)) : 0.f;
        const float dtj = e < 2 ? dt_lo : dt_hi;
        const float cbl = wt[n][e] * lv;
        if (e < 2)
          qs_lo = fmaf(cbl, mt[n][e], qs_lo);
        else
          qs_hi = fmaf(cbl, mt[n][e], qs_hi);
        wt[n][e] = cbl * dtj;            // W^T
        mt[n][e] = mt[n][e] * lv * dtj;  // (M o L o dt)^T
      }
    }
    gemm_rn<HP / 8, kBwdCols / 8, S::LDH>(dx, wt, dys, lane);
    gemm_rn<NP / 8, kBwdCols / 8, S::LDN>(db, mt, cs, lane);
  }
  if (!active) return;
  qs_lo = quad_sum(qs_lo);
  qs_hi = quad_sum(qs_hi);
  const long long rs = static_cast<long long>(p.nh) * p.hp;
  T* dxo = static_cast<T*>(p.dx) +
           (static_cast<long long>(b) * p.S + s0) * rs + h * p.hp;
  float* dbo = p.dBp + ((static_cast<long long>(b) * p.S + s0) * p.nh + h) *
                           p.N;
  const long long rn = static_cast<long long>(p.nh) * p.N;
#pragma unroll
  for (int n = 0; n < HP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= p.hp) continue;
    if (j_lo < p.Q) store2(dxo + j_lo * rs + col, dx[n][0], dx[n][1]);
    if (j_hi < p.Q) store2(dxo + j_hi * rs + col, dx[n][2], dx[n][3]);
  }
#pragma unroll
  for (int n = 0; n < NP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= p.N) continue;
    if (j_lo < p.Q) store2(dbo + j_lo * rn + col, db[n][0], db[n][1]);
    if (j_hi < p.Q) store2(dbo + j_hi * rn + col, db[n][2], db[n][3]);
  }
  if (t == 0) {
    const long long per = static_cast<long long>(p.Bsz) * p.nc * p.nh * p.Q;
    float* rq = p.rows + item * p.Q;
    if (j_lo < p.Q) {
      rq[j_lo] = qs_lo;
      rq[per + j_lo] = e_lo;
    }
    if (j_hi < p.Q) {
      rq[j_hi] = qs_hi;
      rq[per + j_hi] = e_hi;
    }
  }
}

// dC (per head): per (b, c, h, 64-row tile of i), the j <= i in blocks of
// 32.  Also psum_i = sum_j (C_i . B_j) L_ij dt_j M_ij and yd_i = y_off_i .
// dy_i for d(cum).
template <typename T, int NP, int HP>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dc_kernel(const Params p) {
  using S = BwdShapes<T, NP, HP>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* dys = reinterpret_cast<T*>(smem);
  T* cs = dys + kRows * S::LDH;
  T* hs = cs + kRows * S::LDN;
  T* xs = hs + NP * S::LDH;
  T* bs = xs + kBwdCols * S::LDH;
  float* cum_s = reinterpret_cast<float*>(bs + kBwdCols * S::LDN);
  float* dt_s = cum_s + kMaxQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (p.Q + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % p.nh;
  const int c = blockIdx.x / (tiles * p.nh);
  const int b = blockIdx.y;
  const long long item = item_of(b, c, h, p);
  const int s0 = c * p.Q, r0 = tile * kRows, gi = h / p.hpg;

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh +
                s0 * p.x_ss;
  const T* bg = static_cast<const T*>(p.B) + b * p.b_sb + gi * p.b_sg +
                s0 * p.b_ss;
  const T* cg = static_cast<const T*>(p.C) + b * p.c_sb + gi * p.c_sg +
                s0 * p.c_ss;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh +
                 s0 * p.dy_ss;
  for (int i = threadIdx.x; i < kMaxQ; i += kThreads) {
    cum_s[i] = i < p.Q ? p.cum[item * p.Q + i] : 0.f;
    dt_s[i] = i < p.Q
                  ? p.dt[(static_cast<long long>(b) * p.S + s0 + i) * p.nh + h]
                  : 0.f;
  }
  stage_rows<T, S::LDH, kRows, HP>(dys, dyg + r0 * p.dy_ss, p.dy_ss,
                                    p.Q - r0, p.hp);
  stage_rows<T, S::LDN, kRows, NP>(cs, cg + r0 * p.c_ss, p.c_ss, p.Q - r0,
                                    p.N);
  stage_f32<T, S::LDH, NP, HP>(hs, p.state + item * p.N * p.hp, p.N, p.hp);
  cp_wait_all();
  __syncthreads();

  const int wr0 = r0 + warp * 16;
  const bool active = wr0 < p.Q;
  const int i_lo = wr0 + g, i_hi = wr0 + g + 8;
  const float cum_lo = cum_s[i_lo], cum_hi = cum_s[i_hi];
  float dc[NP / 8][4];
  zero<NP / 8>(dc);
  float ps_lo = 0.f, ps_hi = 0.f, yd_lo = 0.f, yd_hi = 0.f;
  if (active) {
    // the state's part: dyH = dy H^T into dC, yd_i = exp(cum_i) C_i . dyH_i,
    // then dC = exp(cum) dyH
    gemm_nt<NP / 8, HP, S::LDH, S::LDH>(dc, dys + warp * 16 * S::LDH, hs,
                                        lane);
#pragma unroll
    for (int n = 0; n < NP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      const T* cl = cs + (warp * 16 + g) * S::LDN + col;
      yd_lo = fmaf(to_f(cl[0]), dc[n][0], fmaf(to_f(cl[1]), dc[n][1], yd_lo));
      yd_hi = fmaf(to_f(cl[8 * S::LDN]), dc[n][2],
                   fmaf(to_f(cl[8 * S::LDN + 1]), dc[n][3], yd_hi));
    }
    const float e_lo = i_lo < p.Q ? expf(cum_lo) : 0.f;
    const float e_hi = i_hi < p.Q ? expf(cum_hi) : 0.f;
    yd_lo = quad_sum(yd_lo) * e_lo;
    yd_hi = quad_sum(yd_hi) * e_hi;
#pragma unroll
    for (int n = 0; n < NP / 8; ++n) {
      dc[n][0] *= e_lo;
      dc[n][1] *= e_lo;
      dc[n][2] *= e_hi;
      dc[n][3] *= e_hi;
    }
  }
  const int j_end = min(r0 + kRows, p.Q);
  for (int j0 = 0; j0 < j_end; j0 += kBwdCols) {
    __syncthreads();
    stage_rows<T, S::LDH, kBwdCols, HP>(xs, xg + j0 * p.x_ss, p.x_ss,
                                         p.Q - j0, p.hp);
    stage_rows<T, S::LDN, kBwdCols, NP>(bs, bg + j0 * p.b_ss, p.b_ss,
                                         p.Q - j0, p.N);
    cp_wait_all();
    __syncthreads();
    if (!active || j0 > wr0 + 15) continue;
    float m[kBwdCols / 8][4], cb[kBwdCols / 8][4];
    zero<kBwdCols / 8>(m);
    zero<kBwdCols / 8>(cb);
    gemm_nt<kBwdCols / 8, HP, S::LDH, S::LDH>(m, dys + warp * 16 * S::LDH,
                                              xs, lane);
    gemm_nt<kBwdCols / 8, NP, S::LDN, S::LDN>(cb, cs + warp * 16 * S::LDN,
                                              bs, lane);
#pragma unroll
    for (int n = 0; n < kBwdCols / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i_lo : i_hi;
        const int j = j0 + n * 8 + 2 * t + (e & 1);
        const bool ok = j <= i && i < p.Q;
        const float lv =
            ok ? expf((e < 2 ? cum_lo : cum_hi) - cum_s[j]) : 0.f;
        const float dsl = m[n][e] * lv * dt_s[j];
        if (e < 2)
          ps_lo = fmaf(cb[n][e], dsl, ps_lo);
        else
          ps_hi = fmaf(cb[n][e], dsl, ps_hi);
        m[n][e] = dsl;
      }
    }
    gemm_rn<NP / 8, kBwdCols / 8, S::LDN>(dc, m, bs, lane);
  }
  if (!active) return;
  ps_lo = quad_sum(ps_lo);
  ps_hi = quad_sum(ps_hi);
  const long long rn = static_cast<long long>(p.nh) * p.N;
  float* dco = p.dCp + ((static_cast<long long>(b) * p.S + s0) * p.nh + h) *
                           p.N;
#pragma unroll
  for (int n = 0; n < NP / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= p.N) continue;
    if (i_lo < p.Q) store2(dco + i_lo * rn + col, dc[n][0], dc[n][1]);
    if (i_hi < p.Q) store2(dco + i_hi * rn + col, dc[n][2], dc[n][3]);
  }
  if (t == 0) {
    const long long per = static_cast<long long>(p.Bsz) * p.nc * p.nh * p.Q;
    float* rq = p.rows + 2 * per + item * p.Q;
    if (i_lo < p.Q) {
      rq[i_lo] = ps_lo;
      rq[per + i_lo] = yd_lo;
    }
    if (i_hi < p.Q) {
      rq[i_hi] = ps_hi;
      rq[per + i_hi] = yd_hi;
    }
  }
}

// d(cum) -> ddt and dA's partial: a warp per (b, c, h).
//   dcum_i = psum_i + yd_i - dt_i (qsum_i + e_i)
//            + [i = Q-1] (sum_j dt_j e_j + sum of the dcl slices)
//   da_k = sum_{i >= k} dcum_i,  ddt_k = qsum_k + e_k + A da_k,
//   dA's partial = sum_k dt_k da_k.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dt_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
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

// dB and dC: the per-head fp32 partials summed over each group's heads, in
// head order, in the inputs' dtype; dA summed over (b, c).
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_reduce_kernel(const Params p) {
  const long long rows = static_cast<long long>(p.Bsz) * p.S;
  const long long per = rows * p.G * p.N;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kPassThreads + threadIdx.x;
  if (idx < 2 * per) {
    const bool is_c = idx >= per;
    const long long e = is_c ? idx - per : idx;
    const int n = static_cast<int>(e % p.N);
    const int gi = static_cast<int>((e / p.N) % p.G);
    const long long bs = e / (static_cast<long long>(p.N) * p.G);
    const float* src = (is_c ? p.dCp : p.dBp) +
                       (bs * p.nh + static_cast<long long>(gi) * p.hpg) * p.N +
                       n;
    float acc = 0.f;
    for (int k = 0; k < p.hpg; ++k) acc += src[static_cast<long long>(k) * p.N];
    static_cast<T*>(is_c ? p.dC : p.dB)[e] = from_f<T>(acc);
  } else if (idx < 2 * per + p.nh) {
    const int h = static_cast<int>(idx - 2 * per);
    float acc = 0.f;
    for (long long bc = 0; bc < static_cast<long long>(p.Bsz) * p.nc; ++bc)
      acc += p.dAp[bc * p.nh + h];
    p.dA[h] = acc;
  }
}

// --- launch ------------------------------------------------------------------

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename K>
int launch(K kernel, dim3 grid, int threads, int smem, const Params& p,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the launches a call makes, by bit (a probe times each alone)
int g_only = -1;

bool on(int k) { return (g_only >> k) & 1; }

template <typename T, int NP, int HP>
int run_fwd(const Params& p, cudaStream_t st) {
  const unsigned items = static_cast<unsigned>(
      static_cast<long long>(p.Bsz) * p.nc * p.nh);
  int e = 0;
  if (on(0))
    e = launch(ssd_chunk_state_kernel<T, NP, HP, false>, dim3(items), NP * 2,
               StateShapes<T, NP, HP, false>::kSmem, p, st);
  if (!e && on(1))
    e = launch(ssd_state_pass_kernel, dim3(p.slices, p.Bsz * p.nh),
               kPassThreads, 0, p, st);
  const int tiles = static_cast<int>(cdiv(p.Q, kRows));
  if (!e && on(2))
    e = launch(ssd_chunk_scan_kernel<T, NP, HP>,
               dim3(tiles * p.nc * p.nh, p.Bsz), kThreads,
               ScanShapes<T, NP, HP>::kSmem, p, st);
  return e;
}

template <typename T, int NP, int HP>
int run_bwd(const Params& p, cudaStream_t st) {
  const long long items = static_cast<long long>(p.Bsz) * p.nc * p.nh;
  int e = 0;
  if (on(0))
    e = launch(ssd_chunk_state_kernel<T, NP, HP, true>,
               dim3(static_cast<unsigned>(items)), NP * 2,
               StateShapes<T, NP, HP, true>::kSmem, p, st);
  if (!e && on(1))
    e = launch(ssd_state_pass_bwd_kernel, dim3(p.slices, p.Bsz * p.nh),
               kPassThreads, 0, p, st);
  const int tiles = static_cast<int>(cdiv(p.Q, kRows));
  const dim3 grid(tiles * p.nc * p.nh, p.Bsz);
  if (!e && on(2))
    e = launch(ssd_bwd_dx_kernel<T, NP, HP>, grid, kThreads,
               BwdShapes<T, NP, HP>::kSmem, p, st);
  if (!e && on(3))
    e = launch(ssd_bwd_dc_kernel<T, NP, HP>, grid, kThreads,
               BwdShapes<T, NP, HP>::kSmem, p, st);
  if (!e && on(4))
    e = launch(ssd_bwd_dt_kernel,
               dim3(static_cast<unsigned>(cdiv(items, kWarps))), kThreads, 0,
               p, st);
  const long long total = 2LL * p.Bsz * p.S * p.G * p.N + p.nh;
  if (!e && on(5))
    e = launch(ssd_bwd_reduce_kernel<T>,
               dim3(static_cast<unsigned>(cdiv(total, kPassThreads))),
               kPassThreads, 0, p, st);
  return e;
}

// the padded (N, hp): bf16 (64, 64), (128, 64) or (128, 128); fp32 always
// (128, 128)
template <typename T>
int dispatch(bool fwd, const Params& p, cudaStream_t st) {
  if (sizeof(T) == 2 && p.N <= 64 && p.hp <= 64)
    return fwd ? run_fwd<T, 64, 64>(p, st) : run_bwd<T, 64, 64>(p, st);
  if (sizeof(T) == 2 && p.hp <= 64)
    return fwd ? run_fwd<T, 128, 64>(p, st) : run_bwd<T, 128, 64>(p, st);
  return fwd ? run_fwd<T, 128, 128>(p, st) : run_bwd<T, 128, 128>(p, st);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Fills p's shape and strides; false when they break the contract.
// strides: x (batch, row, head), B (batch, row, group), C (3), dy (3).
bool setup(Params& p, int dtype, const long long* strides, int Bsz, int S,
           int nh, int hp, int G, int N, int Q, bool bwd) {
  if (dtype != kBf16 && dtype != kF32) return false;
  const int elem = dtype == kBf16 ? 2 : 4;
  if (Bsz < 1 || S < 1 || nh < 1 || G < 1 || nh % G ||
      static_cast<long long>(Bsz) * nh > 65535 ||
      Q < 16 || Q > kMaxQ || Q % 16 || S % Q || N < 16 || N > 128 ||
      N % 16 || hp < 16 || hp > 128 || hp % 16)
    return false;
  for (int i = 0; i < (bwd ? 12 : 9); ++i)
    if ((strides[i] * elem) % 16) return false;
  if (!aligned16(p.x) || !aligned16(p.B) || !aligned16(p.C)) return false;
  if (bwd && !aligned16(p.dy)) return false;
  p.x_sb = strides[0];
  p.x_ss = strides[1];
  p.x_sh = strides[2];
  p.b_sb = strides[3];
  p.b_ss = strides[4];
  p.b_sg = strides[5];
  p.c_sb = strides[6];
  p.c_ss = strides[7];
  p.c_sg = strides[8];
  p.dy_sb = bwd ? strides[9] : 0;
  p.dy_ss = bwd ? strides[10] : 0;
  p.dy_sh = bwd ? strides[11] : 0;
  p.Bsz = Bsz;
  p.S = S;
  p.nh = nh;
  p.hp = hp;
  p.G = G;
  p.N = N;
  p.Q = Q;
  p.nc = S / Q;
  p.hpg = nh / G;
  p.slices = static_cast<int>(cdiv(static_cast<long long>(N) * hp, kSlice));
  return static_cast<long long>(Bsz) * p.nc * nh <= 0x7fffffffLL / 4;
}

}  // namespace

extern "C" {

// Forward on `stream`: x (b, S, nh, hp), B and C (b, S, G, N) as in the
// header (dtype 0 bf16, 1 fp32), dt (b, S, nh) and A (nh,) fp32; y (b, S,
// nh, hp) contiguous in their dtype; cum (b, S/Q, nh, Q) and state (b, S/Q,
// nh, N, hp) fp32, contiguous: the backward reads both (state holds the
// state entering each chunk).  `plant`: 0, or the smoke check's planted
// faults.  Three launches.  Returns 0, a CUDA error code, or kErrArgs.
int ssd_chunk_scan_fwd(int dtype, const void* x, const void* B, const void* C,
                       const void* dt, const void* A, void* y, void* cum,
                       void* state, const long long* strides, int Bsz, int S,
                       int nh, int hp, int G, int N, int Q, int plant,
                       void* stream) {
  Params p = {};
  p.x = x;
  p.B = B;
  p.C = C;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.y = y;
  p.cum = static_cast<float*>(cum);
  p.state = static_cast<float*>(state);
  p.plant = plant;
  if (!setup(p, dtype, strides, Bsz, S, nh, hp, G, N, Q, false) ||
      !aligned16(y) || !aligned16(state))
    return kErrArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kBf16 ? dispatch<__nv_bfloat16>(true, p, st)
                        : dispatch<float>(true, p, st);
}

// Backward on `stream`: from the forward's inputs, cum and state and y's
// gradient dy (b, S, nh, hp; strided like x), dx (b, S, nh, hp), dB and dC
// (b, S, G, N) contiguous in the inputs' dtype, ddt (b, S, nh) and dA (nh,)
// fp32.  Scratch, fp32: dstate (b, S/Q, nh, N, hp), dcl (b, S/Q, nh,
// ceil(N hp / 1024)), rows (4, b, S/Q, nh, Q), dBp and dCp (b, S, nh, N),
// dAp (b, S/Q, nh).  Six launches.
int ssd_chunk_scan_bwd(int dtype, const void* x, const void* B, const void* C,
                       const void* dt, const void* A, const void* dy,
                       const void* cum, const void* state, void* dstate,
                       void* dcl, void* rows, void* dBp, void* dCp, void* dAp,
                       void* dx, void* ddt, void* dA, void* dB, void* dC,
                       const long long* strides, int Bsz, int S, int nh,
                       int hp, int G, int N, int Q, void* stream) {
  Params p = {};
  p.x = x;
  p.B = B;
  p.C = C;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.dy = dy;
  p.cum = static_cast<float*>(const_cast<void*>(cum));
  p.state = static_cast<float*>(const_cast<void*>(state));
  p.dstate = static_cast<float*>(dstate);
  p.dcl = static_cast<float*>(dcl);
  p.rows = static_cast<float*>(rows);
  p.dBp = static_cast<float*>(dBp);
  p.dCp = static_cast<float*>(dCp);
  p.dAp = static_cast<float*>(dAp);
  p.dx = dx;
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dB = dB;
  p.dC = dC;
  if (!setup(p, dtype, strides, Bsz, S, nh, hp, G, N, Q, true) ||
      !aligned16(dx) || !aligned16(dstate) || !aligned16(state) ||
      !aligned16(dBp) || !aligned16(dCp))
    return kErrArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kBf16 ? dispatch<__nv_bfloat16>(false, p, st)
                        : dispatch<float>(false, p, st);
}

// Restricts the next calls to the launches whose bits `mask` sets (-1:
// all, the default): a probe times each launch alone.
void ssd_chunk_scan_only(int mask) { g_only = mask; }

const char* ssd_chunk_scan_error_string(int code) {
  if (code == kErrArgs) return "arguments outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
