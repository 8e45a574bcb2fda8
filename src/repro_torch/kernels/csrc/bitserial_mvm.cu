// Bit-serial digital-CIM MVM for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bitserial_mvm_kernel`
// (src/repro/kernels/bitserial_mvm.py:45, launched by
// `bitserial_mvm_pallas`).  It computes
//
//     out[m, n] = sum_b  s_b * 2^b * sum_k  bit_b(uint8(x[m, k])) * w[k, n]
//
// for b < act_bits, with s_b = -1 for the MSB plane when `is_signed`, else
// +1: `(M,K) int8 @ (K,N) int8 -> (M,N) int32` as a digital CIM macro does
// it, one {0,1} activation bit-plane at a time with shift-add accumulation.
//
// Design.  One thread block owns a (bm, bn) output tile and walks K in
// bk-deep steps: the loop inside the block takes the place of the TPU's
// sequential "arbitrary" K grid axis, whose int32 VMEM scratch becomes
// per-thread registers.  Each step stages the x tile and the w tile in
// shared memory with 4 consecutive K bytes packed per 32-bit word (x
// transposed with an odd row pitch, so the staging stores do not collide
// on banks).  Each thread owns an 8x8 micro-tile of outputs, strided by
// bm/8 rows and bn/8 columns so that neighbouring threads read
// neighbouring shared-memory words and write neighbouring output words.
// For every plane b the thread peels the plane out of four packed
// activation bytes with one shift and one mask ((word >> b) & 0x01010101)
// and feeds it to `__dp4a` against four packed weight bytes; the plane's
// partial sums for the step are then shifted by b and added to (or, for
// the signed MSB, subtracted from) the accumulator.
//
// Overflow.  Signed overflow and left shifts of negative values are
// undefined in C++, so accumulation and shifts run in uint32_t and the
// result is reinterpreted at the end: the output is then the exact sum
// modulo 2^32, bit-identical to the reference's wrapping int32 arithmetic
// in any summation order.  A step's plane partial sum is at most
// bk * 128 in magnitude and cannot overflow its int32 register.
//
// Bound on this card.  The function is one int8 GEMM: the plane sum
// equals x @ w over the act_bits low bits of x, 2*M*K*N operations on
// M*K + K*N + 4*M*N bytes.  At 1979e12 int8 operations/s and 3.35e12 B/s
// every GEMM of the main path is bound by its bytes (the int32 output
// dominates).  The bit-serial design does act_bits times the function's
// operations.  This kernel runs them on the CUDA cores (`__dp4a`, 4 MACs
// per instruction), far below the tensor-core peak, and a grid of
// (M/bm)*(N/bn) blocks leaves most of the 132 SMs idle when M*N is small
// and K deep: it is the simple, exact first version.  Int8 `mma`/`wgmma`
// on the bit-planes with TMA staging, and split-K for small grids, are
// the route to the bound.
//
// Contract (checked by the Python wrapper): M % bm == 0, N % bn == 0,
// K % bk == 0, bm and bn multiples of 8, (bm/8)*(bn/8) <= 256 threads,
// bk a multiple of 4, x and w contiguous row-major and 4-byte aligned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;          // outputs per thread along each axis
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
bitserial_mvm_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     int32_t* __restrict__ out,
                     int M, int N, int K, int bm, int bn, int bk,
                     int act_bits, int is_signed) {
  extern __shared__ uint32_t smem[];
  const int kq = bk / 4;                 // packed K words per step
  const int xpitch = bm + 1;             // odd pitch: no bank collisions
  uint32_t* xs = smem;                   // [kq][xpitch]: x[m, 4q..4q+3]
  uint32_t* ws = smem + kq * xpitch;     // [kq][bn]:     w[4q..4q+3, n]
  uint8_t* ws_bytes = reinterpret_cast<uint8_t*>(ws);

  const int tcols = bn / kTile;          // threads along N
  const int trows = bm / kTile;          // threads along M
  const int tx = threadIdx.x % tcols;
  const int ty = threadIdx.x / tcols;
  const int nthreads = blockDim.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * bm;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * bn;

  uint32_t acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += bk) {
    // x tile: bm rows x kq words, read along K (coalesced), stored
    // transposed to [q][m]
    for (int e = threadIdx.x; e < bm * kq; e += nthreads) {
      const int r = e / kq, q = e % kq;
      xs[q * xpitch + r] = *reinterpret_cast<const uint32_t*>(
          x + (m0 + r) * K + k0 + 4 * q);
    }
    // w tile: bk rows x bn/4 words, read along N (coalesced); each byte
    // lands in column n's packed word for its K quad
    for (int e = threadIdx.x; e < bk * (bn / 4); e += nthreads) {
      const int kk = e / (bn / 4), c = e % (bn / 4);
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          w + static_cast<int64_t>(k0 + kk) * N + n0 + 4 * c);
      const int q = kk / 4, lane = kk % 4;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        ws_bytes[(q * bn + 4 * c + t) * 4 + lane] =
            static_cast<uint8_t>(v >> (8 * t));
    }
    __syncthreads();

    for (int b = 0; b < act_bits; ++b) {
      int part[kTile][kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) part[i][j] = 0;

      for (int q = 0; q < kq; ++q) {
        int plane[kTile], wv[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          plane[i] = static_cast<int>(
              (xs[q * xpitch + ty + i * trows] >> b) & 0x01010101u);
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          wv[j] = static_cast<int>(ws[q * bn + tx + j * tcols]);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            part[i][j] = __dp4a(plane[i], wv[j], part[i][j]);
      }

      const bool negative = is_signed && b == act_bits - 1;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const uint32_t term = static_cast<uint32_t>(part[i][j]) << b;
          acc[i][j] = negative ? acc[i][j] - term : acc[i][j] + term;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int64_t row = m0 + ty + i * trows;
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      out[row * N + n0 + tx + j * tcols] = static_cast<int32_t>(acc[i][j]);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
int bitserial_mvm_launch(const void* x, const void* w, void* out, int M,
                         int N, int K, int bm, int bn, int bk, int act_bits,
                         int is_signed, void* stream) {
  const size_t smem =
      sizeof(uint32_t) * static_cast<size_t>(bk / 4) * (bm + 1 + bn);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bitserial_mvm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(M / bm, N / bn);
  const dim3 block((bm / kTile) * (bn / kTile));
  bitserial_mvm_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, N, K, bm, bn, bk, act_bits, is_signed);
  return static_cast<int>(cudaGetLastError());
}

const char* bitserial_mvm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
