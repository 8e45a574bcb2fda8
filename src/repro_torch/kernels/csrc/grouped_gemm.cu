// Grouped expert GEMM (`ragged_dot`) for NVIDIA Hopper (sm_90a): the
// segment matrix products of expert-parallel MoE, forward and backward.
//
// Replaces `lax.ragged_dot` in src/repro/models/moe_ep.py:114-116 (XLA
// compute, not a Pallas kernel) and the two products its transpose rule
// gives.  With x (M, K), w (G, K, N) and group_sizes (G,) int32, the rows of
// x are cut into consecutive groups, group g owning group_sizes[g] rows:
//
//     fwd:  y[rows of g]  = x[rows of g] @ w[g]          (M, N)
//     dx:   dx[rows of g] = dy[rows of g] @ w[g]^T       (M, K)
//     dw:   dw[g]         = x[rows of g]^T @ dy[rows of g]   (G, K, N)
//
// Rows past sum(group_sizes) come out zero in y and dx, and the dw of an
// empty group is written as zeros: every output element is written, so the
// wrapper allocates with torch.empty.  Negative sizes count as 0 and a sum
// past M is cut at M.
//
// Bound on this card.  At decode (olmoe: 32 (token, expert) hits over 64
// experts) a group holds a row or two and the products read each touched
// expert's weights once: bytes, at 3.35e12 B/s.  In training (olmoe: 65,536
// hits, ~1,000 rows a group) they are 2*rows*K*N operations at the bf16
// tensor cores' 989e12/s.
//
// Design (a simple, correct kernel first).
// * Group offsets on the device: every block reads group_sizes (G <= 1024)
//   and scans it in one warp into shared memory (row offsets, and for the
//   row-ragged products each group's first tile).  No host sync: the grid
//   is sized by an upper bound known on the host, ceil(M / BM) + G row-tile
//   slots (the groups' tiles and the tiles of the rows past their sum fit
//   in it); a block finds its group by a binary search over the tile starts,
//   masks the group's edge rows itself, and a slot past the groups' tiles
//   zeroes rows past the sum (or exits).
// * Tiles of 64 x 128 outputs, 4 warps (32 x 64 each), a K step of 32 (bf16)
//   or 16 (fp32), staged through a ring of 3 (bf16) or 2 (fp32) stages with
//   16-byte `cp.async` copies (zero-filled past the edges) when the rows are
//   16-byte aligned, else by element loads.  Each operand is staged in its
//   memory order (no transposing copy): w^T for dx and x^T for dw are read
//   from w and x as they lie, and `ldmatrix` (`.trans` where the staged
//   order is not the fragment's) builds the fragments.
// * bf16: `mma.sync.m16n8k16` with fp32 accumulation, the output rounded
//   once to bf16.  fp32: an FFMA tile (8 x 8 outputs a thread).
// * The weights stream through the ring once per row tile; at decode a group
//   has one row tile, so each touched expert's weights are read once.
//   Making it fast (TMA, `wgmma`, a persistent grid) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 64;          // output rows a block
constexpr int kBN = 128;         // output columns a block
constexpr int kThreads = 128;    // 4 warps
constexpr int kMaxGroups = 1024;
constexpr int kErrArgs = -1;

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };

template <typename T>
struct Traits;
template <>
struct Traits<bf16> {
  static constexpr int BK = 32, STAGES = 3;
};
template <>
struct Traits<float> {
  static constexpr int BK = 16, STAGES = 2;
};

// A staged operand tile: R rows (output rows or columns) by BK reduction
// steps.  KC: the reduction index is the contiguous one in memory, stored
// [R][BK + pad]; else stored [BK][R + pad].  The 16-byte pad keeps
// `ldmatrix` free of bank conflicts and every stored row 16-byte aligned.
template <typename T, bool KC, int R>
struct Tile {
  static constexpr int BK = Traits<T>::BK;
  static constexpr int EV = 16 / sizeof(T);        // elements a 16-byte copy
  static constexpr int LD = KC ? BK + EV : R + EV;  // elements a stored row
  static constexpr int ROWS = KC ? R : BK;
  static constexpr int SIZE = ROWS * LD;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the tile whose element (r, k) -- r along the tile's R rows, k along
// the reduction -- lies at base[r * ld + k] (KC) or base[k * ld + r], for
// r in [r0, r0 + R) and k in [k0, k0 + BK); elements with r outside
// [r_lo, r_hi) or k outside [k_lo, k_hi) are zeros.  VEC: 16-byte copies
// along the contiguous index (its bounds and ld are multiples of EV, the
// base 16-byte aligned, so a copy is wholly inside or wholly outside).
template <typename T, bool KC, int R, bool VEC>
__device__ __forceinline__ void load_tile(T* s, const T* base, long long ld,
                                          int r0, int r_lo, int r_hi, int k0,
                                          int k_lo, int k_hi) {
  using S = Tile<T, KC, R>;
  constexpr int CONT = KC ? S::BK : R;   // the contiguous extent
  constexpr int OTHER = KC ? R : S::BK;
  if constexpr (VEC) {
    constexpr int CPR = CONT / S::EV;    // copies a stored row
#pragma unroll
    for (int i = threadIdx.x; i < OTHER * CPR; i += kThreads) {
      const int o = i / CPR, c = (i % CPR) * S::EV;
      const int r = KC ? r0 + o : r0 + c;
      const int k = KC ? k0 + c : k0 + o;
      const bool ok = r >= r_lo && r < r_hi && k >= k_lo && k < k_hi;
      const T* src =
          ok ? base + (KC ? static_cast<long long>(r) * ld + k
                          : static_cast<long long>(k) * ld + r)
             : base;
      cp_async16(s + o * S::LD + c, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < OTHER * CONT; i += kThreads) {
      const int o = i / CONT, c = i % CONT;
      const int r = KC ? r0 + o : r0 + c;
      const int k = KC ? k0 + c : k0 + o;
      const bool ok = r >= r_lo && r < r_hi && k >= k_lo && k < k_hi;
      s[o * S::LD + c] =
          ok ? base[KC ? static_cast<long long>(r) * ld + k
                       : static_cast<long long>(k) * ld + r]
             : zero<T>();
    }
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The accumulators of a thread: bf16, 2 x 8 MMA tiles of 16 x 8 (a warp's
// 32 x 64); fp32, 8 x 8 outputs at rows tm + 8i, columns tn + 16j.
template <typename T>
struct Acc;
template <>
struct Acc<bf16> {
  float v[2][8][4];
};
template <>
struct Acc<float> {
  float v[8][8];
};

// One staged K step of the tile into the accumulators.
template <typename T, bool A_KC, bool B_KC>
__device__ __forceinline__ void compute_stage(const T* sA, const T* sB,
                                              Acc<T>& acc) {
  using TA = Tile<T, A_KC, kBM>;
  using TB = Tile<T, B_KC, kBN>;
  constexpr int BK = Traits<T>::BK;
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
    const int j = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m0 = wm + mi * 16;
        // matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15): a0..a3
        if constexpr (A_KC)
          ldsm_x4(af[mi], sA + (m0 + rr + 8 * (j & 1)) * TA::LD + ks +
                              8 * (j >> 1));
        else
          ldsm_x4_t(af[mi], sA + (ks + rr + 8 * (j >> 1)) * TA::LD + m0 +
                                8 * (j & 1));
      }
      unsigned bfr[8][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n0 = wn + np * 16;
        unsigned r[4];
        // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
        // (n 8-15, k 8-15): b0, b1 of two 8-column tiles
        if constexpr (B_KC)
          ldsm_x4(r, sB + (n0 + rr + 8 * (j >> 1)) * TB::LD + ks +
                         8 * (j & 1));
        else
          ldsm_x4_t(r, sB + (ks + rr + 8 * (j & 1)) * TB::LD + n0 +
                           8 * (j >> 1));
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_bf16(acc.v[mi][ni], af[mi], bfr[ni]);
    }
  } else {
    const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = tm + 8 * i;
        a[i] = A_KC ? sA[m * TA::LD + k] : sA[k * TA::LD + m];
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = tn + 16 * jj;
        b[jj] = B_KC ? sB[n * TB::LD + k] : sB[k * TB::LD + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc.v[i][jj] = fmaf(a[i], b[jj], acc.v[i][jj]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void acc_zero(Acc<T>& acc) {
  float* p = reinterpret_cast<float*>(&acc);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(Acc<T>) / sizeof(float)); ++i)
    p[i] = 0.f;
}

// Store the tile at (m0, n0) of c (row stride ldc): rows in [m0, m_hi),
// columns below n_hi.  PAIR: bf16 pairs as one 4-byte store (n_hi even,
// c 4-byte aligned).
template <typename T, bool PAIR>
__device__ __forceinline__ void store_tile(const Acc<T>& acc, T* c,
                                           long long ldc, int m0, int m_hi,
                                           int n0, int n_hi) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = m0 + (warp >> 1) * 32, wn = n0 + (warp & 1) * 64;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mi * 16 + (lane >> 2) + 8 * h;
        if (r >= m_hi) continue;
        T* row = c + static_cast<long long>(r) * ldc;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = wn + ni * 8 + 2 * (lane & 3);
          const float v0 = acc.v[mi][ni][2 * h], v1 = acc.v[mi][ni][2 * h + 1];
          if (PAIR && col + 1 < n_hi) {
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < n_hi) row[col] = __float2bfloat16(v0);
            if (col + 1 < n_hi) row[col + 1] = __float2bfloat16(v1);
          }
        }
      }
  } else {
    const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + tm + 8 * i;
      if (r >= m_hi) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = n0 + tn + 16 * jj;
        if (col < n_hi) c[static_cast<long long>(r) * ldc + col] = acc.v[i][jj];
      }
    }
  }
}

// One warp scans the group sizes: s_off[g] is group g's first row (cut at
// `rows`), s_off[G] the end of the last; s_tile[g] the first of group g's
// row tiles of kBM rows, s_tile[G] the tiles of all groups.
__device__ __forceinline__ void scan_groups(const int* __restrict__ gs, int G,
                                            int rows, int* s_off,
                                            int* s_tile) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
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
    tiles += (b - a + kBM - 1) / kBM;
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

struct Params {
  const void* a;          // fwd, dw: x (M, K); dx: dy (M, N)
  const void* b;          // fwd, dx: w (G, K, N); dw: dy (M, N)
  void* c;                // fwd: y (M, N); dx: dx (M, K); dw: dw (G, K, N)
  const int* gs;          // (G,) int32
  int G, M, K, N;
};

template <typename T>
constexpr int smem_bytes(bool a_kc, bool b_kc) {
  return Traits<T>::STAGES *
         ((a_kc ? Tile<T, true, kBM>::SIZE : Tile<T, false, kBM>::SIZE) +
          (b_kc ? Tile<T, true, kBN>::SIZE : Tile<T, false, kBN>::SIZE)) *
         static_cast<int>(sizeof(T));
}

// The row-ragged products (fwd, dx).  A (dy for dx, x for fwd) is staged
// k-contiguous; B is w[g] as (K, N) (fwd: n-contiguous) or w[g]^T (dx:
// k-contiguous, read from w as it lies).
template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
    ragged_m_kernel(const Params p) {
  constexpr bool B_KC = MODE == kDx;
  constexpr int BK = Traits<T>::BK, STAGES = Traits<T>::STAGES;
  using TA = Tile<T, true, kBM>;
  using TB = Tile<T, B_KC, kBN>;
  __shared__ int s_off[kMaxGroups + 1];
  __shared__ int s_tile[kMaxGroups + 1];
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + STAGES * TA::SIZE;

  // fwd: (M, K) x (K, N); dx: (M, N) x (N, K)
  const int kred = MODE == kFwd ? p.K : p.N;
  const int ncols = MODE == kFwd ? p.N : p.K;
  const T* A = static_cast<const T*>(p.a);
  T* C = static_cast<T*>(p.c);

  scan_groups(p.gs, p.G, p.M, s_off, s_tile);
  __syncthreads();
  const int slot = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int total = s_tile[p.G];
  if (slot >= total) {
    // the spare slots zero the rows past the groups' sum
    const int r0 = s_off[p.G] + (slot - total) * kBM;
    if (r0 >= p.M) return;
    const int r1 = min(r0 + kBM, p.M);
    for (int i = threadIdx.x; i < (r1 - r0) * kBN; i += kThreads) {
      const int r = r0 + i / kBN, col = n0 + i % kBN;
      if (col < ncols) C[static_cast<long long>(r) * ncols + col] = zero<T>();
    }
    return;
  }
  // this slot's group: the last g with s_tile[g] <= slot (non-empty)
  int lo = 0, hi = p.G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_tile[mid] <= slot) lo = mid;
    else hi = mid - 1;
  }
  const int g = lo;
  const int row_lo = s_off[g], row_hi = s_off[g + 1];
  const int r0 = row_lo + (slot - s_tile[g]) * kBM;
  const T* B = static_cast<const T*>(p.b) +
               static_cast<long long>(g) * p.K * p.N;
  // w[g] (K, N): fwd reads (k, n) at k * N + n; dx reads (k=n', n=k') at
  // k' * N + n', k-contiguous with ld N
  const long long lda = kred, ldb = p.N;

  Acc<T> acc;
  acc_zero(acc);
  const int KT = (kred + BK - 1) / BK;
  auto load = [&](int stage, int kt) {
    load_tile<T, true, kBM, VEC>(sA + stage * TA::SIZE, A, lda, r0, row_lo,
                                 row_hi, kt * BK, 0, kred);
    load_tile<T, B_KC, kBN, VEC>(sB + stage * TB::SIZE, B, ldb, n0, 0, ncols,
                                 kt * BK, 0, kred);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();
    const int st = kt % STAGES;
    compute_stage<T, true, B_KC>(sA + st * TA::SIZE, sB + st * TB::SIZE, acc);
  }
  store_tile<T, VEC>(acc, C, ncols, r0, min(r0 + kBM, row_hi), n0, ncols);
}

// The K-ragged product (dw): dw[g] (K, N) = x[rows]^T (K, rows) x dy[rows]
// (rows, N); the reduction runs over the group's rows, none for an empty
// group, whose tile is then written as zeros.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) ragged_k_kernel(const Params p) {
  constexpr int BK = Traits<T>::BK, STAGES = Traits<T>::STAGES;
  using TA = Tile<T, false, kBM>;
  using TB = Tile<T, false, kBN>;
  __shared__ int s_off[kMaxGroups + 1];
  __shared__ int s_tile[kMaxGroups + 1];
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + STAGES * TA::SIZE;

  scan_groups(p.gs, p.G, p.M, s_off, s_tile);
  __syncthreads();
  const int ntn = (p.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / ntn) * kBM;   // over K
  const int n0 = (blockIdx.x % ntn) * kBN;   // over N
  const int g = blockIdx.y;
  const int row_lo = s_off[g], row_hi = s_off[g + 1];
  const T* X = static_cast<const T*>(p.a);
  const T* DY = static_cast<const T*>(p.b);
  T* C = static_cast<T*>(p.c) + static_cast<long long>(g) * p.K * p.N;

  Acc<T> acc;
  acc_zero(acc);
  const int KT = (row_hi - row_lo + BK - 1) / BK;
  auto load = [&](int stage, int kt) {
    const int k0 = row_lo + kt * BK;
    // x^T: (m=k', k=row) at row * K + k'; dy: (k=row, n) at row * N + n
    load_tile<T, false, kBM, VEC>(sA + stage * TA::SIZE, X, p.K, m0, 0, p.K,
                                  k0, row_lo, row_hi);
    load_tile<T, false, kBN, VEC>(sB + stage * TB::SIZE, DY, p.N, n0, 0, p.N,
                                  k0, row_lo, row_hi);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();
    const int st = kt % STAGES;
    compute_stage<T, false, false>(sA + st * TA::SIZE, sB + st * TB::SIZE,
                                   acc);
  }
  store_tile<T, VEC>(acc, C, p.N, m0, min(m0 + kBM, p.K), n0, p.N);
}

// Set a kernel's dynamic shared memory limit once a device, then launch.
template <typename Kernel>
int launch(Kernel kernel, int smem, dim3 grid, const Params& p,
           cudaStream_t stream, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !((*done >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    *done |= 1ull << dev;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool VEC>
int dispatch(int mode, const Params& p, cudaStream_t stream) {
  static unsigned long long done[3] = {0, 0, 0};
  if (mode == kFwd || mode == kDx) {
    const int ncols = mode == kFwd ? p.N : p.K;
    const dim3 grid((p.M + kBM - 1) / kBM + p.G, (ncols + kBN - 1) / kBN);
    if (mode == kFwd)
      return launch(ragged_m_kernel<T, kFwd, VEC>, smem_bytes<T>(true, false),
                    grid, p, stream, &done[0]);
    return launch(ragged_m_kernel<T, kDx, VEC>, smem_bytes<T>(true, true),
                  grid, p, stream, &done[1]);
  }
  const dim3 grid(((p.K + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN), p.G);
  return launch(ragged_k_kernel<T, VEC>, smem_bytes<T>(false, false), grid, p,
                stream, &done[2]);
}

}  // namespace

extern "C" {

// Launches one grouped product on `stream`: mode 0 (fwd: a = x (M, K),
// b = w (G, K, N), c = y (M, N)), 1 (dx: a = dy (M, N), b = w, c = dx
// (M, K)) or 2 (dw: a = x (M, K), b = dy (M, N), c = dw (G, K, N)); dtype
// 0 bf16, 1 fp32; group_sizes (G,) int32 on the device; vec = 1 when every
// pointer is 16-byte aligned and K and N rows are whole 16-byte units.
// Returns 0, a CUDA error code after the launch, or kErrArgs.
int grouped_gemm_launch(int mode, int dtype, const void* a, const void* b,
                        void* c, const void* group_sizes, int G, int M, int K,
                        int N, int vec, void* stream) {
  if (mode < 0 || mode > 2 || dtype < 0 || dtype > 1 || G < 0 ||
      G > kMaxGroups || M < 0 || K < 1 || N < 1 || (G == 0 && mode == kDw) ||
      (M == 0 && mode != kDw) ||
      static_cast<long long>((M + kBM - 1) / kBM) + G > 0x7fffffffLL ||
      (mode == kDw ? G : ((mode == kFwd ? N : K) + kBN - 1) / kBN) > 65535)
    return kErrArgs;
  Params p;
  p.a = a;
  p.b = b;
  p.c = c;
  p.gs = static_cast<const int*>(group_sizes);
  p.G = G;
  p.M = M;
  p.K = K;
  p.N = N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? dispatch<bf16, true>(mode, p, st)
               : dispatch<bf16, false>(mode, p, st);
  return vec ? dispatch<float, true>(mode, p, st)
             : dispatch<float, false>(mode, p, st);
}

const char* grouped_gemm_error_string(int code) {
  if (code == kErrArgs) return "arguments outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
