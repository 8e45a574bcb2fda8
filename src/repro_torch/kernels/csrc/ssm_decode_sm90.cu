// Mamba-2's decode mixer, one token, for NVIDIA Hopper (sm_90a): the conv
// window, dt, the SSD state update and readout and the gated norm in one
// launch, between `in_proj` and `out_proj`.
//
// Replaces no Pallas kernel: the reference computes the mixer in XLA, the
// body of `ssm_decode` (src/repro/models/ssm.py:169-190).  Per batch row b
// and head, with the `in_proj` row zx = [z, x, B, C, dt] read where it lies
// and the last K - 1 = 3 conv inputs `win` (K = 4):
//   conv[c] = round(sum_k win_k[c] w[k, c])   (an fp32 sum, rounded once;
//                                               win_3 = this token's x, B, C)
//   xbc[c]  = round(silu(round(conv[c] + conv_b[c])))
//   dt      = softplus(dt_raw + dt_bias),  dA = exp(dt * -exp(A_log))
//   h'      = h dA + (dt B) (x) x           (fp32; stored in h's dtype)
//   y       = round(C h' + D x)             (the skip before the rounding)
//   g       = round(y round(silu(z)))
//   out     = round(g rsqrt(mean_row(g^2) + eps) norm_w)
// in the compute dtype (bf16 or fp32) where the reference rounds, fp32
// elsewhere; the new window (rows 1..3 of [win, x B C]) into a new tensor,
// the state over the old one.  kernels/ssm_decode.py holds the plain
// versions (`ssm_decode_mixer_ref`, and `ssm_decode_mixer_splits_ref` for
// this file's algorithm) and the planner that sends a call here (`route`).
//
// Bound on this card: the state's bytes.  At mamba2-780m's widths and
// batch 4 a token reads and writes 4 x 48 x 128 x 64 bf16 of state (6.3
// MB), beside 0.2 MB of window, `in_proj` row and output: 0.002 ms at
// 3.35 TB/s, under the launch floor of a graph replay.  The chain this
// kernel replaces ran some 15 launches a layer a token.  What the design
// does:
// * One block a (b, head): all of d_state and of head_dim, so y's sum over
//   N stays in the block and the head's slice of the state (N x hp,
//   contiguous) is one bulk async copy (`cp.async.bulk`) each way.  Cutting
//   a head's columns over two blocks where B x heads leaves SMs idle (B 2)
//   measured slower on an H100 (a copy a row of 64 bytes).
// * The slice's load is issued first and completes on an `mbarrier`; under
//   it the block computes the head's x columns' conv, its group's B and C
//   (2N conv columns, recomputed by every block of the group from L2; the
//   group's first block writes their new window), silu(z) and dt, every
//   thread's loads for them issued before any of that arithmetic.  Each
//   thread then updates 16-byte vectors of the slice in shared memory and
//   keeps y's partial sums (the warps' meet in shared memory in a fixed
//   order); the last warp stores the new slice by one bulk copy, which
//   nothing waits on until the block ends.
// * The row norm crosses blocks.  Each block writes its g (exact in the
//   compute dtype) into the output row and its fp32 sum of g^2 into a slot
//   of its own, fences once, and draws a ticket of its batch row.  The
//   block that draws the last one loads the row's g and norm_w while it
//   sums the row's slots in a fixed order (32 lanes over strided slots,
//   then a butterfly), rescales the row in place and puts the counter back
//   to 0.  No floating atomics: replays give the same bits.  The counters
//   (one a batch row) are allocated once a device by the wrapper and never
//   replaced, so a captured graph keeps them.
// * Tried and not kept (H100): a persistent grid whose blocks walk heads
//   with two slice buffers, the next head's load under this one's work
//   (it spilled at 64 registers and ran slower at every batch); an
//   acquire-release ticket in place of the last block's fence (no gain).
//
// Launches: one a call.  Contract (checked by the Python wrapper and again
// here): d_conv 4, N and hp at most 128, hp a power of two of 16-byte rows,
// h and norm_w on 16-byte boundaries, h contiguous, zx's, the window's and
// conv_w's last dims contiguous; zx, window, h, conv_w, conv_b in the
// compute dtype; dt_bias, A_log, D, norm_w bf16 or fp32 (`flags`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 4;
constexpr int kMaxN = 128;
constexpr int kMaxHp = 128;
constexpr int kLanes = 32;       // lanes of the fixed-order sum of a row
constexpr int kStateOff = 128;   // the state slice after the barrier
constexpr int kPlantShift = 1;   // planted fault: the window left unshifted
constexpr int kPlantPartial = 2; // planted fault: slot 0 left out of the norm
// the block's fp32 arrays after the state slice: x, silu(z) (hp each), B,
// C (N each), the warps' y partials (kWarps x hp), 16 scalars
__host__ __device__ constexpr int smem_of(int n, int hp, int elt) {
  return kStateOff + n * hp * elt + 4 * (2 * hp + 2 * n + kWarps * hp + 16);
}
constexpr int kSmemMax = smem_of(kMaxN, kMaxHp, 4);

enum Error { kErrArgs = -1 };

struct Params {
  const void* zx;        // (B, 1, 2 d_in + 2 g N + nh), batch stride zx_sb
  const void* win;       // (B, K - 1, conv_dim), strides win_sb, win_sk
  const void* conv_w;    // (K, conv_dim), row stride cw_sk
  const void* conv_b;    // (conv_dim,)
  const void* dt_bias;   // (nh,) bf16 or fp32 (flags bit 0)
  const void* a_log;     // (nh,) (bit 1)
  const void* D;         // (nh,) (bit 2)
  const void* norm_w;    // (d_in,) (bit 3)
  void* h;               // (B, nh, N, hp) contiguous, updated in place
  void* out;             // (B, 1, d_in) contiguous
  void* new_win;         // (B, K - 1, conv_dim) contiguous
  float* part;           // (B, nh): each block's sum of g^2
  int* counters;         // (B,): tickets, 0 between launches
  long long zx_sb, win_sb, win_sk;
  int B, nh, N, hp, groups, d_in, conv_dim, cw_sk, flags;
  int plant;
  float eps;
};

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

// one bulk copy of `bytes` (a multiple of 16) from this block's shared
// memory to global memory, in this thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's shared-memory writes before the async proxy's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// v rounded to T, back in fp32
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// a 1-D parameter's value i, bf16 or fp32
__device__ __forceinline__ float param(const void* ptr, int i, int f32) {
  return f32 ? static_cast<const float*>(ptr)[i]
             : __bfloat162float(static_cast<const bf16*>(ptr)[i]);
}

// PyTorch's silu: x / (1 + exp(-x)) in fp32
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
}

// a 16-byte vector's values in fp32, and back (rounded to T)
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<uint32_t>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]))) |
             (static_cast<uint32_t>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])))
              << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// one block's job in the front: the conv of a channel (its 4 taps, weights
// and bias) or silu(z) of a column; loaded first, for both of a thread's
// jobs (2 hp + 2 N <= 2 kThreads of them), then finished
template <typename T>
struct Job {
  int kind;  // 0 none, 1 conv, 2 z
  int c;     // the conv channel (1), the column (2)
  float* dst;
  T tap[kTaps];
  T w[kTaps];
  T b;
};

template <typename T>
__device__ __forceinline__ void job_load(Job<T>& j, int q, const Params& p,
                                         const T* zx, const T* win, int grp,
                                         int col0, float* xs, float* zs,
                                         float* bs, float* cs) {
  const int gn = p.groups * p.N;
  const int n_conv = p.hp + 2 * p.N;
  j.kind = 0;
  if (q < n_conv) {
    j.kind = 1;
    if (q < p.hp) {
      j.c = col0 + q;
      j.dst = xs + q;
    } else if (q < p.hp + p.N) {
      j.c = p.d_in + grp * p.N + (q - p.hp);
      j.dst = bs + (q - p.hp);
    } else {
      j.c = p.d_in + gn + grp * p.N + (q - p.hp - p.N);
      j.dst = cs + (q - p.hp - p.N);
    }
    const T* cw = static_cast<const T*>(p.conv_w);
#pragma unroll
    for (int k = 0; k < kTaps - 1; ++k) j.tap[k] = win[k * p.win_sk + j.c];
    j.tap[kTaps - 1] = zx[p.d_in + j.c];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) j.w[k] = cw[k * p.cw_sk + j.c];
    j.b = static_cast<const T*>(p.conv_b)[j.c];
  } else if (q < n_conv + p.hp) {
    j.kind = 2;
    j.c = col0 + q - n_conv;
    j.dst = zs + q - n_conv;
    j.tap[0] = zx[j.c];
  }
}

template <typename T>
__device__ __forceinline__ void job_finish(const Job<T>& j, const Params& p,
                                           T* nwin, bool bc_writer) {
  if (j.kind == 1) {
    // the taps' fp32 products added in order, rounded once (products of
    // bf16 values are exact in fp32)
    float acc = __fmul_rn(to_f(j.tap[0]), to_f(j.w[0]));
#pragma unroll
    for (int k = 1; k < kTaps; ++k)
      acc = __fadd_rn(acc, __fmul_rn(to_f(j.tap[k]), to_f(j.w[k])));
    const float v = rnd<T>(__fadd_rn(rnd<T>(acc), to_f(j.b)));
    *j.dst = rnd<T>(silu(v));
    if (j.c < p.d_in || bc_writer) {
      if (p.plant & kPlantShift) {
#pragma unroll
        for (int k = 0; k < kTaps - 1; ++k)
          nwin[k * p.conv_dim + j.c] = j.tap[k];
      } else {
#pragma unroll
        for (int k = 0; k < kTaps - 1; ++k)
          nwin[k * p.conv_dim + j.c] = j.tap[k + 1];
      }
    }
  } else if (j.kind == 2) {
    *j.dst = rnd<T>(silu(to_f(j.tap[0])));
  }
}

// norm_w's values at the kEV columns of vector idx of a row, in fp32
template <typename T>
__device__ __forceinline__ void load_w(const Params& p, int idx, float* w) {
  constexpr int kEV = Vec<T>::kN;
  const int col = idx * kEV;
  if (p.flags & 8) {
    const float4* src =
        reinterpret_cast<const float4*>(static_cast<const float*>(p.norm_w) +
                                        col);
#pragma unroll
    for (int i = 0; i < kEV / 4; ++i) {
      const float4 a = __ldg(src + i);
      w[4 * i] = a.x;
      w[4 * i + 1] = a.y;
      w[4 * i + 2] = a.z;
      w[4 * i + 3] = a.w;
    }
  } else {
    const bf16* src = static_cast<const bf16*>(p.norm_w) + col;
    if constexpr (kEV == 8) {
      Vec<bf16>::unpack(__ldg(reinterpret_cast<const uint4*>(src)), w);
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
      w[0] = __uint_as_float(u.x << 16);
      w[1] = __uint_as_float(u.x & 0xFFFF0000u);
      w[2] = __uint_as_float(u.y << 16);
      w[3] = __uint_as_float(u.y & 0xFFFF0000u);
    }
  }
}

// five blocks an SM (48 registers): at B 128 faster than four (64
// registers) on an H100, the same at B 4 (scripts/ssm_decode_probe.py,
// variant lb4)
template <typename T>
__global__ void __launch_bounds__(kThreads, 5) mixer_kernel(const Params p) {
  constexpr int kEV = Vec<T>::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* last = reinterpret_cast<int*>(smem + 8);
  float* scal = reinterpret_cast<float*>(smem + 16);  // dt, dA, D, r
  T* hs = reinterpret_cast<T*>(smem + kStateOff);
  float* xs = reinterpret_cast<float*>(smem + kStateOff +
                                       p.N * p.hp * sizeof(T));
  float* zs = xs + p.hp;
  float* bs = zs + p.hp;
  float* cs = bs + p.N;
  float* yp = cs + p.N;            // [kWarps][hp]
  float* red = yp + kWarps * p.hp;  // [kWarps]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;  // b * nh + head
  const int head = bh % p.nh;
  const int b = bh / p.nh;
  const int hpg = p.nh / p.groups;
  const int grp = head / hpg;
  const int col0 = head * p.hp;  // the head's first column
  T* hg = static_cast<T*>(p.h) + static_cast<long long>(bh) * p.N * p.hp;
  const uint32_t slice_bytes = p.N * p.hp * sizeof(T);

  // the front's loads first: the conv of the head's x columns and its
  // group's B and C ([0, hp) x, [hp, hp + N) B, [hp + N, hp + 2N) C) and
  // hp of z, two jobs a thread at most; dt's on the last thread
  const T* zx = static_cast<const T*>(p.zx) + b * p.zx_sb;
  const T* win = static_cast<const T*>(p.win) + b * p.win_sb;
  T* nwin = static_cast<T*>(p.new_win) +
            static_cast<long long>(b) * (kTaps - 1) * p.conv_dim;
  Job<T> j0, j1;
  job_load(j0, tid, p, zx, win, grp, col0, xs, zs, bs, cs);
  job_load(j1, tid + kThreads, p, zx, win, grp, col0, xs, zs, bs, cs);
  float dt_raw = 0.f, dt_bias = 0.f, a_log = 0.f, d_skip = 0.f;
  if (tid == kThreads - 1) {
    dt_raw = to_f(zx[2 * p.d_in + 2 * p.groups * p.N + head]);
    dt_bias = param(p.dt_bias, head, p.flags & 1);
    a_log = param(p.a_log, head, p.flags & 2);
    d_skip = param(p.D, head, p.flags & 4);
  }

  // the state slice, one bulk copy: it lands under the front's work
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbarrier_init();
    mbar_expect_tx(bar, slice_bytes);
    bulk_load(hs, hg, slice_bytes, bar);
  }
  const bool bc_writer = head % hpg == 0;
  job_finish(j0, p, nwin, bc_writer);
  job_finish(j1, p, nwin, bc_writer);
  if (tid == kThreads - 1) {
    const float v = __fadd_rn(dt_raw, dt_bias);
    // softplus as logaddexp(v, 0)
    const float dt = __fadd_rn(fmaxf(v, 0.f), log1pf(expf(-fabsf(v))));
    scal[0] = dt;
    scal[1] = expf(__fmul_rn(dt, -expf(a_log)));
    scal[2] = d_skip;
  }
  __syncthreads();
  mbar_wait(bar, 0);

  // the state: thread (row group rg, vector v) updates rows rg, rg + n_rg,
  // ... at columns v kEV .. v kEV + kEV - 1, in place in shared memory
  const int vpr = p.hp / kEV;  // a power of two, at most 32
  const int v = tid % vpr;
  const int n_rg = kThreads / vpr;
  const float dt = scal[0], dA = scal[1];
  float xv[kEV], acc[kEV];
#pragma unroll
  for (int e = 0; e < kEV; ++e) {
    xv[e] = xs[v * kEV + e];
    acc[e] = 0.f;
  }
  for (int r = tid / vpr; r < p.N; r += n_rg) {
    const float coef = __fmul_rn(dt, bs[r]);
    const float cr = cs[r];
    uint4* slot = reinterpret_cast<uint4*>(hs + r * p.hp + v * kEV);
    float hv[kEV];
    Vec<T>::unpack(*slot, hv);
#pragma unroll
    for (int e = 0; e < kEV; ++e) {
      hv[e] = __fadd_rn(__fmul_rn(hv[e], dA), __fmul_rn(coef, xv[e]));
      acc[e] = fmaf(cr, hv[e], acc[e]);
    }
    *slot = Vec<T>::pack(hv);
  }
  fence_proxy_async();  // the new state, for the bulk store below
  // y's partials: the lanes of a warp that share a vector, then the warps
  for (int off = vpr; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kEV; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (lane < vpr) {
#pragma unroll
    for (int e = 0; e < kEV; ++e) yp[warp * p.hp + v * kEV + e] = acc[e];
  }
  __syncthreads();

  // the new state to global memory by one bulk copy from the last warp,
  // which stores nothing else: it never holds up the ticket
  if (warp == kWarps - 1 && lane == 0) {
    bulk_store(hg, hs, slice_bytes);
    bulk_commit();
  }

  // y, the skip, the gate: thread t < hp takes column col0 + t
  T* orow = static_cast<T*>(p.out) + static_cast<long long>(b) * p.d_in;
  float g = 0.f, sq = 0.f;
  if (tid < p.hp) {
    float y = 0.f;
    for (int w = 0; w < kWarps; ++w) y += yp[w * p.hp + tid];
    y = __fadd_rn(y, __fmul_rn(scal[2], xs[tid]));
    g = rnd<T>(__fmul_rn(rnd<T>(y), zs[tid]));
    sq = __fmul_rn(g, g);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  // g and the block's sum of g^2 stored, then fenced once, before the
  // block's ticket
  if (tid < p.hp) orow[col0 + tid] = from_f<T>(g);
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    p.part[static_cast<long long>(b) * p.nh + head] = s;
  }
  if (tid < p.hp) __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(p.counters + b, 1);
    *last = ticket == p.nh - 1;
    if (*last) p.counters[b] = 0;  // every block of this row has drawn
  }
  __syncthreads();
  if (warp == kWarps - 1 && lane == 0) bulk_wait_read();  // hs stays
  if (!*last) return;
  __threadfence();

  // the last block of the row: the row's g and norm_w loaded (kPre vectors
  // a thread at once: more spilled) under the fixed-order sum of the row's
  // slots, then rescaled in place
  constexpr int kPre = 2;
  const int nvec = p.d_in / kEV;
  uint4 gv[kPre];
  float wv[kPre][kEV];
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int idx = base + i * kThreads;
      if (idx < nvec) {
        gv[i] = __ldcg(reinterpret_cast<const uint4*>(orow) + idx);
        load_w<T>(p, idx, wv[i]);
      }
    }
  };
  auto rescale = [&](int base, float r) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int idx = base + i * kThreads;
      if (idx < nvec) {
        float gf[kEV];
        Vec<T>::unpack(gv[i], gf);
#pragma unroll
        for (int e = 0; e < kEV; ++e)
          gf[e] = __fmul_rn(__fmul_rn(gf[e], r), wv[i][e]);
        reinterpret_cast<uint4*>(orow)[idx] = Vec<T>::pack(gf);
      }
    }
  };
  load(tid);
  if (warp == 0) {
    const float* slots = p.part + static_cast<long long>(b) * p.nh;
    float s = 0.f;
    for (int i = lane; i < p.nh; i += kLanes)
      if (!((p.plant & kPlantPartial) && i == 0)) s += __ldcg(slots + i);
#pragma unroll
    for (int off = kLanes / 2; off; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0)
      scal[3] = rsqrtf(__fadd_rn(__fdiv_rn(s, static_cast<float>(p.d_in)),
                                 p.eps));
  }
  __syncthreads();
  const float r = scal[3];
  rescale(tid, r);
  for (int base = tid + kPre * kThreads; base < nvec;
       base += kPre * kThreads) {
    load(base);
    rescale(base, r);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  // the shared-memory opt-in, once a device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return kErrArgs;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(mixer_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  const int smem = smem_of(p.N, p.hp, sizeof(T));
  mixer_kernel<T><<<p.B * p.nh, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One token of the mixer on `stream`: zx (B, 1, 2 d_in + 2 g N + nh) with
// batch stride zx_sb, the window (B, 3, conv_dim) with batch and row
// strides, conv_w (4, conv_dim) with row stride cw_sk, conv_b (conv_dim,),
// all in the compute dtype (`f32`: fp32, else bf16); dt_bias, A_log, D and
// norm_w bf16 or fp32 (`flags` bits 0..3 set for fp32; norm_w on a 16-byte
// boundary); h (B, nh, N, hp) contiguous in the compute dtype, updated in
// place; out (B, 1, d_in) and new_win (B, 3, conv_dim) contiguous; part (B
// * nh) fp32 scratch; counters (B) int32, 0 (and left at 0).  `plant`
// plants a fault (1 the window unshifted, 2 the first slot left out of
// each row's norm).  One launch.  Returns 0, a CUDA error code, or a
// negative code of its own.
int ssm_decode_sm90(const void* zx, long long zx_sb, const void* win,
                    long long win_sb, long long win_sk, const void* conv_w,
                    const void* conv_b, const void* dt_bias, const void* a_log,
                    const void* D, const void* norm_w, void* h, void* out,
                    void* new_win, void* part, void* counters, int B, int nh,
                    int N, int hp, int groups, int cw_sk, int f32, int flags,
                    float eps, int plant, void* stream) {
  const int elt = f32 ? 4 : 2;
  if (!zx || !win || !conv_w || !conv_b || !dt_bias || !a_log || !D ||
      !norm_w || !h || !out || !new_win || !part || !counters)
    return kErrArgs;
  if (B < 1 || nh < 1 || groups < 1 || nh % groups || N < 1 || N > kMaxN ||
      hp < 1 || hp > kMaxHp || (hp & (hp - 1)) || (hp * elt) % 16 ||
      !aligned16(h) || !aligned16(out) || !aligned16(norm_w))
    return kErrArgs;
  Params p = {};
  p.zx = zx;
  p.win = win;
  p.conv_w = conv_w;
  p.conv_b = conv_b;
  p.dt_bias = dt_bias;
  p.a_log = a_log;
  p.D = D;
  p.norm_w = norm_w;
  p.h = h;
  p.out = out;
  p.new_win = new_win;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.zx_sb = zx_sb;
  p.win_sb = win_sb;
  p.win_sk = win_sk;
  p.B = B;
  p.nh = nh;
  p.N = N;
  p.hp = hp;
  p.groups = groups;
  p.d_in = nh * hp;
  p.conv_dim = p.d_in + 2 * groups * N;
  p.cw_sk = cw_sk;
  p.flags = flags;
  p.plant = plant;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(p, s) : launch<bf16>(p, s);
}

const char* ssm_decode_sm90_error_string(int err) {
  if (err == kErrArgs)
    return "ssm decode mixer (sm90): bad arguments (shape or alignment)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
