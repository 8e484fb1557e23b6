// Flash attention forward and backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/transformer/flash_attention.py:
//   K1 _fwd_kernel (pallas_call in _flash_fwd):  O = softmax(scale * Q K^T) V, and the fp32
//      log-sum-exp of every row;
//   K2 _dq_kernel  (pallas_call in _flash_bwd):  dQ = scale * (P o (dO V^T - delta)) K;
//   K3 _dkv_kernel (pallas_call in _flash_bwd):  dV = P^T dO, dK = scale * (P o (dO V^T - delta))^T Q,
// with P = exp(scale * Q K^T - lse) recomputed from the forward's LSE and delta = rowsum(dO o O)
// computed by the caller. q, k, v, o, dO are [B, T, N, D] (heads last, as the model lays them
// out), indexed by strides: no transpose on either side. lse and delta are plain [B*N, T] fp32.
// Operands are read in their dtype (fp32, bf16 or fp16) and every product accumulates in fp32;
// the TPU kernels' casts are kept: P -> v's dtype before P V, dS -> k's dtype before dS K,
// P -> dO's dtype before P^T dO, dS -> q's dtype before dS^T Q. Masking uses the finite
// NEG_INF = -1e30; keys at or past T are masked (causal: also keys past the row), a masked
// probability is exactly 0, and rows at or past T are never written, so T need not be a
// multiple of the tile.
//
// What bounds it: at the training shapes (T = 1024, D = 64, bf16) each kernel does 2-4 causal
// T x T x D products per (b, n) over about 3 T D bytes per operand, far above the card's ~295
// flops/byte balance point, so the tensor-core rate bounds it (K1 ~13 us, K2 ~19.5 us, K3 ~26 us
// at B=8, N=12 against 989 TFLOP/s).
//
// K1 for bf16 and fp16 (flash_fwd_tc_kernel) runs on the tensor cores, FlashAttention-2's scheme
// with mma.sync.m16n8k16 (csrc/tensor_core.cuh):
//  * one block of 4 warps per (b*n, 64-row q tile), each warp 16 q rows; the warp's Q fragments
//    stay in registers for the whole walk over the 64-key K/V tiles;
//  * K and V come through a ring in shared memory (3 stages at D = 64, 2 at D = 128, so two
//    blocks fit an SM) filled by 16-byte cp.async copies (rows past T are zero-filled): the copies
//    of the next tiles overlap this tile's products, with one barrier per tile. Tiles are
//    swizzled (chunk c of row r at c ^ (r & 7)), so ldmatrix (and ldmatrix.trans for V) reads are
//    free of bank conflicts without padding;
//  * S = Q K^T accumulates in fp32 registers in the mma C layout; the online softmax runs there,
//    a row's max and sum reduced over the four lanes of a quad, in base 2 with the scale folded
//    into one FMA; P is rounded to v's dtype and repacked from the C layout straight into the A
//    fragments of P V (no shared memory);
//  * only the diagonal tile (causal) and the ragged last tile are masked in registers; tiles
//    above the diagonal are skipped by the loop bound, and the heaviest q tiles start first.
// What bounds it now: about 18% of the bytes bound at the training shape on an H100. Each warp
// re-reads every K/V fragment from shared memory for its 16 rows and waits at one barrier per
// 64-key tile; 128-row tiles (two mma tiles a warp, or 8 warps) would halve those reads but need
// more registers a block, which cuts the blocks an SM holds. mma.sync rather than wgmma: mma.sync keeps P in registers with the
// layouts above and needs no shared-memory descriptors or warpgroup pipeline; wgmma with a TMA
// producer warp is this kernel's next step.
//
// K3 for bf16 and fp16 (flash_dkv_tc_kernel) runs on the tensor cores too, FlashAttention-2's
// key-major backward with the same building blocks:
//  * one block of 4 warps per (b*n, 64-key tile), heaviest (first) key tiles first; each warp
//    owns 16 key rows and their fp32 dK and dV accumulators in registers (its K and V fragments
//    are read from the block's K/V tiles by ldmatrix at each step);
//  * the block walks the q tiles from the diagonal to the end; each 64-row Q and dO tile, with its
//    lse and delta slices, comes through a cp.async ring (3 stages at D = 64, 2 at D = 128) of
//    swizzled tiles, one barrier per q tile;
//  * per q tile (two 32-query halves at D = 128, where dK and dV already hold 128 registers a
//    lane): S^T = K Q^T (B from Q by ldmatrix); P^T = exp(scale S^T - lse) in fp32 registers,
//    masked only on the diagonal and ragged tiles; dV += P^T dO with P^T rounded to dO's dtype
//    and repacked from C to A fragments, B by ldmatrix.trans; dP^T = V dO^T; dS^T =
//    P^T o (dP^T - delta) scale from the fp32 P, rounded to q's dtype; dK += dS^T Q, B by
//    ldmatrix.trans. A warp skips the causal halves in which all of its keys follow every query;
//  * the block owns its dK and dV rows: no atomics, deterministic.
// Because the operands are in their own dtype (K1-K3 take bf16/fp16 products with fp32
// accumulation, as the TPU kernels do), no hi/lo split is needed.
//
// fp32 keeps the first versions (flash_fwd_kernel, flash_dkv_kernel), as does K2 for every dtype:
// fp32 FMAs on the CUDA cores out of padded fp32 shared memory. fp32 is the card's parity path
// (kernel vs plain to about 1e-6 with TF32 off), and tensor cores would need TF32. The entries
// flash_fwd and flash_dkv dispatch by dtype and report the variant they launched.
//
// What the design does about the TPU kernels' shape: the Pallas kernels carry m/l/acc (or dQ,
// dK/dV) in VMEM scratch across a sequential "arbitrary" grid axis of 512-row blocks. Hopper
// runs blocks unordered and a 512 x 64 tile does not fit a block's registers, so:
//  * K1 and K2 run one block per (b*n, 64-row q tile) and loop over the k tiles up to the
//    causal diagonal inside the block, the running state in registers and shared memory;
//  * K3 runs one block per (b*n, 64-row k tile) and loops over the q tiles from the diagonal to
//    the end; it owns its dK and dV rows, so there are no atomics and the result is
//    deterministic;
//  * causal tiles above the diagonal are skipped by the loop bounds, not by a per-tile test;
//  * 64-row tiles give 16 x 96 = 1,536 blocks at B=8, N=12, T=1024, and the heaviest tiles
//    (K1/K2: the last q tiles; K3: the first k tiles) are launched first;
//  * the FMA kernels' 256 threads hold a 4 x 4 register tile of every 64 x 64 score tile (rows
//    ty + 16 i, columns tx + 16 j), so a row's softmax reduction is a 16-lane shuffle, and the
//    same rows of the output accumulator, so the online-softmax rescale needs no shared memory;
//    their shared-memory rows are padded by one float against bank conflicts.
// Not done yet (later work): tensor cores for K2, wgmma / TMA for K1 and K3, a persistent causal
// schedule.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;      // rows of every q and k tile
constexpr int THREADS = 256;  // 16 x 16 threads; each holds 4 x 4 of a 64 x 64 tile
constexpr int SP = TILE + 1;  // padded row of a 64-wide score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// x rounded to T and widened back: the TPU kernels' ".astype(dtype)" before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float reduce16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float reduce16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ size_t tok(int b, int t, int n, int T, int N, int D) {
  return ((static_cast<size_t>(b) * T + t) * N + n) * D;
}

// rows t0 .. t0+63 of head (b, n) into dst[64][D+1] as fp32; rows at or past T read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int n,
                                          int t0, int Tn, int N) {
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int t = t0 + r;
    dst[r * (D + 1) + d] = t < Tn ? to_f32(src[tok(b, t, n, Tn, N, D) + d]) : 0.f;
  }
}

// rows t0 .. t0+63 of a [B*N, T] fp32 row statistic; past T reads as zero
__device__ __forceinline__ void load_rowstat(float* dst, const float* __restrict__ src, int bn,
                                             int t0, int Tn) {
  if (threadIdx.x < TILE) {
    const int t = t0 + threadIdx.x;
    dst[threadIdx.x] = t < Tn ? src[static_cast<size_t>(bn) * Tn + t] : 0.f;
  }
}

// ---------------------------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Tn, int N, int causal,
                 float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + TILE * DP;
  float* vs = ks + TILE * DP;
  float* ps = vs + TILE * DP;  // [64][SP] probabilities, rounded to T

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qt * TILE;
  const int n_kt = (Tn + TILE - 1) / TILE;
  const int k_end = causal ? min(qt + 1, n_kt) : n_kt;

  load_tile<T, D>(qs, q, b, n, q0, Tn, N);
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, D>(ks, k, b, n, k0, Tn, N);
    load_tile<T, D>(vs, v, b, n, k0, Tn, N);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        live[j] = col < Tn && (!causal || col <= row);
        s[i][j] = live[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], reduce16_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        ps[(ty + 16 * i) * SP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = corr * l[i] + reduce16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Tn) {
      const float safe_l = l[i] == 0.f ? 1.f : l[i];
      T* dst = o + tok(b, row, n, Tn, N, D);
#pragma unroll
      for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c] / safe_l);
      if (tx == 0) lse[static_cast<size_t>(bn) * Tn + row] = m[i] + logf(safe_l);
    }
  }
}

// ---------------------------------------------------------------------------------------------
// K1 on the tensor cores: bf16 and fp16
// ---------------------------------------------------------------------------------------------
constexpr int TC_ROWS = 64;      // q rows of a block, 16 a warp
constexpr int TC_KEYS = 64;      // keys of a K/V tile
constexpr int TC_THREADS = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;

// depth of the K/V ring: 3 stages at D = 64 (57 KB of shared memory), 2 at D = 128 (80 KB), so
// that two blocks fit an SM at either width
template <int D>
struct TcRing {
  static constexpr int STAGES = D == 64 ? 3 : 2;
};

// async copy of rows t0 .. t0+63 of head (b, n) of a [B, T, N, D] operand into a swizzled [64][D]
// tile; rows at or past T are zero-filled
template <typename T, int D>
__device__ __forceinline__ void tc_load_tile(T* dst, const T* __restrict__ src, int b, int n, int t0,
                                             int Tn, int N) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < TC_KEYS * CH / TC_THREADS; ++i) {
    const int e = threadIdx.x + i * TC_THREADS;
    const int r = e / CH, c = e % CH;
    const int t = t0 + r;
    const bool valid = t < Tn;
    tc::cp_async16(dst + tc::swz<D>(r, c * 8), src + tok(b, valid ? t : 0, n, Tn, N, D) + c * 8, valid);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse, int Tn, int N, int causal,
                    float scale) {
  constexpr int KS = D / 16;  // k16 steps of Q K^T
  constexpr int DT = D / 8;   // 8-wide output tiles
  constexpr int TC_STAGES = TcRing<D>::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [64][D]
  T* ks = qs + TC_ROWS * D;                // [STAGES][64][D]
  T* vs = ks + TC_STAGES * TC_KEYS * D;    // [STAGES][64][D]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * TC_ROWS;
  const int wq0 = q0 + warp * 16;  // this warp's rows: wq0 + g and wq0 + g + 8
  const int n_kt = (Tn + TC_KEYS - 1) / TC_KEYS;
  const int k_end = causal ? min(qt + 1, n_kt) : n_kt;
  // scores are compared unscaled (scale > 0 keeps their order) and exponentiated in base 2:
  // 2^(s * scale * log2(e) - m * scale * log2(e)) = exp(scale * s - scale * m)
  const float sl2 = scale * LOG2E;

  tc_load_tile<T, D>(qs, q, b, n, q0, Tn, N);
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < k_end) {
      tc_load_tile<T, D>(ks + i * TC_KEYS * D, k, b, n, i * TC_KEYS, Tn, N);
      tc_load_tile<T, D>(vs + i * TC_KEYS * D, v, b, n, i * TC_KEYS, Tn, N);
    }
    tc::cp_async_commit();
  }

  uint32_t qf[KS][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // unscaled running max; this thread's share of the row sum
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < k_end; ++kt) {
    tc::cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile kt has landed, and every warp is done with tile kt - 1's stage
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::ldmatrix_x4(qf[kk], qs + tc::swz<D>(warp * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));
    }
    const int kn = kt + TC_STAGES - 1;  // the tile this step prefetches
    if (kn < k_end) {
      tc_load_tile<T, D>(ks + (kn % TC_STAGES) * TC_KEYS * D, k, b, n, kn * TC_KEYS, Tn, N);
      tc_load_tile<T, D>(vs + (kn % TC_STAGES) * TC_KEYS * D, v, b, n, kn * TC_KEYS, Tn, N);
    }
    tc::cp_async_commit();
    const T* kst = ks + (kt % TC_STAGES) * TC_KEYS * D;
    const T* vst = vs + (kt % TC_STAGES) * TC_KEYS * D;
    const int k0 = kt * TC_KEYS;

    // S = Q K^T: 8 tiles of 16 x 8 scores
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        tc::ldmatrix_x4(bf, kst + tc::swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                             kk * 16 + ((lane >> 3) & 1) * 8));
        tc::mma<T>(s[2 * np], qf[kk], bf[0], bf[1]);
        tc::mma<T>(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // online softmax; only the diagonal and the ragged last tile are masked
    const bool masked = k0 + TC_KEYS > Tn || (causal && k0 + TC_KEYS - 1 > wq0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int row = wq0 + g + (e >> 1) * 8, col = k0 + j * 8 + 2 * t4 + (e & 1);
          if (!(col < Tn && (!causal || col <= row))) s[j][e] = NEG_INF;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], msl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = ex2((m[i] - mx[i]) * sl2);
      m[i] = mx[i];
      l[i] *= corr[i];
      msl[i] = mx[i] * sl2;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // NEG_INF is finite: on a row whose every score so far is masked, exp(s - m) would be 1,
        // so masked probabilities are zeroed explicitly
        float p = ex2(fmaf(s[j][e], sl2, -msl[e >> 1]));
        if (masked && s[j][e] == NEG_INF) p = 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V, P rounded to v's dtype
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      tc::a_from_c<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, vst + tc::swz<D>(kk * 16 + (lane & 15), dp * 16 + (lane >> 4) * 8));
        tc::mma<T>(acc[2 * dp], pa, bf[0], bf[1]);
        tc::mma<T>(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy may outlive the block (the last groups are empty)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = wq0 + g + i * 8;
    if (row < Tn) {
      const float safe_l = li == 0.f ? 1.f : li;
      T* dst = o + tok(b, row, n, Tn, N, D) + 2 * t4;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) = tc::pack2<T>(acc[j][2 * i] / safe_l, acc[j][2 * i + 1] / safe_l);
      if (t4 == 0) lse[static_cast<size_t>(bn) * Tn + row] = m[i] * scale + logf(safe_l);
    }
  }
}

// ---------------------------------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Tn, int N, int causal,
                float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TILE * DP;
  float* ks = dos + TILE * DP;
  float* vs = ks + TILE * DP;
  float* dss = vs + TILE * DP;  // [64][SP] dS, rounded to T
  float* lse_s = dss + TILE * SP;
  float* delta_s = lse_s + TILE;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qt * TILE;
  const int n_kt = (Tn + TILE - 1) / TILE;
  const int k_end = causal ? min(qt + 1, n_kt) : n_kt;

  load_tile<T, D>(qs, q, b, n, q0, Tn, N);
  load_tile<T, D>(dos, dout, b, n, q0, Tn, N);
  load_rowstat(lse_s, lse, bn, q0, Tn);
  load_rowstat(delta_s, delta, bn, q0, Tn);
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();
    load_tile<T, D>(ks, k, b, n, k0, Tn, N);
    load_tile<T, D>(vs, v, b, n, k0, Tn, N);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * DP + d];
        g[i] = dos[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = ks[(tx + 16 * j) * DP + d];
        bv[j] = vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < Tn && (!causal || col <= row);
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * SP + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = ks[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Tn) {
      T* dst = dq + tok(b, row, n, Tn, N, D);
#pragma unroll
      for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------------------------
// K3: dK, dV
// ---------------------------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Tn,
                 int N, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE * DP;
  float* qs = vs + TILE * DP;
  float* dos = qs + TILE * DP;
  float* pts = dos + TILE * DP;  // [64 keys][SP queries] P^T, rounded to T
  float* dsts = pts + TILE * SP;  // dS^T, rounded to T
  float* lse_s = dsts + TILE * SP;
  float* delta_s = lse_s + TILE;

  const int kt = blockIdx.x;  // heaviest causal tiles (the first keys) first
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = kt * TILE;
  const int n_qt = (Tn + TILE - 1) / TILE;

  load_tile<T, D>(ks, k, b, n, k0, Tn, N);
  load_tile<T, D>(vs, v, b, n, k0, Tn, N);
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile<T, D>(qs, q, b, n, q0, Tn, N);
    load_tile<T, D>(dos, dout, b, n, q0, Tn, N);
    load_rowstat(lse_s, lse, bn, q0, Tn);
    load_rowstat(delta_s, delta, bn, q0, Tn);
    __syncthreads();

    // transposed scores: key rows ty + 16 i, query columns tx + 16 j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], av[4], bq[4], bg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty + 16 * i) * DP + d];
        av[i] = vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bq[j] = qs[(tx + 16 * j) * DP + d];
        bg[j] = dos[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i], bq[j], st[i][j]);
          dpt[i][j] = fmaf(av[i], bg[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int key = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int row = q0 + c;
        const bool live = row < Tn && key < Tn && (!causal || key <= row);
        const float p = live ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
        pts[r * SP + c] = round_to<T>(p);
        dsts[r * SP + c] = round_to<T>(p * (dpt[i][j] - delta_s[c]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < TILE; ++qq) {
      float pv[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pts[(ty + 16 * i) * SP + qq];
        ds[i] = dsts[(ty + 16 * i) * SP + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float g = dos[qq * DP + tx + 16 * c];
        const float qv = qs[qq * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pv[i], g, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < Tn) {
      T* dkd = dk + tok(b, key, n, Tn, N, D);
      T* dvd = dv + tok(b, key, n, Tn, N, D);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dkd[tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
        dvd[tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------------------------
// K3 on the tensor cores: bf16 and fp16
// ---------------------------------------------------------------------------------------------
// depth of the Q/dO ring: 3 stages at D = 64 (66 KB of shared memory with the K and V tiles), 2 at
// D = 128 (97 KB); queries a warp takes per sub-step: the whole 64-row q tile at D = 64, half of it
// at D = 128, where the two [16 x D] fp32 accumulators already take 128 registers a lane
template <int D>
struct DkvTc {
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int QS = D == 64 ? 64 : 32;
};

// async copy of the lse and delta entries t0 .. t0+63 of head bn into dst[0..63] and dst[64..127];
// entries at or past T are zero-filled (their queries are masked)
__device__ __forceinline__ void tc_load_stats(float* dst, const float* __restrict__ lse,
                                              const float* __restrict__ delta, int bn, int t0, int Tn) {
  const int i = threadIdx.x & (TC_ROWS - 1);
  const float* src = threadIdx.x < TC_ROWS ? lse : delta;
  const int t = t0 + i;
  const bool valid = t < Tn;
  tc::cp_async4(dst + threadIdx.x, src + static_cast<size_t>(bn) * Tn + (valid ? t : 0), valid);
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Tn,
                    int N, int causal, float scale) {
  constexpr int KS = D / 16;  // k16 steps over D
  constexpr int DT = D / 8;   // 8-wide tiles of dK and dV
  constexpr int STAGES = DkvTc<D>::STAGES;
  constexpr int QS = DkvTc<D>::QS;
  constexpr int NQ = QS / 8;  // 8-wide query tiles of a sub-step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);   // [64][D]
  T* vs = ks + TC_KEYS * D;                 // [64][D]
  T* qs = vs + TC_KEYS * D;                 // [STAGES][64][D]
  T* dos = qs + STAGES * TC_ROWS * D;       // [STAGES][64][D]
  float* stats = reinterpret_cast<float*>(dos + STAGES * TC_ROWS * D);  // [STAGES][lse 64, delta 64]

  const int kt = blockIdx.x;  // heaviest causal tiles (the first keys) first
  const int bn = blockIdx.y, b = bn / N, n = bn % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = kt * TC_KEYS;
  const int wk0 = k0 + warp * 16;  // this warp's keys: wk0 + g and wk0 + g + 8
  const int n_qt = (Tn + TC_ROWS - 1) / TC_ROWS;
  const int qt0 = causal ? kt : 0;
  const int n_it = n_qt - qt0;
  const float sl2 = scale * LOG2E;

  auto load_stage = [&](int stage, int qt) {
    const int q0 = qt * TC_ROWS;
    tc_load_tile<T, D>(qs + stage * TC_ROWS * D, q, b, n, q0, Tn, N);
    tc_load_tile<T, D>(dos + stage * TC_ROWS * D, dout, b, n, q0, Tn, N);
    tc_load_stats(stats + stage * 2 * TC_ROWS, lse, delta, bn, q0, Tn);
  };
  tc_load_tile<T, D>(ks, k, b, n, k0, Tn, N);  // rides in the first group
  tc_load_tile<T, D>(vs, v, b, n, k0, Tn, N);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_it) load_stage(i, qt0 + i);
    tc::cp_async_commit();
  }

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // q tile it has landed, and every warp is done with tile it - 1's stage
    const int nx = it + STAGES - 1;  // the tile this step prefetches
    if (nx < n_it) load_stage(nx % STAGES, qt0 + nx);
    tc::cp_async_commit();
    const int stage = it % STAGES;
    const T* qst = qs + stage * TC_ROWS * D;
    const T* dost = dos + stage * TC_ROWS * D;
    const float* lse_s = stats + stage * 2 * TC_ROWS;
    const float* delta_s = lse_s + TC_ROWS;
    const int q0 = (qt0 + it) * TC_ROWS;

#pragma unroll
    for (int sub = 0; sub < TC_ROWS / QS; ++sub) {
      const int c0 = sub * QS;  // the sub-step's first row in the q tile
      if (causal && q0 + c0 + QS - 1 < wk0) continue;  // every (key, query) pair here is masked
      // S^T = K Q^T: this warp's 16 keys against the sub-step's queries, B from Q rows by ldmatrix
      float s[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[4];
        tc::ldmatrix_x4(kf, ks + tc::swz<D>(warp * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bf[4];
          tc::ldmatrix_x4(bf, qst + tc::swz<D>(c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                               kk * 16 + ((lane >> 3) & 1) * 8));
          tc::mma<T>(s[2 * np], kf, bf[0], bf[1]);
          tc::mma<T>(s[2 * np + 1], kf, bf[2], bf[3]);
        }
      }
      // P^T = exp(scale S^T - lse) in fp32; only the diagonal and ragged tiles are masked
      const bool masked = (causal && wk0 + 15 > q0 + c0) || q0 + c0 + QS > Tn || wk0 + 16 > Tn;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + 2 * t4 + (e & 1);
          float p = ex2(fmaf(s[j][e], sl2, -lse_s[col] * LOG2E));
          if (masked) {
            const int key = wk0 + g + (e >> 1) * 8, query = q0 + col;
            if (!(query < Tn && key < Tn && (!causal || key <= query))) p = 0.f;
          }
          s[j][e] = p;
        }
      // dV += P^T dO, P^T rounded to dO's dtype and repacked from C to A fragments; B from dO by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        uint32_t pa[4];
        tc::a_from_c<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bf[4];
          tc::ldmatrix_x4_trans(bf, dost + tc::swz<D>(c0 + kk * 16 + (lane & 15), dp * 16 + (lane >> 4) * 8));
          tc::mma<T>(dv_acc[2 * dp], pa, bf[0], bf[1]);
          tc::mma<T>(dv_acc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
      // dP^T = V dO^T
      float dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t vf[4];
        tc::ldmatrix_x4(vf, vs + tc::swz<D>(warp * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bf[4];
          tc::ldmatrix_x4(bf, dost + tc::swz<D>(c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                kk * 16 + ((lane >> 3) & 1) * 8));
          tc::mma<T>(dpt[2 * np], vf, bf[0], bf[1]);
          tc::mma<T>(dpt[2 * np + 1], vf, bf[2], bf[3]);
        }
      }
      // dS^T = P^T o (dP^T - delta) scale from the fp32 P (masked entries stay 0)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + j * 8 + 2 * t4 + (e & 1);
          s[j][e] = s[j][e] * (dpt[j][e] - delta_s[col]) * scale;
        }
      // dK += dS^T Q, dS^T rounded to q's dtype; B from Q by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        uint32_t da[4];
        tc::a_from_c<T>(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bf[4];
          tc::ldmatrix_x4_trans(bf, qst + tc::swz<D>(c0 + kk * 16 + (lane & 15), dp * 16 + (lane >> 4) * 8));
          tc::mma<T>(dk_acc[2 * dp], da, bf[0], bf[1]);
          tc::mma<T>(dk_acc[2 * dp + 1], da, bf[2], bf[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy may outlive the block (the last groups are empty)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wk0 + g + i * 8;
    if (key < Tn) {
      T* dkd = dk + tok(b, key, n, Tn, N, D) + 2 * t4;
      T* dvd = dv + tok(b, key, n, Tn, N, D) + 2 * t4;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        *reinterpret_cast<uint32_t*>(dkd + j * 8) = tc::pack2<T>(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dvd + j * 8) = tc::pack2<T>(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------------------------
template <int D>
constexpr size_t tile_bytes(int n_tiles, int n_score_tiles, int n_rowstats) {
  return sizeof(float) * (static_cast<size_t>(n_tiles) * TILE * (D + 1) +
                          static_cast<size_t>(n_score_tiles) * TILE * SP +
                          static_cast<size_t>(n_rowstats) * TILE);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  // above 48 KB a block's shared memory must be opted into per kernel
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *out_lse, *dq, *dk, *dv;
  int B, T, N, causal;
  float scale;
  cudaStream_t stream;
  int* variant;  // K1 and K3: the variant launched
};

// fp32 runs the FMA kernel (the parity path), bf16 and fp16 the tensor-core kernel; *variant
// says which: 0 FMA, 1 tensor cores
template <typename T, int D>
int launch_fwd(const Args& a) {
  const dim3 grid((a.T + TILE - 1) / TILE, a.B * a.N);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = tile_bytes<D>(3, 1, 0);
    auto kernel = flash_fwd_kernel<T, D>;
    err = prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(a.o), static_cast<float*>(a.out_lse), a.T, a.N, a.causal, a.scale);
    *a.variant = 0;
  } else {
    const size_t smem = sizeof(T) * (TC_ROWS + 2 * TcRing<D>::STAGES * TC_KEYS) * D;  // Q; the K/V ring
    auto kernel = flash_fwd_tc_kernel<T, D>;
    err = prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, TC_THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(a.o), static_cast<float*>(a.out_lse), a.T, a.N, a.causal, a.scale);
    *a.variant = 1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = tile_bytes<D>(4, 1, 2);
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + TILE - 1) / TILE, a.B * a.N);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.T, a.N, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// fp32 runs the FMA kernel, bf16 and fp16 the tensor-core kernel; *variant as for launch_fwd
template <typename T, int D>
int launch_dkv(const Args& a) {
  const dim3 grid((a.T + TILE - 1) / TILE, a.B * a.N);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = tile_bytes<D>(4, 2, 2);
    auto kernel = flash_dkv_kernel<T, D>;
    err = prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.T, a.N,
        a.causal, a.scale);
    *a.variant = 0;
  } else {
    // K and V; the Q/dO ring; the lse/delta ring
    const size_t smem = sizeof(T) * (2 * TC_KEYS + 2 * DkvTc<D>::STAGES * TC_ROWS) * D +
                        sizeof(float) * DkvTc<D>::STAGES * 2 * TC_ROWS;
    auto kernel = flash_dkv_tc_kernel<T, D>;
    err = prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, TC_THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.T, a.N,
        a.causal, a.scale);
    *a.variant = 1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <template <typename, int> class Launch>
int dispatch(int dtype, int D, const Args& a) {
  if (a.B <= 0 || a.T <= 0 || a.N <= 0 || a.B * a.N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype * 1000 + D) {
    case 64: return Launch<float, 64>::run(a);
    case 128: return Launch<float, 128>::run(a);
    case 1064: return Launch<__nv_bfloat16, 64>::run(a);
    case 1128: return Launch<__nv_bfloat16, 128>::run(a);
    case 2064: return Launch<__half, 64>::run(a);
    case 2128: return Launch<__half, 128>::run(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
struct Fwd {
  static int run(const Args& a) { return launch_fwd<T, D>(a); }
};
template <typename T, int D>
struct Dq {
  static int run(const Args& a) { return launch_dq<T, D>(a); }
};
template <typename T, int D>
struct Dkv {
  static int run(const Args& a) { return launch_dkv<T, D>(a); }
};

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; D in {64, 128}. Each returns cudaGetLastError() after its launch
// (or the error that stopped it) and does not synchronise. flash_fwd and flash_dkv write the
// variant they launched to *variant: 0 the fp32 FMA kernel, 1 the tensor-core kernel (bf16, fp16).
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int T, int N, int D, int causal, float scale, void* stream,
                         int* variant) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.out_lse = lse;
  a.B = B; a.T = T; a.N = N; a.causal = causal; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  a.variant = variant;
  return dispatch<Fwd>(dtype, D, a);
}

extern "C" int flash_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int T, int N, int D,
                        int causal, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  a.B = B; a.T = T; a.N = N; a.causal = causal; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Dq>(dtype, D, a);
}

extern "C" int flash_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B, int T, int N,
                         int D, int causal, float scale, void* stream, int* variant) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  a.B = B; a.T = T; a.N = N; a.causal = causal; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  a.variant = variant;
  return dispatch<Dkv>(dtype, D, a);
}
