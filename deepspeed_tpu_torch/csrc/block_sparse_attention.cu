// Block-sparse attention forward and backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three TPU kernels of deepspeed_tpu/ops/sparse_attention/pallas_block_sparse.py:
//   K7 _fwd_kernel (pallas_call in _sparse_fwd): for each q block, online-softmax attention over
//      the kv blocks of its compacted row list (row_idx / row_cnt), O and the fp32 log-sum-exp;
//   K8 _dq_kernel  (pallas_call in _sparse_bwd): dQ = scale * (P o (dO V^T - delta)) K over the
//      same row lists;
//   K9 _dkv_kernel (pallas_call in _sparse_bwd): dV = P^T dO, dK = scale * (P o (dO V^T - delta))^T Q
//      over the transposed column lists (col_idx / col_cnt),
// with P = exp(scale * Q K^T - lse) recomputed from the forward's LSE and delta = rowsum(dO o O)
// computed by the caller. q, k, v, o, dO are [BN, T, D] (heads folded into the batch), lse and
// delta plain [BN, T] fp32, the tables int32 ([nq, width] / [nq], [nk, width] / [nk]).
//
// Numerics are the Pallas kernels', not the flash kernels': q, k, v and dO enter in their dtype
// and every product (Q K^T, P V, dO V^T, dS K, P^T dO, dS^T Q) sums in fp32 with P and dS kept in
// fp32; only the outputs are rounded to the inputs' dtype. Scores are scaled after the product;
// the causal mask inside a pair (row >= column, global positions) uses the finite
// NEG_INF = -1e30, and a masked probability is set to exactly 0, so a row with no live score
// (no listed block, or every listed pair causally dead) ends with l = 0: O = 0 and
// LSE = NEG_INF, and its dQ is exactly 0; a key with no live pair gets dK = dV = 0.
//
// What bounds them: at BERT-large width (D = 64, blocks of 16, 67 live blocks a row at T = 4096)
// each call does 2-4 products of 2 D operations per live (query, key) pair over about 5-7
// operand-sized reads, so the tensor-core rate bounds it (K7 ~0.036 ms, K9 ~0.073 ms at B = 2,
// NH = 16 in bf16).
//
// K9 for bf16 and fp16 (sparse_dkv_tc_kernel) runs on the tensor cores with mma.sync.m16n8k16
// (csrc/tensor_core.cuh), over a unit table built on the host (block_sparse.build_dkv_units):
//  * a key block is cut into 16-row key tiles (one mma M; blocks of 8 to 128, the last tile of a
//    block masked). A unit is up to four key tiles whose key blocks list the same q blocks, one
//    warp each, and a chunk of that list; its q blocks are walked in 16-row steps (the ragged
//    part zero-filled), each step's Q, dO, LSE and delta staged once by 16-byte cp.async copies
//    into a 3-stage ring and shared by the four warps. At blocks of 16 the 64 global key
//    columns of a head list the same 256 q blocks and share every staged tile; at blocks of 64
//    the four tiles of one key block do;
//  * per step a warp forms S^T = K Q^T and dP^T = V dO^T (bf16/fp16 operands, exact products,
//    fp32 sums), P^T and dS^T in fp32 in the mma C layout, and accumulates dV += P^T dO and
//    dK += dS^T Q with P^T and dS^T repacked in registers as A fragments. Each fp32 operand is
//    split into hi + lo in the input dtype (hi = T(x), lo = T(x - hi)) and both are multiplied,
//    which carries it to about 2^-16 relative (bf16): 6 products a tile instead of 4, and the
//    Pallas kernel's fp32 numerics held within SPARSE_TOL;
//  * column lists longer than a cap (twice the mean list, at least 8) are cut into balanced
//    chunks, and units run longest first, so a global column (every q block listed) no longer
//    sets the launch's length. A split key block's chunks write fp32 partials to their own slots
//    of a workspace; a second small kernel (sparse_dkv_reduce_kernel) sums each block's slots in
//    chunk order and writes dK and dV. No atomics: two calls give bitwise-equal results;
//  * what bounds it now: at the main shape the units are balanced and each staged tile feeds
//    four warps; the kernel is limited by mma.sync issue and the per-step barrier and softmax
//    work of 16 x 16 score tiles (about 10% of the operations bound).
// K7 for bf16 and fp16 (sparse_fwd_tc_kernel) is the same design on the query side, over a unit
// table built from the row lists (block_sparse.build_fwd_units):
//  * a q block is cut into 16-row q tiles; a unit is up to four q tiles whose q blocks list the
//    same key blocks, one warp each, and a chunk of that list. Its key blocks are walked in 16-key
//    steps, each step's K and V staged once by cp.async into a 4-stage ring and shared by the four
//    warps: at blocks of 16 the 256 q blocks of a Fixed layout form 64 groups of four with equal
//    lists, so each staged K/V tile feeds four q tiles instead of being staged four times;
//  * each warp keeps its Q fragments, its rows' running max and sum and its O accumulators in
//    registers; S = Q K^T takes the operands as stored (exact products, fp32 sums), the scores are
//    scaled after the product, the online softmax runs in fp32 in base 2 with LSE in natural log,
//    masked probabilities are exactly 0, and O += P V multiplies the fp32 P as hi + lo in the
//    input dtype (K9's split; the Pallas kernel keeps P in fp32);
//  * under the causal mask the list ascends, so the first step past the unit's last row ends the
//    walk, and a warp skips a step past its own tile's last row; only steps that cross a tile's
//    diagonal or ragged end are masked;
//  * row lists longer than the same cap are cut into chunks; a split q block's chunks write fp32
//    partials (acc, m, l) to their own workspace slots and sparse_fwd_merge_kernel merges them in
//    chunk order (K4's combine): no atomics, two calls give bitwise-equal results;
//  * what bounds it now: about 9% of the operations bound at the main shape. Each 16-key step is
//    a serial chain per warp (mma.sync, row max by shuffles, exponentials, the C-to-A repack, the
//    hi and lo products) behind one barrier, with four blocks of four warps an SM (126 registers
//    a lane at D = 64). Staging 64 keys a step (four tiles a barrier, double-buffered) measured
//    slower, and skipping the rescale once a warp's row maxima settle gained nothing.
// K8 and fp32 K7 and K9 keep the first version: fp32 FMAs on the CUDA cores out of padded fp32
// shared memory (fp32 is the card's parity path, kernel vs plain to about 1e-6 with TF32 off).
//
// What the design does about the TPU kernels' shape. The Pallas kernels walk a padded list on a
// sequential grid axis (q block, list step), skip padded steps with pl.when and carry m/l/acc
// (or dQ, dK/dV) in VMEM scratch. Here:
//  * one thread block per (b*h, q tile) walks exactly row_cnt[qi] entries of its row list (fp32
//    K7, K8), or per (b*h, k tile) exactly col_cnt[ki] entries of its column list (fp32 K9), or
//    per (b*h, unit) one chunk of a row or column list (bf16/fp16 K7, K9): no padded steps, and
//    the running state stays in registers and shared memory;
//  * in the FMA kernels a block of `blk` rows (any multiple of 8 up to 128) is cut into tiles of
//    TB = 16 rows (blk < 64) or TB = 64 rows (blk >= 64); the last tile of a block may be
//    partial and is masked. Query (K7, K8) or key (K9) tiles of one block are separate thread
//    blocks; the other side's tiles are walked inside the listed block;
//  * under the causal mask a key tile that starts past the q tile's last row (K7, K8), or a
//    q tile that ends before the k tile's first key (K9), is skipped: it holds no live score;
//  * the FMA kernels' 256 threads hold a (TB/16) x (TB/16) register tile of every TB x TB score
//    tile (rows ty + 16 i, columns tx + 16 j), so a row's softmax reduction is a 16-lane
//    shuffle; their shared-memory rows are padded by one float against bank conflicts.
// Not done yet (later work): tensor cores for K8 (the K7 unit table serves its row lists), wgmma.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // 16 x 16 threads

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

// rows r0 .. r0+n-1 (n <= TB) of head bn of a [BN, T, D] tensor into dst[TB][D+1] as fp32;
// rows at or past n read as zeros
template <typename T, int D, int TB>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int bn, int r0,
                                          int n, int Tn) {
  const T* base = src + (static_cast<size_t>(bn) * Tn + r0) * D;
  for (int e = threadIdx.x; e < TB * D; e += THREADS) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < n ? to_f32(base[static_cast<size_t>(r) * D + d]) : 0.f;
  }
}

// rows r0 .. r0+n-1 of a [BN, T] fp32 row statistic; past n reads as zero
template <int TB>
__device__ __forceinline__ void load_stat(float* dst, const float* __restrict__ src, int bn, int r0,
                                          int n, int Tn) {
  if (threadIdx.x < TB) dst[threadIdx.x] = threadIdx.x < n ? src[static_cast<size_t>(bn) * Tn + r0 + threadIdx.x] : 0.f;
}

// ---------------------------------------------------------------------------------------------
// K7: forward
// ---------------------------------------------------------------------------------------------
template <typename T, int D, int TB>
__global__ void __launch_bounds__(THREADS)
sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ row_idx,
                  const int* __restrict__ row_cnt, int width, int Tn, int blk, int causal,
                  float scale) {
  constexpr int DP = D + 1, SP = TB + 1;
  constexpr int R = TB / 16;  // rows (and score columns) per thread
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + TB * DP;
  float* vs = ks + TB * DP;
  float* ps = vs + TB * DP;  // [TB][SP] probabilities, fp32

  const int subs = (blk + TB - 1) / TB;  // tiles per block
  const int qi = blockIdx.x / subs, qsub = blockIdx.x % subs;
  const int bn = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qi * blk + qsub * TB;
  const int nq = min(TB, blk - qsub * TB);
  const int cnt = row_cnt[qi];

  load_rows<T, D, TB>(qs, q, bn, q0, nq, Tn);
  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int li = 0; li < cnt; ++li) {
    const int kb = row_idx[static_cast<size_t>(qi) * width + li];
    for (int ksub = 0; ksub < subs; ++ksub) {
      const int k0 = kb * blk + ksub * TB;
      const int nk = min(TB, blk - ksub * TB);
      if (causal && k0 > q0 + nq - 1) break;  // this and every later key tile lie in the future
      __syncthreads();  // the previous tile's K, V and P are consumed
      load_rows<T, D, TB>(ks, k, bn, k0, nk, Tn);
      load_rows<T, D, TB>(vs, v, bn, k0, nk, Tn);
      __syncthreads();

      float s[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[R], b[R];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
        for (int j = 0; j < R; ++j) b[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        const int row = q0 + r;
        bool live[R];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          live[j] = r < nq && c < nk && (!causal || row >= k0 + c);
          s[i][j] = live[j] ? s[i][j] * scale : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], reduce16_max(mx));
        const float corr = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          // NEG_INF is finite: exp(s - m_new) of a masked score would be 1 on a row whose
          // every score so far is masked, so masked probabilities are zeroed explicitly
          const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
          sum += p;
          ps[r * SP + tx + 16 * j] = p;
        }
        l[i] = corr * l[i] + reduce16_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < TB; ++kk) {
        float p[R];
#pragma unroll
        for (int i = 0; i < R; ++i) p[i] = ps[(ty + 16 * i) * SP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float vv = vs[kk * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const int row = q0 + r;
      const float safe_l = l[i] == 0.f ? 1.f : l[i];
      T* dst = o + (static_cast<size_t>(bn) * Tn + row) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c] / safe_l);
      if (tx == 0) lse[static_cast<size_t>(bn) * Tn + row] = l[i] == 0.f ? NEG_INF : m[i] + logf(safe_l);
    }
  }
}

// ---------------------------------------------------------------------------------------------
// K8: dQ
// ---------------------------------------------------------------------------------------------
template <typename T, int D, int TB>
__global__ void __launch_bounds__(THREADS)
sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, const int* __restrict__ row_idx,
                 const int* __restrict__ row_cnt, int width, int Tn, int blk, int causal,
                 float scale) {
  constexpr int DP = D + 1, SP = TB + 1;
  constexpr int R = TB / 16;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TB * DP;
  float* ks = dos + TB * DP;
  float* vs = ks + TB * DP;
  float* dss = vs + TB * DP;  // [TB][SP] dS, fp32
  float* lse_s = dss + TB * SP;
  float* delta_s = lse_s + TB;

  const int subs = (blk + TB - 1) / TB;
  const int qi = blockIdx.x / subs, qsub = blockIdx.x % subs;
  const int bn = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = qi * blk + qsub * TB;
  const int nq = min(TB, blk - qsub * TB);
  const int cnt = row_cnt[qi];

  load_rows<T, D, TB>(qs, q, bn, q0, nq, Tn);
  load_rows<T, D, TB>(dos, dout, bn, q0, nq, Tn);
  load_stat<TB>(lse_s, lse, bn, q0, nq, Tn);
  load_stat<TB>(delta_s, delta, bn, q0, nq, Tn);
  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int li = 0; li < cnt; ++li) {
    const int kb = row_idx[static_cast<size_t>(qi) * width + li];
    for (int ksub = 0; ksub < subs; ++ksub) {
      const int k0 = kb * blk + ksub * TB;
      const int nk = min(TB, blk - ksub * TB);
      if (causal && k0 > q0 + nq - 1) break;
      __syncthreads();
      load_rows<T, D, TB>(ks, k, bn, k0, nk, Tn);
      load_rows<T, D, TB>(vs, v, bn, k0, nk, Tn);
      __syncthreads();

      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[R], g[R], bk[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a[i] = qs[(ty + 16 * i) * DP + d];
          g[i] = dos[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          bk[j] = ks[(tx + 16 * j) * DP + d];
          bv[j] = vs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(a[i], bk[j], s[i][j]);
            dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          const bool live = r < nq && c < nk && (!causal || row >= k0 + c);
          const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          dss[r * SP + c] = p * (dp[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < TB; ++kk) {
        float ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) ds[i] = dss[(ty + 16 * i) * SP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float kv = ks[kk * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      T* dst = dq + (static_cast<size_t>(bn) * Tn + q0 + r) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------------------------
// K9: dK, dV
// ---------------------------------------------------------------------------------------------
template <typename T, int D, int TB>
__global__ void __launch_bounds__(THREADS)
sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  const int* __restrict__ col_idx, const int* __restrict__ col_cnt, int width,
                  int Tn, int blk, int causal, float scale) {
  constexpr int DP = D + 1, SP = TB + 1;
  constexpr int R = TB / 16;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TB * DP;
  float* qs = vs + TB * DP;
  float* dos = qs + TB * DP;
  float* pts = dos + TB * DP;     // [TB keys][SP queries] P^T, fp32
  float* dsts = pts + TB * SP;    // dS^T, fp32
  float* lse_s = dsts + TB * SP;
  float* delta_s = lse_s + TB;

  const int subs = (blk + TB - 1) / TB;
  const int kb = blockIdx.x / subs, ksub = blockIdx.x % subs;
  const int bn = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int k0 = kb * blk + ksub * TB;
  const int nk = min(TB, blk - ksub * TB);
  const int cnt = col_cnt[kb];

  load_rows<T, D, TB>(ks, k, bn, k0, nk, Tn);
  load_rows<T, D, TB>(vs, v, bn, k0, nk, Tn);
  float dk_acc[R][DC], dv_acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int li = 0; li < cnt; ++li) {
    const int qb = col_idx[static_cast<size_t>(kb) * width + li];
    for (int qsub = 0; qsub < subs; ++qsub) {
      const int q0 = qb * blk + qsub * TB;
      const int nq = min(TB, blk - qsub * TB);
      if (causal && q0 + nq - 1 < k0) continue;  // every row of this q tile precedes every key
      __syncthreads();
      load_rows<T, D, TB>(qs, q, bn, q0, nq, Tn);
      load_rows<T, D, TB>(dos, dout, bn, q0, nq, Tn);
      load_stat<TB>(lse_s, lse, bn, q0, nq, Tn);
      load_stat<TB>(delta_s, delta, bn, q0, nq, Tn);
      __syncthreads();

      // transposed scores: key rows ty + 16 i, query columns tx + 16 j
      float st[R][R], dpt[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[R], av[R], bq[R], bg[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a[i] = ks[(ty + 16 * i) * DP + d];
          av[i] = vs[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          bq[j] = qs[(tx + 16 * j) * DP + d];
          bg[j] = dos[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            st[i][j] = fmaf(a[i], bq[j], st[i][j]);
            dpt[i][j] = fmaf(av[i], bg[j], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
        const int key = k0 + r;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          const bool live = r < nk && c < nq && (!causal || q0 + c >= key);
          const float p = live ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
          pts[r * SP + c] = p;
          dsts[r * SP + c] = p * (dpt[i][j] - delta_s[c]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < TB; ++qq) {
        float pv[R], ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = pts[(ty + 16 * i) * SP + qq];
          ds[i] = dsts[(ty + 16 * i) * SP + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float g = dos[qq * DP + tx + 16 * c];
          const float qv = qs[qq * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dv_acc[i][c] = fmaf(pv[i], g, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r < nk) {
      const size_t at = (static_cast<size_t>(bn) * Tn + k0 + r) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[at + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
        dv[at + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------------------------
// the tensor-core variants (bf16 and fp16): units of four 16-row tiles walking one shared list
// ---------------------------------------------------------------------------------------------
constexpr int UNIT_WARPS = 4;  // tiles of a unit, one a warp
constexpr int UNIT_THREADS = 32 * UNIT_WARPS;
constexpr int TILE_ROWS = 16;  // rows of a tile and of a step
constexpr int UNIT_W = 3 + 2 * UNIT_WARPS;  // list block, start, len, tile[WARPS], slot[WARPS]
constexpr float LOG2E = 1.4426950408889634f;

// async copy of rows r0 .. r0+15 of head bn of a [BN, T, D] tensor into a swizzled [16][D] tile,
// by the `nthreads` threads numbered `tid`; rows at or past n are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int bn, int r0, int n, int Tn,
                                          int tid, int nthreads) {
  constexpr int CH = D / 8;
  for (int e = tid; e < TILE_ROWS * CH; e += nthreads) {
    const int r = e / CH, c = e % CH;
    const bool valid = r < n;
    tc::cp_async16(dst + tc::swz<D>(r, c * 8),
                   src + (static_cast<size_t>(bn) * Tn + r0 + (valid ? r : 0)) * D + c * 8, valid);
  }
}

// K9: one thread block per (unit, b*h). A unit is up to four 16-row key tiles whose key blocks list
// the same q blocks, and a chunk [start, start + len) of that list: every warp takes one key tile
// and all of them share each staged 16-row Q/dO step. A unit either owns its key tiles' whole
// list (slot -1: dK and dV written in T) or one chunk of it (fp32 partials into workspace slot).
constexpr int DKV_STAGES = 3;  // depth of K9's Q/dO ring

template <typename T, int D>
__global__ void __launch_bounds__(UNIT_THREADS)
sparse_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const int* __restrict__ col_idx, const int* __restrict__ units,
                     float* __restrict__ ws, int n_slots, int width, int Tn, int blk, int causal,
                     float scale) {
  constexpr int KS = D / 16;  // k16 steps over the head dimension
  constexpr int DT = D / 8;   // 8-wide tiles of a dK / dV row
  constexpr bool KV_REGS = D == 64;  // K and V fragments in registers (D = 128: re-read them)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* kvs = reinterpret_cast<T*>(smem_raw);         // [WARPS][2][16][D]: each warp's K and V tile
  T* ring = kvs + UNIT_WARPS * 2 * TILE_ROWS * D;    // [STAGES][2][16][D]: Q and dO of a step
  float* stats = reinterpret_cast<float*>(ring + DKV_STAGES * 2 * TILE_ROWS * D);  // [STAGES][2][16]

  const int* unit = units + static_cast<size_t>(blockIdx.x) * UNIT_W;
  const int bn = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int list_kb = unit[0], start = unit[1], len = unit[2];
  const int tile = unit[3 + warp], slot = unit[3 + UNIT_WARPS + warp];
  const int nk = tile < 0 ? 0 : min(TILE_ROWS, blk - tile % blk);  // live rows of this key tile
  int first_key = Tn;  // the unit's first key: a q step wholly before it is dead for every warp
#pragma unroll
  for (int w = 0; w < UNIT_WARPS; ++w)
    if (unit[3 + w] >= 0) first_key = min(first_key, unit[3 + w]);
  const int subs = (blk + TILE_ROWS - 1) / TILE_ROWS;  // 16-row steps of a listed q block
  const int n_steps = len * subs;
  const int* list = col_idx + static_cast<size_t>(list_kb) * width + start;
  const float scale_log2 = scale * LOG2E;

  T* ks = kvs + warp * 2 * TILE_ROWS * D;
  T* vs = ks + TILE_ROWS * D;
  if (tile >= 0) {
    load_tile<T, D>(ks, k, bn, tile, nk, Tn, lane, 32);
    load_tile<T, D>(vs, v, bn, tile, nk, Tn, lane, 32);
  }

  // step s: rows q0 .. q0+nq-1 of the listed q block list[s / subs]; dead for the whole unit under
  // the causal mask when its last row precedes the unit's first key
  auto step_rows = [&](int s, int& q0, int& nq) {
    const int qsub = s % subs;
    q0 = __ldg(list + s / subs) * blk + qsub * TILE_ROWS;
    nq = min(TILE_ROWS, blk - qsub * TILE_ROWS);
  };
  auto load_step = [&](int s) {
    int q0, nq;
    step_rows(s, q0, nq);
    if (causal && q0 + nq - 1 < first_key) return;
    T* qd = ring + (s % DKV_STAGES) * 2 * TILE_ROWS * D;
    load_tile<T, D>(qd, q, bn, q0, nq, Tn, threadIdx.x, UNIT_THREADS);
    load_tile<T, D>(qd + TILE_ROWS * D, dout, bn, q0, nq, Tn, threadIdx.x, UNIT_THREADS);
    float* st = stats + (s % DKV_STAGES) * 2 * TILE_ROWS;
    if (threadIdx.x < 8) {  // 4 chunks of 4 rows of lse, then of delta
      const int which = threadIdx.x >> 2, c = threadIdx.x & 3;
      const float* src = which ? delta : lse;
      const bool valid = c * 4 < nq;
      tc::cp_async16(st + which * TILE_ROWS + c * 4,
                     src + static_cast<size_t>(bn) * Tn + q0 + (valid ? c * 4 : 0), valid);
    }
  };

#pragma unroll
  for (int i = 0; i < DKV_STAGES - 1; ++i) {
    if (i < n_steps) load_step(i);
    tc::cp_async_commit();
  }

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  uint32_t kf[KV_REGS ? KS : 1][4], vf[KV_REGS ? KS : 1][4];

  for (int s = 0; s < n_steps; ++s) {
    tc::cp_async_wait<DKV_STAGES - 2>();
    __syncthreads();  // step s has landed, and every warp is done with step s - 1's stage
    if (s + DKV_STAGES - 1 < n_steps) load_step(s + DKV_STAGES - 1);
    tc::cp_async_commit();
    if constexpr (KV_REGS) {
      if (s == 0 && tile >= 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          tc::ldmatrix_x4(kf[kk], ks + tc::swz<D>(lane & 15, kk * 16 + (lane >> 4) * 8));
          tc::ldmatrix_x4(vf[kk], vs + tc::swz<D>(lane & 15, kk * 16 + (lane >> 4) * 8));
        }
      }
    }
    int q0, nq;
    step_rows(s, q0, nq);
    // this warp's key tile is dead for the step under the causal mask if every row precedes it
    if (tile < 0 || (causal && q0 + nq - 1 < tile)) continue;
    const T* qst = ring + (s % DKV_STAGES) * 2 * TILE_ROWS * D;
    const T* dost = qst + TILE_ROWS * D;
    const float* lse_s = stats + (s % DKV_STAGES) * 2 * TILE_ROWS;
    const float* delta_s = lse_s + TILE_ROWS;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 q rows, two 16 x 8 tiles each
    float st[2][4], dpt[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4], bq[4], bo[4];
      if constexpr (KV_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = kf[kk][i];
          va[i] = vf[kk][i];
        }
      } else {
        tc::ldmatrix_x4(ka, ks + tc::swz<D>(lane & 15, kk * 16 + (lane >> 4) * 8));
        tc::ldmatrix_x4(va, vs + tc::swz<D>(lane & 15, kk * 16 + (lane >> 4) * 8));
      }
      const int r = (lane & 7) + ((lane >> 4) << 3), c = kk * 16 + ((lane >> 3) & 1) * 8;
      tc::ldmatrix_x4(bq, qst + tc::swz<D>(r, c));
      tc::ldmatrix_x4(bo, dost + tc::swz<D>(r, c));
      tc::mma<T>(st[0], ka, bq[0], bq[1]);
      tc::mma<T>(st[1], ka, bq[2], bq[3]);
      tc::mma<T>(dpt[0], va, bo[0], bo[1]);
      tc::mma<T>(dpt[1], va, bo[2], bo[3]);
    }

    // P^T = exp(scale S^T - lse) on live pairs, exactly 0 elsewhere; dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = g + (e >> 1) * 8, qc = j * 8 + 2 * t4 + (e & 1);
        const bool live = kr < nk && qc < nq && (!causal || q0 + qc >= tile + kr);
        const float p = live ? exp2f(st[j][e] * scale_log2 - lse_s[qc] * LOG2E) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - delta_s[qc]) * scale;
      }

    // dV += P^T dO and dK += dS^T Q, each fp32 operand as hi + lo in T
    uint32_t ph[4], pl[4], dh[4], dl[4];
    tc::a_from_c_split<T>(ph, pl, st[0], st[1]);
    tc::a_from_c_split<T>(dh, dl, dpt[0], dpt[1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bo[4], bq[4];
      tc::ldmatrix_x4_trans(bo, dost + tc::swz<D>(lane & 15, dp * 16 + (lane >> 4) * 8));
      tc::ldmatrix_x4_trans(bq, qst + tc::swz<D>(lane & 15, dp * 16 + (lane >> 4) * 8));
      tc::mma<T>(dv_acc[2 * dp], ph, bo[0], bo[1]);
      tc::mma<T>(dv_acc[2 * dp], pl, bo[0], bo[1]);
      tc::mma<T>(dv_acc[2 * dp + 1], ph, bo[2], bo[3]);
      tc::mma<T>(dv_acc[2 * dp + 1], pl, bo[2], bo[3]);
      tc::mma<T>(dk_acc[2 * dp], dh, bq[0], bq[1]);
      tc::mma<T>(dk_acc[2 * dp], dl, bq[0], bq[1]);
      tc::mma<T>(dk_acc[2 * dp + 1], dh, bq[2], bq[3]);
      tc::mma<T>(dk_acc[2 * dp + 1], dl, bq[2], bq[3]);
    }
  }
  tc::cp_async_wait<0>();  // no copy may outlive the block (the last groups are empty)

  if (tile < 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = g + i * 8;
    if (kr >= nk) continue;
    if (slot < 0) {
      const size_t at = (static_cast<size_t>(bn) * Tn + tile + kr) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        *reinterpret_cast<uint32_t*>(dk + at + j * 8) = tc::pack2<T>(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at + j * 8) = tc::pack2<T>(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
      }
    } else {
      // workspace [BN][n_slots][2 (dK, dV)][blk][D] fp32; this tile's rows start at tile % blk
      float* w = ws + ((static_cast<size_t>(bn) * n_slots + slot) * 2 * blk + tile % blk + kr) * D + 2 * t4;
      const size_t half = static_cast<size_t>(blk) * D;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        *reinterpret_cast<float2*>(w + j * 8) = make_float2(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
        *reinterpret_cast<float2*>(w + half + j * 8) = make_float2(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
      }
    }
  }
}

// The split key blocks' partials summed in chunk order, so the result does not depend on which
// chunk finished first: one thread block per (split key block, b*h); reduce[r] = (kb, first slot,
// chunks).
template <typename T>
__global__ void __launch_bounds__(256)
sparse_dkv_reduce_kernel(const float* __restrict__ ws, const int* __restrict__ reduce, T* __restrict__ dk,
                         T* __restrict__ dv, int n_slots, int Tn, int D, int blk) {
  const int* r = reduce + 3 * blockIdx.x;
  const int kb = r[0], s0 = r[1], n = r[2];
  const int bn = blockIdx.y;
  const int quads = 2 * blk * D / 4;  // float4s of dK then dV
  const float4* base = reinterpret_cast<const float4*>(ws + (static_cast<size_t>(bn) * n_slots + s0) * 2 * blk * D);
  for (int e = threadIdx.x; e < quads; e += blockDim.x) {
    float4 acc = base[e];
    for (int c = 1; c < n; ++c) {
      const float4 x = base[static_cast<size_t>(c) * quads + e];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int which = e / (quads / 2), rem = e % (quads / 2);
    T* dst = (which ? dv : dk) + (static_cast<size_t>(bn) * Tn + static_cast<size_t>(kb) * blk) * D + rem * 4;
    uint2 packed;
    packed.x = tc::pack2<T>(acc.x, acc.y);
    packed.y = tc::pack2<T>(acc.z, acc.w);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
}

// ---------------------------------------------------------------------------------------------
// K7 on the tensor cores: bf16 and fp16
// ---------------------------------------------------------------------------------------------
constexpr int FWD_STAGES = 4;  // depth of K7's K/V ring

// One thread block per (unit, b*h). A unit is up to four 16-row q tiles whose q blocks list the
// same key blocks, and a chunk [start, start + len) of that list: every warp takes one q tile and
// all of them share each staged 16-key K/V step. A unit either owns its q tiles' whole list (slot
// -1: O in T and the LSE written) or one chunk of it (fp32 partials m, l, acc into workspace slot).
template <typename T, int D>
__global__ void __launch_bounds__(UNIT_THREADS)
sparse_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ row_idx,
                     const int* __restrict__ units, float* __restrict__ ws, int n_slots, int width, int Tn,
                     int blk, int causal, float scale) {
  constexpr int KS = D / 16;  // k16 steps of Q K^T
  constexpr int DT = D / 8;   // 8-wide tiles of an O row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);          // [WARPS][16][D]: each warp's Q tile
  T* ring = qs + UNIT_WARPS * TILE_ROWS * D;       // [STAGES][2][16][D]: K and V of a step

  const int* unit = units + static_cast<size_t>(blockIdx.x) * UNIT_W;
  const int bn = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int list_qb = unit[0], start = unit[1], len = unit[2];
  const int tile = unit[3 + warp], slot = unit[3 + UNIT_WARPS + warp];
  const int nq = tile < 0 ? 0 : min(TILE_ROWS, blk - tile % blk);  // live rows of this q tile
  int last_row = -1;  // the unit's last row: a key step wholly after it is dead for every warp
#pragma unroll
  for (int w = 0; w < UNIT_WARPS; ++w) {
    const int t = unit[3 + w];
    if (t >= 0) last_row = max(last_row, t + min(TILE_ROWS, blk - t % blk) - 1);
  }
  const int subs = (blk + TILE_ROWS - 1) / TILE_ROWS;  // 16-key steps of a listed key block
  const int n_steps = len * subs;
  const int* list = row_idx + static_cast<size_t>(list_qb) * width + start;

  T* qw = qs + warp * TILE_ROWS * D;
  if (tile >= 0) load_tile<T, D>(qw, q, bn, tile, nq, Tn, lane, 32);  // lands with step 0's group

  // step s: keys k0 .. k0+nk-1 of the listed key block list[s / subs]. The list ascends, so under
  // the causal mask the first step that starts past the unit's last row ends the walk.
  auto step_keys = [&](int s, int& k0, int& nk) {
    const int ksub = s % subs;
    k0 = __ldg(list + s / subs) * blk + ksub * TILE_ROWS;
    nk = min(TILE_ROWS, blk - ksub * TILE_ROWS);
  };
  auto load_step = [&](int s) {
    int k0, nk;
    step_keys(s, k0, nk);
    if (causal && k0 > last_row) return;
    T* kd = ring + (s % FWD_STAGES) * 2 * TILE_ROWS * D;
    load_tile<T, D>(kd, k, bn, k0, nk, Tn, threadIdx.x, UNIT_THREADS);
    load_tile<T, D>(kd + TILE_ROWS * D, v, bn, k0, nk, Tn, threadIdx.x, UNIT_THREADS);
  };

#pragma unroll
  for (int i = 0; i < FWD_STAGES - 1; ++i) {
    if (i < n_steps) load_step(i);
    tc::cp_async_commit();
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // scaled running max; this lane's share of l
  uint32_t qf[KS][4];

  for (int s = 0; s < n_steps; ++s) {
    int k0, nk;
    step_keys(s, k0, nk);
    if (causal && k0 > last_row) break;  // block-uniform
    tc::cp_async_wait<FWD_STAGES - 2>();
    __syncthreads();  // step s has landed, and every warp is done with step s - 1's stage
    if (s + FWD_STAGES - 1 < n_steps) load_step(s + FWD_STAGES - 1);
    tc::cp_async_commit();
    if (s == 0 && tile >= 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        tc::ldmatrix_x4(qf[kk], qw + tc::swz<D>(lane & 15, kk * 16 + (lane >> 4) * 8));
    }
    // this warp's q tile is dead for the step under the causal mask if every key follows its rows
    if (tile < 0 || (causal && k0 > tile + nq - 1)) continue;
    const T* kst = ring + (s % FWD_STAGES) * 2 * TILE_ROWS * D;
    const T* vst = kst + TILE_ROWS * D;

    // S = Q K^T: 16 q rows x 16 keys, two 16 x 8 tiles
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bk[4];
      tc::ldmatrix_x4(bk, kst + tc::swz<D>((lane & 7) + ((lane >> 4) << 3), kk * 16 + ((lane >> 3) & 1) * 8));
      tc::mma<T>(sc[0], qf[kk], bk[0], bk[1]);
      tc::mma<T>(sc[1], qf[kk], bk[2], bk[3]);
    }

    // online softmax on the scaled scores (scaled after the product, as the Pallas kernel does);
    // only a step that crosses the diagonal or a tile's ragged end is masked
    const bool masked = nk < TILE_ROWS || nq < TILE_ROWS || (causal && k0 + TILE_ROWS - 1 > tile);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (masked) {
          const int r = g + (e >> 1) * 8, c = j * 8 + 2 * t4 + (e & 1);
          if (!(r < nq && c < nk && (!causal || tile + r >= k0 + c))) x = NEG_INF;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], ml2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f((m[i] - mx[i]) * LOG2E);
      m[i] = mx[i];
      l[i] *= corr[i];
      ml2[i] = mx[i] * LOG2E;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // NEG_INF is finite: on a row whose every score so far is masked, exp(s - m) would be 1,
        // so masked probabilities are zeroed explicitly
        float p = exp2f(fmaf(sc[j][e], LOG2E, -ml2[e >> 1]));
        if (masked && sc[j][e] == NEG_INF) p = 0.f;
        sc[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += P V with the fp32 P as hi + lo in T; B from V by ldmatrix.trans
    uint32_t ph[4], pl[4];
    tc::a_from_c_split<T>(ph, pl, sc[0], sc[1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      tc::ldmatrix_x4_trans(bv, vst + tc::swz<D>(lane & 15, dp * 16 + (lane >> 4) * 8));
      tc::mma<T>(acc[2 * dp], ph, bv[0], bv[1]);
      tc::mma<T>(acc[2 * dp + 1], ph, bv[2], bv[3]);
      tc::mma<T>(acc[2 * dp], pl, bv[0], bv[1]);
      tc::mma<T>(acc[2 * dp + 1], pl, bv[2], bv[3]);
    }
  }
  tc::cp_async_wait<0>();  // no copy may outlive the block (the last groups are empty)

  if (tile < 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int r = g + h * 8;
    if (r >= nq) continue;
    if (slot < 0) {
      // a row with no live score ends with l = 0: O = 0 and LSE = NEG_INF
      const float safe_l = lh == 0.f ? 1.f : lh;
      T* dst = o + (static_cast<size_t>(bn) * Tn + tile + r) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) = tc::pack2<T>(acc[j][2 * h] / safe_l, acc[j][2 * h + 1] / safe_l);
      if (t4 == 0) lse[static_cast<size_t>(bn) * Tn + tile + r] = lh == 0.f ? NEG_INF : m[h] + logf(safe_l);
    } else {
      // workspace: acc [BN][n_slots][blk][D], then (m, l) [BN][n_slots][blk] as float2; this
      // tile's rows start at tile % blk of the slot
      const size_t row = (static_cast<size_t>(bn) * n_slots + slot) * blk + tile % blk + r;
      float* w = ws + row * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < DT; ++j) *reinterpret_cast<float2*>(w + j * 8) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      if (t4 == 0) {
        float2* ml = reinterpret_cast<float2*>(ws + static_cast<size_t>(gridDim.y) * n_slots * blk * D);
        ml[row] = make_float2(lh == 0.f ? NEG_INF : m[h], lh);
      }
    }
  }
}

// The split q blocks' partials merged in chunk order, so the result does not depend on which
// chunk finished first: one thread block per (split q block, b*h), a warp per row; reduce[r] =
// (qb, first slot, chunks). M = max m over the chunks with l > 0, L = sum exp(m - M) l,
// O = sum exp(m - M) acc / L, LSE = M + log L (NEG_INF and O = 0 where L = 0).
template <typename T, int D>
__global__ void __launch_bounds__(128)
sparse_fwd_merge_kernel(const float* __restrict__ ws, const int* __restrict__ reduce, T* __restrict__ o,
                        float* __restrict__ lse, int n_slots, int Tn, int blk) {
  constexpr int V = D / 32;  // output values a lane
  const int* rd = reduce + 3 * blockIdx.x;
  const int qb = rd[0], s0 = rd[1], n = rd[2];
  const int bn = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float2* ml = reinterpret_cast<const float2*>(ws + static_cast<size_t>(gridDim.y) * n_slots * blk * D);
  for (int r = threadIdx.x >> 5; r < blk; r += blockDim.x >> 5) {
    const size_t first = (static_cast<size_t>(bn) * n_slots + s0) * blk + r;  // chunk c at first + c * blk
    float M = NEG_INF;
    for (int c = 0; c < n; ++c) {
      const float2 p = ml[first + static_cast<size_t>(c) * blk];
      if (p.y > 0.f) M = fmaxf(M, p.x);
    }
    float L = 0.f, out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = 0.f;
    for (int c = 0; c < n; ++c) {
      const size_t at = first + static_cast<size_t>(c) * blk;
      const float2 p = ml[at];
      if (p.y > 0.f) {
        const float wgt = expf(p.x - M);
        L += wgt * p.y;
        const float* a = ws + at * D + lane * V;
#pragma unroll
        for (int i = 0; i < V; ++i) out[i] += wgt * a[i];
      }
    }
    const float safe_l = L == 0.f ? 1.f : L;
    const size_t row = static_cast<size_t>(bn) * Tn + static_cast<size_t>(qb) * blk + r;
    T* dst = o + row * D + lane * V;
#pragma unroll
    for (int i = 0; i < V; i += 2)
      *reinterpret_cast<uint32_t*>(dst + i) = tc::pack2<T>(out[i] / safe_l, out[i + 1] / safe_l);
    if (lane == 0) lse[row] = L == 0.f ? NEG_INF : M + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------------------------
template <int D, int TB>
constexpr size_t smem_bytes(int n_tiles, int n_score_tiles, int n_rowstats) {
  return sizeof(float) * (static_cast<size_t>(n_tiles) * TB * (D + 1) +
                          static_cast<size_t>(n_score_tiles) * TB * (TB + 1) +
                          static_cast<size_t>(n_rowstats) * TB);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *idx, *cnt;
  void *o, *out_lse, *dq, *dk, *dv;
  int width, BN, T, blk, causal;
  float scale;
  cudaStream_t stream;
  // the tensor-core variants of K7 and K9: the unit and reduce tables, the fp32 workspace, and
  // the variant launched (0 the fp32 FMA kernel, 1 tensor cores)
  const void *units, *reduce;
  void* ws;
  int n_units, n_reduce, n_slots;
  int* variant;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  // above 48 KB a block's shared memory must be opted into per kernel
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int TB>
dim3 grid_of(const Args& a) {
  return dim3((a.T / a.blk) * ((a.blk + TB - 1) / TB), a.BN);
}

// fp32 runs the FMA kernel (the parity path); bf16 and fp16 the tensor-core kernel over the unit
// table, then the chunk-order merge of the split q blocks, if the layout has any
template <typename T, int D, int TB>
struct Fwd {
  static int run(const Args& a) {
    if constexpr (std::is_same<T, float>::value) {
      const size_t smem = smem_bytes<D, TB>(3, 1, 0);
      auto kernel = sparse_fwd_kernel<T, D, TB>;
      cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid_of<TB>(a), THREADS, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<T*>(a.o), static_cast<float*>(a.out_lse), static_cast<const int*>(a.idx),
          static_cast<const int*>(a.cnt), a.width, a.T, a.blk, a.causal, a.scale);
      *a.variant = 0;
      return static_cast<int>(cudaGetLastError());
    } else {
      if (a.n_units <= 0 || a.n_reduce < 0 || (a.n_reduce > 0 && (a.n_slots <= 0 || a.ws == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = sizeof(T) * (UNIT_WARPS + FWD_STAGES * 2) * TILE_ROWS * D;
      auto kernel = sparse_fwd_tc_kernel<T, D>;
      cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<dim3(a.n_units, a.BN), UNIT_THREADS, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<T*>(a.o), static_cast<float*>(a.out_lse), static_cast<const int*>(a.idx),
          static_cast<const int*>(a.units), static_cast<float*>(a.ws), a.n_slots, a.width, a.T, a.blk,
          a.causal, a.scale);
      *a.variant = 1;
      err = cudaGetLastError();
      if (err != cudaSuccess || a.n_reduce == 0) return static_cast<int>(err);
      sparse_fwd_merge_kernel<T, D><<<dim3(a.n_reduce, a.BN), 128, 0, a.stream>>>(
          static_cast<const float*>(a.ws), static_cast<const int*>(a.reduce), static_cast<T*>(a.o),
          static_cast<float*>(a.out_lse), a.n_slots, a.T, a.blk);
      return static_cast<int>(cudaGetLastError());
    }
  }
};

template <typename T, int D, int TB>
struct Dq {
  static int run(const Args& a) {
    const size_t smem = smem_bytes<D, TB>(4, 1, 2);
    auto kernel = sparse_dq_kernel<T, D, TB>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid_of<TB>(a), THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), static_cast<const int*>(a.idx),
        static_cast<const int*>(a.cnt), a.width, a.T, a.blk, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
};

// fp32 runs the FMA kernel (the parity path); bf16 and fp16 the tensor-core kernel over the unit
// table, then the chunk-order reduction of the split key blocks, if the layout has any
template <typename T, int D, int TB>
struct Dkv {
  static int run(const Args& a) {
    if constexpr (std::is_same<T, float>::value) {
      const size_t smem = smem_bytes<D, TB>(4, 2, 2);
      auto kernel = sparse_dkv_kernel<T, D, TB>;
      cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid_of<TB>(a), THREADS, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
          static_cast<const int*>(a.idx), static_cast<const int*>(a.cnt), a.width, a.T, a.blk,
          a.causal, a.scale);
      *a.variant = 0;
      return static_cast<int>(cudaGetLastError());
    } else {
      if (a.n_units <= 0 || a.n_reduce < 0 || (a.n_reduce > 0 && (a.n_slots <= 0 || a.ws == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = sizeof(T) * (UNIT_WARPS + DKV_STAGES) * 2 * TILE_ROWS * D +
                          sizeof(float) * DKV_STAGES * 2 * TILE_ROWS;
      auto kernel = sparse_dkv_tc_kernel<T, D>;
      cudaError_t err = prepare(kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<dim3(a.n_units, a.BN), UNIT_THREADS, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
          static_cast<const int*>(a.idx), static_cast<const int*>(a.units), static_cast<float*>(a.ws),
          a.n_slots, a.width, a.T, a.blk, a.causal, a.scale);
      *a.variant = 1;
      err = cudaGetLastError();
      if (err != cudaSuccess || a.n_reduce == 0) return static_cast<int>(err);
      sparse_dkv_reduce_kernel<T><<<dim3(a.n_reduce, a.BN), 256, 0, a.stream>>>(
          static_cast<const float*>(a.ws), static_cast<const int*>(a.reduce), static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.n_slots, a.T, D, a.blk);
      return static_cast<int>(cudaGetLastError());
    }
  }
};

template <template <typename, int, int> class Launch, typename T, int D>
int by_tile(const Args& a) {
  return a.blk >= 64 ? Launch<T, D, 64>::run(a) : Launch<T, D, 16>::run(a);
}

template <template <typename, int, int> class Launch>
int dispatch(int dtype, int D, const Args& a) {
  if (a.BN <= 0 || a.BN > 65535 || a.blk < 8 || a.blk > 128 || a.blk % 8 != 0 || a.T <= 0 ||
      a.T % a.blk != 0 || a.width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype * 1000 + D) {
    case 64: return by_tile<Launch, float, 64>(a);
    case 128: return by_tile<Launch, float, 128>(a);
    case 1064: return by_tile<Launch, __nv_bfloat16, 64>(a);
    case 1128: return by_tile<Launch, __nv_bfloat16, 128>(a);
    case 2064: return by_tile<Launch, __half, 64>(a);
    case 2128: return by_tile<Launch, __half, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16; D in {64, 128}; blk a multiple of 8 in [8, 128] dividing T.
// idx / cnt: the row tables (K7, K8) or the column tables (K9), int32, `width` entries a row.
// Each returns cudaGetLastError() after its launch (or the error that stopped it) and does not
// synchronise.
//
// K7 also takes its unit table (int32 [n_units, 3 + 2 * 4]), its reduce table (int32
// [n_reduce, 3]) and an fp32 workspace of [BN, n_slots, blk, D + 2] (bf16 and fp16; fp32 ignores
// them), and writes the variant it launched to *variant: 0 the fp32 FMA kernel, 1 the
// tensor-core kernel (and its merge pass when n_reduce > 0).
extern "C" int block_sparse_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                                void* lse, const void* row_idx, const void* row_cnt, const void* units,
                                const void* reduce, void* ws, int n_units, int n_reduce, int n_slots,
                                int width, int BN, int T, int D, int blk, int causal, float scale,
                                void* stream, int* variant) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.out_lse = lse; a.idx = row_idx; a.cnt = row_cnt;
  a.units = units; a.reduce = reduce; a.ws = ws;
  a.n_units = n_units; a.n_reduce = n_reduce; a.n_slots = n_slots; a.variant = variant;
  a.width = width; a.BN = BN; a.T = T; a.blk = blk; a.causal = causal; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Fwd>(dtype, D, a);
}

extern "C" int block_sparse_dq(int dtype, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta, void* dq,
                               const void* row_idx, const void* row_cnt, int width, int BN, int T,
                               int D, int blk, int causal, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  a.idx = row_idx; a.cnt = row_cnt;
  a.width = width; a.BN = BN; a.T = T; a.blk = blk; a.causal = causal; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Dq>(dtype, D, a);
}

// K9 also takes the unit table (int32 [n_units, 3 + 2 * 4]), the reduce table (int32
// [n_reduce, 3]) and an fp32 workspace of [BN, n_slots, 2, blk, D] (bf16 and fp16; fp32 ignores
// them), and writes the variant it launched to *variant: 0 the fp32 FMA kernel, 1 the
// tensor-core kernel (and its reduction pass when n_reduce > 0).
extern "C" int block_sparse_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta, void* dk,
                                void* dv, const void* col_idx, const void* col_cnt, const void* units,
                                const void* reduce, void* ws, int n_units, int n_reduce, int n_slots,
                                int width, int BN, int T, int D, int blk, int causal, float scale,
                                void* stream, int* variant) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  a.idx = col_idx; a.cnt = col_cnt;
  a.units = units; a.reduce = reduce; a.ws = ws;
  a.n_units = n_units; a.n_reduce = n_reduce; a.n_slots = n_slots; a.variant = variant;
  a.width = width; a.BN = BN; a.T = T; a.blk = blk; a.causal = causal; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Dkv>(dtype, D, a);
}
