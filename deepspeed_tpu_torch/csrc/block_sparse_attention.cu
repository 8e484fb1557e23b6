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
// Numerics are the Pallas kernels', not the flash kernels': q, k, v and dO are widened to fp32
// and every product (Q K^T, P V, dO V^T, dS K, P^T dO, dS^T Q) runs in fp32 with P and dS kept in
// fp32; only the outputs are rounded to the inputs' dtype. Scores are scaled after the product;
// the causal mask inside a pair (row >= column, global positions) uses the finite
// NEG_INF = -1e30, and a masked probability is set to exactly 0, so a row with no live score
// (no listed block, or every listed pair causally dead) ends with l = 0: O = 0 and
// LSE = NEG_INF, and its dQ is exactly 0.
//
// What bounds it: at BERT-large width (D = 64, blocks of 16, 67 live blocks a row at T = 4096)
// each call does 2-4 products of 2 D operations per live (query, key) pair over about 5-7
// operand-sized reads, so the tensor-core rate bounds it (K7 ~0.036 ms at B = 2, NH = 16 in
// bf16). This first version multiplies with fp32 FMAs on the CUDA cores out of shared memory, as
// the port's flash kernels do, so it sits well above that bound; it is written to be right
// first, for fp32, bf16 and fp16 inputs.
//
// What the design does about the TPU kernels' shape. The Pallas kernels walk a padded list on a
// sequential grid axis (q block, list step), skip padded steps with pl.when and carry m/l/acc
// (or dQ, dK/dV) in VMEM scratch. Here:
//  * one thread block per (b*h, q tile) walks exactly row_cnt[qi] entries of its row list (K7,
//    K8), or per (b*h, k tile) exactly col_cnt[ki] entries of its column list (K9): no padded
//    steps, and the running state stays in registers and shared memory;
//  * a block of `blk` rows (any multiple of 8 up to 128) is cut into tiles of TB = 16 rows
//    (blk < 64) or TB = 64 rows (blk >= 64); the last tile of a block may be partial and is
//    masked. Query (K7, K8) or key (K9) tiles of one block are separate thread blocks; the other
//    side's tiles are walked inside the listed block. So blocks of 16 (the configs' default)
//    waste no lanes, and blocks of 64 (the bench) get the flash kernels' 64 x 64 tiles;
//  * under the causal mask a key tile that starts past the q tile's last row (K7, K8), or a
//    q tile that ends before the k tile's first key (K9), is skipped: it holds no live score;
//  * K9 owns its dK and dV rows, so there are no atomics and the result is deterministic. Its
//    load is uneven by design: a global key column lists every q block (256 at T = 4096) while a
//    local one lists 4, and the heavy thread blocks set the launch's length;
//  * 256 threads hold a (TB/16) x (TB/16) register tile of every TB x TB score tile (rows
//    ty + 16 i, columns tx + 16 j), so a row's softmax reduction is a 16-lane shuffle, and the
//    same rows of the output accumulator, so the online-softmax rescale needs no shared memory;
//  * shared-memory rows are padded by one float, so row-wise and column-wise reads are free of
//    bank conflicts.
// Not done yet (later work): tensor-core tiles (mma.sync / wgmma), cp.async / TMA staging of the
// listed blocks, several heads per thread block for the 16-row tiles, and an ordering of K9's
// thread blocks that starts the heavy columns first.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int D, int TB>
struct Fwd {
  static int run(const Args& a) {
    const size_t smem = smem_bytes<D, TB>(3, 1, 0);
    auto kernel = sparse_fwd_kernel<T, D, TB>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid_of<TB>(a), THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<T*>(a.o), static_cast<float*>(a.out_lse), static_cast<const int*>(a.idx),
        static_cast<const int*>(a.cnt), a.width, a.T, a.blk, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
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

template <typename T, int D, int TB>
struct Dkv {
  static int run(const Args& a) {
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
    return static_cast<int>(cudaGetLastError());
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
extern "C" int block_sparse_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                                void* lse, const void* row_idx, const void* row_cnt, int width,
                                int BN, int T, int D, int blk, int causal, float scale,
                                void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.out_lse = lse; a.idx = row_idx; a.cnt = row_cnt;
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

extern "C" int block_sparse_dkv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta, void* dk,
                                void* dv, const void* col_idx, const void* col_cnt, int width,
                                int BN, int T, int D, int blk, int causal, float scale,
                                void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dk = dk; a.dv = dv;
  a.idx = col_idx; a.cnt = col_cnt;
  a.width = width; a.BN = BN; a.T = T; a.blk = blk; a.causal = causal; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Dkv>(dtype, D, a);
}
