// Ragged paged attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel deepspeed_tpu/ops/transformer/decode_attention.py:
// _ragged_kernel (pallas_call in ragged_paged_attention). It computes the
// same function: for row r of a [R, W] token window, query slot w sits at
// absolute position q_pos = kv_len[r] - q_len[r] + w and attends to the keys
// kv_pos <= q_pos with kv_pos < kv_len[r], read through the row's page table
// out of a shared pool [NP, NKV, P, D]. q/k/v are read in their dtype and
// converted to fp32; scores, the softmax (finite NEG_INF = -1e30 masking) and
// P.V accumulate in fp32 with the scale; the output is written in q's dtype.
// Rows with kv_len == 0, and window slots w >= q_len, are written as zeros.
//
// What bounds it: memory. Per query it does 2*D flops for every key byte
// pair it reads, far below the card's ~295 flops/byte balance point, so the
// least time is the bytes of q, the output and the LIVE K/V pages over HBM
// bandwidth.
//
// What the design does about that:
//  * one block per (row, kv head, tile of QT slots of the W-major [W*Hg]
//    query group): the Hg query heads that share a kv head (GQA) are in the
//    same block, so each K/V page of that kv head is read from HBM once per
//    tile, not once per query head;
//  * the block walks only the pages it needs: ceil(kv_hi / P) of them, where
//    kv_hi = min(kv_len, last live q_pos of the tile + 1); pages past the
//    row's length are never fetched, and page ids are clamped into [0, NP)
//    as the TPU kernel's index map does;
//  * K/V are staged in shared memory a tile of KT = 4096/D keys at a time
//    (any page size: a tile may span pages or cover part of one) with
//    16-byte vector loads, and each key row is reused by all QT queries.
// The TPU kernel carried m/l/acc across a sequential grid axis; Hopper runs
// blocks in no order, so the page walk is a loop inside the block instead,
// with the online-softmax state in shared memory and registers.
// Not done yet (later work): split-KV for the small decode grid (R*NKV
// blocks at W=1), cp.async/TMA double buffering, tensor-core (wgmma) tiles.
// Known costs of the QT-slot tiling: at W=1 with Hg=8 half of each block's
// QT query lanes are empty; at W=32 with Hg=8 a row has ceil(W*Hg/QT) = 16
// tiles per kv head, and each walks the row's K/V up to its own kv_hi, so a
// prefill row reads its K/V about 16 times where the bound counts once. A
// block covering a row's whole live window per kv head removes both.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int QT = 16;        // query slots per block
constexpr int THREADS = 128;  // four warps

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
ragged_paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages, const int* __restrict__ page_table,
                              const int* __restrict__ kv_lens, const int* __restrict__ q_lens,
                              T* __restrict__ out, int W, int NH, int NKV, int NP, int P,
                              int MAXP, float scale) {
  constexpr int KT = 4096 / D;            // keys per staged kv tile
  constexpr int ACC = QT * D / THREADS;   // output elements per thread
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  __shared__ float qs[QT][D];
  __shared__ float ks[KT][D + 1];         // +1: conflict-free column reads
  __shared__ float vs[KT][D];
  __shared__ float ps[QT][KT + 1];        // scores, then probabilities
  __shared__ float m_s[QT], l_s[QT], corr_s[QT];

  const int r = blockIdx.z;
  const int g = blockIdx.y;
  const int Hg = NH / NKV;
  const int Wq = W * Hg;
  const int row0 = blockIdx.x * QT;
  const int kv_len = kv_lens[r];
  const int q_len = q_lens[r];
  const int start = kv_len - q_len;  // the row's write base
  const int tid = threadIdx.x;

  // window slots of this tile are w_lo .. w_last; live ones stop at q_len
  const int w_lo = row0 / Hg;
  const int w_hi = kv_len > 0 ? min((min(row0 + QT, Wq) - 1) / Hg, q_len - 1) : -1;

  if (tid < QT) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  if (w_hi >= w_lo) {  // block-uniform: the tile holds at least one live slot
    // the keys any live slot of the tile can see
    const int kv_hi = min(kv_len, start + w_hi + 1);
    for (int e = tid; e < QT * D; e += THREADS) {
      const int i = e / D, d = e % D;
      const int flat = row0 + i, w = flat / Hg;
      float val = 0.f;
      if (flat < Wq && w < q_len) {
        const int h = g * Hg + flat % Hg;
        val = to_f32(q[(((size_t)r * W + w) * NH + h) * D + d]);
      }
      qs[i][d] = val;
    }
    const int warp = tid / 32, lane = tid % 32;
    for (int base = 0; base < kv_hi; base += KT) {
      const int nkeys = min(KT, kv_hi - base);
      __syncthreads();  // the previous tile is consumed; q and m/l are written
      for (int v = tid; v < nkeys * D / VEC; v += THREADS) {
        const int e = v * VEC;
        const int row = e / D, col = e % D;
        const int slot = (base + row) / P;
        int pid = slot < MAXP ? page_table[(size_t)r * MAXP + slot] : 0;
        pid = min(max(pid, 0), NP - 1);
        const size_t off = (((size_t)pid * NKV + g) * P + (base + row) % P) * D + col;
        const uint4 kr = __ldg(reinterpret_cast<const uint4*>(k_pages + off));
        const uint4 vr = __ldg(reinterpret_cast<const uint4*>(v_pages + off));
        const T* kv = reinterpret_cast<const T*>(&kr);
        const T* vv = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int t = 0; t < VEC; ++t) {
          ks[row][col + t] = to_f32(kv[t]);
          vs[row][col + t] = to_f32(vv[t]);
        }
      }
      __syncthreads();
      // scores: masked entries hold NEG_INF
      for (int e = tid; e < QT * KT; e += THREADS) {
        const int i = e / KT, j = e % KT;
        const int flat = row0 + i, w = flat / Hg;
        const int kv_pos = base + j;
        const bool live = flat < Wq && w < q_len && j < nkeys && kv_pos <= start + w && kv_pos < kv_len;
        float s = NEG_INF;
        if (live) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qs[i][d] * ks[j][d];
          s = dot * scale;
        }
        ps[i][j] = s;
      }
      __syncthreads();
      // online softmax, one warp per query slot. A masked entry contributes
      // p = 0 even while the running max is still NEG_INF, so a tile whose
      // keys are all masked for a slot never turns exp(m - m) into ones.
      for (int i = warp; i < QT; i += THREADS / 32) {
        const int flat = row0 + i, w = flat / Hg;
        float mx = NEG_INF;
        for (int j = lane; j < KT; j += 32) mx = fmaxf(mx, ps[i][j]);
        mx = warp_max(mx);
        const float m_prev = m_s[i];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = lane; j < KT; j += 32) {
          const int kv_pos = base + j;
          const bool live = flat < Wq && w < q_len && j < nkeys && kv_pos <= start + w && kv_pos < kv_len;
          const float p = live ? expf(ps[i][j] - m_new) : 0.f;
          ps[i][j] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          corr_s[i] = corr;
          l_s[i] = l_s[i] * corr + sum;
          m_s[i] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * corr + P.V over the tile's keys
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int e = tid + a * THREADS;
        const int i = e / D, d = e % D;
        float v = acc[a] * corr_s[i];
        for (int j = 0; j < nkeys; ++j) v += ps[i][j] * vs[j][d];
        acc[a] = v;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * THREADS;
    const int i = e / D, d = e % D;
    const int flat = row0 + i;
    if (flat < Wq) {
      const int w = flat / Hg, h = g * Hg + flat % Hg;
      const float l = l_s[i];
      out[(((size_t)r * W + w) * NH + h) * D + d] = from_f32<T>(acc[a] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
           const void* kv_lens, const void* q_lens, void* out, int R, int W, int NH, int NKV,
           int NP, int P, int MAXP, float scale, cudaStream_t stream) {
  const int Hg = NH / NKV;
  dim3 grid((W * Hg + QT - 1) / QT, NKV, R);
  ragged_paged_attention_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<T*>(out), W, NH, NKV, NP, P, MAXP, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int D, const void* q, const void* k_pages, const void* v_pages,
               const void* page_table, const void* kv_lens, const void* q_lens, void* out, int R,
               int W, int NH, int NKV, int NP, int P, int MAXP, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k_pages, v_pages, page_table, kv_lens, q_lens, out, R, W, NH, NKV, NP,
                         P, MAXP, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k_pages, v_pages, page_table, kv_lens, q_lens, out, R, W, NH, NKV,
                          NP, P, MAXP, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns the launch's cudaError_t
// (0 = launched); does not synchronise.
extern "C" int ragged_paged_attention(int dtype, const void* q, const void* k_pages,
                                      const void* v_pages, const void* page_table,
                                      const void* kv_lens, const void* q_lens, void* out, int R,
                                      int W, int NH, int NKV, int NP, int P, int D, int MAXP,
                                      float scale, void* stream) {
  if (R <= 0 || W <= 0 || NKV <= 0 || NH % NKV != 0 || P <= 0 || NP <= 0 || MAXP <= 0 ||
      (D != 64 && D != 128) || R > 65535 || NKV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dim<float>(D, q, k_pages, v_pages, page_table, kv_lens, q_lens, out, R, W, NH,
                               NKV, NP, P, MAXP, scale, s);
    case 1:
      return launch_dim<__nv_bfloat16>(D, q, k_pages, v_pages, page_table, kv_lens, q_lens, out, R,
                                       W, NH, NKV, NP, P, MAXP, scale, s);
    case 2:
      return launch_dim<__half>(D, q, k_pages, v_pages, page_table, kv_lens, q_lens, out, R, W, NH,
                                NKV, NP, P, MAXP, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
