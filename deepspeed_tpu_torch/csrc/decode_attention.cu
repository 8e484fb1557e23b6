// Single-token decode attention for Hopper (sm_90a), plain C interface for
// ctypes: two kernels, one per cache layout.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/decode_attention.py:
//  * K6 _decode_kernel (pallas_call in _grouped_decode, entry decode_attention):
//    dense_decode_attention below, over a contiguous cache [B, S, NKV, D];
//  * K5 _paged_kernel (pallas_call in paged_decode_attention):
//    paged_decode_attention below, over a shared page pool [NP, NKV, P, D]
//    read through a page table [B, MAXP].
// Both compute the same function: row b's one query token (NH heads, q
// [B, NH, D]) attends to the keys kv_pos < kv_len[b]; query head h reads kv
// head h / (NH / NKV). q, k and v are read in their dtype and converted to
// fp32; scores, the softmax (finite NEG_INF = -1e30 masking) and P.V run in
// fp32 with the scale; the output is written in q's dtype. Rows with
// kv_len == 0 are written as exact zeros. K5 clamps page ids into [0, NP),
// so a -1 sentinel reads page 0, which the length then masks.
//
// What bounds it: memory. Each key row read (2 * D * dtype bytes of K and V)
// feeds 4 * D flops per query head, 4 * Hg * D per group: at Hg = 8 and bf16
// that is 8 flops per byte, far below the card's ~295 flops/byte balance
// point. The least time is the bytes of q, the output and the LIVE K/V rows
// (whole live pages for K5) over HBM bandwidth.
//
// What the design does about that:
//  * one block per (row, kv head, tile of up to QH = 8 query heads of that
//    kv head's group): the heads that share a kv head (GQA) sit in one block,
//    so each K/V row is read from HBM once per group (Hg <= 8), not once per
//    query head. The TPU kernel transposed the cache to [B*NKV, S, D] first;
//    here the block indexes the [B, S, NKV, D] layout directly;
//  * the block walks only the live keys, ceil(kv_len / KT) tiles; keys past
//    the row's length (and, for K5, pages past it) are never fetched;
//  * K/V are staged in shared memory a tile of KT = 4096 / D keys at a time
//    with 16-byte vector loads, and each key row is reused by all the
//    block's query heads.
// The TPU kernel carried m/l/acc across a sequential grid axis over cache
// blocks (K6) or table slots (K5); Hopper runs blocks in no order, so the
// walk is a loop inside the block, with the online-softmax state in shared
// memory and registers.
// Not done yet (later work): split-KV. At the dense generate shape (B = 16,
// NKV = 4) the grid is only B * NKV = 64 blocks for 132 SMs, and each block
// walks its keys serially; splitting the walk over blocks and merging the
// partial softmaxes fills the card. Also cp.async/TMA double buffering and
// tensor-core (wgmma) tiles. With Hg = 1 (MHA) seven of the QH query lanes
// of a block are idle.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int QH = 8;         // query heads per block
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

// Element offset of key position `pos` of kv head g in row r of a
// contiguous cache [B, S, NKV, D].
struct DenseRows {
  int S, NKV;
  __device__ __forceinline__ size_t operator()(int r, int g, int pos, int D) const {
    return (((size_t)r * S + pos) * NKV + g) * D;
  }
};

// The same through row r's page table into a pool [NP, NKV, P, D]; ids are
// clamped into [0, NP) (slots past MAXP read page 0).
struct PagedRows {
  const int* __restrict__ page_table;
  int NP, NKV, P, MAXP;
  __device__ __forceinline__ size_t operator()(int r, int g, int pos, int D) const {
    const int slot = pos / P;
    int pid = slot < MAXP ? page_table[(size_t)r * MAXP + slot] : 0;
    pid = min(max(pid, 0), NP - 1);
    return (((size_t)pid * NKV + g) * P + pos % P) * D;
  }
};

// One block: row r = blockIdx.z, kv head g = blockIdx.y, query heads
// h0 .. h0 + nq - 1 of that kv head's group (h0 = blockIdx.x * QH), over the
// keys 0 .. kv_len - 1.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_block(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, int kv_len, T* __restrict__ out,
                                             int NH, int NKV, float scale, const Rows& rows) {
  constexpr int KT = 4096 / D;            // keys per staged kv tile
  constexpr int ACC = QH * D / THREADS;   // output elements per thread
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  __shared__ float qs[QH][D];
  __shared__ float ks[KT][D + 1];         // +1: conflict-free column reads
  __shared__ float vs[KT][D];
  __shared__ float ps[QH][KT + 1];        // scores, then probabilities
  __shared__ float m_s[QH], l_s[QH], corr_s[QH];

  const int r = blockIdx.z;
  const int g = blockIdx.y;
  const int Hg = NH / NKV;
  const int h0 = blockIdx.x * QH;
  const int nq = min(QH, Hg - h0);
  const int tid = threadIdx.x;
  const size_t qbase = ((size_t)r * NH + g * Hg + h0) * D;

  if (tid < QH) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  if (kv_len > 0) {  // block-uniform
    for (int e = tid; e < QH * D; e += THREADS) {
      const int i = e / D, d = e % D;
      qs[i][d] = i < nq ? to_f32(q[qbase + (size_t)i * D + d]) : 0.f;
    }
    const int warp = tid / 32, lane = tid % 32;
    for (int base = 0; base < kv_len; base += KT) {
      const int nkeys = min(KT, kv_len - base);
      __syncthreads();  // the previous tile is consumed; q and m/l are written
      for (int c = tid; c < nkeys * D / VEC; c += THREADS) {
        const int e = c * VEC;
        const int row = e / D, col = e % D;
        const size_t off = rows(r, g, base + row, D) + col;
        const uint4 kr = __ldg(reinterpret_cast<const uint4*>(k + off));
        const uint4 vr = __ldg(reinterpret_cast<const uint4*>(v + off));
        const T* kv = reinterpret_cast<const T*>(&kr);
        const T* vv = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int t = 0; t < VEC; ++t) {
          ks[row][col + t] = to_f32(kv[t]);
          vs[row][col + t] = to_f32(vv[t]);
        }
      }
      __syncthreads();
      // scores: entries past the tile's keys or the block's heads hold NEG_INF
      for (int e = tid; e < QH * KT; e += THREADS) {
        const int i = e / KT, j = e % KT;
        float s = NEG_INF;
        if (i < nq && j < nkeys) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qs[i][d] * ks[j][d];
          s = dot * scale;
        }
        ps[i][j] = s;
      }
      __syncthreads();
      // online softmax, one warp per query head; a masked entry contributes
      // p = 0 even while the running max is still NEG_INF
      for (int i = warp; i < QH; i += THREADS / 32) {
        float mx = NEG_INF;
        for (int j = lane; j < KT; j += 32) mx = fmaxf(mx, ps[i][j]);
        mx = warp_max(mx);
        const float m_prev = m_s[i];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = lane; j < KT; j += 32) {
          const float p = (i < nq && j < nkeys) ? expf(ps[i][j] - m_new) : 0.f;
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
        float val = acc[a] * corr_s[i];
        for (int j = 0; j < nkeys; ++j) val += ps[i][j] * vs[j][d];
        acc[a] = val;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * THREADS;
    const int i = e / D, d = e % D;
    if (i < nq) {
      const float l = l_s[i];
      out[qbase + (size_t)i * D + d] = from_f32<T>(acc[a] / (l == 0.f ? 1.f : l));
    }
  }
}

// K6: the contiguous cache.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int* __restrict__ kv_lens,
                    T* __restrict__ out, int NH, int NKV, int S, float scale) {
  const int kv_len = min(max(kv_lens[blockIdx.z], 0), S);
  decode_block<T, D>(q, k_cache, v_cache, kv_len, out, NH, NKV, scale, DenseRows{S, NKV});
}

// K5: the page pool through the page table.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens, T* __restrict__ out, int NH, int NKV,
                    int NP, int P, int MAXP, float scale) {
  const int kv_len = min(max(kv_lens[blockIdx.z], 0), MAXP * P);
  decode_block<T, D>(q, k_pages, v_pages, kv_len, out, NH, NKV, scale,
                     PagedRows{page_table, NP, NKV, P, MAXP});
}

dim3 grid_of(int B, int NH, int NKV) {
  const int Hg = NH / NKV;
  return dim3((Hg + QH - 1) / QH, NKV, B);
}

template <typename T>
int dense_launch(int D, const void* q, const void* k, const void* v, const void* kv_lens, void* out,
                 int B, int NH, int NKV, int S, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lens = static_cast<const int*>(kv_lens);
  T* o = static_cast<T*>(out);
  if (D == 64)
    dense_decode_kernel<T, 64><<<grid_of(B, NH, NKV), THREADS, 0, stream>>>(qt, kt, vt, lens, o, NH, NKV, S, scale);
  else if (D == 128)
    dense_decode_kernel<T, 128><<<grid_of(B, NH, NKV), THREADS, 0, stream>>>(qt, kt, vt, lens, o, NH, NKV, S, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int paged_launch(int D, const void* q, const void* k, const void* v, const void* page_table,
                 const void* kv_lens, void* out, int B, int NH, int NKV, int NP, int P, int MAXP,
                 float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(kv_lens);
  T* o = static_cast<T*>(out);
  if (D == 64)
    paged_decode_kernel<T, 64><<<grid_of(B, NH, NKV), THREADS, 0, stream>>>(qt, kt, vt, pt, lens, o, NH, NKV,
                                                                            NP, P, MAXP, scale);
  else if (D == 128)
    paged_decode_kernel<T, 128><<<grid_of(B, NH, NKV), THREADS, 0, stream>>>(qt, kt, vt, pt, lens, o, NH, NKV,
                                                                             NP, P, MAXP, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

bool bad_heads(int B, int NH, int NKV, int D) {
  return B <= 0 || NKV <= 0 || NH <= 0 || NH % NKV != 0 || (D != 64 && D != 128) || B > 65535 ||
         NKV > 65535;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Each returns the launch's
// cudaError_t (0 = launched); neither synchronises.

// K6: q [B, NH, D], k_cache / v_cache [B, S, NKV, D], kv_lens [B] int32,
// out [B, NH, D].
extern "C" int dense_decode_attention(int dtype, const void* q, const void* k_cache,
                                      const void* v_cache, const void* kv_lens, void* out, int B,
                                      int NH, int NKV, int S, int D, float scale, void* stream) {
  if (bad_heads(B, NH, NKV, D) || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dense_launch<float>(D, q, k_cache, v_cache, kv_lens, out, B, NH, NKV, S, scale, s);
    case 1:
      return dense_launch<__nv_bfloat16>(D, q, k_cache, v_cache, kv_lens, out, B, NH, NKV, S, scale, s);
    case 2:
      return dense_launch<__half>(D, q, k_cache, v_cache, kv_lens, out, B, NH, NKV, S, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5: q [B, NH, D], k_pages / v_pages [NP, NKV, P, D], page_table [B, MAXP]
// int32, kv_lens [B] int32, out [B, NH, D].
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pages,
                                      const void* v_pages, const void* page_table,
                                      const void* kv_lens, void* out, int B, int NH, int NKV,
                                      int NP, int P, int D, int MAXP, float scale, void* stream) {
  if (bad_heads(B, NH, NKV, D) || NP <= 0 || P <= 0 || MAXP <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return paged_launch<float>(D, q, k_pages, v_pages, page_table, kv_lens, out, B, NH, NKV, NP, P,
                                 MAXP, scale, s);
    case 1:
      return paged_launch<__nv_bfloat16>(D, q, k_pages, v_pages, page_table, kv_lens, out, B, NH, NKV,
                                         NP, P, MAXP, scale, s);
    case 2:
      return paged_launch<__half>(D, q, k_pages, v_pages, page_table, kv_lens, out, B, NH, NKV, NP, P,
                                  MAXP, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
