// Ragged mixed-phase paged attention for Hopper (sm_90a), bound through a
// plain C entry point (mcpx_ragged_paged_attention) loaded with ctypes.
//
// Replaces the Pallas TPU kernel mcpx/engine/kernels/paged_attention.py
// (_ragged_kernel, launched by ragged_paged_attention). Same contract:
//   q        [B, S, K, G, hd]   padded query windows (bf16 or fp32)
//   pools    [K, L, N, Psz, hd] every layer's pages, kv-head major
//   page_table [B, Pmax] int32, start_pos [B] int32, q_lens [B] int32
//   out      [B, S, K, G, hd]   in q's dtype
// Row b's query i < q_lens[b] attends cache positions < start_pos[b]+i+1 of
// layer `layer`; the row streams n = min(cdiv(start+q_len, Psz), Pmax) pages
// (zero for an idle row). Pad queries (i >= q_len) and idle rows write exact
// zeros: the same NEG_INF masking, the same `s <= NEG_INF/2 -> p = 0` guard
// and the same `l > 0` select as the TPU kernel. Logits, softmax and the
// accumulator are fp32; scale is 1/sqrt(hd).
//
// Design. One block per (row b, kv-head kh); the TPU grid's sequential page
// axis becomes a loop inside the block. Each page's K and V tiles [Psz, hd]
// are staged in shared memory (K with an odd word stride, so the 32 lanes of
// a warp reading 32 different positions hit 32 different banks); the live
// query rows (q_len*G of them, the GQA group folded into the rows) sit in
// shared memory as fp32; per-row running max m, sum l and rescale factor
// live in shared memory; the [rows, hd] fp32 accumulator lives in
// registers, at most 64 values a thread. Rows past q_len*G are never
// computed, so a decode row costs G query rows, not S*G.
//
// What bounds it on the H100: it is bandwidth-bound. The least time is
//   bytes / 3.35 TB/s, bytes = sum over live rows of
//   n_pages * Psz * hd * 2 (K and V) * sizeof(elt) + q bytes + out bytes.
// This simple version does not reach that bound: at the serving shapes only
// B*K blocks exist (64 at batch 64 with one kv head) for 132 SMs, each block
// loads a page and then computes on it with no overlap, and the scores and
// P@V run on CUDA cores. Left for a later change: split each row's page
// range across blocks and merge the partial softmax states (flash-decoding),
// double-buffer the tiles with cp.async or TMA, and move the two products to
// tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;  // S * G
constexpr int kMaxHd = 256;
constexpr int kAccPerThread = kMaxRows * kMaxHd / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// K tile in shared memory as 32-bit words with an odd row stride.
template <typename T>
struct KTile;

template <>
struct KTile<float> {
  __host__ __device__ static int stride(int hd) { return hd + 1; }
  __device__ static float2 pair(const uint32_t* ks, int p, int d, int st) {
    const uint32_t* w = ks + p * st + d;
    return make_float2(__uint_as_float(w[0]), __uint_as_float(w[1]));
  }
};

template <>
struct KTile<__nv_bfloat16> {
  __host__ __device__ static int stride(int hd) { return hd / 2 + 1; }
  __device__ static float2 pair(const uint32_t* ks, int p, int d, int st) {
    uint32_t w = ks[p * st + d / 2];
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
    return __bfloat1622float2(h);
  }
};

struct Layout {
  size_t q, p, m, l, a, k, v, total;  // byte offsets into dynamic shared memory
};

__host__ __device__ inline size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

__host__ __device__ inline Layout smem_layout(int rows, int hd, int psz, int elt, int kstride) {
  Layout s;
  const size_t rp = round_up(rows, 4);
  s.q = 0;
  s.p = s.q + sizeof(float) * rp * hd;
  s.m = s.p + sizeof(float) * rp * psz;
  s.l = s.m + sizeof(float) * rp;
  s.a = s.l + sizeof(float) * rp;
  s.k = s.a + sizeof(float) * rp;
  s.v = round_up(s.k + sizeof(uint32_t) * (size_t)psz * kstride, 16);
  s.total = s.v + (size_t)elt * psz * hd;
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ragged_paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages, const int* __restrict__ page_table,
                              const int* __restrict__ start_pos, const int* __restrict__ q_lens,
                              T* __restrict__ out, int S, int K, int G, int hd, int L, int N,
                              int psz, int pmax, int layer) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int rows = S * G;
  const int kstride = KTile<T>::stride(hd);
  const Layout lay = smem_layout(rows, hd, psz, (int)sizeof(T), kstride);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* a_s = reinterpret_cast<float*>(smem + lay.a);
  uint32_t* k_s = reinterpret_cast<uint32_t*>(smem + lay.k);
  T* v_s = reinterpret_cast<T*>(smem + lay.v);

  const int start = start_pos[b];
  const int qn = min(max(q_lens[b], 0), S);
  const int live = qn * G;  // query rows that attend; the rest output zeros
  const int n_pages = qn > 0 ? min((start + qn + psz - 1) / psz, pmax) : 0;
  const float scale = rsqrtf((float)hd);

  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int e = tid; e < live * hd; e += kThreads) {
    const int r = e / hd, d = e - (e / hd) * hd;
    const int s = r / G, g = r - (r / G) * G;
    q_s[e] = to_f32(q[((((size_t)b * S + s) * K + kh) * G + g) * hd + d]);
  }

  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;

  const int row_words = hd * (int)sizeof(T) / 4;  // 32-bit words in one position
  const int row_vec = row_words / 4;              // 16-byte vectors in one position
  const int warp = tid / 32, lane = tid % 32;

  for (int i = 0; i < n_pages; ++i) {
    __syncthreads();  // the previous page's tiles and probabilities are consumed
    const int page = page_table[b * pmax + i];
    const size_t base = (((size_t)kh * L + layer) * N + page) * (size_t)psz * hd;
    const uint4* kg = reinterpret_cast<const uint4*>(k_pages + base);
    const uint4* vg = reinterpret_cast<const uint4*>(v_pages + base);
    uint4* vs4 = reinterpret_cast<uint4*>(v_s);
    for (int e = tid; e < psz * row_vec; e += kThreads) {
      const int p = e / row_vec, c = e - (e / row_vec) * row_vec;
      const uint4 kv = kg[e];
      uint32_t* dst = k_s + p * kstride + c * 4;
      dst[0] = kv.x;
      dst[1] = kv.y;
      dst[2] = kv.z;
      dst[3] = kv.w;
      vs4[e] = vg[e];
    }
    __syncthreads();

    // Scores, masked: query row r (query r/G) sees positions < start + r/G + 1.
    for (int e = tid; e < live * psz; e += kThreads) {
      const int r = e / psz, p = e - (e / psz) * psz;
      const float* qr = q_s + r * hd;
      float s = 0.f;
      for (int d = 0; d < hd; d += 2) {
        const float2 kk = KTile<T>::pair(k_s, p, d, kstride);
        const float2 qq = *reinterpret_cast<const float2*>(qr + d);
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
      }
      const int pos = i * psz + p;
      p_s[r * psz + p] = pos < start + r / G + 1 ? s * scale : kNegInf;
    }
    __syncthreads();

    // Online softmax, one warp per query row.
    for (int r = warp; r < live; r += kThreads / 32) {
      float* pr = p_s + r * psz;
      float mx = kNegInf;
      for (int p = lane; p < psz; p += 32) mx = fmaxf(mx, pr[p]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int p = lane; p < psz; p += 32) {
        const float sv = pr[p];
        const float pv = sv <= kNegInf * 0.5f ? 0.f : expf(sv - m_new);
        pr[p] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r, d] = acc[r, d] * alpha[r] + sum_p P[r, p] * V[p, d]
#pragma unroll
    for (int j = 0; j < kAccPerThread; ++j) {
      const int e = tid + j * kThreads;
      if (e < live * hd) {
        const int r = e / hd, d = e - (e / hd) * hd;
        const float* pr = p_s + r * psz;
        float a = acc[j] * a_s[r];
        for (int p = 0; p < psz; ++p) a = fmaf(pr[p], to_f32(v_s[p * hd + d]), a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e < rows * hd) {
      const int r = e / hd, d = e - (e / hd) * hd;
      const int s = r / G, g = r - (r / G) * G;
      const float l = r < live ? l_s[r] : 0.f;
      const float o = l > 0.f ? acc[j] / fmaxf(l, 1e-30f) : 0.f;
      out[((((size_t)b * S + s) * K + kh) * G + g) * hd + d] = from_f32<T>(o);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
           const void* start_pos, const void* q_lens, void* out, int B, int S, int K, int G,
           int hd, int L, int N, int psz, int pmax, int layer, cudaStream_t stream) {
  const Layout lay = smem_layout(S * G, hd, psz, (int)sizeof(T), KTile<T>::stride(hd));
  cudaError_t err = cudaFuncSetAttribute(ragged_paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  ragged_paged_attention_kernel<T><<<dim3(B, K), kThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(start_pos),
      static_cast<const int*>(q_lens), static_cast<T*>(out), S, K, G, hd, L, N, psz, pmax, layer);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses shapes above
// the card's per-block limit before launching.
size_t mcpx_ragged_paged_attention_smem(int S, int G, int hd, int psz, int dtype) {
  const int elt = dtype == 1 ? 2 : 4;
  const int kstride = dtype == 1 ? KTile<__nv_bfloat16>::stride(hd) : KTile<float>::stride(hd);
  return smem_layout(S * G, hd, psz, elt, kstride).total;
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched). Enqueues on `stream`; does not synchronise.
int mcpx_ragged_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                const void* page_table, const void* start_pos,
                                const void* q_lens, void* out, int B, int S, int K, int G,
                                int hd, int L, int N, int psz, int pmax, int layer, int dtype,
                                void* stream) {
  if (B == 0 || K == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, start_pos, q_lens, out, B, S,
                                 K, G, hd, L, N, psz, pmax, layer, st);
  return launch<float>(q, k_pages, v_pages, page_table, start_pos, q_lens, out, B, S, K, G, hd,
                       L, N, psz, pmax, layer, st);
}

}  // extern "C"
