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
// layer `layer`, through position min(start+q_len, Pmax*Psz) at most. Pad
// queries (i >= q_len) and idle rows write exact zeros: the same NEG_INF
// masking, the same `s <= NEG_INF/2 -> p = 0` guard and the same `l > 0`
// select as the TPU kernel. Logits, softmax and the accumulator are fp32;
// scale is 1/sqrt(hd).
//
// What bounds it on the H100. The least time is bytes / 3.35 TB/s: each
// live row's visible K and V positions once, plus q and out. The products
// need far fewer operations than the tensor cores could do in that time
// (2b shape: 3.8 us of bytes against 0.26 us of bf16 operations). At the
// serving shapes, though, a launch moves only a few MB over few live rows,
// so what sets its time is the longest dependent chain of one block: page
// lookups, copy latency, the products of its tiles, the softmax, and the
// merge. One block per (row, kv-head) would leave most SMs idle on a batch
// with few live rows, and products on CUDA cores out of shared memory cost
// two shared loads per FMA. The design shortens the chain:
//   * Query tiles. A window's S*G query rows (the GQA group folded in) are
//     cut into tiles of kMaxRows = 64 rows, so one launch serves any window
//     the reference kernel does: decode and fast-forward windows are one
//     tile, a suffix prefill at S = 256, G = 8 is 32. Each tile sees only
//     positions below start + (its last live query) + 1, so the causal
//     rule skips whole chunks for the early tiles of a prefill row.
//   * Split positions (flash-decoding). The grid is (B*K*n_tiles, n_split).
//     Block c of a live tile attends positions [c*span, (c+1)*span), span
//     a multiple of kChunk; a block past the tile's last visible position
//     computes nothing. Short spans keep each block's chain short: at 2b
//     width a 64-row tile over 256 positions is about 17 MFLOP, tens of
//     microseconds for one SM's mma.sync, and even at the test width a
//     block walking a whole row pays a dependent chain of address math and
//     softmax per tile. The split count falls as the tiles alone fill the
//     card (about two blocks an SM): n_split = cdiv(Pmax*Psz, span) with
//     span the least multiple of kChunk that keeps B*K*n_tiles*n_split
//     near 2 * SMs, never above cdiv(Pmax*Psz, kChunk) splits. Decode
//     windows (one tile a row) keep one split per kChunk; a wide prefill
//     cohort falls to one split, which also bounds the fp32 scratch to
//     twice the output. Tile and split counts depend on shapes (and the
//     card's SM count) only, so one launch serves any phase mix.
//   * Combine in the same launch. Block 0 writes the zeros of an idle row's
//     tiles and of tiles that hold only pads. Each block of a live tile
//     with work writes its partial (m, l, unnormalised acc) in fp32 to
//     scratch, fences, and takes a ticket on the tile's counter; every
//     block of the tile takes one, empty ones too. The block that draws the
//     last ticket merges the partials in split order (so the output does
//     not depend on block timing), writes the tile's rows (zeros for pads)
//     and resets the counter to 0. It keeps 16 loads of the partials in
//     flight a thread, since one block reads them all. The counters assume
//     that launches sharing them run one after another, so the wrapper
//     keeps one buffer per stream. A second combine launch would cost host
//     time per layer on an engine the host already holds back.
//   * Asynchronous copies. The block computes its positions' pool offsets
//     once, a thread a position, from the page table. K and V arrive by
//     cp.async.cg (16 B a lane, a warp a position, zero-filled past the
//     visible end) into a ring of two stages of kTile positions: both are
//     in flight at once, and a stage is refilled with the tile after next
//     as soon as it has been computed, so a copy lands while the tile
//     before it is computed. q is loaded once per block. Tiles are
//     XOR-swizzled in 16-byte chunks so that ldmatrix and 128-bit loads
//     read without bank conflicts.
//   * Tensor cores (bf16). Both products run as mma.sync m16n8k16 with
//     fragments from ldmatrix (.trans for V) and fp32 accumulators in
//     registers. The live query rows (q_len*G) are padded up to a multiple
//     of 16 and never stored past q_len*G; the mask and the online softmax
//     run on the accumulator fragments. P is rounded to bf16 for P.V, as
//     the plain version rounds its weights to V's type. A head_dim with
//     hd % 16 == 8 is zero-padded in shared memory to a whole k-step.
//     A warp takes a 16-row tile whole (scores, softmax, and up to 128
//     head_dim columns of P.V); two warps share it at hd 256. Redundant
//     scores cost more than idle warps: the time of a tile is the
//     instruction time of the warps that run it.
//     mma.sync rather than wgmma: the work is bound by bytes, and wgmma's
//     64-row tiles would waste 7/8 of each tile on decode rows.
//   * fp32 keeps its products on CUDA cores (no TF32), so it matches the
//     plain fp32 version to summation order; it shares the split, the
//     combine and the copy pipeline.
//   * The launch attribute for dynamic shared memory is set once per
//     instantiation and size, not on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;  // query rows in one tile (a block's rows)
constexpr int kMaxHd = 256;
constexpr int kChunk = 64;  // split spans are multiples of this many positions
constexpr int kTile = 32;   // positions in one pipeline stage
constexpr int kStages = 2;  // stages in the ring
// bf16: a warp holds at most kPairs 16-column pairs of head_dim, and a
// wider head_dim is shared by two warps (at most 4 row tiles, so 8 warps
// do). Two builds: kNarrowPairs for head_dim up to 128, within 128
// registers so two blocks share an SM, and kWidePairs up to 256, whose
// 64-value accumulator would spill under that cap.
constexpr int kNarrowPairs = 4;
constexpr int kWidePairs = 8;
constexpr int kAccF32 = kMaxRows * kMaxHd / kThreads;     // fp32: acc values a thread holds
constexpr float kNegInf = -1e30f;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// Byte offsets into dynamic shared memory. Rows are padded to 16 (one mma
// tile); bf16 rows pad head_dim to a whole k-step of 16.
struct Layout {
  size_t off, q, k, v, p, m, l, a, w, total;
  int rows, hdp, rc;  // padded rows, padded head_dim, 16-byte chunks a row
  int sh;             // swizzle shift: log2 of the rows one 128-byte line holds
};

// rows: a tile's query rows; span: the positions one split attends.
__host__ __device__ inline Layout smem_layout(int rows, int hd, int nsplit, int span, int elt) {
  Layout s;
  s.rows = (int)round_up(rows, 16);
  s.hdp = elt == 2 ? (int)round_up(hd, 16) : hd;
  s.rc = s.hdp * elt / 16;
  s.sh = s.rc == 1 ? 3 : s.rc == 2 ? 2 : s.rc == 4 ? 1 : 0;
  s.off = 0;  // pool offset (in elements) of each of the block's positions
  s.q = sizeof(long long) * span;
  s.k = s.q + (size_t)elt * s.rows * s.hdp;
  s.v = s.k + (size_t)elt * kStages * kTile * s.hdp;
  s.p = s.v + (size_t)elt * kStages * kTile * s.hdp;
  size_t end = s.p;
  if (elt == 4) {  // fp32: scores, running max, sum and rescale in shared memory
    s.m = s.p + sizeof(float) * s.rows * kTile;
    s.l = s.m + sizeof(float) * s.rows;
    s.a = s.l + sizeof(float) * s.rows;
    end = s.a + sizeof(float) * s.rows;
  } else {
    s.m = s.l = s.a = end;
  }
  // The merge's per-split max, sum and weight and per-row sums reuse the tiles.
  s.w = s.k;
  const size_t wend = s.w + sizeof(float) * s.rows * (3 * nsplit + 1);
  s.total = end > wend ? end : wend;
  return s;
}

// Chunk c of row r in a tile of rc chunks a row, as a chunk index: the
// flattened index with its low 3 bits XORed by the row's 128-byte line
// number (row >> sh). Rows of a multiple of 8 chunks and rows of 1, 2 or 4
// chunks put 8 consecutive rows at one chunk in 8 different bank groups;
// other widths stay a permutation of the tile (whose chunk count is a
// multiple of 8). Branch-free: it sits in every ldmatrix address.
__device__ __forceinline__ int swz(int r, int c, int rc, int sh) {
  return (r * rc + c) ^ ((r >> sh) & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ldmatrix x4 at a shared-memory address (plain, and transposed for V).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A(16x16, row) * B(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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
// Reductions over the 4 lanes (a quad) that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* page_table;
  const int* start_pos;
  const int* q_lens;
  void* out;
  float* part;  // [B*K*n_tiles, n_split, trows, hd] unnormalised partial accumulators
  float* ml;    // [B*K*n_tiles, n_split, 2, trows] partial running max, then sum
  int* tickets; // [B*K*n_tiles] zero between launches
  int S, K, G, hd, L, N, psz, pmax, layer;
  int ntiles, trows;  // query tiles a window, rows a tile: min(S*G, kMaxRows)
  int nsplit, span;   // splits a tile, positions a split (a multiple of kChunk)
};

// What one block knows about its (row, kv-head, query tile) and its positions.
struct Block {
  int b, kh, start;
  int row0, rows, live;  // the tile's first window row, its rows, and its live rows
  int total;             // Pmax * Psz: positions the table can name
  int lim;               // the tile sees positions < lim (through its last live query)
  int c0, c1;            // this block's positions [c0, c1)
  float scale;
  // Tile row r (query (row0 + r) / G) sees positions below this; pad rows see none.
  __device__ __forceinline__ int limit(int r, int G) const {
    return r < live ? min(start + (row0 + r) / G + 1, total) : 0;
  }
  // Element offset of tile row r in a [B, S, K, G, hd] tensor.
  __device__ __forceinline__ size_t at(const Args& a, int r) const {
    const int s = (row0 + r) / a.G, g = row0 + r - s * a.G;
    return ((((size_t)b * a.S + s) * a.K + kh) * a.G + g) * a.hd;
  }
};

// q's live rows into shared memory, zero-filled past `live` and past hd:
// a warp a row, a lane a 16-byte chunk.
template <typename T>
__device__ void load_q(const Args& a, const Layout& lay, unsigned char* smem, const Block& blk) {
  constexpr int kPer = 16 / sizeof(T);  // elements in 16 bytes
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rc = lay.rc, sh = lay.sh, real = a.hd / kPer;
  const T* q = static_cast<const T*>(a.q);
  for (int r = warp; r < lay.rows; r += kWarps) {
    const T* row = r < blk.live ? q + blk.at(a, r) : q;
    for (int ch = lane; ch < rc; ch += 32) {
      const bool valid = r < blk.live && ch < real;
      cp_async16(smem + lay.q + swz(r, ch, rc, sh) * 16, valid ? row + ch * kPer : q, valid);
    }
  }
}

// Tile t (kTile positions from c0 + t * kTile) of K and V into `stage`, at
// the offsets the block computed: a warp a position, a lane a 16-byte chunk.
// Positions past c1 and the head_dim pad are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(const Args& a, const Layout& lay, unsigned char* smem,
                                          const Block& blk, int t, int stage) {
  constexpr int kPer = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rc = lay.rc, sh = lay.sh, real = a.hd / kPer;
  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);
  const long long* off = reinterpret_cast<const long long*>(smem + lay.off);
  unsigned char* ks = smem + lay.k + (size_t)stage * kTile * rc * 16;
  unsigned char* vs = smem + lay.v + (size_t)stage * kTile * rc * 16;
  for (int p = warp; p < kTile; p += kWarps) {
    const bool in = blk.c0 + t * kTile + p < blk.c1;
    const long long row = in ? off[t * kTile + p] : 0;
    for (int ch = lane; ch < rc; ch += 32) {
      const bool valid = in && ch < real;
      const long long o = valid ? row + ch * kPer : 0;
      const int dst = swz(p, ch, rc, sh) * 16;
      cp_async16(ks + dst, kp + o, valid);
      cp_async16(vs + dst, vp + o, valid);
    }
  }
}

// Tile rows [from, rows) are exact zeros: a warp a row, 16 bytes a lane.
template <typename T>
__device__ void zero_rows(const Args& a, const Block& blk, int from) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = a.hd * (int)sizeof(T) / 16;
  for (int r = from + warp; r < blk.rows; r += kWarps) {
    uint4* dst = reinterpret_cast<uint4*>(static_cast<T*>(a.out) + blk.at(a, r));
    for (int v = lane; v < nvec; v += 32) dst[v] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Four output values, rounded to T, in one store.
__device__ __forceinline__ void store4(float* dst, float4 v) { *reinterpret_cast<float4*>(dst) = v; }
__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// Calls f(std::integral_constant<int, np>) for np in [0, N], so that loops
// over a warp's column pairs unroll with no guard.
template <int N, typename F>
__device__ __forceinline__ void by_pairs(int np, F&& f) {
  if constexpr (N == 0) {
    f(std::integral_constant<int, 0>());
  } else if (np == N) {
    f(std::integral_constant<int, N>());
  } else {
    by_pairs<N - 1>(np, f);
  }
}

// bf16: both products on tensor cores. A warp owns one 16-row tile of the
// live query rows and `np` 16-column pairs of head_dim; its scores, running
// max and sum and its accumulator live in registers. Lane l holds rows
// r0 = 16 * mi + l / 4 and r0 + 8.
template <int kPairs>
struct MmaRows {
  float acc[kPairs][8];  // per pair: columns +0..7 (c0..c3), +8..15 (c0..c3)
  float m[2], l[2];         // l: this lane's share, summed over the quad at the end
  int mi, hs, p_lo, np, r0, lim0, lim1;
  bool active;

  __device__ __forceinline__ void init(const Args& a, const Layout& lay, unsigned char*,
                                       const Block& blk) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nmt = cdiv(blk.live, 16), npairs = lay.hdp / 16;
    // Each warp computes its tile's scores and softmax in full, so a tile
    // gets as few warps as its accumulator allows: one, or two that split
    // head_dim above kPairs pairs. The other warps only copy.
    const int nh = cdiv(npairs, kPairs);
    mi = warp / nh;
    hs = warp - mi * nh;
    active = mi < nmt;
    p_lo = hs * npairs / nh;
    np = (hs + 1) * npairs / nh - p_lo;
    r0 = mi * 16 + lane / 4;
    lim0 = blk.limit(r0, a.G);
    lim1 = blk.limit(r0 + 8, a.G);
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < kPairs; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void tile(const Args& a, const Layout& lay, unsigned char* smem,
                                       const Block& blk, int stage, int pos0) {
    if (!active) return;
    const int lane = threadIdx.x % 32, rc = lay.rc, sh = lay.sh;
    const uint32_t tile_bytes = kTile * rc * 16;
    const uint32_t qs = smem_u32(smem + lay.q);
    const uint32_t ks = smem_u32(smem + lay.k) + stage * tile_bytes;
    const uint32_t vs = smem_u32(smem + lay.v) + stage * tile_bytes;

    // S = q K^T over the tile: [16 rows, kTile positions] in kTile / 8 fragments.
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // ldmatrix rows and chunks of this lane: swz(r, c) = (r * rc + c) ^ x(r)
    // with c = 2 * k-step + (0 or 1), so only the k-step moves in the loop.
    const int qrow = mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int krow = (lane & 7) + (lane >> 4) * 8;
    const int qc = qrow * rc + (lane >> 4), qx = (qrow >> sh) & 7;
#pragma unroll 2
    for (int kk = 0; kk < lay.hdp / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qs + (((qc + 2 * kk) ^ qx) << 4));
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        const int r = j * 16 + krow;
        uint32_t kb[4];
        ldsm_x4(kb, ks + (((r * rc + ((lane >> 3) & 1) + 2 * kk) ^ ((r >> sh) & 7)) << 4));
        mma_bf16(s[2 * j], qa, kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qa, kb[2], kb[3]);
      }
    }

    // Mask and online softmax on the fragments.
    const int col = pos0 + 2 * (lane & 3);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = col + j * 8 + e;
        s[j][e] = pos < lim0 ? s[j][e] * blk.scale : kNegInf;
        s[j][2 + e] = pos < lim1 ? s[j][2 + e] * blk.scale : kNegInf;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    const float mn0 = fmaxf(m[0], quad_max(mx0)), mn1 = fmaxf(m[1], quad_max(mx1));
    const float al0 = __expf(m[0] - mn0), al1 = __expf(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = s[j][e] <= kNegInf * 0.5f ? 0.f : __expf(s[j][e] - mn0);
        s[j][2 + e] = s[j][2 + e] <= kNegInf * 0.5f ? 0.f : __expf(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    l[0] = l[0] * al0 + sum0;
    l[1] = l[1] * al1 + sum1;
    by_pairs<kPairs>(np, [&](auto n) { this->template pv<decltype(n)::value>(s, al0, al1, vs, rc, sh); });
  }

  // acc = acc * alpha + P V over this warp's NP pairs: P's fragments become
  // the A operand, V comes in transposed.
  template <int NP>
  __device__ __forceinline__ void pv(const float (&s)[kTile / 8][4], float al0, float al1,
                                     uint32_t vs, int rc, int sh) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
        acc[i][h] *= al0;
        acc[i][h + 1] *= al0;
        acc[i][h + 2] *= al1;
        acc[i][h + 3] *= al1;
      }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int vc = r * rc + 2 * p_lo + (lane >> 4), vx = (r >> sh) & 7;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (((vc + 2 * i) ^ vx) << 4));
        mma_bf16(acc[i], pa, vb[0], vb[1]);
        mma_bf16(acc[i] + 4, pa, vb[2], vb[3]);
      }
    }
  }

  // The unnormalised accumulator of this lane's live, unpadded pairs
  // (columns d, d + 1 of rows r0 and r0 + 8) into the [rows, hd] partial.
  template <int NP>
  __device__ __forceinline__ void store_acc(const Args& a, const Block& blk, float* part) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = (p_lo + i) * 16 + h * 8 + 2 * (lane & 3);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (d < a.hd && r0 + 8 * u < blk.live)
            *reinterpret_cast<float2*>(part + (size_t)(r0 + 8 * u) * a.hd + d) =
                make_float2(acc[i][4 * h + 2 * u], acc[i][4 * h + 2 * u + 1]);
      }
  }

  // This split's partial state for the live rows: m, l and the unnormalised acc.
  __device__ __forceinline__ void finish(const Args& a, const Layout&, unsigned char*,
                                         const Block& blk, float* part, float* ml) {
    if (!active) return;
    const int lane = threadIdx.x % 32, rows = a.trows;
    const float ls[2] = {quad_sum(l[0]), quad_sum(l[1])};
    by_pairs<kPairs>(np, [&](auto n) { this->template store_acc<decltype(n)::value>(a, blk, part); });
    if (hs == 0 && (lane & 3) == 0)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (r0 + 8 * u < blk.live) {
          ml[r0 + 8 * u] = m[u];
          ml[rows + r0 + 8 * u] = ls[u];
        }
  }
};

// fp32: both products on CUDA cores, no TF32. Scores and the per-row
// running max, sum and rescale sit in shared memory; thread tid holds
// accumulator values tid + j * kThreads of the [live, hd] block.
struct SimtRows {
  static_assert(kTile == 32, "the softmax gives one lane to each position of a tile");
  float acc[kAccF32];

  __device__ __forceinline__ void init(const Args&, const Layout& lay, unsigned char* smem,
                                       const Block&) {
    float* m_s = reinterpret_cast<float*>(smem + lay.m);
    float* l_s = reinterpret_cast<float*>(smem + lay.l);
    for (int r = threadIdx.x; r < lay.rows; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAccF32; ++j) acc[j] = 0.f;
  }

  __device__ __forceinline__ void tile(const Args& a, const Layout& lay, unsigned char* smem,
                                       const Block& blk, int stage, int pos0) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, rc = lay.rc, sh = lay.sh;
    const float4* q4 = reinterpret_cast<const float4*>(smem + lay.q);
    const float4* k4 = reinterpret_cast<const float4*>(smem + lay.k) + (size_t)stage * kTile * rc;
    const float* vs = reinterpret_cast<const float*>(smem + lay.v) + (size_t)stage * kTile * rc * 4;
    float* p_s = reinterpret_cast<float*>(smem + lay.p);
    float* m_s = reinterpret_cast<float*>(smem + lay.m);
    float* l_s = reinterpret_cast<float*>(smem + lay.l);
    float* a_s = reinterpret_cast<float*>(smem + lay.a);

    // Scores, masked: 8 consecutive lanes read 8 rows of K at one chunk.
    for (int e = tid; e < blk.live * kTile; e += kThreads) {
      const int r = e / kTile, p = e % kTile;
      float s = 0.f;
      for (int ch = 0; ch < rc; ++ch) {
        const float4 qv = q4[swz(r, ch, rc, sh)], kv = k4[swz(p, ch, rc, sh)];
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
      p_s[e] = pos0 + p < blk.limit(r, a.G) ? s * blk.scale : kNegInf;
    }
    __syncthreads();

    // Online softmax, one warp per query row, one lane per position.
    for (int r = warp; r < blk.live; r += kWarps) {
      const float sv = p_s[r * kTile + lane];
      const float m_old = m_s[r], m_new = fmaxf(m_old, warp_max(sv));
      const float pv = sv <= kNegInf * 0.5f ? 0.f : expf(sv - m_new);
      p_s[r * kTile + lane] = pv;
      const float sum = warp_sum(pv);
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
    for (int j = 0; j < kAccF32; ++j) {
      const int e = tid + j * kThreads;
      if (e < blk.live * a.hd) {
        const int r = e / a.hd, d = e - r * a.hd;
        const float* pr = p_s + r * kTile;
        float v = acc[j] * a_s[r];
        for (int p = 0; p < kTile; ++p) v = fmaf(pr[p], vs[swz(p, d >> 2, rc, sh) * 4 + (d & 3)], v);
        acc[j] = v;
      }
    }
  }

  __device__ __forceinline__ void finish(const Args& a, const Layout& lay, unsigned char* smem,
                                         const Block& blk, float* part, float* ml) {
    const float* m_s = reinterpret_cast<const float*>(smem + lay.m);
    const float* l_s = reinterpret_cast<const float*>(smem + lay.l);
    const int rows = a.trows;
#pragma unroll
    for (int j = 0; j < kAccF32; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < blk.live * a.hd) part[e] = acc[j];
    }
    for (int r = threadIdx.x; r < blk.live; r += kThreads) {
      ml[r] = m_s[r];
      ml[rows + r] = l_s[r];
    }
  }
};

// The last block of a split row merges the splits that had work, in split
// order, skipping those whose l is 0, and writes the whole window. Every
// (m, l) load is in flight at once; then each thread starts its columns'
// loads from every split before it uses one.
template <typename T>
__device__ void merge(const Args& a, const Layout& lay, unsigned char* smem, const Block& blk,
                      int nwork, const float* part, const float* ml) {
  const int rows = a.trows, ns = a.nsplit;
  float* m_s = reinterpret_cast<float*>(smem + lay.w);  // [rows, ns]: each split's max
  float* l_s = m_s + (size_t)lay.rows * ns;              // [rows, ns]: each split's sum
  float* w_s = l_s + (size_t)lay.rows * ns;              // [rows, ns]: e^(m_i - m*), 0 if l_i = 0
  float* sum_s = w_s + (size_t)lay.rows * ns;            // [rows]: sum_i l_i e^(m_i - m*)
  for (int e = threadIdx.x; e < blk.live * nwork; e += kThreads) {
    const int r = e / nwork, c = e - r * nwork;
    m_s[r * ns + c] = __ldcg(ml + (size_t)c * 2 * rows + r);
    l_s[r * ns + c] = __ldcg(ml + (size_t)c * 2 * rows + rows + r);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < blk.live; r += kThreads) {
    float mx = kNegInf;
    for (int c = 0; c < nwork; ++c)
      if (l_s[r * ns + c] > 0.f) mx = fmaxf(mx, m_s[r * ns + c]);
    float sum = 0.f;
    for (int c = 0; c < nwork; ++c) {
      const float l = l_s[r * ns + c];
      const float w = l > 0.f ? expf(m_s[r * ns + c] - mx) : 0.f;
      w_s[r * ns + c] = w;
      sum += l * w;
    }
    sum_s[r] = sum;
  }
  __syncthreads();
  // Element e = r * nv + v (row r, 4-column group v) sits at float4 e of
  // every split's [rows, hd] partial. A thread takes kElems elements a pass
  // and starts their loads from kBatch splits before it uses one.
  constexpr int kElems = 4, kBatch = 4;
  const int nv = a.hd / 4, n = blk.live * nv;
  const float4* src = reinterpret_cast<const float4*>(part);
  const size_t split = (size_t)rows * nv;
  for (int e0 = threadIdx.x; e0 < n; e0 += kElems * kThreads) {
    float4 acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < nwork; c0 += kBatch) {
      float4 x[kElems][kBatch];
#pragma unroll
      for (int i = 0; i < kElems; ++i)
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = e0 + i * kThreads;
          x[i][j] = e < n && c0 + j < nwork ? __ldcg(src + (c0 + j) * split + e)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = e0 + i * kThreads;
        if (e < n) {
          const float* wr = w_s + (e / nv) * ns;
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const float w = c0 + j < nwork ? wr[c0 + j] : 0.f;
            if (w > 0.f) {
              acc[i].x = fmaf(w, x[i][j].x, acc[i].x);
              acc[i].y = fmaf(w, x[i][j].y, acc[i].y);
              acc[i].z = fmaf(w, x[i][j].z, acc[i].z);
              acc[i].w = fmaf(w, x[i][j].w, acc[i].w);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kElems; ++i) {
      const int e = e0 + i * kThreads;
      if (e < n) {
        const int r = e / nv, v = e - r * nv;
        const float lv = sum_s[r], den = fmaxf(lv, 1e-30f);
        const float4 o = lv > 0.f ? make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                                                acc[i].w / den)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        store4(static_cast<T*>(a.out) + blk.at(a, r) + 4 * v, o);
      }
    }
  }
  zero_rows<T>(a, blk, blk.live);
}

// Attend positions [blk.c0, blk.c1) of the tile (at most a span): q once,
// each position's pool offset once (a thread a position, through the page
// table), then K and V tiles through the two stages: both in flight at
// once, and with kRing (spans longer than two tiles) each stage refilled
// with the tile after next once computed.
template <typename T, bool kRing, typename St>
__device__ __forceinline__ void attend(const Args& a, const Layout& lay, unsigned char* smem,
                                       const Block& blk, St& st) {
  static_assert(kStages == 2, "the waits below assume two stages");
  st.init(a, lay, smem, blk);
  load_q<T>(a, lay, smem, blk);
  long long* off = reinterpret_cast<long long*>(smem + lay.off);
  for (int p = threadIdx.x; p < blk.c1 - blk.c0; p += kThreads) {
    const int pos = blk.c0 + p;
    const int page = a.page_table[(size_t)blk.b * a.pmax + pos / a.psz];
    off[p] = ((((long long)blk.kh * a.L + a.layer) * a.N + page) * a.psz + pos % a.psz) * a.hd;
  }
  __syncthreads();
  const int nt = cdiv(blk.c1 - blk.c0, kTile);
  for (int t = 0; t < nt && t < kStages; ++t) {
    load_tile<T>(a, lay, smem, blk, t, t);
    cp_commit();  // q rides in the first group
  }
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt)
      cp_wait<1>();  // tile t (and q) have landed
    else
      cp_wait<0>();
    __syncthreads();
    st.tile(a, lay, smem, blk, t & 1, blk.c0 + t * kTile);
    if (kRing && t + kStages < nt) {
      __syncthreads();  // every warp is done with stage t & 1
      load_tile<T>(a, lay, smem, blk, t + kStages, t & 1);
      cp_commit();
    }
  }
}

// Grid (B*K*n_tiles, n_split): block (bkt, c) is split c of query tile
// bkt % n_tiles of (row, kv-head) bkt / n_tiles. A row's tiles sit side by
// side, so the costlier late tiles of a prefill row start early. The build
// without kWide serves windows of one tile split in kChunk positions (the
// decode and fast-forward windows): its tile, span and stages are fixed at
// compile time, so its code is that of a one-tile kernel.
template <typename T, int kPairs, bool kWide>
__global__ void __launch_bounds__(kThreads, kPairs <= kNarrowPairs ? 2 : 1)
ragged_paged_attention_kernel(const Args a) {
  using St =
      typename std::conditional<std::is_same<T, bf16>::value, MmaRows<kPairs>, SimtRows>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int bkt = blockIdx.x, c = blockIdx.y;
  const int bk = kWide ? bkt / a.ntiles : bkt;
  const int span = kWide ? a.span : kChunk;
  Block blk;
  blk.b = bk / a.K;
  blk.kh = bk - blk.b * a.K;
  blk.start = a.start_pos[blk.b];
  const int qn = min(max(a.q_lens[blk.b], 0), a.S);
  blk.row0 = kWide ? (bkt - bk * a.ntiles) * kMaxRows : 0;
  blk.rows = min(kMaxRows, a.S * a.G - blk.row0);
  blk.live = min(max(qn * a.G - blk.row0, 0), blk.rows);
  blk.total = a.pmax * a.psz;
  // The tile's last live query sees positions below start + its index + 1.
  const int seen = kWide ? (blk.row0 + blk.live - 1) / a.G + 1 : qn;
  blk.lim = blk.live > 0 ? max(min(blk.start + seen, blk.total), 0) : 0;
  blk.scale = rsqrtf((float)a.hd);
  const int rows = a.trows;
  const Layout lay = smem_layout(rows, a.hd, a.nsplit, span, (int)sizeof(T));

  if (blk.live == 0) {  // an idle row or a tile of pads: block 0 writes its zeros
    if (c == 0) zero_rows<T>(a, blk, 0);
    return;
  }
  const int nwork = cdiv(blk.lim, span);  // blocks of this tile with work
  blk.c0 = c * span;
  blk.c1 = min(blk.lim, blk.c0 + span);

  // Block c attends positions [c * span, (c + 1) * span) and leaves its
  // partial state in scratch.
  float* part = a.part + (size_t)bkt * a.nsplit * rows * a.hd;
  float* ml = a.ml + (size_t)bkt * a.nsplit * 2 * rows;
  if (c < nwork) {
    St st;
    attend<T, kWide>(a, lay, smem, blk, st);
    st.finish(a, lay, smem, blk, part + (size_t)c * rows * a.hd, ml + (size_t)c * 2 * rows);
  }

  // Every block of a live tile takes a ticket, empty ones too; the last one
  // merges and resets the counter.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.tickets + bkt, 1) == a.nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  merge<T>(a, lay, smem, blk, nwork, part, ml);
  if (threadIdx.x == 0) a.tickets[bkt] = 0;
}

// SMs of the current device, read once per device.
int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

// Query tiles a window, splits a tile and the positions a split attends,
// from the shapes: as many splits of kChunk positions as the table names,
// fewer once the (row, kv-head, tile) blocks alone make about two an SM.
struct Grid {
  int ntiles, trows, nsplit, span;
};

Grid grid_of(int B, int S, int K, int G, int pmax, int psz) {
  Grid g;
  g.ntiles = cdiv(S * G, kMaxRows);
  g.trows = std::min(S * G, kMaxRows);
  const int total = pmax * psz, work = B * K * g.ntiles;
  const int want =
      std::max(1, std::min(cdiv(total, kChunk), cdiv(2 * sm_count(), std::max(work, 1))));
  g.span = cdiv(cdiv(total, want), kChunk) * kChunk;
  g.nsplit = cdiv(total, g.span);
  return g;
}

template <typename T, int kPairs, bool kWide>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_layout(a.trows, a.hd, a.nsplit, a.span, (int)sizeof(T)).total;
  // The attribute is set once per device and size for this instantiation
  // (it only grows), not on every launch. Several host threads launch at
  // once (engines in one process): the check and the set are one step, or
  // a smaller size set last would shrink the limit a larger launch needs.
  static size_t granted[64] = {};
  static std::mutex granting;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> hold(granting);
    if (smem > granted[dev]) {
      err = cudaFuncSetAttribute(ragged_paged_attention_kernel<T, kPairs, kWide>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      granted[dev] = smem;
    }
  }
  ragged_paged_attention_kernel<T, kPairs, kWide>
      <<<dim3(B * a.K * a.ntiles, a.nsplit), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int kPairs>
int launch(const Args& a, int B, cudaStream_t stream) {
  return a.ntiles > 1 || a.span > kChunk ? launch<T, kPairs, true>(a, B, stream)
                                         : launch<T, kPairs, false>(a, B, stream);
}

}  // namespace

extern "C" {

// Splits a query tile (tiles a window: cdiv(S*G, 64)): the scratch holds
// B*K*tiles*splits partials and the tickets B*K*tiles counters.
int mcpx_ragged_paged_attention_splits(int B, int S, int K, int G, int pmax, int psz) {
  return grid_of(B, S, K, G, pmax, psz).nsplit;
}

// Dynamic shared memory one block needs; the wrapper refuses shapes above
// the card's per-block limit before launching.
size_t mcpx_ragged_paged_attention_smem(int B, int S, int K, int G, int hd, int psz, int pmax,
                                        int dtype) {
  const Grid g = grid_of(B, S, K, G, pmax, psz);
  return smem_layout(g.trows, hd, g.nsplit, g.span, dtype == 1 ? 2 : 4).total;
}

// dtype: 0 = float32, 1 = bfloat16. part [B*K*tiles, n_split, trows, hd]
// and ml [B*K*tiles, n_split, 2, trows] are fp32 scratch (any contents),
// trows = min(S*G, 64); tickets [B*K*tiles] int32 must be zero and are left
// zero. Returns cudaGetLastError() after the launch (0 = launched).
// Enqueues on `stream`; does not synchronise.
int mcpx_ragged_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                const void* page_table, const void* start_pos,
                                const void* q_lens, void* out, void* part, void* ml,
                                void* tickets, int B, int S, int K, int G, int hd, int L, int N,
                                int psz, int pmax, int layer, int dtype, void* stream) {
  if (B == 0 || K == 0 || S == 0) return 0;
  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.page_table = static_cast<const int*>(page_table);
  a.start_pos = static_cast<const int*>(start_pos);
  a.q_lens = static_cast<const int*>(q_lens);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.ml = static_cast<float*>(ml);
  a.tickets = static_cast<int*>(tickets);
  a.S = S, a.K = K, a.G = G, a.hd = hd, a.L = L, a.N = N;
  a.psz = psz, a.pmax = pmax, a.layer = layer;
  const Grid g = grid_of(B, S, K, G, pmax, psz);
  a.ntiles = g.ntiles, a.trows = g.trows, a.nsplit = g.nsplit, a.span = g.span;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return launch<float, kWidePairs>(a, B, st);  // kPairs unused by fp32
  // The narrow build while two warps of kNarrowPairs pairs cover head_dim.
  return hd <= 2 * 16 * kNarrowPairs ? launch<bf16, kNarrowPairs>(a, B, st)
                                     : launch<bf16, kWidePairs>(a, B, st);
}

}  // extern "C"
