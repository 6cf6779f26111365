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
// need fewer operations than the tensor cores could do in that time (2b
// prefill cohort: about 1.9 GFLOP, 2 us at the bf16 peak, against 4.2 us of
// bytes). At the serving shapes, though, a launch moves only a few MB, so
// what sets its time is the longest dependent chain of one block: page
// lookups, copy latency, the products, the softmax and, where positions are
// split, the merge.
//
// Three designs, chosen by shape alone (`kernel_design` in paged_attention.py;
// one CUDA-graph key serves any phase mix):
//   * warpgroup: bf16 windows of more than one 64-row query tile (S*G > 64:
//     suffix and tier prefill) at hd 32, 64, 128 or 256 and Psz 8, 16, 32 or
//     64. Each head_dim is an instantiation; 32 and 256 are the presets'.
//   * rowwise: bf16 windows of one query tile (S*G <= 64: decode,
//     fast-forward, verify, one-token steps) at the same head_dims and page
//     sizes, but for windows of 8 rows or fewer at hd 256 (2b's one-token
//     steps), which mma_sync ran as fast or faster. Its wgmma tiles
//     hold 64 rows, of which an S 1 window fills 4
//     or 8 (test, 2b) and the 2b serving window (S 8 x G 8) all 64; no
//     one-tile launch is bound by the tensor cores' rate (each runs 10-419x
//     above its bytes bound on the chain of its blocks), so the empty rows
//     cost no time that counts.
//   * mma_sync: the Ampere-style design below, for every other window
//     (float32, hd % 16 == 8 such as hd 24 and 40, other page sizes).
//
// The warpgroup design. One block per (row, kv-head, 64 query rows) and,
// where the blocks fill less than half the SMs and the table names more
// than 256 positions, per split of at least 256; the serving shapes (the
// 16-row S 128 cohorts, the B 4 tier rows over 256 positions) do not
// split, so they write no fp32 partial. 256 threads: a consumer warpgroup
// and a producer warpgroup, of which one warp reads the page ids and loads
// K and V by TMA, in stages of 64 positions (one page at Psz 64, four at
// Psz 16) viewed through a tensor map of the pool as [K*L*N*Psz, hd] rows
// in boxes of Psz rows by min(hd, 64) columns, swizzled (128 or 64 bytes)
// as wgmma reads them; pages past the block's positions load rows past the
// pool, which TMA fills with zeros. Stages signal completion on mbarriers,
// in a ring of as many stages as shared memory holds. q is loaded once, by
// the consumers' cp.async, into the same layout. Per stage the consumers
// compute S = q K^T as wgmma m64n64k16 from shared memory, mask only where
// the positions reach past the first live row's limit, run the online
// softmax on the accumulator fragments, round P to bf16 in registers and
// issue o += P V as one wgmma m64n{hd}k16 a 16-position k-step, P the
// register operand and V read transposed through its descriptor; past the
// last live row's limit they only wait and release. ptxas allocates every
// thread of a kernel the registers its launch bounds leave (setmaxnreg
// does not raise that), so hd 256, whose accumulator alone is 128
// registers a thread, runs one block an SM at up to 255, and the narrower
// head_dims two at 128; two blocks' consumer warpgroups then share an SM's
// tensor cores. (Two consumer warpgroups a block sharing each stage, at
// 168 registers, spilled and serialized every hd-256 wgmma and ran 2b's
// tier and p16 prefill 1.3x slower.) Blocks run tile-major, a row's last
// (longest) tiles first. The tensor maps are encoded on the host through
// cudaGetDriverEntryPoint and cached per (device, pool, shape) under the
// launcher's mutex; they pass as __grid_constant__ parameters.
// What bounds it: latency, not bytes. At 2b prefill about half the time is
// the launch, q, the first stage's copy and the stores, the rest the chain
// of the heaviest blocks' stages. Each of a row's blocks reads the row's K
// and V again, from L2. At the tier rows (8 or 16 blocks), launch latency.
//
// The rowwise design. What bounds a one-tile launch is the chain of one
// block, neither bytes (a 2b decode window needs 3 us of them) nor the
// launch (an empty kernel on the parent's grid: 1.0-1.2 us in a CUDA graph).
// Measured before it was designed, on scratch copies of the mma_sync
// kernel: one split over the whole table, written straight to the output
// (no partial, no ticket), ran 1.1-1.8x slower than four splits and a
// merge, since its chain is eight serial 32-position tiles; the warpgroup
// design on these windows ran 0.55-0.97x of the mma_sync one (64-position
// stages by TMA, wgmma). So: one block per (row, kv head) over the whole
// table up to 256 positions, so the serving tables write no partial and
// take no ticket. Two consumer warpgroups (256 threads) split the block's
// 64-position stages between them, warpgroup w taking stages w, w + 2, ...,
// each with its own (m, l, acc) through the warpgroup design's q K^T,
// softmax and P V over the tile's 64 rows (the live S*G rows, zeros past
// them). Warp t < kBufs reads stage t's page ids beside start_pos and q_len
// (no read waits on another before the copies) and loads the stage by TMA,
// every buffer's at once: a 256-position table whole at hd up to 128, three
// of its four stages at hd 256, whose fourth stage then loads into the
// first buffer once the warpgroup that read it is done. Each stage has an
// mbarrier of its own, used once, so a warpgroup that runs ahead never
// mistakes an earlier phase for its stage.
// A block of one split whose stages all stay loaded (every serving table:
// 256 positions at hd up to 128, 192 at hd 256) runs its softmax as the
// plain version does (rw_exact): the rows' max and sum first, then q K^T
// again and P = e^(s - M) / L rounded to bf16; online rescaling, which
// rounds P against a running max, turned a 2b plan served from the prefix
// cache away from the same plan served without it. Other blocks rescale
// online. The warpgroups then merge in shared memory in warpgroup order
// (the output does not depend on timing), and warpgroup 0 writes the rows
// with one reciprocal a row. Past 256 positions the grid splits into spans of
// 256-2,048 positions (while B*K blocks stay within one an SM) that merge
// through the tickets as the other designs' splits do. At 2b's S 1 rows
// (4 or 8 blocks) what remains is one SM's load rate: 256 KB of K and V a
// block.
//
// The mma_sync design:
//   * Query tiles. A window's S*G query rows (the GQA group folded in) are
//     cut into tiles of kMaxRows = 64 rows, so one launch serves any window
//     the reference kernel does. Each tile sees only positions below start
//     + (its last live query) + 1, so the causal rule skips whole chunks
//     for the early tiles of a prefill row.
//   * Split positions (flash-decoding). The grid is (B*K*n_tiles, n_split).
//     Block c of a live tile attends positions [c*span, (c+1)*span), span
//     a multiple of kChunk; a block past the tile's last visible position
//     computes nothing. Short spans keep each block's chain short. The
//     split count falls as the tiles alone fill the card (about two blocks
//     an SM): n_split = cdiv(Pmax*Psz, span) with span the least multiple
//     of kChunk that keeps B*K*n_tiles*n_split near 2 * SMs, never above
//     cdiv(Pmax*Psz, kChunk) splits. Decode windows (one tile a row) keep
//     one split per kChunk. Tile and split counts depend on shapes (and
//     the card's SM count) only.
//   * Combine in the same launch (every design). Block 0 writes the zeros
//     of an idle row's tiles and of tiles that hold only pads. Each block
//     of a live tile with work writes its partial (m, l, unnormalised acc)
//     in fp32 to scratch, fences, and takes a ticket on the tile's counter;
//     every block of the tile takes one, empty ones too. The block that
//     draws the last ticket merges the partials in split order (so the
//     output does not depend on block timing), writes the tile's rows
//     (zeros for pads) and resets the counter to 0. It keeps 16 loads of
//     the partials in flight a thread, since one block reads them all. The
//     counters assume that launches sharing them run one after another, so
//     the wrapper keeps one buffer per stream. A second combine launch
//     would cost host time per layer on an engine the host already holds
//     back.
//   * Asynchronous copies. The block computes its positions' pool offsets
//     once, a thread a position, from the page table. K and V arrive by
//     cp.async.cg (16 B a lane, a warp a position, zero-filled past the
//     visible end) into a ring of two stages of kTile positions: both are
//     in flight at once, and a stage is refilled with the tile after next
//     as soon as it has been computed. q is loaded once per block. Tiles
//     are XOR-swizzled in 16-byte chunks so that ldmatrix and 128-bit
//     loads read without bank conflicts.
//   * Tensor cores (bf16). Both products run as mma.sync m16n8k16 with
//     fragments from ldmatrix (.trans for V) and fp32 accumulators in
//     registers. The live query rows (q_len*G) are padded up to a multiple
//     of 16 and never stored past q_len*G; the mask and the online softmax
//     run on the accumulator fragments. P is rounded to bf16 for P.V, as
//     the plain version rounds its weights to V's type. A head_dim with
//     hd % 16 == 8 is zero-padded in shared memory to a whole k-step.
//     A warp takes a 16-row tile whole (scores, softmax, and up to 128
//     head_dim columns of P.V); two warps share it at hd 256.
//   * fp32 keeps its products on CUDA cores (no TF32), so it matches the
//     plain fp32 version to summation order; it shares the split, the
//     combine and the copy pipeline.
//   * The launch attribute for dynamic shared memory is set once per
//     instantiation and size, not on every launch.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <type_traits>
#include <vector>

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

// Barriers for `merge`: the whole block, or the kT consumer threads of a
// warp-specialised block (named barrier `id`; 0 is __syncthreads').
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
template <int kT>
struct NamedSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kT) : "memory");
  }
};

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
template <typename T, int kT = kThreads>
__device__ void zero_rows(const Args& a, const Block& blk, int from) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = a.hd * (int)sizeof(T) / 16;
  for (int r = from + warp; r < blk.rows; r += kT / 32) {
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
// loads from every split before it uses one. Threads [0, kT) run it,
// `ws` holds (3 * nsplit + 1) * prows floats, and `sync` is their barrier
// (__syncthreads, or the consumers' named barrier in the warpgroup design).
template <typename T, int kT, typename Sync>
__device__ void merge(const Args& a, float* ws, int prows, const Block& blk, int nwork,
                      const float* part, const float* ml, Sync sync) {
  const int rows = a.trows, ns = a.nsplit;
  float* m_s = ws;                                  // [rows, ns]: each split's max
  float* l_s = m_s + (size_t)prows * ns;            // [rows, ns]: each split's sum
  float* w_s = l_s + (size_t)prows * ns;            // [rows, ns]: e^(m_i - m*), 0 if l_i = 0
  float* sum_s = w_s + (size_t)prows * ns;          // [rows]: sum_i l_i e^(m_i - m*)
  for (int e = threadIdx.x; e < blk.live * nwork; e += kT) {
    const int r = e / nwork, c = e - r * nwork;
    m_s[r * ns + c] = __ldcg(ml + (size_t)c * 2 * rows + r);
    l_s[r * ns + c] = __ldcg(ml + (size_t)c * 2 * rows + rows + r);
  }
  sync();
  for (int r = threadIdx.x; r < blk.live; r += kT) {
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
  sync();
  // Element e = r * nv + v (row r, 4-column group v) sits at float4 e of
  // every split's [rows, hd] partial. A thread takes kElems elements a pass
  // and starts their loads from kBatch splits before it uses one.
  constexpr int kElems = 4, kBatch = 4;
  const int nv = a.hd / 4, n = blk.live * nv;
  const float4* src = reinterpret_cast<const float4*>(part);
  const size_t split = (size_t)rows * nv;
  for (int e0 = threadIdx.x; e0 < n; e0 += kElems * kT) {
    float4 acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < nwork; c0 += kBatch) {
      float4 x[kElems][kBatch];
#pragma unroll
      for (int i = 0; i < kElems; ++i)
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = e0 + i * kT;
          x[i][j] = e < n && c0 + j < nwork ? __ldcg(src + (c0 + j) * split + e)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int i = 0; i < kElems; ++i) {
        const int e = e0 + i * kT;
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
      const int e = e0 + i * kT;
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
  zero_rows<T, kT>(a, blk, blk.live);
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
  merge<T, kThreads>(a, reinterpret_cast<float*>(smem + lay.w), lay.rows, blk, nwork, part, ml,
                     BlockSync());
  if (threadIdx.x == 0) a.tickets[bkt] = 0;
}

// ---------------------------------------------------------------------------
// The warpgroup design: bf16 windows of more than one 64-row query tile
// (suffix and tier prefill), at the head_dims and page sizes `kernel_design`
// (paged_attention.py) routes here. See "Three designs" in the note above.

constexpr int kWgRows = 64;      // query rows a block: one consumer warpgroup
constexpr int kWgPos = 64;       // positions a stage: the n of q K^T, the k of P V
constexpr int kWgThreads = 256;  // the consumer warpgroup, then the producer's
static_assert(kWgPos == kChunk, "a split's span is a whole number of stages");

template <int HD>
struct Wg {
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256, "the instantiated head_dims");
  // Blocks an SM: registers cap ptxas at 65,536 / (kWgThreads * kMinBlocks)
  // a thread for the whole kernel (setmaxnreg does not raise what it
  // allocates), and hd 256 needs more than 128 beside its accumulator.
  static constexpr int kMinBlocks = HD > 128 ? 1 : 2;
  static constexpr int kCols = HD < 64 ? HD : 64;  // columns a swizzled row: a TMA box's width
  static constexpr int kRowBytes = kCols * 2;      // 64 (64-byte swizzle) or 128 (128-byte)
  static constexpr int kBlocks = HD / kCols;       // column blocks of a tile
  static constexpr int kStages = HD > 64 ? 2 : 4;  // as many as kMinBlocks blocks' shared memory holds
  static constexpr int kQBytes = kWgRows * HD * 2;
  static constexpr int kTileBytes = kWgPos * HD * 2;  // K (or V) of one stage
  static constexpr int kHead = 1024;                  // the barriers and the ticket flag
  static constexpr int kBody = kQBytes + 2 * kStages * kTileBytes;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma descriptor: 128B, 64B swizzle
};

// Dynamic shared memory of a block: alignment slack, head, and the larger
// of the tiles and the merge's workspace (which reuses them).
template <int HD>
size_t wg_smem(int nsplit) {
  const size_t ws = sizeof(float) * kWgRows * (3 * (size_t)nsplit + 1);
  return 1024 + Wg<HD>::kHead + std::max((size_t)Wg<HD>::kBody, ws);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Until the phase of parity `parity` has completed. A wait that has not
// completed after 2^26 polls (seconds) traps: a fault shows as a failed
// launch, never as a card that hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}
// A box of the pool (column x, row y) into shared memory; `bar` counts its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of `d` across a wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets, and the tile's swizzle.
template <int HD>
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (Wg<HD>::kLayout << 62);
}

#define MCPX_F8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define MCPX_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MCPX_R32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MCPX_R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define MCPX_R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127}"

// d (64 x N, fp32) = or += A (64 x 16, shared) * B (16 x N, shared, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MCPX_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MCPX_F8(0), MCPX_F8(8), MCPX_F8(16), MCPX_F8(24)
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MCPX_R16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : MCPX_F8(0), MCPX_F8(8)
      : "l"(a), "l"(b), "r"(acc));
}
// d (64 x N, fp32) += A (64 x 16, registers) * B (16 x N, shared, N-major:
// transposed), N = head_dim: one product covers the whole accumulator.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " MCPX_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : MCPX_F8(0), MCPX_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MCPX_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MCPX_F8(0), MCPX_F8(8), MCPX_F8(16), MCPX_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MCPX_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : MCPX_F8(0), MCPX_F8(8), MCPX_F8(16), MCPX_F8(24), MCPX_F8(32), MCPX_F8(40), MCPX_F8(48),
        MCPX_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MCPX_R128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : MCPX_F8(0), MCPX_F8(8), MCPX_F8(16), MCPX_F8(24), MCPX_F8(32), MCPX_F8(40), MCPX_F8(48),
        MCPX_F8(56), MCPX_F8(64), MCPX_F8(72), MCPX_F8(80), MCPX_F8(88), MCPX_F8(96), MCPX_F8(104),
        MCPX_F8(112), MCPX_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef MCPX_F8
#undef MCPX_R16
#undef MCPX_R32
#undef MCPX_R64
#undef MCPX_R128

// The producer warp: for each stage, each lane one (page, column block) box
// of K and of V. A page past the block's positions (or past the table)
// loads rows beyond the pools, which TMA fills with zeros, so a stage
// always lands whole and holds no stale or unset value. The page table
// entry of stage t + 1 is read before stage t's wait.
template <int HD>
__device__ __forceinline__ void wg_produce(const CUtensorMap* km, const CUtensorMap* vm,
                                           const Args& a, const Block& blk, uint32_t base, int nt) {
  using W = Wg<HD>;
  const int lane = threadIdx.x % 32;
  const int pg = lane / W::kBlocks, cb = lane % W::kBlocks;
  const bool mine = pg < kWgPos / a.psz;
  const int past = a.K * a.L * a.N * a.psz;  // the first row past the pools
  const uint32_t full = base, empty = base + 8 * W::kStages;
  const uint32_t ks = base + W::kHead + W::kQBytes, vs = ks + W::kStages * W::kTileBytes;
  const uint32_t off = cb * (kWgPos * W::kRowBytes) + pg * a.psz * W::kRowBytes;
  auto row_of = [&](int t) {
    const int page = (blk.c0 + t * kWgPos) / a.psz + pg;
    if (!mine || t >= nt || page * a.psz >= blk.c1) return past;
    return ((blk.kh * a.L + a.layer) * a.N + a.page_table[(size_t)blk.b * a.pmax + page]) * a.psz;
  };
  int row = row_of(0);
  for (int t = 0; t < nt; ++t) {
    const int s = t % W::kStages, next = row_of(t + 1);
    if (t >= W::kStages) mbar_wait(empty + 8 * s, (t / W::kStages - 1) & 1);
    if (lane == 0) mbar_expect_tx(full + 8 * s, 2 * W::kTileBytes);
    __syncwarp();
    if (mine) {
      tma_load(ks + s * W::kTileBytes + off, km, cb * W::kCols, row, full + 8 * s);
      tma_load(vs + s * W::kTileBytes + off, vm, cb * W::kCols, row, full + 8 * s);
    }
    row = next;
  }
}

// Byte offset of 16-byte chunk `ch` of q's tile row `row` in the layout TMA
// gives K (column blocks of the block's rows, swizzled), which wgmma reads.
template <int HD>
__device__ __forceinline__ uint32_t wg_chunk(int row, int ch) {
  using W = Wg<HD>;
  constexpr int kPer = W::kCols / 8;  // chunks a swizzled row
  const int sw = W::kRowBytes == 128 ? (row & 7) : ((row >> 1) & 3);
  return (ch / kPer) * (kWgRows * W::kRowBytes) + row * W::kRowBytes + (((ch % kPer) ^ sw) << 4);
}

// The tile's query rows into shared memory by cp.async (every chunk in
// flight at once, no registers), zeros past `blk.live`; the caller waits.
template <int HD>
__device__ __forceinline__ void wg_load_q(const Args& a, const Block& blk, unsigned char* qs) {
  constexpr int kChunks = HD / 8;
  const bf16* q = static_cast<const bf16*>(a.q);
#pragma unroll
  for (int i = 0; i < kWgRows * kChunks / 128; ++i) {
    const int e = threadIdx.x + i * 128, r = e / kChunks, ch = e % kChunks;
    const bool valid = r < blk.live;
    cp_async16(qs + wg_chunk<HD>(r, ch), valid ? q + blk.at(a, r) + ch * 8 : q, valid);
  }
  cp_commit();
}

// One stage for the consumer warpgroup: S = q K^T (HD / 16 k-steps), the
// mask (`masked`: only where the positions reach past the first live row's
// limit), the online softmax on the fragments, then o += P V with P rounded
// to bf16 as the A operand from registers and V read transposed. Lane l of
// warp w holds rows 16w + l/4 and + 8, columns 8j + 2(l%4) + {0,1}. Its
// steps are apart so that the rowwise design can run q K^T twice: once for
// the rows' max and sum, once for P normalised as the plain version does.
template <int HD, int N = kWgPos>
__device__ __forceinline__ void wg_scores(float (&s)[N / 2], uint32_t qs, uint32_t ks) {
  using W = Wg<HD>;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int cb = kk * 16 / W::kCols, within = kk * 16 % W::kCols * 2;
    wgmma_ss(s, wg_desc<HD>(qs + cb * kWgRows * W::kRowBytes + within, 16, 8 * W::kRowBytes),
             wg_desc<HD>(ks + cb * kWgPos * W::kRowBytes + within, 16, 8 * W::kRowBytes), kk > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
}

// The scaled scores, NEG_INF where a row may not see the position: column
// 8j + e of this lane is visible to row r while 8j + e < lim_r - col0.
template <int N = kWgPos>
__device__ __forceinline__ void wg_mask(float (&s)[N / 2], int pos0, bool masked, int lim0, int lim1,
                                        float scale) {
  const int lane = threadIdx.x % 32;
  const int col0 = pos0 + 2 * (lane & 3), d0 = lim0 - col0, d1 = lim1 - col0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = !masked || 8 * j + e < d0 ? s[4 * j + e] * scale : kNegInf;
      s[4 * j + 2 + e] = !masked || 8 * j + e < d1 ? s[4 * j + 2 + e] * scale : kNegInf;
    }
}

template <int HD, int N = kWgPos>
__device__ __forceinline__ void wg_softmax(float (&o)[HD / 2], float (&m)[2], float (&l)[2],
                                           float (&s)[N / 2], uint32_t (&p)[N / 16][4], int pos0,
                                           bool masked, int lim0, int lim1, float scale) {
  wg_mask<N>(s, pos0, masked, lim0, lim1, scale);
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx0 = fmaxf(mx0, s[4 * j + e]);
      mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
    }
  const float mn0 = fmaxf(m[0], quad_max(mx0)), mn1 = fmaxf(m[1], quad_max(mx1));
  const float al0 = __expf(m[0] - mn0), al1 = __expf(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = s[4 * j + e] <= kNegInf * 0.5f ? 0.f : __expf(s[4 * j + e] - mn0);
      s[4 * j + 2 + e] = s[4 * j + 2 + e] <= kNegInf * 0.5f ? 0.f : __expf(s[4 * j + 2 + e] - mn1);
      sum0 += s[4 * j + e];
      sum1 += s[4 * j + 2 + e];
    }
  l[0] = l[0] * al0 + sum0;
  l[1] = l[1] * al1 + sum1;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= al0;
    o[4 * j + 1] *= al0;
    o[4 * j + 2] *= al1;
    o[4 * j + 3] *= al1;
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int HD, int N = kWgPos>
__device__ __forceinline__ void wg_pv(float (&o)[HD / 2], const uint32_t (&p)[N / 16][4], uint32_t vs) {
  using W = Wg<HD>;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    wgmma_rs(o, p[kk],
             wg_desc<HD>(vs + kk * 16 * W::kRowBytes, kWgPos * W::kRowBytes, 8 * W::kRowBytes));
  wgmma_commit();
  wgmma_wait();
  fence_regs(o);
}

template <int HD, int N = kWgPos>
__device__ __forceinline__ void wg_stage(float (&o)[HD / 2],
                                         float (&m)[2], float (&l)[2], uint32_t qs, uint32_t ks,
                                         uint32_t vs, int pos0, bool masked, int lim0, int lim1,
                                         float scale) {
  float s[N / 2];
  uint32_t p[N / 16][4];
  wg_scores<HD, N>(s, qs, ks);
  wg_softmax<HD, N>(o, m, l, s, p, pos0, masked, lim0, lim1, scale);
  wg_pv<HD, N>(o, p, vs);
}

// The consumer warpgroup: q once, then every stage the producer loads
// (past its last live row's limit it only waits and releases), then either
// the output rows (one split) or the partial state, a ticket and, in the
// last block, the merge.
template <int HD>
__device__ __forceinline__ void wg_consume(const Args& a, const Block& blk, unsigned char* smem,
                                           uint32_t base, int nt, int c, int nwork, int bkt) {
  using W = Wg<HD>;
  using Sync = NamedSync<128>;  // the consumer warpgroup's own barrier
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t full = base, empty = base + 8 * W::kStages;
  const uint32_t qs = base + W::kHead, ks = qs + W::kQBytes, vs = ks + W::kStages * W::kTileBytes;
  float o[HD / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + lane / 4;  // this lane's rows r0 and r0 + 8
  const int lim0 = blk.limit(r0, a.G), lim1 = blk.limit(r0 + 8, a.G);
  const int first = blk.limit(0, a.G), last = blk.limit(blk.live - 1, a.G);
  if (nt > 0) {
    wg_load_q<HD>(a, blk, smem + W::kHead);
    cp_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    Sync{1}();
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int s = t % W::kStages, pos0 = blk.c0 + t * kWgPos;
    mbar_wait(full + 8 * s, (t / W::kStages) & 1);
    if (pos0 < last)
      wg_stage<HD>(o, m, l, qs, ks + s * W::kTileBytes, vs + s * W::kTileBytes, pos0,
                   pos0 + kWgPos > first, lim0, lim1, blk.scale);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  const float ls[2] = {quad_sum(l[0]), quad_sum(l[1])};
  bf16* out = static_cast<bf16*>(a.out);
  if (a.nsplit == 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 8 * u;
      if (r >= blk.live) continue;
      const float den = fmaxf(ls[u], 1e-30f);
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + blk.at(a, r));
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float x = o[4 * j + 2 * u], y = o[4 * j + 2 * u + 1];
        dst[4 * j + (lane & 3)] = ls[u] > 0.f ? pack_bf16(x / den, y / den) : 0u;
      }
    }
    // The tile's pad rows: exact zeros, 16 bytes a thread.
    const int from = blk.live;
    for (int e = tid; e < (blk.rows - from) * (HD / 8); e += 128)
      reinterpret_cast<uint4*>(out + blk.at(a, from + e / (HD / 8)))[e % (HD / 8)] =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  float* part = a.part + (size_t)bkt * a.nsplit * a.trows * HD;
  float* ml = a.ml + (size_t)bkt * a.nsplit * 2 * a.trows;
  if (nt > 0) {
    float* mine = part + (size_t)c * a.trows * HD;
    float* mml = ml + (size_t)c * 2 * a.trows;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 8 * u;
      if (r >= blk.live) continue;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(mine + (size_t)r * HD + 8 * j + 2 * (lane & 3)) =
            make_float2(o[4 * j + 2 * u], o[4 * j + 2 * u + 1]);
      if ((lane & 3) == 0) {
        mml[r] = m[u];
        mml[a.trows + r] = ls[u];
      }
    }
  }
  // Every block of a live tile takes a ticket, empty ones too; the last
  // one merges, in split order, and resets the counter.
  int* flag = reinterpret_cast<int*>(smem + 512);
  __threadfence();
  Sync{1}();
  if (tid == 0) *flag = atomicAdd(a.tickets + bkt, 1) == a.nsplit - 1;
  Sync{1}();
  if (!*flag) return;
  __threadfence();
  merge<bf16, 128>(a, reinterpret_cast<float*>(smem + W::kHead), kWgRows, blk, nwork, part, ml,
                   Sync{1});
  if (tid == 0) a.tickets[bkt] = 0;
}


// Grid (B*K*n_tiles, n_split) with 64-row tiles; 256 threads: the consumer
// warpgroup, then the producer warpgroup, of which one warp issues the
// loads. The roles meet at no barrier after the set-up.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, Wg<HD>::kMinBlocks)
    ragged_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const Args a) {
  using W = Wg<HD>;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int bkt = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  // Tile-major, the last tiles first: a causal row's last tiles see the
  // most positions, so where the blocks take more than one wave the
  // longest start first.
  const int nbk = gridDim.x / a.ntiles, bk = bkt % nbk;
  Block blk;
  blk.b = bk / a.K;
  blk.kh = bk - blk.b * a.K;
  blk.start = a.start_pos[blk.b];
  const int qn = min(max(a.q_lens[blk.b], 0), a.S);
  blk.row0 = (a.ntiles - 1 - bkt / nbk) * kWgRows;
  blk.rows = min(kWgRows, a.S * a.G - blk.row0);
  blk.live = min(max(qn * a.G - blk.row0, 0), blk.rows);
  blk.total = a.pmax * a.psz;
  blk.lim = blk.live > 0
                ? max(min(blk.start + (blk.row0 + blk.live - 1) / a.G + 1, blk.total), 0)
                : 0;
  blk.scale = rsqrtf((float)HD);
  if (blk.live == 0) {  // an idle row or a tile of pads: block 0 writes its zeros
    if (c == 0) zero_rows<bf16>(a, blk, 0);
    return;
  }
  const int nwork = cdiv(blk.lim, a.span);
  blk.c0 = c * a.span;
  blk.c1 = min(blk.lim, blk.c0 + a.span);
  const int nt = c < nwork ? cdiv(blk.c1 - blk.c0, kWgPos) : 0;  // stages this block loads
  if (nt > 0) {
    if (tid == 0) {
      for (int s = 0; s < W::kStages; ++s) {
        mbar_init(base + 8 * s, 1);                   // full: the producer's arrival
        mbar_init(base + 8 * (W::kStages + s), 4);  // empty: each consumer warp's
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (tid >= 128) {
    if (tid < 160 && nt > 0) wg_produce<HD>(&kmap, &vmap, a, blk, base, nt);
  } else {
    wg_consume<HD>(a, blk, smem, base, nt, c, nwork, bkt);
  }
}

// ---------------------------------------------------------------------------
// The rowwise design: bf16 windows of one query tile (S*G <= 64: decode,
// fast-forward, verify and one-token steps), at the warpgroup design's head
// dims and page sizes. See "Three designs" in the note above.

constexpr int kRwMinSpan = 4 * kWgPos;    // positions a block covers before the grid splits
constexpr int kRwMaxStages = 32;          // stages a block at most: one mbarrier each
constexpr int kRwMaxSpan = kRwMaxStages * kWgPos;

template <int HD>
struct Rw {
  using W = Wg<HD>;
  // Consumer warpgroups a block, each over every other stage with its own
  // (m, l, acc). (Four at hd 32 and 64, 512 threads a block, ran within 2%
  // of two; hd 256's accumulator leaves registers for two.)
  static constexpr int kWGs = 2;
  static constexpr int kThreads = 128 * kWGs;
  // Stage buffers, all loading from the start: a 256-position table whole,
  // three stages at hd 256 (64 KB each beside 32 KB of q).
  static constexpr int kBufs = HD > 128 ? 3 : 4;
  // A barrier per stage (from 0), the ticket flag (at 512), and each
  // warpgroup's rows' (max, sum) for the exact softmax (from 1024).
  static constexpr int kHead = 2048;
  static constexpr int kBody = W::kQBytes + 2 * kBufs * W::kTileBytes;
  // The other warpgroups' accumulators, then their (m, l), for the merge
  // inside the block, over q and the stages once every stage is done.
  static constexpr int kXo = (kWGs - 1) * 128 * (HD / 2) * 4;
  static constexpr int kXchg = kXo + (kWGs - 1) * kWgRows * 2 * 4;
  static_assert(kXchg <= kBody, "the merge's exchange fits over q and the stages");
  static_assert(8 * kRwMaxStages <= 512, "the barriers end before the ticket flag");
  static_assert(kWGs * 2 * kWgRows * 4 <= 1024, "the warpgroups' (max, sum) fit the head");
};

// Dynamic shared memory of a block: alignment slack, head, and the larger
// of the tiles and the split merge's workspace (which reuses them).
template <int HD>
size_t rw_smem(int nsplit) {
  const size_t ws = sizeof(float) * kWgRows * (3 * (size_t)nsplit + 1);
  return 1024 + Rw<HD>::kHead + std::max((size_t)Rw<HD>::kBody, ws);
}

// The page id this lane of an issuing warp loads from for stage t of the
// positions from c0 (a lane a (page, column block) box). A lane or page
// past the stage or the table reads a clamped entry, which rw_issue does
// not use: the read has no condition, so it issues with the kernel's first.
template <int HD>
__device__ __forceinline__ int rw_page(const Args& a, int b, int c0, int t) {
  const int pg = min((int)(threadIdx.x % 32) / Wg<HD>::kBlocks, kWgPos / a.psz - 1);
  const int page = min((c0 + t * kWgPos) / a.psz + pg, a.pmax - 1);
  return __ldg(a.page_table + (size_t)b * a.pmax + page);
}

// Stage t (64 positions from blk.c0 + 64 t) into buffer t % kBufs, on
// barrier t, by the calling warp: each lane one (page, column block) box of
// K and of V from page `id` (rw_page's). A page at or past c1 loads rows past the pools,
// which TMA fills with zeros, so a stage always lands whole.
template <int HD>
__device__ __forceinline__ void rw_issue(const CUtensorMap* km, const CUtensorMap* vm, const Args& a,
                                         const Block& blk, uint32_t base, int t, int id) {
  using W = Wg<HD>;
  using R = Rw<HD>;
  const int lane = threadIdx.x % 32, pg = lane / W::kBlocks, cb = lane % W::kBlocks;
  const bool mine = pg < kWgPos / a.psz;
  const uint32_t bar = base + 8 * t;
  const uint32_t ks = base + R::kHead + W::kQBytes + (t % R::kBufs) * W::kTileBytes;
  const uint32_t vs = ks + R::kBufs * W::kTileBytes;
  const uint32_t off = cb * (kWgPos * W::kRowBytes) + pg * a.psz * W::kRowBytes;
  const int page = (blk.c0 + t * kWgPos) / a.psz + pg;
  const int row = page * a.psz < blk.c1 ? ((blk.kh * a.L + a.layer) * a.N + id) * a.psz
                                        : a.K * a.L * a.N * a.psz;
  if (lane == 0) mbar_expect_tx(bar, 2 * W::kTileBytes);
  __syncwarp();
  if (mine) {
    tma_load(ks + off, km, cb * W::kCols, row, bar);
    tma_load(vs + off, vm, cb * W::kCols, row, bar);
  }
}

// The tile's query rows (64, zeros past blk.live) by cp.async, every
// thread's chunks in flight at once; the caller waits.
template <int HD, int kT>
__device__ __forceinline__ void rw_load_q(const Args& a, const Block& blk, unsigned char* qs) {
  constexpr int kChunks = HD / 8;
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = threadIdx.x; e < kWgRows * kChunks; e += kT) {
    const int r = e / kChunks, ch = e % kChunks;
    const bool valid = r < blk.live;
    cp_async16(qs + wg_chunk<HD>(r, ch), valid ? q + blk.at(a, r) + ch * 8 : q, valid);
  }
  cp_commit();
}

// The softmax of a block of one split whose stages all stay loaded, as
// the plain version computes it: the rows' max M and sum L over every
// position first (q K^T over the warpgroup's stages, the two warpgroups'
// (max, sum) merged through shared memory in warpgroup order), then q K^T
// again and P = e^(s - M) / L rounded to bf16 before P V. Online rescaling
// rounds P against a running max and divides after P V, so its bf16
// rounding differs from the plain version's; a prompt token fast-forwarded
// through a decode window over cached pages then leaves other hidden states
// than the dense prefill of the same tokens, and a 2b plan served from the
// prefix cache differed from the plan served without it. Leaves o
// normalised, m = M and ls = 1/2 in both warpgroups, so that the merge
// after it adds their o with equal weights and divides by their sum. `ex`
// holds [kWGs][max, sum][64 rows].
template <int HD>
__device__ __forceinline__ void rw_exact(float (&o)[HD / 2], float (&m)[2], float (&ls)[2], float* ex,
                                         uint32_t base, uint32_t qs, uint32_t ks, uint32_t vs,
                                         const Block& blk, int nt, int lim0, int lim1, int first) {
  using W = Wg<HD>;
  using R = Rw<HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int r0 = (warp % 4) * 16 + lane / 4;
  float s[kWgPos / 2];
  float l[2] = {0.f, 0.f};
  for (int t = wg; t < nt; t += R::kWGs) {
    const int pos0 = blk.c0 + t * kWgPos;
    mbar_wait(base + 8 * t, 0);
    wg_scores<HD>(s, qs, ks + (t % R::kBufs) * W::kTileBytes);
    wg_mask(s, pos0, pos0 + kWgPos > first, lim0, lim1, blk.scale);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kWgPos / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) mx[u] = fmaxf(mx[u], fmaxf(s[4 * j + 2 * u], s[4 * j + 2 * u + 1]));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float mn = fmaxf(m[u], quad_max(mx[u]));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kWgPos / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[4 * j + 2 * u + e];
          sum += x <= kNegInf * 0.5f ? 0.f : __expf(x - mn);
        }
      l[u] = l[u] * __expf(m[u] - mn) + sum;
      m[u] = mn;
    }
  }
  // Each warpgroup's (max, sum) of its rows, then both warpgroups' merged.
  const float lq[2] = {quad_sum(l[0]), quad_sum(l[1])};
  if ((lane & 3) == 0)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      ex[wg * 2 * kWgRows + r0 + 8 * u] = m[u];
      ex[wg * 2 * kWgRows + kWgRows + r0 + 8 * u] = lq[u];
    }
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float mx = kNegInf, sum = 0.f;
    for (int g = 0; g < R::kWGs; ++g)
      if (ex[g * 2 * kWgRows + kWgRows + r0 + 8 * u] > 0.f) mx = fmaxf(mx, ex[g * 2 * kWgRows + r0 + 8 * u]);
    for (int g = 0; g < R::kWGs; ++g) {
      const float lg = ex[g * 2 * kWgRows + kWgRows + r0 + 8 * u];
      sum += lg > 0.f ? lg * __expf(ex[g * 2 * kWgRows + r0 + 8 * u] - mx) : 0.f;
    }
    m[u] = mx;
    inv[u] = sum > 0.f ? 1.f / sum : 0.f;
    ls[u] = sum > 0.f ? 0.5f : 0.f;
  }
  for (int t = wg; t < nt; t += R::kWGs) {
    const int pos0 = blk.c0 + t * kWgPos;
    uint32_t p[kWgPos / 16][4];
    wg_scores<HD>(s, qs, ks + (t % R::kBufs) * W::kTileBytes);
    wg_mask(s, pos0, pos0 + kWgPos > first, lim0, lim1, blk.scale);
#pragma unroll
    for (int j = 0; j < kWgPos / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = i / 2;
        const float x = s[4 * j + i];
        s[4 * j + i] = x <= kNegInf * 0.5f ? 0.f : __expf(x - m[u]) * inv[u];
      }
#pragma unroll
    for (int kk = 0; kk < kWgPos / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wg_pv<HD>(o, p, vs + (t % R::kBufs) * W::kTileBytes);
  }
}

// Grid (B*K, n_split): one block per (row, kv head) and split of `span`
// positions (one split at the serving tables). Warp t < kBufs reads the page
// ids of stage t beside start and q_len and loads it by TMA, every buffer's
// at once; q arrives by cp.async meanwhile. Warpgroup w computes stages w, w +
// kWGs, ... with wg_stage (the warpgroup design's products and softmax over
// the tile's 64 rows) and refills each buffer it has finished. The
// warpgroups' states then merge in shared memory in warpgroup order, and
// warpgroup 0 writes the rows (one split) or the block's partial, whose
// splits merge as the other designs' do.
template <int HD>
__global__ void __launch_bounds__(Rw<HD>::kThreads, 1)
    ragged_rowwise_kernel(const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const Args a) {
  using W = Wg<HD>;
  using R = Rw<HD>;
  extern __shared__ unsigned char rw_smem_raw[];
  unsigned char* smem = rw_smem_raw + ((1024 - (smem_u32(rw_smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const int bk = blockIdx.x, c = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, tw = tid % 128;
  Block blk;
  blk.b = bk / a.K;
  blk.kh = bk - blk.b * a.K;
  blk.c0 = c * a.span;
  const int id = rw_page<HD>(a, blk.b, blk.c0, min(warp, R::kBufs - 1));
  blk.start = a.start_pos[blk.b];
  const int qn = min(max(a.q_lens[blk.b], 0), a.S);
  blk.row0 = 0;
  blk.rows = a.S * a.G;
  blk.live = min(max(qn * a.G, 0), blk.rows);
  blk.total = a.pmax * a.psz;
  blk.lim = blk.live > 0 ? max(min(blk.start + qn, blk.total), 0) : 0;
  blk.scale = rsqrtf((float)HD);
  if (blk.live == 0) {  // an idle row: block 0 writes its zeros
    if (c == 0) zero_rows<bf16, R::kThreads>(a, blk, 0);
    return;
  }
  const int nwork = cdiv(blk.lim, a.span);
  blk.c1 = min(blk.lim, blk.c0 + a.span);
  const int nt = c < nwork ? cdiv(blk.c1 - blk.c0, kWgPos) : 0;  // stages this block computes
  // One split whose stages all stay loaded: the exact softmax (rw_exact).
  const bool exact = a.nsplit == 1 && nt <= R::kBufs;

  float o[HD / 2];
  float m[2] = {kNegInf, kNegInf}, ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const int r0 = (warp % 4) * 16 + lane / 4;  // this lane's rows r0 and r0 + 8
  float* xo = reinterpret_cast<float*>(smem + R::kHead);  // [kWGs - 1][HD / 8][128] float4
  float* xml = xo + R::kXo / 4;                            // [kWGs - 1][m, l][64 rows]
  if (nt > 0) {
    const uint32_t qs = base + R::kHead, ks = qs + W::kQBytes, vs = ks + R::kBufs * W::kTileBytes;
    if (warp < R::kBufs && warp < nt) {
      // Barrier t is initialised before anything waits on or loads into it:
      // the first stages' by their issuing warps, the refills' by warp 0.
      if (lane == 0) mbar_init(base + 8 * warp, 1);
      if (warp == 0 && R::kBufs + lane < nt) mbar_init(base + 8 * (R::kBufs + lane), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      __syncwarp();
      rw_issue<HD>(&kmap, &vmap, a, blk, base, warp, id);
    }
    rw_load_q<HD, R::kThreads>(a, blk, smem + R::kHead);
    cp_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int lim0 = blk.limit(r0, a.G), lim1 = blk.limit(r0 + 8, a.G), first = blk.limit(0, a.G);
    if (exact) {
      rw_exact<HD>(o, m, ls, reinterpret_cast<float*>(smem + 1024), base, qs, ks, vs, blk, nt, lim0, lim1,
                   first);
    } else {
      float l[2] = {0.f, 0.f};
      for (int t = wg; t < nt; t += R::kWGs) {
        const int s = t % R::kBufs, pos0 = blk.c0 + t * kWgPos;
        const bool refill = t + R::kBufs < nt && warp == 4 * wg;
        const int next = refill ? rw_page<HD>(a, blk.b, blk.c0, t + R::kBufs) : 0;
        mbar_wait(base + 8 * t, 0);  // every barrier serves one stage: phase 0
        wg_stage<HD>(o, m, l, qs, ks + s * W::kTileBytes, vs + s * W::kTileBytes, pos0,
                     pos0 + kWgPos > first, lim0, lim1, blk.scale);
        if (t + R::kBufs < nt) {
          // Every warp of this warpgroup is done with buffer s: its first warp refills it.
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
          if (refill) rw_issue<HD>(&kmap, &vmap, a, blk, base, t + R::kBufs, next);
        }
      }
      ls[0] = quad_sum(l[0]);
      ls[1] = quad_sum(l[1]);
    }

    // The warpgroups' states merge in warpgroup order: each other warpgroup
    // leaves its accumulator and (m, l) over q and the stages, and warpgroup 0
    // rescales all of them to the rows' largest max and sums them.
    __syncthreads();  // every warpgroup is done with q and the stages
    if (wg > 0) {
      float4* dst = reinterpret_cast<float4*>(xo) + (size_t)(wg - 1) * (HD / 8) * 128 + tw;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        dst[j * 128] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
      if ((lane & 3) == 0)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          xml[(wg - 1) * 2 * kWgRows + r0 + 8 * u] = m[u];
          xml[(wg - 1) * 2 * kWgRows + kWgRows + r0 + 8 * u] = ls[u];
        }
    }
    __syncthreads();
    if (wg == 0) {
      float mx[2], w[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mx[u] = ls[u] > 0.f ? m[u] : kNegInf;
        for (int g = 1; g < R::kWGs; ++g)
          if (xml[(g - 1) * 2 * kWgRows + kWgRows + r0 + 8 * u] > 0.f)
            mx[u] = fmaxf(mx[u], xml[(g - 1) * 2 * kWgRows + r0 + 8 * u]);
        w[u] = ls[u] > 0.f ? __expf(m[u] - mx[u]) : 0.f;
        ls[u] *= w[u];
        m[u] = mx[u];
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= w[0];
        o[4 * j + 1] *= w[0];
        o[4 * j + 2] *= w[1];
        o[4 * j + 3] *= w[1];
      }
      for (int g = 1; g < R::kWGs; ++g) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float lg = xml[(g - 1) * 2 * kWgRows + kWgRows + r0 + 8 * u];
          w[u] = lg > 0.f ? __expf(xml[(g - 1) * 2 * kWgRows + r0 + 8 * u] - mx[u]) : 0.f;
          ls[u] += lg * w[u];
        }
        const float4* src = reinterpret_cast<const float4*>(xo) + (size_t)(g - 1) * (HD / 8) * 128 + tw;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const float4 x = src[j * 128];
          o[4 * j] += w[0] * x.x;
          o[4 * j + 1] += w[0] * x.y;
          o[4 * j + 2] += w[1] * x.z;
          o[4 * j + 3] += w[1] * x.w;
        }
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.out);
  if (a.nsplit == 1) {
    if (wg == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + 8 * u;
        if (r >= blk.live) continue;
        // One reciprocal a row: a division a value (a software sequence on
        // the card) cost 2b's 128 values a thread about 10,000 cycles.
        const float inv = __frcp_rn(fmaxf(ls[u], 1e-30f));
        uint32_t* dst = reinterpret_cast<uint32_t*>(out + blk.at(a, r));
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const float x = o[4 * j + 2 * u], y = o[4 * j + 2 * u + 1];
          dst[4 * j + (lane & 3)] = ls[u] > 0.f ? pack_bf16(x * inv, y * inv) : 0u;
        }
      }
    } else {  // the window's pad rows: exact zeros, 16 bytes a thread
      for (int e = tid - 128; e < (blk.rows - blk.live) * (HD / 8); e += R::kThreads - 128)
        reinterpret_cast<uint4*>(out + blk.at(a, blk.live + e / (HD / 8)))[e % (HD / 8)] =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // Split: this block's partial state (m, l and the unnormalised acc of the
  // live rows), then a ticket; the last block of the row merges in split order.
  float* part = a.part + (size_t)bk * a.nsplit * a.trows * HD;
  float* ml = a.ml + (size_t)bk * a.nsplit * 2 * a.trows;
  if (nt > 0 && wg == 0) {
    float* mine = part + (size_t)c * a.trows * HD;
    float* mml = ml + (size_t)c * 2 * a.trows;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 8 * u;
      if (r >= blk.live) continue;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(mine + (size_t)r * HD + 8 * j + 2 * (lane & 3)) =
            make_float2(o[4 * j + 2 * u], o[4 * j + 2 * u + 1]);
      if ((lane & 3) == 0) {
        mml[r] = m[u];
        mml[a.trows + r] = ls[u];
      }
    }
  }
  int* flag = reinterpret_cast<int*>(smem + 512);
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.tickets + bk, 1) == a.nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  merge<bf16, R::kThreads>(a, reinterpret_cast<float*>(smem + R::kHead), kWgRows, blk, nwork, part, ml,
                           BlockSync());
  if (tid == 0) a.tickets[bk] = 0;
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

enum Design { kMmaSync = 0, kWarpgroup = 1, kRowwise = 2 };

// Query tiles a window, rows a tile, splits a tile and the positions a
// split attends, from the shapes. mma_sync: 64-row tiles, as many splits of
// kChunk positions as the table names, fewer once the (row, kv-head, tile)
// blocks alone make about two an SM. warpgroup: 64-row tiles, split only
// while the blocks fill less than half the SMs (counting one an SM) and only
// into spans of at least kWgMinSpan positions: a split of one or two stages
// costs more in partials and merge than it saves (measured at the B 4 tier
// rows, 256 positions a row; longer rows gain from it). rowwise: one tile
// of the window's rows, one split of the whole table up to kRwMinSpan
// positions; a longer table splits while the blocks stay within one an SM,
// into spans of kRwMinSpan to kRwMaxSpan.
struct Grid {
  int ntiles, trows, nsplit, span;
};

constexpr int kWgMinSpan = 4 * kWgPos;

Grid grid_of(int design, int B, int S, int K, int G, int pmax, int psz) {
  Grid g;
  if (design == kRowwise) {
    const int total = pmax * psz, work = std::max(B * K, 1);
    const int want = std::max(cdiv(total, kRwMaxSpan),
                              std::max(1, std::min(cdiv(total, kRwMinSpan), sm_count() / work)));
    g.ntiles = 1;
    g.trows = S * G;
    g.span = cdiv(cdiv(total, want), kChunk) * kChunk;
    g.nsplit = cdiv(total, g.span);
    return g;
  }
  const bool wg = design == kWarpgroup;
  const int rows = wg ? kWgRows : kMaxRows;
  g.ntiles = cdiv(S * G, rows);
  g.trows = std::min(S * G, rows);
  const int total = pmax * psz, work = std::max(B * K * g.ntiles, 1);
  const int fill = wg ? sm_count() / (2 * work) : cdiv(2 * sm_count(), work);
  const int want = std::max(1, std::min(cdiv(total, wg ? kWgMinSpan : kChunk), fill));
  g.span = cdiv(cdiv(total, want), kChunk) * kChunk;
  g.nsplit = cdiv(total, g.span);
  return g;
}

// The launcher's mutex: several host threads launch at once (engines in one
// process). It guards the shared-memory grants and the tensor-map cache.
std::mutex launching;

// The attribute for dynamic shared memory is set once per device and size
// for an instantiation (it only grows), not on every launch; the check and
// the set are one step under `launching`, or a smaller size set last would
// shrink the limit a larger launch needs.
template <typename K>
cudaError_t grant(K kernel, size_t (&granted)[64], size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(launching);
  if (smem > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted[dev] = smem;
  }
  return cudaSuccess;
}

size_t mma_smem(const Grid& g, int hd, int elt) {
  return smem_layout(g.trows, hd, g.nsplit, g.span, elt).total;
}

template <typename T, int kPairs, bool kWide>
int launch(const Args& a, int B, cudaStream_t stream) {
  static size_t granted[64] = {};
  const size_t smem = smem_layout(a.trows, a.hd, a.nsplit, a.span, (int)sizeof(T)).total;
  const cudaError_t err = grant(ragged_paged_attention_kernel<T, kPairs, kWide>, granted, smem);
  if (err != cudaSuccess) return (int)err;
  ragged_paged_attention_kernel<T, kPairs, kWide>
      <<<dim3(B * a.K * a.ntiles, a.nsplit), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int kPairs>
int launch(const Args& a, int B, cudaStream_t stream) {
  return a.ntiles > 1 || a.span > kChunk ? launch<T, kPairs, true>(a, B, stream)
                                         : launch<T, kPairs, false>(a, B, stream);
}

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda at build).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kMapError = 10000;  // + CUresult: an encode the driver refused

// The tensor map of a pool viewed as [K*L*N*Psz, hd] bf16 rows, in boxes of
// Psz rows by min(hd, 64) columns, swizzled as wgmma reads them. Encoded
// once per (device, pool pointer, shape) and kept: the engine never
// rebinds its pools, so a map captured into a CUDA graph stays valid.
// Under `launching`.
int pool_map(const void* pool, long long rows, int hd, int psz, CUtensorMap* map) {
  struct Entry {
    int dev;
    const void* pool;
    long long rows;
    int hd, psz;
    CUtensorMap map;
  };
  static std::vector<Entry> cache;
  static EncodeTiled encode = nullptr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  for (const Entry& e : cache)
    if (e.dev == dev && e.pool == pool && e.rows == rows && e.hd == hd && e.psz == psz) {
      *map = e.map;
      return 0;
    }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                           &found);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const int cols = hd < 64 ? hd : 64;
  const cuuint64_t dims[2] = {(cuuint64_t)hd, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)hd * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)psz};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(pool), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kMapError + (int)r;
  if (cache.size() >= 256) cache.clear();  // pools come and go in tests; the engine keeps its own
  cache.push_back(Entry{dev, pool, rows, hd, psz, *map});
  return 0;
}

// The pools' tensor maps (pool_map), under `launching`.
int pool_maps(const Args& a, int hd, CUtensorMap* km, CUtensorMap* vm) {
  const long long rows = (long long)a.K * a.L * a.N * a.psz;
  std::lock_guard<std::mutex> hold(launching);
  const int err = pool_map(a.k_pages, rows, hd, a.psz, km);
  return err != 0 ? err : pool_map(a.v_pages, rows, hd, a.psz, vm);
}

template <int HD>
int launch_wg(const Args& a, int B, cudaStream_t stream) {
  static size_t granted[64] = {};
  const size_t smem = wg_smem<HD>(a.nsplit);
  CUtensorMap km, vm;
  const int map_err = pool_maps(a, HD, &km, &vm);
  if (map_err != 0) return map_err;
  const cudaError_t err = grant(ragged_wgmma_kernel<HD>, granted, smem);
  if (err != cudaSuccess) return (int)err;
  ragged_wgmma_kernel<HD><<<dim3(B * a.K * a.ntiles, a.nsplit), kWgThreads, smem, stream>>>(km, vm, a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_rw(const Args& a, int B, cudaStream_t stream) {
  static size_t granted[64] = {};
  const size_t smem = rw_smem<HD>(a.nsplit);
  CUtensorMap km, vm;
  const int map_err = pool_maps(a, HD, &km, &vm);
  if (map_err != 0) return map_err;
  const cudaError_t err = grant(ragged_rowwise_kernel<HD>, granted, smem);
  if (err != cudaSuccess) return (int)err;
  ragged_rowwise_kernel<HD><<<dim3(B * a.K, a.nsplit), Rw<HD>::kThreads, smem, stream>>>(km, vm, a);
  return (int)cudaGetLastError();
}

// Whether the warpgroup and rowwise designs take these shapes: bf16, a
// head_dim they are instantiated for, pages that tile a 64-position stage in
// whole 8-row swizzle atoms, and pool rows a 32-bit TMA coordinate reaches;
// rowwise also one query tile. The route itself is `kernel_design` in
// paged_attention.py.
bool tma_takes(int hd, int psz, int dtype, long long pool_rows) {
  return dtype == 1 && (hd == 32 || hd == 64 || hd == 128 || hd == 256) &&
         (psz == 8 || psz == 16 || psz == 32 || psz == 64) && pool_rows < (1LL << 31);
}

size_t smem_of(int design, const Grid& g, int hd, int dtype) {
  if (design == kWarpgroup) switch (hd) {
      case 32: return wg_smem<32>(g.nsplit);
      case 64: return wg_smem<64>(g.nsplit);
      case 128: return wg_smem<128>(g.nsplit);
      default: return wg_smem<256>(g.nsplit);
    }
  if (design == kRowwise) switch (hd) {
      case 32: return rw_smem<32>(g.nsplit);
      case 64: return rw_smem<64>(g.nsplit);
      case 128: return rw_smem<128>(g.nsplit);
      default: return rw_smem<256>(g.nsplit);
    }
  return mma_smem(g, hd, dtype == 1 ? 2 : 4);
}

}  // namespace

extern "C" {

// design: 0 = mma_sync, 1 = warpgroup, 2 = rowwise; dtype: 0 = float32, 1 = bfloat16.
// Fills plan[0..3] = tiles a window, rows a tile, splits a tile, positions
// a split; returns the dynamic shared memory one block needs (the wrapper
// refuses shapes above the card's per-block limit before launching). The
// scratch holds B*K*tiles*splits partials, the tickets B*K*tiles counters.
size_t mcpx_ragged_paged_attention_plan(int B, int S, int K, int G, int hd, int psz, int pmax,
                                        int dtype, int design, int* plan) {
  const Grid g = grid_of(design, B, S, K, G, pmax, psz);
  plan[0] = g.ntiles, plan[1] = g.trows, plan[2] = g.nsplit, plan[3] = g.span;
  return smem_of(design, g, hd, dtype);
}

// part [B*K*tiles, n_split, trows, hd] and ml [B*K*tiles, n_split, 2,
// trows] are fp32 scratch (any contents; unused by a warpgroup or rowwise
// launch of one split); tickets [B*K*tiles] int32 must be zero and are left zero.
// Returns cudaGetLastError() after the launch (0 = launched), a CUDA error
// before it, or kMapError + a CUresult. Enqueues on `stream`; does not
// synchronise.
int mcpx_ragged_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                const void* page_table, const void* start_pos,
                                const void* q_lens, void* out, void* part, void* ml,
                                void* tickets, int B, int S, int K, int G, int hd, int L, int N,
                                int psz, int pmax, int layer, int dtype, int design, void* stream) {
  if (B == 0 || K == 0 || S == 0) return 0;
  if (design != kMmaSync && !tma_takes(hd, psz, dtype, (long long)K * L * N * psz))
    return (int)cudaErrorInvalidValue;
  if (design == kRowwise && S * G > kWgRows) return (int)cudaErrorInvalidValue;
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
  const Grid g = grid_of(design, B, S, K, G, pmax, psz);
  a.ntiles = g.ntiles, a.trows = g.trows, a.nsplit = g.nsplit, a.span = g.span;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == kWarpgroup) switch (hd) {
      case 32: return launch_wg<32>(a, B, st);
      case 64: return launch_wg<64>(a, B, st);
      case 128: return launch_wg<128>(a, B, st);
      default: return launch_wg<256>(a, B, st);
    }
  if (design == kRowwise) switch (hd) {
      case 32: return launch_rw<32>(a, B, st);
      case 64: return launch_rw<64>(a, B, st);
      case 128: return launch_rw<128>(a, B, st);
      default: return launch_rw<256>(a, B, st);
    }
  if (dtype != 1) return launch<float, kWidePairs>(a, B, st);  // kPairs unused by fp32
  // The narrow build while two warps of kNarrowPairs pairs cover head_dim.
  return hd <= 2 * 16 * kNarrowPairs ? launch<bf16, kNarrowPairs>(a, B, st)
                                     : launch<bf16, kWidePairs>(a, B, st);
}

}  // extern "C"
