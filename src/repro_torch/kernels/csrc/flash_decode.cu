// One-token GQA decode attention for Hopper (sm_90a): the contiguous and the
// paged entry share one kernel body per route.
//
// Replaces src/repro/kernels/flash_decode.py:
//   flash_decode       (_decode_kernel, pallas_call at :127)  -> PAGED=false
//   flash_decode_paged (_paged_kernel,  pallas_call at :241)  -> PAGED=true
//
// What bounds it on the H100: bytes, and at the serve shapes the latency
// of a few dependent memory round trips. Each (row, kv head) reads its
// live K/V once (2 * len * hd elements) and does 4 * G * len * hd flops on
// them, about G flops per byte in bf16, two orders of magnitude under the
// card's ~295 flop/byte balance point; and the whole call moves a few MB,
// a microsecond of HBM time. The first design (one block per (row, kv
// head), 64 blocks at qwen3's serve shape, each walking its row four
// positions a warp at a time with a load, shuffle reductions and expf in
// one dependent chain per step) spent ~40 us on that chain. This design
// shortens the chain:
//
// * Flash-decoding: the grid is (split, kv head, row). The wrapper's
//   _splits cuts each row's capacity into chunks of a multiple of 16
//   positions from the static shapes alone (the lengths are never read on
//   the host), no shorter than what one block keeps in flight (tc: 256
//   positions, simt: 16) and otherwise enough for two blocks per SM. On
//   the H100 a split costs more (its partial, a ticket, the merge's reads:
//   ~3 dependent round trips) than a block's walk of 256 more positions, so
//   at the serve shapes (capacity 160) the tc route walks a row in one
//   block, and hymba's 1,132-position generate cache in 5. A block
//   whose chunk lies wholly past its row's length, or before its window,
//   returns after reading the length: it loads no K/V and writes nothing.
//   A row with one live chunk writes its output directly; otherwise each
//   live split writes its (m, l, f32 [G, hd] sum) partial to scratch the
//   wrapper allocates, takes a ticket (atomicInc on a per-(row, kv head)
//   counter that the last ticket returns to 0), and the last one merges the
//   live partials by logsumexp, as decode_attend's merge_axis merge does
//   (src/repro/models/attention.py:158). One launch, nothing allocated in
//   the kernel. A row of length 0 gets exact zeros from split 0.
// * The paged entry reads block_tab[b, p / page_size] itself and the pool
//   page in place (no gathered per-row view); -1 pages are never read (their
//   positions are masked). The table entries of a warp's first tiles are
//   read together with the length and q, not after them.
//
// tc (bf16 q, bf16 or fp8 e4m3 K/V, hd 16 / 32 / 64 / 128 / 256, 16-byte
// aligned rows): the GQA group on the tensor cores. A block has 8 warps
// (tc_warps; fewer at hd 256, below); the
// first min(8, chunk / 16) take the chunk's 16-position tiles round-robin,
// each copying its tiles with 16-byte cp.async into its own 2-stage ring
// in shared memory (a warp's first two tiles are in flight together, the
// next lands during a tile's math; only __syncwarp, no block barrier in the
// loop; a tile's rows each resolve their own page, so any page size
// works), and all 8 share the merge and the stores. S^T = K q^T on
// mma.sync.m16n8k16 with the 16 positions on M and the G <= 8 query rows on
// N (the swap gmm_tc_decode makes, moe_gmm.cu), q's B fragments loaded
// once into registers; the online softmax runs on log2(e)-scaled scores
// with exp2f, one max reduction over a tile's positions (3 shuffles a
// query row), no shuffle per position; P is rounded to bf16 and turned
// from S^T's accumulator layout into P^T's B fragment by movmatrix.trans,
// and O^T += V^T P^T takes V^T from an ldmatrix.trans of the V tile (hd on
// M). fp8 tiles are widened to bf16 in shared memory after they land
// (exact for e4m3). The warps' (m, l, O) merge through shared memory, then
// the split step above.
//
// At hd 256 (gemma3-1b's global layers, G 4; G 1 on a tp shard) shared
// memory bounds the block: a warp's ring is 33,792 bytes (34,304 over an
// fp8 pool), so 8 warps would need 270,336 of the 232,448 a block may
// take. A block there has TC_WARPS_HD256 warps (PERF.md: 3, 4 and 6
// measured in turns), and kernels/flash_decode.py's split span follows
// (2 stages x 16 positions a warp). Registers do not bound it: O^T is 16
// m16 tiles (64 f32 a lane) and q's B fragments 32 registers. The merge
// (8 x 258 floats a warp) still fits in the rings.
//
// A numerical difference: the Pallas kernel multiplies P V in f32
// (src/repro/kernels/flash_decode.py); the tc route rounds P to bf16 first
// (~2^-9 relative on each weight), inside the bf16 tolerance of 5e-2
// against the plain version, as attn_tc_kernel does.
//
// simt (f32, bf16 with rows the tc route cannot copy): the
// first design's f32-FMA walk over the block's chunk (each lane owns
// hd / 32 consecutive elements, four positions a warp per step, vector
// loads where the rows are aligned and element loads where not), with the
// same split step (its chunks are short: each step of the walk is a
// dependent load, so it wants more blocks). f32 stays true f32: no TF32
// (the f32 parity checks hold at 2e-5).
#include <cmath>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::DType;
using repro::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr int MAXG = 8;       // query rows per kv head (H / KV): N of the tc products
constexpr int NW = 4;         // simt: warps a block
constexpr int U = 4;          // simt: positions a warp takes per step
constexpr int TILE = 16;      // tc: positions a tile (M of S^T)
constexpr int NWT = 8;        // tc: warps a block ...
constexpr int TC_WARPS_HD256 = 6;  // ... at hd 256, where a warp's ring is 33 KB
constexpr int STAGES = 2;     // tc: a warp's K/V tiles in flight
constexpr int MAX_SPLITS = 64;  // kernels/flash_decode.py:MAX_SPLITS
constexpr unsigned FULL = 0xffffffffu;

struct DecodeArgs {
  const void* q;          // [B, H, hd] contiguous
  const void* k;          // contiguous: [B, KV, S, hd] strided view
  const void* v;          //   paged: pool [groups, P1, ps, KV, hd] contiguous
  void* out;              // [B, H, hd] contiguous, q's dtype
  const int* lengths;     // [B] live positions per row
  const int* block_tab;   // paged: [B, npg], -1 = unmapped
  float* part;            // nsplit > 1: acc [B*KV*nsplit][G][hd], then m, l [..][G]
  unsigned* tickets;      // nsplit > 1: [B*KV] counters, 0 between launches
  int B, H, KV, G;
  int cap;                // contiguous: S; paged: npg * ps
  int window;             // > 0: only positions >= length - window
  long long sb, sh, ss;   // contiguous view strides (elements)
  int P1, ps, npg, layer; // paged pool geometry and group index
  int nsplit, chunk;      // splits of a row and the positions each covers
  int vec;                // simt: q and K/V rows allow vector loads
  float sl2;              // hd^-1/2 log2(e): scores in log2 units
};

// A row's live positions [lo, hi) and its live splits [s_lo, s_lo + n_live).
struct Span {
  int lo, hi, s_lo, n_live;
};

__device__ __forceinline__ Span row_span(const DecodeArgs& a, int b) {
  const int len = a.lengths[b];
  Span sp{a.window > 0 ? max(0, len - a.window) : 0, min(max(len, 0), a.cap), 0, 0};
  if (sp.hi > sp.lo) {
    sp.s_lo = sp.lo / a.chunk;
    sp.n_live = (sp.hi - 1) / a.chunk - sp.s_lo + 1;
  }
  return sp;
}

// Whether split s of the row does anything; a row with no live position
// gets its zeros from split 0.
template <typename TQ, int HD>
__device__ __forceinline__ bool split_live(const DecodeArgs& a, const Span& sp, int b, int h,
                                           int s) {
  if (sp.n_live == 0) {
    if (s == 0) {
      TQ* out = static_cast<TQ*>(a.out) + (static_cast<long long>(b) * a.H + h * a.G) * HD;
      for (int i = threadIdx.x; i < a.G * HD; i += blockDim.x) repro::from_f(0.f, out + i);
    }
    return false;
  }
  return s >= sp.s_lo && s < sp.s_lo + sp.n_live;
}

// Element offset of position p's K/V row of kv head h in row b; -1 where
// the paged entry's page is unmapped. `page` is block_tab's entry for p.
template <int HD, bool PAGED>
__device__ __forceinline__ long long kv_row(const DecodeArgs& a, int b, int h, int p, int page) {
  if constexpr (PAGED) {
    return page < 0 ? -1
                    : ((static_cast<long long>(a.layer) * a.P1 + page) * a.ps + p % a.ps) *
                              a.KV * HD + static_cast<long long>(h) * HD;
  } else {
    return b * a.sb + h * a.sh + p * a.ss;
  }
}

template <bool PAGED>
__device__ __forceinline__ int page_of(const DecodeArgs& a, int b, int p) {
  if constexpr (PAGED) return a.block_tab[static_cast<long long>(b) * a.npg + p / a.ps];
  return 0;
}

// The block's state per query row g < G and element d, merged over its nw
// warps' states in shared memory (Wm, Wl [nw][MAXG]; Wo [nw][MAXG][HD];
// scores in log2 units): to the output when the row has one live split;
// else to split s's partial, and the last live split of (row, kv head) to
// arrive merges every live partial and writes the output.
template <typename TQ, int HD>
__device__ void finish(const DecodeArgs& a, const Span& sp, int b, int h, int s, int nw,
                       const float* Wm, const float* Wl, const float* Wo) {
  const int G = a.G;
  TQ* out = static_cast<TQ*>(a.out) + (static_cast<long long>(b) * a.H + h * G) * HD;
  const long long pair = static_cast<long long>(b) * a.KV + h;
  const long long nparts = static_cast<long long>(a.B) * a.KV * a.nsplit;
  float* pacc = a.part;
  float* pm = pacc + nparts * G * HD;
  float* pl = pm + nparts * G;
  const long long me = pair * a.nsplit + s;
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, Wm[w * MAXG + g]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float c = exp2f(Wm[w * MAXG + g] - M);
      L = fmaf(Wl[w * MAXG + g], c, L);
      O = fmaf(Wo[(w * MAXG + g) * HD + d], c, O);
    }
    if (sp.n_live == 1) {
      repro::from_f(O / fmaxf(L, 1e-30f), out + i);
    } else {
      pacc[me * G * HD + i] = O;
      if (d == 0) {
        pm[me * G + g] = M;
        pl[me * G + g] = L;
      }
    }
  }
  if (sp.n_live == 1) return;
  __shared__ bool last;
  __threadfence();   // this split's partial is visible device-wide ...
  __syncthreads();   // ... from every thread, before the ticket
  if (threadIdx.x == 0) {
    const unsigned n = static_cast<unsigned>(sp.n_live - 1);
    last = atomicInc(a.tickets + pair, n) == n;   // the last ticket wraps the counter to 0
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the live splits' (m, l) into shared memory at once; one warp a query
  // row turns them into weights exp2(m_j - M) / L (lane j, j + 32); then
  // every output element is one load a split, weighted
  __shared__ float wt[MAX_SPLITS][MAXG], ls[MAX_SPLITS][MAXG];
  const long long first = pair * a.nsplit + sp.s_lo;
  for (int i = threadIdx.x; i < sp.n_live * G; i += blockDim.x) {
    wt[i / G][i % G] = __ldcg(pm + first * G + i);
    ls[i / G][i % G] = __ldcg(pl + first * G + i);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int g = warp; g < G; g += nwarps) {
    const bool in0 = lane < sp.n_live, in1 = lane + 32 < sp.n_live;
    const float m0 = in0 ? wt[lane][g] : NEG_INF, m1 = in1 ? wt[lane + 32][g] : NEG_INF;
    float M = fmaxf(m0, m1);
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, x));
    const float c0 = in0 ? exp2f(m0 - M) : 0.f, c1 = in1 ? exp2f(m1 - M) : 0.f;
    const float L = repro::warp_sum((in0 ? ls[lane][g] * c0 : 0.f) +
                                    (in1 ? ls[lane + 32][g] * c1 : 0.f));
    const float inv = 1.f / fmaxf(L, 1e-30f);
    if (in0) wt[lane][g] = c0 * inv;
    if (in1) wt[lane + 32][g] = c1 * inv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += blockDim.x) {
    const int g = i / HD;
    float O = 0.f;
#pragma unroll 8
    for (int j = 0; j < sp.n_live; ++j)
      O = fmaf(__ldcg(pacc + (first + j) * G * HD + i), wt[j][g], O);
    repro::from_f(O, out + i);
  }
}

// ---- simt: f32 FMA ------------------------------------------------------

// N consecutive elements widened to f32: one vector of up to 16 bytes where
// `vec`, else element by element
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, bool vec, float (&out)[N]) {
  if (vec) {
    repro::load_f32<T, N>(p, out);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = repro::to_f(p[e]);
  }
}

template <typename TQ, typename TKV, int HD, bool PAGED>
__global__ void __launch_bounds__(NW * 32) decode_simt_kernel(DecodeArgs a) {
  // each lane owns EPT consecutive elements; below hd 32 only the first
  // hd lanes hold any (the rest add zeros to the warp sums)
  constexpr int EPT = HD >= 32 ? HD / 32 : 1;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Span sp = row_span(a, b);
  if (!split_live<TQ, HD>(a, sp, b, h, s)) return;
  const bool owns = lane * EPT < HD, vec = a.vec;
  const int G = a.G;
  const int p0 = max(s * a.chunk, sp.lo), p1 = min((s + 1) * a.chunk, sp.hi);

  const TQ* q = static_cast<const TQ*>(a.q) +
                (static_cast<long long>(b) * a.H + static_cast<long long>(h) * G) * HD;
  float qr[MAXG][EPT], acc[MAXG][EPT], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G && owns) {
      load_row<TQ, EPT>(q + g * HD + lane * EPT, vec, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPT; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[g][e] = 0.f;
    m[g] = NEG_INF;
    l[g] = 0.f;
  }

  const TKV* K = static_cast<const TKV*>(a.k);
  const TKV* V = static_cast<const TKV*>(a.v);
  for (int base = p0 + warp * U; base < p1; base += NW * U) {
    float kf[U][EPT], vf[U][EPT];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u;
      const long long off = p < p1 ? kv_row<HD, PAGED>(a, b, h, p, page_of<PAGED>(a, b, p)) : -1;
      live[u] = off >= 0;  // uniform across the warp
      if (live[u] && owns) {
        load_row<TKV, EPT>(K + off + lane * EPT, vec, kf[u]);
        load_row<TKV, EPT>(V + off + lane * EPT, vec, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float sc[U][MAXG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float d = 0.f;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < EPT; ++e) d = fmaf(qr[g][e], kf[u][e], d);
          d = repro::warp_sum(d);
        }
        sc[u][g] = d * a.sl2;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (live[u]) mx = fmaxf(mx, sc[u][g]);
      const float corr = exp2f(m[g] - mx);
      float pu[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pu[u] = live[u] ? exp2f(sc[u][g] - mx) : 0.f;
        psum += pu[u];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        float t = acc[g][e] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) t = fmaf(pu[u], vf[u][e], t);
        acc[g][e] = t;
      }
      m[g] = mx;
    }
  }

  __shared__ float sm_m[NW][MAXG], sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][HD];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (owns) {
#pragma unroll
      for (int e = 0; e < EPT; ++e) sm_acc[warp][g][lane * EPT + e] = acc[g][e];
    }
  }
  __syncthreads();
  finish<TQ, HD>(a, sp, b, h, s, NW, &sm_m[0][0], &sm_l[0][0], &sm_acc[0][0][0]);
}

// ---- tc: the GQA group on the tensor cores (bf16 q) -----------------------

using repro::cp_async16;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::movmatrix_trans;
using repro::pack_bf16;

// Shared memory of one warp: STAGES x {K, V} tiles of 16 rows as they lie in
// memory (rows padded by 16 bytes), and for fp8 one {K, V} pair widened to
// bf16. After the loop the block reuses it for the warps' merge.
template <typename TKV, int HD>
__host__ __device__ constexpr int tc_warp_bytes() {
  return STAGES * 2 * TILE * (HD * static_cast<int>(sizeof(TKV)) + 16) +
         (sizeof(TKV) == 1 ? 2 * TILE * (HD + 8) * 2 : 0);
}

template <int HD>
__host__ __device__ constexpr int tc_warps() {
  return HD > 128 ? TC_WARPS_HD256 : NWT;
}

template <typename TKV, int HD, bool PAGED>
__global__ void __launch_bounds__((HD > 128 ? TC_WARPS_HD256 : NWT) * 32)
    decode_tc_kernel(DecodeArgs a) {
  static_assert(HD % 16 == 0 && HD <= 256 && STAGES == 2, "tiling");
  constexpr int NWB = tc_warps<HD>();
  constexpr bool F8 = sizeof(TKV) == 1;
  constexpr int SRB = HD * static_cast<int>(sizeof(TKV)) + 16;  // staged row bytes
  constexpr int RS = HD + 8;                                     // bf16 tile row stride
  constexpr int CH = HD * static_cast<int>(sizeof(TKV)) / 16;    // 16-byte chunks a row
  constexpr int EPC = 16 / static_cast<int>(sizeof(TKV));        // elements a chunk
  constexpr int KD = HD / 16;   // k16 steps of K q^T over hd; m16 tiles of O^T
  constexpr int WB = tc_warp_bytes<TKV, HD>();
  static_assert(MAXG * (HD + 2) * 4 <= WB, "the merge fits in the rings");
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // the block's NWB warps all merge and write; the first nw (a warp a tile
  // of the chunk, at most NWB) walk tiles, each with its own ring
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = min(NWB, a.chunk / TILE);
  const int g = lane >> 2, t = lane & 3, r16 = lane & 15;
  const int G = a.G;
  unsigned char* ring = smem + warp * WB;
  auto staged = [&](int st, int kv) {   // stage st's K (kv 0) or V (kv 1) tile
    return reinterpret_cast<TKV*>(ring + (st * 2 + kv) * TILE * SRB);
  };

  // read before the length is known, so all three reads are in flight
  // together: the paged entry's table entries for row r16 of the warp's
  // first tiles (chunk-relative: the paged entry has no window), and q as
  // the B fragments of K q^T (b0: q[g][16kk + 2t..], b1: +8)
  const int pc1 = min((s + 1) * a.chunk, a.cap);
  int page0[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    const int p = (s * a.chunk / TILE + warp + nw * i) * TILE + r16;
    page0[i] = PAGED && warp < nw && p < pc1 ? page_of<PAGED>(a, b, p) : 0;
  }
  const bf16* q = static_cast<const bf16*>(a.q) +
                  (static_cast<long long>(b) * a.H + static_cast<long long>(h) * G) * HD;
  uint32_t qb[KD][2];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + g * HD + kk * 16 + 2 * t);
    qb[kk][0] = g < G ? qw[0] : 0u;
    qb[kk][1] = g < G ? qw[4] : 0u;
  }
  const Span sp = row_span(a, b);
  if (!split_live<bf16, HD>(a, sp, b, h, s)) return;

  // the warp's tiles j0 + warp + nw i, i < nt, of the chunk's live tiles
  const int j0 = max(s * a.chunk, sp.lo) / TILE;
  const int j1 = (min(pc1, sp.hi) + TILE - 1) / TILE;
  const int nt = j1 - j0 > warp && warp < nw ? (j1 - j0 - warp + nw - 1) / nw : 0;
  // row r16 of the warp's tile i: its position, and its offset (-1 where it
  // is not read: outside [lo, hi) or on an unmapped page, `page` being
  // block_tab's entry for it)
  auto pos = [&](int i) { return (j0 + warp + nw * i) * TILE + r16; };
  auto row_off = [&](int i, int page) -> long long {
    const int p = pos(i);
    if (p < sp.lo || p >= sp.hi) return -1;
    return kv_row<HD, PAGED>(a, b, h, p, page);
  };
  const TKV* K = static_cast<const TKV*>(a.k);
  const TKV* V = static_cast<const TKV*>(a.v);
  auto copy_tile = [&](long long my, int st) {   // the tile whose row r16 is at `my`
#pragma unroll
    for (int j = 0; j < (TILE * CH + 31) / 32; ++j) {
      const int it = lane + 32 * j, r = (it / CH) % TILE, c = it % CH;
      const long long off = __shfl_sync(FULL, my, r);
      if (TILE * CH % 32 == 0 || it < TILE * CH) {
        const int at = r * (SRB / static_cast<int>(sizeof(TKV))) + c * EPC;
        cp_async16(staged(st, 0) + at, off >= 0 ? K + off + c * EPC : K, off >= 0);
        cp_async16(staged(st, 1) + at, off >= 0 ? V + off + c * EPC : V, off >= 0);
      }
    }
  };
  // bit r of the low (high) half: row r of the next (second) tile is read
  unsigned rows = 0;
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (i < nt) {
      const long long my = row_off(i, page0[i]);
      copy_tile(my, i);
      rows |= (__ballot_sync(FULL, my >= 0) & 0xffffu) << (16 * i);
    }
    repro::cp_async_commit();
  }

  float o[KD][4];   // O^T: rows d = 16 mt + g (+8), cols query rows 2t, 2t+1
#pragma unroll
  for (int mt = 0; mt < KD; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // query rows 2t, 2t+1

  for (int i = 0; i < nt; ++i) {
    repro::cp_async_wait<STAGES - 1>();   // tile i has landed
    __syncwarp();
    const int st = i % STAGES;
    const bf16* Kt;
    const bf16* Vt;
    if constexpr (F8) {   // widen both tiles to bf16 (exact for e4m3)
      bf16* wide = reinterpret_cast<bf16*>(ring + STAGES * 2 * TILE * SRB);
      for (int it = lane; it < 2 * TILE * CH; it += 32) {
        const int kv = it / (TILE * CH), r = it / CH % TILE, c = it % CH;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(ring + (st * 2 + kv) * TILE * SRB + r * SRB + c * 16);
        const __nv_fp8_e4m3* e8 = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = pack_bf16(repro::to_f(e8[2 * e]), repro::to_f(e8[2 * e + 1]));
        uint4* dst = reinterpret_cast<uint4*>(wide + (kv * TILE + r) * RS + c * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncwarp();
      Kt = wide;
      Vt = wide + TILE * RS;
    } else {
      Kt = staged(st, 0);
      Vt = staged(st, 1);
    }

    // S^T = K q^T: positions g, g + 8 (rows) x query rows 2t, 2t+1 (cols)
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      ldmatrix_x4(ka, Kt + r16 * RS + kk * 16 + (lane >> 4) * 8);
      mma_bf16(sc, ka, qb[kk][0], qb[kk][1]);
    }
    const bool v0 = rows >> g & 1u, v1 = rows >> (g + 8) & 1u;
    sc[0] = v0 ? sc[0] * a.sl2 : NEG_INF;
    sc[1] = v0 ? sc[1] * a.sl2 : NEG_INF;
    sc[2] = v1 ? sc[2] * a.sl2 : NEG_INF;
    sc[3] = v1 ? sc[3] * a.sl2 : NEG_INF;
    // each query row's max over the tile's 16 positions (lanes of one t)
    float mx0 = fmaxf(sc[0], sc[2]), mx1 = fmaxf(sc[1], sc[3]);
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, x));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    // a query row with no live position yet keeps p = 0
    sc[0] = n0 == NEG_INF ? 0.f : exp2f(sc[0] - n0);
    sc[1] = n1 == NEG_INF ? 0.f : exp2f(sc[1] - n1);
    sc[2] = n0 == NEG_INF ? 0.f : exp2f(sc[2] - n0);
    sc[3] = n1 == NEG_INF ? 0.f : exp2f(sc[3] - n1);
    l0 = l0 * c0 + sc[0] + sc[2];   // this lane's share; summed over g at the end
    l1 = l1 * c1 + sc[1] + sc[3];
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      o[mt][0] *= c0;
      o[mt][1] *= c1;
      o[mt][2] *= c0;
      o[mt][3] *= c1;
    }
    // P^T's B fragment (positions on K, query rows on N) is the transpose
    // of S^T's accumulator, 8 positions at a time
    const uint32_t pb0 = movmatrix_trans(pack_bf16(sc[0], sc[1]));
    const uint32_t pb1 = movmatrix_trans(pack_bf16(sc[2], sc[3]));
    // O^T += V^T P^T: V^T's A fragment (hd on M, positions on K) is an
    // ldmatrix.trans of the V tile ([position][hd])
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      uint32_t va[4];
      ldmatrix_x4_trans(va, Vt + ((lane >> 4) * 8 + (lane & 7)) * RS + mt * 16 +
                                ((lane >> 3) & 1) * 8);
      mma_bf16(o[mt], va, pb0, pb1);
    }
    __syncwarp();   // every lane is done with stage st
    rows >>= 16;
    if (i + STAGES < nt) {
      const int p = pos(i + STAGES);
      const long long my = row_off(i + STAGES, p < sp.hi ? page_of<PAGED>(a, b, p) : -1);
      copy_tile(my, st);
      rows |= (__ballot_sync(FULL, my >= 0) & 0xffffu) << 16;
    }
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();
#pragma unroll
  for (int x = 4; x < 32; x <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, x);
    l1 += __shfl_xor_sync(FULL, l1, x);
  }

  __syncthreads();   // every warp is done with its ring: the merge reuses them
  float* Wm = reinterpret_cast<float*>(smem);
  float* Wl = Wm + nw * MAXG;
  float* Wo = Wl + nw * MAXG;
  if (warp < nw) {   // the tile walkers' states (the others have none)
    if (lane < 4) {
      Wm[warp * MAXG + 2 * t] = m0;
      Wm[warp * MAXG + 2 * t + 1] = m1;
      Wl[warp * MAXG + 2 * t] = l0;
      Wl[warp * MAXG + 2 * t + 1] = l1;
    }
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      float* o0 = Wo + (warp * MAXG + 2 * t) * HD + mt * 16 + g;
      o0[0] = o[mt][0];
      o0[HD] = o[mt][1];
      o0[8] = o[mt][2];
      o0[HD + 8] = o[mt][3];
    }
  }
  __syncthreads();
  finish<bf16, HD>(a, sp, b, h, s, nw, Wm, Wl, Wo);
}

// ---- launch ---------------------------------------------------------------

template <typename TQ, typename TKV, int HD, bool PAGED>
int launch_simt(const DecodeArgs& a, cudaStream_t st) {
  const dim3 grid(a.nsplit, a.KV, a.B);
  decode_simt_kernel<TQ, TKV, HD, PAGED><<<grid, NW * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, int HD, bool PAGED>
int launch_tc(const DecodeArgs& a, cudaStream_t st) {
  constexpr int WB = tc_warp_bytes<TKV, HD>(), NWB = tc_warps<HD>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_tc_kernel<TKV, HD, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, NWB * WB);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int nw = min(NWB, a.chunk / TILE);   // the tile walkers' rings
  const dim3 grid(a.nsplit, a.KV, a.B);
  decode_tc_kernel<TKV, HD, PAGED><<<grid, NWB * 32, nw * WB, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool PAGED>
int launch_simt_hd(const DecodeArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_simt<TQ, TKV, 16, PAGED>(a, st);
    case 32: return launch_simt<TQ, TKV, 32, PAGED>(a, st);
    case 64: return launch_simt<TQ, TKV, 64, PAGED>(a, st);
    case 128: return launch_simt<TQ, TKV, 128, PAGED>(a, st);
    case 256: return launch_simt<TQ, TKV, 256, PAGED>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TKV, bool PAGED>
int launch_tc_hd(const DecodeArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_tc<TKV, 16, PAGED>(a, st);
    case 32: return launch_tc<TKV, 32, PAGED>(a, st);
    case 64: return launch_tc<TKV, 64, PAGED>(a, st);
    case 128: return launch_tc<TKV, 128, PAGED>(a, st);
    case 256: return launch_tc<TKV, 256, PAGED>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<size_t>(p) % bytes == 0; }

// q and the output share one dtype (f32 or bf16); K/V are that dtype or fp8.
// route 1: tc (bf16 q, 16-byte aligned rows); route 0: simt.
template <bool PAGED>
int dispatch(DecodeArgs& a, int hd, int q_dt, int kv_dt, int route, cudaStream_t st) {
  const int qb = q_dt == DType::F32 ? 4 : 2, kb = kv_dt == DType::FP8E4M3 ? 1 : qb;
  // the contiguous view's rows start on multiples of `bytes` (the stride of
  // a dim of length 1 is never stepped)
  auto rows_on = [&](int bytes) {
    return PAGED || ((a.B == 1 || a.sb * kb % bytes == 0) &&
                     (a.KV == 1 || a.sh * kb % bytes == 0) &&
                     (a.cap <= 1 || a.ss * kb % bytes == 0));
  };
  if (a.G < 1 || a.G > MAXG || a.chunk < TILE || a.chunk % TILE || a.nsplit < 1 ||
      a.nsplit > MAX_SPLITS ||
      static_cast<long long>(a.nsplit) * a.chunk < a.cap ||
      (a.nsplit > 1 && (a.part == nullptr || a.tickets == nullptr)) ||
      (q_dt != DType::F32 && q_dt != DType::BF16) ||
      (kv_dt != q_dt && kv_dt != DType::FP8E4M3))
    return static_cast<int>(cudaErrorInvalidValue);
  a.sl2 = static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(hd)));
  // the simt route's vector loads: EPT = max(1, hd / 32) elements a lane
  const int ept = hd >= 32 ? hd / 32 : 1, vq = min(16, ept * qb), vk = min(16, ept * kb);
  a.vec = aligned(a.q, vq) && aligned(a.k, vk) && aligned(a.v, vk) && rows_on(vk);
  if (route == 1) {
    const bool rows16 = aligned(a.q, 16) && aligned(a.k, 16) && aligned(a.v, 16) &&
                        hd * kb % 16 == 0 && rows_on(16);
    if (q_dt != DType::BF16 || !rows16) return static_cast<int>(cudaErrorInvalidValue);
    return kv_dt == DType::FP8E4M3 ? launch_tc_hd<__nv_fp8_e4m3, PAGED>(a, hd, st)
                                   : launch_tc_hd<bf16, PAGED>(a, hd, st);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dt == DType::F32 && kv_dt == DType::F32)
    return launch_simt_hd<float, float, PAGED>(a, hd, st);
  if (q_dt == DType::F32) return launch_simt_hd<float, __nv_fp8_e4m3, PAGED>(a, hd, st);
  if (kv_dt == DType::BF16) return launch_simt_hd<bf16, bf16, PAGED>(a, hd, st);
  return launch_simt_hd<bf16, __nv_fp8_e4m3, PAGED>(a, hd, st);
}

}  // namespace

// nsplit / chunk: kernels/flash_decode.py:_splits; part: nsplit > 1 only,
// [B * KV * nsplit * G * (hd + 2)] f32 scratch; tickets: [B * KV] zeroed
// counters the kernel leaves at 0. route: kernels/flash_decode.py:_route.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, void* out,
                                   const int* lengths, float* part, unsigned* tickets, int B,
                                   int H, int KV, int hd, int S, long long sb, long long sh,
                                   long long ss, int window, int nsplit, int chunk, int q_dt,
                                   int kv_dt, int route, void* stream) {
  DecodeArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.lengths = lengths; a.block_tab = nullptr;
  a.part = part; a.tickets = tickets;
  a.B = B; a.H = H; a.KV = KV; a.G = H / KV; a.cap = S; a.window = window;
  a.sb = sb; a.sh = sh; a.ss = ss;
  a.nsplit = nsplit; a.chunk = chunk;
  return dispatch<false>(a, hd, q_dt, kv_dt, route, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_decode_paged_launch(const void* q, const void* k_pool, const void* v_pool,
                                         void* out, const int* block_tab, const int* lengths,
                                         float* part, unsigned* tickets, int B, int H, int KV,
                                         int hd, int P1, int ps, int npg, int layer, int nsplit,
                                         int chunk, int q_dt, int kv_dt, int route, void* stream) {
  DecodeArgs a{};
  a.q = q; a.k = k_pool; a.v = v_pool; a.out = out; a.lengths = lengths;
  a.block_tab = block_tab; a.part = part; a.tickets = tickets;
  a.B = B; a.H = H; a.KV = KV; a.G = H / KV; a.cap = npg * ps; a.window = 0;
  a.P1 = P1; a.ps = ps; a.npg = npg; a.layer = layer;
  a.nsplit = nsplit; a.chunk = chunk;
  return dispatch<true>(a, hd, q_dt, kv_dt, route, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a tc block (bytes) of nw warps at head dim hd
// over a bf16 (fp8 = 0) or fp8 (fp8 = 1) pool; 0 where tc does not run. A
// block has at most 8 warps, TC_WARPS_HD256 at hd 256.
extern "C" int flash_decode_tc_smem_bytes(int hd, int fp8, int nw) {
  switch (hd) {
    case 16: return nw * (fp8 ? tc_warp_bytes<__nv_fp8_e4m3, 16>() : tc_warp_bytes<bf16, 16>());
    case 32: return nw * (fp8 ? tc_warp_bytes<__nv_fp8_e4m3, 32>() : tc_warp_bytes<bf16, 32>());
    case 64: return nw * (fp8 ? tc_warp_bytes<__nv_fp8_e4m3, 64>() : tc_warp_bytes<bf16, 64>());
    case 128: return nw * (fp8 ? tc_warp_bytes<__nv_fp8_e4m3, 128>() : tc_warp_bytes<bf16, 128>());
    case 256: return nw * (fp8 ? tc_warp_bytes<__nv_fp8_e4m3, 256>() : tc_warp_bytes<bf16, 256>());
    default: return 0;
  }
}
