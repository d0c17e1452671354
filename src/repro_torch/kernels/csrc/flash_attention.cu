// Causal GQA flash-attention forward for Hopper (sm_90a), with an optional
// sliding window.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_fwd
// (_attn_kernel, pallas_call at :94).
//
// Both routes keep the flash structure: one block per (64-row q tile, head
// or heads, row) loops over 64-row k tiles of the causal / window band only
// (tiles outside the band are never loaded) with the online softmax in f32
// registers, so no score matrix reaches device memory. The TPU grid carried
// m / l / acc in VMEM across a sequential k axis; here the k axis is the
// block's own loop. The ragged edge (S not a multiple of 64) is masked in
// place, instead of the Pallas wrapper's `while Sq % bq: bq -= 1` shrink. q
// aligns to the start of k; the wrapper refuses Sq != Sk (trap T1). The
// output is written through its strides into the [B, Sq, H, hd] memory the
// wrapper allocates. kernels/flash_attention.py:_route picks the route.
//
// What bounds it on the H100: at the serve path's prompt lengths (S <= a few
// hundred) bytes: at B 8, S 128, 16/8 heads of 128, q, k, v and the output
// once are 12.6 MB, 0.0038 ms at 3.35 TB/s, against 0.54 GFLOP of causal
// score and P V work, 0.0005 ms at 989 TFLOP/s (bf16 tensor cores); at long
// prompts (S ~ 1k and up) operations. Either way the products belong on the
// tensor cores, and at these sizes the launch has to be short.
//
// tc (bf16, hd 16 / 32 / 64 / 128 / 256, 16-byte aligned rows):
// flash-attention-2 on mma.sync.m16n8k16. 4 warps a query head, each owning
// 16 query rows, whose Q fragments are loaded once (ldmatrix) and held in
// registers up to hd 128. S = Q K^T
// comes from bf16 K tiles in shared memory (plain ldmatrix: K's rows are
// the n side); the online softmax runs in f32 registers on log2(e)-scaled
// scores with exp2f, its row max and sum reduced over the 4 lanes that
// share a row; P is cast to bf16 in registers, where the m16n8 accumulator
// layout of S already is the A-fragment layout of P V, so P never touches
// shared memory; V's fragments come through ldmatrix.trans. K/V tiles are
// double-buffered with 16-byte cp.async copies (the next tile lands while
// this one is multiplied); rows padded by 16 bytes keep ldmatrix free of
// bank conflicts. Tiles fully inside the band skip the mask. Where the GQA
// group is even (qwen3, granite: G 2) one block of 8 warps takes two query
// heads of one kv head, so each K/V tile is copied once for both; at G 5
// (hymba) a block takes one. The output goes through Q's shared-memory tile
// (Q is in registers by then) and leaves in 16-byte stores along hd. At
// long prompts the route stays short of SDPA (PERF.md): 16 query rows a
// warp reuse each K/V fragment once; 32 rows a warp (BQ 128), Q re-read
// from shared memory, is the next step.
//
// At hd 256 (gemma3-1b's global layers: 4 query heads over 1 kv head)
// registers bound the design: a warp's 16 rows x 256 f32 output
// accumulators are 128 registers a lane and S (16 x 64 f32) 32 more, so Q's
// fragments (64 more) would pass the 255 limit. There Q stays in its
// shared-memory tile and is re-read by ldmatrix on each k16 step of
// Q K^T (a warp's own 16 rows, so its output can still go through them at
// the end). Shared memory is the other bound: the 2-stage K/V ring and Q
// take (64 GB + 256) x 264 x 2 bytes, 168,960 at GB 1 and 202,752 at GB 2,
// one block an SM either way. A block takes TC_GB256 = 1 query head at hd
// 256: two heads sharing each K/V tile halve the blocks (32 at gemma3's B 8
// x S 128 on 132 SMs) and measured 1.25-1.4x slower (PERF.md;
// kernels/hd256_variants.py times both).
//
// A numerical difference: the Pallas kernel multiplies P V in f32
// (src/repro/kernels/flash_attention.py:63-66); here P is rounded to bf16
// before P V (~2^-9 relative on each weight), inside the bf16 tolerance of
// 5e-2 against the plain version.
//
// simt (f32; bf16 with rows not 16-byte aligned): the first
// design, kept: q / k / v tiles widened to f32 in shared memory, f32 FMAs
// for Q K^T and P V (4 x 4 scores and 4 x hd/16 outputs a thread), P
// through shared memory. f32 needs it: TF32 keeps three digits and would
// break the f32 parity checks (2e-5).
//
// Deliberately not yet: wgmma / TMA, 32 query rows a warp, a block for all
// G query heads at G 5 (or at G 4, hd 256: the K/V ring leaves no room).
#include <cmath>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::DType;
using repro::NEG_INF;

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // k rows per tile
constexpr int NT = 256;   // threads: 16 x 16, each owns 4 q rows x 4 k cols

struct AttnArgs {
  const void* q;          // [B, H, Sq, hd] strided, hd stride 1
  const void* k;          // [B, KV, Sk, hd] strided
  const void* v;
  void* out;              // [B, H, Sq, hd] strided
  int H, KV, G, Sq, Sk;
  int causal, window;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  float scale;
};

template <int HD>
constexpr int smem_bytes() {
  return (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1)) * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) attn_kernel(AttnArgs a) {
  constexpr int DC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][HD + 1]
  float* Ks = Qs + BQ * (HD + 1);         // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);         // [BK][HD]
  float* Ps = Vs + BK * HD;               // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const T* Q = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* K = static_cast<const T*>(a.k) + b * a.kb + kvh * a.kh;
  const T* V = static_cast<const T*>(a.v) + b * a.vb + kvh * a.vh;
  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, gq = q0 + r;
    Qs[r * (HD + 1) + d] = gq < a.Sq ? repro::to_f(Q[gq * a.qs + d]) : 0.f;
  }

  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // the causal / window band of this q tile
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int i = tid; i < BK * HD; i += NT) {
      const int r = i / HD, d = i % HD, gk = k0 + r;
      const bool in = gk < a.Sk;
      Ks[r * (HD + 1) + d] = in ? repro::to_f(K[gk * a.ks + d]) : 0.f;
      Vs[r * HD + d] = in ? repro::to_f(V[gk * a.vs + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gq = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + tx + 16 * j;
        ok[j] = gk < a.Sk && gq < a.Sq && (!a.causal || gq >= gk) &&
                (a.window <= 0 || gq - gk < a.window);
        s[i][j] = ok[j] ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a q row are lanes [16 * (ty % 2), +16) of one warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * HD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

  T* O = static_cast<T*>(a.out) + b * a.ob + h * a.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty + 16 * i;
    if (gq >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
      repro::from_f(acc[i][cc] * inv, O + gq * a.os + tx + 16 * cc);
  }
}

template <typename T, int HD>
int launch(const AttnArgs& a, int B, cudaStream_t st) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(attn_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  attn_kernel<T, HD><<<grid, NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const AttnArgs& a, int B, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(a, B, st);
    case 32: return launch<T, 32>(a, B, st);
    case 64: return launch<T, 64>(a, B, st);
    case 128: return launch<T, 128>(a, B, st);
    case 256: return launch<T, 256>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the bf16 tensor-core route --------------------------------------------

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;

// GB query heads of one kv head a block, 4 warps (64 query rows) a head, 16
// rows a warp; K/V tiles through a KST-deep cp.async ring shared by the GB
// heads. Q's tile doubles as the output tile at the end.
constexpr int TC_KST = 2;   // K/V stages: 3 measured no faster (PERF.md)
constexpr int TC_GB256 = 1;  // heads a block at hd 256 where G is even (1 or 2: PERF.md)

constexpr int tc_smem_bytes(int hd, int gb, int kst) {
  return (gb * BQ + 2 * kst * BK) * (hd + 8) * 2;
}

template <int HD, int GB, int KST>
__global__ void __launch_bounds__(128 * GB) attn_tc_kernel(AttnArgs a) {
  static_assert(HD % 16 == 0 && HD <= 256 && BQ == 64 && BK == 64 && KST >= 2, "tiling");
  constexpr bool QREG = HD <= 128;   // Q's fragments in registers (else re-read)
  constexpr int NTH = 128 * GB;
  constexpr int RS = HD + 8;     // shared-memory row stride (16 bytes of padding)
  constexpr int CH = HD / 8;     // 16-byte chunks a row
  constexpr int KD = HD / 16;    // k16 steps over hd (Q K^T)
  constexpr int ND = HD / 8;     // n8 tiles over hd (P V)
  constexpr int NS = BK / 8;     // n8 tiles over a k tile's keys (Q K^T)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [GB * BQ][RS]
  bf16* Ks = Qs + GB * BQ * RS;                   // [KST][BK][RS]
  bf16* Vs = Ks + KST * BK * RS;                  // [KST][BK][RS]

  const int q0 = blockIdx.x * BQ, h0 = blockIdx.y * GB, b = blockIdx.z;
  const int kvh = h0 / a.G;                       // GB divides G
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int li = lane / 8, lr = lane % 8;
  const int qr = warp * 16;                       // this warp's rows of Qs
  const int hw = warp / 4;                        // ... of head h0 + hw
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.qb + h0 * a.qh;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.kb + kvh * a.kh;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.vb + kvh * a.vh;

#pragma unroll
  for (int j = 0; j < (GB * BQ * CH + NTH - 1) / NTH; ++j) {
    const int i = tid + j * NTH, r = i / CH, c = i % CH * 8, gq = q0 + r % BQ;
    if (GB * BQ * CH % NTH != 0 && i >= GB * BQ * CH) break;
    const bool in = gq < a.Sq;
    cp_async16(Qs + r * RS + c, in ? Q + r / BQ * a.qh + gq * a.qs + c : Q, in);
  }
  auto load_kv = [&](int kt, int s) {
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < (BK * CH + NTH - 1) / NTH; ++j) {
      const int i = tid + j * NTH, r = i / CH, c = i % CH * 8;
      if (BK * CH % NTH != 0 && i >= BK * CH) break;
      const bool in = k0 + r < a.Sk;
      cp_async16(Ks + (s * BK + r) * RS + c, in ? K + (k0 + r) * a.ks + c : K, in);
      cp_async16(Vs + (s * BK + r) * RS + c, in ? V + (k0 + r) * a.vs + c : V, in);
    }
  };

  // the causal / window band of this q tile
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt0 = k_begin / BK, kt1 = (k_end + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < KST - 1; ++s) {   // Q rides with the first K/V tile
    if (kt0 + s < kt1) load_kv(kt0 + s, s);
    repro::cp_async_commit();
  }

  uint32_t qf[QREG ? KD : 1][4];
  float o[ND][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[n][q] = 0.f;
  const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2 units
  const int row0 = q0 + qr % BQ + lane / 4;           // rows row0, row0 + 8

  for (int kt = kt0; kt < kt1; ++kt) {
    repro::cp_async_wait<KST - 2>();   // k tile kt (and Q) has landed
    __syncthreads();                   // ... for every thread; stage kt - 1 is free
    if (kt + KST - 1 < kt1) load_kv(kt + KST - 1, (kt - kt0 + KST - 1) % KST);
    repro::cp_async_commit();
    if constexpr (QREG) {
      if (kt == kt0) {
#pragma unroll
        for (int d = 0; d < KD; ++d)
          ldmatrix_x4(qf[d], Qs + (qr + lane % 16) * RS + d * 16 + lane / 16 * 8);
      }
    }
    const int s = (kt - kt0) % KST;
    const bf16* Kt = Ks + s * BK * RS;
    const bf16* Vt = Vs + s * BK * RS;

    // S = Q K^T: K is [key][hd], so plain ldmatrix gives b0/b1 of the key
    // n-tiles j and j + 1
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[j][q] = 0.f;
#pragma unroll
    for (int d = 0; d < KD; ++d) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int x = 0; x < 4; ++x) qa[x] = qf[d][x];
      } else {
        ldmatrix_x4(qa, Qs + (qr + lane % 16) * RS + d * 16 + lane / 16 * 8);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j * 8 + li / 2 * 8 + lr) * RS + d * 16 + li % 2 * 8);
        mma_bf16(sc[j], qa, kf[0], kf[1]);
        mma_bf16(sc[j + 1], qa, kf[2], kf[3]);
      }
    }

    // mask (only where the tile crosses the band's or the sequence's edge)
    // and the online softmax; a row's 8 keys of a tile sit in lanes 4g..4g+3
    const int k0 = kt * BK;
    const bool full = k0 + BK <= a.Sk && (!a.causal || k0 + BK - 1 <= q0) &&
                      (a.window <= 0 || q0 + BQ - 1 - k0 < a.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gq = row0 + q / 2 * 8, gk = k0 + j * 8 + lane % 4 * 2 + q % 2;
        const bool ok = full || (gk < a.Sk && (!a.causal || gq >= gk) &&
                                 (a.window <= 0 || gq - gk < a.window));
        sc[j][q] = ok ? sc[j][q] * sl2 : NEG_INF;
        mx[q / 2] = fmaxf(mx[q / 2], sc[j][q]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = exp2f(m[hr] - m_new);
      m[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // a row with no key in the band yet keeps p = 0
        const float p = m[q / 2] == NEG_INF ? 0.f : exp2f(sc[j][q] - m[q / 2]);
        sc[j][q] = p;
        rs[q / 2] += p;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
      l[hr] = l[hr] * corr[hr] + rs[hr];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }

    // O += P V: S's accumulators of key tiles 2kk, 2kk + 1 are P's A
    // fragment for keys 16kk..16kk+15; V is [key][hd], so .trans gives b0/b1
    // of the hd n-tiles n and n + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + li % 2 * 8 + lr) * RS + n * 8 + li / 2 * 8);
        mma_bf16(o[n], pa, vf[0], vf[1]);
        mma_bf16(o[n + 1], pa, vf[2], vf[3]);
      }
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();   // every copy has landed before Q's tile takes the output

  // the warp's 16 output rows into its own rows of Q's tile (which only
  // this warp reads), then out in 16-byte stores along hd
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.f / fmaxf(l[hr], 1e-30f);
    bf16* row = Qs + (qr + lane / 4 + hr * 8) * RS + lane % 4 * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
  }
  __syncwarp();
  bf16* O = static_cast<bf16*>(a.out) + b * a.ob + (h0 + hw) * a.oh;
#pragma unroll
  for (int j = 0; j < (16 * CH + 31) / 32; ++j) {
    const int i = lane + j * 32, r = i / CH, c = i % CH * 8, gq = q0 + qr % BQ + r;
    if ((16 * CH % 32 == 0 || i < 16 * CH) && gq < a.Sq)
      *reinterpret_cast<uint4*>(O + gq * a.os + c) =
          *reinterpret_cast<const uint4*>(Qs + (qr + r) * RS + c);
  }
}

template <int HD, int GB, int KST>
int launch_tc(const AttnArgs& a, int B, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes(HD, GB, KST);
  cudaError_t e = cudaFuncSetAttribute(attn_tc_kernel<HD, GB, KST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H / GB, B);
  attn_tc_kernel<HD, GB, KST><<<grid, 128 * GB, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// what the tensor-core route needs (kernels/flash_attention.py:_route
// decides the same from the tensors): 16-byte aligned bases and strides in
// multiples of 8 elements (of dims longer than 1) for q, k, v and out
bool tc_ok(const AttnArgs& a, int B) {
  auto ok = [](long long stride, int n) { return n == 1 || stride % 8 == 0; };
  auto al = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  return al(a.q) && al(a.k) && al(a.v) && al(a.out) && ok(a.qb, B) && ok(a.qh, a.H) &&
         ok(a.qs, a.Sq) && ok(a.kb, B) && ok(a.kh, a.KV) && ok(a.ks, a.Sk) && ok(a.vb, B) &&
         ok(a.vh, a.KV) && ok(a.vs, a.Sk) && ok(a.ob, B) && ok(a.oh, a.H) && ok(a.os, a.Sq);
}

template <int GB, int KST>
int launch_tc_hd(const AttnArgs& a, int B, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_tc<16, GB, KST>(a, B, st);
    case 32: return launch_tc<32, GB, KST>(a, B, st);
    case 64: return launch_tc<64, GB, KST>(a, B, st);
    case 128: return launch_tc<128, GB, KST>(a, B, st);
    case 256: return launch_tc<256, GB == 1 ? 1 : TC_GB256, KST>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements; the last (hd) stride of every operand is 1.
// route: 0 simt (f32 or bf16), 1 tc (bf16); kernels/flash_attention.py:_route
// picks it before the launch.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H, int KV, int Sq,
    int Sk, int hd, int causal, int window, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os, int dt, int route, void* stream) {
  AttnArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.H = H; a.KV = KV; a.G = H / KV; a.Sq = Sq; a.Sk = Sk;
  a.causal = causal; a.window = window;
  a.qb = qb; a.qh = qh; a.qs = qs; a.kb = kb; a.kh = kh; a.ks = ks;
  a.vb = vb; a.vh = vh; a.vs = vs; a.ob = ob; a.oh = oh; a.os = os;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dt != DType::BF16 || !tc_ok(a, B)) return static_cast<int>(cudaErrorInvalidValue);
    // two query heads a block where the GQA group is even
    return a.G % 2 ? launch_tc_hd<1, TC_KST>(a, B, hd, st)
                   : launch_tc_hd<2, TC_KST>(a, B, hd, st);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dt == DType::F32) return launch_hd<float>(a, B, hd, st);
  if (dt == DType::BF16) return launch_hd<__nv_bfloat16>(a, B, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a block takes (bytes) at head dim hd: route 1
// the tensor-core kernel with gb query heads a block (1 or 2), route 0 the
// simt kernel.
extern "C" int flash_attention_smem_bytes(int hd, int gb, int route) {
  if (route) return hd % 16 == 0 && hd <= 256 ? tc_smem_bytes(hd, gb, TC_KST) : 0;
  switch (hd) {
    case 16: return smem_bytes<16>();
    case 32: return smem_bytes<32>();
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 256: return smem_bytes<256>();
    default: return 0;
  }
}
