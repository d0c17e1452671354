// Grouped (expert-batched) matmul of the MoE expert FFN for Hopper (sm_90a).
//
// Replaces src/repro/kernels/moe_gmm.py: grouped_matmul (_gmm_kernel,
// pallas_call at :49).
//
//   out[e, c, n] = sum_k x[e, c, k] w[e, k, n]
//   x [E, C, d], w [E, d, f] -> out [E, C, f]
//
// The contract is the Pallas kernel's: products of the inputs, sums over d
// in f32, one cast to x's dtype at the end. A bf16 x bf16 product is exact
// in f32, so a bf16 tensor-core product with f32 accumulation computes the
// same function; only the order of the sums differs.
//
// The TPU grid walks (e, c-block, f-block, d-block) in order and carries the
// [bc, bf] accumulator in VMEM across the innermost d axis. Here one block
// owns one output tile and walks d itself with the accumulator in
// registers. The wrapper (kernels/moe_gmm.py:_route) picks one of three
// routes from dtype, shape, strides and alignment before the launch:
//
// tc_prefill (bf16, C > 16; granite's prefill C is 320). At E 32, C 320,
// d 1024, f 1024 (w_in) the call does 21.5 GFLOP on 109 MB: 0.033 ms at
// 3.35 TB/s and 0.022 ms at the 989 TFLOP/s of the bf16 tensor cores, so
// bytes and operations are close and the multiply has to run on Hopper's
// warpgroup MMA fed without stalls. The product is swapped (out^T = w^T
// x^T): a block owns 128 f x 160 C, so C 320 is two exact tiles (a 128-row
// C tile would leave the third half empty), and each of two consumer
// warpgroups runs wgmma.m64n160k16 on 64 f, w^T as A read MN-major from
// shared memory (the transpose flag takes w as it lies) and x^T as B,
// accumulators in registers. A ninth warp produces: one thread issues the
// TMA copies of each k-tile of 64 (w's two [64 k, 64 f] boxes and x's
// [160 C, 64 k] box, 128-byte swizzled to match the wgmma descriptors,
// zero-filled past C, d and f) into a 4-stage ring, and full / empty
// mbarriers hand the stages between the roles, so no block-wide barrier runs
// in the loop; one k-tile's wgmma group stays in flight while the next is
// issued. The output goes through shared memory and leaves in 16-byte
// stores. The tensor maps are encoded per call on the host (x's base moves
// from call to call). It stays ~1.2x torch.bmm (PERF.md): larger tiles
// (128 x 256) and multicasting x's tile across a cluster of 2 or 4 blocks
// both measured slower on the H100; a persistent grid that overlaps each
// tile's epilogue with the next tile's copies is the next thing to try.
//
// tc_decode (bf16, C <= 16; granite's decode C is 8). At C 8 the call reads
// 64 MiB of weights for 0.54 GFLOP (8 flops a weight byte, far under the
// 295 the card balances at): bytes only, 0.020 ms at 3.35 TB/s. The job is
// to keep weight bytes in flight and read each once. The product is swapped
// (out^T = w^T x^T): f fills the 16-row M side of the mma and C the 8-wide
// N side (one n-tile for C <= 8, two for C <= 16), so C is never padded to
// 16 or 64. One block of 4 warps owns 128 f columns of one expert (256
// blocks at w_in and w_out, two resident per SM) and walks all of d in
// k-tiles of 64 through a 4-stage cp.async ring of bf16 tiles: 16 KB of w a
// stage, 48 KB in flight per block, ~96 KB per SM, past the ~24 KB per SM
// that Little's law asks at 3.35 TB/s. w^T's fragments come through
// ldmatrix.trans straight from the w tile; x's whole [16, 64] k-tile rides
// along in the same stage.
//
// simt (f32, or bf16 operands the tensor-core routes cannot take: d or f
// not a multiple of 8, a stride not a multiple of 8 elements, a base not
// 16-byte aligned). The kernel's first design, kept: k-tiles staged through
// shared memory as f32, f32 FMAs, a TM x TN register tile a thread, the
// next k-tile's loads in flight in registers during the FMAs; decode tiling
// (C <= 16) 16 x 64 x 64, prefill 64 x 128 x 16. f32 needs it: TF32 would
// keep three digits and break the f32 parity checks (2e-5). In f32 it is
// bounded by the 67 TFLOP/s of f32 FMA (0.32 ms at prefill w_in).
//
// Deliberately not yet: a persistent grid, TMA for the decode route,
// split-d.
//
// x and out have a unit-stride last dim and their other strides are taken as
// they lie; w is the contiguous [E, d, G ff] view of moe_w_in [E, d, G, ff]
// or moe_w_out [E, ff, d] (unit-stride last dim, other strides as given).
#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::from_f;
using repro::to_f;

struct GmmArgs {
  const void* x;     // [E, C, D] strided (xe, xc), D contiguous
  const void* w;     // [E, D, F] strided (we, wk), F contiguous
  void* out;         // [E, C, F] strided (oe, oc), F contiguous
  int C, D, F;
  long long xe, xc;
  long long we, wk;
  long long oe, oc;
};

template <typename T, int V>
struct alignas(V * sizeof(T)) Vec { T v[V]; };

// One (expert, C-tile, f-tile) output tile. Global loads move V elements at
// a time (16 bytes where the shapes and strides allow it, else V = 1).
template <typename T, int BM, int BN, int BK, int TM, int TN, int V, int MINB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB) gmm_kernel(GmmArgs g) {
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY;
  constexpr int XV = BM * BK / V, WV = BK * BN / V;   // vectors per k-tile
  constexpr int XPT = (XV + NT - 1) / NT, WPT = (WV + NT - 1) / NT;
  static_assert(TN % 4 == 0 && BM % 4 == 0 && BK % V == 0 && BN % V == 0,
                "tiling");
  using VT = Vec<T, V>;
  // the x tile transposed; rows padded to BM + 4 floats keep the float4
  // reads of a[] aligned
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM, e = blockIdx.z;
  const T* __restrict__ x = static_cast<const T*>(g.x) + e * g.xe;
  const T* __restrict__ w = static_cast<const T*>(g.w) + e * g.we;

  // the next k-tile, widened to f32 in registers; zeros past C, d and f
  // (with V > 1, d and f are multiples of V: a vector is all in or all out)
  float xr[XPT][V], wr[WPT][V];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int idx = tid + i * NT, r = idx / (BK / V), k = k0 + idx % (BK / V) * V;
      const bool in = (XV % NT == 0 || idx < XV) && c0 + r < g.C && k < g.D;
      if (in) {
        const VT v = *reinterpret_cast<const VT*>(x + (c0 + r) * g.xc + k);
#pragma unroll
        for (int j = 0; j < V; ++j) xr[i][j] = to_f(v.v[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) xr[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int idx = tid + i * NT, kk = idx / (BN / V), n = n0 + idx % (BN / V) * V;
      const bool in = (WV % NT == 0 || idx < WV) && k0 + kk < g.D && n < g.F;
      if (in) {
        const VT v = *reinterpret_cast<const VT*>(w + (k0 + kk) * g.wk + n);
#pragma unroll
        for (int j = 0; j < V; ++j) wr[i][j] = to_f(v.v[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) wr[i][j] = 0.f;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < g.D; k0 += BK) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int idx = tid + i * NT;
      if (XV % NT == 0 || idx < XV) {
        const int r = idx / (BK / V), kv = idx % (BK / V) * V;
#pragma unroll
        for (int j = 0; j < V; ++j) xs[kv + j][r] = xr[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int idx = tid + i * NT;
      if (WV % NT == 0 || idx < WV) {
        const int kk = idx / (BN / V), nv = idx % (BN / V) * V;
#pragma unroll
        for (int j = 0; j < V; ++j) ws[kk][nv + j] = wr[i][j];
      }
    }
    __syncthreads();
    if (k0 + BK < g.D) load(k0 + BK);   // in flight during the FMAs below
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // rows ty TM + m; columns q TX 4 + tx 4 + (0..3): a warp's float4 reads
      // of w cover consecutive 16-byte words (no bank conflict), of x at
      // most two addresses (broadcast)
      float a[TM], b[TN];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int m = 0; m < TM; m += 4) {
          const float4 t = *reinterpret_cast<const float4*>(&xs[kk][ty * TM + m]);
          a[m] = t.x; a[m + 1] = t.y; a[m + 2] = t.z; a[m + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < TM; ++m) a[m] = xs[kk][ty * TM + m];
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(&ws[kk][q * TX * 4 + tx * 4]);
        b[4 * q] = t.x; b[4 * q + 1] = t.y; b[4 * q + 2] = t.z; b[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[m][j] = fmaf(a[m], b[j], acc[m][j]);
    }
    __syncthreads();   // the next k-tile overwrites xs and ws
  }

  T* out = static_cast<T*>(g.out) + e * g.oe;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int c = c0 + ty * TM + m;
    if (c >= g.C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + j / 4 * TX * 4 + tx * 4 + j % 4;
      if (n < g.F) from_f(acc[m][j], out + c * g.oc + n);
    }
  }
}

// MINB: blocks each SM must hold at once (caps the registers a thread may
// use at 65536 / (MINB NT)). The prefill tiling takes 2 (128 registers, no
// spill); the decode tiling is left uncapped: a cap of 4 blocks (64
// registers) spilled and was no faster on the H100.
template <typename T, int BM, int BN, int BK, int TM, int TN, int MINB>
int launch(const GmmArgs& g, int E, bool vec, cudaStream_t st) {
  const dim3 grid((g.F + BN - 1) / BN, (g.C + BM - 1) / BM, E);
  constexpr int NT = (BM / TM) * (BN / TN), V = 16 / sizeof(T);
  if (vec)
    gmm_kernel<T, BM, BN, BK, TM, TN, V, MINB><<<grid, NT, 0, st>>>(g);
  else
    gmm_kernel<T, BM, BN, BK, TM, TN, 1, MINB><<<grid, NT, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tiles(const GmmArgs& g, int E, cudaStream_t st) {
  // 16-byte loads need d, f and every stride in multiples of 16 bytes and
  // 16-byte aligned bases (true of the model's contiguous operands)
  constexpr long long V = 16 / sizeof(T);
  const bool vec = g.D % V == 0 && g.F % V == 0 && g.xe % V == 0 && g.xc % V == 0 &&
                   g.we % V == 0 && g.wk % V == 0 &&
                   reinterpret_cast<size_t>(g.x) % 16 == 0 &&
                   reinterpret_cast<size_t>(g.w) % 16 == 0;
  if (g.C <= 16) return launch<T, 16, 64, 64, 1, 4, 1>(g, E, vec, st);
  return launch<T, 64, 128, 16, 4, 8, 2>(g, E, vec, st);
}

// ---- the bf16 tensor-core routes ------------------------------------------

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;

constexpr int PAD = 8;   // 16 bytes of padding a shared-memory row
constexpr int TC_THREADS = 128;

// tc_decode: out^T = w^T x^T for C <= 16. One (expert, BF f-columns) tile a
// block, each warp BF / 4 columns (MT m16 tiles) by NT n8 tiles of C; all of
// d walked in k-tiles of BK through a STAGES-deep cp.async ring that carries
// the w tile and x's [16, BK] k-tile (rows past C zero).
template <int BF, int BK, int STAGES>
constexpr int decode_smem() {
  return STAGES * (BK * (BF + PAD) + 16 * (BK + PAD)) * 2;
}

template <int NT, int BF, int BK, int STAGES>
__global__ void __launch_bounds__(TC_THREADS) gmm_tc_decode(GmmArgs g) {
  static_assert(BF % 64 == 0 && BK % 64 == 0 && (NT == 1 || NT == 2) &&
                BK * BF % (8 * TC_THREADS) == 0, "tiling");
  constexpr int MT = BF / 4 / 16;
  constexpr int WS = BF + PAD, XS = BK + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][BK][WS]
  bf16* Xs = Ws + STAGES * BK * WS;               // [STAGES][16][XS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BF, e = blockIdx.z;
  const bf16* __restrict__ x = static_cast<const bf16*>(g.x) + e * g.xe;
  const bf16* __restrict__ w = static_cast<const bf16*>(g.w) + e * g.we;
  const int KT = (g.D + BK - 1) / BK;

  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
    bf16* ws = Ws + s * BK * WS;
    bf16* xs = Xs + s * 16 * XS;
#pragma unroll
    for (int j = 0; j < BK * (BF / 8) / TC_THREADS; ++j) {
      const int i = tid + j * TC_THREADS, r = i / (BF / 8), n = n0 + i % (BF / 8) * 8;
      const bool in = k0 + r < g.D && n < g.F;
      cp_async16(ws + r * WS + i % (BF / 8) * 8, in ? w + (k0 + r) * g.wk + n : w, in);
    }
#pragma unroll
    for (int j = 0; j < 16 * (BK / 8) / TC_THREADS; ++j) {
      const int i = tid + j * TC_THREADS, r = i / (BK / 8), k = k0 + i % (BK / 8) * 8;
      const bool in = r < g.C && k < g.D;
      cp_async16(xs + r * XS + i % (BK / 8) * 8, in ? x + r * g.xc + k : x, in);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    repro::cp_async_commit();
  }
  const int li = lane / 8, lr = lane % 8;
  const int m0 = warp * (BF / 4);
  for (int kt = 0; kt < KT; ++kt) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    repro::cp_async_commit();
    const bf16* ws = Ws + kt % STAGES * BK * WS;
    const bf16* xs = Xs + kt % STAGES * 16 * XS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // x^T as B: x is [c][k], so plain ldmatrix gives b0/b1 of the n-tiles
      // c 0..7 (regs 0, 1) and c 8..15 (regs 2, 3)
      uint32_t xb[4];
      ldmatrix_x4(xb, xs + (li / 2 * 8 + lr) * XS + kk + li % 2 * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // w^T as A: w is [k][f], so .trans gives a0..a3 of f rows
        // m0 + 16 mt .. + 15
        uint32_t af[4];
        ldmatrix_x4_trans(af, ws + (kk + li / 2 * 8 + lr) * WS + m0 + mt * 16 + li % 2 * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af, xb[2 * nt], xb[2 * nt + 1]);
      }
    }
  }
  repro::cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(g.out) + e * g.oe;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int f = n0 + m0 + mt * 16 + lane / 4;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + lane % 4 * 2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int fq = f + q / 2 * 8, cq = c + q % 2;
        if (fq < g.F && cq < g.C) out[cq * g.oc + fq] = __float2bfloat16_rn(acc[mt][nt][q]);
      }
    }
  }
}

// tc_prefill: out^T = w^T x^T, one (expert, 128-f tile, 160-C tile) a
// block. Warps 0-7 are two consumer warpgroups of 64 f each, running
// wgmma.m64n160k16 with w^T as A (MN-major: w's f is contiguous) and x^T as
// B (K-major), f32 accumulators in registers; warp 8 is the producer, one
// thread of which copies each k-tile (w's two [64 k, 64 f] boxes, x's
// [160 C, 64 k] box, 128-byte swizzled, zeros past C, d and f) by TMA into a
// STAGES-deep ring. full / empty mbarriers hand the stages over, so no
// block-wide barrier runs in the loop. The output leaves through shared
// memory in 16-byte stores along f.
template <int STAGES>
constexpr int prefill_smem() {
  return STAGES * (64 * 128 * 2 + 160 * 128) + 2 * STAGES * 8 + 1024;
}

template <int STAGES>
__global__ void __launch_bounds__(288, 1)
    gmm_tc_prefill(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, GmmArgs g) {
  constexpr int BF = 128, BC = 160, BK = 64;
  constexpr int W_BYTES = BK * BF * 2, ST_BYTES = W_BYTES + BC * 128;
  static_assert(STAGES * ST_BYTES >= BC * (BF + PAD) * 2, "output staging");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = repro::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // the swizzle needs 1024-byte tiles
  unsigned char* sm = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * ST_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BF, c0 = blockIdx.y * BC, e = blockIdx.z;
  const int KT = (g.D + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      repro::mbar_init(&full[s], 1);    // the producer's expect_tx
      repro::mbar_init(&empty[s], 8);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {   // the producer
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        repro::mbar_wait(&empty[s], (kt / STAGES & 1) ^ 1);
        repro::mbar_expect_tx(&full[s], ST_BYTES);
        unsigned char* st = sm + s * ST_BYTES;
        repro::tma_load_3d(st, &wmap, &full[s], n0, kt * BK, e);
        repro::tma_load_3d(st + 8192, &wmap, &full[s], n0 + 64, kt * BK, e);
        repro::tma_load_3d(st + W_BYTES, &xmap, &full[s], kt * BK, c0, e);
      }
    }
    return;
  }

  const int wg = warp / 4, wq = warp % 4;
  float acc[BC / 2];
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    repro::mbar_wait(&full[s], kt / STAGES & 1);
    const uint32_t st = base + s * ST_BYTES;
    repro::wgmma_fence_regs(acc);
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // w^T: this warpgroup's 64-f slab, 16 k-rows (2 KB) a step; x^T: 32
      // bytes a step inside the swizzled C rows, 8-row groups 1 KB apart
      const uint64_t da = repro::wgmma_desc_sw128(st + wg * 8192 + kk * 2048, 8192, 1024);
      const uint64_t db = repro::wgmma_desc_sw128(st + W_BYTES + kk * 32, 16, 1024);
      repro::wgmma_m64n160k16_bf16_ta(acc, da, db);
    }
    repro::wgmma_commit();
    // k-tile kt - 1's products are done; the last k-tile's too before the
    // loop exits, so no copy of the accumulators can read them in flight
    if (kt + 1 < KT)
      repro::wgmma_wait<1>();
    else
      repro::wgmma_wait<0>();
    repro::wgmma_fence_regs(acc);
    if (kt > 0) {   // the warp's lane 0 releases the stage for the producer
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }

  // out^T tile -> shared memory as [C][f] (rows padded by 16 bytes), then
  // out in 16-byte stores; the ring is free once both warpgroups are here
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  bf16* T = reinterpret_cast<bf16*>(sm);
  const int f = wg * 64 + wq * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BC / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      T[(j * 8 + lane % 4 * 2 + q % 2) * (BF + PAD) + f + q / 2 * 8] =
          __float2bfloat16_rn(acc[4 * j + q]);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  bf16* out = static_cast<bf16*>(g.out) + e * g.oe;
#pragma unroll
  for (int j = 0; j < BC * (BF / 8) / 256; ++j) {
    const int i = tid + j * 256, r = i / (BF / 8), ch = i % (BF / 8);
    if (c0 + r < g.C && n0 + ch * 8 < g.F)
      *reinterpret_cast<uint4*>(out + (c0 + r) * g.oc + n0 + ch * 8) =
          *reinterpret_cast<const uint4*>(T + r * (BF + PAD) + ch * 8);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (the libraries link only libcudart)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a rank-3 bf16 tensor map: dims and element strides innermost first (the
// innermost stride is 1), boxes of box0 x box1 x 1, 128-byte swizzle, zeros
// outside the tensor; a dim of length 1 gets a stride the encoder accepts
bool encode3(CUtensorMap* map, const void* ptr, long long d0, long long d1, long long d2,
             long long s1, long long s2, int box0, int box1) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long row = d0 * 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const long long b1 = d1 == 1 ? (row + 15) / 16 * 16 : s1 * 2;
  const long long b2 = d2 == 1 ? b1 * d1 : s2 * 2;
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(b1), static_cast<cuuint64_t>(b2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K, typename... Args>
int launch_tc(K kernel, dim3 grid, int threads, int smem, cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// what the tensor-core routes need (kernels/moe_gmm.py:_route decides the
// same from x and w; the wrapper allocates out): d and f multiples of 8,
// every stride of a dim longer than 1 a multiple of 8 elements, 16-byte
// aligned bases (cp.async and TMA move 16-byte pieces)
bool tc_ok(const GmmArgs& g, int E) {
  auto ok = [](long long stride, int n) { return n == 1 || stride % 8 == 0; };
  auto al = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  return g.D % 8 == 0 && g.F % 8 == 0 && ok(g.xe, E) && ok(g.xc, g.C) && ok(g.we, E) &&
         ok(g.wk, g.D) && ok(g.oe, E) && ok(g.oc, g.C) && al(g.x) && al(g.w) && al(g.out);
}

template <int STAGES>
int launch_tc_prefill(const GmmArgs& g, int E, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  if (!encode3(&xmap, g.x, g.D, g.C, E, g.xc, g.xe, 64, 160) ||
      !encode3(&wmap, g.w, g.F, g.D, E, g.wk, g.we, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g.F + 127) / 128, (g.C + 159) / 160, E);
  return launch_tc(gmm_tc_prefill<STAGES>, grid, 288, prefill_smem<STAGES>(), st, xmap, wmap,
                   g);
}

template <int BF, int BK, int STAGES>
int launch_tc_decode(const GmmArgs& g, int E, cudaStream_t st) {
  const dim3 grid((g.F + BF - 1) / BF, 1, E);
  constexpr int smem = decode_smem<BF, BK, STAGES>();
  if (g.C <= 8)
    return launch_tc(gmm_tc_decode<1, BF, BK, STAGES>, grid, TC_THREADS, smem, st, g);
  return launch_tc(gmm_tc_decode<2, BF, BK, STAGES>, grid, TC_THREADS, smem, st, g);
}

// the tile shapes that measured fastest on the H100 (PERF.md): decode 128 f
// columns by 64 k, 4 stages; prefill 4 stages of 128 f x 160 C x 64 k
constexpr int DEC_BF = 128, DEC_BK = 64, DEC_STAGES = 4, PRE_STAGES = 4;

}  // namespace

// route: 0 simt (f32 or bf16), 1 tc_decode (bf16, C <= 16), 2 tc_prefill
// (bf16, C > 16); kernels/moe_gmm.py:_route picks it before the launch.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out, int E,
                                     int C, int D, int F, long long xe, long long xc,
                                     long long we, long long wk, long long oe,
                                     long long oc, int dtype, int route, void* stream) {
  if (E < 1 || C < 1 || F < 1 || D < 0 || E > 65535 || (C + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmArgs g{};
  g.x = x; g.w = w; g.out = out;
  g.C = C; g.D = D; g.F = F;
  g.xe = xe; g.xc = xc;
  g.we = we; g.wk = wk;
  g.oe = oe; g.oc = oc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (dtype == repro::DType::F32) return launch_tiles<float>(g, E, st);
    if (dtype == repro::DType::BF16) return launch_tiles<__nv_bfloat16>(g, E, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != repro::DType::BF16 || !tc_ok(g, E))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 && C <= 16) return launch_tc_decode<DEC_BF, DEC_BK, DEC_STAGES>(g, E, st);
  if (route == 2 && C > 16) return launch_tc_prefill<PRE_STAGES>(g, E, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory a block of a tensor-core route takes (bytes; 0
// for the simt route, whose tiles are static and in nvcc's -Xptxas -v log).
extern "C" int grouped_matmul_smem_bytes(int route) {
  if (route == 1) return decode_smem<DEC_BF, DEC_BK, DEC_STAGES>();
  if (route == 2) return prefill_smem<PRE_STAGES>();
  return 0;
}
