// Grouped (expert-batched) matmul of the MoE expert FFN for Hopper (sm_90a).
//
// Replaces src/repro/kernels/moe_gmm.py: grouped_matmul (_gmm_kernel,
// pallas_call at :49).
//
//   out[e, c, n] = sum_k x[e, c, k] w[e, k, n]
//   x [E, C, d], w [E, d, f] -> out [E, C, f]
//
// Both operands are widened to f32, the sum over d runs in f32, and the
// output is written once in x's dtype (bf16 or f32), as the Pallas kernel
// does with its VMEM accumulator.
//
// The TPU grid walks (e, c-block, f-block, d-block) in order and carries the
// [bc, bf] accumulator in VMEM across the innermost d axis; its blocks shrink
// to divisors of C, f and d. Here one block owns one (expert, C-tile, f-tile)
// output tile and walks d itself: k-tiles of x and w are staged through
// shared memory as f32, each thread keeps a TM x TN accumulator in
// registers, and the next k-tile's global loads are issued into registers
// before the current one is multiplied, so they are in flight during the
// FMAs. The ragged C, d and f edges are masked (zeros in, no store out), so
// any shape runs with one tile size. Where d, f and the strides are
// multiples of 16 bytes (the model's operands always are), global loads
// move 16 bytes a thread; elsewhere one element. Each thread reads its w
// operands from shared memory as float4s (and its x operands too where it
// owns 4 rows).
//
// Two tilings: decode (C <= 16, granite-moe-1b's C is 8) and prefill (C
// 320 at granite's serve shape).
//   decode:  BM 16, BN 64,  BK 64, 1 x 4 per thread; one C-tile, so every
//            weight byte is read once; 512 blocks for w_in at E 32, f 1024.
//   prefill: BM 64, BN 128, BK 16, 4 x 8 per thread; C 320 is 5 exact tiles.
//
// What bounds it on the H100. Decode: bytes. At E 32, C 8, d 1024, f 1024
// (w_in) it reads 64 MiB of bf16 weights for 0.54 GFLOP (8 flops a weight
// byte, far under the 295 the card balances at): 0.020 ms at 3.35 TB/s.
// Prefill: at C 320 it does 21.5 GFLOP on 109 MB (x, w and out once):
// 0.033 ms at 3.35 TB/s, 0.022 ms at the 989 TFLOP/s of bf16 tensor cores,
// 0.32 ms at the 67 TFLOP/s of f32 FMA. This first kernel multiplies with
// f32 FMAs from shared memory (no mma.sync, no wgmma, no TMA), so prefill
// cannot come within 15x of the tensor-core bound; PERF.md has its times
// beside torch.bmm's.
//
// x and out have a unit-stride last dim and their other strides are taken as
// they lie; w is the contiguous [E, d, G ff] view of moe_w_in [E, d, G, ff]
// or moe_w_out [E, ff, d] (unit-stride last dim, other strides as given).
#include "common.cuh"

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

}  // namespace

extern "C" int grouped_matmul_launch(const void* x, const void* w, void* out, int E,
                                     int C, int D, int F, long long xe, long long xc,
                                     long long we, long long wk, long long oe,
                                     long long oc, int dtype, void* stream) {
  if (E < 1 || C < 1 || F < 1 || D < 0 || E > 65535 || (C + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  GmmArgs g{};
  g.x = x; g.w = w; g.out = out;
  g.C = C; g.D = D; g.F = F;
  g.xe = xe; g.xc = xc;
  g.we = we; g.wk = wk;
  g.oe = oe; g.oc = oc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DType::F32) return launch_tiles<float>(g, E, st);
  if (dtype == repro::DType::BF16) return launch_tiles<__nv_bfloat16>(g, E, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
