// Causal GQA flash-attention forward for Hopper (sm_90a), with an optional
// sliding window.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_fwd
// (_attn_kernel, pallas_call at :94).
//
// What bounds it on the H100: at the serve path's prompt lengths (S <= a few
// hundred) bytes — q, k, v and the output are each touched once and the
// causal score work is 2 * H * S^2 * hd flops, under the balance point; at
// long prompts (S ~ 1k and up) flops. This first version is the simple, right
// one: f32 FMA math on shared-memory tiles (no wgmma, no TMA yet), so at long
// prompts it sits far from the tensor-core peak. What it does keep is the
// flash structure: one block per (64-row q tile, head, row) loops over 64-row
// k tiles of the causal / window band only — tiles outside the band are
// never loaded — with the online softmax (m, l, acc) in f32 registers, so no
// score matrix reaches device memory and every q/k/v/o byte moves once per
// block. The TPU grid carried m/l/acc in VMEM across a sequential k axis;
// here the k axis is the block's own loop. The ragged edge (S not a multiple
// of 64) is masked in place, instead of the Pallas wrapper's
// `while Sq % bq: bq -= 1` shrink. q aligns to the start of k; the wrapper
// refuses Sq != Sk (the Pallas kernel silently ignores that case's offset).
#include <cmath>

#include "common.cuh"

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

}  // namespace

// Strides are in elements; the last (hd) stride of every operand is 1.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H, int KV, int Sq,
    int Sk, int hd, int causal, int window, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os, int dt, void* stream) {
  AttnArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.H = H; a.KV = KV; a.G = H / KV; a.Sq = Sq; a.Sk = Sk;
  a.causal = causal; a.window = window;
  a.qb = qb; a.qh = qh; a.qs = qs; a.kb = kb; a.kh = kh; a.ks = ks;
  a.vb = vb; a.vh = vh; a.vs = vs; a.ob = ob; a.oh = oh; a.os = os;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == DType::F32) return launch_hd<float>(a, B, hd, st);
  if (dt == DType::BF16) return launch_hd<__nv_bfloat16>(a, B, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
