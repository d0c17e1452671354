// One-token GQA decode attention for Hopper (sm_90a): the contiguous and the
// paged entry share one kernel body.
//
// Replaces src/repro/kernels/flash_decode.py:
//   flash_decode       (_decode_kernel, pallas_call at :127)  -> PAGED=false
//   flash_decode_paged (_paged_kernel,  pallas_call at :241)  -> PAGED=true
//
// What bounds it on the H100: bytes. Each (row, kv head) reads its live K/V
// once (2 * len * hd elements) and does 4 * G * len * hd flops on them, about
// G flops per byte in bf16 — two orders of magnitude under the card's ~295
// flop/byte balance point. So the design moves each live byte once and
// nothing else: one block per (row, kv head); the G query rows of the GQA
// group ride together, so K/V are read once for all of them; positions at or
// past the row's length (and, paged, unmapped -1 pages) are never loaded;
// the paged entry resolves block_tab[b, p / page_size] itself and reads the
// pool page in place (no gathered per-row view); fp8 e4m3 pools are widened
// to f32 in registers. Four warps split the positions; each lane owns
// hd / 32 consecutive elements (vector loads of up to 16 bytes), a warp takes four
// positions per step so their loads are in flight together, and the warps'
// online-softmax states (m, l, acc in f32) merge through shared memory at
// the end. A row with no live position writes zeros (l floored at 1e-30).
#include <cmath>

#include "common.cuh"

namespace {

using repro::DType;
using repro::NEG_INF;

constexpr int NW = 4;     // warps per block
constexpr int U = 4;      // positions a warp takes per step
constexpr int MAXG = 8;   // query rows per kv head (H / KV)

struct DecodeArgs {
  const void* q;          // [B, H, hd] contiguous
  const void* k;          // contiguous: [B, KV, S, hd] strided view
  const void* v;          //   paged: pool [groups, P1, ps, KV, hd] contiguous
  void* out;              // [B, H, hd] contiguous, q's dtype
  const int* lengths;     // [B] live positions per row
  const int* block_tab;   // paged: [B, npg], -1 = unmapped
  int H, KV, G;
  int cap;                // contiguous: S; paged: npg * ps
  int window;             // > 0: only positions >= length - window
  long long sb, sh, ss;   // contiguous view strides (elements)
  int P1, ps, npg, layer; // paged pool geometry and group index
  float scale;
};

template <typename TQ, typename TKV, int HD, bool PAGED>
__global__ void __launch_bounds__(NW * 32) decode_kernel(DecodeArgs a) {
  // each lane owns EPT consecutive elements; below hd 32 only the first
  // hd lanes hold any (the rest add zeros to the warp sums)
  constexpr int EPT = HD >= 32 ? HD / 32 : 1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool owns = lane * EPT < HD;
  const int G = a.G;
  const int len_raw = a.lengths[b];
  const int hi = min(max(len_raw, 0), a.cap);
  const int lo = a.window > 0 ? max(0, len_raw - a.window) : 0;

  const TQ* q = static_cast<const TQ*>(a.q) +
                (static_cast<long long>(b) * a.H + static_cast<long long>(h) * G) * HD;
  float qr[MAXG][EPT], acc[MAXG][EPT], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G && owns) {
      repro::load_f32<TQ, EPT>(q + g * HD + lane * EPT, qr[g]);
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
  for (int base = lo + warp * U; base < hi; base += NW * U) {
    float kf[U][EPT], vf[U][EPT];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u;
      long long off = -1;
      if (p < hi) {
        if constexpr (PAGED) {
          const int page = a.block_tab[static_cast<long long>(b) * a.npg + p / a.ps];
          if (page >= 0)
            off = ((static_cast<long long>(a.layer) * a.P1 + page) * a.ps + p % a.ps) *
                      a.KV * HD + static_cast<long long>(h) * HD;
        } else {
          off = b * a.sb + h * a.sh + p * a.ss;
        }
      }
      live[u] = off >= 0;  // uniform across the warp
      if (live[u] && owns) {
        repro::load_f32<TKV, EPT>(K + off + lane * EPT, kf[u]);
        repro::load_f32<TKV, EPT>(V + off + lane * EPT, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPT; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[U][MAXG];
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
        s[u][g] = d * a.scale;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (live[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = expf(m[g] - mx);
      float pu[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pu[u] = live[u] ? expf(s[u][g] - mx) : 0.f;
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
  TQ* out = static_cast<TQ*>(a.out) +
            (static_cast<long long>(b) * a.H + static_cast<long long>(h) * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += NW * 32) {
    const int g = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - M);
      L = fmaf(sm_l[w][g], c, L);
      O = fmaf(sm_acc[w][g][d], c, O);
    }
    repro::from_f(O / fmaxf(L, 1e-30f), out + i);
  }
}

template <typename TQ, typename TKV, bool PAGED>
int launch_hd(const DecodeArgs& a, int B, int hd, cudaStream_t st) {
  const dim3 grid(a.KV, B), block(NW * 32);
  switch (hd) {
    case 16: decode_kernel<TQ, TKV, 16, PAGED><<<grid, block, 0, st>>>(a); break;
    case 32: decode_kernel<TQ, TKV, 32, PAGED><<<grid, block, 0, st>>>(a); break;
    case 64: decode_kernel<TQ, TKV, 64, PAGED><<<grid, block, 0, st>>>(a); break;
    case 128: decode_kernel<TQ, TKV, 128, PAGED><<<grid, block, 0, st>>>(a); break;
    case 256: decode_kernel<TQ, TKV, 256, PAGED><<<grid, block, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q and the output share one dtype (f32 or bf16); K/V are that dtype or fp8.
template <bool PAGED>
int dispatch(const DecodeArgs& a, int B, int hd, int q_dt, int kv_dt, cudaStream_t st) {
  if (a.G < 1 || a.G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  if (q_dt == DType::F32 && kv_dt == DType::F32)
    return launch_hd<float, float, PAGED>(a, B, hd, st);
  if (q_dt == DType::F32 && kv_dt == DType::FP8E4M3)
    return launch_hd<float, __nv_fp8_e4m3, PAGED>(a, B, hd, st);
  if (q_dt == DType::BF16 && kv_dt == DType::BF16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16, PAGED>(a, B, hd, st);
  if (q_dt == DType::BF16 && kv_dt == DType::FP8E4M3)
    return launch_hd<__nv_bfloat16, __nv_fp8_e4m3, PAGED>(a, B, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, void* out,
                                   const int* lengths, int B, int H, int KV, int hd, int S,
                                   long long sb, long long sh, long long ss, int window,
                                   int q_dt, int kv_dt, void* stream) {
  DecodeArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.lengths = lengths; a.block_tab = nullptr;
  a.H = H; a.KV = KV; a.G = H / KV; a.cap = S; a.window = window;
  a.sb = sb; a.sh = sh; a.ss = ss;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  return dispatch<false>(a, B, hd, q_dt, kv_dt, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_decode_paged_launch(const void* q, const void* k_pool, const void* v_pool,
                                         void* out, const int* block_tab, const int* lengths,
                                         int B, int H, int KV, int hd, int P1, int ps, int npg,
                                         int layer, int q_dt, int kv_dt, void* stream) {
  DecodeArgs a{};
  a.q = q; a.k = k_pool; a.v = v_pool; a.out = out; a.lengths = lengths;
  a.block_tab = block_tab;
  a.H = H; a.KV = KV; a.G = H / KV; a.cap = npg * ps; a.window = 0;
  a.P1 = P1; a.ps = ps; a.npg = npg; a.layer = layer;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  return dispatch<true>(a, B, hd, q_dt, kv_dt, static_cast<cudaStream_t>(stream));
}
