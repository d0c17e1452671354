// Chunked WKV6 (the RWKV6 "Finch" time-mix recurrence) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rwkv6_scan.py: rwkv6_chunked (_wkv6_kernel,
// pallas_call at :67).
//
// Per (row b, head h), with a [hd, hd] f32 state S that starts at zero:
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w = log-decay <= 0)
//
// The TPU grid runs (b, h, chunk) in order and carries S in VMEM across the
// chunk axis. A CUDA block cannot carry anything to another block, so here one
// block owns one (b, h) and walks every chunk itself with S in shared memory
// (16 KB at hd 64): 320 blocks at the serve shape (B 8 x 40 heads) on 132 SMs.
//
// Inside a chunk of C = 16 positions the per-channel decay factorises, as in
// the Pallas kernel: with cs_t the inclusive cumsum of w over the chunk,
// r'_t = r_t exp(cs_{t-1}) and k'_s = k_s exp(-cs_s), so
//   y_t = sum_{s<t} (r'_t . k'_s) v_s + (r_t . (u * k_t)) v_t + r'_t S
//   S   <- exp(cs_{C-1}) * (S + k'^T v)
// exp(-cs) reaches e^64 at C = 16 under the model's clip of the log-decay to
// [-4, 0) (models/ssm.py _LOGW_CLIP), inside f32's range; so the chunk stays
// at 16, everything is f32 FMA (no bf16, no TF32), and the chunk is fixed
// (Pallas shrinks it to a divisor of S, down to 1 for a prime S): the tail
// chunk's rows past S load as k = 0, w = 0 (no change to S, cs stops growing)
// and write no y. Sums run in another order than the sequential plain version
// (kernels/ref.py:rwkv6_ref): results agree to f32 rounding, not bit for bit.
//
// What bounds it on the H100: bytes. Each input element is read once (4
// tensors [B,H,S,hd] f32 + u) and each output written once (y, final S): 58 MB
// at the serve shape, 17 us at 3.35 TB/s, against 0.84 GFLOP (13 us at the
// f32 peak outside the tensor cores). This first kernel is not near that
// (PERF.md has its time): the score matrix, y and the state update are f32
// FMAs with both operands read from shared memory, not wgmma. Inputs may be
// strided ([B, S, H, hd] memory read through a [B, H, S, hd] view, as the
// model hands them over): a row's hd floats are contiguous, so 32 lanes read
// 128 contiguous bytes. Shared rows are padded to hd + 1 floats, so a warp
// reading one column over 16 rows hits 16 banks.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int C = 16;     // chunk length
constexpr int NT = 256;   // threads per block

struct Wkv6Args {
  const float* r;         // [B, H, S, hd] strided (sb, sh, ss), hd contiguous
  const float* k;
  const float* v;
  const float* w;
  const float* u;         // [H, hd] contiguous
  float* y;               // [B, H, S, hd] strided (yb, yh, ys), hd contiguous
  float* state;           // [B, H, hd, hd] contiguous
  int H, S;
  long long sb, sh, ss;
  long long yb, yh, ys;
};

template <int HD>
__global__ void __launch_bounds__(NT) wkv6_kernel(Wkv6Args a) {
  constexpr int P = HD + 1;       // padded row: column reads are conflict-free
  constexpr int TJ = NT / HD;     // threads sharing one column j
  constexpr int TPT = C / TJ;     // y rows per thread
  constexpr int IPT = HD / TJ;    // state rows per thread
  static_assert(NT % HD == 0 && C % TJ == 0 && HD % TJ == 0, "tiling");
  __shared__ float sr[C][P], sk[C][P], sv[C][P], sw[C][P], srp[C][P], skp[C][P];
  __shared__ float sA[C][C + 1];
  __shared__ float sS[HD][HD];
  __shared__ float su[HD], sdec[HD];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int j = tid % HD, tr = tid / HD;
  const long long in0 = b * a.sb + h * a.sh;
  const long long out0 = b * a.yb + h * a.yh;
  for (int e = tid; e < HD * HD; e += NT) sS[e / HD][e % HD] = 0.f;
  for (int i = tid; i < HD; i += NT) su[i] = a.u[static_cast<long long>(h) * HD + i];

  for (int t0 = 0; t0 < a.S; t0 += C) {
    const int n = min(C, a.S - t0);
    // 1. the chunk's rows; rows past S are zeros (k = 0, w = 0: S unchanged)
    for (int e = tid; e < C * HD; e += NT) {
      const int t = e / HD, i = e % HD;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (t < n) {
        const long long o = in0 + static_cast<long long>(t0 + t) * a.ss + i;
        rv = a.r[o];
        kv = a.k[o];
        vv = a.v[o];
        wv = a.w[o];
      }
      sr[t][i] = rv;
      sk[t][i] = kv;
      sv[t][i] = vv;
      sw[t][i] = wv;
    }
    __syncthreads();
    // 2. per channel: cumsum of w, r' = r exp(cs_{t-1}), k' = k exp(-cs_t)
    for (int i = tid; i < HD; i += NT) {
      float cs = 0.f;
      for (int t = 0; t < C; ++t) {
        srp[t][i] = sr[t][i] * expf(cs);
        cs += sw[t][i];
        skp[t][i] = sk[t][i] * expf(-cs);
      }
      sdec[i] = expf(cs);
    }
    __syncthreads();
    // 3. scores: A[t][s] = r'_t . k'_s below the diagonal, the u-bonus
    //    r_t . (u * k_t) on it, zero above
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e % C;
      float acc = 0.f;
      if (s < t) {
#pragma unroll 16
        for (int i = 0; i < HD; ++i) acc = fmaf(srp[t][i], skp[s][i], acc);
      } else if (s == t) {
#pragma unroll 16
        for (int i = 0; i < HD; ++i) acc = fmaf(sr[t][i] * su[i], sk[t][i], acc);
      }
      sA[t][s] = acc;
    }
    __syncthreads();
    // 4. y_t = sum_s A[t][s] v_s + r'_t S, with S from before this chunk
    float acc[TPT];
#pragma unroll
    for (int q = 0; q < TPT; ++q) acc[q] = 0.f;
#pragma unroll
    for (int s = 0; s < C; ++s) {
      const float vs = sv[s][j];
#pragma unroll
      for (int q = 0; q < TPT; ++q) acc[q] = fmaf(sA[tr + q * TJ][s], vs, acc[q]);
    }
#pragma unroll 8
    for (int i = 0; i < HD; ++i) {
      const float sij = sS[i][j];
#pragma unroll
      for (int q = 0; q < TPT; ++q) acc[q] = fmaf(srp[tr + q * TJ][i], sij, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      const int t = tr + q * TJ;
      if (t < n) a.y[out0 + static_cast<long long>(t0 + t) * a.ys + j] = acc[q];
    }
    __syncthreads();  // every y has read S before S changes
    // 5. S <- exp(cs_last) * (S + k'^T v); thread (tr, j) owns rows tr + q*TJ
    float vcol[C];
#pragma unroll
    for (int s = 0; s < C; ++s) vcol[s] = sv[s][j];
    for (int q = 0; q < IPT; ++q) {
      const int i = tr + q * TJ;
      float sij = sS[i][j];
#pragma unroll
      for (int s = 0; s < C; ++s) sij = fmaf(skp[s][i], vcol[s], sij);
      sS[i][j] = sdec[i] * sij;
    }
    __syncthreads();  // the next chunk overwrites the rows read above
  }
  float* st = a.state + (static_cast<long long>(b) * a.H + h) * HD * HD;
  for (int e = tid; e < HD * HD; e += NT) st[e] = sS[e / HD][e % HD];
}

}  // namespace

extern "C" int rwkv6_chunked_launch(const void* r, const void* k, const void* v,
                                    const void* w, const void* u, void* y, void* state,
                                    int B, int H, int S, int hd, long long sb, long long sh,
                                    long long ss, long long yb, long long yh, long long ys,
                                    void* stream) {
  Wkv6Args a{};
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.y = static_cast<float*>(y);
  a.state = static_cast<float*>(state);
  a.H = H; a.S = S;
  a.sb = sb; a.sh = sh; a.ss = ss;
  a.yb = yb; a.yh = yh; a.ys = ys;
  const dim3 grid(H, B), block(NT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  wkv6_kernel<64><<<grid, block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
