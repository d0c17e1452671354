// Chunked SSD (Mamba-2 selective state space, one decay scalar per head) for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/mamba_ssd.py: ssd_chunked (_ssd_kernel,
// pallas_call at :62).
//
// Per (row b, head h), with an [N, P] f32 state h that starts at zero:
//   h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T          (a < 0, dt >= 0)
//   y_t = h_t^T C_t
// B and C [B, S, N] are shared by all heads. Inside a chunk of C = 64
// positions, with cs the inclusive cumsum of dt a over the chunk:
//   y_t = sum_{s<=t} (C_t . B_s) exp(cs_t - cs_s) dt_s x_s + exp(cs_t) C_t . h
//   h  <- exp(cs_last) h + sum_s B_s exp(cs_last - cs_s) dt_s x_s^T
// Every exponent is <= 0, so nothing overflows.
//
// The TPU grid runs (b, h, chunk) in order and carries h in VMEM across the
// chunk axis. A CUDA block cannot hand anything to another block, so here one
// block owns one (b, h) and walks every chunk itself, with the 16 x 64 f32
// state in shared memory: 400 blocks at the serve shape (B 8 x 50 heads) on
// 132 SMs. The chunk's x tile, B, C, the score matrix and cs sit in shared
// memory too (45 KB). Everything is f32 FMA (no wgmma, no TMA yet).
//
// The chunk is fixed at 64 (Pallas shrinks it to the largest divisor of S up
// to 64: 1 for a prime S, 55 for S 1100). Rows of the tail chunk at or past S
// load dt = 0, x = 0, B = C = 0: they leave the state as it is (decay
// exp(0) = 1, no injection) and write no y. cs is summed in f64, so
// exp(cs_t - cs_s) stays accurate when cs is large and the difference small.
// Sums run in another order than the sequential plain version
// (kernels/ref.py:ssd_ref): results agree to f32 rounding, not bit for bit.
//
// What bounds it on the H100: bytes, with operations close behind. At the
// serve shape (B 8, H 50, S 128, P 64, N 16) it reads x, dt, B, C once and
// writes y and the final state once (28 MB, 8.4 us at 3.35 TB/s); the
// chunked form does C (C + 1) P flops for the causal intra-chunk product
// and 4 C N P for the inter-chunk term and the state per (b, h, chunk)
// (0.42 GFLOP, 6.3 us at the 67 TFLOP/s f32 peak outside the tensor
// cores). This first kernel is far from either (PERF.md has its time): its
// products are f32 FMAs with operands from shared memory, not wgmma, and
// it recomputes C B^T for every head.
//
// Inputs are taken through their strides as the model hands them over: x is
// a [B, H, S, P] view of [B, S, d_inner + 2N] conv output (P contiguous,
// row stride d_inner + 2N), dt a [B, H, S] view of [B, S, H] memory, B and C
// column slices of the same conv output (N contiguous). y is written through
// its strides ([B, S, H, P] memory), so the model's transpose back is free.
// B and C rows are padded to N + 1 floats in shared memory, so a warp reading
// one column over 32 rows hits 32 banks.
#include "common.cuh"

namespace {

constexpr int C = 64;     // chunk length
constexpr int NT = 256;   // threads per block

struct SsdArgs {
  const float* x;         // [B, H, S, P] strided (xb, xh, xs), P contiguous
  const float* dt;        // [B, H, S] strided (db, dh, ds)
  const float* bm;        // [B, S, N] strided (bb, bs), N contiguous
  const float* cm;        // [B, S, N] strided (cb, cs), N contiguous
  const float* a;         // [H] contiguous, < 0
  float* y;               // [B, H, S, P] strided (yb, yh, ys), P contiguous
  float* state;           // [B, H, N, P] contiguous
  int H, S;
  long long xb, xh, xs;
  long long db, dh, ds;
  long long bb, bs;
  long long cb, cs;
  long long yb, yh, ys;
};

template <int P, int N>
__global__ void __launch_bounds__(NT) ssd_kernel(SsdArgs g) {
  constexpr int TR = NT / P;      // thread rows sharing one column p
  constexpr int TPT = C / TR;     // y rows per thread
  constexpr int NPT = N / TR;     // state rows per thread
  static_assert(NT % P == 0 && C % TR == 0 && N % TR == 0 && C == 2 * 32,
                "tiling");
  __shared__ float sx[C][P];
  __shared__ float sM[C][C];      // the chunk's masked, decayed scores
  __shared__ float sB[C][N + 1];
  __shared__ float sC[C][N + 1];
  __shared__ float sh[N][P];      // the carried state
  __shared__ float sdt[C], sw[C], sec[C];
  __shared__ double scs[C];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int p = tid % P, tr = tid / P;
  const float a = g.a[h];
  const long long x0 = b * g.xb + h * g.xh, d0 = b * g.db + h * g.dh;
  const long long b0 = b * g.bb, c0 = b * g.cb;
  const long long y0 = b * g.yb + h * g.yh;
  for (int e = tid; e < N * P; e += NT) sh[e / P][e % P] = 0.f;

  for (int t0 = 0; t0 < g.S; t0 += C) {
    const int n = min(C, g.S - t0);
    // 1. the chunk's rows; rows past S are zeros (dt = 0: h unchanged)
    for (int e = tid; e < C * P; e += NT) {
      const int t = e / P, i = e % P;
      sx[t][i] = t < n ? g.x[x0 + static_cast<long long>(t0 + t) * g.xs + i] : 0.f;
    }
    for (int e = tid; e < C * N; e += NT) {
      const int t = e / N, i = e % N;
      const bool live = t < n;
      sB[t][i] = live ? g.bm[b0 + static_cast<long long>(t0 + t) * g.bs + i] : 0.f;
      sC[t][i] = live ? g.cm[c0 + static_cast<long long>(t0 + t) * g.cs + i] : 0.f;
    }
    for (int t = tid; t < C; t += NT)
      sdt[t] = t < n ? g.dt[d0 + static_cast<long long>(t0 + t) * g.ds] : 0.f;
    __syncthreads();
    // 2. cs = inclusive cumsum of dt a (f64): warp 0, two rows per lane
    if (tid < 32) {
      const double l0 = static_cast<double>(sdt[2 * tid]) * a;
      const double l1 = static_cast<double>(sdt[2 * tid + 1]) * a;
      double incl = l0 + l1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      scs[2 * tid] = incl - l1;
      scs[2 * tid + 1] = incl;
    }
    __syncthreads();
    // 3. per row: exp(cs_t) for the inter-chunk term, and the state
    //    injection weight exp(cs_last - cs_s) dt_s
    const double cl = scs[C - 1];
    for (int t = tid; t < C; t += NT) {
      sec[t] = expf(static_cast<float>(scs[t]));
      sw[t] = expf(static_cast<float>(cl - scs[t])) * sdt[t];
    }
    // 4. scores: M[t][s] = (C_t . B_s) exp(cs_t - cs_s) dt_s for s <= t
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e % C;
      float acc = 0.f;
      if (s <= t) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc = fmaf(sC[t][i], sB[s][i], acc);
        acc *= expf(static_cast<float>(scs[t] - scs[s])) * sdt[s];
      }
      sM[t][s] = acc;
    }
    __syncthreads();
    // 5. y_t = sum_s M[t][s] x_s + exp(cs_t) C_t . h, with h from before
    //    this chunk; thread (tr, p) owns rows tr + q * TR of column p
    float acc[TPT];
#pragma unroll
    for (int q = 0; q < TPT; ++q) acc[q] = 0.f;
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      const float xs = sx[s][p];
#pragma unroll
      for (int q = 0; q < TPT; ++q) acc[q] = fmaf(sM[tr + q * TR][s], xs, acc[q]);
    }
    float hcol[N];
#pragma unroll
    for (int i = 0; i < N; ++i) hcol[i] = sh[i][p];
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      const int t = tr + q * TR;
      float inter = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) inter = fmaf(sC[t][i], hcol[i], inter);
      if (t < n)
        g.y[y0 + static_cast<long long>(t0 + t) * g.ys + p] = fmaf(sec[t], inter, acc[q]);
    }
    __syncthreads();  // every thread has read h before h changes
    // 6. h <- exp(cs_last) h + sum_s (B_s w_s) x_s^T; thread (tr, p) owns
    //    rows tr + q * TR of column p
    const float dec = expf(static_cast<float>(cl));
#pragma unroll
    for (int q = 0; q < NPT; ++q) {
      const int i = tr + q * TR;
      float hv = dec * sh[i][p];   // only this thread writes sh[i][p]
#pragma unroll 8
      for (int s = 0; s < C; ++s) hv = fmaf(sB[s][i] * sw[s], sx[s][p], hv);
      sh[i][p] = hv;
    }
    __syncthreads();  // the next chunk overwrites the tiles read above
  }
  float* st = g.state + (static_cast<long long>(b) * g.H + h) * N * P;
  for (int e = tid; e < N * P; e += NT) st[e] = sh[e / P][e % P];
}

}  // namespace

extern "C" int ssd_chunked_launch(const void* x, const void* dt, const void* bm,
                                  const void* cm, const void* a, void* y, void* state,
                                  int B, int H, int S, int P, int N, long long xb,
                                  long long xh, long long xs, long long db, long long dh,
                                  long long ds, long long bb, long long bs, long long cb,
                                  long long cs, long long yb, long long yh, long long ys,
                                  void* stream) {
  SsdArgs g{};
  g.x = static_cast<const float*>(x);
  g.dt = static_cast<const float*>(dt);
  g.bm = static_cast<const float*>(bm);
  g.cm = static_cast<const float*>(cm);
  g.a = static_cast<const float*>(a);
  g.y = static_cast<float*>(y);
  g.state = static_cast<float*>(state);
  g.H = H; g.S = S;
  g.xb = xb; g.xh = xh; g.xs = xs;
  g.db = db; g.dh = dh; g.ds = ds;
  g.bb = bb; g.bs = bs;
  g.cb = cb; g.cs = cs;
  g.yb = yb; g.yh = yh; g.ys = ys;
  const dim3 grid(H, B), block(NT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P != 64 || N != 16) return static_cast<int>(cudaErrorInvalidValue);
  ssd_kernel<64, 16><<<grid, block, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}
