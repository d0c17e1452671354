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
// chunk axis. A CUDA block cannot hand anything to another block, so a block
// walks every chunk of its (b, h) itself. Two routes:
//
//   tile  (ssd_tile_kernel<P, N>, every aligned call: the model's views are)
//         Column p of the [N, P] state depends only on x[:, p], so a block
//         owns one (b, a group of heads, a slice of state columns), and the
//         heads of a group share C B^T. 256 threads, f32 FMA on register
//         tiles fed by 16-byte shared loads, operands landing by cp.async
//         (16 bytes; dt, a strided view, 4 bytes) ahead of the chunk that
//         uses them. The tiling is chosen at compile time by N (SsdTile<N>):
//     N 16 (hymba-1.5b): HG 2 heads, PW 32 columns a block: 400 blocks at
//         the serve shape and 200 at hymba's generate shape [4, 50, 1100,
//         64] (slices of 16 and one head a block measured no faster,
//         PERF.md); for an odd H the last group's second head is zeros and
//         writes nothing. Each chunk's x slices, B, C and dt land in a
//         2-stage ring. Per chunk: C B^T (64 x 64, K = N) once on 4 x 4
//         register tiles, the 16-column bands above the diagonal skipped,
//         kept in registers for the block's HG heads; per head one of the
//         two warps left without a C B^T band gives cs by an f64 shuffle
//         scan meanwhile, then each lane turns its C B^T tile into M = C B^T
//         * exp(cs_t - cs_s) dt_s (s <= t) in shared memory beside C' =
//         exp(cs_t) C; y = [M | C'] [x ; h] on 4 x TP register tiles read
//         as LDS.128 from padded rows (8 FMA a vector load), K split across
//         the warp pairs of each 16-row band and the causal triangle
//         skipped band by band; the state update h <- exp(cs_last) h +
//         B^T (w * x) on two warps' register tiles, the slice's state kept
//         in one warp's registers. 94 KB of shared memory, 2 blocks an SM.
//     N 128 (granite-4.0-h's Mamba-2 layers): 2 heads and all 64 columns a
//         block (4,096 blocks at the padded [64, 128, 512, 64] group, one an
//         SM: 221 KB of shared memory, the arithmetic in SsdTile<128>). B
//         and C (32 KB each a chunk, shared by every head) sit in a 2-stage
//         ring with the heads' dt; each head's x has one buffer, reloaded as
//         soon as that head is done with the chunk, so it lands while the
//         other head and the next C B^T compute (a ring of x, B and C would
//         take 286 KB). Per chunk: C B^T once for both heads as at N 16
//         (K = 128), the cs scans on the two warps it leaves idle. Per
//         head: M into shared memory and the head's state h (before the
//         chunk) from registers into a shared [N][P] buffer; then every
//         thread computes y = exp(cs_t) (C h)_t + sum_{s <= t} M x_s on a
//         4 x 4 tile (rows of its 16-row band, the M x loop ending with the
//         band) and its 4 x 8 slice of h <- exp(cs_last) h + B^T (w * x),
//         held in registers across chunks (32 a head). exp(cs_t) scales
//         the C h product after the sum, so no C' copy is kept. One head a
//         block measured 12-15% slower (C B^T twice and twice the B / C
//         traffic), a third head does not fit.
//   simt  (ssd_kernel, the first design: rows that cannot be copied in
//         16-byte vectors) one block per (b, h), the N x 64 state and the
//         chunk in shared memory, both operands of most FMAs read from
//         shared memory and C B^T computed again in every head. Built for
//         (P, N) = (64, 16) and (64, 128); measured beside tile.
//
// The chunk is fixed at 64 (Pallas shrinks it to the largest divisor of S up
// to 64: 1 for a prime S, 55 for S 1100). Rows of the tail chunk at or past S
// load dt = 0, x = 0, B = C = 0: they leave the state as it is (decay
// exp(0) = 1, no injection) and write no y. cs is summed in f64 and every
// decay is taken in the difference form exp(cs_t - cs_s) <= 1, so it stays
// accurate when cs is large and the difference small, and nothing
// overflows. Sums run in another order than the sequential plain version
// (kernels/ref.py:ssd_ref): results agree to f32 rounding, not bit for bit.
//
// What bounds it on the H100. At N 16, bytes, with operations close behind.
// At the serve shape (B 8, H 50, S 128, P 64, N 16) it reads x, dt, B, C
// once and writes y and the final state once (28 MB, 8.4 us at 3.35 TB/s);
// the chunked form does C (C + 1) P flops for the causal intra-chunk product
// and 4 C N P for the inter-chunk term and the state per (b, h, chunk)
// (0.42 GFLOP, 6.3 us at the 67 TFLOP/s f32 peak outside the tensor
// cores). The tile route runs at 5.3x the bytes bound. Its FMAs run at
// 5.5 per shared load (SASS), so shared loads do not bound them. Taking
// parts out (kernels/scan_ablation.py; PERF.md has the times): the
// products cost 44% of the time (y a quarter, the state update a tenth,
// C B^T a twelfth), M's exponentials (an f64 difference, a conversion and
// an expf for each live entry) a sixth, the exposed loads a twelfth, the
// cs scans a twentieth; the rest is six barriers (two heads) and the y
// partial sums. At the serve shape 400 blocks meet 264 slots (1.5 waves);
// a third ring stage leaves 1 block a SM and runs 40% slower. At N 128,
// operations: the padded [64, 128, 512, 64] group needs 155 GFLOP (2.3 ms)
// against 1.1 GB (0.33 ms); the read-out C h and the state update are 4 C
// N P of it. The FMA loops read 8 (y) and 10.7 (the update) FMA a shared
// vector load, at 8 warps an SM; taking parts out, the read-out costs 28%
// of the time, the update 27%, M x and C B^T 10% each, M's exponentials
// 5%, the exposed loads 4%, the cs scans nothing; the rest is six barriers
// a chunk and the stores (PERF.md).
//
// Inputs are taken through their strides as the model hands them over: x is
// a [B, H, S, P] view of [B, S, d_inner + 2N] conv output (P contiguous,
// row stride d_inner + 2N), dt a [B, H, S] view of [B, S, H] memory, B and C
// column slices of the same conv output (N contiguous). y is written through
// its strides ([B, S, H, P] memory), so the model's transpose back is free.
#include "common.cuh"
#include "mma.cuh"

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

// ---- route simt: one block per (b, h), the state in shared memory ---------
// B and C rows are padded to N + 1 floats in shared memory, so a warp reading
// one column over 32 rows hits 32 banks. Shared memory is dynamic (SimtSmem):
// 44.8 KB at (P, N) = (64, 16), 131.6 KB at (64, 128), one block a SM there.
template <int P, int N>
struct SimtSmem {
  static constexpr int FLOATS = C * P + C * C + 2 * C * (N + 1) + N * P + 3 * C;
  static constexpr int BYTES = FLOATS * 4 + C * 8;   // + the f64 cumsum
};

template <int P, int N>
__global__ void __launch_bounds__(NT) ssd_kernel(SsdArgs g) {
  constexpr int TR = NT / P;      // thread rows sharing one column p
  constexpr int TPT = C / TR;     // y rows per thread
  constexpr int NPT = N / TR;     // state rows per thread
  static_assert(NT % P == 0 && C % TR == 0 && N % TR == 0 && C == 2 * 32,
                "tiling");
  extern __shared__ __align__(16) unsigned char simt_smem[];
  double* const scs = reinterpret_cast<double*>(simt_smem);          // [C]
  float* const sx = reinterpret_cast<float*>(scs + C);                // [C][P]
  float* const sM = sx + C * P;          // [C][C]: the chunk's masked, decayed scores
  float* const sB = sM + C * C;          // [C][N + 1]
  float* const sC = sB + C * (N + 1);    // [C][N + 1]
  float* const sh = sC + C * (N + 1);    // [N][P]: the carried state
  float* const sdt = sh + N * P;
  float* const sw = sdt + C;
  float* const sec = sw + C;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int p = tid % P, tr = tid / P;
  const float a = g.a[h];
  const long long x0 = b * g.xb + h * g.xh, d0 = b * g.db + h * g.dh;
  const long long b0 = b * g.bb, c0 = b * g.cb;
  const long long y0 = b * g.yb + h * g.yh;
  for (int e = tid; e < N * P; e += NT) sh[e] = 0.f;

  for (int t0 = 0; t0 < g.S; t0 += C) {
    const int n = min(C, g.S - t0);
    // 1. the chunk's rows; rows past S are zeros (dt = 0: h unchanged)
    for (int e = tid; e < C * P; e += NT) {
      const int t = e / P, i = e % P;
      sx[t * P + i] = t < n ? g.x[x0 + static_cast<long long>(t0 + t) * g.xs + i] : 0.f;
    }
    for (int e = tid; e < C * N; e += NT) {
      const int t = e / N, i = e % N;
      const bool live = t < n;
      sB[t * (N + 1) + i] = live ? g.bm[b0 + static_cast<long long>(t0 + t) * g.bs + i] : 0.f;
      sC[t * (N + 1) + i] = live ? g.cm[c0 + static_cast<long long>(t0 + t) * g.cs + i] : 0.f;
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
#pragma unroll 16
        for (int i = 0; i < N; ++i) acc = fmaf(sC[t * (N + 1) + i], sB[s * (N + 1) + i], acc);
        acc *= expf(static_cast<float>(scs[t] - scs[s])) * sdt[s];
      }
      sM[t * C + s] = acc;
    }
    __syncthreads();
    // 5. y_t = sum_s M[t][s] x_s + exp(cs_t) C_t . h, with h from before
    //    this chunk; thread (tr, p) owns rows tr + q * TR of column p
    float acc[TPT], inter[TPT];
#pragma unroll
    for (int q = 0; q < TPT; ++q) acc[q] = inter[q] = 0.f;
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      const float xs = sx[s * P + p];
#pragma unroll
      for (int q = 0; q < TPT; ++q) acc[q] = fmaf(sM[(tr + q * TR) * C + s], xs, acc[q]);
    }
#pragma unroll 4
    for (int i = 0; i < N; ++i) {
      const float hv = sh[i * P + p];
#pragma unroll
      for (int q = 0; q < TPT; ++q)
        inter[q] = fmaf(sC[(tr + q * TR) * (N + 1) + i], hv, inter[q]);
    }
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      const int t = tr + q * TR;
      if (t < n)
        g.y[y0 + static_cast<long long>(t0 + t) * g.ys + p] = fmaf(sec[t], inter[q], acc[q]);
    }
    __syncthreads();  // every thread has read h before h changes
    // 6. h <- exp(cs_last) h + sum_s (B_s w_s) x_s^T; thread (tr, p) owns
    //    rows tr + q * TR of column p
    const float dec = expf(static_cast<float>(cl));
#pragma unroll 4
    for (int q = 0; q < NPT; ++q) {
      const int i = tr + q * TR;
      float hv = dec * sh[i * P + p];   // only this thread writes sh[i][p]
#pragma unroll 8
      for (int s = 0; s < C; ++s) hv = fmaf(sB[s * (N + 1) + i] * sw[s], sx[s * P + p], hv);
      sh[i * P + p] = hv;
    }
    __syncthreads();  // the next chunk overwrites the tiles read above
  }
  float* st = g.state + (static_cast<long long>(b) * g.H + h) * N * P;
  for (int e = tid; e < N * P; e += NT) st[e] = sh[e];
}

template <int P, int N>
int launch_simt(const SsdArgs& g, int B, cudaStream_t st) {
  constexpr int bytes = SimtSmem<P, N>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<P, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_kernel<P, N><<<dim3(g.H, B), NT, bytes, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// ---- route tile: one block per (b, a group of heads, slice of state columns)
// The tiling is chosen at compile time by the state size N: SsdTile<N>.
template <int N>
struct SsdTile;

// cs of one head over a chunk (the inclusive cumsum of dt a, f64) by one
// warp's shuffle scan, two rows a lane, with exp(cs_t), the injection
// weights exp(cs_last - cs_s) dt_s and exp(cs_last)
__device__ __forceinline__ void chunk_decays(const float* Dt, float av, int lane, double* cs,
                                             float* ecs, float* ws, float* dec) {
  const float d0 = Dt[2 * lane], d1 = Dt[2 * lane + 1];
  const double l0 = static_cast<double>(d0) * av, l1 = static_cast<double>(d1) * av;
  double incl = l0 + l1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double c0 = excl + l0;
  const double last = __shfl_sync(0xffffffffu, incl, 31);
  cs[2 * lane] = c0;
  cs[2 * lane + 1] = incl;
  ecs[2 * lane] = expf(static_cast<float>(c0));
  ecs[2 * lane + 1] = expf(static_cast<float>(incl));
  ws[2 * lane] = expf(static_cast<float>(last - c0)) * d0;
  ws[2 * lane + 1] = expf(static_cast<float>(last - incl)) * d1;
  if (lane == 0) *dec = expf(static_cast<float>(last));
}

// state 16 (hymba-1.5b): HG heads and PW of the 64 state columns a block
constexpr int PW = 32;          // state columns a block owns
constexpr int HG = 2;           // heads a block takes, sharing C B^T
constexpr int SSD_STAGES = 2;   // chunks in the cp.async ring (1 in flight)

template <>
struct SsdTile<16> {
  static constexpr int P = 64, N = 16, NT = 256, TP = PW / 8, STAGES = SSD_STAGES;
  static constexpr int HEADS = HG, SLICES = P / PW, BLOCKS_PER_SM = 2;
  static constexpr int BP = N + 4;        // B and C rows
  static constexpr int MP = C + N + 4;    // M, then C' = exp(cs) C
  static constexpr int HP = PW + 4;       // state and y-partial rows
  static constexpr int STAGE = HG * C * PW + 2 * C * BP + HG * C;   // x, B, C, dt
  static constexpr int FLOATS = 2 * HG * C + STAGES * STAGE + C * MP + 4 * 16 * HP +
                                HG * N * HP + N * HP + 2 * HG * C + 4;
  static constexpr int BYTES = FLOATS * 4;
};

__device__ __forceinline__ void ssd_tile_n16(const SsdArgs& g) {
  using L = SsdTile<16>;
  constexpr int N = L::N, TP = L::TP, BP = L::BP, MP = L::MP, HP = L::HP;
  extern __shared__ __align__(16) float smem[];
  double* const cs = reinterpret_cast<double*>(smem);   // [HG][C], f64
  float* const stage0 = smem + 2 * HG * C;
  float* const Msh = stage0 + L::STAGES * L::STAGE;      // [C][MP]
  float* const Yp = Msh + C * MP;                        // [4][16][HP]
  float* const Hsh = Yp + 4 * 16 * HP;                   // [HG][N][HP]
  float* const Hp = Hsh + HG * N * HP;                   // [N][HP]
  float* const ecs = Hp + N * HP;                        // [HG][C]: exp(cs_t)
  float* const ws = ecs + HG * C;                        // [HG][C]: injection weights
  float* const dec = ws + HG * C;                        // [HG]: exp(cs_last)

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * PW, h0 = blockIdx.y * HG, b = blockIdx.z;
  const int nch = (g.S + C - 1) / C;

  // x slices, B, C and dt of chunk c into stage st, one commit group (empty
  // past the last chunk); rows past S, and heads past H, zero. A thread
  // copies 16 bytes of x rows xr, xr + XR, .. (column 4 xq) for each head,
  // of B and C row tid / 4 (column 4 (tid % 4)) and, for tid < HG C, dt, at
  // addresses set up once.
  constexpr int XQ = PW / 4, XR = L::NT / XQ;   // x: 16-byte pieces a row, rows a pass
  const int xr = tid / XQ, xq = tid % XQ, br = tid >> 2, bq = tid & 3;
  const long long xo = b * g.xb + h0 * g.xh + static_cast<long long>(xr) * g.xs + p0 + 4 * xq;
  const long long bo = b * g.bb + static_cast<long long>(br) * g.bs + 4 * bq;
  const long long co = b * g.cb + static_cast<long long>(br) * g.cs + 4 * bq;
  const int dhd = tid / C, dr = tid % C;   // dt: head, row
  const long long dto = b * g.db + (h0 + dhd) * g.dh + static_cast<long long>(dr) * g.ds;
  auto load = [&](int c, int st) {
    if (c < nch) {
      float* X = stage0 + st * L::STAGE;
      float* Bs = X + HG * C * PW;
      float* Cs = Bs + C * BP;
      float* Dt = Cs + C * BP;
      const int t0 = c * C;
#pragma unroll
      for (int hh = 0; hh < HG; ++hh)
#pragma unroll
        for (int h2 = 0; h2 < C / XR; ++h2) {
          const int row = xr + XR * h2;
          const bool in = t0 + row < g.S && h0 + hh < g.H;
          repro::cp_async16(X + (hh * C + row) * PW + 4 * xq,
                            in ? g.x + xo + hh * g.xh + (t0 + XR * h2) * g.xs : g.x, in);
        }
      const bool in = t0 + br < g.S;
      repro::cp_async16(Bs + br * BP + 4 * bq, in ? g.bm + bo + t0 * g.bs : g.bm, in);
      repro::cp_async16(Cs + br * BP + 4 * bq, in ? g.cm + co + t0 * g.cs : g.cm, in);
      if (tid < HG * C) {
        const bool din = t0 + dr < g.S && h0 + dhd < g.H;
        repro::cp_async4(Dt + dhd * C + dr, din ? g.dt + dto + t0 * g.ds : g.dt, din);
      }
    }
    repro::cp_async_commit();
  };

  for (int e = tid; e < HG * N * HP; e += L::NT) Hsh[e] = 0.f;
  // lane roles: band tw = w & 3 (rows 16 tw ..), K half kh = w >> 2;
  // lane tile rows tb + 4 r, columns TP pb ..
  const int tw = w & 3, kh = w >> 2, tb = lane & 3, pb = lane >> 2;
  float Hreg[HG][4][TP] = {};        // warp 4: rows 4 tb .., columns TP pb ..
#pragma unroll
  for (int c = 0; c < L::STAGES - 1; ++c) load(c, c);

  for (int c = 0; c < nch; ++c) {
    const int t0 = c * C;
    float* const X = stage0 + c % L::STAGES * L::STAGE;
    float* const Bs = X + HG * C * PW;
    float* const Cs = Bs + C * BP;
    float* const Dt = Cs + C * BP;
    repro::cp_async_wait<L::STAGES - 2>();
    __syncthreads();            // chunk c landed; chunk c - 1 is done with its stage
    load(c + L::STAGES - 1, (c + L::STAGES - 1) % L::STAGES);

    // 1. warps 1 and 3 (no C B^T tile of theirs lies below the diagonal,
    //    so they are free): cs of head w >> 1 (f64 shuffle scan, two rows a
    //    lane), exp(cs_t), the injection weights exp(cs_last - cs_s) dt_s,
    //    exp(cs_last); a head past H has dt = 0 and a = 0
    if ((w == 1 || w == 3) && (w >> 1) < HG) {
      const int sh = w >> 1;
      chunk_decays(Dt + sh * C, h0 + sh < g.H ? g.a[h0 + sh] : 0.f, lane, cs + sh * C,
                   ecs + sh * C, ws + sh * C, dec + sh);
    }
    //    every warp: C B^T on a 4 x 4 tile, rows 16 (w >> 1) + tb + 4 r,
    //    columns 32 (w & 1) + pb + 8 c2, kept for the block's heads; the
    //    column pair c2 = 2 cp, 2 cp + 1 lies in the 16-column band
    //    2 (w & 1) + cp, skipped (warp-uniformly) above the row band
    const int ct = 16 * (w >> 1) + tb, cs0 = 32 * (w & 1) + pb;
    float cb[4][4] = {};
#pragma unroll
    for (int cp = 0; cp < 2; ++cp) {
      if (2 * (w & 1) + cp > (w >> 1)) continue;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        float av[4][4], bv[2][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) repro::ldv(Cs + (ct + 4 * r) * BP + n, av[r]);
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) repro::ldv(Bs + (cs0 + 8 * (2 * cp + c2)) * BP + n, bv[c2]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              cb[r][2 * cp + c2] = fmaf(av[r][q], bv[c2][q], cb[r][2 * cp + c2]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int gh = 0; gh < HG; ++gh) {
      const double* csh = cs + gh * C;
      const float* Xh = X + gh * C * PW;
      // 2. M = C B^T * exp(cs_t - cs_s) dt_s below and on the diagonal;
      //    C' = exp(cs_t) C beside it. A column band above the row band is
      //    zeros (warp-uniform); inside a band no branch, so the 8
      //    exponentials interleave (above the diagonal the exponent is
      //    clamped to 0 and the value dropped)
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        if (2 * (w & 1) + cp > (w >> 1)) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) Msh[(ct + 4 * r) * MP + cs0 + 8 * (2 * cp + c2)] = 0.f;
          continue;
        }
        double css[2];
        float dts[2];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          css[c2] = csh[cs0 + 8 * (2 * cp + c2)];
          dts[c2] = Dt[gh * C + cs0 + 8 * (2 * cp + c2)];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = ct + 4 * r;
          const double cst = csh[t];
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int s = cs0 + 8 * (2 * cp + c2);
            const float e = expf(fminf(static_cast<float>(cst - css[c2]), 0.f));
            Msh[t * MP + s] = s <= t ? cb[r][2 * cp + c2] * (e * dts[c2]) : 0.f;
          }
        }
      }
      {
        const int t = tid >> 2, nq = tid & 3;
        float v[4];
        repro::ldv(Cs + t * BP + 4 * nq, v);
        const float e = ecs[gh * C + t];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] *= e;
        repro::stv(Msh + t * MP + C + 4 * nq, v);
      }
      __syncthreads();
      // 3. y partials over [M | C'] [x ; h]: band tw, K half kh (kh 0: s <
      //    32; kh 1: s >= 32 and the C' h term), rows past the band's last
      //    one skipped; warps 4 and 5 also sum the state injection over s <
      //    32 and s >= 32
      float acc[4][TP] = {};
      auto step = [&](const float* A, const float* Bm, int ldb) {
        float av[4][4], bv[4][TP];
#pragma unroll
        for (int r = 0; r < 4; ++r) repro::ldv(A + (16 * tw + tb + 4 * r) * MP, av[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) repro::ldv(Bm + q * ldb + TP * pb, bv[q]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c2 = 0; c2 < TP; ++c2) acc[r][c2] = fmaf(av[r][q], bv[q][c2], acc[r][c2]);
      };
      const int s_hi = kh ? 16 * tw + 16 : min(32, 16 * tw + 16);
      for (int s = kh ? 32 : 0; s < s_hi; s += 4) step(Msh + s, Xh + s * PW, PW);
      float hacc[4][TP] = {};
      if (kh) {
#pragma unroll
        for (int n = 0; n < N; n += 4) step(Msh + C + n, Hsh + (gh * N + n) * HP, HP);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          repro::stv(Yp + (tw * 16 + tb + 4 * r) * HP + TP * pb, acc[r]);
        if (tw < 2) {
#pragma unroll 4
          for (int s = 32 * tw; s < 32 * tw + 32; ++s) {
            float bq[4], xq[TP];
            repro::ldv(Bs + s * BP + 4 * tb, bq);
            repro::ldv(Xh + s * PW + TP * pb, xq);
            const float wsv = ws[gh * C + s];
#pragma unroll
            for (int c2 = 0; c2 < TP; ++c2) xq[c2] *= wsv;
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int c2 = 0; c2 < TP; ++c2) hacc[q][c2] = fmaf(bq[q], xq[c2], hacc[q][c2]);
          }
          if (tw == 1) {
#pragma unroll
            for (int q = 0; q < 4; ++q) repro::stv(Hp + (4 * tb + q) * HP + TP * pb, hacc[q]);
          }
        }
      }
      __syncthreads();
      // 4. y = the band's two K halves, written through its strides; warp 4:
      //    h <- exp(cs_last) h + both injection halves, into shared memory
      //    for the next chunk's C' h
      if (!kh) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = 16 * tw + tb + 4 * r;
          float v[TP];
          repro::ldv(Yp + (tw * 16 + tb + 4 * r) * HP + TP * pb, v);
#pragma unroll
          for (int c2 = 0; c2 < TP; ++c2) v[c2] += acc[r][c2];
          if (t0 + t < g.S && h0 + gh < g.H)
            repro::stv(g.y + b * g.yb + (h0 + gh) * g.yh + (t0 + t) * g.ys + p0 + TP * pb, v);
        }
      } else if (tw == 0) {
        const float d = dec[gh];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[TP];
          repro::ldv(Hp + (4 * tb + q) * HP + TP * pb, v);
#pragma unroll
          for (int c2 = 0; c2 < TP; ++c2)
            Hreg[gh][q][c2] = fmaf(d, Hreg[gh][q][c2], hacc[q][c2] + v[c2]);
          repro::stv(Hsh + (gh * N + 4 * tb + q) * HP + TP * pb, Hreg[gh][q]);
        }
      }
    }
  }
  if (w == 4) {
#pragma unroll
    for (int gh = 0; gh < HG && h0 + gh < g.H; ++gh) {
      float* st = g.state + (static_cast<long long>(b) * g.H + h0 + gh) * N * L::P;
#pragma unroll
      for (int q = 0; q < 4; ++q) repro::stv(st + (4 * tb + q) * L::P + p0 + TP * pb, Hreg[gh][q]);
    }
  }
}

// state 128 (granite-4.0-h): a block owns one row, HEADS heads and all 64
// state columns. Shared memory, in floats: the f64 cs of each head (2 HEADS
// C); a ring of STAGES chunks of B and C [C][N + 4] (rows padded 16 bytes,
// so 4 or 8 rows read at once as LDS.128 hit distinct banks) and the heads'
// dt; each head's x [C][P], reloaded as soon as that head is done with it;
// M [C][C + 4]; the state of the head being read out [N][P]; exp(cs),
// the injection weights and exp(cs_last) of each head. At HEADS 2, STAGES 2:
// 256 + 2 x 17,024 + 8,192 + 4,352 + 8,192 + 260 = 55,300 floats (221,200 B)
// of the 232,448 a block can have: one block an SM.
template <>
struct SsdTile<128> {
  static constexpr int P = 64, N = 128, NT = 256, HEADS = 2, STAGES = 2;
  static constexpr int SLICES = 1, BLOCKS_PER_SM = 1;
  static constexpr int BP = N + 4;        // B and C rows
  static constexpr int MP = C + 4;        // M rows
  static constexpr int STAGE = 2 * C * BP + HEADS * C;   // B, C, dt
  static constexpr int FLOATS = 2 * HEADS * C + STAGES * STAGE + HEADS * C * P + C * MP +
                                N * P + 2 * HEADS * C + 4;
  static constexpr int BYTES = FLOATS * 4;
};

// C B^T on a 4 x J register tile: rows t + 4 r of Cs, rows s + 8 j of Bs, K = N
// in steps of 4 (each C row read once a step for every column)
template <int J, int N, int BP>
__device__ __forceinline__ void cb_tile(const float* Cs, const float* Bs, int t, int s,
                                        float (&cb)[4][4]) {
#pragma unroll 8
  for (int n = 0; n < N; n += 4) {
    float av[4][4], bv[J][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) repro::ldv(Cs + (t + 4 * r) * BP + n, av[r]);
#pragma unroll
    for (int j = 0; j < J; ++j) repro::ldv(Bs + (s + 8 * j) * BP + n, bv[j]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) cb[r][j] = fmaf(av[r][q], bv[j][q], cb[r][j]);
  }
}

// acc[r][:] += sum_k A[t + 4 r][k] Bm[k][0 .. 3] over k in [0, K): A rows of
// stride lda, Bm rows of stride P; a 4 x 4 register tile fed by LDS.128
template <int P>
__device__ __forceinline__ void mac_rows(const float* A, int lda, const float* Bm, int K, int t,
                                         float (&acc)[4][4]) {
#pragma unroll 8
  for (int k = 0; k < K; k += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) repro::ldv(A + (t + 4 * r) * lda + k, av[r]);
#pragma unroll
    for (int q = 0; q < 4; ++q) repro::ldv(Bm + (k + q) * P, bv[q]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) acc[r][c2] = fmaf(av[r][q], bv[q][c2], acc[r][c2]);
  }
}

__device__ __forceinline__ void ssd_tile_n128(const SsdArgs& g) {
  using L = SsdTile<128>;
  constexpr int N = L::N, P = L::P, HB = L::HEADS, BP = L::BP, MP = L::MP;
  extern __shared__ __align__(16) float smem[];
  double* const cs = reinterpret_cast<double*>(smem);   // [HB][C], f64
  float* const ring = smem + 2 * HB * C;                 // STAGES x (B, C, dt)
  float* const Xs = ring + L::STAGES * L::STAGE;         // [HB][C][P]
  float* const Msh = Xs + HB * C * P;                    // [C][MP]
  float* const Hsh = Msh + C * MP;                       // [N][P]
  float* const ecs = Hsh + N * P;                        // [HB][C]: exp(cs_t)
  float* const ws = ecs + HB * C;                        // [HB][C]: injection weights
  float* const dec = ws + HB * C;                        // [HB]: exp(cs_last)

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int h0 = blockIdx.y * HB, b = blockIdx.z;
  const int nch = (g.S + C - 1) / C;

  // B and C of chunk c (rows w + 8 i, 16 bytes at column 4 lane) and the
  // heads' dt (thread tid < HB C: head tid / C, row tid % C) into its ring
  // stage, one commit group (empty past the last chunk); rows past S, and
  // heads past H, zero
  auto load_bc = [&](int c) {
    if (c < nch) {
      float* const Bs = ring + c % L::STAGES * L::STAGE;
      float* const Cs = Bs + C * BP;
      const int t0 = c * C;
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
        const int r = w + 8 * i;
        const bool in = t0 + r < g.S;
        const long long row = t0 + r;
        repro::cp_async16(Bs + r * BP + 4 * lane,
                          in ? g.bm + b * g.bb + row * g.bs + 4 * lane : g.bm, in);
        repro::cp_async16(Cs + r * BP + 4 * lane,
                          in ? g.cm + b * g.cb + row * g.cs + 4 * lane : g.cm, in);
      }
      if (tid < HB * C) {
        const int hd = tid / C;
        const long long row = t0 + tid % C;
        const bool in = row < g.S && h0 + hd < g.H;
        repro::cp_async4(Cs + C * BP + tid,
                         in ? g.dt + b * g.db + (h0 + hd) * g.dh + row * g.ds : g.dt, in);
      }
    }
    repro::cp_async_commit();
  };
  // x of head gh, chunk c (rows (tid >> 4) + 16 i, 16 bytes at column
  // 4 (tid & 15)) into that head's buffer, one commit group
  auto load_x = [&](int gh, int c) {
    if (c < nch) {
      float* const X = Xs + gh * C * P;
      const int t0 = c * C, xq = tid & 15;
#pragma unroll
      for (int i = 0; i < C / 16; ++i) {
        const int r = (tid >> 4) + 16 * i;
        const long long row = t0 + r;
        const bool in = row < g.S && h0 + gh < g.H;
        repro::cp_async16(X + r * P + 4 * xq,
                          in ? g.x + b * g.xb + (h0 + gh) * g.xh + row * g.xs + 4 * xq : g.x,
                          in);
      }
    }
    repro::cp_async_commit();
  };

  // lane roles. C B^T, M and y: row band rb = w >> 1 (rows ct + 4 r), column
  // half ch = w & 1 (C B^T columns cs0 + 8 j; y columns py .. py + 3). The
  // state update: rows n0 .. n0 + 3, columns 4 pb + 32 j + q (j = 0, 1), that
  // slice of each head's state kept in registers across chunks
  const int tb = lane & 3, pb = lane >> 2, rb = w >> 1, ch = w & 1;
  const int ct = 16 * rb + tb, cs0 = 32 * ch + pb, py = 32 * ch + 4 * pb;
  const int n0 = 16 * w + 4 * tb;
  float Hreg[HB][4][2][4] = {};   // [head][r][j][q]

  // commit order: B/C/dt of chunk c, then x of each head for chunk c. At the
  // top of a chunk and before each head, the HB newest groups may still be
  // in flight and the one needed next has landed
  load_bc(0);
#pragma unroll
  for (int gh = 0; gh < HB; ++gh) load_x(gh, 0);

  for (int c = 0; c < nch; ++c) {
    const int t0 = c * C;
    const float* const Bs = ring + c % L::STAGES * L::STAGE;
    const float* const Cs = Bs + C * BP;
    const float* const Dt = Cs + C * BP;
    repro::cp_async_wait<HB>();
    __syncthreads();            // chunk c's B, C, dt landed; chunk c - 1 is done
    load_bc(c + 1);

    // 1. warps 1 and 3 (no C B^T tile of theirs lies below the diagonal):
    //    the decays of head w >> 1 (a head past H has dt = 0 and a = 0);
    //    every other warp: C B^T on its 4 x 4 tile, the 16-column bands
    //    above its row band skipped (warp-uniformly), kept in registers
    //    for the block's heads
    if ((w & 1) && (w >> 1) < HB) {
      const int sh = w >> 1;
      chunk_decays(Dt + sh * C, h0 + sh < g.H ? g.a[h0 + sh] : 0.f, lane, cs + sh * C,
                   ecs + sh * C, ws + sh * C, dec + sh);
    }
    float cb[4][4] = {};
    if (2 * ch + 1 <= rb)
      cb_tile<4, N, BP>(Cs, Bs, ct, cs0, cb);
    else if (2 * ch <= rb)
      cb_tile<2, N, BP>(Cs, Bs, ct, cs0, cb);
    __syncthreads();

#pragma unroll
    for (int gh = 0; gh < HB; ++gh) {
      const double* const csh = cs + gh * C;
      const float* const X = Xs + gh * C * P;
      // 2. M = C B^T * exp(cs_t - cs_s) dt_s on and below the diagonal (the
      //    bands y reads); no branch inside a band, so the 8 exponentials
      //    interleave (above the diagonal the exponent is clamped to 0 and
      //    the value dropped). The head's state before this chunk into Hsh
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        if (2 * ch + jp > rb) continue;
        double css[2];
        float dts[2];
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          css[j2] = csh[cs0 + 8 * (2 * jp + j2)];
          dts[j2] = Dt[gh * C + cs0 + 8 * (2 * jp + j2)];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = ct + 4 * r;
          const double cst = csh[t];
#pragma unroll
          for (int j2 = 0; j2 < 2; ++j2) {
            const int s = cs0 + 8 * (2 * jp + j2);
            const float e = expf(fminf(static_cast<float>(cst - css[j2]), 0.f));
            Msh[t * MP + s] = s <= t ? cb[r][2 * jp + j2] * (e * dts[j2]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j) repro::stv(Hsh + (n0 + r) * P + 4 * pb + 32 * j, Hreg[gh][r][j]);
      repro::cp_async_wait<HB>();
      __syncthreads();          // M, Hsh and this head's x are in place

      // 3. y = exp(cs_t) C_t h + sum_{s <= t} M[t][s] x_s: rows ct + 4 r,
      //    columns py .., the s loop ending with the warp's row band
      float acc[4][4] = {};
      mac_rows<P>(Cs, BP, Hsh + py, N, ct, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ecs[gh * C + ct + 4 * r];
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) acc[r][c2] *= e;
      }
      mac_rows<P>(Msh, MP, X + py, 16 * rb + 16, ct, acc);
      if (h0 + gh < g.H) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const long long t = t0 + ct + 4 * r;
          if (t < g.S) repro::stv(g.y + b * g.yb + (h0 + gh) * g.yh + t * g.ys + py, acc[r]);
        }
      }
      // 4. h <- exp(cs_last) h + sum_s (w_s B_s) x_s^T on this thread's
      //    4 x 8 slice of the state
      const float d = dec[gh];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) Hreg[gh][r][j][q] *= d;
#pragma unroll 8
      for (int s = 0; s < C; ++s) {
        float bq[4], xv[2][4];
        repro::ldv(Bs + s * BP + n0, bq);
#pragma unroll
        for (int j = 0; j < 2; ++j) repro::ldv(X + s * P + 4 * pb + 32 * j, xv[j]);
        const float wsv = ws[gh * C + s];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bw = bq[r] * wsv;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) Hreg[gh][r][j][q] = fmaf(bw, xv[j][q], Hreg[gh][r][j][q]);
        }
      }
      __syncthreads();          // every warp is done with Msh, Hsh and this head's x
      load_x(gh, c + 1);
    }
  }
#pragma unroll
  for (int gh = 0; gh < HB; ++gh) {
    if (h0 + gh >= g.H) break;
    float* const st = g.state + (static_cast<long long>(b) * g.H + h0 + gh) * N * P;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) repro::stv(st + (n0 + r) * P + 4 * pb + 32 * j, Hreg[gh][r][j]);
  }
}

// one kernel name for both tilings (the profiler's and the SASS counts' tag)
template <int P, int N>
__global__ void __launch_bounds__(SsdTile<N>::NT, SsdTile<N>::BLOCKS_PER_SM)
    ssd_tile_kernel(SsdArgs g) {
  if constexpr (N == 16)
    ssd_tile_n16(g);
  else
    ssd_tile_n128(g);
}

template <int P, int N>
int launch_tile(const SsdArgs& g, int B, cudaStream_t st) {
  using L = SsdTile<N>;
  cudaError_t e = cudaFuncSetAttribute(ssd_tile_kernel<P, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(L::SLICES, (g.H + L::HEADS - 1) / L::HEADS, B);
  ssd_tile_kernel<P, N><<<grid, L::NT, L::BYTES, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route 1: tile; 0: simt
extern "C" int ssd_chunked_launch(const void* x, const void* dt, const void* bm,
                                  const void* cm, const void* a, void* y, void* state,
                                  int B, int H, int S, int P, int N, long long xb,
                                  long long xh, long long xs, long long db, long long dh,
                                  long long ds, long long bb, long long bs, long long cb,
                                  long long cs, long long yb, long long yh, long long ys,
                                  int route, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 16)
    return route == 1 ? launch_tile<64, 16>(g, B, st) : launch_simt<64, 16>(g, B, st);
  if (P == 64 && N == 128)
    return route == 1 ? launch_tile<64, 128>(g, B, st) : launch_simt<64, 128>(g, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the tile route's dynamic shared memory a block at state N (16 or 128)
extern "C" int ssd_tile_smem_bytes(int N) {
  return N == 128 ? SsdTile<128>::BYTES : SsdTile<16>::BYTES;
}
