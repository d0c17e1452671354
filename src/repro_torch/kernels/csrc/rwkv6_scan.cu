// Chunked WKV6 (the RWKV6 "Finch" time-mix recurrence) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rwkv6_scan.py: rwkv6_chunked (_wkv6_kernel,
// pallas_call at :67).
//
// Per (row b, head h), with a [hd, hd] f32 state S that starts at zero:
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w = log-decay <= 0)
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
// chunk's rows past S load as zeros (k = 0, w = 0: no change to S, cs stops
// growing) and write no y. Sums run in another order than the sequential
// plain version (kernels/ref.py:rwkv6_ref): results agree to f32 rounding,
// not bit for bit.
//
// The TPU grid runs (b, h, chunk) in order and carries S in VMEM across the
// chunk axis. A CUDA block cannot carry anything to another block, so a
// block walks every chunk of its (b, h) itself. Two routes:
//
//   tile  (wkv6_tile_kernel, every aligned call: the model's views are)
//         Column j of S depends only on column j of v (S[:, j] <- diag(e^w)
//         S[:, j] + k v_j), so a block owns one (b, h) and a slice of JW
//         state columns (JW 32: 640 blocks at the serve shape, 2 slices a
//         head; slices of 16 measured slower, PERF.md) and recomputes the
//         chunk's 16 x 16 scores.
//         128 threads. Each chunk's r, k, w rows and v slice land by 16-byte
//         cp.async in a 2-stage ring, one chunk ahead of the one that
//         computes. Per chunk: the cumsum runs across the lanes (a
//         branch-free shuffle scan over the 8 lanes of a channel quad, two
//         rows a lane), r' and k' are scaled in place; the scores, y and the state update are f32 FMA on register
//         tiles of 4 x 4 (4 x TJ) read as LDS.128 from rows padded so a
//         warp's reads hit distinct banks: at least 8 FMA per vector load.
//         y = [r' | A] [S ; v] is one K = 80 product split over the 4 warps
//         (16 state rows + 4 score columns each) and summed through shared
//         memory; the slice's 64 x JW state stays in registers (4 x TJ a
//         lane), copied to shared memory for the next chunk's y.
//   simt  (wkv6_kernel, the first design, for unaligned rows) one 256-thread
//         block per (b, h) walks the chunks with S in shared memory, both
//         operands of each FMA read from shared memory.
//
// What bounds it on the H100: bytes. Each input element is read once (4
// tensors [B,H,S,hd] f32 + u) and each output written once (y, final S): 58 MB
// at the serve shape, 17 us at 3.35 TB/s, against 0.84 GFLOP (13 us at the
// f32 peak outside the tensor cores). The tile route runs at 3.3x the
// bytes bound. Its FMAs run at 6 per shared load (SASS), so shared loads
// do not bound them. Taking parts out (kernels/scan_ablation.py; PERF.md
// has the times): the register-tile products (scores, y, state update)
// cost a third of the time, the cumsum and its 20 exponentials a thread a
// sixth, the exposed loads a twentieth; the rest is each chunk's fixed
// work (five barriers, the score and y partial sums through shared
// memory). Slices of 16 repeat that work per slice and run 59% slower; a
// deeper ring costs occupancy (3 stages: 3 blocks a SM, 4: 2) and runs
// slower. Inputs may be strided
// ([B, S, H, hd] memory read through a [B, H, S, hd] view, as the model
// hands them over): a row's hd floats are contiguous, so 32 lanes read 128
// contiguous bytes.
#include <cmath>

#include "common.cuh"
#include "mma.cuh"

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

// ---- route simt: one block per (b, h), S in shared memory ------------------
// Shared rows are padded to hd + 1 floats, so a warp reading one column over
// 16 rows hits 16 banks.
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

// ---- route tile: one block per (b, h, slice of JW state columns) ----------
constexpr int JW = 32;          // state columns a block owns
constexpr int WKV_STAGES = 2;   // chunks in the cp.async ring (1 in flight)

struct WkvTile {
  static constexpr int HD = 64, NT = 128, TJ = JW / 8, STAGES = WKV_STAGES;
  static constexpr int RP = HD + C + 4;   // r' and then the chunk's scores A
  static constexpr int KP = HD + 4;       // k' and w rows
  static constexpr int SP = JW + 4;       // state and y-partial rows
  static constexpr int STAGE = C * RP + 2 * C * KP + C * JW;   // R, K, W, V
  static constexpr int PS = 8 * 16 * 16;  // score partials: 8 K-parts x 16 tiles
  static constexpr int PYF = PS > 4 * C * SP ? PS : 4 * C * SP;
  static constexpr int FLOATS = STAGES * STAGE + HD * SP + PYF + 4 * C + HD;
  static constexpr int BYTES = FLOATS * 4;
};

__global__ void __launch_bounds__(128, 4) wkv6_tile_kernel(Wkv6Args a) {
  using L = WkvTile;
  constexpr int HD = L::HD, TJ = L::TJ, RP = L::RP, KP = L::KP, SP = L::SP;
  constexpr int PER = C * JW / L::NT;     // y outputs a thread writes
  extern __shared__ __align__(16) float smem[];
  float* const Ssh = smem + L::STAGES * L::STAGE;   // [HD][SP]: S before this chunk
  float* const PY = Ssh + HD * SP;          // score partials, then y partials
  float* const Dp = PY + L::PYF;            // [4][C]: the u-bonus per warp
  float* const dec = Dp + 4 * C;            // [HD]: exp(cs_last)

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * JW, h = blockIdx.y, b = blockIdx.z;
  const long long in0 = b * a.sb + h * a.sh;
  const long long out0 = b * a.yb + h * a.yh;
  const int nch = (a.S + C - 1) / C;

  // r, k, w rows and the v slice of chunk c into stage st, one commit group
  // (empty past the last chunk); rows past S zero. A thread copies 16 bytes
  // of rows lr and lr + 8 of r, k and w (column 4 lq) and of v rows lv ..
  // (column 4 qv), at addresses set up once.
  constexpr int VQ = JW / 4, VR = L::NT / VQ;   // v: 16-byte pieces a row, rows a pass
  const int lr = tid >> 4, lq = tid & 15, lv = tid / VQ, qv = tid % VQ;
  const long long rko = in0 + static_cast<long long>(lr) * a.ss + 4 * lq;
  const long long vo = in0 + static_cast<long long>(lv) * a.ss + j0 + 4 * qv;
  auto load = [&](int c, int st) {
    if (c < nch) {
      float* R = smem + st * L::STAGE;
      float* K = R + C * RP;
      float* W = K + C * KP;
      float* V = W + C * KP;
      const int t0 = c * C;
      const long long o = static_cast<long long>(t0) * a.ss;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = lr + 8 * h2;
        const bool in = t0 + row < a.S;
        const long long g = o + rko + 8 * h2 * a.ss;
        repro::cp_async16(R + row * RP + 4 * lq, in ? a.r + g : a.r, in);
        repro::cp_async16(K + row * KP + 4 * lq, in ? a.k + g : a.k, in);
        repro::cp_async16(W + row * KP + 4 * lq, in ? a.w + g : a.w, in);
      }
#pragma unroll
      for (int h2 = 0; h2 < (C + VR - 1) / VR; ++h2) {
        const int row = lv + VR * h2;
        const bool in = t0 + row < a.S;
        if (row < C)
          repro::cp_async16(V + row * JW + 4 * qv, in ? a.v + o + vo + VR * h2 * a.ss : a.v, in);
      }
    }
    repro::cp_async_commit();
  };

  for (int e = tid; e < HD * SP; e += L::NT) Ssh[e] = 0.f;
  // the cumsum lanes: channel quad cq (4 channels), row pair tg
  const int cq = tid >> 3, tg = tid & 7;
  float u4[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) u4[q] = a.u[static_cast<long long>(h) * HD + 4 * cq + q];
  // the state lanes: rows 16 w + 4 ib .. + 3, columns TJ jb .. + TJ - 1
  const int ib = lane & 3, jb = lane >> 2, i0 = 16 * w + 4 * ib;
  float Sreg[4][TJ] = {};
#pragma unroll
  for (int c = 0; c < L::STAGES - 1; ++c) load(c, c);

  for (int c = 0; c < nch; ++c) {
    const int t0 = c * C;
    float* const R = smem + c % L::STAGES * L::STAGE;
    float* const K = R + C * RP;
    float* const W = K + C * KP;
    float* const V = W + C * KP;
    repro::cp_async_wait<L::STAGES - 2>();
    __syncthreads();            // chunk c landed; chunk c - 1 is done with its stage
    load(c + L::STAGES - 1, (c + L::STAGES - 1) % L::STAGES);

    // A. cs over the chunk, a shuffle scan across the 8 lanes of a channel
    //    quad (rows 2 tg, 2 tg + 1 a lane); r' = r e^{cs_{t-1}} and
    //    k' = k e^{-cs_t} in place; the u-bonus r . (u * k) per row
    {
      float rr[2][4], kk[2][4], ww[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        repro::ldv(R + (2 * tg + e) * RP + 4 * cq, rr[e]);
        repro::ldv(K + (2 * tg + e) * KP + 4 * cq, kk[e]);
        repro::ldv(W + (2 * tg + e) * KP + 4 * cq, ww[e]);
      }
      // no branch in here: the four channels' scans and the exponentials
      // interleave
      float d[2] = {0.f, 0.f}, incl[4], dq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        incl[q] = ww[0][q] + ww[1][q];
#pragma unroll
        for (int e = 0; e < 2; ++e) d[e] = fmaf(rr[e][q] * u4[q], kk[e][q], d[e]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = __shfl_up_sync(0xffffffffu, incl[q], o, 8);
          incl[q] += tg >= o ? v : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float up = __shfl_up_sync(0xffffffffu, incl[q], 1, 8);
        const float excl = tg == 0 ? 0.f : up;
        const float cs0 = excl + ww[0][q];
        rr[0][q] *= expf(excl);
        kk[0][q] *= expf(-cs0);
        rr[1][q] *= expf(cs0);
        kk[1][q] *= expf(-incl[q]);
        dq[q] = expf(incl[q]);
      }
      if (tg == 7) repro::stv(dec + 4 * cq, dq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        repro::stv(R + (2 * tg + e) * RP + 4 * cq, rr[e]);
        repro::stv(K + (2 * tg + e) * KP + 4 * cq, kk[e]);
        d[e] += __shfl_xor_sync(0xffffffffu, d[e], 8);
        d[e] += __shfl_xor_sync(0xffffffffu, d[e], 16);
      }
      if (lane < 8) {
        Dp[w * C + 2 * tg] = d[0];
        Dp[w * C + 2 * tg + 1] = d[1];
      }
    }
    __syncthreads();
    // B. score partials r'_t . k'_s over 8 channels a lane: tile (T, Sx) holds
    //    rows T + 4 r and columns Sx + 4 c; K-part 2 w + kh
    {
      const int tile = lane & 15, T = tile >> 2, Sx = tile & 3, kh = lane >> 4;
      float acc[4][4] = {};
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int ch = 16 * w + 8 * kh + 4 * g;
        float av[4][4], bv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) repro::ldv(R + (T + 4 * r) * RP + ch, av[r]);
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) repro::ldv(K + (Sx + 4 * c2) * KP + ch, bv[c2]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][c2] = fmaf(av[r][q], bv[c2][q], acc[r][c2]);
      }
      float* P = PY + ((2 * w + kh) * 16 + tile) * 16;
#pragma unroll
      for (int r = 0; r < 4; ++r) repro::stv(P + 4 * r, acc[r]);
    }
    __syncthreads();
    // the scores A[t][s] into R's columns HD + s: the 8 parts summed below
    // the diagonal, the u-bonus on it, zero above
    if (tid < 64) {
      const int tile = tid >> 2, r = tid & 3, T = tile >> 2, Sx = tile & 3, t = T + 4 * r;
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float v[4];
        repro::ldv(PY + (p * 16 + tile) * 16 + 4 * r, v);
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) sum[c2] += v[c2];
      }
      const float diag = Dp[t] + Dp[C + t] + Dp[2 * C + t] + Dp[3 * C + t];
#pragma unroll
      for (int c2 = 0; c2 < 4; ++c2) {
        const int s = Sx + 4 * c2;
        R[t * RP + HD + s] = s < t ? sum[c2] : (s == t ? diag : 0.f);
      }
    }
    __syncthreads();
    // C. y partials: warp w takes K rows 16 w .. 16 w + 15 of [r' | A] [S ; v]
    //    (state rows) and 4 w .. 4 w + 3 (score columns / v rows); lane tile
    //    rows tb + 4 r, columns TJ jb .. + TJ - 1
    {
      const int tb = lane & 3;
      float acc[4][TJ] = {};
      auto step = [&](const float* A, const float* Bm, int ldb) {
        float av[4][4], bv[4][TJ];
#pragma unroll
        for (int r = 0; r < 4; ++r) repro::ldv(A + (tb + 4 * r) * RP, av[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) repro::ldv(Bm + q * ldb + TJ * jb, bv[q]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c2 = 0; c2 < TJ; ++c2) acc[r][c2] = fmaf(av[r][q], bv[q][c2], acc[r][c2]);
      };
#pragma unroll
      for (int g = 0; g < 4; ++g) step(R + 16 * w + 4 * g, Ssh + (16 * w + 4 * g) * SP, SP);
      step(R + HD + 4 * w, V + 4 * w * JW, JW);
      float* Y = PY + w * C * SP;
#pragma unroll
      for (int r = 0; r < 4; ++r) repro::stv(Y + (tb + 4 * r) * SP + TJ * jb, acc[r]);
    }
    __syncthreads();
    // D. S <- exp(cs_last) (S + k'^T v) on the lane's register tile, copied
    //    to shared memory for the next chunk; y = the 4 warps' partials
    {
      float acc[4][TJ];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c2 = 0; c2 < TJ; ++c2) acc[q][c2] = Sreg[q][c2];
#pragma unroll 4
      for (int s = 0; s < C; ++s) {
        float kq[4], vq[TJ];
        repro::ldv(K + s * KP + i0, kq);
        repro::ldv(V + s * JW + TJ * jb, vq);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c2 = 0; c2 < TJ; ++c2) acc[q][c2] = fmaf(kq[q], vq[c2], acc[q][c2]);
      }
      float dq[4];
      repro::ldv(dec + i0, dq);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int c2 = 0; c2 < TJ; ++c2) Sreg[q][c2] = dq[q] * acc[q][c2];
        repro::stv(Ssh + (i0 + q) * SP + TJ * jb, Sreg[q]);
      }
      const int t = tid >> 3, jq = tid & 7;
      float y[PER] = {};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float v[PER];
        repro::ldv(PY + p * C * SP + t * SP + PER * jq, v);
#pragma unroll
        for (int e = 0; e < PER; ++e) y[e] += v[e];
      }
      if (t0 + t < a.S) repro::stv(a.y + out0 + (t0 + t) * a.ys + j0 + PER * jq, y);
    }
  }
  float* st = a.state + (static_cast<long long>(b) * a.H + h) * HD * HD;
#pragma unroll
  for (int q = 0; q < 4; ++q) repro::stv(st + (i0 + q) * HD + j0 + TJ * jb, Sreg[q]);
}

int launch_tile(const Wkv6Args& a, int B, cudaStream_t st) {
  constexpr int bytes = WkvTile::BYTES;
  cudaError_t e = cudaFuncSetAttribute(wkv6_tile_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(WkvTile::HD / JW, a.H, B);
  wkv6_tile_kernel<<<grid, WkvTile::NT, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route 1: tile; 0: simt
extern "C" int rwkv6_chunked_launch(const void* r, const void* k, const void* v,
                                    const void* w, const void* u, void* y, void* state,
                                    int B, int H, int S, int hd, long long sb, long long sh,
                                    long long ss, long long yb, long long yh, long long ys,
                                    int route, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) return launch_tile(a, B, st);
  const dim3 grid(H, B), block(NT);
  wkv6_kernel<64><<<grid, block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the tile route's dynamic shared memory a block
extern "C" int rwkv6_tile_smem_bytes() { return WkvTile::BYTES; }
