// Non-causal flash attention backward (FA2 from the saved logsumexp):
// q [B, N, H, DH], k/v [B, M, H, DH], dout [B, N, H, DH], lse and
// delta = rowsum(dout * out) [B, H, N] f32. Probabilities are rebuilt as
// p = exp(scale q.k - lse); ds = p (dout.v - delta); dv = sum_i p dout_i,
// dk = scale sum_i ds q_i, dq = scale sum_j ds k_j (with respect to the
// unscaled q). Nothing [N, M]-shaped touches device memory. DH is 16, 32,
// 64 or 128; the wrapper zero-pads any other head dim to the next of these
// and slices the gradients back (the padded columns of dq, dk and dv come out
// zero: q, k, v and dout are zero there).
//
// Replaces mvsformerplusplus_tpu/ops/pallas/flash_attention.py _flash_bwd
// (_bwd_dkv_kernel, _bwd_dq_kernel). Two routes, chosen by type:
//
// flash_bwd_mma_kernel (bf16), FA2's fused backward on mma.sync: the N*M
// exponentials, which bound the CTA backward (DH=16) on the H100's SFUs,
// are computed once instead of once per kernel of a split. A block of 4
// warps owns 64 key rows of one (b, h), 16 per warp, with K and V fragments
// in registers (ldmatrix once), and streams query tiles (64 rows at DH=16,
// 32 at DH=32, 64 and 128) of q and dout (two-stage cp.async ring, zero-
// filled past N) with lse * log2e and delta, in dynamic shared memory (75 KB
// at DH=128, 2 blocks per SM). At DH=128 the K and V fragments and the dK and
// dV accumulators alone take 192 registers a thread: ptxas's spill line
// (chip_smoke.py's build phase) says what spills there. Per tile each warp computes, in the
// accumulator layout of its 16 keys x the tile's queries:
//   S^T = K.Q^T and dP^T = V.dO^T (tensor cores, f32 accumulate);
//   P^T = ex2(S^T scale log2e - lse log2e) (one FFMA + ex2 per logit; lse =
//         +inf past N gives 0), dS^T = P^T (dP^T - delta);
//   dV += P^T.dO and dK += dS^T.Q, P^T and dS^T packed to bf16 in registers
//         as the A operands (as the TPU kernel rounds p and ds to the input
//         type), dO and Q from ldmatrix.trans.
// dQ needs dS with the queries as rows: each warp writes its dS^T rows as
// bf16 into a shared tile, and after a barrier the block computes dQ_tile =
// dS.K (dS from ldmatrix.trans, K from the shared K tile) and adds it with
// f32 atomics into a [B, N, H, DH] f32 scratch the wrapper zeroes; the
// wrapper scales it and casts. dK is scaled once at the end. Keys past M are
// zero rows whose P is masked to 0 and which are not stored.
//
// flash_bwd_3xtf32_kernel (f32), the same fused FA2 backward on the tf32
// tensor cores at fp32 accuracy (mma.sync m16n8k8, 3xTF32 as in
// flash_attention.cu's f32 forward: each operand split into big = tf32(x)
// and small = tf32(x - big) by flash::split_tf32, each product summed as
// small*big + big*small + big*big). It serves the fp32 model: the CTA's
// train shape (B=2, 5120 queries and keys, 4 heads of 16) and any head dim
// of 16, 32, 64 or 128. A block of 4 warps owns 64 key rows of one (b, h),
// 16 per warp, and streams query tiles (32 rows at DH=16, else 16) of q and
// dout through cp.async, with lse * log2e and delta; each tile is split once,
// block-wide, into big and small parts in shared memory (the 4 warps read
// the same tile), and the next tile's copy runs under this tile's products.
// Per tile each warp computes S^T = K.Q^T and dP^T = V.dO^T (the cross terms
// in accumulators apart from big*big, added once per tile), then P^T =
// ex2(S^T scale log2e - lse log2e) once per logit and dS^T = P^T (dP^T -
// delta), and dV += P^T.dO, dK += dS^T.Q with P and dS split too (never
// rounded to one tf32, which would keep 11 bits of them). The accumulators
// give a thread the queries 2t and 2t + 1 of each 8, which dV and dK take as
// their k slots t and t + 4, reading dO's and q's rows in that order with
// 32-bit shared loads (rows DH + 4 floats apart: the 32 lanes hit 32 banks),
// so P and dS go from the accumulators to the A operands with no shuffle.
// The tensor cores add into their accumulators rounding towards zero, and dK
// and dV sum over all N queries (640 k8 steps for the CTA): each tile's
// products go into accumulators of their own, folded into the running sums
// with round-to-nearest FADDs (the running sums in registers at DH <= 32, in
// thread-private shared memory at 64 and 128, where registers run out). dQ
// needs dS with the queries as rows: each warp writes its dS^T rows' split
// parts to shared memory, and after a barrier the block computes dQ_tile =
// dS.K (3xTF32; the 4 warps split the tile's queries and head dim) and adds
// it, times the scale, with 8-byte float2 atomics into an f32 dq the wrapper
// zeroes (a second pass over the keys per query tile would rebuild S and
// the exponentials, which this design computes once). At DH <= 32 K and V
// fragments stay split in registers and K split in shared memory (one pass
// per block); at 64 and 128 they are read from shared memory per tile
// (ldmatrix) and split there; at 128 the block takes 193 KB of shared
// memory, one block per SM. What
// bounds it on the H100: the five products, 3 x 10 * N * M * DH tf32 flops
// (165 TFLOPS for the products' count), and the split and softmax
// instructions beside the mma; the N * M exponentials on the SFUs take a
// quarter of that time at DH=16.
#include "flash_mma.cuh"

using flash::bf16;

// ------------------------------------------------------------------ bf16 mma

constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int MMA_BKV = 64;       // key rows per block, 16 per warp

template <int DH>
struct BwdTile {
  static constexpr int BQ = DH == 16 ? 64 : 32;  // query rows per tile
  static constexpr int LD = DH + 8;              // padded q/dout/k/v row, elements
  static constexpr int LDS = BQ + 8;             // padded dS^T row, elements
  // dynamic shared memory: K, V, the two-stage q and dout rings and dS^T
  // (bf16), then the two-stage lse and delta rows (f32)
  static constexpr int HALVES = (2 * MMA_BKV + 4 * BQ) * LD + MMA_BKV * LDS;
  static constexpr int SMEM = HALVES * (int)sizeof(bf16) + 4 * BQ * (int)sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int n, int m, int h, float scale, float scale_log2) {
  constexpr int BQ = BwdTile<DH>::BQ, LD = BwdTile<DH>::LD, LDS = BwdTile<DH>::LDS;
  constexpr int KT = DH / 16;  // k16 steps over the head dim
  constexpr int NQ = BQ / 8;   // n-tiles of S^T (queries)
  constexpr int DT = DH / 8;   // n-tiles of dK, dV (head dim)
  // dQ = dS.K: BQ/16 m-tiles of queries, each split over WPM warps by head dim
  constexpr int MQ = BQ / 16, WPM = 4 / MQ, DW = DT / WPM;
  static_assert(MQ * WPM == 4 && DW % 2 == 0, "dQ work split");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* const ks = reinterpret_cast<bf16*>(bwd_smem);  // [MMA_BKV * LD]
  bf16* const vs = ks + MMA_BKV * LD;                   // [MMA_BKV * LD]
  bf16* const qs = vs + MMA_BKV * LD;                   // [2][BQ * LD]
  bf16* const dos = qs + 2 * BQ * LD;                   // [2][BQ * LD]
  bf16* const dss = dos + 2 * BQ * LD;                  // [MMA_BKV * LDS]
  float* const lse_s = reinterpret_cast<float*>(ks + BwdTile<DH>::HALVES);  // [2][BQ]
  float* const delta_s = lse_s + 2 * BQ;                                    // [2][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int k0 = blockIdx.x * MMA_BKV;
  const int64_t rs = (int64_t)h * DH;
  const int64_t qoff = (int64_t)b * n * rs + hh * DH;
  const int64_t koff = (int64_t)b * m * rs + hh * DH;
  const float* lseb = lse + (int64_t)bh * n;
  const float* deltab = delta + (int64_t)bh * n;
  const int tiles = (n + BQ - 1) / BQ;

  auto load_tile = [&](int t, int st) {
    bf16* const qt = qs + st * BQ * LD;
    bf16* const dot = dos + st * BQ * LD;
    flash::load_rows_async<BQ, DH>(qt, LD, q + qoff, rs, t * BQ, n, tid, MMA_THREADS);
    flash::load_rows_async<BQ, DH>(dot, LD, dout + qoff, rs, t * BQ, n, tid, MMA_THREADS);
    for (int i = tid; i < BQ; i += MMA_THREADS) {
      const int row = t * BQ + i;
      lse_s[st * BQ + i] = row < n ? lseb[row] * flash::LOG2E : INFINITY;
      delta_s[st * BQ + i] = row < n ? deltab[row] : 0.f;
    }
  };

  flash::load_rows_async<MMA_BKV, DH>(ks, LD, k + koff, rs, k0, m, tid, MMA_THREADS);
  flash::load_rows_async<MMA_BKV, DH>(vs, LD, v + koff, rs, k0, m, tid, MMA_THREADS);
  load_tile(0, 0);
  flash::cp_async_commit();

  uint32_t kf[KT][4], vf[KT][4];
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const int key0 = k0 + warp * 16 + (lane >> 2);  // this thread's rows key0, key0 + 8
  const bool tail = k0 + MMA_BKV > m;

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < tiles) load_tile(t + 1, st ^ 1);
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        flash::ldmatrix_x4(kf[kt], ks + flash::a_off(lane, warp * 16, kt * 16, LD));
        flash::ldmatrix_x4(vf[kt], vs + flash::a_off(lane, warp * 16, kt * 16, LD));
      }
    }

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NQ / 2; ++j2) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t f[4];
        flash::ldmatrix_x4(f, qs + st * BQ * LD + flash::b_off(lane, j2 * 16, kt * 16, LD));
        flash::mma_bf16(s[2 * j2], kf[kt], f[0], f[1]);
        flash::mma_bf16(s[2 * j2 + 1], kf[kt], f[2], f[3]);
        flash::ldmatrix_x4(f, dos + st * BQ * LD + flash::b_off(lane, j2 * 16, kt * 16, LD));
        flash::mma_bf16(dp[2 * j2], vf[kt], f[0], f[1]);
        flash::mma_bf16(dp[2 * j2 + 1], vf[kt], f[2], f[3]);
      }
    }

    // P^T and dS^T in place of s and dp, packed as the A operands (queries
    // as k) of dV and dK; dS^T also to shared memory for dQ
    uint32_t pa[NQ / 2][4], dsa[NQ / 2][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(&lse_s[st * BQ + c]);
      const float2 dl = *reinterpret_cast<const float2*>(&delta_s[st * BQ + c]);
      float p[4], ds[4];
      p[0] = flash::exp2_approx(fmaf(s[j][0], scale_log2, -l2.x));
      p[1] = flash::exp2_approx(fmaf(s[j][1], scale_log2, -l2.y));
      p[2] = flash::exp2_approx(fmaf(s[j][2], scale_log2, -l2.x));
      p[3] = flash::exp2_approx(fmaf(s[j][3], scale_log2, -l2.y));
      if (tail) {
        if (key0 >= m) p[0] = p[1] = 0.f;
        if (key0 + 8 >= m) p[2] = p[3] = 0.f;
      }
      ds[0] = p[0] * (dp[j][0] - dl.x);
      ds[1] = p[1] * (dp[j][1] - dl.y);
      ds[2] = p[2] * (dp[j][2] - dl.x);
      ds[3] = p[3] * (dp[j][3] - dl.y);
      pa[j / 2][(j & 1) * 2] = flash::pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = flash::pack_bf16(p[2], p[3]);
      const uint32_t d01 = flash::pack_bf16(ds[0], ds[1]), d23 = flash::pack_bf16(ds[2], ds[3]);
      dsa[j / 2][(j & 1) * 2] = d01;
      dsa[j / 2][(j & 1) * 2 + 1] = d23;
      const int r = warp * 16 + (lane >> 2);
      *reinterpret_cast<uint32_t*>(&dss[r * LDS + c]) = d01;
      *reinterpret_cast<uint32_t*>(&dss[(r + 8) * LDS + c]) = d23;
    }
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t f[4];
        flash::ldmatrix_x4_trans(f, dos + st * BQ * LD + flash::bt_off(lane, kk * 16, d2 * 16, LD));
        flash::mma_bf16(dva[2 * d2], pa[kk], f[0], f[1]);
        flash::mma_bf16(dva[2 * d2 + 1], pa[kk], f[2], f[3]);
        flash::ldmatrix_x4_trans(f, qs + st * BQ * LD + flash::bt_off(lane, kk * 16, d2 * 16, LD));
        flash::mma_bf16(dka[2 * d2], dsa[kk], f[0], f[1]);
        flash::mma_bf16(dka[2 * d2 + 1], dsa[kk], f[2], f[3]);
      }
    }
    __syncthreads();  // every warp's dS^T rows are in dss

    {
      const int mq = warp / WPM, dw = (warp % WPM) * DW;
      float acc[DW][4];
#pragma unroll
      for (int d = 0; d < DW; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MMA_BKV / 16; ++kk) {
        uint32_t a[4];
        flash::ldmatrix_x4_trans(a, dss + flash::at_off(lane, mq * 16, kk * 16, LDS));
#pragma unroll
        for (int d2 = 0; d2 < DW / 2; ++d2) {
          uint32_t f[4];
          flash::ldmatrix_x4_trans(f, ks + flash::bt_off(lane, kk * 16, (dw + 2 * d2) * 8, LD));
          flash::mma_bf16(acc[2 * d2], a, f[0], f[1]);
          flash::mma_bf16(acc[2 * d2 + 1], a, f[2], f[3]);
        }
      }
      const int row = t * BQ + mq * 16 + (lane >> 2);
      float* dqb = dq_acc + qoff + (dw * 8 + (lane & 3) * 2);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row + 8 * i >= n) continue;
        float* dst = dqb + (int64_t)(row + 8 * i) * rs;
#pragma unroll
        for (int d = 0; d < DW; ++d) {
          atomicAdd(dst + d * 8, acc[d][2 * i]);
          atomicAdd(dst + d * 8 + 1, acc[d][2 * i + 1]);
        }
      }
    }
    __syncthreads();  // dss and stage st are rewritten by the next iteration
  }

  bf16* dkb = dk + koff + (lane & 3) * 2;
  bf16* dvb = dv + koff + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= m) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(dkb + key * rs + d * 8) =
          flash::pack_bf16(dka[d][2 * i] * scale, dka[d][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key * rs + d * 8) =
          flash::pack_bf16(dva[d][2 * i], dva[d][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ f32 3xTF32

template <int DH>
struct BwdF32 {
  static constexpr int BQ = DH == 16 ? 32 : 16;  // query rows per tile
  static constexpr int LD = DH + 4;              // padded q, dout and v row, floats
  static constexpr int LDK = DH + 8;             // padded k row (dQ's B loads), floats
  static constexpr int LDS = BQ + 8;             // padded dS^T row, floats
  static constexpr bool KV_REGS = DH <= 32;      // K, V fragments kept split in registers
  static constexpr bool KSPLIT = DH <= 32;       // K kept split in shared memory for dQ
  static constexpr bool RUN_SMEM = DH >= 64;     // running dK, dV in shared memory
  // dynamic shared memory (floats): K (and its small parts), V, the raw q
  // and dout stage, their big and small parts, dS^T's big and small parts,
  // the two-stage lse and delta rows, then the running sums
  static constexpr int FLOATS = MMA_BKV * LDK * (KSPLIT ? 2 : 1) + MMA_BKV * LD + 6 * BQ * LD +
                                2 * MMA_BKV * LDS + 4 * BQ + (RUN_SMEM ? MMA_THREADS * DH : 0);
  static constexpr int SMEM = FLOATS * (int)sizeof(float);
};

__device__ __forceinline__ void split4(const uint32_t (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) flash::split_tf32(x[i], big[i], small[i]);
}

__device__ __forceinline__ void split_f(float x, uint32_t& big, uint32_t& small) {
  flash::split_tf32(__float_as_uint(x), big, small);
}

// x in place of its big part, its small part to sm[i]
__device__ __forceinline__ void split_in_place(float* x, float* sm, int i) {
  uint32_t b, s;
  split_f(x[i], b, s);
  x[i] = __uint_as_float(b);
  sm[i] = __uint_as_float(s);
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                        int n, int m, int h, float scale, float scale_log2) {
  using Cfg = BwdF32<DH>;
  constexpr int BQ = Cfg::BQ, LD = Cfg::LD, LDK = Cfg::LDK, LDS = Cfg::LDS;
  constexpr int KT = DH / 8;  // k8 steps over the head dim
  constexpr int NQ = BQ / 8;  // n-tiles of S^T (queries) = k8 steps of dV and dK
  constexpr int DT = DH / 8;  // n-tiles of dK, dV and dQ (head dim)
  // dQ = dS.K: BQ/16 m-tiles of queries, each split over WPM warps by head dim
  constexpr int MQ = BQ / 16, WPM = 4 / MQ, DW = DT / WPM;
  static_assert(MQ * WPM == 4 && DW * WPM == DT && NQ % 2 == 0, "work split");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* const ks = reinterpret_cast<float*>(bwd_smem);     // [MMA_BKV * LDK], KSPLIT: big
  float* const kss = ks + MMA_BKV * LDK;                     // [MMA_BKV * LDK] small (KSPLIT)
  float* const vs = kss + (Cfg::KSPLIT ? MMA_BKV * LDK : 0);  // [MMA_BKV * LD]
  float* const qraw = vs + MMA_BKV * LD;                      // [BQ * LD] cp.async targets
  float* const doraw = qraw + BQ * LD;                        // [BQ * LD]
  float* const qb = doraw + BQ * LD;                          // [BQ * LD] split q, dout
  float* const qsm = qb + BQ * LD;
  float* const dob = qsm + BQ * LD;
  float* const dosm = dob + BQ * LD;
  float* const dsb = dosm + BQ * LD;                          // [MMA_BKV * LDS] split dS^T
  float* const dss = dsb + MMA_BKV * LDS;
  float* const lse_s = dss + MMA_BKV * LDS;                   // [2][BQ]
  float* const delta_s = lse_s + 2 * BQ;                      // [2][BQ]
  float* const run = delta_s + 2 * BQ;  // [DH][MMA_THREADS]: thread tid's sums at i * 128 + tid

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int k0 = blockIdx.x * MMA_BKV;
  const int64_t rs = (int64_t)h * DH;
  const int64_t qoff = (int64_t)b * n * rs + hh * DH;
  const int64_t koff = (int64_t)b * m * rs + hh * DH;
  const float* lseb = lse + (int64_t)bh * n;
  const float* deltab = delta + (int64_t)bh * n;
  const int tiles = (n + BQ - 1) / BQ;

  auto load_tile = [&](int t) {
    flash::load_rows_async<BQ, DH>(qraw, LD, q + qoff, rs, t * BQ, n, tid, MMA_THREADS);
    flash::load_rows_async<BQ, DH>(doraw, LD, dout + qoff, rs, t * BQ, n, tid, MMA_THREADS);
    const int st = t & 1;
    for (int i = tid; i < BQ; i += MMA_THREADS) {
      const int row = t * BQ + i;
      lse_s[st * BQ + i] = row < n ? lseb[row] * flash::LOG2E : INFINITY;
      delta_s[st * BQ + i] = row < n ? deltab[row] : 0.f;
    }
  };

  flash::load_rows_async<MMA_BKV, DH>(ks, LDK, k + koff, rs, k0, m, tid, MMA_THREADS);
  flash::load_rows_async<MMA_BKV, DH>(vs, LD, v + koff, rs, k0, m, tid, MMA_THREADS);
  load_tile(0);
  flash::cp_async_commit();

  // K and V A fragments of this warp's 16 keys, split (KV_REGS)
  constexpr int KR = Cfg::KV_REGS ? KT : 1;
  uint32_t kbg[KR][4], ksm[KR][4], vbg[KR][4], vsm[KR][4];
  // running dK and dV in registers (else in run[])
  constexpr int RR = Cfg::RUN_SMEM ? 1 : DT;
  float dka[RR][4], dva[RR][4];
#pragma unroll
  for (int d = 0; d < RR; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  if constexpr (Cfg::RUN_SMEM) {
#pragma unroll
    for (int i = 0; i < DH; ++i) run[i * MMA_THREADS + tid] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;  // this thread's rows key0, key0 + 8
  const bool tail = k0 + MMA_BKV > m;

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    flash::cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if constexpr (Cfg::KSPLIT) {
      if (t == 0)
        for (int i = tid; i < MMA_BKV * DH; i += MMA_THREADS)
          split_in_place(ks, kss, (i / DH) * LDK + i % DH);
    }
    // q and dout split once for the 4 warps: big and small parts
    for (int i = tid; i < BQ * DH; i += MMA_THREADS) {
      const int j = (i / DH) * LD + i % DH;
      uint32_t b0, s0;
      split_f(qraw[j], b0, s0);
      qb[j] = __uint_as_float(b0);
      qsm[j] = __uint_as_float(s0);
      split_f(doraw[j], b0, s0);
      dob[j] = __uint_as_float(b0);
      dosm[j] = __uint_as_float(s0);
    }
    __syncthreads();  // the split tile (and K) ready; the raw stage is free
    if (t + 1 < tiles) load_tile(t + 1);
    flash::cp_async_commit();
    if constexpr (Cfg::KV_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          const int off = flash::a_off_f32(lane, warp * 16, kt * 8, LDK);
          flash::ldmatrix_x4(kbg[kt], ks + off);
          flash::ldmatrix_x4(ksm[kt], kss + off);
          uint32_t f[4];
          flash::ldmatrix_x4(f, vs + flash::a_off_f32(lane, warp * 16, kt * 8, LD));
          split4(f, vbg[kt], vsm[kt]);
        }
      }
    }

    // S^T = K.Q^T and dP^T = V.dO^T: big*big in s and dp, the cross terms in
    // sx and dpx, added once the tile's products are done
    float s[NQ][4], sx[NQ][4], dp[NQ][4], dpx[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sx[j][e] = dp[j][e] = dpx[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t ab[4], as[4], vb[4], vl[4];
      if constexpr (Cfg::KV_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[i] = kbg[kt][i];
          as[i] = ksm[kt][i];
          vb[i] = vbg[kt][i];
          vl[i] = vsm[kt][i];
        }
      } else {
        uint32_t f[4];
        flash::ldmatrix_x4(f, ks + flash::a_off_f32(lane, warp * 16, kt * 8, LDK));
        split4(f, ab, as);
        flash::ldmatrix_x4(f, vs + flash::a_off_f32(lane, warp * 16, kt * 8, LD));
        split4(f, vb, vl);
      }
#pragma unroll
      for (int j2 = 0; j2 < NQ / 2; ++j2) {
        // Q[n0 + g][k0 + t], Q[n0 + g][k0 + t + 4], the same at n0 + 8 + g
        const int off = flash::b_off_f32(lane, j2 * 16, kt * 8, LD);
        uint32_t fb[4], fs[4];
        flash::ldmatrix_x4(fb, qb + off);
        flash::ldmatrix_x4(fs, qsm + off);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          flash::mma_tf32(sx[2 * j2 + e], as, fb[2 * e], fb[2 * e + 1]);
          flash::mma_tf32(sx[2 * j2 + e], ab, fs[2 * e], fs[2 * e + 1]);
          flash::mma_tf32(s[2 * j2 + e], ab, fb[2 * e], fb[2 * e + 1]);
        }
        flash::ldmatrix_x4(fb, dob + off);
        flash::ldmatrix_x4(fs, dosm + off);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          flash::mma_tf32(dpx[2 * j2 + e], vl, fb[2 * e], fb[2 * e + 1]);
          flash::mma_tf32(dpx[2 * j2 + e], vb, fs[2 * e], fs[2 * e + 1]);
          flash::mma_tf32(dp[2 * j2 + e], vb, fb[2 * e], fb[2 * e + 1]);
        }
      }
    }

    // P^T in place of s, dS^T in place of dp: this thread's keys g, g + 8 and
    // queries j * 8 + 2t, + 1
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c = j * 8 + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(&lse_s[st * BQ + c]);
      const float2 dl = *reinterpret_cast<const float2*>(&delta_s[st * BQ + c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += sx[j][e];
        dp[j][e] += dpx[j][e];
      }
      s[j][0] = flash::exp2_approx(fmaf(s[j][0], scale_log2, -l2.x));
      s[j][1] = flash::exp2_approx(fmaf(s[j][1], scale_log2, -l2.y));
      s[j][2] = flash::exp2_approx(fmaf(s[j][2], scale_log2, -l2.x));
      s[j][3] = flash::exp2_approx(fmaf(s[j][3], scale_log2, -l2.y));
      if (tail) {
        if (key0 >= m) s[j][0] = s[j][1] = 0.f;
        if (key0 + 8 >= m) s[j][2] = s[j][3] = 0.f;
      }
      dp[j][0] = s[j][0] * (dp[j][0] - dl.x);
      dp[j][1] = s[j][1] * (dp[j][1] - dl.y);
      dp[j][2] = s[j][2] * (dp[j][2] - dl.x);
      dp[j][3] = s[j][3] * (dp[j][3] - dl.y);
    }

    // this tile's dV = P^T.dO and dK = dS^T.Q in accumulators of their own:
    // k8 step j takes the queries j * 8 + 2t (slot t) and + 1 (slot t + 4);
    // dS^T's split parts also go to shared memory for dQ
    float tdv[DT][4], tdk[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) tdv[d][e] = tdk[d][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      // a0 = X[g][2t], a1 = X[g+8][2t], a2 = X[g][2t+1], a3 = X[g+8][2t+1]
      uint32_t pb[4], ps[4], db[4], dsm[4];
      split_f(s[j][0], pb[0], ps[0]);
      split_f(s[j][2], pb[1], ps[1]);
      split_f(s[j][1], pb[2], ps[2]);
      split_f(s[j][3], pb[3], ps[3]);
      split_f(dp[j][0], db[0], dsm[0]);
      split_f(dp[j][2], db[1], dsm[1]);
      split_f(dp[j][1], db[2], dsm[2]);
      split_f(dp[j][3], db[3], dsm[3]);
      const int r = (warp * 16 + g) * LDS + j * 8 + 2 * tq;  // dS^T[key g][query 2t]
      *reinterpret_cast<uint2*>(&dsb[r]) = make_uint2(db[0], db[2]);
      *reinterpret_cast<uint2*>(&dsb[r + 8 * LDS]) = make_uint2(db[1], db[3]);
      *reinterpret_cast<uint2*>(&dss[r]) = make_uint2(dsm[0], dsm[2]);
      *reinterpret_cast<uint2*>(&dss[r + 8 * LDS]) = make_uint2(dsm[1], dsm[3]);
      const int rq = (j * 8 + 2 * tq) * LD + g;  // dO[query 2t][g], q's alike
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int i0 = rq + d * 8, i1 = i0 + LD;
        flash::mma_3xtf32(tdv[d], pb, ps, bits(dob[i0]), bits(dob[i1]), bits(dosm[i0]),
                          bits(dosm[i1]));
        flash::mma_3xtf32(tdk[d], db, dsm, bits(qb[i0]), bits(qb[i1]), bits(qsm[i0]),
                          bits(qsm[i1]));
      }
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (Cfg::RUN_SMEM) {
          run[(d * 4 + e) * MMA_THREADS + tid] += tdk[d][e];
          run[(DH / 2 + d * 4 + e) * MMA_THREADS + tid] += tdv[d][e];
        } else {
          dka[d][e] += tdk[d][e];
          dva[d][e] += tdv[d][e];
        }
      }
    __syncthreads();  // every warp's dS^T rows are in dsb and dss

    // dQ_tile = dS.K: A = dS (queries as rows) read from dS^T, B = K rows
    {
      const int mq = warp / WPM, dw = (warp % WPM) * DW;
      float acc[DW][4];
#pragma unroll
      for (int d = 0; d < DW; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MMA_BKV / 8; ++kk) {
        const int ia = (kk * 8 + tq) * LDS + mq * 16 + g;
        const uint32_t ab[4] = {bits(dsb[ia]), bits(dsb[ia + 8]), bits(dsb[ia + 4 * LDS]),
                                bits(dsb[ia + 4 * LDS + 8])};
        const uint32_t as[4] = {bits(dss[ia]), bits(dss[ia + 8]), bits(dss[ia + 4 * LDS]),
                                bits(dss[ia + 4 * LDS + 8])};
        const int ik = (kk * 8 + tq) * LDK + dw * 8 + g;
#pragma unroll
        for (int d = 0; d < DW; ++d) {
          const int i0 = ik + d * 8, i1 = i0 + 4 * LDK;
          uint32_t b0, s0, b1, s1;
          if constexpr (Cfg::KSPLIT) {
            b0 = bits(ks[i0]);
            s0 = bits(kss[i0]);
            b1 = bits(ks[i1]);
            s1 = bits(kss[i1]);
          } else {
            split_f(ks[i0], b0, s0);
            split_f(ks[i1], b1, s1);
          }
          flash::mma_3xtf32(acc[d], ab, as, b0, b1, s0, s1);
        }
      }
      const int row = t * BQ + mq * 16 + g;
      float* const dqb = dq + qoff + dw * 8 + 2 * tq;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row + 8 * i >= n) continue;
        float* const dst = dqb + (int64_t)(row + 8 * i) * rs;
#pragma unroll
        for (int d = 0; d < DW; ++d)
          atomicAdd(reinterpret_cast<float2*>(dst + d * 8),
                    make_float2(acc[d][2 * i] * scale, acc[d][2 * i + 1] * scale));
      }
    }
  }

  float* const dkb = dk + koff + 2 * tq;
  float* const dvb = dv + koff + 2 * tq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= m) continue;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      float k0v, k1v, v0v, v1v;
      if constexpr (Cfg::RUN_SMEM) {
        k0v = run[(d * 4 + 2 * i) * MMA_THREADS + tid];
        k1v = run[(d * 4 + 2 * i + 1) * MMA_THREADS + tid];
        v0v = run[(DH / 2 + d * 4 + 2 * i) * MMA_THREADS + tid];
        v1v = run[(DH / 2 + d * 4 + 2 * i + 1) * MMA_THREADS + tid];
      } else {
        k0v = dka[d][2 * i];
        k1v = dka[d][2 * i + 1];
        v0v = dva[d][2 * i];
        v1v = dva[d][2 * i + 1];
      }
      *reinterpret_cast<float2*>(dkb + key * rs + d * 8) = make_float2(k0v * scale, k1v * scale);
      *reinterpret_cast<float2*>(dvb + key * rs + d * 8) = make_float2(v0v, v1v);
    }
  }
}

static bool head_dim_ok(int dh) { return dh == 16 || dh == 32 || dh == 64 || dh == 128; }

template <int DH>
static int launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
                          int b, int n, int m, int h, float scale, cudaStream_t st) {
  constexpr int bytes = BwdTile<DH>::SMEM;
  if (bytes > 48 * 1024) {
    static const cudaError_t once = cudaFuncSetAttribute(
        flash_bwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (once != cudaSuccess) return (int)once;
  }
  const dim3 grid((m + MMA_BKV - 1) / MMA_BKV, b * h);
  flash_bwd_mma_kernel<DH><<<grid, MMA_THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (float*)dq_acc, (bf16*)dk, (bf16*)dv, n, m, h, scale,
      scale * flash::LOG2E);
  return (int)cudaGetLastError();
}

template <int DH>
static int launch_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, void* dk, void* dv,
                          int b, int n, int m, int h, float scale, cudaStream_t st) {
  constexpr int bytes = BwdF32<DH>::SMEM;
  if (bytes > 48 * 1024) {
    static const cudaError_t once = cudaFuncSetAttribute(
        flash_bwd_3xtf32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (once != cudaSuccess) return (int)once;
  }
  const dim3 grid((m + MMA_BKV - 1) / MMA_BKV, b * h);
  flash_bwd_3xtf32_kernel<DH><<<grid, MMA_THREADS, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dq, (float*)dk, (float*)dv, n, m, h, scale,
      scale * flash::LOG2E);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_mma(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq_acc, void* dk, void* dv, int b, int n, int m,
                                       int h, int dh, float scale, void* stream) {
  if (!head_dim_ok(dh) || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  if (b * m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define BWD_MMA(D) \
  launch_bwd_mma<D>(q, k, v, dout, lse, delta, dq_acc, dk, dv, b, n, m, h, scale, st)
  switch (dh) {
    case 16: return BWD_MMA(16);
    case 32: return BWD_MMA(32);
    case 64: return BWD_MMA(64);
    case 128: return BWD_MMA(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_MMA
}

// f32: dq is added into (the caller zeroes it) and comes out scaled, with
// respect to the unscaled q; dk and dv are written. Any scale.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv, int b, int n, int m, int h,
                                       int dh, float scale, void* stream) {
  if (!head_dim_ok(dh)) return (int)cudaErrorInvalidValue;
  if (b * m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define BWD_F32(D) launch_bwd_f32<D>(q, k, v, dout, lse, delta, dq, dk, dv, b, n, m, h, scale, st)
  switch (dh) {
    case 16: return BWD_F32(16);
    case 32: return BWD_F32(32);
    case 64: return BWD_F32(64);
    case 128: return BWD_F32(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_F32
}
