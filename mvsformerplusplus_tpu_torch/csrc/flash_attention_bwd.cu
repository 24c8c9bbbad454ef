// Non-causal flash attention backward (FA2 from the saved logsumexp):
// q [B, N, H, DH], k/v [B, M, H, DH], dout [B, N, H, DH], lse and
// delta = rowsum(dout * out) [B, H, N] f32. Probabilities are rebuilt as
// p = exp(scale q.k - lse); ds = p (dout.v - delta); dv = sum_i p dout_i,
// dk = scale sum_i ds q_i, dq = scale sum_j ds k_j (with respect to the
// unscaled q). Nothing [N, M]-shaped touches device memory.
//
// Replaces mvsformerplusplus_tpu/ops/pallas/flash_attention.py _flash_bwd
// (_bwd_dkv_kernel, _bwd_dq_kernel). Two routes, chosen by type:
//
// flash_bwd_mma_kernel (bf16), FA2's fused backward on mma.sync: the N*M
// exponentials, which bound the CTA backward (DH=16) on the H100's SFUs,
// are computed once instead of once per kernel of a split. A block of 4
// warps owns 64 key rows of one (b, h), 16 per warp, with K and V fragments
// in registers (ldmatrix once), and streams query tiles (64 rows at DH=16,
// 32 at DH=64) of q and dout (two-stage cp.async ring, zero-filled past N)
// with lse * log2e and delta. Per tile each warp computes, in the
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
// flash_bwd_dkv_f32_kernel / flash_bwd_dq_f32_kernel (f32): fp32 FMAs, the
// split of the TPU kernels. The dK/dV kernel gives each thread one key row (k,
// v and the dk/dv accumulators in registers) and streams 32-query tiles of
// scaled q, dout, lse and delta through shared memory (read as broadcasts);
// the dQ kernel gives each thread one query row and streams 64-key K/V
// tiles. They serve the fp32 model (tests, the card-vs-CPU reference), where
// tensor cores would mean TF32.
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
  __shared__ __align__(16) bf16 ks[MMA_BKV * LD];
  __shared__ __align__(16) bf16 vs[MMA_BKV * LD];
  __shared__ __align__(16) bf16 qs[2][BQ * LD];
  __shared__ __align__(16) bf16 dos[2][BQ * LD];
  __shared__ __align__(16) bf16 dss[MMA_BKV * LDS];
  __shared__ __align__(16) float lse_s[2][BQ];
  __shared__ __align__(16) float delta_s[2][BQ];

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
    flash::load_rows_async<BQ, DH>(qs[st], LD, q + qoff, rs, t * BQ, n, tid, MMA_THREADS);
    flash::load_rows_async<BQ, DH>(dos[st], LD, dout + qoff, rs, t * BQ, n, tid, MMA_THREADS);
    for (int i = tid; i < BQ; i += MMA_THREADS) {
      const int row = t * BQ + i;
      lse_s[st][i] = row < n ? lseb[row] * flash::LOG2E : INFINITY;
      delta_s[st][i] = row < n ? deltab[row] : 0.f;
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
        flash::ldmatrix_x4(f, qs[st] + flash::b_off(lane, j2 * 16, kt * 16, LD));
        flash::mma_bf16(s[2 * j2], kf[kt], f[0], f[1]);
        flash::mma_bf16(s[2 * j2 + 1], kf[kt], f[2], f[3]);
        flash::ldmatrix_x4(f, dos[st] + flash::b_off(lane, j2 * 16, kt * 16, LD));
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
      const float2 l2 = *reinterpret_cast<const float2*>(&lse_s[st][c]);
      const float2 dl = *reinterpret_cast<const float2*>(&delta_s[st][c]);
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
        flash::ldmatrix_x4_trans(f, dos[st] + flash::bt_off(lane, kk * 16, d2 * 16, LD));
        flash::mma_bf16(dva[2 * d2], pa[kk], f[0], f[1]);
        flash::mma_bf16(dva[2 * d2 + 1], pa[kk], f[2], f[3]);
        flash::ldmatrix_x4_trans(f, qs[st] + flash::bt_off(lane, kk * 16, d2 * 16, LD));
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

// ------------------------------------------------------------------ f32 SIMT

constexpr int F32_BK = 128;  // dK/dV: key rows per block, one per thread
constexpr int F32_BQ = 32;   // dK/dV: query rows per shared-memory tile
constexpr int F32_BN = 128;  // dQ: query rows per block, one per thread
constexpr int F32_BM = 64;   // dQ: key rows per shared-memory tile

template <int DH>
__global__ void __launch_bounds__(F32_BK)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int n, int m, int h,
                         float scale) {
  __shared__ __align__(16) float qs[F32_BQ][DH];
  __shared__ __align__(16) float dos[F32_BQ][DH];
  __shared__ float lse_s[F32_BQ], delta_s[F32_BQ];
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int key = blockIdx.x * F32_BK + threadIdx.x;
  const bool active = key < m;
  const int64_t rs = (int64_t)h * DH;
  const float* qb = q + (int64_t)b * n * rs + hh * DH;
  const float* dob = dout + (int64_t)b * n * rs + hh * DH;
  const int64_t koff = (int64_t)b * m * rs + hh * DH + key * rs;
  const float* lseb = lse + (int64_t)bh * n;
  const float* deltab = delta + (int64_t)bh * n;

  float kr[DH], vr[DH], dkr[DH], dvr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    kr[d] = active ? k[koff + d] : 0.f;
    vr[d] = active ? v[koff + d] : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }

  for (int t0 = 0; t0 < n; t0 += F32_BQ) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < F32_BQ * DH; idx += F32_BK) {
      const int i = idx / DH, d = idx % DH;
      const int row = t0 + i;
      const bool in = row < n;
      qs[i][d] = in ? qb[row * rs + d] * scale : 0.f;
      dos[i][d] = in ? dob[row * rs + d] : 0.f;
    }
    for (int i = threadIdx.x; i < F32_BQ; i += F32_BK) {
      const int row = t0 + i;
      lse_s[i] = row < n ? lseb[row] : 0.f;
      delta_s[i] = row < n ? deltab[row] : 0.f;
    }
    __syncthreads();
    const int tq = min(F32_BQ, n - t0);
    for (int i = 0; i < tq; ++i) {
      const float4* qr4 = reinterpret_cast<const float4*>(qs[i]);
      const float4* do4 = reinterpret_cast<const float4*>(dos[i]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 qq = qr4[d4], oo = do4[d4];
        s += qq.x * kr[4 * d4] + qq.y * kr[4 * d4 + 1] + qq.z * kr[4 * d4 + 2] +
             qq.w * kr[4 * d4 + 3];
        dp += oo.x * vr[4 * d4] + oo.y * vr[4 * d4 + 1] + oo.z * vr[4 * d4 + 2] +
              oo.w * vr[4 * d4 + 3];
      }
      const float p = __expf(s - lse_s[i]);
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 qq = qr4[d4], oo = do4[d4];
        dvr[4 * d4] += p * oo.x;
        dvr[4 * d4 + 1] += p * oo.y;
        dvr[4 * d4 + 2] += p * oo.z;
        dvr[4 * d4 + 3] += p * oo.w;
        dkr[4 * d4] += ds * qq.x;
        dkr[4 * d4 + 1] += ds * qq.y;
        dkr[4 * d4 + 2] += ds * qq.z;
        dkr[4 * d4 + 3] += ds * qq.w;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk[koff + d] = dkr[d];
    dv[koff + d] = dvr[d];
  }
}

template <int DH>
__global__ void __launch_bounds__(F32_BN)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int n, int m, int h, float scale) {
  __shared__ __align__(16) float ks[F32_BM][DH];
  __shared__ __align__(16) float vs[F32_BM][DH];
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int row = blockIdx.x * F32_BN + threadIdx.x;
  const bool active = row < n;
  const int64_t rs = (int64_t)h * DH;
  const int64_t qoff = (int64_t)b * n * rs + hh * DH + row * rs;
  const float* kb = k + (int64_t)b * m * rs + hh * DH;
  const float* vb = v + (int64_t)b * m * rs + hh * DH;

  float qr[DH], dor[DH], dqr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? q[qoff + d] * scale : 0.f;
    dor[d] = active ? dout[qoff + d] : 0.f;
    dqr[d] = 0.f;
  }
  const float l = active ? lse[(int64_t)bh * n + row] : 0.f;
  const float dl = active ? delta[(int64_t)bh * n + row] : 0.f;

  for (int t0 = 0; t0 < m; t0 += F32_BM) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < F32_BM * DH; idx += F32_BN) {
      const int j = idx / DH, d = idx % DH;
      const int key = t0 + j;
      ks[j][d] = key < m ? kb[key * rs + d] : 0.f;
      vs[j][d] = key < m ? vb[key * rs + d] : 0.f;
    }
    __syncthreads();
    const int tn = min(F32_BM, m - t0);
    for (int j = 0; j < tn; ++j) {
      const float4* kr4 = reinterpret_cast<const float4*>(ks[j]);
      const float4* vr4 = reinterpret_cast<const float4*>(vs[j]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kk = kr4[d4], vv = vr4[d4];
        s += qr[4 * d4] * kk.x + qr[4 * d4 + 1] * kk.y + qr[4 * d4 + 2] * kk.z +
             qr[4 * d4 + 3] * kk.w;
        dp += dor[4 * d4] * vv.x + dor[4 * d4 + 1] * vv.y + dor[4 * d4 + 2] * vv.z +
              dor[4 * d4 + 3] * vv.w;
      }
      const float ds = __expf(s - l) * (dp - dl);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kk = kr4[d4];
        dqr[4 * d4] += ds * kk.x;
        dqr[4 * d4 + 1] += ds * kk.y;
        dqr[4 * d4 + 2] += ds * kk.z;
        dqr[4 * d4 + 3] += ds * kk.w;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int d = 0; d < DH; ++d) dq[qoff + d] = dqr[d] * scale;
}

extern "C" int flash_attention_bwd_mma(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq_acc, void* dk, void* dv, int b, int n, int m,
                                       int h, int dh, float scale, void* stream) {
  if ((dh != 16 && dh != 64) || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  if (b * m == 0) return 0;
  const dim3 grid((m + MMA_BKV - 1) / MMA_BKV, b * h);
  const float scale_log2 = scale * flash::LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 16) {
    flash_bwd_mma_kernel<16><<<grid, MMA_THREADS, 0, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
        (const float*)delta, (float*)dq_acc, (bf16*)dk, (bf16*)dv, n, m, h, scale, scale_log2);
  } else {
    flash_bwd_mma_kernel<64><<<grid, MMA_THREADS, 0, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
        (const float*)delta, (float*)dq_acc, (bf16*)dk, (bf16*)dv, n, m, h, scale, scale_log2);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int b, int n, int m, int h, int dh,
                                           float scale, void* stream) {
  if (dh != 16 && dh != 64) return (int)cudaErrorInvalidValue;
  if (b * m == 0) return 0;
  const dim3 grid((m + F32_BK - 1) / F32_BK, b * h);
  cudaStream_t st = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v,
              *df = (const float*)dout, *lf = (const float*)lse, *dlf = (const float*)delta;
  if (dh == 16) {
    flash_bwd_dkv_f32_kernel<16><<<grid, F32_BK, 0, st>>>(qf, kf, vf, df, lf, dlf, (float*)dk,
                                                          (float*)dv, n, m, h, scale);
  } else {
    flash_bwd_dkv_f32_kernel<64><<<grid, F32_BK, 0, st>>>(qf, kf, vf, df, lf, dlf, (float*)dk,
                                                          (float*)dv, n, m, h, scale);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int b, int n, int m, int h, int dh,
                                          float scale, void* stream) {
  if (dh != 16 && dh != 64) return (int)cudaErrorInvalidValue;
  if (b * n == 0) return 0;
  const dim3 grid((n + F32_BN - 1) / F32_BN, b * h);
  cudaStream_t st = (cudaStream_t)stream;
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v,
              *df = (const float*)dout, *lf = (const float*)lse, *dlf = (const float*)delta;
  if (dh == 16) {
    flash_bwd_dq_f32_kernel<16><<<grid, F32_BN, 0, st>>>(qf, kf, vf, df, lf, dlf, (float*)dq, n,
                                                         m, h, scale);
  } else {
    flash_bwd_dq_f32_kernel<64><<<grid, F32_BN, 0, st>>>(qf, kf, vf, df, lf, dlf, (float*)dq, n,
                                                         m, h, scale);
  }
  return (int)cudaGetLastError();
}
