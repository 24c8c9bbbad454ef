// Non-causal flash attention forward with fp32 logits and online softmax.
// q [B, N, H, DH], k/v [B, M, H, DH] -> out [B, N, H, DH] in the input type,
// and optionally lse [B, H, N] f32 (natural log). DH is 16, 32, 64 or 128:
// the wrapper zero-pads any other head dim up to the next of these (zero
// channels leave q.k unchanged and give zero output columns, which it slices
// off), as the TPU kernel pads the head dim to its 128 lanes.
//
// Replaces mvsformerplusplus_tpu/ops/pallas/flash_attention.py _flash_fwd
// (_fwd_kernel / _fwd_kernel_nolse). Two kernels, chosen by type:
//
// flash_fwd_mma_kernel (bf16), FA2 on mma.sync. A block of 4 warps owns 64
// query rows of one (b, h), 16 per warp; the warp keeps its Q fragments in
// registers (ldmatrix once) and streams K/V tiles (128 keys at DH=16, 64 at
// DH=32, 64 and 128) through a two-stage cp.async ring in dynamic shared
// memory (87 KB at DH=128, so 2 blocks per SM there) whose rows are padded
// by 16 bytes so that ldmatrix's eight row addresses fall in eight different
// bank groups. S = Q.K^T on the tensor cores (m16n8k16, f32 accumulate); the
// online softmax runs on the accumulators in registers (row max and, at the
// end, row sum across each quad with shuffles) in base 2, with scale * log2e
// folded into the one FFMA per logit that feeds ex2.approx; P is packed to
// bf16x2 and used directly as the A operand of P.V (V from ldmatrix.trans),
// as the TPU kernel rounds p to v's type before its second product. The
// scale multiplies the fp32 logits, not q, so q reaches the tensor cores as
// given. Out is acc / l in f32, rounded once to bf16; lse = (m + log2 l) ln 2.
// Ragged tails: K/V rows >= M and Q rows >= N are zero-filled by cp.async's
// source size (stale shared memory may hold NaN bit patterns, and 0 * NaN is
// NaN); keys >= M get s = -inf on the last tile only; rows >= N are not
// stored.
//
// Where the time goes on the H100: at DH=16 (the CTA, ~5-28k tokens) the N*M
// exponentials on the SFUs, 16 ex2 per clock per SM against 128 FP32 lanes;
// per logit the kernel adds one FMNMX, one FFMA, one FADD and half an F2FP
// pack, so the FP32 pipe stays under the SFU's time (cuobjdump -sass shows
// one MUFU.EX2 per logit and one F2FP per two; which pipe F2FP issues on is
// not measured, ncu does not run on the card's machine). At DH=64 (the ViT)
// the two products; mma.sync, not wgmma, reaches a fraction of the tensor
// cores' peak there, with one ldmatrix per two mma and 3 blocks per SM at
// ~130 registers (a later redesign's work).
//
// flash_fwd_f32_kernel (f32): fp32 FMAs, one thread per query row (q and the
// accumulator in registers); a block of 128 rows stages 64-key K/V tiles in
// shared memory (read as broadcasts; 32-key tiles at DH=128, to stay in the
// 48 KB of static shared memory); keys are folded into the running
// max/normalizer 16 at a time. Its per-thread q and accumulator rows are DH
// registers each, so at DH=128 they spill to local memory (ptxas's spill
// line in chip_smoke.py's build phase). It serves the fp32 model (tests,
// the card-vs-CPU reference, the DINOv2 matcher), where tensor cores would
// mean TF32.
#include "flash_mma.cuh"

using flash::bf16;

// ------------------------------------------------------------------ bf16 mma

constexpr int MMA_THREADS = 128;  // 4 warps
constexpr int MMA_BN = 64;        // query rows per block, 16 per warp

template <int DH>
struct FwdTile {
  static constexpr int BM = DH == 16 ? 128 : 64;  // keys per K/V tile
  static constexpr int LD = DH + 8;               // padded shared row, elements
  // dynamic shared memory: the Q tile, then the two-stage K and V rings
  static constexpr int SMEM = (MMA_BN + 4 * BM) * LD * (int)sizeof(bf16);
};

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                     int n, int m, int h, float scale_log2) {
  constexpr int BM = FwdTile<DH>::BM, LD = FwdTile<DH>::LD;
  constexpr int KT = DH / 16;  // k16 steps of Q.K^T
  constexpr int NT = BM / 8;   // n-tiles of S
  constexpr int DT = DH / 8;   // n-tiles of O
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fwd_smem);  // [MMA_BN * LD]
  bf16* const ks = qs + MMA_BN * LD;  // [2][BM * LD], stage st at ks + st * BM * LD
  bf16* const vs = ks + 2 * BM * LD;   // [2][BM * LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * MMA_BN;
  const int64_t rs = (int64_t)h * DH;  // elements between tokens
  const bf16* qb = q + (int64_t)b * n * rs + hh * DH;
  const bf16* kb = k + (int64_t)b * m * rs + hh * DH;
  const bf16* vb = v + (int64_t)b * m * rs + hh * DH;
  const int tiles = (m + BM - 1) / BM;

  flash::load_rows_async<MMA_BN, DH>(qs, LD, qb, rs, q0, n, tid, MMA_THREADS);
  flash::load_rows_async<BM, DH>(ks, LD, kb, rs, 0, m, tid, MMA_THREADS);
  flash::load_rows_async<BM, DH>(vs, LD, vb, rs, 0, m, tid, MMA_THREADS);
  flash::cp_async_commit();

  uint32_t qf[KT][4];
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // running max (in units of scale_log2 * logit) and this thread's partial
  // row sums of rows lane/4 and lane/4 + 8
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < tiles) {
      bf16* const kn = ks + (st ^ 1) * BM * LD;
      bf16* const vn = vs + (st ^ 1) * BM * LD;
      flash::load_rows_async<BM, DH>(kn, LD, kb, rs, (t + 1) * BM, m, tid, MMA_THREADS);
      flash::load_rows_async<BM, DH>(vn, LD, vb, rs, (t + 1) * BM, m, tid, MMA_THREADS);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        flash::ldmatrix_x4(qf[kt], qs + flash::a_off(lane, warp * 16, kt * 16, LD));
    }

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t kf[4];
        flash::ldmatrix_x4(kf, ks + st * BM * LD + flash::b_off(lane, j2 * 16, kt * 16, LD));
        flash::mma_bf16(s[2 * j2], qf[kt], kf[0], kf[1]);
        flash::mma_bf16(s[2 * j2 + 1], qf[kt], kf[2], kf[3]);
      }
    }
    const int k0 = t * BM;
    if (k0 + BM > m) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = k0 + j * 8 + (lane & 3) * 2;
        if (key >= m) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= m) s[j][1] = s[j][3] = -INFINITY;
      }
    }

    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tm[0] = fmaxf(tm[0], fmaxf(s[j][0], s[j][1]));
      tm[1] = fmaxf(tm[1], fmaxf(s[j][2], s[j][3]));
    }
    float mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 1));
      tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 2));
      const float mnew = fmaxf(mx[i], tm[i] * scale_log2);  // scale_log2 > 0
      const float alpha = flash::exp2_approx(mx[i] - mnew);
      mx[i] = mnew;
      mb[i] = -mnew;
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }

    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = flash::exp2_approx(fmaf(s[j][0], scale_log2, mb[0]));
      const float p1 = flash::exp2_approx(fmaf(s[j][1], scale_log2, mb[0]));
      const float p2 = flash::exp2_approx(fmaf(s[j][2], scale_log2, mb[1]));
      const float p3 = flash::exp2_approx(fmaf(s[j][3], scale_log2, mb[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j & 1) * 2] = flash::pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = flash::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        flash::ldmatrix_x4_trans(vf, vs + st * BM * LD + flash::bt_off(lane, kk * 16, dp * 16, LD));
        flash::mma_bf16(o[2 * dp], pa[kk], vf[0], vf[1]);
        flash::mma_bf16(o[2 * dp + 1], pa[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int r0 = q0 + warp * 16 + (lane >> 2);
  bf16* ob = out + (int64_t)b * n * rs + hh * DH + (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(ob + row * rs + d * 8) =
          flash::pack_bf16(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(int64_t)bh * n + row] = (mx[i] + log2f(l[i])) * flash::LN2;
  }
}

// ------------------------------------------------------------------ f32 SIMT

constexpr int F32_BN = 128;  // query rows per block, one per thread
constexpr int F32_CH = 16;   // keys per online-softmax update
constexpr float NEG = -1e30f;

template <int DH>
__global__ void __launch_bounds__(F32_BN)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int n, int m, int h, float scale) {
  constexpr int F32_BM = DH >= 128 ? 32 : 64;  // keys per shared-memory tile
  __shared__ __align__(16) float ks[F32_BM][DH];
  __shared__ __align__(16) float vs[F32_BM][DH];
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int row = blockIdx.x * F32_BN + threadIdx.x;
  const bool active = row < n;
  const int64_t rs = (int64_t)h * DH;
  const float* qb = q + (int64_t)b * n * rs + hh * DH;
  const float* kb = k + (int64_t)b * m * rs + hh * DH;
  const float* vb = v + (int64_t)b * m * rs + hh * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? qb[row * rs + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float mx = NEG, l = 0.f;

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
    for (int c0 = 0; c0 < tn; c0 += F32_CH) {
      float s[F32_CH];
      float cmax = NEG;
#pragma unroll
      for (int j = 0; j < F32_CH; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks[c0 + j]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 kk = kr[d4];
          dot += qr[4 * d4] * kk.x + qr[4 * d4 + 1] * kk.y + qr[4 * d4 + 2] * kk.z +
                 qr[4 * d4 + 3] * kk.w;
        }
        s[j] = (c0 + j < tn) ? dot : NEG;
        cmax = fmaxf(cmax, s[j]);
      }
      const float mnew = fmaxf(mx, cmax);
      const float alpha = __expf(mx - mnew);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < F32_CH; ++j) {
        const float p = __expf(s[j] - mnew);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[c0 + j]);
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] += p * vv.x;
          acc[4 * d4 + 1] += p * vv.y;
          acc[4 * d4 + 2] += p * vv.z;
          acc[4 * d4 + 3] += p * vv.w;
        }
      }
      mx = mnew;
    }
  }
  if (!active) return;
  const float inv = 1.f / l;
  float* ob = out + (int64_t)b * n * rs + hh * DH + row * rs;
#pragma unroll
  for (int d = 0; d < DH; ++d) ob[d] = acc[d] * inv;
  if (lse != nullptr) lse[(int64_t)bh * n + row] = mx + logf(l);
}

template <int DH>
static int launch_fwd_mma(const void* q, const void* k, const void* v, void* out, void* lse,
                          int b, int n, int m, int h, float scale, cudaStream_t st) {
  constexpr int bytes = FwdTile<DH>::SMEM;
  if (bytes > 48 * 1024) {
    static const cudaError_t once = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (once != cudaSuccess) return (int)once;
  }
  const dim3 grid((n + MMA_BN - 1) / MMA_BN, b * h);
  flash_fwd_mma_kernel<DH><<<grid, MMA_THREADS, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse, n, m, h,
      scale * flash::LOG2E);
  return (int)cudaGetLastError();
}

template <int DH>
static int launch_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                          int b, int n, int m, int h, float scale, cudaStream_t st) {
  const dim3 grid((n + F32_BN - 1) / F32_BN, b * h);
  flash_fwd_f32_kernel<DH><<<grid, F32_BN, 0, st>>>((const float*)q, (const float*)k,
                                                    (const float*)v, (float*)out, (float*)lse,
                                                    n, m, h, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_fwd_mma(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int b, int n, int m, int h, int dh, float scale,
                                       void* stream) {
  if (m < 1 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  if (b * n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return launch_fwd_mma<16>(q, k, v, out, lse, b, n, m, h, scale, st);
    case 32: return launch_fwd_mma<32>(q, k, v, out, lse, b, n, m, h, scale, st);
    case 64: return launch_fwd_mma<64>(q, k, v, out, lse, b, n, m, h, scale, st);
    case 128: return launch_fwd_mma<128>(q, k, v, out, lse, b, n, m, h, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int b, int n, int m, int h, int dh, float scale,
                                       void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  if (b * n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16: return launch_fwd_f32<16>(q, k, v, out, lse, b, n, m, h, scale, st);
    case 32: return launch_fwd_f32<32>(q, k, v, out, lse, b, n, m, h, scale, st);
    case 64: return launch_fwd_f32<64>(q, k, v, out, lse, b, n, m, h, scale, st);
    case 128: return launch_fwd_f32<128>(q, k, v, out, lse, b, n, m, h, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
