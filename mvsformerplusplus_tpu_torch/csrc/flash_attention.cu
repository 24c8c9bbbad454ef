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
// flash_fwd_3xtf32_kernel (f32), FA2 on the tf32 tensor cores at fp32
// accuracy. The fp32 model runs it (the DINOv2 matcher's ViT-B, 12 heads of
// 64 at ~1600 tokens; the card-vs-CPU reference phases; tests). One tf32
// pass keeps ~11 significant bits, 40-280x outside the f32 tolerance, so
// every product is 3xTF32: each fp32 operand x is split into big = tf32(x)
// and small = tf32(x - big) (cvt.rna's rounding, by bit mask:
// flash::split_tf32) and a product is small*big + big*small + big*big on
// mma.sync m16n8k8, for S = Q.K^T and P.V alike (P is fp32 and is split
// too). These are explicit instructions: torch.backends.cuda.matmul.
// allow_tf32 does not govern them. The tensor cores add into their f32
// accumulators rounding towards zero, so a long chain of mma on one
// accumulator drifts: one chain of P.V across all key tiles put the
// matcher's case past its tolerance. So each tile's P.V goes into
// accumulators of its own, folded into O with one FFMA (O = O * alpha + PV,
// rounding to nearest), and S's cross terms go into accumulators apart from
// big*big, added once per tile. Blocks, staging and tails are the bf16
// kernel's: 4 warps own 64 query rows of one (b, h); K/V tiles (F32Tile: 128
// keys at DH=16, 64 at 32 and 64, 16 at 128; chosen on the card) stream
// through a two-stage cp.async ring in dynamic shared memory, rows padded by
// 16 bytes (87 KB at DH=64, 2 blocks per SM). Q and K reach the fragments by
// ldmatrix (an 8x8 b16 matrix of fp32 rows is 8 rows x 4 floats, lane i
// getting row i/4, float i%4: the tf32 A fragment, and B's for K^T); V's B
// fragment (row t, column g) by 32-bit shared loads, since ldmatrix.trans
// transposes 16-bit halves: with rows DH + 4 floats apart the 32 lanes hit
// 32 banks. S's accumulators give a thread the keys 2t and 2t + 1 of each 8;
// P.V takes them as its k slots t and t + 4 and reads V's rows in that
// order, so P goes from the accumulators to the A operand with no shuffle.
// At DH <= 64 a warp keeps its Q fragments split (big and small, DH / 2
// registers each); at DH=128 raw, split per k step and tile. The softmax is
// the bf16 kernel's (base 2, scale * log2e in one FFMA per logit, quad
// shuffles); a negative scale flips q's sign bit, so any scale runs. What
// bounds it on the H100: the 3 x 4 * N * M * DH tf32 flops at the TF32 rate
// (a third of it, 165 TFLOPS, for the products' count), where mma.sync
// reaches part of the peak; and the issue of the splits,
// 4 integer and FP32 instructions per K and V element each warp reads (the
// 4 warps of a block split the same tile), about as many as the mma.
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

// ------------------------------------------------------------------ f32 3xTF32

template <int DH>
struct F32Tile {
  static constexpr int BM = DH == 16 ? 128 : DH == 128 ? 16 : 64;  // keys per K/V tile
  static constexpr int LD = DH + 4;                                // padded shared row, floats
  static constexpr bool QSPLIT = DH <= 64;  // Q kept split in registers, else raw
  // dynamic shared memory: the Q tile, then the two-stage K and V rings
  static constexpr int SMEM = (MMA_BN + 4 * BM) * LD * (int)sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int n, int m, int h, float scale_log2) {
  using Cfg = F32Tile<DH>;
  constexpr int BM = Cfg::BM, LD = Cfg::LD;
  constexpr int KT = DH / 8;  // k8 steps of Q.K^T
  constexpr int NT = BM / 8;  // n-tiles of S, k8 steps of P.V
  constexpr int DT = DH / 8;  // n-tiles of O
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  float* qs = reinterpret_cast<float*>(fwd_smem);  // [MMA_BN * LD]
  float* const ks = qs + MMA_BN * LD;  // [2][BM * LD], stage st at ks + st * BM * LD
  float* const vs = ks + 2 * BM * LD;  // [2][BM * LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * MMA_BN;
  const int64_t rs = (int64_t)h * DH;  // elements between tokens
  const float* qb = q + (int64_t)b * n * rs + hh * DH;
  const float* kb = k + (int64_t)b * m * rs + hh * DH;
  const float* vb = v + (int64_t)b * m * rs + hh * DH;
  const int tiles = (m + BM - 1) / BM;
  // s * scale_log2 = (-s) * |scale_log2|: a negative scale flips q's sign;
  // a zero one (uniform weights) runs as the least normal float, so that a
  // masked key's -inf * scale_log2 stays -inf
  const uint32_t qsign = scale_log2 < 0.f ? 0x80000000u : 0u;
  scale_log2 = fmaxf(fabsf(scale_log2), 1.17549435e-38f);

  flash::load_rows_async<MMA_BN, DH>(qs, LD, qb, rs, q0, n, tid, MMA_THREADS);
  flash::load_rows_async<BM, DH>(ks, LD, kb, rs, 0, m, tid, MMA_THREADS);
  flash::load_rows_async<BM, DH>(vs, LD, vb, rs, 0, m, tid, MMA_THREADS);
  flash::cp_async_commit();

  // the warp's Q fragments: big in qf and small in ql (QSPLIT), or raw in qf
  uint32_t qf[KT][4], ql[Cfg::QSPLIT ? KT : 1][4];
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  // running max (in units of scale_log2 * logit) and this thread's partial
  // row sums of rows g and g + 8
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < tiles) {
      float* const kn = ks + (st ^ 1) * BM * LD;
      float* const vn = vs + (st ^ 1) * BM * LD;
      flash::load_rows_async<BM, DH>(kn, LD, kb, rs, (t + 1) * BM, m, tid, MMA_THREADS);
      flash::load_rows_async<BM, DH>(vn, LD, vb, rs, (t + 1) * BM, m, tid, MMA_THREADS);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        flash::ldmatrix_x4(qf[kt], qs + flash::a_off_f32(lane, warp * 16, kt * 8, LD));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qf[kt][i] ^= qsign;
          if constexpr (Cfg::QSPLIT) flash::split_tf32(qf[kt][i], qf[kt][i], ql[kt][i]);
        }
      }
    }

    // S = Q.K^T: big*big in s, the cross terms small*big + big*small in sx,
    // added once the tile's products are done
    const float* const kst = ks + st * BM * LD;
    const float* const vst = vs + st * BM * LD;
    float s[NT][4], sx[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = sx[j][i] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (Cfg::QSPLIT) {
          ab[i] = qf[kt][i];
          as[i] = ql[kt][i];
        } else {
          flash::split_tf32(qf[kt][i], ab[i], as[i]);
        }
      }
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        // K[n0 + g][k0 + t], K[n0 + g][k0 + t + 4], the same at n0 + 8 + g
        uint32_t kf[4], kbg[4], ksm[4];
        flash::ldmatrix_x4(kf, kst + flash::b_off_f32(lane, j2 * 16, kt * 8, LD));
#pragma unroll
        for (int i = 0; i < 4; ++i) flash::split_tf32(kf[i], kbg[i], ksm[i]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          flash::mma_tf32(sx[2 * j2 + e], as, kbg[2 * e], kbg[2 * e + 1]);
          flash::mma_tf32(sx[2 * j2 + e], ab, ksm[2 * e], ksm[2 * e + 1]);
          flash::mma_tf32(s[2 * j2 + e], ab, kbg[2 * e], kbg[2 * e + 1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] += sx[j][i];
    const int k0 = t * BM;
    if (k0 + BM > m) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = k0 + j * 8 + tq * 2;
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
    float mb[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 1));
      tm[i] = fmaxf(tm[i], __shfl_xor_sync(0xffffffffu, tm[i], 2));
      const float mnew = fmaxf(mx[i], tm[i] * scale_log2);  // scale_log2 > 0
      alpha[i] = flash::exp2_approx(mx[i] - mnew);
      mx[i] = mnew;
      mb[i] = -mnew;
      l[i] *= alpha[i];
    }

    // P.V into this tile's own accumulators, one k8 step per n-tile j of S:
    // the thread's keys j*8 + 2t and j*8 + 2t + 1 are its k slots t and t + 4,
    // in P and in V's rows alike
    float ot[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) ot[d][0] = ot[d][1] = ot[d][2] = ot[d][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = flash::exp2_approx(fmaf(s[j][0], scale_log2, mb[0]));
      const float p1 = flash::exp2_approx(fmaf(s[j][1], scale_log2, mb[0]));
      const float p2 = flash::exp2_approx(fmaf(s[j][2], scale_log2, mb[1]));
      const float p3 = flash::exp2_approx(fmaf(s[j][3], scale_log2, mb[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      // a0 = P[g][2t], a1 = P[g+8][2t], a2 = P[g][2t+1], a3 = P[g+8][2t+1]
      uint32_t pb[4], ps[4];
      flash::split_tf32(__float_as_uint(p0), pb[0], ps[0]);
      flash::split_tf32(__float_as_uint(p2), pb[1], ps[1]);
      flash::split_tf32(__float_as_uint(p1), pb[2], ps[2]);
      flash::split_tf32(__float_as_uint(p3), pb[3], ps[3]);
      const float* const vr = vst + (j * 8 + 2 * tq) * LD + g;  // V[key 2t][g]
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t vb0, vs0, vb1, vs1;
        flash::split_tf32(__float_as_uint(vr[d * 8]), vb0, vs0);
        flash::split_tf32(__float_as_uint(vr[LD + d * 8]), vb1, vs1);
        flash::mma_3xtf32(ot[d], pb, ps, vb0, vb1, vs0, vs1);
      }
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[d][i] = fmaf(o[d][i], alpha[i >> 1], ot[d][i]);
    __syncthreads();  // stage st is refilled by the next iteration
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int r0 = q0 + warp * 16 + g;
  float* ob = out + (int64_t)b * n * rs + hh * DH + tq * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(ob + row * rs + d * 8) =
          make_float2(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
    if (lse != nullptr && tq == 0)
      lse[(int64_t)bh * n + row] = (mx[i] + log2f(l[i])) * flash::LN2;
  }
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
  constexpr int bytes = F32Tile<DH>::SMEM;
  if (bytes > 48 * 1024) {
    static const cudaError_t once = cudaFuncSetAttribute(
        flash_fwd_3xtf32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (once != cudaSuccess) return (int)once;
  }
  const dim3 grid((n + MMA_BN - 1) / MMA_BN, b * h);
  flash_fwd_3xtf32_kernel<DH><<<grid, MMA_THREADS, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, n, m, h,
      scale * flash::LOG2E);
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
