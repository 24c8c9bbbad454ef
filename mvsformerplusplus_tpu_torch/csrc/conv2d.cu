// Stride-1 "same" zero-padded odd-k 2D conv, NHWC, fp32 accumulation:
// x [B, H, W, Ci], w [K, K, Ci, Co] -> out [B, H, W, Co] (input type), no bias.
//
// Replaces mvsformerplusplus_tpu/ops/pallas/conv2d.py _conv2d_fwd_impl
// (_kernel); the conv's input gradient (_conv2d_bwd's dx) is the same
// function on the flipped, ci/co-swapped weights. Two kernels:
//
// conv2d_mma_kernel (bf16, Co a multiple of 8, Ci of 1-8, 16, 32 or 64), an
// implicit GEMM on mma.sync m16n8k16 with fp32 accumulators: M is a block
// tile of 8 x 32 output pixels (one warp per row, two m16 tiles each), N the
// block's Co tile (COT = 8-64, whole n8 fragments), K runs over (tap, 8-channel
// group) in the order k = tap * CP + c (CP = Ci, or 8 with Ci of 1-8
// zero-padded). A k16 step is two 8-channel groups: one tap's for CP >= 16,
// two neighbouring taps' for CP = 8 (the last step of an odd tap count pairs
// its tap with a zero chunk). Each A row is one pixel's 16-byte channel group
// at its tap's shifted position in the staged halo tile, so ldmatrix takes one
// row address per lane and no im2col buffer exists. The weights come packed
// by the wrapper into B-fragment order ([Co tiles][k16 steps][n8 tiles][32
// lanes][4 bf16]: one 8-byte shared load per lane per fragment) and stay
// resident in shared memory while the block walks its pixel tiles (a
// persistent grid, one Co tile per blockIdx.y). The zero-padded input halo
// [IH][IW][CP] is double-buffered: cp.async.cg 16-byte copies, whose source
// size 0 zero-fills the out-of-image halo (the conv's padding), fetch the
// next tile while the tensor cores work on this one; Ci of 1-7 is loaded into
// registers at the same point and stored, zero-padded to 8 channels, after
// the tensor cores' work. Each pixel's 16-byte chunks are
// XOR-swizzled by its index, so the eight row addresses of an ldmatrix phase
// and the epilogue's fragment writes fall in eight different bank groups. The
// epilogue rounds fp32 to bf16 once, stages the warp's 32 x COT outputs in
// shared memory and writes 16-byte rows.
//
// Bound on the H100: bytes. Every path case has an arithmetic intensity
// (bf16 in + out) at or below 288 FLOP/byte, under the tensor cores' ridge of
// ~295. Inside the SM the A fragments read k*k*CP*2 bytes of shared memory per
// output pixel, so the 3x3 convs at Ci = 64 and the 5x5/7x7 ones at CP = 8
// also press on the shared-memory rate.
//
// conv2d_tf32_kernel (f32, and the bf16 widths and alignments the mma
// kernel does not take), the same implicit GEMM on the tf32 tensor cores
// (mma.sync m16n8k8, fp32 accumulators). M and the block are the mma
// kernel's (8 x 32 pixels, a warp per row, two m16 tiles each, a persistent
// grid); N is a Co tile of 8, 16 or 32 (Co padded to a multiple of it in the
// packed weights, outputs past Co not stored); K runs over 8-channel chunks
// of the input (Ci zero-padded to a multiple of 8) and, within a chunk, the
// k*k taps, one k8 step each. The block walks (tile, chunk) items; a chunk's
// halo ([IH][IW][8] f32, 11-17 KB, each pixel's two 16-byte halves swapped
// by bit 2 of its index so ldmatrix's rows hit 8 bank groups) is split
// once into big and small parts (f32 products are 3xTF32: big = tf32(x),
// small = tf32(x - big), flash::split_tf32), which every tap's A fragments
// then read with two ldmatrix per m16 tile and no split instructions (each
// value serves k*k taps). f32 items stream through a two-stage cp.async
// ring, the next in flight while one is split and multiplied (the item at
// hand split in place to its big parts; a third stage would cost the
// 64-channel convs their 16-wide Co tile): 16-byte copies where x is on a
// 16-byte boundary
// with Ci % 4 == 0, else 4-byte ones (Ci of 1-7, any Ci, any alignment);
// bf16 values are loaded into registers during the previous item's
// products and converted and stored after them. An 8x8 b16 ldmatrix of f32
// rows hands each lane A's (g, t) float: the A fragment of an m16 tile is one
// ldmatrix. The weights come packed by the wrapper already split for
// 3xTF32 ([Co tiles][chunks][taps][n8 tiles][32 lanes]
// x (big b0, big b1, small b0, small b1): one 16-byte shared load per lane
// per fragment) and stay resident in shared memory for the block's Co tile;
// where they cannot (the 7x7 at Ci 64), a chunk's weights are staged with
// its halo instead (STREAM). A bf16 value is exact in tf32 and a product of
// two tf32 values exact in fp32, so bf16 takes one pass (one halo, no small
// parts) and differs from the plain version only in summation order. The
// tensor cores add into their accumulators rounding towards zero: each row
// of taps goes into accumulators of its own, folded in with
// round-to-nearest adds (a 3x3 at Ci 64 is 72 k8 steps, 216 mma on one
// output). Launch bounds of 2 blocks per SM (128 registers), and the
// wrapper picks the widest Co tile whose resident weights let 2 blocks
// share an SM (ops/cuda/conv2d.py tf32_plan). Bound on the H100, against
// the 3xTF32 rate (TF32 / 3, a ridge of ~49 flop per byte): bytes where
// 2 k^2 Ci Co / (4 (Ci + Co)) is under it (the 16 -> 16 convs, the
// decoder's 64 -> 8), the products above it (32 -> 32, 64 -> 64).
//
// Each instantiation sets its dynamic shared memory limit (and, for the mma
// kernel, reads its occupancy) once, at its first launch; the tf32 kernel's
// occupancy is read per launch, its shared memory depending on Ci. The mma kernel's
// register budget lets in as many blocks per SM as its shared memory does, up
// to 4 (Cfg::MINB); Ci of 1-7 has instantiations of its own (PLAIN), so the
// registers it stages through do not weigh on the others.
#include "flash_mma.cuh"

using flash::bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ------------------------------------------------------------------ bf16 mma

namespace mma_conv {

constexpr int TH = 8, TW = 32;  // output pixels per tile: a warp per row
constexpr int THREADS = 32 * TH;

// The physical 16-byte chunk of logical chunk c of pixel p when each pixel
// holds CG chunks (1, 2, 4 or 8): 8 consecutive pixels' chunk c land in 8
// different 16-byte bank groups.
template <int CG>
__device__ __forceinline__ int swz(int p, int c) {
  constexpr int SH = CG == 1 ? 3 : CG == 2 ? 2 : CG == 4 ? 1 : 0;
  return c ^ ((p >> SH) & (CG - 1));
}

template <int K, int CP, int COT>
struct Cfg {
  static constexpr int P = (K - 1) / 2, IH = TH + 2 * P, IW = TW + 2 * P;
  static constexpr int KK = K * K;
  static constexpr int CG = CP / 8;                        // input chunks per pixel
  static constexpr int NT = COT / 8;                       // n8 tiles = output chunks per pixel
  static constexpr int KSTEPS = (KK * CP + 15) / 16;
  static constexpr int HALO = IH * IW * CP;                // elements per stage
  static constexpr int WFRAG = KSTEPS * NT * 32 * 4;       // packed weight elements
  static constexpr int STAGE = TH * TW * COT;              // epilogue elements
  static constexpr int SMEM = (2 * HALO + WFRAG + STAGE + 8) * 2;
  // blocks per SM the registers must allow: as many as shared memory lets
  // in (228 KB per SM, 1 KB of it reserved per block), at most 4 (64
  // registers a thread) for up to 16 accumulators, 2 for 32, 1 for 64
  static constexpr int BY_SMEM = 233472 / (SMEM + 1024);
  static constexpr int BY_ACC = NT <= 2 ? 4 : NT == 4 ? 2 : 1;
  static constexpr int MINB = BY_SMEM < BY_ACC ? BY_SMEM : BY_ACC;
  static_assert(CP == 8 || CP == 16 || CP == 32 || CP == 64, "channel pad");
  static_assert(COT == 8 || COT == 16 || COT == 32 || COT == 64, "Co tile");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// Stage tile (b, y0, x0)'s zero-padded input halo asynchronously (Ci = CP, 16-
// byte chunks): pixel p = yy * IW + xx holds input (y0 + yy - P, x0 + xx - P),
// its CG chunks swizzled.
template <class C>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ x, int b, int y0,
                                          int x0, int h, int w, int ci, int tid) {
  const bf16* xb = x + (int64_t)b * h * w * ci;
  for (int i = tid; i < C::IH * C::IW * C::CG; i += THREADS) {
    const int p = i / C::CG, c = i % C::CG;
    const int yy = p / C::IW, xx = p - yy * C::IW;
    const int gy = y0 + yy - C::P, gx = x0 + xx - C::P;
    const bool in = (unsigned)gy < (unsigned)h && (unsigned)gx < (unsigned)w;
    const bf16* src = in ? xb + ((int64_t)gy * w + gx) * ci + c * 8 : xb;
    flash::cp_async16(dst + p * C::CG * 8 + swz<C::CG>(p, c) * 8, src, in ? 16 : 0);
  }
}

// Ci of 1-7, whose pixels are not 16-byte aligned: the halo's values are
// loaded into registers (PPT pixels per thread, issued before the tensor
// cores' work on the current tile) and stored to shared memory, zero-padded
// to 8 channels, after it.
template <class C>
struct PlainTile {
  static constexpr int PPT = (C::IH * C::IW + THREADS - 1) / THREADS;
  unsigned short v[PPT][7];

  __device__ __forceinline__ void fetch(const bf16* __restrict__ x, int b, int y0, int x0, int h,
                                        int w, int ci, int tid) {
    const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) + (int64_t)b * h * w * ci;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = tid + j * THREADS;
      const int yy = p / C::IW, xx = p - yy * C::IW;
      const int gy = y0 + yy - C::P, gx = x0 + xx - C::P;
      const bool in = p < C::IH * C::IW && (unsigned)gy < (unsigned)h && (unsigned)gx < (unsigned)w;
      const unsigned short* s = xb + (in ? ((int64_t)gy * w + gx) * ci : 0);
#pragma unroll
      for (int c = 0; c < 7; ++c) v[j][c] = in && c < ci ? s[c] : 0;
    }
  }

  __device__ __forceinline__ void store(bf16* dst, int tid) const {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int p = tid + j * THREADS;
      if (p < C::IH * C::IW)
        *reinterpret_cast<uint4*>(dst + p * 8) = make_uint4(
            v[j][0] | (uint32_t)v[j][1] << 16, v[j][2] | (uint32_t)v[j][3] << 16,
            v[j][4] | (uint32_t)v[j][5] << 16, v[j][6]);
    }
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// One k16 step for both m16 tiles of the warp: A rows at shared byte address
// `addr` (the second tile's `next` bytes on), B fragments at b[n * 32].
template <int NT>
__device__ __forceinline__ void k16_step(float (&acc)[2][NT][4], uint32_t addr, uint32_t next,
                                         const uint2* b) {
  uint32_t a0[4], a1[4];
  ldsm_x4(a0, addr);
  ldsm_x4(a1, addr + next);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint2 bb = b[n * 32];
    flash::mma_bf16(acc[0][n], a0, bb.x, bb.y);
    flash::mma_bf16(acc[1][n], a1, bb.x, bb.y);
  }
}

// The k16 steps of tap `tap` (CP >= 16): channels 16 cs + 8 khalf .. + 7.
template <int K, int CP, class C>
__device__ __forceinline__ void tap_steps(float (&acc)[2][C::NT][4], uint32_t hs, int p0, int tap,
                                          int khalf, const uint2* bl) {
  const int p = p0 + (tap / K) * C::IW + tap % K;  // p + 16 swizzles alike
  const uint32_t row = hs + p * CP * 2;
#pragma unroll
  for (int cs = 0; cs < CP / 16; ++cs)
    k16_step<C::NT>(acc, row + swz<C::CG>(p, 2 * cs + khalf) * 16, 16 * CP * 2,
                    bl + (tap * (CP / 16) + cs) * C::NT * 32);
}

// PLAIN: Ci of 1-7 (CP = 8), staged through registers; else Ci = CP, by cp.async.
template <int K, int CP, int COT, bool PLAIN>
__global__ void __launch_bounds__(THREADS, Cfg<K, CP, COT>::MINB)
conv2d_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpack,
                  bf16* __restrict__ out, int h, int w, int ci, int co, int tiles_x,
                  int tiles_y, int ntiles) {
  using C = Cfg<K, CP, COT>;
  static_assert(!PLAIN || CP == 8, "Ci of 1-7 pads to 8 channels");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* halo = reinterpret_cast<bf16*>(smem_raw);                   // [2][IH * IW][CP]
  const uint2* wfrag = reinterpret_cast<const uint2*>(halo + 2 * C::HALO);  // [KSTEPS][NT][32]
  bf16* stage = halo + 2 * C::HALO + C::WFRAG;                       // [TH][TW][COT]
  bf16* zero = stage + C::STAGE;                                     // one zero chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = blockIdx.y * COT;
  {
    const bf16* wsrc = wpack + (int64_t)blockIdx.y * C::WFRAG;
    bf16* wdst = halo + 2 * C::HALO;
    for (int i = tid; i < C::WFRAG / 8; i += THREADS) flash::cp_async16(wdst + i * 8, wsrc + i * 8, 16);
    if (tid == 0) *reinterpret_cast<uint4*>(zero) = make_uint4(0u, 0u, 0u, 0u);
  }
  const int per_img = tiles_x * tiles_y;
  auto origin = [&](int t, int& b, int& y0, int& x0) {
    b = t / per_img;
    const int r = t - b * per_img, ty = r / tiles_x;
    y0 = ty * TH;
    x0 = (r - ty * tiles_x) * TW;
  };
  PlainTile<C> pt;
  int t = blockIdx.x;
  if (t < ntiles) {
    int b, y0, x0;
    origin(t, b, y0, x0);
    if constexpr (PLAIN) {
      pt.fetch(x, b, y0, x0, h, w, ci, tid);
      pt.store(halo, tid);
    } else {
      load_tile<C>(halo, x, b, y0, x0, h, w, ci, tid);
    }
  }
  flash::cp_async_commit();

  // this lane's A row: pixel (warp, lane % 16) of the first m16 tile, k half lane / 16
  const int arow = lane & 15, khalf = lane >> 4;
  const int p0 = warp * C::IW + arow;  // its halo pixel at tap (0, 0)
  const uint2* bl = wfrag + lane;
  for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
    const int tn = t + gridDim.x;
    bf16* nxt = halo + ((it + 1) & 1) * C::HALO;
    if (tn < ntiles) {
      int b, y0, x0;
      origin(tn, b, y0, x0);
      if constexpr (PLAIN)
        pt.fetch(x, b, y0, x0, h, w, ci, tid);
      else
        load_tile<C>(nxt, x, b, y0, x0, h, w, ci, tid);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<1>();
    __syncthreads();

    const uint32_t hs = flash::smem_u32(halo + (it & 1) * C::HALO);
    float acc[2][C::NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < C::NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

    if constexpr (CP == 8) {
      // k16 step s: taps 2s (k half 0) and 2s + 1 (k half 1), one chunk each;
      // an odd tap count's last step gives k half 1 the zero chunk
      const uint32_t a_base = hs + p0 * 16, zero_u = flash::smem_u32(zero);
#pragma unroll
      for (int s = 0; s < C::KSTEPS; ++s) {
        const int t0 = 2 * s, t1 = 2 * s + 1;
        const uint32_t off0 = ((t0 / K) * C::IW + t0 % K) * 16;
        const uint32_t off1 = ((t1 / K) * C::IW + t1 % K) * 16;
        const bool last_half = t1 >= C::KK && khalf;
        const uint32_t addr = last_half ? zero_u : a_base + (khalf ? off1 : off0);
        k16_step<C::NT>(acc, addr, last_half ? 0u : 16u * 16u, bl + s * C::NT * 32);
      }
    } else if constexpr (C::KSTEPS <= 64) {
#pragma unroll
      for (int tap = 0; tap < C::KK; ++tap) tap_steps<K, CP, C>(acc, hs, p0, tap, khalf, bl);
    } else {
#pragma unroll 1
      for (int tap = 0; tap < C::KK; ++tap) tap_steps<K, CP, C>(acc, hs, p0, tap, khalf, bl);
    }
    if constexpr (PLAIN) {
      if (tn < ntiles) pt.store(nxt, tid);
    }
    __syncthreads();  // every warp is done with this halo stage; the next one is stored

    int b, y0, x0;
    origin(t, b, y0, x0);
    const int oy = y0 + warp;
    if (oy < h) {
      // C fragment: rows g, g + 8 of each m16 tile, columns 2 (lane % 4) .. + 1
      bf16* ws = stage + warp * TW * COT;
      const int g = lane >> 2, cq = lane & 3;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < C::NT; ++n) {
          const int q0 = m * 16 + g, q1 = q0 + 8;
          *reinterpret_cast<uint32_t*>(ws + q0 * COT + swz<C::NT>(q0, n) * 8 + 2 * cq) =
              flash::pack_bf16(acc[m][n][0], acc[m][n][1]);
          *reinterpret_cast<uint32_t*>(ws + q1 * COT + swz<C::NT>(q1, n) * 8 + 2 * cq) =
              flash::pack_bf16(acc[m][n][2], acc[m][n][3]);
        }
      }
      __syncwarp();
      bf16* orow = out + (((int64_t)b * h + oy) * w + x0) * co + co0;
      for (int i = lane; i < TW * C::NT; i += 32) {
        const int q = i / C::NT, c = i % C::NT;
        if (x0 + q < w)
          *reinterpret_cast<uint4*>(orow + (int64_t)q * co + c * 8) =
              *reinterpret_cast<const uint4*>(ws + q * COT + swz<C::NT>(q, c) * 8);
      }
    }
  }
}

struct Launch {
  int err;     // cudaError of the one-time setup
  int blocks;  // resident blocks on the device (SMs x blocks per SM)
};

template <int K, int CP, int COT, bool PLAIN>
static Launch setup() {
  using C = Cfg<K, CP, COT>;
  auto kern = conv2d_mma_kernel<K, CP, COT, PLAIN>;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, C::SMEM);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  return {(int)e, per_sm * sms};
}

template <int K, int CP, int COT, bool PLAIN>
static int launch_plain(const void* x, const void* wpack, void* out, int b, int h, int w, int ci,
                        int co, cudaStream_t st) {
  static const Launch once = setup<K, CP, COT, PLAIN>();
  if (once.err) return once.err;
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const int ntiles = b * tiles_x * tiles_y, ncot = co / COT;
  const int per_cot = once.blocks / ncot > 1 ? once.blocks / ncot : 1;
  const dim3 grid(ntiles < per_cot ? ntiles : per_cot, ncot);
  conv2d_mma_kernel<K, CP, COT, PLAIN><<<grid, THREADS, Cfg<K, CP, COT>::SMEM, st>>>(
      (const bf16*)x, (const bf16*)wpack, (bf16*)out, h, w, ci, co, tiles_x, tiles_y, ntiles);
  return (int)cudaGetLastError();
}

template <int K, int CP, int COT>
static int launch(const void* x, const void* wpack, void* out, int b, int h, int w, int ci,
                  int co, cudaStream_t st) {
  if constexpr (CP == 8) {
    if (ci < 8) return launch_plain<K, CP, COT, true>(x, wpack, out, b, h, w, ci, co, st);
  }
  return launch_plain<K, CP, COT, false>(x, wpack, out, b, h, w, ci, co, st);
}

}  // namespace mma_conv

// The (k, channel pad, Co tile) instantiations of the mma kernel: every one
// whose shared memory fits one block. ops/cuda/conv2d.py MMA_CASES lists the
// same (a CPU test reads these lines).
#define CONV_MMA_CASE(K, CP, COT) \
  if (k == K && cp == CP && cot == COT) \
    return mma_conv::launch<K, CP, COT>(x, wpack, out, b, h, w, ci, co, st);

// x bf16 [B, H, W, Ci] (16-byte aligned), wpack the weights in the kernel's
// B-fragment order (ops/cuda/conv2d.py pack_weights), out bf16 [B, H, W, Co].
extern "C" int conv2d_same_mma(const void* x, const void* wpack, void* out, int b, int h, int w,
                               int ci, int co, int k, void* stream) {
  if ((int64_t)b * h * w * co == 0) return 0;
  const int cp = ci <= 8 ? 8 : ci;
  const int cot = co % 64 == 0 ? 64 : co % 32 == 0 ? 32 : co % 16 == 0 ? 16 : co % 8 == 0 ? 8 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  CONV_MMA_CASE(3, 8, 8)
  CONV_MMA_CASE(3, 8, 16)
  CONV_MMA_CASE(3, 8, 32)
  CONV_MMA_CASE(3, 8, 64)
  CONV_MMA_CASE(3, 16, 8)
  CONV_MMA_CASE(3, 16, 16)
  CONV_MMA_CASE(3, 16, 32)
  CONV_MMA_CASE(3, 16, 64)
  CONV_MMA_CASE(3, 32, 8)
  CONV_MMA_CASE(3, 32, 16)
  CONV_MMA_CASE(3, 32, 32)
  CONV_MMA_CASE(3, 32, 64)
  CONV_MMA_CASE(3, 64, 8)
  CONV_MMA_CASE(3, 64, 16)
  CONV_MMA_CASE(3, 64, 32)
  CONV_MMA_CASE(3, 64, 64)
  CONV_MMA_CASE(5, 8, 8)
  CONV_MMA_CASE(5, 8, 16)
  CONV_MMA_CASE(5, 8, 32)
  CONV_MMA_CASE(5, 8, 64)
  CONV_MMA_CASE(5, 16, 8)
  CONV_MMA_CASE(5, 16, 16)
  CONV_MMA_CASE(5, 16, 32)
  CONV_MMA_CASE(5, 16, 64)
  CONV_MMA_CASE(5, 32, 8)
  CONV_MMA_CASE(5, 32, 16)
  CONV_MMA_CASE(5, 32, 32)
  CONV_MMA_CASE(5, 32, 64)
  CONV_MMA_CASE(5, 64, 8)
  CONV_MMA_CASE(5, 64, 16)
  CONV_MMA_CASE(5, 64, 32)
  CONV_MMA_CASE(7, 8, 8)
  CONV_MMA_CASE(7, 8, 16)
  CONV_MMA_CASE(7, 8, 32)
  CONV_MMA_CASE(7, 8, 64)
  CONV_MMA_CASE(7, 16, 8)
  CONV_MMA_CASE(7, 16, 16)
  CONV_MMA_CASE(7, 16, 32)
  CONV_MMA_CASE(7, 16, 64)
  CONV_MMA_CASE(7, 32, 8)
  CONV_MMA_CASE(7, 32, 16)
  CONV_MMA_CASE(7, 32, 32)
  CONV_MMA_CASE(7, 64, 8)
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ tf32 mma

namespace tf32_conv {

constexpr int TH = 8, TW = 32;  // output pixels per tile: a warp per row
constexpr int THREADS = 32 * TH;
constexpr int CC = 8;  // input channels per staged chunk: one k8 step per tap
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one block

// Staging modes: VEC, f32 on a 16-byte boundary with Ci % 4 == 0, by 16-byte
// cp.async; ELEM, any other f32, by 4-byte cp.async; REG, bf16, through
// registers (converted to f32 there).
constexpr int VEC = 0, ELEM = 1, REG = 2;
constexpr int RING = 2;  // cp.async stages of the f32 modes: the next item in flight

// halo stages of one chunk in shared memory: for f32 the ring (the item at
// hand split in place to its big parts) and one of small parts; for bf16
// one (its values are exact in tf32). Streamed weights take two stages.
__host__ __device__ constexpr int tf32_stages(int mode) { return mode == REG ? 1 : RING + 1; }

template <int K>
struct Geo {
  static constexpr int P = (K - 1) / 2, IH = TH + 2 * P, IW = TW + 2 * P;
  static constexpr int KK = K * K;
  static constexpr int STAGE = IH * IW * CC;                   // floats per halo stage
  static constexpr int PPT = (STAGE + THREADS - 1) / THREADS;  // values a thread stages
};

// The float offset of channel c (0-7) of halo pixel p: its two 16-byte
// halves swapped where bit 2 of p is set, so that the 8 rows of an ldmatrix
// phase (8 consecutive pixels, one half) fall in 8 different bank groups.
__device__ __forceinline__ int hoff(int p, int c) {
  return p * CC + ((((c >> 2) ^ (p >> 2)) & 1) << 2) + (c & 3);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = flash::pack_bf16(a, b);
}

// 4 bytes global -> shared, asynchronously; 0 source bytes write a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(flash::smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void split_at(float* big, float* small, int i) {
  uint32_t b, s;
  flash::split_tf32(__float_as_uint(big[i]), b, s);
  big[i] = __uint_as_float(b);
  small[i] = __uint_as_float(s);
}

template <typename T, int K, int COT, int MODE, bool STREAM>
__global__ void __launch_bounds__(THREADS, 2)
conv2d_tf32_kernel(const T* __restrict__ x, const float4* __restrict__ wpack,
                   T* __restrict__ out, int h, int w, int ci, int co, int nch, int tiles_x,
                   int tiles_y, int ntiles) {
  using G = Geo<K>;
  constexpr int NT = COT / 8;           // n8 tiles
  constexpr int WCH = G::KK * NT * 32;  // float4s of one chunk's weights
  static_assert((MODE == REG) == (sizeof(T) == 2), "f32 by cp.async, bf16 through registers");
  extern __shared__ __align__(128) float tf32_smem[];
  // f32: ring[RING][STAGE], then the small parts [STAGE]; bf16: the halo
  // [STAGE]; then the weights (resident: [nch][WCH]; streamed: a stage each)
  float* const ring = tf32_smem;
  float* const hsml = tf32_smem + RING * G::STAGE;
  float4* const wsm = reinterpret_cast<float4*>(tf32_smem + tf32_stages(MODE) * G::STAGE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = blockIdx.y * COT;
  const float4* const wsrc = wpack + (int64_t)blockIdx.y * nch * WCH;
  if constexpr (!STREAM) {
    for (int i = tid; i < nch * WCH; i += THREADS) flash::cp_async16(wsm + i, wsrc + i, 16);
  }
  const int per_img = tiles_x * tiles_y;
  const int64_t img = (int64_t)h * w * ci;
  // item i of this block: tile blockIdx.x + (i / nch) * gridDim.x, chunk i % nch
  auto tile_of = [&](int i) { return (int)(blockIdx.x + (i / nch) * gridDim.x); };
  auto origin = [&](int t, int& b, int& y0, int& x0) {
    b = t / per_img;
    const int r = t - b * per_img, ty = r / tiles_x;
    y0 = ty * TH;
    x0 = (r - ty * tiles_x) * TW;
  };
  auto stream_weights = [&](int i, int wst) {
    if constexpr (STREAM) {
      for (int j = tid; j < WCH; j += THREADS)
        flash::cp_async16(wsm + wst * WCH + j, wsrc + (int64_t)(i % nch) * WCH + j, 16);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  // this lane's A row: pixel (warp, lane % 16) of the first m16 tile, half lane / 16
  const int piece = lane >> 4;
  const int p0 = warp * G::IW + (lane & 15);  // its halo pixel at tap (0, 0)
  const int g = lane >> 2, cq = lane & 3;

  // the item's products from its halo's big (hb) and small (hl) parts and
  // its chunk's weights (wl, this lane's)
  auto compute = [&](uint32_t hb, uint32_t hl, const float4* wl) {
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      // one row of taps into partial accumulators, folded into acc by
      // round-to-nearest adds (the tensor cores' own adds truncate)
      float part[2][NT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          part[m][n][0] = part[m][n][1] = part[m][n][2] = part[m][n][3] = 0.f;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int pp = p0 + dy * G::IW + dx;  // pp + 16 (the second m16 tile) swizzles alike
        const uint32_t off = (pp * CC + (((piece ^ (pp >> 2)) & 1) << 2)) * 4;
        uint32_t b0[4], b1[4];
        mma_conv::ldsm_x4(b0, hb + off);
        mma_conv::ldsm_x4(b1, hb + off + 16 * CC * 4);
        const float4* const wt = wl + (dy * K + dx) * NT * 32;
        if constexpr (MODE != REG) {
          uint32_t s0[4], s1[4];
          mma_conv::ldsm_x4(s0, hl + off);
          mma_conv::ldsm_x4(s1, hl + off + 16 * CC * 4);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float4 bw = wt[n * 32];  // big b0, big b1, small b0, small b1
            const uint32_t bb0 = __float_as_uint(bw.x), bb1 = __float_as_uint(bw.y);
            const uint32_t bs0 = __float_as_uint(bw.z), bs1 = __float_as_uint(bw.w);
            flash::mma_3xtf32(part[0][n], b0, s0, bb0, bb1, bs0, bs1);
            flash::mma_3xtf32(part[1][n], b1, s1, bb0, bb1, bs0, bs1);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float4 bw = wt[n * 32];
            flash::mma_tf32(part[0][n], b0, __float_as_uint(bw.x), __float_as_uint(bw.y));
            flash::mma_tf32(part[1][n], b1, __float_as_uint(bw.x), __float_as_uint(bw.y));
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
    }
  };

  auto epilogue = [&](int t) {  // acc to out (the tile's last chunk), then zeroed
    int b, y0, x0;
    origin(t, b, y0, x0);
    const int oy = y0 + warp;
    if (oy < h) {
      // C fragment: rows g, g + 8 of each m16 tile, columns 2 cq .. + 1
      T* const orow = out + ((int64_t)b * h + oy) * w * co;
      const bool pairs = (co & 1) == 0;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int px = x0 + m * 16 + g + 8 * i;
          if (px >= w) continue;
          T* const op = orow + (int64_t)px * co + co0 + 2 * cq;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int c = co0 + n * 8 + 2 * cq;
            const float v0 = acc[m][n][2 * i], v1 = acc[m][n][2 * i + 1];
            if (pairs && c + 1 < co) {
              store2(op + n * 8, v0, v1);
            } else {
              if (c < co) store(op + n * 8, v0);
              if (c + 1 < co) store(op + n * 8 + 1, v1);
            }
          }
        }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  };

  if constexpr (MODE != REG) {
    // item i's halo chunk (channels 8 ch .. + 7, zero past Ci and outside
    // the image: the conv's padding) into ring stage i % RING, and its
    // weights where streamed; one commit group per item, empty past the last
    auto issue = [&](int i) {
      const int t = tile_of(i), ch = i % nch;
      if (t < ntiles) {
        int b, y0, x0;
        origin(t, b, y0, x0);
        float* const dst = ring + (i % RING) * G::STAGE;
        const float* xb = reinterpret_cast<const float*>(x) + b * img;
        if constexpr (MODE == VEC) {
          for (int j = tid; j < G::IH * G::IW * 2; j += THREADS) {
            const int p = j >> 1, half = j & 1;
            const int yy = p / G::IW, xx = p - yy * G::IW;
            const int gy = y0 + yy - G::P, gx = x0 + xx - G::P, gc = ch * CC + half * 4;
            const bool in = (unsigned)gy < (unsigned)h && (unsigned)gx < (unsigned)w && gc < ci;
            flash::cp_async16(dst + hoff(p, half * 4),
                              in ? xb + ((int64_t)gy * w + gx) * ci + gc : xb, in ? 16 : 0);
          }
        } else {
          for (int j = tid; j < G::STAGE; j += THREADS) {
            const int p = j >> 3, c = j & 7;
            const int yy = p / G::IW, xx = p - yy * G::IW;
            const int gy = y0 + yy - G::P, gx = x0 + xx - G::P, gc = ch * CC + c;
            const bool in = (unsigned)gy < (unsigned)h && (unsigned)gx < (unsigned)w && gc < ci;
            cp_async4(dst + hoff(p, c), in ? xb + ((int64_t)gy * w + gx) * ci + gc : xb,
                      in ? 4 : 0);
          }
        }
        stream_weights(i, i % RING);
      }
      flash::cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < RING - 1; ++i) issue(i);
    for (int it = 0;; ++it) {
      const int t = tile_of(it), ch = it % nch;
      if (t >= ntiles) break;
      flash::cp_async_wait<RING - 2>();
      __syncthreads();  // item it landed; every warp is done with item it - 1
      float* const cur = ring + (it % RING) * G::STAGE;
      for (int j = tid; j < G::STAGE; j += THREADS) split_at(cur, hsml, j);
      __syncthreads();  // item it is split (its big parts in place)
      issue(it + RING - 1);
      compute(flash::smem_u32(cur), flash::smem_u32(hsml),
              wsm + (STREAM ? it % RING : ch) * WCH + lane);
      if (ch == nch - 1) epilogue(t);
    }
  } else {
    // bf16: each item's values loaded into registers during the previous
    // item's products, converted and stored after them
    float v[G::PPT];
    auto fetch = [&](int i) {
      const int t = tile_of(i), ch = i % nch;
      int b, y0, x0;
      origin(t, b, y0, x0);
      const T* xb = x + b * img;
#pragma unroll
      for (int j = 0; j < G::PPT; ++j) {
        const int e = tid + j * THREADS, p = e >> 3, c = e & 7;
        const int yy = p / G::IW, xx = p - yy * G::IW;
        const int gy = y0 + yy - G::P, gx = x0 + xx - G::P, gc = ch * CC + c;
        const bool in = p < G::IH * G::IW && (unsigned)gy < (unsigned)h &&
                        (unsigned)gx < (unsigned)w && gc < ci;
        v[j] = in ? to_f32(xb[((int64_t)gy * w + gx) * ci + gc]) : 0.f;
      }
    };
    auto put = [&]() {
#pragma unroll
      for (int j = 0; j < G::PPT; ++j) {
        const int e = tid + j * THREADS, p = e >> 3;
        if (p < G::IH * G::IW) ring[hoff(p, e & 7)] = v[j];
      }
    };
    if (tile_of(0) < ntiles) {
      fetch(0);
      stream_weights(0, 0);
    }
    flash::cp_async_commit();
    if (tile_of(0) < ntiles) put();
    for (int it = 0;; ++it) {
      const int t = tile_of(it), ch = it % nch;
      if (t >= ntiles) break;
      const bool next = tile_of(it + 1) < ntiles;
      flash::cp_async_wait<0>();
      __syncthreads();  // item it stored (and its weights landed); item it - 1 done
      if (next) {
        fetch(it + 1);
        stream_weights(it + 1, (it + 1) & 1);
      }
      flash::cp_async_commit();
      compute(flash::smem_u32(ring), 0, wsm + (STREAM ? it & 1 : ch) * WCH + lane);
      if (next) {
        __syncthreads();  // every warp is done with the halo
        put();
      }
      if (ch == nch - 1) epilogue(t);
    }
  }
}

struct Setup {
  int err;  // cudaError of the one-time setup
  int sms;  // the device's SMs
};

template <typename T, int K, int COT, int MODE, bool STREAM>
static Setup setup() {
  int dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(conv2d_tf32_kernel<T, K, COT, MODE, STREAM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return {(int)e, sms};
}

template <typename T, int K, int COT, int MODE, bool STREAM>
static int launch(const void* x, const void* wpack, void* out, int b, int h, int w, int ci,
                  int co, cudaStream_t st) {
  using G = Geo<K>;
  auto kern = conv2d_tf32_kernel<T, K, COT, MODE, STREAM>;
  static const Setup once = setup<T, K, COT, MODE, STREAM>();
  if (once.err) return once.err;
  const int nch = (ci + CC - 1) / CC;
  // the halo's stages, then the weights: per chunk KK x COT/8 fragments of 32 float4s
  const int64_t bytes = (tf32_stages(MODE) * G::STAGE +
                         (int64_t)(STREAM ? 2 : nch) * G::KK * (COT / 8) * 128) * 4;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
  const int ntiles = b * tiles_x * tiles_y, ncot = (co + COT - 1) / COT;
  const int per_cot = per_sm * once.sms / ncot > 1 ? per_sm * once.sms / ncot : 1;
  const dim3 grid(ntiles < per_cot ? ntiles : per_cot, ncot);
  kern<<<grid, THREADS, (size_t)bytes, st>>>((const T*)x, (const float4*)wpack, (T*)out, h, w, ci,
                                             co, nch, tiles_x, tiles_y, ntiles);
  return (int)cudaGetLastError();
}

template <int K, int COT, bool STREAM>
static int launch_t(const void* x, const void* wpack, void* out, int b, int h, int w, int ci,
                    int co, int dtype, cudaStream_t st) {
  if (dtype == 1) return launch<bf16, K, COT, REG, STREAM>(x, wpack, out, b, h, w, ci, co, st);
  if ((uintptr_t)x % 16 == 0 && ci % 4 == 0)
    return launch<float, K, COT, VEC, STREAM>(x, wpack, out, b, h, w, ci, co, st);
  return launch<float, K, COT, ELEM, STREAM>(x, wpack, out, b, h, w, ci, co, st);
}

}  // namespace tf32_conv

// The tf32 kernel's packed weights in one launch (ops/cuda/conv2d.py
// pack_weights_tf32, whose CPU path is the same gather and split in torch):
// pair i of the index (offsets into the stored kernel w, f32 or bf16, as it
// lies) gives out[i] = (big b0, big b1, small b0, small b1), each weight
// first rounded to bf16 where the conv's input is bf16 (round_bf16), big =
// tf32(w), small = tf32(w - big), both to nearest, ties away, the low 13
// bits cleared: the torch version's values bit for bit.
__global__ void conv2d_pack_tf32_kernel(const void* __restrict__ w,
                                        const int64_t* __restrict__ idx, float4* __restrict__ out,
                                        int64_t pairs, int src_bf16, int round_bf16) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  uint32_t big[2], small[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int64_t j = idx[2 * i + e];
    float v = src_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(w)[j])
                       : reinterpret_cast<const float*>(w)[j];
    if (round_bf16) v = __bfloat162float(__float2bfloat16(v));
    flash::split_tf32(__float_as_uint(v), big[e], small[e]);
    small[e] &= 0xffffe000u;
  }
  out[i] = make_float4(__uint_as_float(big[0]), __uint_as_float(big[1]), __uint_as_float(small[0]),
                       __uint_as_float(small[1]));
}

extern "C" int conv2d_pack_tf32(const void* w, const void* idx, void* out, int64_t pairs,
                                int src_bf16, int round_bf16, void* stream) {
  if (pairs == 0) return 0;
  const int threads = 256;
  conv2d_pack_tf32_kernel<<<(unsigned)((pairs + threads - 1) / threads), threads, 0,
                            (cudaStream_t)stream>>>(w, (const int64_t*)idx, (float4*)out, pairs,
                                                    src_bf16, round_bf16);
  return (int)cudaGetLastError();
}

// The (k, Co tile, streamed) instantiations of the tf32 kernel, each for f32
// (cp.async or register staging) and bf16 inputs. ops/cuda/conv2d.py
// TF32_CASES lists the same (a CPU test reads these lines).
#define CONV_TF32_CASE(K, COT, STREAM) \
  if (k == K && cot == COT && streamed == STREAM) \
    return tf32_conv::launch_t<K, COT, STREAM>(x, wpack, out, b, h, w, ci, co, dtype, st);

// x [B, H, W, Ci] f32 (dtype 0) or bf16 (dtype 1), any alignment; wpack the
// weights in the kernel's pre-split B-fragment order for Co tile `cot`
// (ops/cuda/conv2d.py pack_weights_tf32; `streamed`: staged per chunk with
// the halo, else resident), out [B, H, W, Co] in x's type.
extern "C" int conv2d_same_tf32(const void* x, const void* wpack, void* out, int b, int h, int w,
                                int ci, int co, int k, int cot, int streamed, int dtype,
                                void* stream) {
  if ((int64_t)b * h * w * co == 0) return 0;
  if (ci < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CONV_TF32_CASE(3, 8, 0)
  CONV_TF32_CASE(3, 16, 0)
  CONV_TF32_CASE(3, 32, 0)
  CONV_TF32_CASE(3, 8, 1)
  CONV_TF32_CASE(5, 8, 0)
  CONV_TF32_CASE(5, 16, 0)
  CONV_TF32_CASE(5, 32, 0)
  CONV_TF32_CASE(5, 8, 1)
  CONV_TF32_CASE(7, 8, 0)
  CONV_TF32_CASE(7, 16, 0)
  CONV_TF32_CASE(7, 8, 1)
  return (int)cudaErrorInvalidValue;
}
