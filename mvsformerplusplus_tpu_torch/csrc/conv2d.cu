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
// conv2d_same_kernel (f32, and any other width or alignment): fp32 SIMT
// FMAs. A block computes a TH x TW tile of output pixels for COT output
// channels; per chunk of CIC input channels it stages the zero-padded input
// halo tile ([ci][y][x]: neighbouring threads read neighbouring words) and the
// chunk's weights (broadcast reads) in shared memory, and each thread
// accumulates its pixel's COT outputs in registers. It serves the fp32 model.
//
// Each instantiation sets its dynamic shared memory limit (and, for the mma
// kernel, reads its occupancy) once, at its first launch. The mma kernel's
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

// ------------------------------------------------------------------ fp32 SIMT

constexpr int TH = 8, TW = 32, NT = TH * TW, CIC = 8;

template <int K, int COT>
constexpr int smem_bytes() {
  return (CIC * (TH + K - 1) * (TW + K - 1) + K * K * CIC * COT) * 4;
}

template <typename T, int K, int COT>
__global__ void __launch_bounds__(NT)
conv2d_same_kernel(const T* __restrict__ x, const T* __restrict__ wgt, T* __restrict__ out,
                   int h, int w, int ci, int co, int ncot) {
  constexpr int P = (K - 1) / 2;
  constexpr int IH = TH + 2 * P, IW = TW + 2 * P;
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem;                   // [CIC][IH][IW]
  float* w_s = smem + CIC * IH * IW;    // [K*K][CIC][COT]
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int b = blockIdx.z / ncot;
  const int co0 = (blockIdx.z % ncot) * COT;
  const T* xb = x + (int64_t)b * h * w * ci;

  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < ci; c0 += CIC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < IH * IW * CIC; idx += NT) {
      const int cc = idx % CIC, p = idx / CIC;
      const int yy = p / IW, xx = p % IW;
      const int gy = y0 + yy - P, gx = x0 + xx - P, gc = c0 + cc;
      float val = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && gc < ci)
        val = to_f32(xb[((int64_t)gy * w + gx) * ci + gc]);
      in_s[(cc * IH + yy) * IW + xx] = val;
    }
    for (int idx = threadIdx.x; idx < K * K * CIC * COT; idx += NT) {
      const int oc = idx % COT, r = idx / COT;
      const int cc = r % CIC, tap = r / CIC;
      const int gc = c0 + cc, gco = co0 + oc;
      w_s[idx] = (gc < ci && gco < co) ? to_f32(wgt[((int64_t)tap * ci + gc) * co + gco]) : 0.f;
    }
    __syncthreads();
    const int nci = min(CIC, ci - c0);
    for (int cc = 0; cc < nci; ++cc) {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float xv = in_s[(cc * IH + ty + dy) * IW + tx + dx];
          const float4* wr = reinterpret_cast<const float4*>(w_s + ((dy * K + dx) * CIC + cc) * COT);
#pragma unroll
          for (int c4 = 0; c4 < COT / 4; ++c4) {
            const float4 ww = wr[c4];
            acc[4 * c4] += xv * ww.x;
            acc[4 * c4 + 1] += xv * ww.y;
            acc[4 * c4 + 2] += xv * ww.z;
            acc[4 * c4 + 3] += xv * ww.w;
          }
        }
      }
    }
  }
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy >= h || ox >= w) return;
  T* op = out + (((int64_t)b * h + oy) * w + ox) * co + co0;
#pragma unroll
  for (int c = 0; c < COT; ++c)
    if (co0 + c < co) store(op + c, acc[c]);
}

template <typename T, int K, int COT>
static int launch(const void* x, const void* wgt, void* out, int b, int h, int w, int ci, int co,
                  cudaStream_t st) {
  constexpr int bytes = smem_bytes<K, COT>();
  static const cudaError_t once = cudaFuncSetAttribute(
      conv2d_same_kernel<T, K, COT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (once != cudaSuccess) return (int)once;
  const int ncot = (co + COT - 1) / COT;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b * ncot);
  conv2d_same_kernel<T, K, COT><<<grid, NT, bytes, st>>>((const T*)x, (const T*)wgt, (T*)out, h,
                                                          w, ci, co, ncot);
  return (int)cudaGetLastError();
}

template <typename T, int K>
static int launch_k(const void* x, const void* wgt, void* out, int b, int h, int w, int ci,
                    int co, cudaStream_t st) {
  if (co % 32 == 0) return launch<T, K, 32>(x, wgt, out, b, h, w, ci, co, st);
  if (co % 16 == 0) return launch<T, K, 16>(x, wgt, out, b, h, w, ci, co, st);
  return launch<T, K, 8>(x, wgt, out, b, h, w, ci, co, st);
}

template <typename T>
static int launch_t(const void* x, const void* wgt, void* out, int b, int h, int w, int ci,
                    int co, int k, cudaStream_t st) {
  switch (k) {
    case 3: return launch_k<T, 3>(x, wgt, out, b, h, w, ci, co, st);
    case 5: return launch_k<T, 5>(x, wgt, out, b, h, w, ci, co, st);
    case 7: return launch_k<T, 7>(x, wgt, out, b, h, w, ci, co, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int conv2d_same_simt(const void* x, const void* wgt, void* out, int b, int h, int w,
                                int ci, int co, int k, int dtype, void* stream) {
  if ((int64_t)b * h * w * co == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) return launch_t<__nv_bfloat16>(x, wgt, out, b, h, w, ci, co, k, st);
  return launch_t<float>(x, wgt, out, b, h, w, ci, co, k, st);
}
