// Image gradient of the plane-sweep warp (warp.cu): the transpose of the
// bilinear sample. g [B, N, C] f32 cotangent of the warped samples, coords
// [B, N, 2] f32 pixel-unit (x, y) -> dsrc [B, H, W, C] f32, which the caller
// zero-initialises. Each sample scatters g x (bilinear weight) into the
// corners that lie inside the image; zero-padded corners get nothing. The
// coordinates get no gradient (the JAX warps stop it).
//
// Replaces mvsformerplusplus_tpu/ops/pallas/warp_band.py
// banded_warp_rows_bwd (narrow-row train stages) and banded_warp_blocked_bwd
// (wide rows): the TPU kernels build the transpose as one-hot band matmuls;
// here it is exact for every sample.
//
// Bound on the H100: the bytes (the f32 cotangent read, dsrc written), with
// four reductions per element into L2 on top, provided each element costs
// few instructions. The vector variant maps work as the forward does: one
// thread per (sample, 4-channel vector), C a template parameter, the batch
// from blockIdx.y, 32-bit indices up to the final pointer offset. A sample
// whose four corners all lie outside returns before it reads g, a zero
// cotangent vector before the atomics, and each inside corner takes one
// 16-byte vector reduction (atomicAdd(float4*), sm_90): a quarter of the
// atomic instructions and requests of scalar f32 atomics. Sums land in an
// order that varies from run to run. The scalar variant takes any C that is
// not a multiple of 4 or a g not on a 16-byte boundary; no full-width path
// reaches it. It maps work as the forward's scalar kernel does: a block's
// tile of SCALAR_TILE samples has its corners worked out once, into shared
// memory (warp_corners.cuh), then the block sweeps the tile's [samples x C]
// cotangent with the channel index fastest, V consecutive channels a thread:
// g, the only operand that may be misaligned, is read element by element
// (coalesced), and each inside corner takes one V-wide reduction at V
// consecutive addresses of dsrc, which is freshly allocated and aligned: a
// 16-byte atomicAdd(float4*) where 4 divides C, 8-byte float2 where 2 does,
// else scalar atomics, neighbouring lanes on neighbouring addresses.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_corners.cuh"

template <int C>
__global__ void __launch_bounds__(256) warp_bilinear_bwd_vec_kernel(
    const float* __restrict__ g, const float2* __restrict__ coords, float* __restrict__ dsrc,
    int h, int w, int nsamp) {
  constexpr unsigned G = C / 4;  // threads per sample, a power of two
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (unsigned)nsamp * G) return;
  const unsigned s = i / G, v = i % G;
  const int64_t sample = (int64_t)blockIdx.y * nsamp + s;
  const float2 xy = __ldg(coords + sample);
  const Corners k = bilinear_corners(xy.x, xy.y, h, w);
  if (!any_inside(k)) return;
  const float4 gv = __ldcs(reinterpret_cast<const float4*>(g + sample * C + v * 4));
  if (gv.x == 0.f && gv.y == 0.f && gv.z == 0.f && gv.w == 0.f) return;
  float* img = dsrc + (int64_t)blockIdx.y * h * w * C + v * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (k.pix[q] >= 0) {
      const float wt = k.wt[q];
      atomicAdd(reinterpret_cast<float4*>(img + k.pix[q] * C),
                make_float4(gv.x * wt, gv.y * wt, gv.z * wt, gv.w * wt));
    }
  }
}

template <int V>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[V], float wt);

template <>
__device__ __forceinline__ void add_vec<4>(float* p, const float (&v)[4], float wt) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0] * wt, v[1] * wt, v[2] * wt,
                                                      v[3] * wt));
}

template <>
__device__ __forceinline__ void add_vec<2>(float* p, const float (&v)[2], float wt) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0] * wt, v[1] * wt));
}

template <>
__device__ __forceinline__ void add_vec<1>(float* p, const float (&v)[1], float wt) {
  atomicAdd(p, v[0] * wt);
}

// V channels a thread (4, 2 or 1, dividing C), so its V elements belong to
// one sample and start on a V x 4-byte boundary of dsrc
template <int V>
__global__ void __launch_bounds__(SCALAR_TILE) warp_bilinear_bwd_scalar_kernel(
    const float* __restrict__ g, const float2* __restrict__ coords, float* __restrict__ dsrc,
    int h, int w, int c, int nsamp, int64_t total) {
  __shared__ int4 pix[SCALAR_TILE];
  __shared__ float4 wt[SCALAR_TILE];
  __shared__ float* img[SCALAR_TILE];
  const int64_t first = (int64_t)blockIdx.x * SCALAR_TILE;
  const int n = load_tile_corners(coords, dsrc, first, total, h, w, c, nsamp, pix, wt, img);
  const unsigned elems = (unsigned)n * c;
  const float* gt = g + first * c;
  for (unsigned e = threadIdx.x * V; e < elems; e += SCALAR_TILE * V) {
    const unsigned s = e / c, ch = e - s * c;
    const int4 p = pix[s];
    if ((p.x & p.y & p.z & p.w) < 0) continue;  // no corner inside
    float v[V];
    bool zero = true;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = __ldcs(gt + e + j);
      zero = zero && v[j] == 0.f;
    }
    if (zero) continue;
    const float4 k = wt[s];
    float* im = img[s] + ch;
    if (p.x >= 0) add_vec<V>(im + p.x, v, k.x);
    if (p.y >= 0) add_vec<V>(im + p.y, v, k.y);
    if (p.z >= 0) add_vec<V>(im + p.z, v, k.z);
    if (p.w >= 0) add_vec<V>(im + p.w, v, k.w);
  }
}

static unsigned int blocks_for(int64_t threads_needed, int threads) {
  return (unsigned int)((threads_needed + threads - 1) / threads);
}

template <int C>
static int launch_vec(const void* g, const void* coords, void* dsrc, int b, int h, int w,
                      int nsamp, cudaStream_t st) {
  const int threads = 256;
  const dim3 grid(blocks_for((int64_t)nsamp * (C / 4), threads), b);
  warp_bilinear_bwd_vec_kernel<C><<<grid, threads, 0, st>>>(
      (const float*)g, (const float2*)coords, (float*)dsrc, h, w, nsamp);
  return (int)cudaGetLastError();
}

// The channel counts the vector variant is built for; ops/cuda/warp.py
// VEC_CHANNELS[float32] lists the same (a CPU test reads these lines).
#define WARP_BWD_VEC_CASE(C) \
  case C:                    \
    return launch_vec<C>(g, coords, dsrc, b, h, w, nsamp, st);

extern "C" int warp_bilinear_bwd_vec(const void* g, const void* coords, void* dsrc, int b, int h,
                                     int w, int c, int nsamp, void* stream) {
  if (b == 0 || nsamp == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    WARP_BWD_VEC_CASE(4)
    WARP_BWD_VEC_CASE(8)
    WARP_BWD_VEC_CASE(16)
    WARP_BWD_VEC_CASE(32)
    WARP_BWD_VEC_CASE(64)
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int warp_bilinear_bwd_scalar(const void* g, const void* coords, void* dsrc, int b,
                                        int h, int w, int c, int nsamp, void* stream) {
  if (b == 0 || nsamp == 0) return 0;
  const int64_t total = (int64_t)b * nsamp;
  const unsigned grid = blocks_for(total, SCALAR_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  const float* gp = (const float*)g;
  const float2* xy = (const float2*)coords;
  float* d = (float*)dsrc;
  if (c % 4 == 0) {
    warp_bilinear_bwd_scalar_kernel<4><<<grid, SCALAR_TILE, 0, st>>>(gp, xy, d, h, w, c, nsamp,
                                                                     total);
  } else if (c % 2 == 0) {
    warp_bilinear_bwd_scalar_kernel<2><<<grid, SCALAR_TILE, 0, st>>>(gp, xy, d, h, w, c, nsamp,
                                                                     total);
  } else {
    warp_bilinear_bwd_scalar_kernel<1><<<grid, SCALAR_TILE, 0, st>>>(gp, xy, d, h, w, c, nsamp,
                                                                     total);
  }
  return (int)cudaGetLastError();
}
