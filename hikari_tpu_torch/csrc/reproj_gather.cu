// Kernel 9: the reprojection gather, one thread per output pixel, every
// plane of every source.
//
// Replaces hikari_tpu/ops/reproj_gather.py:_make_kernel (launched by
// _gather_impl). out[s][y, c, x] = src[s][piy, c, pix] where
// 0 <= piy < hs and 0 <= pix < w, and 0 otherwise, for up to five sources
// (three temporal and two spatial reservoir carries) in one launch.
//
// Design: the TPU kernel's banded window, group-mean offsets, tap codes and
// lane rolls exist because the TPU has no per-lane gather; here every
// thread loads its source words directly. Bound on the H100: bytes. Per
// pixel and source it reads 16 planes * 4 B and writes 16 * 4 B, plus 8 B
// of coordinates, and does no arithmetic on the values (pure selection,
// bit-exact). So the kernel moves those bytes and little else:
// * a 2-D grid (GATHER_TX columns x GATHER_TY rows a block) with 32-bit
//   index math (the launcher refuses planes of 2^31 words or more);
// * each thread reads its pixel's two coordinates once, then loops over
//   the sources and the 16 planes (unrolled), loading
//   GATHER_BATCH planes before it stores them (the compiler may not move
//   a load above a store through another pointer that could alias it);
// * the lanes of a warp take neighbouring x of one plane row, so every
//   store instruction of a warp writes 128 contiguous bytes;
// * a rejected pixel stores zeros without loading.
// Tried on the card and dropped (PERF.md): 2 or 4 neighbouring pixels a
// thread, with one vector store per plane and one vector read where the
// group's source columns are consecutive and aligned (equal within 2%:
// the kernel runs at ~84% of the bytes bound either way), and
// streaming-cache loads and stores (__ldcs / __stcs: equal or up to 9%
// slower).

#include <cuda_runtime.h>

#define HK_MAX_SRC 5

#define GATHER_TX 32     // threads of a block along x (one warp)
#define GATHER_TY 4      // rows of a block
#define GATHER_BATCH 8   // planes loaded before they are stored
#define GATHER_F 16      // planes per pixel: the packed reservoir's

struct GatherPtrs {
  const float* src[HK_MAX_SRC];
  float* dst[HK_MAX_SRC];
};

__global__ void __launch_bounds__(GATHER_TX * GATHER_TY)
gather_kernel(GatherPtrs p, const int* __restrict__ piy,
              const int* __restrict__ pix, int n_src, int hs, int h, int w) {
  const int f = GATHER_F;
  int x = blockIdx.x * GATHER_TX + threadIdx.x;
  int y = blockIdx.y * GATHER_TY + threadIdx.y;
  if (x >= w || y >= h) return;
  int sy = __ldg(piy + y * w + x);
  int sx = __ldg(pix + y * w + x);
  bool ok = sy >= 0 && sy < hs && sx >= 0 && sx < w;
  int src_at = ok ? sy * f * w + sx : 0;
  int dst_at = y * f * w + x;

  // unrolled over the pointer slots, so they stay in the parameter bank
#pragma unroll
  for (int s = 0; s < HK_MAX_SRC; s++) {
    if (s >= n_src) break;
    const float* src = p.src[s] + src_at;
    float* dst = p.dst[s] + dst_at;
#pragma unroll
    for (int c0 = 0; c0 < f; c0 += GATHER_BATCH) {
      float v[GATHER_BATCH];
#pragma unroll
      for (int b = 0; b < GATHER_BATCH; b++)
        v[b] = ok ? __ldg(src + (c0 + b) * w) : 0.0f;
#pragma unroll
      for (int b = 0; b < GATHER_BATCH; b++) dst[(c0 + b) * w] = v[b];
    }
  }
}

// One launch's arguments, as ops/reproj_gather.py GATHER_TABLE packs them:
// the sources' and the outputs' pointers (null past n_src), the
// coordinate planes, then n_src, hs, h, w and f.
struct GatherCall {
  const float* src[HK_MAX_SRC];
  float* dst[HK_MAX_SRC];
  const int* piy;
  const int* pix;
  int n_src, hs, h, w, f;
};
static_assert(sizeof(GatherCall) == 120, "GatherCall: ops/reproj_gather.py");

extern "C" int hk_reproj_gather(const GatherCall* call, void* stream) {
  const GatherCall& c = *call;
  GatherPtrs p;
  for (int s = 0; s < HK_MAX_SRC; s++) {
    p.src[s] = c.src[s];
    p.dst[s] = c.dst[s];
  }
  int n_src = c.n_src, hs = c.hs, h = c.h, w = c.w;
  if (n_src < 1 || n_src > HK_MAX_SRC || h < 0 || hs < 0 || w < 0 ||
      c.f != GATHER_F)
    return (int)cudaErrorInvalidValue;
  // 32-bit indices: every plane word of a source and an output
  if ((long long)(h > hs ? h : hs) * GATHER_F * w >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return 0;
  dim3 block(GATHER_TX, GATHER_TY);
  dim3 grid((w + GATHER_TX - 1) / GATHER_TX, (h + GATHER_TY - 1) / GATHER_TY);
  gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p, c.piy, c.pix,
                                                          n_src, hs, h, w);
  return (int)cudaGetLastError();
}
