// Kernel 9: the reprojection gather, one thread per (pixel, plane).
//
// Replaces hikari_tpu/ops/reproj_gather.py:_make_kernel (launched by
// _gather_impl). out[s][y, f, x] = src[s][piy, f, pix] where
// 0 <= piy < hs and 0 <= pix < w, and 0 otherwise, for up to five sources
// (three temporal and two spatial reservoir carries) in one launch.
//
// Design: the TPU kernel's banded window, group-mean offsets, tap codes and
// lane rolls exist because the TPU has no per-lane gather; here every
// thread loads its source word directly. Threads of a warp take
// neighbouring x of one output plane row, so the stores are coalesced and
// the loads of a smooth motion field fall on few source lines.
//
// Bound on the H100: bytes. Per pixel and source it reads 16 planes * 4 B
// and writes 16 * 4 B, plus 8 B of coordinates, and does no arithmetic on
// the values (pure selection, bit-exact).

#include <cuda_runtime.h>

#define HK_MAX_SRC 5

struct GatherPtrs {
  const float* src[HK_MAX_SRC];
  float* dst[HK_MAX_SRC];
};

__global__ void __launch_bounds__(256)
gather_kernel(GatherPtrs p, const int* __restrict__ piy,
              const int* __restrict__ pix, int n_src, int hs, int h, int w,
              int f) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)h * f * w;
  if (i >= total) return;
  int x = (int)(i % w);
  long long yf = i / w;
  int c = (int)(yf % f);
  int y = (int)(yf / f);
  int sy = piy[(long long)y * w + x];
  int sx = pix[(long long)y * w + x];
  bool ok = sy >= 0 && sy < hs && sx >= 0 && sx < w;
  long long src_i = ((long long)sy * f + c) * w + sx;
  // unrolled over the pointer slots, so they stay in the parameter bank
#pragma unroll
  for (int s = 0; s < HK_MAX_SRC; s++) {
    if (s < n_src) {
      float v = 0.0f;
      if (ok) v = p.src[s][src_i];
      p.dst[s][i] = v;
    }
  }
}

extern "C" int hk_reproj_gather(const float* s0, const float* s1,
                                const float* s2, const float* s3,
                                const float* s4, float* d0, float* d1,
                                float* d2, float* d3, float* d4,
                                const int* piy, const int* pix, int n_src,
                                int hs, int h, int w, int f, void* stream) {
  GatherPtrs p;
  p.src[0] = s0;
  p.src[1] = s1;
  p.src[2] = s2;
  p.src[3] = s3;
  p.src[4] = s4;
  p.dst[0] = d0;
  p.dst[1] = d1;
  p.dst[2] = d2;
  p.dst[3] = d3;
  p.dst[4] = d4;
  long long total = (long long)h * f * w;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, piy, pix, n_src, hs, h, w, f);
  return (int)cudaGetLastError();
}
