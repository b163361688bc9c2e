// Kernel 7 of the port: the per-keypoint patch gather on Hopper.
//
// Replaces akaze_tpu/kernels/patch_pallas.py :: gather_patches
// (_gather_kernel).  For slot n and channel c (Lt, Lx, Ly) it writes
//   out[n, c] = stack_c[frame, level, y0 : y0 + ph, x0 : x0 + pw]
// for a valid slot and zeros for an invalid one.  The stacks are addressed
// through a frame stride and a level stride (rows contiguous), which covers
// the three layouts the JAX kernel accepts: frame-major (F, L, H0, W0),
// level-major (L, F, H0, W0) and one frame's (L, H0, W0).  Start indices
// clamp as lax.dynamic_slice clamps them, so a window stays inside the
// padded plane; where a level is smaller than the patch it reads the
// stack's zero padding, exactly as the JAX slice does.
//
// The TPU kernel fetched an (8, 128)-aligned superset window by DMA and
// recentred it with rolls (a Mosaic constraint), eight slots per program;
// none of that is needed here.  It is pure data movement, bound by bytes
// (each valid window read once, every slot written once): one block per
// (slot, channel), its threads copying the window row by row, so a warp
// reads and writes consecutive floats of a row.
#include "common.cuh"

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
    gather_patches_kernel(const float* __restrict__ lt, const float* __restrict__ lx,
                          const float* __restrict__ ly, const int* __restrict__ frame,
                          const int* __restrict__ lvl, const int* __restrict__ y0,
                          const int* __restrict__ x0, const int* __restrict__ valid,
                          float* __restrict__ out, int F, int L, long long s_frame,
                          long long s_level, int H0, int W0, int ph, int pw) {
  const int n = blockIdx.x, c = blockIdx.y;
  const int np = ph * pw;
  float* o = out + ((size_t)n * 3 + c) * np;
  if (valid[n] == 0) {
    for (int i = threadIdx.x; i < np; i += THREADS) o[i] = 0.f;
    return;
  }
  const float* src = c == 0 ? lt : (c == 1 ? lx : ly);
  const int f = clampi(frame[n], 0, F - 1), l = clampi(lvl[n], 0, L - 1);
  const int y = clampi(y0[n], 0, H0 - ph), x = clampi(x0[n], 0, W0 - pw);
  src += f * s_frame + l * s_level + (long long)y * W0 + x;
  for (int i = threadIdx.x; i < np; i += THREADS) {
    const int r = i / pw;
    o[i] = __ldg(src + (size_t)r * W0 + (i - r * pw));
  }
}

// frame/lvl/y0/x0/valid: (n,) int32 on the device; out: (n, 3, ph, pw).
// Strides are in floats; the caller checks ph <= H0 and pw <= W0.
extern "C" int gather_patches(const float* lt, const float* lx, const float* ly, const int* frame,
                              const int* lvl, const int* y0, const int* x0, const int* valid,
                              float* out, int n, int F, int L, long long s_frame,
                              long long s_level, int H0, int W0, int ph, int pw, void* stream) {
  if (n == 0) return 0;
  if (ph > H0 || pw > W0 || F < 1 || L < 1) return (int)cudaErrorInvalidValue;
  dim3 grd(n, 3);
  gather_patches_kernel<<<grd, THREADS, 0, (cudaStream_t)stream>>>(
      lt, lx, ly, frame, lvl, y0, x0, valid, out, F, L, s_frame, s_level, H0, W0, ph, pw);
  return (int)cudaGetLastError();
}
