// Kernels 1 and 2 of the port: the nonlinear scale space on Hopper.
//
// Kernel 1, base_stage, replaces akaze_tpu/kernels/fed_pallas.py ::
// base_stage_batched (_base_kernel).  For each frame it writes
//   seed = G_sigma0 * img                 (9 taps at sigma0 = 1.6)
//   modg = |Scharr grad (G_1 * img)|      (input of the contrast factor)
// One launch covers the batch: one block per 32x16 output tile, the input
// tile plus a 4-px halo in shared memory, each blur a separable pass there
// (tile_blur, which kernel 2's G_1 blur shares).  It is bound by bytes (one plane
// read, two written: 12 B/px against ~90 flops/px), so the design reads
// the frame once and keeps every intermediate pass in shared memory.
//
// Kernel 2, fused_octave, replaces fed_pallas.py :: fused_octave_batched
// (_octave_kernel with with_detect=True, with_half=True).  The TPU kernel
// kept a whole level in VMEM; one SM's 227 KB cannot hold a VGA level
// (1.2 MB), so here each stage of a level is its own short launch over the
// whole batch; the blur runs on shared-memory tiles like kernel 1, the
// other stages one thread per pixel reading their neighbourhood from
// global memory (L1/L2 serve the overlap):
//   blur (G_1) -> Scharr + conductivity -> one launch per FED sweep
//   (ping-pong) -> first Scharr derivatives (Lx, Ly) -> second
//   derivatives (Ldet, kept in scratch) -> score + packed sub-pixel field
// and at the end of the octave a 2x2 half-size launch.  Every stage is
// bound by bytes (about 3 planes moved per FED sweep against ~17 flops per
// pixel); fusing the sweeps with a widening halo is the next step.
//
// Numerics follow the reference exactly: every stage clamps to the plane
// border at its own input, taps are summed in the golden order (vertical
// pass, then horizontal; zero taps skipped; first term not added to zero),
// and the build passes -fmad=false so no product is contracted into an FMA.
#include "common.cuh"

#define MAXTAPS 9

struct Taps {
  float w[MAXTAPS];
  int n;  // odd, <= MAXTAPS
};

// sum_t w[t] * x[t * stride] over the nonzero taps, left to right.
__device__ __forceinline__ float tap_sum(const Taps& k, const float* x, int stride) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int t = 0; t < MAXTAPS; ++t) {
    if (t >= k.n) break;
    const float w = k.w[t];
    if (w == 0.f) continue;
    const float term = w * x[t * stride];
    acc = first ? term : acc + term;
    first = false;
  }
  return acc;
}

// ------------------------------------------------- separable tile blur

#define BT_W 32
#define BT_H 16
#define BR 4  // halo: up to 9 taps; the modg chain needs 2 + 1
#define IW (BT_W + 2 * BR)
#define IH (BT_H + 2 * BR)

// s_in[i][j] = p[clamp(y0 - BR + i)][clamp(x0 - BR + j)]; ends with a barrier.
__device__ void load_tile(const float* __restrict__ p, float (*s_in)[IW], int y0, int x0, int H,
                          int W) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  for (int i = tid; i < IH * IW; i += nt) {
    const int r = i / IW, c = i % IW;
    s_in[r][c] = p[(size_t)clampi(y0 - BR + r, 0, H - 1) * W + clampi(x0 - BR + c, 0, W - 1)];
  }
  __syncthreads();
}

// Edge-replicated separable blur of a loaded tile, vertical pass first (the
// golden tap order).  out[a * ow + b] is the blur at the clamped position
// (clamp(y0 + o + a), clamp(x0 + o + b)) for a < rows, b < ow, so a halo
// entry past the border holds exactly the value the reference reads there.
// vt holds rows x IW floats of the vertical pass.  Needs BR >= k.n / 2 - o
// and ow + o + k.n / 2 <= BT_W + BR; ends with a barrier.
__device__ void tile_blur(const Taps& k, const float (*s_in)[IW], int o, int rows, int ow,
                          float* vt, float* out, int y0, int x0, int H, int W) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const int hk = k.n / 2;
  for (int i = tid; i < rows * IW; i += nt) {
    const int a = i / IW, c = i % IW;
    const int ga = clampi(y0 + o + a, 0, H - 1);  // the clamped row this entry stands for
    vt[i] = tap_sum(k, &s_in[ga - hk - y0 + BR][c], IW);
  }
  __syncthreads();
  for (int i = tid; i < rows * ow; i += nt) {
    const int a = i / ow, b = i % ow;
    const int gb = clampi(x0 + o + b, 0, W - 1);
    out[i] = tap_sum(k, &vt[a * IW + gb - hk - x0 + BR], 1);
  }
  __syncthreads();
}

// ---------------------------------------------------------------- kernel 1

__global__ void base_stage_kernel(const float* __restrict__ img, float* __restrict__ seed,
                                  float* __restrict__ modg, int H, int W, Taps g0, Taps g1,
                                  float sn, float swn) {
  __shared__ float s_in[IH][IW];
  __shared__ float s_v0[BT_H * IW];
  __shared__ float s_seed[BT_H][BT_W];
  __shared__ float s_v1[(BT_H + 2) * IW];
  __shared__ float s_sm[BT_H + 2][BT_W + 2];  // G_1*img at (clamp(y0-1+a), clamp(x0-1+b))

  const int x0 = blockIdx.x * BT_W, y0 = blockIdx.y * BT_H;
  const size_t off = (size_t)blockIdx.z * H * W;
  load_tile(img + off, s_in, y0, x0, H, W);
  tile_blur(g0, s_in, 0, BT_H, BT_W, s_v0, &s_seed[0][0], y0, x0, H, W);
  tile_blur(g1, s_in, -1, BT_H + 2, BT_W + 2, s_v1, &s_sm[0][0], y0, x0, H, W);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  for (int i = tid; i < BT_H * BT_W; i += nt) {
    const int r = i / BT_W, c = i % BT_W;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    seed[off + (size_t)y * W + x] = s_seed[r][c];
    // Scharr (sigma 1) of G_1*img: row r+t and column c+t of s_sm stand
    // for the clamped positions y-1+t and x-1+t.
    const float vl = ((sn * s_sm[r][c]) + (swn * s_sm[r + 1][c])) + (sn * s_sm[r + 2][c]);
    const float vr =
        ((sn * s_sm[r][c + 2]) + (swn * s_sm[r + 1][c + 2])) + (sn * s_sm[r + 2][c + 2]);
    const float gx = (-vl) + vr;
    const float d0 = (-s_sm[r][c]) + s_sm[r + 2][c];
    const float d1 = (-s_sm[r][c + 1]) + s_sm[r + 2][c + 1];
    const float d2 = (-s_sm[r][c + 2]) + s_sm[r + 2][c + 2];
    const float gy = ((sn * d0) + (swn * d1)) + (sn * d2);
    modg[off + (size_t)y * W + x] = sqrtf(gx * gx + gy * gy);
  }
}

extern "C" int base_stage(const float* img, float* seed, float* modg, int B, int H, int W,
                          const float* g0, int n0, const float* g1, int n1, float sn, float swn,
                          void* stream) {
  Taps t0{}, t1{};
  for (int i = 0; i < n0; ++i) t0.w[i] = g0[i];
  for (int i = 0; i < n1; ++i) t1.w[i] = g1[i];
  t0.n = n0;
  t1.n = n1;
  dim3 blk(32, 8);
  dim3 grd((W + BT_W - 1) / BT_W, (H + BT_H - 1) / BT_H, B);
  base_stage_kernel<<<grd, blk, 0, (cudaStream_t)stream>>>(img, seed, modg, H, W, t0, t1, sn,
                                                           swn);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- kernel 2

__device__ __forceinline__ float ld(const float* p, int y, int x, int w) {
  return __ldg(p + (size_t)y * w + x);
}

// Scaled Scharr along x at half-width s: vertical smoothing [sn, swn, sn]
// at rows y-s, y, y+s, then the derivative (-left + right) at x-s, x+s.
__device__ __forceinline__ float scharr_x(const float* p, int y, int x, int h, int w, int s,
                                          float sn, float swn) {
  const int yu = clampi(y - s, 0, h - 1), yd = clampi(y + s, 0, h - 1);
  const int xl = clampi(x - s, 0, w - 1), xr = clampi(x + s, 0, w - 1);
  const float vl = ((sn * ld(p, yu, xl, w)) + (swn * ld(p, y, xl, w))) + (sn * ld(p, yd, xl, w));
  const float vr = ((sn * ld(p, yu, xr, w)) + (swn * ld(p, y, xr, w))) + (sn * ld(p, yd, xr, w));
  return (-vl) + vr;
}

// Scaled Scharr along y: vertical derivative, then horizontal smoothing.
__device__ __forceinline__ float scharr_y(const float* p, int y, int x, int h, int w, int s,
                                          float sn, float swn) {
  const int yu = clampi(y - s, 0, h - 1), yd = clampi(y + s, 0, h - 1);
  const int xl = clampi(x - s, 0, w - 1), xr = clampi(x + s, 0, w - 1);
  const float dl = (-ld(p, yu, xl, w)) + ld(p, yd, xl, w);
  const float dc = (-ld(p, yu, x, w)) + ld(p, yd, x, w);
  const float dr = (-ld(p, yu, xr, w)) + ld(p, yd, xr, w);
  return ((sn * dl) + (swn * dc)) + (sn * dr);
}

#define PIXEL_PROLOGUE                                     \
  const int x = blockIdx.x * blockDim.x + threadIdx.x;     \
  const int y = blockIdx.y * blockDim.y + threadIdx.y;     \
  if (x >= w || y >= h) return;                            \
  const size_t plane = (size_t)blockIdx.z * h * w;         \
  const size_t idx = plane + (size_t)y * w + x;

// Lsmooth = G_1 * Lt: the same tiled separable blur as kernel 1.
__global__ void blur_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                            Taps k) {
  __shared__ float s_in[IH][IW];
  __shared__ float s_v[BT_H * IW];
  __shared__ float s_out[BT_H][BT_W];
  const int x0 = blockIdx.x * BT_W, y0 = blockIdx.y * BT_H;
  const size_t plane = (size_t)blockIdx.z * h * w;
  load_tile(in + plane, s_in, y0, x0, h, w);
  tile_blur(k, s_in, 0, BT_H, BT_W, s_v, &s_out[0][0], y0, x0, h, w);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  for (int i = tid; i < BT_H * BT_W; i += nt) {
    const int y = y0 + i / BT_W, x = x0 + i % BT_W;
    if (y < h && x < w) out[plane + (size_t)y * w + x] = s_out[i / BT_W][i % BT_W];
  }
}

// kind: 0 = PM_G1, 1 = PM_G2, 2 = Weickert (Diffusivity enum order).
__global__ void conductivity_kernel(const float* __restrict__ lsm, const float* __restrict__ kf,
                                    float* __restrict__ g, int h, int w, float sn, float swn,
                                    int kind) {
  PIXEL_PROLOGUE
  const float* p = lsm + plane;
  const float gx = scharr_x(p, y, x, h, w, 1, sn, swn);
  const float gy = scharr_y(p, y, x, h, w, 1, sn, swn);
  const float k = kf[blockIdx.z];
  const float grad2 = (gx * gx + gy * gy) / (k * k);
  float out;
  if (kind == 1) {
    out = 1.f / (1.f + grad2);
  } else if (kind == 0) {
    out = expf(-grad2);
  } else {
    float g4 = grad2 * grad2;
    g4 = g4 * g4;
    const float safe = g4 > 0.f ? g4 : 1.f;
    out = grad2 > 0.f ? 1.f - expf(-3.315f / safe) : 1.f;
  }
  g[idx] = out;
}

// One explicit FED sweep: dst = src + ht * sum_n (g_c + g_n)(src_n - src_c)
// over E, W, S, N with clamped neighbours; ht = float32(tau / 2).
__global__ void fed_sweep_kernel(const float* __restrict__ src, const float* __restrict__ gp,
                                 float* __restrict__ dst, int h, int w, float ht) {
  PIXEL_PROLOGUE
  const float* l = src + plane;
  const float* g = gp + plane;
  const int xe = min(x + 1, w - 1), xw = max(x - 1, 0);
  const int ys = min(y + 1, h - 1), yn = max(y - 1, 0);
  const float c = ld(l, y, x, w), gc = ld(g, y, x, w);
  const float step = (((gc + ld(g, y, xe, w)) * (ld(l, y, xe, w) - c) +
                       (gc + ld(g, y, xw, w)) * (ld(l, y, xw, w) - c)) +
                      (gc + ld(g, ys, x, w)) * (ld(l, ys, x, w) - c)) +
                     (gc + ld(g, yn, x, w)) * (ld(l, yn, x, w) - c);
  dst[idx] = c + ht * step;
}

// First derivatives of the detector cascade: raw Lx, Ly into scratch and
// the sigma-scaled copies into the level-major outputs.
__global__ void deriv1_kernel(const float* __restrict__ lsm, float* __restrict__ lxr,
                              float* __restrict__ lyr, float* __restrict__ lx_out,
                              float* __restrict__ ly_out, int h, int w, int s, float sn,
                              float swn, float sf) {
  PIXEL_PROLOGUE
  const float* p = lsm + plane;
  const float lx = scharr_x(p, y, x, h, w, s, sn, swn);
  const float ly = scharr_y(p, y, x, h, w, s, sn, swn);
  lxr[idx] = lx;
  lyr[idx] = ly;
  lx_out[idx] = lx * sf;
  ly_out[idx] = ly * sf;
}

// Second derivatives and the det-Hessian response Ldet (scratch only).
__global__ void deriv2_kernel(const float* __restrict__ lxr, const float* __restrict__ lyr,
                              float* __restrict__ ldet, int h, int w, int s, float sn, float swn,
                              float s2) {
  PIXEL_PROLOGUE
  const float lxx = scharr_x(lxr + plane, y, x, h, w, s, sn, swn);
  const float lyy = scharr_y(lyr + plane, y, x, h, w, s, sn, swn);
  const float lxy = scharr_y(lxr + plane, y, x, h, w, s, sn, swn);
  ldet[idx] = (lxx * s2) * (lyy * s2) - (lxy * s2) * (lxy * s2);
}

// Strict 3x3-max candidate score (-3e38 elsewhere) and the packed 2-variable
// sub-pixel fit: qx * 65536 + qy with q = rint((clip(o, -1, 1) + 1) * 16000),
// or -1 for a rejected fit (kernels/fed_pallas.py pack_sub).
__global__ void score_kernel(const float* __restrict__ ldet, float* __restrict__ score,
                             int* __restrict__ sub, int h, int w, int border, float thr) {
  PIXEL_PROLOGUE
  const float* p = ldet + plane;
  const int xe = min(x + 1, w - 1), xw = max(x - 1, 0);
  const int ys = min(y + 1, h - 1), yn = max(y - 1, 0);
  const float v = ld(p, y, x, w);
  const float n_e = ld(p, y, xe, w), n_w = ld(p, y, xw, w);
  const float n_s = ld(p, ys, x, w), n_n = ld(p, yn, x, w);
  const float n_se = ld(p, ys, xe, w), n_nw = ld(p, yn, xw, w);
  const float n_ne = ld(p, yn, xe, w), n_sw = ld(p, ys, xw, w);
  float nmax = fmaxf(n_e, n_w);
  nmax = fmaxf(nmax, fmaxf(n_s, n_n));
  nmax = fmaxf(nmax, fmaxf(n_se, n_nw));
  nmax = fmaxf(nmax, fmaxf(n_ne, n_sw));
  const bool interior = y >= border && y < h - border && x >= border && x < w - border;
  const bool cand = interior && v > thr && v > nmax;
  score[idx] = cand ? v : -3.0e38f;

  const float dxv = 0.5f * (n_e - n_w);
  const float dyv = 0.5f * (n_s - n_n);
  const float dxx = (n_e + n_w) - 2.f * v;
  const float dyy = (n_s + n_n) - 2.f * v;
  const float dxy = 0.25f * (((n_se + n_nw) - n_ne) - n_sw);
  const float det = dxx * dyy - dxy * dxy;
  const bool tiny = fabsf(det) < 1e-30f;
  const float safe = tiny ? 1.f : det;
  const float ox = ((-dxv) * dyy + dyv * dxy) / safe;
  const float oy = ((-dyv) * dxx + dxv * dxy) / safe;
  const bool keep = !tiny && fabsf(ox) <= 1.f && fabsf(oy) <= 1.f;
  const float cx = fminf(fmaxf(keep ? ox : 0.f, -1.f), 1.f);
  const float cy = fminf(fmaxf(keep ? oy : 0.f, -1.f), 1.f);
  const int qx = (int)rintf((cx + 1.f) * 16000.f);
  const int qy = (int)rintf((cy + 1.f) * 16000.f);
  sub[idx] = keep ? qx * 65536 + qy : -1;
}

// 2x2 box mean of the octave's last Lt: the next octave's seed.
__global__ void half_kernel(const float* __restrict__ lt, float* __restrict__ out, int h, int w) {
  const int w2 = w / 2, h2 = h / 2;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w2 || y >= h2) return;
  const float* p = lt + (size_t)blockIdx.z * h * w;
  const float a00 = ld(p, 2 * y, 2 * x, w), a10 = ld(p, 2 * y + 1, 2 * x, w);
  const float a01 = ld(p, 2 * y, 2 * x + 1, w), a11 = ld(p, 2 * y + 1, 2 * x + 1, w);
  out[(size_t)blockIdx.z * h2 * w2 + (size_t)y * w2 + x] = 0.25f * (((a00 + a10) + a01) + a11);
}

// One octave for the whole batch.  Outputs are level-major (n, B, h, w);
// scratch planes are (B, h, w).  Per-level tables are host arrays:
// n_sweeps[n], half_taus[sum n_sweeps] (float32(tau/2), level by level),
// sigma_sizes[n], sn[n], swn[n] (Scharr smoothing taps at that size),
// borders[n].  g1/s1n/s1wn are the G_1 taps and the sigma-1 Scharr taps.
extern "C" int fused_octave(const float* seed, const float* k, float* lt, float* lx, float* ly,
                            float* score, int* sub, float* half, float* lsmooth, float* g,
                            float* tmp, float* lxr, float* lyr, float* ldet, int B, int h, int w,
                            int n, int first, int kind, const int* n_sweeps,
                            const float* half_taus, const int* sigma_sizes, const float* sn,
                            const float* swn, const int* borders, float threshold,
                            const float* g1, int n1, float s1n, float s1wn, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Taps t1{};
  for (int i = 0; i < n1; ++i) t1.w[i] = g1[i];
  t1.n = n1;
  const size_t pl = (size_t)B * h * w;
  dim3 blk(32, 8);
  dim3 grd((w + 31) / 32, (h + 7) / 8, B);
  dim3 tiles((w + BT_W - 1) / BT_W, (h + BT_H - 1) / BT_H, B);
  int tau_at = 0;
  for (int li = 0; li < n; ++li) {
    const float* src = li == 0 ? seed : lt + (li - 1) * pl;
    float* lt_li = lt + li * pl;
    const float* lsm;
    if (first && li == 0) {
      // Level 0: the seed is already G_sigma0 * img; Lsmooth == Lt, no FED.
      cudaMemcpyAsync(lt_li, seed, pl * sizeof(float), cudaMemcpyDeviceToDevice, st);
      lsm = seed;
    } else {
      blur_kernel<<<tiles, blk, 0, st>>>(src, lsmooth, h, w, t1);
      conductivity_kernel<<<grd, blk, 0, st>>>(lsmooth, k, g, h, w, s1n, s1wn, kind);
      const int ns = n_sweeps[li];
      if (ns == 0) cudaMemcpyAsync(lt_li, src, pl * sizeof(float), cudaMemcpyDeviceToDevice, st);
      const float* cur = src;
      for (int j = 0; j < ns; ++j) {
        // Ping-pong so that the last sweep lands in this level's output.
        float* dst = ((ns - 1 - j) % 2 == 0) ? lt_li : tmp;
        fed_sweep_kernel<<<grd, blk, 0, st>>>(cur, g, dst, h, w, half_taus[tau_at + j]);
        cur = dst;
      }
      tau_at += ns;
      lsm = lsmooth;
    }
    const int s = sigma_sizes[li];
    deriv1_kernel<<<grd, blk, 0, st>>>(lsm, lxr, lyr, lx + li * pl, ly + li * pl, h, w, s, sn[li],
                                       swn[li], (float)s);
    deriv2_kernel<<<grd, blk, 0, st>>>(lxr, lyr, ldet, h, w, s, sn[li], swn[li], (float)(s * s));
    score_kernel<<<grd, blk, 0, st>>>(ldet, score + li * pl, sub + li * pl, h, w, borders[li],
                                      threshold);
    AKAZE_RETURN_IF_ERROR();
  }
  if (half != nullptr) {
    dim3 hg((w / 2 + 31) / 32, (h / 2 + 7) / 8, B);
    half_kernel<<<hg, blk, 0, st>>>(lt + (n - 1) * pl, half, h, w);
  }
  return (int)cudaGetLastError();
}
