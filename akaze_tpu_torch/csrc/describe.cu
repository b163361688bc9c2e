// Kernel 3 of the port: orientation + M-LDB description on Hopper.
//
// Replaces akaze_tpu/kernels/describe_fused.py :: describe_fused (_run,
// _fused_kernel).  The TPU kernel DMA'd an 8x128-aligned patch per keypoint
// into VMEM and sampled it with one-hot MXU products; here one warp owns one
// keypoint slot and reads its ~1,500 samples straight from the level planes
// in global memory (the planes of a batch stay resident in the 50 MB L2 far
// better than in the TPU's VMEM).  Per valid slot:
//   109 orientation samples of Lx/Ly (Gaussian weights) -> Cephes atan2 ->
//   42 sliding pi/3 windows (each lane sums its windows; warp-shuffle
//   argmax, first max wins) -> 441 rotated M-LDB samples of Lt/Lx/Ly ->
//   29 cell means per channel -> 486 comparisons packed LSB-first into 16
//   words with __ballot_sync.
// Invalid slots write zeros and return; validity may have holes, so every
// slot is looked at.  The work is bound by bytes (the samples: ~6 KB per
// keypoint against ~25 kflop), and the design touches each sample once,
// through L1/L2, keeping the per-keypoint intermediates in shared memory.
//
// Numerics as the reference: the Cephes atan2 polynomial (not atan2f); the
// remainder mod 2 pi takes the divisor's sign; sample coordinates are
// floor(x + off * scale + 0.5) clipped to the level; with -fmad=false every
// product and sum rounds on its own, as in the float32 reference.
//
// Table layout (kernels/describe.py _host_tables):
//   ftab: ori_di, ori_dj, ori_w [n_ori] | win_lo, win_hi, win_wrap [n_win] |
//         offk, offl [n_samp] | cell mean weight [n_cells]
//   itab: cell_start [n_cells + 1] | cell members (sample indices) |
//         bit_a, bit_b [n_bits] (indices into means[ch * n_cells + cell])
#include "common.cuh"

#define MAXG 8
#define MAX_ORI 128
#define MAX_SAMP 448
#define MAX_CELLS 32
#define WARPS 4
#define FULL 0xffffffffu

#define TWO_PI 6.28318548202514648f  // float32(2 pi)
#define PI_F 3.14159274101257324f    // float32(pi)

struct DescArgs {
  const float* lt[MAXG];
  const float* lx[MAXG];
  const float* ly[MAXG];
  int gh[MAXG], gw[MAXG];
  int B, n_kp;
  const float* kpf;  // (n_kp, 5): xf, yf, scale, xmax, ymax
  const int* kpi;    // (n_kp, 4): group, level in group, frame, valid
  const float* ftab;
  const int* itab;
  int n_ori, n_win, n_samp, n_cells, n_bits, n_words;
  float* angle;
  int* desc;
};

__device__ float atan2_cephes(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float t = ay / (ax > 0.f ? ax : 1.f);
  const bool big = t > 2.414213562373095f;
  const bool mid = (t > 0.4142135623730951f) && !big;
  const float base = big ? PI_F / 2.f : (mid ? PI_F / 4.f : 0.f);
  const float safe_t = big ? fmaxf(t, 1.f) : t;
  const float tr = big ? -1.f / safe_t : (mid ? (t - 1.f) / (t + 1.f) : t);
  const float z = tr * tr;
  const float p =
      ((8.05374449538e-2f * z - 1.38776856032e-1f) * z + 1.99777106478e-1f) * z -
      3.33329491539e-1f;
  float q = (base + tr) + (tr * z) * p;
  q = ax > 0.f ? q : PI_F / 2.f;
  q = (ax == 0.f && ay == 0.f) ? 0.f : q;
  q = x < 0.f ? PI_F - q : q;
  return y < 0.f ? -q : q;
}

__device__ __forceinline__ float mod_2pi(float a) {
  const float r = fmodf(a, TWO_PI);
  return r < 0.f ? r + TWO_PI : r;
}

__device__ __forceinline__ size_t sample_at(float xf, float yf, float offx, float offy,
                                            float sc, float xmax, float ymax, int w) {
  const float gx = floorf((xf + offx * sc) + 0.5f);
  const float gy = floorf((yf + offy * sc) + 0.5f);
  const int ix = (int)fminf(fmaxf(gx, 0.f), xmax);
  const int iy = (int)fminf(fmaxf(gy, 0.f), ymax);
  return (size_t)iy * w + ix;
}

__global__ void __launch_bounds__(WARPS * 32) describe_kernel(DescArgs a) {
  __shared__ float s_rx[WARPS][MAX_ORI], s_ry[WARPS][MAX_ORI], s_ang[WARPS][MAX_ORI];
  __shared__ float s_smp[WARPS][3][MAX_SAMP];
  __shared__ float s_mean[WARPS][3 * MAX_CELLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * WARPS + warp;
  if (kp >= a.n_kp) return;  // whole warp
  const int* ki = a.kpi + 4 * kp;
  if (ki[3] == 0) {
    if (lane == 0) a.angle[kp] = 0.f;
    if (lane < a.n_words) a.desc[(size_t)kp * a.n_words + lane] = 0;
    return;  // whole warp
  }
  const int g = ki[0];
  const int w = a.gw[g];
  const size_t off = ((size_t)ki[1] * a.B + ki[2]) * (size_t)a.gh[g] * w;
  const float* Lt = a.lt[g] + off;
  const float* Lx = a.lx[g] + off;
  const float* Ly = a.ly[g] + off;
  const float* kf = a.kpf + 5 * kp;
  const float xf = kf[0], yf = kf[1], sc = kf[2], xmax = kf[3], ymax = kf[4];

  const float* ori_di = a.ftab;
  const float* ori_dj = ori_di + a.n_ori;
  const float* ori_w = ori_dj + a.n_ori;
  const float* win_lo = ori_w + a.n_ori;
  const float* win_hi = win_lo + a.n_win;
  const float* win_wrap = win_hi + a.n_win;
  const float* offk = win_wrap + a.n_win;
  const float* offl = offk + a.n_samp;
  const float* cell_w = offl + a.n_samp;
  const int* cell_start = a.itab;
  const int* cell_mem = cell_start + a.n_cells + 1;
  const int* bit_a = cell_mem + cell_start[a.n_cells];
  const int* bit_b = bit_a + a.n_bits;

  // Orientation samples.
  float* rx = s_rx[warp];
  float* ry = s_ry[warp];
  float* ang = s_ang[warp];
  for (int s = lane; s < a.n_ori; s += 32) {
    const size_t p = sample_at(xf, yf, ori_di[s], ori_dj[s], sc, xmax, ymax, w);
    const float vx = ori_w[s] * __ldg(Lx + p);
    const float vy = ori_w[s] * __ldg(Ly + p);
    rx[s] = vx;
    ry[s] = vy;
    ang[s] = mod_2pi(atan2_cephes(vy, vx));
  }
  __syncwarp();

  // SURF windows: each lane sums its windows; the warp keeps the first max.
  float best_n = -1.f, best_x = 0.f, best_y = 0.f;
  int best_i = 1 << 30;
  for (int wi = lane; wi < a.n_win; wi += 32) {
    const float lo = win_lo[wi], hi = win_hi[wi], hi_wrapped = hi - TWO_PI;
    const bool wrap = win_wrap[wi] > 0.5f;
    float sx = 0.f, sy = 0.f;
    for (int s = 0; s < a.n_ori; ++s) {
      const float an = ang[s];
      const bool in = wrap ? (an > lo || an < hi_wrapped) : (an > lo && an < hi);
      if (in) {
        sx = sx + rx[s];
        sy = sy + ry[s];
      }
    }
    const float nrm = sx * sx + sy * sy;
    if (nrm > best_n) {
      best_n = nrm;
      best_i = wi;
      best_x = sx;
      best_y = sy;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float on = __shfl_xor_sync(FULL, best_n, o);
    const int oi = __shfl_xor_sync(FULL, best_i, o);
    const float ox = __shfl_xor_sync(FULL, best_x, o);
    const float oy = __shfl_xor_sync(FULL, best_y, o);
    if (on > best_n || (on == best_n && oi < best_i)) {
      best_n = on;
      best_i = oi;
      best_x = ox;
      best_y = oy;
    }
  }
  const float angle = mod_2pi(atan2_cephes(best_y, best_x));
  const float co = cosf(angle), si = sinf(angle);

  // M-LDB samples, gradients rotated into the keypoint frame.
  float* s0 = s_smp[warp][0];
  float* s1 = s_smp[warp][1];
  float* s2 = s_smp[warp][2];
  for (int u = lane; u < a.n_samp; u += 32) {
    const float k = offk[u], l = offl[u];
    const float syo = l * co + k * si;
    const float sxo = (-l) * si + k * co;
    const size_t p = sample_at(xf, yf, sxo, syo, sc, xmax, ymax, w);
    const float gx = __ldg(Lx + p), gy = __ldg(Ly + p);
    s0[u] = __ldg(Lt + p);
    s1[u] = gx * co + gy * si;
    s2[u] = (-gx) * si + gy * co;
  }
  __syncwarp();

  // Cell means: one lane per cell, members in increasing sample order.
  float* mean = s_mean[warp];
  for (int c = lane; c < a.n_cells; c += 32) {
    const float cw = cell_w[c];
    for (int ch = 0; ch < 3; ++ch) {
      const float* smp = s_smp[warp][ch];
      float acc = 0.f;
      for (int m = cell_start[c]; m < cell_start[c + 1]; ++m) acc = acc + smp[cell_mem[m]] * cw;
      mean[ch * a.n_cells + c] = acc;
    }
  }
  __syncwarp();

  // 486 comparisons: bit i -> word i / 32, bit i % 32 (LSB-first bytes,
  // little-endian words).
  for (int wd = 0; wd < a.n_words; ++wd) {
    const int b = wd * 32 + lane;
    const bool bit = b < a.n_bits && mean[bit_a[b]] > mean[bit_b[b]];
    const unsigned word = __ballot_sync(FULL, bit);
    if (lane == wd) a.desc[(size_t)kp * a.n_words + wd] = (int)word;
  }
  if (lane == 0) a.angle[kp] = angle;
}

extern "C" int describe(const void* const* planes, const int* gh, const int* gw, int G, int B,
                        int n_kp, const float* kpf, const int* kpi, const float* ftab,
                        const int* itab, int n_ori, int n_win, int n_samp, int n_cells,
                        int n_bits, int n_words, float* angle, int* desc, void* stream) {
  if (G > MAXG || n_ori > MAX_ORI || n_samp > MAX_SAMP || n_cells > MAX_CELLS || n_words > 32)
    return (int)cudaErrorInvalidValue;
  DescArgs a{};
  for (int g = 0; g < G; ++g) {
    a.lt[g] = (const float*)planes[3 * g];
    a.lx[g] = (const float*)planes[3 * g + 1];
    a.ly[g] = (const float*)planes[3 * g + 2];
    a.gh[g] = gh[g];
    a.gw[g] = gw[g];
  }
  a.B = B;
  a.n_kp = n_kp;
  a.kpf = kpf;
  a.kpi = kpi;
  a.ftab = ftab;
  a.itab = itab;
  a.n_ori = n_ori;
  a.n_win = n_win;
  a.n_samp = n_samp;
  a.n_cells = n_cells;
  a.n_bits = n_bits;
  a.n_words = n_words;
  a.angle = angle;
  a.desc = desc;
  if (n_kp == 0) return 0;
  const int blocks = (n_kp + WARPS - 1) / WARPS;
  describe_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
