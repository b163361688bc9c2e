// Kernels 3 and 6 of the port: orientation + M-LDB description on Hopper.
//
// Kernel 3 replaces akaze_tpu/kernels/describe_fused.py :: describe_fused
// (_run, _fused_kernel).  The TPU kernel DMA'd an 8x128-aligned patch per keypoint
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
// Kernel 6 replaces akaze_tpu/kernels/describe_pallas.py :: describe_pallas
// (_describe_kernel): the same per-slot work for one frame, reading that
// frame's padded (L, H0, W0) stacks in place (no per-keypoint DMA window, no
// one-hot matmul sampling).  Both kernels run one body, describe_slot, and
// are bound the same way.
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

// Sampling tables (kernels/describe.py _host_tables), shared by kernels 3
// and 6.
struct Tables {
  const float* ftab;
  const int* itab;
  int n_ori, n_win, n_samp, n_cells, n_bits, n_words;
};

struct DescArgs {
  const float* lt[MAXG];
  const float* lx[MAXG];
  const float* ly[MAXG];
  int gh[MAXG], gw[MAXG];
  int B, n_kp;
  const float* kpf;  // (n_kp, 5): xf, yf, scale, xmax, ymax
  const int* kpi;    // (n_kp, 4): group, level in group, frame, valid
  Tables t;
  float* angle;
  int* desc;
};

// Kernel 6's arguments: one frame's padded (L, H0, W0) stacks.
struct SingleArgs {
  const float *lt, *lx, *ly;
  int H0, W0, n_kp;
  const float* kpf;  // (n_kp, 5): xf, yf, scale, xmax, ymax
  const int* kpi;    // (n_kp, 2): level, valid
  Tables t;
  float* angle;
  int* desc;
};

// Per-warp shared scratch of one slot.
struct SlotSmem {
  float rx[MAX_ORI], ry[MAX_ORI], ang[MAX_ORI];
  float smp[3][MAX_SAMP];
  float mean[3 * MAX_CELLS];
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

__device__ __forceinline__ void zero_slot(const Tables& t, int kp, int lane, float* angle,
                                          int* desc) {
  if (lane == 0) angle[kp] = 0.f;
  if (lane < t.n_words) desc[(size_t)kp * t.n_words + lane] = 0;
}

// Orientation + M-LDB of one valid slot by one warp.  Lt/Lx/Ly point at the
// slot's level plane (row stride w); kf = (xf, yf, scale, xmax, ymax).
__device__ void describe_slot(const Tables& t, const float* Lt, const float* Lx, const float* Ly,
                              int w, const float* kf, SlotSmem& sm, int lane, int kp,
                              float* angle_out, int* desc_out) {
  const float xf = kf[0], yf = kf[1], sc = kf[2], xmax = kf[3], ymax = kf[4];
  const float* ori_di = t.ftab;
  const float* ori_dj = ori_di + t.n_ori;
  const float* ori_w = ori_dj + t.n_ori;
  const float* win_lo = ori_w + t.n_ori;
  const float* win_hi = win_lo + t.n_win;
  const float* win_wrap = win_hi + t.n_win;
  const float* offk = win_wrap + t.n_win;
  const float* offl = offk + t.n_samp;
  const float* cell_w = offl + t.n_samp;
  const int* cell_start = t.itab;
  const int* cell_mem = cell_start + t.n_cells + 1;
  const int* bit_a = cell_mem + cell_start[t.n_cells];
  const int* bit_b = bit_a + t.n_bits;

  // Orientation samples.
  for (int s = lane; s < t.n_ori; s += 32) {
    const size_t p = sample_at(xf, yf, ori_di[s], ori_dj[s], sc, xmax, ymax, w);
    const float vx = ori_w[s] * __ldg(Lx + p);
    const float vy = ori_w[s] * __ldg(Ly + p);
    sm.rx[s] = vx;
    sm.ry[s] = vy;
    sm.ang[s] = mod_2pi(atan2_cephes(vy, vx));
  }
  __syncwarp();

  // SURF windows: each lane sums its windows; the warp keeps the first max.
  float best_n = -1.f, best_x = 0.f, best_y = 0.f;
  int best_i = 1 << 30;
  for (int wi = lane; wi < t.n_win; wi += 32) {
    const float lo = win_lo[wi], hi = win_hi[wi], hi_wrapped = hi - TWO_PI;
    const bool wrap = win_wrap[wi] > 0.5f;
    float sx = 0.f, sy = 0.f;
    for (int s = 0; s < t.n_ori; ++s) {
      const float an = sm.ang[s];
      const bool in = wrap ? (an > lo || an < hi_wrapped) : (an > lo && an < hi);
      if (in) {
        sx = sx + sm.rx[s];
        sy = sy + sm.ry[s];
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
  for (int u = lane; u < t.n_samp; u += 32) {
    const float k = offk[u], l = offl[u];
    const float syo = l * co + k * si;
    const float sxo = (-l) * si + k * co;
    const size_t p = sample_at(xf, yf, sxo, syo, sc, xmax, ymax, w);
    const float gx = __ldg(Lx + p), gy = __ldg(Ly + p);
    sm.smp[0][u] = __ldg(Lt + p);
    sm.smp[1][u] = gx * co + gy * si;
    sm.smp[2][u] = (-gx) * si + gy * co;
  }
  __syncwarp();

  // Cell means (mean_mat^T . samples): one lane per cell, a running sum
  // over the cell's members in increasing sample order (the zero entries
  // of mean_mat add nothing and are skipped).
  for (int c = lane; c < t.n_cells; c += 32) {
    const float cw = cell_w[c];
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.f;
      for (int m = cell_start[c]; m < cell_start[c + 1]; ++m) acc = acc + sm.smp[ch][cell_mem[m]] * cw;
      sm.mean[ch * t.n_cells + c] = acc;
    }
  }
  __syncwarp();

  // 486 comparisons: bit i -> word i / 32, bit i % 32 (LSB-first bytes,
  // little-endian words).
  for (int wd = 0; wd < t.n_words; ++wd) {
    const int b = wd * 32 + lane;
    bool bit = false;
    if (b < t.n_bits) {
      const float ma = sm.mean[bit_a[b]], mb = sm.mean[bit_b[b]];
      bit = ma > mb;  // = (ma - mb > 0): IEEE subtraction is exact in sign
    }
    const unsigned word = __ballot_sync(FULL, bit);
    if (lane == wd) desc_out[(size_t)kp * t.n_words + wd] = (int)word;
  }
  if (lane == 0) angle_out[kp] = angle;
}

// Kernel 3: one warp per slot of the batch, per-octave level-major stacks.
__global__ void __launch_bounds__(WARPS * 32) describe_kernel(DescArgs a) {
  __shared__ SlotSmem smem[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * WARPS + warp;
  if (kp >= a.n_kp) return;  // whole warp
  const int* ki = a.kpi + 4 * kp;
  if (ki[3] == 0) {
    zero_slot(a.t, kp, lane, a.angle, a.desc);
    return;  // whole warp
  }
  const int g = ki[0];
  const int w = a.gw[g];
  const size_t off = ((size_t)ki[1] * a.B + ki[2]) * (size_t)a.gh[g] * w;
  describe_slot(a.t, a.lt[g] + off, a.lx[g] + off, a.ly[g] + off, w, a.kpf + 5 * kp,
                smem[warp], lane, kp, a.angle, a.desc);
}

// Kernel 6: one warp per slot of one frame, padded (L, H0, W0) stacks read
// in place (row stride W0; samples clip to the level's own extent).
__global__ void __launch_bounds__(WARPS * 32) describe_single_kernel(SingleArgs a) {
  __shared__ SlotSmem smem[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = blockIdx.x * WARPS + warp;
  if (kp >= a.n_kp) return;  // whole warp
  const int* ki = a.kpi + 2 * kp;
  if (ki[1] == 0) {
    zero_slot(a.t, kp, lane, a.angle, a.desc);
    return;  // whole warp
  }
  const size_t off = (size_t)ki[0] * a.H0 * a.W0;
  describe_slot(a.t, a.lt + off, a.lx + off, a.ly + off, a.W0, a.kpf + 5 * kp, smem[warp],
                lane, kp, a.angle, a.desc);
}

static bool make_tables(Tables& t, const float* ftab, const int* itab, int n_ori, int n_win,
                        int n_samp, int n_cells, int n_bits, int n_words) {
  if (n_ori > MAX_ORI || n_samp > MAX_SAMP || n_cells > MAX_CELLS || n_words > 32) return false;
  t = Tables{ftab, itab, n_ori, n_win, n_samp, n_cells, n_bits, n_words};
  return true;
}

extern "C" int describe(const void* const* planes, const int* gh, const int* gw, int G, int B,
                        int n_kp, const float* kpf, const int* kpi, const float* ftab,
                        const int* itab, int n_ori, int n_win, int n_samp, int n_cells,
                        int n_bits, int n_words, float* angle, int* desc, void* stream) {
  DescArgs a{};
  if (G > MAXG ||
      !make_tables(a.t, ftab, itab, n_ori, n_win, n_samp, n_cells, n_bits, n_words))
    return (int)cudaErrorInvalidValue;
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
  a.angle = angle;
  a.desc = desc;
  if (n_kp == 0) return 0;
  const int blocks = (n_kp + WARPS - 1) / WARPS;
  describe_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int describe_single(const float* lt, const float* lx, const float* ly, int H0, int W0,
                               int n_kp, const float* kpf, const int* kpi, const float* ftab,
                               const int* itab, int n_ori, int n_win, int n_samp, int n_cells,
                               int n_bits, int n_words, float* angle, int* desc, void* stream) {
  SingleArgs a{};
  if (!make_tables(a.t, ftab, itab, n_ori, n_win, n_samp, n_cells, n_bits, n_words))
    return (int)cudaErrorInvalidValue;
  a.lt = lt;
  a.lx = lx;
  a.ly = ly;
  a.H0 = H0;
  a.W0 = W0;
  a.n_kp = n_kp;
  a.kpf = kpf;
  a.kpi = kpi;
  a.angle = angle;
  a.desc = desc;
  if (n_kp == 0) return 0;
  const int blocks = (n_kp + WARPS - 1) / WARPS;
  describe_single_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
