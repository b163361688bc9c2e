// Kernels 3 and 6 of the port: orientation + M-LDB description on Hopper.
//
// Kernel 3 replaces akaze_tpu/kernels/describe_fused.py :: describe_fused
// (_run, _fused_kernel); kernel 6 replaces akaze_tpu/kernels/describe_pallas.py
// :: describe_pallas (_describe_kernel).  The TPU kernels DMA'd an aligned
// patch per keypoint into VMEM and sampled it with one-hot MXU products; here
// the samples are read straight from the level planes in global memory (the
// planes of a batch stay resident in the 50 MB L2).  Both wrappers launch the
// one kernel below: kernel 3 on the per-octave (n, B, h, w) stacks, kernel 6
// on one frame's padded (L, H0, W0) stacks read in place (one "group" of L
// planes, B = 1).
//
// Design.  A block of THREADS threads describes one keypoint slot at a time,
// every phase spread over the whole block, no serial chain longer than a few
// dozen steps:
//   orientation: 109 Lx/Ly samples, one per thread, all loads in flight at
//     once; Cephes atan2 -> angle mod 2 pi;
//   windows: 42 sliding pi/3 windows x WIN_SPLIT sample ranges of
//     ceil(109 / WIN_SPLIT) = 37 samples: 126 tasks of <= 37 steps; warp 0
//     adds each window's range sums in range order and takes the first max
//     (lanes scan their windows in increasing order, then a shuffle tree
//     whose ties keep the lower window);
//   M-LDB: 441 rotated samples of Lt/Lx/Ly, <= 4 per thread, all 12 loads of
//     a thread in flight before the first is used;
//   cell means: each cell's members (sample order) cut into parts of
//     CELL_PART: 50 tasks of <= 25 members x 3 channels (the 2x2 grid's
//     100-member cells in 4 parts, the 3x3 grid's 49 in 2), then per
//     (cell, channel) the part sums added in part order;
//   bits: 486 comparisons over the block, packed by __ballot_sync per warp.
// The sampling tables (kernels/describe.py kernel_table, ~10.5 KB) are copied
// into shared memory once per block with cp.async.
//
// Dead slots: a persistent grid of min(slots, SMs x resident blocks) blocks;
// block b owns slots b, b + grid, b + 2 grid, ... (strided, so the valid
// prefix of every frame spreads over all blocks).  Per round of THREADS owned
// slots each thread reads one slot's fields, dead slots are zeroed there and
// then (one float and four 16-byte stores), and the live ones are compacted
// into a list in shared memory that the block then describes one by one.
//
// What bounds it: neither bytes nor flops (~6 KB of samples and ~31 kflop
// per valid slot; PERF.md) but the scattered sample loads, the window scan
// and the L1 they hit.  The carveout is set for BLOCKS_PER_SM = 8 resident
// blocks: at 9 blocks of 23.5 KB the default carveout (228 KB) leaves 28 KB
// of L1, and the kernel took 0.38 ms at batch-128 VGA against 0.28 ms with
// 8 blocks and ~60 KB of L1; 6 blocks with more L1 gained 2 %, 4 lost 25 %
// (H100 80GB HBM3, 700 W; tools/describe_variants.py, PERF.md).  Hopper's tensor cores have no exact role: the
// sums are float32 and their rounding is part of the result.
//
// Numerics as the reference and the plain twin (kernels/describe.py
// describe_from_samples): the Cephes atan2 polynomial (not atan2f); the
// remainder mod 2 pi takes the divisor's sign; sample coordinates are
// floor(x + off * scale + 0.5) clipped to the level; cosf/sinf; with
// -fmad=false every product and sum rounds on its own.  The twin sums the
// windows and cells in the order described above.
//
// Table layout (int32 words, floats by their bits; kernels/describe.py
// kernel_table):
//   ori_di, ori_dj, ori_w [n_ori] | win_lo, win_hi, win_wrap [n_win] |
//   offk, offl [n_samp] | cell weight [n_cells] | cell_start [n_cells + 1] |
//   cell_first (first task of each cell) [n_cells + 1] | task_cell [n_tasks] |
//   bits (a | b << 16, indices into means[ch * n_cells + cell]) [n_bits] |
//   cell members (sample indices, uint16) [cell_start[n_cells]] | pad to 4.
#include "common.cuh"

#define THREADS 128
#define WARPS (THREADS / 32)
#define BLOCKS_PER_SM 8
#define WIN_SPLIT 3
#define CELL_PART 25
#define MAXG 8
#define MAXL 32
#define MAX_ORI THREADS
#define MAX_WIN 64
#define MAX_SAMP 448
#define MAX_CELLS 32
#define MAX_TASKS 128
#define MAX_TAB 3072
#define GATHER_ROUNDS ((MAX_SAMP + THREADS - 1) / THREADS)
#define FULL 0xffffffffu

#define TWO_PI 6.28318548202514648f  // float32(2 pi)
#define PI_F 3.14159274101257324f    // float32(pi)

struct Sizes {
  int n_ori, n_win, n_samp, n_cells, n_tasks, n_bits, n_words, n_tab;
};

struct DescArgs {
  const float* lt[MAXG];
  const float* lx[MAXG];
  const float* ly[MAXG];
  int gh[MAXG], gw[MAXG];  // plane extent of each group
  // Per level: ratio, sampling scale, clip bounds, group, plane index in it.
  float lv_ratio[MAXL], lv_scale[MAXL], lv_xmax[MAXL], lv_ymax[MAXL];
  int lv_group[MAXL], lv_li[MAXL];
  int B, M, n_kp;  // the n_kp = B * M slots, frame = slot / M
  const float* x;  // keypoint fields, octave-0 pixels
  const float* y;
  const int* lvl;
  const unsigned char* valid;
  const int* tab;  // sampling tables (layout above)
  Sizes s;
  float* angle;
  int* desc;
};

// A live slot: its octave-0 position, slot index and level.
struct Rec {
  float x, y;
  int kp, lvl;
};

struct OriSmem {
  float4 ori[MAX_ORI];                 // rx, ry, angle of each orientation sample
  float2 part[WIN_SPLIT][MAX_WIN];     // window range sums (x, y)
};

struct SlotSmem {
  union {
    OriSmem o;
    float4 smp[MAX_SAMP];  // Lt, rotated Lx, rotated Ly of each M-LDB sample
  } a;
  float cpart[3][MAX_TASKS];
  float mean[3 * MAX_CELLS];
  float cs[2];  // cos, sin of the slot's angle
};

struct TabView {
  const float *ori_di, *ori_dj, *ori_w, *win_lo, *win_hi, *win_wrap, *offk, *offl, *cell_w;
  const int *cell_start, *cell_first, *task_cell, *bits;
  const unsigned short* members;
};

__device__ __forceinline__ TabView tab_view(const int* t, const Sizes& s) {
  TabView v;
  const float* f = reinterpret_cast<const float*>(t);
  v.ori_di = f;
  v.ori_dj = f + s.n_ori;
  v.ori_w = f + 2 * s.n_ori;
  v.win_lo = f + 3 * s.n_ori;
  v.win_hi = v.win_lo + s.n_win;
  v.win_wrap = v.win_hi + s.n_win;
  v.offk = v.win_wrap + s.n_win;
  v.offl = v.offk + s.n_samp;
  v.cell_w = v.offl + s.n_samp;
  v.cell_start = t + 3 * s.n_ori + 3 * s.n_win + 2 * s.n_samp + s.n_cells;
  v.cell_first = v.cell_start + s.n_cells + 1;
  v.task_cell = v.cell_first + s.n_cells + 1;
  v.bits = v.task_cell + s.n_tasks;
  v.members = reinterpret_cast<const unsigned short*>(v.bits + s.n_bits);
  return v;
}

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

__device__ __forceinline__ void zero_slot(const DescArgs& a, int kp) {
  a.angle[kp] = 0.f;
  int* d = a.desc + (size_t)kp * a.s.n_words;
  if ((a.s.n_words & 3) == 0) {
    for (int i = 0; i < a.s.n_words / 4; ++i) reinterpret_cast<int4*>(d)[i] = make_int4(0, 0, 0, 0);
  } else {
    for (int i = 0; i < a.s.n_words; ++i) d[i] = 0;
  }
}

// Orientation + M-LDB of one live slot by the whole block.
__device__ __forceinline__ void describe_slot(const DescArgs& a, const TabView& t, SlotSmem& sm,
                                              const Rec rec, int tid) {
  const Sizes& s = a.s;
  const int lane = tid & 31, warp = tid >> 5;
  const int l = rec.lvl;
  const float ratio = a.lv_ratio[l];
  const float xf = rec.x / ratio, yf = rec.y / ratio;
  const float sc = a.lv_scale[l], xmax = a.lv_xmax[l], ymax = a.lv_ymax[l];
  const int g = a.lv_group[l], w = a.gw[g];
  const size_t off = ((size_t)a.lv_li[l] * a.B + rec.kp / a.M) * (size_t)a.gh[g] * w;
  const float* __restrict__ Lt = a.lt[g] + off;
  const float* __restrict__ Lx = a.lx[g] + off;
  const float* __restrict__ Ly = a.ly[g] + off;

  // Orientation samples, one per thread.
  if (tid < s.n_ori) {
    const size_t p = sample_at(xf, yf, t.ori_di[tid], t.ori_dj[tid], sc, xmax, ymax, w);
    const float vx = t.ori_w[tid] * __ldg(Lx + p);
    const float vy = t.ori_w[tid] * __ldg(Ly + p);
    sm.a.o.ori[tid] = make_float4(vx, vy, mod_2pi(atan2_cephes(vy, vx)), 0.f);
  }
  __syncthreads();

  // Window range sums: task = (range r, window wi), each range summed in
  // sample order from 0.
  const int wlen = (s.n_ori + WIN_SPLIT - 1) / WIN_SPLIT;
  for (int task = tid; task < s.n_win * WIN_SPLIT; task += THREADS) {
    const int r = task / s.n_win, wi = task - r * s.n_win;
    const float lo = t.win_lo[wi], hi = t.win_hi[wi], hi_wrapped = hi - TWO_PI;
    const bool wrap = t.win_wrap[wi] > 0.5f;
    const int k1 = min(s.n_ori, (r + 1) * wlen);
    float sx = 0.f, sy = 0.f;
    for (int k = r * wlen; k < k1; ++k) {
      const float4 o = sm.a.o.ori[k];
      const bool in = wrap ? (o.z > lo || o.z < hi_wrapped) : (o.z > lo && o.z < hi);
      if (in) {  // = adding 0 where out: the sums start at +0 and never turn -0
        sx = sx + o.x;
        sy = sy + o.y;
      }
    }
    sm.a.o.part[r][wi] = make_float2(sx, sy);
  }
  __syncthreads();

  // Warp 0: each window's range sums added in range order, then the first
  // max of |sum|^2 as torch.argmax and jnp.argmax take it: a NaN counts as
  // the largest value, so the first NaN window wins where there is one
  // (lanes scan windows lane, lane + 32, ... in order; the shuffle tree
  // keeps the lower window on ties).
  float angle = 0.f;
  if (warp == 0) {
    float best_n = -1.f, best_x = 0.f, best_y = 0.f;
    int best_i = 1 << 30;
    for (int wi = lane; wi < s.n_win; wi += 32) {
      float sx = sm.a.o.part[0][wi].x, sy = sm.a.o.part[0][wi].y;
      for (int r = 1; r < WIN_SPLIT; ++r) {
        sx = sx + sm.a.o.part[r][wi].x;
        sy = sy + sm.a.o.part[r][wi].y;
      }
      const float nrm = sx * sx + sy * sy;
      if (nrm != nrm ? best_n == best_n : nrm > best_n) {
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
      const bool o_nan = on != on, b_nan = best_n != best_n;
      if (o_nan ? (!b_nan || oi < best_i) : (!b_nan && (on > best_n || (on == best_n && oi < best_i)))) {
        best_n = on;
        best_i = oi;
        best_x = ox;
        best_y = oy;
      }
    }
    if (lane == 0) {
      angle = mod_2pi(atan2_cephes(best_y, best_x));
      sm.cs[0] = cosf(angle);
      sm.cs[1] = sinf(angle);
    }
  }
  __syncthreads();
  const float co = sm.cs[0], si = sm.cs[1];

  // M-LDB samples, gradients rotated into the keypoint frame: every address
  // first, then every load, then the arithmetic.
  size_t p[GATHER_ROUNDS];
#pragma unroll
  for (int q = 0; q < GATHER_ROUNDS; ++q) {
    const int u = tid + q * THREADS;
    p[q] = 0;
    if (u < s.n_samp) {
      const float k = t.offk[u], l2 = t.offl[u];
      const float syo = l2 * co + k * si;
      const float sxo = (-l2) * si + k * co;
      p[q] = sample_at(xf, yf, sxo, syo, sc, xmax, ymax, w);
    }
  }
  float vt[GATHER_ROUNDS], gx[GATHER_ROUNDS], gy[GATHER_ROUNDS];
#pragma unroll
  for (int q = 0; q < GATHER_ROUNDS; ++q) {
    vt[q] = __ldg(Lt + p[q]);
    gx[q] = __ldg(Lx + p[q]);
    gy[q] = __ldg(Ly + p[q]);
  }
#pragma unroll
  for (int q = 0; q < GATHER_ROUNDS; ++q) {
    const int u = tid + q * THREADS;
    if (u < s.n_samp)
      sm.a.smp[u] = make_float4(vt[q], gx[q] * co + gy[q] * si, (-gx[q]) * si + gy[q] * co, 0.f);
  }
  __syncthreads();

  // Cell parts: task = (cell c, part q) sums members q * CELL_PART ... of c
  // in sample order from 0, three channels at once.
  for (int task = tid; task < s.n_tasks; task += THREADS) {
    const int c = t.task_cell[task];
    const int m0 = t.cell_start[c] + (task - t.cell_first[c]) * CELL_PART;
    const int m1 = min(t.cell_start[c + 1], m0 + CELL_PART);
    const float cw = t.cell_w[c];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int m = m0; m < m1; ++m) {
      const float4 v = sm.a.smp[t.members[m]];
      a0 = a0 + v.x * cw;
      a1 = a1 + v.y * cw;
      a2 = a2 + v.z * cw;
    }
    sm.cpart[0][task] = a0;
    sm.cpart[1][task] = a1;
    sm.cpart[2][task] = a2;
  }
  __syncthreads();

  // Cell means: the part sums of (channel, cell) added in part order.
  for (int i = tid; i < 3 * s.n_cells; i += THREADS) {
    const int ch = i / s.n_cells, c = i - ch * s.n_cells;
    const int f0 = t.cell_first[c], f1 = t.cell_first[c + 1];
    float acc = sm.cpart[ch][f0];
    for (int f = f0 + 1; f < f1; ++f) acc = acc + sm.cpart[ch][f];
    sm.mean[i] = acc;
  }
  __syncthreads();

  // Comparisons: bit i -> word i / 32, bit i % 32 (LSB-first bytes,
  // little-endian words); warp w of round b0 packs word b0 / 32 + w.
  for (int b0 = 0; b0 < s.n_words * 32; b0 += THREADS) {
    const int b = b0 + tid;
    bool bit = false;
    if (b < s.n_bits) {
      const int pr = t.bits[b];
      bit = sm.mean[pr & 0xffff] > sm.mean[pr >> 16];  // = (ma - mb > 0): IEEE subtraction is exact in sign
    }
    const unsigned word = __ballot_sync(FULL, bit);
    const int wd = (b0 >> 5) + warp;
    if (lane == 0 && wd < s.n_words) a.desc[(size_t)rec.kp * s.n_words + wd] = (int)word;
  }
  if (tid == 0) a.angle[rec.kp] = angle;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    describe_kernel(const __grid_constant__ DescArgs a) {
  __shared__ __align__(16) int tab_s[MAX_TAB];
  __shared__ __align__(16) SlotSmem sm;
  __shared__ Rec recs[THREADS];
  __shared__ int warp_n[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const int owned = a.n_kp > b ? (a.n_kp - 1 - b) / G + 1 : 0;  // slots b, b + G, ...
  const TabView t = tab_view(tab_s, a.s);
  bool staged = false;
  for (int j0 = 0; j0 < owned; j0 += THREADS) {
    bool live = false;
    Rec r{0.f, 0.f, 0, 0};
    if (j0 + tid < owned) {
      const int kp = b + (j0 + tid) * G;
      live = a.valid[kp] != 0;
      r = Rec{a.x[kp], a.y[kp], kp, a.lvl[kp]};
      if (!live) zero_slot(a, kp);
    }
    const unsigned ball = __ballot_sync(FULL, live);
    if (lane == 0) warp_n[warp] = __popc(ball);
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      base += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (live) recs[base + __popc(ball & ((1u << lane) - 1u))] = r;
    if (total > 0 && !staged) {
      for (int i = 4 * tid; i < a.s.n_tab; i += 4 * THREADS) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(tab_s + i);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(a.tab + i) : "memory");
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      staged = true;
    }
    __syncthreads();
    for (int i = 0; i < total; ++i) describe_slot(a, t, sm, recs[i], tid);
  }
}

// Resident blocks per SM and SM count of the current device, found once,
// after setting the kernel's shared-memory carveout to what BLOCKS_PER_SM
// blocks need (the rest of the SM's 256 KB stays L1).
static int launch_shape(int* sms, int* blocks_per_sm) {
  static int cached_sms[64], cached_bps[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached_sms[dev] == 0) {
    int n = 0, bps = 0, smem_sm = 0, reserved = 0;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, describe_kernel);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (e == cudaSuccess) {
      const long need = (long)BLOCKS_PER_SM * ((long)attr.sharedSizeBytes + reserved);
      const int pct = (int)((100 * need + smem_sm - 1) / smem_sm);
      e = cudaFuncSetAttribute(describe_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               pct < 100 ? pct : 100);
    }
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, describe_kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    cached_bps[dev] = bps;
    cached_sms[dev] = n;
  }
  *sms = cached_sms[dev];
  *blocks_per_sm = cached_bps[dev];
  return 0;
}

// Threads per block, resident blocks per SM, SMs, static shared memory per
// block and registers per thread of describe_kernel on the current device.
extern "C" int describe_occupancy(int* out) {
  int sms = 0, bps = 0;
  const int e = launch_shape(&sms, &bps);
  if (e != 0) return e;
  cudaFuncAttributes attr;
  const cudaError_t ea = cudaFuncGetAttributes(&attr, describe_kernel);
  if (ea != cudaSuccess) return (int)ea;
  out[0] = THREADS;
  out[1] = bps;
  out[2] = sms;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = attr.numRegs;
  return 0;
}

// planes: G x (Lt, Lx, Ly) device pointers of (n_g, B, gh, gw) stacks;
// lv_f: (4, L) ratio, scale, xmax, ymax and lv_i: (2, L) group, plane index
// in the group, per level (host); x, y, lvl, valid: the B * M slots' fields;
// sizes: n_ori, n_win, n_samp, n_cells, n_tasks, n_bits, n_words, n_tab.
// The grid is min(slots, SMs x resident blocks).
extern "C" int describe(const void* const* planes, const int* gh, const int* gw, int G, int B, int M,
                        const float* lv_f, const int* lv_i, int L, const float* x, const float* y,
                        const int* lvl, const unsigned char* valid, const int* tab, const int* sizes,
                        float* angle, int* desc, void* stream) {
  DescArgs a{};
  a.s = Sizes{sizes[0], sizes[1], sizes[2], sizes[3], sizes[4], sizes[5], sizes[6], sizes[7]};
  const Sizes& s = a.s;
  if (G > MAXG || L > MAXL || s.n_ori > MAX_ORI || s.n_win > MAX_WIN || s.n_samp > MAX_SAMP ||
      s.n_cells > MAX_CELLS || s.n_tasks > MAX_TASKS || s.n_tab > MAX_TAB || (s.n_tab & 3) != 0 ||
      s.n_words > 32)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < G; ++g) {
    a.lt[g] = (const float*)planes[3 * g];
    a.lx[g] = (const float*)planes[3 * g + 1];
    a.ly[g] = (const float*)planes[3 * g + 2];
    a.gh[g] = gh[g];
    a.gw[g] = gw[g];
  }
  for (int l = 0; l < L; ++l) {
    a.lv_ratio[l] = lv_f[l];
    a.lv_scale[l] = lv_f[L + l];
    a.lv_xmax[l] = lv_f[2 * L + l];
    a.lv_ymax[l] = lv_f[3 * L + l];
    a.lv_group[l] = lv_i[l];
    a.lv_li[l] = lv_i[L + l];
  }
  a.B = B;
  a.M = M;
  a.n_kp = B * M;
  a.x = x;
  a.y = y;
  a.lvl = lvl;
  a.valid = valid;
  a.tab = tab;
  a.angle = angle;
  a.desc = desc;
  if (a.n_kp == 0) return 0;
  int sms = 0, bps = 0;
  const int e = launch_shape(&sms, &bps);
  if (e != 0) return e;
  const int grid = a.n_kp < sms * bps ? a.n_kp : sms * bps;
  describe_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
