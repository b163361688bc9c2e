// Kernels 1, 2 and 5 of the port: the nonlinear scale space on Hopper.
//
// Kernel 1, base_stage, replaces akaze_tpu/kernels/fed_pallas.py ::
// base_stage_batched (_base_kernel).  For each frame it writes
//   seed = G_sigma0 * img                 (9 taps at sigma0 = 1.6)
//   modg = |Scharr grad (G_1 * img)|      (input of the contrast factor)
// One launch covers the batch on the level chain's machinery below: one
// block of 256 threads per 64x64 output tile (kernels/fed.py BASE_TILE), the
// tile and a 4-px halo clipped to the plane (1.27x the tile at VGA) copied
// into shared memory with cp.async (every copy in flight before the first
// wait), three barriers per tile; each thread walks a run of rows of one
// column, so the vertical passes keep their rows in registers, and the taps
// are written out (blur_v_run / blur_h_run, G_sigma0's tap count a template
// argument).  Its byte floor is 12 B/px (one plane read, two written): 0.14
// ms per batch-128 VGA, against ~0.39 ms measured on the H100 (PERF.md).  It
// is not bound by bytes; by estimate it issues ~150 instructions per pixel,
// ~80 of them flops, but three cuts to them each gained under 3 % while the
// cp.async load gained 8 %, so latency holds it too (not measured: no
// profiler of stalls runs there).  64x64 tiles beat 32x64, 32x128 and 64x128.
//
// Kernel 2, fused_octave, replaces fed_pallas.py :: fused_octave_batched
// (_octave_kernel with with_detect=True, with_half=True).  The TPU kernel
// kept a whole level in VMEM; one SM's 227 KB cannot hold a VGA level
// (1.2 MB), so each level runs as a few launches over the whole batch, each
// block holding one output tile and a halo that covers the launch's whole
// chain in shared memory (temporal blocking, as GPGPU-KAZE fuses the FED
// sweeps):
//   level_diffuse: G_1 blur -> Scharr + conductivity -> all of the level's
//     FED sweeps (halo 3 + sweeps); a plane small enough for shared memory
//     is one tile;
//   level_detect: first Scharr derivatives (Lx, Ly) -> second derivatives
//     -> Ldet -> score + packed sub-pixel field (halo 2s + 1);
// and at the end of the octave a 2x2 half-size launch.  A non-first level
// reads one plane and writes Lt and Lsmooth (diffuse), then reads Lsmooth
// and writes Lx, Ly, score and sub (detect): ~32 B/px against 60 + 12 n_tau
// when each stage was its own launch.  It stays bound by bytes; the halo's
// recomputation costs flops and shared-memory traffic, not device memory.
//
// Kernel 5, fused_level, replaces fed_pallas.py :: fused_level_batched
// (_level_kernel): one level of the per-level build for a batch, seed ->
// Lsmooth, conductivity, the FED sweeps -> Lt, then Lx, Ly and Ldet, all
// four written out (no score, sub-pixel or half-size fields).  It runs the
// same level chain as kernel 2 (level_chain below), so it is bound by bytes
// the same way: one seed read and four planes written is its floor.
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

// ------------------------------------------- tiles with a halo (1, 2, 5)
//
// The level chain of kernels 2 and 5, and kernel 1.  A block owns one
// output tile of one frame and loads its input with a halo of R pixels,
// clipped to the plane: shared-memory row 0
// stands for plane row ty0 = max(0, oy0 - R), and the loaded extent ends at
// the plane border or R past the tile.  Every stage then computes a region
// one stage-radius smaller than the last (for_radius) and reads its
// neighbours clamped to the loaded extent.  Where the extent meets the plane
// border that clamp is the reference's plane clamp; elsewhere the shrinking
// regions never reach the extent's edge, so the tile's centre is the
// reference's value bit for bit; a tile as large as the plane holds the
// whole level.  A plan computed on the host (kernels/fed.py level_plan)
// gives each level its launches: each is {stage, tile rows, tile cols,
// halo, sweeps, threads per block}.  Every launch keeps three planes of its
// extent in shared memory (12 B per loaded pixel).  Each thread walks a run of rows of one
// column (for_runs), so a stage keeps the rows it reuses in registers.
// The level kernels are built once per block size a plan may ask for
// (TILE_THREADS, PLANE_THREADS), each bounded at that size.

#define MAX_LAUNCH_SWEEPS 256
#define SMEM_MAX 232448  // dynamic shared memory of one block on sm_90
#define TILE_THREADS 256
#define PLANE_THREADS 1024
#define STAGE_DIFFUSE 0  // G_1 blur, conductivity, sweeps; writes Lsmooth
#define STAGE_DETECT 1   // derivative cascade, then score + sub (kernel 2) or Ldet (kernel 5)
#define STAGE_LEVEL 2    // STAGE_DIFFUSE and STAGE_DETECT in one launch, Lsmooth kept on chip
#define PLAN_INTS 6

struct Sweeps {
  float ht[MAX_LAUNCH_SWEEPS];  // float32(tau / 2) of each sweep
  int n;
};

// The block's output tile [oy0, oy1) x [ox0, ox1) of the plane and the
// loaded extent [ty0, ty0 + rows) x [tx0, tx0 + cols) around it.
struct Region {
  int oy0, ox0, oy1, ox1, ty0, tx0, rows, cols;
};

__device__ __forceinline__ Region block_region(int h, int w, int th, int tw, int halo) {
  Region g;
  g.oy0 = blockIdx.y * th;
  g.ox0 = blockIdx.x * tw;
  g.oy1 = min(h, g.oy0 + th);
  g.ox1 = min(w, g.ox0 + tw);
  g.ty0 = max(0, g.oy0 - halo);
  g.tx0 = max(0, g.ox0 - halo);
  g.rows = min(h, g.oy1 + halo) - g.ty0;
  g.cols = min(w, g.ox1 + halo) - g.tx0;
  return g;
}

// f(x, ya, yb) over the columns x of [x0, x1), each cut into runs of
// consecutive rows [ya, yb) within [y0, y1): as many runs per column as the
// block has threads for, one run per thread.  Neighbouring threads take
// neighbouring columns (coalesced, free of bank conflicts), and a run lets
// a stage keep what the next row reuses in registers.
template <class F>
__device__ __forceinline__ void for_runs(int y0, int y1, int x0, int x1, F f) {
  const int wd = x1 - x0, ht = y1 - y0;
  if (wd <= 0 || ht <= 0) return;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const int runs = max(1, min(ht, nt / wd));
  const int len = (ht + runs - 1) / runs;
  for (int i = tid; i < runs * wd; i += nt) {
    const int r = i / wd, x = x0 + i - r * wd;
    const int ya = y0 + r * len, yb = min(y1, ya + len);
    if (ya < yb) f(x, ya, yb);
  }
}

// f(x, ya, yb) over the columns x of [x0, x1) and, in each, the rows of
// [y0, y1) of one residue modulo `step`, cut into runs ya, ya + step, ...
// below yb, one run per thread.  A stage that reads rows y - step, y and
// y + step then carries two of its three rows from one row to the next.
template <class F>
__device__ __forceinline__ void for_strided_runs(int y0, int y1, int x0, int x1, int step, F f) {
  const int wd = x1 - x0, ht = y1 - y0;
  if (wd <= 0 || ht <= 0) return;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
  const int lanes = wd * step;               // (residue, column) pairs
  const int per = (ht + step - 1) / step;    // rows of a residue, at most
  const int runs = max(1, min(per, nt / lanes));
  const int len = (per + runs - 1) / runs;   // rows of a run
  for (int i = tid; i < runs * lanes; i += nt) {
    const int r = i / lanes, q = i - r * lanes;
    const int res = q / wd, x = x0 + q - res * wd;
    const int ya = y0 + res + r * len * step;
    if (ya < y1) f(x, ya, min(y1, ya + len * step));
  }
}

// f(y, x) for y in [y0, y1), x in [x0, x1), run by run.
template <class F>
__device__ __forceinline__ void for_rect(int y0, int y1, int x0, int x1, F f) {
  for_runs(y0, y1, x0, x1, [&](int x, int ya, int yb) {
    for (int y = ya; y < yb; ++y) f(y, x);
  });
}

// f(y, x) over the tile grown by ry rows and rx columns, clipped to the
// extent; (y, x) are shared-memory coordinates.
template <class F>
__device__ __forceinline__ void for_radius(const Region& g, int ry, int rx, F f) {
  for_rect(max(0, g.oy0 - ry - g.ty0), min(g.rows, g.oy1 + ry - g.ty0),
           max(0, g.ox0 - rx - g.tx0), min(g.cols, g.ox1 + rx - g.tx0), f);
}

// The same rectangle as runs f(x, ya, yb).
template <class F>
__device__ __forceinline__ void for_radius_runs(const Region& g, int r, F f) {
  for_runs(max(0, g.oy0 - r - g.ty0), min(g.rows, g.oy1 + r - g.ty0),
           max(0, g.ox0 - r - g.tx0), min(g.cols, g.ox1 + r - g.tx0), f);
}

// The extent of plane p at the block's frame into s (row stride g.cols),
// copied with cp.async: each thread has all its copies in flight before it
// waits for any.  They are complete before the caller's barrier.
__device__ __forceinline__ void load_extent(const float* __restrict__ p, float* s, const Region& g,
                                            int w) {
  for_rect(0, g.rows, 0, g.cols, [&](int y, int x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(s + y * g.cols + x);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(p + (size_t)(g.ty0 + y) * w + g.tx0 + x)
                 : "memory");
  });
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The scaled Scharr derivatives at half-width s, as the stages below write
// them out (u, m, d: rows y - s, y, y + s; l, r: columns x - s, x + s; all
// clamped to the plane):
//   along x: (-(((sn * ul) + (swn * ml)) + (sn * dl))) + (((sn * ur) + (swn * mr)) + (sn * dr))
//   along y: ((sn * ((-ul) + dl)) + (swn * ((-um) + dm))) + (sn * ((-ur) + dr))
// the reference's vertical pass first, then the horizontal one.

// kind: 0 = PM_G1, 1 = PM_G2, 2 = Weickert (Diffusivity enum order).
__device__ __forceinline__ float conductivity(float gx, float gy, float k, int kind) {
  const float grad2 = (gx * gx + gy * gy) / (k * k);
  if (kind == 1) return 1.f / (1.f + grad2);
  if (kind == 0) return expf(-grad2);
  float g4 = grad2 * grad2;
  g4 = g4 * g4;
  const float safe = g4 > 0.f ? g4 : 1.f;
  return grad2 > 0.f ? 1.f - expf(-3.315f / safe) : 1.f;
}

// The passes of an N-tap separable blur (N odd, no zero tap: the host
// checks), written out: taps summed left to right, first term not added to
// zero, as the reference's filter_1d.  The vertical pass of rows [ya, yb) of
// column x of a (rows x cols, clamped at its border) into v keeps the N rows
// it reads in registers.
template <int N>
__device__ __forceinline__ void blur_v_run(const float* __restrict__ a, float* __restrict__ v,
                                           const Taps& t, int x, int ya, int yb, int rows, int cols) {
  constexpr int R = N / 2;
  float r[N];
#pragma unroll
  for (int k = 0; k < N - 1; ++k) r[k] = a[clampi(ya - R + k, 0, rows - 1) * cols + x];
  for (int y = ya; y < yb; ++y) {
    r[N - 1] = a[min(y + R, rows - 1) * cols + x];
    float acc = t.w[0] * r[0];
#pragma unroll
    for (int k = 1; k < N; ++k) acc = acc + t.w[k] * r[k];
    v[y * cols + x] = acc;
#pragma unroll
    for (int k = 0; k < N - 1; ++k) r[k] = r[k + 1];
  }
}

// The horizontal pass of rows [ya, yb) of column x of v (cols wide, clamped
// at its border) into out, whose rows are `os` floats apart.
template <int N>
__device__ __forceinline__ void blur_h_run(const float* __restrict__ v, float* __restrict__ out, int os,
                                           const Taps& t, int x, int ya, int yb, int cols) {
  constexpr int R = N / 2;
  int xs[N];
#pragma unroll
  for (int k = 0; k < N; ++k) xs[k] = clampi(x - R + k, 0, cols - 1);
  for (int y = ya; y < yb; ++y) {
    const float* r = v + y * cols;
    float acc = t.w[0] * r[xs[0]];
#pragma unroll
    for (int k = 1; k < N; ++k) acc = acc + t.w[k] * r[xs[k]];
    out[y * os + x] = acc;
  }
}

// The sigma-1 Scharr gradient of rows [ya, yb) of column x of c (rows x
// cols, clamped at its border), read through a window of three rows kept in
// registers: f(y, gx, gy) for each row.
template <class F>
__device__ __forceinline__ void scharr1_run(const float* __restrict__ c, int x, int ya, int yb, int rows,
                                            int cols, float sn, float swn, F f) {
  const int xl = max(x - 1, 0), xr = min(x + 1, cols - 1);
  const float* u = c + max(ya - 1, 0) * cols;
  const float* m = c + ya * cols;
  float ul = u[xl], um = u[x], ur = u[xr];
  float ml = m[xl], mm = m[x], mr = m[xr];
  for (int y = ya; y < yb; ++y) {
    const float* d = c + min(y + 1, rows - 1) * cols;
    const float dl = d[xl], dm = d[x], dr = d[xr];
    const float vl = ((sn * ul) + (swn * ml)) + (sn * dl);
    const float vr = ((sn * ur) + (swn * mr)) + (sn * dr);
    const float gx = (-vl) + vr;
    const float el = (-ul) + dl, em = (-um) + dm, er = (-ur) + dr;
    const float gy = ((sn * el) + (swn * em)) + (sn * er);
    f(y, gx, gy);
    ul = ml; um = mm; ur = mr;
    ml = dl; mm = dm; mr = dr;
  }
}

// ---------------------------------------------------------------- kernel 1
//
// One block per output tile of one frame, loaded with a halo clipped to the
// plane (block_region, as the level chain).  Each stage computes the region
// the next one reads and clamps its neighbours to the extent: G_sigma0's
// vertical pass on the tile's rows, G_1's on the tile grown by 1 row and 3
// columns (the Scharr reads 1 around the tile, the horizontal G_1 pass 2
// more), so a halo of max(N / 2, 3) is exact.  Shared memory: the extent of
// the image (then G_1 * img), and the vertical passes of G_sigma0 and G_1.
// The G_sigma0 tap count N is a template argument, dispatched on the host.
template <int N>
__global__ void __launch_bounds__(TILE_THREADS)
    base_stage_kernel(const float* __restrict__ img, float* __restrict__ seed, float* __restrict__ modg,
                      int H, int W, int th, int tw, int halo, Taps g0, Taps g1, float sn, float swn) {
  extern __shared__ float sm[];
  const Region g = block_region(H, W, th, tw, halo);
  const int rows = g.rows, cols = g.cols, n = rows * cols;
  float* a = sm;
  float* v0 = sm + n;
  float* v1 = sm + 2 * n;
  const size_t plane = (size_t)blockIdx.z * H * W;
  load_extent(img + plane, a, g, W);
  __syncthreads();
  constexpr int R = N / 2;
  const int cy0 = g.oy0 - g.ty0, cy1 = g.oy1 - g.ty0, cx0 = g.ox0 - g.tx0, cx1 = g.ox1 - g.tx0;
  for_runs(cy0, cy1, max(0, cx0 - R), min(cols, cx1 + R),
           [&](int x, int ya, int yb) { blur_v_run<N>(a, v0, g0, x, ya, yb, rows, cols); });
  for_runs(max(0, cy0 - 1), min(rows, cy1 + 1), max(0, cx0 - 3), min(cols, cx1 + 3),
           [&](int x, int ya, int yb) { blur_v_run<5>(a, v1, g1, x, ya, yb, rows, cols); });
  __syncthreads();
  const size_t at = plane + (size_t)g.ty0 * W + g.tx0;  // the extent's origin in the batch
  for_radius_runs(g, 0, [&](int x, int ya, int yb) { blur_h_run<N>(v0, seed + at, W, g0, x, ya, yb, cols); });
  for_radius_runs(g, 1, [&](int x, int ya, int yb) { blur_h_run<5>(v1, a, cols, g1, x, ya, yb, cols); });
  __syncthreads();
  for_radius_runs(g, 0, [&](int x, int ya, int yb) {
    scharr1_run(a, x, ya, yb, rows, cols, sn, swn, [&](int y, float gx, float gy) {
      modg[at + (size_t)y * W + x] = sqrtf(gx * gx + gy * gy);
    });
  });
}

// base_stage_kernel for each tap count of G_sigma0, at index N / 2.
static void (*const base_stage_kernels[])(const float*, float*, float*, int, int, int, int, int, Taps, Taps, float,
                                          float) = {base_stage_kernel<1>, base_stage_kernel<3>, base_stage_kernel<5>,
                                                    base_stage_kernel<7>, base_stage_kernel<9>};

// One explicit FED sweep of rows [ya, yb) of column x:
//   nxt = cur + ht * sum_n (g_c + g_n)(cur_n - cur_c)  over E, W, S, N,
// the centre and north values of L and g carried from row to row.
__device__ __forceinline__ void sweep_run(const float* __restrict__ cur, const float* __restrict__ gb,
                                          float* __restrict__ nxt, int x, int ya, int yb, int rows,
                                          int cols, float ht) {
  const int de = min(x + 1, cols - 1) - x, dw = max(x - 1, 0) - x;
  int i = ya * cols + x;
  const int up = ya > 0 ? cols : 0;
  float ln = cur[i - up], gn = gb[i - up], lc = cur[i], gc = gb[i];
  for (int y = ya; y < yb; ++y, i += cols) {
    const int ds = y + 1 < rows ? cols : 0;
    const float ls = cur[i + ds], gs = gb[i + ds];
    const float le = cur[i + de], lw = cur[i + dw];
    const float step = (((gc + gb[i + de]) * (le - lc) + (gc + gb[i + dw]) * (lw - lc)) +
                        (gc + gs) * (ls - lc)) +
                       (gc + gn) * (ln - lc);
    nxt[i] = lc + ht * step;
    ln = lc;
    gn = gc;
    lc = ls;
    gc = gs;
  }
}

// The larger of a and b, NaN where either is NaN, as torch.maximum and
// jnp.maximum take it (fmaxf alone drops a NaN operand, so a pixel beside a
// NaN region could pass as a local maximum).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// Strict 3x3-max candidate score (-3e38 elsewhere) and the packed 2-variable
// sub-pixel fit: qx * 65536 + qy with q = rint((clip(o, -1, 1) + 1) * 16000),
// or -1 for a rejected fit (kernels/fed_pallas.py pack_sub), of Ldet v and
// its eight neighbours (n = north, s = south, e = east, w = west).
__device__ __forceinline__ void score_px(float v, float n_e, float n_w, float n_s, float n_n,
                                         float n_se, float n_nw, float n_ne, float n_sw,
                                         bool interior, float thr, float* score, int* sub) {
  float nmax = nan_max(n_e, n_w);
  nmax = nan_max(nmax, nan_max(n_s, n_n));
  nmax = nan_max(nmax, nan_max(n_se, n_nw));
  nmax = nan_max(nmax, nan_max(n_ne, n_sw));
  const bool cand = interior && v > thr && v > nmax;
  *score = cand ? v : -3.0e38f;

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
  *sub = keep ? qx * 65536 + qy : -1;
}

// score_px over rows [ya, yb) of column x of Ldet p (shared memory; row 0
// is plane row ty0, column 0 plane column tx0), the 3x3 window kept in
// registers; writes the plane's score and sub at frame offset `plane`.
__device__ __forceinline__ void score_run(const float* __restrict__ p, float* __restrict__ score,
                                          int* __restrict__ sub, int x, int ya, int yb, int rows,
                                          int cols, int ty0, int tx0, size_t plane, int h, int w,
                                          int border, float thr) {
  const int xe = min(x + 1, cols - 1), xw = max(x - 1, 0), gx = tx0 + x;
  const bool in_x = gx >= border && gx < w - border;
  const float* n = p + max(ya - 1, 0) * cols;
  const float* c = p + ya * cols;
  float nw = n[xw], nm = n[x], ne = n[xe];
  float cw = c[xw], cm = c[x], ce = c[xe];
  for (int y = ya; y < yb; ++y) {
    const float* d = p + min(y + 1, rows - 1) * cols;  // the south row
    const float dw = d[xw], dm = d[x], de = d[xe];
    const int gy = ty0 + y;
    const size_t o = plane + (size_t)gy * w + gx;
    score_px(cm, ce, cw, dm, nm, de, nw, ne, dw, in_x && gy >= border && gy < h - border, thr,
             score + o, sub + o);
    nw = cw; nm = cm; ne = ce;
    cw = dw; cm = dm; ce = de;
  }
}

// Where a level's detector cascade writes, and its Scharr size and taps.
// score set: kernel 2's score and sub; else kernel 5's Ldet.  lt_copy set
// (the first level): the Lsmooth tile, which is the seed, goes to Lt too.
struct DetectArgs {
  float *lt_copy, *lx, *ly, *ldet, *score;
  int* sub;
  int s, border;
  float sn, swn, thr;
};

// One tile's detector cascade from Lsmooth a (shared memory, valid at
// radius >= 2s + 1; overwritten with Ldet), lxr and lyr its scratch planes:
// raw Lx, Ly at radius s + 1, Lxx, Lyy, Lxy and Ldet at radius 1, then the
// score and sub (or Ldet) of the tile.  Writes s * Lx and s * Ly.
__device__ void detect_tile(float* a, float* lxr, float* lyr, const Region& g, int h, int w,
                            size_t plane, const DetectArgs& d) {
  const int rows = g.rows, cols = g.cols;
  const int cy0 = g.oy0 - g.ty0, cx0 = g.ox0 - g.tx0, cy1 = g.oy1 - g.ty0, cx1 = g.ox1 - g.tx0;
  const auto at = [&](int y, int x) { return plane + (size_t)(g.ty0 + y) * w + g.tx0 + x; };
  const int s = d.s;
  const float sn = d.sn, swn = d.swn, sf = (float)s, s2 = (float)(s * s);
  // Raw Lx, Ly (Scharr of Lsmooth) at radius s + 1, rows y - s, y and y + s
  // carried along the run; the tile also gets s * Lx, s * Ly.
  const auto rect = [&](int r, int step, auto run) {
    for_strided_runs(max(0, g.oy0 - r - g.ty0), min(rows, g.oy1 + r - g.ty0),
                     max(0, g.ox0 - r - g.tx0), min(cols, g.ox1 + r - g.tx0), step, run);
  };
  rect(s + 1, s, [&](int x, int ya, int yb) {
    const int xl = max(x - s, 0), xr = min(x + s, cols - 1);
    const bool in_x = x >= cx0 && x < cx1;
    const float* u = a + max(ya - s, 0) * cols;
    const float* m = a + ya * cols;
    float ul = u[xl], um = u[x], ur = u[xr], ml = m[xl], mm = m[x], mr = m[xr];
    for (int y = ya; y < yb; y += s) {
      const float* down = a + min(y + s, rows - 1) * cols;
      const float dl = down[xl], dm = down[x], dr = down[xr];
      const float vl = ((sn * ul) + (swn * ml)) + (sn * dl);
      const float vr = ((sn * ur) + (swn * mr)) + (sn * dr);
      const float lx = (-vl) + vr;
      const float el = (-ul) + dl, em = (-um) + dm, er = (-ur) + dr;
      const float ly = ((sn * el) + (swn * em)) + (sn * er);
      const int i = y * cols + x;
      lxr[i] = lx;
      lyr[i] = ly;
      if (in_x && y >= cy0 && y < cy1) {
        const size_t o = at(y, x);
        d.lx[o] = lx * sf;
        d.ly[o] = ly * sf;
        if (d.lt_copy != nullptr) d.lt_copy[o] = mm;
      }
      ul = ml; um = mm; ur = mr;
      ml = dl; mm = dm; mr = dr;
    }
  });
  __syncthreads();
  // Ldet at radius 1 from Lxx (Scharr along x of Lx), Lyy (along y of Ly)
  // and Lxy (along y of Lx), the same three rows of each carried.
  rect(1, s, [&](int x, int ya, int yb) {
    const int xl = max(x - s, 0), xr = min(x + s, cols - 1);
    const float* pu = lxr + max(ya - s, 0) * cols;
    const float* pm = lxr + ya * cols;
    const float* qu = lyr + max(ya - s, 0) * cols;
    const float* qm = lyr + ya * cols;
    float pul = pu[xl], pum = pu[x], pur = pu[xr], pml = pm[xl], pmm = pm[x], pmr = pm[xr];
    float qul = qu[xl], qum = qu[x], qur = qu[xr], qml = qm[xl], qmm = qm[x], qmr = qm[xr];
    for (int y = ya; y < yb; y += s) {
      const int yd = min(y + s, rows - 1) * cols;
      const float pdl = lxr[yd + xl], pdm = lxr[yd + x], pdr = lxr[yd + xr];
      const float qdl = lyr[yd + xl], qdm = lyr[yd + x], qdr = lyr[yd + xr];
      const float vl = ((sn * pul) + (swn * pml)) + (sn * pdl);
      const float vr = ((sn * pur) + (swn * pmr)) + (sn * pdr);
      const float lxx = (-vl) + vr;
      const float lyy = ((sn * ((-qul) + qdl)) + (swn * ((-qum) + qdm))) + (sn * ((-qur) + qdr));
      const float lxy = ((sn * ((-pul) + pdl)) + (swn * ((-pum) + pdm))) + (sn * ((-pur) + pdr));
      a[y * cols + x] = (lxx * s2) * (lyy * s2) - (lxy * s2) * (lxy * s2);
      pul = pml; pum = pmm; pur = pmr;
      pml = pdl; pmm = pdm; pmr = pdr;
      qul = qml; qum = qmm; qur = qmr;
      qml = qdl; qmm = qdm; qmr = qdr;
    }
  });
  __syncthreads();
  if (d.score != nullptr)
    for_radius_runs(g, 0, [&](int x, int ya, int yb) {
      score_run(a, d.score, d.sub, x, ya, yb, rows, cols, g.ty0, g.tx0, plane, h, w, d.border, d.thr);
    });
  else
    for_radius(g, 0, 0, [&](int y, int x) { d.ldet[at(y, x)] = a[y * cols + x]; });
}

// One level's diffusion for one output tile.  STAGE_DIFFUSE: Lsmooth =
// G_1 * src at radius ns + 1, g at radius ns, then ns explicit FED sweeps,
// each on a region one pixel smaller; needs halo >= ns + 3.  Writes the
// tile of Lsmooth and of the last sweep's L into dst.  STAGE_LEVEL (dt.lx
// set): the same, with Lsmooth at radius max(ns + 1, 2s + 1) kept in a
// fourth plane (halo >= 2s + 3 too) for the detector cascade of the tile,
// run last; Lsmooth is not written.  Shared memory: the level's L, g
// (first the vertical blur pass) and Lsmooth, which then takes the sweeps'
// other half of the ping-pong (STAGE_LEVEL: a fourth plane holds Lsmooth).
template <int NT>
__global__ void __launch_bounds__(NT)
    level_diffuse_kernel(const float* __restrict__ src, const float* __restrict__ kf,
                         float* __restrict__ dst, float* __restrict__ ls_out, int h, int w,
                         int th, int tw, int halo, Sweeps sw, Taps t1, float s1n, float s1wn,
                         int kind, DetectArgs dt) {
  extern __shared__ float sm[];
  const Region g = block_region(h, w, th, tw, halo);
  const int rows = g.rows, cols = g.cols, ns = sw.n, n = rows * cols;
  const bool fused = dt.lx != nullptr;
  float* a = sm;
  float* gb = sm + n;
  float* c = sm + 2 * n;
  float* ls = fused ? sm + 3 * n : c;
  const size_t plane = (size_t)blockIdx.z * h * w;
  load_extent(src + plane, a, g, w);
  __syncthreads();
  const auto at = [&](int y, int x) { return plane + (size_t)(g.ty0 + y) * w + g.tx0 + x; };
  const int rb = fused ? max(ns + 1, 2 * dt.s + 1) : ns + 1;
  // G_1 blur, vertical pass first (the golden order).
  for_runs(max(0, g.oy0 - rb - g.ty0), min(rows, g.oy1 + rb - g.ty0),
           max(0, g.ox0 - rb - 2 - g.tx0), min(cols, g.ox1 + rb + 2 - g.tx0),
           [&](int x, int ya, int yb) { blur_v_run<5>(a, gb, t1, x, ya, yb, rows, cols); });
  __syncthreads();
  for_radius_runs(g, rb, [&](int x, int ya, int yb) { blur_h_run<5>(gb, ls, cols, t1, x, ya, yb, cols); });
  __syncthreads();
  const float k = kf[blockIdx.z];
  for_radius_runs(g, ns, [&](int x, int ya, int yb) {
    scharr1_run(ls, x, ya, yb, rows, cols, s1n, s1wn,
                [&](int y, float gx, float gy) { gb[y * cols + x] = conductivity(gx, gy, k, kind); });
  });
  if (!fused) for_radius(g, 0, 0, [&](int y, int x) { ls_out[at(y, x)] = ls[y * cols + x]; });
  __syncthreads();
  float* cur = a;
  float* nxt = c;
  for (int j = 0; j < ns; ++j) {
    const float ht = sw.ht[j];
    for_radius_runs(g, ns - 1 - j, [&](int x, int ya, int yb) {
      sweep_run(cur, gb, nxt, x, ya, yb, rows, cols, ht);
    });
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for_radius(g, 0, 0, [&](int y, int x) { dst[at(y, x)] = cur[y * cols + x]; });
  if (fused) detect_tile(ls, gb, nxt, g, h, w, plane, dt);
}

// One level's detector cascade for one output tile, from Lsmooth with halo
// >= 2s + 1 (detect_tile).  Shared memory: Lsmooth (then Ldet), raw Lx,
// raw Ly.
__global__ void __launch_bounds__(TILE_THREADS)
    level_detect_kernel(const float* __restrict__ ls, DetectArgs d, int h, int w, int th, int tw,
                        int halo) {
  extern __shared__ float sm[];
  const Region g = block_region(h, w, th, tw, halo);
  const int n = g.rows * g.cols;
  const size_t plane = (size_t)blockIdx.z * h * w;
  load_extent(ls + plane, sm, g, w);
  __syncthreads();
  detect_tile(sm, sm + n, sm + 2 * n, g, h, w, plane, d);
}

__device__ __forceinline__ float ld(const float* p, int y, int x, int w) {
  return __ldg(p + (size_t)y * w + x);
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

static int imin(int a, int b) { return a < b ? a : b; }

struct PlanLaunch {
  int stage, th, tw, halo, sweeps, threads;
};

// Three planes of the loaded extent, four for STAGE_LEVEL.
static size_t launch_smem(const PlanLaunch& p, int h, int w) {
  return (p.stage == STAGE_LEVEL ? 4 : 3) * sizeof(float) * (size_t)imin(h, p.th + 2 * p.halo) *
         (size_t)imin(w, p.tw + 2 * p.halo);
}

// Whether the launches of one level form a chain the kernels can run: the
// first level one detect launch; any other a level launch (diffuse and
// detect), or a diffuse launch then a detect launch; each with the halo its
// stages need, a block size it was built for, and all ns sweeps.
static bool plan_ok(const PlanLaunch* p, int nl, int h, int w, bool first, int ns, int s) {
  if (nl != 1 && (first || nl != 2)) return false;
  for (int i = 0; i < nl; ++i) {
    const PlanLaunch& l = p[i];
    const int want = first || i == 1 ? STAGE_DETECT : nl == 1 ? STAGE_LEVEL : STAGE_DIFFUSE;
    if (l.stage != want || l.th < 1 || l.tw < 1 || launch_smem(l, h, w) > SMEM_MAX) return false;
    if (l.stage == STAGE_DETECT) {
      if (l.halo < 2 * s + 1 || l.sweeps != 0 || l.threads != TILE_THREADS) return false;
      continue;
    }
    const int need = l.stage == STAGE_LEVEL && 2 * s + 3 > ns + 3 ? 2 * s + 3 : ns + 3;
    if (l.halo < need || l.sweeps != ns || ns > MAX_LAUNCH_SWEEPS) return false;
    if (l.threads != TILE_THREADS && l.threads != PLANE_THREADS) return false;
  }
  return true;
}

// Lets each tile kernel take SMEM_MAX bytes of dynamic shared memory, once
// per device.
static int set_smem_limits() {
  static bool done[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaFuncSetAttribute(level_diffuse_kernel<TILE_THREADS>, attr, SMEM_MAX);
    cudaFuncSetAttribute(level_diffuse_kernel<PLANE_THREADS>, attr, SMEM_MAX);
    cudaFuncSetAttribute(level_detect_kernel, attr, SMEM_MAX);
    for (auto* kernel : base_stage_kernels) cudaFuncSetAttribute(kernel, attr, SMEM_MAX);
    AKAZE_RETURN_IF_ERROR();
    done[dev] = true;
  }
  return 0;
}

static dim3 plan_grid(const PlanLaunch& p, int B, int h, int w) {
  return dim3((w + p.tw - 1) / p.tw, (h + p.th - 1) / p.th, B);
}

static dim3 plan_block(const PlanLaunch& p) { return dim3(32, p.threads / 32); }

static Taps make_taps(const float* taps, int n) {
  Taps t{};
  for (int i = 0; i < n; ++i) t.w[i] = taps[i];
  t.n = n;
  return t;
}

static bool taps_nonzero(const Taps& t) {
  for (int i = 0; i < t.n; ++i)
    if (t.w[i] == 0.f) return false;
  return true;
}

// The chain of one level for the whole batch (kernels 2 and 5 share it),
// following its plan: Lt from `src` (the first level: the seed itself, no
// FED) through the diffuse (or level) launch; then, unless the level
// launch ran it, the detect launch from Lsmooth (the seed on the first
// level, which it also copies into lt).  score set: kernel 2's score and
// sub; else kernel 5's Ldet.
static int level_chain(const float* src, const float* k, float* lt, float* lx, float* ly,
                       float* ldet, float* score, int* sub, float* lsmooth, int B, int h, int w,
                       bool first, int kind, int ns, const float* half_taus, int s, float sn,
                       float swn, int border, float thr, const Taps& t1, float s1n, float s1wn,
                       const int* plan, int nl, cudaStream_t st, int* n_launched) {
  const PlanLaunch* p = reinterpret_cast<const PlanLaunch*>(plan);
  if (!plan_ok(p, nl, h, w, first, ns, s)) return (int)cudaErrorInvalidValue;
  const bool fused = p[0].stage == STAGE_LEVEL;
  if (!first && !fused && lsmooth == nullptr) return (int)cudaErrorInvalidValue;
  if (t1.n != 5 || !taps_nonzero(t1)) return (int)cudaErrorInvalidValue;  // blur_*_run<5>
  const int rc = set_smem_limits();
  if (rc) return rc;
  const DetectArgs dt{first ? lt : nullptr, lx, ly, ldet, score, sub, s, border, sn, swn, thr};
  if (!first) {
    const PlanLaunch& d = p[0];
    Sweeps sw{};
    sw.n = ns;
    for (int j = 0; j < ns; ++j) sw.ht[j] = half_taus[j];
    const DetectArgs none{};
    auto* kernel = d.threads == PLANE_THREADS ? level_diffuse_kernel<PLANE_THREADS>
                                              : level_diffuse_kernel<TILE_THREADS>;
    kernel<<<plan_grid(d, B, h, w), plan_block(d), launch_smem(d, h, w), st>>>(
        src, k, lt, lsmooth, h, w, d.th, d.tw, d.halo, sw, t1, s1n, s1wn, kind, fused ? dt : none);
    AKAZE_RETURN_IF_ERROR();
    ++*n_launched;
  }
  if (!fused) {
    const PlanLaunch& d = p[nl - 1];
    level_detect_kernel<<<plan_grid(d, B, h, w), plan_block(d), launch_smem(d, h, w), st>>>(
        first ? src : lsmooth, dt, h, w, d.th, d.tw, d.halo);
    AKAZE_RETURN_IF_ERROR();
    ++*n_launched;
  }
  return 0;
}

// ---------------------------------------------------------------- kernel 1

// img (B, H, W) -> seed, modg (B, H, W).  g0[n0]: the G_sigma0 taps (odd n0
// <= 9, none zero: the host drops zero end taps); g1[n1]: the G_1 taps (5);
// sn, swn: the sigma-1 Scharr smoothing taps; (th, tw) the output tile and
// halo >= max(n0 / 2, 3) its halo.
extern "C" int base_stage(const float* img, float* seed, float* modg, int B, int H, int W,
                          const float* g0, int n0, const float* g1, int n1, float sn, float swn,
                          int th, int tw, int halo, void* stream) {
  if (n0 < 1 || n0 > MAXTAPS || n0 % 2 == 0 || n1 != 5 || th < 1 || tw < 1 || halo < 3 ||
      halo < n0 / 2)
    return (int)cudaErrorInvalidValue;
  const Taps t0 = make_taps(g0, n0), t1 = make_taps(g1, n1);
  if (!taps_nonzero(t0) || !taps_nonzero(t1)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const size_t smem = 3 * sizeof(float) * (size_t)imin(H, th + 2 * halo) * (size_t)imin(W, tw + 2 * halo);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int rc = set_smem_limits();
  if (rc) return rc;
  const dim3 grd((W + tw - 1) / tw, (H + th - 1) / th, B), blk(32, TILE_THREADS / 32);
  base_stage_kernels[n0 / 2]<<<grd, blk, smem, (cudaStream_t)stream>>>(img, seed, modg, H, W, th, tw, halo,
                                                                       t0, t1, sn, swn);
  return (int)cudaGetLastError();
}

// One octave for the whole batch.  Outputs are level-major (n, B, h, w);
// lsmooth is a (B, h, w) scratch plane for a plan with a separate detect
// launch past the first level (else null).  Per-level tables are host arrays:
// n_sweeps[n], half_taus[sum n_sweeps] (float32(tau/2), level by level),
// sigma_sizes[n], sn[n], swn[n] (Scharr smoothing taps at that size),
// borders[n]; plan_counts[n] launches per level and plan[6 * sum
// plan_counts] their {stage, tile rows, tile cols, halo, sweeps, threads}.
// g1/s1n/s1wn are the G_1 taps and the sigma-1 Scharr taps.  *n_launched
// receives the number of __global__ launches.
extern "C" int fused_octave(const float* seed, const float* k, float* lt, float* lx, float* ly,
                            float* score, int* sub, float* half, float* lsmooth, int B, int h,
                            int w, int n, int first, int kind,
                            const int* n_sweeps, const float* half_taus, const int* sigma_sizes,
                            const float* sn, const float* swn, const int* borders, float threshold,
                            const float* g1, int n1, float s1n, float s1wn, const int* plan_counts,
                            const int* plan, int* n_launched, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Taps t1 = make_taps(g1, n1);
  const size_t pl = (size_t)B * h * w;
  *n_launched = 0;
  int tau_at = 0, plan_at = 0;
  for (int li = 0; li < n; ++li) {
    const float* src = li == 0 ? seed : lt + (li - 1) * pl;
    const bool first_level = first && li == 0;
    const int ns = first_level ? 0 : n_sweeps[li];
    const int rc = level_chain(src, k, lt + li * pl, lx + li * pl, ly + li * pl, nullptr,
                               score + li * pl, sub + li * pl, lsmooth, B, h, w,
                               first_level, kind, ns, half_taus + tau_at, sigma_sizes[li], sn[li],
                               swn[li], borders[li], threshold, t1, s1n, s1wn,
                               plan + PLAN_INTS * plan_at, plan_counts[li], st, n_launched);
    if (rc) return rc;
    tau_at += ns;
    plan_at += plan_counts[li];
  }
  if (half != nullptr) {
    dim3 hg((w / 2 + 31) / 32, (h / 2 + 7) / 8, B);
    half_kernel<<<hg, dim3(32, 8), 0, st>>>(lt + (n - 1) * pl, half, h, w);
    ++*n_launched;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- kernel 5

// One level for the whole batch: seed (B, h, w) -> Lt, Lx, Ly, Ldet, each
// (B, h, w).  half_taus[ns] are float32(tau/2) of this level's sweeps; s,
// sn, swn its Scharr size and smoothing taps; plan[6 * nl] its launches.
// Scratch lsmooth as for fused_octave.  *n_launched receives the number of
// __global__ launches.
extern "C" int fused_level(const float* seed, const float* k, float* lt, float* lx, float* ly,
                           float* ldet, float* lsmooth, int B, int h, int w, int first, int kind,
                           int ns, const float* half_taus, int s, float sn, float swn,
                           const float* g1, int n1, float s1n, float s1wn, const int* plan, int nl,
                           int* n_launched, void* stream) {
  *n_launched = 0;
  const int rc = level_chain(seed, k, lt, lx, ly, ldet, nullptr, nullptr, lsmooth, B, h, w,
                             first != 0, kind, first ? 0 : ns, half_taus, s, sn, swn, 0, 0.f,
                             make_taps(g1, n1), s1n, s1wn, plan, nl, (cudaStream_t)stream,
                             n_launched);
  return rc ? rc : (int)cudaGetLastError();
}
