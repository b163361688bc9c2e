// The contrast factor of a batch of |grad| planes in two launches per call.
//
// Replaces no TPU kernel: the JAX package computes the factor in plain jnp
// (akaze_tpu/frontend/scale_space.py compute_contrast_factor, a coarse and a
// fine count with no scatter), and the port ran it as ~52 PyTorch ops per
// call (frontend/scale_space.py contrast_factor_from_modg: an int64 key per
// interior pixel, a masked select that syncs the host, torch.bincount into
// B x nbins bins in device memory, a cumulative sum).
//
// Semantics (contrast_factor_from_modg on the card, bit for bit).  For each
// frame of modg (B, H, W), over its interior m = modg[1:-1, 1:-1]:
//   hmax = max(m), NaN if any pixel is NaN; safe = hmax > 0 ? hmax : 1;
//   each pixel with m > 0 counts in bin min((int)floor(nbins * (m / safe)),
//   nbins - 1), the division IEEE (inf / inf converts to bin 0, as the
//   plain form's cast does on the card);
//   threshold = (float)npoints * percentile, npoints the pixels counted;
//   idx = the first bin whose cumulative count reaches the threshold;
//   k = (safe * (idx + 1)) * inv_nbins: PyTorch on the card divides a
//   tensor by a host scalar as a product with the scalar's float reciprocal;
//   k = fallback where hmax <= 0 or no bin reaches the threshold.
// The counts are integers, so any order of atomics gives the same bins.  The
// prefix sums are exact, equal to the plain form's float32 cumulative sums
// while a frame holds fewer than 2^24 interior pixels.
//
// Bound: bytes.  Two reads of the interior planes, one for the maximum and
// one for the bins: 2 x 4 B x B (H - 2)(W - 2), at batch-128 VGA 312 MB,
// 0.093 ms at 3.35 TB/s.
//
// Design.  Both launches run blocks (tile, frame); a tile is a contiguous
// run of one frame's rows 1..H-2 read as float4s (scalars at the ends where
// the run is not 16-byte aligned, as at KITTI's odd width), the first and
// last column of each row skipped by a running column count.
//   Launch 1: each block reduces its tile's maximum as the order-preserving
//   integer of the float's bits (any NaN above everything) into one partial
//   per block, and zeroes the frame's bins and ticket and the path counts
//   for launch 2.  It walks the frames from the last, so launch 2, which
//   walks them from the first, starts on what launch 1 left in L2.
//   Launch 2: each block reduces its frame's partials to hmax, counts its
//   tile into per-warp copies of the bins in shared memory (a textured frame
//   crowds into a few dozen low bins, so warps do not share an address), and
//   adds the non-zero sums into the frame's bins in device memory.  The last
//   block of the frame to arrive (a ticket after __threadfence) searches the
//   bins with one warp and writes k.
// Two per-call sums count the frames that took a percentile and those that
// fell back.
#include "common.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define UNROLL 4
// WARPS copies of the bins in at most 192 KB of shared memory, over the
// default 48 KB a block may take without the opt-in attribute.
#define MAX_BINS 6144
#define FULL 0xffffffffu
#define NAN_KEY 0xffffffffu
#define NONE 0x7fffffff

struct Args {
  const float* modg;  // (B, H, W) contiguous
  int B, H, W, n;     // n: pixels from (1, 1) to (H - 2, W - 2) in row order, edge columns included
  int tiles, nbins;
  float percentile, fallback, inv_nbins;
  int* paths;         // 2: frames that took a percentile, frames that fell back
  int* ticket;        // B
  int* counts;        // (B, nbins)
  unsigned* partial;  // (B, tiles) maximum keys
  float* k;           // B
};

// The float's bits as an unsigned integer in the float's order, any NaN last.
__device__ __forceinline__ unsigned max_key(float v) {
  const unsigned b = __float_as_uint(v);
  return v != v ? NAN_KEY : ((b & 0x80000000u) ? ~b : (b ^ 0x80000000u));
}

// The inverse of max_key; NAN_KEY gives a NaN.
__device__ __forceinline__ float from_key(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// Calls visit(v) on every interior pixel of tile `tile` of the frame whose
// pixel (1, 1) is src[0]; src[i] lies in column (1 + i) % W.
template <bool STREAM, class Visit>
__device__ __forceinline__ void walk_tile(const float* src, int n, unsigned W, int tile, int tiles, Visit visit) {
  const int head = min((int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2), n);
  const int nvec = (n - head) >> 2;
  const int tail = n - head - 4 * nvec;
  const int per = (nvec + tiles - 1) / tiles;
  const int lo = min(tile * per, nvec);
  const int hi = min(lo + per, nvec);
  const float4* v4 = reinterpret_cast<const float4*>(src + head);
  const unsigned step = (4u * THREADS) % W;  // column advance from one float4 of a thread to its next
  int q = lo + threadIdx.x;
  unsigned col = (1u + (unsigned)head + 4u * (unsigned)q) % W;
  for (; q < hi; q += THREADS * UNROLL) {
    float4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int qu = q + u * THREADS;
      if (qu < hi) x[u] = STREAM ? __ldcs(v4 + qu) : v4[qu];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (q + u * THREADS < hi) {
        const float v[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned c = col + i;
          if (c >= W) c -= W;
          if (c != 0 && c != W - 1) visit(v[i]);
        }
      }
      col += step;
      if (col >= W) col -= W;
    }
  }
  if (tile == 0 && (int)threadIdx.x < head + tail) {  // at most 3 + 3 scalars
    const int i = (int)threadIdx.x < head ? (int)threadIdx.x : n - tail + ((int)threadIdx.x - head);
    const unsigned c = (1u + (unsigned)i) % W;
    if (c != 0 && c != W - 1) visit(src[i]);
  }
}

__device__ __forceinline__ const float* interior(const Args& a, int f) {
  return a.modg + (size_t)f * a.H * a.W + a.W + 1;
}

__global__ void __launch_bounds__(THREADS, 4) contrast_max_kernel(const Args a) {
  __shared__ unsigned s_key[WARPS];
  const int f = a.B - 1 - (int)blockIdx.y;
  const int t = blockIdx.x;
  unsigned mx = 0;
  walk_tile<false>(interior(a, f), a.n, (unsigned)a.W, t, a.tiles, [&](float v) { mx = max(mx, max_key(v)); });
  for (int i = t * THREADS + threadIdx.x; i < a.nbins; i += a.tiles * THREADS) a.counts[(size_t)f * a.nbins + i] = 0;
  if (t == 0 && threadIdx.x == 0) a.ticket[f] = 0;
  if (f == 0 && t == 0 && threadIdx.x < 2) a.paths[threadIdx.x] = 0;
  mx = __reduce_max_sync(FULL, mx);
  if ((threadIdx.x & 31) == 0) s_key[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) mx = max(mx, s_key[w]);
    a.partial[(size_t)f * a.tiles + t] = mx;
  }
}

__global__ void __launch_bounds__(THREADS, 4) contrast_hist_kernel(const Args a) {
  extern __shared__ int hist[];  // WARPS x nbins
  __shared__ unsigned s_key[WARPS];
  __shared__ int s_last;
  const int f = blockIdx.y;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = a.nbins;

  unsigned key = 0;
  for (int i = threadIdx.x; i < a.tiles; i += THREADS) key = max(key, __ldcg(a.partial + (size_t)f * a.tiles + i));
  key = __reduce_max_sync(FULL, key);
  if (lane == 0) s_key[warp] = key;
  for (int i = threadIdx.x; i < WARPS * nb; i += THREADS) hist[i] = 0;
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) key = max(key, s_key[w]);
  const float hmax = from_key(key);
  const float safe = hmax > 0.0f ? hmax : 1.0f;
  const float fnb = (float)nb;
  int* wh = hist + warp * nb;
  walk_tile<true>(interior(a, f), a.n, (unsigned)a.W, t, a.tiles, [&](float m) {
    if (m > 0.0f) atomicAdd(wh + min((int)floorf(fnb * __fdiv_rn(m, safe)), nb - 1), 1);
  });
  __syncthreads();
  int* counts = a.counts + (size_t)f * nb;
  for (int b = threadIdx.x; b < nb; b += THREADS) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += hist[w * nb + b];
    if (s) atomicAdd(counts + b, s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.ticket + f, 1) == a.tiles - 1;
  __syncthreads();
  if (!s_last || warp != 0) return;

  // The frame's last block: the first bin whose cumulative count reaches
  // the threshold, lane by lane over runs of bins.
  __threadfence();
  const int per = (nb + 31) / 32;
  const int b0 = min(lane * per, nb);
  const int b1 = min(b0 + per, nb);
  int local = 0;
  for (int b = b0; b < b1; ++b) local += __ldcg(counts + b);
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  const int npoints = __shfl_sync(FULL, incl, 31);
  const float thr = (float)npoints * a.percentile;
  int run = incl - local, found = NONE;
  for (int b = b0; b < b1; ++b) {
    run += __ldcg(counts + b);
    if ((double)run >= (double)thr) {
      found = b;
      break;
    }
  }
  found = __reduce_min_sync(FULL, found);
  if (lane == 0) {
    const bool bad = hmax <= 0.0f || found == NONE;
    a.k[f] = bad ? a.fallback : (safe * ((float)found + 1.0f)) * a.inv_nbins;
    atomicAdd(a.paths + (bad ? 1 : 0), 1);
  }
}

// Lets contrast_hist_kernel take the bins of MAX_BINS in dynamic shared
// memory, once per device.
static int set_smem_limit() {
  static bool done[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(contrast_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)(WARPS * MAX_BINS * sizeof(int)));
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

// modg is a contiguous (B, H, W) float32 batch, H, W >= 3; ws holds
// 2 + B + B * nbins + B * tiles int32 (path counts, tickets, bins,
// partials); k gets the (B,) factors.  ws[0..2) gets the frames that took
// a percentile and those that fell back.
extern "C" int contrast_factor(const float* modg, int B, int H, int W, int tiles, int nbins, float percentile,
                               float fallback, float inv_nbins, int* ws, float* k, void* stream) {
  if (B < 0 || B > 65535 || H < 3 || W < 3 || (long long)H * W >= 2147483647LL || tiles < 1 || nbins < 1 ||
      nbins > MAX_BINS)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a;
  a.modg = modg;
  a.B = B;
  a.H = H;
  a.W = W;
  a.n = (H - 2) * W - 2;
  a.tiles = tiles;
  a.nbins = nbins;
  a.percentile = percentile;
  a.fallback = fallback;
  a.inv_nbins = inv_nbins;
  a.paths = ws;
  a.ticket = ws + 2;
  a.counts = a.ticket + B;
  a.partial = (unsigned*)(a.counts + (size_t)B * nbins);
  a.k = k;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(tiles, B);
  const int err = set_smem_limit();
  if (err) return err;
  contrast_max_kernel<<<grid, THREADS, 0, st>>>(a);
  AKAZE_RETURN_IF_ERROR();
  contrast_hist_kernel<<<grid, THREADS, (size_t)WARPS * nbins * sizeof(int), st>>>(a);
  return (int)cudaGetLastError();
}
