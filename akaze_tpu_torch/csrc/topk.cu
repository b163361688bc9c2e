// The detector's per-level candidate top-K in one pass over the score planes.
//
// Replaces no TPU kernel: the JAX package's find_candidates_oct
// (akaze_tpu/frontend/detect.py) is lax.top_k, and the port ran it as ~190
// PyTorch ops per call (an int64 key per pixel, torch.topk's radix select
// over every key, then gathers, divisions, pads and casts per octave).
//
// Semantics (kernels/topk.py, per_level_topk_plain).  For every (level,
// frame) plane of h * w scores, the k = min(K, h * w) entries with the
// largest scores, ordered by the float's bits mapped to an order-preserving
// integer (NaN and infinities included, -0 below +0), then by the lower
// index; slots k..K-1 hold NEG at index 0.  Each entry is written as its
// score's bits, level pixel (yi, xi), octave-0 flat index yi * w0 + xi and
// valid = score > NEG, all (B, L, K) at the level's offset.
//
// Bound: bytes.  Every score is read once (4 B) and the (B, L, K) result
// written (17 B a slot): at batch-128 VGA 836 MB, 0.25 ms at 3.35 TB/s.
// Kernel 2 writes NEG wherever a pixel is no candidate, so a plane holds a
// few hundred entries above NEG, and only those need sorting.
//
// Design.  Launch 1 zeroes the per-plane counters.  Launch 2: each block
// reads one chunk of CHUNK_VEC float4s of one plane (the plane split over
// as many blocks as its size asks for; a scalar head and tail where a plane
// is not 16-byte aligned, as at KITTI's odd widths), skips the all-NEG
// float4s with one vote, appends each entry above NEG to the plane's
// scratch as a 64-bit key (ordered bits, then the inverted index) through
// one atomicAdd per warp, and counts the entries below NEG.  The last block
// of a plane to arrive (arrival counter after __threadfence) finishes it:
//   fast path, when at most CAP entries lie above NEG and they reach k or
//   nothing lies below NEG: bitonic sort of those keys in shared memory,
//   the first min(k, count) written; a short plane is filled with NEG at
//   the lowest indices that hold no entry (a binary search over the
//   entries sorted by index, since the j-th such index is j plus the count
//   of entries before it);
//   general path, otherwise (more than CAP entries, or a short plane with
//   entries below NEG): an exact radix select of the k-th largest 64-bit
//   key over the whole plane (8 passes of 8 bits), then every key at or
//   above it collected, sorted and written.
// The 64-bit keys are unique, so the order in which entries land in the
// scratch does not matter.  Three per-call sums count the planes by path
// (fast; fast and cut at k; general).
#include "common.cuh"

#define THREADS 512
#define VEC_PER_THREAD 8
#define CHUNK_VEC (THREADS * VEC_PER_THREAD)  // float4s a block reads: 64 KB
#define MAX_OCTAVES 8
#define FULL 0xffffffffu

struct Octave {
  const float* score;  // (n, B, h, w) contiguous: plane row = level * B + frame
  long long block0;    // first block of the octave
  int plane0;          // first plane of the octave among all B * L
  int hw, w, level0, nch;  // pixels and width of a plane, first level, blocks per plane
};

struct Args {
  Octave oct[MAX_OCTAVES];
  int noct, B, L, K, w0, cap;
  float neg;
  unsigned long long* scratch;  // (B * L, cap) keys above NEG
  int* ws;  // 3 path sums, then per plane: arrivals, entries above NEG, entries below NEG
  float* resp;
  int *yi, *xi, *flat;
  unsigned char* valid;
};

// The float's bits as an unsigned integer in the float's total order.
__device__ __forceinline__ unsigned ukey(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b ^ 0x80000000u);
}

__device__ __forceinline__ float from_ukey(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// Larger key first, then the lower index; never 0 (the sort's padding).
__device__ __forceinline__ unsigned long long entry_key(unsigned u, int idx) {
  return ((unsigned long long)u << 32) | (unsigned)~idx;
}

// One element of the count phase; every lane of the warp calls it together.
__device__ __forceinline__ void visit(float v, int idx, unsigned u_neg, int lane, int& below, int* above,
                                      unsigned long long* ent, int cap) {
  const unsigned u = ukey(v);
  below += u < u_neg;
  const bool up = u > u_neg;
  const unsigned m = __ballot_sync(FULL, up);
  if (m == 0) return;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(above, __popc(m));
  base = __shfl_sync(FULL, base, leader);
  if (up) {
    const int pos = base + __popc(m & ((1u << lane) - 1u));
    if (pos < cap) ent[pos] = entry_key(u, idx);
  }
}

// Descending bitonic sort of n (a power of two) keys in shared memory.
__device__ void bitonic_desc(unsigned long long* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < (n >> 1); q += THREADS) {
        const int i = 2 * q - (q & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = s[i], b = s[j];
        if ((i & size) == 0 ? a < b : a > b) {
          s[i] = b;
          s[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The k largest keys of a whole plane into buf[0..k): radix select of the
// k-th largest 64-bit key, then every key at or above it.
__device__ void select_plane(const float* src, int hw, int k, unsigned long long* buf, unsigned* hist) {
  __shared__ unsigned long long s_prefix;
  __shared__ int s_count;
  unsigned long long prefix = 0, mask = 0;
  int remaining = k;  // rank of the sought key among those matching the prefix
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < hw; i += THREADS) {
      const unsigned long long c = entry_key(ukey(src[i]), i);
      if ((c & mask) == prefix) atomicAdd(&hist[(c >> shift) & 255], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int d = 255;
      unsigned acc = 0;
      while (acc + hist[d] < (unsigned)remaining) acc += hist[d--];
      remaining -= (int)acc;
      s_prefix = prefix | ((unsigned long long)d << shift);
    }
    __syncthreads();
    prefix = s_prefix;
    mask |= 0xffull << shift;
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < hw; i += THREADS) {
    const unsigned long long c = entry_key(ukey(src[i]), i);
    if (c >= prefix) buf[atomicAdd(&s_count, 1)] = c;
  }
  __syncthreads();
}

__device__ __forceinline__ void put(const Args& a, size_t o, float v, int idx, int w) {
  const int y = idx / w;
  const int x = idx - y * w;
  a.resp[o] = v;
  a.yi[o] = y;
  a.xi[o] = x;
  a.flat[o] = (int)((unsigned)y * (unsigned)a.w0 + (unsigned)x);
  a.valid[o] = v > a.neg;
}

__global__ void clear_kernel(int* ws, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ws[i] = 0;
}

__global__ void __launch_bounds__(THREADS) topk_kernel(const Args a) {
  extern __shared__ unsigned long long buf[];  // cap keys
  __shared__ unsigned hist[256];
  __shared__ int s_last;

  const long long blk = blockIdx.x;
  int o = 0;
  while (o + 1 < a.noct && blk >= a.oct[o + 1].block0) ++o;
  const Octave& oc = a.oct[o];
  const int row = (int)((blk - oc.block0) / oc.nch);
  const int chunk = (int)(blk - oc.block0 - (long long)row * oc.nch);
  const int P = a.B * a.L;
  const int g = oc.plane0 + row;
  int* arrive = a.ws + 3;
  int* above = arrive + P;
  int* below_n = above + P;
  unsigned long long* ent = a.scratch + (size_t)g * a.cap;
  const int hw = oc.hw;
  const float* src = oc.score + (size_t)row * hw;
  const int head = min((int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2), hw);
  const int nvec = (hw - head) >> 2;
  const int tail = hw - head - 4 * nvec;
  const float4* v4 = reinterpret_cast<const float4*>(src + head);
  const unsigned u_neg = ukey(a.neg);
  const unsigned negbits = __float_as_uint(a.neg);
  const int lane = threadIdx.x & 31;

  // Count and compact this block's chunk.
  int below = 0;
  const int q0 = chunk * CHUNK_VEC + threadIdx.x;
  float4 x[VEC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < VEC_PER_THREAD; ++i) {
    const int q = q0 + i * THREADS;
    x[i] = q < nvec ? __ldcs(v4 + q) : make_float4(a.neg, a.neg, a.neg, a.neg);
  }
#pragma unroll
  for (int i = 0; i < VEC_PER_THREAD; ++i) {
    const bool hit = __float_as_uint(x[i].x) != negbits || __float_as_uint(x[i].y) != negbits ||
                     __float_as_uint(x[i].z) != negbits || __float_as_uint(x[i].w) != negbits;
    if (__any_sync(FULL, hit)) {
      const int idx = head + 4 * (q0 + i * THREADS);
      visit(x[i].x, idx, u_neg, lane, below, above + g, ent, a.cap);
      visit(x[i].y, idx + 1, u_neg, lane, below, above + g, ent, a.cap);
      visit(x[i].z, idx + 2, u_neg, lane, below, above + g, ent, a.cap);
      visit(x[i].w, idx + 3, u_neg, lane, below, above + g, ent, a.cap);
    }
  }
  if (chunk == 0 && threadIdx.x < 32) {  // the unaligned head and tail, at most 3 + 3 scalars
    const int t = threadIdx.x;
    int idx = -1;
    if (t < head) idx = t;
    else if (t < head + tail) idx = hw - tail + (t - head);
    visit(idx >= 0 ? src[idx] : a.neg, idx, u_neg, lane, below, above + g, ent, a.cap);
  }
  below = __reduce_add_sync(FULL, below);
  if (lane == 0 && below) atomicAdd(below_n + g, below);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrive + g, 1) == oc.nch - 1;
  __syncthreads();
  if (!s_last) return;

  // The last block of the plane selects its top k.
  __threadfence();
  const int count = *(volatile int*)(above + g);
  const int nbelow = *(volatile int*)(below_n + g);
  const int k = min(a.K, hw);
  const bool fast = count <= a.cap && (count >= k || nbelow == 0);
  int n;
  if (fast) {
    n = count;
    for (int i = threadIdx.x; i < n; i += THREADS) buf[i] = __ldcg(ent + i);
  } else {
    n = k;
    select_plane(src, hw, k, buf, hist);
  }
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int i = n + threadIdx.x; i < p2; i += THREADS) buf[i] = 0;
  __syncthreads();
  bitonic_desc(buf, p2);

  const int lvl = row / a.B;
  const int frame = row - lvl * a.B;
  const size_t out = ((size_t)frame * a.L + oc.level0 + lvl) * a.K;
  const int nout = min(k, n);
  for (int s = threadIdx.x; s < nout; s += THREADS) {
    const unsigned long long c = buf[s];
    put(a, out + s, from_ukey((unsigned)(c >> 32)), (int)~(unsigned)c, oc.w);
  }
  if (n < k) {
    // Fast path with nothing below NEG: the rest of the first k are NEG at
    // the lowest indices that hold no entry.  Sort the entries by index
    // (the low word of a key is the inverted index).
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += THREADS) buf[i] &= 0xffffffffull;
    __syncthreads();
    bitonic_desc(buf, p2);
    for (int s = n + threadIdx.x; s < k; s += THREADS) {
      const int j = s - n;
      int lo = 0, hi = n;  // entries c_i with c_i - i <= j lie below the j-th free index
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((int)~(unsigned)buf[mid] - mid <= j) lo = mid + 1;
        else hi = mid;
      }
      put(a, out + s, a.neg, j + lo, oc.w);
    }
  }
  for (int s = k + threadIdx.x; s < a.K; s += THREADS) put(a, out + s, a.neg, 0, oc.w);
  if (threadIdx.x == 0) {
    atomicAdd(a.ws + (fast ? 0 : 2), 1);
    if (fast && count > k) atomicAdd(a.ws + 1, 1);
  }
}

// scores[o] is octave o's contiguous (n[o], B, h[o], w[o]) float32 stack;
// levels run octave by octave.  scratch is (B * L, cap) 64-bit, cap a
// power of two >= K; ws holds 3 + 3 * B * L ints; resp, yi, xi, flat and
// valid are contiguous (B, L, K).  ws[0..3) gets the planes on the fast
// path, those of them cut at k, and those on the general path.
extern "C" int per_level_topk(const float* const* scores, const int* n, const int* h, const int* w, int noct,
                              int B, int K, int w0, float neg, void* scratch, int cap, int* ws, float* resp,
                              int* yi, int* xi, int* flat, unsigned char* valid, void* stream) {
  if (noct < 1 || noct > MAX_OCTAVES || B < 0 || K < 0 || cap < K || (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.noct = noct;
  a.B = B;
  a.K = K;
  a.w0 = w0;
  a.cap = cap;
  a.neg = neg;
  a.scratch = (unsigned long long*)scratch;
  a.ws = ws;
  a.resp = resp;
  a.yi = yi;
  a.xi = xi;
  a.flat = flat;
  a.valid = valid;
  long long blocks = 0;
  int L = 0;
  for (int o = 0; o < noct; ++o) {
    const long long hw = (long long)h[o] * w[o];
    if (n[o] < 1 || hw < 1 || hw >= 2147483647LL) return (int)cudaErrorInvalidValue;
    Octave& oc = a.oct[o];
    oc.score = scores[o];
    oc.block0 = blocks;
    oc.plane0 = L * B;
    oc.hw = (int)hw;
    oc.w = w[o];
    oc.level0 = L;
    oc.nch = (int)((hw / 4 + CHUNK_VEC - 1) / CHUNK_VEC);
    if (oc.nch < 1) oc.nch = 1;
    blocks += (long long)n[o] * B * oc.nch;
    L += n[o];
  }
  a.L = L;
  if (B == 0 || K == 0) return 0;
  if (blocks > 2147483647LL || (long long)B * L > 100000000LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nws = 3 + 3 * B * L;
  clear_kernel<<<(nws + 255) / 256, 256, 0, st>>>(ws, nws);
  AKAZE_RETURN_IF_ERROR();
  const size_t smem = (size_t)cap * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  topk_kernel<<<(unsigned)blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
