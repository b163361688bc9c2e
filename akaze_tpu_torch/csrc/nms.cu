// The detector's cross-level NMS in one launch per call.
//
// Replaces no TPU kernel: the JAX package's cross_level_nms
// (akaze_tpu/frontend/detect.py) is plain jnp, and the port ran it as ~80
// PyTorch ops that each wrote a (B, L, K, K) tensor (134 M elements at
// batch 128, K = 256), ~13 ms per VGA batch on the H100 for a few
// megabytes of candidates.  This kernel computes the same survivors
// without any pair tensor, and writes their responses (NEG elsewhere), the
// keys that detect's top-M ranks.
//
// Semantics (kernels/nms.py, cross_level_nms_plain).  Candidate P on level
// l is suppressed by a valid candidate Q on level l, l - 1 or l + 1 when
// dx * dx + dy * dy <= r2[max(l, level of Q)] (octave-0 coordinates
// x = float(xi) * ratio[level]) and Q beats P: resp_Q > resp_P, or equal
// responses and the lower tie key level * npx + flat.  A NaN response
// neither beats nor is beaten, as torch compares; P meets itself on its
// own level and does not suppress itself.  Every product and sum is a
// separately rounded float32 operation (__fmul_rn, __fadd_rn, __fsub_rn,
// which nvcc never contracts), so the output equals the plain form's bit
// for bit.
//
// Bound.  Every slot's valid flag is read (1 B) and its masked response
// written (4 B); only a valid slot's response, x, y and flat index are read
// (16 B): 5 B per slot and 16 B per valid slot, ~3.4 MB at batch-128 VGA
// with 9 % of the slots valid (~1 us at 3.35 TB/s).  The dense form makes
// B * L * K * 3K pair tests (0.4 G there, ~0.05 ms of float32 work at ~8
// operations a test): as the plain form computes it, the NMS is bound by
// its pair tests.  This kernel tests only pairs of valid slots, a small
// share of them where most slots are empty (chip_smoke.py prints both
// counts), so the bytes and the latency of the block's loads are what is
// left.
//
// Design.  One block per (frame, level), THREADS threads; thread t owns
// the slots t, t + THREADS, ... of its level and keeps its P in registers.
// The Qs of levels l, l - 1 and l + 1 (3K slots, 2K at the first and last
// level) are staged in shared memory in windows of CAP slots, only the
// valid ones (compacted through a shared counter: their order varies from
// run to run, the OR over them does not), each with its x, y, response,
// tie key and squared radius; every thread then scans the window with
// broadcast reads and stops at the first Q that suppresses its P.  A
// window is skipped once no P of the block is alive (__syncthreads_or), so
// a level with few valid slots costs little more than its loads.  At
// K <= THREADS one window holds every Q and every P is one thread's; a
// larger K walks P chunks and reloads the windows for each.
#include "common.cuh"

#define THREADS 256
#define CAP (3 * THREADS)  // Q slots staged per window: all three levels at K <= THREADS

// Level of the si-th source of level l: l itself, then l - 1 (if any), then
// l + 1 (if any).
__device__ __forceinline__ int source_level(int si, int l) {
  if (si == 0) return l;
  return (si == 1 && l > 0) ? l - 1 : l + 1;
}

__global__ void __launch_bounds__(THREADS)
nms_kernel(const float* __restrict__ resp, const int* __restrict__ xi, const int* __restrict__ yi,
           const int* __restrict__ flat, const unsigned char* __restrict__ valid,
           const float* __restrict__ tables, int L, int K, int npx, float neg,
           float* __restrict__ masked) {
  __shared__ float qx[CAP], qy[CAP], qr[CAP], qd[CAP];
  __shared__ int qt[CAP];
  __shared__ int count;

  const float* ratio = tables;  // (L,) level pixel -> octave-0 pixel
  const float* r2 = tables + L;  // (L,) squared suppression radius
  const int l = blockIdx.x % L;
  const size_t frame0 = (size_t)(blockIdx.x - l) * K;  // slot (frame, level 0, 0)
  const int nsrc = 1 + (l > 0) + (l + 1 < L);
  const int nq = nsrc * K;

  for (int p0 = 0; p0 < K; p0 += THREADS) {
    const int p = p0 + threadIdx.x;
    const size_t ip = frame0 + (size_t)l * K + p;
    bool alive = false;
    float px = 0.f, py = 0.f, pr = 0.f;
    int pt = 0;
    if (p < K && valid[ip]) {
      alive = true;
      px = __fmul_rn((float)xi[ip], ratio[l]);
      py = __fmul_rn((float)yi[ip], ratio[l]);
      pr = resp[ip];
      pt = l * npx + flat[ip];
    }
    for (int j0 = 0; j0 < nq; j0 += CAP) {
      // Also the barrier that ends the previous window's scans.
      if (!__syncthreads_or(alive)) break;
      if (threadIdx.x == 0) count = 0;
      __syncthreads();
      const int j1 = min(j0 + CAP, nq);
      for (int j = j0 + threadIdx.x; j < j1; j += THREADS) {
        const int si = j / K;
        const int s = source_level(si, l);
        const size_t iq = frame0 + (size_t)s * K + (j - si * K);
        if (valid[iq]) {
          const int slot = atomicAdd(&count, 1);
          qx[slot] = __fmul_rn((float)xi[iq], ratio[s]);
          qy[slot] = __fmul_rn((float)yi[iq], ratio[s]);
          qr[slot] = resp[iq];
          qt[slot] = s * npx + flat[iq];
          qd[slot] = r2[max(s, l)];
        }
      }
      __syncthreads();
      if (alive) {
        const int n = count;
        for (int i = 0; i < n; ++i) {
          const float dx = __fsub_rn(px, qx[i]);
          const float dy = __fsub_rn(py, qy[i]);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const float r = qr[i];
          if (d2 <= qd[i] && (r > pr || (r == pr && qt[i] < pt))) {
            alive = false;
            break;
          }
        }
      }
    }
    if (p < K) masked[ip] = alive ? pr : neg;
  }
}

// resp, xi, yi, flat, valid and masked are contiguous (B, L, K); masked
// gets the survivors' responses and neg elsewhere.  tables is (2, L): the
// ratios, then the squared radii.  L * npx < 2^31.
extern "C" int cross_level_nms(const float* resp, const int* xi, const int* yi, const int* flat,
                               const unsigned char* valid, const float* tables, int B, int L, int K,
                               int npx, float neg, float* masked, void* stream) {
  if (B < 0 || L < 0 || K < 0 || (long long)B * L > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0 || K == 0) return 0;
  nms_kernel<<<B * L, THREADS, 0, (cudaStream_t)stream>>>(resp, xi, yi, flat, valid, tables, L, K, npx, neg,
                                                          masked);
  return (int)cudaGetLastError();
}
