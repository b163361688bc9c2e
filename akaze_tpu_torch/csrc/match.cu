// Kernel 4 of the port: the one-pass Hamming match reduction on Hopper's
// tensor cores.
//
// Replaces akaze_tpu/kernels/match_pallas.py :: match_reduce
// (_match_kernel).  One launch covers all P descriptor pairs (the JAX
// package vmaps the kernel over pairs).
//
// Bound: operations.  Every distance that an output depends on is a 512-bit
// Hamming distance, and the inputs are ~130 KB per pair.  The distance is an
// integer dot product over bits: |a ^ b| = |a| + |b| - 2 |a & b|, so the
// tensor cores compute |a & b| (mma.sync m16n8k256 b1 and.popc: a 16 x 8
// block of (row, column) pairs over 256 bits per instruction, exact in s32)
// straight on the packed descriptors; |a| and |b| are popcounts taken once
// per tile load.  The bound counts these distances at the int8 tensor-core
// rate (1,024 operations each; chip_smoke.py); at batch-128 VGA it is
// ~0.026 ms, and the kernel takes ~0.11 ms (PERF.md).  The s8 form
// (m16n8k32 on descriptors unpacked to one 0/1 byte per bit) was 3x slower
// on the H100: 8x the mma and the unpacking.
//
// Design.  Grid: (row tiles of TR = 64 rows of A, pairs).  A block keeps its
// row tile in shared memory and walks the column tiles of TC = 128
// descriptors of B in increasing order.  Four warps each own a 32 x 64
// block of the 64 x 128 tile and read their fragments with ldmatrix from
// rows padded by 16 bytes, so the eight rows of each matrix hit distinct
// banks.  The bit order inside k does not matter: A and B are loaded the
// same way, and the dot product sums over all 512 bits.
//   Tile skip: a (row tile, column tile) whose rows are all A-invalid and
//   whose columns are all B-invalid feeds no output and is not computed;
//   the flags come from the masks inside the block (__syncthreads_or).
//   Row side: each thread keeps (best, nn, second) for its four rows over
//   its columns in increasing order (strict <, so the lowest column wins and
//   second == best on a tie); the four threads of a quad, then the two warps
//   that split the tile's columns, merge with merge_best.  A block owns its
//   rows across all of B, so no row state crosses blocks and no second pass
//   is needed.
//   Column side: min of the key (d << 16) | row over A-valid rows, across
//   the 8 lanes that share a column (xor shuffles 4, 8, 16), then a global
//   atomicMin: blocks run in no order, and the smallest key is the lowest
//   row among the closest.  init_keys_kernel and finish_columns_kernel set
//   and decode the keys (folding them in would need a grid-wide barrier), so
//   a call is three __global__ launches.
#include "common.cuh"

#define WORDS 16        // 32-bit words of a descriptor (512 bits)
#define TR 64           // rows of A per block
#define TC 128          // columns of B per tile
#define WARP_ROWS 32    // a warp's block of the tile: 2 x 8 mma tiles of 16 x 8
#define WARP_COLS 64
#define THREADS 128     // four warps: 2 x 2 warp blocks
#define BIG (1 << 30)
#define NO_KEY 0xffffffffu

#define ROW_BYTES 64    // a descriptor's 512 bits
#define KSTEPS 2        // k-slices of 256 bits
#define STRIDE (ROW_BYTES + 16)  // padded row: ldmatrix reads its 8 rows conflict-free
static_assert(THREADS == 32 * (TR / WARP_ROWS) * (TC / WARP_COLS) && TR / WARP_ROWS == 2 &&
              WARP_ROWS == 32 && WARP_COLS == 64, "match_kernel's warp layout");
#define SMEM_BYTES ((TR + TC) * STRIDE + 4 * (2 * TR + 2 * TC + 3 * TR))  // 17,664: under 48 KB

__global__ void init_keys_kernel(unsigned* keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = NO_KEY;
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const unsigned char* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += popc(A & B) of a 16 x 8 block of (row, column) pairs over one
// 256-bit k-slice: A (16 x 256 bits, row), B (256 bits x 8, col).
__device__ __forceinline__ void mma_and(int c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n descriptors from src (zeros up to `rows`) into shared rows of STRIDE
// bytes, and each row's popcount into pop.  Every thread of the block calls
// it (the popcount is summed across lanes).
__device__ __forceinline__ void stage(const int* __restrict__ src, int n, int rows,
                                      unsigned char* dst, int* pop) {
  // One uint4 (4 words) per thread, 4 lanes per row.
  for (int i = threadIdx.x; i < rows * 4; i += THREADS) {
    const int r = i >> 2, q = i & 3;
    const uint4 v = r < n ? reinterpret_cast<const uint4*>(src)[i] : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dst + r * STRIDE + 16 * q) = v;
    int p = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (q == 0) pop[r] = p;
  }
}

// Merges another row state (ob, oa, os) into (b, a, s): the smaller key
// (distance, column) wins, and the second best is the smaller of the
// winner's second and the loser's best.
__device__ __forceinline__ void merge_best(int& b, int& a, int& s, int ob, int oa, int os) {
  const bool take = ob < b || (ob == b && oa < a);
  s = min(take ? os : s, take ? b : ob);
  if (take) {
    b = ob;
    a = oa;
  }
}

__global__ void __launch_bounds__(THREADS) match_kernel(
    const int* __restrict__ da, const unsigned char* __restrict__ va,
    const int* __restrict__ db, const unsigned char* __restrict__ vb, int Ka, int Kb,
    int* __restrict__ best, int* __restrict__ second, int* __restrict__ nn,
    unsigned* __restrict__ colkey) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sa = smem;           // TR rows of A
  unsigned char* sb = sa + TR * STRIDE;  // TC rows of B
  int* pa = reinterpret_cast<int*>(sb + TC * STRIDE);  // popcounts
  int* pb = pa + TR;
  int* sva = pb + TC;                 // A validity
  int* pen = sva + TR;                // 0 for a B-valid column, BIG for the others
  int* rst = pen + TC;                // row states of warp column 1: best, nn, second

  const int pair = blockIdx.y, r0 = blockIdx.x * TR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 1, wc = warp & 1;  // warp block: rows 32 wr.., columns 64 wc..
  const int g = lane >> 2, t = lane & 3;    // mma fragment: group, thread in group

  stage(da + ((size_t)pair * Ka + r0) * WORDS, min(TR, Ka - r0), TR, sa, pa);
  int rv = 0;
  if (tid < TR) {
    rv = r0 + tid < Ka && va[(size_t)pair * Ka + r0 + tid];
    sva[tid] = rv;
  }
  const bool rowany = __syncthreads_or(rv);

  // Row state of rows 32 wr + 16 mi + 8 h + g.
  int bst[2][2], sec[2][2], arg[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bst[mi][h] = BIG;
      sec[mi][h] = BIG;
      arg[mi][h] = 0;
    }

  for (int c0 = 0; c0 < Kb; c0 += TC) {
    const int cv = c0 + tid < Kb && vb[(size_t)pair * Kb + c0 + tid];
    // Also the barrier after the previous tile's last reads of sb.
    const bool colany = __syncthreads_or(cv);
    if (!rowany && !colany) continue;
    pen[tid] = cv ? 0 : BIG;
    stage(db + ((size_t)pair * Kb + c0) * WORDS, min(TC, Kb - c0), TC, sb, pb);
    __syncthreads();

    int acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    // ldmatrix addresses: A matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31),
    // B matrices (columns 0-7 | 8-15) x (bytes 0-15 | 16-31) of two n-tiles.
    const unsigned char* pa_row = sa + (wr * WARP_ROWS + (lane & 7) + 8 * ((lane >> 3) & 1)) * STRIDE + 16 * (lane >> 4);
    const unsigned char* pb_row = sb + (wc * WARP_COLS + (lane & 7) + 8 * (lane >> 4)) * STRIDE + 16 * ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      unsigned af[2][4];
      ldsm_x4(af[0], pa_row + 32 * ks);
      ldsm_x4(af[1], pa_row + 16 * STRIDE + 32 * ks);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bf[4];
        ldsm_x4(bf, pb_row + 16 * np * STRIDE + 32 * ks);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_and(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_and(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }

    // Element e of acc[mi][ni]: row 32 wr + 16 mi + 8 (e >> 1) + g,
    // column 64 wc + 8 ni + 2 t + (e & 1) of the tile.  cb: |b| of the
    // thread's columns; cr: the same plus BIG for a B-invalid column, whose
    // distance then never enters a row state.
    int cb[8][2], cr[8][2];
    unsigned key[8][2];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = wc * WARP_COLS + ni * 8 + 2 * t + j;
        cb[ni][j] = pb[cl];
        cr[ni][j] = pb[cl] + pen[cl];
        key[ni][j] = NO_KEY;
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wr * WARP_ROWS + mi * 16 + h * 8 + g;
        const int prow = pa[rl];
        const bool rvalid = sva[rl] != 0;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int dot2 = 2 * acc[mi][ni][2 * h + j];
            if (colany) {
              const int dr = prow + cr[ni][j] - dot2;
              if (dr < bst[mi][h]) {
                sec[mi][h] = bst[mi][h];
                bst[mi][h] = dr;
                arg[mi][h] = c0 + wc * WARP_COLS + ni * 8 + 2 * t + j;
              } else if (dr < sec[mi][h]) {
                sec[mi][h] = dr;
              }
            }
            if (rvalid)
              key[ni][j] = min(key[ni][j], ((unsigned)(prow + cb[ni][j] - dot2) << 16) | (unsigned)(r0 + rl));
          }
      }
    if (rowany) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          unsigned k = key[ni][j];
          k = min(k, __shfl_xor_sync(0xffffffffu, k, 4));
          k = min(k, __shfl_xor_sync(0xffffffffu, k, 8));
          k = min(k, __shfl_xor_sync(0xffffffffu, k, 16));
          const int c = c0 + wc * WARP_COLS + ni * 8 + 2 * t + j;
          if (g == 0 && k != NO_KEY && c < Kb) atomicMin(&colkey[(size_t)pair * Kb + c], k);
        }
    }
  }

  // Row states: across the quad, then across the two warp columns.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 1; m < 4; m <<= 1)
        merge_best(bst[mi][h], arg[mi][h], sec[mi][h],
                   __shfl_xor_sync(0xffffffffu, bst[mi][h], m),
                   __shfl_xor_sync(0xffffffffu, arg[mi][h], m),
                   __shfl_xor_sync(0xffffffffu, sec[mi][h], m));
  if (wc == 1 && t == 0)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wr * WARP_ROWS + mi * 16 + h * 8 + g;
        rst[rl] = bst[mi][h];
        rst[TR + rl] = arg[mi][h];
        rst[2 * TR + rl] = sec[mi][h];
      }
  __syncthreads();
  if (wc == 0 && t == 0)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wr * WARP_ROWS + mi * 16 + h * 8 + g;
        if (r0 + rl >= Ka) continue;
        merge_best(bst[mi][h], arg[mi][h], sec[mi][h], rst[rl], rst[TR + rl], rst[2 * TR + rl]);
        const size_t o = (size_t)pair * Ka + r0 + rl;
        best[o] = bst[mi][h];
        second[o] = sec[mi][h];
        nn[o] = arg[mi][h];
      }
}

__global__ void finish_columns_kernel(const unsigned* keys, int* colmin, int* colarg, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned k = keys[i];
  colmin[i] = k == NO_KEY ? BIG : (int)(k >> 16);
  colarg[i] = k == NO_KEY ? 0 : (int)(k & 0xffffu);
}

// da (P, Ka, 16) / db (P, Kb, 16) int32, 16-byte aligned, va (P, Ka) / vb
// (P, Kb) bool -> best, second, nn (P, Ka) and colmin, colarg (P, Kb) int32;
// colkey is (P, Kb) uint32 scratch.  Requires Ka <= 65536 and P <= 65535.
extern "C" int match_reduce(const int* da, const unsigned char* va, const int* db,
                            const unsigned char* vb, int P, int Ka, int Kb, int* best,
                            int* second, int* nn, int* colmin, int* colarg, unsigned* colkey,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Ka > 65536 || P > 65535) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  const int ncol = P * Kb;
  if (ncol > 0) init_keys_kernel<<<(ncol + 255) / 256, 256, 0, st>>>(colkey, ncol);
  if (Ka > 0)
    match_kernel<<<dim3((Ka + TR - 1) / TR, P), THREADS, SMEM_BYTES, st>>>(da, va, db, vb, Ka, Kb, best,
                                                                          second, nn, colkey);
  if (ncol > 0)
    finish_columns_kernel<<<(ncol + 255) / 256, 256, 0, st>>>(colkey, colmin, colarg, ncol);
  return (int)cudaGetLastError();
}
