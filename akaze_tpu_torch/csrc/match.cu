// Kernel 4 of the port: the one-pass Hamming match reduction on Hopper.
//
// Replaces akaze_tpu/kernels/match_pallas.py :: match_reduce
// (_match_kernel).  One launch covers all P descriptor pairs (the JAX
// package vmaps the kernel over pairs).  Grid: (row blocks of RB = 128 rows
// of A, pairs).  A block keeps the pair's B descriptors (Kb x 16 words,
// 64 KB at Kb = 1024) in dynamic shared memory; each thread owns one row of
// A in registers and walks the columns in order with XOR + __popc:
//   row side   best / second / nn over B-valid columns, the lowest column
//              winning ties (sequential order keeps `second == best` when
//              another column ties);
//   column side min / argmin over A-valid rows.  The TPU kernel carried
//              the column minima across grid steps in order; blocks on this
//              card run in no order, so each column's minimum is the key
//              (dist << 16) | row, reduced across the warp with
//              __reduce_min_sync, across the block with a shared atomicMin
//              and across blocks with a global atomicMin: the smallest key
//              is the lowest row among the closest.
// It is bound by operations: P * Ka * Kb * 16 popcounts against ~200 KB of
// descriptors per pair, so B stays on chip and only O(Ka + Kb) vectors are
// written.
#include "common.cuh"

#define RB 128
#define WORDS 16
#define BIG (1 << 30)
#define NO_KEY 0xffffffffu

__global__ void init_keys_kernel(unsigned* keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = NO_KEY;
}

__global__ void __launch_bounds__(RB) match_kernel(
    const int* __restrict__ da, const unsigned char* __restrict__ va,
    const int* __restrict__ db, const unsigned char* __restrict__ vb, int Ka, int Kb,
    int* __restrict__ best, int* __restrict__ second, int* __restrict__ nn,
    unsigned* __restrict__ colkey) {
  extern __shared__ uint4 smem[];
  uint4* sb = smem;                                 // Kb x 4 uint4
  unsigned* skey = (unsigned*)(sb + (size_t)Kb * 4);  // Kb
  unsigned char* svb = (unsigned char*)(skey + Kb);   // Kb

  const int pair = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const uint4* gb = (const uint4*)(db + (size_t)pair * Kb * WORDS);
  for (int i = tid; i < Kb * 4; i += RB) sb[i] = gb[i];
  for (int c = tid; c < Kb; c += RB) {
    skey[c] = NO_KEY;
    svb[c] = vb[(size_t)pair * Kb + c];
  }
  __syncthreads();

  const int row = blockIdx.x * RB + tid;
  const bool has_row = row < Ka;
  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0, a2 = a0, a3 = a0;
  bool row_valid = false;
  if (has_row) {
    const uint4* ga = (const uint4*)(da + ((size_t)pair * Ka + row) * WORDS);
    a0 = ga[0];
    a1 = ga[1];
    a2 = ga[2];
    a3 = ga[3];
    row_valid = va[(size_t)pair * Ka + row] != 0;
  }
  int bst = BIG, sec = BIG, arg = 0;
  for (int c = 0; c < Kb; ++c) {
    const uint4 b0 = sb[4 * c], b1 = sb[4 * c + 1], b2 = sb[4 * c + 2], b3 = sb[4 * c + 3];
    const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
                  __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                  __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w) + __popc(a2.x ^ b2.x) +
                  __popc(a2.y ^ b2.y) + __popc(a2.z ^ b2.z) + __popc(a2.w ^ b2.w) +
                  __popc(a3.x ^ b3.x) + __popc(a3.y ^ b3.y) + __popc(a3.z ^ b3.z) +
                  __popc(a3.w ^ b3.w);
    if (svb[c]) {
      if (d < bst) {
        sec = bst;
        bst = d;
        arg = c;
      } else if (d < sec) {
        sec = d;
      }
    }
    const unsigned key = row_valid ? (((unsigned)d << 16) | (unsigned)row) : NO_KEY;
    const unsigned m = __reduce_min_sync(0xffffffffu, key);
    if (lane == 0 && m != NO_KEY) atomicMin(&skey[c], m);
  }
  if (has_row) {
    const size_t o = (size_t)pair * Ka + row;
    best[o] = bst;
    second[o] = sec;
    nn[o] = arg;
  }
  __syncthreads();
  for (int c = tid; c < Kb; c += RB)
    if (skey[c] != NO_KEY) atomicMin(&colkey[(size_t)pair * Kb + c], skey[c]);
}

__global__ void finish_columns_kernel(const unsigned* keys, int* colmin, int* colarg, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned k = keys[i];
  colmin[i] = k == NO_KEY ? BIG : (int)(k >> 16);
  colarg[i] = k == NO_KEY ? 0 : (int)(k & 0xffffu);
}

// da (P, Ka, 16) / db (P, Kb, 16) int32, va (P, Ka) / vb (P, Kb) bool ->
// best, second, nn (P, Ka) and colmin, colarg (P, Kb) int32; colkey is
// (P, Kb) uint32 scratch.  Requires Ka <= 65536.
extern "C" int match_reduce(const int* da, const unsigned char* va, const int* db,
                            const unsigned char* vb, int P, int Ka, int Kb, int* best,
                            int* second, int* nn, int* colmin, int* colarg, unsigned* colkey,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Ka > 65536) return (int)cudaErrorInvalidValue;
  const int ncol = P * Kb;
  if (P == 0 || Kb == 0) return 0;
  init_keys_kernel<<<(ncol + 255) / 256, 256, 0, st>>>(colkey, ncol);
  const size_t shmem = (size_t)Kb * (WORDS * 4 + 4 + 1);
  cudaError_t e = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)shmem);
  if (e != cudaSuccess) return (int)e;
  if (Ka > 0) {
    dim3 grd((Ka + RB - 1) / RB, P);
    match_kernel<<<grd, RB, shmem, st>>>(da, va, db, vb, Ka, Kb, best, second, nn, colkey);
  }
  finish_columns_kernel<<<(ncol + 255) / 256, 256, 0, st>>>(colkey, colmin, colarg, ncol);
  return (int)cudaGetLastError();
}
