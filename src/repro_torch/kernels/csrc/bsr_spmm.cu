// Block-row Gustavson product of a float32 BSR matrix with a float32 dense
// one, on the CUDA cores: the float32 route of ops.bsr_spmm.  bfloat16
// inputs go to bsr_spmm_wgmma.cu (the tensor cores; a TF32 wgmma would keep
// only 10 mantissa bits of float32 operands).
//   C[i*bs:(i+1)*bs, :] = sum over j < min(max_blocks_per_row, row length)
//                         of A_blocks[rowptr[i] + j] @ B[colidx[.]*bs : +bs, :]
// accumulated in float32.
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_bsr.py:bsr_spmm
// (_accum_kernel: grid (block-rows, max_blocks_per_row), rowptr and colidx
// scalar-prefetched, the B row-block DMA'd through colidx, the output block
// revisited along the inner grid axis).  As there, the blocks of a row past
// max_blocks_per_row are dropped, a block id past the last stored block
// reads the last block, and an empty row gives zeros.  Block-column ids are
// clipped to B's block rows, so no id reads outside B.
//
// What bounds it on an H100: at the FFN path's shape in float32 (128 x 128
// blocks, 3 per block-row, d = 2048) the bytes (A's blocks, the B rows it
// names and C written once, ~105 MB) over 3.35 TB/s against the operations
// at the 67 TFLOP/s float32 rate of the CUDA cores (12.9 GFLOP, 0.19 ms):
// operations.
//
// Design: the sequential inner grid axis of the TPU kernel becomes a loop
// inside a block.  A block owns a 64 x 64 tile of one block-row's output
// (rows m0.. of the block-row, columns n0..), walks the row's blocks in
// order and, for each, the block's depth in steps of 16: it stages the
// 64 x 16 slice of the A block (transposed) and the 16 x 64 slice of the B
// row-block in shared memory, then each of 256 threads accumulates a 4 x 4
// patch in registers (fmaf).  Rows past bs and columns past d are staged as
// zeros and not stored, so any bs and d are served.  Offsets are 64-bit.
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 16;
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int kPad = 4;        // keeps As's columns 16-byte aligned

__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ rowptr, const int* __restrict__ colidx,
                const float* __restrict__ a_blocks,
                const float* __restrict__ b,
                float* __restrict__ out, int n_bcols, int bs, long long d,
                int max_bpr, long long bcap, int m_tiles) {
  __shared__ __align__(16) float As[kTK][kTM + kPad];  // As[k][m]
  __shared__ __align__(16) float Bs[kTK][kTN];         // Bs[k][n]
  const long long brow = blockIdx.x / m_tiles;
  const int m0 = (blockIdx.x % m_tiles) * kTM;
  const long long n0 = (long long)blockIdx.y * kTN;
  const int tx = threadIdx.x % 16;  // column group
  const int ty = threadIdx.x / 16;  // row group

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const long long start = rowptr[brow];
  long long len = rowptr[brow + 1] - start;
  if (len > max_bpr) len = max_bpr;
  for (long long j = 0; j < len; ++j) {
    const long long p = start + j < bcap ? start + j : bcap - 1;
    int c = colidx[p];
    c = c < 0 ? 0 : (c >= n_bcols ? n_bcols - 1 : c);
    const float* a = a_blocks + p * bs * bs;
    const float* bb = b + (long long)c * bs * d;
    for (int k0 = 0; k0 < bs; k0 += kTK) {
      for (int e = threadIdx.x; e < kTM * kTK; e += kThreads) {
        const int m = e / kTK, k = e % kTK;
        As[k][m] = (m0 + m < bs && k0 + k < bs)
                       ? a[(long long)(m0 + m) * bs + k0 + k]
                       : 0.0f;
      }
      for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
        const int k = e / kTN, n = e % kTN;
        Bs[k][n] = (k0 + k < bs && n0 + n < d)
                       ? bb[(long long)(k0 + k) * d + n0 + n]
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTK; ++k) {
        const float4 av = reinterpret_cast<const float4*>(As[k])[ty];
        const float4 bv = reinterpret_cast<const float4*>(Bs[k])[tx];
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] = fmaf(ar[i], br[jj], acc[i][jj]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= bs) continue;
    float* row = out + (brow * bs + m) * d;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const long long n = n0 + tx * 4 + jj;
      if (n < d) row[n] = acc[i][jj];
    }
  }
}

int launch(const void* rowptr, const void* colidx, const void* a_blocks,
           const void* b, void* out, long long n_brows, long long n_bcols,
           long long bs, long long d, long long max_bpr, long long bcap,
           cudaStream_t stream) {
  const long long m_tiles = (bs + kTM - 1) / kTM;
  const long long gx = n_brows * m_tiles;
  const long long gy = (d + kTN - 1) / kTN;
  if (gx > 2147483647LL || gy > 65535 || n_bcols > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_bpr > 2147483647LL) max_bpr = 2147483647LL;
  bsr_spmm_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                    stream>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colidx),
      static_cast<const float*>(a_blocks), static_cast<const float*>(b),
      static_cast<float*>(out), (int)n_bcols, (int)bs, d, (int)max_bpr, bcap,
      (int)m_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rowptr: (n_brows + 1,) int32; colidx: (bcap,) int32; a_blocks:
// (bcap, bs, bs) float32; b: (n_bcols * bs, d) float32; out:
// (n_brows * bs, d) float32, written in full.  bcap > 0.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the grid cannot hold.
extern "C" int repro_bsr_spmm(const void* rowptr, const void* colidx,
                              const void* a_blocks, const void* b, void* out,
                              long long n_brows, long long n_bcols,
                              long long bs, long long d, long long max_bpr,
                              long long bcap, void* stream) {
  if (n_brows <= 0 || bs <= 0 || d <= 0) return 0;
  if (bcap <= 0 || n_bcols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(rowptr, colidx, a_blocks, b, out, n_brows, n_bcols, bs, d,
                max_bpr, bcap, static_cast<cudaStream_t>(stream));
}
