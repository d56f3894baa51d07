// Row-split CSR SpMV with explicit columns (K13, csr_split): the heavy rows
// of an f32 row-split hybrid, y[row] = sum_k vals[k] * x[cols[k]] over the
// row's nonzeros k in CSR order.
//
// Replaces no TPU kernel.  On the TPU the hybrid's heavy rows ride SELL-8W
// tiles (spmv_tpu/ops/pallas_sell.py::_kernel_v2 in row mode, K1 row here):
// x is cut into 1,024-column windows because it had to sit in VMEM, and a
// permuted scale-free graph spreads each heavy row over many windows, so
// most slots of that stream are padding (7.44 slots a nonzero on Graph500
// SCALE 19).  The card keeps an x of up to 2M f32 columns in its 50 MB L2,
// so this layout (spmv_tpu_torch/formats/csr_split.py) is plain CSR: an
// int32 column plane and an f32 value plane, each nonzero once, about 8 B a
// nonzero, and no windows.
//
// Bound on the H100: the two planes stream once from device memory, and
// each nonzero gathers one x word, a 32-B L2 sector where x is L2-resident.
// The hub rows of a Kronecker graph run to tens of thousands of nonzeros,
// so no warp takes a whole row: each row is cut into pieces of at most P
// nonzeros (the reference's Balanced2 intra-row split), and each piece
// takes a warp, whose lanes stride it, so that each step's 32 column loads
// and 32 value loads are each one coalesced 128-B stretch.  A lane keeps
// kUnroll steps' loads in flight before their FMAs.  Latency is hidden by
// occupancy: no shared memory, few registers.  The planes are read with
// the streaming hint (ld.global.cs: used once, evicted first) so that they
// do not push x out of the L2.  Measured on the H100 (Graph500 SCALE 19's
// heavy rows: 10.56 M nonzeros in rows of 140 to 40,527, 200 chained
// calls): P 256, 512, 1024, 2048 take 102.9, 93.5, 84.1, 83.1 us at
// kUnroll 4, and kUnroll 1 and 2 are 0.3-3.0% slower at every P; in
// another call P 2048, 4096, 6144, 8192, 16384 and no split take 83.7,
// 80.2, 87.2, 90.0, 108.7 and 195.9 us.  Short rows get no sub-warp: 8 or
// 16 lanes a row shorter than 64 or 128 timed the same, as no heavy row
// there is that short.
//
// Each lane sums its nonzeros in order with one FMA each; the lanes of a
// piece are added by a butterfly of shuffles (xor 16, 8, 4, 2, 1).  A row
// of one piece is written by its piece.  A row of several pieces: each
// piece writes its sum to `partial`, fences, and takes a ticket (atomicAdd
// on the row's counter); the piece that takes the last ticket adds the
// row's piece sums in piece order, from 0, and sets the counter back to 0.
// The ticket is the only atomic.  Every sum has a fixed order, so y
// repeats bit for bit from call to call.
#include "common.cuh"

namespace spmv {
namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;       // warps a block
constexpr int kUnroll = 4;      // steps a lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

// One lane's sum over nonzeros s + lane, s + lane + 32, ... < e, in order.
__device__ __forceinline__ float lane_sum(const int32_t* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          const float* __restrict__ x,
                                          int32_t s, int32_t e, int lane) {
  float acc = 0.0f;
  int32_t k = s + lane;
  for (; k < e - (kUnroll - 1) * kWarp; k += kUnroll * kWarp) {
    int32_t c[kUnroll];
    float v[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      c[u] = __ldcs(cols + k + u * kWarp);
      v[u] = __ldcs(vals + k + u * kWarp);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = __ldg(x + c[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = fma_acc(v[u], xv[u], acc);
  }
  for (; k < e; k += kWarp)
    acc = fma_acc(__ldcs(vals + k), __ldg(x + __ldcs(cols + k)), acc);
  return acc;
}

__global__ void __launch_bounds__(kWarp * kWarps)
csr_split_kernel(const int32_t* __restrict__ piece_ptr,
                 const int32_t* __restrict__ piece_row,
                 const int32_t* __restrict__ row_piece,
                 const int32_t* __restrict__ cols,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 float* __restrict__ y, float* __restrict__ partial,
                 int32_t* __restrict__ ticket, int64_t npieces) {
  const int64_t p = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (p >= npieces) return;
  const int lane = int(threadIdx.x % kWarp);
  float sum = lane_sum(cols, vals, x, __ldg(piece_ptr + p),
                       __ldg(piece_ptr + p + 1), lane);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  const int32_t r = __ldg(piece_row + p);
  const int32_t f = __ldg(row_piece + r);
  const int32_t c = __ldg(row_piece + r + 1) - f;
  if (c == 1) {
    if (lane == 0) y[r] = sum;
    return;
  }
  int last = 0;
  if (lane == 0) {
    partial[p] = sum;
    // the piece's store is visible device-wide before its ticket
    __threadfence();
    last = atomicAdd(ticket + r, 1) == c - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  // the last piece: the row's piece sums in piece order, 32 loads at a
  // time, added from lane 0's to lane 31's
  float total = 0.0f;
  for (int32_t i0 = 0; i0 < c; i0 += kWarp) {
    const float v = i0 + lane < c ? __ldcg(partial + f + i0 + lane) : 0.0f;
    const int k = min(kWarp, c - i0);
    for (int j = 0; j < k; ++j) total += __shfl_sync(kFull, v, j);
  }
  if (lane == 0) {
    y[r] = total;
    ticket[r] = 0;
  }
}

}  // namespace
}  // namespace spmv

// piece_ptr: (npieces + 1,) int32, each piece's first nonzero; piece_row:
// (npieces,) int32; row_piece: (m + 1,) int32, each row's first piece (a
// row's pieces are consecutive); cols, vals: (nnz,) int32 and f32; x: (n,)
// f32; y: (m,) f32, every row written; partial: (npieces,) f32 scratch,
// may be null where no row has two pieces; ticket: (m,) int32, zero, left
// zero.  One warp a piece.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int spmv_csr_split_launch(const void* piece_ptr,
                                     const void* piece_row,
                                     const void* row_piece, const void* cols,
                                     const void* vals, const void* x,
                                     void* y, void* partial, void* ticket,
                                     int64_t npieces, void* stream) {
  if (npieces <= 0) return 0;
  constexpr int64_t kThreads = spmv::kWarp * spmv::kWarps;
  const int64_t blocks = (npieces + spmv::kWarps - 1) / spmv::kWarps;
  spmv::csr_split_kernel<<<unsigned(blocks), unsigned(kThreads), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(piece_ptr),
      static_cast<const int32_t*>(piece_row),
      static_cast<const int32_t*>(row_piece),
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(partial), static_cast<int32_t*>(ticket), npieces);
  return int(cudaGetLastError());
}
